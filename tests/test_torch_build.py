"""The kernel build's cache key (luminaai_tpu_torch/ops/_build.py).

A kernel library is named by a hash of what it is built from. The sources
include headers from csrc/ (hopper.cuh), so the hash must cover them too,
or a changed header would load a stale library. Runs on the CPU: nothing
is compiled, only `library_path` is read, over a copy of csrc/.
"""

import shutil

import pytest

from luminaai_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, copy)
    monkeypatch.setattr(_build, "CSRC_DIR", copy)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_kernels")
    return copy


def test_every_source_and_its_headers_exist():
    for name in _build.SOURCES:
        assert (_build.CSRC_DIR / f"{name}.cu").is_file()
    assert list(_build.CSRC_DIR.glob("*.cuh")), "csrc/ holds no header"


@pytest.mark.parametrize("name", _build.SOURCES)
def test_library_path_is_stable(csrc, name):
    first = _build.library_path(name)
    assert first == _build.library_path(name)
    assert first.parent == _build.BUILD_DIR
    assert first.name.startswith(f"{name}-") and first.suffix == ".so"


@pytest.mark.parametrize("name", _build.SOURCES)
def test_library_path_follows_headers(csrc, name):
    before = _build.library_path(name)
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// changed\n")
    changed = _build.library_path(name)
    assert changed != before
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path(name) not in (before, changed)


def test_library_path_follows_source_and_flags(csrc, monkeypatch):
    before = _build.library_path("gmm")
    src = csrc / "gmm.cu"
    src.write_text(src.read_text() + "\n")
    after_src = _build.library_path("gmm")
    assert after_src != before
    monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "-lineinfo"))
    assert _build.library_path("gmm") != after_src
