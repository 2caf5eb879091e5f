"""The port's OASST acquisition (data/acquisition.py) against the JAX
package's, run side by side on the same inputs in their own directories:

- `process_local_dump` of a seeded raw OASST dump (message trees with
  branches, dead ends, non-English and corrupt lines): the same shard
  files, byte for byte, and the same stats, at a record limit that
  rotates shards and without one;
- `fetch_raw` through an injected opener: a fresh fetch with its sha256
  sidecar, a failed transfer whose partial resumes with Range + If-Range,
  a server answering 200 to a resume (If-Range saw a changed remote), a
  416 on a stale partial, a partial without a validator, and a checksum
  mismatch: the same return values, files and request headers;
- `download_and_process` returns False, as JAX's does, where `datasets`
  is missing (the network probe patched out: no test contacts a host);
- `data acquire --in DUMP` prints the stats and writes the shards.
"""

import hashlib
import io
import json
import os
import sys
import urllib.error
from pathlib import Path

import numpy as np
import pytest

from luminaai_tpu.data import acquisition as jacq
from luminaai_tpu_torch.data import acquisition as tacq

SIDES = {"jax": jacq, "torch": tacq}


def _raw_dump(path: Path, seed: int = 0, trees: int = 40) -> None:
    """Seeded raw OASST rows: per tree a prompt, 1-3 assistant answers,
    follow-ups two levels deep; some empty texts, some 'de' rows, one
    corrupt line in the middle and a truncated tail."""
    rng = np.random.RandomState(seed)
    rows = []
    for t in range(trees):
        root = f"t{t}"
        lang = "de" if rng.rand() < 0.15 else "en"
        rows.append({"message_id": root, "parent_id": None,
                     "role": "prompter", "lang": lang,
                     "message_tree_id": root,
                     "text": f"Question {t}: " + "why " * rng.randint(1, 9)})
        frontier = [root]
        for depth in range(3):
            nxt = []
            for parent in frontier:
                role = "assistant" if depth % 2 == 0 else "prompter"
                for k in range(rng.randint(1, 3)):
                    mid = f"{parent}.{k}"
                    text = ("" if rng.rand() < 0.05 else
                            f"{role} turn {depth} " + "word " *
                            rng.randint(2, 30))
                    rows.append({"message_id": mid, "parent_id": parent,
                                 "role": role, "lang": lang, "text": text,
                                 "rank": int(rng.randint(0, 3)),
                                 "synthetic": bool(rng.rand() < 0.1)})
                    nxt.append(mid)
            frontier = nxt
    lines = [json.dumps(r) for r in rows]
    lines.insert(len(lines) // 2, '{"message_id": "broken", "text": ')
    path.write_text("\n".join(lines) + '\n{"message_id": "cut')


@pytest.mark.parametrize("max_records", [None, 7])
def test_process_local_dump_equals_jax(tmp_path, max_records):
    dump = tmp_path / "raw.jsonl"
    _raw_dump(dump)
    out = {}
    for name, mod in SIDES.items():
        dl = mod.DatasetDownloader(str(tmp_path / name),
                                   max_records_per_file=max_records)
        stats = dl.process_local_dump(str(dump), "train")
        files = stats.pop("files")
        out[name] = (stats, [(Path(f).name, Path(f).read_bytes())
                             for f in files])
    assert out["torch"] == out["jax"]
    stats, files = out["torch"]
    assert stats["count"] > 10
    if max_records:
        assert len(files) > 1


class FakeResp(io.BytesIO):
    status = 206
    headers = {"ETag": 'W/"v1"'}

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _dying(payload):
    def opener(url, headers):
        resp = FakeResp(payload)
        read = resp.read

        def once(n):
            chunk = read(n)
            if not chunk:
                raise OSError("connection reset")
            return chunk

        resp.read = once
        return resp
    return opener


def _serving(payload, status=206, seen=None, refuse_range=False):
    def opener(url, headers):
        if seen is not None:
            seen.append((headers.get("Range"), headers.get("If-Range")))
        if refuse_range and headers.get("Range"):
            raise urllib.error.HTTPError(url, 416, "Range Not Satisfiable",
                                         {}, None)
        resp = FakeResp(payload)
        resp.status = status
        return resp
    return opener


def _scenario(mod, d: Path, case: str):
    """Run one fetch_raw case in directory d; return what it observably
    did (return value, files and their bytes, the headers sent)."""
    url = "https://example.com/" + case
    dest = d / "dest.dat"
    seen = []
    part = Path(mod._part_path(str(dest), url))
    if case == "fresh":
        ret = [mod.fetch_raw(url, str(dest), _opener=_serving(b"payload"))]
    elif case == "resume":
        ret = [mod.fetch_raw(url, str(dest), _opener=_dying(b"first-")),
               mod.fetch_raw(url, str(dest),
                             _opener=_serving(b"rest", seen=seen))]
    elif case == "if_range_200":
        part.write_bytes(b"stale-half")
        Path(str(part) + ".meta").write_text('W/"v1"')
        ret = [mod.fetch_raw(url, str(dest),
                             _opener=_serving(b"whole", 200, seen))]
    elif case == "416":
        part.write_bytes(b"toolongpartial")
        Path(str(part) + ".meta").write_text('W/"v1"')
        ret = [mod.fetch_raw(url, str(dest),
                             _opener=_serving(b"fresh", seen=seen,
                                              refuse_range=True))]
    elif case == "no_validator":
        part.write_bytes(b"orphan")
        ret = [mod.fetch_raw(url, str(dest),
                             _opener=_serving(b"complete", seen=seen))]
    elif case == "sha_mismatch":
        good = hashlib.sha256(b"payload").hexdigest()
        ret = [mod.fetch_raw(url, str(dest), _opener=_serving(b"payload"),
                             expected_sha256=good),
               mod.fetch_raw(url, str(d / "bad.dat"),
                             _opener=_serving(b"payload"),
                             expected_sha256="0" * 64)]
    files = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    return ([None if r is None else os.path.relpath(r, d) for r in ret],
            files, seen)


@pytest.mark.parametrize("case", ["fresh", "resume", "if_range_200", "416",
                                  "no_validator", "sha_mismatch"])
def test_fetch_raw_equals_jax(tmp_path, case):
    got = {}
    for name, mod in SIDES.items():
        d = tmp_path / name
        d.mkdir()
        got[name] = _scenario(mod, d, case)
    assert got["torch"] == got["jax"]
    ret, files, seen = got["torch"]
    if case == "resume":
        assert files["dest.dat"] == b"first-rest"
        assert seen == [("bytes=6-", 'W/"v1"')]
    if case == "sha_mismatch":
        assert ret[1] is None and "bad.dat" not in files


def test_download_and_process_without_datasets(tmp_path, monkeypatch):
    for mod in SIDES.values():
        monkeypatch.setattr(mod, "network_available",
                            lambda timeout=2.0: False)
    monkeypatch.setitem(sys.modules, "datasets", None)
    for mod in SIDES.values():
        assert mod.DatasetDownloader(str(tmp_path)).download_and_process() \
            is False


def test_cli_data_acquire_in_dump(tmp_path, capsys, monkeypatch):
    from luminaai_tpu_torch import cli

    dump = tmp_path / "raw.jsonl"
    _raw_dump(dump, seed=1, trees=12)
    out = tmp_path / "oasst"
    assert cli.main(["data", "acquire", "--in", str(dump), "--out",
                     str(out), "--max-per-file", "5"]) == 0
    stats = json.loads(capsys.readouterr().out)
    want = jacq.DatasetDownloader(str(tmp_path / "j"),
                                  max_records_per_file=5).process_local_dump(
        str(dump))
    assert stats["count"] == want["count"] and len(stats["files"]) == len(
        want["files"]) > 1
    monkeypatch.setattr(tacq, "network_available", lambda timeout=2.0: False)
    monkeypatch.setitem(sys.modules, "datasets", None)
    assert cli.main(["data", "acquire", "--out", str(out)]) == 1
