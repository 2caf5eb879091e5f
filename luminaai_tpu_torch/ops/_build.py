"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` compiles into its own shared library with a plain C
interface, keyed by a hash of the source, the headers beside it
(`csrc/*.cuh`, which the sources include) and the flags, under
`luminaai_tpu_torch/_kernels/` (git-ignored). Nothing is built when a
module is imported: the first launch of a kernel builds its library, and
`build_all()` builds every source at once with one nvcc process each (the
way `chip_smoke.py` front-loads the build). nvcc exists only on the machine
with the card, so the CPU tests never reach this module's build path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_kernels"

# Every kernel source of the port (csrc/<name>.cu).
SOURCES = ("ragged_paged_attention", "flash_attention", "gmm")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    # Registers, shared memory and spills per kernel, kept in the build log.
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or CUDA_HOME/bin): the port's CUDA kernels "
        "are built from source on the machine with the card"
    )


def library_path(name: str) -> Path:
    """The library built from csrc/<name>.cu: its name changes with the
    source, with any header in csrc/ (the build's include directory) and
    with the flags, so a stale library is never loaded."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str) -> Optional[Tuple[subprocess.Popen, Path, Path]]:
    """Start nvcc for one source into a temporary file. Returns (process,
    library path, temporary path), or None when the library for this
    exact source is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, out, tmp


def _finish(name: str, started: Tuple[subprocess.Popen, Path, Path]) -> None:
    proc, out, tmp = started
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builds agree


def build_all(names: Iterable[str] = SOURCES) -> float:
    """Build every listed source, all nvcc processes started together.
    Returns the wall seconds spent."""
    t0 = time.perf_counter()  # lumina: disable=LX004 -- times the nvcc build it reports; no result depends on it
    with _lock:
        started = {n: _start(n) for n in names}
        for n, st in started.items():
            if st is not None:
                _finish(n, st)
    return time.perf_counter() - t0  # lumina: disable=LX004 -- the build's wall seconds, as above


def build_log(name: str) -> str:
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        started = _start(name)
        if started is not None:
            _finish(name, started)
        lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib
