"""Native (C++) runtime helpers, loaded via ctypes with build-on-demand
(the port's copy of luminaai_tpu/native/__init__.py and its sources).

dataloader.cpp and bpe.cpp compile with g++ -O3 into one shared library
on first use, keyed by a hash of both sources, under the git-ignored
`luminaai_tpu_torch/native/_build/` (as ops/_build.py builds csrc/).
Every entry point keeps the JAX module's pure-numpy version, used when
the library cannot be built or when the caller asks for it; the packer's
two paths are bit-identical. Each entry point logs, once, which path it
took, and `path_counts()` counts the calls per path (chip_smoke.py reads
it to prove the native packer ran). See dataloader.cpp for the packer
contract; `content_hashes` binds its FNV-1a routine for the multi-source
blender's dedup (data/multi_source.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_SRC = Path(__file__).parent / "dataloader.cpp"
_SRC_BPE = Path(__file__).parent / "bpe.cpp"
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


BUILD_DIR = Path(__file__).resolve().parent / "_build"

# Calls per (function, path), path "native" or "numpy".
_COUNTS: Dict[Tuple[str, str], int] = {}


def _took(fn: str, native: bool) -> None:
    key = (fn, "native" if native else "numpy")
    if key not in _COUNTS:
        logger.info("%s: %s path", fn, key[1])
    _COUNTS[key] = _COUNTS.get(key, 0) + 1


def path_counts() -> Dict[str, Dict[str, int]]:
    """{function: {"native": calls, "numpy": calls}} since the start (or
    the last reset_path_counts())."""
    out: Dict[str, Dict[str, int]] = {}
    for (fn, path), n in _COUNTS.items():
        out.setdefault(fn, {"native": 0, "numpy": 0})[path] = n
    return out


def reset_path_counts() -> None:
    _COUNTS.clear()


def _build() -> Optional[ctypes.CDLL]:
    src = _SRC.read_bytes() + _SRC_BPE.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    so = BUILD_DIR / f"dataloader_{tag}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
            str(_SRC), str(_SRC_BPE), "-o", str(tmp),
        ]
        try:
            subprocess.run(
                cmd, check=True, capture_output=True, timeout=120
            )
            os.replace(tmp, so)  # atomic: concurrent builds agree
        except Exception as e:  # pragma: no cover - toolchain-dependent
            tmp.unlink(missing_ok=True)
            logger.warning("native build failed (%s); using numpy fallback", e)
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:  # pragma: no cover
        logger.warning("native load failed (%s); using numpy fallback", e)
        return None
    lib.lumina_pack_batch.restype = ctypes.c_long
    lib.lumina_pack_batch.argtypes = [
        ctypes.POINTER(ctypes.c_int32),  # tokens
        ctypes.POINTER(ctypes.c_int64),  # offsets
        ctypes.c_long, ctypes.c_long, ctypes.c_long,  # n_docs, start_doc, start_token
        ctypes.POINTER(ctypes.c_int32),  # out
        ctypes.POINTER(ctypes.c_int32),  # out_mask
        ctypes.c_long, ctypes.c_long,    # batch, seq_len
        ctypes.c_int32, ctypes.c_int32,  # pad_id, eos_id
        ctypes.c_int,                    # split_docs
        ctypes.POINTER(ctypes.c_long),   # out_token_cursor
    ]
    lib.lumina_shuffle_indices.restype = None
    lib.lumina_shuffle_indices.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_long, ctypes.c_uint64
    ]
    lib.lumina_index_lines.restype = ctypes.c_long
    lib.lumina_index_lines.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_long,
    ]
    lib.lumina_fnv1a64_batch.restype = None
    lib.lumina_fnv1a64_batch.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_long, ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.bpe_train.restype = ctypes.c_int32
    lib.bpe_train.argtypes = [
        ctypes.POINTER(ctypes.c_int32),  # word_data
        ctypes.POINTER(ctypes.c_int64),  # word_offsets
        ctypes.POINTER(ctypes.c_int64),  # word_counts
        ctypes.c_int32, ctypes.c_int32,  # n_words, n_merges
        ctypes.POINTER(ctypes.c_int32),  # merges_out
    ]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        _LIB = _build()
    return _LIB


def native_available() -> bool:
    return get_lib() is not None


def _as_c(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def pack_batch(
    tokens: np.ndarray,
    doc_offsets: np.ndarray,
    start_doc: int,
    batch: int,
    seq_len: int,
    pad_id: int,
    eos_id: int = -1,
    split_docs: bool = True,
    start_token: int = 0,
    use_native: bool = True,
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Pack documents into a [batch, seq_len] int32 grid + mask.

    Returns (batch_tokens, mask, next_doc, next_token_offset) — the cursor
    pair resumes packing exactly where this call stopped.
    """
    tokens = np.ascontiguousarray(tokens, dtype=np.int32)
    doc_offsets = np.ascontiguousarray(doc_offsets, dtype=np.int64)
    n_docs = len(doc_offsets) - 1
    out = np.empty((batch, seq_len), dtype=np.int32)
    mask = np.empty((batch, seq_len), dtype=np.int32)

    lib = get_lib() if use_native else None
    if lib is not None:
        cursor = ctypes.c_long(0)
        next_doc = lib.lumina_pack_batch(
            _as_c(tokens, ctypes.c_int32),
            _as_c(doc_offsets, ctypes.c_int64),
            n_docs, start_doc, start_token,
            _as_c(out, ctypes.c_int32),
            _as_c(mask, ctypes.c_int32),
            batch, seq_len, pad_id, eos_id,
            1 if split_docs else 0,
            ctypes.byref(cursor),
        )
        if next_doc >= 0:
            _took("pack_batch", True)
            return out, mask, int(next_doc), int(cursor.value)
        logger.warning("native packer error; falling back to numpy")

    _took("pack_batch", False)
    return _pack_batch_numpy(
        tokens, doc_offsets, start_doc, start_token, out, mask,
        batch, seq_len, pad_id, eos_id, split_docs,
    )


def _pack_batch_numpy(
    tokens, doc_offsets, start_doc, start_token, out, mask,
    batch, seq_len, pad_id, eos_id, split_docs,
):
    """Reference implementation; semantics identical to the C++ packer."""
    out.fill(pad_id)
    mask.fill(0)
    n_docs = len(doc_offsets) - 1
    doc, tok_in_doc = start_doc, start_token
    for row in range(batch):
        col = 0
        while col < seq_len and doc < n_docs:
            beg = int(doc_offsets[doc]) + tok_in_doc
            end = int(doc_offsets[doc + 1])
            avail = end - beg
            if avail <= 0:
                doc += 1
                tok_in_doc = 0
                continue
            take = min(avail, seq_len - col)
            out[row, col:col + take] = tokens[beg:beg + take]
            mask[row, col:col + take] = 1
            col += take
            if take == avail:
                doc += 1
                tok_in_doc = 0
                if eos_id >= 0 and col < seq_len:
                    out[row, col] = eos_id
                    mask[row, col] = 1
                    col += 1
            else:
                tok_in_doc += take
                if not split_docs:
                    doc += 1
                    tok_in_doc = 0
                break
        if doc >= n_docs:
            break
    return out, mask, doc, tok_in_doc


def shuffle_indices(n: int, seed: int, use_native: bool = True) -> np.ndarray:
    idx = np.arange(n, dtype=np.int64)
    lib = get_lib() if use_native else None
    if lib is not None:
        lib.lumina_shuffle_indices(_as_c(idx, ctypes.c_int64), n, seed)
        _took("shuffle_indices", True)
        return idx
    _took("shuffle_indices", False)
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    rng.shuffle(idx)
    return idx


def index_lines(data, use_native: bool = True) -> np.ndarray:
    """Byte offsets of every line start in a buffer (jsonl random access).

    `data` is any buffer (bytes / mmap / memoryview); indexing is zero-copy
    via numpy's buffer view. The C scanner runs memchr over the buffer off
    the GIL; fallback is a numpy newline scan (bit-identical, tested).
    """
    arr = np.frombuffer(data, dtype=np.uint8)
    n_bytes = arr.size
    if n_bytes == 0:
        return np.empty(0, dtype=np.int64)
    lib = get_lib() if use_native else None
    if lib is not None:
        # Seed capacity from the buffer size so the first memchr pass
        # almost always suffices (retry re-scans the whole buffer).
        cap = max(4096, n_bytes // 32)
        while True:
            out = np.empty(cap, dtype=np.int64)
            n = lib.lumina_index_lines(
                arr.ctypes.data_as(ctypes.c_char_p), n_bytes,
                _as_c(out, ctypes.c_int64), cap,
            )
            if n >= 0:
                _took("index_lines", True)
                return out[:n].copy()
            cap = -n
    _took("index_lines", False)
    newlines = np.flatnonzero(arr == ord("\n"))
    starts = np.concatenate([[0], newlines + 1])
    if starts[-1] >= n_bytes:  # trailing newline: no final line start
        starts = starts[:-1]
    return starts.astype(np.int64)


def content_hashes(
    docs: "list[bytes]", use_native: bool = True
) -> np.ndarray:
    """FNV-1a 64-bit hash per document (dedup keys for the multi-source
    blender). Native path hashes one concatenated buffer off the GIL; the
    plain version is the JAX module's byte loop."""
    n = len(docs)
    out = np.empty(n, dtype=np.uint64)
    lib = get_lib() if use_native else None
    if lib is not None and n:
        buf = b"".join(docs)
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(d) for d in docs], out=offsets[1:])
        lib.lumina_fnv1a64_batch(
            buf, _as_c(offsets, ctypes.c_int64), n,
            _as_c(out, ctypes.c_uint64),
        )
        _took("content_hashes", True)
        return out
    _took("content_hashes", False)
    for i, d in enumerate(docs):
        h = 14695981039346656037
        for b in d:
            h = ((h ^ b) * 1099511628211) & 0xFFFFFFFFFFFFFFFF
        out[i] = h
    return out


def bpe_train_native(
    word_data: np.ndarray,
    word_offsets: np.ndarray,
    word_counts: np.ndarray,
    n_merges: int,
) -> Optional[np.ndarray]:
    """Run the C++ BPE merge loop; None when the native lib is absent.

    Returns [n_produced, 2] int32 merge pairs in merge order (merge i
    creates token id 256+i). See bpe.cpp for the algorithm contract.
    """
    lib = get_lib()
    if lib is None:
        return None
    _took("bpe_train_native", True)
    word_data = np.ascontiguousarray(word_data, dtype=np.int32)
    word_offsets = np.ascontiguousarray(word_offsets, dtype=np.int64)
    word_counts = np.ascontiguousarray(word_counts, dtype=np.int64)
    out = np.zeros((n_merges, 2), dtype=np.int32)
    n = lib.bpe_train(
        _as_c(word_data, ctypes.c_int32),
        _as_c(word_offsets, ctypes.c_int64),
        _as_c(word_counts, ctypes.c_int64),
        len(word_counts),
        n_merges,
        _as_c(out, ctypes.c_int32),
    )
    return out[:n]
