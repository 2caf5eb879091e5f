#!/usr/bin/env python3
"""Time the port's kernels from two source trees side by side.

    python scripts/bisect_kernels.py --parent DIR [--rounds 2]
        [--cases b1_decode,b1_decode_int8,b1_train,flagship_train,
                 debug200m_train,b14_group5_train,debug300m_train,
                 d256_train,gmm_train_wi,...]

DIR holds another checkout of the repository (for example the parent
commit, unpacked with `git archive`). The script builds
`luminaai_tpu_torch/csrc/{ragged_paged_attention,flash_attention,gmm}.cu`
from DIR and from this checkout with the port's nvcc flags, loads both
through ctypes (the C interfaces are the same in both trees), and times on
one card, in turns (parent, this, this, parent, ...), on the same inputs:

- B5 at the b1 decode shape (8 lanes, Hq 16, Hkv 4, head_dim 128, lengths
  1-2048 in 128-row pages; each call reads the next of 4 K/V pools, past
  the 50 MB L2), and B5-int8 at the same shape over 4 int8 pools (codes
  and fp32 scales, 67 MB together);
- B1, B2, B3 at the b1 dense training micro-batch (q [2, 2048, 16, 128],
  k/v [2, 2048, 4, 128], causal), at the flagship MoE training shape
  (q [16, 2048, 16, 64], k/v [16, 2048, 8, 64], causal) and at
  debug_200m's (q [8, 2048, 12, 64], k/v [8, 2048, 4, 64], causal: a
  group of 3), at b14's attention (q [1, 4096, 40, 128], k/v [1, 4096, 8,
  128], causal: a group of 5, padding rows in B1 and B2), at debug_300m's
  micro-batch (q [16, 1024, 4, 192], k/v [16, 1024, 2, 192], causal:
  head_dim 192) and at head_dim 256 (q [1, 2048, 8, 256], k/v [1, 2048, 2,
  256], causal);
- B4a (gmm, and with transpose_rhs) and B4b (tgmm) at the flagship MoE
  wi shape (65,536 rows, 65,100 kept over 8 experts, K 1024, N 5632) and
  wo shape (K 2816, N 1024), and B4a at the b1 decode wi shape (16 pair rows over 7 of 8 experts in a
  128-row buffer, K 2048, N 11008).

It prints the card's name and power limit, then one JSON object: the
CUDA-event ms of every kernel, tree and round over back-to-back calls
("ms"); for the decode cases also the ms a launch replayed from a CUDA
graph of the same calls ("graph_ms": no host time between launches,
which back-to-back calls of a kernel of tens of microseconds might
include); and the largest absolute difference between the two trees'
outputs on the same inputs ("max_abs_diff"). Before the timings it prints
each tree's ptxas lines for the flash kernels (registers and spills, from
`-Xptxas -v`; the whole logs stay in _kernels/bisect/). It needs a card and
nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SOURCES = ("ragged_paged_attention", "flash_attention", "gmm")
# The chip_smoke.py GMM_CASES shapes timed here: (rows, K, N, group sizes).
GMM_TRAIN_WI = (65536, 1024, 2 * 2816,
                [9000, 8100, 7900, 8200, 8300, 7700, 8050, 7850])
GMM_TRAIN_WO = (65536, 2816, 1024, GMM_TRAIN_WI[3])
GMM_SERVE_WI = (128, 2048, 2 * 5504, [2, 3, 1, 0, 4, 2, 3, 1])


def _build_dir() -> Path:
    from luminaai_tpu_torch.ops import _build

    return _build.BUILD_DIR / "bisect"


def build(tree: Path, tag: str) -> dict:
    """{source: loaded library} built from tree's csrc/ into this
    checkout's git-ignored _kernels/bisect/ (with each build's log)."""
    from luminaai_tpu_torch.ops import _build

    out = _build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = {
        name: subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out / f"{tag}-{name}.so"),
             str(tree / "luminaai_tpu_torch" / "csrc" / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in SOURCES
    }
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        # ptxas -v: each kernel's registers and spills, per tree.
        (out / f"{tag}-{name}.log").write_text(log)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tag} {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out / f"{tag}-{name}.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn, n_ptrs in (("lumina_ragged_paged_attention", 6),
                       ("lumina_ragged_paged_attention_int8", 8)):
        f = getattr(libs["ragged_paged_attention"], fn)
        f.argtypes, f.restype = [p] * n_ptrs + [i] * 8 + [ctypes.c_float, p], i
    for fn, n_ptrs in (("lumina_flash_fwd", 5), ("lumina_flash_bwd_dq", 7),
                       ("lumina_flash_bwd_dkv", 8)):
        f = getattr(libs["flash_attention"], fn)
        f.argtypes = [p] * n_ptrs + [i] * 8 + [ctypes.c_float, p]
        f.restype = i
    for fn in ("lumina_gmm", "lumina_tgmm"):
        f = getattr(libs["gmm"], fn)
        f.argtypes, f.restype = [p] * 4 + [i] * 5 + [p], i
    return libs


def _stream() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream


class Call:
    """One kernel on fixed inputs: run(libs, turn) launches it (turn picks
    the input copy, None the next in rotation); outputs are the tensors it
    writes."""

    def __init__(self, run, outputs, copies: int = 1):
        self.run, self.outputs, self.copies = run, outputs, copies
        self._turn = itertools.count()

    def __call__(self, libs, turn=None):
        self.run(libs, next(self._turn) if turn is None else turn)


def decode_calls(dev, int8: bool = False):
    """{"B5" or "B5-int8": Call} at the b1 decode shape over 4 pools."""
    import torch

    lanes, hq, hkv, d, page, pages = 8, 16, 4, 128, 128, 16
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(lanes, 1, hq, d, generator=gen, device=dev).bfloat16()

    def side():
        x = torch.randn(lanes, page * pages, hkv, d, generator=gen,
                        device=dev)
        if not int8:
            return (x.bfloat16(),)
        # Per-row codes over head_dim, as the int8 cache quantizes at insert.
        scale = x.abs().amax(-1, keepdim=True).clamp_min(1e-8) / 127
        return ((x / scale).round().clamp(-127, 127).to(torch.int8),
                scale.contiguous())

    pools = [side() + side() for _ in range(4)]
    lengths = torch.tensor([1, 127, 128, 129, 700, 1500, 2047, 2048],
                           dtype=torch.int32, device=dev)
    table = (torch.arange(lanes, dtype=torch.int32, device=dev)[:, None]
             * pages + torch.arange(pages, dtype=torch.int32, device=dev))
    table = table.contiguous()
    out = torch.empty_like(q)
    fn = ("lumina_ragged_paged_attention_int8" if int8
          else "lumina_ragged_paged_attention")

    def b5(libs, turn):
        err = getattr(libs["ragged_paged_attention"], fn)(
            q.data_ptr(), *[t.data_ptr() for t in pools[turn % len(pools)]],
            table.data_ptr(), lengths.data_ptr(), out.data_ptr(), lanes, hq,
            hkv, d, page, pages, lanes * pages, 0, 1 / math.sqrt(d),
            _stream())
        assert err == 0, err

    return {"B5-int8" if int8 else "B5": Call(b5, [out], len(pools))}


def flash_calls(dev, b, s, hq, hkv, d):
    """{"B1"|"B2"|"B3": Call} at one causal training shape."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    q, k, v, do = (randn(b, s, hq, d), randn(b, s, hkv, d),
                   randn(b, s, hkv, d), randn(b, s, hq, d))
    o, dq, dk, dv = (torch.empty_like(t) for t in (q, q, k, v))
    # lse: B1's of these inputs once B1 has run (main runs it first).
    lse = torch.zeros(b, hq, s, device=dev)
    delta = torch.randn(b, hq, s, generator=gen, device=dev) * 0.1
    dims = (b, s, s, hq, hkv, d, 1, 0, d ** -0.5)

    def call(fn, tensors, outputs):
        def run(libs, _turn):
            err = getattr(libs["flash_attention"], fn)(
                *[t.data_ptr() for t in tensors], *dims, _stream())
            assert err == 0, err
        return Call(run, outputs)

    return {
        "B1": call("lumina_flash_fwd", (q, k, v, o, lse), [o, lse]),
        "B2": call("lumina_flash_bwd_dq", (q, k, v, do, lse, delta, dq),
                   [dq]),
        "B3": call("lumina_flash_bwd_dkv",
                   (q, k, v, do, lse, delta, dk, dv), [dk, dv]),
    }


def gmm_calls(dev, rows, k, n, sizes, transposed=True):
    """{"B4a"|"B4a_t"|"B4b": Call} at one grouped-matmul shape."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(3)
    e = len(sizes)
    lhs = torch.randn(rows, k, generator=gen, device=dev).bfloat16()
    dout = torch.randn(rows, n, generator=gen, device=dev).bfloat16()
    w = (torch.randn(e, k, n, generator=gen, device=dev) * 0.02).bfloat16()
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    out, out_t = (torch.empty(rows, c, dtype=torch.bfloat16, device=dev)
                  for c in (n, k))
    drhs = torch.empty(e, k, n, dtype=torch.bfloat16, device=dev)

    def call(fn, tensors, dims, flag):
        def run(libs, _turn):
            err = getattr(libs["gmm"], fn)(
                *[t.data_ptr() for t in tensors], *dims, flag, _stream())
            assert err == 0, err
        return Call(run, [tensors[-1]])

    calls = {"B4a": call("lumina_gmm", (lhs, w, gs, out),
                         (rows, k, n, e), 0)}
    if transposed:
        # dout [rows, n] @ w[g]^T -> [rows, k]: the reduction runs over n.
        calls["B4a_t"] = call("lumina_gmm", (dout, w, gs, out_t),
                              (rows, n, k, e), 1)
        calls["B4b"] = call("lumina_tgmm", (lhs, dout, gs, drhs),
                            (rows, k, n, e), 0)
    return calls


def _medians(rows: dict) -> dict:
    return {tag: round(statistics.median(v), 5) for tag, v in rows.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="another checkout (e.g. the parent commit)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cases", default="b1_decode,b1_decode_int8,b1_train,"
                    "flagship_train,debug200m_train,b14_group5_train,"
                    "debug300m_train,d256_train,gmm_train_wi,gmm_train_wo,"
                    "gmm_serve_wi",
                    help="comma-separated subset of the cases to time")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("bisect_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    from luminaai_tpu_torch.ops._timing import cuda_ms, graph_ms

    trees = {"parent": build(args.parent.resolve(), "parent"),
             "this": build(ROOT, "this")}
    for tag in trees:
        log = (_build_dir() / f"{tag}-flash_attention.log").read_text()
        for line in log.splitlines():
            if "flash_" in line or "registers" in line or "spill" in line:
                print(f"ptxas [{tag}] {line.strip()}")
    dev = torch.device("cuda", 0)
    makers = {
        "b1_decode": (lambda: decode_calls(dev), 200),
        "b1_decode_int8": (lambda: decode_calls(dev, int8=True), 200),
        "b1_train": (lambda: flash_calls(dev, 2, 2048, 16, 4, 128), 30),
        "flagship_train": (lambda: flash_calls(dev, 16, 2048, 16, 8, 64),
                           20),
        "debug200m_train": (lambda: flash_calls(dev, 8, 2048, 12, 4, 64),
                            20),
        "b14_group5_train": (lambda: flash_calls(dev, 1, 4096, 40, 8, 128),
                             20),
        "debug300m_train": (lambda: flash_calls(dev, 16, 1024, 4, 2, 192),
                            20),
        "d256_train": (lambda: flash_calls(dev, 1, 2048, 8, 2, 256), 20),
        "gmm_train_wi": (lambda: gmm_calls(dev, *GMM_TRAIN_WI), 20),
        "gmm_train_wo": (lambda: gmm_calls(dev, *GMM_TRAIN_WO), 20),
        "gmm_serve_wi": (lambda: gmm_calls(dev, *GMM_SERVE_WI,
                                           transposed=False), 200),
    }
    results, diffs, graphs = {}, {}, {}
    for case in args.cases.split(","):
        make, iters = makers[case]
        calls = make()
        for kern, call in calls.items():
            key = f"{case}/{kern}"
            # Both trees on the same inputs (B1 first, so that B2 and B3
            # read its lse): the largest difference of their outputs. Then
            # parent/this alternate, the order flipping by round.
            outs = {}
            for tag in trees:
                call(trees[tag], turn=0)
                torch.cuda.synchronize()
                outs[tag] = [t.clone() for t in call.outputs]
            diffs[key] = max(
                (a.float() - b.float()).abs().max().item()
                for a, b in zip(outs["parent"], outs["this"]))
            del outs
            rows = results.setdefault(key, {"parent": [], "this": []})
            for rnd in range(args.rounds):
                order = ("parent", "this") if rnd % 2 == 0 else (
                    "this", "parent")
                for tag in order:
                    rows[tag].append(cuda_ms(lambda: call(trees[tag]),
                                             iters))
            if call.copies > 1:  # decode: host time between launches shows
                g = graphs.setdefault(key, {"parent": [], "this": []})
                for rnd in range(args.rounds):
                    order = ("parent", "this") if rnd % 2 == 0 else (
                        "this", "parent")
                    for tag in order:
                        g[tag].append(graph_ms(lambda: call(trees[tag]),
                                               8 * call.copies))
            line = f"{key}: ms median {_medians(rows)}"
            if key in graphs:
                line += f", graph {_medians(graphs[key])}"
            print(f"{line}, max |parent - this| {diffs[key]:.3e}", flush=True)
        del calls
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "ms": results, "graph_ms": graphs,
                      "max_abs_diff": diffs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
