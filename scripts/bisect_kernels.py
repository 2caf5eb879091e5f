#!/usr/bin/env python3
"""Time the port's kernels from two source trees side by side.

    python scripts/bisect_kernels.py --parent DIR [--rounds 2]
        [--cases b1_decode,b1_train,flagship_train,gmm_train_wi,...]

DIR holds another checkout of the repository (for example the parent
commit, unpacked with `git archive`). The script builds
`luminaai_tpu_torch/csrc/{ragged_paged_attention,flash_attention,gmm}.cu`
from DIR and from this checkout with the port's nvcc flags, loads both
through ctypes (the C interfaces are the same in both trees), and times on
one card, in turns (parent, this, this, parent, ...), on the same inputs:

- B5 at the b1 decode shape (8 lanes, Hq 16, Hkv 4, head_dim 128, lengths
  1-2048 in 128-row pages; each call reads the next of 4 K/V pools, past
  the 50 MB L2);
- B1, B2, B3 at the b1 dense training micro-batch (q [2, 2048, 16, 128],
  k/v [2, 2048, 4, 128], causal) and at the flagship MoE training shape
  (q [16, 2048, 16, 64], k/v [16, 2048, 8, 64], causal);
- B4a (gmm, and with transpose_rhs) and B4b (tgmm) at the flagship MoE
  wi shape (65,536 rows, 65,100 kept over 8 experts, K 1024, N 5632) and
  wo shape (K 2816, N 1024), and B4a at the b1 decode wi shape (16 pair rows over 7 of 8 experts in a
  128-row buffer, K 2048, N 11008).

It prints the card's name and power limit, then one JSON object with the
CUDA-event ms of every kernel, tree and round. It needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import math
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


def build(tree: Path, tag: str) -> dict:
    """{source: loaded library} built from tree's csrc/ into this
    checkout's git-ignored _kernels/bisect/."""
    from luminaai_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "bisect"
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
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tag} {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out / f"{tag}-{name}.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    f = libs["ragged_paged_attention"].lumina_ragged_paged_attention
    f.argtypes, f.restype = [p] * 6 + [i] * 8 + [ctypes.c_float, p], i
    for fn, n_ptrs in (("lumina_flash_fwd", 5), ("lumina_flash_bwd_dq", 7),
                       ("lumina_flash_bwd_dkv", 8)):
        f = getattr(libs["flash_attention"], fn)
        f.argtypes = [p] * n_ptrs + [i] * 8 + [ctypes.c_float, p]
        f.restype = i
    for fn in ("lumina_gmm", "lumina_tgmm"):
        f = getattr(libs["gmm"], fn)
        f.argtypes, f.restype = [p] * 4 + [i] * 5 + [p], i
    return libs


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def decode_calls(dev, stream):
    """{"B5": call(libs)} at the b1 decode shape."""
    import torch

    lanes, hq, hkv, d, page, pages = 8, 16, 4, 128, 128, 16
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(lanes, 1, hq, d, generator=gen, device=dev).bfloat16()
    pools = [tuple(torch.randn(lanes, page * pages, hkv, d, generator=gen,
                               device=dev).bfloat16() for _ in range(2))
             for _ in range(4)]
    lengths = torch.tensor([1, 127, 128, 129, 700, 1500, 2047, 2048],
                           dtype=torch.int32, device=dev)
    table = (torch.arange(lanes, dtype=torch.int32, device=dev)[:, None]
             * pages + torch.arange(pages, dtype=torch.int32, device=dev))
    table = table.contiguous()
    out = torch.empty_like(q)
    turn = itertools.count()

    def b5(libs):
        k, v = pools[next(turn) % len(pools)]
        err = libs["ragged_paged_attention"].lumina_ragged_paged_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), lanes, hq, hkv, d, page,
            pages, lanes * pages, 0, 1 / math.sqrt(d), stream)
        assert err == 0, err

    return {"B5": b5}


def flash_calls(dev, stream, b, s, hq, hkv, d):
    """{"B1"|"B2"|"B3": call(libs)} at one causal training shape."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    q, k, v, do = (randn(b, s, hq, d), randn(b, s, hkv, d),
                   randn(b, s, hkv, d), randn(b, s, hq, d))
    o, dq, dk, dv = (torch.empty_like(t) for t in (q, q, k, v))
    lse = torch.zeros(b, hq, s, device=dev)
    delta = torch.zeros(b, hq, s, device=dev)
    dims = (b, s, s, hq, hkv, d, 1, 0, d ** -0.5, stream)

    def call(fn, tensors):
        def run(libs):
            err = getattr(libs["flash_attention"], fn)(
                *[t.data_ptr() for t in tensors], *dims)
            assert err == 0, err
        return run

    return {
        "B1": call("lumina_flash_fwd", (q, k, v, o, lse)),
        "B2": call("lumina_flash_bwd_dq", (q, k, v, do, lse, delta, dq)),
        "B3": call("lumina_flash_bwd_dkv",
                   (q, k, v, do, lse, delta, dk, dv)),
    }


def gmm_calls(dev, stream, rows, k, n, sizes, transposed=True):
    """{"B4a"|"B4a_t"|"B4b": call(libs)} at one grouped-matmul shape."""
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
        def run(libs):
            err = getattr(libs["gmm"], fn)(
                *[t.data_ptr() for t in tensors], *dims, flag, stream)
            assert err == 0, err
        return run

    calls = {"B4a": call("lumina_gmm", (lhs, w, gs, out),
                         (rows, k, n, e), 0)}
    if transposed:
        # dout [rows, n] @ w[g]^T -> [rows, k]: the reduction runs over n.
        calls["B4a_t"] = call("lumina_gmm", (dout, w, gs, out_t),
                              (rows, n, k, e), 1)
        calls["B4b"] = call("lumina_tgmm", (lhs, dout, gs, drhs),
                            (rows, k, n, e), 0)
    return calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="another checkout (e.g. the parent commit)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cases", default="b1_decode,b1_train,flagship_train,"
                    "gmm_train_wi,gmm_train_wo,gmm_serve_wi",
                    help="comma-separated subset of the cases to time")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("bisect_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    trees = {"parent": build(args.parent.resolve(), "parent"),
             "this": build(ROOT, "this")}
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    makers = {
        "b1_decode": (lambda: decode_calls(dev, stream), 200),
        "b1_train": (lambda: flash_calls(dev, stream, 2, 2048, 16, 4, 128),
                     30),
        "flagship_train": (lambda: flash_calls(dev, stream, 16, 2048, 16, 8,
                                               64), 20),
        "gmm_train_wi": (lambda: gmm_calls(dev, stream, *GMM_TRAIN_WI), 20),
        "gmm_train_wo": (lambda: gmm_calls(dev, stream, *GMM_TRAIN_WO), 20),
        "gmm_serve_wi": (lambda: gmm_calls(dev, stream, *GMM_SERVE_WI,
                                           transposed=False), 200),
    }
    cases = {name: (makers[name][0](), makers[name][1])
             for name in args.cases.split(",")}
    # The first launch of each library on these inputs primes it outside
    # the timings; then parent/this alternate, the order flipping by round.
    results = {}
    for case, (calls, iters) in cases.items():
        for kern, call in calls.items():
            rows = results.setdefault(f"{case}/{kern}",
                                      {"parent": [], "this": []})
            for tag in trees:
                call(trees[tag])
            for rnd in range(args.rounds):
                order = ("parent", "this") if rnd % 2 == 0 else (
                    "this", "parent")
                for tag in order:
                    rows[tag].append(cuda_ms(lambda: call(trees[tag]),
                                             iters))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
