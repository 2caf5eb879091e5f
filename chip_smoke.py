#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (luminaai_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. build   every CUDA kernel of the port from the checkout's sources
             (one nvcc per source, started together);
  2. kernels hold each kernel against its plain PyTorch version: the
             decode kernel (B5) at the serving shapes and at a group of
             16 q heads per kv head; the flash-attention forward and
             backward kernels (B1-B3) at the training shapes (causal), a
             window-512 case, a non-causal case, a GQA group of 1 at
             head_dim 64, and the shapes the JAX gate admits that the
             first kernels refused (head_dim 192, 320 and 512, S 200, a
             group of 3), and B1-B3 at the flagship MoE shape (head_dim
             64, q [16, 2048, 16, 64]); B5 also at head_dim 576 and at the
             split-KV kernel's share boundaries; the grouped matmul (B4a
             gmm with and without transpose_rhs, B4b tgmm) at the b1
             decode and flagship training shapes, with an empty group and
             a tail that must stay exactly zero, and at the flagship shape
             with 9 experts and with two of 8 groups empty; time kernel / plain /
             library call at every shape, and compute the least time the
             card could take and each kernel's share of it; log which CUDA
             kernel each flash call took (torch.profiler) and require the
             wgmma B2/B3 kernels at both training shapes;
  3. serve   the b1-width dense model (16 layers, hidden 2048, seeded
             weights) through the port's ContinuousScheduler +
             StepwiseDecoder behind its HTTP server: first-decode-step
             logits with the kernel vs the plain version, then concurrent
             POST /v1/generate requests; the kernel must have launched
             exactly decode steps x layers times;
  4. serve   b1 with its 8 experts (moe_dispatch="gmm", 4.6B parameters
     MoE     in bf16): first-decode-step logits with B4a vs the plain gmm,
             a profiled decode step, 8 concurrent requests with B4a
             launched exactly 2 x 16 x (decode steps + prefill forwards);
  5. train   the b1 dense widths through the port's Trainer (what `python
             -m luminaai_tpu_torch train --preset b1 --dense --synthetic`
             runs): batch 16 x 2048, accumulation 8, remat per block,
             seeded fp32 weights, TRAIN_STEPS optimizer steps on the
             synthetic batches. The first step's loss and grad norm with
             the kernels vs the plain attention; every loss and grad norm
             finite, the loss falling, and the kernels launched exactly
             B1 = 2 x 16 x 8 per step (forward and its recompute),
             B2 = B3 = 16 x 8 per step; step time, tokens/s, model-FLOPs
             share and the card's busy time of one profiled step;
  6. train   bench.py's flagship MoE widths (vocab 32768, hidden 1024, 10
     MoE     layers, 8 experts top-2) with gmm dispatch and bf16 RoPE:
             TRAIN_STEPS steps through Trainer, the first against the plain
             gmm (routing noise reseeded identically), exact launches per
             step B1 20, B2 = B3 10, B4a 60, B4b 20, a falling loss, step
             time, tokens/s, model-FLOPs share (active parameters), peak
             memory and the router metrics.
  7. runtime the training runtime through the port's CLI, in child
             processes (this script with --runtime-child, which runs the
             CLI's main and records each step), at the b1 dense widths
             (batch 8 x 2048, no accumulation): a JSONL text corpus
             written from a seed and packed through a TokenCache with the
             native packer; run A `train --data --packed --steps 6`
             (exit 0); run B the same, SIGTERM once its log shows step 2
             (exit 75, emergency checkpoint committed at its step
             boundary); `resume` of B to step 6 (exit 0). Every step's
             packed batch and loss of B equal A's bitwise, and so do the
             final parameters (hashes of both checkpoints); B1 == 32 and
             B2 == B3 == 16 launches per step; the native packer ran;
             csrc/ holds no atomics. Then `serve --checkpoint A` (the
             CLI's engine builder): its first decode step's logits equal
             those of an engine built from run A's final in-memory
             weights bitwise, and 8 concurrent requests through the
             server launch B5 decode steps x 16 times. Step time,
             tokens/s, the goodput split, each save's and restore's
             seconds and GB, and the disk at the start; the runs and
             checkpoints are deleted at the end. (The CLI's `train` runs
             under the adaptive orchestrator: at b1's health-check
             interval no decision fires in 6 steps, and the summaries
             carry `adaptive_decisions` (empty) and `trajectory`.)
  8. adaptive the flagship MoE of phase 6 trained in-process under
             AdaptiveTrainingOrchestrator(trainer).run() from phase 7's
             corpus, packed: one decision of each MoE-path kind injected
             through the orchestrator's _execute at fixed steps (LR x 0.5,
             weight decay x 2, clip, temperature, capacity, expert dropout
             0.1 then 0, curriculum 0.6, add_expert 8 -> 9, prune of the
             least-loaded expert 9 -> 8, rollback to the prune's forced
             save, two more steps). Each decision applied, no
             "intervention ... failed" record, exact B1-B4 launches and a
             finite loss in every step, the LR override holding; the steps
             after expert dropout, add, prune and the rollback against the
             same step through the plain gmm; the optimizer count equal to
             the step after each evolution; the rolled-back parameters
             bitwise those of the forced save. Steady and post-
             intervention step times, E over the run, saves and restore,
             the goodput split, the decisions.

Earlier train phases write their checkpoints under chip_smoke_runs/ too,
and the directory is removed when the script ends.

Output: progress lines, the card's `nvidia-smi` name and power limit, one
{"kernels": [...]} JSON line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or without the luminaai_tpu_torch package beside
this file, it exits non-zero and prints no result. It imports nothing of
JAX and nothing of the luminaai_tpu package.
"""

from __future__ import annotations

import gc
import hashlib
import itertools
import json
import math
import re
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# Serving slice shapes (the b1 preset: 16 q heads over 4 kv heads,
# head_dim 128) and the pool the server runs (8 slots, 128-row pages).
LANES, HQ, HKV, D, PAGE, PAGES = 8, 16, 4, 128, 128, 16
# Training slice: micro-batch 2 x 2048 tokens at the same heads.
MICRO, SEQ = 2, 2048
TRAIN_STEPS = 6
# Flash kernels vs plain versions, bf16 outputs (O, dQ, dK, dV): within
# 2e-2 x max|plain|. bf16 keeps 8 significant bits; both sides round P
# and dS to bf16, but the kernel rounds P against a running 64-column
# maximum and the plain version against the row's maximum, and the fp32
# sums run in other orders. lse is fp32 on both sides from the same fp32
# scores: within 1e-4 absolute.
FLASH_REL_TOL = 2e-2
LSE_TOL = 1e-4
# First optimizer step, flash kernels vs the plain attention (which rounds
# the scores to bf16 before its fp32 softmax, as the JAX _xla_attention
# does, where the kernels keep fp32 scores): the mean loss within 1e-2
# relative (the loss at a random init is ~ln(V) and moves little with the
# attention's rounding), the pre-clip grad norm within 5e-2 relative (the
# gradients run back through 16 bf16 layers of that rounding).
LOSS_RTOL = 1e-2
GRAD_NORM_RTOL = 5e-2
# Kernel vs plain version, bf16: bf16 keeps 8 significant bits; the kernel
# keeps fp32 scores and rounds the unnormalised P to bf16, the plain
# version rounds the scores and the normalised P, so outputs (|out| <=
# max|v| ~ 4.5) differ by a few bf16 ulps.
KERNEL_TOL = 3e-2
# First-decode-step logits, kernel vs plain attention through 16 bf16
# layers: the attention difference above enters every layer's bf16
# residual stream, so logits move by a few bf16 ulps (2^-8 relative) of
# their largest magnitude. Tolerance: 1e-2 x max|logit| (2.56 ulps).
LOGIT_RTOL = 1e-2
COPIES = 4  # K/V pools the kernel timing rotates through (past the L2)
# Flash shapes the JAX gate admits that the first kernels refused:
# name: (B, S, Hq, Hkv, D, causal, window).
REPAIRED_FLASH = {
    "d192_g2_s1024": (2, 1024, 4, 2, 192, True, 0),
    "s200": (MICRO, 200, HQ, HKV, D, True, 0),
    "group3": (MICRO, 1024, 12, 4, D, True, 0),
    # Above head_dim 256 (the 64-column slice kernels).
    "d320_s256": (1, 256, 4, 2, 320, True, 0),
    "d512_window64": (1, 256, 4, 1, 512, True, 64),
}
# B1 at the flagship MoE training shape (bench.py's widths: 16 q over 8 kv
# heads, head_dim 64, micro-batch 16 x 2048): (B, S, Hq, Hkv, D).
FLAGSHIP_ATTN = (16, 2048, 16, 8, 64)
# B5 above head_dim 512 (512-column output slices): Hq 8 over Hkv 2.
WIDE_DECODE = (8, 2, 576)
# Rounds whose median is the library's time where single rounds differ by
# more than 2x from run to run (SDPA's backward on an H100).
LIB_ROUNDS = 5
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12    # dense bf16 tensor-core peak
# Training runs and checkpoints (git-ignored; removed when the script ends).
RUN_DIR = Path(__file__).resolve().parent / "chip_smoke_runs"


def _release() -> None:
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


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


def kernel_names(fn) -> list:
    """The CUDA kernels one call of fn launches, as torch.profiler (CUPTI)
    names them: [] when the profiler records no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def _short(name: str) -> str:
    """A kernel's name without its namespace and parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].replace("void ", "").strip()


def phase_build() -> None:
    from luminaai_tpu_torch.ops import _build

    secs = _build.build_all()
    log(f"build: {len(_build.SOURCES)} source(s) in {secs:.1f}s")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


def phase_kernels(dev) -> dict:
    """Kernel vs plain version at the slice's shapes; timings and bound."""
    import torch
    import torch.nn.functional as F

    from luminaai_tpu_torch.ops import ragged_paged_attention as rpa

    C = PAGES * PAGE
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(
            *shape, generator=gen, device=dev
        ).to(torch.bfloat16)

    q = randn(LANES, 1, HQ, D)
    k = randn(LANES, C, HKV, D)
    v = randn(LANES, C, HKV, D)
    # Mixed residency: one row, a page boundary from both sides, partial
    # pages, and a full slot.
    lengths = torch.tensor(
        [1, 127, 128, 129, 700, 1500, 2047, 2048], dtype=torch.int32,
        device=dev,
    )
    ident = torch.arange(PAGES, dtype=torch.int32, device=dev).expand(
        LANES, PAGES
    ).contiguous()
    perm = torch.randperm(LANES * PAGES, generator=gen, device=dev)
    cases = {
        "identity": rpa.LaneMeta(lengths=lengths, page_table=ident,
                                 page_size=PAGE),
        "window512": rpa.LaneMeta(lengths=lengths, page_table=ident,
                                  page_size=PAGE, window=512),
        # Lengths on both sides of a 64-row tile and of the shares of the
        # split-KV kernel's blocks.
        "shares": rpa.LaneMeta(
            lengths=torch.tensor([1, 63, 64, 65, 255, 256, 257, 2048],
                                 dtype=torch.int32, device=dev),
            page_table=ident, page_size=PAGE),
        "global": rpa.LaneMeta(
            lengths=lengths,
            page_table=perm.view(LANES, PAGES).to(torch.int32),
            page_size=PAGE, identity_pages=False, global_pages=True,
        ),
    }
    errs = {}
    for name, meta in cases.items():
        out = rpa.ragged_paged_attention(q, k, v, meta)
        want = rpa.ragged_paged_attention_ref(q, k, v, meta)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"kernel output not finite ({name})")
        errs[name] = (out.float() - want.float()).abs().max().item()
        log(f"kernel vs plain [{name}]: max_abs_err={errs[name]:.3e} "
            f"(tol {KERNEL_TOL})")
        if errs[name] > KERNEL_TOL:
            raise AssertionError(f"kernel disagrees with plain ({name})")

    # Any group (repaired in this slice; the JAX gate admits any): 16 q
    # heads over one kv head, held against the plain version and timed.
    q16, k16, v16 = randn(LANES, 1, 16, D), randn(LANES, C, 1, D), randn(
        LANES, C, 1, D)
    meta16 = cases["identity"]
    out = rpa.ragged_paged_attention(q16, k16, v16, meta16)
    want = rpa.ragged_paged_attention_ref(q16, k16, v16, meta16)
    torch.cuda.synchronize()
    errs["group16"] = (out.float() - want.float()).abs().max().item()
    lane_mask = (torch.arange(C, device=dev)[None, :]
                 < lengths[:, None].long())[:, None, None, :]
    g16 = {
        "max_abs_err": errs["group16"],
        "ms": cuda_ms(lambda: rpa.ragged_paged_attention(q16, k16, v16,
                                                         meta16), 100),
        "plain_ms": cuda_ms(lambda: rpa.ragged_paged_attention_ref(
            q16, k16, v16, meta16), 10),
        # Library yardstick: SDPA over the same K/V with the length mask.
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q16.transpose(1, 2), k16.transpose(1, 2), v16.transpose(1, 2),
            attn_mask=lane_mask, enable_gqa=True), 50),
        "shapes": {"lanes": LANES, "hq": 16, "hkv": 1, "head_dim": D},
    }
    log(f"kernel vs plain [group16: Hq 16 over Hkv 1]: max_abs_err="
        f"{errs['group16']:.3e} (tol {KERNEL_TOL}); kernel {g16['ms']:.4f} "
        f"ms, plain {g16['plain_ms']:.4f} ms, library (SDPA) "
        f"{g16['library_ms']:.4f} ms")
    if not torch.isfinite(out).all() or errs["group16"] > KERNEL_TOL:
        raise AssertionError("kernel disagrees with plain (group16)")
    del q16, k16, v16, out, want

    # head_dim above 512 (repaired in this slice: the gate admits any
    # multiple of 64), held against the plain version and timed.
    hq_w, hkv_w, d_w = WIDE_DECODE
    qw, kw, vw = (randn(LANES, 1, hq_w, d_w), randn(LANES, C, hkv_w, d_w),
                  randn(LANES, C, hkv_w, d_w))
    out = rpa.ragged_paged_attention(qw, kw, vw, meta16)
    want = rpa.ragged_paged_attention_ref(qw, kw, vw, meta16)
    torch.cuda.synchronize()
    errs["d576"] = (out.float() - want.float()).abs().max().item()
    wide = {
        "max_abs_err": errs["d576"],
        "ms": cuda_ms(lambda: rpa.ragged_paged_attention(qw, kw, vw, meta16),
                      50),
        "plain_ms": cuda_ms(lambda: rpa.ragged_paged_attention_ref(
            qw, kw, vw, meta16), 10),
        "shapes": {"lanes": LANES, "hq": hq_w, "hkv": hkv_w, "head_dim": d_w},
    }
    log(f"kernel vs plain [d{d_w}: Hq {hq_w} over Hkv {hkv_w}]: max_abs_err="
        f"{errs['d576']:.3e} (tol {KERNEL_TOL}); kernel {wide['ms']:.4f} ms, "
        f"plain {wide['plain_ms']:.4f} ms")
    if not torch.isfinite(out).all() or errs["d576"] > KERNEL_TOL:
        raise AssertionError(f"kernel disagrees with plain (d{d_w})")
    del qw, kw, vw, out, want

    # Timing. One K/V pool here is 33.5 MB, under the H100's 50 MB L2, and
    # the serving caller reads each layer's pool once per step, cold: so
    # each timed call reads the next of COPIES pools (134 MB together).
    meta = cases["identity"]
    pools = [(k, v)] + [(k.clone(), v.clone()) for _ in range(COPIES - 1)]

    def rotating(fn):
        turn = itertools.count()
        return lambda: fn(*pools[next(turn) % COPIES])

    kernel_ms = cuda_ms(rotating(
        lambda kk, vv: rpa.ragged_paged_attention(q, kk, vv, meta)), 200)
    plain_ms = cuda_ms(rotating(
        lambda kk, vv: rpa.ragged_paged_attention_ref(q, kk, vv, meta)), 20)

    # Library yardstick (never called by the port): SDPA over the same K/V,
    # [B, H, S, D] views with a per-lane length mask.
    qs = q.transpose(1, 2)
    mask = (torch.arange(C, device=dev)[None, :] < lengths[:, None].long())
    mask = mask[:, None, None, :]

    def library(kk, vv):
        return F.scaled_dot_product_attention(
            qs, kk.transpose(1, 2), vv.transpose(1, 2), attn_mask=mask,
            enable_gqa=True,
        )

    library_ms = cuda_ms(rotating(library), 50)
    lib_err = (library(k, v).transpose(1, 2).float()
               - rpa.ragged_paged_attention_ref(q, k, v, meta).float()
               ).abs().max().item()
    del pools

    resident = int(lengths.sum().item())
    bytes_moved = (
        resident * HKV * D * 2 * 2           # K and V rows, bf16
        + 2 * LANES * HQ * D * 2             # q in, out
        + LANES * PAGES * 4 + LANES * 4      # table, lengths
    )
    flops = 4 * resident * HQ * D            # QK^T and PV
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    log(f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"(SDPA) {library_ms:.4f} ms (max diff to plain {lib_err:.3e}), "
        f"bound {max(t_bytes, t_ops):.4f} ms "
        f"({bytes_moved / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    return {
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "luminaai_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "luminaai_tpu/ops/ragged_paged_attention.py:227",
        "tpu_kernel": "_decode_kernel",
        "launches": None,  # filled from the serving run
        "max_abs_err": max(errs.values()),
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
        "shapes": {"lanes": LANES, "hq": HQ, "hkv": HKV, "head_dim": D,
                   "page_size": PAGE, "pages": PAGES,
                   "lengths": [int(x) for x in lengths.tolist()]},
        "repaired": {"group16": g16, f"d{WIDE_DECODE[2]}": wide},
    }


def _band_pairs(s: int, causal: bool, window: int) -> int:
    """(q, k) pairs inside the attention band of one (batch, head)."""
    if not causal:
        return s * s
    return sum(q - (max(0, q - window + 1) if window else 0) + 1
               for q in range(s))


def phase_flash_kernels(dev) -> list:
    """B1-B3 vs their plain versions (bf16) at the training shapes and
    three variants; timings, library yardstick and bound at the training
    shapes."""
    import torch
    import torch.nn.functional as F

    from luminaai_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    def inputs(b, s, hq, hkv, d):
        q, k, v, do = (randn(*shape) for shape in (
            (b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d)))
        g_lse = torch.randn(b, hq, s, generator=gen, device=dev)
        return q, k, v, do, g_lse

    def rel(got, want):
        return ((got.float() - want.float()).abs().max()
                / want.float().abs().max()).item()

    cases = {
        # name: (B, S, Hq, Hkv, D, causal, window)
        "train": (MICRO, SEQ, HQ, HKV, D, True, 0),
        "window512": (MICRO, SEQ, HQ, HKV, D, True, 512),
        "noncausal": (1, 1024, HQ, HKV, D, False, 0),
        "group1_d64": (MICRO, 1024, 8, 8, 64, True, 0),
        # Shapes the JAX gate admits that the first kernels refused
        # (repaired in this slice, timed below): debug_300m's attention
        # (head_dim 192, 4 q heads over 2 kv heads, S 1024), a length that
        # is not a multiple of 128, and a group of 3.
        **REPAIRED_FLASH,
    }
    abs_err = {"B1": 0.0, "B2": 0.0, "B3": 0.0}
    repaired, routes = {}, {}
    for name, (b, s, hq, hkv, d, causal, window) in cases.items():
        q, k, v, do, g_lse = inputs(b, s, hq, hkv, d)
        args = dict(scale=d ** -0.5, causal=causal, window=window)
        o, lse = fa.flash_fwd(q, k, v, **args)
        o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, **args)
        delta = ((do.float() * o_ref.float()).sum(-1).transpose(1, 2)
                 - g_lse).contiguous()
        dq = fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, **args)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, **args)
        dq_ref = fa.flash_bwd_dq_ref(q, k, v, do, lse_ref, delta, **args)
        dk_ref, dv_ref = fa.flash_bwd_dkv_ref(q, k, v, do, lse_ref, delta,
                                              **args)
        torch.cuda.synchronize()
        taken = {kern: [_short(n) for n in kernel_names(call)] for kern, call
                 in (("B1", lambda: fa.flash_fwd(q, k, v, **args)),
                     ("B2", lambda: fa.flash_bwd_dq(
                         q, k, v, do, lse_ref, delta, **args)),
                     ("B3", lambda: fa.flash_bwd_dkv(
                         q, k, v, do, lse_ref, delta, **args)))}
        routes[name] = taken
        log(f"  kernels taken [{name}]: " + "; ".join(
            f"{kern} {', '.join(n) or 'not measured'}"
            for kern, n in taken.items()))
        pairs = {"o": (o, o_ref), "dq": (dq, dq_ref), "dk": (dk, dk_ref),
                 "dv": (dv, dv_ref)}
        for t, _ in pairs.values():
            if not torch.isfinite(t.float()).all():
                raise AssertionError(f"flash kernel output not finite "
                                     f"({name})")
        errs = {key: rel(a, b_) for key, (a, b_) in pairs.items()}
        lse_err = (lse - lse_ref).abs().max().item()
        for kern, keys in (("B1", ("o",)), ("B2", ("dq",)),
                           ("B3", ("dk", "dv"))):
            for key in keys:
                a, b_ = pairs[key]
                abs_err[kern] = max(abs_err[kern], (
                    a.float() - b_.float()).abs().max().item())
        log(f"flash kernels vs plain [{name}: B{b} S{s} Hq{hq} Hkv{hkv} "
            f"D{d}{' causal' if causal else ''}"
            f"{f' window {window}' if window else ''}]: rel err "
            + ", ".join(f"{key} {e:.3e}" for key, e in errs.items())
            + f"; lse abs err {lse_err:.3e} (tol {FLASH_REL_TOL} x max, "
            f"lse {LSE_TOL})")
        if max(errs.values()) > FLASH_REL_TOL or lse_err > LSE_TOL:
            raise AssertionError(f"flash kernels disagree with plain "
                                 f"({name})")
        if name in REPAIRED_FLASH:
            t = {
                "B1": cuda_ms(lambda: fa.flash_fwd(q, k, v, **args), 20),
                "B2": cuda_ms(lambda: fa.flash_bwd_dq(
                    q, k, v, do, lse_ref, delta, **args), 20),
                "B3": cuda_ms(lambda: fa.flash_bwd_dkv(
                    q, k, v, do, lse_ref, delta, **args), 20),
            }
            repaired[name] = {"ms": t, "rel_err": errs,
                              "shape": [b, s, hq, hkv, d]}
            log(f"  repaired shape {name}: B1 {t['B1']:.4f} ms, B2 "
                f"{t['B2']:.4f} ms, B3 {t['B3']:.4f} ms")
        del o, o_ref, dq, dq_ref, dk, dk_ref, dv, dv_ref, pairs
        torch.cuda.empty_cache()

    # Timing at the training shapes (causal, no window).
    b, s, hq, hkv, d = MICRO, SEQ, HQ, HKV, D
    q, k, v, do, _ = inputs(b, s, hq, hkv, d)
    args = dict(scale=d ** -0.5, causal=True, window=0)
    o, lse = fa.flash_fwd_ref(q, k, v, **args)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    ms = {
        "B1": cuda_ms(lambda: fa.flash_fwd(q, k, v, **args), 50),
        "B2": cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta,
                                              **args), 50),
        "B3": cuda_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                               **args), 50),
    }
    plain_ms = {
        "B1": cuda_ms(lambda: fa.flash_fwd_ref(q, k, v, **args), 5, 1),
        "B2": cuda_ms(lambda: fa.flash_bwd_dq_ref(q, k, v, do, lse, delta,
                                                  **args), 5, 1),
        "B3": cuda_ms(lambda: fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta,
                                                   **args), 5, 1),
    }
    # Library yardstick (never called by the port): SDPA forward, and its
    # backward (dQ, dK and dV in one call) for B2 and B3 together.
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    with torch.no_grad():
        lib_fwd = cuda_ms(sdpa, 50)
    out = sdpa()
    # Single rounds of the backward have read 0.29 and 0.79 ms at this
    # shape: the median of LIB_ROUNDS rounds.
    lib_bwd_rounds = [cuda_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), 20)
        for _ in range(LIB_ROUNDS)]
    lib_bwd = statistics.median(lib_bwd_rounds)
    log(f"SDPA backward, {LIB_ROUNDS} rounds (ms): "
        + ", ".join(f"{x:.4f}" for x in lib_bwd_rounds))
    lib_err = (out.detach().transpose(1, 2).float() - o.float()
               ).abs().max().item()
    del out, qt, kt, vt, dot

    pairs = b * hq * _band_pairs(s, True, 0)
    act = b * s * hq * d * 2         # q, o, do or dq, bf16
    kv = b * s * hkv * d * 2         # k or v, bf16
    stat = b * hq * s * 4            # lse or delta, fp32
    work = {  # (flops, bytes): each input read once, each output written once
        "B1": (4 * d * pairs, act + 2 * kv + act + stat),
        "B2": (6 * d * pairs, 2 * act + 2 * kv + 2 * stat + act),
        "B3": (8 * d * pairs, 2 * act + 2 * kv + 2 * stat + 2 * kv),
    }
    meta = {
        "B1": ("flash_fwd", "luminaai_tpu/ops/flash_attention.py:99",
               "_fwd_kernel", lib_fwd),
        "B2": ("flash_bwd_dq", "luminaai_tpu/ops/flash_attention.py:205",
               "_bwd_dq_kernel", lib_bwd),
        "B3": ("flash_bwd_dkv", "luminaai_tpu/ops/flash_attention.py:248",
               "_bwd_dkv_kernel", lib_bwd),
    }
    entries = []
    for kern, (name, replaces, tpu_kernel, lib_ms) in meta.items():
        flops, nbytes = work[kern]
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_BF16_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        log(f"{kern} {name}: kernel {ms[kern]:.4f} ms, plain "
            f"{plain_ms[kern]:.4f} ms, library (SDPA "
            f"{'fwd' if kern == 'B1' else 'bwd'}) {lib_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} "
            f"MB; {100 * bound / ms[kern]:.1f}% of bound)")
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "luminaai_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces,
            "tpu_kernel": tpu_kernel,
            "launches": None,  # filled from the training run
            "max_abs_err": abs_err[kern],
            "ms": ms[kern],
            "plain_ms": plain_ms[kern],
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
            "library_rounds_ms": None if kern == "B1" else lib_bwd_rounds,
            "shapes": {"batch": b, "seq": s, "hq": hq, "hkv": hkv,
                       "head_dim": d, "causal": True},
            "repaired": {name: {"ms": r["ms"][kern], "shape": r["shape"]}
                         for name, r in repaired.items()},
            "kernels_taken": {case: r[kern] for case, r in routes.items()},
        })
    log(f"SDPA forward vs plain B1 output: max abs diff {lib_err:.3e}")
    del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()
    _require_wgmma_backward(routes["train"], "the b1 training shape")
    flagship = _flash_flagship(inputs, rel)
    for e, kern in zip(entries, ("B1", "B2", "B3")):
        e["flagship_d64"] = flagship[kern]
        e["max_abs_err"] = max(e["max_abs_err"], flagship[kern]["max_abs_err"])
    return entries


def _require_wgmma_backward(taken: dict, where: str) -> None:
    """B2 and B3 took the wgmma kernels (when the profiler saw them)."""
    for kern, want in (("B2", "flash_bwd_dq_wgmma_kernel"),
                       ("B3", "flash_bwd_dkv_wgmma_kernel")):
        if taken[kern] and not all(want in n for n in taken[kern]):
            raise AssertionError(f"{kern} did not take {want} at {where}: "
                                 f"{taken[kern]}")


def _flash_flagship(inputs, rel) -> dict:
    """B1-B3 at the flagship MoE training shape (q [16, 2048, 16, 64], k/v
    [16, 2048, 8, 64], causal): each against its plain version, then
    kernel / plain / SDPA (forward for B1, backward for B2 and B3, the
    median of LIB_ROUNDS rounds) ms and the bound. -> {kernel: entry}."""
    import torch
    import torch.nn.functional as F

    from luminaai_tpu_torch.ops import flash_attention as fa

    b, s, hq, hkv, d = FLAGSHIP_ATTN
    q, k, v, do, g_lse = inputs(b, s, hq, hkv, d)
    args = dict(scale=d ** -0.5, causal=True, window=0)
    o, lse = fa.flash_fwd(q, k, v, **args)
    o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, **args)
    delta = ((do.float() * o_ref.float()).sum(-1).transpose(1, 2)
             - g_lse).contiguous()
    got = {"B1": [o], "B2": [fa.flash_bwd_dq(q, k, v, do, lse_ref, delta,
                                             **args)],
           "B3": list(fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, **args))}
    torch.cuda.synchronize()
    lse_err = (lse - lse_ref).abs().max().item()
    del o, lse
    want = {"B1": [o_ref],
            "B2": [fa.flash_bwd_dq_ref(q, k, v, do, lse_ref, delta, **args)]}
    torch.cuda.empty_cache()
    want["B3"] = list(fa.flash_bwd_dkv_ref(q, k, v, do, lse_ref, delta,
                                           **args))
    torch.cuda.synchronize()
    errs, abs_err = {}, {}
    for kern in got:
        errs[kern] = max(rel(a, w) for a, w in zip(got[kern], want[kern]))
        abs_err[kern] = max((a.float() - w.float()).abs().max().item()
                            for a, w in zip(got[kern], want[kern]))
    del got, want, o_ref
    torch.cuda.empty_cache()
    log(f"B1-B3 vs plain [flagship: B{b} S{s} Hq{hq} Hkv{hkv} D{d} causal]: "
        f"rel err " + ", ".join(f"{kern} {e:.3e}" for kern, e in errs.items())
        + f"; lse abs err {lse_err:.3e} (tol {FLASH_REL_TOL} x max, lse "
        f"{LSE_TOL})")
    if max(errs.values()) > FLASH_REL_TOL or not lse_err <= LSE_TOL:
        raise AssertionError("flash kernels disagree with plain (flagship)")
    calls = {
        "B1": (lambda: fa.flash_fwd(q, k, v, **args),
               lambda: fa.flash_fwd_ref(q, k, v, **args)),
        "B2": (lambda: fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, **args),
               lambda: fa.flash_bwd_dq_ref(q, k, v, do, lse_ref, delta,
                                           **args)),
        "B3": (lambda: fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, **args),
               lambda: fa.flash_bwd_dkv_ref(q, k, v, do, lse_ref, delta,
                                            **args)),
    }
    taken = {kern: [_short(n) for n in kernel_names(kc)]
             for kern, (kc, _) in calls.items()}
    log("  kernels taken [flagship]: " + "; ".join(
        f"{kern} {', '.join(n) or 'not measured'}" for kern, n in
        taken.items()))
    _require_wgmma_backward(taken, "the flagship shape")
    ms, plain_ms = {}, {}
    for kern, (kc, pc) in calls.items():
        ms[kern] = cuda_ms(kc, 20)
        plain_ms[kern] = cuda_ms(pc, 2, 1)
        torch.cuda.empty_cache()
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    with torch.no_grad():
        lib_fwd = cuda_ms(sdpa, 20)
    out = sdpa()
    lib_bwd_rounds = [cuda_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), 10)
        for _ in range(LIB_ROUNDS)]
    lib_bwd = statistics.median(lib_bwd_rounds)
    log(f"SDPA backward at the flagship shape, {LIB_ROUNDS} rounds (ms): "
        + ", ".join(f"{x:.4f}" for x in lib_bwd_rounds))
    del out, qt, kt, vt, dot

    pairs = b * hq * _band_pairs(s, True, 0)
    act, kv, stat = b * s * hq * d * 2, b * s * hkv * d * 2, b * hq * s * 4
    work = {  # (flops, bytes): each input read once, each output written once
        "B1": (4 * d * pairs, act + 2 * kv + act + stat),
        "B2": (6 * d * pairs, 2 * act + 2 * kv + 2 * stat + act),
        "B3": (8 * d * pairs, 2 * act + 2 * kv + 2 * stat + 2 * kv),
    }
    out = {}
    for kern, (flops, nbytes) in work.items():
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_BF16_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        lib_ms = lib_fwd if kern == "B1" else lib_bwd
        log(f"{kern} at the flagship shape: kernel {ms[kern]:.4f} ms, plain "
            f"{plain_ms[kern]:.4f} ms, library (SDPA "
            f"{'fwd' if kern == 'B1' else 'bwd'}) {lib_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB; "
            f"{100 * bound / ms[kern]:.1f}% of bound)")
        out[kern] = {
            "ms": ms[kern], "plain_ms": plain_ms[kern], "library_ms": lib_ms,
            "library_rounds_ms": None if kern == "B1" else lib_bwd_rounds,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": abs_err[kern], "rel_err": errs[kern],
            "kernels_taken": taken[kern], "shape": [b, s, hq, hkv, d]}
    out["B1"]["lse_err"] = lse_err
    del q, k, v, do, lse_ref, delta
    torch.cuda.empty_cache()
    return out


# The port's kernels by family, as torch.profiler names them.
KERNEL_FAMILIES = {"B1-B3": "flash_", "B4": "grouped_kernel",
                   "B5": "ragged_decode_kernel"}


def _families(kernels, busy_ms: float) -> dict:
    """{family: [ms, share of busy]} over (name, ms, count) rows."""
    out = {}
    for fam, key in KERNEL_FAMILIES.items():
        ms = sum(t for name, t, _ in kernels if key in name)
        if ms > 0:
            out[fam] = [ms, ms / busy_ms]
    log("  port kernels: " + ", ".join(
        f"{fam} {ms:.3f} ms ({100 * share:.1f}% of busy)"
        for fam, (ms, share) in out.items()))
    return out


def profile_decode(dec, steps: int = 5) -> None:
    """Where one decode step's time goes: host wall per step (synchronised,
    no profiler), then the card's busy time per step and its largest
    kernels from torch.profiler (CUPTI). Prints "not measured" when the
    profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    dec.step_logits()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        dec.step_logits()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            dec.step_logits()
        torch.cuda.synchronize()
    kernels = [
        (e.key, e.self_device_time_total / 1e3 / steps, e.count // steps)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
    ]
    busy_ms = sum(ms for _, ms, _ in kernels)
    if busy_ms <= 0:
        log(f"decode step: host wall {wall_ms:.3f} ms; device time not "
            "measured (the profiler recorded no device events)")
        return
    kernels.sort(key=lambda r: -r[1])
    log(f"decode step (8 lanes): host wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
        f"{sum(n for _, _, n in kernels)} kernel launches")
    for name, ms, n in kernels[:8]:
        log(f"  {ms:8.4f} ms  x{n:<4d} {name[:90]}")
    _families(kernels, busy_ms)


PROMPT_LENGTHS = (10, 40, 64, 65, 150, 300, 450, 600)


def _prompt(n: int, i: int) -> str:
    words = "the quick brown fox jumps over the lazy dog while serving "
    text = (f"request {i}: " + words * (n // len(words) + 1))[:n]
    return text


def _filled_decoder(engine):
    """A decoder of its own (LANES slots) holding the PROMPT_LENGTHS
    prompts, each prefilled whole or in chunks as the decoder chooses."""
    dec = engine.make_stepwise(num_slots=LANES, page_size=PAGE)
    for i, n in enumerate(PROMPT_LENGTHS):
        p = engine.tokenizer.encode_text(_prompt(n, i))
        slot = dec.acquire_slot()
        st = dec.start_prefill(slot, p, max_new_tokens=32)
        if st is None:
            dec.prefill_into_slot(slot, p, max_new_tokens=32)
        else:
            while dec.advance_prefill(st) is None:
                pass
    return dec


def _serve_burst(engine, label: str, health_ok, reset, read):
    """LANES concurrent greedy POST /v1/generate requests (prompts of
    PROMPT_LENGTHS characters, 32 new tokens each) through the port's
    ChatServer. `reset()` sets the launch counters to 0 just before the
    burst, `read()` reads them just after. -> (launches, summary)."""
    from luminaai_tpu_torch.serving.server import ChatServer

    cfg = engine.config
    server = ChatServer(engine, num_slots=LANES, page_size=PAGE)
    httpd = server.make_httpd("127.0.0.1", 0)
    host, port = httpd.server_address[:2]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://{host}:{port}"

    def post(body):
        req = urllib.request.Request(
            url + "/v1/generate", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())

    try:
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            health = json.loads(r.read())
        if r.status != 200 or not health_ok(health["model"]):
            raise AssertionError(f"bad /health: {health}")
        post({"prompt": "warm up", "max_new_tokens": 2, "temperature": 0})
        dec = server.batcher.decoder
        steps0, pf0 = dec.steps, dec.prefill_forwards
        dsec0 = server.batcher.decode_seconds
        bodies = [{"prompt": _prompt(n, i), "max_new_tokens": 32,
                   "temperature": 0}
                  for i, n in enumerate(PROMPT_LENGTHS)]
        reset()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(bodies)) as pool:
            replies = list(pool.map(post, bodies))
        wall = time.perf_counter() - t0
        launches = read()
        steps, prefills = dec.steps - steps0, dec.prefill_forwards - pf0
        dsec = server.batcher.decode_seconds - dsec0
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()

    tokens = 0
    for (code, body), n in zip(replies, PROMPT_LENGTHS):
        if code != 200 or not body.get("token_ids"):
            raise AssertionError(f"bad {label} reply for a {n}-char prompt: "
                                 f"{body}")
        if not all(0 <= t < cfg.vocab_size for t in body["token_ids"]):
            raise AssertionError("token id outside the vocabulary")
        tokens += body["tokens"]
    if steps <= 0:
        raise AssertionError(f"{label}: no decode step ran")
    lat = sorted(body["latency_s"] for _, body in replies)
    log(f"{label}: {len(replies)} concurrent requests (prompts "
        f"{min(PROMPT_LENGTHS)}-{max(PROMPT_LENGTHS)} tokens), {tokens} "
        f"tokens in {wall:.3f}s = {tokens / wall:.1f} tok/s; {steps} decode "
        f"steps, {1e3 * dsec / steps:.3f} ms/step, {prefills} prefill "
        f"forwards; peak lanes {stats['max_batch_seen']}; latency median "
        f"{statistics.median(lat):.3f}s, max {lat[-1]:.3f}s")
    return launches, {"requests": len(replies), "tokens": tokens,
                      "wall_s": wall, "decode_steps": steps,
                      "prefill_forwards": prefills,
                      "decode_step_ms": 1e3 * dsec / steps,
                      "tokens_per_s": tokens / wall, "latency_max_s": lat[-1]}


def phase_serve(dev, entry: dict) -> dict:
    import torch

    from luminaai_tpu_torch.config import ConfigPresets
    from luminaai_tpu_torch.inference.chat import build_engine
    from luminaai_tpu_torch.ops import ragged_paged_attention as rpa

    cfg = ConfigPresets.get("b1", use_moe=False)
    t0 = time.perf_counter()
    engine = build_engine(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in engine.model.parameters())
    log(f"engine: b1 dense, {cfg.num_layers} layers, hidden "
        f"{cfg.hidden_size}, {n_params / 1e6:.1f}M params, built in "
        f"{time.perf_counter() - t0:.1f}s")

    # First decode step of the same prompts through a decoder of its own:
    # kernel attention vs plain attention on the same pool state.
    dec = _filled_decoder(engine)
    lk = dec.step_logits()
    lp = dec.step_logits("plain")
    torch.cuda.synchronize()
    if lk.shape != (LANES, cfg.vocab_size) or not torch.isfinite(lk).all():
        raise AssertionError(f"bad decode logits {tuple(lk.shape)}")
    logit_err = (lk - lp).abs().max().item()
    logit_tol = LOGIT_RTOL * lp.abs().max().item()
    agree = int((lk.argmax(-1) == lp.argmax(-1)).sum().item())
    log(f"first decode step logits, kernel vs plain: max_abs_err="
        f"{logit_err:.3e} (tol {logit_tol:.3e} = {LOGIT_RTOL} x max|logit|"
        f"), argmax agree {agree}/{LANES}")
    if logit_err > logit_tol:
        raise AssertionError("decode logits disagree with the plain version")
    profile_decode(dec)
    del dec, lk, lp
    torch.cuda.empty_cache()

    def reset():
        rpa.ragged_paged_attention.launches = 0

    launches, summary = _serve_burst(
        engine, "serve",
        lambda model: model["hidden_size"] == cfg.hidden_size, reset,
        lambda: rpa.ragged_paged_attention.launches)
    want = summary["decode_steps"] * cfg.num_layers
    log(f"kernel launches during serving: {launches} (decode steps x "
        f"layers = {want})")
    if launches != want:
        raise AssertionError("the decode path did not run through the kernel")
    entry["launches"] = launches
    return summary


def _model_flops_per_step(cfg, n_params: int) -> float:
    """Model FLOPs of one optimizer step (no recompute counted): 3 x the
    forward's 2 x (matmul parameters) per token, with the tied head's
    V x H counted once for the head and the embedding lookup free, plus
    3 x 4 x D flops per attended (q, k) pair per layer and q head."""
    tokens = cfg.batch_size * cfg.seq_length
    # Norm scales are not matmul parameters: two per layer and the final.
    matmul_params = n_params - cfg.hidden_size * (2 * cfg.num_layers + 1)
    pairs = (cfg.batch_size * cfg.num_heads
             * _band_pairs(cfg.seq_length, True, cfg.attention_window or 0))
    return 3 * (2 * matmul_params * tokens
                + 4 * cfg.head_dim() * pairs * cfg.num_layers)


def profile_train_step(trainer, batch) -> dict:
    """Card busy time and top kernels of one optimizer step, from
    torch.profiler (CUPTI); "not measured" when it records no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.state, _ = trainer.train_step(trainer.state, batch)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
    ]
    busy_ms = sum(ms for _, ms, _ in kernels)
    if busy_ms <= 0:
        log(f"profiled train step: host wall {wall_ms:.1f} ms; device time "
            "not measured (the profiler recorded no device events)")
        return {"profiled_wall_ms": wall_ms, "device_busy_ms": None}
    kernels.sort(key=lambda r: -r[1])
    log(f"profiled train step (under the profiler): host wall "
        f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), "
        f"{sum(n for _, _, n in kernels)} kernel launches")
    for name, ms, n in kernels[:10]:
        log(f"  {ms:9.3f} ms  x{n:<5d} {name[:90]}")
    flash = [[_short(name), ms, n] for name, ms, n in kernels
             if "flash_" in name]
    log("  flash kernels taken: " + ", ".join(
        f"{name} x{n} {ms:.3f} ms" for name, ms, n in flash))
    _require_wgmma_backward(
        {"B2": [n for n, _, _ in flash if "bwd_dq" in n],
         "B3": [n for n, _, _ in flash if "bwd_dkv" in n]}, "a train step")
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "port_kernels": _families(kernels, busy_ms),
            "flash_kernels": flash,
            "top_kernels": [[name[:90], ms, n]
                            for name, ms, n in kernels[:10]]}


def phase_train(dev, entries: list) -> dict:
    import torch

    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.config import ConfigPresets
    from luminaai_tpu_torch.ops import flash_attention as fa
    from luminaai_tpu_torch.ops.fused import global_norm
    from luminaai_tpu_torch.parallel import train_step as ts
    from luminaai_tpu_torch.training.trainer import Trainer

    cfg = ConfigPresets.get("b1", use_moe=False, max_steps=TRAIN_STEPS,
                            output_dir=str(RUN_DIR / "train_dense"))
    accum = cfg.gradient_accumulation_steps
    t0 = time.perf_counter()
    trainer = Trainer(cfg, cli._synthetic_batches(cfg), device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in trainer.state.params)
    log(f"trainer: b1 dense, {cfg.num_layers} layers, hidden "
        f"{cfg.hidden_size}, {n_params / 1e6:.1f}M fp32 params, batch "
        f"{cfg.batch_size} x {cfg.seq_length}, accumulation {accum}, "
        f"remat {cfg.remat_policy}, built in {time.perf_counter() - t0:.1f}s")

    # The first step's batch through the plain attention (no kernel), for
    # the comparison with the trainer's first step below.
    first = trainer._to_device(next(iter(cli._synthetic_batches(cfg)())))
    cfg.use_flash_attention = False
    grads, m = ts._accumulate_grads(
        ts.make_loss_fn(cfg, trainer.model), trainer.state.params, first,
        None, accum)
    plain_loss, plain_norm = float(m["loss"]), float(global_norm(grads))
    cfg.use_flash_attention = True
    del grads, m
    torch.cuda.empty_cache()

    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    summary = trainer.train()
    launches = {"B1": fa.flash_fwd.launches, "B2": fa.flash_bwd_dq.launches,
                "B3": fa.flash_bwd_dkv.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    hist = summary["history"]
    for i, h in enumerate(hist, 1):
        log(f"  step {i}: loss {h['loss']:.4f} grad_norm "
            f"{h['grad_norm']:.4f} lr {h['learning_rate']:.3e} "
            f"{h['step_seconds'] * 1e3:.1f} ms "
            f"{h['tokens_per_sec']:.0f} tok/s")
    losses, norms = _check_run(hist, plain_loss, plain_norm,
                               "plain attention")
    per_step = cfg.num_layers * accum
    want = {"B1": 2 * per_step * TRAIN_STEPS, "B2": per_step * TRAIN_STEPS,
            "B3": per_step * TRAIN_STEPS}
    log(f"flash kernel launches during training: {launches} (want {want}: "
        f"{cfg.num_layers} layers x {accum} micro-batches x {TRAIN_STEPS} "
        f"steps, B1 twice for the remat recompute)")
    if launches != want:
        raise AssertionError("the training path did not run through the "
                             "flash kernels as expected")
    for e, kern in zip(entries, ("B1", "B2", "B3")):
        e["launches"] = launches[kern]
        e["launches_per_step"] = launches[kern] // TRAIN_STEPS

    steady = _steady_step(cfg, hist, n_params, "train step", "")
    log(f"  peak memory allocated {peak_gb:.2f} GB")
    prof = profile_train_step(trainer, first)
    trainer.close()
    return {"steps": TRAIN_STEPS, "losses": losses, "grad_norms": norms,
            **steady, "peak_memory_gb": peak_gb,
            "first_step_loss_plain": plain_loss,
            "first_step_grad_norm_plain": plain_norm, **prof}


def _check_run(hist, plain_loss: float, plain_norm: float, what: str):
    """TRAIN_STEPS finite losses and grad norms, a falling loss, and the
    first step within LOSS_RTOL / GRAD_NORM_RTOL of its re-run through
    `what`. -> (losses, grad norms)."""
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    if len(hist) != TRAIN_STEPS or not all(
            map(math.isfinite, losses + norms)):
        raise AssertionError(f"bad training run: {losses} {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    loss_err = abs(hist[0]["loss"] - plain_loss) / abs(plain_loss)
    norm_err = abs(hist[0]["grad_norm"] - plain_norm) / abs(plain_norm)
    log(f"first step, kernels vs {what}: loss {hist[0]['loss']:.5f} vs "
        f"{plain_loss:.5f} (rel {loss_err:.2e}, tol {LOSS_RTOL}), grad_norm "
        f"{hist[0]['grad_norm']:.5f} vs {plain_norm:.5f} (rel "
        f"{norm_err:.2e}, tol {GRAD_NORM_RTOL})")
    if loss_err > LOSS_RTOL or norm_err > GRAD_NORM_RTOL:
        raise AssertionError(f"the kernels' first step disagrees with the "
                             f"{what}'s")
    return losses, norms


def _steady_step(cfg, hist, n_params: int, label: str, note: str) -> dict:
    """Median host wall of steps 2..TRAIN_STEPS, tokens/s and the
    model-FLOPs share of H100_BF16_FLOPS (n_params: the matmul parameters
    a token runs through)."""
    step_s = statistics.median(h["step_seconds"] for h in hist[1:])
    tokens = cfg.batch_size * cfg.seq_length
    flops = _model_flops_per_step(cfg, n_params)
    mfu = flops / step_s / H100_BF16_FLOPS
    log(f"{label} (steps 2-{TRAIN_STEPS}, median): host wall "
        f"{step_s * 1e3:.1f} ms, {tokens / step_s:.0f} tokens/s, model "
        f"FLOPs{note} {flops / 1e12:.2f} TFLOP/step = {100 * mfu:.2f}% of "
        f"989 TFLOP/s")
    return {"step_ms_median": step_s * 1e3, "tokens_per_s": tokens / step_s,
            "mfu": mfu}


# ---------------------------------------------------------------------------
# The MoE slice: B4 (gmm, tgmm), b1 served with its experts, the bench
# flagship trained.
# ---------------------------------------------------------------------------
# Serving: b1 (hidden 2048, 8 experts of intermediate 5504); a decode step
# at 8 lanes routes 16 (token, expert) pairs into one 128-row buffer.
# Training: bench.py's flagship widths (hidden 1024, 8 experts of 2816); a
# micro-batch of 16 x 2048 tokens is 65,536 pair rows.
GMM_CASES = {
    # name: (rows, K, N, group sizes); the decode case leaves one expert
    # untouched and a 112-row tail, the training case a 436-row tail.
    "serve_wi": (128, 2048, 2 * 5504, [2, 3, 1, 0, 4, 2, 3, 1]),
    "serve_wo": (128, 5504, 2048, [2, 3, 1, 0, 4, 2, 3, 1]),
    "train_wi": (65536, 1024, 2 * 2816,
                 [9000, 8100, 7900, 8200, 8300, 7700, 8050, 7850]),
    "train_wo": (65536, 2816, 1024,
                 [9000, 8100, 7900, 8200, 8300, 7700, 8050, 7850]),
    "train_empty": (4096, 1024, 2 * 2816,
                    [1200, 0, 900, 700, 0, 600, 300, 100]),
    # The adaptive phase's expert counts at the flagship training shape:
    # 9 experts after add_expert, and 8 with two whole experts dropped
    # (expert dropout empties their groups).
    "train_e9_wi": (65536, 1024, 2 * 2816,
                    [7300, 7100, 6900, 7200, 7400, 6800, 7250, 6950, 7000]),
    "train_e9_wo": (65536, 2816, 1024,
                    [7300, 7100, 6900, 7200, 7400, 6800, 7250, 6950, 7000]),
    "train_e8_two_empty": (65536, 1024, 2 * 2816,
                           [10900, 0, 10800, 10700, 11000, 0, 10600,
                            10900]),
}
# B4 kernel vs plain version, bf16 outputs: within 1e-2 x max|plain|. Both
# accumulate in fp32 and round once to bf16 (2^-8 relative), the sums in
# other orders, so an element may land on the neighbouring bf16 value.
GMM_REL_TOL = 1e-2
# bench.py:129-146 (_child_config "flagship"), copied literally, and two
# of flagship_tuned's levers (bench.py:119-128); save_attn remat and bf16
# Adam moments are not ported (ROADMAP A6, A7), so the remat policy is
# nothing_saveable and the moments are fp32.
FLAGSHIP = dict(
    vocab_size=32768,
    hidden_size=1024,
    num_layers=10,
    num_heads=16,
    num_kv_heads=8,
    seq_length=2048,
    batch_size=16,
    use_moe=True,
    num_experts=8,
    moe_top_k=2,
    capacity_factor=1.25,
    load_balancing_weight=0.01,
    precision="bf16",
    use_flash_attention=True,
    gradient_checkpointing=True,
)
FLAGSHIP_LEVERS = dict(moe_dispatch="gmm", rope_dtype="bf16")


def _plain_gmm(lhs, rhs, group_sizes, out_dtype=None, transpose_rhs=False):
    """The plain grouped matmul (differentiable by autograd) in place of
    the kernel, for the re-runs the kernels' steps are held against."""
    from luminaai_tpu_torch.ops import gmm as tg

    return tg.gmm_ref(lhs, rhs, group_sizes, out_dtype, transpose_rhs)


def _grouped_mm(a, b, group_sizes):
    """One PyTorch call computing B4a (a [M, K], b [E, K, N]) or B4b (a =
    lhs^T [K, M], b = dout [M, N]) on the same operands:
    torch._grouped_mm, a yardstick only (the port never calls it). None
    where this torch lacks it or refuses the operands."""
    import torch

    offs = torch.cumsum(group_sizes, 0, dtype=torch.int32)

    def call():
        return torch._grouped_mm(a, b, offs=offs, out_dtype=torch.bfloat16)

    try:
        call()
        torch.cuda.synchronize()
    except (AttributeError, RuntimeError) as exc:
        log(f"  torch._grouped_mm unavailable: {str(exc).splitlines()[0]}")
        return None
    return call


def _gmm_bound(kept, touched, k, n, e, rows, tgmm=False):
    """(bound ms, bound_by, flops, bytes) of one B4 call: each input byte
    this run's data needs read once (the kept rows; the touched experts'
    weights), each output byte written once, 2 x kept x K x N flops."""
    flops = 2 * kept * k * n
    if tgmm:
        nbytes = kept * k * 2 + kept * n * 2 + e * k * n * 2 + e * 4
    else:
        nbytes = kept * k * 2 + touched * k * n * 2 + rows * n * 2 + e * 4
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", flops, nbytes)


def phase_gmm_kernels(dev) -> list:
    """B4a (gmm, and its transpose_rhs form) and B4b (tgmm) against their
    plain versions at the serving and training shapes; exact zeros in the
    tail and in empty groups; kernel / plain / library times and bounds."""
    import torch

    from luminaai_tpu_torch.ops import gmm as tg

    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    def rel(got, want):
        return ((got.float() - want.float()).abs().max()
                / want.float().abs().max()).item()

    cases, abs_err = {}, {"gmm": 0.0, "tgmm": 0.0}
    for name, (rows, k, n, sizes) in GMM_CASES.items():
        e, kept = len(sizes), sum(sizes)
        touched = sum(1 for x in sizes if x)
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
        lhs, dout = randn(rows, k), randn(rows, n)
        w = randn(e, k, n, scale=0.02)
        checks = {
            "gmm": (lambda: tg.gmm(lhs, w, gs),
                    lambda: tg.gmm_ref(lhs, w, gs)),
            "gmm_t": (lambda: tg.gmm(dout, w, gs, transpose_rhs=True),
                      lambda: tg.gmm_ref(dout, w, gs, transpose_rhs=True)),
            "tgmm": (lambda: tg.tgmm(lhs.t(), dout, gs),
                     lambda: tg.tgmm_ref(lhs.t(), dout, gs)),
        }
        errs = {}
        for key, (kern, plain) in checks.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"{key} output not finite ({name})")
            if key == "tgmm":
                errs[key] = rel(got, want)
                zero_ok = all(not got[g].any() for g, x in enumerate(sizes)
                              if x == 0)
            else:
                errs[key] = rel(got[:kept], want[:kept])
                zero_ok = not got[kept:].any()
            abs_err["tgmm" if key == "tgmm" else "gmm"] = max(
                abs_err["tgmm" if key == "tgmm" else "gmm"],
                (got.float() - want.float()).abs().max().item())
            if errs[key] > GMM_REL_TOL or not zero_ok:
                raise AssertionError(f"{key} disagrees with plain ({name}): "
                                     f"rel {errs[key]:.3e}, zeros {zero_ok}")
            del got, want
        # Per product: kernel ms, bound, and the library's one call on the
        # same operands (torch._grouped_mm; None where it refuses them).
        libs = {"gmm": _grouped_mm(lhs, w, gs),
                "gmm_t": _grouped_mm(dout, w.transpose(1, 2), gs),
                "tgmm": _grouped_mm(lhs.t(), dout, gs)}
        bounds = {"gmm": _gmm_bound(kept, touched, k, n, e, rows)[0],
                  "gmm_t": _gmm_bound(kept, touched, n, k, e, rows)[0],
                  "tgmm": _gmm_bound(kept, touched, k, n, e, rows,
                                     tgmm=True)[0]}
        case = {"rows": rows, "K": k, "N": n, "group_sizes": sizes,
                "rel_err": errs}
        for key, (kern, _) in checks.items():
            case[f"{key}_ms"] = cuda_ms(kern, 20)
            case[f"{key}_bound_ms"] = bounds[key]
            case[f"{key}_bound_share"] = bounds[key] / case[f"{key}_ms"]
            case[f"{key}_library_ms"] = (cuda_ms(libs[key], 20)
                                         if libs[key] else None)
        cases[name] = case
        log(f"B4 [{name}: rows {rows} K {k} N {n} kept {kept}, {touched}/{e}"
            f" experts]: rel err " + ", ".join(f"{a} {b:.2e}" for a, b in
                                               errs.items())
            + f" (tol {GMM_REL_TOL} x max)")
        for key in checks:
            lib_ms = case[f"{key}_library_ms"]
            log(f"  {key}: kernel {case[key + '_ms']:.4f} ms, bound "
                f"{case[key + '_bound_ms']:.4f} ms "
                f"({100 * case[key + '_bound_share']:.1f}% of bound), "
                f"library (torch._grouped_mm) "
                + (f"{lib_ms:.4f} ms" if lib_ms else "not measured"))
        del libs
        if name == "train_wi":
            headline = dict(rows=rows, k=k, n=n, e=e, kept=kept,
                            touched=touched, gs=gs, lhs=lhs, dout=dout, w=w,
                            sizes=sizes)
        else:
            del lhs, dout, w
        torch.cuda.empty_cache()

    # Headline numbers at the training wi shape: the largest B4 work on
    # the main path (forward, recompute and grad products).
    h = headline
    entries = []
    for kern in ("gmm", "tgmm"):
        if kern == "gmm":
            run = lambda: tg.gmm(h["lhs"], h["w"], h["gs"])  # noqa: E731
            plain = lambda: tg.gmm_ref(h["lhs"], h["w"], h["gs"])  # noqa
            lib = _grouped_mm(h["lhs"], h["w"], h["gs"])
        else:
            run = lambda: tg.tgmm(h["lhs"].t(), h["dout"], h["gs"])  # noqa
            plain = lambda: tg.tgmm_ref(h["lhs"].t(), h["dout"],  # noqa
                                        h["gs"])
            lib = _grouped_mm(h["lhs"].t(), h["dout"], h["gs"])
        ms = cuda_ms(run, 20)
        plain_ms = cuda_ms(plain, 3, 1)
        lib_ms = cuda_ms(lib, 20) if lib else None
        bound, bound_by, flops, nbytes = _gmm_bound(
            h["kept"], h["touched"], h["k"], h["n"], h["e"], h["rows"],
            tgmm=kern == "tgmm")
        log(f"B4{'a' if kern == 'gmm' else 'b'} {kern} at the training wi "
            f"shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"(torch._grouped_mm) {lib_ms} ms, bound {bound:.4f} ms "
            f"({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB; "
            f"{100 * bound / ms:.1f}% of bound)")
        entries.append({
            "name": kern,
            "route": "cuda",
            "source": "luminaai_tpu_torch/csrc/gmm.cu",
            "replaces": "luminaai_tpu/models/moe.py:806",
            "tpu_kernel": ("megablox gmm (gmm.py:314)" if kern == "gmm"
                           else "megablox tgmm (gmm.py:573)"),
            "launches": None,  # filled from the MoE serving and training
            "max_abs_err": abs_err[kern],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": bound_by,
            "library_ms": lib_ms,
            "library": "torch._grouped_mm",
            "shapes": {"rows": h["rows"], "K": h["k"], "N": h["n"],
                       "group_sizes": h["sizes"]},
            "cases": cases,
        })
    del headline, h
    torch.cuda.empty_cache()
    return entries


def phase_serve_moe(dev, rpa_entry: dict, gmm_entries: list) -> dict:
    """b1 with its 8 experts (moe_dispatch="gmm", seeded bf16 weights)
    behind the HTTP server: the first decode step's logits against a
    re-run through the plain gmm, one profiled decode step, then 8
    concurrent requests with B4a launched exactly 2 x 16 x (decode steps
    + prefill forwards) times."""
    import torch

    from luminaai_tpu_torch.config import ConfigPresets
    from luminaai_tpu_torch.inference.chat import build_engine
    from luminaai_tpu_torch.models import moe
    from luminaai_tpu_torch.ops import gmm as tg
    from luminaai_tpu_torch.ops import ragged_paged_attention as rpa

    cfg = ConfigPresets.get("b1", moe_dispatch="gmm")
    t0 = time.perf_counter()
    engine = build_engine(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in engine.model.parameters())
    n_moe = cfg.num_moe_layers()
    log(f"engine: b1 with experts ({cfg.num_experts} x top-"
        f"{cfg.moe_top_k}, cf {cfg.capacity_factor}, {n_moe} MoE layers, "
        f"gmm), {n_params / 1e9:.3f}B params "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated), built "
        f"in {time.perf_counter() - t0:.1f}s")

    dec = _filled_decoder(engine)
    # Top-2 routing is discontinuous: the kernel and the plain version
    # round each expert output to bf16 after sums in other orders, so a
    # near-tied second choice may flip between the two runs and move that
    # lane's FFN output by O(1). Record each MoE layer's expert choices in
    # both runs: lanes routed alike in every layer are held to the dense
    # decode tolerance, lanes with a flip are counted and reported.
    routes, real_routing = [], moe.sort_routing

    def recording(probs, top_k, capacity):
        out = real_routing(probs, top_k, capacity)
        routes.append(torch.sort(out[0] // capacity, dim=-1).values)
        return out

    n0 = tg.gmm.launches
    moe.sort_routing = recording
    try:
        lk = dec.step_logits()
        if tg.gmm.launches - n0 != 2 * n_moe:
            raise AssertionError("a decode step did not run B4a twice per "
                                 "MoE layer")
        kernel_routes, routes = routes, []
        moe.GMM_OVERRIDE = _plain_gmm
        lp = dec.step_logits()
    finally:
        moe.GMM_OVERRIDE = None
        moe.sort_routing = real_routing
    torch.cuda.synchronize()
    if lk.shape != (LANES, cfg.vocab_size) or not torch.isfinite(lk).all():
        raise AssertionError(f"bad MoE decode logits {tuple(lk.shape)}")
    same = torch.stack([(a == b).flatten(1).all(1) for a, b in
                        zip(kernel_routes, routes)]).all(0)  # [lanes]
    n_same = int(same.sum().item())
    logit_tol = LOGIT_RTOL * lp.abs().max().item()
    all_err = (lk - lp).abs().max().item()
    logit_err = (lk - lp)[same].abs().max().item() if n_same else math.inf
    agree = int((lk.argmax(-1) == lp.argmax(-1))[same].sum().item())
    log(f"MoE first decode step logits, B4a vs plain gmm: {n_same}/{LANES} "
        f"lanes routed alike in all {n_moe} MoE layers; on those max_abs_err"
        f"={logit_err:.3e} (tol {logit_tol:.3e} = {LOGIT_RTOL} x "
        f"max|logit|), argmax agree {agree}/{n_same}; all lanes max_abs_err"
        f"={all_err:.3e}, argmax agree "
        f"{int((lk.argmax(-1) == lp.argmax(-1)).sum().item())}/{LANES}")
    if not n_same or logit_err > logit_tol or agree != n_same:
        raise AssertionError("MoE decode logits disagree with the plain gmm")
    profile_decode(dec)
    del dec, lk, lp
    torch.cuda.empty_cache()

    def reset():
        tg.reset_launches()
        rpa.ragged_paged_attention.launches = 0

    launches, summary = _serve_burst(
        engine, "MoE serve", lambda model: model["moe"], reset,
        lambda: {"B4a": tg.gmm.launches, "B4b": tg.tgmm.launches,
                 "B5": rpa.ragged_paged_attention.launches})
    steps = summary["decode_steps"]
    want = {"B4a": 2 * n_moe * (steps + summary["prefill_forwards"]),
            "B4b": 0, "B5": steps * cfg.num_layers}
    log(f"kernel launches while serving with experts: {launches} (want "
        f"{want}: B4a 2 x {n_moe} MoE layers x (decode steps + prefill "
        f"forwards), B5 decode steps x layers)")
    if launches != want:
        raise AssertionError("MoE serving did not run through the kernels "
                             "as expected")
    gmm_entries[0]["launches"] = (gmm_entries[0]["launches"] or 0) + (
        launches["B4a"])
    gmm_entries[0]["launches_serve"] = launches["B4a"]
    rpa_entry["launches"] = (rpa_entry["launches"] or 0) + launches["B5"]
    rpa_entry["launches_serve_moe"] = launches["B5"]
    del engine
    return {**summary, "first_step_logit_err": logit_err,
            "first_step_lanes_routed_alike": n_same}


def phase_train_moe(dev, flash_entries: list, gmm_entries: list) -> dict:
    """The bench flagship widths with experts trained TRAIN_STEPS steps
    through Trainer: the first step against the same step through the
    plain gmm (routing-noise generator reseeded identically), exact B1-B4
    launch counts, finite and falling losses, step time, tokens/s,
    model-FLOPs share (active parameters), peak memory, MoE metrics."""
    import torch

    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.models import moe
    from luminaai_tpu_torch.ops import flash_attention as fa
    from luminaai_tpu_torch.ops import gmm as tg
    from luminaai_tpu_torch.ops.fused import global_norm
    from luminaai_tpu_torch.parallel import train_step as ts
    from luminaai_tpu_torch.training.trainer import Trainer

    cfg = Config(**FLAGSHIP, **FLAGSHIP_LEVERS, max_steps=TRAIN_STEPS,
                 output_dir=str(RUN_DIR / "train_moe"))
    accum = cfg.gradient_accumulation_steps
    n_moe = cfg.num_moe_layers()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, cli._synthetic_batches(cfg), device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in trainer.state.params)
    expert_ffn = 3 * cfg.hidden_size * cfg.intermediate_size
    n_active = n_params - n_moe * (cfg.num_experts - cfg.moe_top_k) * (
        expert_ffn)
    log(f"trainer: flagship MoE (bench.py:129-146 + gmm, bf16 RoPE), "
        f"{cfg.num_layers} layers, hidden {cfg.hidden_size}, "
        f"{cfg.num_experts} experts x {cfg.intermediate_size}, "
        f"{n_params / 1e6:.1f}M params ({n_active / 1e6:.1f}M active), "
        f"batch {cfg.batch_size} x {cfg.seq_length}, accumulation {accum}, "
        f"remat {cfg.remat_policy}, built in {time.perf_counter() - t0:.1f}s")

    first = trainer._to_device(next(iter(cli._synthetic_batches(cfg)())))
    gen_state = trainer.state.generator.get_state()
    moe.GMM_OVERRIDE = _plain_gmm
    try:
        grads, m = ts._accumulate_grads(
            ts.make_loss_fn(cfg, trainer.model), trainer.state.params,
            first, trainer.state.generator, accum)
        plain_loss, plain_norm = float(m["loss"]), float(global_norm(grads))
    finally:
        moe.GMM_OVERRIDE = None
    trainer.state.generator.set_state(gen_state)
    del grads, m
    torch.cuda.empty_cache()

    fa.reset_launches()
    tg.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    summary = trainer.train()
    launches = {"B1": fa.flash_fwd.launches, "B2": fa.flash_bwd_dq.launches,
                "B3": fa.flash_bwd_dkv.launches, "B4a": tg.gmm.launches,
                "B4b": tg.tgmm.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    hist = summary["history"]
    for i, h in enumerate(hist, 1):
        log(f"  step {i}: loss {h['loss']:.4f} (aux {h['aux_loss']:.4f}) "
            f"grad_norm {h['grad_norm']:.4f} lr {h['learning_rate']:.3e} "
            f"drop {h['moe_drop_rate']:.4f} {h['step_seconds'] * 1e3:.1f} "
            f"ms {h['tokens_per_sec']:.0f} tok/s")
    losses, norms = _check_run(hist, plain_loss, plain_norm,
                               "MoE step through the plain gmm")
    L, n = cfg.num_layers, accum * TRAIN_STEPS
    want = {"B1": 2 * L * n, "B2": L * n, "B3": L * n,
            "B4a": 6 * n_moe * n, "B4b": 2 * n_moe * n}
    log(f"kernel launches during MoE training: {launches} (want {want}: per "
        f"layer and micro-batch B1 forward + recompute, B2, B3; per MoE "
        f"layer B4a 2 forward + 2 recompute + 2 grad_lhs, B4b 2 grad_rhs)")
    if launches != want:
        raise AssertionError("MoE training did not run through the kernels "
                             "as expected")
    for e, kern in zip(flash_entries, ("B1", "B2", "B3")):
        e["launches"] = (e["launches"] or 0) + launches[kern]
        e["launches_per_step_moe"] = launches[kern] // TRAIN_STEPS
    for e, kern in zip(gmm_entries, ("B4a", "B4b")):
        e["launches"] = (e["launches"] or 0) + launches[kern]
        e["launches_train"] = launches[kern]
        e["launches_per_step"] = launches[kern] // TRAIN_STEPS

    steady = _steady_step(cfg, hist, n_active, "MoE train step",
                          " (active params)")
    last = hist[-1]
    moe_metrics = {k: last[k] for k in last if k.startswith("moe_")
                   or k == "expert_utilization"}
    log(f"  peak memory allocated {peak_gb:.2f} GB; last step "
        f"{json.dumps(moe_metrics)}")
    prof = profile_train_step(trainer, first)
    trainer.close()
    del trainer
    return {"steps": TRAIN_STEPS, "losses": losses, "grad_norms": norms,
            **steady, "peak_memory_gb": peak_gb,
            "first_step_loss_plain": plain_loss,
            "first_step_grad_norm_plain": plain_norm,
            "params": n_params, "active_params": n_active,
            "moe_metrics": moe_metrics, **prof}


# ---------------------------------------------------------------------------
# The training runtime: train from a data file with checkpoints, preempt,
# resume exactly, serve the checkpoint.
# ---------------------------------------------------------------------------
RUNTIME_STEPS = 6
RUNTIME_BATCH = 8  # x 2048 tokens, no accumulation
PREEMPT_AFTER = 2  # SIGTERM once run B's log shows this step
CORPUS_DOCS = 1500  # ~3 MB of text, ~190 packed batches of 8 x 2048


def _write_corpus(path: Path, seed: int = 0) -> int:
    """A JSONL text corpus drawn from `seed`: documents of 50-700 words
    over a 2,000-word vocabulary of random lowercase words. Returns its
    size in bytes."""
    import numpy as np

    rng = np.random.RandomState(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = ["".join(rng.choice(letters, rng.randint(2, 11)))
             for _ in range(2000)]
    with open(path, "w") as f:
        for _ in range(CORPUS_DOCS):
            words = rng.choice(vocab, rng.randint(50, 700))
            f.write(json.dumps({"text": " ".join(words) + "."}) + "\n")
    return path.stat().st_size


def _tensor_digest(tree: dict) -> str:
    """sha256 over a flat {name: CPU tensor} tree, names in order."""
    import torch

    h = hashlib.sha256()
    for name in sorted(tree):
        t = tree[name].contiguous()
        h.update(name.encode() + b"\0" + str(t.dtype).encode())
        h.update(t.view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def runtime_child(argv: list) -> int:
    """Run the port's CLI main on `argv` (after `--`), recording for each
    optimizer step the sha256 of its input_ids, its loss and grad norm and
    the flash launches it made, and at the end the launch totals, the
    native data-path counts and the checkpoint saves and restores. With
    --logits PATH, also save the first decode step's logits of an engine
    built from the trainer's final in-memory weights."""
    sep = argv.index("--")
    opts, cli_argv = argv[:sep], argv[sep + 1:]
    record_path = Path(opts[0])
    logits_path = Path(opts[opts.index("--logits") + 1]) if (
        "--logits" in opts) else None
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np
    import torch

    from luminaai_tpu_torch import cli, native
    from luminaai_tpu_torch.ops import flash_attention as fa
    from luminaai_tpu_torch.training import trainer as tr

    out = record_path.open("w")
    held = {}
    orig_init = tr.Trainer.__init__

    def launches():
        return {"B1": fa.flash_fwd.launches, "B2": fa.flash_bwd_dq.launches,
                "B3": fa.flash_bwd_dkv.launches}

    def init(self, *a, **kw):
        orig_init(self, *a, **kw)
        held["trainer"] = self
        step = self.train_step

        def recording(state, batch):
            ids = batch["input_ids"].to(torch.int32).cpu().numpy()
            before = launches()
            state, metrics = step(state, batch)
            loss = float(metrics["loss"])
            after = launches()
            out.write(json.dumps({
                "step": state.step,
                "batch_sha256": hashlib.sha256(
                    np.ascontiguousarray(ids).tobytes()).hexdigest(),
                "loss": loss, "grad_norm": float(metrics["grad_norm"]),
                "launches": {k: after[k] - before[k] for k in after},
            }) + "\n")
            out.flush()
            return state, metrics

        self.train_step = recording

    tr.Trainer.__init__ = init
    fa.reset_launches()
    native.reset_path_counts()
    rc = cli.main(cli_argv)
    t = held.get("trainer")
    ck = t.checkpoints if t is not None else None
    out.write(json.dumps({
        "exit": rc, "launches": launches(), "native": native.path_counts(),
        "saves": ck.save_log if ck else [],
        "restores": ck.restore_log if ck else [],
    }) + "\n")
    out.flush()
    if logits_path is not None and rc == 0:
        from luminaai_tpu_torch.inference.chat import build_engine

        engine = build_engine(t.config, device=t.device, seed=0)
        engine.model.load_params(t.model.state_dict())
        torch.save(_filled_decoder(engine).step_logits().cpu(), logits_path)
    return rc


def _read_records(path: Path):
    lines = [json.loads(x) for x in path.read_text().splitlines() if x]
    return [r for r in lines if "batch_sha256" in r], (
        lines[-1] if lines and "exit" in lines[-1] else None)


def _run_child(args: list, log_path: Path, timeout: float = 900,
               preempt_after: int = 0):
    """This script as a runtime child; with preempt_after, SIGTERM once
    the log shows that step. -> (exit code, log text)."""
    cmd = [sys.executable, "-u", str(Path(__file__).resolve()),
           "--runtime-child", *args]
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                cwd=str(RUN_DIR))
        sent = False
        t0 = time.perf_counter()
        try:
            for line in proc.stdout:
                logf.write(line)
                m = re.search(r"step (\d+) loss=", line)
                if (preempt_after and not sent and m
                        and int(m.group(1)) >= preempt_after):
                    proc.send_signal(signal.SIGTERM)
                    sent = True
                    log(f"  SIGTERM sent after the log showed step "
                        f"{m.group(1)} ({time.perf_counter() - t0:.1f}s)")
                if time.perf_counter() - t0 > timeout:
                    raise TimeoutError(f"runtime child ran past {timeout}s")
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    text = log_path.read_text()
    if preempt_after and not sent:
        raise AssertionError("run B never logged step "
                             f"{preempt_after}:\n{text[-3000:]}")
    return rc, text


# The runtime phase's model: b1's widths without experts; per optimizer
# step (16 layers, one micro-batch) B1 runs the forward and its remat
# recompute.
RUNTIME_MODEL = ("--preset", "b1", "--dense", "--batch-size",
                 str(RUNTIME_BATCH), "--grad-accum", "1")
RUNTIME_LAUNCHES = {"B1": 2 * 16, "B2": 16, "B3": 16}


def phase_runtime(dev, rpa_entry: dict, flash_entries: list,
                  model_args=RUNTIME_MODEL, want=RUNTIME_LAUNCHES) -> dict:
    import torch

    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.ops import ragged_paged_attention as rpa
    from luminaai_tpu_torch.training import checkpoint as ck

    csrc = Path(__file__).resolve().parent / "luminaai_tpu_torch" / "csrc"
    atomics = [f"{p.name}:{i}" for p in sorted(csrc.iterdir())
               for i, line in enumerate(p.read_text().splitlines(), 1)
               if re.search(r"\batomic\w*\s*\(|\bred\.(global|shared)",
                            line.split("//")[0])]
    log(f"runtime: atomics in csrc/: {atomics or 'none'}")
    if atomics:
        raise AssertionError(f"csrc/ holds atomics: {atomics}")

    disk = shutil.disk_usage(RUN_DIR)
    log(f"runtime: disk at {RUN_DIR}: {disk.free / 1e9:.1f} GB free of "
        f"{disk.total / 1e9:.1f} GB ({disk.used / 1e9:.1f} GB used)")
    corpus = RUN_DIR / "corpus.jsonl"
    n_bytes = _write_corpus(corpus)
    log(f"runtime: corpus {corpus.name}: {CORPUS_DOCS} documents, "
        f"{n_bytes / 1e6:.2f} MB")

    def cli_args(out: str) -> list:
        return [*model_args, "--data", str(corpus), "--packed", "--steps",
                str(RUNTIME_STEPS), "--seed", "0", "--output-dir",
                str(RUN_DIR / out)]

    runs = {}
    t0 = time.perf_counter()
    rc, _ = _run_child([str(RUN_DIR / "a.jsonl"), "--logits",
                        str(RUN_DIR / "a_logits.pt"), "--", "train",
                        *cli_args("A")], RUN_DIR / "a.log")
    runs["A"] = (time.perf_counter() - t0, rc)
    if rc != 0:
        raise AssertionError(f"run A exited {rc}: "
                             f"{(RUN_DIR / 'a.log').read_text()[-3000:]}")
    t0 = time.perf_counter()
    rc, text = _run_child([str(RUN_DIR / "b.jsonl"), "--", "train",
                           *cli_args("B")], RUN_DIR / "b.log",
                          preempt_after=PREEMPT_AFTER)
    runs["B"] = (time.perf_counter() - t0, rc)
    if rc != 75:
        raise AssertionError(f"preempted run B exited {rc}, not 75: "
                             f"{text[-3000:]}")
    steps_b, _ = _read_records(RUN_DIR / "b.jsonl")
    k = len(steps_b)
    ckpt_b = RUN_DIR / "B" / "checkpoints"
    if ck.committed_steps(ckpt_b) != [k] or ck.verify_step_dir(
            ckpt_b / str(k))["status"] != "ok":
        raise AssertionError(f"run B stopped after step {k} without an "
                             f"intact emergency checkpoint there: "
                             f"{ck.committed_steps(ckpt_b)}")
    log(f"runtime: run B preempted at step {k}, exit 75, emergency "
        f"checkpoint {ckpt_b.name}/{k} verified")
    t0 = time.perf_counter()
    rc, text = _run_child([str(RUN_DIR / "r.jsonl"), "--", "resume",
                           *cli_args("B")], RUN_DIR / "r.log")
    runs["resume"] = (time.perf_counter() - t0, rc)
    if rc != 0:
        raise AssertionError(f"resume of B exited {rc}: {text[-3000:]}")

    steps_a, end_a = _read_records(RUN_DIR / "a.jsonl")
    steps_r, end_r = _read_records(RUN_DIR / "r.jsonl")
    _, end_b = _read_records(RUN_DIR / "b.jsonl")
    got = steps_b + steps_r
    for rec in steps_a:
        log(f"  A step {rec['step']}: loss {rec['loss']!r} grad_norm "
            f"{rec['grad_norm']!r} batch {rec['batch_sha256'][:12]} "
            f"launches {rec['launches']}")
    if len(steps_a) != RUNTIME_STEPS or [r["step"] for r in got] != list(
            range(1, RUNTIME_STEPS + 1)):
        raise AssertionError(f"steps: A {len(steps_a)}, B+resume "
                             f"{[r['step'] for r in got]}")
    for a, b in zip(steps_a, got):
        if (a["batch_sha256"], a["loss"], a["grad_norm"]) != (
                b["batch_sha256"], b["loss"], b["grad_norm"]):
            raise AssertionError(f"step {a['step']}: run A {a} vs the "
                                 f"preempted and resumed run {b}")
    losses = [r["loss"] for r in steps_a]
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"bad losses {losses}")
    log(f"runtime: the {RUNTIME_STEPS} batches and losses of B (steps "
        f"1-{k} before the preemption, {k + 1}-{RUNTIME_STEPS} after the "
        f"resume) equal run A's bitwise")

    bad = [r for r in steps_a + got if r["launches"] != want]
    if bad:
        raise AssertionError(f"flash launches per step {bad[0]['launches']}"
                             f" at step {bad[0]['step']}, want {want}")
    totals = {kern: sum(e["launches"][kern] for e in (end_a, end_b, end_r))
              for kern in want}
    log(f"runtime: flash launches per step {want} in every step of the "
        f"three runs; totals {totals}")
    for e, kern in zip(flash_entries, ("B1", "B2", "B3")):
        e["launches"] = (e["launches"] or 0) + totals[kern]
        e["launches_runtime"] = totals[kern]
    for name, end in (("A", end_a), ("B", end_b), ("resume", end_r)):
        nat = end["native"].get("pack_batch", {})
        if not nat.get("native") or nat.get("numpy"):
            raise AssertionError(f"run {name}: the packer did not run "
                                 f"natively: {end['native']}")
    log(f"runtime: native data path in all runs: {end_a['native']}")

    tree_a = ck.load_state_file(RUN_DIR / "A" / "checkpoints" /
                                str(RUNTIME_STEPS))
    tree_b = ck.load_state_file(ckpt_b / str(RUNTIME_STEPS))
    digest_a, digest_b = (_tensor_digest(tree_a["params"]),
                          _tensor_digest(tree_b["params"]))
    log(f"runtime: final parameters sha256 A {digest_a[:16]}, B "
        f"{digest_b[:16]}")
    if digest_a != digest_b:
        raise AssertionError("the resumed run's final parameters differ "
                             "from the uninterrupted run's")
    del tree_a, tree_b

    saves = [dict(s, run=n) for n, e in (("A", end_a), ("B", end_b),
                                         ("resume", end_r))
             for s in e["saves"]]
    restores = [dict(s, run="resume") for s in end_r["restores"]]
    for s in saves:
        log(f"  save ({s['run']}) step {s['step']}: {s['seconds']:.2f} s "
            f"({s['host_copy_seconds']:.2f} s host copy), "
            f"{s['bytes'] / 1e9:.2f} GB")
    for s in restores:
        log(f"  restore ({s['run']}) step {s['step']}: {s['seconds']:.2f} s"
            f", {s['bytes'] / 1e9:.2f} GB")
    summary_a = json.loads((RUN_DIR / "A" / "training_summary.json")
                           .read_text())
    summary_b = json.loads((RUN_DIR / "B" / "training_summary.json")
                           .read_text())
    for name, summ in (("A", summary_a), ("resume", summary_b)):
        # The CLI trains under the orchestrator; no decision fires in 6
        # steps at b1's health-check interval.
        if summ.get("adaptive_decisions") != [] or "trajectory" not in summ:
            raise AssertionError(f"run {name}'s summary lacks the "
                                 f"orchestrator's keys or decided: "
                                 f"{summ.get('adaptive_decisions')}")
    log("runtime: runs A and resume trained under the orchestrator "
        "(adaptive_decisions [], trajectory "
        f"{summary_a['trajectory']})")
    hist = summary_a["history"]
    step_s = statistics.median(h["step_seconds"] for h in hist[1:])
    cfg = json.loads(
        (RUN_DIR / "A" / "experiment_metadata.json").read_text())["config"]
    tokens = cfg["batch_size"] * cfg["seq_length"]
    gp = summary_a["goodput"]["seconds"]
    gp_r = summary_b["goodput"]["seconds"]

    def split(g):
        return ", ".join(f"{c} {g[c]:.2f} s" for c in g if g[c] > 0)

    log(f"runtime: run A step (steps 2-{RUNTIME_STEPS}, median) "
        f"{step_s * 1e3:.1f} ms, {tokens / step_s:.0f} tokens/s; goodput "
        f"of A: {split(gp)}; of the resume: {split(gp_r)}; wall A "
        f"{runs['A'][0]:.1f} s, B {runs['B'][0]:.1f} s, resume "
        f"{runs['resume'][0]:.1f} s")

    # serve --checkpoint: the CLI's engine builder on A's checkpoints.
    args = cli._parser().parse_args(
        ["serve", "--checkpoint", str(RUN_DIR / "A" / "checkpoints"),
         *(["--device", str(dev)] if dev.type != "cuda" else [])])
    t0 = time.perf_counter()
    engine = cli.build_serve_engine(args)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    lk = _filled_decoder(engine).step_logits().cpu()
    mem = torch.load(RUN_DIR / "a_logits.pt")
    same = torch.equal(lk, mem)
    log(f"runtime: serve --checkpoint loaded step {RUNTIME_STEPS} in "
        f"{load_s:.1f} s; first decode step logits vs the engine built "
        f"from run A's in-memory weights: "
        f"{'bitwise equal' if same else 'DIFFERENT'} (max abs diff "
        f"{(lk - mem).abs().max().item():.3e})")
    if not same:
        raise AssertionError("the checkpoint's logits differ from the "
                             "in-memory weights'")

    def reset():
        rpa.ragged_paged_attention.launches = 0

    b5, serve = _serve_burst(
        engine, "serve --checkpoint",
        lambda model: model["hidden_size"] == engine.config.hidden_size,
        reset, lambda: rpa.ragged_paged_attention.launches)
    want_b5 = serve["decode_steps"] * engine.config.num_layers
    log(f"runtime: B5 launches serving the checkpoint {b5} (decode steps x "
        f"layers = {want_b5})")
    if b5 != want_b5:
        raise AssertionError("serving the checkpoint did not run through "
                             "the decode kernel")
    rpa_entry["launches"] = (rpa_entry["launches"] or 0) + b5
    rpa_entry["launches_runtime"] = b5
    del engine
    return {"steps": RUNTIME_STEPS, "preempted_at": k, "losses": losses,
            "step_ms_median": step_s * 1e3, "tokens_per_s": tokens / step_s,
            "goodput_seconds": gp, "goodput_seconds_resume": gp_r,
            "saves": saves, "restores": restores,
            "disk_free_gb": disk.free / 1e9, "corpus_mb": n_bytes / 1e6,
            "run_wall_s": {n: w for n, (w, _) in runs.items()},
            "serve_load_s": load_s, "serve": serve,
            "params_sha256": digest_a}


# ---------------------------------------------------------------------------
# Adaptive training: the orchestrator's interventions on the flagship MoE.
# ---------------------------------------------------------------------------
ADAPTIVE_STEPS = 14  # global steps; 15 run (the rollback replays one)
# Executed step after which each scripted decision runs: (kind, params).
# The weight decay doubles the config's; prune takes the least-loaded
# expert of the step before; rollback goes to the last healthy step,
# fenced to the prune's forced save.
ADAPTIVE_SCRIPT = {
    3: ("lr_adjust", {"factor": 0.5, "action": "decrease"}),
    4: ("weight_decay", None),
    5: ("clip_tighten", {}),
    6: ("temperature_up", {"new_value": 1.25}),
    7: ("capacity_up", {"new_value": 1.5}),
    8: ("expert_dropout", {"rate": 0.1}),
    9: ("expert_dropout", {"rate": 0.0}),
    10: ("curriculum", {"difficulty": 0.6}),
    11: ("add_expert", {}),
    12: ("prune_expert", None),
    13: ("rollback", {}),
}
# Steps held against the same step through the plain gmm: the one after
# each of these decisions.
ADAPTIVE_COMPARE = {8: "expert dropout 0.1", 11: "add_expert",
                    12: "prune_expert", 13: "rollback"}
STEADY_STEPS = (2, 3, 15)  # no intervention just before them


def _smi() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except OSError as exc:
        return f"nvidia-smi unavailable: {exc}"
    return (out.stdout.strip().splitlines()[0] if out.stdout.strip()
            else f"nvidia-smi unavailable: {out.stderr.strip()}")


def _param_digest(trainer) -> str:
    """sha256 over the trainer's parameters by name, copied to the host."""
    return _tensor_digest({n: p.detach().cpu() for n, p in
                           zip(trainer.state.names, trainer.state.params)})


def phase_adaptive(dev, flash_entries: list, gmm_entries: list,
                   model: dict = FLAGSHIP, want: dict = None) -> dict:
    """The flagship MoE trained in-process under
    AdaptiveTrainingOrchestrator(trainer).run() from phase 7's corpus,
    packed. The organic health check cannot fire (health_check_interval
    19 > the steps; the log boundary is every step); one decision of each
    MoE-path kind is injected through the orchestrator's _execute at
    fixed steps. After each: the decision applied, exact B1-B4 launches
    and a finite loss in the next step; after expert dropout, add, prune
    and the rollback that step against the same step through the plain
    gmm (the generator reseeded identically); the optimizer count equal
    to the step after each evolution; the parameters after the rollback
    bitwise those of the prune's forced save. `model` and `want` (the
    launches per step) default to the flagship on the card."""
    import logging
    import types

    import numpy as np
    import torch

    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.models import moe
    from luminaai_tpu_torch.ops import flash_attention as fa
    from luminaai_tpu_torch.ops import gmm as tg
    from luminaai_tpu_torch.ops.fused import global_norm
    from luminaai_tpu_torch.parallel import train_step as ts
    from luminaai_tpu_torch.training import orchestrator as orch_mod
    from luminaai_tpu_torch.training.trainer import Trainer

    t_phase = time.perf_counter()
    smi = _smi()
    corpus = RUN_DIR / "corpus.jsonl"
    cfg = Config(**model, **FLAGSHIP_LEVERS, max_steps=ADAPTIVE_STEPS,
                 health_check_interval=19,
                 output_dir=str(RUN_DIR / "adaptive"))
    train_fn, _, n_tokens = cli.make_data(
        cfg, types.SimpleNamespace(data=str(corpus), packed=True))
    trainer = Trainer(cfg, train_fn, device=dev, seed=0)
    orch = orch_mod.AdaptiveTrainingOrchestrator(trainer)
    L, n_moe = cfg.num_layers, cfg.num_moe_layers()
    if want is None:
        want = {"B1": 2 * L, "B2": L, "B3": L, "B4a": 6 * n_moe,
                "B4b": 2 * n_moe}
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()
    log(f"adaptive: flagship MoE ({smi}), {cfg.num_experts} experts, "
        f"batch {cfg.batch_size} x {cfg.seq_length} packed from "
        f"{corpus.name} ({n_tokens:,} tokens), {ADAPTIVE_STEPS} steps")

    failed = []

    class Failures(logging.Handler):
        def emit(self, record):
            if "failed" in record.getMessage():
                failed.append(record.getMessage())

    handler = Failures(level=logging.ERROR)
    orch_mod.logger.addHandler(handler)

    def launches():
        return {"B1": fa.flash_fwd.launches, "B2": fa.flash_bwd_dq.launches,
                "B3": fa.flash_bwd_dkv.launches, "B4a": tg.gmm.launches,
                "B4b": tg.tgmm.launches}

    steps, compares, digests = [], {}, {}
    pending = {"label": None}
    compare_launches = dict.fromkeys(want, 0)
    # Whole experts expert dropout leaves out of routing in the real step
    # (their B4 groups are empty), summed over the MoE layers.
    real_draw = moe.MoELayer.draw_routing
    dropped = {"live": False, "n": 0}

    def draw(self, G, S, generator, device):
        out = real_draw(self, G, S, generator, device)
        if dropped["live"] and out and "expert_u" in out:
            rate = self.config.expert_dropout_rate
            dropped["n"] += int((out["expert_u"] >= 1.0 - rate).sum())
        return out

    def wrap(real):
        def step(state, batch):
            label, pending["label"] = pending["label"], None
            if label is not None:
                gen = state.generator.get_state()
                before = launches()
                moe.GMM_OVERRIDE = _plain_gmm
                try:
                    grads, m = ts._accumulate_grads(
                        ts.make_loss_fn(trainer.config, trainer.model),
                        state.params, batch, state.generator,
                        trainer.config.gradient_accumulation_steps)
                    plain = (float(m["loss"]), float(global_norm(grads)))
                finally:
                    moe.GMM_OVERRIDE = None
                del grads, m
                for k, v in launches().items():
                    compare_launches[k] += v - before[k]
                state.generator.set_state(gen)
            sync()
            before = launches()
            dropped.update(live=True, n=0)
            t0 = time.perf_counter()
            state, metrics = real(state, batch)
            loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
            ms = (time.perf_counter() - t0) * 1e3
            dropped["live"] = False
            steps.append({
                "n": len(steps) + 1, "step": state.step, "ms": ms,
                "loss": loss, "grad_norm": norm,
                "lr": float(metrics["learning_rate"]),
                "experts": trainer.config.num_experts,
                "drop_rate": float(metrics["moe_drop_rate"]),
                "experts_dropped": dropped["n"],
                "launches": {k: v - before[k]
                             for k, v in launches().items()},
            })
            if label is not None:
                errs = (abs(loss - plain[0]) / abs(plain[0]),
                        abs(norm - plain[1]) / abs(plain[1]))
                compares[label] = {"step": state.step, "loss": loss,
                                   "loss_plain": plain[0],
                                   "grad_norm": norm,
                                   "grad_norm_plain": plain[1],
                                   "loss_rel": errs[0], "norm_rel": errs[1]}
                log(f"  step {state.step} after {label}, B4 vs plain gmm: "
                    f"loss {loss:.5f} vs {plain[0]:.5f} (rel {errs[0]:.2e},"
                    f" tol {LOSS_RTOL}), grad_norm {norm:.5f} vs "
                    f"{plain[1]:.5f} (rel {errs[1]:.2e}, tol "
                    f"{GRAD_NORM_RTOL})")
                if errs[0] > LOSS_RTOL or errs[1] > GRAD_NORM_RTOL:
                    raise AssertionError(f"the step after {label} disagrees"
                                         f" with the plain gmm")
            return state, metrics

        step.wrapped = True
        return step

    def scripted(global_step, metrics, observe=orch.on_metrics):
        observe(global_step, metrics)
        n = len(steps)
        rec = steps[-1]
        if rec["launches"] != want or not (math.isfinite(rec["loss"])
                                           and math.isfinite(
                                               rec["grad_norm"])):
            raise AssertionError(f"step {n}: launches {rec['launches']} "
                                 f"(want {want}), loss {rec['loss']}")
        if n in ADAPTIVE_SCRIPT:
            kind, params = ADAPTIVE_SCRIPT[n]
            if kind == "weight_decay":
                params = {"new_value": 2 * cfg.weight_decay}
            if kind == "prune_expert":
                util = np.asarray(metrics["expert_utilization"])
                params = {"expert_idx": int(util.argmin())}
            decision = orch_mod.AdaptiveDecision(
                kind=kind, params=params, reason=f"scripted at step {n}",
                confidence=1.0, step=trainer.global_step)
            t0 = time.perf_counter()
            orch._execute(decision)
            rec["decision"] = kind
            rec["decision_s"] = time.perf_counter() - t0
            if not decision.applied or failed:
                raise AssertionError(f"decision {kind} at step {n} not "
                                     f"applied: {failed}")
            if kind in ("add_expert", "prune_expert"):
                count = trainer.state.opt_state.count
                if count != trainer.global_step:
                    raise AssertionError(f"optimizer count {count} after "
                                         f"{kind} at step "
                                         f"{trainer.global_step}")
                if kind == "prune_expert":
                    digests["saved"] = (trainer.global_step,
                                        _param_digest(trainer))
            if kind == "rollback":
                digests["restored"] = (trainer.global_step,
                                       _param_digest(trainer))
            if n in ADAPTIVE_COMPARE:
                pending["label"] = ADAPTIVE_COMPARE[n]
        if not getattr(trainer.train_step, "wrapped", False):
            trainer.train_step = wrap(trainer.train_step)

    orch.on_metrics = scripted
    trainer.train_step = wrap(trainer.train_step)
    fa.reset_launches()
    tg.reset_launches()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    moe.MoELayer.draw_routing = draw
    try:
        summary = orch.run()
    finally:
        moe.MoELayer.draw_routing = real_draw
        orch_mod.logger.removeHandler(handler)
    total = launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    if failed:
        raise AssertionError(f"intervention failures logged: {failed}")

    for rec in steps:
        log(f"  step {rec['n']:2d} (global {rec['step']:2d}, E "
            f"{rec['experts']}): loss {rec['loss']:.4f} grad_norm "
            f"{rec['grad_norm']:.4f} lr {rec['lr']:.3e} drop "
            f"{rec['drop_rate']:.4f} {rec['ms']:.1f} ms"
            + (f"; then {rec['decision']} ({rec['decision_s']:.2f} s)"
               if "decision" in rec else ""))
    if len(steps) != ADAPTIVE_STEPS + 1 or summary["final_step"] != (
            ADAPTIVE_STEPS):
        raise AssertionError(f"{len(steps)} steps run, final step "
                             f"{summary['final_step']}")
    if set(compares) != set(ADAPTIVE_COMPARE.values()):
        raise AssertionError(f"compared steps {sorted(compares)}")
    n_drop = [r["experts_dropped"] for r in steps]
    log(f"adaptive: whole experts left out by expert dropout per step "
        f"(summed over {n_moe} MoE layers; their B4 groups empty): {n_drop}")
    if not n_drop[8] or any(n_drop[:8]) or any(n_drop[9:]):
        raise AssertionError("expert dropout did not empty B4 groups in "
                             "exactly the step it was on")
    lr_override = trainer._lr_override
    if any(abs(r["lr"] - lr_override) > 1e-6 * lr_override
           for r in steps[3:]):
        raise AssertionError(f"the LR override {lr_override} did not hold: "
                             f"{[r['lr'] for r in steps]}")
    if digests["saved"] != digests["restored"]:
        raise AssertionError(f"rollback restored {digests['restored']}, the "
                             f"forced save held {digests['saved']}")
    log(f"adaptive: rollback to step {digests['restored'][0]} restored the "
        f"parameters of the prune's forced save bitwise (sha256 "
        f"{digests['saved'][1][:16]})")
    experts = [r["experts"] for r in steps]
    per_step = {k: want[k] * len(steps) for k in want}
    run = {k: total[k] - compare_launches[k] for k in total}
    if run != per_step:
        raise AssertionError(f"launches {run}, want {per_step}")
    log(f"adaptive: launches per step {want} in all {len(steps)} steps; "
        f"totals {run} (plus {compare_launches} in the plain re-runs); E "
        f"over the run {experts}")
    for e, kern in zip(flash_entries + gmm_entries,
                       ("B1", "B2", "B3", "B4a", "B4b")):
        e["launches"] = (e["launches"] or 0) + run[kern]
        e["launches_adaptive"] = run[kern]

    steady = statistics.median(steps[n - 1]["ms"] for n in STEADY_STEPS)
    tokens = cfg.batch_size * cfg.seq_length
    after = {f"{n}:{steps[n - 1]['decision']}": steps[n]["ms"]
             for n in sorted(ADAPTIVE_SCRIPT)}
    log(f"adaptive: steady step (median of steps {STEADY_STEPS}) "
        f"{steady:.1f} ms, {tokens / steady * 1e3:.0f} tokens/s ({smi})")
    for n in sorted(ADAPTIVE_SCRIPT):
        r = steps[n]
        log(f"  step after {steps[n - 1]['decision']}: {r['ms']:.1f} ms "
            f"({100 * (r['ms'] / steady - 1):+.1f}% of steady)")
    ck = trainer.checkpoints
    for s_ in ck.save_log:
        log(f"  save step {s_['step']}: {s_['seconds']:.2f} s "
            f"({s_['host_copy_seconds']:.2f} s host copy), "
            f"{s_['bytes'] / 1e9:.2f} GB")
    for s_ in ck.restore_log:
        log(f"  restore step {s_['step']}: {s_['seconds']:.2f} s, "
            f"{s_['bytes'] / 1e9:.2f} GB")
    gp = summary["goodput"]["seconds"]
    decisions = summary["adaptive_decisions"]
    log("adaptive: goodput " + ", ".join(f"{c} {gp[c]:.2f} s" for c in gp
                                         if gp[c] > 0)
        + f"; peak memory {peak_gb:.2f} GB")
    log(f"adaptive: decisions {json.dumps(decisions)}")
    if len(decisions) != len(ADAPTIVE_SCRIPT) or not all(
            d["applied"] for d in decisions):
        raise AssertionError(f"decisions {decisions}")
    trainer.close()
    wall = time.perf_counter() - t_phase
    log(f"adaptive: phase wall {wall:.1f} s ({smi})")
    return {"steps": steps, "steady_ms": steady,
            "tokens_per_s": tokens / steady * 1e3, "after_ms": after,
            "compares": compares, "experts": experts,
            "experts_dropped": n_drop,
            "saves": ck.save_log, "restores": ck.restore_log,
            "goodput_seconds": gp, "peak_memory_gb": peak_gb,
            "decisions": decisions, "wall_s": wall, "card": smi}


def main() -> int:
    if sys.argv[1:2] == ["--runtime-child"]:
        return runtime_child(sys.argv[2:])
    repo = Path(__file__).resolve().parent
    if not (repo / "luminaai_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: luminaai_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    # fp32 products are compared below: keep them full fp32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    RUN_DIR.mkdir()
    try:
        phase_build()
        entry = phase_kernels(dev)
        flash_entries = phase_flash_kernels(dev)
        gmm_entries = phase_gmm_kernels(dev)
        serve = phase_serve(dev, entry)
        _release()
        serve_moe = phase_serve_moe(dev, entry, gmm_entries)
        _release()
        train = phase_train(dev, flash_entries)
        shutil.rmtree(RUN_DIR / "train_dense")
        _release()
        train_moe = phase_train_moe(dev, flash_entries, gmm_entries)
        shutil.rmtree(RUN_DIR / "train_moe")
        _release()
        runtime = phase_runtime(dev, entry, flash_entries)
        # Phase 7's runs and checkpoints go; its corpus feeds phase 8.
        for run in ("A", "B"):
            shutil.rmtree(RUN_DIR / run)
        _release()
        adaptive = phase_adaptive(dev, flash_entries, gmm_entries)
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)
    log(f"all phases passed in {time.perf_counter() - t0:.1f}s: "
        f"serve {serve}; serve_moe {serve_moe}; train {json.dumps(train)}; "
        f"train_moe {json.dumps(train_moe)}; runtime {json.dumps(runtime)}; "
        f"adaptive {json.dumps(adaptive)}")

    print(_smi())
    print(json.dumps({"kernels": [entry, *flash_entries, *gmm_entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
