#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (luminaai_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. build   every CUDA kernel of the serving path from the checkout's
             sources (one nvcc per source, started together);
  2. kernels hold each kernel against its plain PyTorch version at the
             serving slice's shapes, time kernel / plain / library call,
             and compute the least time the card could take;
  3. serve   the b1-width dense model (16 layers, hidden 2048, seeded
             weights) through the port's ContinuousScheduler +
             StepwiseDecoder behind its HTTP server: first-decode-step
             logits with the kernel vs the plain version, then concurrent
             POST /v1/generate requests; the kernel must have launched
             exactly decode steps x layers times.

Output: progress lines, the card's `nvidia-smi` name and power limit, one
{"kernels": [...]} JSON line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or without the luminaai_tpu_torch package beside
this file, it exits non-zero and prints no result. It imports nothing of
JAX and nothing of the luminaai_tpu package.
"""

from __future__ import annotations

import itertools
import json
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
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12    # dense bf16 tensor-core peak


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
    }


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


PROMPT_LENGTHS = (10, 40, 64, 65, 150, 300, 450, 600)


def _prompt(n: int, i: int) -> str:
    words = "the quick brown fox jumps over the lazy dog while serving "
    text = (f"request {i}: " + words * (n // len(words) + 1))[:n]
    return text


def phase_serve(dev, entry: dict) -> dict:
    import torch

    from luminaai_tpu_torch.config import ConfigPresets
    from luminaai_tpu_torch.inference.chat import build_engine
    from luminaai_tpu_torch.ops import ragged_paged_attention as rpa
    from luminaai_tpu_torch.serving.server import ChatServer

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
    tok = engine.tokenizer
    prompts = [tok.encode_text(_prompt(n, i))
               for i, n in enumerate(PROMPT_LENGTHS)]
    dec = engine.make_stepwise(num_slots=LANES, page_size=PAGE)
    for p in prompts:
        slot = dec.acquire_slot()
        st = dec.start_prefill(slot, p, max_new_tokens=32)
        if st is None:
            dec.prefill_into_slot(slot, p, max_new_tokens=32)
        else:
            while dec.advance_prefill(st) is None:
                pass
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
        if r.status != 200 or health["model"]["hidden_size"] != cfg.hidden_size:
            raise AssertionError(f"bad /health: {health}")
        post({"prompt": "warm up", "max_new_tokens": 2, "temperature": 0})

        sched = server.batcher
        rpa.ragged_paged_attention.launches = 0
        steps0, dsec0 = sched.decoder.steps, sched.decode_seconds
        t0 = time.perf_counter()
        bodies = [{"prompt": _prompt(n, i), "max_new_tokens": 32,
                   "temperature": 0}
                  for i, n in enumerate(PROMPT_LENGTHS)]
        with ThreadPoolExecutor(len(bodies)) as pool:
            replies = list(pool.map(post, bodies))
        wall = time.perf_counter() - t0
        launches = rpa.ragged_paged_attention.launches
        steps = sched.decoder.steps - steps0
        dsec = sched.decode_seconds - dsec0
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()

    tokens = 0
    for (code, body), n in zip(replies, PROMPT_LENGTHS):
        if code != 200 or not body.get("token_ids"):
            raise AssertionError(f"bad reply for a {n}-char prompt: {body}")
        if not all(0 <= t < cfg.vocab_size for t in body["token_ids"]):
            raise AssertionError("token id outside the vocabulary")
        tokens += body["tokens"]
    log(f"serve: {len(replies)} concurrent requests (prompts "
        f"{min(PROMPT_LENGTHS)}-{max(PROMPT_LENGTHS)} tokens), {tokens} "
        f"tokens in {wall:.3f}s = {tokens / wall:.1f} tok/s; {steps} decode "
        f"steps, {1e3 * dsec / max(steps, 1):.3f} ms/step; peak lanes "
        f"{stats['max_batch_seen']}")
    lat = sorted(body["latency_s"] for _, body in replies)
    log(f"request latency (n={len(lat)}): median "
        f"{statistics.median(lat):.3f}s, "
        f"max {lat[-1]:.3f}s")
    want = steps * cfg.num_layers
    log(f"kernel launches during serving: {launches} (decode steps x "
        f"layers = {want})")
    if steps <= 0 or launches != want:
        raise AssertionError("the decode path did not run through the kernel")
    entry["launches"] = launches
    return {"requests": len(replies), "tokens": tokens, "wall_s": wall,
            "decode_steps": steps, "decode_step_ms": 1e3 * dsec / steps,
            "tokens_per_s": tokens / wall, "latency_max_s": lat[-1]}


def main() -> int:
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
    phase_build()
    entry = phase_kernels(dev)
    serve = phase_serve(dev, entry)
    log(f"all phases passed in {time.perf_counter() - t0:.1f}s: {serve}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi unavailable: {smi.stderr.strip()}")
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
