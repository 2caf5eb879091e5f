"""Op microbenchmarks of the PyTorch/CUDA port (counterpart of
bench_ops.py): the port's competing implementations head to head on the
card, at bench_ops.py's shapes.

  - attention: the flash kernels (B1 forward; B1-B3 forward + backward)
    against the model's einsum path (models/layers.py _xla_attention),
    causal and at a window of S/4;
  - moe: the sort, gather, einsum (one-hot) and gmm (B4a/B4b) dispatches;
  - loss: the fused chunked LM-head CE against the plain logits CE,
    forward + backward;
  - int8: bf16 against W8A8 (torch._int_mm, ops/quantized.py);
  - rope: the rotation in fp32 against bf16.

Before timing, each suite holds its competitors against each other within
the tolerance it states (TOLERANCES; the kernels at chip_smoke.py's):
a suite whose competitors disagree is not timed and counts as failed.
Times are CUDA-event medians (luminaai_tpu_torch/ops/_timing.py
cuda_ms). One child process per suite (bench_common_torch.run_child),
so a hung suite costs only itself.

    python3 bench_ops_torch.py [--suite all|attention|moe|loss|int8|rope]
                               [--small] [--timeout S] [--device cpu]

Prints one human table, then one JSON line; exits 1 when every suite
failed. Without --device the suites run on the card: where the probe
(bench_torch.py _probe_backend) finds none, the line carries "error" and
the exit code is 1 (nothing runs on the CPU in its place).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from typing import Callable, Dict, List

# Agreement each suite requires before it times anything (max |a - b|
# over max |b|). The flash kernels against the einsum path: chip_smoke.py's
# FLASH_REL_TOL (bf16 outputs; both round P to bf16, at other points);
# gmm against the plain grouped matmul: chip_smoke.py's KERNEL_TOL; the
# other dispatches against each other, the fused against the plain CE
# (fp32 sums in other orders: loss 1e-4 relative, gradients in bf16 or
# fp32 at 2e-2), W8A8 against bf16 (chip_smoke.py's W8A8_LOGIT_RTOL) and
# bf16 RoPE against fp32 (bf16's 2^-8 steps) the same way.
TOLERANCES = {
    "attention": 2e-2,
    "moe_gmm": 3e-2,
    "moe_dispatch": 3e-2,
    "loss": 1e-4,
    "loss_grad": 2e-2,
    "int8": 5e-2,
    "rope": 2e-2,
}
ROUNDS = 5


def _rel(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))


def _time_fn(fn: Callable, device, iters: int = 10) -> float:
    """Median ms of a call: on the card the median of ROUNDS CUDA-event
    timings of `iters` back-to-back calls; on the CPU of single calls."""
    if device.type == "cuda":
        from luminaai_tpu_torch.ops import _timing

        fn()
        return statistics.median(_timing.cuda_ms(fn, iters, warmup=1)
                                 for _ in range(ROUNDS))
    fn()
    out = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def _check(name: str, errs: Dict[str, float], tol: float) -> Dict:
    bad = {k: v for k, v in errs.items() if not v <= tol}
    if bad:
        raise AssertionError(f"{name}: competitors disagree beyond {tol}: "
                             f"{bad}")
    return {"tolerance": tol, "max_rel_err": errs}


def _grads(f, *xs):
    """A fn running f forward and backward from a fixed cotangent; and
    the gradients of one run."""
    import torch

    def run():
        for x in xs:
            x.grad = None
        out = f(*xs)
        out.float().backward(torch.ones_like(out, dtype=torch.float32))
        return [x.grad for x in xs]

    return run


def bench_attention(device, B=4, S=2048, Hq=16, Hkv=8, D=64) -> Dict:
    import torch

    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.models.layers import GQAttention
    from luminaai_tpu_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, S, h, D, generator=g).to(device,
                                                        torch.bfloat16)
               for h in (Hq, Hkv, Hkv))
    win = max(128, S // 4)

    def einsum_attn(window):
        # The model's plain path (the JAX _xla_attention), bound to a
        # config that carries only the window.
        cfg = Config(attention_window=window)
        return lambda q, k, v: GQAttention._xla_attention(
            type("_A", (), {"config": cfg})(), q, k, v)

    variants = {
        "flash": lambda q, k, v: fa.flash_attention(q, k, v, causal=True),
        "einsum": einsum_attn(None),
        f"flash_win{win}": lambda q, k, v: fa.flash_attention(
            q, k, v, causal=True, window=win),
        f"einsum_win{win}": einsum_attn(win),
    }
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    outs, grads = {}, {}
    for name, f in variants.items():
        with torch.no_grad():
            outs[name] = f(q, k, v)
        grads[name] = _grads(f, *leaves)()
    errs = {}
    for flash, plain in (("flash", "einsum"),
                         (f"flash_win{win}", f"einsum_win{win}")):
        errs[f"{flash}_out"] = _rel(outs[flash], outs[plain])
        for i, wrt in enumerate("qkv"):
            errs[f"{flash}_d{wrt}"] = _rel(grads[flash][i], grads[plain][i])
    check = _check("attention", errs, TOLERANCES["attention"])
    del outs, grads
    shape = f"B{B}xS{S}xH{Hq}/{Hkv}xD{D}"
    rows = []
    for name, f in variants.items():
        with torch.no_grad():
            rows.append({"op": f"attention_{name}_fwd", "shape": shape,
                         "ms": _time_fn(lambda f=f: f(q, k, v), device)})
    for name, f in variants.items():
        rows.append({"op": f"attention_{name}_fwdbwd", "shape": shape,
                     "ms": _time_fn(_grads(f, *leaves), device)})
    out = {"rows": rows, "check": check}
    if device.type == "cuda":
        out["flash_last_kernel"] = {kern: fa.last_kernel(kern)
                                    for kern in ("B1", "B2", "B3")}
    return out


def bench_moe_dispatch(device, G=8, S=2048, H=512, E=8, k=2,
                       F=1408) -> Dict:
    import dataclasses

    import torch

    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.models import moe
    from luminaai_tpu_torch.models.moe import MoELayer
    from luminaai_tpu_torch.ops import gmm as tg

    cfg = Config(
        vocab_size=1024, hidden_size=H, num_layers=2, num_heads=8,
        num_kv_heads=4, seq_length=S, batch_size=G, use_moe=True,
        num_experts=E, moe_top_k=k, intermediate_size=F,
        use_flash_attention=False, gradient_checkpointing=False,
    )
    g = torch.Generator().manual_seed(0)
    x = torch.randn(G, S, H, generator=g).to(device, torch.bfloat16)
    weights = [torch.randn(H, E, generator=g) * 0.02,
               torch.randn(E, H, 2 * F, generator=g) * 0.02,
               torch.randn(E, F, H, generator=g) * 0.02]
    layers = {}
    for mode in ("sort", "gather", "einsum", "gmm"):
        layer = MoELayer(dataclasses.replace(cfg, moe_dispatch=mode),
                         device=device, trainable=True)
        with torch.no_grad():
            for p, w in zip((layer.router, layer.wi, layer.wo), weights):
                p.copy_(w)
        layers[mode] = layer

    def fwd(layer):
        def run():
            with torch.no_grad():
                return layer(x)[0]
        return run

    def fwdbwd(layer):
        def run():
            layer.zero_grad(set_to_none=True)
            layer(x)[0].float().sum().backward()
        return run

    outs = {mode: fwd(layer)() for mode, layer in layers.items()}
    moe.GMM_OVERRIDE = lambda lhs, rhs, gs, out_dtype=None, \
        transpose_rhs=False: tg.gmm_ref(lhs, rhs, gs, out_dtype,
                                        transpose_rhs)
    try:
        plain_gmm = fwd(layers["gmm"])()
    finally:
        moe.GMM_OVERRIDE = None
    check = _check("moe_gmm", {"gmm_vs_plain_gmm": _rel(outs["gmm"],
                                                        plain_gmm)},
                   TOLERANCES["moe_gmm"])
    check["dispatch"] = _check("moe_dispatch", {
        f"{m}_vs_sort": _rel(outs[m], outs["sort"])
        for m in ("gather", "einsum")}, TOLERANCES["moe_dispatch"])
    del outs, plain_gmm
    shape = f"G{G}xS{S}xH{H} E{E}k{k}"
    rows = []
    for mode, layer in layers.items():
        before = tg.gmm.launches
        rows.append({"op": f"moe_{mode}_fwd", "shape": shape,
                     "ms": _time_fn(fwd(layer), device)})
        rows.append({"op": f"moe_{mode}_fwdbwd", "shape": shape,
                     "ms": _time_fn(fwdbwd(layer), device)})
        if mode == "gmm" and device.type == "cuda" and (
                tg.gmm.launches == before):
            raise AssertionError("the gmm dispatch launched no B4a")
    return {"rows": rows, "check": check}


def bench_loss(device, B=8, S=2048, H=1024, V=32768) -> Dict:
    import torch

    from luminaai_tpu_torch.ops.fused import (
        cross_entropy_loss,
        fused_lm_head_cross_entropy,
    )

    g = torch.Generator().manual_seed(0)
    hidden = (torch.randn(B, S, H, generator=g) * 0.02).to(device,
                                                           torch.bfloat16)
    emb = (torch.randn(V, H, generator=g) * 0.02).to(device)
    labels = torch.randint(0, V, (B, S), generator=g).to(device)

    def plain(hidden, emb):
        logits = torch.einsum("bsh,vh->bsv", hidden.float(), emb)
        return cross_entropy_loss(logits, labels)[0]

    def fused(hidden, emb):
        return fused_lm_head_cross_entropy(hidden, emb, labels)[0]

    leaves = [hidden.clone().requires_grad_(), emb.clone().requires_grad_()]
    got = {}
    for name, f in (("fused", fused), ("plain", plain)):
        for x in leaves:
            x.grad = None
        loss = f(*leaves)
        loss.backward()
        got[name] = [loss.detach()] + [x.grad.clone() for x in leaves]
    check = _check("loss", {"loss": _rel(got["fused"][0], got["plain"][0])},
                   TOLERANCES["loss"])
    check["grads"] = _check("loss_grad", {
        f"d{n}": _rel(a, b) for n, a, b in zip(
            ("hidden", "head"), got["fused"][1:], got["plain"][1:])},
        TOLERANCES["loss_grad"])
    del got
    rows = []
    for name, f in (("fused", fused), ("plain", plain)):
        def run(f=f):
            for x in leaves:
                x.grad = None
            f(*leaves).backward()
        rows.append({"op": f"lm_head_ce_{name}_fwdbwd",
                     "shape": f"B{B}xS{S}xH{H}xV{V}",
                     "ms": _time_fn(run, device, iters=3)})
    return {"rows": rows, "check": check}


def bench_rope(device, B=16, S=2048, Hq=16, D=64) -> Dict:
    """RoPE in fp32 against bf16 at the flagship q-projection shape;
    inputs and outputs bf16 either way."""
    import torch

    from luminaai_tpu_torch.models.layers import apply_rope, rope_frequencies

    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, S, Hq, D, generator=g).to(device, torch.bfloat16)
    cos, sin = rope_frequencies(D, S, device=device)
    variants = {name: (lambda x, ct=ct: apply_rope(x, cos, sin,
                                                   compute_dtype=ct))
                for name, ct in (("fp32", torch.float32),
                                 ("bf16", torch.bfloat16))}
    check = _check("rope", {"bf16_vs_fp32": _rel(variants["bf16"](x),
                                                 variants["fp32"](x))},
                   TOLERANCES["rope"])
    leaf = x.clone().requires_grad_()
    shape = f"B{B}xS{S}xH{Hq}xD{D}"
    rows = [{"op": f"rope_{n}_fwd", "shape": shape,
             "ms": _time_fn(lambda f=f: f(x), device)}
            for n, f in variants.items()]
    rows += [{"op": f"rope_{n}_fwdbwd", "shape": shape,
              "ms": _time_fn(_grads(f, leaf), device)}
             for n, f in variants.items()]
    return {"rows": rows, "check": check}


def bench_int8_matmul(device, M=256, K=1024, N=32768) -> Dict:
    """bf16 against W8A8 at the decode vocab-projection shape: the raw
    int8 product and the whole quantized projection (the activations'
    quantization included), as served."""
    import torch

    from luminaai_tpu_torch.ops.quantized import (
        int8_attend,
        int_mm,
        quantize_array,
    )

    g = torch.Generator().manual_seed(0)
    x = (torch.randn(M, K, generator=g) * 0.02).to(device, torch.bfloat16)
    w = (torch.randn(N, K, generator=g) * 0.02).to(device)
    qt = quantize_array(w, bits=8, axis=(-1,))
    x8 = torch.randint(-127, 128, (M, K), generator=g,
                       dtype=torch.int8).to(device)
    wbf = w.to(torch.bfloat16)
    qT = qt.q.t()

    def bf16():
        return torch.mm(x, wbf.t()).float()

    check = _check("int8", {"w8a8_vs_bf16": _rel(
        int8_attend(x, qt, torch.float32), bf16())}, TOLERANCES["int8"])
    shape = f"M{M}xK{K}xN{N}"
    return {"rows": [
        {"op": "matmul_bf16", "shape": shape, "ms": _time_fn(bf16, device)},
        {"op": "matmul_int8_raw", "shape": shape,
         "ms": _time_fn(lambda: int_mm(x8, qT), device)},
        {"op": "matmul_int8_attend_full", "shape": shape,
         "ms": _time_fn(lambda: int8_attend(x, qt, torch.float32), device)},
    ], "check": check}


SUITES = ("attention", "moe", "loss", "int8", "rope")
SMALL = {
    "attention": dict(B=1, S=256, Hq=4, Hkv=2, D=64),
    "moe": dict(G=2, S=256, H=128, F=256),
    "int8": dict(M=32, K=128, N=2048),
    "rope": dict(B=2, S=256, Hq=4, D=64),
    "loss": dict(B=2, S=256, H=128, V=2048),
}


def _run_suite(suite: str, small: bool, device) -> Dict:
    fn = {"attention": bench_attention, "moe": bench_moe_dispatch,
          "loss": bench_loss, "int8": bench_int8_matmul,
          "rope": bench_rope}[suite]
    return fn(device, **(SMALL[suite] if small else {}))


def _child_main(suite: str, small: bool, device_arg) -> None:
    import torch

    from luminaai_tpu_torch.config import resolve_device

    device = resolve_device(device_arg)
    out = _run_suite(suite, small, device)
    print(json.dumps({
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "suite": suite, "results": out.pop("rows"), **out,
    }), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--suite", default="all",
                        choices=["all", *SUITES])
    parser.add_argument("--small", action="store_true",
                        help="small shapes, for smoke runs")
    parser.add_argument("--timeout", type=int, default=900,
                        help="per-suite timeout (seconds)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)

    from bench_common_torch import run_child
    from bench_torch import _probe_backend

    if args.device is None:
        # The card or nothing: no suite runs on the CPU in its place.
        found, diag = _probe_backend()
        if found != "gpu":
            print(json.dumps({"platform": None, "results": [],
                              "error": diag}), flush=True)
            return 1
    suites = list(SUITES) if args.suite == "all" else [args.suite]
    rows: List[Dict] = []
    checks: Dict[str, Dict] = {}
    extra: Dict[str, Dict] = {}
    platform = device = None
    errors: List[str] = []
    here = os.path.dirname(os.path.abspath(__file__))
    for suite in suites:
        cmd = [sys.executable, os.path.abspath(__file__), "--child", suite]
        cmd += ["--small"] if args.small else []
        cmd += ["--device", args.device] if args.device else []
        parsed, diag = run_child(cmd, args.timeout,
                                 validate=lambda p: "results" in p,
                                 label=suite, cwd=here)
        if parsed is None:
            errors.append(diag)
            continue
        platform, device = parsed["platform"], parsed["device"]
        rows += [dict(r, suite=suite) for r in parsed["results"]]
        checks[suite] = parsed["check"]
        if "flash_last_kernel" in parsed:
            extra["flash_last_kernel"] = parsed["flash_last_kernel"]

    if rows:
        width = max(len(r["op"]) for r in rows)
        print(f"\n{'op':<{width}}  {'ms':>10}  shape   [{device}]")
        for r in rows:
            print(f"{r['op']:<{width}}  {r['ms']:>10.3f}  {r['shape']}")
    out: Dict = {"platform": platform, "device": device, "results": rows,
                 "checks": checks, **extra}
    if platform == "gpu":
        from bench_torch import card_identity

        out["card"] = card_identity()
    if errors:
        out["errors"] = errors
    if not rows:
        out["error"] = "; ".join(errors)[-1500:]
    print(json.dumps(out), flush=True)
    return 0 if rows else 1


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--child":
        dev = (sys.argv[sys.argv.index("--device") + 1]
               if "--device" in sys.argv else None)
        _child_main(sys.argv[2], "--small" in sys.argv, dev)
    else:
        sys.exit(main())
