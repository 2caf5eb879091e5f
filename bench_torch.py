"""Benchmark harness of the PyTorch/CUDA port (one JSON line on stdout).

The port's counterpart of bench.py: the same rungs, metric and result
line, measured on an NVIDIA card through luminaai_tpu_torch.

North-star metric: training tokens/s per card on the 8-expert top-2 MoE
(capacity 1.25, aux 0.01), bf16, the whole train step (forward,
backward, optimizer). vs_baseline divides by the reference's published
debug-MoE figure (59.5k tokens/s, its BENCHMARKS.md "MoE Configuration
(8 experts, top-2)"), measured on its debug preset's widths, which the
headline rung (ref_debug_moe) runs. flagship_tuned (757M total, 238M
active parameters) rides along in extras.flagship with its MFU; the
dense200 and reference-table rungs run after the line is printed and
write bench_torch_out/DENSE_BENCH.json and REF_TABLE.json.

Robustness: the parent imports no torch. It probes the card in a
subprocess (retrying a hung probe within BENCH_PROBE_BUDGET_S), runs each
rung in a child with a timeout and walks down the ladder when one fails.
Nothing runs on the CPU in place of the card: without one the line
carries value 0.0 and an "error" field, and the exit code is 1.

    python3 bench_torch.py                  # the ladder (the card)
    python3 bench_torch.py --child NAME     # one rung
    python3 bench_torch.py --serve-bench    # continuous vs micro-batched
    python3 bench_torch.py --router-bench   # 2-replica router, kill rung
    python3 bench_torch.py --smoke          # attribution surface
    (--smoke-serve / --smoke-router: the smaller tiers; add
    --device cpu to run --smoke, --smoke-serve, --serve-bench or a rung
    on the CPU, which the tests do)
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

REF_MOE_TOKENS_PER_SEC = 59_500.0
METRIC = "train_tokens_per_sec_per_chip_moe8x2"

# The reference's published throughput rows (its BENCHMARKS.md) that fit
# one card, matched dims for dims: (ref tokens/s, rung timeout s).
REF_TABLE_RUNGS = {
    "ref_debug_dense": (104_000.0, 420),   # "Debug" dense row
    "ref_200m_dense": (119_000.0, 600),    # "Debug 200M" dense row
    "ref_200m_mod": (172_000.0, 600),      # "Debug 200M" MoD cap 0.5 row
    "ref_200m_hybrid": (139_000.0, 600),   # "Debug 200M" hybrid row
}
REF_BASELINES = {
    "ref_debug_moe": REF_MOE_TOKENS_PER_SEC,
    "dense200": 119_000.0,
    **{k: v[0] for k, v in REF_TABLE_RUNGS.items()},
}

# (name, timeout_s), tried in order until one emits a valid line.
# ref_debug_moe is the headline (the reference's own debug preset widths);
# the flagship rungs follow. bench.py's CPU rung has no counterpart: a CPU
# number under a card's metric would hide the card.
LADDER = [
    ("ref_debug_moe", 420),
    ("flagship_tuned", 900),
    ("flagship", 1500),
    ("flagship_small", 600),
]
FLAGSHIP_TIMEOUT = 900
DENSE_TIMEOUT = 700

# The seed of every rung's weights and of the step's generator.
RUNG_SEED = 0
# The kernels whose launches the timed window counts.
KERNELS = ("B1", "B2", "B3", "B4a", "B4b")

_HERE = os.path.dirname(os.path.abspath(__file__))
# Where the sidecars land (git-ignored).
OUT_DIR = os.path.join(_HERE, "bench_torch_out")
# The keys of a flagship result carried into the headline's extras.
FLAGSHIP_KEYS = ("config", "total_params_m", "active_params_m", "batch",
                 "seq", "mfu", "model_tflops_per_sec", "moe_drop_rate",
                 "moe_drop_rate_steady", "step_ms", "compile_s",
                 "device_busy_share", "launches")


def _child_config(name: str, n_chips: int = 1):
    """The rungs' configurations, field for field bench.py's
    _child_config (bench.py:78-226). flagship: ~757M total / ~238M active
    MoE. Batch scales with the card count."""
    from luminaai_tpu_torch.config import Config

    if name == "ref_debug_moe":
        # The reference's headline benchmark config: its debug preset's
        # model dims, 8 experts top-2, capacity 1.25, aux 0.01, batch 256.
        return Config(
            vocab_size=1024,
            hidden_size=128,
            num_layers=2,
            num_heads=2,
            num_kv_heads=1,
            seq_length=256,
            intermediate_size=256,
            batch_size=256 * n_chips,
            use_moe=True,
            num_experts=8,
            moe_top_k=2,
            capacity_factor=1.25,
            load_balancing_weight=0.01,
            precision="bf16",
            use_flash_attention=True,
            gradient_checkpointing=False,
        )
    if name in ("flagship_tuned", "flagship", "flagship_small"):
        # flagship_tuned: dropless gmm dispatch (B4a/B4b), bf16 RoPE,
        # save_attn remat, bf16 Adam mu.
        tuned = (
            dict(
                moe_dispatch="gmm",
                rope_dtype="bf16",
                remat_policy="save_attn",
                adam_mu_dtype="bf16",
            )
            if name == "flagship_tuned"
            else {}
        )
        return Config(
            vocab_size=32768,
            hidden_size=1024,
            num_layers=10,
            num_heads=16,
            num_kv_heads=8,
            seq_length=2048,
            batch_size=(8 if name == "flagship_small" else 16) * n_chips,
            use_moe=True,
            num_experts=8,
            moe_top_k=2,
            capacity_factor=1.25,
            load_balancing_weight=0.01,
            precision="bf16",
            use_flash_attention=True,
            gradient_checkpointing=True,
            **tuned,
        )
    if name == "ref_debug_dense":
        # The reference's debug dense row: its debug dims, MoE off.
        return Config(
            vocab_size=1024,
            hidden_size=128,
            num_layers=2,
            num_heads=2,
            num_kv_heads=1,
            seq_length=256,
            intermediate_size=256,
            batch_size=256 * n_chips,
            use_moe=False,
            precision="bf16",
            use_flash_attention=True,
            gradient_checkpointing=False,
        )
    if name in ("ref_200m_dense", "ref_200m_mod", "ref_200m_hybrid"):
        # The reference's debug_200m dims under its three published
        # variants: dense, MoD cap 0.5, hybrid MoE8 + MoD.
        return Config(
            vocab_size=1024,
            hidden_size=640,
            num_layers=12,
            num_heads=8,
            num_kv_heads=8,
            seq_length=512,
            intermediate_size=2560,
            batch_size=64 * n_chips,
            use_moe=(name == "ref_200m_hybrid"),
            num_experts=8,
            moe_top_k=2,
            capacity_factor=1.25,
            load_balancing_weight=0.01,
            use_mod=(name != "ref_200m_dense"),
            mod_capacity_factor=0.5,
            precision="bf16",
            use_flash_attention=True,
            gradient_checkpointing=False,
        )
    if name == "dense200":
        # ~200M dense comparison point (ref "200M dense ~119k tok/s").
        return Config(
            vocab_size=32768,
            hidden_size=896,
            num_layers=20,
            num_heads=14,
            num_kv_heads=7,
            seq_length=2048,
            batch_size=16 * n_chips,
            use_moe=False,
            precision="bf16",
            use_flash_attention=True,
            gradient_checkpointing=True,
        )
    if name == "smoke":
        # The attribution surface's model (--smoke): seconds on any device.
        return Config(
            vocab_size=512,
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            seq_length=128,
            batch_size=4,
            use_moe=True,
            num_experts=4,
            moe_top_k=2,
            capacity_factor=1.25,
            load_balancing_weight=0.01,
            precision="fp32",
            use_flash_attention=False,
            gradient_checkpointing=False,
        )
    raise ValueError(f"unknown rung {name!r}")


def _rung_batch(cfg, device):
    """The rung's batch: RandomState(0) ids, drawn as bench.py draws them."""
    import numpy as np
    import torch

    ids = np.random.RandomState(0).randint(
        1, cfg.vocab_size, size=(cfg.batch_size, cfg.seq_length)
    )
    return {"input_ids": torch.as_tensor(ids).long().to(device)}


def _build_rung(cfg, device):
    """(model, state, step) of a rung: weights and the step's generator
    from RUNG_SEED, the port's train step and optimizer."""
    from luminaai_tpu_torch.convert import init_params
    from luminaai_tpu_torch.models.transformer import LuminaTransformer
    from luminaai_tpu_torch.parallel import train_step as ts
    from luminaai_tpu_torch.training.optimizer import (
        make_optimizer,
        make_schedule,
    )

    model = init_params(
        LuminaTransformer(cfg, device=device, trainable=True), RUNG_SEED)
    schedule = make_schedule(cfg, 1000)
    tx = make_optimizer(cfg, 1000, schedule)
    state = ts.init_train_state(model, tx, RUNG_SEED)
    step = ts.make_train_step(cfg, model, schedule, tx)
    return model, state, step


def _launch_counts() -> dict:
    """The kernel wrappers' launch counters, by kernel."""
    from luminaai_tpu_torch.ops import flash_attention as fa
    from luminaai_tpu_torch.ops import gmm as tg

    return {"B1": fa.flash_fwd.launches, "B2": fa.flash_bwd_dq.launches,
            "B3": fa.flash_bwd_dkv.launches, "B4a": tg.gmm.launches,
            "B4b": tg.tgmm.launches}


def _reset_launch_counts() -> None:
    from luminaai_tpu_torch.ops import flash_attention as fa
    from luminaai_tpu_torch.ops import gmm as tg

    fa.reset_launches()
    tg.reset_launches()


def card_identity() -> str | None:
    """The card's `name, power.limit` as nvidia-smi prints them (None
    without nvidia-smi)."""
    from luminaai_tpu_torch.utils.environment import _smi

    out = _smi(["--query-gpu=name,power.limit", "--format=csv,noheader"])
    return out.strip().splitlines()[0] if out and out.strip() else None


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _busy_share(step, state, batch, device, steps: int = 3) -> dict:
    """The card's busy share over `steps` train steps under torch.profiler
    (CUPTI): the device kernels' summed time over the host wall, and the
    flash kernels the profiler names. Not measured off the card or where
    the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return {"device_busy_share": None, "profiled_flash_kernels": []}
    _sync(device)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, metrics = step(state, batch)
        float(metrics["loss"])
        _sync(device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3) for e in
            prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(ms for _, ms in rows)
    return {
        "device_busy_share": round(busy / wall_ms, 4) if busy else None,
        "profiled_wall_ms": round(wall_ms, 2),
        "device_busy_ms": round(busy, 2),
        "profiled_flash_kernels": sorted(
            {m.group(0) for name, _ in rows
             for m in [re.search(r"flash_\w+(?:<[^>]*>)?", name)] if m}),
    }


def _child_main(name: str, device_arg: str | None = None) -> None:
    """Runs in a subprocess; prints the JSON result line."""
    child_t0 = time.perf_counter()
    budget = float(os.environ.get("BENCH_CHILD_BUDGET_S", "0") or 0)

    import numpy as np
    import torch

    from luminaai_tpu_torch.config import resolve_device
    from luminaai_tpu_torch.monitoring.attribution import (
        analytic_train_flops,
        compiled_cost_metrics,
        donation_audit,
        tree_bytes,
    )
    from luminaai_tpu_torch.monitoring.telemetry import get_registry
    from luminaai_tpu_torch.ops import flash_attention as fa
    from luminaai_tpu_torch.training.scaler import ComputeEfficiencyTracker
    from luminaai_tpu_torch.utils.environment import device_peak_flops

    device = resolve_device(device_arg)
    on_card = device.type == "cuda"
    platform = "gpu" if on_card else "cpu"
    n_chips = 1  # one child trains on one card
    cfg = _child_config(name, n_chips)
    if not on_card:
        # The kernels run on the card only; a CPU run takes the plain path.
        cfg.use_flash_attention = False
    model, state, step = _build_rung(cfg, device)
    batch = _rung_batch(cfg, device)

    # Every clock read follows a host sync: loss.item() waits for the
    # step, and synchronize() for whatever the step left queued.
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    float(metrics["loss"])
    _sync(device)
    compile_s = time.perf_counter() - t0  # kernel loads, first allocations

    state, metrics = step(state, batch)
    float(metrics["loss"])
    _sync(device)

    steps = {"smoke": 3}.get(name, 20)
    _reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step(state, batch)
    loss_val = float(metrics["loss"])
    _sync(device)
    dt = time.perf_counter() - t0
    launches = _launch_counts()
    drop_val = float(metrics.get("moe_drop_rate", 0.0))
    flash_last = ({k: fa.last_kernel(k) for k in ("B1", "B2", "B3")}
                  if on_card and launches["B1"] else {})

    registry = get_registry()
    registry.counter(
        "bench_steps_total", "Measured train steps in the bench window"
    ).inc(steps)
    registry.counter(
        "bench_tokens_total", "Tokens through the measured bench window"
    ).inc(steps * cfg.batch_size * cfg.seq_length)
    registry.histogram(
        "bench_step_seconds",
        "Mean step wall time over the measured window (count = steps)",
        buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0),
    ).observe(dt / steps, count=steps)
    registry.gauge(
        "bench_compile_seconds", "First-step wall (kernel loads included)"
    ).set(compile_s)

    # Steady-state MoE routing: the timed window starts from random init,
    # so its drop rate is an initialisation artifact. Keep stepping on
    # fresh batches and report the settled drop rate; sync every 10 steps
    # and bail at 75% of the child budget.
    drop_steady = None
    if cfg.use_moe and name != "smoke":
        rng = np.random.RandomState(1)
        extra = [
            {"input_ids": torch.as_tensor(rng.randint(
                1, cfg.vocab_size, size=(cfg.batch_size, cfg.seq_length)
            )).long().to(device)}
            for _ in range(4)
        ]
        steady_steps = 150 if on_card else 10
        tail = []
        for i in range(steady_steps):
            if budget and i % 10 == 0:
                float(metrics["loss"])
                if time.perf_counter() - child_t0 > 0.75 * budget:
                    break
            state, metrics = step(state, extra[i % 4])
            if i >= steady_steps - 10:
                tail.append(float(metrics.get("moe_drop_rate", 0.0)))
        if tail:
            drop_steady = round(sum(tail) / len(tail), 4)

    busy = (_busy_share(step, state, batch, device)
            if not budget or time.perf_counter() - child_t0 < 0.85 * budget
            else {"device_busy_share": None, "profiled_flash_kernels": [],
                  "busy_reason": "child budget exhausted before the "
                                 "profiled steps"})

    # Counted cost of one more step (monitoring/attribution.py): torch's
    # FLOP counter plus the kernels' own counts, the allocator's view of
    # memory, the analytic-vs-counted cross-check; after the timed window.
    if not budget or time.perf_counter() - child_t0 < 0.85 * budget:
        compiled_cost = compiled_cost_metrics(
            step, state, batch, program="train", registry=registry,
            analytic_flops=analytic_train_flops(
                cfg.estimate_active_parameters(),
                cfg.batch_size * cfg.seq_length,
            ),
            state=state,
        )
    else:
        compiled_cost = {
            "available": False,
            "reason": "child budget exhausted before cost analysis",
        }
    donation = donation_audit(
        compiled_cost.get("memory"), tree_bytes(state), expected=True,
        registry=registry,
    )

    tokens = steps * cfg.batch_size * cfg.seq_length
    tps_chip = tokens / dt / n_chips
    tracker = ComputeEfficiencyTracker(
        active_params=cfg.estimate_active_parameters(),
        n_chips=n_chips,
        peak_flops=device_peak_flops(device if on_card else None),
    )
    sample = tracker.record(tokens, dt)
    mfu = round(sample["mfu"], 4) if on_card else None

    sidecar_rung = (
        name == "dense200" or name in REF_TABLE_RUNGS or name == "smoke"
    )
    result = {
        "metric": (
            f"train_tokens_per_sec_per_chip_{name}"
            if sidecar_rung
            else METRIC
        ),
        "value": round(tps_chip, 1),
        "unit": "tokens/sec/chip",
        "vs_baseline": round(
            tps_chip / REF_BASELINES.get(name, REF_MOE_TOKENS_PER_SEC), 3
        ),
        "extras": {
            "chips": n_chips,
            "platform": platform,
            "device": (torch.cuda.get_device_name(device) if on_card
                       else "cpu"),
            "card": card_identity() if on_card else None,
            "config": name,
            "total_params_m": round(cfg.estimate_parameters() / 1e6, 1),
            "active_params_m": round(cfg.estimate_active_parameters() / 1e6,
                                     1),
            "batch": cfg.batch_size,
            "seq": cfg.seq_length,
            "layers": cfg.num_layers,
            "steps": steps,
            "mfu": mfu,
            "model_tflops_per_sec": round(sample["tflops_per_sec"], 2),
            "loss": round(loss_val, 4),
            "moe_drop_rate": round(drop_val, 4),
            "moe_drop_rate_steady": drop_steady,
            "step_ms": round(dt / steps * 1e3, 2),
            "compile_s": round(compile_s, 1),
            "launches": launches,
            "flash_last_kernel": flash_last,
            **busy,
            "use_flash_attention": cfg.use_flash_attention,
            "moe_dispatch": cfg.moe_dispatch if cfg.use_moe else None,
            "compiled_cost": compiled_cost,
            "donation_audit": donation,
            "telemetry": registry.snapshot(),
        },
    }
    if name == "smoke":
        _smoke_extras(result, cfg, model, state, metrics, registry, steps,
                      tps_chip, device, budget, child_t0)
    if name == "ref_debug_moe":
        result["extras"]["note"] = (
            "reference's own headline benchmark config (debug preset dims, "
            "ref BENCHMARKS.md ~59.5k tok/s row): apples-to-apples model "
            "scale for vs_baseline"
        )
    print(json.dumps(result), flush=True)
    if name == "smoke" and "error" in result:
        sys.exit(1)


def _smoke_extras(result, cfg, model, state, metrics, registry, steps,
                  tps_chip, device, budget, child_t0) -> None:
    """--smoke's extras: the decode step's counted cost, the dispatch A/B,
    the recompile surface, the expert-dispatch and gradient-reduction
    audits, optimizer memory, router health, durable I/O, the
    preempt-and-resume cycle with its goodput and SLO verdicts, and the
    event spine. A failed resume or missing SLO verdicts set "error"."""
    from luminaai_tpu_torch.monitoring.events import get_recorder
    from luminaai_tpu_torch.monitoring.telemetry import register_build_info
    from luminaai_tpu_torch.training.optimizer import (
        describe_optimizer_memory,
    )

    def within(frac):
        return not budget or time.perf_counter() - child_t0 < frac * budget

    ex = result["extras"]
    ex["decode_compiled_cost"] = _smoke_decode_cost(cfg, model, registry)
    ex["moe_dispatch_flops"] = (
        _smoke_dispatch_flops(device, registry) if within(0.6) else {
            "available": False,
            "reason": "child budget exhausted before dispatch A/B"})
    ex["recompile_surface"] = (
        _smoke_recompile_surface(registry) if within(0.75) else {
            "available": False,
            "reason": "child budget exhausted before surface audit"})
    ex["ep_dispatch"] = _smoke_audit("audit_ep_dispatch") if within(0.8) \
        else {"available": False,
              "reason": "child budget exhausted before ep-dispatch audit"}
    ex["grad_reduce"] = _smoke_audit("audit_grad_reduce") if within(0.85) \
        else {"available": False,
              "reason": "child budget exhausted before grad-reduce audit"}
    ex["optimizer_memory"] = describe_optimizer_memory(state.opt_state)
    ex["router_health"] = _router_health_extras(metrics)
    ex["io_resilience"] = _smoke_io_resilience()
    resume_check = _smoke_resume_check(device)
    ex["resumed_exact_data_state"] = resume_check.pop(
        "resumed_exact_data_state")
    ex["goodput"] = resume_check.pop("goodput", None) or {
        "available": False,
        "reason": "resume check did not produce a ledger",
    }
    slo = resume_check.pop("slo", None)
    ex["slo"] = (
        {"available": True, **slo}
        if isinstance(slo, dict) and slo.get("objectives")
        else {"available": False,
              "reason": "resume check produced no slo verdicts"}
    )
    ex["resume_check"] = resume_check
    rec = get_recorder()
    rec.emit("bench_window", config="smoke", steps=steps,
             platform=ex["platform"],
             tokens_per_sec_per_chip=round(tps_chip, 1))
    ex["events"] = {"counts": rec.counts_by_type(), "buffered": len(rec),
                    "dropped": rec.dropped}
    ex["note"] = ("attribution + resume surface check, not a performance "
                  "claim")
    register_build_info(registry, config=cfg)
    ex["telemetry"] = registry.snapshot()
    if ex["resumed_exact_data_state"] is not True:
        result["error"] = "resumed_exact_data_state_false"
    elif not ex["slo"].get("available"):
        result["error"] = "slo_verdicts_missing"


def _pctl(xs, p):
    """Percentile of a small sample (nearest-rank on the sorted list)."""
    if not xs:
        return None
    xs = sorted(xs)
    k = min(len(xs) - 1, max(0, int(round(p / 100.0 * (len(xs) - 1)))))
    return xs[k]


def _card_layout(cfg, device):
    """The decode kernel (B5) takes bf16 and head_dim a multiple of 64
    (ops/ragged_paged_attention.py ragged_eligible), and a decode shape it
    refuses raises on the card. So on the card a small serving model keeps
    its hidden width, depth and vocabulary with 64-wide heads (kv heads
    half the q heads, at least one) in bf16; on the CPU it stays as
    given. -> (config, what changed or None)."""
    import dataclasses

    if device.type != "cuda" or (cfg.head_dim() % 64 == 0
                                 and cfg.precision == "bf16"):
        return cfg, None
    heads = max(1, cfg.hidden_size // 64)
    out = dataclasses.replace(cfg, num_heads=heads,
                              num_kv_heads=max(1, heads // 2),
                              precision="bf16")
    return out, {"num_heads": out.num_heads,
                 "num_kv_heads": out.num_kv_heads, "head_dim": 64,
                 "precision": "bf16",
                 "why": "the decode kernel takes bf16 at head_dim % 64 == 0"}


class _StubTok:
    """Minimal engine tokenizer contract; no tokenizer data needed."""

    eos_token_id = 1
    pad_token_id = 0
    im_end = 2

    class backend:
        @staticmethod
        def encode(text):
            return [3 + (ord(c) % 200) for c in text]

    @staticmethod
    def decode(tokens):
        return " ".join(str(t) for t in tokens)


def _serve_run_continuous(sched, prompts, budgets):
    """Drive the ContinuousScheduler with one thread per request through
    submit_stream, timestamping every token.
    Returns (total_tokens, wall_s, inter_token_gaps_s, ttft_s)."""
    import threading

    results = [None] * len(prompts)

    def worker(i):
        t_s = time.perf_counter()
        stamps = []
        for item in sched.submit_stream(
            prompts[i],
            {"max_new_tokens": budgets[i], "temperature": 0.0,
             "repetition_penalty": 1.0},
        ):
            if isinstance(item, dict):
                break
            stamps.append(time.perf_counter())
        results[i] = (t_s, stamps)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    tokens = sum(len(stamps) for _, stamps in results)
    gaps, ttft = [], []
    for t_s, stamps in results:
        if stamps:
            ttft.append(stamps[0] - t_s)
        gaps += [b - a for a, b in zip(stamps, stamps[1:])]
    return tokens, wall, gaps, ttft


def _serve_run_legacy(batcher, prompts, budgets):
    """The same workload through the run-to-completion MicroBatcher.
    Returns (total_tokens, wall_s, ttft_s, ms_per_token_s): the whole reply
    arrives at once, so a request's first token comes with its last, and
    its gap is its wall over its tokens."""
    import threading

    results = [None] * len(prompts)

    def worker(i):
        t_s = time.perf_counter()
        out = batcher.submit(
            prompts[i],
            {"max_new_tokens": budgets[i], "temperature": 0.0,
             "repetition_penalty": 1.0},
        )
        results[i] = (out, time.perf_counter() - t_s)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    tokens = sum(len(toks) for (toks, _), _ in results)
    return (tokens, wall, [t for _, t in results],
            [t / len(toks) for (toks, _), t in results if toks])


def _serve_bench_main(smoke: bool, device_arg: str | None = None) -> None:
    """Serving A/B: continuous batching (slot-paged pool, step-level
    admission) against the MicroBatcher on a mixed-max_new workload, plus
    the shared-prefix tier (radix prefix cache on vs off) and the SLO
    stack over the serving registry. bench.py's model, widths and stub
    tokenizer, random weights, on the card (the heads made 64 wide in
    bf16 there, _card_layout) or on the CPU with --device cpu. Prints ONE
    JSON line; on failure it carries "error" and the exit code is 1."""
    result = {
        "metric": "serve_tokens_per_sec_continuous",
        "value": 0.0,
        "unit": "tokens/sec",
        "vs_baseline": 0.0,
    }
    sched = None
    try:
        import threading

        import numpy as np
        import torch

        from luminaai_tpu_torch.config import Config, resolve_device
        from luminaai_tpu_torch.convert import init_params
        from luminaai_tpu_torch.inference.generate import GenerationEngine
        from luminaai_tpu_torch.models.transformer import LuminaTransformer
        from luminaai_tpu_torch.monitoring.slo import build_slo_stack
        from luminaai_tpu_torch.monitoring.telemetry import (
            MetricsRegistry,
            register_build_info,
        )
        from luminaai_tpu_torch.ops import ragged_paged_attention as rpa
        from luminaai_tpu_torch.serving.server import (
            ContinuousScheduler,
            MicroBatcher,
        )

        device = resolve_device(device_arg)
        cfg, layout = _card_layout(Config(
            vocab_size=512,
            hidden_size=64 if smoke else 128,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            seq_length=512,
            use_flash_attention=False,
            precision="fp32",
            gradient_checkpointing=False,
            max_new_tokens=32,
        ), device)
        model = init_params(LuminaTransformer(cfg, device=device), 0)
        engine = GenerationEngine(model, _StubTok(), cfg)

        n_req = 8 if smoke else 16
        budget_cycle = [4, 8, 24] if smoke else [8, 64, 256]
        budgets = [budget_cycle[i % len(budget_cycle)] for i in range(n_req)]
        rs = np.random.RandomState(0)
        prompts = [
            rs.randint(3, cfg.vocab_size, size=int(rs.randint(4, 24))).tolist()
            for _ in range(n_req)
        ]
        num_slots = 4 if smoke else 8
        serve_registry = MetricsRegistry()
        sched = ContinuousScheduler(
            engine, num_slots=num_slots, page_size=64,
            registry=serve_registry,
        )
        legacy = MicroBatcher(engine, max_batch=num_slots, window_ms=100.0)

        # A warm pass first (kernel loads, allocator), then the measured.
        _serve_run_continuous(sched, prompts, budgets)
        _serve_run_legacy(legacy, prompts, budgets)
        b5_before = rpa.ragged_paged_attention.launches
        c_tokens, c_wall, gaps, ttft = _serve_run_continuous(
            sched, prompts, budgets)
        b5_continuous = rpa.ragged_paged_attention.launches - b5_before
        b5_before = rpa.ragged_paged_attention.launches
        l_tokens, l_wall, l_ttft, l_gaps = _serve_run_legacy(
            legacy, prompts, budgets)
        b5_legacy = rpa.ragged_paged_attention.launches - b5_before
        cont_tps = c_tokens / max(c_wall, 1e-9)
        leg_tps = l_tokens / max(l_wall, 1e-9)

        # -- shared-prefix tier: 8 requests sharing a 192-token prefix
        # through the scheduler with the radix prefix cache on vs off.
        rs2 = np.random.RandomState(7)
        shared_prefix = rs2.randint(3, cfg.vocab_size, size=192).tolist()
        prefix_reqs = [
            shared_prefix + rs2.randint(3, cfg.vocab_size, size=12).tolist()
            for _ in range(8)
        ]
        greedy = {"max_new_tokens": 4, "temperature": 0.0,
                  "repetition_penalty": 1.0}

        def prefix_tier(cache_pages):
            reg = MetricsRegistry()
            tier = ContinuousScheduler(
                GenerationEngine(model, _StubTok(), cfg),
                num_slots=num_slots, page_size=64, registry=reg,
                prefix_cache_pages=cache_pages,
            )
            try:
                # The prefix's first use pays the cold prefill (and, cache
                # on, harvests its pages); its seconds are subtracted.
                tier.submit(list(prefix_reqs[0]), dict(greedy))
                warm = reg.snapshot().get("serve_prefill_seconds") or {}
                warm_s = float(warm.get("sum") or 0.0)
                ths = [threading.Thread(target=tier.submit,
                                        args=(list(p), dict(greedy)))
                       for p in prefix_reqs]
                for t in ths:
                    t.start()
                for t in ths:
                    t.join()
                hist = reg.snapshot().get("serve_prefill_seconds") or {}
                cache = getattr(tier.decoder, "prefix_cache", None)
                return (max(0.0, float(hist.get("sum") or 0.0) - warm_s),
                        cache.stats() if cache is not None else None)
            finally:
                tier.close()

        cold_prefill_s, _ = prefix_tier(0)
        cached_prefill_s, pc = prefix_tier(24)
        pc = pc or {}
        prompt_tokens_total = (sum(len(p) for p in prefix_reqs)
                               + len(prefix_reqs[0]))
        saved = int(pc.get("tokens_saved", 0))
        prefix_cache = {
            "requests": len(prefix_reqs) + 1,
            "prefix_tokens": len(shared_prefix),
            "prompt_tokens_total": prompt_tokens_total,
            "hit_rate": pc.get("hit_rate", 0.0),
            "hits": pc.get("hits", 0),
            "misses": pc.get("misses", 0),
            "pages_shared": pc.get("pages_spliced", 0),
            "pages_cached": pc.get("pages_cached", 0),
            "prefill_tokens_saved": saved,
            "prefill_seconds_cached": round(cached_prefill_s, 4),
            "prefill_seconds_cold": round(cold_prefill_s, 4),
            "prefill_seconds_ratio": (
                round(cached_prefill_s / cold_prefill_s, 4)
                if cold_prefill_s else None),
        }
        if saved < 0.5 * prompt_tokens_total:
            result["error"] = "prefix_cache_tokens_saved_below_half"
        elif not prefix_cache["hit_rate"] > 0:
            result["error"] = "prefix_cache_no_hits"

        # -- SLO engine over the serving registry.
        register_build_info(serve_registry, config=cfg)
        slo_ring, slo_engine = build_slo_stack(
            cfg, registry=serve_registry, program="serve")
        for _ in range(3):
            slo_ring.sample_once()
        slo_extras = {"available": True, **slo_engine.verdicts(),
                      "ring": slo_ring.stats()}

        def ms(xs, p):
            v = _pctl(xs, p)
            return None if v is None else round(1e3 * v, 2)

        decode_path = ("B5" if b5_continuous else "plain")
        result.update(
            value=round(cont_tps, 1),
            # Baseline: the micro-batched path on the same workload and
            # device; > 1.0 means continuous batching wins.
            vs_baseline=round(cont_tps / max(leg_tps, 1e-9), 3),
            extras={
                "platform": "gpu" if device.type == "cuda" else "cpu",
                "device": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"),
                "card": (card_identity() if device.type == "cuda"
                         else None),
                "mode": "smoke" if smoke else "full",
                "model": {"hidden": cfg.hidden_size,
                          "layers": cfg.num_layers,
                          "heads": cfg.num_heads,
                          "kv_heads": cfg.num_kv_heads,
                          "head_dim": cfg.head_dim(),
                          "precision": cfg.precision,
                          "card_layout": layout},
                "decode_path": decode_path,
                "b5_launches": {"continuous": b5_continuous,
                                "legacy": b5_legacy},
                "requests": n_req,
                "max_new_mix": budget_cycle,
                "num_slots": num_slots,
                "page_size": 64,
                "tokens_continuous": c_tokens,
                "tokens_legacy": l_tokens,
                "legacy_tokens_per_sec": round(leg_tps, 1),
                "speedup_vs_microbatch": round(
                    cont_tps / max(leg_tps, 1e-9), 3),
                "latency_ms_per_token": {"p50": ms(gaps, 50),
                                         "p95": ms(gaps, 95)},
                "ttft_ms": {"p50": ms(ttft, 50), "p95": ms(ttft, 95)},
                "legacy_ttft_ms": {"p50": ms(l_ttft, 50),
                                   "p95": ms(l_ttft, 95)},
                "legacy_ms_per_token": {"p50": ms(l_gaps, 50),
                                        "p95": ms(l_gaps, 95)},
                "decode_steps": int(sched.decoder.steps),
                "slot_reuses": int(sched.decoder.pool.reuses),
                "prefill_chunk_tokens": int(
                    getattr(sched.decoder, "prefill_chunk", 0)),
                "prefix_cache": prefix_cache,
                "slo": slo_extras,
                "telemetry": serve_registry.snapshot(),
                "telemetry_passes": "warmup+measured",
            },
        )
        if "error" not in result and device.type == "cuda" and (
                not b5_continuous):
            result["error"] = "decode_did_not_launch_B5_on_the_card"
    except Exception as e:  # the line must stay parseable
        result["error"] = f"{type(e).__name__}: {e}"
    finally:
        if sched is not None:  # the MicroBatcher's worker is a daemon
            sched.close()
    if "error" not in result and not result.get("extras", {}).get(
            "telemetry"):
        result["error"] = "telemetry_snapshot_missing"
    if "error" not in result and not (
            result.get("extras", {}).get("slo", {}).get("objectives")):
        result["error"] = "slo_verdicts_missing"
    print(json.dumps(result), flush=True)
    if "error" in result:
        sys.exit(1)


def _page_share_extras(smoke: bool, device_arg: str | None = None) -> dict:
    """extras.page_share of the router bench: a shared-prefix workload
    priced cache-on vs cache-off. Replica B pulls replica A's harvested
    pages through the real PageShareClient fetch path (loopback seams, no
    sockets; the owner side is ChatServer's export route core), and every
    later admission rides the splice. A tiny real model on the device
    given (prefill only: its chunks take the plain attention)."""
    try:
        from types import SimpleNamespace

        from luminaai_tpu_torch.config import Config, resolve_device
        from luminaai_tpu_torch.convert import init_params
        from luminaai_tpu_torch.data.tokenizer import ConversationTokenizer
        from luminaai_tpu_torch.inference.generate import GenerationEngine
        from luminaai_tpu_torch.models.transformer import LuminaTransformer
        from luminaai_tpu_torch.serving.page_share import PageShareClient
        from luminaai_tpu_torch.serving.server import ChatServer

        device = resolve_device(device_arg)
        tok = ConversationTokenizer()
        cfg = Config(
            vocab_size=tok.vocab_size, hidden_size=64, num_layers=2,
            num_heads=1, num_kv_heads=1, seq_length=256,
            use_flash_attention=False, precision="fp32",
            gradient_checkpointing=False, max_new_tokens=4,
            prefill_chunk_size=32,
        )
        model = init_params(LuminaTransformer(cfg, device=device), 0)
        engine = GenerationEngine(model, tok, cfg)

        def mk(cache):
            kw = dict(num_slots=2, page_size=32, max_slot_tokens=192)
            if cache:
                kw["prefix_cache_pages"] = 6
            return engine.make_stepwise(**kw)

        class _Loopback(PageShareClient):
            """Router and owner conversations short-circuited onto the
            in-process owner decoder; fetch_page stays the real code."""

            def __init__(self, owner):
                super().__init__("http://router:0", self_url="http://b:1",
                                 timeout_s=10.0)
                self.owner = owner

            def lookup(self, keys, have=0):
                idx = self.owner.prefix_cache._index
                owned = []
                for k in keys:
                    if k not in idx:
                        break
                    owned.append(k)
                if len(owned) <= have:
                    return None, []
                return "http://a:0", owned

            def get_bytes(self, base_url, path, timeout_s=None):
                key = path.rsplit("/", 1)[1]
                payload = ChatServer.export_page_by_key(SimpleNamespace(
                    batcher=SimpleNamespace(decoder=self.owner)), key)
                return (404, b"") if payload is None else (200, payload)

        shared = tok.encode_text(
            "the quick brown fox jumps over the lazy dog " * 3)[:96]
        n = 3 if smoke else 8
        prompts = [shared + tok.encode_text(f"suffix {i}") for i in range(n)]
        warm = tok.encode_text("warmup pass only " * 8)[:80]

        def admit(dec, prompt):
            s = dec.acquire_slot()
            if device.type == "cuda":
                import torch

                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            st = dec.start_prefill(s, prompt, max_new_tokens=1)
            info = None
            while info is None:
                info = dec.advance_prefill(st)
            dt = time.perf_counter() - t0
            dec.release_slot(s)
            return dt, info

        dec_off = mk(cache=False)
        admit(dec_off, warm)
        off_s = sum(admit(dec_off, p)[0] for p in prompts)

        dec_a = mk(cache=True)
        admit(dec_a, warm)
        admit(dec_a, prompts[0])  # A computes and harvests the prefix
        dec_a.flush_harvests()
        dec_b = mk(cache=True)
        admit(dec_b, warm)
        dec_b.page_share = _Loopback(dec_a)
        on_s, hits, saved = 0.0, 0, 0
        for p in prompts:
            dt, info = admit(dec_b, p)
            on_s += dt
            pages = int(info["prefix"]["hit_pages"])
            if pages:
                hits += 1
            saved += pages * 32
        tokens_off = sum(len(p) for p in prompts)
        return {
            "device": device.type,
            "requests": n,
            "cross_replica_hit_rate": round(hits / n, 3),
            "remote_hit_admissions": dec_b.remote_hits,
            "pull_failures": dec_b.remote_pull_failures,
            "prefill_seconds_cache_on": round(on_s, 4),
            "prefill_seconds_cache_off": round(off_s, 4),
            "prefill_tokens_cache_on": tokens_off - saved,
            "prefill_tokens_cache_off": tokens_off,
        }
    except Exception as e:  # nested: the routing rungs stand on their own
        return {"error": f"{type(e).__name__}: {e}"}


def _router_bench_main(smoke: bool, device_arg: str | None = None) -> None:
    """Serving-plane router bench: a 2-replica local fleet behind the
    port's router (serving/router.py), then the kill-one-replica rung.
    Headline: tokens/s through the router; vs_baseline: the same workload
    driven at ONE replica directly. extras.router: failovers > 0,
    post-kill success rate 1.0, a breaker opened. The replicas run a
    synthetic engine (the rung measures routing, not decode); loopback
    sockets only; ONE JSON line, "error" and exit 1 on any failure."""
    result = {
        "metric": "router_tokens_per_sec_2replica",
        "value": 0.0,
        "unit": "tokens/sec",
        "vs_baseline": 0.0,
    }
    try:
        import threading
        import types
        import urllib.error
        import urllib.request
        from http.server import ThreadingHTTPServer

        from luminaai_tpu_torch.config import Config
        from luminaai_tpu_torch.monitoring.events import FlightRecorder
        from luminaai_tpu_torch.monitoring.telemetry import MetricsRegistry
        from luminaai_tpu_torch.serving.router import Router
        from luminaai_tpu_torch.serving.server import ChatServer
        from luminaai_tpu_torch.testing.faults import kill_replica

        class _Backend:
            def encode(self, text):
                return [ord(c) % 250 for c in text]

        class _Tok:
            backend = _Backend()

            def decode(self, tokens):
                return "tok:" + ",".join(str(t) for t in tokens)

        class _Eng:
            """The engine contract ChatServer reads, at a fixed pace per
            token, so tokens/s measures the routing plane."""

            TICK_S = 0.0005

            def __init__(self):
                self.config = Config(
                    vocab_size=256, hidden_size=64, num_layers=2,
                    num_heads=4, num_kv_heads=2, seq_length=64,
                    use_flash_attention=False,
                )
                self.tokenizer = _Tok()

            def generate(self, prompt_tokens, max_new_tokens=16, **kw):
                n = max(1, min(int(max_new_tokens), 64))
                time.sleep(self.TICK_S * n)
                toks = [t % 250 for t in list(prompt_tokens)[:n]] or [1]
                return toks, {"tokens_generated": len(toks),
                              "stopped": "eos"}

            def generate_batch(self, prompts, **kw):
                return [self.generate(p, **kw) for p in prompts]

            def encode_chat(self, messages):
                return self.tokenizer.backend.encode(
                    messages[-1]["content"])

        def _spawn_replica():
            srv = ChatServer(_Eng(), registry=MetricsRegistry())
            httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                        srv.make_handler())
            threading.Thread(target=httpd.serve_forever,
                             daemon=True).start()
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            return types.SimpleNamespace(server=srv, httpd=httpd, url=url)

        replicas = [_spawn_replica(), _spawn_replica()]
        recorder = FlightRecorder(capacity=4096)
        registry = MetricsRegistry()
        router = Router(
            [("r0", replicas[0].url), ("r1", replicas[1].url)],
            registry=registry, recorder=recorder,
            probe_interval_s=0.2, breaker_failures=3,
            breaker_cooldown_s=1.0, max_failovers=1,
        )
        router.probe_all()
        httpd_r = ThreadingHTTPServer(("127.0.0.1", 0),
                                      router.make_handler())
        threading.Thread(target=httpd_r.serve_forever, daemon=True).start()
        router_url = f"http://127.0.0.1:{httpd_r.server_address[1]}"

        prompts = [
            "system alpha: summarize the day",
            "system beta: write a haiku now",
            "system gamma: translate to french",
            "system delta: count to twenty",
        ]

        def drive(base, n, out, offset=0):
            for i in range(n):
                body = {"prompt": prompts[(offset + i) % len(prompts)],
                        "max_new_tokens": 16}
                req = urllib.request.Request(
                    base + "/v1/generate", data=json.dumps(body).encode(),
                    headers={"Content-Type": "application/json"},
                )
                try:
                    with urllib.request.urlopen(req, timeout=30) as r:
                        out.append((r.status, json.loads(r.read())))
                except urllib.error.HTTPError as e:
                    out.append((e.code, {}))
                except Exception as e:  # transport-level failure
                    out.append((0, {"error": str(e)}))

        per_client = 6 if smoke else 24
        n_clients = 4

        def clients(base, out):
            ts = [threading.Thread(target=drive,
                                   args=(base, per_client, out, c))
                  for c in range(n_clients)]
            t0 = time.perf_counter()
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            return time.perf_counter() - t0

        base_out: list = []
        base_dt = clients(replicas[0].url, base_out)
        base_tps = sum(p.get("tokens", 0) for _, p in base_out) / max(
            base_dt, 1e-9)
        routed_out: list = []
        routed_dt = clients(router_url, routed_out)
        routed_tps = sum(p.get("tokens", 0) for _, p in routed_out) / max(
            routed_dt, 1e-9)
        n_routed = len(routed_out)
        routed_ok = sum(1 for c, _ in routed_out if c == 200)
        total = max(1, sum(x.requests for x in router.replicas))
        share = {r.name: round(r.requests / total, 3)
                 for r in router.replicas}

        # -- kill-one-replica rung
        kill_replica(replicas[1])
        post_out: list = []
        drive(router_url, 4 if smoke else 8, post_out)  # organic failover
        router.probe_all()  # the dead endpoint trips its breaker
        drive(router_url, 4 if smoke else 8, post_out, offset=2)
        failovers = len(recorder.snapshot(type="router_failover"))
        breaker_opened = bool(recorder.snapshot(type="breaker_open"))
        post_rate = sum(1 for c, _ in post_out if c == 200) / max(
            1, len(post_out))

        httpd_r.shutdown()
        httpd_r.server_close()
        replicas[0].httpd.shutdown()
        replicas[0].httpd.server_close()

        result.update(
            value=round(routed_tps, 1),
            vs_baseline=round(routed_tps / max(base_tps, 1e-9), 3),
            extras={
                "mode": "smoke" if smoke else "full",
                "requests": n_routed,
                "direct_tokens_per_sec": round(base_tps, 1),
                "router": {
                    "replicas": 2,
                    "routed_ok": routed_ok,
                    "routed_requests": n_routed,
                    "per_replica_share": share,
                    "failovers": failovers,
                    "post_kill_requests": len(post_out),
                    "post_kill_success_rate": round(post_rate, 3),
                    "breaker_opened": breaker_opened,
                    "breaker_states": {r.name: r.breaker.state
                                       for r in router.replicas},
                },
                "page_share": _page_share_extras(smoke, device_arg),
            },
        )
        if routed_ok != n_routed:
            result["error"] = (
                f"routed phase lost requests: {routed_ok}/{n_routed}")
        elif failovers < 1:
            result["error"] = "kill rung produced zero failovers"
        elif post_rate != 1.0:
            result["error"] = f"post-kill success rate {post_rate} != 1.0"
        elif not breaker_opened:
            result["error"] = "breaker never opened after replica kill"
    except Exception as e:  # the line must stay parseable
        result["error"] = f"{type(e).__name__}: {e}"
    print(json.dumps(result), flush=True)
    if "error" in result:
        sys.exit(1)


def _probe_backend(timeout: int = 90, budget_s: float | None = None):
    """Wait-for-card probe: in a throwaway process, torch.cuda and one
    256 x 256 bf16 matmul on the card, reporting (platform | None, diag).
    platform is "gpu" when the card answered, "none" when the probe
    answered that there is no card (returned at once), None when it never
    answered within BENCH_PROBE_BUDGET_S (default 25 min). A hung probe
    earns the whole budget; a probe that crashes fast gets at most five
    minutes of retries, a minute apart."""
    if budget_s is None:
        try:
            budget_s = float(os.environ.get("BENCH_PROBE_BUDGET_S", "1500"))
        except ValueError:
            budget_s = 1500.0  # a malformed env must not cost the line
        if not (0 <= budget_s < 86_400):  # nan/inf/negative: same rule
            budget_s = 1500.0
    code = (
        "import torch\n"
        "if not torch.cuda.is_available():\n"
        "    print(0, 'none')\n"
        "else:\n"
        "    x = torch.ones(256, 256, dtype=torch.bfloat16, device='cuda')\n"
        "    float((x @ x).float().sum())\n"
        "    print(torch.cuda.device_count(), 'gpu')\n"
    )
    t0 = time.monotonic()
    deadline = t0 + budget_s
    attempts = 0
    saw_hang = False
    last_err = ""
    while True:
        attempts += 1
        try:
            proc = subprocess.run(
                [sys.executable, "-c", code], capture_output=True,
                text=True, timeout=timeout, cwd=_HERE,
            )
            if proc.returncode == 0:
                parts = proc.stdout.split()
                platform = parts[1] if len(parts) >= 2 else "unknown"
                return platform, (
                    f"backend_probe={platform}"
                    f"(attempts={attempts},"
                    f"waited={int(time.monotonic() - t0)}s)")
            err_lines = (proc.stderr or "").strip().splitlines()
            last_err = (err_lines[-1][-160:] if err_lines
                        else f"rc={proc.returncode}")
        except subprocess.TimeoutExpired:
            saw_hang = True
        eff_deadline = deadline
        if not saw_hang and last_err:
            eff_deadline = min(deadline, t0 + min(300.0, budget_s))
        if time.monotonic() + 60 >= eff_deadline:
            err_note = f",last_err={last_err}" if last_err else ""
            return None, (
                f"backend_probe=failed(attempts={attempts},"
                f"waited={int(time.monotonic() - t0)}s,"
                f"budget={int(budget_s)}s{err_note})")
        time.sleep(60)


def _run_child(name: str, timeout: int):
    """Run one rung in a child; (parsed_json | None, diagnostic)."""
    from bench_common_torch import run_child

    env = dict(os.environ)
    env["BENCH_CHILD_BUDGET_S"] = str(timeout)
    return run_child(
        [sys.executable, os.path.abspath(__file__), "--child", name],
        timeout,
        validate=lambda p: str(p.get("metric", "")).startswith(
            "train_tokens_per_sec_per_chip"),
        label=name, env=env, cwd=_HERE,
    )


def _build_kernels(timeout: int = 900) -> str:
    """Build every kernel source once, in a child (one nvcc per source,
    started together), so no rung's first step pays nvcc: its compile_s
    then counts the library loads and first allocations."""
    code = ("from luminaai_tpu_torch.ops import _build\n"
            "print(f'built in {_build.build_all():.1f}s')\n")
    try:
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True,
                              timeout=timeout, cwd=_HERE)
    except subprocess.TimeoutExpired:
        return f"kernel_build=timeout after {timeout}s"
    if proc.returncode != 0:
        err = (proc.stderr or "").strip().splitlines()
        return f"kernel_build=failed({err[-1][-300:] if err else ''})"
    return f"kernel_build=ok({proc.stdout.strip()})"


def _write_sidecar(name: str, payload) -> None:
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, name), "w") as f:
        json.dump(payload, f, indent=2)


def _error_line(diagnostics) -> dict:
    return {"metric": METRIC, "value": 0.0, "unit": "tokens/sec/chip",
            "vs_baseline": 0.0, "error": "; ".join(diagnostics)[-1500:]}


def _sidecars() -> None:
    """The dense rung and the reference-table sweep, after the line is
    printed: a sidecar that hangs costs its file, never the headline."""
    dense, ddiag = _run_child("dense200", DENSE_TIMEOUT)
    if dense is not None:
        dense["baseline_note"] = "ref dense 200M ~119k tok/s"
        _write_sidecar("DENSE_BENCH.json", dense)
    else:
        _write_sidecar("DENSE_BENCH.json", {"config": "dense200",
                                            "error": ddiag[-300:]})
    table = []
    for rname, (ref_tps, rtimeout) in REF_TABLE_RUNGS.items():
        res, rdiag = _run_child(rname, rtimeout)
        if res is not None:
            ex = res.get("extras", {})
            table.append({
                "config": rname,
                "tokens_per_sec_per_chip": res["value"],
                "ref_tokens_per_sec": ref_tps,
                "vs_ref": res["vs_baseline"],
                "step_ms": ex.get("step_ms"),
                "mfu": ex.get("mfu"),
                "compile_s": ex.get("compile_s"),
                "device_busy_share": ex.get("device_busy_share"),
                "launches": ex.get("launches"),
                "batch": ex.get("batch"),
                "seq": ex.get("seq"),
                "card": ex.get("card"),
            })
        else:
            table.append({"config": rname, "error": rdiag[-300:]})
    _write_sidecar("REF_TABLE.json", {
        "note": ("matched-dims counterparts of the reference "
                 "BENCHMARKS.md debug-scale rows, measured on the card"),
        "rows": table,
    })


def main() -> int:
    diagnostics = []
    platform, probe_diag = _probe_backend()
    diagnostics.append(probe_diag)
    if platform != "gpu":
        # No card: no number. A CPU run would measure the wrong device.
        print(json.dumps(_error_line(diagnostics)), flush=True)
        return 1
    build_diag = _build_kernels()
    diagnostics.append(build_diag)
    if not build_diag.startswith("kernel_build=ok"):
        print(json.dumps(_error_line(diagnostics)), flush=True)
        return 1

    for name, timeout in LADDER:
        result, diag = _run_child(name, timeout)
        diagnostics.append(diag)
        if result is None:
            continue
        extras = result.setdefault("extras", {})
        if name == "ref_debug_moe":
            # The MFU rung rides along: one bounded attempt, captured
            # before the headline prints.
            fres, fdiag = _run_child("flagship_tuned", FLAGSHIP_TIMEOUT)
            diagnostics.append(fdiag)
            if fres is not None:
                fex = fres.get("extras", {})
                extras["flagship"] = {
                    "value": fres.get("value"),
                    "vs_ref_debug_baseline": fres.get("vs_baseline"),
                    **{k: fex.get(k) for k in FLAGSHIP_KEYS},
                }
        failed = [d for d in diagnostics[2:] if not d.endswith(": ok")]
        if failed:
            extras["ladder_diag"] = failed
        extras["probe"] = probe_diag
        extras["kernel_build"] = build_diag
        print(json.dumps(result), flush=True)
        _sidecars()
        return 0
    print(json.dumps(_error_line(diagnostics)), flush=True)
    return 1


# ---------------------------------------------------------------------------
# --smoke helpers
# ---------------------------------------------------------------------------
def _router_health_extras(metrics) -> dict:
    """MoE router health from one train step's metrics: normalised
    per-expert load (sums to ~1.0), routing entropy, max expert share."""
    import numpy as np

    util = metrics.get("expert_utilization")
    if util is None:
        return {"available": False, "reason": "no expert_utilization"}
    try:
        util = np.asarray(util.detach().float().cpu(), dtype=np.float64)
        total = float(util.sum())
        if not np.isfinite(total) or total <= 0:
            return {"available": False, "reason": f"bad load sum {total}"}
        load = util / total

        def scalar(key):
            v = metrics.get(key)
            if v is None:
                return None
            f = float(v)
            return round(f, 4) if math.isfinite(f) else None

        return {
            "available": True,
            "expert_load": [round(float(x), 4) for x in load],
            "load_sum": round(float(load.sum()), 4),
            "router_entropy": scalar("moe_router_entropy"),
            "max_expert_share": scalar("moe_max_expert_share"),
            "drop_rate": scalar("moe_drop_rate"),
        }
    except Exception as e:
        return {"available": False, "reason": f"{type(e).__name__}: {e}"}


def _smoke_resume_check(device) -> dict:
    """Preempt-and-resume cycle on a tiny trainer: train, inject a
    preemption after step 3 (blocking emergency save + data cursor),
    resume in a FRESH trainer, finish. Reports resumed_exact_data_state
    and the resumed run's goodput ledger and SLO verdicts."""
    import shutil
    import tempfile

    import numpy as np

    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.data.dataset import PrefetchLoader
    from luminaai_tpu_torch.monitoring.telemetry import MetricsRegistry
    from luminaai_tpu_torch.testing.faults import preempt_at_step
    from luminaai_tpu_torch.training.trainer import Trainer

    tmp = tempfile.mkdtemp(prefix="bench_smoke_resume_")
    try:
        def cfg(max_steps):
            return Config(
                vocab_size=128, hidden_size=32, num_layers=1, num_heads=2,
                num_kv_heads=1, seq_length=32, batch_size=4,
                use_moe=False, use_flash_attention=False,
                gradient_checkpointing=False, precision="fp32",
                max_steps=max_steps, eval_every_n_batches=10**6,
                save_every_n_batches=10**6, health_check_interval=10,
                output_dir=tmp, learning_rate=1e-3,
            )

        def loader():
            def gen(epoch=0):
                rng = np.random.RandomState(epoch)
                for _ in range(50):
                    yield {"input_ids": rng.randint(
                        1, 100, size=(4, 32)).astype(np.int32)}

            return PrefetchLoader(gen, prefetch=2)

        ckpt = tmp + "/ckpt"
        t1 = Trainer(cfg(6), loader(), checkpoint_dir=ckpt, device=device,
                     seed=0, registry=MetricsRegistry())
        with preempt_at_step(t1, 3):
            s1 = t1.train()
        t1.close()
        t2 = Trainer(cfg(6), loader(), checkpoint_dir=ckpt, device=device,
                     seed=0, registry=MetricsRegistry())
        resumed_at = t2.global_step
        s2 = t2.train()
        t2.close()
        return {
            "resumed_exact_data_state": bool(
                s1.get("preempted")
                and resumed_at == s1.get("final_step")
                and s2.get("resumed_exact_data_state")),
            "preempted_at": s1.get("final_step"),
            "resumed_at": resumed_at,
            "final_step": s2.get("final_step"),
            "goodput": s2.get("goodput"),
            "slo": s2.get("slo"),
        }
    except Exception as e:  # the line must stay parseable
        return {"resumed_exact_data_state": False,
                "reason": f"{type(e).__name__}: {e}"}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _smoke_io_resilience() -> dict:
    """Durable I/O: an injected flaky-storage save/restore cycle through
    utils/retry.py's seam must complete with the retries counted, the
    committed step's sha256 manifest must verify, and a bitflipped byte
    must be DETECTED at restore. A tiny train state on the host."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.models.transformer import LuminaTransformer
    from luminaai_tpu_torch.monitoring.telemetry import MetricsRegistry
    from luminaai_tpu_torch.parallel import train_step as ts
    from luminaai_tpu_torch.testing.faults import (
        bitflip_checkpoint,
        flaky_storage,
    )
    from luminaai_tpu_torch.training.checkpoint import (
        CheckpointIntegrityError,
        CheckpointManager,
        verify_step_dir,
    )
    from luminaai_tpu_torch.training.optimizer import make_optimizer

    tmp = tempfile.mkdtemp(prefix="bench_smoke_io_")
    try:
        cfg = Config(vocab_size=128, hidden_size=32, num_layers=1,
                     num_heads=2, num_kv_heads=1, seq_length=32,
                     intermediate_size=64, use_moe=False, precision="fp32")

        def state(v):
            model = LuminaTransformer(cfg, device="cpu", trainable=True)
            with torch.no_grad():
                for p in model.parameters():
                    p.copy_(torch.arange(p.numel(), dtype=torch.float32)
                            .reshape(p.shape) * 1e-3 + v)
            st = ts.init_train_state(model, make_optimizer(cfg, 10), 0)
            st.step = int(v)
            return st

        reg = MetricsRegistry()  # private: the retry counts land here
        cm = CheckpointManager(cfg, tmp + "/ckpt", registry=reg)
        with flaky_storage(times=2, ops=("checkpoint",)) as stats:
            saved = cm.save(state(1), 1)
            cm.wait()
        retries = reg.get("io_retries_total").labels(
            op="checkpoint_save").value
        want = state(1)
        restored = cm.restore(state(0), 1)
        round_trip = all(torch.equal(a, b) for a, b in
                         zip(restored.params, want.params))
        manifest_verified = (
            verify_step_dir(Path(tmp) / "ckpt" / "1")["status"] == "ok")
        bitflip_checkpoint(tmp + "/ckpt", 1)
        corruption_detected = False
        try:
            cm.restore(state(0), 1)
        except CheckpointIntegrityError:
            corruption_detected = True
        mismatches = reg.get("checkpoint_manifest_mismatch_total").value
        cm.close()
        return {
            "available": True,
            "saved": bool(saved),
            "round_trip": bool(round_trip),
            "injected_faults": stats["raised"],
            "io_retries_total": retries,
            "manifest_verified": manifest_verified,
            "corruption_detected": corruption_detected,
            "manifest_mismatches_total": mismatches,
        }
    except Exception as e:  # the line must stay parseable
        return {"available": False, "reason": f"{type(e).__name__}: {e}"}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _smoke_dispatch_flops(device, registry=None) -> dict:
    """Counted FLOPs of one train step at the flagship's per-layer shape
    (hidden 1024, 8 experts top-2 at capacity 1.25, seq 2048, vocab 32768;
    2 layers, batch 2: the per-layer fractions do not depend on depth or
    batch) under the capacity einsum dispatch and the dropless gmm
    dispatch: torch's FLOP counter plus B4a/B4b's own counts. The steps
    run for real, so this runs on the card only."""
    if device.type != "cuda":
        return {"available": False,
                "reason": "runs two flagship-shaped steps for real: on the "
                          "card only"}
    try:
        import dataclasses

        import torch

        from luminaai_tpu_torch.monitoring.attribution import (
            compiled_cost_metrics,
        )

        base = _child_config("flagship", 1)
        flops = {}
        for mode in ("einsum", "gmm"):
            cfg = dataclasses.replace(
                base, num_layers=2, batch_size=2, moe_dispatch=mode,
                routing_noise_std=0.0)
            _, state, step = _build_rung(cfg, device)
            cc = compiled_cost_metrics(
                step, state, _rung_batch(cfg, device),
                program=f"train_{mode}", registry=registry)
            f = (cc.get("cost_model") or {}).get("flops_per_step")
            if not f:
                return {"available": False,
                        "reason": f"{mode}: no counted flops "
                                  f"({cc.get('reason', 'no cost model')})"}
            flops[mode] = f
            del state, step
            torch.cuda.empty_cache()
        reduction = 1.0 - flops["gmm"] / flops["einsum"]
        return {
            "available": True,
            "config": ("flagship-shaped: hidden 1024, 8 experts top-2 cf "
                       "1.25, seq 2048, vocab 32768; 2 layers, batch 2"),
            "einsum_flops_per_step": flops["einsum"],
            "gmm_flops_per_step": flops["gmm"],
            "reduction": round(reduction, 4),
            "meets_10pct_target": bool(reduction >= 0.10),
        }
    except Exception as e:
        return {"available": False, "reason": f"{type(e).__name__}: {e}"}


def _smoke_audit(fn_name: str) -> dict:
    """analysis/trace_audit.py's expert-dispatch (a2a vs replicated
    gather) or gradient-reduction (hierarchical vs flat) audit on a
    simulated dcn 2 x ici 4 mesh: cross-node bytes of each path."""
    try:
        from luminaai_tpu_torch.analysis import trace_audit

        return getattr(trace_audit, fn_name)()
    except Exception as e:
        return {"available": False, "reason": f"{type(e).__name__}: {e}"}


def _smoke_recompile_surface(registry=None) -> dict:
    """Distinct op-sequence signatures of the train and decode programs
    across the config variants the code forks on
    (analysis/trace_audit.py enumerate_recompile_surface)."""
    try:
        from luminaai_tpu_torch.analysis.trace_audit import (
            enumerate_recompile_surface,
        )

        surface = enumerate_recompile_surface(registry=registry)
        return {
            "available": True,
            "total_variants": surface["total_variants"],
            "total_distinct": surface["total_distinct"],
            "host_syncs": surface["host_syncs"],
            "programs": {
                prog: {
                    "distinct_signatures": rec["distinct_signatures"],
                    "variants": {v["variant"]: v["signature"]
                                 for v in rec["variants"]},
                }
                for prog, rec in surface["programs"].items()
            },
            "note": surface["note"],
        }
    except Exception as e:
        return {"available": False, "reason": f"{type(e).__name__}: {e}"}


def _smoke_decode_cost(cfg, model, registry) -> dict:
    """Counted cost of one continuous-batching decode step
    (StepwiseDecoder.decode_step under the FLOP counter) over the smoke
    model's weights; on the card in the decode kernel's layout
    (_card_layout), with fresh weights."""
    try:
        import dataclasses

        from luminaai_tpu_torch.analysis.trace_audit import _AuditTokenizer
        from luminaai_tpu_torch.convert import init_params
        from luminaai_tpu_torch.inference.generate import GenerationEngine
        from luminaai_tpu_torch.models.transformer import LuminaTransformer
        from luminaai_tpu_torch.monitoring.attribution import (
            compiled_cost_metrics,
        )

        dcfg, layout = _card_layout(
            dataclasses.replace(cfg, max_new_tokens=8), model.device)
        if layout is not None:
            model = init_params(
                LuminaTransformer(dcfg, device=model.device), RUNG_SEED)
        engine = GenerationEngine(model, _AuditTokenizer(), dcfg)
        decoder = engine.make_stepwise(num_slots=2, page_size=64)
        decoder.prefill_into_slot(0, [5, 6, 7, 8], max_new_tokens=4, seed=0)
        out = compiled_cost_metrics(decoder.decode_step, program="decode",
                                    registry=registry)
        out["card_layout"] = layout
        return out
    except Exception as e:
        return {"available": False, "reason": f"{type(e).__name__}: {e}"}


def _device_flag(argv) -> str | None:
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 < len(argv):
            return argv[i + 1]
    return None


if __name__ == "__main__":
    argv = sys.argv[1:]
    device_arg = _device_flag(argv)
    if len(argv) >= 2 and argv[0] == "--child":
        _child_main(argv[1], device_arg)
    elif "--smoke-serve" in argv:
        _serve_bench_main(smoke=True, device_arg=device_arg)
    elif "--serve-bench" in argv:
        _serve_bench_main(smoke=False, device_arg=device_arg)
    elif "--smoke-router" in argv:
        _router_bench_main(smoke=True, device_arg=device_arg)
    elif "--router-bench" in argv:
        _router_bench_main(smoke=False, device_arg=device_arg)
    elif "--smoke" in argv:
        _child_main("smoke", device_arg)
    else:
        sys.exit(main())
