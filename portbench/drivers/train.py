"""The training window: the port's train step over batches from the seed.

Set-up builds one object, the port's training step
(`luminaai_tpu_torch.parallel.train_step.make_train_step` over the
port's model and `training/optimizer.py` AdamW), loads the benchmark's
weights into it, and drives it through the cell's checked steps with the
window's own call and feed (batches whose rows all differ). The same
object then runs the window:

- `--trace 0`: steps back to back for `--seconds`; `train_tokens_per_s`
  is every token of every step launched over the window's seconds, the
  window ending on a sync (at most two steps in flight, so the host
  cannot run far ahead of the card);
- `--trace 1`: the cell's `trace_steps` steps three times over, for the
  per-layer readers (portbench/metrics/): untraced, timed on the host's
  clock between two syncs (the step's time, for `mfu.train`); under a
  light device trace (device events and CUDA runtime calls only, the
  window from the first device event to the end of the last: busy and
  idle time, the kernels by name); and with host ops and scopes (the LM
  head's scope, the idle gaps' labels). Each trace records its steps
  after one untraced warm step under the profiler, and is taken again
  while the profiler's launches of B1-B4b differ from the program's
  launch counters.

Once the window has closed and the peak memory is read, the program's
state is freed and the plain reference (portbench/reference/train.py)
follows the checked steps from the same seed; portbench/lib/check.py
compares them.

Cell parameters (`params` of portbench/cells/<cell>.json): `batches`
(distinct batches drawn, reused in turn), `checked_steps`,
`schedule_steps` (the learning-rate schedule's length), `trace_steps`,
and `limits` (number -> limit).
"""

from __future__ import annotations

import json
import math
import os
import sys
import tempfile
import time
from typing import Dict, List

import torch

from portbench.lib import check, device as dev, trace as tr
from portbench.lib.flops import shapes
from portbench.lib.inputs import batches, leaves, sub_seed, weights
from portbench.lib.window import Window, timed_steps

# Traced windows taken while the profiler's launches differ from the
# counters (CUPTI has lost short calls before).
TRACE_TRIES = 3


def _launches() -> Dict[str, int]:
    from luminaai_tpu_torch.ops import flash_attention as fa
    from luminaai_tpu_torch.ops import gmm as tg

    return {"B1": fa.flash_fwd.launches, "B2": fa.flash_bwd_dq.launches,
            "B3": fa.flash_bwd_dkv.launches, "B4a": tg.gmm.launches,
            "B4b": tg.tgmm.launches}


def build(config: Dict, params: Dict, seed: int, device):
    """(config object, model, state, step): the port's training step with
    the benchmark's weights loaded."""
    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.models.transformer import LuminaTransformer
    from luminaai_tpu_torch.parallel import train_step as ts
    from luminaai_tpu_torch.training.optimizer import (
        make_optimizer,
        make_schedule,
    )

    cfg = Config(**config)
    s = shapes(config)
    model = LuminaTransformer(cfg, device=device, trainable=True)
    named = dict(model.named_parameters())
    loaded = set()
    with torch.no_grad():
        for kind, t in weights(s, seed, device):
            for name, leaf in leaves(kind, t, s.layers):
                if named[name].shape != leaf.shape:
                    raise ValueError(f"{name}: program {named[name].shape}, "
                                     f"benchmark {tuple(leaf.shape)}")
                named[name].copy_(leaf)
                loaded.add(name)
            del t
    if loaded != set(named):
        raise ValueError(f"parameters not loaded: {sorted(set(named) - loaded)}")
    total = params["schedule_steps"]
    schedule = make_schedule(cfg, total)
    tx = make_optimizer(cfg, total, schedule)
    state = ts.init_train_state(model, tx, sub_seed(seed, "routing"))
    step = ts.make_train_step(cfg, model, schedule, tx)
    return cfg, model, state, step


def first_gradients(state, b1: float) -> Dict[str, float]:
    """Each parameter's gradient norm as the optimizer took it in its
    first update, from its first moment: mu_1 = (1 - b1) g."""
    mu = state.opt_state.mu
    return {n: float(m.float().norm()) / (1.0 - b1)
            for n, m in zip(state.names, mu)}


def changes(model, config: Dict, seed: int, device) -> Dict[str, float]:
    """Each parameter's change from the benchmark's initial weights."""
    s = shapes(config)
    named = dict(model.named_parameters())
    out = {}
    with torch.no_grad():
        for kind, t0 in weights(s, seed, device):
            for name, leaf in leaves(kind, t0, s.layers):
                out[name] = float((named[name].detach() - leaf).norm())
            del t0
    return out


def _traced(run_step, n: int, device, host_ops: bool, tries: int,
            log) -> Dict:
    """`n` steps under the profiler (dev.profile_steps), taken again (up
    to `tries` in all) while the profiler's launches of B1-B4b differ
    from the program's counters. The window runs from the first device
    event of the recorded steps to the end of the last."""
    for attempt in range(tries):
        box = dev.profile_steps(device, run_step, n, host_ops,
                                before_active=_launches)
        counted = {k: v - box["mark"][k] for k, v in _launches().items()}
        fd, path = tempfile.mkstemp(prefix="portbench-", suffix=".json")
        os.close(fd)
        try:
            box["prof"].export_chrome_trace(path)
            with open(path) as f:
                trace = tr.read_trace(json.load(f))
        finally:
            os.unlink(path)
        t0, t1 = tr.device_span(trace)
        if t1 <= t0:  # no device event (a CPU run): the host's time
            t1 = t0 + box["host_s"] * 1e6
        traced = tr.kernel_launches(trace)
        lost = {k: counted[k] - traced.get(k, 0) for k in counted
                if counted[k] != traced.get(k, 0)}
        got = {"trace": trace, "t0": t0, "t1": t1, "host_s": box["host_s"],
               "lossy": bool(lost) and device.type == "cuda",
               "tries": attempt + 1}
        if not got["lossy"]:
            return got
        log(f"profiler launches differ from the counters (counter minus "
            f"profiler: {lost}); try {attempt + 1} of {tries}")
    return got


def checked_program(config: Dict, params: Dict, seed: int, device):
    """The program built from the seed and driven through the cell's
    checked steps with the window's own call and feed: (config object,
    model, state, step, batches, readings). The readings are each step's
    loss, each parameter's gradient norm as the first update took it, and
    each parameter's change after the checked steps (check.compare's
    form). The state and step go on into the window."""
    cfg, model, state, step = build(config, params, seed, device)
    ids = batches(seed, params["batches"], cfg.batch_size, cfg.seq_length,
                  cfg.vocab_size, device)
    losses: List[torch.Tensor] = []
    grads = None
    for t in range(params["checked_steps"]):
        state, metrics = step(state, {"input_ids": ids[t]})
        losses.append(metrics["loss"])
        if t == 0:
            grads = first_gradients(state, cfg.beta1)
    readings = {"losses": [float(x) for x in losses], "grad_norms": grads,
                "change_norms": changes(model, config, seed, device)}
    dev.sync(device)
    return cfg, model, state, step, ids, readings


def _program(ctx, log) -> Dict:
    """Everything the program does in this run; its objects die here."""
    config, params, device = ctx["config"], ctx["cell"]["params"], ctx[
        "device"]
    seed = ctx["seed"]
    s = shapes(config)
    if device.type == "cuda":
        from luminaai_tpu_torch.ops import _build

        log(f"kernels built in {_build.build_all():.1f} s")
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    cfg, model, state, step, ids, readings = checked_program(
        config, params, seed, device)
    B, S = cfg.batch_size, cfg.seq_length
    n_check = params["checked_steps"]
    log(f"model, weights and checked steps in {time.perf_counter() - t0:.1f}"
        f" s; setup {time.perf_counter() - ctx['t_start']:.1f} s")
    out = {"readings": readings,
           "setup_s": time.perf_counter() - ctx["t_start"]}
    tokens_per_step = B * S
    done = [n_check]

    def one(i=None):
        nonlocal state
        state, metrics = step(state, {"input_ids": ids[done[0] % len(ids)]})
        done[0] += 1
        return metrics["loss"]

    if not ctx["trace"]:
        n, wall, window_losses = timed_steps(one, ctx["seconds"], device,
                                             log)
        bad = sum(1 for x in torch.stack(window_losses).tolist()
                  if not math.isfinite(x))
        out.update(attempted=n, failed=bad, e2e={
            "train_tokens_per_s": n * tokens_per_step / wall},
            window_s=wall)
    else:
        n = params["trace_steps"]
        # The same steps three ways: untraced, for the step's time; under
        # the light device trace, for busy and idle time and the kernels;
        # with host ops and scopes, for the LM head's scope and the idle
        # gaps' labels.
        dev.sync(device)
        t0 = time.perf_counter()
        for _ in range(n):
            one()
        dev.sync(device)
        untraced_s = time.perf_counter() - t0
        light = _traced(one, n, device, False, TRACE_TRIES, log)
        full = _traced(one, n, device, True, TRACE_TRIES, log)
        window_s = (light["t1"] - light["t0"]) * 1e-6
        busy_s = tr.busy_us(light["trace"]) * 1e-6
        log(f"traced window: {n} steps, {window_s / n:.4f} s a step "
            f"(untraced {untraced_s / n:.4f} s; with host ops "
            f"{(full['t1'] - full['t0']) * 1e-6 / n:.4f} s), busy "
            f"{busy_s / n:.4f} s a step")
        facts = {"steps": n, "untraced_s": untraced_s,
                 "micro_batch": B // max(1, cfg.gradient_accumulation_steps),
                 "accum": max(1, cfg.gradient_accumulation_steps),
                 "seq": S,
                 "recompute_ffn": bool(cfg.gradient_checkpointing
                                       and cfg.remat_policy != "full")}
        out.update(attempted=3 * n, failed=0, window=Window(
            trace=light["trace"], window_s=window_s, busy_s=busy_s,
            cell=ctx["cell"], config=config, shapes=s,
            lossy=light["lossy"], scopes=full["trace"],
            scopes_lossy=full["lossy"], facts=facts),
            breakdown=tr.breakdown(full["trace"], full["t0"], full["t1"]),
            busy_s=busy_s, window_s=window_s)
    out["device"] = dev.describe(device)
    return out


def run(ctx) -> Dict:
    log = ctx.get("log") or (lambda m: print(m, file=sys.stderr))
    out = _program(ctx, log)
    dev.free(ctx["device"])
    from portbench.reference.train import steps as reference_steps

    config, params = ctx["config"], ctx["cell"]["params"]
    ids = batches(ctx["seed"], params["batches"], config["batch_size"],
                  config["seq_length"], config["vocab_size"], ctx["device"])
    t0 = time.perf_counter()
    ref = reference_steps(config, ctx["seed"], ids[:params["checked_steps"]],
                          params["checked_steps"], params["schedule_steps"])
    log(f"reference in {time.perf_counter() - t0:.1f} s")
    numbers = check.compare(out["readings"], ref)
    out["correct"], out["checks"] = check.judge(numbers, params["limits"])
    out["numbers"] = {name: n["value"] for name, n in numbers.items()}
    out["checks_at"] = {name: n["at"] for name, n in numbers.items()}
    out["not_compared"] = {name: n["value"] for name, n in numbers.items()
                           if name not in params["limits"]}
    dev.free(ctx["device"])
    return out
