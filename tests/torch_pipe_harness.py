"""Shared pieces of the port's pipeline tests (tests/test_torch_pipeline*.py;
not a test file itself): the widths, the batches, the rank body that
trains a case through the port's pipelined step and its one-stage step
over the same microbatches, and JAX's pipelined step (in this process,
or in a child process for the expert and sequence compositions, whose
manual collectives the JAX tests keep out of a shared CPU runtime:
tests/test_pipeline.py)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from torch_mesh_harness import TRACE_KEYS

ARCH = dict(vocab_size=256, hidden_size=64, num_layers=4, num_heads=4,
            num_kv_heads=2, seq_length=64, intermediate_size=128,
            precision="fp32", batch_size=8, grad_clip_norm=0.5,
            learning_rate=1e-3, warmup_ratio=0.25, routing_noise_std=0.0,
            gradient_checkpointing=False, use_flash_attention=False,
            use_moe=False, scan_layers=True)
MOE = dict(use_moe=True, num_experts=4, moe_pattern="all",
           moe_dispatch="gather")
MESH_KEYS = ("pipeline_parallel_size", "fsdp_parallel_size",
             "tensor_parallel_size", "expert_parallel_size",
             "sequence_parallel_size", "data_parallel_size",
             "pipeline_schedule", "pipeline_microbatches")
EVAL_KEYS = ("loss", "ce_loss", "moe_aux_loss", "mod_aux_loss")


def batches(n: int = 2):
    """Batches without a loss mask: every microbatch carries the same CE
    weight, so the pipeline's CE over the global weight equals the
    one-stage step's mean of microbatch means."""
    out = []
    for s in range(n):
        rng = np.random.RandomState(s)
        out.append({"input_ids": rng.randint(
            1, ARCH["vocab_size"], (ARCH["batch_size"], ARCH["seq_length"])
        ).astype(np.int64)})
    return out


def n_micro(kw: dict) -> int:
    return kw.get("pipeline_microbatches") or kw["pipeline_parallel_size"]


def one_stage_kw(kw: dict) -> dict:
    """The same model on one rank, accumulating over the pipeline's
    microbatches."""
    out = {k: v for k, v in kw.items() if k not in MESH_KEYS}
    out["gradient_accumulation_steps"] = n_micro(kw)
    return out


def _trace(trace, m):
    for k in TRACE_KEYS:
        if k in m:
            trace[k].append(float(m[k]))


def _one_stage_eval(cfg, model, batch, n):
    """The one-stage eval averaged over the pipeline's microbatches."""
    import torch

    from luminaai_tpu_torch.parallel import train_step as ts

    ev = ts.make_eval_step(cfg, model)
    B = batch["input_ids"].shape[0] // n
    ms = [ev(None, {k: v[i * B:(i + 1) * B] for k, v in batch.items()})
          for i in range(n)]
    return {k: float(torch.stack([m[k] for m in ms]).mean())
            for k in EVAL_KEYS if k in ms[0]}


def pipe_case(kw: dict, sd: dict, data: list, one_stage: bool = False,
              virtual: bool = False):
    """Train `data` with the port's pipelined step over the process
    group (or every stage in this process with `virtual`; or the
    one-stage step with `one_stage`), then evaluate the first batch:
    ({metric: [per step]}, whole parameters on rank 0, eval metrics)."""
    import torch
    import torch.distributed as dist

    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.models.transformer import LuminaTransformer
    from luminaai_tpu_torch.parallel import pipeline as pl
    from luminaai_tpu_torch.parallel import train_step as ts
    from luminaai_tpu_torch.training.optimizer import (
        make_optimizer,
        make_schedule,
    )

    trace = {k: [] for k in TRACE_KEYS}
    tensors = [{k: torch.as_tensor(v) for k, v in b.items()} for b in data]
    if one_stage or virtual:
        if one_stage:
            cfg = Config(**one_stage_kw(kw))
        else:
            cfg = Config(**{k: v for k, v in kw.items()
                            if k not in MESH_KEYS})
        model = LuminaTransformer(cfg, device="cpu", trainable=True)
        model.load_params(sd)
        sched = make_schedule(cfg, 4)
        tx = make_optimizer(cfg, 4, sched)
        state = ts.init_train_state(model, tx, seed=0)
        if one_stage:
            step = ts.make_train_step(cfg, model, sched, tx)
            ev = _one_stage_eval(cfg, model, tensors[0], n_micro(kw))
        else:
            sch = kw.get("pipeline_schedule", "1f1b")
            step = pl.virtual_pipeline_step(
                cfg, model, sched, tx, kw["pipeline_parallel_size"],
                n_micro(kw), sch)
            m = pl.virtual_pipeline_eval(
                cfg, model, kw["pipeline_parallel_size"], n_micro(kw),
                sch)(None, tensors[0])
            ev = {k: float(m[k]) for k in EVAL_KEYS if k in m}
        for b in tensors:
            state, m = step(state, b)
            _trace(trace, m)
        return trace, {n: p.detach().clone()
                       for n, p in model.named_parameters()}, ev
    from luminaai_tpu_torch.parallel.mesh import build_mesh
    from luminaai_tpu_torch.parallel.sharding import init_sharded_state

    cfg = Config(**kw)
    mesh = build_mesh(cfg, device=torch.device("cpu"))
    sched = make_schedule(cfg, 4)
    tx = make_optimizer(cfg, 4, sched)
    model, state = init_sharded_state(cfg, mesh, tx, 0, params=sd)
    ev_step = ts.make_sharded_eval_step(cfg, model, mesh)
    m = ev_step(state, ts.shard_batch(tensors[0], mesh, cfg))
    ev = {k: float(m[k]) for k in EVAL_KEYS if k in m}
    step = ts.make_sharded_train_step(cfg, model, sched, tx, mesh)
    for b in tensors:
        state, m = step(state, ts.shard_batch(b, mesh, cfg))
        _trace(trace, m)
    full = state.gather_full()
    params = None if full is None else dict(zip(full.names, full.params))
    if dist.get_rank() != 0:
        trace = None
    return trace, params, ev


def init_sd(kw: dict, seed: int = 0) -> dict:
    """The one-rank model's seeded weights (the port's init)."""
    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.convert import init_params
    from luminaai_tpu_torch.models.transformer import LuminaTransformer

    cfg = Config(**{k: v for k, v in kw.items() if k not in MESH_KEYS})
    model = init_params(LuminaTransformer(cfg, device="cpu",
                                          trainable=True), seed)
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def pipe_cases(rank: int, n: int, cases: list):
    """run_ranks body: pipe_case over each (name, kw, sd) over the
    process group; rank 0 also runs each one-stage equal ("one:" + name)
    while the others wait."""
    out = {}
    for name, kw, sd in cases:
        out[name] = pipe_case(kw, sd, batches())
        if rank == 0:
            out["one:" + name] = pipe_case(kw, sd, batches(),
                                           one_stage=True)
    return out


def compare(trace, params, ev, want_trace, want_params, want_ev, what,
             norm_rtol=1e-5):
    """A pipelined run (trace, parameters, eval) against a reference's:
    metrics and the eval's loss and CE at rtol 1e-5, grad_norm at
    `norm_rtol`, parameters as assert_params holds them."""
    from torch_mesh_harness import assert_close_trace, assert_params

    worst = assert_close_trace(
        {k: v for k, v in trace.items() if k != "grad_norm"}, want_trace,
        1e-5, what)
    assert_close_trace({"grad_norm": trace["grad_norm"]},
                       {"grad_norm": want_trace["grad_norm"]}, norm_rtol,
                       what)
    worst_p = assert_params(params, want_params,
                            sum(trace["learning_rate"]), what)
    for k in ("loss", "ce_loss"):
        np.testing.assert_allclose(ev[k], want_ev[k], rtol=1e-5,
                                   err_msg=f"{what}: eval {k}")
    return worst, worst_p


# --------------------------------------------------------------------------
# JAX's pipelined step
# --------------------------------------------------------------------------

def jax_pipe(kw: dict, n_devices: int, data=None):
    """JAX's step at `kw` over jax.devices()[:n_devices] (its pipeline
    under pipeline_parallel_size > 1) from its own init: (the initial
    weights as the port's state_dict, {metric: [per step]}, the final
    weights, the eval metrics of the first batch before training)."""
    from torch_mesh_harness import jax_init

    handle, init = jax_init(kw, n_devices=n_devices)
    return (init,) + jax_pipe_run(handle, kw, n_devices, data)


def jax_pipe_run(handle: dict, kw: dict, n_devices: int, data=None):
    """(trace, final weights, first-batch eval) of a jax_init handle."""
    import jax
    import jax.numpy as jnp

    from luminaai_tpu.config import Config as JConfig
    from luminaai_tpu.models.transformer import LuminaTransformer as JModel
    from luminaai_tpu.parallel.mesh import build_mesh
    from luminaai_tpu.parallel.train_step import make_eval_step
    from torch_mesh_harness import jax_steps

    data = data if data is not None else batches()
    cfg = JConfig(**kw)
    mesh = build_mesh(cfg, devices=jax.devices()[:n_devices])
    ev = make_eval_step(cfg, JModel(cfg), handle["shardings"], mesh)
    m = ev(handle["state"], {"input_ids": jnp.asarray(
        data[0]["input_ids"].astype("int32"))})
    evm = {k: float(m[k]) for k in EVAL_KEYS if k in m}
    trace, final = jax_steps(handle, data)
    return trace, final, evm


def jax_pipe_child(cases: dict, n_devices: int, out: Path, timeout=900):
    """jax_pipe over {name: kw} in a child process (JAX on the CPU with
    the conftest's 8 devices); returns {name: its result}."""
    import torch

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8")
    here = Path(__file__).resolve().parent
    spec = out.with_suffix(".json")
    spec.write_text(json.dumps(cases))
    code = (
        "import sys, json, torch\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        f"sys.path.insert(0, {str(here.parent)!r})\n"
        f"sys.path.insert(0, {str(here)!r})\n"
        "from torch_pipe_harness import jax_pipe\n"
        f"cases = json.load(open({str(spec)!r}))\n"
        f"res = {{k: jax_pipe(kw, {n_devices}) for k, kw in cases.items()}}\n"
        f"torch.save(res, {str(out)!r})\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return torch.load(out, weights_only=False)
