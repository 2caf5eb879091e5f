"""Multi-process harness for the port's mesh tests (imported by the
tests/test_torch_*mesh*, *sharded*, *grad_reduce*, *expert_dispatch* and
*ring_attention* files; not a test file itself).

`run_ranks(n, fn, args, tmp_path)` (or `Ranks(...).join()`, which lets
the parent run JAX meanwhile) spawns n processes once, joins them
into a gloo process group through a FileStore in tmp_path (no TCP port,
so test files can run side by side), runs `fn(rank, n, *args)` in each
and returns the ranks' results (torch.save'd). The group's timeout is
GROUP_TIMEOUT_S; the parent joins with JOIN_TIMEOUT_S and kills what is
left, so a hung collective fails the test and never the suite. A rank runs
torch and the port only; `fn` must be a module-level function (spawn
sends it by name), so a rank imports the module that defines it, and
with it that module's imports.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import sys
import time
import traceback
from pathlib import Path

GROUP_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 120
TRACE_KEYS = ("loss", "grad_norm", "learning_rate", "tokens_in_loss",
              "ce_loss", "moe_aux_loss", "moe_drop_rate")


def _child(rank: int, n: int, fn, args, tmp: str) -> None:
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = Path(tmp) / f"rank{rank}.pt"
    try:
        store = dist.FileStore(str(Path(tmp) / "store"), n)
        dist.init_process_group(
            "gloo", store=store, rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        result = fn(rank, n, *args)
        torch.save({"ok": True, "result": result}, out)
        dist.destroy_process_group()
    except BaseException:  # reported by the parent
        torch.save({"ok": False, "error": traceback.format_exc()}, out)
        sys.exit(1)


class Ranks:
    """n spawned ranks running fn(rank, n, *args) (start_ranks); .join()
    gives their results. The parent may work (JAX) meanwhile."""

    def __init__(self, n, fn, args, tmp_path):
        self.n, self.tmp = n, Path(tmp_path)
        self.tmp.mkdir(parents=True, exist_ok=True)
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_child,
                                  args=(r, n, fn, args, str(self.tmp)),
                                  daemon=True) for r in range(n)]
        for p in self.procs:
            p.start()
        self.t0 = time.monotonic()

    def join(self, timeout: float = JOIN_TIMEOUT_S):
        """[result of rank 0, ..., rank n-1]; raises with a rank's
        traceback when one failed, or when the ranks outlive `timeout`
        (counted from the start)."""
        import torch

        deadline = self.t0 + timeout
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [p for p in self.procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(5)
        results, errors = [], []
        for r in range(self.n):
            f = self.tmp / f"rank{r}.pt"
            if not f.exists():
                errors.append(f"rank {r}: no result (exit "
                              f"{self.procs[r].exitcode})")
                continue
            rec = torch.load(f, weights_only=False)
            if rec["ok"]:
                results.append(rec["result"])
            else:
                errors.append(f"rank {r}:\n{rec['error']}")
        if hung:
            errors.insert(0, f"{len(hung)} rank(s) still running after "
                             f"{timeout} s: killed")
        if errors:
            raise RuntimeError("\n".join(errors))
        return results


def run_ranks(n: int, fn, args, tmp_path, timeout: float = JOIN_TIMEOUT_S):
    """Ranks(n, fn, args, tmp_path).join(timeout)."""
    return Ranks(n, fn, args, tmp_path).join(timeout)


def port_case(cfg_kw: dict, init_sd: dict, batches: list, total: int = 4,
              seed: int = 0, one_rank: bool = False):
    """Train `batches` with the port's sharded step (inside run_ranks) or
    its one-rank step (no process group, or one_rank): ({metric: [per
    step]}, the whole parameters after the last step {name: tensor} (rank
    0; None on the others))."""
    import torch
    import torch.distributed as dist

    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.models.transformer import LuminaTransformer
    from luminaai_tpu_torch.parallel import train_step as ts
    from luminaai_tpu_torch.training.optimizer import (
        make_optimizer,
        make_schedule,
    )

    cfg = Config(**cfg_kw)
    model = LuminaTransformer(cfg, device="cpu", trainable=True)
    model.load_params(init_sd)
    schedule = make_schedule(cfg, total)
    tx = make_optimizer(cfg, total, schedule)
    keys = TRACE_KEYS
    trace = {k: [] for k in keys}
    if one_rank or not dist.is_initialized():
        state = ts.init_train_state(model, tx, seed=seed)
        step = ts.make_train_step(cfg, model, schedule, tx)
        for b in batches:
            state, m = step(state, {k: torch.as_tensor(v) for k, v in
                                    b.items()})
            for k in keys:
                if k in m:
                    trace[k].append(float(m[k]))
        return trace, {n: p.detach().clone() for n, p in
                       model.named_parameters()}
    from luminaai_tpu_torch.parallel.mesh import build_mesh
    from luminaai_tpu_torch.parallel.sharding import init_sharded_state

    mesh = build_mesh(cfg, device=torch.device("cpu"))
    model, state = init_sharded_state(cfg, mesh, tx, seed, model=model)
    step = ts.make_sharded_train_step(cfg, model, schedule, tx, mesh)
    for b in batches:
        local = ts.shard_batch({k: torch.as_tensor(v) for k, v in
                                b.items()}, mesh, cfg)
        state, m = step(state, local)
        for k in keys:
            if k in m:
                trace[k].append(float(m[k]))
    full = state.gather_full()
    params = None if full is None else dict(zip(full.names, full.params))
    return trace, params


def port_cases(rank: int, n: int, cases: list):
    """run_ranks body: port_case over each (name, cfg_kw, init_sd,
    batches), sharded; rank 0 then also runs each case's one-rank
    equal (one_rank_kw) while the parent works, under "one:" + name."""
    out = {name: port_case(kw, sd, batches)
           for name, kw, sd, batches in cases}
    if rank == 0:
        out.update({"one:" + name: port_case(one_rank_kw(kw), sd, batches,
                                             one_rank=True)
                    for name, kw, sd, batches in cases})
    return out


def jax_init(cfg_kw: dict, n_devices: int = 4, total: int = 4,
             jax_kw=None, share=None):
    """The JAX package's sharded state and step over jax.devices()[:n]
    (the conftest's CPU devices): (a handle for jax_steps, the initial
    parameters as the port's state_dict). `jax_kw` overrides config
    fields on the JAX side only; `share` (another handle of the same
    widths and mesh) lends its initial state instead of a new init.
    Imports JAX: call it in the pytest process, never in a rank."""
    import jax

    from luminaai_tpu.config import Config as JConfig
    from luminaai_tpu.models.transformer import LuminaTransformer as JModel
    from luminaai_tpu.parallel.mesh import build_mesh
    from luminaai_tpu.parallel.sharding import init_sharded_state
    from luminaai_tpu.parallel.train_step import make_train_step
    from luminaai_tpu.training.optimizer import (
        make_optimizer,
        make_schedule,
    )
    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.convert import params_from_flax

    cfg = JConfig(**{**cfg_kw, **(jax_kw or {})})
    model = JModel(cfg)
    schedule = make_schedule(cfg, total)
    tx = make_optimizer(cfg, total, schedule)
    mesh = build_mesh(cfg, devices=jax.devices()[:n_devices])
    if share is not None:
        state, shardings = share["state"], share["shardings"]
    else:
        state, shardings = init_sharded_state(cfg, model, tx, mesh,
                                              jax.random.key(0))
    tcfg = Config(**cfg_kw)
    step = make_train_step(cfg, model, shardings, mesh, schedule, tx)
    init = params_from_flax(jax.device_get(state.params), tcfg)
    return {"state": state, "step": step, "cfg": tcfg,
            "shardings": shardings}, init


def jax_steps(handle: dict, batches: list):
    """Train `batches` with a jax_init handle: ({metric: [per step]}, the
    final parameters as the port's state_dict)."""
    import jax
    import jax.numpy as jnp

    from luminaai_tpu_torch.convert import params_from_flax

    # A copy: the step donates its state, which another handle may share.
    state = jax.tree.map(lambda a: a.copy(), handle["state"])
    trace = {k: [] for k in TRACE_KEYS}
    for b in batches:
        state, m = handle["step"](state, {
            k: jnp.asarray(v.astype("int32") if k == "input_ids" else v)
            for k, v in b.items()})
        for k in TRACE_KEYS:
            if k in m:
                trace[k].append(float(m[k]))
    return trace, params_from_flax(jax.device_get(state.params),
                                   handle["cfg"])


def one_rank_kw(cfg_kw: dict) -> dict:
    """The same model and run on one rank: every mesh axis 1 ('a2a'
    dispatch, which needs an expert axis, as its one-rank equal 'gmm')."""
    out = dict(cfg_kw)
    for k in ("fsdp_parallel_size", "tensor_parallel_size",
              "expert_parallel_size", "sequence_parallel_size",
              "data_parallel_size"):
        out.pop(k, None)
    if out.get("moe_dispatch") == "a2a":
        out["moe_dispatch"] = "gmm"
    out.pop("grad_reduce", None)
    out.pop("gradient_dcn_size", None)
    return out


def assert_close_trace(got: dict, want: dict, rtol: float, what: str):
    """Every metric both traces carry, step by step, within rtol; returns
    the largest relative difference seen."""
    import numpy as np

    worst = 0.0
    for k, w in want.items():
        g = got.get(k, [])
        if not w or not g:
            continue
        g, w = np.asarray(g), np.asarray(w)
        rel = np.abs(g - w) / np.maximum(np.abs(w), 1e-30)
        worst = max(worst, float(rel.max()))
        np.testing.assert_allclose(g, w, rtol=rtol, atol=0,
                                   err_msg=f"{what}: {k}")
    return worst


def assert_params(got: dict, want: dict, lr_sum: float, what: str):
    """Parameters after the steps: every element within 2 x (the sum of
    the learning rates) + 1e-6 (Adam moves an element whose gradient is
    rounding noise by about +-lr either way) and 99.9% within 1e-6 (the
    tolerance of tests/test_torch_train_step.py). Returns the largest
    difference."""
    import numpy as np

    worst = 0.0
    for name, w in want.items():
        d = (got[name].double() - w.double()).abs().numpy()
        worst = max(worst, float(d.max()))
        assert d.max() <= 2 * lr_sum + 1e-6, (what, name, d.max())
        assert np.mean(d <= 1e-6) >= 0.999, (what, name,
                                               np.mean(d > 1e-6))
    return worst
