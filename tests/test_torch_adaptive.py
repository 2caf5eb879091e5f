"""The port's Trainer under adaptive interventions, on the CPU.

Against the JAX package's Trainer (2 layers, hidden 64, 4 experts top-2,
sort dispatch with capacity factor 1 so tokens drop, no routing noise, no
expert dropout; fp32; the same initial weights, convert.params_from_flax
of the JAX trainer's, and the same synthetic batches): both apply the
same hooks at the same step from their step_callback — an LR override,
weight decay, the clip norm, routing temperature and capacity (the LR
override must survive the later rebuilds). Losses within rtol 1e-5 and
grad norms within 1e-4 (the tolerances of tests/test_torch_runtime.py),
equal learning rates and equal `interventions` records. (The same for
evolve_experts: tests/test_torch_adaptive_evolve.py.)

Within the port (exact):
- expert dropout at rate 0.1, then 0: the steps in between draw one
  uniform per expert from the step's generator, and drop experts;
- rollback waits for a save still being written, refuses the
  checkpoints from before an evolution, and a resume walks back past a
  corrupt step only as far as the fence;
- a run that grows an expert and is preempted after it: resuming with the
  old num_experts is refused by the guard; with the new one it trains the
  uninterrupted run's losses and ends on its parameters bit for bit, with
  routing noise and expert dropout drawn from the restored generator;
- the moe_expert_load gauges equal JAX's for the same metrics and sum to
  ~1.
"""

import time
import types

import jax
import numpy as np
import pytest
import torch

from luminaai_tpu import cli as jcli
from luminaai_tpu.config import Config as JConfig
from luminaai_tpu.monitoring.events import FlightRecorder as JRecorder
from luminaai_tpu.monitoring.telemetry import MetricsRegistry as JRegistry
from luminaai_tpu.training.trainer import Trainer as JTrainer
from luminaai_tpu_torch import cli
from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.convert import params_from_flax
from luminaai_tpu_torch.models import moe
from luminaai_tpu_torch.models.transformer import LuminaTransformer
from luminaai_tpu_torch.monitoring.events import FlightRecorder
from luminaai_tpu_torch.monitoring.telemetry import MetricsRegistry
from luminaai_tpu_torch.training import checkpoint as ck
from luminaai_tpu_torch.training.trainer import Trainer

TINY = dict(vocab_size=384, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, seq_length=32, intermediate_size=128,
            precision="fp32", batch_size=8, use_flash_attention=False,
            gradient_checkpointing=False, use_moe=True, num_experts=4,
            moe_top_k=2, moe_dispatch="sort", capacity_factor=1.0,
            routing_noise_std=0.0, max_steps=8, learning_rate=1e-3,
            eval_every_n_batches=10**6, save_every_n_batches=10**6,
            health_check_interval=10, watchdog=False)

# step -> the hooks applied after it, in order: (hook, args). The JAX
# step compiles once after each scripted step.
HOOKS = {
    2: [("adjust_learning_rate", (5e-4,)), ("adjust_weight_decay", (0.05,)),
        ("set_grad_clip", (0.5,)), ("adjust_routing_temperature", (1.5,)),
        ("adjust_capacity_factor", (1.5,))],
}


def _scripted(trainer, counts, script):
    """A step_callback applying `script` and recording the optimizer count
    after each evolution."""

    def callback(step, metrics):
        for hook, args in script.get(step, ()):
            out = getattr(trainer, hook)(*args, reason=f"scripted {hook}")
            if hook == "evolve_experts":
                assert out is True
                counts.append((step, _count(trainer)))

    return callback


def _count(trainer) -> int:
    st = trainer.state.opt_state
    if isinstance(trainer, Trainer):
        return st.count
    leaves = jax.tree_util.tree_flatten_with_path(st)[0]
    counts = {int(v) for p, v in leaves
              if getattr(p[-1], "name", None) == "count"}
    assert len(counts) == 1, counts
    return counts.pop()


def _record(trainer, sink):
    """Record each step's loss, grad norm and learning rate into sink."""
    orig = trainer.train_step

    def wrap(state, batch):
        out = orig(state, batch)
        sink.append({k: float(out[1][k]) for k in
                     ("loss", "grad_norm", "learning_rate")})
        return out

    wrap.recording = True
    trainer.train_step = wrap


def _attach(trainer, sink, inner=None):
    """Install `inner` as the step callback and record every step into
    sink, re-wrapping whatever train_step a hook rebuilt."""

    def callback(step, metrics):
        if inner is not None:
            inner(step, metrics)
        if not getattr(trainer.train_step, "recording", False):
            _record(trainer, sink)

    trainer.step_callback = callback
    _record(trainer, sink)


def run_both(tmp_path, script, max_steps):
    """The JAX Trainer and the port's from the same weights and batches,
    each applying `script` from its step_callback; the per-step records
    compared within the tolerances. -> (port trainer, JAX trainer, port
    summary, JAX summary, port counts, JAX counts)."""
    kw = {**TINY, "max_steps": max_steps}
    jcfg = JConfig(**{**kw, "output_dir": str(tmp_path / "jax"),
                      "slo": False})
    jt = JTrainer(jcfg, train_data=jcli._synthetic_batches(jcfg),
                  checkpoint_dir=str(tmp_path / "jax" / "ckpt"))
    jparams = jax.device_get(jt.state.params)
    jcounts, theirs = [], []
    _attach(jt, theirs, _scripted(jt, jcounts, script))
    jsummary = jt.train()
    jt.close()

    cfg = Config(**{**kw, "output_dir": str(tmp_path / "port")})
    model = LuminaTransformer(cfg, device="cpu", trainable=True)
    model.load_params(params_from_flax(jparams, cfg))
    t = Trainer(cfg, cli._synthetic_batches(cfg), model=model, device="cpu",
                checkpoint_dir=str(tmp_path / "port" / "ckpt"))
    counts, ours = [], []
    _attach(t, ours, _scripted(t, counts, script))
    summary = t.train()
    t.close()

    assert len(ours) == len(theirs) == max_steps
    for i, (a, b) in enumerate(zip(ours, theirs), 1):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5,
                                   err_msg=f"loss {i}")
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"],
                                   rtol=1e-4, err_msg=f"norm {i}")
        np.testing.assert_allclose(a["learning_rate"], b["learning_rate"],
                                   rtol=1e-6, err_msg=f"lr {i}")
    assert summary["interventions"] == jsummary["interventions"]
    return t, jt, summary, ours, counts, jcounts


def test_trainer_hooks_match_jax(tmp_path):
    t, jt, summary, ours, _, _ = run_both(tmp_path, HOOKS, max_steps=4)
    # The override holds through the temperature and capacity rebuilds.
    np.testing.assert_allclose([r["learning_rate"] for r in ours[2:]],
                               [5e-4] * 2, rtol=1e-6)
    assert [iv["kind"] for iv in summary["interventions"]] == [
        "lr_override", "weight_decay", "grad_clip", "routing_temperature",
        "capacity_factor"]
    cfg = t.config
    assert (cfg.weight_decay, cfg.grad_clip_norm, cfg.routing_temperature,
            cfg.capacity_factor) == (0.05, 0.5, 1.5, 1.5)
    assert t._lr_override == jt._lr_override == 5e-4


def _port(tmp_path, name, **kw):
    cfg = Config(**{**TINY, "output_dir": str(tmp_path / name), **kw})
    return Trainer(cfg, cli._synthetic_batches(cfg), device="cpu", seed=0,
                   checkpoint_dir=str(tmp_path / name / "ckpt"))


def test_expert_dropout_on_then_off(tmp_path, monkeypatch):
    drawn = []
    real = moe.MoELayer.draw_routing

    def draw(self, G, S, generator, device):
        out = real(self, G, S, generator, device)
        drawn.append(None if out is None else out.get("expert_u"))
        return out

    monkeypatch.setattr(moe.MoELayer, "draw_routing", draw)
    t = _port(tmp_path, "d", max_steps=8)
    losses = {}

    def callback(step, metrics):
        losses[step] = metrics["loss"]
        if step == 1:
            t.enable_expert_dropout(0.1, reason="collapse")
        if step == 6:
            t.enable_expert_dropout(0.0, reason="cleared")
        with pytest.raises(ValueError, match="not in"):
            t.enable_expert_dropout(0.6)

    t.step_callback = callback
    t.train()
    t.close()
    per_step = [drawn[i:i + 2] for i in range(0, len(drawn), 2)]
    assert len(per_step) == 8
    for step, layers in enumerate(per_step, 1):
        on = 2 <= step <= 6
        assert all((u is not None) == on for u in layers), step
        if on:
            assert all(u.shape == (4,) for u in layers)
    # Whole experts left routing (u >= 1 - rate) in some layer and step.
    dropped = sum(int((u >= 0.9).sum()) for s in per_step[1:6] for u in s)
    assert dropped >= 1
    assert all(np.isfinite(list(losses.values())))
    assert [iv["to"] for iv in t._interventions] == [0.1, 0.0]
    assert t.config.expert_dropout_rate == 0.0


def test_rollback_is_fenced_by_evolution(tmp_path, monkeypatch):
    t = _port(tmp_path, "r", max_steps=4, save_every_n_batches=2)
    real_commit = ck.CheckpointManager._commit

    def slow_commit(self, *a, **kw):
        time.sleep(0.3)  # a large save still in flight at the rollback
        return real_commit(self, *a, **kw)

    monkeypatch.setattr(ck.CheckpointManager, "_commit", slow_commit)

    def callback(step, metrics):
        if step == 3:
            assert t.evolve_experts("prune_expert", expert_idx=0)
            # The forced save is still being written: the rollback waits
            # for it and lands on it.
            assert t.rollback(to_step=3, reason="right after") is True
            assert t.global_step == 3

    t.step_callback = callback
    t.train()
    assert t.checkpoints.all_steps() == [2, 3, 4]
    assert t.rollback(to_step=2, reason="before the evolution") is False
    assert t.global_step == 4
    assert t.rollback(to_step=3, reason="after it") is True
    assert t.global_step == 3 and t.state.step == 3
    assert t._interventions[-1]["kind"] == "rollback"
    t.close()
    # A resumed run (num_experts 3) walks back past a corrupt newest step
    # to 3; step 2 predates the architecture and the guard refuses it.
    state = tmp_path / "r" / "ckpt" / "4" / ck.STATE_NAME
    data = bytearray(state.read_bytes())
    data[-100] ^= 1
    state.write_bytes(bytes(data))
    t2 = _port(tmp_path, "r", max_steps=4, num_experts=3)
    assert t2.global_step == 3
    t2.close()


def test_resume_after_add_expert_is_bitwise(tmp_path):
    kw = dict(routing_noise_std=0.1, expert_dropout_rate=0.2, max_steps=6)

    def grow_at_2(t):
        def callback(step, metrics):
            if step == 2:
                assert t.evolve_experts("add_expert", reason="capacity")
        return callback

    ref = []
    ta = _port(tmp_path, "a", **kw)
    _attach(ta, ref, grow_at_2(ta))
    ta.train()
    ta.close()
    assert ta.config.num_experts == 5 and len(ref) == 6

    got = []
    tb = _port(tmp_path, "b", **kw)
    grow = grow_at_2(tb)

    def stop_at_4(step, metrics):
        grow(step, metrics)
        if step == 4:
            tb.request_stop("injected preemption")

    _attach(tb, got, stop_at_4)
    sb = tb.train()
    tb.close()
    assert sb["preempted"] and sb["final_step"] == 4
    with pytest.raises(ValueError, match="num_experts=5"):
        _port(tmp_path, "b", **kw)
    tb2 = _port(tmp_path, "b", **kw, num_experts=5)
    assert tb2.global_step == 4 and tb2._resumed_exact_data_state
    assert tb2._min_restorable_step == 0  # the fence is the guard's now
    _record(tb2, got)
    tb2.train()
    tb2.close()
    assert [r["loss"] for r in got] == [r["loss"] for r in ref]
    assert [r["grad_norm"] for r in got] == [r["grad_norm"] for r in ref]
    for a, b in zip(ta.state.params, tb2.state.params):
        assert torch.equal(a, b)
    assert ta.state.opt_state.count == tb2.state.opt_state.count == 6


def test_router_health_gauges_match_jax():
    util = np.array([1.6, 0.2, 1.2, 1.0], np.float32)
    scalars = {"moe_router_entropy": 1.21, "moe_max_expert_share": 0.4,
               "moe_drop_rate": 0.07, "loss": 2.0}
    texts = []
    for cls, reg, rec, extra in (
            (Trainer, MetricsRegistry(), FlightRecorder(), {}),
            (JTrainer, JRegistry(), JRecorder(), {})):
        ns = types.SimpleNamespace(registry=reg, recorder=rec,
                                   global_step=7, **extra)
        cls._export_router_health(ns, {"expert_utilization": util}, scalars)
        texts.append("\n".join(
            line for line in reg.render_prometheus().splitlines()
            if line.startswith("moe_")))
        events = [e for e in rec.snapshot() if e["type"] == "router_health"]
        assert events and events[-1]["step"] == 7
    assert texts[0] == texts[1]
    loads = [float(line.split()[-1]) for line in texts[0].splitlines()
             if line.startswith("moe_expert_load{")]
    assert len(loads) == 4 and abs(sum(loads) - 1.0) < 1e-6
