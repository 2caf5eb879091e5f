"""The port's adaptive orchestrator against the JAX package's, on the CPU.

- Decisions: the same scripted metric streams (plateau, steady progress,
  grad explosion, loss spike with and without a checkpoint, NaN losses,
  expert collapse and its clearing, sustained drops, slack capacity, dead
  expert, balanced-but-dropping, imbalance, rising loss, curriculum
  velocity, batch noise, the cooldown and the confidence floor) go through
  both AdaptiveTrainingOrchestrators, each over a stub trainer that
  records its hook calls: the decision lists (to_dict()) and the hook-call
  sequences are identical.
- Pure pieces, exactly equal: RealTimeAnalytics' loss dynamics,
  trajectory and anomalies; AdaptiveCurriculum; ProductionMonitoring;
  ComputeEfficiencyTracker (the port's default peak is the H100's);
  MetaLearningEngine's history file written by one side and read by the
  other, in both directions.
- Expert surgery: evolution.grow_expert / prune_expert on the port's
  parameters against JAX's on the flax tree, converted with
  convert.params_from_flax: exact at noise_scale=0 and for prune; shape,
  mean and scale with noise; num_experts_in and evolution_feasible.
"""

import json

import jax
import numpy as np
import pytest
import torch

from luminaai_tpu.config import Config as JConfig
from luminaai_tpu.training import evolution as jevo
from luminaai_tpu.training import orchestrator as jorch
from luminaai_tpu.training import scaler as jscaler
from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.convert import params_from_flax
from luminaai_tpu_torch.training import evolution as evo
from luminaai_tpu_torch.training import orchestrator as orch
from luminaai_tpu_torch.training import scaler

BASE = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, seq_length=64, batch_size=8, use_moe=True,
            num_experts=4, moe_top_k=2, max_steps=1000,
            health_check_interval=5, intervention_cooldown_steps=10)


class StubTrainer:
    """What the orchestrator reads of a Trainer, recording each hook call
    (name, arguments) instead of training."""

    def __init__(self, config, rollback_ok=True):
        self.config = config
        self.total_steps = config.max_steps
        self.global_step = 0
        self._lr_override = None
        self.rollback_ok = rollback_ok
        self.calls = []
        self.step_callback = None

    def schedule(self, step):
        return self.config.learning_rate * (1.0 - step / self.total_steps)

    def _call(self, name, *args):
        self.calls.append([name, *args])

    def adjust_learning_rate(self, new_lr, reason=""):
        self._call("adjust_learning_rate", new_lr, reason)
        self._lr_override = new_lr

    def rollback(self, to_step=None, reason=""):
        self._call("rollback", to_step, reason)
        if self.rollback_ok:
            self.global_step = to_step
        return self.rollback_ok

    def evolve_experts(self, action, expert_idx=None, reason=""):
        self._call("evolve_experts", action, expert_idx, reason)
        self.config.num_experts += 1 if action == "add_expert" else -1
        return True

    def set_grad_clip(self, norm, reason=""):
        self._call("set_grad_clip", norm, reason)
        self.config.grad_clip_norm = norm

    def adjust_capacity_factor(self, value, reason=""):
        self._call("adjust_capacity_factor", value, reason)
        self.config.capacity_factor = float(value)

    def adjust_routing_temperature(self, value, reason=""):
        self._call("adjust_routing_temperature", value, reason)
        self.config.routing_temperature = float(value)

    def adjust_batch_size(self, value, reason=""):
        self._call("adjust_batch_size", value, reason)
        self.config.batch_size = value
        return True

    def enable_expert_dropout(self, rate, reason=""):
        self._call("enable_expert_dropout", rate, reason)
        self.config.expert_dropout_rate = float(rate)

    def adjust_weight_decay(self, value, reason=""):
        self._call("adjust_weight_decay", value, reason)
        self.config.weight_decay = float(value)

    def set_data_difficulty(self, difficulty, reason=""):
        self._call("set_data_difficulty", difficulty, reason)
        return True


def _noise(i, scale):
    return scale * np.random.RandomState(i).randn()


def _steps(n, every=5):
    return range(every, every * n + 1, every)


def stream_plateau():
    return [(s, {"loss": 1.8, "grad_norm": 1.0}) for s in _steps(120)]


def stream_steady_progress():
    return [(s, {"loss": 6.0 - 0.004 * s, "grad_norm": 1.0})
            for s in _steps(120)]


def stream_grad_explosion():
    return [(s, {"loss": 1.0 + _noise(s, 0.01),
                 "grad_norm": 1.0 if s < 400 else 500.0})
            for s in _steps(100)]


def stream_loss_spike():
    return [(s, {"loss": (1.0 + _noise(s, 0.001)) if s < 350 else 3.5,
                 "grad_norm": 1.0}) for s in _steps(90)]


def stream_nan():
    return [(s, {"loss": float("nan") if 200 <= s < 260 else 1.8,
                 "grad_norm": 1.0}) for s in _steps(120)]


def _moe(util, drop):
    return {"expert_utilization": np.asarray(util, dtype=np.float32),
            "moe_drop_rate": drop}


def stream_collapse_and_clearing():
    collapsed, healthy = [3.2, 0.01, 0.4, 0.39], [1.1, 0.9, 1.0, 1.0]
    return [(s, {"loss": 1.0, "grad_norm": 1.0,
                 **_moe(collapsed if s <= 500 else healthy, 0.0)})
            for s in _steps(180)]


def stream_sustained_drops():
    return [(s, {"loss": 2.0 + _noise(s, 0.1), "grad_norm": 1.0,
                 **_moe([1.0, 1.0, 1.0, 1.0], 0.3)}) for s in _steps(60)]


def stream_slack_capacity():
    return [(s, {"loss": 2.0 + _noise(s, 0.1), "grad_norm": 1.0,
                 **_moe([1.05, 0.95, 1.0, 1.0], 0.0)}) for s in _steps(60)]


def stream_dead_expert():
    return [(s, {"loss": 2.0 + _noise(s, 0.1), "grad_norm": 1.0,
                 **_moe([1.6, 0.01, 1.2, 1.19], 0.0)}) for s in _steps(60)]


def stream_imbalance():
    return [(s, {"loss": 2.0 + _noise(s, 0.1), "grad_norm": 1.0,
                 **_moe([2.5, 0.2, 0.6, 0.7] if s < 200 else
                        [1.02, 0.98, 1.0, 1.0], 0.01)})
            for s in _steps(100)]


def stream_rising_loss():
    return [(s, {"loss": 1.0 + 0.002 * (s // 5), "grad_norm": 1.0})
            for s in _steps(100)]


def stream_curriculum_velocity():
    return [(s, {"loss": 6.0 - 0.05 * s / 5, "grad_norm": 1.0})
            for s in _steps(40)]


def stream_batch_noise():
    return [(s, {"loss": 1.8 + _noise(s, 0.001),
                 "grad_norm": 1.0 + abs(_noise(s + 7, 3.0))})
            for s in _steps(120)]


# name: (stream, config overrides, rollback available)
CASES = {
    "plateau": (stream_plateau, {}, True),
    "steady_progress": (stream_steady_progress, {}, True),
    "grad_explosion": (stream_grad_explosion, {}, True),
    "loss_spike": (stream_loss_spike, {}, True),
    "loss_spike_no_checkpoint": (stream_loss_spike, {}, False),
    "nan": (stream_nan, {}, True),
    "collapse_and_clearing": (stream_collapse_and_clearing,
                              {"enable_adaptive_lr": False}, True),
    "sustained_drops": (stream_sustained_drops,
                        {"enable_adaptive_lr": False}, True),
    "slack_capacity": (stream_slack_capacity,
                       {"enable_adaptive_lr": False}, True),
    "dead_expert": (stream_dead_expert,
                    {"enable_adaptive_lr": False,
                     "enable_architecture_evolution": True}, True),
    "balanced_but_dropping": (stream_sustained_drops,
                              {"enable_adaptive_lr": False,
                               "enable_architecture_evolution": True}, True),
    "imbalance": (stream_imbalance,
                  {"enable_adaptive_lr": False,
                   "routing_temperature": 1.2}, True),
    "rising_loss": (stream_rising_loss, {"enable_adaptive_lr": False},
                    True),
    "curriculum_velocity": (stream_curriculum_velocity,
                            {"enable_adaptive_curriculum": True,
                             "enable_adaptive_lr": False,
                             "enable_moe_routing_optimization": False,
                             "enable_adaptive_wd": False, "max_steps": 200},
                            True),
    "batch_noise": (stream_batch_noise,
                    {"enable_adaptive_lr": False,
                     "enable_batch_size_optimization": True}, True),
    "cooldown": (stream_plateau, {"intervention_cooldown_steps": 400},
                 True),
    "confidence_floor": (stream_grad_explosion,
                         {"min_override_threshold": 0.95}, True),
}


def _run_stream(mod, cfg_cls, name, tmp_path):
    stream, overrides, rollback_ok = CASES[name]
    cfg = cfg_cls(**{**BASE, **overrides,
                     "output_dir": str(tmp_path / mod.__name__)})
    trainer = StubTrainer(cfg, rollback_ok=rollback_ok)
    o = mod.AdaptiveTrainingOrchestrator(trainer)
    for step, metrics in stream():
        trainer.global_step = step
        o.on_metrics(step, dict(metrics))
    return ([d.to_dict() for d in o.decisions], trainer.calls,
            o.analytics.predict_training_trajectory())


def _canon(obj) -> str:
    return json.dumps(obj, sort_keys=True, default=repr)


@pytest.mark.parametrize("name", sorted(CASES))
def test_decisions_equal_jax(name, tmp_path):
    ours = _run_stream(orch, Config, name, tmp_path)
    theirs = _run_stream(jorch, JConfig, name, tmp_path)
    assert _canon(ours[0]) == _canon(theirs[0])
    assert _canon(ours[1]) == _canon(theirs[1])
    assert _canon(ours[2]) == _canon(theirs[2])
    decisions, calls = ours[0], ours[1]
    if name == "cooldown":
        # The plateau's interventions, no two within the cooldown.
        steps = [d["step"] for d in decisions]
        assert len(steps) >= 2 and min(np.diff(steps)) >= 400, steps
    elif name == "confidence_floor":
        assert not decisions and not calls
    elif name == "nan":
        assert all(d["kind"] == "lr_adjust" for d in decisions)
    else:
        assert decisions and all(d["applied"] for d in decisions), decisions
    kinds = {d["kind"] for d in decisions}
    expect = {
        "plateau": "lr_adjust", "steady_progress": "lr_adjust",
        "grad_explosion": "lr_emergency", "loss_spike": "rollback",
        "loss_spike_no_checkpoint": "rollback",
        "collapse_and_clearing": "expert_dropout",
        "sustained_drops": "capacity_up", "slack_capacity": "capacity_down",
        "dead_expert": "prune_expert", "balanced_but_dropping": "add_expert",
        "imbalance": "temperature_up", "rising_loss": "weight_decay",
        "curriculum_velocity": "curriculum", "batch_noise": "batch_size",
    }.get(name)
    if expect:
        assert expect in kinds, kinds
    if name == "collapse_and_clearing":
        rates = [c[1] for c in calls if c[0] == "enable_expert_dropout"]
        assert rates[0] == 0.1 and rates[-1] == 0.0, calls
        assert any(c[0] == "set_grad_clip" for c in calls)
    if name == "imbalance":
        assert "temperature_down" in kinds
    if name == "loss_spike_no_checkpoint":
        names = [c[0] for c in calls]
        falls = [names[i + 1] for i, n in enumerate(names) if n == "rollback"]
        assert falls and set(falls) == {"adjust_learning_rate"}, names


ANALYTICS_STREAMS = {
    "falling": [(i, 5.0 - 0.03 * i, 1.0, None) for i in range(100)],
    "spike": [(i, 1.0 + _noise(i, 0.001) if i < 60 else 3.5,
               1.0 if i < 60 else 500.0, None) for i in range(70)],
    "collapse": [(i, 1.0, 1.0, np.array([7.5, 0.001, 0.2, 0.3]))
                 for i in range(60)],
    "rising": [(i, 1.0 + 0.01 * i, 1.0, None) for i in range(20)],
    "flat": [(i, 1.5, 1.0, None) for i in range(20)],
}


@pytest.mark.parametrize("name", sorted(ANALYTICS_STREAMS))
def test_analytics_equal_jax(name):
    ours, theirs = orch.RealTimeAnalytics(), jorch.RealTimeAnalytics()
    for step, loss, gn, util in ANALYTICS_STREAMS[name]:
        ours.observe(step, loss, gn, util)
        theirs.observe(step, loss, gn, util)
    for fn in ("analyze_loss_dynamics", "predict_training_trajectory",
               "detect_anomalies"):
        a, b = getattr(ours, fn)(), getattr(theirs, fn)()
        assert _canon(a) == _canon(b), fn
    if name != "flat":
        assert ours.detect_anomalies() or name in ("falling", "rising")


def test_curriculum_equal_jax():
    ours, theirs = scaler.AdaptiveCurriculum(), jscaler.AdaptiveCurriculum()
    seq = ([6.0 - 0.05 * i for i in range(20)] + [5.0] * 20
           + [float("nan")] + [5.0 + 0.02 * i for i in range(20)])
    got, want = [], []
    for loss in seq:
        ours.update(loss)
        theirs.update(loss)
        got.append(ours.difficulty())
        want.append(theirs.difficulty())
    assert got == want
    assert got[0] == 0.3 and max(got) > 0.8 and got[-1] < 0.5


def test_production_monitoring_and_efficiency_equal_jax():
    ref = ["the cat sat on the mat"] * 10
    for texts in (["the cat sat on the mat"], ["zx qv wk jj pq mm"] * 5):
        assert (orch.ProductionMonitoring().monitor_semantic_drift(texts, ref)
                == jorch.ProductionMonitoring().monitor_semantic_drift(
                    texts, ref))
    flagged = ["please give me your credit card number", "fine text"]
    assert (orch.ProductionMonitoring().track_safety_metrics(flagged)
            == jorch.ProductionMonitoring().track_safety_metrics(flagged))
    ours = scaler.ComputeEfficiencyTracker(active_params=1_000_000)
    assert ours.peak_flops == 989e12
    theirs = jscaler.ComputeEfficiencyTracker(active_params=1_000_000,
                                              peak_flops=989e12)
    a, b = ours.record(10_000, 0.5), theirs.record(10_000, 0.5)
    assert {k: v for k, v in a.items() if k != "ts"} == {
        k: v for k, v in b.items() if k != "ts"}
    assert ours.summary()["samples"] == theirs.summary()["samples"] == 1


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_meta_history_round_trip(writer, tmp_path):
    path = str(tmp_path / "meta_history.jsonl")
    kw = dict(BASE, learning_rate=2e-4)
    mods = {"jax": (jorch, JConfig), "port": (orch, Config)}
    w_mod, w_cfg = mods[writer]
    r_mod, r_cfg = mods["port" if writer == "jax" else "jax"]
    for loss in (1.2, 0.8, 2.0):
        w_mod.MetaLearningEngine(path).record_training_outcome(
            w_cfg(**kw), {"loss": loss})
    ours = r_mod.MetaLearningEngine(path)
    again = w_mod.MetaLearningEngine(path)
    assert [{k: v for k, v in r.items() if k != "ts"} for r in ours.runs] \
        == [{k: v for k, v in r.items() if k != "ts"} for r in again.runs]
    assert len(ours.runs) == 3
    sug = ours.suggest_hyperparameters(r_cfg(**kw))
    assert sug == again.suggest_hyperparameters(w_cfg(**kw))
    assert sug["learning_rate"] == 2e-4 and sug["based_on_runs"] == 3


# -- expert surgery ---------------------------------------------------------
TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, seq_length=32, intermediate_size=128,
            use_moe=True, num_experts=4, moe_top_k=2, precision="fp32",
            use_flash_attention=False)


@pytest.fixture(scope="module")
def trees():
    """A flax parameter tree of the TINY model (numpy leaves drawn from a
    seed, in the layout convert.params_from_flax reads) and its port
    state_dict."""
    rng = np.random.RandomState(0)
    H, nq, nkv, d, F, E = 64, 4, 2, 16, 128, 4

    def r(*shape):
        return rng.randn(*shape).astype(np.float32)

    jparams = {"embedder": {"embedding": r(128, H)},
               "final_norm": {"scale": r(H)}}
    for i in range(2):
        jparams[f"layer_{i}"] = {
            "attn_norm": {"scale": r(H)}, "ffn_norm": {"scale": r(H)},
            "attention": {"wq": r(H, nq, d), "wk": r(H, nkv, d),
                          "wv": r(H, nkv, d), "wo": r(nq, d, H)},
            "moe": {"router": r(H, E), "wi": r(E, H, 2 * F),
                    "wo": r(E, F, H)},
        }
    cfg = Config(**TINY)
    return jparams, cfg, params_from_flax(jparams, cfg)


def _as_port(jtree, cfg, num_experts):
    return params_from_flax(jax.device_get(jtree),
                            Config(**{**TINY, "num_experts": num_experts}))


def test_grow_expert_noise_free_equals_jax(trees):
    jparams, cfg, sd = trees
    theirs = _as_port(jevo.grow_expert(jparams, jax.random.key(1),
                                       noise_scale=0.0), cfg, 5)
    ours = evo.grow_expert(sd, torch.Generator().manual_seed(1),
                           noise_scale=0.0)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k
    assert evo.num_experts_in(ours) == 5 == jevo.num_experts_in(
        jevo.grow_expert(jparams, jax.random.key(1)))


@pytest.mark.parametrize("idx", [0, 2, 3])
def test_prune_expert_equals_jax(trees, idx):
    jparams, cfg, sd = trees
    theirs = _as_port(jevo.prune_expert(jparams, idx), cfg, 3)
    ours = evo.prune_expert(sd, idx)
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k
    assert evo.num_experts_in(ours) == 3
    with pytest.raises(ValueError, match="out of range"):
        evo.prune_expert(sd, 4)


def test_grow_expert_with_noise(trees):
    _, _, sd = trees
    ours = evo.grow_expert(sd, torch.Generator().manual_seed(5),
                           noise_scale=0.01)
    again = evo.grow_expert(sd, torch.Generator().manual_seed(5),
                            noise_scale=0.01)
    for prefix in evo.moe_prefixes(sd):
        r = ours[prefix + "router"]
        assert r.shape == (64, 5)
        dev = r[:, 4] - sd[prefix + "router"].mean(-1)
        assert 0.005 < float(dev.std()) < 0.02
        for name in ("wi", "wo"):
            w, w0 = ours[prefix + name], sd[prefix + name]
            assert w.shape[0] == 5 and w.shape[1:] == w0.shape[1:]
            assert torch.equal(w[:4], w0)
            dev = w[4] - w0.mean(0)
            assert abs(float(dev.mean())) < 1e-3
            assert 0.009 < float(dev.std()) < 0.011
            assert torch.equal(w, again[prefix + name])
    # Non-MoE parameters pass through as the same tensors.
    assert ours["embedder.embedding"] is sd["embedder.embedding"]
    assert evo.moe_prefixes(sd) == ["layers.0.moe.", "layers.1.moe."]


def test_evolution_feasible_and_dense():
    cfg = Config(**TINY)
    assert evo.evolution_feasible(cfg, 5) == (True, "ok")
    ok, why = evo.evolution_feasible(cfg, 1)
    assert not ok and "below 2" in why
    jcfg = JConfig(**TINY)
    for E in (1, 3, 5):
        assert evo.evolution_feasible(cfg, E)[0] == jevo.evolution_feasible(
            jcfg, E)[0]
    dense = Config(**{**TINY, "use_moe": False})
    assert evo.evolution_feasible(dense, 5)[0] is False
    assert evo.num_experts_in({"layers.0.ffn.wi": torch.zeros(2)}) is None
