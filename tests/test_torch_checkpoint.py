"""The port's CheckpointManager (training/checkpoint.py) on the CPU.

- A save/restore round trip is bitwise: parameters, Adam moments, the
  optimizer count, the step and the generator state (the MoE routing
  noise draws from it: the next draws after a restore are the draws after
  the save).
- The saved tensors are named by the JAX model's flax paths, with the
  flax shapes.
- A bit flipped in a committed file fails the sha256 manifest; restore
  raises CheckpointIntegrityError, and restore_with_fallback walks back to
  the older step, counting the skip. A torn manifest is corrupt; a step
  without one restores with a warning.
- Rotation keeps save_total_limit steps: the newest, then the best by
  eval_loss.
- emergency_save blocks until the step is committed with its manifest,
  and falls back to the local tier when the primary dir fails.
- A periodic duplicate is not re-saved; force re-saves. A forced
  rewrite that fails leaves the committed step whole, and so does a kill
  between its two renames.
"""

import json
import threading

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from luminaai_tpu.config import Config as JConfig
from luminaai_tpu.models.transformer import LuminaTransformer as JModel
from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.convert import init_params
from luminaai_tpu_torch.models.transformer import LuminaTransformer
from luminaai_tpu_torch.monitoring.telemetry import MetricsRegistry
from luminaai_tpu_torch.parallel import train_step as ts
from luminaai_tpu_torch.training import checkpoint as ck
from luminaai_tpu_torch.training.optimizer import make_optimizer, make_schedule

ARCH = dict(vocab_size=384, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, seq_length=32, intermediate_size=128,
            precision="fp32", batch_size=2, use_flash_attention=False,
            gradient_checkpointing=False, use_moe=True, num_experts=4,
            moe_top_k=2, routing_noise_std=0.1, max_steps=10)


def _cfg(**kw) -> Config:
    return Config(**{**ARCH, **kw})


def _state(cfg, seed=0, steps=2):
    """A trained-for-`steps` state (non-zero moments, an advanced
    generator) of the tiny MoE model."""
    model = init_params(LuminaTransformer(cfg, device="cpu", trainable=True),
                        seed)
    sched = make_schedule(cfg, 10)
    tx = make_optimizer(cfg, 10, sched)
    state = ts.init_train_state(model, tx, seed)
    step = ts.make_train_step(cfg, model, sched, tx)
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        ids = torch.as_tensor(rng.randint(1, 300, (2, 32))).long()
        state, _ = step(state, {"input_ids": ids})
    return state


def _snapshot(state):
    return {
        "params": [p.detach().clone() for p in state.params],
        "mu": [m.clone() for m in state.opt_state.mu],
        "nu": [v.clone() for v in state.opt_state.nu],
        "count": state.opt_state.count, "step": state.step,
        "gen": state.generator.get_state().clone(),
    }


def _assert_same(state, snap):
    for key, live in (("params", state.params), ("mu", state.opt_state.mu),
                      ("nu", state.opt_state.nu)):
        for a, b in zip(live, snap[key]):
            assert torch.equal(a, b), key
    assert state.opt_state.count == snap["count"]
    assert state.step == snap["step"]
    assert torch.equal(state.generator.get_state(), snap["gen"])


def _mgr(cfg, path, **kw):
    return ck.CheckpointManager(cfg, str(path), registry=MetricsRegistry(),
                                **kw)


def test_round_trip_is_bitwise(tmp_path):
    cfg = _cfg()
    state = _state(cfg)
    snap = _snapshot(state)
    mgr = _mgr(cfg, tmp_path)
    assert mgr.save(state, state.step, metrics={"loss": 1.0},
                    data_state={"epoch": 1, "batch_index": 3})
    # save() copied to host before returning: training on is safe.
    with torch.no_grad():
        for p in state.params:
            p.add_(1.0)
    mgr.wait()
    after_save = torch.randn(8, generator=state.generator)

    fresh = _state(cfg, seed=1, steps=0)
    mgr.restore(fresh, 2)
    _assert_same(fresh, snap)
    assert torch.equal(torch.randn(8, generator=fresh.generator), after_save)
    meta = mgr.load_metadata(2)
    assert meta["data_state"] == {"epoch": 1, "batch_index": 3}
    assert meta["config"] == cfg.to_dict()
    assert meta["metrics"] == {"loss": 1.0}
    assert mgr.verify_step(2)["status"] == "ok"
    assert json.loads((tmp_path / "checkpoint_history.json").read_text())[
        0]["step"] == 2
    assert mgr.save_log[0]["bytes"] > 0
    assert mgr.restore_log[0]["step"] == 2


def test_saved_names_are_the_flax_paths(tmp_path):
    cfg = _cfg()
    state = _state(cfg, steps=0)
    mgr = _mgr(cfg, tmp_path)
    mgr.save(state, 0)
    mgr.wait()
    tree = ck.load_state_file(tmp_path / "0")
    jcfg = JConfig(**ARCH)
    shapes = jax.eval_shape(JModel(jcfg).init, jax.random.key(0),
                            jax.ShapeDtypeStruct((1, 8), np.int32))
    flat = jax.tree_util.tree_flatten_with_path(
        shapes["params"],
        is_leaf=lambda x: isinstance(x, nn.meta.AxisMetadata))[0]
    flax = {
        "/".join(k.key for k in path): (
            leaf.unbox() if isinstance(leaf, nn.meta.AxisMetadata) else leaf)
        for path, leaf in flat
    }
    for part in (tree["params"], tree["opt_state"]["mu"],
                 tree["opt_state"]["nu"]):
        assert sorted(part) == sorted(flax)
        for k, v in part.items():
            assert tuple(v.shape) == flax[k].shape, k
            assert v.is_contiguous()
    assert tree["format"] == ck.FORMAT and tree["step"] == 0


def _flip_a_bit(path):
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0x10
    path.write_bytes(bytes(data))


def test_bit_flip_fails_manifest_and_walks_back(tmp_path):
    cfg = _cfg()
    state = _state(cfg)
    mgr = _mgr(cfg, tmp_path)
    mgr.save(state, 1)
    snap1 = _snapshot(state)
    state = _state(cfg, steps=3)
    mgr.save(state, 2)
    mgr.wait()
    _flip_a_bit(tmp_path / "2" / ck.STATE_NAME)
    report = mgr.verify_step(2)
    assert report["status"] == "corrupt"
    assert report["mismatches"][0]["reason"] == "sha256 mismatch"
    target = _state(cfg, seed=3, steps=0)
    with pytest.raises(ck.CheckpointIntegrityError):
        mgr.restore(target, 2)
    restored, used, skipped = mgr.restore_with_fallback(target)
    assert (used, skipped) == (1, 1)
    snap1["step"], snap1["count"] = 2, 2
    _assert_same(restored, snap1)
    assert mgr._m_fallbacks.value == 1
    assert mgr._m_manifest.value == 2
    # The serving loader walks back the same way.
    step_dir, meta = ck.find_checkpoint_step(tmp_path)
    assert step_dir.name == "1" and meta["step"] == 1


def test_torn_and_missing_manifests(tmp_path):
    cfg = _cfg()
    state = _state(cfg, steps=0)
    mgr = _mgr(cfg, tmp_path)
    for step in (1, 2):
        mgr.save(state, step)
    mgr.wait()
    (tmp_path / "2" / ck.MANIFEST_NAME).write_text("{torn")
    assert mgr.verify_step(2)["status"] == "corrupt"
    (tmp_path / "1" / ck.MANIFEST_NAME).unlink()
    assert mgr.verify_step(1)["status"] == "unmanifested"
    mgr.restore(state, 1)
    assert mgr._m_unmanifested.value == 1
    # sample mode still checks sizes.
    with open(tmp_path / "1" / ck.METADATA_NAME, "a") as f:
        f.write(" ")
    ck.write_manifest(tmp_path / "1")
    assert ck.verify_step_dir(tmp_path / "1", mode="sample")["status"] == "ok"
    (tmp_path / "1" / ck.METADATA_NAME).write_text("{}")
    assert ck.verify_step_dir(tmp_path / "1", "sample")["status"] == "corrupt"


def test_rotation_keeps_the_newest_and_the_best(tmp_path):
    cfg = _cfg(save_total_limit=3)
    state = _state(cfg, steps=0)
    mgr = _mgr(cfg, tmp_path)
    losses = {1: 5.0, 2: 1.0, 3: None, 4: 3.0, 5: None, 6: None}
    for step, loss in losses.items():
        mgr.save(state, step,
                 metrics={} if loss is None else {"eval_loss": loss})
        mgr.wait()
        assert len(mgr.all_steps()) <= 3
    # 6 (newest), then the best by eval_loss: 2 (1.0), 4 (3.0).
    assert mgr.all_steps() == [2, 4, 6]
    assert mgr.best_step() == 2 and mgr.latest_step() == 6
    cfg2 = _cfg(save_total_limit=2)
    mgr2 = _mgr(cfg2, tmp_path / "plain")
    for step in range(1, 5):
        mgr2.save(state, step)
    mgr2.wait()
    assert mgr2.all_steps() == [3, 4]


def test_emergency_save_blocks_until_committed(tmp_path, monkeypatch):
    cfg = _cfg()
    state = _state(cfg)
    mgr = _mgr(cfg, tmp_path)
    release = threading.Event()
    orig = mgr._commit

    def slow_commit(*a, **kw):
        release.wait(5.0)
        return orig(*a, **kw)

    monkeypatch.setattr(mgr, "_commit", slow_commit)
    threading.Timer(0.3, release.set).start()
    assert mgr.emergency_save(state, 7, "sigterm preemption",
                              data_state={"epoch": 0, "batch_index": 7})
    # Returned only after the commit: the step and its manifest are there.
    assert mgr._writer is None
    assert mgr.verify_step(7)["status"] == "ok"
    assert mgr.load_metadata(7)["metrics"] == {"emergency": 1.0}
    assert mgr._m_emergency.labels(reason="preemption").value == 1


def test_emergency_save_falls_back_to_the_local_tier(tmp_path, monkeypatch):
    cfg = _cfg(checkpoint_local_tier=str(tmp_path / "local"))
    state = _state(cfg, steps=1)
    mgr = _mgr(cfg, tmp_path / "primary", )
    mgr._retry.max_attempts = 1

    def broken(*a, **kw):
        raise PermissionError("read-only remount")

    monkeypatch.setattr(mgr, "_commit", broken)
    assert mgr.emergency_save(state, 1, "preemption")
    assert mgr.all_steps() == []
    local = _mgr(cfg, tmp_path / "local" / "primary")
    assert local.all_steps() == [1]
    assert local.verify_step(1)["status"] == "ok"
    assert mgr._m_local_tier.value == 1


def test_duplicate_and_forced_saves(tmp_path):
    cfg = _cfg()
    state = _state(cfg, steps=1)
    mgr = _mgr(cfg, tmp_path)
    assert mgr.save(state, 1, metrics={"loss": 2.0})
    assert not mgr.save(state, 1, metrics={"loss": 9.0})
    mgr.wait()
    assert mgr.load_metadata(1)["metrics"] == {"loss": 2.0}
    assert mgr.save(state, 1, metrics={"loss": 9.0}, force=True)
    mgr.close()
    assert mgr.load_metadata(1)["metrics"] == {"loss": 9.0}
    assert mgr.verify_step(1)["status"] == "ok"
    # A stray tmp dir (a kill mid-write) is not a step.
    (tmp_path / "3.tmp-1").mkdir()
    assert mgr.all_steps() == [1]


def test_failed_forced_rewrite_keeps_the_committed_step(tmp_path,
                                                         monkeypatch):
    cfg = _cfg()
    state = _state(cfg, steps=1)
    mgr = _mgr(cfg, tmp_path)
    mgr._retry.max_attempts = 1
    assert mgr.save(state, 1, metrics={"loss": 2.0})
    mgr.wait()
    snap = _snapshot(state)
    with torch.no_grad():
        state.params[0].add_(1.0)  # the rewrite would store other bytes

    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(ck, "write_manifest", broken)
    assert mgr.save(state, 1, metrics={"loss": 9.0}, force=True)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.all_steps() == [1]
    assert mgr.verify_step(1)["status"] == "ok"
    assert mgr.load_metadata(1)["metrics"] == {"loss": 2.0}
    _assert_same(mgr.restore(_state(cfg, seed=1, steps=1), 1), snap)

    # A kill between the rewrite's two renames: the old step is only
    # under its aside name, and the next manager puts it back.
    (tmp_path / "1").rename(tmp_path / f"1{ck.ASIDE}4242")
    (tmp_path / f"2{ck.ASIDE}4242").mkdir()
    (tmp_path / "2").mkdir()
    mgr2 = _mgr(cfg, tmp_path)
    assert mgr2.all_steps() == [1, 2]
    assert mgr2.verify_step(1)["status"] == "ok"
    assert not list(tmp_path.glob(f"*{ck.ASIDE}*"))
