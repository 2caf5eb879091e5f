"""The port's train step against the JAX package's make_train_step.

The JAX step is built as tests/test_performance.py builds it: the
conftest's 8 virtual CPU devices as a data-parallel mesh,
init_sharded_state, make_schedule/make_optimizer, make_train_step. Its
initial parameters go to the port through convert.params_from_flax. Debug
dense widths (vocab 1024, hidden 128, 2 layers, 2 q heads over 1 kv head,
intermediate 256), sequence 128, fp32, a batch of 8 with a loss mask and
loss weights, accumulation 2 (micro-batches of 4), remat on, clipping at
0.5 (the initial norm is ~2, so every step clips), a schedule of 4 steps
with one warmup step.

Tolerances (fp32; reductions run in other orders on the two sides):
- loss rtol 1e-5, grad_norm rtol 1e-4, lr rtol 1e-6, tokens_in_loss exact
  (the eval step's loss, ce_loss and tokens_in_loss likewise, before the
  first step);
- parameters after step 1 and step 3: every element within 2 x (sum of the
  learning rates so far) + 1e-6, since Adam moves an element whose
  gradient is ~0 by about +-lr whichever sign its rounding noise takes,
  and 99.9% of elements within 1e-6.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from luminaai_tpu.config import Config as JConfig
from luminaai_tpu.models.transformer import LuminaTransformer as JModel
from luminaai_tpu.parallel.mesh import build_mesh
from luminaai_tpu.parallel.sharding import init_sharded_state
from luminaai_tpu.parallel.train_step import make_eval_step as jmake_eval
from luminaai_tpu.parallel.train_step import make_train_step as jmake_step
from luminaai_tpu.training.optimizer import make_optimizer as jmake_opt
from luminaai_tpu.training.optimizer import make_schedule as jmake_sched
from luminaai_tpu_torch.config import Config as TConfig
from luminaai_tpu_torch.convert import params_from_flax
from luminaai_tpu_torch.models.transformer import LuminaTransformer as TModel
from luminaai_tpu_torch.parallel import train_step as ts
from luminaai_tpu_torch.training.optimizer import make_optimizer, make_schedule

ARCH = dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=2,
            num_kv_heads=1, seq_length=128, intermediate_size=256,
            precision="fp32", use_moe=False, batch_size=8,
            gradient_accumulation_steps=2, grad_clip_norm=0.5,
            learning_rate=1e-3, warmup_ratio=0.25, gradient_checkpointing=True,
            flash_block_q=128, flash_block_kv=128)
TOTAL = 4


def _batch(seed, batch_size=ARCH["batch_size"]):
    rng = np.random.RandomState(seed)
    shape = (batch_size, ARCH["seq_length"])
    return {
        "input_ids": rng.randint(1, ARCH["vocab_size"], shape).astype(
            np.int32),
        "loss_mask": (rng.rand(*shape) > 0.1).astype(np.float32),
        "loss_weights": rng.choice([1.0, 1.5], size=shape).astype(
            np.float32),
    }


def _jax_setup(**kw):
    cfg = JConfig(**{**ARCH, **kw})
    model = JModel(cfg)
    schedule = jmake_sched(cfg, TOTAL)
    tx = jmake_opt(cfg, TOTAL, schedule)
    mesh = build_mesh(cfg)
    state, shardings = init_sharded_state(cfg, model, tx, mesh,
                                          jax.random.key(0))
    step = jmake_step(cfg, model, shardings, mesh, schedule, tx)
    return cfg, state, step, jmake_eval(cfg, model, shardings, mesh)


def _port_setup(params, **kw):
    cfg = TConfig(**{**ARCH, **kw})
    model = TModel(cfg, device="cpu", trainable=True)
    model.load_params(params_from_flax(jax.device_get(params), cfg))
    schedule = make_schedule(cfg, TOTAL)
    tx = make_optimizer(cfg, TOTAL, schedule)
    state = ts.init_train_state(model, tx, seed=0)
    return cfg, model, state, ts.make_train_step(cfg, model, schedule, tx)


def _torch_batch(b):
    return {k: torch.as_tensor(v).long() if k == "input_ids"
            else torch.as_tensor(v) for k, v in b.items()}


def _assert_params(model, jparams, cfg, lr_sum):
    want = params_from_flax(jax.device_get(jparams), cfg)
    for name, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - want[name].numpy())
        assert diff.max() <= 2 * lr_sum + 1e-6, (name, diff.max())
        assert np.mean(diff <= 1e-6) >= 0.999, (name, np.mean(diff > 1e-6))


def _assert_metrics(mt, mj):
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(mt["grad_norm"]),
                               float(mj["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(float(mt["learning_rate"]),
                               float(mj["learning_rate"]), rtol=1e-6)
    assert float(mt["tokens_in_loss"]) == float(mj["tokens_in_loss"])


def test_three_steps_match_jax():
    _, jstate, jstep, jeval = _jax_setup(use_flash_attention=False)
    cfg, model, state, step = _port_setup(jstate.params,
                                          use_flash_attention=False)
    b = _batch(5)
    mj = jeval(jstate, {k: jnp.asarray(v) for k, v in b.items()})
    mt = ts.make_eval_step(cfg, model)(state, _torch_batch(b))
    for key in ("loss", "ce_loss", "tokens_in_loss"):
        np.testing.assert_allclose(float(mt[key]), float(mj[key]),
                                   rtol=1e-5, err_msg=key)
    lr_sum = 0.0
    for i in range(3):
        b = _batch(i)
        jstate, mj = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, mt = step(state, _torch_batch(b))
        _assert_metrics(mt, mj)
        assert float(mj["grad_norm"]) > ARCH["grad_clip_norm"]  # clipped
        lr_sum += float(mt["learning_rate"])
        if i in (0, 2):
            _assert_params(model, jstate.params, cfg, lr_sum)
    assert state.step == 3 and int(jstate.step) == 3


def test_flash_step_matches_jax():
    _, jstate, jstep, _ = _jax_setup(use_flash_attention=True)
    cfg, model, state, step = _port_setup(jstate.params,
                                          use_flash_attention=True)
    b = _batch(7)
    jstate, mj = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
    state, mt = step(state, _torch_batch(b))
    _assert_metrics(mt, mj)


# The MoE trajectory: 4 experts top-2 in both layers, the dropless gmm
# dispatch (the JAX side's CPU fallback of _pick_gmm, under its 8-device
# data-parallel shard_map), no routing noise; batch 16 so each of the 2
# micro-batches of 8 sequences splits over the 8 devices.
MOE = dict(use_moe=True, num_experts=4, moe_top_k=2, moe_dispatch="gmm",
           routing_noise_std=0.0, batch_size=16, use_flash_attention=False)
MOE_METRICS = ("aux_loss", "moe_aux_loss", "moe_z_loss", "moe_drop_rate",
               "moe_router_entropy", "moe_max_expert_share",
               "expert_utilization")


def test_moe_three_steps_match_jax():
    _, jstate, jstep, _ = _jax_setup(**MOE)
    cfg, model, state, step = _port_setup(jstate.params, **MOE)
    lr_sum = 0.0
    for i in range(3):
        b = _batch(10 + i, batch_size=16)
        jstate, mj = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, mt = step(state, _torch_batch(b))
        _assert_metrics(mt, mj)
        for key in MOE_METRICS:
            np.testing.assert_allclose(np.asarray(mt[key]),
                                       np.asarray(mj[key]), atol=1e-4,
                                       rtol=1e-4, err_msg=key)
        lr_sum += float(mt["learning_rate"])
        if i in (0, 2):
            _assert_params(model, jstate.params, cfg, lr_sum)
    assert float(mt["moe_aux_loss"]) > 0


@pytest.mark.parametrize("fused", [True, False], ids=["fused_ce", "logits"])
def test_remat_policies_give_the_same_gradients(fused):
    """nothing_saveable (a checkpoint per block) and full (no recompute)
    differentiate the same function: gradients agree to 1e-6."""
    params = JModel(JConfig(**ARCH)).init(
        jax.random.key(3), jnp.ones((1, 8), jnp.int32))["params"]
    from flax import linen as nn

    params = jax.tree.map(
        lambda x: x.unbox() if isinstance(x, nn.meta.AxisMetadata) else x,
        params, is_leaf=lambda x: isinstance(x, nn.meta.AxisMetadata))
    batch = _torch_batch(_batch(9))
    grads = {}
    for policy in ("nothing_saveable", "full"):
        cfg, model, state, _ = _port_setup(
            params, remat_policy=policy, fused_lm_head_ce=fused)
        loss_fn = ts.make_loss_fn(cfg, model)
        grads[policy], _ = ts._accumulate_grads(
            loss_fn, state.params, batch, None, 2)
    for a, b in zip(grads["nothing_saveable"], grads["full"]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_untrainable_settings_are_refused():
    for kw, match in [(dict(adam_mu_dtype="bf16"), "Adam moments"),
                      (dict(adam_state_quantization="int8"), "Adam moments"),
                      (dict(remat_policy="save_attn"), "remat_policy"),
                      (dict(dropout=0.1), "dropout")]:
        with pytest.raises(NotImplementedError, match=match):
            ts.check_trainable(TConfig(**{**ARCH, **kw}))
    with pytest.raises(ValueError, match="multiple"):
        ts.check_trainable(TConfig(**{**ARCH, "batch_size": 6,
                                      "gradient_accumulation_steps": 4}))
