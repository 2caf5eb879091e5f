"""The five remat policies and dropout against the JAX package, on the CPU.

For each JAX REMAT_POLICIES entry the JAX train step's loss function
(parallel/train_step.make_loss_fn, gradient checkpointing on, the flash
kernels in Pallas interpret mode) and the port's give the same loss and
gradients: 2 layers, hidden 128, 2 q heads over 1 kv head (head_dim 64),
sequence 128, fp32, batch 2 with a loss mask; weights from a flax init
through convert.params_from_flax. Tolerances of test_torch_train_step.py:
loss rtol 1e-5, gradient norm rtol 1e-4 (each gradient within atol 1e-6
of JAX's).

The port's B1 forward (flash_fwd, its plain version on the CPU) is
counted: once per layer in the forward under every policy, and again per
layer in the backward except under save_attn (its (O, lse) kept by name)
and full (nothing recomputed).

Dropout: no layer of either package reads config.dropout, so a train step
at dropout 0.1 equals one at 0, bitwise within each package.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from luminaai_tpu.config import Config as JConfig
from luminaai_tpu.models.transformer import LuminaTransformer as JModel
from luminaai_tpu.parallel.train_step import make_loss_fn as jmake_loss
from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.convert import params_from_flax
from luminaai_tpu_torch.models.transformer import (
    REMAT_POLICIES,
    LuminaTransformer,
)
from luminaai_tpu_torch.ops import flash_attention as fa
from luminaai_tpu_torch.ops.fused import global_norm
from luminaai_tpu_torch.parallel import train_step as ts
from luminaai_tpu_torch.training.optimizer import make_optimizer, make_schedule

ARCH = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
            num_kv_heads=1, seq_length=128, intermediate_size=256,
            precision="fp32", use_moe=False, batch_size=2,
            gradient_checkpointing=True, use_flash_attention=True,
            flash_block_q=128, flash_block_kv=128)
POLICIES = ("nothing_saveable", "save_outs", "save_attn", "dots_saveable",
            "full")
# B1 calls per layer in the backward (recompute) under each policy.
RECOMPUTES_B1 = {"nothing_saveable": 1, "save_outs": 1, "save_attn": 0,
                 "dots_saveable": 1, "full": 0}


def _unbox(tree):
    from flax import linen as nn

    return jax.tree.map(
        lambda x: x.unbox() if isinstance(x, nn.meta.AxisMetadata) else x,
        tree, is_leaf=lambda x: isinstance(x, nn.meta.AxisMetadata))


@pytest.fixture(scope="module")
def params():
    p = JModel(JConfig(**ARCH)).init(jax.random.key(0),
                                     jnp.ones((1, 8), jnp.int32))["params"]
    return jax.device_get(_unbox(p))


def _batch():
    rng = np.random.RandomState(3)
    shape = (ARCH["batch_size"], ARCH["seq_length"])
    return {"input_ids": rng.randint(1, ARCH["vocab_size"], shape).astype(
                np.int32),
            "loss_mask": (rng.rand(*shape) > 0.1).astype(np.float32)}


def _jax_loss_grads(params, **kw):
    cfg = JConfig(**{**ARCH, **kw})
    loss_fn = jmake_loss(cfg, JModel(cfg))
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, batch, jax.random.key(1))
    return float(loss), jax.device_get(grads)


def _port(params, **kw):
    cfg = Config(**{**ARCH, **kw})
    model = LuminaTransformer(cfg, device="cpu", trainable=True)
    model.load_params(params_from_flax(params, cfg))
    return cfg, model


def _torch_batch():
    return {k: torch.as_tensor(v).long() if k == "input_ids"
            else torch.as_tensor(v) for k, v in _batch().items()}


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_jax_and_recomputes_b1_as_jax(policy, params,
                                                     monkeypatch):
    assert set(REMAT_POLICIES) == set(POLICIES)
    j_loss, j_grads = _jax_loss_grads(params, remat_policy=policy)
    cfg, model = _port(params, remat_policy=policy)
    calls = []
    real = fa.flash_fwd

    def counting(*args, **kwargs):
        calls.append(torch.is_grad_enabled())
        return real(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_fwd", counting)
    named = [(n, p) for n, p in model.named_parameters()]
    loss, _ = ts.make_loss_fn(cfg, model)(_torch_batch())
    in_forward = len(calls)
    grads = torch.autograd.grad(loss, [p for _, p in named])
    L = cfg.num_layers
    assert in_forward == L
    assert len(calls) - in_forward == RECOMPUTES_B1[policy] * L, calls

    np.testing.assert_allclose(float(loss), j_loss, rtol=1e-5)
    want = params_from_flax(j_grads, cfg)
    np.testing.assert_allclose(
        float(global_norm(list(grads))),
        float(global_norm(list(want.values()))), rtol=1e-4)
    for (name, _), g in zip(named, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-6,
                                   rtol=1e-4, err_msg=name)


def test_dropout_is_read_by_no_layer(params):
    j0, g0 = _jax_loss_grads(params, dropout=0.0, use_flash_attention=False)
    j1, g1 = _jax_loss_grads(params, dropout=0.1, use_flash_attention=False)
    assert j0 == j1
    for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
        assert np.array_equal(a, b)

    out = {}
    for rate in (0.0, 0.1):
        cfg, model = _port(params, dropout=rate, use_flash_attention=False)
        sched = make_schedule(cfg, 4)
        tx = make_optimizer(cfg, 4, sched)
        state = ts.init_train_state(model, tx, seed=0)
        step = ts.make_train_step(cfg, model, sched, tx)
        state, metrics = step(state, _torch_batch())
        out[rate] = (metrics, [p.detach().clone() for p in state.params])
    (m0, p0), (m1, p1) = out[0.0], out[0.1]
    assert float(m0["loss"]) == float(m1["loss"])
    assert float(m0["grad_norm"]) == float(m1["grad_norm"])
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    np.testing.assert_allclose(float(m1["loss"]), j1, rtol=1e-5)
