"""The port's schedules and AdamW against luminaai_tpu/training/optimizer.py (optax).

- make_schedule at every count 0..total (and past it) for cosine, linear,
  constant and wsd, and with the scheduler off: rtol 1e-5 / atol 1e-12
  (optax evaluates in fp32, the port in Python floats).
- AdamW: a flax init of a small dense model and three rounds of the same
  numpy gradients through optax (the JAX make_optimizer) and through the
  port's AdamW on the converted parameters; the decay mask (ndim >= 2)
  maps onto the fused wqkv. Parameters and both moments, converted with
  params_from_flax, agree at rtol 1e-5 / atol 1e-8 (fp32, one rounding per
  elementwise op on both sides).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from luminaai_tpu.config import Config as JConfig
from luminaai_tpu.models.transformer import LuminaTransformer as JModel
from luminaai_tpu.training import optimizer as jo
from luminaai_tpu_torch.config import Config as TConfig
from luminaai_tpu_torch.convert import params_from_flax
from luminaai_tpu_torch.models.transformer import LuminaTransformer as TModel
from luminaai_tpu_torch.training import optimizer as to

ARCH = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            num_kv_heads=1, seq_length=16, intermediate_size=48,
            precision="fp32", use_moe=False)


@pytest.mark.parametrize("total", [7, 40])
@pytest.mark.parametrize("kind", ["cosine", "linear", "constant", "wsd",
                                  "off"])
def test_schedule_matches_optax(kind, total):
    kw = dict(learning_rate=3e-4, min_lr=1e-6, warmup_ratio=0.15)
    if kind == "off":
        kw["use_lr_scheduler"] = False
    else:
        kw["lr_scheduler"] = kind
    js = jo.make_schedule(JConfig(**ARCH, **kw), total)
    ts = to.make_schedule(TConfig(**ARCH, **kw), total)
    counts = list(range(total + 3))
    want = [float(js(jnp.int32(c))) for c in counts]
    got = [ts(c) for c in counts]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)
    if kind != "off":
        assert got[0] == 0.0  # the first update of a warmup has lr 0


def _unbox(params):
    from flax import linen as nn

    return jax.tree.map(
        lambda x: x.unbox() if isinstance(x, nn.meta.AxisMetadata) else x,
        params, is_leaf=lambda x: isinstance(x, nn.meta.AxisMetadata),
    )


def test_adamw_matches_optax_for_three_updates():
    kw = dict(learning_rate=1e-2, weight_decay=0.1, warmup_ratio=0.3)
    jcfg = JConfig(**ARCH, **kw)
    tcfg = TConfig(**ARCH, **kw)
    total = 10
    params = _unbox(JModel(jcfg).init(
        jax.random.key(0), jnp.ones((1, 8), jnp.int32))["params"])
    tx = jo.make_optimizer(jcfg, total)
    opt_state = tx.init(params)

    model = TModel(tcfg, device="cpu", trainable=True)
    model.load_params(params_from_flax(jax.device_get(params), tcfg))
    names = [n for n, _ in model.named_parameters()]
    tparams = [p for _, p in model.named_parameters()]
    ttx = to.make_optimizer(tcfg, total)
    tstate = ttx.init(tparams)

    rng = np.random.RandomState(0)
    for step in range(3):
        grads = jax.tree.map(
            lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32)),
            params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        tgrads = params_from_flax(jax.device_get(grads), tcfg)
        lr = ttx.apply(tparams, [tgrads[n] for n in names], tstate)
        np.testing.assert_allclose(lr, float(to.make_schedule(tcfg, total)(
            step)), rtol=0)

    adam = opt_state[0]
    assert int(adam.count) == tstate.count == 3
    want = {
        "params": params_from_flax(jax.device_get(params), tcfg),
        "mu": params_from_flax(jax.device_get(adam.mu), tcfg),
        "nu": params_from_flax(jax.device_get(adam.nu), tcfg),
    }
    got = {"params": tparams, "mu": tstate.mu, "nu": tstate.nu}
    for kind in want:
        for name, t in zip(names, got[kind]):
            np.testing.assert_allclose(
                t.detach().numpy(), want[kind][name].numpy(), rtol=1e-5,
                atol=1e-8, err_msg=f"{kind} {name}")


def test_decay_mask_selects_the_matrices():
    model = TModel(TConfig(**ARCH), device="cpu", trainable=True)
    decayed = {n for n, p in model.named_parameters() if to._decay_mask(p)}
    assert decayed == {n for n, _ in model.named_parameters()
                       if not n.endswith("norm.scale")}
