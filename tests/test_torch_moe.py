"""The port's MoELayer against the JAX MoELayer, in fp32 on the CPU.

Both layers hold the same weights (a flax init of the JAX layer, handed to
the port as numpy) and take the same input, drawn from a numpy seed.
Routing noise and expert dropout are off (threefry and Philox draws cannot
match). Dispatch 'sort' and 'gmm'; on the JAX side gmm runs as
tests/test_moe.py runs it: the CPU fallback of `_pick_gmm`, and once
megablox in Pallas interpret mode through a monkeypatch of
`moe._GMM_OVERRIDE` (a module attribute of the test process). Groups of 50
tokens (200 pair rows, padded to 256) and 64 tokens; capacity factor 1.25,
and 0.5 to force drops.

Compared: the output, the aux and z losses, drop rate, expert utilization,
router entropy and max expert share, and the gradients of x, router, wi
and wo of sum(out * ct) + aux_loss + z_loss. Tolerance 1e-4 (fp32; sums
in other orders on the two sides).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from luminaai_tpu.config import Config as JConfig
from luminaai_tpu.models import moe as jmoe
from luminaai_tpu_torch.config import Config as TConfig
from luminaai_tpu_torch.models import moe as tmoe

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, seq_length=64, intermediate_size=96,
            use_moe=True, num_experts=4, moe_top_k=2, routing_noise_std=0.0,
            gradient_checkpointing=False, precision="fp32")
METRICS = ("moe_aux_loss", "moe_z_loss", "moe_drop_rate",
           "expert_utilization", "moe_router_entropy",
           "moe_max_expert_share")


def _unbox(tree):
    from flax import linen as nn

    return jax.tree.map(
        lambda x: x.unbox() if isinstance(x, nn.meta.AxisMetadata) else x,
        tree, is_leaf=lambda x: isinstance(x, nn.meta.AxisMetadata))


def _megablox_interpret(lhs, rhs, group_sizes, preferred_element_type, **_):
    from jax.experimental.pallas.ops.tpu.megablox import gmm

    return gmm(lhs, rhs, group_sizes,
               preferred_element_type=preferred_element_type, interpret=True)


def _run_jax(cfg, x, ct):
    layer = jmoe.MoELayer(cfg, dtype=jnp.float32)
    params = _unbox(jax.jit(layer.init)(jax.random.PRNGKey(0),
                                        jnp.asarray(x)))

    def loss(p, xx):
        out, m = layer.apply(p, xx)
        return (jnp.sum(out * ct) + m["moe_aux_loss"] + m["moe_z_loss"],
                (out, m))

    (_, (out, m)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    grads = {k: np.asarray(v) for k, v in gp["params"].items()}
    grads["x"] = np.asarray(gx)
    return (jax.device_get(params["params"]), np.asarray(out),
            {k: np.asarray(v) for k, v in m.items()}, grads)


def _run_port(cfg, params, x, ct):
    layer = tmoe.MoELayer(cfg, dtype=torch.float32, device="cpu",
                          trainable=True)
    with torch.no_grad():
        for name in ("router", "wi", "wo"):
            getattr(layer, name).copy_(torch.as_tensor(np.array(params[name])))
    tx = torch.as_tensor(x).requires_grad_()
    out, m = layer(tx)
    (torch.sum(out * torch.as_tensor(ct)) + m["moe_aux_loss"]
     + m["moe_z_loss"]).backward()
    grads = {name: getattr(layer, name).grad.numpy()
             for name in ("router", "wi", "wo")}
    grads["x"] = tx.grad.numpy()
    return out.detach().numpy(), {k: v.detach().numpy()
                                  for k, v in m.items()}, grads


CASES = {
    # name: (dispatch, capacity factor, seq, megablox interpret on the
    # JAX side)
    "sort": ("sort", 1.25, 50, False),
    "sort_drops": ("sort", 0.5, 64, False),
    "gmm": ("gmm", 1.25, 50, False),
    "gmm_drops": ("gmm", 0.5, 50, False),
    "gmm_megablox": ("gmm", 0.5, 64, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_layer_matches_jax(case, monkeypatch):
    dispatch, cf, seq, megablox = CASES[case]
    if megablox:
        monkeypatch.setattr(jmoe, "_GMM_OVERRIDE", _megablox_interpret)
    kw = dict(ARCH, moe_dispatch=dispatch, capacity_factor=cf)
    rng = np.random.RandomState(4)
    x = rng.randn(2, seq, 64).astype(np.float32)
    ct = rng.randn(2, seq, 64).astype(np.float32)
    params, jout, jm, jgrads = _run_jax(JConfig(**kw), x, ct)
    tout, tm, tgrads = _run_port(TConfig(**kw), params, x, ct)
    np.testing.assert_allclose(tout, jout, **TOL)
    for key in METRICS:
        np.testing.assert_allclose(tm[key], jm[key], err_msg=key, **TOL)
    if cf < 1:
        assert float(tm["moe_drop_rate"]) > 0.0
    for key in ("x", "router", "wi", "wo"):
        np.testing.assert_allclose(tgrads[key], jgrads[key], err_msg=key,
                                   **TOL)


def test_sort_routing_matches_jax():
    """Slots, gates, drops and counts of the sort routing, exactly (slots
    and counts) and within 1e-6 (gates), under heavy capacity pressure."""
    rng = np.random.RandomState(5)
    probs = rng.dirichlet(np.ones(8), size=(3, 40)).astype(np.float32)
    for cap in (1, 4, 16):
        js, jg, jd, jc = jax.jit(jmoe._sort_routing, static_argnums=(1, 2))(
            jnp.asarray(probs), 2, cap)
        ts, tg, td, tc = tmoe.sort_routing(torch.as_tensor(probs), 2, cap)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_capacity_matches_jax_formula():
    for cf, s, k, e in ((1.25, 2048, 2, 8), (1.1, 256, 2, 8), (1.25, 1, 2, 8),
                        (0.5, 64, 2, 4), (1.25, 64, 1, 16)):
        cfg = TConfig(**dict(ARCH, capacity_factor=cf, moe_top_k=k,
                             num_experts=e))
        want = max(1, int(cf * s * k / e))
        want = ((want + 7) // 8) * 8 if want >= 8 else want
        assert tmoe.expert_capacity(cfg, s) == want


def test_routing_draws_change_assignment_and_are_reproducible():
    """Training-time noise and expert dropout come from the generator:
    the same seed routes the same way, and the draws move the routing."""
    cfg = TConfig(**dict(ARCH, routing_noise_std=1.0,
                         expert_dropout_rate=0.5))
    layer = tmoe.MoELayer(cfg, dtype=torch.float32, device="cpu")
    torch.nn.init.normal_(layer.router, std=0.02)
    torch.nn.init.normal_(layer.wi, std=0.02)
    torch.nn.init.normal_(layer.wo, std=0.02)
    x = torch.randn(2, 16, 64, generator=torch.Generator().manual_seed(0))
    draws = [layer.draw_routing(2, 16, torch.Generator().manual_seed(s), "cpu")
             for s in (1, 1, 2)]
    probs = [layer.route(x, d)[1] for d in draws]
    torch.testing.assert_close(probs[0], probs[1], atol=0, rtol=0)
    assert not torch.allclose(probs[0], probs[2])
    assert not torch.allclose(probs[0], layer.route(x)[1])
    assert layer.draw_routing(2, 16, None, "cpu").keys() == {"noise",
                                                              "expert_u"}
    quiet = tmoe.MoELayer(dataclasses.replace(cfg, routing_noise_std=0.0,
                                              expert_dropout_rate=0.0),
                          dtype=torch.float32, device="cpu")
    assert quiet.draw_routing(2, 16, None, "cpu") is None


@pytest.mark.parametrize("mode", ["gather", "einsum", "a2a"])
def test_unported_dispatch_is_refused(mode):
    cfg = TConfig(**dict(ARCH, moe_dispatch=mode))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmoe.MoELayer(cfg, dtype=torch.float32, device="cpu")


def test_moe_config_fields_and_patterns_match_jax():
    fields = ("num_experts", "moe_top_k", "capacity_factor",
              "load_balancing_weight", "router_z_loss_weight",
              "routing_temperature", "routing_noise_std",
              "expert_dropout_rate", "moe_pattern", "dense_start_layers",
              "dense_end_layers", "expert_output_scaling", "moe_dispatch")
    jd, td = JConfig(), TConfig()
    for f in fields:
        assert getattr(td, f) == getattr(jd, f), f
    for pattern in ("all", "every_3rd", "every_4th", "sandwich", "none"):
        kw = dict(num_layers=9, use_moe=True, moe_pattern=pattern)
        jc, tc = JConfig(**kw), TConfig(**kw)
        assert [tc.is_moe_layer(i) for i in range(9)] == [
            jc.is_moe_layer(i) for i in range(9)]
        assert tc.num_moe_layers() == jc.num_moe_layers()
    from luminaai_tpu.config import ConfigPresets as JPresets
    from luminaai_tpu_torch.config import ConfigPresets as TPresets

    for name in TPresets.available():
        jp, tp = JPresets.get(name), TPresets.get(name)
        for f in fields + ("use_moe",):
            assert getattr(tp, f) == getattr(jp, f), (name, f)
    for bad in (dict(moe_top_k=9), dict(moe_pattern="odd"),
                dict(capacity_factor=0.0), dict(moe_dispatch="magic"),
                dict(expert_dropout_rate=0.7)):
        with pytest.raises(ValueError):
            TConfig(use_moe=True, **bad)
