"""The 'gather' and 'einsum' MoE dispatch against the JAX MoELayer, on the
CPU in fp32.

As tests/test_torch_moe.py for 'sort' and 'gmm': the same weights (a
flax init of the JAX layer) and input (numpy seed), routing noise and
expert dropout off; groups of 50 tokens at capacity factor 1.25 and of 64
at 0.5 (drops). Compared: the output, the router metrics, and the
gradients of x, router, wi and wo of sum(out * ct) + aux + z, within the
TOL of test_torch_moe.py (1e-4). 'gather' runs the JAX gather-only
backward's counterpart (DispatchGather); 'einsum' the greedy top-k routing
(`top_k_routing`, whose dispatch and combine tensors equal JAX
`_top_k_routing`'s). The port's four dispatches agree with each other on
the same layer.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

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
    # name: (dispatch, capacity factor, seq)
    "gather": ("gather", 1.25, 50),
    "gather_drops": ("gather", 0.5, 64),
    "einsum": ("einsum", 1.25, 50),
    "einsum_drops": ("einsum", 0.5, 64),
}


def _inputs(seq):
    rng = np.random.RandomState(4)
    return (rng.randn(2, seq, 64).astype(np.float32),
            rng.randn(2, seq, 64).astype(np.float32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_dispatch_matches_jax(case):
    dispatch, cf, seq = CASES[case]
    kw = dict(ARCH, moe_dispatch=dispatch, capacity_factor=cf)
    x, ct = _inputs(seq)
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


def test_top_k_routing_matches_jax():
    """Dispatch and combine tensors and drops of the greedy routing, under
    capacity pressure: dispatch and drops exactly, combine within 1e-6."""
    rng = np.random.RandomState(5)
    probs = rng.dirichlet(np.ones(8), size=(3, 40)).astype(np.float32)
    for cap in (1, 4, 16):
        jd, jc, jdrop = jax.jit(jmoe._top_k_routing, static_argnums=(1, 2))(
            jnp.asarray(probs), 2, cap)
        td, tc, tdrop = tmoe.top_k_routing(torch.as_tensor(probs), 2, cap)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
        np.testing.assert_array_equal(tdrop.numpy(), np.asarray(jdrop))


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_the_four_dispatches_agree(cf):
    """sort, gather, einsum and gmm (its plain version on the CPU) route
    the same pairs to the same capacity: the same outputs, metrics and
    gradients on one layer's weights."""
    x, ct = _inputs(64)
    params, *_ = _run_jax(JConfig(**dict(ARCH, capacity_factor=cf)), x, ct)
    runs = {d: _run_port(TConfig(**dict(ARCH, capacity_factor=cf,
                                        moe_dispatch=d)), params, x, ct)
            for d in ("sort", "gather", "einsum", "gmm")}
    out0, m0, g0 = runs["sort"]
    for d, (out, m, g) in runs.items():
        np.testing.assert_allclose(out, out0, err_msg=d, **TOL)
        for key in METRICS:
            np.testing.assert_allclose(m[key], m0[key], err_msg=f"{d} {key}",
                                       **TOL)
        for key in g0:
            np.testing.assert_allclose(g[key], g0[key], err_msg=f"{d} {key}",
                                       **TOL)


def test_gather_backward_is_a_row_gather():
    """DispatchGather's backward equals autograd's scatter-add adjoint of
    the same forward gather (the JAX custom VJP's claim)."""
    cfg = TConfig(**dict(ARCH, capacity_factor=0.5))
    rng = np.random.RandomState(6)
    probs = torch.softmax(torch.as_tensor(rng.randn(2, 32, 4)
                                          .astype(np.float32)), -1)
    C = tmoe.expert_capacity(cfg, 32)
    slot, _, _, _ = tmoe.sort_routing(probs, 2, C)
    G, S, k, E = 2, 32, 2, 4
    tok = torch.arange(S)[:, None].expand(S, k).reshape(-1)
    inv = torch.full((G, E * C + 1), S, dtype=torch.long)
    inv = inv.index_put((torch.arange(G)[:, None], slot.reshape(G, S * k)),
                        tok.expand(G, S * k))
    inv_egc = inv[:, : E * C].reshape(G, E, C).transpose(0, 1)
    x = torch.as_tensor(rng.randn(G, S, 8).astype(np.float32))
    g = torch.as_tensor(rng.randn(E, G, C, 8).astype(np.float32))
    xa = x.clone().requires_grad_()
    tmoe.DispatchGather.apply(xa, inv_egc, slot, C).backward(g)
    xb = x.clone().requires_grad_()
    filled = (inv_egc < S)[..., None].float()
    (xb[torch.arange(G)[None, :, None], inv_egc.clamp(max=S - 1)]
     * filled).backward(g)
    torch.testing.assert_close(xa.grad, xb.grad, atol=1e-6, rtol=1e-6)
