"""Windowed flash attention and the no-cache GQAttention against the JAX package.

- Sliding windows 64, 128 and 200 at S = 512 (sub-block, exact-block and
  straddling bands against 128-row blocks; the geometry of
  tests/test_ops.py test_sliding_window_fwd_and_bwd): O, lse and dq/dk/dv
  under a nonzero lse cotangent, as in test_torch_flash_attention.py
  (atol 1e-5 forward, 5e-4 gradients, fp32).
- The attention layer's no-cache (training) forward, flash path and plain
  path, against the flax GQAttention on the same weights, windowed: the
  output and the gradient with respect to its input, atol 1e-5 / 5e-4
  (fp32; the projections add sums in other orders on the two sides).
- The gate's refusals, as the JAX function's.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from luminaai_tpu.config import Config as JConfig
from luminaai_tpu.models import layers as jl
from luminaai_tpu_torch.config import Config as TConfig
from luminaai_tpu_torch.models import layers as tl
from luminaai_tpu_torch.ops import flash_attention as tfa
from test_torch_flash_attention import compare_with_jax


@pytest.mark.parametrize("window", [64, 128, 200])
def test_windowed_flash_matches_jax(window):
    compare_with_jax(1, 512, 2, 1, 128, window=window, seed=window)


def test_window_changes_result():
    rng = np.random.RandomState(6)
    q, k, v = (torch.as_tensor(rng.randn(1, 256, 2, 64).astype(np.float32))
               for _ in range(3))
    full = tfa.flash_attention(q, k, v, block_q=128, block_kv=128)
    win = tfa.flash_attention(q, k, v, block_q=128, block_kv=128, window=32)
    assert (full - win).abs().max().item() > 1e-3


def test_gate_refusals_match_jax():
    x = torch.zeros(1, 100, 2, 64)
    assert not tfa.flash_eligible(100, 64, 1024, 1024)
    with pytest.raises(ValueError, match="no usable flash block"):
        tfa.flash_attention(x, x, x)
    y = torch.zeros(1, 128, 2, 64)
    with pytest.raises(ValueError, match="requires causal"):
        tfa.flash_attention(y, y, y, causal=False, window=16)
    with pytest.raises(ValueError, match="positive"):
        tfa.flash_attention(y, y, y, window=0)


ARCH = dict(vocab_size=384, hidden_size=256, num_layers=1, num_heads=4,
            num_kv_heads=2, seq_length=256, intermediate_size=384,
            precision="fp32", attention_window=100)


def _unbox(params):
    from flax import linen as nn

    return jax.tree.map(
        lambda x: x.unbox() if isinstance(x, nn.meta.AxisMetadata) else x,
        params, is_leaf=lambda x: isinstance(x, nn.meta.AxisMetadata),
    )


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "plain"])
def test_attention_no_cache_forward_matches_flax(flash):
    jcfg = JConfig(**ARCH, use_flash_attention=flash, flash_block_q=128,
                   flash_block_kv=128)
    tcfg = TConfig(**ARCH, use_flash_attention=flash, flash_block_q=128,
                   flash_block_kv=128)
    H, S = ARCH["hidden_size"], ARCH["seq_length"]
    rng = np.random.RandomState(11)
    x = rng.randn(2, S, H).astype(np.float32)
    g = rng.randn(2, S, H).astype(np.float32)
    jlayer = jl.GQAttention(jcfg, dtype=jnp.float32)
    params = _unbox(jlayer.init(jax.random.key(1), jnp.asarray(x))["params"])
    out_j, vjp = jax.vjp(
        lambda x: jlayer.apply({"params": params}, x)[0], jnp.asarray(x))
    (gx_j,) = vjp(jnp.asarray(g))

    layer = tl.GQAttention(tcfg, dtype=torch.float32, device="cpu",
                           trainable=True)
    p = jax.tree.map(np.array, jax.device_get(params))
    with torch.no_grad():
        layer.wqkv.copy_(torch.as_tensor(np.concatenate(
            [p[n].reshape(H, -1) for n in ("wq", "wk", "wv")], axis=1)))
        layer.wo.copy_(torch.as_tensor(p["wo"].reshape(-1, H)))
    xt = torch.tensor(x, requires_grad=True)
    out_t, cache = layer(xt)
    assert cache is None
    (out_t * torch.as_tensor(g)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), atol=5e-4)
    assert layer.wqkv.grad is not None and layer.wo.grad is not None
