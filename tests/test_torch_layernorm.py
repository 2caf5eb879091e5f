"""The port's LayerNorm (models/layers.py) against the JAX LayerNorm
(luminaai_tpu/models/layers.py:49): fp32 mean and variance, an fp32 scale
and optional bias, output in the compute dtype. No JAX model uses it, so
it is held as a module: the same seeded scale, bias and input through
both, its flax tree converted by convert.layernorm_from_flax and back.
Tolerances: fp32 output within 1e-6 of max|y|; bf16 output within one
bf16 step (2^-8 relative) of JAX's, both rounding the same fp32 value.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from luminaai_tpu.models.layers import LayerNorm as JLayerNorm
from luminaai_tpu_torch.convert import layernorm_from_flax, layernorm_to_flax
from luminaai_tpu_torch.models.layers import LayerNorm


@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(use_bias, dtype):
    rng = np.random.RandomState(0)
    H = 96
    x = (rng.randn(3, 7, H) * 3 + 1).astype(np.float32)
    jln = JLayerNorm(use_bias=use_bias, dtype=getattr(jnp, dtype))
    names = jln.init(jax.random.key(0), jnp.asarray(x))["params"]
    tree = {"params": {k: (rng.randn(H) * 0.5 + 1).astype(np.float32)
                       for k in names}}
    want = np.asarray(jln.apply(tree, jnp.asarray(x)).astype(jnp.float32))

    ln = LayerNorm(H, use_bias=use_bias, dtype=getattr(torch, dtype))
    ln.load_state_dict(layernorm_from_flax(tree["params"]))
    got = ln(torch.tensor(x)).float().numpy()
    scale = np.abs(want).max()
    tol = 1e-6 if dtype == "float32" else 2.0 ** -8
    assert np.abs(got - want).max() <= tol * scale
    back = layernorm_to_flax(ln)
    assert sorted(back) == sorted(tree["params"])
    for k, v in back.items():
        np.testing.assert_array_equal(v, tree["params"][k])
