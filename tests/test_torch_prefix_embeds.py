"""The port's prefix_embeds (soft-prompt virtual tokens) against the JAX
model's (luminaai_tpu/models/transformer.py:255-336).

Both sides hold the same weights (one flax tree, made from the port's
seeded init with convert.state_dict_to_flax and loaded back with
convert.params_from_flax) in fp32 on the CPU, routing noise off: [B, P,
H] virtual tokens before the blocks, scaled by sqrt(H) under
use_stable_embedding, positions over all S + P rows, the prefix stripped
after the final norm. The logits of the real tokens, dense and with 8
experts (the prefix rows routed and counted in the aux loss like the
others), stable embedding on and off, within rtol 1e-5 (of the largest
logit); the aux loss too. The final-normed hidden rows equal the logits'
(the LM head sees only real tokens).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from luminaai_tpu.config import Config as JConfig
from luminaai_tpu.models.transformer import LuminaTransformer as JModel
from luminaai_tpu_torch.config import Config as TConfig
from luminaai_tpu_torch.convert import (
    init_params,
    params_from_flax,
    state_dict_to_flax,
)
from luminaai_tpu_torch.models.transformer import LuminaTransformer as TModel

ARCH = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, seq_length=64, intermediate_size=128,
            precision="fp32", routing_noise_std=0.0)
B, S, P = 2, 20, 6


def _nest(flat):
    """'/'-joined flax paths -> the nested tree flax's apply takes."""
    tree = {}
    for path, v in flat.items():
        *heads, leaf = path.split("/")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = jnp.asarray(v.numpy())
    return tree


@pytest.mark.parametrize("stable", [True, False], ids=["stable", "plain"])
@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe8"])
def test_prefix_embeds_logits_equal_jax(moe, stable):
    extra = dict(use_moe=moe, use_stable_embedding=stable)
    if moe:
        extra.update(num_experts=8, moe_top_k=2)
    jcfg = JConfig(**ARCH, **extra, use_flash_attention=False,
                   gradient_checkpointing=False)
    jmodel = JModel(jcfg)
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 256, (B, S)).astype(np.int32)
    prefix = rng.normal(0, 0.5, (B, P, ARCH["hidden_size"])).astype(
        np.float32)
    tcfg = TConfig(**ARCH, **extra)
    flat = state_dict_to_flax(
        init_params(TModel(tcfg, device="cpu"), 0).state_dict(), tcfg)
    params = _nest(flat)
    jlogits, jaux = jax.jit(lambda p, i, e: jmodel.apply(
        {"params": p}, i, prefix_embeds=e))(params, jnp.asarray(ids),
                                            jnp.asarray(prefix))
    want = np.asarray(jlogits)

    model = TModel(tcfg, device="cpu").load_params(
        params_from_flax(flat, tcfg))
    with torch.no_grad():
        logits, aux = model(torch.as_tensor(ids, dtype=torch.long),
                            prefix_embeds=torch.as_tensor(prefix))
        hidden, _ = model(torch.as_tensor(ids, dtype=torch.long),
                          prefix_embeds=torch.as_tensor(prefix),
                          return_hidden=True)
    assert logits.shape == want.shape == (B, S, ARCH["vocab_size"])
    np.testing.assert_allclose(logits.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(float(aux["aux_loss"]),
                               float(jaux.get("aux_loss", 0.0)), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(model.embedder.decode(hidden).numpy(),
                               logits.numpy(), rtol=1e-6, atol=1e-6)
    if moe:
        assert float(aux["aux_loss"]) > 0
