"""convert.py's scanned trees and untied heads against the JAX package.

- Scanned trees (scan_layers=True, JAX scan_segments): a flax init of the
  scanned JAX model converts to the same state_dict as its unstacked form
  (JAX unstack_params_from_scan), bitwise; state_dict_to_flax(...,
  scanned=True) gives back the scanned tree bitwise; the port's
  scan_segments equals JAX's; and the port's logits on the scanned
  model's weights equal the scanned JAX model's (atol/rtol 1e-4). Dense,
  and a 5-layer hybrid (every_3rd MoE, MoD elsewhere: a periodic unit and
  a tail).
- Untied heads (tie_word_embeddings=False, JAX Embedder.lm_head): the
  logits of the no-cache forward within 1e-4, and the train step's fused
  LM-head CE loss (rtol 1e-5) and gradients, lm_head's included (each
  within 1e-6, norm rtol 1e-4), against JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from luminaai_tpu.config import Config as JConfig
from luminaai_tpu.models import transformer as jtr
from luminaai_tpu.parallel.train_step import make_loss_fn as jmake_loss
from luminaai_tpu_torch import convert
from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.models.transformer import LuminaTransformer
from luminaai_tpu_torch.ops.fused import global_norm
from luminaai_tpu_torch.parallel import train_step as ts

ARCH = dict(vocab_size=384, hidden_size=64, num_layers=4, num_heads=4,
            num_kv_heads=2, seq_length=64, intermediate_size=128,
            precision="fp32", gradient_checkpointing=False,
            use_flash_attention=False, routing_noise_std=0.0, batch_size=2)
LAYOUTS = {
    "dense": dict(use_moe=False),
    "hybrid": dict(num_layers=5, use_moe=True, num_experts=4, moe_top_k=2,
                   moe_pattern="every_3rd", use_mod=True),
}


def _unbox(tree):
    from flax import linen as nn

    return jax.tree.map(
        lambda x: x.unbox() if isinstance(x, nn.meta.AxisMetadata) else x,
        tree, is_leaf=lambda x: isinstance(x, nn.meta.AxisMetadata))


def _ids(seed=0, shape=(2, 64)):
    return np.random.RandomState(seed).randint(1, 384, shape).astype(
        np.int32)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_scanned_tree_converts_like_its_unscanned_form(layout):
    kw = dict(ARCH, **LAYOUTS[layout])
    jcfg = JConfig(**kw, scan_layers=True)
    jmodel = jtr.LuminaTransformer(jcfg)
    scanned = jax.device_get(_unbox(jmodel.init(
        jax.random.key(0), jnp.ones((1, 8), jnp.int32))["params"]))
    assert any(k.startswith("scan_") for k in scanned)
    unscanned = jax.device_get(jtr.unstack_params_from_scan(jcfg, scanned))
    cfg = Config(**kw)
    assert convert.scan_segments(cfg) == jtr.scan_segments(jcfg)
    a = convert.params_from_flax(scanned, cfg)
    b = convert.params_from_flax(unscanned, cfg)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k

    model = LuminaTransformer(cfg, device="cpu")
    model.load_params(a)
    back = convert.state_dict_to_flax(dict(model.state_dict()), cfg,
                                      scanned=True)
    want = convert.flatten_tree(scanned)
    assert back.keys() == want.keys()
    for k, v in want.items():
        assert np.array_equal(back[k].numpy(), v), k
    assert convert.flax_to_state_dict(back, cfg).keys() == a.keys()

    ids = _ids()
    jlogits, _ = jmodel.apply({"params": scanned}, jnp.asarray(ids))
    with torch.no_grad():
        logits, _ = model(torch.as_tensor(ids).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)


def test_untied_head_matches_jax():
    """An untied head, and the embedding without its sqrt(hidden) scale
    (use_stable_embedding=False)."""
    kw = dict(ARCH, use_moe=False, tie_word_embeddings=False,
              use_stable_embedding=False)
    jcfg = JConfig(**kw)
    jmodel = jtr.LuminaTransformer(jcfg)
    params = jax.device_get(_unbox(jmodel.init(
        jax.random.key(1), jnp.ones((1, 8), jnp.int32))["params"]))
    assert "lm_head" in params["embedder"]
    cfg = Config(**kw)
    assert cfg.estimate_parameters() == jcfg.estimate_parameters()
    ids = _ids(1)

    serving = LuminaTransformer(cfg, device="cpu")
    serving.load_params(convert.params_from_flax(params, cfg))
    jlogits, _ = jmodel.apply({"params": params}, jnp.asarray(ids))
    with torch.no_grad():
        logits, _ = serving(torch.as_tensor(ids).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    assert not torch.allclose(serving.embedder.head(),
                              serving.embedder.embedding)

    batch = {"input_ids": ids}
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        jmake_loss(jcfg, jmodel), has_aux=True))(
        params, {"input_ids": jnp.asarray(ids)}, jax.random.key(0))
    model = LuminaTransformer(cfg, device="cpu", trainable=True)
    model.load_params(convert.params_from_flax(params, cfg))
    names = [n for n, _ in model.named_parameters()]
    assert "embedder.lm_head" in names
    loss, _ = ts.make_loss_fn(cfg, model)(
        {"input_ids": torch.as_tensor(batch["input_ids"]).long()})
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    want = convert.params_from_flax(jax.device_get(j_grads), cfg)
    np.testing.assert_allclose(float(global_norm(list(grads))),
                               float(global_norm(list(want.values()))),
                               rtol=1e-4)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=1e-6,
                                   rtol=1e-4, err_msg=n)
    assert float(grads[names.index("embedder.lm_head")].abs().max()) > 0
