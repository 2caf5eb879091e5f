"""The port's LuminaTransformer against the flax LuminaTransformer.

Weights: a flax init of the JAX model, converted with
convert.params_from_flax. Both models run in fp32 on the CPU over the
per-lane cache paths the serving decoder uses: a chunked prefill into one
lane (rows at absolute positions, padding rows marked -1), a one-chunk
prefill into a second lane, then batched decode steps with the pool's
LaneMeta (lengths, identity page table, resident extent). Logits of live
rows and the caches must agree within atol 1e-4 / rtol 1e-4 (fp32 logits
of magnitude ~1 after two layers and a 384-wide vocab projection; sums run
in other orders on the two sides).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from luminaai_tpu.config import Config as JConfig
from luminaai_tpu.models.transformer import LuminaTransformer as JModel
from luminaai_tpu.ops.ragged_paged_attention import LaneMeta as JLaneMeta
from luminaai_tpu_torch.config import Config as TConfig
from luminaai_tpu_torch.convert import flatten_tree, init_params, params_from_flax
from luminaai_tpu_torch.models.transformer import LuminaTransformer as TModel
from luminaai_tpu_torch.ops.ragged_paged_attention import LaneMeta

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = dict(vocab_size=384, hidden_size=128, num_layers=2, num_heads=2,
            num_kv_heads=1, seq_length=64, intermediate_size=192,
            precision="fp32")
C, PS, CHUNK = 32, 8, 8


def _unbox(params):
    from flax import linen as nn

    return jax.tree.map(
        lambda x: x.unbox() if isinstance(x, nn.meta.AxisMetadata) else x,
        params, is_leaf=lambda x: isinstance(x, nn.meta.AxisMetadata),
    )


@pytest.fixture(scope="module")
def models():
    jcfg = JConfig(**ARCH, use_flash_attention=False,
                   gradient_checkpointing=False,
                   attention_backend="ragged_xla")
    jmodel = JModel(jcfg)
    params = _unbox(
        jmodel.init(jax.random.key(0), jnp.ones((1, 8), jnp.int32))["params"]
    )
    tmodel = TModel(TConfig(**ARCH), device="cpu")
    tmodel.load_params(params_from_flax(jax.device_get(params), tmodel.config))
    return jmodel, params, tmodel


def _jrun(jmodel, params, ids, positions, caches, cache_index, meta=None):
    logits, caches, _ = jmodel.apply(
        {"params": params}, jnp.asarray(ids), positions=jnp.asarray(positions),
        kv_caches=caches, cache_index=jnp.asarray(cache_index, jnp.int32),
        lane_meta=meta or JLaneMeta(lengths=None, backend="ragged_xla"),
    )
    return np.asarray(logits), caches


def _trun(tmodel, ids, positions, caches, cache_index, meta=None):
    logits, caches = tmodel(
        torch.as_tensor(ids), positions=torch.as_tensor(positions),
        kv_caches=caches, cache_index=torch.as_tensor(cache_index),
        lane_meta=meta,
    )
    return logits.numpy(), caches


def _assert_caches(tc, jc):
    for (tk, tv), (jk, jv) in zip(tc, jc):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_chunked_prefill_then_decode_matches_flax(models):
    jmodel, params, tmodel = models
    rng = np.random.RandomState(0)
    prompt_a = rng.randint(0, 384, size=13)  # two chunks: 8 + 5 live rows
    prompt_b = rng.randint(0, 384, size=5)   # one chunk

    def prefill(prompt):
        n = -(-len(prompt) // CHUNK)
        ids = np.zeros((1, n * CHUNK), np.int64)
        ids[0, : len(prompt)] = prompt
        jc = jmodel.init_cache(1, C, rolling=False)
        tc = tmodel.init_cache(1, C)
        last = None
        for c in range(n):
            start = c * CHUNK
            pos = start + np.arange(CHUNK)
            positions = np.where(pos < len(prompt), pos, -1)[None]
            chunk = ids[:, start:start + CHUNK]
            lj, jc = _jrun(jmodel, params, chunk, positions, jc, [start])
            lt, tc = _trun(tmodel, chunk, positions, tc, [start])
            live = positions[0] >= 0
            np.testing.assert_allclose(lt[0, live], lj[0, live], **TOL)
            last = lt[0, live][-1]
        _assert_caches(tc, jc)
        return jc, tc, last

    jca, tca, last_a = prefill(prompt_a)
    jcb, tcb, last_b = prefill(prompt_b)
    # Two-lane pool from the two prefilled lanes.
    jc = [(jnp.concatenate([a[0], b[0]]), jnp.concatenate([a[1], b[1]]))
          for a, b in zip(jca, jcb)]
    tc = [(torch.cat([a[0], b[0]]), torch.cat([a[1], b[1]]))
          for a, b in zip(tca, tcb)]
    tokens = np.asarray([last_a.argmax(), last_b.argmax()])
    pos = np.asarray([13, 5])
    table = np.tile(np.arange(C // PS, dtype=np.int32), (2, 1))
    for _ in range(3):
        lengths = (pos + 1).astype(np.int32)
        common = dict(page_size=PS, extent=2 * PS)
        jmeta = JLaneMeta(lengths=jnp.asarray(lengths),
                          page_table=jnp.asarray(table),
                          backend="ragged_xla", kind="decode", **common)
        tmeta = LaneMeta(lengths=torch.as_tensor(lengths),
                         page_table=torch.as_tensor(table),
                         backend="ragged", **common)
        lj, jc = _jrun(jmodel, params, tokens[:, None], pos[:, None], jc,
                       pos, jmeta)
        lt, tc = _trun(tmodel, tokens[:, None], pos[:, None], tc, pos, tmeta)
        np.testing.assert_allclose(lt, lj, **TOL)
        tokens = lt[:, -1].argmax(-1)
        pos = pos + 1
    _assert_caches(tc, jc)


def test_params_from_flax_round_trips_the_tree(models):
    """Flat '/'-keyed trees (the npz layout) convert like nested ones."""
    _, params, tmodel = models
    nested = params_from_flax(jax.device_get(params), tmodel.config)
    flat = params_from_flax(flatten_tree(jax.device_get(params)),
                            tmodel.config)
    assert nested.keys() == flat.keys() == tmodel.state_dict().keys()
    for k in nested:
        torch.testing.assert_close(nested[k], flat[k], atol=0, rtol=0)


def test_seeded_init_is_reproducible_with_jax_init_scales():
    cfg = TConfig(**ARCH)
    a = init_params(TModel(cfg, device="cpu"), seed=3)
    b = init_params(TModel(cfg, device="cpu"), seed=3)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, atol=0, rtol=0)
        if name.endswith("norm.scale"):
            assert bool((pa == 1).all())
    wqkv = a.layers[0].attention.wqkv
    wo = a.layers[0].attention.wo
    assert abs(wqkv.std().item() - 0.02) < 2e-3
    assert abs(wo.std().item() - 0.02 / 2 ** 0.5) < 2e-3


def test_moe_is_refused():
    """What the port still refuses where the model is built: dispatch
    modes it has not ported, and mixture of depths."""
    with pytest.raises(NotImplementedError, match="moe_dispatch='gather'"):
        TModel(TConfig(**ARCH, use_moe=True, moe_dispatch="gather"),
               device="cpu")
    with pytest.raises(NotImplementedError, match="use_mod"):
        TModel(TConfig(**ARCH, use_mod=True), device="cpu")


MOE_ARCH = dict(ARCH, use_moe=True, num_experts=4, moe_top_k=2,
                routing_noise_std=0.0)


@pytest.mark.parametrize("dispatch,pattern,layers", [
    ("gmm", "all", 2), ("sort", "every_3rd", 3), ("gmm", "every_3rd", 3)])
def test_moe_forward_matches_flax(dispatch, pattern, layers):
    """The no-cache forward of an MoE model (the training forward): logits,
    aux_loss (the layers' summed aux and z losses) and the router metrics
    averaged over MoE layers, as the JAX _reduce_metrics gives them."""
    kw = dict(MOE_ARCH, moe_dispatch=dispatch, moe_pattern=pattern,
              num_layers=layers)
    jcfg = JConfig(**kw, use_flash_attention=False,
                   gradient_checkpointing=False, scan_layers=False)
    jmodel = JModel(jcfg)
    ids = np.random.RandomState(6).randint(0, 384, size=(2, 40))
    params = _unbox(jax.jit(jmodel.init)(jax.random.key(1),
                                         jnp.asarray(ids))["params"])
    jlogits, jaux = jax.jit(lambda p, x: jmodel.apply({"params": p}, x))(
        params, jnp.asarray(ids))
    tcfg = TConfig(**kw)
    tmodel = TModel(tcfg, device="cpu")
    sd = params_from_flax(jax.device_get(params), tcfg)
    assert sd.keys() == tmodel.state_dict().keys()
    tmodel.load_params(sd)
    tlogits, taux = tmodel(torch.as_tensor(ids))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    assert sorted(taux) == sorted(jaux)
    for key in jaux:
        np.testing.assert_allclose(taux[key].numpy(), np.asarray(jaux[key]),
                                   err_msg=key, **TOL)
    assert [hasattr(b, "moe") for b in tmodel.layers] == [
        tcfg.is_moe_layer(i) for i in range(layers)]
