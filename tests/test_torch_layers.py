"""The port's layers against the flax layers they replace.

Same numpy inputs and the same weights (the flax init, handed over as
numpy) through luminaai_tpu/models/layers.py and
luminaai_tpu_torch/models/layers.py, in fp32 on the CPU. Tolerance: atol
1e-5 / rtol 1e-5 (fp32; matmul sums and cos/sin run in other orders and
implementations on the two sides). The bf16 embedder case is looser (see
there).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from luminaai_tpu.config import Config as JConfig
from luminaai_tpu.models import layers as jl
from luminaai_tpu.ops.ragged_paged_attention import LaneMeta as JLaneMeta
from luminaai_tpu_torch.config import Config as TConfig
from luminaai_tpu_torch.models import layers as tl
from luminaai_tpu_torch.ops.ragged_paged_attention import LaneMeta

TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = dict(vocab_size=384, hidden_size=128, num_layers=1, num_heads=4,
            num_kv_heads=2, seq_length=64, intermediate_size=192,
            precision="fp32")


def _np(tree):
    return jax.tree.map(np.array, jax.device_get(tree))


def _unbox(params):
    from flax import linen as nn

    return jax.tree.map(
        lambda x: x.unbox() if isinstance(x, nn.meta.AxisMetadata) else x,
        params, is_leaf=lambda x: isinstance(x, nn.meta.AxisMetadata),
    )


def test_rmsnorm_matches_flax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 128).astype(np.float32) * 3
    scale = rng.rand(128).astype(np.float32) + 0.5
    want = jl.RMSNorm(1e-6, dtype=jnp.float32).apply(
        {"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x)
    )
    norm = tl.RMSNorm(128, 1e-6, dtype=torch.float32, device="cpu")
    norm.scale.data.copy_(torch.as_tensor(scale))
    np.testing.assert_allclose(
        norm(torch.as_tensor(x)).numpy(), np.asarray(want), **TOL
    )


@pytest.mark.parametrize("rope_dtype", ["fp32", "bf16"])
def test_rope_matches_flax(rope_dtype):
    cos_j, sin_j = jl.rope_frequencies(64, 256)
    cos_t, sin_t = tl.rope_frequencies(64, 256)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=2e-6)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=2e-6)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 3, 64).astype(np.float32)
    positions = np.asarray([[0, 1, 2, 3, 4, 5], [200, 201, 7, 9, -1, -1]])
    live = positions >= 0
    jdt, tdt = (jnp.float32, torch.float32) if rope_dtype == "fp32" else (
        jnp.bfloat16, torch.bfloat16
    )
    want = jl.apply_rope(
        jnp.asarray(x, jdt), cos_j, sin_j, jnp.asarray(positions),
        compute_dtype=jdt,
    )
    got = tl.apply_rope(
        torch.as_tensor(x).to(tdt), cos_t, sin_t, torch.as_tensor(positions),
        compute_dtype=tdt,
    )
    # bf16: one bf16 ulp of |x| <= 4 where the two sides' cos/sin round
    # apart before the bf16 multiply.
    tol = TOL if rope_dtype == "fp32" else dict(atol=4e-2, rtol=1e-2)
    np.testing.assert_allclose(
        got.float().numpy()[live],
        np.asarray(want.astype(jnp.float32))[live], **tol,
    )


def test_swiglu_matches_flax():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 4, 128).astype(np.float32)
    mod = jl.SwiGLU(192, dtype=jnp.float32)
    params = _unbox(mod.init(jax.random.key(0), jnp.asarray(x))["params"])
    want = mod.apply({"params": params}, jnp.asarray(x))
    p = _np(params)
    ffn = tl.SwiGLU(128, 192, dtype=torch.float32, device="cpu")
    ffn.wi.data.copy_(torch.as_tensor(p["wi"]))
    ffn.wo.data.copy_(torch.as_tensor(p["wo"]))
    np.testing.assert_allclose(
        ffn(torch.as_tensor(x)).numpy(), np.asarray(want), **TOL
    )


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_embedder_matches_flax(dtype):
    """Stable-scaled lookup and the tied head with fp32 logits. bf16: the
    port rounds the table once and multiplies in fp32; the JAX head casts
    to bf16 with fp32 accumulation, so the logits agree to fp32 sum
    order (atol 1e-4 on |logits| ~ 1)."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (
        jnp.bfloat16, torch.bfloat16
    )
    jcfg = JConfig(**ARCH)
    mod = jl.Embedder(jcfg, dtype=jdt)
    tokens = np.asarray([[1, 7, 300, 383], [0, 2, 2, 5]])
    params = _unbox(
        mod.init(jax.random.key(3), jnp.asarray(tokens), method="encode")[
            "params"
        ]
    )
    x_j = mod.apply({"params": params}, jnp.asarray(tokens), method="encode")
    logits_j = mod.apply({"params": params}, x_j, method="decode")
    emb = tl.Embedder(TConfig(**ARCH), dtype=tdt, device="cpu")
    emb.embedding.data.copy_(torch.as_tensor(_np(params)["embedding"]))
    emb.round_()
    x_t = emb.encode(torch.as_tensor(tokens))
    np.testing.assert_array_equal(
        x_t.float().numpy(), np.asarray(x_j.astype(jnp.float32))
    )
    logits_t = emb.decode(x_t)
    assert logits_t.dtype == torch.float32
    tol = TOL if dtype == "fp32" else dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **tol)


@pytest.fixture(scope="module")
def attention():
    """A flax GQAttention (4 q heads over 2 kv heads, head_dim 32) and the
    port's GQAttention carrying its weights."""
    jcfg = JConfig(**ARCH, use_flash_attention=False,
                   gradient_checkpointing=False, attention_backend="ragged")
    jmod = jl.GQAttention(jcfg, dtype=jnp.float32)
    x0 = jnp.zeros((1, 4, 128), jnp.float32)
    params = _unbox(jmod.init(jax.random.key(4), x0)["params"])
    p = _np(params)
    H, d = 128, 32
    tmod = tl.GQAttention(TConfig(**ARCH), dtype=torch.float32, device="cpu")
    tmod.wqkv.data.copy_(torch.as_tensor(np.concatenate(
        [p["wq"].reshape(H, -1), p["wk"].reshape(H, -1),
         p["wv"].reshape(H, -1)], axis=1)))
    tmod.wo.data.copy_(torch.as_tensor(p["wo"].reshape(-1, H)))
    return jmod, params, tmod


def test_attention_per_lane_writes_and_decode_match_flax(attention):
    """Per-lane multi-row write (padding rows marked -1 land nowhere),
    then one per-lane decode row, through the derived-LaneMeta dispatch;
    caches and live outputs match."""
    jmod, params, tmod = attention
    rng = np.random.RandomState(5)
    B, S, C = 2, 8, 32
    x = rng.randn(B, S, 128).astype(np.float32)
    positions = np.asarray([list(range(8)), [0, 1, 2, 3, 4, -1, -1, -1]])
    zeros = np.zeros((B, C, 2, 32), np.float32)
    hint = JLaneMeta(lengths=None, backend="ragged_xla")

    y_j, (ck_j, cv_j) = jmod.apply(
        {"params": params}, jnp.asarray(x), positions=jnp.asarray(positions),
        kv_cache=(jnp.asarray(zeros), jnp.asarray(zeros)),
        cache_index=jnp.zeros((B,), jnp.int32), lane_meta=hint,
    )
    ck_t, cv_t = torch.zeros(zeros.shape), torch.zeros(zeros.shape)
    y_t, _ = tmod(
        torch.as_tensor(x), positions=torch.as_tensor(positions),
        kv_cache=(ck_t, cv_t), cache_index=torch.zeros(B, dtype=torch.int64),
    )
    live = positions >= 0
    np.testing.assert_allclose(y_t.numpy()[live], np.asarray(y_j)[live], **TOL)
    np.testing.assert_allclose(ck_t.numpy(), np.asarray(ck_j), **TOL)
    np.testing.assert_allclose(cv_t.numpy(), np.asarray(cv_j), **TOL)
    assert not ck_t[1, 5:].any()  # padding rows were never written

    # One decode row per lane at its own offset.
    xd = rng.randn(B, 1, 128).astype(np.float32)
    idx = np.asarray([8, 5])
    yd_j, (ck_j, _) = jmod.apply(
        {"params": params}, jnp.asarray(xd),
        positions=jnp.asarray(idx[:, None]), kv_cache=(ck_j, cv_j),
        cache_index=jnp.asarray(idx, jnp.int32), lane_meta=hint,
    )
    yd_t, _ = tmod(
        torch.as_tensor(xd), positions=torch.as_tensor(idx[:, None]),
        kv_cache=(ck_t, cv_t), cache_index=torch.as_tensor(idx),
    )
    np.testing.assert_allclose(yd_t.numpy(), np.asarray(yd_j), **TOL)
    np.testing.assert_allclose(ck_t.numpy(), np.asarray(ck_j), **TOL)


def test_attention_pool_lane_meta_matches_flax(attention):
    """The decode step's LaneMeta (pool page table, resident extent,
    window, a length-0 lane) gives the flax layer's outputs on live
    lanes."""
    jmod, params, tmod = attention
    rng = np.random.RandomState(6)
    B, C, ps = 3, 32, 8
    ck = rng.randn(B, C, 2, 32).astype(np.float32)
    cv = rng.randn(B, C, 2, 32).astype(np.float32)
    x = rng.randn(B, 1, 128).astype(np.float32)
    pos = np.asarray([3, 0, 12])
    active = np.asarray([True, False, True])
    lengths = np.where(active, pos + 1, 0).astype(np.int32)
    table = np.tile(np.arange(C // ps, dtype=np.int32), (B, 1))
    common = dict(window=6, page_size=ps, extent=2 * ps)
    jmeta = JLaneMeta(lengths=jnp.asarray(lengths),
                      page_table=jnp.asarray(table), backend="ragged",
                      kind="decode", **common)
    tmeta = LaneMeta(lengths=torch.as_tensor(lengths),
                     page_table=torch.as_tensor(table), backend="ragged",
                     **common)
    y_j, _ = jmod.apply(
        {"params": params}, jnp.asarray(x),
        positions=jnp.asarray(pos[:, None]),
        kv_cache=(jnp.asarray(ck), jnp.asarray(cv)),
        cache_index=jnp.asarray(pos, jnp.int32), lane_meta=jmeta,
    )
    y_t, _ = tmod(
        torch.as_tensor(x), positions=torch.as_tensor(pos[:, None]),
        kv_cache=(torch.as_tensor(ck), torch.as_tensor(cv)),
        cache_index=torch.as_tensor(pos), lane_meta=tmeta,
    )
    np.testing.assert_allclose(
        y_t.numpy()[active], np.asarray(y_j)[active], **TOL
    )


def test_decode_write_past_the_last_row_is_clamped(attention):
    """A finished lane can sit one row past its slot; XLA would drop that
    write, torch would fault, so the port lands it on the lane's own last
    row and leaves every other lane's rows alone."""
    _, _, tmod = attention
    B, C = 2, 16
    ck, cv = torch.zeros(B, C, 2, 32), torch.zeros(B, C, 2, 32)
    x = torch.randn(B, 1, 128, generator=torch.Generator().manual_seed(0))
    idx = torch.tensor([C, 3])
    tmod(x, positions=idx[:, None], kv_cache=(ck, cv), cache_index=idx,
         lane_meta=LaneMeta(lengths=torch.tensor([0, 4], dtype=torch.int32),
                            page_size=8))
    assert ck[0, C - 1].any() and not ck[0, : C - 1].any()
    assert ck[1, 3].any() and not ck[1, 4:].any() and not ck[1, :3].any()
