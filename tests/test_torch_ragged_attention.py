"""The port's ragged paged attention against the JAX package's.

The port's plain version (`ragged_paged_attention_ref`) is held, in fp32
on the CPU, against both JAX implementations on the same numpy inputs: the
Pallas decode kernel (interpret mode, as tests/test_ragged_attention.py
runs it) and the XLA reference. Only live lanes (length > 0) are compared:
a length-0 lane's output is garbage the caller discards (the JAX kernel
writes zeros there, the references average V).

Tolerance: atol 2e-5 / rtol 2e-5 in fp32. Both sides compute the same
einsum + masked softmax; the sums run in different orders, which moves
fp32 results by a few ulps of |out| <= max|v| ~ 4.

The kernel itself runs only on the card (tests/test_torch_cuda.py, marked
`cuda`); chip_smoke.py holds it against the plain version at the serving
slice's shapes.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from luminaai_tpu.ops import ragged_paged_attention as jrpa
from luminaai_tpu_torch.ops import ragged_paged_attention as trpa

ATOL = RTOL = 2e-5


def _inputs(seed, B, T, C, Hq, Hkv, D, Sq=1):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Sq, Hq, D).astype(np.float32)
    k = rng.randn(T, C, Hkv, D).astype(np.float32)
    v = rng.randn(T, C, Hkv, D).astype(np.float32)
    return rng, q, k, v


def _metas(lengths, **kw):
    """The same LaneMeta on both sides (numpy arrays in, each side's
    tensors out)."""
    arrays = {"lengths": lengths}
    if kw.get("page_table") is not None:
        arrays["page_table"] = kw.pop("page_table")
    jm = jrpa.LaneMeta(
        **{k: jnp.asarray(a, jnp.int32) for k, a in arrays.items()}, **kw
    )
    tm = trpa.LaneMeta(
        **{k: torch.as_tensor(a, dtype=torch.int32) for k, a in arrays.items()},
        **kw,
    )
    return jm, tm


def _live(x, lengths):
    return np.asarray(x)[np.asarray(lengths) > 0]


@pytest.mark.parametrize(
    "B,P,ps,Hq,Hkv,D,window",
    [
        (3, 4, 8, 2, 1, 64, None),
        (3, 4, 8, 2, 2, 128, 20),
        (4, 4, 32, 8, 2, 64, 40),
    ],
)
def test_plain_matches_jax_kernel_and_reference(B, P, ps, Hq, Hkv, D, window):
    C = P * ps
    rng, q, k, v = _inputs(B * 10 + P, B, B, C, Hq, Hkv, D)
    lengths = rng.randint(1, C + 1, size=(B,))
    lengths[0] = 0 if B > 2 else lengths[0]  # a free lane rides along
    lengths[-1] = C  # a full lane
    jm, tm = _metas(lengths, window=window, page_size=ps)

    got = trpa.ragged_paged_attention_ref(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), tm
    ).numpy()
    assert np.isfinite(got).all()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    ref = jrpa.ragged_paged_attention_xla(jq, jk, jv, jm)
    kern = jrpa.ragged_paged_attention(jq, jk, jv, jm)
    np.testing.assert_allclose(
        _live(got, lengths), _live(ref, lengths), atol=ATOL, rtol=RTOL
    )
    np.testing.assert_allclose(
        _live(got, lengths), _live(kern, lengths), atol=ATOL, rtol=RTOL
    )


@pytest.mark.parametrize("window", [None, 24])
def test_global_pages_match_jax(window):
    """Global (slot, page) ids: lanes read pages that live in other slots,
    including arena slots past the lanes, through an extent-sliced
    table."""
    B, T, P, ps, Hq, Hkv, D = 3, 5, 4, 8, 4, 2, 64
    C = P * ps
    rng, q, k, v = _inputs(7, B, T, C, Hq, Hkv, D)
    table = np.stack(
        [rng.permutation(T * P)[:P] for _ in range(B)]
    ).astype(np.int32)
    lengths = np.asarray([C - 3, 9, 17])
    extent = 3 * ps  # every length fits the first 3 logical pages
    jm, tm = _metas(
        lengths, page_table=table, window=window, page_size=ps,
        extent=extent, identity_pages=False, global_pages=True,
    )
    got = trpa.ragged_paged_attention_ref(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), tm
    ).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    ref = jrpa.ragged_paged_attention_xla(jq, jk, jv, jm)
    kern = jrpa.ragged_paged_attention(jq, jk, jv, jm)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, np.asarray(kern), atol=ATOL, rtol=RTOL)


def test_local_permuted_table_matches_jax():
    B, P, ps, Hq, Hkv, D = 2, 4, 8, 2, 1, 64
    C = P * ps
    rng, q, k, v = _inputs(1, B, B, C, Hq, Hkv, D)
    table = np.stack([rng.permutation(P) for _ in range(B)]).astype(np.int32)
    lengths = np.asarray([C, C - 5])
    jm, tm = _metas(
        lengths, page_table=table, page_size=ps, identity_pages=False
    )
    got = trpa.ragged_paged_attention_ref(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), tm
    ).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    np.testing.assert_allclose(
        got, np.asarray(jrpa.ragged_paged_attention_xla(jq, jk, jv, jm)),
        atol=ATOL, rtol=RTOL,
    )
    np.testing.assert_allclose(
        got, np.asarray(jrpa.ragged_paged_attention(jq, jk, jv, jm)),
        atol=ATOL, rtol=RTOL,
    )


def test_prefill_positions_match_jax():
    """Multi-row chunk: -1-marked padding rows attend nothing; live rows
    match the XLA reference (the only JAX path for Sq > 1)."""
    B, C, Hq, Hkv, D, Sq = 2, 64, 4, 2, 32, 8
    _, q, k, v = _inputs(2, B, B, C, Hq, Hkv, D, Sq=Sq)
    start, L = 16, 21  # final chunk: 5 live rows, 3 padding
    pos = start + np.arange(Sq)
    positions = np.where(pos < L, pos, -1)[None].repeat(B, 0).astype(np.int32)
    jm, tm = _metas(np.full((B,), L), page_size=8)
    jm = jm.replace(kind="prefill")
    got = trpa.ragged_paged_attention_ref(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), tm,
        positions=torch.as_tensor(positions, dtype=torch.int64),
    ).numpy()
    ref = jrpa.ragged_paged_attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm,
        positions=jnp.asarray(positions),
    )
    live = L - start
    np.testing.assert_allclose(
        got[:, :live], np.asarray(ref)[:, :live], atol=ATOL, rtol=RTOL
    )
    assert np.isfinite(got).all()


def test_cpu_wrapper_runs_plain_version_and_counts_no_launch():
    """On a CPU tensor the kernel wrapper is the plain version over the
    resident extent, and it counts no launch (nothing ran on a card)."""
    B, P, ps, Hq, Hkv, D = 3, 4, 8, 4, 1, 64
    C = P * ps
    rng, q, k, v = _inputs(3, B, B, C, Hq, Hkv, D)
    lengths = np.asarray([5, 0, 16])
    _, tm = _metas(lengths, page_size=ps, extent=2 * ps,
                   page_table=np.tile(np.arange(P, dtype=np.int32), (B, 1)))
    before = trpa.ragged_paged_attention.launches
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    out = trpa.ragged_paged_attention(tq, tk, tv, tm)
    assert trpa.ragged_paged_attention.launches == before
    want = trpa.ragged_paged_attention_ref(
        tq, tk[:, :2 * ps], tv[:, :2 * ps], tm
    )
    torch.testing.assert_close(out, want, atol=0, rtol=0)


def test_dispatcher_gating():
    """'ragged' takes the kernel wrapper for eligible decode shapes and the
    plain version for prefill chunks; 'plain' always the plain version;
    anything else raises."""
    assert trpa.ragged_eligible(8, 64, 1)
    assert not trpa.ragged_eligible(8, 64, 4)
    assert not trpa.ragged_eligible(12, 64, 1)
    assert not trpa.ragged_eligible(8, 48, 1)
    _, q, k, v = _inputs(4, 2, 2, 32, 2, 1, 48)
    _, tm = _metas(np.asarray([9, 30]), page_size=8)
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    want = trpa.ragged_paged_attention_ref(tq, tk, tv, tm)
    for backend in ("ragged", "plain"):
        got = trpa.paged_attention(tq, tk, tv, tm, backend=backend)
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    with pytest.raises(ValueError):
        trpa.paged_attention(tq, tk, tv, tm, backend="dense")


def test_kernel_table_is_global_ids():
    lengths = torch.tensor([3, 0, 7], dtype=torch.int32)
    local = trpa.LaneMeta(
        lengths=lengths, page_table=torch.tensor([[1, 0], [0, 1], [1, 1]])
    )
    np.testing.assert_array_equal(
        local.kernel_table(2).numpy(), [[1, 0], [2, 3], [5, 5]]
    )
    ident = trpa.LaneMeta(lengths=lengths)
    np.testing.assert_array_equal(
        ident.kernel_table(2).numpy(), [[0, 1], [2, 3], [4, 5]]
    )
    glob = trpa.LaneMeta(
        lengths=lengths, page_table=torch.tensor([[9, 4], [2, 2], [0, 7]]),
        global_pages=True,
    )
    np.testing.assert_array_equal(
        glob.kernel_table(2).numpy(), [[9, 4], [2, 2], [0, 7]]
    )
    assert glob.kernel_table(2).dtype == torch.int32


def test_implied_page_size_matches_jax():
    for rows in (512, 192, 48, 20, 8, 2048):
        assert trpa.implied_page_size(rows) == jrpa.implied_page_size(rows)
