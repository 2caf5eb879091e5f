"""The split-KV decode kernel's algebra, held on the CPU against JAX.

csrc/ragged_paged_attention.cu splits each lane's band [start, length)
(start = length - window, clipped at 0) into tiles of R rows and gives
block `rank` of a cluster of n the tiles [T * rank / n, T * (rank + 1) /
n); each block keeps an online-softmax state (max m, sum l, unnormalised
output o) over its share, an empty share keeping (-inf, 0, 0), and the
states merge as out = sum_j 2^(m_j - M) o_j / sum_j 2^(m_j - M) l_j with
M = max_j m_j (base 2: the kernel scales the scores by log2(e)). The
kernel runs only on the card (tests/test_torch_cuda.py); here the same
shares and merge, written in fp32 torch over the port's plain version's
inputs, are held against the JAX package's `ragged_paged_attention_xla`
on the same numpy inputs, for shares that are empty, partial or whole.

Tolerance: atol 2e-5 / rtol 2e-5 in fp32, as tests/
test_torch_ragged_attention.py: the sums run in other orders, a few ulps
of |out| <= max|v| ~ 4.
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from luminaai_tpu.ops import ragged_paged_attention as jrpa
from luminaai_tpu_torch.ops import ragged_paged_attention as trpa

ATOL = RTOL = 2e-5
NEG_INF = -1e30


def _shares(length: int, window, n: int, rows: int):
    """[(first, end)) row ranges of the n blocks' shares of a lane's band."""
    start = max(length - window, 0) if window else 0
    tiles = -(-(length - start) // rows)
    out = []
    for rank in range(n):
        t0, t1 = tiles * rank // n, tiles * (rank + 1) // n
        out.append((start + t0 * rows, min(start + t1 * rows, length)))
    return out


def _state(q, k, v, first, end, scale):
    """(m, l, o) in base 2 of one share: q [Hq, D]; k/v [C, Hkv, D]."""
    hq, d = q.shape
    hkv = k.shape[1]
    if end <= first:
        return (torch.full((hq,), NEG_INF), torch.zeros(hq),
                torch.zeros(hq, d))
    kk = k[first:end].repeat_interleave(hq // hkv, dim=1)  # [rows, Hq, D]
    vv = v[first:end].repeat_interleave(hq // hkv, dim=1)
    s = torch.einsum("hd,rhd->hr", q, kk) * scale * math.log2(math.e)
    m = s.max(dim=1).values
    p = torch.exp2(s - m[:, None])
    return m, p.sum(dim=1), torch.einsum("hr,rhd->hd", p, vv)


def split_merge(q, k, v, lengths, window, n, rows):
    """The kernel's split and merge over flat per-lane k/v [B, C, Hkv, D];
    q [B, 1, Hq, D]. Returns [B, 1, Hq, D]."""
    B, _, hq, d = q.shape
    scale = 1.0 / math.sqrt(d)
    out = torch.zeros(B, 1, hq, d)
    for b in range(B):
        states = [_state(q[b, 0], k[b], v[b], first, end, scale)
                  for first, end in _shares(int(lengths[b]), window, n, rows)]
        m = torch.stack([s[0] for s in states])  # [n, Hq]
        big_m = m.max(dim=0).values
        w = torch.exp2(m - big_m)
        total = (w * torch.stack([s[1] for s in states])).sum(dim=0)
        safe = torch.where(total == 0, torch.ones_like(total), total)
        acc = (w[:, :, None] * torch.stack([s[2] for s in states])).sum(dim=0)
        out[b, 0] = acc / safe[:, None]
    return out


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("rows", [16, 64])
@pytest.mark.parametrize("window", [None, 37])
def test_split_merge_matches_jax(n, rows, window):
    """Lengths around tiles and shares (1, 63, 64, 65, 255, 256), a full
    slot, and a free lane: the free lane's states are all empty and merge
    to zeros, as the kernel writes."""
    B, P, ps, hq, hkv, d = 8, 4, 64, 4, 2, 64
    C = P * ps
    rng = np.random.RandomState(100 + n + rows)
    q = rng.randn(B, 1, hq, d).astype(np.float32)
    k = rng.randn(B, C, hkv, d).astype(np.float32)
    v = rng.randn(B, C, hkv, d).astype(np.float32)
    lengths = np.asarray([1, 63, 64, 65, 255, 256, 0, C])
    got = split_merge(*(torch.as_tensor(a) for a in (q, k, v)), lengths,
                      window, n, rows).numpy()
    jm = jrpa.LaneMeta(lengths=jnp.asarray(lengths, jnp.int32),
                       window=window, page_size=ps)
    want = np.asarray(jrpa.ragged_paged_attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm))
    live = lengths > 0
    np.testing.assert_allclose(got[live], want[live], atol=ATOL, rtol=RTOL)
    assert not got[~live].any()
    # The port's plain version agrees too (the oracle the kernel meets on
    # the card).
    tm = trpa.LaneMeta(lengths=torch.as_tensor(lengths, dtype=torch.int32),
                       window=window, page_size=ps)
    plain = trpa.ragged_paged_attention_ref(
        *(torch.as_tensor(a) for a in (q, k, v)), tm).numpy()
    np.testing.assert_allclose(got[live], plain[live], atol=ATOL, rtol=RTOL)


def test_shares_partition_the_band():
    """Every row of the band in exactly one share, in order; blocks past
    the tiles get empty shares; a window's first row inside a share."""
    for length, window, n, rows in [(2048, None, 8, 64), (1, None, 8, 64),
                                    (257, None, 8, 64), (700, 333, 8, 64),
                                    (0, None, 3, 16), (65, 64, 8, 16)]:
        shares = _shares(length, window, n, rows)
        start = max(length - window, 0) if window else 0
        covered = [r for first, end in shares for r in range(first, end)]
        assert covered == list(range(start, length))
        assert len(shares) == n
        tiles = -(-(length - start) // rows)
        assert sum(end > first for first, end in shares) == min(n, tiles)
