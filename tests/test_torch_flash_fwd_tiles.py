"""The wgmma forward kernel's tiling and algebra, held on the CPU against JAX.

csrc/flash_attention.cu's flash_fwd_wgmma_kernel (B1) runs only on the card
(tests/test_torch_flash_cuda.py), at every group and head_dim 64-256. Here
what it computes, block by block and tile by tile, is written in fp32 torch
and held against the JAX package's flash attention forward (Pallas in
interpret mode, as tests/test_ops.py runs it) on the same numpy inputs:

- a block's rows: 128 (q head, position) rows, 192 at head_dim 64,
  position-major (row r is head h0 + r % HB at position q0 + r / HB, HB =
  min(G, rows), P = rows // HB positions a block, ceil(G / HB) head
  chunks); a group that does not tile the rows (3, 5, 10, 12, ...) leaves
  rows past HB P as padding, and a partial last chunk's heads past the
  group too: zero rows of Q, position Sq, never stored (every (head,
  position) is stored exactly once);
- K/V tiles of 128 rows (64 above head_dim 128) from the window's band
  (aligned down) to the diagonal, partial tiles zero past Skv and masked;
- the online softmax in base 2: rows keep the raw max m, p = 2^(s c - m
  c) with c = scale log2 e (0 for a row with no key of its band yet),
  the row sum l summed over the tiles, O = acc / l (0 where l is 0), lse =
  (m c + log2 l) ln 2;
- the interior test: a tile it calls interior needs no mask (checked
  element by element), so the kernel skips the masks there.

Tolerance: atol 1e-5 (FWD_TOL, tests/test_torch_flash_attention.py's): fp32
throughout, the sums and the exponentials (2^x here, e^x in JAX) in other
orders and forms.
"""

import functools
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from luminaai_tpu.ops import flash_attention as jfa
from luminaai_tpu_torch.ops import flash_attention as tfa

FWD_TOL = 1e-5
LOG2E = math.log2(math.e)
NEG_INF = -1e30


def rows_of(d):
    """(q head, position) rows of a block: 64 x 3 consumer warpgroups at
    head_dim 64, 64 x 2 above."""
    return 192 if d <= 64 else 128


def tk(d):
    """K/V rows per tile."""
    return 128 if d <= 128 else 64


GEOMETRIES = {
    # name: (B, S, Hq, Hkv, D, causal, window). Groups that do not tile
    # the rows (padding rows, Sq no multiple of P): 3, 5, 10 and 12 at
    # head_dim 128 (b14's 5, b100's 10, b200's 12), 3 and 5 at 192 and
    # 256, 5 at 64 (of 192 rows); causal, windowed and not causal.
    "causal_g3_d128_s200": (1, 200, 3, 1, 128, True, None),
    "win60_g5_d128_s256": (1, 256, 5, 1, 128, True, 60),
    "noncausal_g10_d128_s150": (1, 150, 10, 1, 128, False, None),
    "causal_g12_d128_s256": (1, 256, 12, 1, 128, True, None),
    "causal_g3_d192_s256": (1, 256, 6, 2, 192, True, None),
    "win50_g5_d192_s180": (1, 180, 5, 1, 192, True, 50),
    "noncausal_g3_d256_s128": (1, 128, 3, 1, 256, False, None),
    "causal_g5_d256_s230": (2, 230, 5, 1, 256, True, None),
    "win40_g5_d64_s300": (1, 300, 10, 2, 64, True, 40),
    # A group above the rows that they do not divide: two head chunks,
    # the second one's heads past the group padding.
    "causal_g130_d128_s128": (1, 128, 130, 1, 128, True, None),
}


def _in_band(q, k, causal, window):
    """[len(q), len(k)] keep-mask of query positions q against keys k."""
    keep = torch.ones(len(q), len(k), dtype=torch.bool)
    if causal:
        keep = q[:, None] >= k[None, :]
        if window:
            keep &= q[:, None] - k[None, :] < window
    return keep


def _kv_range(qlo, qhi, skv, causal, window, tile):
    end = min(skv, qhi + 1) if causal else skv
    begin = max(0, qlo - window + 1) if causal and window else 0
    return begin // tile * tile, end


def row_map(g, hk, chunk, q0, sq, rows):
    """A block's rows: (position, head) per row, position sq for a padding
    row (past HB P, or a head past the group in a partial last chunk), as
    the kernel assigns them."""
    hb = min(g, rows)
    r = torch.arange(rows)
    head = hk * g + chunk * hb + r % hb
    pad = (r >= hb * (rows // hb)) | (head >= (hk + 1) * g)
    pos = torch.where(pad, sq, q0 + r // hb)
    return pos, head


def blocks(g, sq, rows):
    """The grid over one kv head: (head chunk, q0) for every block."""
    hb = min(g, rows)
    per = rows // hb
    return [(chunk, q0) for chunk in range(-(-g // hb))
            for q0 in range(0, sq, per)]


def fwd_tiles(q, k, v, scale, causal, window, counts):
    """B1's blocks and tiles: (O [B, Sq, Hq, D], lse [B, Hq, Sq]) fp32."""
    B, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    rows, TK = rows_of(d), tk(d)
    per = rows // min(g, rows)
    c = scale * LOG2E
    o = torch.zeros(B, sq, hq, d)
    lse = torch.zeros(B, hq, sq)
    stored = torch.zeros(B, sq, hq, dtype=torch.int64)
    for b in range(B):
        for hk in range(hkv):
            for chunk, q0 in blocks(g, sq, rows):
                pos, head = row_map(g, hk, chunk, q0, sq, rows)
                ok = pos < sq
                qr = torch.where(ok[:, None], q[b, pos.clamp(max=sq - 1),
                                                head.clamp(max=hq - 1)], 0.0)
                qhi = min(q0 + per, sq) - 1
                begin, end = _kv_range(q0, qhi, skv, causal, window, TK)
                m = torch.full((rows,), NEG_INF)
                l = torch.zeros(rows)
                acc = torch.zeros(rows, d)
                for kv0 in range(begin, end, TK):
                    kp = torch.arange(kv0, kv0 + TK)
                    kt, vt = torch.zeros(TK, d), torch.zeros(TK, d)
                    n = min(TK, skv - kv0)
                    kt[:n], vt[:n] = k[b, kv0:kv0 + n, hk], v[b, kv0:kv0 + n, hk]
                    s = qr @ kt.T
                    keep = _in_band(pos, kp, causal, window) & (kp < skv)
                    interior = kv0 + TK <= skv and (not causal or (
                        kv0 + TK - 1 <= q0
                        and (not window or qhi - kv0 < window)))
                    if interior:
                        counts["interior"] += 1
                        assert keep[ok].all()
                    else:
                        s = torch.where(keep, s, NEG_INF)
                    m_new = torch.maximum(m, s.max(dim=1).values)
                    alpha = torch.exp2((m - m_new) * c)
                    mc = torch.where(m_new == NEG_INF, 0.0, m_new * c)
                    p = torch.exp2(s * c - mc[:, None])
                    l = l * alpha + p.sum(dim=1)
                    acc = acc * alpha[:, None] + p @ vt
                    m = m_new
                safe = torch.where(l == 0, 1.0, l)
                o[b, pos[ok], head[ok]] = (acc / safe[:, None])[ok]
                lse[b, head[ok], pos[ok]] = ((m * c + torch.log2(safe))
                                             * math.log(2))[ok]
                stored[b, pos[ok], head[ok]] += 1
    counts["stored"] = stored
    return o, lse


@functools.lru_cache(maxsize=None)
def _reference(name):
    """Inputs and the JAX forward's (O, lse)."""
    B, S, hq, hkv, d, causal, window = GEOMETRIES[name]
    rng = np.random.RandomState(300 + sorted(GEOMETRIES).index(name))
    q, k, v = (rng.randn(*shape).astype(np.float32) for shape in (
        (B, S, hq, d), (B, S, hkv, d), (B, S, hkv, d)))
    # One block of the whole sequence (block 512 fits S <= 512): the
    # interpreted grid is B x Hq steps.
    o, lse = jfa.flash_attention_with_lse(
        *map(jnp.asarray, (q, k, v)), causal=causal, block_q=512,
        block_kv=512, window=window)
    return (q, k, v), (np.asarray(o), np.asarray(lse))


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_fwd_tiles_match_jax(name):
    (q, k, v), (o_j, lse_j) = _reference(name)
    d = q.shape[-1]
    causal, window = GEOMETRIES[name][5], GEOMETRIES[name][6] or 0
    q, k, v = map(torch.as_tensor, (q, k, v))
    counts = {"interior": 0}
    o, lse = fwd_tiles(q, k, v, d ** -0.5, causal, window, counts)
    np.testing.assert_allclose(o.numpy(), o_j, atol=FWD_TOL, err_msg="o")
    np.testing.assert_allclose(lse.numpy(), lse_j, atol=FWD_TOL,
                               err_msg="lse")
    o_p, lse_p = tfa.flash_fwd_ref(q, k, v, scale=d ** -0.5, causal=causal,
                                   window=window)
    np.testing.assert_allclose(o.numpy(), o_p.numpy(), atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), lse_p.numpy(), atol=FWD_TOL)
    assert (counts["stored"] == 1).all()  # every (head, position) once
    if causal and not window and q.shape[1] >= 2 * tk(d):
        assert counts["interior"] > 0


@pytest.mark.parametrize("rows", [128, 192])
@pytest.mark.parametrize("g", [1, 2, 3, 5, 6, 10, 12, 24, 127, 128, 130,
                               192, 200, 384])
def test_padding_rows_never_store(g, rows):
    """The row map over a kv head's blocks: the rows past HB P and the
    heads past the group are padding, and the other rows store every
    (head, position) of the group exactly once, for lengths that are and
    are not multiples of P; the groups that tile the rows have no padding
    row (the kernel's kPadRows false)."""
    hb = min(g, rows)
    filled = hb * (rows // hb)
    assert rows - filled < hb  # the box leaves less than one position
    tiles = rows % hb == 0 and g % hb == 0
    for hk, sq in ((0, 1), (1, 61), (2, 130)):
        stored = torch.zeros(sq, g, dtype=torch.int64)
        any_pad = False
        for chunk, q0 in blocks(g, sq, rows):
            pos, head = row_map(g, hk, chunk, q0, sq, rows)
            r = torch.arange(rows)
            pad = (r >= filled) | (r % hb + chunk * hb >= g)
            assert (pos[pad] == sq).all()
            any_pad |= bool(pad.any())
            ok = pos < sq
            assert (ok == ~pad & (q0 + r // hb < sq)).all()
            assert ((head[ok] >= hk * g) & (head[ok] < (hk + 1) * g)).all()
            stored[pos[ok], head[ok] - hk * g] += 1
        assert (stored == 1).all(), (g, sq)
        assert any_pad != tiles
