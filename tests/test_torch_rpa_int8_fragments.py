"""B5-int8's fragment map, held on the CPU against dequantize_kv and JAX.

csrc/ragged_paged_attention.cu's int8 split kernel runs only on the card
(tests/test_torch_cuda_int8.py). It never builds a bf16 K/V tile in shared
memory: each lane dequantizes its own B fragments of K in registers, and
each warp its own D / 4 columns of V into a private region. Here that map
is written in numpy, index for index as the kernel reads and writes:

- the cp.async ring: 16-byte chunk c of tile row r at chunk c ^
  code_swizzle(r, D);
- q's columns placed at q_slot(c), so that lane (g, t4) finds its k slots
  {2 t4, 2 t4 + 1, 8 + 2 t4, 9 + 2 t4} of k step 4 j + m in bytes 4 m ..
  4 m + 3 of chunk 4 j + t4 of K row 8 n + g;
- dequant4: byte ^ 0x80 in the mantissa of 2^23, minus 2^23 + 128, times
  the row's scale in fp32, rounded to bf16 (nearest even);
- V: lane l of warp w converts chunk (u // R) of the warp's columns at row
  u % R for u = l, l + 32, ... into the warp's region.

Held: the K fragments rebuild the dequantized K tile exactly, element by
element, each (k step, slot, row) once, the slots a permutation of the
columns shared with q, so S = Q K^T; the warps' regions rebuild the
dequantized V tile exactly, each element once, each warp only its own
columns; dequantize_kv and the JAX int8 cache's read (models/layers.py
`(codes.astype(float32) * scales).astype(bf16)`) give the same bits; the
kernel's 16-byte shared reads of 8 lanes (a quarter warp) hit 8 distinct
bank groups. Exact: every comparison is bitwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from luminaai_tpu_torch.ops import ragged_paged_attention as rpa

WARPS = 4


def split_rows(d):
    """Tile rows R of the split kernel at head_dim d."""
    return 64 if d <= 128 else 32 if d <= 256 else 16


def code_swizzle(r, d):
    if d % 128 == 0:
        return ((r & 1) << 2) | ((r >> 1) & 3)
    return (r >> 1) & 3


def q_slot(c):
    return (4 * (c // 64) + ((c >> 2) & 3)) * 16 + ((c >> 1) & 1) * 8 \
        + 2 * ((c >> 4) & 3)


def dequant(chunk, scale):
    """The kernel's dequant4 over int8 codes (any count, a multiple of 4)
    with one fp32 scale: fp32 products, before the bf16 rounding."""
    words = np.ascontiguousarray(chunk).view(np.uint32)
    biased = words ^ np.uint32(0x80808080)
    out = np.empty((len(words), 4), np.float32)
    for j in range(4):
        bits = np.uint32(0x4B000000) | ((biased >> np.uint32(8 * j))
                                        & np.uint32(0xFF))
        x = bits.view(np.float32)
        out[:, j] = (x - np.float32(8388736.0)) * np.float32(scale)
    return out.reshape(-1)


def bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _tile(R, d, seed):
    """One tile's codes [R, d] (every code value present, the last rows zero
    as the ring's zero-fill past the band) and fp32 scales [R]."""
    rng = np.random.RandomState(seed)
    codes = rng.randint(-128, 128, size=(R, d)).astype(np.int8)
    codes.reshape(-1)[:256] = np.arange(-128, 128, dtype=np.int16).astype(
        np.int8)
    scales = (np.abs(rng.randn(R)) * 0.05 / 127).astype(np.float32)
    scales[:3] = [1.0, 2.0 ** -7, 1e30]
    codes[-2:] = 0
    scales[-2:] = 0.0
    return codes, scales


def ring_rows(codes, d):
    """The tile as the cp.async loads lay it in the ring."""
    R = codes.shape[0]
    ring = np.zeros_like(codes)
    for r in range(R):
        for c in range(d // 16):
            p = c ^ code_swizzle(r, d)
            ring[r, 16 * p:16 * p + 16] = codes[r, 16 * c:16 * c + 16]
    return ring


def k_fragments(ring, scales, R, d):
    """B[kk, slot, row] of S = Q K^T as the lanes build them (every warp
    the same), and how often each was written."""
    frag = np.zeros((d // 16, 16, R), np.float32)
    hits = np.zeros((d // 16, 16, R), np.int64)
    for g in range(8):
        swz = code_swizzle(g, d)
        for t4 in range(4):
            for j in range(d // 64):
                for n in range(R // 8):
                    row = 8 * n + g
                    assert code_swizzle(row, d) == swz
                    p = (4 * j + t4) ^ swz
                    vals = dequant(ring[row, 16 * p:16 * p + 16], scales[row])
                    for m in range(4):
                        kk = 4 * j + m
                        for e, slot in enumerate((2 * t4, 2 * t4 + 1,
                                                  8 + 2 * t4, 9 + 2 * t4)):
                            frag[kk, slot, row] = vals[4 * m + e]
                            hits[kk, slot, row] += 1
    return bf16(frag), hits


def v_regions(ring, scales, R, d):
    """Each warp's region [R, d / 4] as its lanes fill it, and hit counts."""
    regions, hits = [], []
    nch = d // 64
    for w in range(WARPS):
        region = np.zeros((R, d // 4), np.float32)
        hit = np.zeros((R, d // 4), np.int64)
        for lane in range(32):
            for u in range(lane, R * nch, 32):
                r, ch = u % R, u // R
                p = (w * nch + ch) ^ code_swizzle(r, d)
                region[r, 16 * ch:16 * ch + 16] = dequant(
                    ring[r, 16 * p:16 * p + 16], scales[r])
                hit[r, 16 * ch:16 * ch + 16] += 1
        regions.append(bf16(region))
        hits.append(hit)
    return regions, hits


def _dequantized(codes, scales):
    """dequantize_kv's tile, and the JAX int8 cache's read of it."""
    port = rpa.dequantize_kv((torch.from_numpy(codes),
                              torch.from_numpy(scales)[:, None]),
                             torch.bfloat16)
    jax_read = (jnp.asarray(codes).astype(jnp.float32)
                * jnp.asarray(scales)[:, None]).astype(jnp.bfloat16)
    return port.float().numpy(), np.asarray(jax_read.astype(jnp.float32))


TILES = [(R, d) for R in (64, 32, 16) for d in (64, 128, 256)]


@pytest.mark.parametrize("R,d", TILES)
def test_k_fragments_rebuild_the_dequantized_tile(R, d):
    codes, scales = _tile(R, d, seed=R + d)
    want, want_jax = _dequantized(codes, scales)
    np.testing.assert_array_equal(want, want_jax)
    frag, hits = k_fragments(ring_rows(codes, d), scales, R, d)
    assert (hits == 1).all()
    # q's column at each (k step, slot): q_slot is a permutation, and the
    # fragment there is that column of the dequantized K row.
    col = np.full(d, -1)
    for c in range(0, d, 2):
        col[q_slot(c)], col[q_slot(c) + 1] = c, c + 1
    assert sorted(col) == list(range(d))
    col = col.reshape(d // 16, 16)
    np.testing.assert_array_equal(frag, want.T[col])
    # So the mma sums, over the permuted k slots, q . k of every row.
    q = np.random.RandomState(d).randn(16, d)
    q_sm = np.zeros((16, d))
    for c in range(d):
        q_sm[:, (q_slot(c & ~1) + (c & 1))] = q[:, c]
    s = sum(q_sm[:, 16 * kk:16 * kk + 16] @ frag[kk].astype(np.float64)
            for kk in range(d // 16))
    np.testing.assert_allclose(s, q @ want.T.astype(np.float64), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("R,d", TILES)
def test_v_regions_rebuild_the_dequantized_tile(R, d):
    codes, scales = _tile(R, d, seed=3 * R + d)
    want, want_jax = _dequantized(codes, scales)
    np.testing.assert_array_equal(want, want_jax)
    regions, hits = v_regions(ring_rows(codes, d), scales, R, d)
    for w in range(WARPS):
        assert (hits[w] == 1).all()  # the warp's own D / 4 columns, once
        np.testing.assert_array_equal(
            regions[w], want[:, w * d // 4:(w + 1) * d // 4])


def test_dequant4_is_the_float_of_every_code():
    codes = np.arange(-128, 128, dtype=np.int16).astype(np.int8)
    np.testing.assert_array_equal(dequant(codes, 1.0),
                                  codes.astype(np.float32))


@pytest.mark.parametrize("d", [64, 128, 192, 256, 320, 512])
def test_shared_reads_of_a_quarter_warp_hit_distinct_bank_groups(d):
    """16-byte reads by 8 lanes in one shared-memory wavefront: the S
    product's (rows g = 0, 1 or 2, 3 of a row tile, chunks 4 j + t4) and
    the V dequantize's (8 rows at one chunk) land on the 8 different
    16-byte bank groups of a 128-byte line."""
    R = split_rows(d)

    def group(r, c):
        return (r * d // 16 + (c ^ code_swizzle(r, d))) % 8

    for j in range(d // 64):
        for n in range(R // 8):
            for quarter in range(4):
                lanes = range(8 * quarter, 8 * quarter + 8)
                got = {group(8 * n + l // 4, 4 * j + l % 4) for l in lanes}
                assert len(got) == 8, (d, j, n, quarter)
    nch = d // 64
    for w in range(WARPS):
        for start in range(0, R * nch, 8):
            got = {group(u % R, w * nch + u // R)
                   for u in range(start, start + 8)}
            assert len(got) == 8, (d, w, start)
