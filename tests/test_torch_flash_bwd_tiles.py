"""The wgmma backward kernels' tiling and algebra, held on the CPU against JAX.

csrc/flash_attention.cu's flash_bwd_dq_wgmma_kernel (B2) and
flash_bwd_dkv_wgmma_kernel (B3) run only on the card
(tests/test_torch_flash_cuda.py). Here what they compute, tile by tile, is
written in fp32 torch over the port's plain forward's O and lse and held
against the JAX package's flash attention VJP (Pallas in interpret mode, as
tests/test_ops.py runs it) on the same numpy inputs:

- P recomputed in base 2, p = 2^(s c - lse log2 e) with c = scale log2 e;
  dS = P (dP - delta) scale with delta = rowsum(dO O) - g_lse;
- B2's blocks: 128 (q head, position) rows, position-major (row r is head
  h0 + r % HB at position q0 + r / HB, HB = min(G, 128)), K/V tiles of 64
  rows (128 at head_dim 64) from the window's band (aligned down) to the
  diagonal;
- B3's blocks: 128 kv rows (64 a warpgroup), the q tiles of 64 rows (128
  at head_dim 64, taken 64 columns at a time) from the diagonal on to the
  window's far edge, every q head of the group, the GQA group summed in
  the fp32 accumulators; the (q head, q tile) steps of a kv tile cut into
  `split` contiguous shares for the blocks of a cluster (empty, partial or
  whole), each share's fp32 partial, and the merge that sums the partials
  in rank order;
- the interior test: a tile it calls interior needs no mask (checked
  element by element), so the kernels skip the masks there.

Tolerance: atol 5e-4 on the gradients, tests/test_ops.py's and
tests/test_torch_flash_attention.py's: fp32 throughout, the sums and the
exponentials (2^x here, e^x in JAX) in other orders and forms.
"""

import functools
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from luminaai_tpu.ops import flash_attention as jfa
from luminaai_tpu_torch.ops import flash_attention as tfa

GRAD_TOL = 5e-4
LOG2E = math.log2(math.e)
ROWS_DQ = 128  # B2: (q head, position) rows per block
ROWS_KV = 128  # B3: kv rows per block
WG_ROWS = 64   # B3: kv rows per consumer warpgroup
SUB = 64       # B3: q columns per product


def tk(d):
    """B2: kv rows per tile."""
    return 128 if d <= 64 else 64


def tq(d):
    """B3: q rows per tile."""
    return 128 if d <= 64 else 64

GEOMETRIES = {
    # name: (B, S, Hq, Hkv, D, causal, window)
    "causal_g4_d64": (1, 256, 8, 2, 64, True, None),
    "causal_g2_d128": (1, 256, 4, 2, 128, True, None),
    # G = 1 and a 80-row window: the last kv tile has one step (a split
    # leaves shares empty), and no tile is interior to every row's band.
    "window80_g1_d64": (1, 384, 2, 2, 64, True, 80),
    "partial_s200_g2_d64": (2, 200, 4, 2, 64, True, None),
    "noncausal_s200_g4_d64": (1, 200, 4, 1, 64, False, None),
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


def _q_range(kv0, sq, causal, window, tile):
    """B3: [begin, end) of the q rows that can see kv rows [kv0, kv0 + 128)."""
    if not causal:
        return 0, sq
    end = min(sq, kv0 + ROWS_KV - 1 + window) if window else sq
    return kv0 // tile * tile, end


def _p(s, lse, scale):
    """P in base 2: s [rows, cols] fp32 scores, lse broadcast to them."""
    return torch.exp2(s * (scale * LOG2E) - lse * LOG2E)


def dq_tiles(q, k, v, do, lse, delta, scale, causal, window, counts):
    """B2's blocks and tiles: dQ [B, Sq, Hq, D] fp32."""
    B, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    hb = min(g, ROWS_DQ)
    pos_per_block = ROWS_DQ // hb
    dq = torch.zeros(B, sq, hq, d)
    r = torch.arange(ROWS_DQ)
    TK = tk(d)
    for b in range(B):
        for hk in range(hkv):
            for chunk in range(g // hb):
                h0 = hk * g + chunk * hb
                for q0 in range(0, sq, pos_per_block):
                    pos, head = q0 + r // hb, h0 + r % hb
                    ok = pos < sq
                    p_c, h_c = pos.clamp(max=sq - 1), head
                    qr = torch.where(ok[:, None], q[b, p_c, h_c], 0.0)
                    dor = torch.where(ok[:, None], do[b, p_c, h_c], 0.0)
                    lse_r = torch.where(ok, lse[b, h_c, p_c], 0.0)[:, None]
                    dl_r = torch.where(ok, delta[b, h_c, p_c], 0.0)[:, None]
                    qhi = min(q0 + pos_per_block, sq) - 1
                    begin, end = _kv_range(q0, qhi, skv, causal, window, TK)
                    acc = torch.zeros(ROWS_DQ, d)
                    for kv0 in range(begin, end, TK):
                        kp = torch.arange(kv0, kv0 + TK)
                        kt = torch.zeros(TK, d)
                        vt = torch.zeros(TK, d)
                        n = min(TK, skv - kv0)
                        kt[:n], vt[:n] = k[b, kv0:kv0 + n, hk], v[b, kv0:kv0 + n, hk]
                        p = _p(qr @ kt.T, lse_r, scale)
                        keep = _in_band(pos, kp, causal, window) & (kp < skv)
                        interior = kv0 + TK <= skv and (not causal or (
                            kv0 + TK - 1 <= q0
                            and (not window or qhi - kv0 < window)))
                        if interior:
                            counts["dq_interior"] += 1
                            assert keep[ok].all()
                        else:
                            p = torch.where(keep, p, 0.0)
                        ds = p * (dor @ vt.T - dl_r) * scale
                        acc += ds @ kt
                    dq[b, pos[ok], head[ok]] = acc[ok]
    return dq


def dkv_tiles(q, k, v, do, lse, delta, scale, causal, window, split, counts):
    """B3's blocks, cluster shares and merge: (dK, dV) [B, Skv, Hkv, D]
    fp32."""
    B, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    TQ = tq(d)
    dk = torch.zeros(B, skv, hkv, d)
    dv = torch.zeros(B, skv, hkv, d)
    for b in range(B):
        for hk in range(hkv):
            for kv0 in range(0, skv, ROWS_KV):
                q_begin, q_end = _q_range(kv0, sq, causal, window, TQ)
                nq = max(0, -(-(q_end - q_begin) // TQ))
                steps = g * nq
                counts["steps"].append(steps)
                for lo in range(kv0, min(skv, kv0 + ROWS_KV), WG_ROWS):
                    n = min(WG_ROWS, skv - lo)
                    kp = torch.arange(lo, lo + WG_ROWS)
                    kr = torch.zeros(WG_ROWS, d)
                    vr = torch.zeros(WG_ROWS, d)
                    kr[:n], vr[:n] = k[b, lo:lo + n, hk], v[b, lo:lo + n, hk]
                    partials = []
                    for rank in range(split):
                        acc_k = torch.zeros(WG_ROWS, d)
                        acc_v = torch.zeros(WG_ROWS, d)
                        share = range(steps * rank // split,
                                      steps * (rank + 1) // split)
                        counts["shares"][min(len(share), 2)] += 1
                        for j in share:
                            hq_j = hk * g + j // nq
                            q_tile = q_begin + (j % nq) * TQ
                            for q0 in range(q_tile, q_tile + TQ, SUB):
                                qp = torch.arange(q0, q0 + SUB)
                                ok = qp < sq
                                qc = qp.clamp(max=sq - 1)
                                qt = torch.where(ok[:, None], q[b, qc, hq_j], 0.0)
                                dot = torch.where(ok[:, None], do[b, qc, hq_j],
                                                  0.0)
                                # Past Sq the flat lse/delta load reads on
                                # (the next head's rows): finite, masked.
                                lse_c = lse[b, hq_j, qc][None, :]
                                dl_c = delta[b, hq_j, qc][None, :]
                                pt = _p(kr @ qt.T, lse_c, scale)
                                keep = (_in_band(qp, kp, causal, window).T
                                        & ok[None, :])
                                interior = q0 + SUB <= sq and (not causal or (
                                    q0 >= lo + WG_ROWS - 1
                                    and (not window
                                         or q0 + SUB - 1 - lo < window)))
                                if interior:
                                    counts["dkv_interior"] += 1
                                    assert keep.all()
                                else:
                                    pt = torch.where(keep, pt, 0.0)
                                dst = pt * (vr @ dot.T - dl_c) * scale
                                acc_v += pt @ dot
                                acc_k += dst @ qt
                        partials.append((acc_k, acc_v))
                    # The merge: the ranks' partials summed in rank order.
                    mk, mv = partials[0]
                    for acc_k, acc_v in partials[1:]:
                        mk = mk + acc_k
                        mv = mv + acc_v
                    dk[b, lo:lo + n, hk] = mk[:n]
                    dv[b, lo:lo + n, hk] = mv[:n]
    return dk, dv


@functools.lru_cache(maxsize=None)
def _reference(name):
    """Inputs, the JAX VJP's (dq, dk, dv), and the port's plain O and lse."""
    B, S, hq, hkv, d, causal, window = GEOMETRIES[name]
    rng = np.random.RandomState(sorted(GEOMETRIES).index(name))
    q, k, v, g_o = (rng.randn(*shape).astype(np.float32) for shape in (
        (B, S, hq, d), (B, S, hkv, d), (B, S, hkv, d), (B, S, hq, d)))
    g_lse = rng.randn(B, hq, S).astype(np.float32)
    block = 128 if S % 128 == 0 else 512

    def jax_fn(q, k, v):
        return jfa.flash_attention_with_lse(
            q, k, v, causal=causal, block_q=block, block_kv=block,
            window=window)

    _, vjp = jax.vjp(jax_fn, *map(jnp.asarray, (q, k, v)))
    grads = [np.asarray(x) for x in vjp((jnp.asarray(g_o),
                                         jnp.asarray(g_lse)))]
    return (q, k, v, g_o, g_lse), grads


def _tiles_inputs(name):
    (q, k, v, g_o, g_lse), grads = _reference(name)
    d = q.shape[-1]
    causal, window = GEOMETRIES[name][5], GEOMETRIES[name][6] or 0
    q, k, v, do, g_lse = map(torch.as_tensor, (q, k, v, g_o, g_lse))
    args = dict(scale=d ** -0.5, causal=causal, window=window)
    o, lse = tfa.flash_fwd_ref(q, k, v, **args)
    delta = (do * o).sum(-1).transpose(1, 2) - g_lse
    return (q, k, v, do, lse, delta), args, grads


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_dq_tiles_match_jax(name):
    inputs, args, (dq_j, _, _) = _tiles_inputs(name)
    counts = {"dq_interior": 0}
    dq = dq_tiles(*inputs, args["scale"], args["causal"], args["window"],
                  counts)
    np.testing.assert_allclose(dq.numpy(), dq_j, atol=GRAD_TOL)
    plain = tfa.flash_bwd_dq_ref(*inputs, **args)
    np.testing.assert_allclose(dq.numpy(), plain.numpy(), atol=GRAD_TOL)
    if args["causal"] and not args["window"] and inputs[0].shape[1] >= 256:
        assert counts["dq_interior"] > 0  # and a window of 80 has none


@pytest.mark.parametrize("split", [1, 2])
@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_dkv_tiles_and_cluster_merge_match_jax(name, split):
    inputs, args, (_, dk_j, dv_j) = _tiles_inputs(name)
    counts = {"dkv_interior": 0, "steps": [], "shares": [0, 0, 0]}
    dk, dv = dkv_tiles(*inputs, args["scale"], args["causal"],
                       args["window"], split, counts)
    np.testing.assert_allclose(dk.numpy(), dk_j, atol=GRAD_TOL, err_msg="dk")
    np.testing.assert_allclose(dv.numpy(), dv_j, atol=GRAD_TOL, err_msg="dv")
    dk_p, dv_p = tfa.flash_bwd_dkv_ref(*inputs, **args)
    np.testing.assert_allclose(dk.numpy(), dk_p.numpy(), atol=GRAD_TOL)
    np.testing.assert_allclose(dv.numpy(), dv_p.numpy(), atol=GRAD_TOL)
    if args["causal"] and not args["window"] and inputs[0].shape[1] >= 256:
        assert counts["dkv_interior"] > 0
    if args["causal"]:  # the band shrinks along the kv tiles
        assert counts["steps"][0] > counts["steps"][-1]
    if name.startswith("window") and split == 2:
        assert counts["shares"][0] > 0  # empty shares occurred


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (True, 200), (False, 0)])
@pytest.mark.parametrize("sq", [128, 200, 384])
def test_q_ranges_cover_every_pair_of_the_band(sq, causal, window):
    """B3: every (q, k) pair in the band has q inside its kv tile's q range,
    and the range starts at most one tile before the tile's first pair."""
    kp, qp = torch.arange(sq), torch.arange(sq)
    keep = _in_band(qp, kp, causal, window)
    for d in (64, 128):
        TQ = tq(d)
        for kv0 in range(0, sq, ROWS_KV):
            begin, end = _q_range(kv0, sq, causal, window, TQ)
            seen = keep[:, kv0:kv0 + ROWS_KV].any(dim=1).nonzero().flatten()
            if len(seen):
                assert begin <= seen.min() and seen.max() < end
                assert seen.min() - begin < TQ
