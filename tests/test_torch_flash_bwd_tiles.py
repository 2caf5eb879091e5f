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
  h0 + r % HB at position q0 + r / HB, HB = min(G, 128), P = 128 // HB
  positions a block, ceil(G / HB) head chunks); a group that does not
  divide 128 (3, 5, 6, 12, ...) leaves rows past HB P as padding, and a
  partial last chunk's heads past the group too: zero rows, never stored
  (every (head, position) is stored exactly once); K/V tiles of 64 rows
  (128 at head_dim 64, 32 at 256) from the window's band (aligned down) to
  the diagonal; the ring that feeds them (stages and the producer's refill
  rule, walked over every interleaving of the two warpgroups) and the
  block's shared memory, per head_dim;
- B3's blocks: 128 kv rows (64 a warpgroup), the q tiles of 64 rows (128
  at head_dim 64, taken 64 columns at a time) from the diagonal on to the
  window's far edge, every q head of the group, the GQA group summed in
  the fp32 accumulators; the (q head, q tile) steps of a kv tile cut into
  `split` contiguous shares for the blocks of a cluster (empty, partial or
  whole), each share's fp32 partial, and the merge that sums the partials
  in rank order;
- B3 at head_dim 192 and 256 (flash_bwd_dkv_wgmma_hd256_kernel): 64 kv
  rows a block, both warpgroups over them, q tiles of 64 rows; warpgroup 0
  makes S^T = K Q^T and the masked fp32 P^T and accumulates dV, warpgroup
  1 makes dP^T = V dO^T, takes P^T from warpgroup 0 (shared memory) for
  dS^T and accumulates dK; the cluster shares and merge as above;
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
ROWS_KV_HD = 64  # B3 at head_dim 192/256: kv rows per block
TQ_HD = 64       # B3 at head_dim 192/256: q rows per step


def tk(d):
    """B2: kv rows per tile."""
    return 128 if d <= 64 else 64 if d <= 192 else 32


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
# Groups that do not divide B2's 128 rows (padding rows; Sq no multiple of
# P = 128 // G): debug_200m's 3, b14's 5, 6, and 12, at head_dim 64 and
# 128, causal, with a window, and not causal.
GROUP_GEOMETRIES = {
    "causal_g3_d64_s200": (1, 200, 6, 2, 64, True, None),
    "causal_g3_d128_s300": (1, 300, 3, 1, 128, True, None),
    "g5_win90_d128_s310": (1, 310, 5, 1, 128, True, 90),
    "noncausal_g5_d64_s160": (1, 160, 10, 2, 64, False, None),
    "g6_win70_d64_s250": (1, 250, 6, 1, 64, True, 70),
    "causal_g6_d128_s200": (2, 200, 6, 1, 128, True, None),
    "causal_g12_d64_s205": (1, 205, 12, 1, 64, True, None),
    "g12_win40_d128_s137": (1, 137, 24, 2, 128, True, 40),
}
# B3 at head_dim 192 and 256: causal with a group of 2, a window over a
# length that is no multiple of 4 (the stats' off-boundary rows), and a
# group of 5 not causal.
HD_GEOMETRIES = {
    "causal_g2_d192_s256": (1, 256, 4, 2, 192, True, None),
    "win70_g3_d256_s201": (1, 201, 3, 1, 256, True, 70),
    "noncausal_g5_d192_s137": (1, 137, 5, 1, 192, False, None),
}
ALL_GEOMETRIES = {**GEOMETRIES, **GROUP_GEOMETRIES, **HD_GEOMETRIES}


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


def _q_range(kv0, sq, causal, window, tile, rows=ROWS_KV):
    """B3: [begin, end) of the q rows that can see kv rows [kv0, kv0 +
    rows)."""
    if not causal:
        return 0, sq
    end = min(sq, kv0 + rows - 1 + window) if window else sq
    return kv0 // tile * tile, end


def _p(s, lse, scale):
    """P in base 2: s [rows, cols] fp32 scores, lse broadcast to them."""
    return torch.exp2(s * (scale * LOG2E) - lse * LOG2E)


def dq_row_map(g, hk, chunk, q0, sq):
    """B2's rows of one block: (position, head) per row, position sq for a
    padding row (past HB P, or a head past the group in a partial last
    chunk), as the kernel assigns them."""
    hb = min(g, ROWS_DQ)
    r = torch.arange(ROWS_DQ)
    head = hk * g + chunk * hb + r % hb
    pad = (r >= hb * (ROWS_DQ // hb)) | (head >= (hk + 1) * g)
    pos = torch.where(pad, sq, q0 + r // hb)
    return pos, head


def dq_blocks(g, sq):
    """B2's grid over one kv head: (head chunk, q0) for every block."""
    hb = min(g, ROWS_DQ)
    per = ROWS_DQ // hb
    return [(chunk, q0) for chunk in range(-(-g // hb))
            for q0 in range(0, sq, per)]


def dq_tiles(q, k, v, do, lse, delta, scale, causal, window, counts):
    """B2's blocks and tiles: dQ [B, Sq, Hq, D] fp32."""
    B, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    pos_per_block = ROWS_DQ // min(g, ROWS_DQ)
    dq = torch.zeros(B, sq, hq, d)
    stored = torch.zeros(B, sq, hq, dtype=torch.int64)
    TK = tk(d)
    for b in range(B):
        for hk in range(hkv):
            for chunk, q0 in dq_blocks(g, sq):
                pos, head = dq_row_map(g, hk, chunk, q0, sq)
                ok = pos < sq
                p_c, h_c = pos.clamp(max=sq - 1), head.clamp(max=hq - 1)
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
                stored[b, pos[ok], head[ok]] += 1
    counts["stored"] = stored
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


def dkv_tiles_hd(q, k, v, do, lse, delta, scale, causal, window, split,
                 counts):
    """B3's head_dim 192/256 blocks, the two warpgroups' split of the work,
    the cluster shares and merge: (dK, dV) [B, Skv, Hkv, D] fp32."""
    B, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    dk = torch.zeros(B, skv, hkv, d)
    dv = torch.zeros(B, skv, hkv, d)
    for b in range(B):
        for hk in range(hkv):
            for kv0 in range(0, skv, ROWS_KV_HD):
                q_begin, q_end = _q_range(kv0, sq, causal, window, TQ_HD,
                                          ROWS_KV_HD)
                nq = max(0, -(-(q_end - q_begin) // TQ_HD))
                steps = g * nq
                counts["steps"].append(steps)
                n = min(ROWS_KV_HD, skv - kv0)
                kp = torch.arange(kv0, kv0 + ROWS_KV_HD)
                kr = torch.zeros(ROWS_KV_HD, d)
                vr = torch.zeros(ROWS_KV_HD, d)
                kr[:n], vr[:n] = k[b, kv0:kv0 + n, hk], v[b, kv0:kv0 + n, hk]
                partials = []
                for rank in range(split):
                    acc_v = torch.zeros(ROWS_KV_HD, d)  # warpgroup 0
                    acc_k = torch.zeros(ROWS_KV_HD, d)  # warpgroup 1
                    share = range(steps * rank // split,
                                  steps * (rank + 1) // split)
                    counts["shares"][min(len(share), 2)] += 1
                    for j in share:
                        hq_j = hk * g + j // nq
                        q0 = q_begin + (j % nq) * TQ_HD
                        qp = torch.arange(q0, q0 + TQ_HD)
                        ok = qp < sq
                        qc = qp.clamp(max=sq - 1)
                        qt = torch.where(ok[:, None], q[b, qc, hq_j], 0.0)
                        dot = torch.where(ok[:, None], do[b, qc, hq_j], 0.0)
                        lse_c = lse[b, hq_j, qc][None, :]
                        dl_c = delta[b, hq_j, qc][None, :]
                        # Warpgroup 0: S^T, P^T masked unless interior, dV.
                        pt = _p(kr @ qt.T, lse_c, scale)
                        keep = (_in_band(qp, kp, causal, window).T
                                & ok[None, :])
                        interior = q0 + TQ_HD <= sq and (not causal or (
                            q0 >= kv0 + ROWS_KV_HD - 1
                            and (not window
                                 or q0 + TQ_HD - 1 - kv0 < window)))
                        if interior:
                            counts["dkv_interior"] += 1
                            assert keep.all()
                        else:
                            pt = torch.where(keep, pt, 0.0)
                        acc_v += pt @ dot
                        # Warpgroup 1: dP^T, then dS^T from the P^T that
                        # warpgroup 0 hands over in fp32; masked there.
                        handed = pt.clone()
                        dst = handed * (vr @ dot.T - dl_c) * scale
                        acc_k += dst @ qt
                    partials.append((acc_k, acc_v))
                mk, mv = partials[0]
                for acc_k, acc_v in partials[1:]:
                    mk = mk + acc_k
                    mv = mv + acc_v
                dk[b, kv0:kv0 + n, hk] = mk[:n]
                dv[b, kv0:kv0 + n, hk] = mv[:n]
    return dk, dv


@functools.lru_cache(maxsize=None)
def _reference(name):
    """Inputs, the JAX VJP's (dq, dk, dv), and the port's plain O and lse."""
    B, S, hq, hkv, d, causal, window = ALL_GEOMETRIES[name]
    seed = (sorted(GEOMETRIES).index(name) if name in GEOMETRIES
            else 100 + sorted(GROUP_GEOMETRIES).index(name)
            if name in GROUP_GEOMETRIES
            else 200 + sorted(HD_GEOMETRIES).index(name))
    rng = np.random.RandomState(seed)
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
    causal, window = ALL_GEOMETRIES[name][5], ALL_GEOMETRIES[name][6] or 0
    q, k, v, do, g_lse = map(torch.as_tensor, (q, k, v, g_o, g_lse))
    args = dict(scale=d ** -0.5, causal=causal, window=window)
    o, lse = tfa.flash_fwd_ref(q, k, v, **args)
    delta = (do * o).sum(-1).transpose(1, 2) - g_lse
    return (q, k, v, do, lse, delta), args, grads


@pytest.mark.parametrize("name", sorted(GEOMETRIES) + sorted(GROUP_GEOMETRIES)
                         + sorted(HD_GEOMETRIES))
def test_dq_tiles_match_jax(name):
    inputs, args, (dq_j, _, _) = _tiles_inputs(name)
    counts = {"dq_interior": 0}
    dq = dq_tiles(*inputs, args["scale"], args["causal"], args["window"],
                  counts)
    np.testing.assert_allclose(dq.numpy(), dq_j, atol=GRAD_TOL)
    plain = tfa.flash_bwd_dq_ref(*inputs, **args)
    np.testing.assert_allclose(dq.numpy(), plain.numpy(), atol=GRAD_TOL)
    assert (counts["stored"] == 1).all()  # every (head, position) once
    if args["causal"] and not args["window"] and inputs[0].shape[1] >= 256:
        assert counts["dq_interior"] > 0  # and a window of 80 has none


@pytest.mark.parametrize("g", [1, 2, 3, 4, 5, 6, 7, 12, 24, 96, 127, 128,
                               129, 200, 256])
def test_dq_padding_rows_never_store(g):
    """B2's row map over a kv head's blocks: the rows past HB P and the
    heads past the group are padding, and the other rows store every
    (head, position) of the group exactly once, for lengths that are and
    are not multiples of P."""
    hb = min(g, ROWS_DQ)
    rows = hb * (ROWS_DQ // hb)
    assert ROWS_DQ - rows < hb  # the box leaves less than one position
    for hk, sq in ((0, 1), (1, 127), (2, 130), (1, 257)):
        stored = torch.zeros(sq, g, dtype=torch.int64)
        for chunk, q0 in dq_blocks(g, sq):
            pos, head = dq_row_map(g, hk, chunk, q0, sq)
            r = torch.arange(ROWS_DQ)
            pad = (r >= rows) | (r % hb + chunk * hb >= g)
            assert (pos[pad] == sq).all()
            ok = pos < sq
            assert (ok == ~pad & (q0 + r // hb < sq)).all()
            assert ((head[ok] >= hk * g) & (head[ok] < (hk + 1) * g)).all()
            stored[pos[ok], head[ok] - hk * g] += 1
        assert (stored == 1).all(), (g, sq)


# B2's ring by head_dim, as BwdDq<D> sets it: (kv rows a tile, stages, the
# refill's lag). At tile t the producer (thread 0, in warpgroup 0) refills
# the stage of tile t - lag, once both warpgroups have released it, with
# tile t - lag + stages; with lag 1 it first releases tile t - 1 itself.
DQ_RING = {64: (128, 4, 2), 128: (64, 4, 2), 192: (64, 2, 1), 256: (32, 3, 1)}
SMEM_BYTES = 232448  # shared memory one block may take on an H100


def dq_smem_bytes(d):
    """BwdDq<D>::kSmemBytes: alignment slack, Q and dO for 128 rows, the
    ring of K/V stages, the mbarriers."""
    tile, stages, _ = DQ_RING[d]
    return 1024 + 2 * ROWS_DQ * d * 2 + stages * 2 * tile * d * 2 + (2 * stages + 1) * 8


def dq_ring_program(wg, tiles, stages, lag, refill_of=None):
    """One warpgroup's ring actions, in the kernel's order after the block
    barrier (the producer's first min(tiles, stages) loads come before it):
    per tile t, wait for its stage to be full; the producer's refill before
    the release where lag > 1 (under the score products), after it where
    lag is 1; release tile t - 1's stage (its dQ product has completed).
    refill_of(t) -> (tile waited for, tile loaded) or None overrides the
    kernel's rule."""
    def refill(t):
        if refill_of is not None:
            pair = refill_of(t)
            return [] if pair is None else [("wait_empty", pair[0]), ("load", pair[1])]
        if t >= lag and t - lag + stages < tiles:
            return [("wait_empty", t - lag), ("load", t - lag + stages)]
        return []

    prog = []
    for t in range(tiles):
        prog.append(("wait_full", t))
        if wg == 0 and lag > 1:
            prog += refill(t)
        if t > 0:
            prog.append(("release", t - 1))
        if wg == 0 and lag == 1:
            prog += refill(t)
    return prog


def dq_ring_faults(tiles, stages, lag, refill_of=None):
    """Walk every interleaving of the two warpgroups' ring actions. ->
    the faults found (empty where the schedule holds): a tile loaded twice
    or never, a load into a stage not released by both warpgroups or still
    read, a tile read after its stage was overwritten, a deadlock."""
    progs = [dq_ring_program(w, tiles, stages, lag, refill_of) for w in (0, 1)]
    first = tuple(range(min(tiles, stages)))
    faults, seen = set(), set()
    stack = [((0, 0), first)]
    while stack:
        pcs, loads = stack.pop()
        if (pcs, loads) in seen:
            continue
        seen.add((pcs, loads))
        done = [progs[w][:pcs[w]] for w in (0, 1)]
        released = [{t for a, t in done[w] if a == "release"} for w in (0, 1)]
        reading = [{t for a, t in done[w] if a == "wait_full"} - released[w]
                   for w in (0, 1)]
        held = {}  # stage -> the tile last loaded into it
        for t in loads:
            held[t % stages] = t
        moved = False
        for w in (0, 1):
            if pcs[w] == len(progs[w]):
                continue
            act, t = progs[w][pcs[w]]
            if act == "wait_full" and t not in loads:
                continue
            if act == "wait_empty" and not all(t in r for r in released):
                continue
            nxt = loads
            if act == "load":
                if t in loads:
                    faults.add(f"tile {t} loaded twice")
                old = t - stages
                if old >= 0 and not all(old in r for r in released):
                    faults.add(f"tile {t} into a stage not released by both")
                if any(old in r for r in reading):
                    faults.add(f"tile {t} over tile {old} while it is read")
                nxt = loads + (t,)
            if act in ("wait_full", "release") and held.get(t % stages) != t:
                faults.add(f"tile {t} read after its stage was overwritten")
            moved = True
            stack.append(((pcs[0] + (w == 0), pcs[1] + (w == 1)), nxt))
        if not moved and pcs != (len(progs[0]), len(progs[1])):
            faults.add(f"deadlock at {pcs}")
        if pcs == (len(progs[0]), len(progs[1])) and sorted(loads) != list(range(tiles)):
            faults.add(f"tiles loaded {sorted(loads)}")
    return faults


@pytest.mark.parametrize("d", sorted(DQ_RING))
def test_dq_ring_refill_schedule(d):
    """B2's producer at each head_dim's (tile, stages, lag), 0-9 tiles:
    every tile loaded exactly once, each into a stage that both warpgroups
    have released and no one still reads, no deadlock; and the model
    catches the rule the kernel had before its stage count varied (at tile
    t refill tile t - 2's stage with tile t + 2), which holds at 4 stages
    only."""
    tile, stages, lag = DQ_RING[d]
    assert tile == tk(d)
    for tiles in range(10):
        assert not dq_ring_faults(tiles, stages, lag), (d, tiles)
    def four_stage_rule(t):
        return (t - 2, t + 2) if t >= 2 and t + 2 < 9 else None
    assert not dq_ring_faults(9, 4, 2, four_stage_rule)
    if stages != 4:
        assert dq_ring_faults(9, stages, 2, four_stage_rule)


@pytest.mark.parametrize("d", sorted(DQ_RING))
def test_dq_block_fits_shared_memory_and_registers(d):
    """BwdDq<D>: shared memory at or under the H100's 232,448 bytes a
    block; K/V boxes of whole 8-row swizzle groups that tile the stage; and
    per thread the dQ accumulator (D / 2 fp32), one tile's S and dP (TK / 2
    each) and the last tile's bf16 dS (TK / 4), live together while that dQ
    product runs: at most head_dim 64's 192 (which compiles without a
    spill) of the 255 registers a thread may hold."""
    tile, stages, _ = DQ_RING[d]
    assert dq_smem_bytes(d) <= SMEM_BYTES, dq_smem_bytes(d)
    box = min(tile, 64)
    assert tile % box == 0 and box % 8 == 0
    assert tile in (32, 64, 128)  # the SS wgmma widths hopper.cuh has
    assert d // 2 + tile + tile // 4 <= 192
    # One more stage would not fit at head_dim 192 and 256.
    if d > 128:
        over = dq_smem_bytes(d) + 2 * tile * d * 2 + 16
        assert over > SMEM_BYTES


@pytest.mark.parametrize("split", [1, 2])
@pytest.mark.parametrize("name", sorted(GEOMETRIES) + sorted(GROUP_GEOMETRIES))
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


@pytest.mark.parametrize("split", [1, 2])
@pytest.mark.parametrize("name", sorted(HD_GEOMETRIES))
def test_dkv_hd_tiles_and_cluster_merge_match_jax(name, split):
    """B3 at head_dim 192/256: the warpgroups' split by gradient with P^T
    handed over, against the JAX VJP and the plain version."""
    inputs, args, (_, dk_j, dv_j) = _tiles_inputs(name)
    counts = {"dkv_interior": 0, "steps": [], "shares": [0, 0, 0]}
    dk, dv = dkv_tiles_hd(*inputs, args["scale"], args["causal"],
                          args["window"], split, counts)
    np.testing.assert_allclose(dk.numpy(), dk_j, atol=GRAD_TOL, err_msg="dk")
    np.testing.assert_allclose(dv.numpy(), dv_j, atol=GRAD_TOL, err_msg="dv")
    dk_p, dv_p = tfa.flash_bwd_dkv_ref(*inputs, **args)
    np.testing.assert_allclose(dk.numpy(), dk_p.numpy(), atol=GRAD_TOL)
    np.testing.assert_allclose(dv.numpy(), dv_p.numpy(), atol=GRAD_TOL)
    if args["causal"] and not args["window"]:
        assert counts["dkv_interior"] > 0
        assert counts["steps"][0] > counts["steps"][-1]


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (True, 200), (False, 0)])
@pytest.mark.parametrize("sq", [128, 200, 384])
def test_q_ranges_cover_every_pair_of_the_band(sq, causal, window):
    """B3: every (q, k) pair in the band has q inside its kv tile's q range,
    and the range starts at most one tile before the tile's first pair, at
    every head_dim's tiles."""
    kp, qp = torch.arange(sq), torch.arange(sq)
    keep = _in_band(qp, kp, causal, window)
    # head_dim 64 and 128, then 192 and 256 (64-row kv tiles).
    for rows, TQ in ((ROWS_KV, tq(64)), (ROWS_KV, tq(128)),
                     (ROWS_KV_HD, TQ_HD)):
        for kv0 in range(0, sq, rows):
            begin, end = _q_range(kv0, sq, causal, window, TQ, rows)
            seen = keep[:, kv0:kv0 + rows].any(dim=1).nonzero().flatten()
            if len(seen):
                assert begin <= seen.min() and seen.max() < end
                assert seen.min() - begin < TQ
