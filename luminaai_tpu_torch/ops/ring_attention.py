"""Ring attention over the sequence axis (port of luminaai_tpu/ops/ring_attention.py).

Each rank of the mesh's sequence group holds a contiguous chunk of Sl rows
of every sequence; K/V chunks travel around the ring (rank i sends to
i + 1, `parallel.mesh.ppermute`, isend/irecv) while each rank accumulates
its queries' attention over the chunks it sees, merged by their
logsumexps in fp32. The backward rotates the other way (the transpose of
ppermute) and reaches each chunk's kernels with the lse cotangent.

The pieces are module-level functions apart from the send/recv, so a
driver can play the rotation itself (`virtual_ring_attention`, which
chip_smoke.py runs on one card):

  - `chunk_kind` classifies ring step `step` of rank `my_idx`: the
    diagonal chunk (step 0; causal, an in-chunk window through the
    kernel's own band), a fully visible chunk (non-causal kernel), a chunk
    straddling the window's far edge (`banded_chunk`, the JAX einsum with
    the global band mask, :140-176: not a Pallas kernel there either), or
    a chunk in the causal future / entirely past the band (skipped: no
    kernel runs, and the merge is left as it is, which is what merging
    its zero weight gives);
  - `ring_chunk` computes one chunk's per-chunk-normalised (o, lse):
    `flash_attention_with_lse` (B1 forward; B2/B3 in the backward, with
    the lse cotangent folded into delta) or `banded_chunk`;
  - `ring_merge` folds a chunk into the running (acc, den, m), and
    `ring_finish` normalises;
  - `_chunk_update` / `_ring_attention_shard` are the JAX einsum ring
    (every chunk an online-softmax update, no kernel), taken where the
    local length is not flash-eligible.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from luminaai_tpu_torch.ops.flash_attention import (
    flash_attention_with_lse,
    flash_eligible,
)

NEG_INF = -1e30
DIAGONAL, ATTEND, BANDED, SKIP = "diagonal", "attend", "banded", "skip"


def chunk_kind(my_idx: int, step: int, axis_size: int, sl: int,
               causal: bool, window: Optional[int]) -> str:
    """What ring step `step` of rank `my_idx` computes (the JAX lax.cond /
    lax.switch of _ring_attention_shard_flash, resolved on the host)."""
    if step == 0:
        return DIAGONAL
    if not causal:
        return ATTEND
    kv_idx = (my_idx - step) % axis_size
    if kv_idx > my_idx:
        return SKIP
    if window is None:
        return ATTEND
    offset = (my_idx - kv_idx) * sl  # q_pos - k_pos at matching rows
    if offset - (sl - 1) >= window:
        return SKIP
    if offset + (sl - 1) < window:
        return ATTEND
    return BANDED


def banded_chunk(q, k, v, offset: int, window: int, scale: float):
    """Offset-band chunk: 0 <= q_pos - k_pos < window with q_pos - k_pos =
    offset + i - j; per-chunk-normalised (o [B, Sl, Hq, D], lse [B, Hq,
    Sl]), lse NEG_INF on rows whose band misses the chunk."""
    B, Sl, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    # fp32 scores and an fp32 P.V over P rounded to v's dtype, as the
    # flash kernels keep them (JAX's einsum here rounds the scores to
    # bf16 under bf16 inputs; the same in fp32).
    qg = q.reshape(B, Sl, Hkv, G, D).float()
    logits = torch.einsum("bqhgd,bkhd->bqhgk", qg, k.float()) * scale
    i = torch.arange(Sl, device=q.device)
    diff = offset + i[:, None] - torch.arange(k.shape[1],
                                              device=q.device)[None, :]
    mask = (diff >= 0) & (diff < window)
    logits = torch.where(mask[None, :, None, None, :], logits,
                         torch.full((), NEG_INF, device=q.device))
    m_c = logits.amax(dim=-1)
    p = torch.exp(logits - m_c[..., None])
    l_c = p.sum(dim=-1)
    any_row = mask.any(dim=-1)[None, :, None, None]
    o_row = torch.einsum("bqhgk,bkhd->bqhgd", p.to(v.dtype).float(),
                         v.float()) / l_c[..., None]
    lse = torch.where(any_row, m_c + torch.log(l_c),
                      torch.full((), NEG_INF, device=q.device))
    return (o_row.reshape(B, Sl, Hq, D).to(q.dtype),
            lse.reshape(B, Sl, Hq).transpose(1, 2))


def ring_chunk(q, k, v, kind: str, *, offset: int, causal: bool,
               window: Optional[int], block_q: int, block_kv: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ring chunk's (o, lse) for a `chunk_kind` other than SKIP."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if kind == DIAGONAL:
        return flash_attention_with_lse(
            q, k, v, causal=causal, block_q=block_q, block_kv=block_kv,
            window=window if causal else None)
    if kind == ATTEND:
        return flash_attention_with_lse(
            q, k, v, causal=False, block_q=block_q, block_kv=block_kv)
    if kind == BANDED:
        scale = 1.0 / math.sqrt(q.shape[-1])
        # Checkpointed as in JAX: the backward recomputes the [Sl, Sl]
        # logits instead of keeping them per ring step.
        return checkpoint(banded_chunk, q, k, v, offset, window, scale,
                          use_reentrant=False)
    raise ValueError(f"no chunk to compute for kind {kind!r}")


def ring_init(q: torch.Tensor):
    """Empty (acc [B, Sl, Hq, D], den [B, Hq, Sl], m [B, Hq, Sl]) fp32."""
    B, Sl, Hq, D = q.shape
    return (torch.zeros((B, Sl, Hq, D), dtype=torch.float32, device=q.device),
            torch.zeros((B, Hq, Sl), dtype=torch.float32, device=q.device),
            torch.full((B, Hq, Sl), NEG_INF, dtype=torch.float32,
                       device=q.device))


def ring_merge(acc, den, m, o_c, lse_c):
    """Fold a per-chunk-normalised chunk into the running state, weighted
    by exp(lse_c) (the JAX merge, :122-132)."""
    m_new = torch.maximum(m, lse_c)
    corr = torch.exp(m - m_new)
    w = torch.exp(lse_c - m_new)
    den = den * corr + w
    w_t = w.transpose(1, 2)[..., None]
    corr_t = corr.transpose(1, 2)[..., None]
    acc = acc * corr_t + o_c.float() * w_t
    return acc, den, m_new


def ring_finish(acc, den, dtype):
    return (acc / den.transpose(1, 2)[..., None]).to(dtype)


def _ring_attention_shard_flash(q, k, v, *, group, my_idx: int,
                                axis_size: int, causal: bool, block_q: int,
                                block_kv: int, window: Optional[int] = None):
    """The flash ring body of one rank (JAX :76): the diagonal chunk, then
    axis_size - 1 rotations, each chunk by chunk_kind."""
    Sl = q.shape[1]
    acc, den, m = ring_init(q)
    rotate = _Rotation(k, v, group, axis_size)
    for step in range(axis_size):
        k, v = rotate.step(step)
        kind = chunk_kind(my_idx, step, axis_size, Sl, causal, window)
        if kind == SKIP:
            continue
        rotate.used(step)
        kv_idx = (my_idx - step) % axis_size
        o_c, lse_c = ring_chunk(q, k, v, kind, offset=(my_idx - kv_idx) * Sl,
                                causal=causal, window=window,
                                block_q=block_q, block_kv=block_kv)
        acc, den, m = ring_merge(acc, den, m, o_c, lse_c)
    return rotate.finish(ring_finish(acc, den, q.dtype))


class _Rotation:
    """K and V travelling the ring as ONE tensor, so every rank runs the
    same chain of sends and receives in its backward: the ranks' graphs
    differ only in the chunks they skip, and a rotation whose chunk was
    skipped still joins the output (with weight 0), so its backward
    exchange runs on every rank, in the chain's order."""

    def __init__(self, k, v, group, axis_size: int):
        self.d = k.shape[-1]
        self.kv = torch.cat([k, v], dim=-1)
        self.group = group
        self.perm = [(i, (i + 1) % axis_size) for i in range(axis_size)]
        self.unused = []

    def step(self, step: int):
        from luminaai_tpu_torch.parallel.mesh import ppermute

        if step > 0:
            self.kv = ppermute(self.kv, self.group, self.perm)
            self.unused.append(self.kv)
        k, v = self.kv.split(self.d, dim=-1)
        return k.contiguous(), v.contiguous()

    def used(self, step: int) -> None:
        if step > 0:
            self.unused.pop()

    def finish(self, out):
        if not self.unused or not torch.is_grad_enabled():
            return out
        dep = sum(kv.sum() for kv in self.unused) * 0.0
        return out + dep.to(out.dtype)


def _chunk_update(qg, k, v, kv_idx, m, l, o, *, my_idx, sl_q, causal,
                  scale, window=None):
    """One online-softmax accumulation step against a single K/V chunk
    (JAX :44). qg [B, Sq, Hkv, G, D]; m, l, o fp32 accumulators."""
    logits = torch.einsum("bqhgd,bkhd->bqhgk", qg, k).float() * scale
    if causal or window is not None:
        sk = k.shape[1]
        q_pos = my_idx * sl_q + torch.arange(sl_q, device=qg.device)
        k_pos = kv_idx * sk + torch.arange(sk, device=qg.device)
        diff = q_pos[:, None] - k_pos[None, :]
        mask = diff >= 0 if causal else torch.ones_like(diff, dtype=bool)
        if window is not None:
            mask = mask & (diff < window)
        logits = torch.where(mask[None, :, None, None, :], logits,
                             torch.full((), NEG_INF, device=qg.device))
    m_new = torch.maximum(m, logits.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[..., None])
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bqhgk,bkhd->bqhgd", p.to(v.dtype), v)
    o_new = o * corr[..., None] + pv.float()
    return m_new, l_new, o_new


def _ring_attention_shard(q, k, v, *, group, my_idx: int, axis_size: int,
                          causal: bool, window: Optional[int] = None):
    """The einsum ring body (JAX :213); every update checkpointed."""
    B, Sl, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sl, Hkv, G, D)
    m = torch.full((B, Sl, Hkv, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Sl, Hkv, G), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, Sl, Hkv, G, D), dtype=torch.float32,
                    device=q.device)
    rotate = _Rotation(k, v, group, axis_size)
    for step in range(axis_size):
        k, v = rotate.step(step)
        kv_idx = (my_idx - step) % axis_size
        proc = True
        if causal and step > 0:
            proc = kv_idx < my_idx
            if window is not None:
                proc = proc and (my_idx - kv_idx) * Sl - (Sl - 1) < window
        if proc:
            rotate.used(step)
            m, l, o = checkpoint(
                _chunk_update, qg, k, v, kv_idx, m, l, o, my_idx=my_idx,
                sl_q=Sl, causal=causal, scale=scale, window=window,
                use_reentrant=False)
    out = o / l[..., None]
    return rotate.finish(out.to(q.dtype).reshape(B, Sl, Hq, D))


def _check_window(causal: bool, window: Optional[int]) -> None:
    if window is not None and not causal:
        raise ValueError(
            "windowed ring attention is causal-only: a non-causal window "
            "would need a symmetric |q_pos - k_pos| < window band neither "
            "path implements; drop the window or use causal=True"
        )


def ring_attention(q, k, v, mesh, *, causal: bool = True,
                   axis: str = "sequence", use_flash: bool = False,
                   block_q: int = 512, block_kv: int = 512,
                   window: Optional[int] = None) -> torch.Tensor:
    """Sequence-parallel attention over the mesh's `axis` group (JAX
    :276). q [B, Sl, Hq, D], k/v [B, Sl, Hkv, D] are this rank's chunk
    (rows [i * Sl, (i + 1) * Sl) of the sequence for sequence index i);
    returns its [B, Sl, Hq, D] rows. use_flash runs the kernel body where
    the local length is flash-eligible, else the einsum body."""
    _check_window(causal, window)
    n = mesh.shape[axis]
    group, idx = mesh.group(axis), mesh.coords[axis]
    Sl = q.shape[1]
    if use_flash and flash_eligible(Sl, q.shape[-1], block_q, block_kv):
        return _ring_attention_shard_flash(
            q, k, v, group=group, my_idx=idx, axis_size=n, causal=causal,
            block_q=min(block_q, Sl), block_kv=min(block_kv, Sl),
            window=window)
    return _ring_attention_shard(q, k, v, group=group, my_idx=idx,
                                 axis_size=n, causal=causal, window=window)


def virtual_ring_attention(q, k, v, n: int, *, causal: bool = True,
                           window: Optional[int] = None,
                           block_q: int = 512, block_kv: int = 512,
                           kinds: Optional[dict] = None,
                           return_lse: bool = False):
    """The flash ring of n ranks played in one process on the whole
    sequence (q [B, n * Sl, Hq, D]): for every (rank, ring step) the chunk
    rank (rank - step) % n would hold, through chunk_kind, ring_chunk and
    ring_merge as the ranks run them. `kinds` (a dict) counts the chunk
    kinds; return_lse adds the merged logsumexp [B, Hq, n * Sl] (fp32).
    Differentiable; the rotation itself is the only thing not
    exercised."""
    _check_window(causal, window)
    B, S, Hq, D = q.shape
    Sl = S // n
    qs, ks, vs = (t.split(Sl, dim=1) for t in (q, k, v))
    outs, lses = [], []
    for r in range(n):
        acc, den, m = ring_init(qs[r])
        for step in range(n):
            kind = chunk_kind(r, step, n, Sl, causal, window)
            if kinds is not None:
                kinds[kind] = kinds.get(kind, 0) + 1
            if kind == SKIP:
                continue
            j = (r - step) % n
            o_c, lse_c = ring_chunk(
                qs[r], ks[j], vs[j], kind,
                offset=(r - j) * Sl, causal=causal, window=window,
                block_q=min(block_q, Sl), block_kv=min(block_kv, Sl))
            acc, den, m = ring_merge(acc, den, m, o_c, lse_c)
        outs.append(ring_finish(acc, den, q.dtype))
        lses.append(m + torch.log(den))
    if return_lse:
        return torch.cat(outs, dim=1), torch.cat(lses, dim=2)
    return torch.cat(outs, dim=1)
