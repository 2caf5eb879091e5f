"""Core transformer layers (PyTorch counterpart of luminaai_tpu/models/layers.py).

The JAX model keeps fp32 parameters and casts them to the compute dtype at
each use. A trainable build (`trainable=True`, what the trainer builds)
does the same: fp32 parameters with gradients, cast at each use, so the
optimizer updates the real fp32 values. A serving build stores the
compute-dtype copies once, without gradients (the values are identical,
and the casts are then no-ops). Norm scales stay fp32 in both, as the JAX
RMSNorm applies them.

Quantized serving (training/quantization.py) puts a QuantizedTensor
module in a weight's place; each call site then runs the int8 product of
ops/quantized.py, as the JAX layers switch on isinstance (SwiGLU wi/wo,
the attention projections, the embedding lookup and the head). A cache
side is a tensor, or with kv_cache_dtype='int8' a (codes int8, scales
fp32 [.., 1]) pair: fresh rows are quantized per row and kv head over
head_dim at insert (the JAX layer's quantize_act), and the attention
reads the pair (B5-int8 on the card).

KV caches are updated IN PLACE: the JAX layers return a functionally
updated cache, the port writes the rows into the caller's tensors (the
pool, or a view of one slot of it) and returns the same tensors, so a
decode step never copies the pool.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.monitoring.attribution import ATTENTION_SCOPE
from luminaai_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_eligible,
)
from luminaai_tpu_torch.ops.fused import vocab_parallel_lookup
from luminaai_tpu_torch.ops.quantized import (
    QuantizedTensor,
    embed_rows,
    int8_attend,
    project,
    quantize_act,
)
from luminaai_tpu_torch.ops.ragged_paged_attention import (
    NEG_INF,
    LaneMeta,
    cache_rows,
    dequantize_kv,
    implied_page_size,
    paged_attention,
)
from luminaai_tpu_torch.ops.ring_attention import ring_attention
from luminaai_tpu_torch.parallel.mesh import (
    active_mesh,
    copy_to,
    reduce_from,
)


class RMSNorm(nn.Module):
    """Root-mean-square norm with fp32 math, output in the compute dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.bfloat16,
                 device=None, trainable: bool = False):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device),
            requires_grad=trainable,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.eps)
        return (y * self.scale).to(self.dtype)


class LayerNorm(nn.Module):
    """Standard layer norm (the JAX `LayerNorm`): fp32 mean and variance,
    an fp32 scale and, with use_bias, an fp32 bias; output in the compute
    dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, use_bias: bool = True,
                 dtype=torch.bfloat16, device=None, trainable: bool = False):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device),
            requires_grad=trainable,
        )
        self.bias = nn.Parameter(
            torch.zeros(dim, dtype=torch.float32, device=device),
            requires_grad=trainable,
        ) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = torch.mean(x32, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x32 - mean), dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps) * self.scale
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.dtype)


def rope_frequencies(
    head_dim: int, max_len: int, theta: float = 10000.0, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 RoPE tables (cos, sin) of shape [max_len, head_dim // 2]."""
    inv_freq = 1.0 / (
        theta ** (
            torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
            / head_dim
        )
    )
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Rotate q/k, split-halves convention. x: [B, S, H, D]; positions:
    [B, S] (padding rows carry -1 and read the table's last row, as JAX's
    wrapped gather does; their K/V are never written)."""
    d2 = x.shape[-1] // 2
    ct = torch.float32 if compute_dtype is None else compute_dtype
    if positions is None:
        c = cos[None, : x.shape[1], None, :]
        s = sin[None, : x.shape[1], None, :]
    else:
        c = cos[positions][:, :, None, :]
        s = sin[positions][:, :, None, :]
    c, s = c.to(ct), s.to(ct)
    x1, x2 = x[..., :d2].to(ct), x[..., d2:].to(ct)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def _tensor_group():
    """The tensor group of the mesh the step runs under (None without
    tensor parallelism)."""
    mesh = active_mesh()
    if mesh is None or mesh.shape["tensor"] == 1:
        return None
    return mesh.group("tensor")


class SwiGLU(nn.Module):
    """down(silu(gate(x)) * up(x)) with the fused [hidden, 2F] gate+up."""

    def __init__(self, hidden: int, intermediate_size: int,
                 dtype=torch.bfloat16, device=None, trainable: bool = False):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=torch.float32 if trainable else dtype, device=device)
        self.wi = nn.Parameter(
            torch.empty(hidden, 2 * intermediate_size, **kw),
            requires_grad=trainable,
        )
        self.wo = nn.Parameter(
            torch.empty(intermediate_size, hidden, **kw),
            requires_grad=trainable,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tg = _tensor_group()
        # Tensor parallel (parallel/sharding.py): wi holds this rank's
        # gate and up columns, wo the matching rows; the partial outputs
        # sum over the tensor group (Megatron column-then-row).
        x = copy_to(x, tg)
        gate, up = torch.chunk(project(x, self.wi, self.dtype), 2, dim=-1)
        return reduce_from(project(F.silu(gate) * up, self.wo, self.dtype),
                           tg)


class QKVParts(nn.Module):
    """The fused projection's wq, wk and wv blocks ([H, n d] each) held
    apart, where quantization took some and not others (the JAX per-leaf
    min_size): each block runs its own product, in JAX's order."""

    def __init__(self, parts):
        super().__init__()
        for name, w in zip(("wq", "wk", "wv"), parts):
            if not isinstance(w, QuantizedTensor):
                w = nn.Parameter(w, requires_grad=False)
            setattr(self, name, w)

    def parts(self):
        return (self.wq, self.wk, self.wv)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        return torch.cat([project(x, w, dtype) for w in self.parts()],
                         dim=-1)


def _write_rows(cache, index, fresh: torch.Tensor) -> None:
    """cache[index] = fresh, in place; an int8 (codes, scales) side
    stores fresh quantized per row over head_dim."""
    if isinstance(cache, tuple):
        codes, scales = cache
        q8, s = quantize_act(fresh)
        codes[index] = q8
        scales[index] = s
    else:
        cache[index] = fresh.to(cache.dtype)


def _scatter_rows(cache, fresh: torch.Tensor, slots: torch.Tensor,
                  keep: torch.Tensor) -> None:
    """cache[b, slots[b, s]] = fresh[b, s] for the rows `keep` marks, in
    place, with no host sync. The JAX layer scatters a dropped row into a
    dummy row C; a boolean selection here would make the row count a
    host value. So a dropped row is sent to its lane's last kept row's
    slot with that row's value (duplicate writes of one value land the
    same in any order), and a lane with no kept row rewrites its row 0
    with its own content."""
    B, S = slots.shape
    rows = torch.arange(S, device=slots.device).expand(B, S)
    last = torch.where(keep, rows, -1).amax(dim=1, keepdim=True)
    has = last >= 0
    last = last.clamp(min=0)
    src = torch.where(keep, rows, last)
    target = torch.where(keep, slots,
                         torch.where(has, slots.gather(1, last), 0))
    lanes = torch.arange(B, device=slots.device)[:, None].expand(B, S)

    def put(t, vals):
        keep_of = has.reshape(B, 1, *([1] * (vals.dim() - 2)))
        t[lanes, target] = torch.where(keep_of, vals[lanes, src],
                                       t[:, :1]).to(t.dtype)

    if isinstance(cache, tuple):
        q8, s = quantize_act(fresh)
        put(cache[0], q8)
        put(cache[1], s)
    else:
        put(cache, fresh)


class GQAttention(nn.Module):
    """Grouped-query attention with RoPE, with or without a KV cache.

    Parameters: `wqkv` [H, (nq + 2 nkv) * d], the JAX layer's wq/wk/wv
    concatenated once (its fused projection), and `wo` [nq * d, H].

    Without a cache (training and evaluation) the layer attends over its
    own rows, causal, banded under config.attention_window: through the
    flash kernels where `flash_eligible` admits the shape and
    config.use_flash_attention is set (as the JAX layer decides), else
    through the plain einsum attention (the JAX `_xla_attention`).

    With a cache, `cache_index` is a scalar offset (a Python int or a
    0-dim tensor: one request, the JAX engine's form) or a [B] tensor
    (lanes at their own offsets: the slot pool, or with `rolling_lanes`
    the batched engine's own per-lane caches). Rows land at their
    `positions` (offset + row when None); a multi-row write drops rows
    marked -1. The cache ROLLS, as JAX decides (layers.py:328-332), when
    the window is set and the cache holds fewer rows than
    max(seq_length, S) (init_cache shrank it to the window), unless the
    offsets are per-lane pool offsets (`rolling_lanes` False): the pool
    never wraps. Then a decode row goes to slot pos % C, a multi-row
    write keeps each lane's last C live rows and leaves untouched slots
    as they are, a prefill (S > 1 without multi_row_update) attends its
    raw rows (the banded no-cache forward: flash where eligible), and
    decode and a multi-row verify (multi_row_update) read the cache
    through the slot mask. Otherwise attention reads the post-write
    cache through the ragged dispatch (the decode kernel for one row).
    """

    def __init__(self, config: Config, dtype=torch.bfloat16, device=None,
                 trainable: bool = False):
        super().__init__()
        self.config = config
        self.dtype = dtype
        H, d = config.hidden_size, config.head_dim()
        n_q, n_kv = config.num_heads, config.num_kv_heads
        kw = dict(dtype=torch.float32 if trainable else dtype, device=device)
        self.wqkv = nn.Parameter(
            torch.empty(H, (n_q + 2 * n_kv) * d, **kw),
            requires_grad=trainable,
        )
        self.wo = nn.Parameter(torch.empty(n_q * d, H, **kw),
                               requires_grad=trainable)
        self._rope = None  # (max_len, cos, sin), built on first use

    def _rope_tables(self, max_len: int, device):
        if self._rope is None or self._rope[0] < max_len or (
            self._rope[1].device != device
        ):
            cfg = self.config
            cos, sin = rope_frequencies(
                cfg.head_dim(), max_len, cfg.rope_theta, device=device
            )
            self._rope = (max_len, cos, sin)
        return self._rope[1], self._rope[2]

    def forward(self, x: torch.Tensor, **kwargs):
        """`_attend` inside the profiler scope `attention` (what
        monitoring/attribution.py attributes to attn_proj_rope)."""
        with torch.profiler.record_function(ATTENTION_SCOPE):
            return self._attend(x, **kwargs)

    def _attend(
        self,
        x: torch.Tensor,
        *,
        positions: Optional[torch.Tensor] = None,
        kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        cache_index=None,
        lane_meta: Optional[LaneMeta] = None,
        multi_row_update: bool = False,
        rolling_lanes: bool = False,
    ):
        cfg = self.config
        B, S, H = x.shape
        n_q, n_kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim()
        if kv_cache is not None and cache_index is None:
            raise ValueError("a cache forward needs a cache_index")
        mesh = active_mesh() if kv_cache is None else None
        tg = None
        if mesh is not None and mesh.shape["tensor"] > 1:
            # Tensor parallel (parallel/sharding.py): wqkv holds this
            # rank's q heads and its kv heads (all of them where the kv
            # heads do not divide over the ranks, whose partial gradients
            # then sum over the group), wo the matching rows.
            tp, tg = mesh.shape["tensor"], mesh.group("tensor")
            n_q = n_q // tp
            w = self.wqkv
            if n_kv % tp:
                w = torch.cat([w[:, : n_q * d],
                               copy_to(w[:, n_q * d:], tg)], dim=1)
            else:
                n_kv = n_kv // tp
            qkv = project(copy_to(x, tg), w, self.dtype)
        elif isinstance(self.wqkv, QKVParts):
            qkv = self.wqkv(x, self.dtype)
        else:
            qkv = project(x, self.wqkv, self.dtype)
        q = qkv[..., : n_q * d].reshape(B, S, n_q, d)
        k = qkv[..., n_q * d: (n_q + n_kv) * d].reshape(B, S, n_kv, d)
        v = qkv[..., (n_q + n_kv) * d:].reshape(B, S, n_kv, d)
        if tg is not None and n_kv == cfg.num_kv_heads and n_q < (
                cfg.num_heads):
            # Whole kv heads: keep those this rank's q heads read.
            grp = cfg.num_heads // cfg.num_kv_heads
            q0 = mesh.coords["tensor"] * n_q
            k = k[:, :, q0 // grp: -(-(q0 + n_q) // grp)]
            v = v[:, :, q0 // grp: -(-(q0 + n_q) // grp)]
        rope_ct = self.dtype if cfg.rope_dtype == "bf16" else torch.float32

        if kv_cache is None:
            sp = mesh.shape["sequence"] if mesh is not None else 1
            if sp > 1 and positions is None:
                # This rank's rows of the sequence rotate at their global
                # positions.
                i0 = mesh.coords["sequence"] * S
                positions = torch.arange(i0, i0 + S,
                                         device=x.device).expand(B, S)
            cos, sin = self._rope_tables(max(cfg.seq_length, S * sp),
                                         x.device)
            q = apply_rope(q, cos, sin, positions, compute_dtype=rope_ct)
            k = apply_rope(k, cos, sin, positions, compute_dtype=rope_ct)
            if sp > 1 and cfg.use_ring_attention:
                out = ring_attention(
                    q, k, v.contiguous(), mesh, causal=True,
                    use_flash=cfg.use_flash_attention,
                    block_q=cfg.flash_block_q, block_kv=cfg.flash_block_kv,
                    window=cfg.attention_window,
                )
            elif cfg.use_flash_attention and flash_eligible(
                S, d, cfg.flash_block_q, cfg.flash_block_kv
            ):
                out = flash_attention(
                    q, k, v.contiguous(), causal=True,
                    block_q=cfg.flash_block_q, block_kv=cfg.flash_block_kv,
                    window=cfg.attention_window,
                )
            else:
                out = self._xla_attention(q, k, v)
            return reduce_from(project(out.reshape(B, S, n_q * d), self.wo,
                                       self.dtype), tg), None

        ck, cv = kv_cache
        C = cache_rows(ck)
        cos, sin = self._rope_tables(max(cfg.seq_length, S, C), x.device)
        q = apply_rope(q, cos, sin, positions, compute_dtype=rope_ct)
        k = apply_rope(k, cos, sin, positions, compute_dtype=rope_ct)

        per_lane = torch.is_tensor(cache_index) and cache_index.ndim == 1
        if per_lane:
            offsets = cache_index
        elif torch.is_tensor(cache_index):
            offsets = cache_index.to(x.device).reshape(1).expand(B)
        else:
            offsets = torch.full((B,), int(cache_index), device=x.device)
        w = cfg.attention_window
        rolling = (w is not None and C < max(cfg.seq_length, S)
                   and (rolling_lanes or not per_lane))
        lanes = torch.arange(B, device=x.device)
        if S > 1:
            if per_lane and positions is None:
                raise ValueError(
                    "per-lane multi-row cache writes need explicit "
                    "positions (padding rows marked -1)")
            pos = (positions if positions is not None else
                   offsets[:, None] + torch.arange(S, device=x.device))
            keep = pos >= 0
            slots = pos
            if rolling:
                # Only the last C live rows of this write can coexist.
                length = keep.sum(dim=1, keepdim=True)
                keep = keep & (pos >= length - C)
                slots = torch.remainder(pos, C)
            _scatter_rows(ck, k, slots, keep)
            _scatter_rows(cv, v, slots, keep)
        else:
            pos = (positions if positions is not None
                   else offsets[:, None])
            # One decode row per lane. XLA drops an out-of-range scatter
            # row, torch faults on it: the only lanes that can sit past the
            # last row are finished or free ones whose output is discarded,
            # so their write is clamped onto their own last row.
            index = (lanes, torch.remainder(offsets, C) if rolling
                     else offsets.clamp(0, C - 1))
            _write_rows(ck, index, k[:, 0])
            _write_rows(cv, index, v[:, 0])

        if rolling and S > 1 and multi_row_update and S - 1 > C - w:
            # Row j's band must survive rows j+1.. landing in later slots.
            raise ValueError(
                f"rolling-cache multi-row update of {S} rows needs cache "
                f"slack >= {S - 1} (cache {C} slots, window {w}); reduce "
                "draft_k or use a non-multiple-of-128 window")
        if rolling and S > 1 and not multi_row_update:
            # Rolling prefill attends its raw rows (early prompt rows may
            # have left the cache): the banded no-cache forward.
            if cfg.use_flash_attention and flash_eligible(
                S, d, cfg.flash_block_q, cfg.flash_block_kv
            ):
                out = flash_attention(
                    q, k, v.contiguous(), causal=True,
                    block_q=cfg.flash_block_q, block_kv=cfg.flash_block_kv,
                    window=w,
                )
            else:
                out = self._xla_attention(q, k, v)
        elif rolling:
            out = self._slot_attention(q, ck, cv, pos)
        else:
            backend = getattr(lane_meta, "backend", None) or "ragged"
            out = self._ragged_attention(
                q, ck, cv, lane_meta, offsets, positions, backend)
        y = project(out.reshape(B, S, n_q * d), self.wo, self.dtype)
        return y, (ck, cv)

    def _slot_attention(self, q, k, v, q_pos):
        """Attention over a rolling cache of C slots (the JAX
        `_xla_attention`'s rolling branch, plain PyTorch as JAX leaves it
        to XLA): slot s holds the freshest position of its residue class,
        and back = (q_pos - s) mod C admits it where back <= q_pos (a
        position >= 0: causal) and back < window (the band). q_pos:
        [B, Sq] absolute positions."""
        if isinstance(k, tuple):
            k, v = dequantize_kv(k, q.dtype), dequantize_kv(v, q.dtype)
        B, Sq, n_q, d = q.shape
        C, n_kv = k.shape[1], k.shape[2]
        qg = q.reshape(B, Sq, n_kv, n_q // n_kv, d)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * (
            1.0 / math.sqrt(d))
        qp = q_pos[:, :, None]
        back = torch.remainder(qp - torch.arange(C, device=q.device), C)
        mask = (back <= qp) & (back < self.config.attention_window)
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
        return out.reshape(B, Sq, n_q, d)

    def _xla_attention(self, q, k, v):
        """Plain no-cache attention (the JAX layer's `_xla_attention`
        without a cache): grouped einsums in the compute dtype, fp32
        softmax over the causal (banded) mask, probabilities cast back."""
        B, Sq, n_q, d = q.shape
        Skv, n_kv = k.shape[1], k.shape[2]
        qg = q.reshape(B, Sq, n_kv, n_q // n_kv, d)
        scale = 1.0 / math.sqrt(d)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * scale
        q_pos = torch.arange(Sq, device=q.device)[:, None]
        k_pos = torch.arange(Skv, device=q.device)[None, :]
        mask = q_pos >= k_pos
        w = self.config.attention_window
        if w is not None:
            mask = mask & (q_pos - k_pos < w)
        logits = torch.where(mask, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
        return out.reshape(B, Sq, n_q, d)

    def _ragged_attention(self, q, k, v, meta, cache_index, positions,
                          backend):
        """Callers on the slot-paged pool pass a LaneMeta with the pool's
        page table and resident extent; everyone else gets one derived
        here (identity pages, lengths from positions / cache_index, full
        extent)."""
        B, Sq = q.shape[0], q.shape[1]
        if meta is not None and meta.lengths is None:
            meta = None  # backend hint only; derive everything below
        if meta is None:
            if positions is not None:
                lengths = positions.max(dim=1).values.to(torch.int32) + 1
            else:
                lengths = cache_index.to(torch.int32) + Sq
            meta = LaneMeta(
                lengths=lengths,
                window=self.config.attention_window,
                page_size=implied_page_size(cache_rows(k)),
            )
        return paged_attention(
            q, k, v, meta,
            backend=backend,
            positions=positions if Sq > 1 else None,
        )


class Embedder(nn.Module):
    """Token embedding, scaled by sqrt(hidden) under
    config.use_stable_embedding, and the LM head: the embedding itself
    (config.tie_word_embeddings, the JAX presets' setting) or a separate
    `lm_head` [V, H] (the JAX Embedder's untied head).

    The tables are fp32. The head multiplies the table's compute-dtype
    values with fp32 accumulation and fp32 output, as the JAX head's
    preferred_element_type=float32 does (a bf16 GEMM would round the
    logits to bf16): an fp32 product of bf16 values. A serving build
    rounds the tables to those values once (round_), so the lookup and the
    head use them as they are; a trainable build keeps the real fp32
    values the optimizer updates and casts at each use, as the JAX model
    does.

    Under tensor parallelism the tables are cut by vocabulary
    (parallel/sharding.py): tensor rank t holds rows [t V/tp, (t+1) V/tp)
    of each. Under a mesh with such a cut (vocab_group), encode is the
    vocab-parallel lookup (ops/fused.py), head_weight / head are this
    rank's slice, and decode gives this rank's [.., V/tp] logits, which
    only the vocab-parallel CE reads.
    """

    def __init__(self, config: Config, dtype=torch.bfloat16, device=None,
                 trainable: bool = False):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.trainable = trainable
        shape = (config.vocab_size, config.hidden_size)
        self.embedding = nn.Parameter(
            torch.empty(shape, dtype=torch.float32, device=device),
            requires_grad=trainable,
        )
        if not config.tie_word_embeddings:
            self.lm_head = nn.Parameter(
                torch.empty(shape, dtype=torch.float32, device=device),
                requires_grad=trainable,
            )
        # sqrt(hidden) rounded to the compute dtype once, as the JAX
        # encode casts it before the multiply.
        self.scale = float(
            torch.tensor(float(config.hidden_size)).sqrt().to(dtype)
        ) if config.use_stable_embedding else None

    @torch.no_grad()
    def round_(self) -> None:
        """Round the fp32 tables to compute-dtype values, the values the
        JAX model casts them to at each use (call after loading). A
        trainable build keeps its fp32 values: the optimizer updates
        them, and head() casts at each use."""
        if self.trainable:
            return
        for name in ("embedding", "lm_head"):
            t = getattr(self, name, None)
            if isinstance(t, nn.Parameter):
                t.copy_(t.to(self.dtype).float())

    def head_weight(self) -> torch.Tensor:
        """The head's fp32 parameter [V, H] (this tensor rank's [V/tp, H]
        slice under a vocab cut): the embedding when tied, else lm_head
        (what the fused CE takes)."""
        if self.config.tie_word_embeddings:
            return self.embedding
        return self.lm_head

    def head(self) -> torch.Tensor:
        """The head [V, H] (or this rank's slice): its compute-dtype
        values, in fp32."""
        if self.trainable:
            return self.head_weight().to(self.dtype).float()
        return self.head_weight()

    def vocab_group(self):
        """The tensor group the tables are cut over by vocabulary under
        the active mesh (None: whole tables). A quantized table runs on
        no mesh, as in the JAX package."""
        tg = _tensor_group()
        if tg is None:
            return None
        if any(isinstance(t, QuantizedTensor)
               for t in (self.embedding, self.head_weight())):
            raise ValueError("a quantized embedding or head cannot run "
                             "under tensor parallelism")
        if self.embedding.shape[0] == self.config.vocab_size:
            return None
        return tg

    def encode(self, tokens: torch.Tensor) -> torch.Tensor:
        tg = self.vocab_group()
        if tg is not None:
            x = vocab_parallel_lookup(self.embedding, tokens, tg, self.dtype)
        elif isinstance(self.embedding, QuantizedTensor):
            x = embed_rows(self.embedding, tokens, self.dtype)
        else:
            x = self.embedding[tokens].to(self.dtype)
        return x * self.scale if self.scale is not None else x

    def decode(self, x: torch.Tensor) -> torch.Tensor:
        tg = self.vocab_group()
        if tg is not None:
            return copy_to(x.float(), tg) @ self.head().t()
        head = self.head_weight()
        if isinstance(head, QuantizedTensor):
            return int8_attend(x, head, torch.float32)
        return x.float() @ self.head().t()


def init_std_out(std: float) -> float:
    """The JAX init's std for output projections (attention and FFN wo)."""
    return std / math.sqrt(2.0)
