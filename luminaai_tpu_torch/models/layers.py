"""Core transformer layers (PyTorch counterpart of luminaai_tpu/models/layers.py).

The JAX model keeps fp32 parameters and casts them to the compute dtype at
each use. A trainable build (`trainable=True`, what the trainer builds)
does the same: fp32 parameters with gradients, cast at each use, so the
optimizer updates the real fp32 values. A serving build stores the
compute-dtype copies once, without gradients (the values are identical,
and the casts are then no-ops). Norm scales stay fp32 in both, as the JAX
RMSNorm applies them.

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
from luminaai_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_eligible,
)
from luminaai_tpu_torch.ops.ragged_paged_attention import (
    NEG_INF,
    LaneMeta,
    implied_page_size,
    paged_attention,
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
        gate, up = torch.chunk(x @ self.wi.to(self.dtype), 2, dim=-1)
        return (F.silu(gate) * up) @ self.wo.to(self.dtype)


class GQAttention(nn.Module):
    """Grouped-query attention with RoPE over a per-lane KV cache.

    Parameters: `wqkv` [H, (nq + 2 nkv) * d], the JAX layer's wq/wk/wv
    concatenated once (its fused projection), and `wo` [nq * d, H].

    Without a cache (training and evaluation) the layer attends over its
    own rows, causal, banded under config.attention_window: through the
    flash kernels where `flash_eligible` admits the shape and
    config.use_flash_attention is set (as the JAX layer decides), else
    through the plain einsum attention (the JAX `_xla_attention`).

    The cache paths are the two per-lane ones the serving slice runs, each
    selected by a [B] `cache_index` (lanes at their own offsets):
      S == 1: one decode row per lane at cache_index[b];
      S > 1:  rows at their absolute `positions`; padding rows (-1) are
              dropped by a boolean mask (the JAX layer scatters them into a
              dummy row C; torch would wrap an index of -1).
    Attention then reads the post-write cache through the ragged dispatch.
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

    def forward(
        self,
        x: torch.Tensor,
        *,
        positions: Optional[torch.Tensor] = None,
        kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        cache_index: Optional[torch.Tensor] = None,
        lane_meta: Optional[LaneMeta] = None,
    ):
        cfg = self.config
        B, S, H = x.shape
        n_q, n_kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim()
        if kv_cache is not None and (
            cache_index is None or cache_index.ndim != 1
        ):
            raise NotImplementedError(
                "the port's attention runs the per-lane cache paths only "
                "(a [B] cache_index) and the no-cache forward"
            )
        qkv = x @ self.wqkv.to(self.dtype)
        q = qkv[..., : n_q * d].reshape(B, S, n_q, d)
        k = qkv[..., n_q * d: (n_q + n_kv) * d].reshape(B, S, n_kv, d)
        v = qkv[..., (n_q + n_kv) * d:].reshape(B, S, n_kv, d)
        rope_ct = self.dtype if cfg.rope_dtype == "bf16" else torch.float32

        if kv_cache is None:
            cos, sin = self._rope_tables(max(cfg.seq_length, S), x.device)
            q = apply_rope(q, cos, sin, positions, compute_dtype=rope_ct)
            k = apply_rope(k, cos, sin, positions, compute_dtype=rope_ct)
            if cfg.use_flash_attention and flash_eligible(
                S, d, cfg.flash_block_q, cfg.flash_block_kv
            ):
                out = flash_attention(
                    q, k, v.contiguous(), causal=True,
                    block_q=cfg.flash_block_q, block_kv=cfg.flash_block_kv,
                    window=cfg.attention_window,
                )
            else:
                out = self._xla_attention(q, k, v)
            return out.reshape(B, S, n_q * d) @ self.wo.to(self.dtype), None

        ck, cv = kv_cache
        C = ck.shape[1]
        cos, sin = self._rope_tables(max(cfg.seq_length, S, C), x.device)
        q = apply_rope(q, cos, sin, positions, compute_dtype=rope_ct)
        k = apply_rope(k, cos, sin, positions, compute_dtype=rope_ct)

        lanes = torch.arange(B, device=x.device)
        if S > 1:
            if positions is None:
                raise ValueError(
                    "per-lane multi-row cache writes need explicit "
                    "positions (padding rows marked -1)"
                )
            live = positions >= 0
            rows = lanes[:, None].expand(B, S)[live]
            ck[rows, positions[live]] = k[live].to(ck.dtype)
            cv[rows, positions[live]] = v[live].to(cv.dtype)
        else:
            # One decode row per lane. XLA drops an out-of-range scatter
            # row, torch faults on it: the only lanes that can sit past the
            # last row are finished or free ones whose output is discarded,
            # so their write is clamped onto their own last row.
            at = cache_index.clamp(0, C - 1)
            ck[lanes, at] = k[:, 0].to(ck.dtype)
            cv[lanes, at] = v[:, 0].to(cv.dtype)

        backend = getattr(lane_meta, "backend", None) or "ragged"
        out = self._ragged_attention(
            q, ck, cv, lane_meta, cache_index, positions, backend
        )
        y = out.reshape(B, S, n_q * d) @ self.wo.to(self.dtype)
        return y, (ck, cv)

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
                page_size=implied_page_size(k.shape[1]),
            )
        return paged_attention(
            q, k, v, meta,
            backend=backend,
            positions=positions if Sq > 1 else None,
        )


class Embedder(nn.Module):
    """Token embedding with stable scaling (x * sqrt(hidden)) and the tied
    head (the JAX presets' tie_word_embeddings=True,
    use_stable_embedding=True; the other settings are not ported).

    The table is fp32. The head multiplies the table's compute-dtype
    values with fp32 accumulation and fp32 output, as the JAX head's
    preferred_element_type=float32 does (a bf16 GEMM would round the
    logits to bf16): an fp32 product of bf16 values. A serving build
    rounds the table to those values once (round_), so the lookup and the
    head use it as it is; a trainable build keeps the real fp32 values the
    optimizer updates and casts at each use, as the JAX model does.
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
        # sqrt(hidden) rounded to the compute dtype once, as the JAX
        # encode casts it before the multiply.
        self.scale = float(
            torch.tensor(float(config.hidden_size)).sqrt().to(dtype)
        )

    @torch.no_grad()
    def round_(self) -> None:
        """Round the fp32 table to compute-dtype values, the values the
        JAX model casts it to at each use (call after loading). A
        trainable build keeps its fp32 values: the optimizer updates
        them, and head() casts at each use."""
        if self.trainable:
            return
        self.embedding.copy_(self.embedding.to(self.dtype).float())

    def head(self) -> torch.Tensor:
        """The tied head [V, H]: the table's compute-dtype values, in fp32."""
        if self.trainable:
            return self.embedding.to(self.dtype).float()
        return self.embedding

    def encode(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embedding[tokens].to(self.dtype) * self.scale

    def decode(self, x: torch.Tensor) -> torch.Tensor:
        return x.float() @ self.head().t()


def init_std_out(std: float) -> float:
    """The JAX init's std for output projections (attention and FFN wo)."""
    return std / math.sqrt(2.0)
