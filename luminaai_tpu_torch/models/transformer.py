"""Decoder-only transformer (PyTorch counterpart of luminaai_tpu/models/transformer.py).

The dense model: embedding, N pre-norm blocks (RMSNorm -> GQA attention with
RoPE -> residual; RMSNorm -> SwiGLU -> residual), final norm, tied head with
fp32 logits. The layer loop is the JAX model's unscanned one. Mixture of
experts and mixture of depths are not ported yet and are refused here.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from luminaai_tpu_torch.config import Config, resolve_device
from luminaai_tpu_torch.models.layers import (
    Embedder,
    GQAttention,
    RMSNorm,
    SwiGLU,
)
from luminaai_tpu_torch.ops.ragged_paged_attention import LaneMeta

KVCache = Tuple[torch.Tensor, torch.Tensor]


class TransformerBlock(nn.Module):
    """Pre-norm block with a dense SwiGLU FFN."""

    def __init__(self, config: Config, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.attn_norm = RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)
        self.attention = GQAttention(config, **kw)
        self.ffn_norm = RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)
        self.ffn = SwiGLU(config.hidden_size, config.intermediate_size, **kw)

    def forward(self, x, *, positions, kv_cache, cache_index, lane_meta):
        h, kv_cache = self.attention(
            self.attn_norm(x),
            positions=positions,
            kv_cache=kv_cache,
            cache_index=cache_index,
            lane_meta=lane_meta,
        )
        x = x + h
        x = x + self.ffn(self.ffn_norm(x))
        return x, kv_cache


class LuminaTransformer(nn.Module):
    """Decoder-only LM over a per-lane KV cache.

    device=None means the card (raises where CUDA is absent); tests pass
    device='cpu'. Weights are created uninitialised: fill them with
    `load_params(convert.params_from_flax(...))` or convert.init_params.
    """

    def __init__(self, config: Config, device=None):
        super().__init__()
        if config.use_moe:
            raise NotImplementedError(
                "use_moe=True is not ported yet (models/moe.py is a later "
                "slice); serve the dense model with use_moe=False "
                "(CLI: --dense)"
            )
        self.config = config
        self.device = resolve_device(device)
        self.dtype = config.compute_dtype()
        kw = dict(dtype=self.dtype, device=self.device)
        self.embedder = Embedder(config, **kw)
        self.layers = nn.ModuleList(
            TransformerBlock(config, **kw) for _ in range(config.num_layers)
        )
        self.final_norm = RMSNorm(
            config.hidden_size, config.rms_norm_eps, **kw
        )

    def load_params(self, state_dict) -> "LuminaTransformer":
        """Load a state_dict (convert.params_from_flax) into the model's
        dtypes and devices."""
        self.load_state_dict(state_dict)
        self.embedder.round_()
        return self

    @torch.no_grad()
    def forward(
        self,
        input_ids: torch.Tensor,
        *,
        positions: Optional[torch.Tensor] = None,
        kv_caches: List[KVCache],
        cache_index: torch.Tensor,
        lane_meta: Optional[LaneMeta] = None,
        return_hidden: bool = False,
    ):
        """input_ids [B, S] -> (fp32 logits [B, S, V], kv_caches), or
        (final-normed hidden [B, S, H], kv_caches) with return_hidden (the
        caller projects only the rows it needs with embedder.decode)."""
        x = self.embedder.encode(input_ids)
        for layer, cache in zip(self.layers, kv_caches):
            x, _ = layer(
                x,
                positions=positions,
                kv_cache=cache,
                cache_index=cache_index,
                lane_meta=lane_meta,
            )
        x = self.final_norm(x)
        if return_hidden:
            return x, kv_caches
        return self.embedder.decode(x), kv_caches

    def init_cache(self, batch_size: int, max_len: int) -> List[KVCache]:
        """Preallocated per-layer (k, v) caches [B, max_len, Hkv, D] in the
        compute dtype: the plain position-addressed layout (the JAX
        init_cache with rolling=False), which is what the slot-paged pool
        uses."""
        cfg = self.config
        shape = (batch_size, max_len, cfg.num_kv_heads, cfg.head_dim())
        kw = dict(dtype=self.dtype, device=self.device)
        return [
            (torch.zeros(shape, **kw), torch.zeros(shape, **kw))
            for _ in range(cfg.num_layers)
        ]
