"""Decoder-only transformer (PyTorch counterpart of luminaai_tpu/models/transformer.py).

Embedding, N pre-norm blocks (RMSNorm -> GQA attention with RoPE ->
residual; RMSNorm -> SwiGLU, or the MoE layer where config.is_moe_layer
says, -> residual), final norm, tied head with fp32 logits. The layer loop
is the JAX model's unscanned one. The MoE layers' aux losses and router
metrics reduce over layers as the JAX `_reduce_metrics` does. Mixture of
depths is not ported yet and is refused here.

Two forwards, as in the JAX model: over per-lane KV caches (serving; its
callers run it under torch.inference_mode()) and without a cache (training
and evaluation), where config.gradient_checkpointing with the
'nothing_saveable' policy recomputes each block in the backward
(torch.utils.checkpoint per block, the JAX nn.remat) and 'full' keeps every
activation.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from luminaai_tpu_torch.config import Config, resolve_device
from luminaai_tpu_torch.models.layers import (
    Embedder,
    GQAttention,
    RMSNorm,
    SwiGLU,
)
from luminaai_tpu_torch.models.moe import MoELayer
from luminaai_tpu_torch.ops.ragged_paged_attention import LaneMeta

KVCache = Tuple[torch.Tensor, torch.Tensor]

# The JAX REMAT_POLICIES the port runs: whether each block's forward is
# recomputed in the backward. The others (save_outs, save_attn,
# dots_saveable) are refused by the trainer (train_step.check_trainable).
REMAT_POLICIES = {"nothing_saveable": True, "full": False}


class TransformerBlock(nn.Module):
    """Pre-norm block; its FFN is the dense SwiGLU (`ffn`) or, where
    config.is_moe_layer(layer_idx), the MoE layer (`moe`)."""

    def __init__(self, config: Config, layer_idx: int, dtype, device=None,
                 trainable: bool = False):
        super().__init__()
        kw = dict(dtype=dtype, device=device, trainable=trainable)
        self.attn_norm = RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)
        self.attention = GQAttention(config, **kw)
        self.ffn_norm = RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)
        if config.is_moe_layer(layer_idx):
            self.moe = MoELayer(config, **kw)
        else:
            self.ffn = SwiGLU(config.hidden_size, config.intermediate_size,
                              **kw)

    def forward(self, x, *, positions=None, kv_cache=None, cache_index=None,
                lane_meta=None, routing=None):
        """-> (x, kv_cache, metrics); `routing` are the MoE layer's
        training-time draws (MoELayer.draw_routing)."""
        h, kv_cache = self.attention(
            self.attn_norm(x),
            positions=positions,
            kv_cache=kv_cache,
            cache_index=cache_index,
            lane_meta=lane_meta,
        )
        x = x + h
        y = self.ffn_norm(x)
        metrics: Dict[str, torch.Tensor] = {}
        if hasattr(self, "moe"):
            y, metrics = self.moe(y, routing)
        else:
            y = self.ffn(y)
        return x + y, kv_cache, metrics


def reduce_metrics(all_metrics: List[Dict[str, torch.Tensor]], device
                   ) -> Dict[str, torch.Tensor]:
    """The JAX `_reduce_metrics` over unscanned layers: `*_loss` keys are
    summed over layers and added into aux_loss; the others (router health)
    are averaged over the layers that report them."""
    out: Dict[str, torch.Tensor] = {
        "aux_loss": torch.zeros((), dtype=torch.float32, device=device)
    }
    keys = sorted(set().union(*all_metrics)) if all_metrics else []
    for key in keys:
        vals = [m[key] for m in all_metrics if key in m]
        if key.endswith("_loss"):
            out[key] = torch.stack(vals).sum()
            out["aux_loss"] = out["aux_loss"] + out[key]
        else:
            out[key] = torch.stack(vals).sum(0) / len(vals)
    return out


class LuminaTransformer(nn.Module):
    """Decoder-only LM over a per-lane KV cache.

    device=None means the card (raises where CUDA is absent); tests pass
    device='cpu'. Weights are created uninitialised: fill them with
    `load_params(convert.params_from_flax(...))` or convert.init_params.
    trainable=True builds the training model: fp32 parameters with
    gradients, cast to the compute dtype at each use (models/layers.py).
    """

    def __init__(self, config: Config, device=None, trainable: bool = False):
        super().__init__()
        if config.use_mod:
            raise NotImplementedError(
                "use_mod=True (mixture of depths, models/mod.py) is not "
                "ported yet (ROADMAP queue A)"
            )
        self.config = config
        self.device = resolve_device(device)
        self.dtype = config.compute_dtype()
        kw = dict(dtype=self.dtype, device=self.device, trainable=trainable)
        self.embedder = Embedder(config, **kw)
        self.layers = nn.ModuleList(
            TransformerBlock(config, i, **kw) for i in range(config.num_layers)
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

    def forward(
        self,
        input_ids: torch.Tensor,
        *,
        positions: Optional[torch.Tensor] = None,
        kv_caches: Optional[List[KVCache]] = None,
        cache_index: Optional[torch.Tensor] = None,
        lane_meta: Optional[LaneMeta] = None,
        deterministic: bool = True,
        return_hidden: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        """input_ids [B, S] -> with kv_caches: (fp32 logits [B, S, V],
        kv_caches), or (final-normed hidden [B, S, H], kv_caches) with
        return_hidden (the caller projects only the rows it needs with
        embedder.decode); the MoE layers route each batch row as its own
        group and their metrics are dropped, as the JAX decoder drops them.
        Without kv_caches: (logits or hidden, aux) as the JAX model returns
        them, aux = {"aux_loss": summed MoE losses, the MoE metrics}
        (reduce_metrics). `deterministic` is the JAX flag: False draws the
        MoE routing noise and expert dropout from `generator` (dropout > 0
        is refused by the trainer)."""
        if kv_caches is None:
            return self._forward_no_cache(input_ids, positions,
                                          return_hidden, deterministic,
                                          generator)
        x = self.embedder.encode(input_ids)
        for layer, cache in zip(self.layers, kv_caches):
            x, _, _ = layer(
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

    def _forward_no_cache(self, input_ids, positions, return_hidden,
                          deterministic, generator):
        cfg = self.config
        remat = (
            cfg.gradient_checkpointing
            and REMAT_POLICIES.get(cfg.remat_policy, False)
            and torch.is_grad_enabled()
        )
        B, S = input_ids.shape
        x = self.embedder.encode(input_ids)
        all_metrics = []
        for layer in self.layers:
            # Random draws happen here, outside the checkpointed block, so
            # its recompute in the backward routes as its forward did.
            routing = None
            if not deterministic and hasattr(layer, "moe"):
                routing = layer.moe.draw_routing(B, S, generator, x.device)
            if remat:
                x, _, metrics = checkpoint(
                    layer, x, positions=positions, routing=routing,
                    use_reentrant=False)
            else:
                x, _, metrics = layer(x, positions=positions,
                                      routing=routing)
            if metrics:
                all_metrics.append(metrics)
        x = self.final_norm(x)
        aux = reduce_metrics(all_metrics, x.device)
        if return_hidden:
            return x, aux
        return self.embedder.decode(x), aux

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
