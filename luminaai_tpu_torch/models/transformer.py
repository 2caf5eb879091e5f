"""Decoder-only transformer (PyTorch counterpart of luminaai_tpu/models/transformer.py).

Embedding, N pre-norm blocks (RMSNorm -> GQA attention with RoPE ->
residual; RMSNorm -> FFN -> residual), final norm, the head with fp32
logits. The FFN is the dense SwiGLU, the MoE layer where
config.is_moe_layer says, or, in a use_mod model, the SwiGLU wrapped in
mixture-of-depths routing (models/mod.py) on its dense layers (the
hybrid MoE+MoD model when use_moe is on too). The layer loop is the JAX
model's unscanned one (convert.py maps scanned trees onto it). The aux
losses and router metrics reduce over layers as the JAX `_reduce_metrics`
does.

Two forwards, as in the JAX model: over KV caches (serving; its
callers run it under torch.inference_mode(), and MoD layers run their
plain SwiGLU there, as the JAX decoder does) and without a cache
(training and evaluation), where config.gradient_checkpointing applies
the JAX remat policy (REMAT_POLICIES) with torch.utils.checkpoint.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from luminaai_tpu_torch.config import Config, resolve_device
from luminaai_tpu_torch.models.layers import (
    Embedder,
    GQAttention,
    QKVParts,
    RMSNorm,
    SwiGLU,
)
from luminaai_tpu_torch.models.mod import MoDRouter, apply_mod
from luminaai_tpu_torch.models.moe import MoELayer
# Importing the flash module registers torch.ops.lumina.flash_fwd.
from luminaai_tpu_torch.ops import flash_attention  # noqa: F401
from luminaai_tpu_torch.ops.quantized import QuantizedTensor
from luminaai_tpu_torch.ops.ragged_paged_attention import LaneMeta

# A side is a tensor, or an int8 (codes, scales) pair.
KVCache = Tuple[Any, Any]

_aten = torch.ops.aten
# The plain matrix products (what torch's matmul and einsum dispatch to):
# the JAX dots_saveable keeps dot_general outputs. B1 and B4a are not
# products there (Pallas calls), nor here.
_DOTS = {_aten.mm.default, _aten.bmm.default, _aten.addmm.default,
         _aten.baddbmm.default}


def _keep(ops):
    """A checkpoint context_fn that keeps the outputs of `ops` and
    recomputes the rest."""

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return lambda: create_selective_checkpoint_contexts(policy)


# The JAX REMAT_POLICIES (luminaai_tpu/models/transformer.py:28-49), each
# as (what is checkpointed, what a checkpoint keeps):
#   nothing_saveable  each block, nothing (the block recomputes);
#   save_outs         each branch (attention, FFN) on its own, so the
#                     block's two branch outputs are kept and the backward
#                     recomputes only the branch it differentiates;
#   save_attn         save_outs, and the attention branch keeps B1's
#                     (O, lse): B1 does not re-run in the backward;
#   dots_saveable     each block, keeping the plain matrix products;
#   full              nothing checkpointed (no recomputation).
REMAT_POLICIES = {
    "nothing_saveable": ("block", noop_context_fn),
    "save_outs": ("branch", noop_context_fn),
    "save_attn": ("branch", _keep({torch.ops.lumina.flash_fwd.default})),
    "dots_saveable": ("block", _keep(_DOTS)),
    "full": (None, noop_context_fn),
}


def _ckpt(fn, *args, context_fn=noop_context_fn, **kwargs):
    return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn,
                      **kwargs)


class TransformerBlock(nn.Module):
    """Pre-norm block; its FFN is the dense SwiGLU (`ffn`), the MoE layer
    (`moe`) where config.is_moe_layer(layer_idx), or, in a use_mod model,
    the SwiGLU behind a MoDRouter (`mod_router`) on the dense layers."""

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
            if config.use_mod:
                self.mod_router = MoDRouter(config, **kw)

    def attention_branch(self, x, positions=None):
        """attn(attn_norm(x)) without a cache (the JAX "attn_out")."""
        return self.attention(self.attn_norm(x), positions=positions)[0]

    def ffn_branch(self, x, routing=None, cached: bool = False):
        """(ffn(ffn_norm(x)) (the JAX "ffn_out"), metrics)."""
        y = self.ffn_norm(x)
        if hasattr(self, "moe"):
            return self.moe(y, routing)
        if hasattr(self, "mod_router") and not cached:
            return apply_mod(self.mod_router, self.ffn, y)
        return self.ffn(y), {}

    def forward(self, x, *, positions=None, kv_cache=None, cache_index=None,
                lane_meta=None, routing=None, remat: Optional[str] = None,
                multi_row_update: bool = False, rolling_lanes: bool = False):
        """-> (x, kv_cache, metrics); `routing` are the MoE layer's
        training-time draws (MoELayer.draw_routing). `remat` names a
        REMAT_POLICIES entry whose checkpoints sit inside the block
        (save_outs, save_attn): no-cache forward only."""
        if kv_cache is None:
            if remat is None:
                x = x + self.attention_branch(x, positions)
                y, metrics = self.ffn_branch(x, routing)
            else:
                context_fn = REMAT_POLICIES[remat][1]
                x = x + _ckpt(self.attention_branch, x, positions,
                              context_fn=context_fn)
                y, metrics = _ckpt(self.ffn_branch, x, routing)
            return x + y, None, metrics
        h, kv_cache = self.attention(
            self.attn_norm(x),
            positions=positions,
            kv_cache=kv_cache,
            cache_index=cache_index,
            lane_meta=lane_meta,
            multi_row_update=multi_row_update,
            rolling_lanes=rolling_lanes,
        )
        x = x + h
        y, metrics = self.ffn_branch(x, routing, cached=True)
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


def _draw_routing(moe: MoELayer, B: int, S: int, generator, device):
    """The layer's training-time draws. On a mesh they are drawn for the
    global batch (every rank the same numbers from the step's generator)
    and this rank keeps its rows, over the whole sequence (the MoE layer
    routes gathered sequences): a sharded step routes as the one-rank
    step does."""
    from luminaai_tpu_torch.parallel.mesh import active_mesh

    mesh = active_mesh()
    if mesh is None:
        return moe.draw_routing(B, S, generator, device)
    nb = mesh.axis_size("data", "fsdp")
    draws = moe.draw_routing(B * nb, S * mesh.shape["sequence"], generator,
                             device)
    if draws is not None and "noise" in draws:
        b0 = mesh.axis_index("data", "fsdp") * B
        draws["noise"] = draws["noise"][b0:b0 + B]
    return draws


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
        dtypes and devices. A QuantizedTensor entry (or a partly quantized
        wqkv's tuple of blocks) takes its weight's place; a tensor entry
        where a quantized weight sits puts a plain weight back."""
        plain = {}
        for name, val in state_dict.items():
            owner_name, _, attr = name.rpartition(".")
            owner = self.get_submodule(owner_name)
            if isinstance(val, torch.Tensor) and isinstance(
                    owner._parameters.get(attr), nn.Parameter):
                plain[name] = val
                continue
            if isinstance(val, QuantizedTensor):
                new = val.to(self.device).mm_layout()
            elif isinstance(val, tuple):
                new = QKVParts([
                    w.to(self.device).mm_layout()
                    if isinstance(w, QuantizedTensor)
                    else w.to(self.device, owner.dtype) for w in val])
            else:
                new = nn.Parameter(torch.empty(
                    val.shape, device=self.device,
                    dtype=torch.float32 if attr in ("embedding", "lm_head")
                    else owner.dtype), requires_grad=False)
            owner._parameters.pop(attr, None)
            owner._modules.pop(attr, None)
            setattr(owner, attr, new)
            if isinstance(new, nn.Parameter):
                plain[name] = val
            else:
                plain.update({f"{name}.{k}": t
                              for k, t in new.state_dict().items()})
        self.load_state_dict(plain)
        self.embedder.round_()
        return self

    def load_params_tree(self, flat) -> "LuminaTransformer":
        """load_params from a flat {flax path: tensor or QuantizedTensor}
        tree (convert.state_dict_to_flax's form)."""
        from luminaai_tpu_torch.convert import flax_to_state_dict

        return self.load_params(flax_to_state_dict(flat, self.config))

    def forward(
        self,
        input_ids: torch.Tensor,
        *,
        positions: Optional[torch.Tensor] = None,
        kv_caches: Optional[List[KVCache]] = None,
        cache_index=None,
        lane_meta: Optional[LaneMeta] = None,
        deterministic: bool = True,
        return_hidden: bool = False,
        generator: Optional[torch.Generator] = None,
        stage=None,
        prefix_embeds: Optional[torch.Tensor] = None,
        multi_row_update: bool = False,
        rolling_lanes: bool = False,
    ):
        """input_ids [B, S] -> with kv_caches: (fp32 logits [B, S, V],
        kv_caches), or (final-normed hidden [B, S, H], kv_caches) with
        return_hidden (the caller projects only the rows it needs with
        embedder.decode); the MoE layers route each batch row as its own
        group and their metrics are dropped, as the JAX decoder drops them.
        Without kv_caches: (logits or hidden, aux) as the JAX model returns
        them, aux = {"aux_loss": summed MoE losses, the MoE metrics}
        (reduce_metrics). `deterministic` is the JAX flag: False draws the
        MoE routing noise and expert dropout from `generator`. `stage`
        (parallel/pipeline.py) is one pipeline stage's work, called with
        the model and returned: through forward, so FSDP2's root hooks
        gather the embedding and final norm around it. `prefix_embeds`
        [B, P, H] (soft-prompt tuning, training/adapters.py; no-cache
        forward only) are virtual tokens put before the blocks, with the
        stable-embedding scale when config.use_stable_embedding; positions
        run over all S + P rows, the prefix rows are routed (and counted
        in the aux losses) like the others, and are stripped after the
        final norm, so the outputs cover the S real tokens (JAX
        transformer.py:255-336). `cache_index` is a scalar offset (one
        request) or [B] per-lane offsets; `multi_row_update` marks an S > 1
        call that writes mid-stream rows into an existing cache (the
        speculative verify) and `rolling_lanes` per-lane offsets into
        per-lane rolling caches (models/layers.py GQAttention)."""
        if stage is not None:
            return stage(self)
        if kv_caches is None:
            return self._forward_no_cache(input_ids, positions,
                                          return_hidden, deterministic,
                                          generator, prefix_embeds)
        if prefix_embeds is not None:
            raise ValueError("prefix_embeds apply to the no-cache forward")
        x = self.embedder.encode(input_ids)
        for layer, cache in zip(self.layers, kv_caches):
            x, _, _ = layer(
                x,
                positions=positions,
                kv_cache=cache,
                cache_index=cache_index,
                lane_meta=lane_meta,
                multi_row_update=multi_row_update,
                rolling_lanes=rolling_lanes,
            )
        x = self.final_norm(x)
        if return_hidden:
            return x, kv_caches
        return self.embedder.decode(x), kv_caches

    def _forward_no_cache(self, input_ids, positions, return_hidden,
                          deterministic, generator, prefix_embeds=None):
        x = self.embedder.encode(input_ids)
        n_prefix = 0
        if prefix_embeds is not None:
            # The prefix takes the real tokens' stable-embedding scale:
            # init_soft_prompt draws raw table rows.
            n_prefix = prefix_embeds.shape[1]
            prefix = prefix_embeds.to(x.dtype)
            if self.embedder.scale is not None:
                prefix = prefix * self.embedder.scale
            x = torch.cat([prefix, x], dim=1)
        B, S = x.shape[:2]
        # Random draws happen here, before the layers, so a recompute in
        # the backward routes as its forward did.
        routing = [None] * len(self.layers)
        if not deterministic:
            routing = [_draw_routing(layer.moe, B, S, generator, x.device)
                       if hasattr(layer, "moe") else None
                       for layer in self.layers]
        x, all_metrics = self.run_blocks(x, range(len(self.layers)), routing,
                                         positions)
        x = self.final_norm(x)
        if n_prefix:
            # The [B, P, V] logits would be computed only to be discarded.
            x = x[:, n_prefix:]
        aux = reduce_metrics(all_metrics, x.device)
        if return_hidden:
            return x, aux
        return self.embedder.decode(x), aux

    def run_blocks(self, x, indices, routing, positions=None):
        """x through the layers `indices` without a cache, under the
        config's remat policy when grad is enabled: (x, [each reporting
        layer's metrics]). `routing[i]` is layer i's draws (None: none).
        The whole model's forward and a pipeline stage's both run here."""
        cfg = self.config
        scope, context_fn = (None, None)
        if cfg.gradient_checkpointing and torch.is_grad_enabled():
            scope, context_fn = REMAT_POLICIES[cfg.remat_policy]
        all_metrics = []
        for i in indices:
            layer = self.layers[i]
            if scope == "block":
                x, _, metrics = _ckpt(layer, x, positions=positions,
                                      routing=routing[i],
                                      context_fn=context_fn)
            else:
                x, _, metrics = layer(
                    x, positions=positions, routing=routing[i],
                    remat=cfg.remat_policy if scope == "branch" else None)
            if metrics:
                all_metrics.append(metrics)
        return x, all_metrics

    def init_cache(self, batch_size: int, max_len: int,
                   kv_cache_dtype: Optional[str] = None,
                   rolling: bool = True) -> List[KVCache]:
        """Preallocated per-layer (k, v) caches [B, C, Hkv, D] (the JAX
        init_cache). C is max_len, but under attention_window with max_len
        <= seq_length the cache ROLLS: C = min(max_len, ceil(window / 128)
        * 128) slots, slot pos % C holding the freshest row of its residue
        class, so decode memory is O(window). rolling=False keeps the
        plain position-addressed layout, which the slot-paged pool uses
        (it never wraps). Each side is in the compute dtype, or with
        kv_cache_dtype 'int8' (None: the model config's; the engine passes
        its own, as in JAX) a pair of int8 codes (zeros) and fp32 per-row
        scales [.., 1] (ones)."""
        cfg = self.config
        choice = kv_cache_dtype or cfg.kv_cache_dtype
        rows = max_len
        w = cfg.attention_window
        if rolling and w is not None and max_len <= cfg.seq_length:
            rows = min(max_len, -(-w // 128) * 128)
        shape = (batch_size, rows, cfg.num_kv_heads, cfg.head_dim())

        def side():
            if choice == "int8":
                return (torch.zeros(shape, dtype=torch.int8,
                                    device=self.device),
                        torch.ones(shape[:-1] + (1,), dtype=torch.float32,
                                   device=self.device))
            return torch.zeros(shape, dtype=self.dtype, device=self.device)

        return [(side(), side()) for _ in range(cfg.num_layers)]
