"""Weights for the port: from a flax parameter tree, or a seeded random init.

`params_from_flax` maps the JAX model's per-layer tree (numpy leaves; the
caller runs `jax.device_get`, so the port never imports JAX) onto
LuminaTransformer's state_dict:

  embedder/embedding [V, H]              -> embedder.embedding (tied head)
  layer_i/attn_norm/scale, ffn_norm/scale -> layers.i.{attn,ffn}_norm.scale
  layer_i/attention/wq [H, nq, d],
    wk, wv [H, nkv, d]                   -> layers.i.attention.wqkv
                                            [H, (nq + 2 nkv) d]
  layer_i/attention/wo [nq, d, H]        -> layers.i.attention.wo [nq d, H]
  layer_i/ffn/wi [H, 2F], wo [F, H]      -> layers.i.ffn.wi, .wo
  layer_i/moe/router [H, E], wi [E, H, 2F],
    wo [E, F, H] (MoE layers)            -> layers.i.moe.router, .wi, .wo
  final_norm/scale                       -> final_norm.scale

`state_dict_to_flax` is the inverse map, dtype kept (the checkpoints name
every tensor by its flax path), and `flax_to_state_dict` maps such a flat
tree of tensors back without a cast.

`init_params` draws the same shapes from a seed with the JAX init's
standard deviations (init_std; init_std / sqrt(2) for the output
projections, experts' included; 0.02 for the router; ones for norm
scales). The draws are torch's, not JAX's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.models.layers import init_std_out
from luminaai_tpu_torch.models.moe import ROUTER_INIT_STD


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict of arrays -> {'a/b/c': array} (the npz layout the CLI's
    --weights reads)."""
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(flatten_tree(val, name + "/"))
        else:
            out[name] = np.asarray(val)
    return out


def params_from_flax(tree: Mapping[str, Any], config: Config) -> Dict[str, torch.Tensor]:
    """A flax parameter tree (nested dicts or flat 'a/b' keys of numpy
    arrays, unscanned layout) -> a CPU fp32 state_dict for
    LuminaTransformer; load_state_dict casts to the model's dtypes."""
    flat = flatten_tree(tree) if any(
        isinstance(v, Mapping) for v in tree.values()
    ) else {k: np.asarray(v) for k, v in tree.items()}
    if any(k.startswith("scan_") for k in flat):
        raise ValueError("scanned parameter trees are not supported; "
                         "unstack them first (unstack_params_from_scan)")
    if "embedder/lm_head" in flat:
        raise ValueError("untied LM heads are not ported (the JAX presets "
                         "tie the head to the embedding)")

    def t(name: str) -> torch.Tensor:
        if name not in flat:
            raise KeyError(f"missing parameter {name!r}")
        return torch.from_numpy(np.array(flat[name], dtype=np.float32))

    return _to_state_dict(t, config)


def flax_to_state_dict(
    flat: Mapping[str, torch.Tensor], config: Config
) -> Dict[str, torch.Tensor]:
    """A flat {flax path: tensor} tree (state_dict_to_flax's output) ->
    a state_dict, each tensor keeping its dtype and device."""

    def t(name: str) -> torch.Tensor:
        if name not in flat:
            raise KeyError(f"missing parameter {name!r}")
        return flat[name]

    return _to_state_dict(t, config)


def state_dict_to_flax(
    sd: Mapping[str, torch.Tensor], config: Config
) -> Dict[str, torch.Tensor]:
    """LuminaTransformer's state_dict (or any tensors keyed like it, the
    Adam moments too) -> {flax path: tensor} in the flax shapes, dtype
    kept: the fused wqkv splits into wq [H, nq, d], wk and wv [H, nkv,
    d], and wo reshapes to [nq, d, H]. Split tensors are views; callers
    that store them make them contiguous."""
    H, d = config.hidden_size, config.head_dim()
    n_q, n_kv = config.num_heads, config.num_kv_heads
    out: Dict[str, torch.Tensor] = {
        "embedder/embedding": sd["embedder.embedding"],
        "final_norm/scale": sd["final_norm.scale"],
    }
    for i in range(config.num_layers):
        p, q = f"layer_{i}/", f"layers.{i}."
        out[p + "attn_norm/scale"] = sd[q + "attn_norm.scale"]
        out[p + "ffn_norm/scale"] = sd[q + "ffn_norm.scale"]
        wq, wk, wv = sd[q + "attention.wqkv"].split(
            [n_q * d, n_kv * d, n_kv * d], dim=1)
        out[p + "attention/wq"] = wq.reshape(H, n_q, d)
        out[p + "attention/wk"] = wk.reshape(H, n_kv, d)
        out[p + "attention/wv"] = wv.reshape(H, n_kv, d)
        out[p + "attention/wo"] = sd[q + "attention.wo"].reshape(n_q, d, H)
        if config.is_moe_layer(i):
            for name in ("router", "wi", "wo"):
                out[p + "moe/" + name] = sd[q + "moe." + name]
        else:
            out[p + "ffn/wi"] = sd[q + "ffn.wi"]
            out[p + "ffn/wo"] = sd[q + "ffn.wo"]
    return out


def _to_state_dict(t: Callable[[str], torch.Tensor],
                   config: Config) -> Dict[str, torch.Tensor]:
    H, d = config.hidden_size, config.head_dim()
    n_q, n_kv = config.num_heads, config.num_kv_heads
    sd: Dict[str, torch.Tensor] = {
        "embedder.embedding": t("embedder/embedding"),
        "final_norm.scale": t("final_norm/scale"),
    }
    for i in range(config.num_layers):
        p, q = f"layer_{i}/", f"layers.{i}."
        sd[q + "attn_norm.scale"] = t(p + "attn_norm/scale")
        sd[q + "ffn_norm.scale"] = t(p + "ffn_norm/scale")
        sd[q + "attention.wqkv"] = torch.cat(
            [
                t(p + "attention/wq").reshape(H, n_q * d),
                t(p + "attention/wk").reshape(H, n_kv * d),
                t(p + "attention/wv").reshape(H, n_kv * d),
            ],
            dim=1,
        )
        sd[q + "attention.wo"] = t(p + "attention/wo").reshape(n_q * d, H)
        if config.is_moe_layer(i):
            for name in ("router", "wi", "wo"):
                sd[q + "moe." + name] = t(p + "moe/" + name)
        else:
            sd[q + "ffn.wi"] = t(p + "ffn/wi")
            sd[q + "ffn.wo"] = t(p + "ffn/wo")
    return sd


@torch.no_grad()
def init_params(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Fill the model's weights in place from `seed`, drawn on the model's
    device (a b1-width model draws 0.8G values) and cast to each weight's
    dtype. Returns the model."""
    cfg: Config = model.config
    std, std_out = cfg.init_std, init_std_out(cfg.init_std)
    gen = torch.Generator(device=model.device).manual_seed(int(seed))
    for name, p in model.named_parameters():
        if name.endswith("norm.scale"):
            p.fill_(1.0)
            continue
        s = std_out if name.endswith(".wo") else std
        if name.endswith("moe.router"):
            s = ROUTER_INIT_STD
        draw = torch.randn(
            p.shape, generator=gen, device=p.device, dtype=torch.float32
        )
        p.copy_(draw.mul_(s))
    model.embedder.round_()
    return model
