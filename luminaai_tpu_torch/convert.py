"""Weights for the port: from a flax parameter tree, or a seeded random init.

`params_from_flax` maps the JAX model's tree (numpy leaves; the caller
runs `jax.device_get`, so the port never imports JAX) onto
LuminaTransformer's state_dict. A scanned tree (scan_layers: 'scan_s/
block_j/...' with a leading repetition axis, JAX scan_segments) is
unstacked to the per-layer one first (`unstack_scanned`, a copy of JAX
unstack_params_from_scan); the per-layer names map as

  embedder/embedding [V, H]              -> embedder.embedding
  embedder/lm_head [V, H] (untied head)  -> embedder.lm_head
  layer_i/attn_norm/scale, ffn_norm/scale -> layers.i.{attn,ffn}_norm.scale
  layer_i/attention/wq [H, nq, d],
    wk, wv [H, nkv, d]                   -> layers.i.attention.wqkv
                                            [H, (nq + 2 nkv) d]
  layer_i/attention/wo [nq, d, H]        -> layers.i.attention.wo [nq d, H]
  layer_i/ffn/wi [H, 2F], wo [F, H]      -> layers.i.ffn.wi, .wo
  layer_i/moe/router [H, E], wi [E, H, 2F],
    wo [E, F, H] (MoE layers)            -> layers.i.moe.router, .wi, .wo
  layer_i/mod_router/router [H, 1],
    bias [1] (MoD layers)                -> layers.i.mod_router.router, .bias
  final_norm/scale                       -> final_norm.scale

`state_dict_to_flax` is the inverse map, dtype kept (the checkpoints name
every tensor by its flax path), per-layer or, with scanned=True, in the
scanned layout; `flax_to_state_dict` maps either back without a cast.

Quantized weights (training/quantization.py) travel through the same
maps as QuantizedTensor leaves in the compute layouts: the fused wqkv
(codes [H, (nq + 2 nkv) d], one scale a column, contraction axis 0)
splits into JAX's wq, wk and wv over axis 0 and concatenates back; wo
(axis 0 of [nq d, H]) is JAX's axes (0, 1) of [nq, d, H]. Where JAX's
per-leaf min_size quantized only some of wq, wk and wv, the port keeps
the three blocks apart (a tuple; models/layers.QKVParts). `model_tree`
gives a model's weights with any QuantizedTensor in its place.

`layernorm_from_flax` / `layernorm_to_flax` map a JAX `LayerNorm`'s
tree ({scale [H], bias [H]}; no bias under use_bias=False) onto
models/layers.LayerNorm's state_dict and back. No JAX model uses a
LayerNorm, so the model maps above have no entry for one.

`init_params` draws the same shapes from a seed with the JAX init's
standard deviations (init_std, the untied head's too; init_std / sqrt(2)
for the output projections, experts' included; 0.02 for the MoE router,
0.01 for the MoD router; zeros for its bias; ones for norm scales). The
draws are torch's, not JAX's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.models.layers import init_std_out
from luminaai_tpu_torch.models.mod import MOD_ROUTER_INIT_STD
from luminaai_tpu_torch.models.moe import ROUTER_INIT_STD
from luminaai_tpu_torch.ops.quantized import QuantizedTensor


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


def scan_segments(config: Config) -> List[Tuple[int, Tuple[int, ...], int]]:
    """The JAX scan_segments (models/transformer.py): the layer stack as
    [(start_layer, unit_layer_offsets, count)], `count` repetitions of a
    unit of consecutive layers from start_layer. every_3rd/every_4th MoE
    patterns give one unit per period (the tail as count-1 segments);
    otherwise runs of equal layer kinds give units of one layer."""
    L = config.num_layers
    kinds = [config.is_moe_layer(i) for i in range(L)]
    segments: List[Tuple[int, Tuple[int, ...], int]] = []
    period = {"every_3rd": 3, "every_4th": 4}.get(
        config.moe_pattern if config.use_moe else "", 0)
    if period and L >= period:
        body = (L // period) * period
        segments.append((0, tuple(range(period)), L // period))
        for i in range(body, L):
            segments.append((i, (0,), 1))
        return segments
    i = 0
    while i < L:
        j = i
        while j < L and kinds[j] == kinds[i]:
            j += 1
        segments.append((i, (0,), j - i))
        i = j
    return segments


def _split_path(name: str):
    head, _, rest = name.partition("/")
    return head, rest


def unstack_scanned(flat: Mapping[str, Any], config: Config
                    ) -> Dict[str, Any]:
    """A flat scanned tree ('scan_s/block_j/...', leading repetition axis)
    -> the per-layer one ('layer_i/...'); other keys pass through. Leaves
    are indexed (numpy arrays or tensors alike; tensors come back as
    views). The JAX unstack_params_from_scan on a flat tree."""
    out = {k: v for k, v in flat.items() if not k.startswith("scan_")}
    for s, (start, offsets, count) in enumerate(scan_segments(config)):
        u = len(offsets)
        for name, v in flat.items():
            head, rest = _split_path(name)
            if head != f"scan_{s}":
                continue
            block, leaf = _split_path(rest)
            j = int(block[len("block_"):])
            for k in range(count):
                out[f"layer_{start + k * u + offsets[j]}/{leaf}"] = v[k]
    return out


def stack_scanned(flat: Mapping[str, torch.Tensor], config: Config
                  ) -> Dict[str, torch.Tensor]:
    """The inverse of unstack_scanned over tensors (the JAX
    stack_params_for_scan on a flat tree)."""
    out = {k: v for k, v in flat.items() if not k.startswith("layer_")}
    for s, (start, offsets, count) in enumerate(scan_segments(config)):
        u = len(offsets)
        for j, off in enumerate(offsets):
            prefix = f"layer_{start + off}/"
            for name in flat:
                if not name.startswith(prefix):
                    continue
                leaf = name[len(prefix):]
                out[f"scan_{s}/block_{j}/{leaf}"] = torch.stack([
                    flat[f"layer_{start + k * u + off}/{leaf}"]
                    for k in range(count)])
    return out


def params_from_flax(tree: Mapping[str, Any], config: Config,
                     manifest: Optional[Mapping[str, Any]] = None
                     ) -> Dict[str, Any]:
    """A flax parameter tree (nested dicts or flat 'a/b' keys of numpy
    arrays, per-layer or scanned layout) -> a CPU fp32 state_dict for
    LuminaTransformer; load_params casts to the model's dtypes. With the
    `manifest` of a JAX int8 export (export_quantized_tree: {'q', 'scale'}
    leaves), the quantized leaves arrive as QuantizedTensor entries (int8
    codes and fp32 scales as saved) in the port's fused layouts."""
    flat = flatten_tree(tree) if any(
        isinstance(v, Mapping) for v in tree.values()
    ) else {k: np.asarray(v) for k, v in tree.items()}
    if any(k.startswith("scan_") for k in flat):
        flat = unstack_scanned(flat, config)
    if manifest:
        from luminaai_tpu_torch.training.quantization import (
            import_quantized_tree,
        )

        quantized = {k.rpartition("/")[0] for k in flat
                     if k.rpartition("/")[0] in manifest}
        tensors = {
            k: torch.from_numpy(np.array(
                v, dtype=v.dtype if k.rpartition("/")[0] in quantized
                else np.float32))
            for k, v in flat.items()}
        leaves = import_quantized_tree(tensors, manifest)

        def t(name: str):
            if name not in leaves:
                raise KeyError(f"missing parameter {name!r}")
            return leaves[name]

        return _to_state_dict(t, config)

    def t(name: str) -> torch.Tensor:
        if name not in flat:
            raise KeyError(f"missing parameter {name!r}")
        return torch.from_numpy(np.array(flat[name], dtype=np.float32))

    return _to_state_dict(t, config)


def flax_to_state_dict(
    flat: Mapping[str, torch.Tensor], config: Config
) -> Dict[str, torch.Tensor]:
    """A flat {flax path: tensor} tree (state_dict_to_flax's output,
    either layout) -> a state_dict, each tensor keeping its dtype and
    device."""
    if any(k.startswith("scan_") for k in flat):
        flat = unstack_scanned(flat, config)

    def t(name: str) -> torch.Tensor:
        if name not in flat:
            raise KeyError(f"missing parameter {name!r}")
        return flat[name]

    return _to_state_dict(t, config)


def state_dict_to_flax(
    sd: Mapping[str, torch.Tensor], config: Config, scanned: bool = False
) -> Dict[str, torch.Tensor]:
    """LuminaTransformer's state_dict (or any tensors keyed like it, the
    Adam moments too) -> {flax path: tensor} in the flax shapes, dtype
    kept: the fused wqkv splits into wq [H, nq, d], wk and wv [H, nkv,
    d], and wo reshapes to [nq, d, H]. Split tensors are views; callers
    that store them make them contiguous. scanned=True gives the scanned
    layout (JAX scan_layers), stacked copies."""
    H, d = config.hidden_size, config.head_dim()
    n_q, n_kv = config.num_heads, config.num_kv_heads
    out: Dict[str, torch.Tensor] = {
        "embedder/embedding": sd["embedder.embedding"],
        "final_norm/scale": sd["final_norm.scale"],
    }
    if not config.tie_word_embeddings:
        out["embedder/lm_head"] = sd["embedder.lm_head"]
    for i in range(config.num_layers):
        p, q = f"layer_{i}/", f"layers.{i}."
        out[p + "attn_norm/scale"] = sd[q + "attn_norm.scale"]
        out[p + "ffn_norm/scale"] = sd[q + "ffn_norm.scale"]
        shapes = ((H, n_q, d), (H, n_kv, d), (H, n_kv, d))
        for name, w in zip(("wq", "wk", "wv"),
                           _split_qkv(sd[q + "attention.wqkv"], shapes)):
            out[p + "attention/" + name] = w
        out[p + "attention/wo"] = _reshape_wo(sd[q + "attention.wo"],
                                              (n_q, d, H))
        if config.is_moe_layer(i):
            for name in ("router", "wi", "wo"):
                out[p + "moe/" + name] = sd[q + "moe." + name]
        else:
            out[p + "ffn/wi"] = sd[q + "ffn.wi"]
            out[p + "ffn/wo"] = sd[q + "ffn.wo"]
            if config.use_mod:
                for name in ("router", "bias"):
                    out[p + "mod_router/" + name] = sd[
                        q + "mod_router." + name]
    return stack_scanned(out, config) if scanned else out


def layernorm_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX LayerNorm's {scale, bias} leaves -> LayerNorm's state_dict
    (fp32 copies)."""
    return {name: torch.tensor(np.asarray(tree[name]), dtype=torch.float32)
            for name in ("scale", "bias") if name in tree}


def layernorm_to_flax(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    """LayerNorm's parameters -> the JAX LayerNorm's tree."""
    return {name: p.detach().cpu().numpy()
            for name, p in module.named_parameters()}


def _qt(q, scale, axis, shape) -> QuantizedTensor:
    return QuantizedTensor(q, scale, 8, axis, shape)


def _check_compute(w: QuantizedTensor, axis, what: str) -> None:
    if w.bits != 8 or w.axis != axis:
        raise ValueError(
            f"{what}: int{w.bits} codes over axes {w.axis}, the int8 "
            f"products contract {axis} — re-quantize with "
            "quantize_for_serving")


def _split_qkv(w, shapes):
    """The fused wqkv (a tensor, an int8 QuantizedTensor over axis 0, or
    the three blocks of a partly quantized projection) -> wq, wk, wv in
    the JAX shapes."""
    sizes = [a * b for _, a, b in shapes]
    if isinstance(w, tuple):
        return [_split_qkv(part, [shape])[0]
                for part, shape in zip(w, shapes)]
    if isinstance(w, QuantizedTensor):
        _check_compute(w, (0,), "attention.wqkv")
        return [_qt(qq.reshape(shape), ss.reshape((1,) + shape[1:]), (0,),
                    shape)
                for qq, ss, shape in zip(w.q.split(sizes, 1),
                                         w.scale.split(sizes, 1), shapes)]
    return [part.reshape(shape)
            for part, shape in zip(w.split(sizes, dim=1), shapes)]


def _fuse_qkv(parts, H: int):
    """wq, wk, wv in the JAX shapes -> the port's fused wqkv: one tensor,
    one QuantizedTensor when all three are int8 over axis 0, else the
    three [H, n d] blocks as a tuple."""
    flat = []
    for w in parts:
        if isinstance(w, QuantizedTensor):
            _check_compute(w, (0,), "attention wq/wk/wv")
            n = w.q[0].numel()
            w = _qt(w.q.reshape(H, n), w.scale.reshape(1, n), (0,), (H, n))
        else:
            w = w.reshape(H, -1)
        flat.append(w)
    quantized = [isinstance(w, QuantizedTensor) for w in flat]
    if not any(quantized):
        return torch.cat(flat, dim=1)
    if not all(quantized):
        return tuple(flat)
    cols = sum(w.q.shape[1] for w in flat)
    return _qt(torch.cat([w.q for w in flat], 1),
               torch.cat([w.scale for w in flat], 1), (0,), (H, cols))


def _reshape_wo(w, shape):
    """The attention wo between [nq d, H] (port, axis 0) and [nq, d, H]
    (JAX, axes (0, 1))."""
    if not isinstance(w, QuantizedTensor):
        return w.reshape(shape)
    if len(shape) == 3:
        _check_compute(w, (0,), "attention.wo")
        return _qt(w.q.reshape(shape), w.scale.reshape(1, 1, shape[2]),
                   (0, 1), shape)
    _check_compute(w, (0, 1), "attention/wo")
    return _qt(w.q.reshape(shape), w.scale.reshape(1, shape[1]), (0,),
               shape)


def model_tree(model: torch.nn.Module) -> Dict[str, Any]:
    """A model's weights by state_dict name: each parameter, or the
    QuantizedTensor (or partly quantized QKVParts, as a tuple) installed
    in a weight's place."""
    from luminaai_tpu_torch.models.layers import QKVParts

    out: Dict[str, Any] = {}
    held = []
    for name, mod in model.named_modules():
        if any(name.startswith(h + ".") for h in held):
            continue
        if isinstance(mod, QKVParts):
            out[name] = mod.parts()
            held.append(name)
        elif isinstance(mod, QuantizedTensor):
            out[name] = mod
    for name, p in model.named_parameters():
        if not any(name.startswith(h + ".") for h in held):
            out[name] = p
    return out


def _to_state_dict(t: Callable[[str], torch.Tensor],
                   config: Config) -> Dict[str, torch.Tensor]:
    H, d = config.hidden_size, config.head_dim()
    n_q, n_kv = config.num_heads, config.num_kv_heads
    sd: Dict[str, torch.Tensor] = {
        "embedder.embedding": t("embedder/embedding"),
        "final_norm.scale": t("final_norm/scale"),
    }
    if not config.tie_word_embeddings:
        sd["embedder.lm_head"] = t("embedder/lm_head")
    for i in range(config.num_layers):
        p, q = f"layer_{i}/", f"layers.{i}."
        sd[q + "attn_norm.scale"] = t(p + "attn_norm/scale")
        sd[q + "ffn_norm.scale"] = t(p + "ffn_norm/scale")
        sd[q + "attention.wqkv"] = _fuse_qkv(
            [t(p + "attention/" + name) for name in ("wq", "wk", "wv")], H)
        sd[q + "attention.wo"] = _reshape_wo(t(p + "attention/wo"),
                                             (n_q * d, H))
        if config.is_moe_layer(i):
            for name in ("router", "wi", "wo"):
                sd[q + "moe." + name] = t(p + "moe/" + name)
        else:
            sd[q + "ffn.wi"] = t(p + "ffn/wi")
            sd[q + "ffn.wo"] = t(p + "ffn/wo")
            if config.use_mod:
                for name in ("router", "bias"):
                    sd[q + "mod_router." + name] = t(
                        p + "mod_router/" + name)
    return sd


def init_std_of(name: str, config: Config) -> Optional[float]:
    """The std parameter `name` is drawn with at init (None: not drawn:
    norm scales are ones, the MoD bias zeros)."""
    if name.endswith("norm.scale") or name.endswith("mod_router.bias"):
        return None
    if name.endswith("moe.router"):
        return ROUTER_INIT_STD
    if name.endswith("mod_router.router"):
        return MOD_ROUTER_INIT_STD
    return init_std_out(config.init_std) if name.endswith(".wo") else (
        config.init_std)


def init_value(name: str, shape, config: Config, gen: torch.Generator,
               device) -> torch.Tensor:
    """Parameter `name`'s whole fp32 init value: the next draw of `gen`
    (init_params' order) scaled by its std, or its constant."""
    std = init_std_of(name, config)
    if std is None:
        fill = 1.0 if name.endswith("norm.scale") else 0.0
        return torch.full(shape, fill, dtype=torch.float32, device=device)
    draw = torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)
    return draw.mul_(std)


@torch.no_grad()
def init_params(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Fill the model's weights in place from `seed`, drawn on the model's
    device (a b1-width model draws 0.8G values) and cast to each weight's
    dtype. Returns the model. parallel/sharding.py draws the same values
    one parameter at a time and keeps each rank's slices (init_value)."""
    cfg: Config = model.config
    gen = torch.Generator(device=model.device).manual_seed(int(seed))
    for name, p in model.named_parameters():
        p.copy_(init_value(name, p.shape, cfg, gen, p.device))
    model.embedder.round_()
    return model
