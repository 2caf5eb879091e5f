"""Weight quantization for serving (port of luminaai_tpu/training/quantization.py).

Trees here are the JAX package's parameter trees in flat form: {flax
path 'layer_0/attention/wq': tensor or QuantizedTensor}, the leaves in the
JAX shapes (convert.state_dict_to_flax gives them from a model, so the
fused wqkv is quantized through its wq [H, nq, d], wk and wv [H, nkv, d]
leaves, each by its own size and role, exactly as JAX quantizes them).
Every function computes what its JAX namesake computes, leaf for leaf:

  - quantize_tree: storage-only, scales over axis -1 (per row and head
    over head_dim for wq/wk/wv), for eligible leaves (ndim >= 2, size >=
    min_size, never a `scale`, `bias` or `router`);
  - quantize_for_serving: int8 with scales over each weight's contraction
    axes by its role (`_serving_axis`), for the int8 products of
    ops/quantized.py;
  - export_quantized_tree / import_quantized_tree: {'path/q', 'path/scale'}
    tensors plus a manifest of the static fields (a checkpoint's form);
  - dequantize_tree, and QuantizationManager.prepare_serving_params: int8
    runs the compute path; int8 under scan_layers and int4 are storage
    only, dequantized once to the compute dtype.

`quantize_model` applies a manager to a built model in place, as the JAX
GenerationEngine applies it to its params: the model's weights in flax
form through the manager, then back into the model (QuantizedTensor
modules in the weights' places for int8 compute; the dequantized values
for the storage paths).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Tuple

import torch

from luminaai_tpu_torch.ops.quantized import QuantizedTensor, quantize_array

logger = logging.getLogger(__name__)

Tree = Dict[str, Any]


def _keys(path: str) -> Tuple[str, ...]:
    return tuple(path.split("/"))


def _nbytes(t) -> int:
    if isinstance(t, QuantizedTensor):
        return t.nbytes
    return t.numel() * t.element_size()


def _eligible(keys: Tuple[str, ...], leaf: torch.Tensor,
              min_size: int) -> bool:
    if leaf.ndim < 2 or leaf.numel() < min_size:
        return False
    # Norm scales, biases and routers stay full precision.
    return keys[-1] not in ("scale", "bias", "router")


def _info(bits, quantized, total, before, after, **extra) -> Dict[str, Any]:
    return {
        "bits": bits,
        **extra,
        "quantized_leaves": quantized,
        "total_leaves": total,
        "bytes_before": before,
        "bytes_after": after,
        "compression": before / max(after, 1),
    }


def quantize_tree(params: Mapping[str, Any], bits: int = 8,
                  min_size: int = 4096) -> Tuple[Tree, Dict[str, Any]]:
    """Storage-only quantization of the eligible leaves (scales over axis
    -1). Idempotent: QuantizedTensor leaves of the same width pass
    through; another width round-trips through bf16."""
    out: Tree = {}
    before = after = quantized = 0
    for path, leaf in params.items():
        if isinstance(leaf, QuantizedTensor):
            if leaf.bits == bits:
                before += leaf.nbytes
                after += leaf.nbytes
                quantized += 1
                out[path] = leaf
                continue
            leaf = leaf.dequantize(torch.bfloat16)
        before += _nbytes(leaf)
        if _eligible(_keys(path), leaf, min_size):
            qt = quantize_array(leaf, bits=bits, axis=-1)
            after += qt.nbytes
            quantized += 1
            out[path] = qt
        else:
            after += _nbytes(leaf)
            out[path] = leaf
    return out, _info(bits, quantized, len(params), before, after)


def _serving_axis(keys: Tuple[str, ...], ndim: int):
    """Contraction axes of the int8 compute path by the weight's role (the
    JAX layouts); None for leaves it does not handle."""
    name = keys[-1] if keys else ""
    if ndim < 2:
        return None
    if name in ("embedding", "lm_head"):
        return (ndim - 1,)  # [V, H] contract H
    if name in ("wq", "wk", "wv"):
        return (0,)  # [H, heads, d] contract H
    in_moe = any("moe" in k.lower() for k in keys)
    if name == "wi":
        return (1,) if ndim == 3 else (0,)  # experts [E, H, 2F] / [H, 2F]
    if name == "wo":
        if ndim == 3 and in_moe:
            return (1,)  # [E, F, H] contract F
        if ndim == 3:
            return (0, 1)  # attention [heads, d, H] contract heads x d
        return (0,)  # SwiGLU [F, H]
    return None


def quantize_for_serving(params: Mapping[str, Any], min_size: int = 4096
                         ) -> Tuple[Tree, Dict[str, Any]]:
    """int8 with scales over each weight's contraction axes. Leaves
    already in that layout pass through; other QuantizedTensor leaves
    (storage axis, int4) are re-quantized from bf16."""
    out: Tree = {}
    before = after = quantized = 0
    for path, leaf in params.items():
        keys = _keys(path)
        if isinstance(leaf, QuantizedTensor):
            expect = _serving_axis(keys, len(leaf.orig_shape))
            if leaf.bits == 8 and expect is not None and tuple(
                    a % len(leaf.orig_shape) for a in expect) == leaf.axis:
                before += leaf.nbytes
                after += leaf.nbytes
                quantized += 1
                out[path] = leaf
                continue
            leaf = leaf.dequantize(torch.bfloat16)
        before += _nbytes(leaf)
        axes = (_serving_axis(keys, leaf.ndim)
                if _eligible(keys, leaf, min_size) else None)
        if axes is not None:
            qt = quantize_array(leaf, bits=8, axis=axes)
            after += qt.nbytes
            quantized += 1
            out[path] = qt
        else:
            after += _nbytes(leaf)
            out[path] = leaf
    return out, _info(8, quantized, len(params), before, after,
                      mode="int8_compute")


def export_quantized_tree(qtree: Mapping[str, Any]
                          ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Serializable form: each QuantizedTensor leaf becomes 'path/q' and
    'path/scale' tensors (the JAX {'q', 'scale'} dict, flattened), with a
    manifest {path: {bits, axis, orig_shape}}."""
    manifest: Dict[str, Any] = {}
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in qtree.items():
        if isinstance(leaf, QuantizedTensor):
            manifest[path] = {"bits": leaf.bits, "axis": list(leaf.axis),
                              "orig_shape": list(leaf.orig_shape)}
            out[path + "/q"] = leaf.q
            out[path + "/scale"] = leaf.scale
        else:
            out[path] = leaf
    return out, manifest


def import_quantized_tree(plain: Mapping[str, Any],
                          manifest: Mapping[str, Any]) -> Tree:
    """Inverse of export_quantized_tree: QuantizedTensor leaves rebuilt
    from their 'path/q' and 'path/scale' tensors and the manifest."""
    out: Tree = {k: v for k, v in plain.items()
                 if k.rpartition("/")[0] not in manifest}
    for path, m in manifest.items():
        axis = m["axis"]
        out[path] = QuantizedTensor(
            plain[path + "/q"], plain[path + "/scale"], int(m["bits"]),
            # Older manifests stored a bare int for one axis.
            tuple(axis) if isinstance(axis, list) else (int(axis),),
            tuple(m["orig_shape"]))
    return out


def dequantize_tree(qparams: Mapping[str, Any], dtype=torch.bfloat16
                    ) -> Tree:
    """A plain tree from a quantized one."""
    return {k: v.dequantize(dtype) if isinstance(v, QuantizedTensor) else v
            for k, v in qparams.items()}


@dataclass
class QuantizationManager:
    """Config-driven quantization (the JAX QuantizationManager):
    quantization_method None | 'int8' | 'int4', quantization_bits kept
    consistent with the method."""

    config: Any
    is_quantized: bool = False
    quantization_info: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        self.method = getattr(self.config, "quantization_method", None)
        self.bits = getattr(self.config, "quantization_bits", 8)
        self._validate()

    def _validate(self) -> None:
        if self.method is None:
            return
        if self.method not in ("int8", "int4"):
            raise ValueError(
                f"Unsupported quantization_method: {self.method!r} "
                "(int8/int4 supported)")
        if self.bits not in (4, 8):
            raise ValueError(
                f"Unsupported quantization bits: {self.bits}. "
                "Only 4 and 8 bit supported.")
        if self.method == "int4" and self.bits == 8:
            self.bits = 4  # the method wins
        if self.method == "int8" and self.bits == 4:
            self.bits = 8

    @property
    def enabled(self) -> bool:
        return self.method is not None

    def quantize_for_inference(self, params: Mapping[str, Any]) -> Tree:
        """Storage-only quantization of a tree (the original untouched)."""
        if not self.enabled:
            return dict(params)
        qparams, info = quantize_tree(params, bits=self.bits)
        self.is_quantized = True
        self.quantization_info = info
        logger.info(
            "quantized %d/%d leaves to int%d: %.2fx compression "
            "(%.1f MB -> %.1f MB)", info["quantized_leaves"],
            info["total_leaves"], self.bits, info["compression"],
            info["bytes_before"] / 1e6, info["bytes_after"] / 1e6)
        return qparams

    def prepare_serving_params(self, params: Mapping[str, Any],
                               dtype=torch.bfloat16) -> Tree:
        """The tree as the engine serves it: int8 -> QuantizedTensor leaves
        in the compute layout; int8 under scan_layers and int4 ->
        storage-only, dequantized to `dtype`."""
        if not self.enabled:
            return dict(params)
        if self.bits == 8 and getattr(self.config, "scan_layers", False):
            logger.info("int8 compute path skipped for scan_layers tree "
                        "(storage-only quantization applied)")
        elif self.bits == 8:
            qparams, info = quantize_for_serving(params)
            self.is_quantized = True
            self.quantization_info = info
            logger.info(
                "int8 COMPUTE quantization: %d/%d leaves, %.2fx bytes "
                "(%.1f MB -> %.1f MB)", info["quantized_leaves"],
                info["total_leaves"], info["compression"],
                info["bytes_before"] / 1e6, info["bytes_after"] / 1e6)
            return qparams
        return dequantize_tree(self.quantize_for_inference(params), dtype)


@torch.no_grad()
def quantize_model(model, config) -> Dict[str, Any]:
    """Apply config's quantization to `model` in place (the JAX engine's
    prepare_serving_params on its params) and return the manager's
    quantization_info ({} when the config asks for none). Leaves already
    quantized (a loaded int8 export) go through the manager as JAX's
    do."""
    from luminaai_tpu_torch.convert import model_tree, state_dict_to_flax

    manager = QuantizationManager(config)
    if not manager.enabled:
        return {}
    # The tree in the config's layout: a scan_layers model quantizes its
    # stacked leaves (min_size sees their stacked size), as JAX's does.
    flat = state_dict_to_flax(model_tree(model), model.config,
                              scanned=bool(config.scan_layers))
    model.load_params_tree(
        manager.prepare_serving_params(flat, model.dtype))
    return manager.quantization_info
