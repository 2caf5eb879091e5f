"""int8 weights and int8 products for serving (PyTorch counterpart of
luminaai_tpu/ops/quantized.py).

Weights carry static symmetric scales (fp32) reduced over the axes the
product contracts, so the scale factors out of the integer dot;
activations are quantized per row at each call. Each product is one
int8 x int8 -> int32 `torch._int_mm` per weight (the JAX package's XLA
`lax.dot_general` with preferred_element_type=int32), then `y * sx * sw`
in fp32, in the JAX order. Every step is exact or IEEE-rounded alike in
both frameworks (fp32 `amax / qmax`, a division, round-half-to-even,
clip), so codes, scales and products equal JAX's bitwise on the CPU.

Layout contracts (what training/quantization.quantize_for_serving makes;
a mismatch raises ValueError, as in the JAX package):
  int8_project   w [K, *O], contraction axis 0, scale [1, *O]
  int8_attend    w [V, K], contraction axis -1, scale [V, 1]
  int8_out_proj  w [A, B, H], contraction axes (0, 1), scale [1, 1, H]
  int8_expert    w [E, K, N], batch E, contraction axis 1, scale [E, 1, N]
  embed_rows     w [V, H] quantized over H, scale [V, 1]

`torch._int_mm` on the card (torch 2.11, CUDA 12.8; scripts/probe_int_mm.py)
takes an activation of more than 16 rows and K and N multiples of 8,
and runs 5-10x faster with the weight column-major (the transpose of a
contiguous [N, K]: cuBLASLt's TN form) than row-major, which it refuses
outright at some small shapes. So decode's few rows are padded with zero
rows (code 0) and the result sliced, and a model's weight codes take the
column-major layout once, where the model installs them (`mm_layout`).
On the CPU it takes any shape and layout and is exact.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# cuBLASLt's int8 GEMM (torch._int_mm on the card) takes more than this
# many activation rows.
_INT_MM_MIN_ROWS = 16


class QuantizedTensor(nn.Module):
    """Per-channel symmetric quantized weight: int8 codes `q` ([-127, 127]
    for 8 bits; two int4 nibbles a byte for 4 bits, packed along the
    quantization axis, odd lengths padded), fp32 `scale` shaped like the
    original with the quantized axes reduced to 1, and the static `bits`,
    normalised `axis` tuple and `orig_shape`.

    A module holding the two tensors as buffers, so it takes a weight's
    place in the model (`model.to(device)` moves it, its state_dict names
    `<weight>.q` and `<weight>.scale`). A dtype cast of the model leaves it
    as it is: its codes and scales keep their dtypes."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, bits: int,
                 axis: Sequence[int], orig_shape: Sequence[int]):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.bits = int(bits)
        self.axis = tuple(int(a) for a in axis)
        self.orig_shape = tuple(int(d) for d in orig_shape)

    def _apply(self, fn, recurse=True):
        # Device moves apply; dtype casts do not (int8 codes, fp32 scales).
        for name in ("q", "scale"):
            t = self._buffers[name]
            moved = fn(t)
            self._buffers[name] = (moved if moved.dtype == t.dtype
                                   else t.to(moved.device))
        return self

    def mm_layout(self) -> "QuantizedTensor":
        """Store the codes of a product's weight column-major (each
        [K, N] matrix the transpose of a contiguous [N, K]), the layout
        the card's int8 GEMM takes at full speed; same shape and values.
        An int8_project weight (axis 0 of [K, N]) or an expert stack
        (axis 1 of [E, K, N]); a table quantized over its last axis
        (embedding, head) is already K-contiguous as the head reads it."""
        q = self.q
        if self.bits == 8 and q.ndim == 2 and self.axis == (0,):
            self._buffers["q"] = q.t().contiguous().t()
        elif self.bits == 8 and q.ndim == 3 and self.axis == (1,):
            self._buffers["q"] = q.transpose(1, 2).contiguous().transpose(
                1, 2)
        return self

    @property
    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())

    def extra_repr(self) -> str:
        return (f"bits={self.bits}, axis={self.axis}, "
                f"orig_shape={self.orig_shape}")

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        if self.bits == 4:
            ax = self.axis[0]  # int4 is always single-axis
            packed = self.q.to(torch.int8)
            low = (packed << 4) >> 4  # sign-extended low nibble
            high = packed >> 4
            vals = torch.stack([low, high], dim=ax + 1)
            shape = list(self.q.shape)
            shape[ax] *= 2
            vals = vals.reshape(shape).narrow(ax, 0, self.orig_shape[ax])
        else:
            vals = self.q
        return (vals.to(torch.float32) * self.scale).to(dtype)


def quantize_array(w: torch.Tensor, bits: int = 8, axis=-1) -> QuantizedTensor:
    """Symmetric per-channel quantization, scales reduced over `axis` (an
    int or a tuple; several axes are int8-only). The JAX quantize_array."""
    if isinstance(axis, (tuple, list)):
        if bits == 4 and len(axis) != 1:
            raise ValueError("multi-axis quantization is int8-only")
        axis = tuple(a % w.ndim for a in axis)
    else:
        axis = (axis % w.ndim,)
    w32 = w.to(torch.float32)
    qmax = 127.0 if bits == 8 else 7.0
    amax = torch.amax(torch.abs(w32), dim=axis, keepdim=True)
    # A divisor tensor on amax's device: CUDA's true division multiplies
    # by the reciprocal of a Python-number divisor, one ulp off the
    # quotient the CPU (and JAX) computes.
    scale = torch.where(amax > 0, amax / amax.new_tensor(qmax),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / scale), -qmax, qmax).to(torch.int8)
    if bits == 4:
        ax = axis[0]
        if q.shape[ax] % 2:  # pad to an even length for nibble packing
            pad = [0, 0] * q.ndim
            pad[2 * (q.ndim - 1 - ax) + 1] = 1
            q = F.pad(q, pad)
        lohi = q.reshape(*q.shape[:ax], q.shape[ax] // 2, 2, *q.shape[ax + 1:])
        low = lohi.select(ax + 1, 0).to(torch.int32)
        high = lohi.select(ax + 1, 1).to(torch.int32)
        q = ((high << 4) | (low & 0xF)).to(torch.int8)
    return QuantizedTensor(q, scale, bits, axis, tuple(w.shape))


def quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-row int8 over the last axis -> (codes int8
    [..., K], scale fp32 [..., 1]). Zero rows get scale 1 and codes 0."""
    x32 = x.to(torch.float32)
    amax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    s = torch.where(amax > 0, amax / amax.new_tensor(127.0),
                    torch.ones_like(amax))  # true quotient (quantize_array)
    xq = torch.clamp(torch.round(x32 / s), -127, 127).to(torch.int8)
    return xq, s


def _check(qt: QuantizedTensor, contraction_axes) -> None:
    if qt.bits != 8:
        raise ValueError("int8 compute path needs 8-bit codes")
    want = tuple(a % qt.q.ndim for a in contraction_axes)
    got = tuple(a % qt.q.ndim for a in qt.axis)
    if got != want:
        raise ValueError(
            f"weight quantized over axes {got}, int8 kernel contracts "
            f"{want} — re-quantize with quantize_for_serving"
        )


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 a [M, K] @ int8 b [K, N] -> int32 [M, N], exact. On the card a
    decode-sized M is padded with zero rows up to cuBLASLt's minimum."""
    m = a.shape[0]
    if a.is_cuda and m <= _INT_MM_MIN_ROWS:
        a = F.pad(a, (0, 0, 0, 2 * _INT_MM_MIN_ROWS - m))
        return torch._int_mm(a, b)[:m]
    return torch._int_mm(a, b)


def int8_project(x: torch.Tensor, qt: QuantizedTensor, out_dtype
                 ) -> torch.Tensor:
    """x [..., K] . w [K, *O] -> [..., *O] with int32 accumulation."""
    _check(qt, (0,))
    xq, sx = quantize_act(x)
    out_dims = tuple(qt.q.shape[1:])
    y = int_mm(xq.reshape(-1, x.shape[-1]), qt.q.reshape(qt.q.shape[0], -1))
    y = y.reshape(*x.shape[:-1], *out_dims).to(torch.float32)
    sx = sx.reshape(sx.shape[:-1] + (1,) * len(out_dims))
    return (y * sx * qt.scale.reshape(out_dims)).to(out_dtype)


def int8_attend(x: torch.Tensor, qt: QuantizedTensor,
                out_dtype=torch.float32) -> torch.Tensor:
    """x [..., K] . w [V, K] -> [..., V] (the vocab head)."""
    _check(qt, (qt.q.ndim - 1,))
    xq, sx = quantize_act(x)
    y = int_mm(xq.reshape(-1, x.shape[-1]), qt.q.t())
    y = y.reshape(*x.shape[:-1], qt.q.shape[0]).to(torch.float32)
    return (y * sx * qt.scale.reshape(-1)).to(out_dtype)


def int8_out_proj(x: torch.Tensor, qt: QuantizedTensor, out_dtype
                  ) -> torch.Tensor:
    """x [..., A, B] . w [A, B, H] -> [..., H] (JAX's attention output
    projection over heads x head_dim; the port's fused [A B, H] layout
    takes int8_project)."""
    _check(qt, (0, 1))
    k = qt.q.shape[0] * qt.q.shape[1]
    xf = x.reshape(*x.shape[:-2], k)
    xq, sx = quantize_act(xf)
    y = int_mm(xq.reshape(-1, k), qt.q.reshape(k, qt.q.shape[-1]))
    y = y.reshape(*xf.shape[:-1], qt.q.shape[-1]).to(torch.float32)
    return (y * sx * qt.scale.reshape(-1)).to(out_dtype)


def int8_expert(x: torch.Tensor, qt: QuantizedTensor, out_dtype
                ) -> torch.Tensor:
    """x [E, ..., K] . w [E, K, N] -> [E, ..., N], one product an expert
    (torch has no batched int8 product)."""
    _check(qt, (1,))
    xq, sx = quantize_act(x)
    E, K = x.shape[0], x.shape[-1]
    xq2 = xq.reshape(E, -1, K)
    y = torch.stack([int_mm(xq2[e], qt.q[e]) for e in range(E)])
    mid = tuple(x.shape[1:-1])
    y = y.reshape(E, *mid, qt.q.shape[-1]).to(torch.float32)
    sw = qt.scale.reshape(qt.scale.shape[0], *([1] * len(mid)),
                          qt.scale.shape[-1])
    return (y * sx * sw).to(out_dtype)


def embed_rows(qt: QuantizedTensor, tokens: torch.Tensor, dtype
               ) -> torch.Tensor:
    """Rows of an int8 embedding table ([V, H], scale [V, 1]): only the
    gathered rows are dequantized."""
    _check(qt, (qt.q.ndim - 1,))
    rows = qt.q[tokens].to(torch.float32)
    s = qt.scale.reshape(-1)[tokens][..., None]
    return (rows * s).to(dtype)


def project(x: torch.Tensor, w, dtype) -> torch.Tensor:
    """x @ w in the compute dtype, or the int8 product where the weight
    is a QuantizedTensor (the JAX layers' isinstance switch)."""
    if isinstance(w, QuantizedTensor):
        return int8_project(x, w, dtype)
    return x @ w.to(dtype)
