"""Grouped matrix multiplication for the MoE expert FFN (PyTorch + CUDA).

Counterpart of the megablox kernels the JAX package reaches through
luminaai_tpu/models/moe.py `_pick_gmm` (jax.experimental.pallas.ops.tpu.
megablox: `gmm`, gmm.py:314, and `tgmm`, gmm.py:573, with the custom VJP
of ops.py:28-107). Contract, as megablox's:

- `gmm(lhs [M, K], rhs [E, K, N], group_sizes [E])`: rows are grouped
  in order, group g owning the next group_sizes[g] rows, and
  out[rows of g] = lhs[rows of g] @ rhs[g] (rhs[g]^T, rhs [E, N, K], under
  transpose_rhs). Rows at or past sum(group_sizes) are written as zeros
  (megablox leaves them uninitialised; models/moe.py keeps the JAX
  `row_kept` masks all the same).
- `tgmm(lhsT [K, M], rhs [M, N], group_sizes [E])`: out[g] = lhsT[:, rows
  of g] @ rhs[rows of g] -> [E, K, N]; an empty group gives zeros.
- `GroupedMatmul`, the autograd.Function in place of megablox's custom VJP:
  grad_lhs = gmm(grad, rhs, transpose_rhs=not transpose_rhs) in lhs's
  dtype, grad_rhs = tgmm(lhs^T, grad) in rhs's dtype, transposed back under
  transpose_rhs.

group_sizes stays on the device: the kernels read it there (a host read
would synchronise every MoE layer of every decode step).

On a CPU tensor each wrapper runs its plain version (`gmm_ref`,
`tgmm_ref`: a loop over the groups' row slices in fp32, or wider for fp64
inputs, rounded to the output dtype; these read the group sizes on the
host). On a CUDA tensor it launches its kernel (csrc/gmm.cu) and counts
the launch in `<wrapper>.launches`, or raises on what the kernel does not
take: bf16 operands and output, K and N multiples of 8, contiguous rows.
It never falls back from the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path and oracle)
# ---------------------------------------------------------------------------
def _acc_dtype(*ts: torch.Tensor) -> torch.dtype:
    dt = torch.float32
    for t in ts:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def _bounds(group_sizes: torch.Tensor, m: int):
    """Host (start, end) row ranges of the groups, clipped to m rows."""
    start = 0
    for n in group_sizes.tolist():
        end = min(m, start + max(0, int(n)))
        yield start, end
        start = end


def gmm_ref(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
            out_dtype: Optional[torch.dtype] = None,
            transpose_rhs: bool = False) -> torch.Tensor:
    """The plain grouped matmul: per group, its row slice times rhs[g]
    (rhs[g]^T under transpose_rhs), accumulated in fp32 (fp64 for fp64
    inputs) and rounded to out_dtype; rows past sum(group_sizes) are 0."""
    out_dtype = out_dtype or lhs.dtype
    acc = _acc_dtype(lhs, rhs)
    m = lhs.shape[0]
    n = rhs.shape[1] if transpose_rhs else rhs.shape[2]
    out = torch.zeros(m, n, dtype=acc, device=lhs.device)
    for g, (start, end) in enumerate(_bounds(group_sizes, m)):
        if end > start:
            w = rhs[g].to(acc)
            out[start:end] = lhs[start:end].to(acc) @ (
                w.t() if transpose_rhs else w)
    return out.to(out_dtype)


def tgmm_ref(lhsT: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain transposed grouped matmul: out[g] = lhsT[:, rows of g] @
    rhs[rows of g] -> [E, K, N], fp32 (or wider) accumulation, rounded to
    out_dtype; empty groups are 0."""
    out_dtype = out_dtype or rhs.dtype
    acc = _acc_dtype(lhsT, rhs)
    k, m = lhsT.shape
    e = group_sizes.shape[0]
    out = torch.zeros(e, k, rhs.shape[1], dtype=acc, device=rhs.device)
    for g, (start, end) in enumerate(_bounds(group_sizes, m)):
        if end > start:
            out[g] = lhsT[:, start:end].to(acc) @ rhs[start:end].to(acc)
    return out.to(out_dtype)


# ---------------------------------------------------------------------------
# Hopper kernel wrappers
# ---------------------------------------------------------------------------
def _kernel(name: str):
    from luminaai_tpu_torch.ops import _build

    fn = getattr(_build.load("gmm"), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # lhs, rhs, group_sizes, out, M, K, N, E, flag, stream
        fn.argtypes = [p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(pairs, group_sizes, out_dtype, dims):
    """Refuse what the kernels do not take (raise, never fall back)."""
    dev = pairs[0][1].device
    for name, t in pairs:
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous bf16, got {t.dtype}"
                             f"{'' if t.is_contiguous() else ' (strided)'}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if out_dtype != torch.bfloat16:
        raise ValueError(f"the gmm kernels write bf16, asked for {out_dtype}")
    if (group_sizes.dtype != torch.int32 or group_sizes.ndim != 1
            or not group_sizes.is_contiguous() or group_sizes.device != dev):
        raise ValueError("group_sizes must be a contiguous int32 [E] tensor "
                         "on the operands' device")
    for name, d in dims.items():
        if d % 8 or d <= 0:
            raise ValueError(f"the gmm kernels take {name} a positive "
                             f"multiple of 8, got {d}")


def _launch(name, ptrs, dims, flag, device):
    err = _kernel(name)(*ptrs, *dims, int(flag),
                        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def gmm(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
        out_dtype: Optional[torch.dtype] = None,
        transpose_rhs: bool = False) -> torch.Tensor:
    """B4a: lhs [M, K], rhs [E, K, N] ([E, N, K] under transpose_rhs) ->
    [M, N]. One launch on the card; the plain version on the CPU."""
    out_dtype = out_dtype or lhs.dtype
    if not lhs.is_cuda:
        return gmm_ref(lhs, rhs, group_sizes, out_dtype, transpose_rhs)
    m, k = lhs.shape
    e = rhs.shape[0]
    n, k_rhs = (rhs.shape[1], rhs.shape[2]) if transpose_rhs else (
        rhs.shape[2], rhs.shape[1])
    if rhs.ndim != 3 or k_rhs != k or group_sizes.shape != (e,):
        raise ValueError(f"gmm shapes lhs {tuple(lhs.shape)}, rhs "
                         f"{tuple(rhs.shape)}, group_sizes "
                         f"{tuple(group_sizes.shape)} (transpose_rhs="
                         f"{transpose_rhs}) do not match")
    _check([("lhs", lhs), ("rhs", rhs)], group_sizes, out_dtype,
           {"K": k, "N": n})
    out = torch.empty(m, n, dtype=out_dtype, device=lhs.device)
    _launch("lumina_gmm",
            [t.data_ptr() for t in (lhs, rhs, group_sizes, out)],
            (m, k, n, e), transpose_rhs, lhs.device)
    gmm.launches += 1
    return out


def tgmm(lhsT: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """B4b: lhsT [K, M], rhs [M, N] -> [E, K, N]. The kernel reads lhs in
    its [M, K] row layout: lhsT is best the transposed view of a contiguous
    [M, K] (what the VJP passes), else it is copied. One launch on the
    card; the plain version on the CPU."""
    out_dtype = out_dtype or rhs.dtype
    if not rhs.is_cuda:
        return tgmm_ref(lhsT, rhs, group_sizes, out_dtype)
    k, m = lhsT.shape
    n = rhs.shape[1]
    e = group_sizes.shape[0]
    if rhs.ndim != 2 or rhs.shape[0] != m or group_sizes.ndim != 1:
        raise ValueError(f"tgmm shapes lhsT {tuple(lhsT.shape)}, rhs "
                         f"{tuple(rhs.shape)}, group_sizes "
                         f"{tuple(group_sizes.shape)} do not match")
    lhs = lhsT.t().contiguous()
    _check([("lhs", lhs), ("rhs", rhs)], group_sizes, out_dtype,
           {"K": k, "N": n})
    out = torch.empty(e, k, n, dtype=out_dtype, device=rhs.device)
    _launch("lumina_tgmm",
            [t.data_ptr() for t in (lhs, rhs, group_sizes, out)],
            (m, k, n, e), 0, rhs.device)
    tgmm.launches += 1
    return out


gmm.launches = 0
tgmm.launches = 0


def reset_launches() -> None:
    gmm.launches = 0
    tgmm.launches = 0


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------
class GroupedMatmul(torch.autograd.Function):
    """gmm with megablox's VJP (ops.py `_gmm_fwd` / `_gmm_bwd`)."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes, out_dtype, transpose_rhs):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        ctx.transpose_rhs = transpose_rhs
        return gmm(lhs, rhs, group_sizes, out_dtype, transpose_rhs)

    @staticmethod
    def backward(ctx, grad):
        lhs, rhs, group_sizes = ctx.saved_tensors
        grad = grad.to(rhs.dtype).contiguous()
        grad_lhs = grad_rhs = None
        if ctx.needs_input_grad[0]:
            grad_lhs = gmm(grad, rhs, group_sizes, lhs.dtype,
                           transpose_rhs=not ctx.transpose_rhs)
        if ctx.needs_input_grad[1]:
            grad_rhs = tgmm(lhs.t(), grad, group_sizes, rhs.dtype)
            if ctx.transpose_rhs:
                grad_rhs = grad_rhs.transpose(1, 2)
        return grad_lhs, grad_rhs, None, None, None


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor,
                   group_sizes: torch.Tensor,
                   out_dtype: Optional[torch.dtype] = None,
                   transpose_rhs: bool = False) -> torch.Tensor:
    """Differentiable gmm (lhs and rhs); group_sizes is an int32 [E]
    tensor on the operands' device."""
    return GroupedMatmul.apply(lhs, rhs, group_sizes,
                               out_dtype or lhs.dtype, transpose_rhs)
