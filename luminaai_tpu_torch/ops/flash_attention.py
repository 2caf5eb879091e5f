"""Flash attention forward and backward for training (PyTorch + CUDA).

Counterpart of luminaai_tpu/ops/flash_attention.py. Layout as there: q
[B, Sq, Hq, D], k/v [B, Skv, Hkv, D] (GQA: Hq a multiple of Hkv), lse
[B, Hq, Sq] fp32. Pieces:

- `fit_block`, `flash_eligible`: the JAX package's gate, kept line for
  line so both packages send the same shapes to their kernels.
- Plain PyTorch versions of the three kernels, `flash_fwd_ref`,
  `flash_bwd_dq_ref` and `flash_bwd_dkv_ref`: the same function as each
  kernel, with fp32 scores and the kernels' bf16 roundings (P before P.V
  and dP^T.dO, dS before dS.K and dS^T.Q) when given bf16. They
  materialise the [S, S] scores, so they are the CPU path and the oracle
  the kernels are held against, not a fast path.
- The kernel wrappers `flash_fwd`, `flash_bwd_dq`, `flash_bwd_dkv`
  (csrc/flash_attention.cu, replacing the TPU kernels `_fwd_kernel`,
  `_bwd_dq_kernel` and `_bwd_dkv_kernel`). On a CUDA tensor each launches
  its kernel and counts the launch in `<wrapper>.launches`, or raises on a
  shape, type or layout the kernel does not take; on a CPU tensor it runs
  its plain version. It never falls back from the card.
- `FlashAttention`, the autograd.Function in place of the JAX custom VJP:
  both outputs are differentiable; the lse cotangent folds into delta
  (delta = rowsum(dO * O) - g_lse), as the JAX `_bwd` does.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30

# What the kernels take (csrc/flash_attention.cu): head_dim a multiple of
# 64 (a template each up to 256, 64-column output slices above), any number
# of q heads per kv head, any sequence lengths (partial tiles are masked in
# the kernel). That is every shape the JAX gate `flash_eligible` admits.
KERNEL_HEAD_DIM_MULTIPLE = 64


def fit_block(seq_len: int, want: int) -> int:
    """Largest lane-aligned block <= `want` that divides seq_len: multiples
    of 128 scanned downward, else a halving search whose result may be
    < 128 (flash_eligible treats that as ineligible)."""
    b = min(want, seq_len)
    b -= b % 128
    while b >= 128 and seq_len % b:
        b -= 128
    if b >= 128:
        return b
    b = max(1, min(want, seq_len))
    while seq_len % b:
        b //= 2
    return b


def flash_eligible(
    seq_len: int, head_dim: int, block_q: int, block_kv: int
) -> bool:
    """When the flash path applies: a long-enough sequence, head_dim a
    multiple of 64, and a usable block fit (>= 128) for both block sizes."""
    return (
        seq_len >= 128
        and head_dim % 64 == 0
        and fit_block(seq_len, block_q) >= 128
        and fit_block(seq_len, block_kv) >= 128
    )


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path and oracle)
# ---------------------------------------------------------------------------
def _band(sq: int, skv: int, window: int, device) -> torch.Tensor:
    """[Sq, Skv] keep-mask of causal attention, banded under a window."""
    qp = torch.arange(sq, device=device)[:, None]
    kp = torch.arange(skv, device=device)[None, :]
    keep = qp >= kp
    if window:
        keep = keep & (qp - kp < window)
    return keep


def _scores(q, k, scale, causal, window):
    """fp32 scores [B, Hkv, G, Sq, Skv] of q [B,Sq,Hq,D] against k
    [B,Skv,Hkv,D], masked with NEG_INF outside the band."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if causal:
        s = torch.where(_band(Sq, Skv, window, q.device), s, NEG_INF)
    return s


def _grouped(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """[B, S, Hq, D] -> fp32 [B, S, Hkv, G, D]."""
    B, S, Hq, D = x.shape
    return x.reshape(B, S, hkv, Hq // hkv, D).float()


def _row_stat(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """[B, Hq, Sq] -> [B, Hkv, G, Sq, 1] for broadcasting over scores."""
    B, Hq, Sq = x.shape
    return x.reshape(B, hkv, Hq // hkv, Sq, 1)


def flash_fwd_ref(q, k, v, *, scale: float, causal: bool = True,
                  window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O [B,Sq,Hq,D] in q's dtype, lse [B,Hq,Sq] fp32). The row sum adds
    the fp32 probabilities; P.V takes them rounded to v's dtype; a zero
    row sum gives output 0 (the TPU kernel's safe_l)."""
    B, Sq, Hq, D = q.shape
    s = _scores(q, k, scale, causal, window)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, 1.0, l)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    o = (acc / safe_l).to(q.dtype)
    o = o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D)
    lse = (m + torch.log(safe_l)).reshape(B, Hq, Sq)
    return o, lse


def _probs_and_ds(q, k, v, do, lse, delta, scale, causal, window):
    """Recomputed P (fp32) and dS rounded to q's dtype (as fp32), both
    [B, Hkv, G, Sq, Skv]."""
    hkv = k.shape[2]
    s = _scores(q, k, scale, causal, window)
    p = torch.exp(s - _row_stat(lse, hkv))
    dp = torch.einsum("bqhgd,bkhd->bhgqk", _grouped(do, hkv), v.float())
    ds = (p * (dp - _row_stat(delta, hkv)) * scale).to(q.dtype).float()
    return p, ds


def flash_bwd_dq_ref(q, k, v, do, lse, delta, *, scale: float,
                     causal: bool = True, window: int = 0) -> torch.Tensor:
    """dQ = dS.K with P recomputed from lse and dS = P*(dP - delta)*scale;
    delta [B,Hq,Sq] already carries the lse cotangent. Returns q's dtype."""
    B, Sq, Hq, D = q.shape
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, scale, causal, window)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float())
    return dq.reshape(B, Sq, Hq, D).to(q.dtype)


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, *, scale: float,
                      causal: bool = True, window: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) [B,Skv,Hkv,D]: per q head dK = dS^T.Q and dV = P^T.dO (P
    rounded to dO's dtype), summed over each kv head's group in fp32, then
    cast to k's and v's dtypes."""
    hkv = k.shape[2]
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, scale, causal, window)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(do.dtype).float(),
                      _grouped(do, hkv))
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, _grouped(q, hkv))
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Hopper kernel wrappers
# ---------------------------------------------------------------------------
def _kernel(name: str, n_ptrs: int):
    from luminaai_tpu_torch.ops import _build

    fn = getattr(_build.load("flash_attention"), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # pointers, B, Sq, Skv, Hq, Hkv, D, causal, window, scale, stream
        fn.argtypes = [p] * n_ptrs + [i] * 8 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def kernel_shape_error(B: int, Sq: int, Skv: int, Hq: int, Hkv: int,
                       D: int) -> Optional[str]:
    """Why the flash kernels refuse this shape, or None when they take it
    (a pure function of the shape: the wrappers raise with its message)."""
    if min(B, Sq, Skv, Hq, Hkv) <= 0:
        return f"empty shape B={B}, Sq={Sq}, Skv={Skv}, Hq={Hq}, Hkv={Hkv}"
    if Hq % Hkv:
        return f"Hq={Hq} is not a multiple of Hkv={Hkv}"
    if D <= 0 or D % KERNEL_HEAD_DIM_MULTIPLE:
        return (f"the flash kernels take head_dim a multiple of "
                f"{KERNEL_HEAD_DIM_MULTIPLE}, got {D}")
    return None


def _check(q, k, v, extra=(), stats=()):
    """Refuse what the kernels do not take (raise, never fall back)."""
    B, Sq, Hq, D = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    Skv, Hkv = k.shape[1], k.shape[2]
    err = kernel_shape_error(B, Sq, Skv, Hq, Hkv, D)
    if err:
        raise ValueError(err)
    for name, t in (("q", q), ("k", k), ("v", v), *extra):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous bf16, got {t.dtype}"
                             f"{'' if t.is_contiguous() else ' (strided)'}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    for name, t in stats:
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.shape != (B, Hq, Sq) or t.device != q.device):
            raise ValueError(f"{name} must be contiguous fp32 [B, Hq, Sq] "
                             f"on q's device, got {t.dtype} "
                             f"{tuple(t.shape)}")
    return B, Sq, Skv, Hq, Hkv, D


def _launch(name, n_ptrs, ptrs, dims, causal, window, scale, device):
    err = _kernel(name, n_ptrs)(
        *ptrs, *dims, int(causal), int(window or 0), float(scale),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def flash_fwd(q, k, v, *, scale: float, causal: bool = True,
              window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1: (O, lse). One launch on the card; the plain version on the CPU."""
    if not q.is_cuda:
        return flash_fwd_ref(q, k, v, scale=scale, causal=causal,
                             window=window)
    dims = _check(q, k, v)
    B, Sq, _, Hq, _, _ = dims
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    _launch("lumina_flash_fwd", 5,
            [t.data_ptr() for t in (q, k, v, o, lse)],
            dims, causal, window, scale, q.device)
    flash_fwd.launches += 1
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, *, scale: float,
                 causal: bool = True, window: int = 0) -> torch.Tensor:
    """B2: dQ. One launch on the card; the plain version on the CPU."""
    if not q.is_cuda:
        return flash_bwd_dq_ref(q, k, v, do, lse, delta, scale=scale,
                                causal=causal, window=window)
    dims = _check(q, k, v, [("do", do)], [("lse", lse), ("delta", delta)])
    dq = torch.empty_like(q)
    _launch("lumina_flash_bwd_dq", 7,
            [t.data_ptr() for t in (q, k, v, do, lse, delta, dq)],
            dims, causal, window, scale, q.device)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, scale: float,
                  causal: bool = True, window: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B3: (dK, dV), the GQA group summed in the kernel. One launch on the
    card; the plain version on the CPU."""
    if not q.is_cuda:
        return flash_bwd_dkv_ref(q, k, v, do, lse, delta, scale=scale,
                                 causal=causal, window=window)
    dims = _check(q, k, v, [("do", do)], [("lse", lse), ("delta", delta)])
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("lumina_flash_bwd_dkv", 8,
            [t.data_ptr() for t in (q, k, v, do, lse, delta, dk, dv)],
            dims, causal, window, scale, q.device)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def reset_launches() -> None:
    for fn in (flash_fwd, flash_bwd_dq, flash_bwd_dkv):
        fn.launches = 0


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------
class FlashAttention(torch.autograd.Function):
    """(O, lse) with both outputs differentiable (the JAX `_flash_lse`
    custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window):
        o, lse = flash_fwd(q, k, v, scale=scale, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = dict(scale=scale, causal=causal, window=window)
        return o, lse

    @staticmethod
    def backward(ctx, g_o, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        do = g_o.to(q.dtype).contiguous()
        delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)
        if g_lse is not None:
            # dlse/ds = p, so ds = p*(dp - delta + g_lse): the lse
            # cotangent folds into delta and the kernels stay unchanged.
            delta = delta - g_lse.float()
        delta = delta.contiguous()
        dq = flash_bwd_dq(q, k, v, do, lse, delta, **ctx.args)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    block_q: int = 512,
    block_kv: int = 512,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention that also returns the per-row logsumexp [B, Hq, Sq];
    differentiable in both outputs. block_q/block_kv only gate (the JAX
    fit): below a 128-row fit this raises, as the JAX function does; the
    card's kernels use their own tiles."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError("num q heads must be a multiple of kv heads")
    bq, bkv = fit_block(Sq, block_q), fit_block(Skv, block_kv)
    if bq < 128 or bkv < 128:
        raise ValueError(
            f"no usable flash block for seq lengths ({Sq},{Skv}); largest "
            f"fitting blocks ({bq},{bkv}) < 128: gate calls with "
            "flash_eligible() and take the plain attention path"
        )
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if window is not None:
        if not causal:
            raise ValueError("sliding window requires causal attention")
        if window <= 0:
            raise ValueError(f"window must be positive, got {window}")
    return FlashAttention.apply(q, k, v, float(scale), bool(causal),
                                int(window or 0))


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    block_q: int = 512,
    block_kv: int = 512,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Flash attention over [B, S, H, D] tensors (differentiable)."""
    return flash_attention_with_lse(
        q, k, v, causal=causal, scale=scale,
        block_q=block_q, block_kv=block_kv, window=window,
    )[0]
