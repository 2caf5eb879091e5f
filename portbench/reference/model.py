"""The plain reference: a decoder-only MoE transformer in float32.

Plain PyTorch, no kernel, no cache, no batching trick: what the
configuration file states, written from the published description of the
model (pre-norm blocks: RMSNorm, grouped-query attention with RoPE on
split halves, causal softmax; RMSNorm, then top-k routed SwiGLU experts
with a per-sequence capacity, or a dense SwiGLU; final RMSNorm; the
embedding tied to the head, scaled by sqrt(hidden) at the input). It
imports nothing of the program under test.

Every matrix product goes through `Products`: float32 (TF32 off), or
`fp8`, the same model one precision below the configuration's bf16, for
the control that the comparison has to reject.

Memory: each layer, each group of attention heads and each block of the
head's rows is recomputed in the backward (torch.utils.checkpoint), so
that the float32 reference of a whole cell fits one card beside its
AdamW state; the arithmetic is the same.

Departures from the program that the comparison tolerates: the input
scale sqrt(hidden) is exact here (the program rounds it to bf16 once);
top-k ties go to torch.topk's choice.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# The largest attention scores block and head logits block computed at
# once (bytes, float32).
SCORE_BYTES = 1 << 30
HEAD_ROWS = 4096

E4M3, E4M3_MAX = torch.float8_e4m3fn, 448.0
E5M2, E5M2_MAX = torch.float8_e5m2, 57344.0


def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x rounded to an fp8 format under one per-tensor scale (amax to the
    format's largest value), back in float32."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Fp8Product(torch.autograd.Function):
    """a @ b with both operands in e4m3 and the incoming gradient in e5m2
    (fp8 training's formats), products accumulated in float32."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a, E4M3, E4M3_MAX), _fp8(b, E4M3, E4M3_MAX)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g, E5M2, E5M2_MAX)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


class Products:
    """The matrix products of one precision: 'fp32' or 'fp8'."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            return _Fp8Product.apply(a, b)
        return a @ b


def fp32_products_only() -> None:
    """float32 products in float32: no TF32 (the GPU would round their
    inputs to 10 mantissa bits otherwise)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, theta: float):
    """Rotate [B, S, n, d] by position, split-halves convention."""
    B, S, n, d = x.shape
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device,
                                       dtype=torch.float32) / d)
    ang = torch.outer(torch.arange(S, device=x.device, dtype=torch.float32),
                      inv)
    c, s = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(x, wqkv, wo, cfg: Dict, mm: Products):
    B, S, H = x.shape
    nq, nkv = cfg["num_heads"], cfg["num_kv_heads"]
    d = H // nq
    qkv = mm(x.reshape(B * S, H), wqkv).reshape(B, S, -1)
    q = qkv[..., : nq * d].reshape(B, S, nq, d)
    k = qkv[..., nq * d: (nq + nkv) * d].reshape(B, S, nkv, d)
    v = qkv[..., (nq + nkv) * d:].reshape(B, S, nkv, d)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    # q head h reads kv head h // (nq / nkv).
    k = k.repeat_interleave(nq // nkv, dim=2)
    v = v.repeat_interleave(nq // nkv, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # [B, n, S, d]
    # Heads in groups whose scores stay near SCORE_BYTES.
    per_head = B * S * S * 4
    hc = max(1, min(nq, SCORE_BYTES // per_head))
    outs = [checkpoint(_attend, q[:, h:h + hc], k[:, h:h + hc],
                       v[:, h:h + hc], mm, use_reentrant=False)
            for h in range(0, nq, hc)]
    out = torch.cat(outs, dim=1).transpose(1, 2).reshape(B * S, nq * d)
    return mm(out, wo).reshape(B, S, H)


def _attend(q, k, v, mm: Products):
    """Causal softmax attention of [B, n, S, d] heads."""
    S, d = q.shape[2], q.shape[3]
    scores = mm(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    return mm(probs, v)


def swiglu(x2d, wi, wo, mm: Products):
    gate, up = mm(x2d, wi).chunk(2, dim=-1)
    return mm(F.silu(gate) * up, wo)


def capacity(cfg: Dict, seq: int) -> int:
    """Pairs an expert takes from one sequence: int(cf * S * k / E),
    at least 1, rounded up to a multiple of 8 from 8 on."""
    c = max(1, int(cfg["capacity_factor"] * seq * cfg["moe_top_k"]
                   / cfg["num_experts"]))
    return ((c + 7) // 8) * 8 if c >= 8 else c


def moe(x, router, wi, wo, noise, cfg: Dict, mm: Products):
    """Top-k routed experts. Each sequence is a routing group: an expert
    takes at most `capacity` of its (token, choice) pairs, first choices
    of every token in sequence order before any second choice; a pair
    past capacity is dropped (its gate 0). Returns (out, load-balancing
    loss, z loss) with the losses already weighted."""
    B, S, H = x.shape
    E, k = cfg["num_experts"], cfg["moe_top_k"]
    C = capacity(cfg, S)
    x2d = x.reshape(B * S, H)
    logits = mm(x2d, router).reshape(B, S, E) / cfg["routing_temperature"]
    if noise is not None:
        logits = logits + noise * cfg["routing_noise_std"]
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.topk(probs, k, dim=-1)
    gates = vals / (vals.sum(-1, keepdim=True) + 1e-9)
    # Pair order within a sequence: choice-major, then position.
    e_pairs = idx.transpose(1, 2).reshape(B, k * S)
    onehot = F.one_hot(e_pairs, E)
    pos = (onehot.cumsum(1) - 1).gather(2, e_pairs[..., None])[..., 0]
    keep = (pos < C).reshape(B, k, S).transpose(1, 2)  # [B, S, k]
    gates = gates * keep
    out = torch.zeros(B * S, H, dtype=x.dtype, device=x.device)
    flat_idx, flat_keep = idx.reshape(B * S, k), keep.reshape(B * S, k)
    flat_gate = gates.reshape(B * S, k)
    for e in range(E):
        tok, choice = torch.nonzero((flat_idx == e) & flat_keep,
                                    as_tuple=True)
        if tok.numel() == 0:
            continue
        y = swiglu(x2d[tok], wi[e], wo[e], mm)
        out = out.index_add(0, tok, y * flat_gate[tok, choice][:, None])
    out = out * cfg.get("expert_output_scaling", 1.0)
    counts = torch.stack([((idx == e) & keep).sum() for e in range(E)]
                         ).float()  # kept pairs per expert
    f = counts / (B * S * k + 1e-9)
    p = probs.mean(dim=(0, 1))
    aux = torch.clamp((f * p).sum() * E * cfg["load_balancing_weight"],
                      max=1.0)
    z = torch.logsumexp(logits, dim=-1).square().mean() * cfg[
        "router_z_loss_weight"]
    return out.reshape(B, S, H), aux, z


def forward_loss(W: Dict[str, torch.Tensor], ids: torch.Tensor, cfg: Dict,
                 noises: Optional[List[torch.Tensor]], mm: Products
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, CE) of one micro-batch of token ids [B, S]: the mean
    next-token cross-entropy over positions 0..S-2, plus the MoE layers'
    load-balancing and z losses summed over layers."""
    B, S = ids.shape
    H, L = cfg["hidden_size"], cfg["num_layers"]
    eps = cfg["rms_norm_eps"]
    x = W["embedding"][ids]
    if cfg["use_stable_embedding"]:
        x = x * math.sqrt(H)
    aux_total = torch.zeros((), device=ids.device)
    for i in range(L):
        noise = None if noises is None else noises[i]
        x, aux = checkpoint(_layer, x, W, i, noise, cfg, mm,
                            use_reentrant=False)
        aux_total = aux_total + aux
    x = rms_norm(x, W["final_norm"], eps)
    head = W["embedding"] if cfg["tie_word_embeddings"] else W["lm_head"]
    h = x[:, :-1].reshape(B * (S - 1), H)
    labels = ids[:, 1:].reshape(-1)
    nll = sum(checkpoint(_nll_sum, h[r:r + HEAD_ROWS], head,
                         labels[r:r + HEAD_ROWS], mm, use_reentrant=False)
              for r in range(0, h.shape[0], HEAD_ROWS))
    ce = nll / h.shape[0]
    return ce + aux_total, ce


def _nll_sum(h, head, labels, mm: Products):
    return F.cross_entropy(mm(h, head.t()), labels, reduction="sum")


def _layer(x, W, i: int, noise, cfg: Dict, mm: Products):
    """One block: (x out, its MoE losses)."""
    B, S, H = x.shape
    eps = cfg["rms_norm_eps"]
    x = x + attention(rms_norm(x, W["attn_norm"][i], eps), W["wqkv"][i],
                      W["attn_wo"][i], cfg, mm)
    h = rms_norm(x, W["ffn_norm"][i], eps)
    if cfg.get("use_moe"):
        y, aux, z = moe(h, W["router"][i], W["ffn_wi"][i], W["ffn_wo"][i],
                        noise, cfg, mm)
        return x + y, aux + z
    y = swiglu(h.reshape(B * S, H), W["ffn_wi"][i], W["ffn_wo"][i], mm)
    return x + y.reshape(B, S, H), torch.zeros((), device=x.device)
