"""The reference's training steps: the plain model, AdamW, in float32.

`steps` follows the first steps of a training job from the seed as the
configuration states it: micro-batches of the batch summed as g_i / accum,
the global gradient norm clipped, then AdamW (optax's adamw: bias-
corrected moments, decoupled weight decay on matrices only) at the
configuration's warmup-then-cosine learning rate. The routing noise is
drawn from its own generator seeded with the benchmark's routing seed:
one standard-normal [micro-batch, S, E] draw per MoE layer, layer by
layer, per micro-batch, the order in which the configuration's training
step consumes its generator.

It returns what the comparison reads: each step's loss, each parameter's
gradient norm as the optimizer takes it in the first step (after
clipping), and each parameter's change after the last step. Weights and
batches are the benchmark's (portbench/lib/inputs.py); nothing of the
program is imported or read.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench.lib.flops import shapes
from portbench.lib.inputs import leaves, sub_seed, weights
from portbench.reference.model import Products, forward_loss, \
    fp32_products_only

UNSUPPORTED = {"attention_window": None, "expert_dropout_rate": 0.0,
               "label_smoothing": 0.0, "z_loss_weight": 0.0}


def check_supported(cfg: Dict) -> None:
    for key, plain in UNSUPPORTED.items():
        if cfg.get(key, plain) != plain:
            raise ValueError(f"the reference does not model {key}="
                             f"{cfg[key]!r}")
    if cfg.get("use_moe") and cfg.get("moe_pattern", "all") != "all":
        raise ValueError("the reference models MoE on every layer only")


def learning_rate(cfg: Dict, total_steps: int):
    """lr(count): linear warmup from 0 over int(total * warmup_ratio)
    steps (at least 1), then cosine decay to min_lr (the configuration's
    'cosine' schedule), as optax counts: the first update has count 0."""
    peak = cfg["learning_rate"]
    if not cfg.get("use_lr_scheduler", True):
        return lambda count: peak
    if cfg.get("lr_scheduler", "cosine") != "cosine":
        raise ValueError("the reference models the cosine schedule only")
    warm = max(1, int(total_steps * cfg["warmup_ratio"]))
    floor = min(cfg["min_lr"], peak)
    decay = max(1, total_steps - warm)

    def lr(count: int) -> float:
        if count < warm:
            return peak * count / warm
        c = min(count - warm, decay)
        cos = 0.5 * (1 + math.cos(math.pi * c / decay))
        alpha = floor / max(peak, 1e-12)
        return peak * ((1 - alpha) * cos + alpha)

    return lr


def steps(cfg: Dict, seed: int, ids: torch.Tensor, n_steps: int,
          total_steps: int, precision: str = "fp32",
          rows_kept: float = 1.0) -> Dict:
    """n_steps training steps over ids[0..n_steps) ([B, S] each).
    `rows_kept` < 1 keeps only that share of each micro-batch's rows
    (a planted fault: part of the batch left out, the mean over the
    rest)."""
    check_supported(cfg)
    fp32_products_only()
    device = ids.device
    s = shapes(cfg)
    mm = Products(precision)
    W, K = {}, {}
    for kind, t in weights(s, seed, device):
        W[kind.name] = t.requires_grad_(True)
        K[kind.name] = kind
    m = {k: torch.zeros_like(v) for k, v in W.items()}
    v2 = {k: torch.zeros_like(v) for k, v in W.items()}
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed,
                                                              "routing"))
    lr_of = learning_rate(cfg, total_steps)
    b1, b2, eps = cfg["beta1"], cfg["beta2"], cfg["eps"]
    accum = max(1, cfg.get("gradient_accumulation_steps", 1))
    draws = cfg.get("use_moe") and cfg.get("routing_noise_std", 0) > 0
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    for t in range(n_steps):
        batch = ids[t]
        B, S = batch.shape
        mb = B // accum
        total = torch.zeros((), device=device)
        for i in range(accum):
            micro = batch[i * mb:(i + 1) * mb]
            noises = ([torch.randn((mb, S, cfg["num_experts"]),
                                   generator=gen, device=device,
                                   dtype=torch.float32)
                       for _ in range(cfg["num_layers"])] if draws
                      else None)
            keep = max(1, int(mb * rows_kept))
            if keep < mb:
                micro = micro[:keep]
                noises = None if noises is None else [n[:keep]
                                                      for n in noises]
            loss, _ = forward_loss(W, micro, cfg, noises, mm)
            (loss / accum).backward()
            total = total + loss.detach()
        losses.append(float(total / accum))
        with torch.no_grad():
            grads = {k: p.grad for k, p in W.items()}
            norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
            clip = cfg["grad_clip_norm"]
            scale = (torch.clamp(clip / (norm + 1e-6), max=1.0) if clip > 0
                     else torch.ones((), device=device))
            for g in grads.values():
                g.mul_(scale)
            if t == 0:
                for k, g in grads.items():
                    for name, leaf in leaves(K[k], g, s.layers):
                        grad_norms[name] = float(leaf.norm())
            count = t + 1
            bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
            lr = lr_of(t)
            for k, p in W.items():
                g = grads[k]
                m[k].mul_(b1).add_((1 - b1) * g)
                v2[k].mul_(b2).add_((1 - b2) * g.square())
                u = (m[k] / bc1) / (torch.sqrt(v2[k] / bc2) + eps)
                if K[k].decays and cfg["weight_decay"]:
                    u = u + cfg["weight_decay"] * p
                p.sub_(lr * u)
                p.grad = None
    del m, v2
    change: Dict[str, float] = {}
    with torch.no_grad():
        for kind, t0 in weights(s, seed, device):
            for name, leaf in leaves(kind, W[kind.name] - t0, s.layers):
                change[name] = float(leaf.norm())
            del t0
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}
