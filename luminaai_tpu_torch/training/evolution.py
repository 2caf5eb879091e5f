"""Expert add/prune parameter surgery (port of luminaai_tpu/training/evolution.py).

The JAX module maps over the flax tree's `moe` subtrees; here the same
surgery runs over the port's flat parameter dict (LuminaTransformer's
state_dict keys). Every MoE layer `layers.{i}.moe.` holds `router` [H, E]
(expert axis LAST) and `wi` [E, H, 2F], `wo` [E, F, H] (expert axis
FIRST), so add/prune are concatenations/selections along those axes,
producing the parameters of a rebuilt model with num_experts ± 1. Other
entries pass through as the same tensors.

A new expert is the mean of the existing experts plus `noise_scale`
Gaussian noise (the reference's strategy: the router's existing routing
stays roughly valid while the newcomer differentiates). The noise comes
from the caller's torch.Generator, per MoE layer in layer order: router
column, then wi, then wo. The draws are torch's, not JAX's.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import torch

ROUTER_NAME = "router"  # [H, E]: expert axis is LAST
EXPERT_LEADING = ("wi", "wo")  # [E, ...]: expert axis is FIRST
_MOE_ROUTER = re.compile(r"^(.*\.moe\.)" + ROUTER_NAME + "$")

Params = Dict[str, torch.Tensor]


def moe_prefixes(params: Params) -> List[str]:
    """The MoE layers' key prefixes ('layers.3.moe.'), in layer order."""
    found = [m.group(1) for m in map(_MOE_ROUTER.match, params) if m]

    def layer(prefix: str):
        digits = re.findall(r"\d+", prefix)
        return [int(d) for d in digits]

    return sorted(found, key=layer)


def grow_expert(params: Params, generator: Optional[torch.Generator],
                noise_scale: float = 0.01) -> Params:
    """Return params with one expert appended to every MoE layer."""
    out = dict(params)
    with torch.no_grad():
        for prefix in moe_prefixes(params):
            router = params[prefix + ROUTER_NAME]
            new_col = router.mean(dim=-1, keepdim=True)
            new_col = new_col + noise_scale * torch.randn(
                new_col.shape, generator=generator, device=router.device,
                dtype=router.dtype)
            out[prefix + ROUTER_NAME] = torch.cat([router, new_col], dim=-1)
            for name in EXPERT_LEADING:
                w = params[prefix + name]
                new_slab = w.mean(dim=0, keepdim=True)
                new_slab = new_slab + noise_scale * torch.randn(
                    new_slab.shape, generator=generator, device=w.device,
                    dtype=w.dtype)
                out[prefix + name] = torch.cat([w, new_slab], dim=0)
    return out


def prune_expert(params: Params, expert_idx: int) -> Params:
    """Return params with expert `expert_idx` removed from every MoE
    layer."""
    out = dict(params)
    with torch.no_grad():
        for prefix in moe_prefixes(params):
            router = params[prefix + ROUTER_NAME]
            E = router.shape[-1]
            if not 0 <= expert_idx < E:
                raise ValueError(
                    f"expert_idx {expert_idx} out of range [0,{E})")
            keep = torch.tensor([i for i in range(E) if i != expert_idx],
                                device=router.device)
            out[prefix + ROUTER_NAME] = router.index_select(-1, keep)
            for name in EXPERT_LEADING:
                out[prefix + name] = params[prefix + name].index_select(
                    0, keep)
    return out


def num_experts_in(params: Params) -> Optional[int]:
    """E of the first MoE layer found (None if dense)."""
    prefixes = moe_prefixes(params)
    if not prefixes:
        return None
    return int(params[prefixes[0] + ROUTER_NAME].shape[-1])


def evolution_feasible(config, new_num_experts: int) -> Tuple[bool, str]:
    """Whether the surgery may run: the model has MoE layers, keeps at
    least max(2, top_k) experts, and the experts divide over the expert
    axis (the JAX gate)."""
    if not config.use_moe:
        return False, "model has no MoE layers"
    if new_num_experts < max(2, config.moe_top_k):
        return False, f"cannot go below {max(2, config.moe_top_k)} experts"
    if new_num_experts % config.expert_parallel_size != 0:
        return (False, f"{new_num_experts} experts not divisible by "
                       f"expert_parallel_size={config.expert_parallel_size}")
    return True, "ok"
