"""LoRA adapters (port of the LoRA half of luminaai_tpu/training/adapters.py).

The adapter lives in the JAX package's coordinates: keys are flax paths
('layer_3/attention/wq'), and each adapted kernel W of flax shape
[*lead, *in, *out] gets factors a [*lead, m, r] and b [*lead, r, n]
(m = prod(in), n = prod(out)), split at the einsum's in/out boundary
(`_split_axis`): wq [H, nq, d] -> a [H, r], b [r, nq d]; attention wo
[nq, d, H] -> a [nq d, r], b [r, H]; FFN wi [H, 2F] and wo [F, H] as they
are; MoE expert kernels [E, ...] get per-expert factors. The adapted
kernel is W + (alpha / r) a @ b. So the .npz + .json files are the JAX
format, and an adapter trained by either package loads in the other.

The port's model stores attention fused (wqkv [H, (nq + 2 nkv) d], wo
[nq d, H]; convert.py). Merging happens in flax space, and the merged
flax tree maps onto the model's tensors through convert's own map
(`flax_to_state_dict`: a concatenation and reshapes, differentiable).

Training (`make_lora_train_step`) keeps the base frozen: the model's
parameters have requires_grad=False and no optimizer moments; only the
factors get gradients and an Adam state (optax.adam(lr), i.e. the port's
optax-exact AdamW with weight decay 0, its moments in the config's form:
fp32, bf16 mu or int8; the JAX CLI's finetune keeps fp32 moments
whatever the config, so the two agree at the default form). Each step merges the factors into
the kernels, installs the merged tensors in the model in place of its
parameters for the forward AND the backward (the remat recompute reads
them again), and runs the train step's loss function
(parallel/train_step.make_loss_fn), so the flash kernels, and the
grouped matmul for adapted experts, carry the step.

Soft-prompt tuning (the JAX file's second half, :245-319): a [P, H]
tensor of virtual tokens, initialized from random rows of the embedding
table (`init_soft_prompt`, drawn from a torch.Generator), prepended to
every sequence through the model's `prefix_embeds` (`prepend_soft_prompt`,
which warns, as JAX does, when S + P leaves the flash kernels' gate), and
trained alone (`make_prompt_tuning_step`): the base frozen, the loss the
JAX step's (next-token CE of the real tokens plus the MoE aux loss), and
Adam moments for the prompt only. Its gradient reaches the prompt through
every layer's attention backward (B2, B3 on the card).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import re
from typing import Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from luminaai_tpu_torch.ops.fused import global_norm
from luminaai_tpu_torch.training.optimizer import (
    AdamW,
    constant_schedule,
    make_adam,
    moment_form,
)

logger = logging.getLogger(__name__)

_TARGET_NAMES = ("wq", "wk", "wv", "wo", "wi")

Lora = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass
class LoRASpec:
    """What to adapt and how."""

    rank: int = 8
    alpha: float = 16.0
    # Regexes matched against the '/'-joined param path. Defaults adapt
    # attention + dense FFN projections; add 'moe/' to adapt expert FFNs
    # (per-expert factors).
    target_patterns: Tuple[str, ...] = (r"attention/", r"ffn/")

    def scaling(self) -> float:
        return self.alpha / max(self.rank, 1)


def _split_axis(path_s: str, name: str, ndim: int) -> Optional[Tuple[int, int]]:
    """(lead_axes, split) for a target kernel; None if not factorizable.

    The core kernel is 3-D for attention (wq [H, nq, d], wo [nq, d, H])
    and 2-D for FFN/expert kernels (wi [H, 2F], wo [F, H]); axes in front
    (the MoE expert axis) are lead axes with factors of their own."""
    core = 3 if "/attention/" in f"/{path_s}/" else 2
    lead = ndim - core
    if lead < 0 or ndim < 2:
        return None
    if name in ("wq", "wk", "wv", "wi"):
        return lead, lead + 1  # in = first core axis
    if name == "wo":
        return lead, ndim - 1  # out = last axis
    return None


def _is_target(path_s: str, name: str, spec: LoRASpec) -> bool:
    if name not in _TARGET_NAMES:
        return False
    return any(re.search(p, path_s) for p in spec.target_patterns)


def init_lora_params(
    params: Mapping[str, torch.Tensor], spec: LoRASpec, seed: int
) -> Lora:
    """The adapter for a flat {flax path: tensor} tree (convert's
    `state_dict_to_flax`): {path: {'a': [..., m, r], 'b': [..., r, n]}},
    fp32 on the parameters' device. a ~ N(0, 1/r), b = 0: the adapted
    model starts equal to the base. Draws come from a torch.Generator
    seeded with `seed`, one per kernel in path order (not JAX's numbers)."""
    lora: Lora = {}
    for i, path_s in enumerate(sorted(params)):
        leaf = params[path_s]
        name = path_s.rsplit("/", 1)[-1]
        if not _is_target(path_s, name, spec):
            continue
        ax = _split_axis(path_s, name, leaf.ndim)
        if ax is None:
            continue
        n_lead, split = ax
        shape = tuple(leaf.shape)
        m = int(np.prod(shape[n_lead:split]))
        n = int(np.prod(shape[split:]))
        lead = shape[:n_lead]
        gen = torch.Generator(device=leaf.device).manual_seed(
            int(seed) * 1_000_003 + i)
        a = torch.randn((*lead, m, spec.rank), generator=gen,
                        dtype=torch.float32, device=leaf.device)
        lora[path_s] = {
            "a": a / np.sqrt(spec.rank),
            "b": torch.zeros((*lead, spec.rank, n), dtype=torch.float32,
                             device=leaf.device),
        }
    if not lora:
        raise ValueError(
            f"no LoRA targets matched patterns {spec.target_patterns}"
        )
    return lora


def lora_param_count(lora: Lora) -> int:
    return sum(t.numel() for ab in lora.values() for t in ab.values())


def merge_lora(
    params: Mapping[str, torch.Tensor], lora: Lora, spec: LoRASpec
) -> Dict[str, torch.Tensor]:
    """A new flat tree with `W + scaling * (a @ b)` at every adapted
    kernel, each in W's dtype (a bf16 W takes the fp32 sum rounded to
    bf16, as the JAX merge casts). Differentiable in the factors. Raises
    when an adapter key has no kernel in `params`."""
    scale = spec.scaling()
    missing = sorted(set(lora) - set(params))
    if missing:
        raise ValueError(
            "adapter does not match this parameter tree (wrong model or "
            f"layer layout?): unmatched keys {missing[:4]}"
            f"{' ...' if len(missing) > 4 else ''}"
        )
    out = dict(params)
    for path_s, ab in lora.items():
        raw = params[path_s]
        delta = torch.matmul(ab["a"].to(raw.device),
                             ab["b"].to(raw.device)) * scale
        out[path_s] = (raw + delta.reshape(raw.shape)).to(raw.dtype)
    return out


@contextlib.contextmanager
def installed_weights(model: torch.nn.Module,
                      tensors: Mapping[str, torch.Tensor]) -> Iterator[None]:
    """Put plain tensors in place of the named parameters (state_dict
    names) for the duration of the block, then put the parameters back.
    Unlike torch.func.functional_call the swap spans a backward run inside
    the block, whose remat recompute reads the weights again."""
    saved = []
    try:
        for name, t in tensors.items():
            mod_name, _, attr = name.rpartition(".")
            mod = model.get_submodule(mod_name)
            saved.append((mod, attr, mod._parameters.pop(attr)))
            setattr(mod, attr, t)
        yield
    finally:
        for mod, attr, p in reversed(saved):
            delattr(mod, attr)
            mod.register_parameter(attr, p)


def adapted_tensors(model: torch.nn.Module, config: Config,
                    lora: Lora, spec: LoRASpec) -> Dict[str, torch.Tensor]:
    """The model tensors (state_dict names) that the adapter changes,
    merged from the model's own parameters: what `installed_weights`
    puts in place for a step."""
    base = state_dict_to_flax(dict(model.named_parameters()), config)
    merged = flax_to_state_dict(merge_lora(base, lora, spec), config)
    return {n: t for n, t in merged.items() if t.requires_grad}


def make_lora_train_step(
    config: Config,
    model: torch.nn.Module,
    spec: LoRASpec,
    tx: AdamW,
    loss_fn: Optional[Callable] = None,
):
    """PEFT step: gradients and optimizer state for the adapter only.

    The model's parameters are frozen here (requires_grad=False). Returns
    step((lora, opt_state), batch, generator) -> ((lora, opt_state),
    metrics); the factors and moments update in place (tx.apply over the
    factors in the adapter's key order, 'a' then 'b'). metrics are the
    loss function's plus `grad_norm`, the adapter gradients' global norm."""
    from luminaai_tpu_torch.parallel.train_step import make_loss_fn

    model.requires_grad_(False)
    inner = loss_fn or make_loss_fn(config, model)

    def step(carry, batch, generator: Optional[torch.Generator] = None):
        lora, opt_state = carry
        leaves = [t.requires_grad_(True) for t in lora_leaves(lora)]
        with installed_weights(model, adapted_tensors(model, config, lora,
                                                      spec)):
            loss, metrics = inner(batch, generator)
            grads = torch.autograd.grad(loss, leaves)
        metrics["grad_norm"] = global_norm(grads)
        tx.apply(leaves, grads, opt_state)
        return (lora, opt_state), metrics

    return step


def lora_leaves(lora: Lora):
    """The factor tensors in a fixed order: adapter keys as stored, 'a'
    then 'b' (the optimizer's moments follow this order)."""
    return [ab[sub] for ab in lora.values() for sub in ("a", "b")]


def adam(learning_rate: float, config: Optional[Config] = None) -> AdamW:
    """optax.adam(learning_rate) with optax's defaults (b1 0.9, b2 0.999,
    eps 1e-8): the port's AdamW without weight decay, its moments in
    `config`'s form (optimizer.moment_form; fp32 without a config)."""
    form = moment_form(config) if config is not None else "fp32"
    return make_adam(form, constant_schedule(learning_rate), 0.9, 0.999,
                     1e-8, 0.0)


def save_lora(path: str, lora: Lora, spec: LoRASpec) -> None:
    """Adapter checkpoint in the JAX format: one .npz of fp32 factors
    keyed 'path::a' / 'path::b', plus the spec as .json."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    base = path[: -len(".npz")] if path.endswith(".npz") else path
    flat = {
        f"{k}::{sub}": v.detach().float().cpu().numpy()
        for k, ab in lora.items()
        for sub, v in ab.items()
    }
    np.savez(base + ".npz", **flat)
    with open(base + ".json", "w") as f:
        json.dump(dataclasses.asdict(spec), f)


def load_lora(path: str, device=None) -> Tuple[Lora, LoRASpec]:
    """(adapter, spec) from save_lora's files (either package's)."""
    base = path[: -len(".npz")] if path.endswith(".npz") else path
    lora: Lora = {}
    with np.load(base + ".npz") as data:
        for key in data.files:
            k, sub = key.rsplit("::", 1)
            lora.setdefault(k, {})[sub] = torch.as_tensor(
                np.asarray(data[key]), device=device)
    with open(base + ".json") as f:
        raw = json.load(f)
    raw["target_patterns"] = tuple(raw["target_patterns"])
    return lora, LoRASpec(**raw)


# ---------------------------------------------------------------------------
# Soft-prompt tuning
# ---------------------------------------------------------------------------
def init_soft_prompt(model: torch.nn.Module, num_tokens: int,
                     generator: torch.Generator) -> torch.Tensor:
    """[P, H] fp32 virtual-token embeddings: random rows of the model's
    embedding table (rows in the distribution the first layer expects),
    drawn from `generator` on its device."""
    table = model.embedder.embedding
    idx = torch.randint(0, table.shape[0], (num_tokens,),
                        generator=generator, device=generator.device)
    return table.detach()[idx.to(table.device)].float().clone()


def prepend_soft_prompt(model: torch.nn.Module, prompt: torch.Tensor,
                        input_ids: torch.Tensor, return_hidden: bool = False):
    """The model's no-cache forward with `prompt` [P, H] before every
    sequence of input_ids [B, S]: (logits [B, S, V], or the final-normed
    hidden [B, S, H] with return_hidden, for the real tokens only; aux).
    Warns when S + P is not flash-eligible: attention then takes the
    plain path (JAX adapters.py:269-287)."""
    from luminaai_tpu_torch.ops.flash_attention import flash_eligible

    cfg = model.config
    B, S = input_ids.shape
    P = prompt.shape[0]
    if cfg.use_flash_attention and not flash_eligible(
            S + P, cfg.head_dim(), cfg.flash_block_q, cfg.flash_block_kv):
        logger.warning(
            "soft prompt of %d tokens makes seq %d flash-ineligible (no "
            "block divisor >= 128): attention takes the plain O(S^2) path; "
            "pick P so S+P has a divisor >= 128 that is <= the configured "
            "flash blocks (e.g. a multiple of 128)", P, S + P)
    return model(input_ids, return_hidden=return_hidden,
                 prefix_embeds=prompt[None].expand(B, P, prompt.shape[1]))


def make_prompt_tuning_step(config: Config, model: torch.nn.Module,
                            tx: AdamW):
    """The step training only the [P, H] prompt (JAX adapters.py:289-319).

    The model is frozen here (requires_grad=False: no .grad, no moments).
    Returns step((prompt, opt_state), batch) -> ((prompt, opt_state),
    metrics), with opt_state = tx.init([prompt]); the prompt and its
    moments update in place. The loss is JAX's: next-token CE over the
    real tokens (shifted labels, loss_mask / loss_weights shifted with
    them; the fused LM-head CE where config.fused_lm_head_ce) plus the
    MoE aux loss; metrics are the CE's plus `loss` and `grad_norm`, the
    prompt gradient's norm."""
    from luminaai_tpu_torch.parallel.train_step import (
        _ce,
        _shifted_mask_weights,
        shift_labels,
    )

    model.requires_grad_(False)

    def step(carry, batch):
        prompt, opt_state = carry
        leaf = prompt.requires_grad_(True)
        out, aux = prepend_soft_prompt(model, leaf, batch["input_ids"],
                                       return_hidden=config.fused_lm_head_ce)
        labels, valid = shift_labels(batch)
        mask, weights = _shifted_mask_weights(batch, valid)
        loss, metrics = _ce(config, model, out, labels, mask, weights)
        loss = loss + aux.get("aux_loss", 0.0)
        (grad,) = torch.autograd.grad(loss, [leaf])
        leaf.requires_grad_(False)
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = global_norm([grad])
        tx.apply([prompt], [grad], opt_state)
        return (prompt, opt_state), metrics

    return step
