"""Inputs made from the seed: weights, token batches, sub-seeds.

The benchmark makes the weights and hands the same values to the program
and to the plain reference. They are drawn on the device with a
torch.Generator, one call per kind of parameter (all layers of a kind at
once), in the fp32 the training model keeps; `weights` yields them kind by
kind so that a check can draw them again one kind at a time.

Parameter names are the port's state_dict keys (the program's interface);
the reference reads the same tensors by kind.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import torch

from portbench.lib.flops import Shapes

INIT_STD = 0.02


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


@dataclass(frozen=True)
class Kind:
    """One kind of parameter: per layer ([L, *shape]) or whole."""

    name: str
    shape: Tuple[int, ...]
    per_layer: bool
    std: Optional[float]  # None: ones (norm scales)
    leaf: str  # the port's key; {i} is the layer
    decays: bool  # AdamW's mask: matrices decay, norm scales do not


def kinds(s: Shapes) -> List[Kind]:
    h, d, f = s.hidden, s.head_dim, s.ffn
    out = [Kind("embedding", (s.vocab, h), False, INIT_STD,
                "embedder.embedding", True),
           Kind("attn_norm", (h,), True, None, "layers.{i}.attn_norm.scale",
                False),
           Kind("wqkv", (h, (s.heads + 2 * s.kv_heads) * d), True, INIT_STD,
                "layers.{i}.attention.wqkv", True),
           Kind("attn_wo", (s.heads * d, h), True, INIT_STD / math.sqrt(2),
                "layers.{i}.attention.wo", True),
           Kind("ffn_norm", (h,), True, None, "layers.{i}.ffn_norm.scale",
                False)]
    if s.experts:
        e = s.experts
        out += [Kind("router", (h, e), True, INIT_STD,
                     "layers.{i}.moe.router", True),
                Kind("ffn_wi", (e, h, 2 * f), True, INIT_STD,
                     "layers.{i}.moe.wi", True),
                Kind("ffn_wo", (e, f, h), True, INIT_STD / math.sqrt(2),
                     "layers.{i}.moe.wo", True)]
    else:
        out += [Kind("ffn_wi", (h, 2 * f), True, INIT_STD,
                     "layers.{i}.ffn.wi", True),
                Kind("ffn_wo", (f, h), True, INIT_STD / math.sqrt(2),
                     "layers.{i}.ffn.wo", True)]
    out.append(Kind("final_norm", (h,), False, None, "final_norm.scale",
                    False))
    return out


def leaf_names(kind: Kind, layers: int) -> List[str]:
    if not kind.per_layer:
        return [kind.leaf]
    return [kind.leaf.format(i=i) for i in range(layers)]


def weights(s: Shapes, seed: int, device) -> Iterator[Tuple[Kind,
                                                           torch.Tensor]]:
    """(kind, fp32 tensor [L, *shape] or [*shape]) in a fixed order, from
    one generator: the same seed gives the same values."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed,
                                                              "weights"))
    for k in kinds(s):
        full = ((s.layers,) if k.per_layer else ()) + k.shape
        if k.std is None:
            yield k, torch.ones(full, dtype=torch.float32, device=device)
        else:
            yield k, torch.randn(full, generator=gen, device=device,
                                 dtype=torch.float32).mul_(k.std)


def leaves(kind: Kind, t: torch.Tensor, layers: int
           ) -> List[Tuple[str, torch.Tensor]]:
    names = leaf_names(kind, layers)
    if not kind.per_layer:
        return [(names[0], t)]
    return list(zip(names, t.unbind(0)))


def batches(seed: int, n: int, batch: int, seq: int, vocab: int,
            device) -> torch.Tensor:
    """[n, batch, seq] token ids, uniform over [1, vocab), on the device."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "data"))
    return torch.randint(1, vocab, (n, batch, seq), generator=gen,
                         device=device, dtype=torch.int64)

