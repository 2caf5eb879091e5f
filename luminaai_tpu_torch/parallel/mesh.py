"""Device mesh and process-group plumbing (port of luminaai_tpu/parallel/mesh.py).

The JAX package lays its devices out as a `jax.sharding.Mesh` with six
named axes and lets XLA insert the collectives. The port runs one process
per card (torchrun), so the same six axes become a layout of the ranks:
rank r sits at the row-major position r of the mesh shape in
`config.mesh_axes` order (the last axis varies fastest, as the JAX CPU
mesh's reshape of `jax.devices()` places device r), and every set of axes
a layer reduces over gets its process groups, built once, by every rank,
in one order.

  - `mesh_shape_from_config` / `build_mesh` / `describe_mesh`: the JAX
    functions (:34, :68, :258) over ranks instead of devices; `Mesh.fsdp`
    is the `torch.distributed.device_mesh.DeviceMesh` FSDP2 shards over:
    (data x sequence, fsdp) for the ranks of one (expert, tensor) cell.
  - `initialize_multihost` (:231): `init_process_group` from torchrun's
    environment, or from the config's coordinator address, process id and
    process count; NCCL on `cuda:LOCAL_RANK`, gloo only where the caller
    passes device='cpu'. A failed NCCL start raises.
  - The collective wrappers (:136-190) over `torch.distributed` on a mesh
    group: `all_to_all`, `ppermute`, `psum_scatter`, `all_gather`, `psum`.
  - `use_mesh` / `active_mesh`: the mesh the current step runs under, read
    by the layers that need explicit collectives (ring attention, the MoE
    dispatches, tensor-parallel projections).
"""

from __future__ import annotations

import contextlib
import datetime
import itertools
import logging
import math
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from luminaai_tpu_torch.config import Config

logger = logging.getLogger(__name__)

MESH_AXES = ("data", "pipe", "fsdp", "expert", "sequence", "tensor")
# The sets of axes some layer reduces over; each gets its groups at build.
GROUP_AXES = (
    ("data",), ("pipe",), ("fsdp",), ("expert",), ("sequence",),
    ("tensor",),
    ("data", "fsdp"),                  # the batch shards (MoE statistics)
    ("data", "fsdp", "sequence"),      # the gradient reduction
    ("data", "fsdp", "expert"),        # a2a token shards
    ("expert", "tensor"),              # the MoE model-parallel partials
)
DEFAULT_TIMEOUT_S = 600.0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def mesh_shape_from_config(config: Config, n_devices: Optional[int] = None
                           ) -> Dict[str, int]:
    """Per-axis sizes; the data axis (-1) takes the ranks left over."""
    if n_devices is None:
        n_devices = world_size()
    fixed = {
        "pipe": config.pipeline_parallel_size,
        "fsdp": config.fsdp_parallel_size,
        "expert": config.expert_parallel_size,
        "sequence": config.sequence_parallel_size,
        "tensor": config.tensor_parallel_size,
    }
    model_parallel = math.prod(fixed.values())
    if n_devices % model_parallel != 0:
        raise ValueError(
            f"device count {n_devices} not divisible by model-parallel "
            f"product {model_parallel} (pipe×fsdp×expert×sequence×tensor)"
        )
    dp = config.data_parallel_size
    if dp == -1:
        dp = n_devices // model_parallel
    if dp * model_parallel != n_devices:
        raise ValueError(
            f"mesh {dp}×{model_parallel} != {n_devices} devices; set "
            "data_parallel_size=-1 to auto-size"
        )
    return {"data": dp, **fixed}


class Mesh:
    """The named layout of the ranks and its process groups.

    shape: {axis: size}; axes: the layout order; coords: this rank's
    position on each axis; device: this rank's card (or the CPU)."""

    def __init__(self, shape: Dict[str, int], axes: Sequence[str],
                 device: torch.device, rank: int = 0):
        self.shape = dict(shape)
        self.axes = tuple(axes)
        self.device = device
        self.rank = rank
        dims = [self.shape[a] for a in self.axes]
        self.size = math.prod(dims)
        self.coords = dict(zip(self.axes, _unravel(rank, dims)))
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._ranks: Dict[Tuple[str, ...], List[int]] = {}
        self._tiers: Dict[Tuple[str, int], tuple] = {}
        self.fsdp = None
        # The axes the MoE statistics average over (the batch's ranks);
        # () keeps them per rank (grad_reduce='hierarchical', as JAX).
        self.stat_axes: Tuple[str, ...] = ("data", "fsdp")

    def axis_size(self, *axes: str) -> int:
        return math.prod(self.shape[a] for a in axes)

    def axis_index(self, *axes: str) -> int:
        """This rank's row-major index over `axes` (in the given order),
        as JAX's axis_index over a tuple of axes."""
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group_ranks(self, axes: Sequence[str]) -> List[int]:
        """The global ranks of this rank's group over `axes`, in the
        order of their row-major index over `axes`. GROUP_AXES keep the
        mesh's axis order, so that order is the ascending global rank a
        process group numbers its members by."""
        return self._ranks.get(tuple(axes), [self.rank])

    def group(self, *axes: str):
        """The process group over `axes` holding this rank (None on a
        one-rank mesh: the collectives are then identities)."""
        return self._groups.get(tuple(axes))

    def tier_groups(self, axis: str, dcn: int):
        """(stage-1 group, stage-2 group) of this rank for `axis` factored
        as dcn x ici (JAX hierarchical_groups): stage 1 the contiguous
        in-node blocks, stage 2 the strided cross-node rails, each
        ordered by the axis index. Built at build_mesh for the config's
        expert_dcn_size and gradient_dcn_size."""
        return self._tiers.get((axis, dcn), (None, None))

    def dcn(self, axis: str) -> int:
        """The node count `axis` was factored by (1: one stage)."""
        return next((d for (a, d) in self._tiers if a == axis), 1)

    def _build_tiers(self, axis: str, dcn: int) -> None:
        n = self.shape[axis]
        if dcn <= 1 or n % dcn or (axis, dcn) in self._tiers:
            return
        ici = n // dcn
        stage1 = [[h * ici + i for i in range(ici)] for h in range(dcn)]
        stage2 = [[h * ici + i for h in range(dcn)] for i in range(ici)]
        others = [a for a in self.axes if a != axis]
        mine = [None, None]
        for fixed in itertools.product(
                *[range(self.shape[a]) for a in others]):
            base = dict(zip(others, fixed))
            for k, stage in enumerate((stage1, stage2)):
                for members in stage:
                    ranks = [self._rank_of({**base, axis: j})
                             for j in members]
                    grp = dist.new_group(ranks) if len(ranks) > 1 else None
                    if self.rank in ranks:
                        mine[k] = grp
        self._tiers[(axis, dcn)] = tuple(mine)

    def _rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in self.axes:
            r = r * self.shape[a] + coords[a]
        return r

    def _build_groups(self, backend_device: str) -> None:
        for axes in GROUP_AXES:
            others = [a for a in self.axes if a not in axes]
            mine = None
            for fixed in itertools.product(
                    *[range(self.shape[a]) for a in others]):
                base = dict(zip(others, fixed))
                ranks = []
                for var in itertools.product(
                        *[range(self.shape[a]) for a in axes]):
                    ranks.append(self._rank_of({**base, **dict(zip(axes,
                                                                   var))}))
                grp = None
                if self.size > 1 and len(ranks) > 1:
                    grp = dist.new_group(ranks)
                if self.rank in ranks:
                    mine = (grp, ranks)
            self._groups[axes], self._ranks[axes] = mine
        # FSDP2's mesh: replicate over data x sequence, shard over fsdp,
        # for each (pipe, expert, tensor) cell.
        from torch.distributed.device_mesh import DeviceMesh

        rep = ("data", "sequence")
        model = ("pipe", "expert", "tensor")
        rows = []
        for m in itertools.product(*[range(self.shape[a]) for a in model]):
            plane = []
            for r in itertools.product(*[range(self.shape[a]) for a in rep]):
                plane.append([
                    self._rank_of({**dict(zip(model, m)),
                                   **dict(zip(rep, r)), "fsdp": f})
                    for f in range(self.shape["fsdp"])])
            rows.append(plane)
        dm = DeviceMesh(backend_device, torch.tensor(rows),
                        mesh_dim_names=("model", "replicate", "shard"))
        self.fsdp = dm["replicate", "shard"]

    def __repr__(self) -> str:
        return describe_mesh(self)


def _unravel(r: int, dims: Sequence[int]) -> List[int]:
    out = []
    for d in reversed(dims):
        out.append(r % d)
        r //= d
    return list(reversed(out))


def build_mesh(config: Config, device: Optional[torch.device] = None) -> Mesh:
    """The named mesh over the initialized process group (one rank without
    one). Every rank must call it, in the same order of calls."""
    axes = tuple(config.mesh_axes)
    if sorted(axes) != sorted(MESH_AXES):
        raise ValueError(
            f"mesh_axes must be a permutation of {MESH_AXES}, got {axes}"
        )
    n = world_size()
    shape = mesh_shape_from_config(config, n)
    rank = dist.get_rank() if dist.is_initialized() else 0
    if device is None:
        device = current_device()
    mesh = Mesh(shape, axes, torch.device(device), rank)
    if dist.is_initialized():
        mesh._build_groups("cuda" if mesh.device.type == "cuda" else "cpu")
        mesh._build_tiers("expert", config.expert_dcn_size)
        mesh._build_tiers("data", config.gradient_dcn_size)
    return mesh


def batch_shard(config: Config) -> Tuple[int, int]:
    """(index, count) of this rank's share of the global batch: its
    position over the (data, fsdp) axes, without building the groups
    (the data loaders' process_index / process_count)."""
    n = world_size()
    shape = mesh_shape_from_config(config, n)
    rank = dist.get_rank() if dist.is_initialized() else 0
    coords = dict(zip(config.mesh_axes, _unravel(
        rank, [shape[a] for a in config.mesh_axes])))
    return (coords["data"] * shape["fsdp"] + coords["fsdp"],
            shape["data"] * shape["fsdp"])


def current_device() -> torch.device:
    """This rank's card (cuda:LOCAL_RANK), or the CPU under a gloo group."""
    if dist.is_initialized() and dist.get_backend() == "gloo":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return torch.device("cuda", local)


def initialize_multihost(config: Optional[Config] = None, device=None,
                         timeout_s: float = DEFAULT_TIMEOUT_S,
                         store=None) -> torch.device:
    """Start the process group and return this rank's device.

    torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, LOCAL_RANK)
    wins; else config.multihost with coordinator_address ('host:port'),
    process_id and num_processes; `store` (a FileStore in the tests)
    replaces the rendezvous. NCCL on cuda:LOCAL_RANK; gloo only where
    device='cpu' is passed. Nothing falls back: a failed start raises."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if dist.is_initialized():
        return torch.device("cpu") if cpu else current_device()
    backend = "gloo" if cpu else "nccl"
    kw = dict(backend=backend,
              timeout=datetime.timedelta(seconds=timeout_s))
    if not cpu:
        dev = current_device()
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    if store is not None:
        kw.update(store=store, rank=int(config.process_id),
                  world_size=int(config.num_processes))
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        kw["init_method"] = "env://"
    elif config is not None and config.multihost:
        if config.coordinator_address is None:
            raise ValueError("multihost needs coordinator_address host:port")
        kw.update(init_method=f"tcp://{config.coordinator_address}",
                  rank=int(config.process_id or 0),
                  world_size=int(config.num_processes or 1))
    else:
        return torch.device("cpu") if cpu else current_device()
    dist.init_process_group(**kw)
    logger.info("process group up: rank %d/%d (%s)", dist.get_rank(),
                dist.get_world_size(), backend)
    return torch.device("cpu") if cpu else current_device()


def describe_mesh(mesh: Mesh) -> str:
    """Human-readable mesh summary for logs and reports."""
    parts = [f"{a}={mesh.shape[a]}" for a in mesh.axes]
    return (f"Mesh[{' × '.join(parts)}] on {mesh.size} "
            f"{mesh.device.type} device(s)")


# --------------------------------------------------------------------------
# the thin collective wrappers (JAX mesh.py:136-190), on a mesh group
# --------------------------------------------------------------------------


def all_to_all(x: torch.Tensor, group, *, split_axis: int = 0,
               concat_axis: int = 0) -> torch.Tensor:
    """Tiled all-to-all (JAX tiled=True): x's `split_axis` splits into
    the group's size blocks, block j goes to member j, and the blocks
    received concatenate on `concat_axis` in member order.
    Differentiable (its backward is the reverse exchange)."""
    if group is None:
        return x
    from torch.distributed.nn.functional import all_to_all_single

    n = dist.get_world_size(group)
    xs = x.movedim(split_axis, 0).contiguous()
    out = all_to_all_single(torch.empty_like(xs), xs, group=group)
    blocks = out.reshape(n, xs.shape[0] // n, *xs.shape[1:])
    pieces = [b.movedim(0, split_axis) for b in blocks.unbind(0)]
    return torch.cat(pieces, dim=concat_axis)


class _Permute(torch.autograd.Function):
    """y = x sent to next[rank], received from prev; the backward sends
    the cotangent the other way (the transpose of ppermute)."""

    @staticmethod
    def forward(ctx, x, group, send_to, recv_from):
        ctx.group, ctx.send_to, ctx.recv_from = group, send_to, recv_from
        return _sendrecv(x, group, send_to, recv_from)

    @staticmethod
    def backward(ctx, g):
        return (_sendrecv(g.contiguous(), ctx.group, ctx.recv_from,
                          ctx.send_to), None, None, None)


def _sendrecv(x, group, send_to, recv_from):
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, send_to, group),
           dist.P2POp(dist.irecv, out, recv_from, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def ppermute(x: torch.Tensor, group, perm: Sequence[Tuple[int, int]]
             ) -> torch.Tensor:
    """`lax.ppermute` over a group: perm holds (source, destination)
    pairs of group members (indices into the group's ranks); every
    member sends once and receives once. Differentiable."""
    if group is None:
        return x
    ranks = dist.get_process_group_ranks(group)
    me = ranks.index(dist.get_rank())
    dst = {s: d for s, d in perm}
    src = {d: s for s, d in perm}
    return _Permute.apply(x, group, ranks[dst[me]], ranks[src[me]])


def psum_scatter(x: torch.Tensor, group, *, scatter_dimension: int = 0
                 ) -> torch.Tensor:
    """Sum over the group, this member keeping its tiled block of
    `scatter_dimension` (not differentiable: gradient sync only)."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    xs = x.movedim(scatter_dimension, 0).contiguous()
    out = torch.empty((xs.shape[0] // n, *xs.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, xs, group=group)
    return out.movedim(0, scatter_dimension)


def all_gather(x: torch.Tensor, group, *, axis: int = 0) -> torch.Tensor:
    """Tiled all-gather on `axis` in member order (not differentiable)."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    xs = x.movedim(axis, 0).contiguous()
    out = torch.empty((n * xs.shape[0], *xs.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, xs, group=group)
    return out.movedim(0, axis)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group, in place on a copy (not differentiable)."""
    if group is None:
        return x
    y = x.clone()
    dist.all_reduce(y, group=group)
    return y


# --------------------------------------------------------------------------
# differentiable collectives of the sharded forward (each group is the
# ranks that hold one replicated value or the partials of one sum)
# --------------------------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    """Identity forward; the backward sums the cotangents over the group
    (Megatron's f: a replicated input feeding per-rank partials)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    """Sum over the group forward; identity backward (Megatron's g: the
    partial outputs of a row-parallel product, consumed replicated)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherRows(torch.autograd.Function):
    """Tiled all-gather on `dim` forward; the backward keeps this rank's
    block of the cotangent (the gathered value is consumed replicated)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.n = x.shape[dim]
        return all_gather(x, group, axis=dim)

    @staticmethod
    def backward(ctx, g):
        i = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n).contiguous(), None, None


class _GatherSum(torch.autograd.Function):
    """Tiled all-gather on `dim` forward; the backward reduce-scatters the
    cotangent (every rank consumes the whole gathered value)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, axis=dim)

    @staticmethod
    def backward(ctx, g):
        return psum_scatter(g, ctx.group, scatter_dimension=ctx.dim), None, \
            None


class _MeanOver(torch.autograd.Function):
    """Mean over the group forward; the backward averages the cotangents
    (d/dx_j of sum_r J_r(mean))."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.n = dist.get_world_size(group)
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y / ctx.n

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g / ctx.n, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_rows(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    return x if group is None else _GatherRows.apply(x, group, dim)


def gather_sum(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    return x if group is None else _GatherSum.apply(x, group, dim)


def mean_over(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _MeanOver.apply(x, group)


# --------------------------------------------------------------------------
# the mesh the current step runs under
# --------------------------------------------------------------------------

_ACTIVE_MESH = threading.local()


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Run the enclosed forward/backward under `mesh` (active_mesh)."""
    prev = getattr(_ACTIVE_MESH, "mesh", None)
    _ACTIVE_MESH.mesh = mesh
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.mesh = prev


def active_mesh() -> Optional[Mesh]:
    """The Mesh whose use_mesh() encloses the caller, or None."""
    return getattr(_ACTIVE_MESH, "mesh", None)
