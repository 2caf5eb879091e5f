"""Pipeline stages (port of luminaai_tpu/parallel/pipeline.py).

Stage p of P holds layers [p L / P, (p + 1) L / P) (parallel/sharding.py's
'layers' -> pipe rule, applied at born-sharded init, so a stage never
builds another stage's layers). The batch splits into
`pipeline_microbatches` microbatches (config.normalize_parallelism folds
gradient accumulation into them) that flow through the stages. The
embedding, the final norm and the fused LM-head CE run on every stage's
copy of those parameters: stage 0 embeds, the last stage takes the CE,
and their gradients sum over the pipe group, as JAX psums its io
gradients.

The schedule is kept apart from the transport:

  - `schedule_actions` lists one step's (tick, stage, microbatch, kind)
    actions. Each stage runs its own order: GPipe ('gpipe') every forward,
    then the backwards in reverse (autograd back through them); 1F1B
    ('1f1b', PipeDream-flush) min(P - p - 1, n) warm-up forwards, then one
    forward and one backward in turn, then the cool-down backwards, so at
    most P - p microbatches are in flight on stage p. An action takes the
    first tick after those it waits for (a forward the previous stage's
    forward of its microbatch, a backward the next stage's backward).
  - `run_actions` executes the actions of the stages a process holds, in
    tick order, and after each tick passes the outputs on through a hop:
    `MeshHop` sends activations down and their gradients up over the
    mesh's pipe groups (one batch_isend_irecv a tick, its operations in
    one fixed order on every rank), `LocalHop` hands them over in one
    process. `virtual_pipeline_step` plays every stage in one process
    over LocalHop (the counterpart of ops/ring_attention.py's
    virtual_ring_attention), so the card runs everything but the send.

Each stage's work goes through the model's forward (`stage=`), so FSDP2's
root hooks gather the embedding and final norm. A forward stashes the
stage's autograd graph; its backward runs autograd from the stage's
output with the gradient that came back (the last stage from its loss),
so GPipe holds every microbatch's graph and 1F1B at most P - p.

The loss is JAX's: the CE in token-sum form over the global weight total
(computed from the whole batch first), the aux losses at 1 / n_micro
each, so gradients and metrics equal the one-stage step's over the same
microbatches (the CE exactly where every microbatch carries the same
weight, e.g. without a loss mask; the one-stage step averages
per-microbatch means). Metrics: the CE sums, summed over microbatches on
the last stage; the MoE and MoD metrics summed over each stage's layers
and microbatches, then over the stages, the `*_loss` keys over n_micro
and the others over the reporting layers x n_micro, as JAX reduces them.
Under FSDP2 every backward runs with the gradient sync off and one
reduce-scatter follows the last (torch.distributed.pipelining's
REDUCE_GRAD). Tensor, expert and sequence parallelism run inside a
stage as in the one-stage sharded step (their collectives within the
stage's ranks; stage 0's lookup and the last stage's CE vocab-parallel
over the tensor group); the routing draws of every microbatch and layer are
drawn first, in the one-stage step's order.
"""

from __future__ import annotations

import dataclasses
from collections import namedtuple
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.ops.fused import (
    clip_by_global_norm,
    fused_lm_head_ce_sums,
    global_norm,
)

Batch = Dict[str, torch.Tensor]
Action = namedtuple("Action", ["tick", "stage", "micro", "kind"])


def scan_segments(config: Config) -> List[Tuple[int, Tuple[int, ...], int]]:
    """The JAX scan_segments (models/transformer.py:138): the layer stack
    as homogeneous runs [(start, unit offsets, count)]."""
    L = config.num_layers
    kinds = [config.is_moe_layer(i) for i in range(L)]
    period = {"every_3rd": 3, "every_4th": 4}.get(
        config.moe_pattern if config.use_moe else "", 0)
    if period and L >= period:
        body = (L // period) * period
        segs = [(0, tuple(range(period)), L // period)]
        segs += [(i, (0,), 1) for i in range(body, L)]
        return segs
    segs, i = [], 0
    while i < L:
        j = i
        while j < L and kinds[j] == kinds[i]:
            j += 1
        segs.append((i, (0,), j - i))
        i = j
    return segs


def pipeline_compatible(config: Config) -> Tuple[bool, str]:
    """Whether the layer stack can be pipelined (the JAX function, :53):
    one homogeneous segment that divides over the stages."""
    if config.pipeline_parallel_size <= 1:
        return False, "pipeline_parallel_size is 1"
    segs = scan_segments(config)
    if len(segs) != 1 or len(segs[0][1]) != 1:
        return False, (
            f"layer stack is not one homogeneous segment (got {len(segs)} "
            "segments); use moe_pattern 'all' or 'none'")
    return True, ""


@dataclasses.dataclass(frozen=True)
class PipePlan:
    """P stages over n microbatches of `schedule` ('gpipe' | '1f1b')."""

    stages: int
    n_micro: int
    schedule: str
    num_layers: int

    def layers(self, stage: int) -> range:
        per = self.num_layers // self.stages
        return range(stage * per, (stage + 1) * per)


def plan_of(config: Config) -> PipePlan:
    ok, why = pipeline_compatible(config)
    if not ok:
        raise ValueError(f"config not pipeline-compatible: {why}")
    P = config.pipeline_parallel_size
    return PipePlan(P, config.pipeline_microbatches or P,
                    config.pipeline_schedule, config.num_layers)


def schedule_actions(schedule: str, stages: int, n_micro: int,
                     backward: bool = True) -> List[Action]:
    """Every action of one step in tick order (stage order within a
    tick): forward-only when not `backward` (evaluation)."""
    P, n = stages, n_micro
    orders = []
    for p in range(P):
        fwd = [("F", m) for m in range(n)]
        if not backward:
            order = fwd
        elif schedule == "gpipe":
            order = fwd + [("B", m) for m in reversed(range(n))]
        elif schedule == "1f1b":
            w = min(P - p - 1, n)
            order = fwd[:w]
            for m in range(n - w):
                order += [("F", w + m), ("B", m)]
            order += [("B", m) for m in range(n - w, n)]
        else:
            raise ValueError(f"invalid pipeline_schedule {schedule}")
        orders.append(order)
    done: Dict[Tuple[str, int, int], int] = {}
    pos, t, out = [0] * P, 0, []
    while any(pos[p] < len(orders[p]) for p in range(P)):
        ran = []
        for p in range(P):
            if pos[p] >= len(orders[p]):
                continue
            kind, m = orders[p][pos[p]]
            need = [("F", p, m)] if kind == "B" else []
            if kind == "F" and p > 0:
                need.append(("F", p - 1, m))
            if kind == "B" and p < P - 1:
                need.append(("B", p + 1, m))
            if all(done.get(d, t) < t for d in need):
                ran.append((kind, p, m))
                out.append(Action(t, p, m, kind))
                pos[p] += 1
        for d in ran:
            done[d] = t
        t += 1
    return out


def in_flight_peaks(actions: Sequence[Action], stages: int) -> List[int]:
    """The most microbatches forwarded and not yet backwarded on each
    stage at any tick of `actions`."""
    live, peak = [0] * stages, [0] * stages
    for a in actions:
        live[a.stage] += 1 if a.kind == "F" else -1
        peak[a.stage] = max(peak[a.stage], live[a.stage])
    return peak


class LocalHop:
    """Every stage in this process: an output is handed to the next
    (forward) or previous (backward) stage's mailbox."""

    def exchange(self, acts, outs, mailbox) -> None:
        for a, t in outs:
            if a.kind == "F":
                mailbox[(a.stage + 1, a.micro, "F")] = t
            else:
                mailbox[(a.stage - 1, a.micro, "B")] = t


class MeshHop:
    """This rank's stage over the mesh's pipe group: after each tick one
    batch_isend_irecv with this rank's sends and receives in action
    order (the same order on every rank of the group)."""

    def __init__(self, mesh, shape, dtype):
        self.mesh, self.shape, self.dtype = mesh, shape, dtype
        self.stage = mesh.coords["pipe"]

    def _peer(self, stage: int) -> int:
        return self.mesh._rank_of(dict(self.mesh.coords, pipe=stage))

    def exchange(self, acts, outs, mailbox) -> None:
        mine = {(a.stage, a.micro, a.kind): t for a, t in outs}
        ops, recvs = [], []
        for a in acts:
            key = (a.stage, a.micro, a.kind)
            if a.stage == self.stage and key in mine:
                to = a.stage + 1 if a.kind == "F" else a.stage - 1
                ops.append(dist.P2POp(dist.isend, mine[key].contiguous(),
                                      self._peer(to)))
            elif (a.kind == "F" and a.stage == self.stage - 1) or (
                    a.kind == "B" and a.stage == self.stage + 1):
                buf = torch.empty(self.shape, dtype=self.dtype,
                                  device=self.mesh.device)
                ops.append(dist.P2POp(dist.irecv, buf, self._peer(a.stage)))
                recvs.append(((self.stage, a.micro, a.kind), buf))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for key, buf in recvs:
            mailbox[key] = buf


def run_actions(actions: Sequence[Action], stages_here, work, hop) -> None:
    """Execute the actions of `stages_here` in tick order through
    `work` (forward(stage, micro) -> the activation to pass on or None;
    backward(stage, micro) -> the input gradient or None), passing each
    tick's outputs on through `hop`."""
    i = 0
    while i < len(actions):
        t = actions[i].tick
        acts = []
        while i < len(actions) and actions[i].tick == t:
            acts.append(actions[i])
            i += 1
        outs = []
        for a in acts:
            if a.stage not in stages_here:
                continue
            out = (work.forward if a.kind == "F" else work.backward)(
                a.stage, a.micro)
            if out is not None:
                outs.append((a, out))
        hop.exchange(acts, outs, work.mailbox)


def _add(acc: Dict[str, torch.Tensor], key: str, v: torch.Tensor) -> None:
    v = v.detach().float()
    acc[key] = acc[key] + v if key in acc else v


class _StageWork:
    """One step's per-microbatch work of the stages a process holds."""

    def __init__(self, config, model, plan: PipePlan, micro: List[Batch],
                 draws, w_total, n_red: float, train: bool, mesh=None,
                 fsdp: bool = False):
        self.cfg, self.model, self.plan = config, model, plan
        self.micro, self.draws, self.w_total = micro, draws, w_total
        self.n_red, self.train = n_red, train
        self.mesh, self.fsdp = mesh, fsdp
        self.mailbox: Dict = {}
        self.stash: Dict = {}
        self.ce = None                 # [4] sums on the last stage
        self.macc: Dict[str, torch.Tensor] = {}
        self.mcount: Dict[str, int] = {}

    def _call(self, fn):
        """fn(model) through the model's forward (FSDP2's root hooks)."""
        from luminaai_tpu_torch.parallel.mesh import use_mesh

        with use_mesh(self.mesh):
            return self.model(None, stage=fn)

    def forward(self, p: int, m: int):
        cfg, P = self.cfg, self.plan.stages
        last = p == P - 1
        x_in = None
        if p > 0:
            x_in = self.mailbox.pop((p, m, "F")).detach()
            if self.train:
                x_in.requires_grad_(True)
        b = self.micro[m]
        routing = self.draws[m] if self.draws is not None else None

        def body(model):
            x = model.embedder.encode(b["ids"]) if p == 0 else x_in
            x, mets = model.run_blocks(
                x, self.plan.layers(p),
                routing or [None] * cfg.num_layers, positions=None)
            aux = None
            for mt in mets:
                for k, v in mt.items():
                    _add(self.macc, k, v)
                    self.mcount[k] = self.mcount.get(k, 0) + 1
                    if k.endswith("_loss"):
                        aux = v if aux is None else aux + v
            sums = None
            if last:
                h = model.final_norm(x)
                sums = fused_lm_head_ce_sums(
                    h, model.embedder.head_weight(), b["labels"],
                    b["weights"],
                    label_smoothing=(cfg.label_smoothing if self.train
                                     else 0.0),
                    chunk_size=cfg.loss_chunk_size,
                    tensor_group=model.embedder.vocab_group())
            return x, aux, sums

        with torch.set_grad_enabled(self.train):
            x, aux, sums = self._call(body)
        if last:
            nll, w, z, n_tok = sums
            s4 = torch.stack([nll.detach(), w.detach(), z.detach(),
                              n_tok.detach()])
            self.ce = s4 if self.ce is None else self.ce + s4
        if not self.train:
            return None if last else x
        if last:
            zw = cfg.z_loss_weight
            obj = (sums[0] + zw * sums[2]) * (self.n_red / self.w_total)
            if aux is not None:
                obj = obj + aux * (1.0 / self.plan.n_micro)
            self.stash[(p, m)] = (x_in, [obj], [None])
            return None
        outs, grads = [x], [None]
        if aux is not None and aux.requires_grad:
            outs.append(aux)
            grads.append(torch.full_like(aux, 1.0 / self.plan.n_micro))
        self.stash[(p, m)] = (x_in, outs, grads)
        return x.detach()

    def backward(self, p: int, m: int):
        x_in, outs, grads = self.stash.pop((p, m))
        if p < self.plan.stages - 1:
            grads[0] = self.mailbox.pop((p, m, "B"))
        if self.fsdp:
            self.model.set_is_last_backward(False)
            self.model.set_reshard_after_backward(False)
            self.model.set_requires_gradient_sync(False)
        torch.autograd.backward(outs, None if grads[0] is None else grads)
        del outs, grads
        if x_in is None:
            return None
        g = x_in.grad
        return torch.zeros_like(x_in) if g is None else g


def _fsdp_reduce_grads(model) -> None:
    """The REDUCE_GRAD of torch.distributed.pipelining (stage.py
    perform_reduce_grad): after every backward ran with the sync off,
    reduce-scatter each unit's accumulated gradients and finish FSDP2's
    backward."""
    from torch.distributed.fsdp import fully_shard

    model.set_is_last_backward(True)
    model.set_reshard_after_backward(True)
    model.set_requires_gradient_sync(True)
    state = fully_shard.state(model)
    for st in state._state_ctx.all_states:
        groups = getattr(st, "_fsdp_param_groups", None)
        if groups is None:
            groups = [g for g in [getattr(st, "_fsdp_param_group", None)]
                      if g is not None]
        for g in groups:
            g.post_backward()
    state._root_post_backward_final_callback()


def _targets(config: Config, batch: Batch, n_micro: int, mesh
             ) -> Tuple[List[Batch], torch.Tensor]:
    """The microbatches (ids, labels and weights, this rank's sequence
    chunk) and the batch's local CE weight sum."""
    from luminaai_tpu_torch.parallel.train_step import (
        _shifted_mask_weights,
        shift_labels,
    )

    labels, valid = shift_labels(batch)
    mask, weights = _shifted_mask_weights(batch, valid)
    w = (mask if weights is None else mask * weights).float()
    ids = batch["input_ids"]
    if mesh is not None and mesh.shape["sequence"] > 1:
        sp, si = mesh.shape["sequence"], mesh.coords["sequence"]
        sl = ids.shape[1] // sp
        cut = slice(si * sl, (si + 1) * sl)
        ids, labels, w = ids[:, cut], labels[:, cut], w[:, cut]
    B = ids.shape[0]
    if B % n_micro:
        raise ValueError(f"batch of {B} rows does not split into {n_micro} "
                         "pipeline microbatches")
    mb = B // n_micro
    micro = [{"ids": ids[i * mb:(i + 1) * mb],
              "labels": labels[i * mb:(i + 1) * mb],
              "weights": w[i * mb:(i + 1) * mb]} for i in range(n_micro)]
    return micro, w.sum()


def _draws(config: Config, model, plan: PipePlan, micro, generator, mesh):
    """Every microbatch's routing draws, layer by layer ([micro][layer]),
    in the order the one-stage step draws them; None without MoE layers
    or draws."""
    from luminaai_tpu_torch.models.transformer import _draw_routing
    from luminaai_tpu_torch.parallel.mesh import use_mesh

    moe = next((layer.moe for layer in model.layers
                if hasattr(layer, "moe")), None)
    if moe is None:
        return None
    out = []
    with use_mesh(mesh):
        for b in micro:
            B, S = b["ids"].shape
            out.append([_draw_routing(moe, B, S, generator, b["ids"].device)
                        if config.is_moe_layer(i) else None
                        for i in range(config.num_layers)])
    return out


def _finish_metrics(config: Config, plan: PipePlan, work: _StageWork,
                    mesh, red_group, n_red: int, train: bool, device):
    """The step's global metrics from the stages' sums (JAX's reduction)."""
    from luminaai_tpu_torch.parallel.mesh import psum

    keys = sorted(work.mcount)
    ce = work.ce if work.ce is not None else torch.zeros(4, device=device)
    vals = [ce] + [work.macc[k].reshape(-1) for k in keys]
    counts = torch.tensor([float(work.mcount[k]) for k in keys] or [0.0],
                          device=device)
    if mesh is not None:
        pg = mesh.group("pipe")
        # Every stage must hold every key (homogeneous stages do).
        flat = torch.cat([v.float() for v in vals])
        flat = psum(flat, pg)
        counts = psum(counts, pg)
        ce_part = psum(flat[:4], red_group)
        rest = psum(flat[4:], red_group) / n_red
        vals = [ce_part]
        off = 0
        for k in keys:
            n = work.macc[k].numel()
            vals.append(rest[off:off + n].reshape(work.macc[k].shape))
            off += n
    else:
        vals = [vals[0]] + [work.macc[k] for k in keys]
    nll, w, z, n_tok = vals[0].unbind(0)
    denom = w.clamp(min=1.0)
    ce_loss = nll / denom
    out = {"ce_loss": ce_loss,
           "perplexity": torch.exp(ce_loss.clamp(max=20.0)),
           "tokens_in_loss": n_tok}
    total = ce_loss
    if train and config.z_loss_weight > 0.0:
        zl = z / denom * config.z_loss_weight
        total = total + zl
        out["z_loss"] = zl
    out["total_loss"] = total
    aux = torch.zeros((), dtype=torch.float32, device=device)
    for i, k in enumerate(keys):
        v = vals[1 + i]
        if k.endswith("_loss"):
            out[k] = v / plan.n_micro
            aux = aux + out[k]
        else:
            out[k] = v / float(counts[i])
    out["aux_loss"] = aux
    out["loss"] = total + aux
    return out


def _make_pipeline_step(config: Config, model, schedule, tx, plan: PipePlan,
                        mesh=None):
    """The train step over `plan`: on a mesh this rank's stage over
    MeshHop, else every stage in this process over LocalHop."""
    from luminaai_tpu_torch.parallel.mesh import psum
    from luminaai_tpu_torch.parallel.train_step import (
        local_grad,
        sharded_global_norm,
    )

    if not config.fused_lm_head_ce:
        raise ValueError("pipeline train step requires fused_lm_head_ce "
                         "(the LM head runs on the last stage's hidden "
                         "states)")
    actions = schedule_actions(plan.schedule, plan.stages, plan.n_micro)
    if mesh is not None:
        stages_here = {mesh.coords["pipe"]}
        red = ("data", "fsdp", "sequence")
        red_group, n_red = mesh.group(*red), mesh.axis_size(*red)
        mesh.stat_axes = ("data", "fsdp")
    else:
        stages_here = set(range(plan.stages))
        red_group, n_red = None, 1
    fsdp = hasattr(model, "set_requires_gradient_sync")

    def train_step(state, batch: Batch):
        micro, w_local = _targets(config, batch, plan.n_micro, mesh)
        w_total = psum(w_local, red_group).clamp(min=1.0)
        draws = _draws(config, model, plan, micro, state.generator, mesh)
        work = _StageWork(config, model, plan, micro, draws, w_total, n_red,
                          True, mesh, fsdp)
        if mesh is not None:
            ids = micro[0]["ids"]
            hop = MeshHop(mesh, (ids.shape[0], ids.shape[1],
                                 config.hidden_size), model.dtype)
        else:
            hop = LocalHop()
        run_actions(actions, stages_here, work, hop)
        if mesh is not None:
            if fsdp:
                _fsdp_reduce_grads(model)
            grads = [local_grad(p) for p in state.dparams]
            for p in state.dparams:
                p.grad = None
            pg = mesh.group("pipe")
            if pg is not None:  # the embedding and final norm's partials
                for i, n in enumerate(state.names):
                    if not n.startswith("layers."):
                        dist.all_reduce(grads[i], group=pg)
            grad_norm = sharded_global_norm(state, grads)
            if config.grad_clip_norm > 0:
                scale = torch.clamp(
                    config.grad_clip_norm / (grad_norm + 1e-6), max=1.0)
                grads = [(g * scale).to(g.dtype) for g in grads]
        else:
            grads = [p.grad if p.grad is not None
                     else torch.zeros_like(p) for p in state.params]
            for p in state.params:
                p.grad = None
            if config.grad_clip_norm > 0:
                grads, grad_norm = clip_by_global_norm(
                    grads, config.grad_clip_norm)
            else:
                grad_norm = global_norm(grads)
        metrics = _finish_metrics(config, plan, work, mesh, red_group, n_red,
                                  True, w_total.device)
        lr = state.apply_gradients(grads, tx)
        metrics["grad_norm"] = grad_norm
        if schedule is not None:
            metrics["learning_rate"] = torch.tensor(lr, dtype=torch.float32)
        return state, metrics

    train_step.actions = actions
    train_step.in_flight = in_flight_peaks(actions, plan.stages)
    return train_step


def _make_pipeline_eval(config: Config, model, plan: PipePlan, mesh=None):
    """eval(state, batch) -> global metrics: the forward-only schedule,
    deterministic, no z-loss or label smoothing (the one-stage eval's
    contract)."""
    from luminaai_tpu_torch.parallel.mesh import psum

    actions = schedule_actions(plan.schedule, plan.stages, plan.n_micro,
                               backward=False)
    if mesh is not None:
        stages_here = {mesh.coords["pipe"]}
        red = ("data", "fsdp", "sequence")
        red_group, n_red = mesh.group(*red), mesh.axis_size(*red)
    else:
        stages_here, red_group, n_red = set(range(plan.stages)), None, 1

    @torch.no_grad()
    def call(state, batch: Batch):
        micro, w_local = _targets(config, batch, plan.n_micro, mesh)
        w_total = psum(w_local, red_group).clamp(min=1.0)
        work = _StageWork(config, model, plan, micro, None, w_total, n_red,
                          False, mesh)
        if mesh is not None:
            ids = micro[0]["ids"]
            hop = MeshHop(mesh, (ids.shape[0], ids.shape[1],
                                 config.hidden_size), model.dtype)
        else:
            hop = LocalHop()
        run_actions(actions, stages_here, work, hop)
        return _finish_metrics(config, plan, work, mesh, red_group, n_red,
                               False, w_total.device)

    return call


def make_pipeline_train_step(config: Config, model, schedule, tx,
                             mesh=None):
    """The train step under pipeline_parallel_size > 1 (JAX
    make_pipeline_train_step): on a mesh this rank's stage of `model`
    over its batch rows (shard_batch), else every stage of the whole
    model in this process; the batch splits into the config's
    microbatches."""
    return _make_pipeline_step(config, model, schedule, tx, plan_of(config),
                               mesh)


def make_pipeline_eval_step(config: Config, model, mesh=None):
    """The pipelined eval step (JAX make_pipeline_eval_step)."""
    return _make_pipeline_eval(config, model, plan_of(config), mesh)


def virtual_plan(config: Config, stages: int, n_micro: int,
                 schedule: str) -> PipePlan:
    """A plan of `stages` stages over a one-process model (which need not
    carry pipeline_parallel_size itself: a gmm model, which JAX keeps off
    the pipe axis, still plays its stages in one process)."""
    if config.num_layers % stages:
        raise ValueError("num_layers must divide evenly over pipeline "
                         "stages")
    kinds = {config.is_moe_layer(i) for i in range(config.num_layers)}
    if len(kinds) != 1:
        raise ValueError("layer stack is not one homogeneous segment")
    return PipePlan(stages, n_micro, schedule, config.num_layers)


def virtual_pipeline_step(config: Config, model, schedule, tx, stages: int,
                          n_micro: int, pipeline_schedule: str = "1f1b"):
    """step(state, batch) over the whole one-process `model` and state
    (parallel.train_step.init_train_state) with every one of `stages`
    stages played in this process and the hops handed over locally: the
    same schedule, stage work, loss and update as a mesh's, without the
    sends. `step.in_flight` is each stage's most microbatches in flight."""
    return _make_pipeline_step(
        config, model, schedule, tx,
        virtual_plan(config, stages, n_micro, pipeline_schedule))


def virtual_pipeline_eval(config: Config, model, stages: int, n_micro: int,
                          pipeline_schedule: str = "1f1b"):
    """The pipelined eval over every stage in this process."""
    return _make_pipeline_eval(
        config, model,
        virtual_plan(config, stages, n_micro, pipeline_schedule))
