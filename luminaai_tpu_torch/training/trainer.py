"""The training loop (port of luminaai_tpu/training/trainer.py).

`Trainer(config, train_data)` builds the trainable model on the card (or
the device it is given), seeds its weights, builds the schedule, AdamW and
the train step, and `train()` runs `total_steps` optimizer steps over the
batches of `train_data()` (a callable returning an iterator of
{"input_ids": [batch_size, seq_length], optional "loss_mask" /
"loss_weights"} numpy or torch batches; called again for each epoch: a
data/dataset.PrefetchLoader, whose state_dict is the exact-resume
cursor). Each step is synchronised to log loss, grad_norm, learning rate
and tokens/s; the per-step history also carries the MoE metrics.

The runtime around the loop, as in the JAX package:
  - checkpoints (training/checkpoint.py) every `save_every_n_batches`,
    overdue backups, a forced save at the end, and `maybe_resume` at
    construction (config.auto_resume): the num_experts guard, the walk
    back past a corrupt latest step, and the data loader fast-forwarded
    to the saved cursor, so a resumed run trains the same batches;
  - `request_stop` (the CLI's SIGTERM/SIGINT handler): stop at the next
    step boundary with a blocking emergency save;
  - evaluation every `eval_every_n_batches`, early stopping, and the
    Chinchilla convergence stop;
  - the non-finite fence: three non-finite losses in a row roll back to
    the newest checkpoint strictly before the first, or abort with an
    emergency save;
  - the adaptive hooks the orchestrator (training/orchestrator.py) calls
    from `step_callback`, which the loop calls at each log boundary with
    the step's scalars and the `expert_utilization` vector:
    adjust_learning_rate (a constant schedule, the moments kept),
    adjust_weight_decay (AdamW rebuilt over the same moments and count),
    set_grad_clip, adjust_capacity_factor, adjust_routing_temperature,
    enable_expert_dropout, adjust_mod_capacity (the MoD compute ratio;
    mod_statistics reads it back), set_data_difficulty (the loader's
    curriculum), rollback (to a checkpoint at or after
    `_min_restorable_step`) and evolve_experts (the model rebuilt with
    one expert more or fewer, the moments reset, the count kept at the
    step, older checkpoints fenced off, a forced save). Each rebuilds the
    steps it changes against `_active_schedule`, so an LR override
    survives later rebuilds, and records itself in `interventions`;
  - the router-health export at each log boundary (moe_expert_load
    {expert}, moe_router_entropy, moe_max_expert_share, moe_drop_rate
    gauges and a router_health event), from the values the step's sync
    already brought to the host;
  - `train_with_oom_protection`: on torch.cuda.OutOfMemoryError split the
    micro-batches (under pipeline stages: more pipeline microbatches),
    then halve the batch;
  - under an initialized process group (torchrun, one process a card) the
    mesh (parallel/mesh.py), the born-sharded state (parallel/sharding.py)
    and the sharded or pipelined step, whatever the mesh's size: each rank
    trains its rows of the global batch, a stop armed on any rank stops
    every rank at the same step, an OOM on any rank is agreed after the
    step (one all-reduce) so every rank takes the same rung, an expert
    evolution or a rollback rebuilds every rank's shards from the same
    whole state, `host_step_skew` runs at each log boundary, and rank 0
    alone writes the logs and checkpoints;
  - the goodput ledger (compile = the first step until its sync,
    data_wait, checkpoint, eval, resume_replay), the hang watchdog (armed
    after the first step), the step-time sentinel, the health monitor and
    the flight recorder, all on the process registry;
  - the SLO stack (config.slo: monitoring/slo.py's build_slo_stack, the
    time-series ring sampling the registry and the engine judging the
    train objectives; summary["slo"] carries the verdicts), and span
    tracing (`tracer`: checkpoint_save and evaluate spans);
  - epochs: with `steps_per_epoch`, total_steps is steps_per_epoch x
    num_epochs and the loop stops after num_epochs passes (the JAX CLI
    passes none, so `train --epochs` only records num_epochs, as there);
  - the profiling window (config.profile_start_step /
    profile_num_steps / profile_dir): a torch.profiler trace (CPU and
    CUDA) of exactly the steps [start, start + n), each marked
    "train_step <global step>", written as
    <dir>/steps<start>-<end>.pt.trace.json on rank 0, then attributed per
    subsystem (monitoring/attribution.py) into the registry and
    <dir>/attribution.jsonl;
  - config.compiled_cost_analysis: on one card, the first step runs
    under the FLOP counter (monitoring/attribution.compiled_cost_metrics:
    torch's counter plus the kernels' own counts, the allocator's peak,
    the analytic-vs-counted cross-check and the in-place audit of the
    state).

The summary keeps the JAX keys (final_step, epochs, elapsed_sec,
tokens_seen, tokens_per_sec, final_metrics, health, interventions,
preempted, resumed_exact_data_state, goodput, slo) and adds the per-step
history.

The scan-layer compile fallback is XLA's own and has no counterpart.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.convert import init_params
from luminaai_tpu_torch.models.transformer import LuminaTransformer
from luminaai_tpu_torch.monitoring.events import FlightRecorder, get_recorder
from luminaai_tpu_torch.monitoring.goodput import GoodputLedger
from luminaai_tpu_torch.monitoring.logger import TrainingHealthMonitor
from luminaai_tpu_torch.monitoring.slo import SLOEngine, build_slo_stack
from luminaai_tpu_torch.monitoring.telemetry import (
    MetricsRegistry,
    get_registry,
    register_build_info,
    weak_callback,
)
from luminaai_tpu_torch.monitoring.timeseries import (
    TimeSeriesRing,
    get_history,
    set_history,
)
from luminaai_tpu_torch.monitoring.tracing import NULL_TRACER, SpanTracer
from luminaai_tpu_torch.monitoring.watchdog import (
    HangWatchdog,
    StepTimeSentinel,
    host_step_skew,
)
from luminaai_tpu_torch.parallel.mesh import build_mesh, describe_mesh
from luminaai_tpu_torch.parallel.sharding import init_sharded_state
from luminaai_tpu_torch.parallel.train_step import (
    check_trainable,
    init_train_state,
    make_eval_step,
    make_sharded_eval_step,
    make_sharded_train_step,
    make_train_step,
    shard_batch,
)
from luminaai_tpu_torch.training.checkpoint import (
    CheckpointManager,
    MomentFormError,
)
from luminaai_tpu_torch.training.optimizer import (
    constant_schedule,
    make_optimizer,
    make_schedule,
)
from luminaai_tpu_torch.training.precision import PrecisionManager
from luminaai_tpu_torch.utils import profiling
from luminaai_tpu_torch.utils.retry import RetryPolicy, set_default_policy

logger = logging.getLogger(__name__)

Batches = Callable[[], Iterator[Dict[str, Any]]]


class Trainer:
    """Model + train state + loop + eval + checkpoints on one device, or
    over the mesh of an initialized process group (one rank a card)."""

    def __init__(
        self,
        config: Config,
        train_data: Batches,
        eval_data: Optional[Batches] = None,
        model: Optional[LuminaTransformer] = None,
        checkpoint_dir: Optional[str] = None,
        total_steps: Optional[int] = None,
        steps_per_epoch: Optional[int] = None,
        registry: Optional[MetricsRegistry] = None,
        tracer: Optional[SpanTracer] = None,
        recorder: Optional[FlightRecorder] = None,
        device=None,
        seed: Optional[int] = None,
    ):
        check_trainable(config)
        self.config = config
        self.train_data = train_data
        self.eval_data = eval_data
        ckpt_dir = checkpoint_dir or f"{config.output_dir}/checkpoints"
        self.seed = config.seed if seed is None else seed
        # Under an initialized process group: the mesh, and the sharded
        # state and step whatever the mesh's size (JAX trainer.py:165-177);
        # without one, the one-card path.
        self.mesh = None
        self._writer = not dist.is_initialized() or dist.get_rank() == 0
        if dist.is_initialized():
            self.mesh = build_mesh(config)
            device = self.mesh.device
            logger.info("training over %s", describe_mesh(self.mesh))
        if model is None and self.mesh is None:
            model = init_params(
                LuminaTransformer(config, device=device, trainable=True),
                self.seed,
            )
        self.model = model
        self.device = device if model is None else model.device
        self.precision = PrecisionManager(config)
        plan = self.precision.plan
        logger.info("precision %s: %s parameters, %s compute", plan.name,
                    plan.param_dtype, plan.compute_dtype)

        if total_steps is None:
            if config.max_steps:
                total_steps = config.max_steps
            elif steps_per_epoch:
                total_steps = steps_per_epoch * config.num_epochs
            else:
                total_steps = 10_000
        self.total_steps = total_steps
        self.steps_per_epoch = steps_per_epoch
        self.schedule = make_schedule(config, self.total_steps)
        self.tx = make_optimizer(config, self.total_steps, self.schedule)
        if self.mesh is not None:
            self.model, self.state = init_sharded_state(
                config, self.mesh, self.tx, self.seed, model=model)
        else:
            self.state = init_train_state(model, self.tx, self.seed)
        self.train_step = self._make_train_step(self.schedule)
        self.eval_step = self._make_eval_step()

        self.registry = registry or get_registry()
        self.tracer = tracer or NULL_TRACER
        self.recorder = recorder if recorder is not None else get_recorder()
        # Wall clock per cause (goodput), the hang watchdog and the
        # step-time sentinel: host clocks only, no new syncs.
        self.goodput = GoodputLedger(
            registry=self.registry, enabled=config.goodput
        )
        self.goodput.start("idle")
        self.watchdog: Optional[HangWatchdog] = None
        if config.watchdog:
            self.watchdog = HangWatchdog(
                kind="training",
                registry=self.registry,
                recorder=self.recorder,
                dump_dir=str(ckpt_dir),
                k=config.watchdog_k,
                floor_s=config.watchdog_floor_s,
                warmup=config.watchdog_warmup,
                poll_s=config.watchdog_poll_s,
                abort=config.watchdog_abort,
                ledger=self.goodput,
            )
        self._sentinel = StepTimeSentinel(
            registry=self.registry,
            recorder=self.recorder,
            prefix="train_step_seconds",
            program="train",
            k=config.step_anomaly_k,
            enabled=config.step_anomaly,
        )
        register_build_info(self.registry, config=config)
        # SLO layer: the ring keeps windowed registry history on a
        # background sampler (started by train()), the engine judges the
        # train objectives (or config.slo_config's) by burn rate. Host
        # side only: it reads what the producers already wrote.
        # (JAX's Trainer.history; here `history` is the per-step list.)
        self.timeseries: Optional[TimeSeriesRing] = None
        self.slo: Optional[SLOEngine] = None
        self._installed_history = False
        if config.slo:
            self.timeseries, self.slo = build_slo_stack(
                config, registry=self.registry, recorder=self.recorder,
                program="train",
            )
            # The first ring installed is the process default (`top`
            # with no source reads it); close() restores.
            self._prev_history = (
                set_history(self.timeseries) if get_history() is None
                else None
            )
            self._installed_history = get_history() is self.timeseries
        # Liveness: wall ts of the last completed optimizer step, NaN
        # outside a live loop or inside eval/checkpoint windows.
        self._last_step_wall: Optional[float] = None
        self._training_active = False

        def _liveness_ts(t: "Trainer") -> float:
            if not t._training_active or not t._last_step_wall:
                return float("nan")
            if t.goodput.current_cause() in ("eval", "checkpoint"):
                return float("nan")
            return t._last_step_wall

        self.registry.gauge(
            "train_last_step_ts",
            "Wall-clock timestamp of the last completed train step "
            "(NaN outside a live train loop or during eval/checkpoint "
            "windows)",
        ).set_function(weak_callback(self, _liveness_ts))
        self.checkpoints = CheckpointManager(
            config, ckpt_dir, registry=self.registry, recorder=self.recorder,
        )
        # The trainer owns the process-wide durable-I/O policy while it
        # lives (data readers without a Config use it); close() restores.
        self._prev_io_policy = set_default_policy(
            RetryPolicy.from_config(config, registry=self.registry)
        )
        r = self.registry
        self._m_steps = r.counter(
            "train_steps_total", "Optimizer steps executed this process"
        )
        self._m_tokens = r.counter(
            "train_tokens_total", "Tokens consumed by executed train steps"
        )
        self._m_recompiles = r.counter(
            "train_recompiles_total",
            "Train-step builds after the first (the OOM ladder's) and the "
            "first step, by cause",
            labelnames=("reason",),
        )
        self._m_step_time = r.histogram(
            "train_step_seconds",
            "Per-step wall time, averaged over each log window",
            buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                     10.0, 30.0, 60.0, 120.0),
        )
        self._m_tps = r.gauge(
            "train_tokens_per_sec", "Throughput over the last log window"
        )
        self._m_preemptions = r.counter(
            "preemptions_total",
            "Stop requests (SIGTERM/SIGINT preemption) honored at a step "
            "boundary with a blocking emergency save",
        )
        self.monitor = TrainingHealthMonitor(
            # Only rank 0 writes the step log.
            log_dir=f"{config.output_dir}/logs" if self._writer else None,
            loss_spike_threshold=config.loss_spike_threshold,
            grad_norm_threshold=config.grad_norm_threshold,
            health_check_interval=config.health_check_interval,
            registry=self.registry,
            recorder=self.recorder,
        )

        self.global_step = 0
        self.history: List[Dict[str, Any]] = []
        self._last_backup_time = time.time()
        self._convergence = None
        if config.use_chinchilla_scaling:
            from luminaai_tpu_torch.training.scaler import ConvergenceDetector

            self._convergence = ConvergenceDetector(
                patience=config.convergence_patience
            )
        self.best_eval_loss = float("inf")
        self._epochs_without_improvement = 0
        self._consecutive_nonfinite = 0
        self._first_nonfinite_step: Optional[int] = None
        self._lr_override: Optional[float] = None
        self._active_schedule = self.schedule  # reflects any LR override
        # Checkpoints older than this are shape-incompatible (expert
        # evolution changed the parameters) and must never be restored.
        self._min_restorable_step = 0
        self._interventions: list = []
        # Exact-resume data cursor, counted per TRAINED batch (the loader
        # prefetches ahead; only the consumer knows what entered a step).
        self._data_epoch = 0
        self._batch_in_epoch = 0
        self._resumed_exact_data_state = False
        self._stop_requested: Optional[str] = None
        self._preempted = False
        # True while the state, global_step and the data cursor disagree:
        # from the start of a step (the optimizer updates the parameters
        # and moments in place, one tensor at a time) until the cursor has
        # counted it, and while a rollback copies a checkpoint in or an
        # expert evolution swaps the model. A forced save must not
        # snapshot the state then.
        self._state_in_flux = False
        # The open profiling window's torch.profiler session, its dir.
        self._profiler = None
        self._profile_trace_dir: Optional[str] = None
        self._compiled_costs: Optional[Dict[str, Any]] = None
        # Orchestrator hook: called with (step, scalar metrics) at each
        # log boundary; may call the adaptive hooks below.
        self.step_callback: Optional[
            Callable[[int, Dict[str, Any]], None]] = None

        if config.auto_resume:
            self.maybe_resume()

    # -- checkpoint/resume ------------------------------------------------
    def maybe_resume(self) -> bool:
        step = self.checkpoints.get_resume_step()
        if step is None:
            return False
        # Architecture guard from the checkpoint's own metadata, before
        # any bytes are restored.
        saved_e = None
        try:
            saved_cfg = (self.checkpoints.load_metadata(step) or {}).get(
                "config", {}
            )
            if saved_cfg.get("use_moe"):
                saved_e = saved_cfg.get("num_experts")
        except Exception:
            pass  # unreadable metadata: the corrupt-restore path decides
        if saved_e is not None and saved_e != self.config.num_experts:
            raise ValueError(
                f"checkpoint at step {step} was saved with num_experts="
                f"{saved_e} (architecture evolved mid-run) but config has "
                f"{self.config.num_experts}; set num_experts={saved_e} to "
                "resume"
            )
        used = step
        try:
            with self.goodput.region("checkpoint"):
                self.state = self.checkpoints.restore(self.state, step)
        except MomentFormError:
            raise
        except Exception as e:
            # The latest checkpoint is corrupt or partial: count it and
            # walk back to the newest intact older step.
            self.checkpoints._m_fallbacks.inc()
            older = [s for s in self.checkpoints.all_steps()
                     if s < step and s >= self._min_restorable_step]
            if not older:
                raise
            logger.warning(
                "latest checkpoint (step %d) failed to restore (%s: %s); "
                "falling back to an older intact one",
                step, type(e).__name__, str(e)[:200],
            )
            with self.goodput.region("checkpoint"):
                self.state, used, _ = self.checkpoints.restore_with_fallback(
                    self.state, step=max(older),
                    min_step=self._min_restorable_step,
                )
        self.global_step = int(self.state.step)
        self._load_data_state(used)
        logger.info(
            "resumed from checkpoint at step %d (exact data state: %s)",
            self.global_step, self._resumed_exact_data_state,
        )
        return True

    def _data_state(self) -> Optional[Dict[str, Any]]:
        """The loader's exact-resume cursor, with epoch/batch_index from
        this loop's consumption counters. None when the data callable has
        no checkpointable state."""
        sd = getattr(self.train_data, "state_dict", None)
        if not callable(sd):
            return None
        try:
            state = dict(sd())
        except Exception as e:  # never let data state cost the checkpoint
            logger.warning("data state_dict failed: %s", e)
            return None
        state["epoch"] = self._data_epoch
        state["batch_index"] = self._batch_in_epoch
        return state

    def _load_data_state(self, step: int) -> None:
        """Fast-forward the loader to the cursor saved with `step`, so
        the resumed batch stream continues bitwise-identically."""
        self._resumed_exact_data_state = False
        try:
            meta = self.checkpoints.load_metadata(step) or {}
        except Exception:
            return
        ds_state = meta.get("data_state")
        if not ds_state:
            logger.warning(
                "checkpoint %d carries no data state; resumed batches may "
                "replay or skip data", step,
            )
            return
        ld = getattr(self.train_data, "load_state_dict", None)
        if not callable(ld):
            logger.warning(
                "data loader has no load_state_dict; resumed batches may "
                "replay or skip data"
            )
            return
        try:
            ld(dict(ds_state))
        except Exception as e:
            logger.warning("data state restore failed: %s", e)
            return
        self._data_epoch = int(ds_state.get("epoch", 0))
        self._batch_in_epoch = int(ds_state.get("batch_index", 0))
        self._resumed_exact_data_state = True
        logger.info(
            "data loader fast-forwarded to epoch %d batch %d",
            self._data_epoch, self._batch_in_epoch,
        )

    def save_checkpoint(self, metrics=None, force: bool = False) -> None:
        with self.tracer.span("checkpoint_save", step=self.global_step), \
                self.goodput.region("checkpoint"), self._wd_pause():
            self.checkpoints.save(
                self.state, self.global_step, metrics, force=force,
                data_state=self._data_state(),
            )

    def _wd_pause(self):
        """Watchdog pause across legitimately slow host work."""
        if self.watchdog is None:
            return contextlib.nullcontext()
        return self.watchdog.pause()

    def request_stop(self, reason: str = "preemption") -> None:
        """Arm a graceful stop at the NEXT step boundary (the SIGTERM /
        SIGINT path). Signal-handler-safe: only sets a flag; the loop
        does the blocking emergency save from its own thread."""
        self._stop_requested = reason or "preemption"

    def forced_save(self, reason: str) -> bool:
        """The second signal's save, run from the signal handler between
        two bytecodes of the loop. At a step boundary it is a blocking
        emergency save. Inside a step (or a rollback) the state is torn,
        so nothing is saved: the pending periodic commit is waited for
        and the newest committed checkpoint stands. True when it saved."""
        if self._state_in_flux:
            logger.warning(
                "%s inside step %d: the state is mid-update, keeping the "
                "newest committed checkpoint", reason, self.global_step + 1,
            )
            self.checkpoints.wait()
            return False
        ok = self.checkpoints.emergency_save(
            self.state, self.global_step, reason,
            data_state=self._data_state(),
        )
        self._dump_flight_record(reason)
        return ok

    def _count_recompile(self, reason: str) -> None:
        """Count a step rebuild by cause; a new step is a new timing
        regime for the sentinel and watchdog."""
        self._m_recompiles.labels(reason=reason or "config_change").inc()
        self.recorder.emit("recompile", step=self.global_step,
                           reason=reason or "config_change")
        self._sentinel.reset()
        if self.watchdog is not None:
            self.watchdog.skip_next()

    def _make_train_step(self, schedule):
        if self.mesh is not None:
            return make_sharded_train_step(self.config, self.model, schedule,
                                           self.tx, self.mesh)
        return make_train_step(self.config, self.model, schedule, self.tx)

    def _make_eval_step(self):
        if self.mesh is not None:
            return make_sharded_eval_step(self.config, self.model, self.mesh)
        return make_eval_step(self.config, self.model)

    def _rebuild_train_step(self, reason: str) -> None:
        self.train_step = self._make_train_step(self._active_schedule)
        self._count_recompile(reason)

    def _rebuild_steps(self, reason: str = "config_change") -> None:
        """Rebuild the train/eval steps against the (mutated) config and
        the active schedule (an LR override stays in force)."""
        self.eval_step = self._make_eval_step()
        self._rebuild_train_step(reason)

    def _stop_agreed(self) -> Optional[str]:
        """The stop request as every rank sees it: on a mesh of more than
        one rank a stop armed on any rank stops them all at the same step
        boundary (one scalar all-reduce a step)."""
        if self.mesh is None or self.mesh.size == 1:
            return self._stop_requested
        flag = torch.tensor([1.0 if self._stop_requested else 0.0],
                            device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        if flag.item() > 0 and not self._stop_requested:
            self._stop_requested = "preemption (another rank)"
        return self._stop_requested

    # -- adaptive hooks (called by the orchestrator) ----------------------
    def adjust_learning_rate(self, new_lr: float, reason: str = "") -> None:
        """Override the schedule with a constant LR. The Adam moments and
        count survive: only the learning-rate factor changes."""
        logger.warning("LR override -> %.3g (%s)", new_lr, reason)
        self._lr_override = new_lr
        self._active_schedule = constant_schedule(new_lr)
        self.tx = make_optimizer(self.config, self.total_steps,
                                 self._active_schedule)
        self._rebuild_train_step("lr_override")
        self._interventions.append(
            {"step": self.global_step, "kind": "lr_override", "lr": new_lr,
             "reason": reason})

    def evolve_experts(self, action: str, expert_idx: Optional[int] = None,
                       reason: str = "") -> bool:
        """Add or prune an MoE expert mid-run: parameter surgery
        (training/evolution.py) into a model rebuilt with num_experts ± 1,
        the Adam moments reset (the expert axis changed shape) with the
        count kept at the step, so the schedule does not replay warmup;
        older checkpoints are fenced off and a forced save banks the new
        architecture. False when the change is infeasible."""
        from luminaai_tpu_torch.training.evolution import (
            evolution_feasible,
            grow_expert,
            prune_expert,
        )

        cfg = self.config
        new_E = cfg.num_experts + (1 if action == "add_expert" else -1)
        ok, why = evolution_feasible(cfg, new_E)
        if not ok:
            logger.warning("expert evolution skipped: %s", why)
            return False
        params = self._whole_params()
        if action == "add_expert":
            gen = torch.Generator(device=self.device).manual_seed(
                int(self.seed) + self.global_step)
            new_params = grow_expert(params, gen)
        else:
            if expert_idx is None:
                raise ValueError("prune requires expert_idx")
            new_params = prune_expert(params, expert_idx)
        old = self.state
        self._state_in_flux = True
        cfg.num_experts = new_E
        self.tx = make_optimizer(cfg, self.total_steps,
                                 self._active_schedule)
        if self.mesh is not None:
            # Born sharded from the whole new parameters: every rank
            # keeps its slices of the one-rank surgery's result.
            model, state = init_sharded_state(cfg, self.mesh, self.tx,
                                              self.seed, params=new_params)
        else:
            model = LuminaTransformer(cfg, device=self.device,
                                      trainable=True)
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.copy_(new_params[name])
            state = init_train_state(model, self.tx, self.seed)
        del params, new_params
        self.model = model
        state.step = state.opt_state.count = old.step  # no warmup replay
        state.generator = old.generator  # the routing draws go on
        self.state = state
        del old
        self._rebuild_steps("expert_evolution")
        self._state_in_flux = False
        logger.warning("%s -> %d experts (%s); optimizer moments reset",
                       action, new_E, reason)
        self._interventions.append(
            {"step": self.global_step, "kind": action, "num_experts": new_E,
             "reason": reason})
        # Older checkpoints are now shape-incompatible: fence them off and
        # bank a restorable post-surgery checkpoint at once.
        self._min_restorable_step = self.global_step
        self.save_checkpoint(force=True)
        return True

    def _whole_params(self) -> Dict[str, torch.Tensor]:
        """{name: the one-rank parameter} on this rank's device. Over a
        mesh the shards gather to rank 0 and every rank receives the whole
        model (an expert evolution's surgery runs on every rank alike)."""
        if self.mesh is None:
            return dict(zip(self.state.names, self.state.params))
        full = self.state.gather_full()
        box = [None if full is None else dict(zip(full.names, full.params))]
        if self.mesh.size > 1:
            dist.broadcast_object_list(box, src=0)
        return {n: t.to(self.device) for n, t in box[0].items()}

    def adjust_capacity_factor(self, new_factor: float,
                               reason: str = "") -> None:
        """Change the MoE capacity factor (a shape of the expert buffers;
        the parameters are untouched)."""
        cfg = self.config
        if not cfg.use_moe:
            logger.warning("cannot adjust capacity factor: MoE not enabled")
            return
        old = cfg.capacity_factor
        cfg.capacity_factor = float(new_factor)
        self._rebuild_steps("capacity_factor")
        logger.warning("capacity factor %.2f -> %.2f (%s)", old, new_factor,
                       reason)
        self._interventions.append(
            {"step": self.global_step, "kind": "capacity_factor",
             "from": old, "to": new_factor, "reason": reason})

    def adjust_routing_temperature(self, new_temp: float,
                                   reason: str = "") -> None:
        """Change the MoE routing temperature (higher = more uniform)."""
        cfg = self.config
        if not cfg.use_moe:
            logger.warning("cannot adjust routing temperature: MoE not "
                           "enabled")
            return
        old = cfg.routing_temperature
        cfg.routing_temperature = float(new_temp)
        self._rebuild_steps("routing_temperature")
        logger.warning("routing temperature %.2f -> %.2f (%s)", old,
                       new_temp, reason)
        self._interventions.append(
            {"step": self.global_step, "kind": "routing_temperature",
             "from": old, "to": new_temp, "reason": reason})

    def mod_statistics(self) -> Dict[str, Any]:
        """MoD routing efficiency: the configured capacity, the observed
        compute ratio (the health monitor's mod_compute_ratio series) and
        the implied dense-FFN compute savings."""
        if not self.config.use_mod:
            return {"error": "MoD not enabled"}
        summary = self.monitor.collector.get_metric_summary(
            "mod_compute_ratio")
        ratio = summary.get("current", self.config.mod_capacity_factor)
        return {
            "configured_capacity": self.config.mod_capacity_factor,
            "observed_compute_ratio": ratio,
            "compute_savings_vs_dense_ffn": round(1.0 - ratio, 4),
            "recent": summary,
        }

    def adjust_mod_capacity(self, new_capacity: float,
                            reason: str = "") -> None:
        """Change the MoD compute ratio (the share of tokens that get the
        full FFN). It is a shape of the routed buffers, so the steps are
        rebuilt; the parameters are untouched."""
        cfg = self.config
        if not cfg.use_mod:
            logger.warning("cannot adjust MoD capacity: MoD not enabled")
            return
        new_capacity = float(new_capacity)
        if not 0.0 < new_capacity <= 1.0:
            raise ValueError(
                f"mod_capacity_factor {new_capacity} not in (0, 1]")
        old = cfg.mod_capacity_factor
        cfg.mod_capacity_factor = new_capacity
        self._rebuild_steps("mod_capacity")
        logger.warning("MoD capacity %.2f -> %.2f (%s)", old, new_capacity,
                       reason)
        self._interventions.append(
            {"step": self.global_step, "kind": "mod_capacity",
             "from": old, "to": new_capacity, "reason": reason})

    def enable_expert_dropout(self, rate: float, reason: str = "") -> None:
        """Whole-expert dropout mid-run to break expert collapse; rate 0
        disables. The draws come from the step's generator (one uniform
        per expert, MoELayer.draw_routing)."""
        cfg = self.config
        if not cfg.use_moe:
            logger.warning("cannot enable expert dropout: MoE not enabled")
            return
        rate = float(rate)
        if not 0.0 <= rate <= 0.5:
            raise ValueError(f"expert_dropout_rate {rate} not in [0, 0.5]")
        old = cfg.expert_dropout_rate
        cfg.expert_dropout_rate = rate
        # Evaluation routes deterministically: only the train step changes.
        self._rebuild_train_step("expert_dropout")
        logger.warning("expert dropout %.2f -> %.2f (%s)", old, rate, reason)
        self._interventions.append(
            {"step": self.global_step, "kind": "expert_dropout",
             "from": old, "to": rate, "reason": reason})

    def adjust_weight_decay(self, new_wd: float, reason: str = "") -> None:
        """Change AdamW weight decay mid-run: AdamW rebuilt against the
        mutated config; the moments and count carry over untouched."""
        old = self.config.weight_decay
        self.config.weight_decay = float(new_wd)
        self.tx = make_optimizer(self.config, self.total_steps,
                                 self._active_schedule)
        self._rebuild_train_step("weight_decay")
        logger.warning("weight decay %.3g -> %.3g (%s)", old, new_wd, reason)
        self._interventions.append(
            {"step": self.global_step, "kind": "weight_decay",
             "from": old, "to": new_wd, "reason": reason})

    def set_grad_clip(self, norm: float, reason: str = "") -> None:
        """Change the gradient-clip norm mid-run."""
        old = self.config.grad_clip_norm
        self.config.grad_clip_norm = norm
        self._rebuild_train_step("grad_clip")
        logger.warning("grad clip %.3g -> %.3g (%s)", old, norm, reason)
        self._interventions.append(
            {"step": self.global_step, "kind": "grad_clip", "from": old,
             "to": norm, "reason": reason})

    def set_data_difficulty(self, difficulty: float,
                            reason: str = "") -> bool:
        """Forward the curriculum difficulty to the data loader (its
        set_difficulty; PackedDataset maps it to a doc-length quantile).
        Takes effect at the next epoch; nothing is rebuilt."""
        target = getattr(self.train_data, "set_difficulty", None)
        applied = bool(callable(target) and target(difficulty) is not False)
        if applied:
            logger.info("data difficulty -> %.2f (%s)", difficulty, reason)
            self._interventions.append(
                {"step": self.global_step, "kind": "curriculum",
                 "to": round(float(difficulty), 3), "reason": reason})
        return applied

    # -- OOM ladder -------------------------------------------------------
    def adjust_microbatch(self, factor: int = 2, reason: str = "") -> bool:
        """Split the batch into more micro-batches (OOM relief): the same
        math, ~1/factor of the activation memory. False when the batch
        cannot split further."""
        cfg = self.config
        if cfg.pipeline_parallel_size > 1:
            # Under pipeline stages the memory knob is the microbatch
            # count (JAX trainer.py:643-660).
            old = cfg.pipeline_microbatches or cfg.pipeline_parallel_size
            new_micro = old * factor
            if not self._splits(cfg.batch_size, new_micro):
                logger.warning("cannot raise pipeline microbatches to %d "
                               "(batch %d)", new_micro, cfg.batch_size)
                return False
            cfg.pipeline_microbatches = new_micro
            self._rebuild_steps("microbatch_split")
            logger.warning("pipeline microbatch split: %d -> %d (%s)", old,
                           new_micro, reason)
            self._interventions.append(
                {"step": self.global_step, "kind": "microbatch_split",
                 "from": old, "to": new_micro, "reason": reason})
            return True
        new_accum = cfg.gradient_accumulation_steps * factor
        if not self._splits(cfg.batch_size, new_accum):
            logger.warning("cannot raise grad accum to %d (batch %d)",
                           new_accum, cfg.batch_size)
            return False
        old = cfg.gradient_accumulation_steps
        cfg.gradient_accumulation_steps = new_accum
        self._rebuild_steps("microbatch_split")
        logger.warning("microbatch split: accum %d -> %d (%s)", old,
                       new_accum, reason)
        self._interventions.append(
            {"step": self.global_step, "kind": "microbatch_split",
             "from": old, "to": new_accum, "reason": reason})
        return True

    def adjust_batch_size(self, new_batch_size: int, reason: str = "") -> bool:
        """Change the batch mid-run, rescaling the accumulation so the
        micro-batch (the memory knob) stays the same size. The data
        callable must honor config.batch_size at its next epoch."""
        cfg = self.config
        if new_batch_size == cfg.batch_size:
            return True
        ways = (self.mesh.axis_size("data", "fsdp")
                if self.mesh is not None else 1)
        if new_batch_size % ways:
            logger.warning("batch size %d not divisible by the %d-way batch "
                           "sharding (data x fsdp); refusing",
                           new_batch_size, ways)
            return False
        old_bs, old_accum = cfg.batch_size, cfg.gradient_accumulation_steps
        new_accum = old_accum
        if cfg.pipeline_parallel_size > 1:
            # Keep the pipeline microbatch's rows (the memory knob under
            # pipeline stages; JAX trainer.py:709-717).
            old_micro = cfg.pipeline_microbatches or cfg.pipeline_parallel_size
            rows = max(1, old_bs // old_micro)
            new_micro = max(1, new_batch_size // rows)
            while new_batch_size % new_micro != 0 and new_micro > 1:
                new_micro -= 1
            cfg.pipeline_microbatches = new_micro
        else:
            micro = max(1, old_bs // old_accum)
            new_accum = max(1, new_batch_size // micro)
            while new_batch_size % new_accum != 0 and new_accum > 1:
                new_accum -= 1
        cfg.batch_size = new_batch_size
        cfg.gradient_accumulation_steps = new_accum
        self._rebuild_steps("batch_size")
        logger.warning("batch size %d -> %d (accum %d -> %d) (%s)", old_bs,
                       new_batch_size, old_accum, new_accum, reason)
        self._interventions.append(
            {"step": self.global_step, "kind": "batch_size", "from": old_bs,
             "to": new_batch_size, "accum": new_accum, "reason": reason})
        return True

    def _splits(self, batch_size: int, micro: int) -> bool:
        """Whether `batch_size` splits into `micro` micro-batches, each
        over the mesh's batch ranks."""
        ways = (self.mesh.axis_size("data", "fsdp")
                if self.mesh is not None else 1)
        return (micro <= batch_size and batch_size % micro == 0
                and (batch_size // micro) % ways == 0)

    def _oom_agreed(self, error: Optional[BaseException]) -> None:
        """After every step over a mesh of more than one rank: one MAX
        all-reduce of this rank's OOM flag; when any rank ran out of
        memory every rank raises, so all take the same rung of the
        ladder. A rank whose OOM struck inside one of the step's
        collectives leaves the others waiting until the group's timeout."""
        flag = torch.tensor([1.0 if error is not None else 0.0],
                            device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        if flag.item() > 0:
            if error is not None:
                raise error
            raise torch.cuda.OutOfMemoryError(
                "out of memory on another rank (agreed after the step)")

    def train_with_oom_protection(
        self, max_attempts: Optional[int] = None
    ) -> Dict[str, Any]:
        """OOM backoff ladder around train(): on torch.cuda.OutOfMemoryError
        first split micro-batches, then halve the batch; each rung
        rebuilds the step and continues from the live state."""
        if max_attempts is None:
            max_attempts = max(2, self.config.max_retries * 2)
        for attempt in range(1, max_attempts + 1):
            try:
                return self.train()
            except torch.cuda.OutOfMemoryError as e:
                logger.warning("OOM on attempt %d/%d: %s", attempt,
                               max_attempts, str(e).splitlines()[0][:200])
                if self.device.type == "cuda":
                    torch.cuda.empty_cache()
                if self.adjust_microbatch(2, reason="oom_backoff"):
                    continue
                new_bs = self.config.batch_size // 2
                if new_bs >= 1 and self.adjust_batch_size(
                        new_bs, reason="oom_backoff"):
                    continue
                raise
        raise RuntimeError(f"still OOM after {max_attempts} backoff attempts")

    def rollback(self, to_step: Optional[int] = None,
                 reason: str = "") -> bool:
        """Restore the newest checkpoint at or before `to_step` and at or
        after `_min_restorable_step` (saves from before an expert
        evolution do not fit the model). A save still being written in
        the background is waited for and counts. The data stream goes
        on."""
        with self.goodput.region("checkpoint"), self._wd_pause():
            self.checkpoints.wait()
        candidates = [
            s for s in self.checkpoints.all_steps()
            if (to_step is None or s <= to_step)
            and s >= self._min_restorable_step
        ]
        target = max(candidates) if candidates else -1
        if self.mesh is not None and self.mesh.size > 1:
            # Rank 0 (the writer, its saves committed) picks the step for
            # every rank.
            t = torch.tensor([target], dtype=torch.int64, device=self.device)
            dist.broadcast(t, 0)
            target = int(t.item())
        if target < 0:
            return False  # never fall forward onto a possibly-tainted save
        self._state_in_flux = True
        with self.goodput.region("checkpoint"), self._wd_pause():
            self.state = self.checkpoints.restore(self.state, target)
        self.global_step = int(self.state.step)
        self._state_in_flux = False
        logger.warning("rolled back to step %d (%s)", target, reason)
        self._interventions.append(
            {"step": self.global_step, "kind": "rollback", "reason": reason})
        return True

    # -- data -------------------------------------------------------------
    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            t = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
            if k == "input_ids":
                t = t.long()
            out[k] = t.to(self.device, non_blocking=True)
        if self.mesh is not None:  # this rank's rows of a global batch
            out = shard_batch(out, self.mesh, self.config)
        return out

    def _goodput_batches(self, host_iter):
        """Loop time blocked on the loader (and the host->device copy) is
        data_wait; replay time the loader banked while fast-forwarding a
        resume is reattributed to resume_replay inside the open segment."""
        it = iter(host_iter)
        consume = getattr(
            self.train_data, "consume_resume_replay_seconds", None
        )
        while True:
            with self.goodput.region("data_wait"):
                try:
                    batch = self._to_device(next(it))
                except StopIteration:
                    return
                if consume is not None:
                    replay = consume()
                    if replay > 0:
                        self.goodput.reattribute("resume_replay", replay)
            yield batch

    # -- eval -------------------------------------------------------------
    def evaluate(self, max_batches: int = 100) -> Dict[str, float]:
        if self.eval_data is None:
            return {}
        totals: Dict[str, float] = {}
        count = 0
        self.model.eval()
        try:
            with self.tracer.span("evaluate", step=self.global_step) as sp, \
                    self.goodput.region("eval"), self._wd_pause():
                for i, batch in enumerate(self.eval_data()):
                    if i >= max_batches:
                        break
                    metrics = self.eval_step(self.state,
                                             self._to_device(batch))
                    for k, v in metrics.items():
                        if getattr(v, "ndim", 1) == 0:
                            totals[k] = totals.get(k, 0.0) + float(v)
                    count += 1
                sp.set(batches=count)
        finally:
            self.model.train()
        if count == 0:
            return {}
        out = {f"eval_{k}": v / count for k, v in totals.items()}
        out["eval_loss"] = out.get("eval_loss", out.get("eval_ce_loss", 0.0))
        return out

    # -- main loop ---------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        """Run to total_steps (or num_epochs passes with steps_per_epoch).
        Returns the summary dict."""
        try:
            self._last_step_wall = None
            self._training_active = True
            if self.timeseries is not None:
                self.timeseries.start()  # idempotent across train() calls
            return self._train_inner()
        finally:
            self._training_active = False
            if self.watchdog is not None:
                self.watchdog.disarm()
            self.goodput.switch("idle")

    def _train_inner(self) -> Dict[str, Any]:
        cfg = self.config
        self.model.train()
        t_start = time.time()
        tokens_seen = 0
        last_metrics: Dict[str, Any] = {}
        log_every = max(1, cfg.health_check_interval // 10)
        stop = False
        self._preempted = False
        epoch = 0
        self._run_start_step = self.global_step
        window_t0, window_tokens, window_steps = time.time(), 0, 0
        self.goodput.switch("productive")
        while not stop and self.global_step < self.total_steps:
            epoch += 1
            start = self.global_step
            for batch in self._goodput_batches(self.train_data()):
                if self.global_step >= self.total_steps:
                    break
                first_step = self.global_step == self._run_start_step
                self._maybe_profile()
                if first_step:
                    # The first step until its sync: kernel builds and
                    # loads, the allocator's warm-up.
                    self.goodput.switch("compile")
                n_tok = int(batch["input_ids"].numel())
                t0 = time.perf_counter()
                self._state_in_flux = True
                if self.mesh is None or self.mesh.size == 1:
                    if first_step and cfg.compiled_cost_analysis:
                        metrics = self._export_compiled_costs(batch)
                    else:
                        with self._step_mark():
                            self.state, metrics = self.train_step(
                                self.state, batch)
                else:
                    oom = None
                    try:
                        with self._step_mark():
                            self.state, metrics = self.train_step(
                                self.state, batch)
                    except torch.cuda.OutOfMemoryError as e:
                        oom = e
                    self._oom_agreed(oom)
                # Reading the values waits for the device: dt is the
                # whole step. Vector metrics (expert_utilization) stay
                # lists.
                scalars = {k: float(v) if v.ndim == 0 else v.tolist()
                           for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                self.global_step += 1
                self._batch_in_epoch += 1
                self._state_in_flux = False
                self._last_step_wall = time.time()
                tokens_seen += n_tok
                window_tokens += n_tok
                window_steps += 1
                self._m_steps.inc()
                self._m_tokens.inc(n_tok)
                scalars["step_seconds"] = dt
                scalars["tokens_per_sec"] = n_tok / max(dt, 1e-9)
                self.history.append(scalars)
                self._maybe_end_profile()
                logger.info(
                    "step %d loss=%.4f grad_norm=%.4f lr=%.3e tokens/s=%.1f",
                    self.global_step, scalars["loss"], scalars["grad_norm"],
                    scalars.get("learning_rate", float("nan")),
                    scalars["tokens_per_sec"],
                )
                if first_step:
                    self._m_recompiles.labels(reason="initial_compile").inc()
                    self.goodput.switch("productive")
                    if self.watchdog is not None:
                        # Armed after the first step: its rolling stats
                        # see only steady-state windows.
                        self.watchdog.arm()
                    window_t0, window_tokens, window_steps = time.time(), 0, 0

                if self.global_step % log_every == 0:
                    logged = {k: v for k, v in scalars.items()
                              if isinstance(v, float)}
                    now = time.time()
                    if window_steps > 0:
                        logged["tokens_per_sec"] = window_tokens / max(
                            now - window_t0, 1e-9)
                        window_mean_s = (now - window_t0) / window_steps
                        self._m_step_time.observe(window_mean_s,
                                                  count=window_steps)
                        self._sentinel.observe(window_mean_s,
                                               step=self.global_step)
                    if self.watchdog is not None:
                        self.watchdog.beat()
                    # Straggler signal at this sync: one tiny all-gather
                    # across the ranks, 0.0 on one.
                    host_step_skew(self.registry)
                    self._m_tps.set(logged["tokens_per_sec"])
                    window_t0, window_tokens, window_steps = now, 0, 0
                    self.monitor.log_step(self.global_step, logged)
                    self._export_router_health(scalars, logged)
                    last_metrics = logged
                    if self.step_callback is not None:
                        cb_metrics = dict(logged)
                        if "expert_utilization" in scalars:
                            cb_metrics["expert_utilization"] = np.asarray(
                                scalars["expert_utilization"])
                        # May roll back or rebuild the model: the loop
                        # reads global_step, state and train_step anew.
                        self.step_callback(self.global_step, cb_metrics)
                    if not np.isfinite(logged.get("loss", 0.0)):
                        stop = self._handle_nonfinite()
                        if stop:
                            break
                    else:
                        self._consecutive_nonfinite = 0
                        self._first_nonfinite_step = None

                if (
                    self.eval_data is not None
                    and self.global_step % cfg.eval_every_n_batches == 0
                ):
                    eval_metrics = self.evaluate()
                    self.monitor.log_step(
                        self.global_step, eval_metrics, event="eval_step"
                    )
                    last_metrics.update(eval_metrics)
                    if self._check_early_stopping(
                            eval_metrics.get("eval_loss")):
                        stop = True
                        break
                    if (
                        self._convergence is not None
                        and eval_metrics.get("eval_loss") is not None
                        and self._convergence.update(
                            eval_metrics["eval_loss"], self.global_step
                        )
                    ):
                        logger.info(
                            "convergence detected at step %d; stopping "
                            "(chinchilla budget satisfied early)",
                            self.global_step,
                        )
                        stop = True
                        break
                    window_t0, window_tokens, window_steps = time.time(), 0, 0

                overdue_backup = (
                    cfg.backup_every_n_hours > 0
                    and time.time() - self._last_backup_time
                    > cfg.backup_every_n_hours * 3600
                )
                if (
                    (
                        self.global_step % cfg.save_every_n_batches == 0
                        or overdue_backup
                    )
                    and self._first_nonfinite_step is None
                ):
                    self.save_checkpoint(last_metrics, force=overdue_backup)
                    self._last_backup_time = time.time()
                    window_t0, window_tokens, window_steps = time.time(), 0, 0

                if self._stop_agreed():
                    # Preemption: a BLOCKING emergency save at this step
                    # boundary, then return with preempted=True.
                    reason = self._stop_requested
                    logger.warning(
                        "stop requested (%s): emergency save at step %d",
                        reason, self.global_step,
                    )
                    self._preempted = True
                    self._m_preemptions.inc()
                    self.recorder.emit(
                        "preemption", step=self.global_step, reason=reason,
                    )
                    with self.goodput.region("checkpoint"), self._wd_pause():
                        self.checkpoints.emergency_save(
                            self.state, self.global_step, reason=reason,
                            data_state=self._data_state(),
                        )
                        self._dump_flight_record(reason)
                    stop = True
                    break
            else:
                # Epoch iterator exhausted: one full data pass consumed.
                if self.global_step == start:
                    raise ValueError("train_data() yielded no batches")
                self._state_in_flux = True
                self._data_epoch += 1
                self._batch_in_epoch = 0
                self._state_in_flux = False

            if (
                self.steps_per_epoch is not None
                and epoch >= cfg.num_epochs
            ):
                break

        if not self._preempted:
            # A preempted run already banked its emergency checkpoint.
            final_eval = self.evaluate() if self.eval_data is not None else {}
            last_metrics.update(final_eval)
            self.save_checkpoint(last_metrics, force=True)
        with self.goodput.region("checkpoint"), self._wd_pause():
            self.checkpoints.wait()

        elapsed = time.time() - t_start
        summary = {
            "final_step": self.global_step,
            "epochs": epoch,
            "elapsed_sec": round(elapsed, 1),
            "tokens_seen": tokens_seen,
            "tokens_per_sec": round(tokens_seen / max(elapsed, 1e-9), 1),
            "final_metrics": dict(last_metrics),
            "health": self.monitor.get_health_summary(),
            "interventions": self._interventions,
            "preempted": self._preempted,
            "resumed_exact_data_state": self._resumed_exact_data_state,
            "goodput": self.goodput.snapshot(),
            "history": list(self.history),
        }
        if self.slo is not None:
            # The final verdicts over what the ring kept: one last sample,
            # so a short run whose sampler never ticked still carries the
            # objectives' states (the attached engine evaluates on it).
            self.timeseries.sample_once()
            summary["slo"] = {
                **self.slo.verdicts(),
                "ring": self.timeseries.stats(),
            }
        logger.info("training done: final_step=%d preempted=%s",
                    self.global_step, self._preempted)
        return summary

    # -- router health ----------------------------------------------------
    def _export_router_health(self, metrics, scalars) -> None:
        """Per-expert load and router telemetry at log cadence, from the
        values the step's sync already read: gauges moe_expert_load
        {expert} (share of kept routed tokens, sums to ~1.0),
        moe_router_entropy, moe_max_expert_share, moe_drop_rate, and one
        router_health event per log window."""
        util = metrics.get("expert_utilization")
        if util is None:
            return
        util = np.asarray(util, dtype=np.float64)
        E = int(util.shape[-1])
        total = float(util.sum())
        # expert_utilization is f*E (1.0 == balanced); normalize to the
        # kept-token share per expert so the loads sum to ~1.0.
        load = (util / total) if total > 0 else np.full(E, 1.0 / max(E, 1))
        r = self.registry
        if E <= 256:  # bounded gauge cardinality, whatever the config
            g = r.gauge(
                "moe_expert_load",
                "Share of kept routed tokens per expert (sums to ~1.0; "
                "1/E == balanced)",
                labelnames=("expert",),
                max_label_values=256,
            )
            for i in range(E):
                g.labels(expert=str(i)).set(float(load[i]))
        entropy = scalars.get("moe_router_entropy")
        if entropy is not None:
            r.gauge(
                "moe_router_entropy",
                "Mean per-token routing entropy (ln(num_experts) == "
                "uniform, 0 == collapsed)",
            ).set(entropy)
        max_share = scalars.get("moe_max_expert_share")
        if max_share is not None:
            r.gauge(
                "moe_max_expert_share",
                "Hottest expert's share of kept routed tokens",
            ).set(max_share)
        drop = scalars.get("moe_drop_rate")
        if drop is not None:
            r.gauge(
                "moe_drop_rate",
                "Fraction of tokens losing >=1 routing slot to capacity "
                "(capacity dispatch paths)",
            ).set(drop)
        self.recorder.emit(
            "router_health", step=self.global_step,
            expert_load=[round(float(x), 4) for x in load],
            entropy=(round(float(entropy), 4)
                     if entropy is not None else None),
            max_share=(round(float(max_share), 4)
                       if max_share is not None else None),
            drop_rate=round(float(drop), 4) if drop is not None else None,
        )

    # -- crash forensics ---------------------------------------------------
    def _dump_flight_record(self, reason: str) -> Optional[str]:
        """Dump the flight ring next to the checkpoints, and the
        time-series history with the SLO verdicts where the ring is on
        (`top <dir>` replays it). Never raises."""
        if self.timeseries is not None:
            self.timeseries.dump_to_dir(
                str(self.checkpoints.dir), reason,
                slo=self.slo.verdicts() if self.slo is not None else None,
            )
        return self.recorder.dump_to_dir(str(self.checkpoints.dir), reason)

    # -- profiling ----------------------------------------------------------
    def _maybe_profile(self) -> None:
        """Open the profiling window before the step at
        config.profile_start_step (rank 0; 0 disables). A profiler that
        fails to start costs a warning, not the run."""
        cfg = self.config
        if (not cfg.profile_start_step or self._profiler is not None
                or not self._writer
                or self.global_step != cfg.profile_start_step):
            return
        trace_dir = cfg.profile_dir or f"{cfg.output_dir}/profile"
        try:
            self._profiler = profiling.start_trace()
        except RuntimeError as e:  # a profiler already running
            logger.warning("profiler start failed: %s", e)
            return
        self._profile_trace_dir = trace_dir
        logger.info("profiler trace started -> %s", trace_dir)

    def _step_mark(self):
        """The open window's mark around one step ("train_step <global
        step>"); nothing outside a window."""
        if self._profiler is None:
            return contextlib.nullcontext()
        return profiling.annotate(f"train_step {self.global_step}")

    def _maybe_end_profile(self, force: bool = False) -> None:
        """Close the window after its last step (or at the end of the
        run) and attribute it."""
        cfg = self.config
        if self._profiler is None or not force and self.global_step < (
                cfg.profile_start_step + cfg.profile_num_steps):
            return
        prof, self._profiler = self._profiler, None
        start = cfg.profile_start_step
        path = profiling.stop_trace(
            prof, self._profile_trace_dir,
            f"steps{start}-{start + cfg.profile_num_steps}")
        logger.info("profiler trace stopped -> %s", path)
        self._attribute_profile(self._profile_trace_dir)

    def _attribute_profile(self, trace_dir: str) -> None:
        """Per-subsystem breakdown of the window just captured, into the
        registry and <trace_dir>/attribution.jsonl; a failure costs a
        warning, never the run."""
        from luminaai_tpu_torch.monitoring.attribution import (
            attribute_torch_trace_dir,
            export_attribution,
        )

        try:
            attr = attribute_torch_trace_dir(
                trace_dir, n_steps=max(1, self.config.profile_num_steps))
            export_attribution(
                attr, registry=self.registry,
                jsonl_path=os.path.join(trace_dir, "attribution.jsonl"),
            )
        except (OSError, RuntimeError, ValueError) as e:
            logger.warning("trace attribution unavailable: %s", e)
            return
        top = list(attr.ms_per_step.items())[:3]
        logger.info(
            "step attribution (%d steps, %.1f ms/step attributed): %s -> "
            "%s/attribution.jsonl", attr.n_steps, attr.total_ms_per_step,
            ", ".join(f"{k}={v:.1f}ms" for k, v in top), trace_dir)

    def _export_compiled_costs(self, batch) -> Dict[str, torch.Tensor]:
        """The first step, run under the FLOP counter
        (config.compiled_cost_analysis; monitoring/attribution.py):
        exports the counted FLOPs, the allocator's peak and the
        analytic-vs-counted cross-check, audits that the step updated the
        parameters and moments in place, and returns the step's metrics.
        One card only: over a mesh of more than one rank the first step
        runs uncounted."""
        from luminaai_tpu_torch.monitoring.attribution import (
            analytic_train_flops,
            compiled_cost_metrics,
            donation_audit,
            tree_bytes,
        )

        out: Dict[str, Any] = {}

        def step():
            with self._step_mark():
                self.state, out["metrics"] = self.train_step(self.state,
                                                             batch)

        result = compiled_cost_metrics(
            step, program="train", registry=self.registry, state=self.state,
            analytic_flops=analytic_train_flops(
                self.config.estimate_active_parameters(),
                int(batch["input_ids"].numel())),
        )
        audit = donation_audit(result.get("memory"), tree_bytes(self.state),
                               registry=self.registry)
        result["donation_audit"] = audit
        if audit.get("flagged"):
            logger.warning(
                "in-place audit: coverage %.2f < %.2f: the step replaces "
                "its state's storage", audit.get("coverage") or 0.0,
                audit.get("threshold", 0.0))
        xc = result.get("mfu_crosscheck") or {}
        if xc.get("flagged"):
            logger.warning(
                "analytic-vs-counted FLOPs diverge %.1f%% (analytic 6NT "
                "%.3e, counted %.3e)", 100 * xc["divergence"],
                xc["analytic_flops_per_step"], xc["compiled_flops_per_step"])
        else:
            logger.info("compiled cost analysis: %s", result)
        self._compiled_costs = result
        return out["metrics"]

    # -- failure handling --------------------------------------------------
    def _handle_nonfinite(self) -> bool:
        """NaN/Inf loss: after three in a row roll back strictly before
        the first detection, else abort with an emergency save. Saves are
        suppressed while a step is suspect."""
        self._consecutive_nonfinite += 1
        if self._first_nonfinite_step is None:
            self._first_nonfinite_step = self.global_step
        if self._consecutive_nonfinite < 3:
            logger.warning(
                "non-finite loss at step %d (%d consecutive)",
                self.global_step, self._consecutive_nonfinite,
            )
            return False
        safe = self._first_nonfinite_step - 1
        if self.rollback(to_step=safe, reason="non-finite loss x3"):
            self._consecutive_nonfinite = 0
            self._first_nonfinite_step = None
            return False
        logger.error(
            "no checkpoint at or before step %d; aborting with emergency save",
            safe,
        )
        self.recorder.emit(
            "train_abort", step=self.global_step,
            reason="non-finite loss, no rollback point",
        )
        with self.goodput.region("checkpoint"), self._wd_pause():
            self.checkpoints.emergency_save(
                self.state, self.global_step,
                "non-finite loss, no rollback point",
                data_state=self._data_state(),
            )
            self._dump_flight_record("non_finite")
        return True

    def _check_early_stopping(self, eval_loss: Optional[float]) -> bool:
        if eval_loss is None:
            return False
        if eval_loss < self.best_eval_loss - 1e-4:
            self.best_eval_loss = eval_loss
            self._epochs_without_improvement = 0
            return False
        self._epochs_without_improvement += 1
        patience = self.config.early_stopping_patience
        if patience is not None and self._epochs_without_improvement >= patience:
            logger.info("early stopping: no improvement in %d evals",
                        patience)
            return True
        return False

    def close(self) -> None:
        if self._profiler is not None:  # the run ended inside the window
            self._maybe_end_profile(force=True)
        if self.watchdog is not None:
            self.watchdog.close()
        if self.timeseries is not None:
            self.timeseries.stop()
            if (self._installed_history
                    and get_history() is self.timeseries):
                set_history(getattr(self, "_prev_history", None))
        self.checkpoints.close()
        self.goodput.stop()
        set_default_policy(self._prev_io_policy)
