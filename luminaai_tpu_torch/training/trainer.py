"""The training loop (trimmed port of luminaai_tpu/training/trainer.py).

`Trainer(config, train_data)` builds the trainable model on the card (or
the device it is given), seeds its weights, builds the schedule, AdamW and
the train step, and `train()` runs `max_steps` optimizer steps over the
batches of `train_data()` (a callable returning an iterator of
{"input_ids": [batch_size, seq_length]} numpy or torch batches; called
again for each epoch). Each step is synchronised to log loss, grad_norm,
learning rate and tokens/s; the history also carries the MoE metrics
(aux/z losses, drop rate, router entropy, max expert share, and the
per-expert utilization as a list). The summary keeps the JAX keys
(final_step, epochs, elapsed_sec, tokens_seen, tokens_per_sec,
final_metrics) and adds the per-step history.

Not ported yet: checkpoints and resume, the OOM ladder, the watchdog,
goodput accounting, the adaptive orchestrator and evaluation scheduling
(the eval step itself is parallel/train_step.make_eval_step).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.convert import init_params
from luminaai_tpu_torch.models.transformer import LuminaTransformer
from luminaai_tpu_torch.parallel.train_step import (
    check_trainable,
    init_train_state,
    make_train_step,
)
from luminaai_tpu_torch.training.optimizer import make_optimizer, make_schedule
from luminaai_tpu_torch.training.precision import PrecisionManager

logger = logging.getLogger(__name__)

Batches = Callable[[], Iterator[Dict[str, Any]]]


class Trainer:
    def __init__(
        self,
        config: Config,
        train_data: Batches,
        model: Optional[LuminaTransformer] = None,
        total_steps: Optional[int] = None,
        device=None,
        seed: Optional[int] = None,
    ):
        check_trainable(config)
        self.config = config
        self.train_data = train_data
        seed = config.seed if seed is None else seed
        if model is None:
            model = init_params(
                LuminaTransformer(config, device=device, trainable=True),
                seed,
            )
        self.model = model
        self.device = model.device
        self.precision = PrecisionManager(config)
        plan = self.precision.plan
        logger.info("precision %s: %s parameters, %s compute", plan.name,
                    plan.param_dtype, plan.compute_dtype)
        self.total_steps = total_steps or config.max_steps or 10_000
        self.schedule = make_schedule(config, self.total_steps)
        self.tx = make_optimizer(config, self.total_steps, self.schedule)
        self.state = init_train_state(model, self.tx, seed)
        self.train_step = make_train_step(config, model, self.schedule,
                                          self.tx)
        self.global_step = 0
        self.history: List[Dict[str, float]] = []

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            t = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
            if k == "input_ids":
                t = t.long()
            out[k] = t.to(self.device, non_blocking=True)
        return out

    def train(self) -> Dict[str, Any]:
        """Run to total_steps. Returns the summary dict."""
        self.model.train()
        t_start = time.perf_counter()
        tokens_seen, epoch = 0, 0
        last: Dict[str, float] = {}
        while self.global_step < self.total_steps:
            epoch += 1
            start = self.global_step
            for batch in self.train_data():
                if self.global_step >= self.total_steps:
                    break
                batch = self._to_device(batch)
                n_tok = int(batch["input_ids"].numel())
                t0 = time.perf_counter()
                self.state, metrics = self.train_step(self.state, batch)
                # Reading the values waits for the device: dt is the
                # whole step. Vector metrics (expert_utilization) stay
                # lists.
                scalars = {k: float(v) if v.ndim == 0 else v.tolist()
                           for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                self.global_step += 1
                tokens_seen += n_tok
                scalars["step_seconds"] = dt
                scalars["tokens_per_sec"] = n_tok / max(dt, 1e-9)
                self.history.append(scalars)
                last = scalars
                logger.info(
                    "step %d loss=%.4f grad_norm=%.4f lr=%.3e tokens/s=%.1f",
                    self.global_step, scalars["loss"], scalars["grad_norm"],
                    scalars.get("learning_rate", float("nan")),
                    scalars["tokens_per_sec"],
                )
            if self.global_step == start:
                raise ValueError("train_data() yielded no batches")
        elapsed = time.perf_counter() - t_start
        return {
            "final_step": self.global_step,
            "epochs": epoch,
            "elapsed_sec": round(elapsed, 1),
            "tokens_seen": tokens_seen,
            "tokens_per_sec": round(tokens_seen / max(elapsed, 1e-9), 1),
            "final_metrics": dict(last),
            "history": list(self.history),
        }
