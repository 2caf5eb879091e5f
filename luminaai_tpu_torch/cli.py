"""Command line of the port: `python -m luminaai_tpu_torch serve|train|resume`.

  python -m luminaai_tpu_torch train --preset b1 --dense \\
      --data corpus.jsonl --packed --steps 1000 --output-dir runs/b1
  python -m luminaai_tpu_torch resume --preset b1 --dense \\
      --data corpus.jsonl --packed --steps 1000 --output-dir runs/b1
  python -m luminaai_tpu_torch serve --checkpoint runs/b1/checkpoints
  python -m luminaai_tpu_torch serve --preset b1 --moe-dispatch gmm --seed 0
  python -m luminaai_tpu_torch train --preset debug --moe-dispatch gmm \\
      --synthetic --steps 3 --device cpu --output-dir /tmp/run
  python -m luminaai_tpu_torch train --config run.json --no-adaptive

The presets are mixture-of-experts models, as in the JAX package; --dense
builds the preset's widths without experts. The model is built on the card
unless --device says otherwise.

`train` takes the JAX CLI's flags that apply to one card. It runs under
the AdaptiveTrainingOrchestrator (training/orchestrator.py) unless given
--no-adaptive, as the JAX CLI does: the orchestrator watches the loss,
grad norm and router metrics at each log boundary and may change the LR,
weight decay, clip norm, MoE capacity, routing temperature, expert
dropout, the data curriculum or the number of experts, or roll back; the
summary then carries its `adaptive_decisions` and loss `trajectory`.
--config FILE.json (or .yaml) loads a Config saved by either package in
place of --preset; the other flags override it. --data is a
jsonl of conversations, or with --packed a jsonl of {"text": ...}
documents tokenized once into a memmap TokenCache under
OUTPUT_DIR/cache/ and packed into [batch, seq] rows; without --data it
warns and trains on the synthetic pattern batches. Checkpoints go to
OUTPUT_DIR/checkpoints; a run whose output dir holds one resumes from it
(`resume` is `train` with --resume). The first SIGTERM or SIGINT stops at
the next step boundary with a blocking emergency checkpoint and exit 75
(RESUMABLE_EXIT: rerun `resume` with the same flags); a second one exits
75 at once, saving only when it lands between two steps. `serve --checkpoint DIR` serves the
newest step under DIR whose sha256 manifest verifies, with the model
config saved in it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import signal
import sys
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from luminaai_tpu_torch.config import Config, ConfigPresets, resolve_device

logger = logging.getLogger(__name__)

# Exit code for "stopped on a preemption signal with a resumable
# checkpoint banked" (EX_TEMPFAIL), distinct from success (0) and failure
# (1/2), so an orchestrator reschedules with `resume` instead of alerting.
RESUMABLE_EXIT = 75


def _moe_dispatch_flag(p: argparse.ArgumentParser) -> None:
    # The JAX train flag's choices (luminaai_tpu/cli.py); gather and einsum
    # are refused where the model is built (not ported yet).
    p.add_argument("--moe-dispatch", dest="moe_dispatch",
                   choices=["sort", "gather", "einsum", "gmm"],
                   help="MoE dispatch (default: the config's, 'sort'); "
                        "'gmm' runs the grouped-matmul kernel")


def _model_overrides(args) -> Dict[str, object]:
    overrides: Dict[str, object] = {}
    if getattr(args, "dense", False):
        overrides["use_moe"] = False
    if args.moe_dispatch is not None:
        overrides["moe_dispatch"] = args.moe_dispatch
    return overrides


def _train_flags(t: argparse.ArgumentParser) -> None:
    t.add_argument("--preset", default="debug",
                   choices=ConfigPresets.available())
    t.add_argument("--config",
                   help="json/yaml config file (in place of --preset)")
    t.add_argument("--experiment", help="experiment name")
    t.add_argument("--adaptive", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="run under the adaptive orchestrator")
    t.add_argument("--dense", action="store_true",
                   help="train the preset's widths without experts")
    _moe_dispatch_flag(t)
    t.add_argument("--data",
                   help="jsonl conversations (or text with --packed)")
    t.add_argument("--eval-data", dest="eval_data")
    t.add_argument("--packed", action="store_true",
                   help="treat --data as base-training text jsonl")
    t.add_argument("--synthetic", action="store_true",
                   help="train on the synthetic pattern batches")
    t.add_argument("--tokenizer",
                   help="tokenizer backend: byte | bpe:PATH")
    t.add_argument("--output-dir", dest="output_dir")
    t.add_argument("--auto-epochs", action="store_true",
                   help="chinchilla-style step budget from dataset size")
    t.add_argument("--oom-protect", dest="oom_protect",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="backoff ladder on device OOM (microbatch split, "
                        "then batch halving)")
    t.add_argument("--lr", type=float)
    t.add_argument("--batch-size", dest="batch_size", type=int)
    t.add_argument("--seq-length", dest="seq_length", type=int)
    t.add_argument("--steps", type=int, help="max optimizer steps")
    t.add_argument("--grad-accum", dest="grad_accum", type=int)
    t.add_argument("--precision",
                   choices=["fp32", "bf16", "mixed_bf16", "auto"])
    t.add_argument("--no-flash", action="store_true")
    t.add_argument("--seed", type=int, default=None,
                   help="random initial weights from this seed (default: "
                        "config seed)")
    t.add_argument("--device", default=None,
                   help="torch device (default: the card)")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m luminaai_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    s = sub.add_parser("serve", help="serve a model over HTTP")
    s.add_argument("--preset", default="b1", choices=ConfigPresets.available())
    s.add_argument("--dense", action="store_true",
                   help="serve the preset's widths without experts")
    _moe_dispatch_flag(s)
    w = s.add_mutually_exclusive_group()
    w.add_argument("--checkpoint",
                   help="training checkpoint dir (or its output dir): the "
                        "newest step whose manifest verifies, with its "
                        "saved config")
    w.add_argument("--weights", help=".npz of a flax parameter tree "
                                     "('/'-joined keys)")
    w.add_argument("--seed", type=int, default=None,
                   help="random weights from this seed (default: config seed)")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=5001)
    s.add_argument("--num-slots", type=int, default=8)
    s.add_argument("--page-size", type=int, default=128)
    s.add_argument("--device", default=None,
                   help="torch device (default: the card)")

    t = sub.add_parser("train", help="train a model")
    _train_flags(t)
    t.add_argument("--resume", action="store_true")
    t.set_defaults(resume=False)
    r = sub.add_parser("resume", help="resume training from an output dir")
    _train_flags(r)
    r.set_defaults(resume=True)
    return p


def _synthetic_batches(cfg: Config, n_batches: int = 200, seed: int = 0):
    """Learnable repeating-pattern batches, drawn exactly as the JAX CLI's
    _synthetic_batches draws them: deterministic per (seed, epoch) from
    numpy RandomState(seed + epoch), inside a PrefetchLoader that passes
    the epoch, so a synthetic run resumes exactly too."""
    from luminaai_tpu_torch.data.dataset import PrefetchLoader

    def gen(epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.RandomState(seed + epoch)
        period = min(64, cfg.vocab_size - 2)
        for _ in range(n_batches):
            starts = rng.randint(0, 32, size=(cfg.batch_size, 1))
            seq = (starts + np.arange(cfg.seq_length)) % period + 1
            yield {"input_ids": seq.astype(np.int32)}

    return PrefetchLoader(gen, prefetch=2)


def make_data(cfg: Config, args):
    """(train_fn, eval_fn, dataset_tokens or None), as the JAX CLI's
    make_data builds them (one process: no per-process shards)."""
    from luminaai_tpu_torch.data.dataset import (
        ConversationDataset,
        PackedDataset,
        PrefetchLoader,
        build_text_cache,
        conversation_batches,
    )
    from luminaai_tpu_torch.data.tokenizer import ConversationTokenizer

    # --data wins; config train_data_path only when the file exists.
    cfg_path = cfg.train_data_path
    data_path = getattr(args, "data", None) or (
        cfg_path if cfg_path and Path(cfg_path).exists() else None
    )
    if getattr(args, "synthetic", False) or not data_path:
        if not getattr(args, "synthetic", False):
            logger.warning("no --data given; training on synthetic data")
        return _synthetic_batches(cfg), None, None

    tokenizer = ConversationTokenizer(
        model_name=cfg.tokenizer_name,
        assistant_loss_weight=cfg.assistant_loss_weight,
    )
    if tokenizer.vocab_size > cfg.vocab_size:
        logger.warning(
            "tokenizer vocab %d > model vocab_size %d; raising model "
            "vocab_size to match", tokenizer.vocab_size, cfg.vocab_size,
        )
        cfg.vocab_size = tokenizer.vocab_size
    if getattr(args, "packed", False):
        cache = build_text_cache(
            data_path,
            str(Path(cfg.output_dir) / "cache" / Path(data_path).stem),
            tokenizer,
        )
        ds = PackedDataset(
            cache, cfg.batch_size, cfg.seq_length,
            pad_id=tokenizer.pad_token_id, eos_id=tokenizer.eos_token_id,
            shuffle_seed=cfg.seed,
            use_native=cfg.use_native_dataloader,
            split_docs=cfg.pack_sequences,
        )
        return (
            PrefetchLoader(lambda: iter(ds), prefetch=max(1, cfg.num_workers),
                           source=ds),
            None, cache.n_tokens,
        )

    ds = ConversationDataset(data_path, tokenizer, cfg)
    tokens = None
    if not ds.streaming:
        tokens = sum(int(s["loss_mask"].size) for s in ds.samples)

    def train_fn(epoch: int):
        # A permutation per epoch NUMBER: a resumed run replays the same
        # per-epoch shuffles.
        return conversation_batches(ds, cfg.batch_size, seed=cfg.seed + epoch)

    eval_fn = None
    eval_path = getattr(args, "eval_data", None) or (
        cfg.eval_data_path
        if cfg.eval_data_path and Path(cfg.eval_data_path).exists()
        else None
    )
    if eval_path:
        eval_ds = ConversationDataset(eval_path, tokenizer, cfg, split="eval")

        def eval_fn():
            return conversation_batches(eval_ds, cfg.batch_size, seed=0)

    return (
        PrefetchLoader(train_fn, prefetch=max(1, cfg.num_workers)),
        eval_fn, tokens,
    )


def _train_config(args) -> Config:
    overrides = _model_overrides(args)
    for flag, field in [
        ("lr", "learning_rate"),
        ("batch_size", "batch_size"),
        ("seq_length", "seq_length"),
        ("steps", "max_steps"),
        ("precision", "precision"),
        ("output_dir", "output_dir"),
        ("grad_accum", "gradient_accumulation_steps"),
        ("tokenizer", "tokenizer_name"),
        ("experiment", "experiment_name"),
    ]:
        val = getattr(args, flag)
        if val is not None:
            overrides[field] = val
    if args.no_flash:
        overrides["use_flash_attention"] = False
    if args.config:
        return dataclasses.replace(Config.load(args.config), **overrides)
    return ConfigPresets.get(args.preset, **overrides)


def _jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, float) and not np.isfinite(obj):
        return str(obj)
    return obj


def _signal_handler(trainer):
    """SIGINT/SIGTERM -> graceful preemption: the FIRST signal only arms
    `trainer.request_stop()`; the loop finishes the step in flight, runs a
    BLOCKING emergency save at the boundary, and `train` exits
    RESUMABLE_EXIT. A SECOND signal exits RESUMABLE_EXIT at once, after an
    emergency save when it lands between steps; inside a step the state
    is mid-update and the newest committed checkpoint stands
    (`Trainer.forced_save`)."""
    seen = {"n": 0}

    def handler(sig, frame):
        seen["n"] += 1
        if seen["n"] == 1:
            print(
                f"\nsignal {sig}: stopping at the next step boundary "
                "(emergency checkpoint + exact data cursor); signal again "
                "to exit at once", flush=True,
            )
            trainer.request_stop(f"signal {sig}")
            return
        print(f"\nsignal {sig} (again): exiting now", flush=True)
        try:
            if trainer.forced_save(f"signal {sig} forced"):
                print("state saved; exiting", flush=True)
            else:
                print("mid-step: resume from the newest committed "
                      "checkpoint", flush=True)
        except Exception as e:
            print(f"emergency save failed: {e}", flush=True)
        sys.exit(RESUMABLE_EXIT)

    return handler


def _install_signal_handlers(trainer) -> None:
    handler = _signal_handler(trainer)
    try:
        signal.signal(signal.SIGINT, handler)
        signal.signal(signal.SIGTERM, handler)
    except ValueError:  # pragma: no cover - not the main thread (tests)
        pass


def train(args) -> int:
    from luminaai_tpu_torch.training.orchestrator import (
        AdaptiveTrainingOrchestrator,
    )
    from luminaai_tpu_torch.training.scaler import ChinchillaScaler
    from luminaai_tpu_torch.training.trainer import Trainer

    resolve_device(args.device)  # the card, or raise before any output
    cfg = _train_config(args)
    logging.getLogger().setLevel(cfg.log_level)
    if args.resume:
        cfg.auto_resume = True
    train_fn, eval_fn, dataset_tokens = make_data(cfg, args)

    if (args.auto_epochs or cfg.use_chinchilla_scaling) and dataset_tokens:
        # Chinchilla budget -> step count; an explicit --steps wins.
        plan = ChinchillaScaler(cfg).plan(dataset_tokens)
        if args.steps is None:
            cfg.max_steps = plan.recommended_steps
        print(
            f"chinchilla auto-budget: recommended_steps="
            f"{plan.recommended_steps} (dataset {dataset_tokens:,} tokens, "
            f"applied={'yes' if args.steps is None else 'no, --steps set'})"
        )

    # Provenance before the trainer is built, so a crash still leaves it;
    # a resume never overwrites the original run's record.
    meta_path = Path(cfg.output_dir) / "experiment_metadata.json"
    if not (args.resume and meta_path.exists()):
        meta_path.parent.mkdir(parents=True, exist_ok=True)
        meta_path.write_text(json.dumps(_jsonable({
            "experiment_name": cfg.experiment_name,
            "config": cfg.to_dict(),
            "total_params": cfg.estimate_parameters(),
            "active_params": cfg.estimate_active_parameters(),
            "dataset_tokens": dataset_tokens,
            "planned_steps": cfg.max_steps,
            "argv": sys.argv[1:],
        }), indent=2))

    trainer = Trainer(cfg, train_data=train_fn, eval_data=eval_fn,
                      device=args.device, seed=args.seed)
    _install_signal_handlers(trainer)
    if args.adaptive:
        orchestrator = AdaptiveTrainingOrchestrator(trainer)
        summary = orchestrator.run(oom_protect=args.oom_protect)
    elif args.oom_protect:
        summary = trainer.train_with_oom_protection()
    else:
        summary = trainer.train()
    trainer.close()

    out = Path(cfg.output_dir) / "training_summary.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(_jsonable(summary), indent=2))
    final = summary.get("final_metrics", {})
    if summary.get("preempted"):
        print(
            f"training PREEMPTED at step {summary.get('final_step')}: "
            f"emergency checkpoint committed; rerun `resume` to continue "
            f"(exit {RESUMABLE_EXIT} = resumable)"
        )
        return RESUMABLE_EXIT
    print(
        f"training done: steps={summary.get('final_step')} "
        f"final_loss={final.get('loss', float('nan')):.4f}"
    )
    return 0


def build_serve_engine(args):
    """The engine `serve` runs: from --checkpoint (its saved config, the
    moe-dispatch flag applied), --weights or --seed."""
    from luminaai_tpu_torch.inference.chat import build_engine

    if args.checkpoint is not None:
        return build_engine(None, device=args.device,
                            checkpoint=args.checkpoint,
                            overrides=_model_overrides(args))
    config = ConfigPresets.get(args.preset, **_model_overrides(args))
    return build_engine(config, device=args.device, seed=args.seed,
                        weights=args.weights)


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.command in ("train", "resume"):
        return train(args)
    from luminaai_tpu_torch.serving.server import ChatServer

    engine = build_serve_engine(args)
    ChatServer(
        engine, num_slots=args.num_slots, page_size=args.page_size
    ).serve_forever(args.host, args.port)
    return 0
