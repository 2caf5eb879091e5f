"""Command line of the port: `python -m luminaai_tpu_torch serve|train ...`.

  python -m luminaai_tpu_torch serve --preset b1 --moe-dispatch gmm --seed 0
  python -m luminaai_tpu_torch serve --preset b1 --dense --seed 0 --port 5001
  python -m luminaai_tpu_torch serve --preset debug \\
      --weights params.npz --device cpu
  python -m luminaai_tpu_torch train --preset debug --moe-dispatch gmm \\
      --synthetic --steps 3 --device cpu
  python -m luminaai_tpu_torch train --preset b1 --dense --synthetic --steps 6

The presets are mixture-of-experts models, as in the JAX package; --dense
builds the preset's widths without experts. The model is built on the card
unless --device says otherwise. `train` takes the JAX CLI's flags that
apply to one card; --synthetic is required (real data loading is a later
slice).
"""

from __future__ import annotations

import argparse
import itertools
import logging
from typing import Dict, Iterator, List, Optional

import numpy as np

from luminaai_tpu_torch.config import Config, ConfigPresets


def _moe_dispatch_flag(p: argparse.ArgumentParser) -> None:
    # The JAX train flag's choices (luminaai_tpu/cli.py); gather and einsum
    # are refused where the model is built (not ported yet).
    p.add_argument("--moe-dispatch", dest="moe_dispatch",
                   choices=["sort", "gather", "einsum", "gmm"],
                   help="MoE dispatch (default: the config's, 'sort'); "
                        "'gmm' runs the grouped-matmul kernel")


def _model_overrides(args) -> Dict[str, object]:
    overrides: Dict[str, object] = {}
    if args.dense:
        overrides["use_moe"] = False
    if args.moe_dispatch is not None:
        overrides["moe_dispatch"] = args.moe_dispatch
    return overrides


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m luminaai_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    s = sub.add_parser("serve", help="serve a model over HTTP")
    s.add_argument("--preset", default="b1", choices=ConfigPresets.available())
    s.add_argument("--dense", action="store_true",
                   help="serve the preset's widths without experts")
    _moe_dispatch_flag(s)
    w = s.add_mutually_exclusive_group()
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
    t.add_argument("--preset", default="debug",
                   choices=ConfigPresets.available())
    t.add_argument("--dense", action="store_true",
                   help="train the preset's widths without experts")
    _moe_dispatch_flag(t)
    t.add_argument("--synthetic", action="store_true",
                   help="train on the synthetic repeating-pattern batches "
                        "(required: real data loading is not ported yet)")
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
    return p


def _synthetic_batches(cfg: Config, n_batches: int = 200, seed: int = 0):
    """Learnable repeating-pattern batches, drawn exactly as the JAX CLI's
    _synthetic_batches draws them: each call starts the next epoch, from
    numpy RandomState(seed + epoch)."""
    epochs = itertools.count()

    def gen() -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.RandomState(seed + next(epochs))
        period = min(64, cfg.vocab_size - 2)
        for _ in range(n_batches):
            starts = rng.randint(0, 32, size=(cfg.batch_size, 1))
            seq = (starts + np.arange(cfg.seq_length)) % period + 1
            yield {"input_ids": seq.astype(np.int32)}

    return gen


def _train_config(args) -> Config:
    overrides = _model_overrides(args)
    for flag, field in [
        ("lr", "learning_rate"),
        ("batch_size", "batch_size"),
        ("seq_length", "seq_length"),
        ("steps", "max_steps"),
        ("precision", "precision"),
        ("grad_accum", "gradient_accumulation_steps"),
    ]:
        val = getattr(args, flag)
        if val is not None:
            overrides[field] = val
    if args.no_flash:
        overrides["use_flash_attention"] = False
    return ConfigPresets.get(args.preset, **overrides)


def train(args) -> int:
    from luminaai_tpu_torch.training.trainer import Trainer

    if not args.synthetic:
        raise NotImplementedError(
            "real data loading is not ported yet: pass --synthetic"
        )
    cfg = _train_config(args)
    trainer = Trainer(cfg, train_data=_synthetic_batches(cfg),
                      device=args.device, seed=args.seed)
    summary = trainer.train()
    final = summary.get("final_metrics", {})
    print(
        f"training done: steps={summary.get('final_step')} "
        f"final_loss={final.get('loss', float('nan')):.4f}"
    )
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.command == "train":
        return train(args)
    from luminaai_tpu_torch.inference.chat import build_engine
    from luminaai_tpu_torch.serving.server import ChatServer

    config = ConfigPresets.get(args.preset, **_model_overrides(args))
    engine = build_engine(
        config, device=args.device, seed=args.seed, weights=args.weights
    )
    ChatServer(
        engine, num_slots=args.num_slots, page_size=args.page_size
    ).serve_forever(args.host, args.port)
    return 0
