"""Command line of the port: `python -m luminaai_tpu_torch serve ...`.

  python -m luminaai_tpu_torch serve --preset b1 --dense --seed 0 --port 5001
  python -m luminaai_tpu_torch serve --preset debug --dense \\
      --weights params.npz --device cpu

The model is built on the card unless --device says otherwise.
"""

from __future__ import annotations

import argparse
import logging
from typing import List, Optional

from luminaai_tpu_torch.config import ConfigPresets


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m luminaai_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    s = sub.add_parser("serve", help="serve a model over HTTP")
    s.add_argument("--preset", default="b1", choices=ConfigPresets.available())
    s.add_argument("--dense", action="store_true",
                   help="serve the preset's widths without experts "
                        "(required: MoE is not ported yet)")
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
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from luminaai_tpu_torch.inference.chat import build_engine
    from luminaai_tpu_torch.serving.server import ChatServer

    overrides = {"use_moe": False} if args.dense else {}
    config = ConfigPresets.get(args.preset, **overrides)
    engine = build_engine(
        config, device=args.device, seed=args.seed, weights=args.weights
    )
    ChatServer(
        engine, num_slots=args.num_slots, page_size=args.page_size
    ).serve_forever(args.host, args.port)
    return 0
