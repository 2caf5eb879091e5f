#!/usr/bin/env python3
"""Where the port's int8 product (ops/quantized.py `int8_project`) on the
card first differs from the same call on the CPU.

    python3 scripts/int8_card_vs_cpu.py [--repo DIR]

On the inputs of tests/test_torch_cuda_int8.py
`test_int8_products_on_card_equal_the_cpu` (rows m of 1, 8, 16, 17 and
40, K 256, N 384, from numpy seed m) it compares, card against CPU, each
stage of the product on the same inputs: the activation codes and scales
of `quantize_act`, the int32 product of `int_mm` (the CPU's codes on both
sides), the fp32 rescale (the CPU's int32 and scales on both sides), and
the whole call. It prints one line a row count with the number of
elements that differ at each stage. --repo takes the package from
another checkout (for example the parent commit's). Needs a card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", type=Path,
                    default=Path(__file__).resolve().parent.parent)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.repo.resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("int8_card_vs_cpu: needs a CUDA device", file=sys.stderr)
        return 2
    from luminaai_tpu_torch.ops import quantized as tq

    dev = torch.device("cuda", 0)
    for m in (1, 8, 16, 17, 40):
        rng = np.random.RandomState(m)
        x = torch.as_tensor(rng.randn(m, 256).astype(np.float32))
        w = tq.quantize_array(torch.as_tensor(
            rng.randn(256, 384).astype(np.float32) * 0.02), axis=0)
        wc = tq.QuantizedTensor(w.q, w.scale, 8, w.axis, w.orig_shape).to(
            dev).mm_layout()
        xq, sx = tq.quantize_act(x)
        xq_card, sx_card = tq.quantize_act(x.to(dev))
        y = tq.int_mm(xq, w.q)
        y_card = tq.int_mm(xq.to(dev), wc.q)
        f = y.float() * sx * w.scale.reshape(-1)
        f_card = (y.to(dev).float() * sx.to(dev)
                  * w.scale.reshape(-1).to(dev))
        want = tq.int8_project(x, w, torch.float32)
        got = tq.int8_project(x.to(dev), wc, torch.float32).cpu()
        bad_rows = (sx_card.cpu() != sx).flatten().nonzero().flatten()
        ulps = [(sx_card.cpu()[r, 0].view(torch.int32)
                 - sx[r, 0].view(torch.int32)).item() for r in bad_rows]
        print(f"m={m}: codes differ {(xq_card.cpu() != xq).sum().item()}, "
              f"scales {len(bad_rows)} (rows {bad_rows.tolist()}, ulps "
              f"{ulps}), int32 {(y_card.cpu() != y).sum().item()}, rescale "
              f"{(f_card.cpu() != f).sum().item()}, whole call "
              f"{(got != want).sum().item()} of {got.numel()} (max "
              f"{(got - want).abs().max().item():.3e})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
