#!/usr/bin/env python3
"""What torch._int_mm (int8 x int8 -> int32, cuBLASLt) takes on the card,
and what it costs at the b1 serving shapes.

    python3 scripts/probe_int_mm.py

The port's int8 products (luminaai_tpu_torch/ops/quantized.py) call it
once a weight. This prints, as one JSON line: which (M, K, N) and which
weight layouts it accepts (the weight [K, N] contiguous, or the transpose
of a contiguous [N, K]); whether each accepted call is exact against an
int32 product; and CUDA-event milliseconds of the b1 decode products (M
32: 8 lanes padded past the 16-row minimum) and a prefill chunk (M 64)
in each layout, beside the bf16 product of the same shape. Needs a card.
"""

from __future__ import annotations

import json
import subprocess
import sys


def _ms(fn, iters=200, warmup=10):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_int_mm: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def layouts(k, n):
        return {"kn": codes(k, n), "nk_t": codes(n, k).t()}

    accepts = []
    for m, k, n in ((8, 2048, 3072), (16, 2048, 3072), (17, 2048, 3072),
                    (32, 2048, 3072), (32, 2044, 3072), (32, 2048, 3068),
                    (32, 2050, 3072), (24, 64, 40)):
        a = codes(m, k)
        for name, b in layouts(k, n).items():
            row = {"m": m, "k": k, "n": n, "layout": name}
            try:
                y = torch._int_mm(a, b)
                torch.cuda.synchronize()
                ref = (a.double() @ b.double()).to(torch.int64)
                row["ok"] = True
                row["exact"] = bool(torch.equal(y.to(torch.int64), ref))
            except RuntimeError as e:
                row["ok"] = False
                row["error"] = str(e).splitlines()[0][:160]
            accepts.append(row)

    # b1 (hidden 2048, 16 q / 4 kv heads of 128, FFN 5504, vocab 50304).
    shapes = {"wqkv": (2048, 3072), "attn_wo": (2048, 2048),
              "ffn_wi": (2048, 11008), "ffn_wo": (5504, 2048),
              "head": (2048, 50304)}
    timing = []
    for m in (32, 64):
        for name, (k, n) in shapes.items():
            a = codes(m, k)
            row = {"m": m, "weight": name, "k": k, "n": n}
            for lay, b in layouts(k, n).items():
                try:
                    row[f"int8_{lay}_ms"] = _ms(lambda: torch._int_mm(a, b))
                except RuntimeError:
                    row[f"int8_{lay}_ms"] = None
            ab = a.to(torch.bfloat16)
            bb = codes(k, n).to(torch.bfloat16)
            row["bf16_ms"] = _ms(lambda: ab @ bb)
            timing.append(row)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip())
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0),
                      "accepts": accepts, "timing": timing}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
