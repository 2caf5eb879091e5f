"""The readings a training cell's limits are set from, in one process.

    python3 portbench/calibrate.py --workload b1.train --seeds 1 2 3 ... \
        [--control-seeds 3] [--out FILE]

For each seed: the program's checked steps (the timed path's set-up, as
drivers/train.py runs it) against the float32 reference (the lower
reading). For the first `--control-seeds` seeds also the control, the
reference computed with fp8 products in the program's place, and a
planted fault, the reference with half of every micro-batch left out and
the mean over the rest, each against the float32 reference (the upper
readings). Every side's numbers are also judged under the cell's limits
(`judged`: `correct` and each number beside its limit), as a run of the
benchmark would judge them. A step that returns its state unchanged
reads 1 on `change_gap` and needs no run. Not run by the benchmark's own
runs.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.run import fix_caches

    fix_caches()
    import torch

    from portbench.drivers import train as drv
    from portbench.lib import check, device as dev, spec
    from portbench.lib.inputs import batches
    from portbench.reference.train import steps as reference_steps

    bench = spec.load_benchmark()
    wl = spec.by_name(bench["workloads"], args.workload, "workload")
    entry = spec.by_name(bench["configs"], wl["config"], "configuration")
    cell = spec.load_cell(args.workload)
    config = spec.load_config(entry)["config"]
    params = cell["params"]
    device = torch.device(args.device)
    if device.type == "cuda":
        from luminaai_tpu_torch.ops import _build

        _build.build_all()
    sink = open(args.out, "a") if args.out else None

    def judged(nums):
        """check.judge under the cell's limits, as a run decides it."""
        ok, checks = check.judge(nums, params["limits"])
        return {"correct": ok, "checks": checks}

    def emit(rec):
        rec = {"workload": args.workload, **rec}
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        # The readings alone: the program's state dies before the
        # reference runs.
        prog = drv.checked_program(config, params, seed, device)[-1]
        dev.free(device)
        t1 = time.perf_counter()
        ids = batches(seed, params["batches"], config["batch_size"],
                      config["seq_length"], config["vocab_size"], device)
        ids = ids[:params["checked_steps"]]
        ref = reference_steps(config, seed, ids, params["checked_steps"],
                              params["schedule_steps"])
        dev.free(device)
        t2 = time.perf_counter()
        nums = check.compare(prog, ref)
        emit({"seed": seed, "side": "program", "numbers": nums,
              "judged": judged(nums),
              "program_s": t1 - t0, "reference_s": t2 - t1,
              "losses": prog["losses"], "ref_losses": ref["losses"]})
        if i < args.control_seeds:
            for side, kw in (("control_fp8", {"precision": "fp8"}),
                             ("fault_half_batch", {"rows_kept": 0.5})):
                t3 = time.perf_counter()
                other = reference_steps(config, seed, ids,
                                        params["checked_steps"],
                                        params["schedule_steps"], **kw)
                dev.free(device)
                nums = check.compare(other, ref)
                emit({"seed": seed, "side": side, "numbers": nums,
                      "judged": judged(nums),
                      "seconds": time.perf_counter() - t3})
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
