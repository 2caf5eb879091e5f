"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic or
job, and its metrics are found by name (portbench/lib/spec.py); the
driver named by the cell's file runs the set-up, the window and the
check against the plain reference. With `--trace 0` the line carries the
cell's end-to-end metrics, with `--trace 1` its per-layer metrics and
the device's busy and window seconds.

Exits non-zero and prints no result without enough CUDA cards, and when
`jax`, `jaxlib`, `flax` or `luminaai_tpu` (top-level names, compared
whole) is loaded once the window has closed. Build and kernel caches
are kept at fixed paths inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "luminaai_tpu")


def fix_caches(root: Path = ROOT) -> None:
    """Every cache the run writes at a fixed path inside the checkout:
    Python's bytecode (so each run loads torch's instead of compiling
    it), Triton's and torch's extension builds. The port's kernels build
    into luminaai_tpu_torch/_kernels/, also inside the checkout."""
    cache = root / ".portbench_cache"
    sys.dont_write_bytecode = False
    sys.pycache_prefix = str(cache / "pycache")
    os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def few_threads() -> None:
    """One host thread for CPU-side tensor work: the card does the run's
    work, and idle pool threads spinning beside the launching thread only
    add jitter to a host-paced step."""
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"


def forbidden_modules():
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def _finite(x):
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def make_context(workload: str, seed: int, seconds: float, trace: bool,
                 device, root: Path = ROOT, t_start: float = T_START,
                 log=None, overrides=None):
    """(BENCHMARK.json, the cell's driver module, its context) of one run.
    `overrides` (tests) replace keys of the cell's `params` and of the
    configuration's `config`."""
    from portbench.lib import spec

    bench = spec.load_benchmark(root)
    wl = spec.by_name(bench["workloads"], workload, "workload")
    entry = spec.by_name(bench["configs"], wl["config"], "configuration")
    cell = spec.load_cell(workload, root)
    config = dict(spec.load_config(entry, root)["config"])
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    cell = {**cell, "params": {**cell["params"],
                               **overrides.get("params", {})}}
    driver = spec.load_driver(cell["driver"], root)
    ctx = {"workload": workload, "cell": cell, "config": config,
           "seed": int(seed), "seconds": float(seconds), "trace": trace,
           "device": device, "t_start": t_start, "root": root,
           "chips": wl["chips"],
           "log": log or (lambda m: print(m, file=sys.stderr, flush=True))}
    return bench, driver, ctx


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, root: Path = ROOT, t_start: float = T_START,
             log=None, overrides=None):
    """(result line, check lines) of one run."""
    from portbench.lib import spec

    bench, driver, ctx = make_context(workload, seed, seconds, trace,
                                      device, root, t_start, log, overrides)
    out = driver.run(ctx)
    metrics = {}
    if trace:
        metrics = spec.read_per_layer(spec.per_layer_of(bench, workload),
                                      out["window"], root)
    else:
        for m in spec.end_to_end_of(bench, workload):
            value = (out["setup_s"] if m["name"] == "setup_s"
                     else out["e2e"][m["name"]])
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = dict(out["device"])
    if trace:
        device_info["busy_s"] = float(out["busy_s"])
        device_info["window_s"] = float(out["window_s"])
    line = {"correct": bool(out["correct"]),
            "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics,
            "device": device_info}
    if trace and "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    at = out.get("checks_at", {})
    lines = [f"reading {k}: {v!r} (not compared: it has no upper reading)"
             for k, v in out.get("not_compared", {}).items()]
    lines += [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
             + (f" worst at {at[k]}" if k in at else "")
             for k, v in out["checks"].items()]
    return line, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fix_caches()
    few_threads()
    sys.path.insert(0, str(ROOT))

    import torch

    torch.set_num_threads(1)

    from portbench.lib import spec

    wl = spec.by_name(spec.load_benchmark()["workloads"], args.workload,
                      "workload")
    if not torch.cuda.is_available():
        print("portbench: no CUDA card (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < wl["chips"]:
        print(f"portbench: {wl['chips']} cards needed, "
              f"{torch.cuda.device_count()} seen", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    line, checks = run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), device)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {found}",
              file=sys.stderr)
        return 3
    for c in checks:
        print(c, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
