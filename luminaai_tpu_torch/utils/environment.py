"""Environment detection: host, cards, topology, memory, recommended config
(port of luminaai_tpu/utils/environment.py).

The JAX module's functions over torch.cuda and nvidia-smi:

- `get_system_info`: the host and the software (Python, torch, CUDA).
- `get_device_info`: platform "gpu", the card's name and memory from
  torch.cuda (platform "cpu" without a card).
- `get_topology`: ranks and cards, and the links between cards from
  `nvidia-smi topo -m` (NVLink counts per pair).
- `device_peak_flops`: the card's dense bf16 peak by name, from NVIDIA's
  data sheets (the MFU denominator).
- `estimate_training_memory_gb`, `check_config_fits`, `recommend_preset`:
  the JAX formulas over the port's Config and presets.
- `cuda_runtime_diagnostics`: the counterpart of JAX's
  `tpu_runtime_diagnostics`: a subprocess runs a matmul on the card under
  a timeout (a wedged driver hangs rather than errors, and nothing in
  this process initializes CUDA before the probe answers), plus the
  state of the port's kernel build directory (the role of XLA's compile
  cache).
- `connectivity_probe`: rank and card visibility, and one timed
  all-reduce per tier over parallel/mesh.py (within a node, and across
  nodes where there are several): NCCL on the cards, gloo on the CPU.
- `format_diagnostics`: the human-readable block.
"""

from __future__ import annotations

import glob
import json
import os
import platform
import re
import shutil
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

# Dense bf16 tensor-core peaks (FLOP/s, without sparsity) by card name, from
# NVIDIA's data sheets. Matched as substrings of torch.cuda.get_device_name
# (nvidia-smi's name), most specific first.
_GPU_PEAK_FLOPS: Tuple[Tuple[str, float], ...] = (
    ("h100 pcie", 756e12),
    ("h100 nvl", 835e12),
    ("h100", 989e12),      # SXM5 (e.g. "NVIDIA H100 80GB HBM3")
    ("h200", 989e12),
    ("gh200", 989e12),
    ("b200", 2250e12),
    ("a100", 312e12),
    ("a10g", 70e12),
    ("l40s", 362e12),
    ("l4", 121e12),
)
# Without a card: a planning figure for a CPU host (the JAX CLI's 5e11).
_CPU_PEAK_FLOPS = 5e11

# The port's kernel build directory (ops/_build.py): the compile cache.
_KERNEL_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_kernels")


def _lookup(kind: str, table, default):
    kind = kind.lower()
    for key, val in table:
        if key in kind:
            return val
    return default


def device_peak_flops(device=None, default: Optional[float] = None
                      ) -> float:
    """Dense bf16 peak FLOP/s of `device` (default: the current card) by
    its name; `default` (else the H100 SXM's 989e12) for a card the table
    does not name; the CPU planning figure without a card."""
    import torch

    if device is None and not torch.cuda.is_available():
        return _CPU_PEAK_FLOPS if default is None else default
    name = (device if isinstance(device, str)
            else torch.cuda.get_device_name(device))
    return _lookup(name, _GPU_PEAK_FLOPS,
                   989e12 if default is None else default)


def get_system_info() -> Dict[str, Any]:
    """Host-side software/hardware summary."""
    info: Dict[str, Any] = {
        "python_version": sys.version.split()[0],
        "platform": platform.platform(),
        "cpu_count": os.cpu_count(),
    }
    try:
        import torch

        info["torch_version"] = torch.__version__
        info["cuda_version"] = torch.version.cuda
    except ImportError:  # pragma: no cover - torch is a hard dependency
        info["torch_version"] = None
    try:
        page = os.sysconf("SC_PAGE_SIZE")
        info["host_memory_gb"] = round(
            page * os.sysconf("SC_PHYS_PAGES") / 1e9, 2
        )
        info["host_memory_available_gb"] = round(
            page * os.sysconf("SC_AVPHYS_PAGES") / 1e9, 2
        )
    except (ValueError, OSError):  # pragma: no cover - non-POSIX
        pass
    return info


def _rank_world() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def get_device_info() -> Dict[str, Any]:
    """Accelerator summary: platform "gpu", the cards, the first card's
    name and memory (platform "cpu", one device, no memory figure,
    without a card)."""
    import torch

    rank, world = _rank_world()
    if not torch.cuda.is_available():
        return {"platform": "cpu", "device_count": 1,
                "local_device_count": 1, "device_kind": "cpu",
                "process_index": rank, "process_count": world,
                "memory_per_device_gb": None}
    props = torch.cuda.get_device_properties(0)
    return {
        "platform": "gpu",
        "device_count": torch.cuda.device_count() * max(
            1, world // max(1, _local_world())),
        "local_device_count": torch.cuda.device_count(),
        "device_kind": torch.cuda.get_device_name(0),
        "process_index": rank,
        "process_count": world,
        "memory_per_device_gb": round(props.total_memory / 1e9, 2),
        "compute_capability": f"{props.major}.{props.minor}",
    }


def _local_world() -> int:
    """Ranks on this node (torchrun's LOCAL_WORLD_SIZE; the world on one
    node)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", _rank_world()[1]))


def _smi(args: List[str], timeout: float = 20.0) -> Optional[str]:
    """nvidia-smi's output, or None where it is absent or fails."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        proc = subprocess.run([exe, *args], capture_output=True, text=True,
                              timeout=timeout)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return proc.stdout if proc.returncode == 0 else None


def parse_topology_matrix(text: str) -> Dict[str, Any]:
    """`nvidia-smi topo -m` -> {"gpus": [...], "links": {"GPU0-GPU1":
    "NV18", ...}, "nvlink_pairs": n, "nvlinks": total links}: each pair
    of cards once, with the matrix's connection type (NV<k> = k NVLinks;
    PIX, PXB, PHB, NODE, SYS = PCIe/host paths)."""
    rows = [ln.split() for ln in text.splitlines() if ln.strip()]
    is_gpu = re.compile(r"GPU\d+$").match
    gpus = [c for c in (rows[0] if rows else []) if is_gpu(c)]
    links: Dict[str, str] = {}
    for r in rows[1:]:
        if not is_gpu(r[0]):
            continue
        src = r[0]
        for dst, cell in zip(gpus, r[1:1 + len(gpus)]):
            if dst != src and f"{dst}-{src}" not in links:
                links[f"{src}-{dst}"] = cell
    nv = [int(c[2:]) for c in links.values()
          if c.startswith("NV") and c[2:].isdigit()]
    return {"gpus": gpus, "links": links, "nvlink_pairs": len(nv),
            "nvlinks": sum(nv)}


def get_topology() -> Dict[str, Any]:
    """Ranks and cards for multi-node planning, and the card-to-card
    links (`nvidia-smi topo -m`; None where nvidia-smi is absent)."""
    import torch

    rank, world = _rank_world()
    local = _local_world()
    topo = _smi(["topo", "-m"])
    return {
        "process_count": world,
        "process_index": rank,
        "devices_per_process": 1 if torch.cuda.is_available() else 0,
        "ranks_per_node": local,
        "nodes": max(1, world // max(1, local)),
        "local_devices": (torch.cuda.device_count()
                          if torch.cuda.is_available() else 0),
        "interconnect": (parse_topology_matrix(topo) if topo is not None
                         else None),
    }


def estimate_training_memory_gb(config) -> Dict[str, float]:
    """Per-card memory need for a config under its parallelism settings."""
    est = config.memory_estimate_gb()
    model_shards = max(
        1,
        config.fsdp_parallel_size
        * max(1, config.tensor_parallel_size)
        * max(1, config.expert_parallel_size),
    )
    per_chip = {
        "params_gb": est["parameters_gb"] / model_shards,
        "optimizer_gb": est["optimizer_gb"] / model_shards,
        "activations_gb": est["activations_gb"],
        "total_gb": (est["parameters_gb"] + est["optimizer_gb"]) / model_shards
        + est["activations_gb"],
    }
    return {k: round(v, 3) for k, v in per_chip.items()}


def check_config_fits(config, n_devices: Optional[int] = None
                      ) -> Dict[str, Any]:
    """Does this config fit the detected hardware? Returns {fits,
    per_chip_gb, available_gb, platform, device_count, detail}."""
    dev = get_device_info()
    hbm = dev.get("memory_per_device_gb") or 16.0
    need = estimate_training_memory_gb(config)
    budget = getattr(config, "max_memory_usage", 0.9)
    fits = need["total_gb"] <= hbm * budget
    return {
        "fits": fits,
        "per_chip_gb": need["total_gb"],
        "available_gb": hbm,
        "platform": dev["platform"],
        "device_count": n_devices or dev["device_count"],
        "detail": need,
    }


def recommend_preset(n_devices: Optional[int] = None) -> str:
    """The largest preset whose parameters and optimizer state fit the
    detected fleet's memory (92% of it)."""
    from luminaai_tpu_torch.config import ConfigPresets

    dev = get_device_info()
    n = n_devices or dev["device_count"]
    hbm = dev.get("memory_per_device_gb") or 16.0
    budget_gb = n * hbm * 0.92
    best = "debug"
    for name in ConfigPresets.available():
        cfg = ConfigPresets.get(name)
        total = cfg.memory_estimate_gb()
        need = total["parameters_gb"] + total["optimizer_gb"]
        if need <= budget_gb and cfg.estimate_parameters() > (
            ConfigPresets.get(best).estimate_parameters()
        ):
            best = name
    return best


_PROBE_CODE = """
import json, sys, time
import torch
if not torch.cuda.is_available():
    sys.exit("no CUDA device is available")
t0 = time.perf_counter()
x = torch.ones((512, 512), dtype=torch.bfloat16, device="cuda")
float((x @ x).sum())
cold = time.perf_counter() - t0
t0 = time.perf_counter()
float((x @ x).sum())
warm = time.perf_counter() - t0
free, total = torch.cuda.mem_get_info()
print(json.dumps({
    "platform": "gpu",
    "devices": torch.cuda.device_count(),
    "device_kind": torch.cuda.get_device_name(0),
    "torch": torch.__version__,
    "cuda": torch.version.cuda,
    "cold_matmul_s": round(cold, 2),
    "warm_matmul_s": round(warm, 4),
    "hbm_in_use_gb": round((total - free) / 1e9, 3),
    "hbm_limit_gb": round(total / 1e9, 2),
}))
"""


def cuda_runtime_diagnostics(probe_timeout: int = 90) -> Dict[str, Any]:
    """Runtime probes for `cli diagnose`: the card's reachability through
    a real matmul in a subprocess with a hard timeout (status ok, error
    or hung; this process initializes no CUDA), and the port's kernel
    build directory (entries, size, freshness: an empty one explains a
    slow first step, which builds every kernel)."""
    out: Dict[str, Any] = {}
    t0 = time.monotonic()
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _PROBE_CODE],
            capture_output=True, text=True, timeout=probe_timeout,
        )
        dt = round(time.monotonic() - t0, 1)
        if proc.returncode == 0:
            try:
                probe = json.loads(proc.stdout.strip().splitlines()[-1])
            except (ValueError, IndexError):
                probe = {"raw": proc.stdout[-200:]}
            out["backend"] = {"status": "ok", "probe_seconds": dt, **probe}
        else:
            err = (proc.stderr or "").strip().splitlines()
            out["backend"] = {
                "status": "error",
                "probe_seconds": dt,
                "last_error": (err[-1][-200:] if err
                               else f"rc={proc.returncode}"),
            }
    except subprocess.TimeoutExpired:
        out["backend"] = {
            "status": "hung",
            "probe_seconds": probe_timeout,
            "hint": "the card's probe hung past the timeout: a wedged "
                    "driver or card; check nvidia-smi",
        }
    if os.path.isdir(_KERNEL_DIR):
        sizes, mtimes = [], []
        for e in glob.glob(os.path.join(_KERNEL_DIR, "*.so")):
            try:
                st = os.stat(e)
            except OSError:
                continue
            sizes.append(st.st_size)
            mtimes.append(st.st_mtime)
        out["compile_cache"] = {
            "dir": _KERNEL_DIR,
            "entries": len(sizes),
            "total_mb": round(sum(sizes) / 1e6, 1),
            "newest_age_s": (round(time.time() - max(mtimes))
                             if mtimes else None),
        }
    else:
        out["compile_cache"] = {
            "dir": None,
            "note": "no kernel built yet: the first step builds them "
                    "(ops/_build.py)",
        }
    return out


def connectivity_probe(
    payload_mb: float = 4.0, iters: int = 5, registry=None, mesh=None,
) -> Dict[str, Any]:
    """Rank visibility and one timed all-reduce per tier, for `cli
    diagnose` (JAX's ICI/DCN probe).

    Needs an initialized process group (diagnose starts a one-rank group
    where there is none). Visibility: every node must hold the same
    number of ranks (world == nodes x ranks per node), else a node came
    up short. The all-reduce runs over parallel/mesh.py's data axis
    factored into nodes: `ici` within a node (the whole world on one)
    and, with several nodes, `dcn` across them. On one rank it is the
    default group's all-reduce of one member: it checks the machinery
    (NCCL on the card), not a link. Results are returned and exported as
    the JAX diagnose_* gauges."""
    import torch
    import torch.distributed as dist

    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.monitoring.telemetry import get_registry
    from luminaai_tpu_torch.parallel.mesh import build_mesh

    registry = registry or get_registry()
    rank, world = _rank_world()
    local = _local_world()
    n_nodes = max(1, world // max(1, local))
    cuda = dist.get_backend() == "nccl"
    visibility: Dict[str, Any] = {
        "process_count": n_nodes,
        "process_index": rank // max(1, local),
        "local_device_count": local,
        "global_device_count": world,
        "platform": "gpu" if cuda else "cpu",
        "device_kind": (torch.cuda.get_device_name(torch.cuda.current_device())
                        if cuda else "cpu"),
        "visibility_ok": world == n_nodes * local,
    }
    out: Dict[str, Any] = {"visibility": visibility, "allreduce": {}}
    _export_visibility_gauges(registry, visibility)
    if world % n_nodes:
        out["allreduce"]["skipped"] = (
            f"ragged ranks ({world} over {n_nodes} nodes): no dcn x ici "
            "factoring; see visibility")
        return out
    if mesh is None:
        mesh = build_mesh(Config(gradient_dcn_size=n_nodes))
    stage1, stage2 = mesh.tier_groups("data", n_nodes)
    tiers = {"ici": stage1 if n_nodes > 1 else mesh.group("data")}
    if n_nodes > 1:
        tiers["dcn"] = stage2
    n_elems = max(1, int(payload_mb * 1e6 / 4))
    for axis, group in tiers.items():
        size = (dist.get_world_size(group) if group is not None else 1)
        x = torch.ones(n_elems, dtype=torch.float32, device=mesh.device)
        try:
            dist.all_reduce(x, group=group)  # warm the communicator
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                dist.all_reduce(x, group=group)
            if cuda:
                torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / iters
        except (RuntimeError, ValueError) as e:  # diagnose reports, not dies
            out["allreduce"][axis] = {"size": size,
                                      "error": f"{type(e).__name__}: {e}"}
            continue
        payload = n_elems * 4
        out["allreduce"][axis] = {
            "size": size,
            "payload_mb": round(payload / 1e6, 2),
            "mean_seconds": round(dt, 6),
            "algo_gbps": round(payload / max(dt, 1e-9) / 1e9, 3),
        }
    ar_s = registry.gauge(
        "diagnose_allreduce_seconds",
        "Mean timed all-reduce per mesh axis at last diagnose",
        labelnames=("axis",),
    )
    ar_bw = registry.gauge(
        "diagnose_allreduce_gbps",
        "Algorithmic all-reduce bandwidth per mesh axis at last diagnose",
        labelnames=("axis",),
    )
    for axis, rec in out["allreduce"].items():
        if isinstance(rec, dict) and "mean_seconds" in rec:
            ar_s.labels(axis=axis).set(rec["mean_seconds"])
            ar_bw.labels(axis=axis).set(rec["algo_gbps"])
    return out


def _export_visibility_gauges(registry, visibility: Dict[str, Any]) -> None:
    """The diagnose_* visibility gauges, exported before any mesh work so
    a short node still reports."""
    g = registry.gauge
    g("diagnose_processes", "Hosts in the job at last diagnose").set(
        visibility["process_count"]
    )
    g(
        "diagnose_local_devices", "Devices visible to this process"
    ).set(visibility["local_device_count"])
    g(
        "diagnose_global_devices", "Global devices at last diagnose"
    ).set(visibility["global_device_count"])
    g(
        "diagnose_device_visibility_ok",
        "1 when global devices == process_count * local devices",
    ).set(1.0 if visibility["visibility_ok"] else 0.0)


def format_diagnostics(include_accelerator: bool = True) -> str:
    """Human-readable diagnostics block. include_accelerator=False touches
    no CUDA (what diagnose prints when its probe found no card)."""
    lines: List[str] = ["=" * 64, "SYSTEM DIAGNOSTICS", "=" * 64]
    lines.append("[host]")
    for k, v in get_system_info().items():
        lines.append(f"  {k}: {v}")
    if not include_accelerator:
        lines.append("[accelerator] skipped: the card's probe did not answer")
        lines.append("=" * 64)
        return "\n".join(lines)
    try:
        lines.append("[accelerator]")
        for k, v in get_device_info().items():
            lines.append(f"  {k}: {v}")
        lines.append("[topology]")
        for k, v in get_topology().items():
            lines.append(f"  {k}: {v}")
    except RuntimeError as e:  # a card that fails to answer
        lines.append(f"[accelerator] unavailable: {e}")
    lines.append("=" * 64)
    return "\n".join(lines)
