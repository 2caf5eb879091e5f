"""bench_torch.py's smoke tiers and the `benchmark` CLI, run for real on
the CPU as processes of their own (started together once per file):

- `--smoke-serve --device cpu`: one well-formed
  serve_tokens_per_sec_continuous line (continuous against the
  MicroBatcher, TTFT and gaps both ways, the prefix-cache tier, SLO
  verdicts), the decode on the plain path (there is no card);
- `--smoke-router --device cpu`: exit 0, failovers > 0, every request
  after the kill answered, a breaker opened, the cross-replica page pull;
- `--smoke --device cpu`: resumed_exact_data_state true, SLO verdicts and
  the goodput ledger, the durable-I/O cycle, router health;
- `python -m luminaai_tpu_torch benchmark [--ops]` without a card: one
  JSON line with "error", a non-zero exit, no number.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
RUNS = {
    "serve": ["bench_torch.py", "--smoke-serve", "--device", "cpu"],
    "router": ["bench_torch.py", "--smoke-router", "--device", "cpu"],
    "smoke": ["bench_torch.py", "--smoke", "--device", "cpu"],
    "cli_bench": ["-m", "luminaai_tpu_torch", "benchmark"],
    "cli_ops": ["-m", "luminaai_tpu_torch", "benchmark", "--ops"],
}


@pytest.fixture(scope="module")
def runs():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI runs would run for real")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = {name: subprocess.Popen(
        [sys.executable, *argv], cwd=ROOT, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for name, argv in RUNS.items()}
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            lines = [json.loads(l) for l in stdout.splitlines()
                     if l.startswith("{")]
            out[name] = (proc.returncode, lines, stderr)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


def _one(runs, name, rc=0):
    code, lines, stderr = runs[name]
    assert code == rc, stderr[-3000:]
    assert len(lines) == 1, lines
    return lines[0]


def test_smoke_serve_line(runs):
    out = _one(runs, "serve")
    assert out["metric"] == "serve_tokens_per_sec_continuous"
    assert "error" not in out and out["value"] > 0
    ex = out["extras"]
    assert ex["platform"] == "cpu" and ex["decode_path"] == "plain"
    assert ex["model"]["card_layout"] is None  # bench.py's widths
    assert (ex["model"]["hidden"], ex["model"]["heads"]) == (64, 4)
    assert ex["tokens_continuous"] == ex["tokens_legacy"] > 0
    assert out["vs_baseline"] == pytest.approx(
        out["value"] / ex["legacy_tokens_per_sec"], rel=1e-2)
    for key in ("latency_ms_per_token", "ttft_ms", "legacy_ttft_ms",
                "legacy_ms_per_token"):
        assert ex[key]["p50"] is not None and ex[key]["p95"] is not None
    pc = ex["prefix_cache"]
    assert pc["hits"] > 0
    assert pc["prefill_tokens_saved"] >= 0.5 * pc["prompt_tokens_total"]
    assert ex["slo"]["objectives"] and ex["telemetry"]


def test_smoke_router_line(runs):
    out = _one(runs, "router")
    assert out["metric"] == "router_tokens_per_sec_2replica"
    router = out["extras"]["router"]
    assert router["routed_ok"] == router["routed_requests"] > 0
    assert router["failovers"] > 0
    assert router["post_kill_success_rate"] == 1.0
    assert router["breaker_opened"] is True
    share = out["extras"]["page_share"]
    assert share["device"] == "cpu" and share["remote_hit_admissions"] > 0
    assert share["prefill_tokens_cache_on"] < share["prefill_tokens_cache_off"]


def test_smoke_attribution_line(runs):
    out = _one(runs, "smoke")
    assert out["metric"] == "train_tokens_per_sec_per_chip_smoke"
    ex = out["extras"]
    assert "error" not in out and ex["platform"] == "cpu"
    assert ex["mfu"] is None  # measured on the card only
    assert ex["resumed_exact_data_state"] is True
    assert ex["slo"]["available"] and ex["slo"]["objectives"]
    assert ex["goodput"]["available"]
    io = ex["io_resilience"]
    assert io["round_trip"] and io["manifest_verified"]
    assert io["corruption_detected"] and io["io_retries_total"] >= 1
    assert ex["router_health"]["load_sum"] == pytest.approx(1.0, abs=1e-3)
    assert ex["compiled_cost"]["available"]
    assert ex["donation_audit"]["coverage"] == 1.0
    assert ex["recompile_surface"]["available"]
    assert ex["ep_dispatch"]["a2a_below_gather"]
    assert ex["grad_reduce"]["hier_below_flat"]
    assert ex["events"]["counts"]["preemption"] == 1


@pytest.mark.parametrize("name", ["cli_bench", "cli_ops"])
def test_cli_benchmark_without_a_card_prints_an_error_line(runs, name):
    code, lines, stderr = runs[name]
    assert code != 0, stderr[-2000:]
    assert len(lines) == 1 and "error" in lines[0], lines
    assert "backend_probe=none" in lines[0]["error"]
    assert not lines[0].get("value") and not lines[0].get("results")
