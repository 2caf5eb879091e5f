"""bench_ops_torch.py, the port's op table, on the CPU at --small shapes:

- `--small --device cpu` prints the human table and one JSON line with a
  row for each suite (attention, moe, loss, int8, rope), each suite's
  agreement check passed within its stated tolerance;
- a suite whose competitors disagree is not timed: it raises before any
  row (tolerances forced to 0 in-process);
- without a card and without --device, one JSON line with "error" and
  exit 1 (the probe answers that there is no card).
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import bench_ops_torch

ROOT = Path(__file__).resolve().parent.parent


def test_small_table_has_every_suite():
    proc = subprocess.run(
        [sys.executable, "bench_ops_torch.py", "--small", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [l for l in proc.stdout.splitlines() if l.startswith("{")]
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["platform"] == "cpu" and "errors" not in out
    suites = {r["suite"] for r in out["results"]}
    assert suites == set(bench_ops_torch.SUITES)
    assert all(r["ms"] > 0 for r in out["results"])
    for suite in bench_ops_torch.SUITES:
        check = out["checks"][suite]
        assert max(check["max_rel_err"].values()) <= check["tolerance"]
    # The human table precedes the line.
    assert "attention_flash_fwdbwd" in proc.stdout.split(lines[0])[0]


@pytest.mark.parametrize("suite", ["attention", "rope"])
def test_disagreeing_suite_is_not_timed(monkeypatch, suite):
    monkeypatch.setattr(bench_ops_torch, "TOLERANCES",
                        {k: 0.0 for k in bench_ops_torch.TOLERANCES})
    monkeypatch.setattr(bench_ops_torch, "_time_fn", lambda *a, **k: (
        pytest.fail("timed a suite that disagrees")))
    with pytest.raises(AssertionError, match="disagree"):
        bench_ops_torch._run_suite(suite, True, torch.device("cpu"))


def test_no_card_gives_an_error_line(monkeypatch, capsys):
    import bench_torch

    monkeypatch.setattr(bench_torch, "_probe_backend", lambda *a, **k: (
        "none", "backend_probe=none(attempts=1,waited=0s)"))
    assert bench_ops_torch.main([]) == 1
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["results"] == [] and "backend_probe=none" in out["error"]
