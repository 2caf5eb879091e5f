"""Each cell on the card (skips without one): `python3 portbench/run.py`
exits 0 with a correct result line."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench.tests.portbench_tiny import CELLS

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the port's kernels have no CPU "
                    "mode")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2**33 + 5), "--seconds", "3", "--trace", str(trace)],
        cwd=str(ROOT), capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, out.stderr[-3000:]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == 1
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["breakdown"]["device_ops"]
    else:
        assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}
