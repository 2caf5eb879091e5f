"""The plain reference against the port at tiny widths on the CPU; the
fp8 control, and the timed path broken underneath, come out not
correct."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import run
from portbench.lib import check, spec
from portbench.lib.inputs import batches
from portbench.reference.train import steps as reference_steps
from portbench.tests.portbench_tiny import CELLS, fp32, tiny

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")


def _line(cell, overrides, seed=11):
    line, _ = run.run_cell(cell, seed, 0.2, False, CPU, overrides=overrides,
                           log=lambda m: None)
    return line


def _numbers(cell, overrides, seed=11):
    """Every number the comparison reads, compared or not."""
    _, driver, ctx = run.make_context(cell, seed, 0.2, False, CPU,
                                      overrides=overrides,
                                      log=lambda m: None)
    return driver.run(ctx)["numbers"]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_equals_the_port_in_float32(cell):
    """With the program in float32 too, the two differ by rounding only:
    the routing noise, capacity, aux losses, clipping, AdamW and the
    schedule are the same."""
    nums = _numbers(cell, fp32(cell))
    assert nums["loss_gap"] < 1e-5
    assert nums["grad_gap"] < 1e-4
    assert nums["change_gap"] < 1e-4


@pytest.mark.parametrize("cell", CELLS)
def test_reference_near_the_port_in_bf16(cell):
    nums = _numbers(cell, tiny(cell))
    assert nums["loss_gap"] < 1e-3
    assert nums["grad_gap"] < 1e-2
    assert nums["change_gap"] < 1e-2


def _config(cell, overrides):
    bench = spec.load_benchmark(ROOT)
    wl = spec.by_name(bench["workloads"], cell, "workload")
    entry = spec.by_name(bench["configs"], wl["config"], "configuration")
    cfg = dict(spec.load_config(entry, ROOT)["config"])
    cfg.update(overrides["config"])
    return cfg


@pytest.mark.parametrize("cell", CELLS)
def test_fp8_control_reads_well_above_the_program(cell):
    """The control (the reference with fp8 products in the program's
    place) reads a grad_gap several times the bf16 program's."""
    o = tiny(cell)
    cfg = _config(cell, o)
    ids = batches(11, 6, cfg["batch_size"], cfg["seq_length"],
                  cfg["vocab_size"], CPU)[:3]
    ref = reference_steps(cfg, 11, ids, 3, 1000)
    ctl = reference_steps(cfg, 11, ids, 3, 1000, precision="fp8")
    control = check.compare(ctl, ref)["grad_gap"]["value"]
    program = _numbers(cell, o)["grad_gap"]
    assert control >= 3 * program


def _unchanged(monkeypatch):
    from luminaai_tpu_torch.training import optimizer

    def apply(self, params, grads, state):  # the state left as it was
        return self.learning_rate(state.count)

    monkeypatch.setattr(optimizer.AdamW, "apply", apply)


def _half_batch(monkeypatch):
    from luminaai_tpu_torch.parallel import train_step as ts

    real = ts.make_train_step

    def make(config, model, schedule, tx, loss_fn=None):
        inner = real(config, model, schedule, tx, loss_fn)

        def step(state, batch):  # half the rows, the mean over the rest
            rows = batch["input_ids"].shape[0] // 2
            return inner(state, {k: v[:rows] for k, v in batch.items()})

        return step

    monkeypatch.setattr(ts, "make_train_step", make)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch],
                         ids=["state_unchanged", "half_batch"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    """A sound float32 run passes the cell's limits; the same run with
    the timed path broken underneath does not."""
    o = fp32(cell)
    if fault is _half_batch and cell.startswith("b1."):
        o["config"]["batch_size"] = 8  # half still splits into 2 micro
    assert _line(cell, o)["correct"] is True
    fault(monkeypatch)
    assert _line(cell, o)["correct"] is False


PROBE = """
import json, sys
sys.path.insert(0, {root!r})
import torch
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(body: str):
    out = subprocess.run([sys.executable, "-c", PROBE.format(
        root=str(ROOT), body=body)], capture_output=True, text=True,
        timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_of_every_cell_loads_no_jax_package():
    body = "\n".join([
        "from portbench import run",
        "from portbench.tests.portbench_tiny import CELLS, tiny",
        "for c in CELLS:",
        "    run.run_cell(c, 5, 0.1, False, torch.device('cpu'),",
        "                 overrides=tiny(c), log=lambda m: None)",
        "    run.run_cell(c, 5, 0.1, True, torch.device('cpu'),",
        "                 overrides=tiny(c), log=lambda m: None)"])
    mods = _modules(body)
    assert "luminaai_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "luminaai_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    body = "\n".join([
        "from portbench.reference.train import steps",
        "from portbench.lib.inputs import batches",
        "from portbench.tests.portbench_tiny import TINY",
        "cfg = json.load(open('portbench/configs/b1.json'))['config']",
        "cfg.update(TINY, gradient_accumulation_steps=2)",
        "ids = batches(5, 2, 4, 64, 512, torch.device('cpu'))",
        "steps(cfg, 5, ids, 2, 100)",
        "steps(cfg, 5, ids, 1, 100, precision='fp8')"])
    mods = _modules(body)
    assert not mods & {"jax", "jaxlib", "flax", "luminaai_tpu",
                       "luminaai_tpu_torch"}
