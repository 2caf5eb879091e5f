"""The harness finds what it runs by name, keeps BENCHMARK.json's shape,
and takes rates over the whole window (CPU, tiny widths)."""

from __future__ import annotations

import json
import re
import shutil
import time
from pathlib import Path

import pytest
import torch

from portbench import run
from portbench.lib import spec
from portbench.lib.window import timed_steps
from portbench.tests.portbench_tiny import CELLS, tiny

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CPU = torch.device("cpu")


def test_benchmark_json_names_files_that_exist():
    bench = spec.load_benchmark(ROOT)
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in bench[k]]
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["source"] == c["source"]
        assert sorted(f["reduced"]) == sorted(c["reduced"])
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], ROOT)
        assert (ROOT / "portbench" / "drivers"
                / f"{cell['driver']}.py").exists()
        assert any(m["name"] == "setup_s"
                   for m in spec.end_to_end_of(bench, w["name"]))
        assert len(spec.end_to_end_of(bench, w["name"])) >= 2
        assert spec.per_layer_of(bench, w["name"])
    for m in bench["per_layer"]:
        assert callable(spec.load_reader(m["name"], ROOT))
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_per_layer_metrics_follow_their_workloads_key():
    bench = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}],
             "per_layer": [{"name": "p", "moves": "a"},
                           {"name": "q", "moves": "b"},
                           {"name": "r", "moves": "a", "workloads": ["y"]}]}
    assert [m["name"] for m in spec.per_layer_of(bench, "x")] == ["p", "q"]
    assert [m["name"] for m in spec.per_layer_of(bench, "y")] == ["p", "r"]


def _copy_benchmark(dst: Path) -> None:
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))


def test_added_config_cell_and_metric_are_taken_up_from_files(tmp_path):
    """A configuration, a cell and a per-layer metric added as files and
    entries, in a copy of the benchmark, with no file edited."""
    _copy_benchmark(tmp_path)
    pb = tmp_path / "portbench"
    base = json.loads((pb / "configs" / "b1.json").read_text())
    base["config"].update(tiny("b1.train")["config"], num_layers=1)
    (pb / "configs" / "tiny_moe.json").write_text(json.dumps(base))
    (pb / "cells" / "tiny_moe.train.json").write_text(json.dumps({
        "driver": "train", "why": "a throwaway cell",
        "params": {"batches": 4, "checked_steps": 2, "schedule_steps": 100,
                   "trace_steps": 1,
                   "limits": {"loss_gap": 1.0, "grad_gap": 1.0,
                              "change_gap": 1.0}}}))
    (pb / "metrics" / "steps_seen.train.py").write_text(
        "def read(w):\n    return float(w.fact('steps'))\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_moe", "source": "x",
                             "file": "portbench/configs/tiny_moe.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny_moe.train",
                               "config": "tiny_moe", "traffic": "train",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "steps_seen.train", "unit": "steps",
                               "better": "higher", "source": "device_trace",
                               "layer": "device",
                               "moves": "train_tokens_per_s",
                               "workloads": ["tiny_moe.train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    line, _ = run.run_cell("tiny_moe.train", 3, 0.2, True, CPU,
                           root=tmp_path, log=lambda m: None)
    assert line["metrics"]["steps_seen.train"]["value"] == 1.0
    assert line["correct"] is True
    line, _ = run.run_cell("tiny_moe.train", 3, 0.2, False, CPU,
                           root=tmp_path, log=lambda m: None)
    assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert list(line)[-1] == "checks"


class _Clock:
    def __init__(self):
        self.calls = []

    def step(self, i):
        time.sleep(0.02)
        self.calls.append(i)
        return i


def test_window_counts_every_step_and_all_of_its_time():
    c = _Clock()
    t0 = time.perf_counter()
    n, wall, results = timed_steps(c.step, 0.15, CPU)
    total = time.perf_counter() - t0
    assert n == len(c.calls) == len(results) and results == list(range(n))
    assert wall >= 0.15 and wall <= total
    # The last step (the one that crossed the limit) is in the count and
    # its time in the window.
    assert wall >= n * 0.02


@pytest.mark.parametrize("cell", CELLS)
def test_run_cell_line_has_the_result_keys(cell):
    line, checks = run.run_cell(cell, 2**31 + 17, 0.3, False, CPU,
                                overrides=tiny(cell), log=lambda m: None)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    rate = line["metrics"]["train_tokens_per_s"]
    assert rate["unit"] == "tokens/s" and rate["value"] > 0
    compared = [c for c in checks if c.startswith("check ")]
    assert checks[-len(compared):] == compared
    assert len(compared) == len(line["checks"])
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}


def test_run_exits_non_zero_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(run, "fix_caches", lambda: None)
    monkeypatch.setattr(run, "few_threads", lambda: None)
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    rc = run.main(["--workload", "b1.train", "--seed", "1", "--seconds",
                   "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "luminaai_tpu_torch_x",
                        types.ModuleType("luminaai_tpu_torch_x"))
    assert "luminaai_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert run.forbidden_modules() == ["jax"]


def test_profile_steps_records_only_the_steps_after_the_warm_one(tmp_path):
    """The warm step pays the profiler's start-up outside the trace; the
    trace holds the recorded steps' scopes, and `before_active` runs
    between the two."""
    from torch.profiler import record_function

    from portbench.lib import device as dev, trace as tr

    calls = []

    def one():
        with record_function("pb_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
        calls.append(1)

    box = dev.profile_steps(CPU, one, 3, True,
                            before_active=lambda: len(calls))
    assert box["mark"] == 1 and len(calls) == 4 and box["host_s"] > 0
    path = tmp_path / "t.json"
    box["prof"].export_chrome_trace(str(path))
    got = tr.read_trace(json.loads(path.read_text()))
    assert tr.scope_count(got, "pb_step") == 3


def test_mfu_is_taken_from_the_untraced_steps():
    """mfu.train divides the model FLOPs by the untraced steps' seconds,
    not by the traced window."""
    from portbench.lib import flops
    from portbench.lib.trace import Trace
    from portbench.lib.window import Window

    config = dict(tiny("b1.train")["config"], num_experts=8, moe_top_k=2,
                  use_moe=True)
    s = flops.shapes(config)
    w = Window(trace=Trace([], [], []), window_s=9.0, busy_s=1.0, cell={},
               config=config, shapes=s,
               facts={"steps": 2, "untraced_s": 0.5})
    want = (100.0 * 2 * flops.train_step_flops(s, config["batch_size"],
                                               config["seq_length"])
            / 0.5 / flops.PEAK_BF16_FLOPS)
    assert spec.load_reader("mfu.train", ROOT)(w) == pytest.approx(want)
