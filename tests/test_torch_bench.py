"""The port's bench harness (bench_torch.py) against bench.py's contract.

- Config parity: every rung's port _child_config equals bench.py's,
  field by field (the port's Config fields; JAX-only attention backends
  read as the port's 'ragged', as the port's Config maps them).
- Step parity: the `smoke` rung's first train step against JAX's from
  the same flax init (convert.params_from_flax) and the same
  RandomState(0) batch, routing noise off (dropout and expert dropout are
  off in the rung): loss and grad norm within rtol 1e-5 (fp32).
- main()'s ladder and the card probe with the children faked, mirroring
  tests/test_bench_contract.py's non-cache cases: the headline with the
  flagship embedded, a flagship failure survived, the ladder walked in
  order, every rung failing still one line; the probe's wait, budget and
  crash-loop cases. No card: one line with "error", exit 1, no rung run.
- The CLI's `benchmark [--ops]` spawns the right script and passes its
  exit code through (2 when it is missing). Run for real without a card:
  tests/test_torch_bench_smoke.py.
"""

import contextlib
import dataclasses
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bench
import bench_torch
from luminaai_tpu.models.transformer import LuminaTransformer as JModel
from luminaai_tpu.parallel.mesh import build_mesh
from luminaai_tpu.parallel.sharding import init_sharded_state
from luminaai_tpu.parallel.train_step import make_train_step as jmake_step
from luminaai_tpu.training.optimizer import make_optimizer as jmake_opt
from luminaai_tpu.training.optimizer import make_schedule as jmake_sched
from luminaai_tpu_torch import cli
from luminaai_tpu_torch.config import JAX_ONLY_BACKENDS
from luminaai_tpu_torch.convert import params_from_flax
from luminaai_tpu_torch.models.transformer import LuminaTransformer as TModel
from luminaai_tpu_torch.parallel import train_step as ts
from luminaai_tpu_torch.training.optimizer import make_optimizer, make_schedule

ROOT = Path(__file__).resolve().parent.parent
RUNGS = ("ref_debug_moe", "flagship_tuned", "flagship", "flagship_small",
         "ref_debug_dense", "ref_200m_dense", "ref_200m_mod",
         "ref_200m_hybrid", "dense200", "smoke")


@pytest.mark.parametrize("name", RUNGS)
def test_rung_config_matches_bench_py(name):
    want = dataclasses.asdict(bench._child_config(name, 1))
    got = dataclasses.asdict(bench_torch._child_config(name, 1))
    if want["attention_backend"] in JAX_ONLY_BACKENDS:
        want["attention_backend"] = "ragged"
    diff = {k: (v, want[k]) for k, v in got.items() if want[k] != v}
    assert diff == {}


def test_ladder_holds_bench_py_rungs_but_the_cpu_one():
    assert bench_torch.LADDER == [r for r in bench.LADDER
                                  if r[0] != "cpu_fallback"]
    assert bench_torch.REF_TABLE_RUNGS == bench.REF_TABLE_RUNGS
    assert bench_torch.REF_BASELINES == bench.REF_BASELINES
    assert bench_torch.METRIC == bench.METRIC
    with pytest.raises(ValueError, match="unknown rung"):
        bench_torch._child_config("cpu_fallback")


def test_smoke_rung_first_step_matches_jax():
    jcfg = dataclasses.replace(bench._child_config("smoke", 1),
                               routing_noise_std=0.0)
    tcfg = dataclasses.replace(bench_torch._child_config("smoke", 1),
                               routing_noise_std=0.0)
    assert (tcfg.dropout, tcfg.expert_dropout_rate) == (0.0, 0.0)
    jmodel = JModel(jcfg)
    jsched = jmake_sched(jcfg, 1000)
    jtx = jmake_opt(jcfg, 1000, jsched)
    mesh = build_mesh(jcfg, devices=jax.devices()[:1])
    jstate, shardings = init_sharded_state(jcfg, jmodel, jtx, mesh,
                                           jax.random.key(0))
    jstep = jmake_step(jcfg, jmodel, shardings, mesh, jsched, jtx)

    model = TModel(tcfg, device="cpu", trainable=True)
    model.load_params(params_from_flax(jax.device_get(jstate.params), tcfg))
    sched = make_schedule(tcfg, 1000)
    tx = make_optimizer(tcfg, 1000, sched)
    state = ts.init_train_state(model, tx, bench_torch.RUNG_SEED)
    step = ts.make_train_step(tcfg, model, sched, tx)

    ids = np.random.RandomState(0).randint(
        1, jcfg.vocab_size, size=(jcfg.batch_size, jcfg.seq_length))
    batch = bench_torch._rung_batch(tcfg, torch.device("cpu"))
    np.testing.assert_array_equal(batch["input_ids"].numpy(), ids)
    _, mj = jstep(jstate, {"input_ids": jnp.asarray(ids, jnp.int32)})
    _, mt = step(state, batch)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(mt[key]), float(mj[key]),
                                   rtol=1e-5, err_msg=key)


# -- main(): the ladder, with the children faked -------------------------
def _canned(name):
    base = {"unit": "tokens/sec/chip"}
    if name == "ref_debug_moe":
        return {**base, "metric": bench_torch.METRIC, "value": 2_000_000.0,
                "vs_baseline": 33.6,
                "extras": {"chips": 1, "platform": "gpu",
                           "config": "ref_debug_moe", "batch": 256,
                           "seq": 256, "mfu": 0.001, "step_ms": 32.8}}
    if name == "flagship_tuned":
        return {**base, "metric": bench_torch.METRIC, "value": 54_800.0,
                "vs_baseline": 0.921,
                "extras": {"chips": 1, "platform": "gpu",
                           "config": "flagship_tuned",
                           "total_params_m": 757.0, "active_params_m": 238.0,
                           "batch": 16, "seq": 2048, "mfu": 0.079,
                           "model_tflops_per_sec": 78.2,
                           "moe_drop_rate": 0.2,
                           "moe_drop_rate_steady": 0.04, "step_ms": 597.6}}
    if name in ("flagship", "flagship_small"):
        return {**base, "metric": bench_torch.METRIC, "value": 50_000.0,
                "vs_baseline": 0.84, "extras": {"config": name}}
    return {**base, "metric": f"train_tokens_per_sec_per_chip_{name}",
            "value": 100_000.0, "vs_baseline": 0.84,
            "extras": {"config": name, "step_ms": 300.0, "batch": 16,
                       "seq": 2048}}


@pytest.fixture
def harness(monkeypatch, tmp_path):
    """main() with the probe answering "gpu", the kernel build faked and
    the sidecars written under tmp_path."""
    monkeypatch.setattr(bench_torch, "OUT_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(
        bench_torch, "_probe_backend",
        lambda *a, **k: ("gpu", "backend_probe=gpu(attempts=1,waited=0s)"))
    monkeypatch.setattr(bench_torch, "_build_kernels",
                        lambda *a, **k: "kernel_build=ok(built in 1.0s)")
    calls = []

    def fake_children(fail=()):
        def run(name, timeout):
            calls.append(name)
            if name in fail:
                return None, f"{name}: timeout after {timeout}s"
            return _canned(name), f"{name}: ok"
        monkeypatch.setattr(bench_torch, "_run_child", run)

    return calls, fake_children, tmp_path / "out"


def _run_main():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_torch.main()
    lines = [l for l in buf.getvalue().splitlines()
             if l.strip().startswith("{")]
    assert len(lines) == 1, f"exactly one JSON line: {lines}"
    return rc, json.loads(lines[0])


def test_headline_with_flagship_embedded_and_sidecars(harness):
    calls, fake, out_dir = harness
    fake()
    rc, out = _run_main()
    assert rc == 0
    assert calls == ["ref_debug_moe", "flagship_tuned", "dense200",
                     *bench_torch.REF_TABLE_RUNGS]
    assert out["value"] == 2_000_000.0
    assert out["extras"]["config"] == "ref_debug_moe"
    assert out["extras"]["flagship"]["value"] == 54_800.0
    assert out["extras"]["flagship"]["mfu"] == 0.079
    assert "ladder_diag" not in out["extras"]
    dense = json.loads((out_dir / "DENSE_BENCH.json").read_text())
    assert dense["value"] == 100_000.0
    table = json.loads((out_dir / "REF_TABLE.json").read_text())
    assert [r["config"] for r in table["rows"]] == list(
        bench_torch.REF_TABLE_RUNGS)
    assert all(r["tokens_per_sec_per_chip"] == 100_000.0
               for r in table["rows"])


def test_flagship_failure_costs_only_its_extras(harness):
    calls, fake, out_dir = harness
    fake(fail=("flagship_tuned", "dense200"))
    rc, out = _run_main()
    assert rc == 0 and out["value"] == 2_000_000.0
    assert "flagship" not in out["extras"]
    assert out["extras"]["ladder_diag"] == [
        "flagship_tuned: timeout after 900s"]
    assert "error" in json.loads((out_dir / "DENSE_BENCH.json").read_text())


@pytest.mark.parametrize("dead,headline", [
    (("ref_debug_moe",), "flagship_tuned"),
    (("ref_debug_moe", "flagship_tuned"), "flagship"),
    (("ref_debug_moe", "flagship_tuned", "flagship"), "flagship_small"),
])
def test_ladder_walks_in_order(harness, dead, headline):
    calls, fake, _ = harness
    fake(fail=dead)
    rc, out = _run_main()
    assert rc == 0
    assert out["extras"]["config"] == headline
    assert calls[:len(dead) + 1] == [n for n, _ in bench_torch.LADDER][
        :len(dead) + 1]
    # Every failed rung's diagnostic is kept.
    assert [d.split(":")[0] for d in out["extras"]["ladder_diag"]] == list(
        dead)


def test_every_rung_failing_still_gives_one_line(harness):
    calls, fake, _ = harness
    fake(fail=[n for n, _ in bench_torch.LADDER])
    rc, out = _run_main()
    assert rc == 1
    assert out["value"] == 0.0 and out["metric"] == bench_torch.METRIC
    assert all(n in out["error"] for n, _ in bench_torch.LADDER)
    assert calls == [n for n, _ in bench_torch.LADDER]


@pytest.mark.parametrize("probe", [
    ("none", "backend_probe=none(attempts=1,waited=0s)"),
    (None, "backend_probe=failed(attempts=5,waited=1500s,budget=1500s)"),
], ids=["no_card", "probe_failed"])
def test_no_card_no_number(harness, monkeypatch, probe):
    """Without a card: one line with value 0.0 and "error", exit 1, and no
    rung runs (nothing is measured on the CPU in the card's place)."""
    calls, fake, _ = harness
    fake()
    monkeypatch.setattr(bench_torch, "_probe_backend", lambda *a, **k: probe)
    rc, out = _run_main()
    assert rc == 1
    assert out["value"] == 0.0 and probe[1] in out["error"]
    assert calls == []


def test_kernel_build_failure_gives_an_error_line(harness, monkeypatch):
    calls, fake, _ = harness
    fake()
    monkeypatch.setattr(bench_torch, "_build_kernels",
                        lambda *a, **k: "kernel_build=failed(nvcc)")
    rc, out = _run_main()
    assert rc == 1 and "kernel_build=failed" in out["error"]
    assert calls == []


# -- the card probe ------------------------------------------------------
class _FakeClock:
    """Deterministic monotonic clock; sleep() advances it."""

    def __init__(self):
        self.now = 0.0
        self.sleeps = []

    def monotonic(self):
        return self.now

    def sleep(self, s):
        self.sleeps.append(s)
        self.now += s


def _answer(stdout, rc=0, stderr=""):
    class P:
        returncode = rc

    P.stdout, P.stderr = stdout, stderr
    return P()


def _patch_probe(monkeypatch, run_impl, clock):
    class FakeTime:
        monotonic = staticmethod(clock.monotonic)
        sleep = staticmethod(clock.sleep)
        perf_counter = staticmethod(clock.monotonic)

    class FakeSubprocess:
        TimeoutExpired = subprocess.TimeoutExpired
        run = staticmethod(run_impl)

    monkeypatch.setattr(bench_torch, "time", FakeTime)
    monkeypatch.setattr(bench_torch, "subprocess", FakeSubprocess)


def test_probe_waits_out_an_outage(monkeypatch):
    clock, attempts = _FakeClock(), []

    def run_impl(cmd, timeout=None, **k):
        attempts.append(clock.now)
        if len(attempts) < 4:
            clock.now += timeout  # the probe hangs for its whole timeout
            raise subprocess.TimeoutExpired(cmd, timeout)
        clock.now += 5
        return _answer("1 gpu")

    _patch_probe(monkeypatch, run_impl, clock)
    platform, diag = bench_torch._probe_backend()
    assert platform == "gpu" and "attempts=4" in diag
    assert clock.sleeps == [60, 60, 60]


def test_probe_answering_no_card_returns_at_once(monkeypatch):
    clock = _FakeClock()
    _patch_probe(monkeypatch, lambda cmd, timeout=None, **k: _answer(
        "0 none"), clock)
    platform, diag = bench_torch._probe_backend()
    assert platform == "none" and clock.sleeps == []


def test_probe_surrenders_after_its_budget(monkeypatch):
    clock, attempts = _FakeClock(), []

    def run_impl(cmd, timeout=None, **k):
        attempts.append(clock.now)
        clock.now += timeout
        raise subprocess.TimeoutExpired(cmd, timeout)

    _patch_probe(monkeypatch, run_impl, clock)
    platform, diag = bench_torch._probe_backend(budget_s=600)
    assert platform is None and "failed" in diag
    assert all(t < 600 for t in attempts)
    assert clock.now <= 600 + 90 + 60


def test_probe_crash_loop_surrenders_early_with_stderr(monkeypatch):
    clock, attempts = _FakeClock(), []

    def run_impl(cmd, timeout=None, **k):
        attempts.append(clock.now)
        clock.now += 3  # a fast crash
        return _answer("", 1, "RuntimeError: CUDA driver initialization "
                              "failed\n")

    _patch_probe(monkeypatch, run_impl, clock)
    platform, diag = bench_torch._probe_backend(budget_s=1500)
    assert platform is None
    assert "CUDA driver initialization failed" in diag
    assert clock.now <= 300 + 90 + 60 and len(attempts) < 8


def test_probe_hang_after_crashes_restores_the_budget(monkeypatch):
    clock, attempts = _FakeClock(), []

    def run_impl(cmd, timeout=None, **k):
        attempts.append(clock.now)
        if len(attempts) <= 2:
            clock.now += 3
            return _answer("", 1, "exit 1\n")
        if clock.now < 700:
            clock.now += timeout
            raise subprocess.TimeoutExpired(cmd, timeout)
        return _answer("1 gpu")

    _patch_probe(monkeypatch, run_impl, clock)
    platform, _ = bench_torch._probe_backend(budget_s=1500)
    assert platform == "gpu"


def test_probe_malformed_budget_env_defaults(monkeypatch):
    clock = _FakeClock()
    _patch_probe(monkeypatch, lambda cmd, timeout=None, **k: _answer(
        "1 gpu"), clock)
    monkeypatch.setenv("BENCH_PROBE_BUDGET_S", "25min")
    assert bench_torch._probe_backend()[0] == "gpu"


# -- the CLI ---------------------------------------------------------------
@pytest.mark.parametrize("argv,script", [
    (["benchmark"], "bench_torch.py"),
    (["benchmark", "--ops"], "bench_ops_torch.py"),
], ids=["bench", "ops"])
def test_cli_benchmark_spawns_the_script(monkeypatch, argv, script):
    spawned = []

    def call(cmd):
        spawned.append(cmd)
        return 7

    monkeypatch.setattr(subprocess, "call", call)
    assert cli.main(argv) == 7
    assert spawned == [[sys.executable, str(ROOT / script)]]


def test_cli_benchmark_missing_script_exits_2(monkeypatch, tmp_path):
    monkeypatch.setattr(cli, "__file__",
                        str(tmp_path / "pkg" / "cli.py"))
    assert cli.main(["benchmark"]) == 2
