"""The CLI pieces of the A5 leftovers against the JAX CLI.

- `train`/`resume` take every JAX train flag (the port adds --dense,
  --seed, --device); --epochs, --no-moe, --attention-window,
  --profile-steps/--profile-start/--profile-dir, --cost-analysis,
  --watchdog/--no-watchdog, --slo/--no-slo and --auto-hardware give the
  Config fields JAX's build_config gives (the cards' memory and count
  patched alike on both sides for --auto-hardware).
- `report training` and `report data` write JAX's HTML but the
  "Generated on" timestamp.
- `events` prints what JAX's cmd_events prints over the same flight
  record, plain, --json, --stats, --stats --by tenant|request and with
  --type, --grep, --request, --since and --tail.
- The span tracer of `serve --trace-jax` mirrors spans as
  torch.profiler ranges.
"""

import argparse
import re
import time

import pytest
import torch

from luminaai_tpu import cli as jcli
from luminaai_tpu.utils import environment as jenv
from luminaai_tpu.utils import reporting as jrep
from luminaai_tpu_torch import cli
from luminaai_tpu_torch.monitoring.events import FlightRecorder
from luminaai_tpu_torch.monitoring.tracing import SpanTracer
from luminaai_tpu_torch.utils import environment as tenv

PORT_ONLY_TRAIN = {"--dense", "--seed", "--device"}


def _flags(parser, name):
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            sub = action.choices[name]
    return {opt: a for a in sub._actions for opt in a.option_strings
            if opt.startswith("--") and opt != "--help"}


@pytest.mark.parametrize("name", ["train", "resume"])
def test_train_flag_set_matches_jax(name):
    jf, tf = _flags(jcli.build_parser(), name), _flags(cli._parser(), name)
    assert set(tf) == set(jf) | PORT_ONLY_TRAIN
    for opt in set(jf) - {"--moe-dispatch", "--preset"}:
        ja, ta = jf[opt], tf[opt]
        assert (ta.dest, ta.default, type(ta)) == (
            ja.dest, ja.default, type(ja)), opt


FLAG_CASES = [
    ["--epochs", "5", "--no-moe", "--attention-window", "64"],
    ["--profile-steps", "2"],
    ["--profile-start", "4", "--profile-dir", "prof", "--cost-analysis"],
    ["--no-watchdog", "--watchdog-k", "5", "--watchdog-floor", "9",
     "--watchdog-abort", "--no-slo"],
    ["--watchdog", "--slo", "--steps", "7"],
    ["--auto-hardware"],
]
FIELDS = ("num_epochs", "use_moe", "attention_window", "profile_start_step",
          "profile_num_steps", "profile_dir", "compiled_cost_analysis",
          "watchdog", "watchdog_k", "watchdog_floor_s", "watchdog_abort",
          "slo", "max_steps", "expert_parallel_size", "data_parallel_size",
          "tensor_parallel_size", "fsdp_parallel_size")


@pytest.mark.parametrize("extra", FLAG_CASES, ids=lambda e: e[0])
def test_train_flags_give_jax_config(extra, monkeypatch):
    info = {"platform": "gpu", "device_count": 8, "local_device_count": 8,
            "device_kind": "card", "memory_per_device_gb": 80.0}
    for mod in (jenv, tenv):
        monkeypatch.setattr(mod, "get_device_info", lambda: dict(info))
    argv = ["train", "--preset", "debug", *extra]
    want = jcli.build_config(jcli.build_parser().parse_args(argv))
    got = cli._train_config(cli._parser().parse_args(argv))
    assert {f: getattr(got, f) for f in FIELDS} == {
        f: getattr(want, f) for f in FIELDS}


def _strip_time(html: str) -> str:
    return re.sub(r"<p>Generated on: [^<]*</p>", "", html)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("a7cli")
    assert cli.main(["train", "--preset", "debug", "--dense", "--synthetic",
                     "--steps", "2", "--batch-size", "2", "--grad-accum",
                     "1", "--seq-length", "32", "--device", "cpu",
                     "--no-adaptive", "--quiet", "--output-dir",
                     str(d / "run")]) == 0
    return d


def test_report_training_equals_jax(run_dir, capsys):
    run = run_dir / "run"
    assert cli.main(["report", "training", "--dir", str(run), "--out",
                     str(run_dir / "t.html")]) == 0
    jrep.create_training_report(str(run), str(run_dir / "j.html"))
    got = (run_dir / "t.html").read_text()
    assert "Final Metrics" in got and "Generated on" in got
    assert _strip_time(got) == _strip_time(
        (run_dir / "j.html").read_text())
    assert cli.main(["report", "training"]) == 2
    assert cli.main(["report", "training", "--dir", str(run_dir)]) == 1


def test_report_data_equals_jax(run_dir):
    from luminaai_tpu.data.tokenizer import ConversationTokenizer as JTok

    data = run_dir / "sample.jsonl"
    assert cli.main(["data", "sample", "--out", str(data), "--count",
                     "20"]) == 0
    assert cli.main(["report", "data", str(data), "--out",
                     str(run_dir / "td.html")]) == 0
    jrep.create_data_summary_report([str(data)], JTok(),
                                    str(run_dir / "jd.html"))
    assert _strip_time((run_dir / "td.html").read_text()) == _strip_time(
        (run_dir / "jd.html").read_text())


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    """A flight record of step, router and request events from two
    tenants, spread over the last minutes."""
    d = tmp_path_factory.mktemp("flight")
    rec = FlightRecorder(capacity=256)
    now = time.time()
    for i in range(30):
        kind = ("train_step", "router_health", "request_admitted",
                "request_completed")[i % 4]
        ev = rec.emit(kind, step=i, tenant=("alice", "bob")[i % 2],
                      request_id=f"r{i % 5}", note=f"n{i}")
        ev["ts"] = now - 300 + 10 * i
    path = rec.dump_to_dir(str(d), "test")
    assert path
    return d


EVENT_ARGS = [[], ["--json"], ["--stats"], ["--stats", "--json"],
              ["--stats", "--by", "tenant"], ["--by", "request"],
              ["--type", "router_health"], ["--grep", "n1[0-9]"],
              ["--request", "r3"], ["--since", "2m"], ["--tail", "4"],
              ["--type", "nothing"]]


@pytest.mark.parametrize("extra", EVENT_ARGS, ids=lambda e: "_".join(e)
                         or "plain")
def test_events_equal_jax(dump, extra, capsys):
    argv = ["events", str(dump), *extra]
    assert cli.main(argv) == 0
    got = capsys.readouterr()
    args = jcli.build_parser().parse_args(argv)
    assert jcli.cmd_events(args) == 0
    want = capsys.readouterr()
    assert got.out == want.out
    assert got.err == want.err
    if extra in ([], ["--json"]):
        assert got.out.count("\n") == 30


def test_events_refusals(tmp_path, capsys):
    assert cli.main(["events", "--grep", "("]) == 2
    assert cli.main(["events", "--since", "soon"]) == 2
    assert cli.main(["events", str(tmp_path)]) == 2


def test_trace_jax_spans_are_profiler_ranges():
    from torch.profiler import ProfilerActivity, profile

    tracer = SpanTracer(profiler_ranges=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("prefill_chunk", slot=1):
            with tracer.span("decode_step"):
                torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"prefill_chunk", "decode_step"} <= names
    assert [s.name for s in tracer.recent()] == ["decode_step",
                                                   "prefill_chunk"]
    args = cli._parser().parse_args(["serve", "--trace-jax"])
    assert args.trace_jax is True
