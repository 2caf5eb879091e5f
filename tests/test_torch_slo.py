"""The port's SLO engine, time-series ring, span tracer and `top`, against
the JAX package's.

The same sample streams go through both sides (each side's own
MetricsRegistry, FlightRecorder, TimeSeriesRing and SLOEngine, a fake
clock): every evaluation's verdicts (states, burn rates, values), the ring's
windows and snapshots, the slo_burn transitions in the flight recorder and
the alert counters are equal (exact: host arithmetic on the same floats).
The default serving objectives and a --slo-config override resolve alike;
build_slo_stack reads the same Config knobs. SpanTracer writes the same
span records but for their timestamps and durations. `top` renders the
same frame (and --json payload) from the same history and verdicts, also
through the CLI's --url source against a live port server.
"""

import json
import threading

import numpy as np
import pytest

from luminaai_tpu.config import Config as JConfig
from luminaai_tpu.monitoring import events as jev
from luminaai_tpu.monitoring import slo as jslo
from luminaai_tpu.monitoring import telemetry as jtel
from luminaai_tpu.monitoring import timeseries as jts
from luminaai_tpu.monitoring import top as jtop
from luminaai_tpu.monitoring import tracing as jtr
from luminaai_tpu_torch.config import Config as TConfig
from luminaai_tpu_torch.monitoring import events as tev
from luminaai_tpu_torch.monitoring import slo as tslo
from luminaai_tpu_torch.monitoring import telemetry as ttel
from luminaai_tpu_torch.monitoring import timeseries as tts
from luminaai_tpu_torch.monitoring import top as ttop
from luminaai_tpu_torch.monitoring import tracing as ttr

SIDES = {
    "jax": (jtel, jev, jts, jslo),
    "torch": (ttel, tev, tts, tslo),
}


def _rig(side):
    tel, ev, ts, slo = SIDES[side]
    reg = tel.MetricsRegistry()
    rec = ev.FlightRecorder()
    hists = {
        name: reg.histogram(name, "", buckets=tel.DEFAULT_LATENCY_BUCKETS)
        for name in ("serve_ttft_seconds", "serve_token_latency_seconds")
    }
    counters = {
        name: reg.counter(name, "")
        for name in ("serve_admissions_total",
                     "serving_requests_timed_out_total",
                     "serving_overload_rejections_total",
                     "serve_tokens_out_total")
    }
    tenant = reg.counter("tenant_tokens_out_total", "",
                         labelnames=("tenant",))
    ring = ts.TimeSeriesRing(reg, interval_s=1.0, capacity=64)
    cfg = (JConfig if side == "jax" else TConfig)(
        vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
        num_kv_heads=2, seq_length=64, slo_ttft_p95_s=0.5,
        slo_decode_p50_s=0.05, slo_error_rate=0.1,
    )
    eng = slo.SLOEngine(
        ring, slo.default_serve_objectives(cfg), registry=reg, recorder=rec,
        program="serve", fast_window_s=10.0, slow_window_s=100.0,
        fast_burn=10.0, slow_burn=2.0, clear_evals=2,
    )
    return reg, rec, hists, counters, tenant, ring, eng


def _drive(side, seed):
    """One seeded stream: healthy traffic, a stall (slow TTFT, errors),
    recovery. Returns everything observable."""
    reg, rec, hists, counters, tenant, ring, eng = _rig(side)
    rng = np.random.RandomState(seed)
    verdicts = []
    t = 1000.0
    for i in range(90):
        bad = 30 <= i < 55
        for _ in range(rng.randint(1, 6)):
            hists["serve_ttft_seconds"].observe(
                float(rng.uniform(1.0, 4.0) if bad else rng.uniform(0.01, 0.3)))
            hists["serve_token_latency_seconds"].observe(
                float(rng.uniform(0.001, 0.04)))
            counters["serve_admissions_total"].inc()
            tenant.labels(tenant=f"t{rng.randint(3)}").inc(
                int(rng.randint(1, 30)))
        if bad and rng.rand() < 0.6:
            counters["serving_requests_timed_out_total"].inc()
        if rng.rand() < 0.1:
            counters["serving_overload_rejections_total"].inc()
        counters["serve_tokens_out_total"].inc(int(rng.randint(0, 50)))
        now = t + i if i < 60 else t + 500 + i
        ring.sample_once(now=now)
        v = eng.evaluate(now=now)
        v.pop("ts", None)
        verdicts.append(v)
    burns = [(e["type"], e.get("objective"), e.get("severity"),
              e.get("transition"), e.get("prev_state"))
             for e in rec.snapshot(type="slo_burn")]
    slo_lines = [line for line in reg.render_prometheus().splitlines()
                 if line.startswith("slo_")]
    snap = ring.snapshot(window_s=400.0, max_points=50)
    snap.pop("ts", None)
    snap.pop("created_ts", None)
    return {
        "verdicts": verdicts,
        "burns": burns,
        "slo_metrics": slo_lines,
        "windows": ring.window("serve_ttft_seconds:p95", 1000, now=t + 700),
        "sum": ring.window_sum(["serve_admissions_total"], 30.0,
                               now=t + 589),
        "snapshot": snap,
        "states": {o: eng.state(o) for o in eng.verdicts()["objectives"]},
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_same_streams_same_burn_rates_and_transitions(seed):
    want = _drive("jax", seed)
    got = _drive("torch", seed)
    assert got["burns"], "the stall never paged"
    assert got == want


def test_default_objectives_and_override_resolve_alike(tmp_path):
    cfgs = (JConfig(slo_ttft_p95_s=1.5), TConfig(slo_ttft_p95_s=1.5))
    for prog in ("serve", "train"):
        j = [o.to_dict() for o in jslo.objectives_for(prog, cfgs[0])]
        t = [o.to_dict() for o in tslo.objectives_for(prog, cfgs[1])]
        assert t == j
    path = tmp_path / "slo.json"
    path.write_text(json.dumps({"objectives": [
        {"name": "x", "series": "serve_ttft_seconds:p50", "op": "<=",
         "target": 0.2, "budget": 0.05}]}))
    assert ([o.to_dict() for o in tslo.load_slo_config(str(path))]
            == [o.to_dict() for o in jslo.load_slo_config(str(path))])
    jring, jeng = jslo.build_slo_stack(cfgs[0], registry=jtel.MetricsRegistry())
    tring, teng = tslo.build_slo_stack(cfgs[1], registry=ttel.MetricsRegistry())
    for a in ("interval_s", "capacity", "max_series"):
        assert getattr(tring, a) == getattr(jring, a)
    assert ([o.to_dict() for o in teng.objectives]
            == [o.to_dict() for o in jeng.objectives])


def _spans(mod, path):
    tr = mod.SpanTracer(jsonl_path=str(path))
    with tr.span("http_request", route="/v1/chat") as outer:
        with tr.span("prefill", slot=2, prompt_tokens=40):
            pass
        try:
            with tr.span("decode", slot=2):
                raise ValueError("boom")
        except ValueError:
            pass
        outer.set(tokens=7)
    with tr.span("warmup"):
        pass
    tr.close()
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    # Span ids come from a process-wide counter: compare the nesting by
    # each id's order of first appearance.
    order = {}
    for r in recs:
        assert r.pop("ts") > 0 and r.pop("duration_s") >= 0
        for key in ("span", "parent"):
            if r[key] is not None:
                r[key] = order.setdefault(r[key], len(order))
    return recs, [s.name for s in tr.recent()], tr.spans_recorded


def test_span_tracer_records_match_jax(tmp_path):
    assert (_spans(ttr, tmp_path / "t.jsonl")
            == _spans(jtr, tmp_path / "j.jsonl"))
    assert ttr.NULL_TRACER.span("x").set(a=1) is ttr.NULL_TRACER.span("y")


def test_top_renders_the_same_frame():
    side = _drive("torch", 0)
    hist = dict(side["snapshot"], ts=1600.0, created_ts=990.0)
    slo = dict(side["verdicts"][-1], ts=1600.0)
    for window in (None, 30.0):
        assert (ttop.render_top(hist, slo, source="s", window_s=window)
                == jtop.render_top(hist, slo, source="s", window_s=window))
        # "fleet" (a router's table) is None for a replica on both sides.
        jpay = jtop.top_payload(hist, slo, window_s=window, top_k=2)
        assert jpay["fleet"] is None
        assert ttop.top_payload(hist, slo, window_s=window, top_k=2) == jpay
    assert ttop.sparkline([1, 5, 2, 8]) == jtop.sparkline([1, 5, 2, 8])


def test_top_cli_against_a_live_server(capsys):
    """`top --url` fetches /metrics/history and /slo from a port server and
    renders what top.render_top renders from the same payloads."""
    from luminaai_tpu_torch import cli

    class Tok:
        class backend:
            @staticmethod
            def encode(text):
                return [ord(c) % 250 for c in text]

        def decode(self, tokens):
            return ",".join(str(t) for t in tokens)

    class Engine:
        config = TConfig(vocab_size=256, hidden_size=64, num_layers=2,
                         num_heads=4, num_kv_heads=2, seq_length=64)
        tokenizer = Tok()

        def generate_batch(self, prompts, **kw):
            return [(list(p)[:3], {"tokens_generated": 3, "stopped": "eos"})
                    for p in prompts]

    from luminaai_tpu_torch.serving.server import ChatServer

    srv = ChatServer(Engine(), registry=ttel.MetricsRegistry())
    httpd = srv.make_httpd("127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        assert srv.handle("POST", "/v1/generate", {"prompt": "abc"},
                          None)[0] == 200
        srv.history.sample_once()
        srv.slo.evaluate()
        assert cli.main(["top", "--url", url, "--once"]) == 0
        frame = capsys.readouterr().out
        assert cli.main(["top", "--url", url, "--json"]) == 0
        payload = json.loads(capsys.readouterr().out)
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
    assert frame.startswith(f"lumina top — {url} — samples=")
    assert "serve tok/s" in frame and "slo (serve;" in frame
    assert payload["slo"]["program"] == "serve"
    assert cli.main(["top", "--url", url, "--once"]) == 2  # server gone
