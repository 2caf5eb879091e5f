"""`python -m luminaai_tpu_torch serve` against the JAX CLI's `serve`.

- The flag set is the JAX parser's (--trace-jax included: the port's
  tracer mirrors spans as torch.profiler ranges), plus the port's own
  model flags; `route` and `top` take the JAX CLI's flags exactly (host
  code: no --device); every shared flag has the JAX default.
- The exit-2 checks exit 2 before any model load, where the JAX cmd_serve
  does: bad --latency-buckets, --healthz-stale-after <= 0, --secure with
  neither --user/--password nor a users.json (and --adapter without
  --checkpoint, which the port adds).
- Every flag reaches the server: a `serve` run on the CPU with
  serve_forever stubbed builds a ChatServer whose settings are the flags'.
- The page-share flags reach the server's PageShareClient.
"""

import argparse

import pytest

from luminaai_tpu import cli as jcli
from luminaai_tpu_torch import cli as tcli

LEFT_OUT = set()
PORT_ONLY = {"--preset", "--dense", "--moe-dispatch", "--weights", "--seed",
             "--device"}


def _sub(parser, name):
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            return action.choices[name]
    raise KeyError(name)


def _flags(sub):
    return {opt: a for a in sub._actions for opt in a.option_strings
            if opt.startswith("--") and opt != "--help"}


@pytest.mark.parametrize("name", ["serve", "top", "route"])
def test_flag_set_matches_jax(name):
    jsub = _sub(jcli.build_parser(), name)
    tsub = _sub(tcli._parser(), name)
    jf, tf = _flags(jsub), _flags(tsub)
    left_out = LEFT_OUT if name == "serve" else set()
    port_only = PORT_ONLY if name == "serve" else set()
    assert set(tf) == (set(jf) - left_out) | port_only
    for opt in set(jf) & set(tf):
        ja, ta = jf[opt], tf[opt]
        assert ta.dest == ja.dest, opt
        assert ta.default == ja.default, opt
        assert ta.choices == ja.choices, opt
        assert type(ta) is type(ja), opt
    jpos = [a.dest for a in jsub._actions if not a.option_strings]
    tpos = [a.dest for a in tsub._actions if not a.option_strings]
    assert tpos == jpos


@pytest.mark.parametrize("argv,msg", [
    (["--latency-buckets", "0.1,x"], "--latency-buckets"),
    (["--latency-buckets", "0.1,0.1"], "--latency-buckets"),
    (["--latency-buckets", "-1"], "--latency-buckets"),
    (["--healthz-stale-after", "0"], "--healthz-stale-after"),
    (["--healthz-stale-after", "-5"], "--healthz-stale-after"),
    (["--secure"], "nobody could authenticate"),
    (["--secure", "--user", "u"], "BOTH --user and --password"),
    (["--adapter", "a.npz"], "--adapter needs --checkpoint"),
])
def test_exit_2_checks_before_any_model_load(argv, msg, capsys, tmp_path,
                                             monkeypatch):
    monkeypatch.chdir(tmp_path)  # no users.json here
    assert tcli.main(["serve", *argv]) == 2  # no --device: no model built
    assert msg in capsys.readouterr().err
    # The JAX CLI refuses the same flags with exit 2 (all but --adapter,
    # which it loads without a checkpoint check).
    if "--adapter" not in argv:
        args = jcli.build_parser().parse_args(["serve", *argv])
        assert jcli.cmd_serve(args) == 2


@pytest.fixture
def fresh_registry():
    """serve() builds on the process registry; --latency-buckets fixes its
    histograms' buckets, so each run here gets a registry of its own."""
    from luminaai_tpu_torch.monitoring import telemetry

    prev = telemetry.set_registry(telemetry.MetricsRegistry())
    yield telemetry
    telemetry.set_registry(prev)


def test_every_flag_reaches_the_server(monkeypatch, tmp_path, fresh_registry):
    from luminaai_tpu_torch.serving import server

    built, kwargs = [], []
    monkeypatch.setattr(server.ChatServer, "serve_forever",
                        lambda self, host, port: built.append(
                            (self, host, port)))
    init = server.ChatServer.__init__

    def record(self, engine, **kw):
        kwargs.append(kw)
        init(self, engine, **kw)

    monkeypatch.setattr(server.ChatServer, "__init__", record)
    slo_cfg = tmp_path / "slo.json"
    slo_cfg.write_text('{"objectives": [{"name": "x", "series": '
                       '"serve_ttft_seconds:p95", "op": "<=", '
                       '"target": 1.0, "budget": 0.1}]}')
    argv = [
        "serve", "--preset", "debug", "--dense", "--seed", "0",
        "--device", "cpu", "--host", "127.0.0.2", "--port", "0",
        "--num-slots", "3", "--page-size", "16", "--prefill-chunk", "32",
        "--prefix-cache-pages", "8", "--prefix-cache-tenant-quota", "4",
        "--tenant-rate", "2.5", "--tenant-burst", "7",
        "--request-timeout", "9", "--max-queue-depth", "5",
        "--drain-grace", "3", "--flight-dir", str(tmp_path / "fl"),
        "--latency-buckets", "0.5,0.01,2", "--healthz-stale-after", "11",
        "--no-watchdog", "--slo-config", str(slo_cfg),
        "--secure", "--user", "ops", "--password", "Corr3ct-Horse-Battery",
        "--admission-window-ms", "4",
        "--trace-jsonl", str(tmp_path / "spans.jsonl"),
        "--page-share", "http://127.0.0.9:8000",
        "--page-pull-timeout", "0.7", "--page-share-max-inflight", "3",
    ]
    monkeypatch.chdir(tmp_path)
    assert tcli.main(argv) == 0
    srv, host, port = built[-1]
    dec = srv.batcher.decoder
    assert (host, port) == ("127.0.0.2", 0)
    assert srv.continuous and srv.secure and srv.watchdog is None
    assert dec.num_slots == 3 and dec.pool.page_size == 16
    assert dec.prefill_chunk == 32
    assert dec.prefix_cache.capacity == 8
    assert dec.prefix_cache.tenant_quota == 4
    assert srv.tenant_bucket.rate == 2.5 and srv.tenant_bucket.burst == 7
    assert srv.request_timeout_s == 9.0 and srv.max_queue_depth == 5
    assert srv.drain_grace_s == 3.0 and srv.flight_dir == str(tmp_path / "fl")
    assert srv.healthz_stale_after_s == 11.0
    assert srv.batcher.window == 0.004
    assert [o.name for o in srv.slo.objectives] == ["x"]
    assert kwargs[-1]["latency_buckets"] == (0.01, 0.5, 2.0)
    assert kwargs[-1]["warmup"] is True
    assert srv.tracer.jsonl_path == str(tmp_path / "spans.jsonl")
    share = srv.page_share
    assert dec.page_share is share
    assert share.router_url == "http://127.0.0.9:8000"
    assert share.self_url == "http://127.0.0.2:0"  # serve's own address
    assert share.timeout_s == 0.7
    assert kwargs[-1]["page_share_max_inflight"] == 3
    srv.close()
    fresh_registry.set_registry(fresh_registry.MetricsRegistry())
    # --no-continuous, --no-telemetry and --no-slo.
    assert tcli.main(["serve", "--preset", "debug", "--dense", "--seed",
                      "0", "--device", "cpu", "--port", "0",
                      "--no-continuous", "--no-telemetry", "--no-slo"]) == 0
    srv = built[-1][0]
    assert not srv.continuous and not srv.telemetry and srv.slo is None
    assert srv.max_queue_depth == 128  # the JAX flag's default
    srv.close()


def test_sigterm_drains_in_flight_requests(tmp_path):
    """`serve` in a child process: /healthz 200 once warm; SIGTERM with
    requests in flight lets them finish (200, full budgets), the process
    exits 0, and the drain dumps the flight record into --flight-dir."""
    import json
    import os
    import signal
    import socket
    import subprocess
    import sys
    import threading
    import time
    import urllib.request
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(root)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "luminaai_tpu_torch", "serve", "--preset",
         "debug", "--dense", "--seed", "0", "--device", "cpu", "--port",
         str(port), "--num-slots", "4", "--page-size", "16",
         "--flight-dir", str(tmp_path / "flight")],
        cwd=str(tmp_path), env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 60
        while True:
            try:
                with urllib.request.urlopen(url + "/healthz", timeout=5) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            assert time.time() < deadline and proc.poll() is None
            time.sleep(0.05)
        replies = {}

        def post(i):
            req = urllib.request.Request(
                url + "/v1/generate", data=json.dumps({
                    "prompt": f"drain {i}", "max_new_tokens": 150,
                    "temperature": 0}).encode())
            with urllib.request.urlopen(req, timeout=60) as r:
                replies[i] = (r.status, json.loads(r.read()))

        threads = [threading.Thread(target=post, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        while True:
            with urllib.request.urlopen(url + "/stats", timeout=5) as r:
                if json.loads(r.read())["active_lanes"]:
                    break
            time.sleep(0.01)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        for t in threads:
            t.join(10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert sorted(replies) == [0, 1, 2]
    for code, body in replies.values():
        assert code == 200
        assert body["tokens"] == 150 or body["stopped"] == "eos"
    assert list((tmp_path / "flight").glob("flightrec-*-drain.jsonl"))


def test_attention_backend_is_ragged_only():
    """The Config's attention_backend takes 'ragged' only: the plain
    version is a per-call argument of the oracle, never a setting that
    would keep a card's decode off B5. The JAX package's XLA backends
    load as 'ragged'."""
    from luminaai_tpu_torch.config import Config

    with pytest.raises(ValueError, match="attention_backend"):
        Config(attention_backend="plain")
    for name in ("ragged", "ragged_xla", "dense"):
        cfg = Config.from_dict({"attention_backend": name})
        assert cfg.attention_backend == "ragged"
