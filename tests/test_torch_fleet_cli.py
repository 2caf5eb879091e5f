"""The fleet's commands in the port's CLI: `serve --replicas`, `route`, and
`top` over a router.

- `serve --replicas N` and `route` parse as the JAX CLI's do;
  `_fleet_child_argv` strips the flags the JAX one strips.
- `serve --replicas N` spawns N `python -m luminaai_tpu_torch serve`
  children (never the JAX package) on port+1..port+N, each wired to share
  pages through the parent's router, fronts them with the Router built
  from the Config's router knobs, and sends the children SIGTERM when the
  router stops; a child that dies before it is ready fails the command
  at once.
- `route` rejects duplicate replicas (exit 2) and runs the router with
  the Config's knobs unless flags override them.
- Without a card `serve --replicas` and `route` raise before they start
  anything; `--device cpu` runs them.
- End to end on the CPU: `serve --replicas 2 --device cpu` as one
  command answers a request through its router, and on SIGTERM exits 0
  with both replicas gone.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest
import torch

from luminaai_tpu import cli as jcli
from luminaai_tpu_torch import cli
from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.serving import router as trouter

ROOT = Path(__file__).resolve().parent.parent


def test_route_and_serve_replicas_parse():
    p = cli._parser()
    args = p.parse_args([
        "route", "--replica", "http://a:1", "--replica", "http://b:2",
        "--breaker-failures", "4", "--hedge", "--port", "8123",
    ])
    assert args.replicas == ["http://a:1", "http://b:2"]
    assert args.breaker_failures == 4 and args.hedge and args.port == 8123
    assert p.parse_args(["serve", "--replicas", "3"]).replicas == 3
    args = p.parse_args(["serve", "--page-share", "http://r:1",
                         "--page-share-self", "http://me:2",
                         "--page-pull-timeout", "0.5",
                         "--page-share-max-inflight", "3"])
    assert (args.page_share, args.page_share_self, args.page_pull_timeout,
            args.page_share_max_inflight) == ("http://r:1", "http://me:2",
                                              0.5, 3)


@pytest.mark.parametrize("argv", [
    ["serve", "--replicas", "3", "--port", "8000", "--seed", "0"],
    ["serve", "--replicas=3", "--port=8000", "--page-share", "http://x:1",
     "--page-share-self=http://y:2", "--dense"],
    ["serve", "--preset", "b1", "--dense", "--replicas", "2",
     "--prefix-cache-pages", "64", "--device", "cpu"],
])
def test_fleet_child_argv_matches_jax(argv):
    child = cli._fleet_child_argv(argv, 8001)
    assert child == jcli._fleet_child_argv(argv, 8001)
    assert child[-2:] == ["--port", "8001"]
    assert not any(a.startswith(("--replicas", "--page-share"))
                   for a in child)
    assert child.count("--port") == 1


class _FakeProc:
    def __init__(self, argv, exit_code=None):
        self.argv = argv
        self.signals = []
        self.returncode = exit_code

    def poll(self):
        return self.returncode

    def send_signal(self, sig):
        self.signals.append(sig)
        self.returncode = 0

    def wait(self, timeout=None):
        return self.returncode

    def kill(self):
        self.returncode = -9


@pytest.fixture
def fake_fleet(monkeypatch):
    """Popen, the readiness wait and the router's listener stubbed: what
    serve --replicas spawns and builds, without processes or sockets."""
    seen = {"procs": [], "routers": []}

    def popen(argv, **kw):
        proc = _FakeProc(argv, exit_code=seen.get("child_exit"))
        seen["procs"].append(proc)
        return proc

    def serve_forever(self, host, port):
        seen["routers"].append((self, host, port))

    monkeypatch.setattr(subprocess, "Popen", popen)
    monkeypatch.setattr(trouter.Router, "serve_forever", serve_forever)
    monkeypatch.setattr(trouter.Router, "start_probing", lambda self: None)
    monkeypatch.setattr(trouter.Router, "probe_all", lambda self: None)
    monkeypatch.setattr(trouter, "wait_ready", lambda urls, timeout_s: None)
    return seen


def test_serve_replicas_spawns_port_children(fake_fleet):
    argv = ["serve", "--replicas", "2", "--preset", "b1", "--dense",
            "--seed", "0", "--prefix-cache-pages", "64", "--port", "7000",
            "--device", "cpu"]
    assert cli.main(argv) == 0
    procs = fake_fleet["procs"]
    assert len(procs) == 2
    for i, proc in enumerate(procs):
        port = 7001 + i
        assert proc.argv[:3] == [sys.executable, "-m", "luminaai_tpu_torch"]
        assert proc.argv[3:] == cli._fleet_child_argv(argv, port) + [
            "--page-share", "http://127.0.0.1:7000",
            "--page-share-self", f"http://127.0.0.1:{port}",
        ]
        assert proc.signals == [signal.SIGTERM]  # drained at exit
    (router, host, port), = fake_fleet["routers"]
    assert (host, port) == ("127.0.0.1", 7000)
    cfg = Config()
    assert [(r.name, r.url) for r in router.replicas] == [
        ("r0", "http://127.0.0.1:7001"), ("r1", "http://127.0.0.1:7002")]
    assert router.max_failovers == min(cfg.router_max_failovers, 1)
    assert router.probe_interval_s == cfg.router_probe_interval_s
    assert router.hedge_budget == cfg.router_hedge_budget
    assert router.replicas[0].breaker.cooldown_s == \
        cfg.router_breaker_cooldown_s


def test_serve_replicas_fails_fast_when_a_child_dies(fake_fleet, capsys):
    fake_fleet["child_exit"] = 1
    t0 = time.monotonic()
    assert cli.main(["serve", "--replicas", "2", "--device", "cpu",
                     "--port", "7100"]) == 1
    assert time.monotonic() - t0 < 10
    assert "exited" in capsys.readouterr().err
    assert not fake_fleet["routers"]


def test_route_rejects_duplicates_and_takes_config_knobs(monkeypatch,
                                                         capsys):
    assert cli.main(["route", "--replica", "http://a:1",
                     "--replica", "http://a:1/"]) == 2
    assert "duplicate" in capsys.readouterr().err
    runs = []
    monkeypatch.setattr(trouter, "run_router",
                        lambda urls, **kw: runs.append((urls, kw)))
    assert cli.main(["route", "--replica", "a:1", "--replica", "b:2",
                     "--hedge-budget", "0.3"]) == 0
    (urls, kw), = runs
    cfg = Config()
    assert urls == ["http://a:1", "http://b:2"]
    assert kw["hedge_budget"] == 0.3
    assert kw["probe_interval_s"] == cfg.router_probe_interval_s
    assert kw["breaker_failures"] == cfg.router_breaker_failures
    assert kw["max_failovers"] == min(cfg.router_max_failovers, 1)


def test_page_share_knobs_default_to_the_engines_config(monkeypatch):
    """`serve` passes --page-pull-timeout and --page-share-max-inflight
    through as given (None when absent); the ChatServer then takes the
    pull deadline and the pull slots from the engine's Config, and a flag
    overrides it. A Config outside their range is refused."""
    from luminaai_tpu_torch.inference.chat import build_engine
    from luminaai_tpu_torch.serving import server

    seen = []
    monkeypatch.setattr(server.ChatServer, "__init__",
                        lambda self, engine, **kw: seen.append(kw))
    monkeypatch.setattr(server.ChatServer, "serve_forever",
                        lambda self, host, port: None)
    monkeypatch.setattr(cli, "build_serve_engine", lambda args: None)
    assert cli.main(["serve", "--page-share", "http://r:1",
                     "--device", "cpu"]) == 0
    assert seen[-1]["page_pull_timeout_s"] is None
    assert seen[-1]["page_share_max_inflight"] is None
    monkeypatch.undo()

    def pull_slots(client):
        n = 0
        while client.try_begin_pull():
            n += 1
        for _ in range(n):
            client.end_pull()
        return n

    cfg = Config(vocab_size=384, hidden_size=64, num_layers=2, num_heads=2,
                 num_kv_heads=1, seq_length=128, intermediate_size=128,
                 precision="fp32", prefill_chunk_size=32,
                 page_pull_timeout_s=0.7, page_share_max_inflight=3)
    engine = build_engine(cfg, device="cpu", seed=0)
    for kw, want in (({}, (0.7, 3)),
                     ({"page_pull_timeout_s": 0.4,
                       "page_share_max_inflight": 1}, (0.4, 1))):
        srv = server.ChatServer(engine, num_slots=1, page_size=16,
                                prefix_cache_pages=4,
                                page_share="http://127.0.0.1:1", **kw)
        try:
            assert (srv.page_share.timeout_s,
                    pull_slots(srv.page_share)) == want
        finally:
            srv.close()
    for bad in ({"page_pull_timeout_s": 0.0},
                {"page_share_max_inflight": 0}):
        with pytest.raises(ValueError, match=next(iter(bad))):
            Config(**bad)


def test_fleet_entry_points_default_to_the_card(monkeypatch, fake_fleet):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve", "--replicas", "2", "--port", "7200"])
    assert not fake_fleet["procs"]  # nothing spawned
    # `route` is host code: it takes no device and runs without a card.
    runs = []
    monkeypatch.setattr(trouter, "run_router",
                        lambda urls, **k: runs.append(urls))
    assert cli.main(["route", "--replica", "a:1", "--replica", "b:2"]) == 0
    assert runs == [["http://a:1", "http://b:2"]]


def _free_base_port(n=3):
    """A port p with p..p+n-1 all free on loopback right now."""
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n > 65535:
            continue
        try:
            socks = []
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free port run")


def test_one_command_fleet_on_the_cpu(tmp_path):
    port = _free_base_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "luminaai_tpu_torch", "serve", "--replicas",
         "2", "--preset", "debug", "--dense", "--seed", "0", "--device",
         "cpu", "--port", str(port), "--num-slots", "2", "--page-size",
         "16", "--prefix-cache-pages", "8"],
        cwd=tmp_path, env=env, stdout=subprocess.DEVNULL,
        stderr=open(tmp_path / "fleet.log", "w"),
    )
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 60
        while True:
            assert proc.poll() is None, (tmp_path / "fleet.log").read_text()
            try:
                with urllib.request.urlopen(base + "/healthz",
                                            timeout=2) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            assert time.monotonic() < deadline, "fleet never ready"
            time.sleep(0.2)
        req = urllib.request.Request(
            base + "/v1/generate",
            data=json.dumps({"prompt": "hello", "max_new_tokens": 3}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200 and json.loads(r.read())["tokens"] >= 1
        with urllib.request.urlopen(base + "/fleet", timeout=10) as r:
            fleet = json.loads(r.read())
        assert [x["replica"] for x in fleet["replicas"]] == ["r0", "r1"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        for p in (port + 1, port + 2):  # both replicas are gone
            with pytest.raises(OSError):
                urllib.request.urlopen(f"http://127.0.0.1:{p}/healthz",
                                       timeout=2)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
