"""The port's replica router (serving/router.py) against the JAX router's
contracts, and the fleet over real HTTP on the CPU.

- The contracts of the JAX package's router tests, run on the port's
  Router with the same SimReplica, FakeTransport and FakeClock (an
  injected clock and in-memory transport, no wall-clock sleeps): the
  breaker FSM, prefix affinity, failover, shed as a routing signal, the
  all-shedding 503, stream failover before the first token and the error
  frame after it, hedging and its budget, /healthz, the fleet payload and
  its top table, page report and lookup.
- Parity: JAX's Router and the port's are driven through one scripted
  sequence (the same clock moves, the same seeded rng): the dispatch
  results, backoff sleeps, breaker transitions, flight events, health
  and fleet payloads and the Prometheus text are equal.
- HTTP: two tiny port ChatServers (device="cpu", prefix cache on, page
  sharing pointed at the router) behind the port's Router on loopback.
  A chat with a shared system prompt prefills on its affine replica A,
  whose flush reports its page keys; the same request sent to B pulls
  A's pages, decodes A's tokens, and B's /pages/<key> bytes equal A's; a
  repeat on B is a local hit. Killing A opens its breaker in one probe
  round; every later request through the router answers 200, /healthz
  reads degraded and no lookup names A.
"""

import json
import random
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from types import SimpleNamespace

import pytest

from luminaai_tpu.serving.router import Router as JRouter
from luminaai_tpu.monitoring.events import FlightRecorder as JRecorder
from luminaai_tpu.monitoring.telemetry import MetricsRegistry as JRegistry
from luminaai_tpu_torch.testing.faults import kill_replica, replica_5xx_burst
from tests.test_router import FakeClock, FakeTransport, SimReplica
from tests.test_serving import _get, _post, _post_sse
from luminaai_tpu_torch import cli
from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.inference.chat import build_engine
from luminaai_tpu_torch.monitoring.events import FlightRecorder, filter_events
from luminaai_tpu_torch.monitoring.telemetry import MetricsRegistry
from luminaai_tpu_torch.monitoring.top import render_top
from luminaai_tpu_torch.serving.router import CircuitBreaker, Router
from luminaai_tpu_torch.serving.server import REQUEST_ID_RX, ChatServer


def make_router(n=2, router_cls=Router, recorder_cls=FlightRecorder,
                registry_cls=MetricsRegistry, **kw):
    sims = [SimReplica(f"r{i}") for i in range(n)]
    transport = FakeTransport(sims)
    clock = FakeClock()
    sleeps = []
    recorder = recorder_cls(capacity=512)
    kw.setdefault("breaker_failures", 3)
    kw.setdefault("breaker_cooldown_s", 5.0)
    kw.setdefault("max_failovers", n - 1)
    router = router_cls(
        transport.endpoints(), transport=transport,
        registry=registry_cls(), recorder=recorder,
        clock=clock, sleep=sleeps.append, **kw,
    )
    return SimpleNamespace(router=router, sims=sims, clock=clock,
                           sleeps=sleeps, recorder=recorder)


def metric_line(registry, prefix):
    for line in registry.render_prometheus().splitlines():
        if line.startswith(prefix):
            return float(line.rsplit(" ", 1)[1])
    return None


def _affine(router, name, path="/v1/generate", stream=False, stem="p"):
    """A prompt whose affine head is replica `name`."""
    for i in range(64):
        body = {"prompt": f"{stem}{i}"}
        if stream:
            body["stream"] = True
        if router._ordered(router._affinity_key(path, body))[0].name == name:
            return f"{stem}{i}"
    raise AssertionError(f"no prompt lands on {name}")


# -- circuit breaker FSM ----------------------------------------------------

def test_breaker_consecutive_failures_open_halfopen_close():
    clock = FakeClock()
    seen = []
    b = CircuitBreaker("r0", failures=3, cooldown_s=5.0, clock=clock,
                       on_transition=lambda bk, o, n, r: seen.append((o, n)))
    for _ in range(2):
        b.record_failure()
    assert b.state == "closed" and b.allow()
    b.record_failure()
    assert b.state == "open" and not b.allow()
    clock.advance(4.9)
    assert not b.allow()
    clock.advance(0.2)
    assert b.allow() and b.state == "half_open"
    assert not b.allow()  # the one probe slot is taken
    b.record_success()
    assert b.state == "closed" and b.allow()
    assert seen == [("closed", "open"), ("open", "half_open"),
                    ("half_open", "closed")]


def test_breaker_halfopen_failure_reopens_and_probe_rearms():
    clock = FakeClock()
    b = CircuitBreaker("r0", failures=1, cooldown_s=5.0, clock=clock)
    b.record_failure()
    clock.advance(5.1)
    assert b.allow() and b.state == "half_open"
    b.record_failure()
    assert b.state == "open" and not b.allow()
    clock.advance(5.1)
    assert b.allow() and b.state == "half_open"
    clock.advance(5.1)
    assert b.allow()  # a probe lost without a verdict re-arms


def test_breaker_error_rate_and_trip():
    b = CircuitBreaker("r0", failures=5, error_rate=0.5, min_requests=8,
                       clock=FakeClock())
    for _ in range(4):
        b.record_success()
        b.record_failure()
    assert b.state == "open"
    b = CircuitBreaker("r1", failures=3, clock=FakeClock())
    b.trip("probe failed: ConnectionRefusedError")
    assert b.state == "open" and not b.allow()


# -- dispatch: affinity, failover, shed -------------------------------------

def test_affinity_stable_per_prompt_and_spreads():
    env = make_router(n=3)
    key = env.router._affinity_key("/v1/generate", {"prompt": "shared sys"})
    assert len({env.router._ordered(key)[0].name for _ in range(10)}) == 1
    spread = {
        env.router._ordered(env.router._affinity_key(
            "/v1/generate", {"prompt": f"p{i}"}))[0].name
        for i in range(24)
    }
    assert len(spread) > 1


def test_failover_on_dead_replica_is_invisible_to_client():
    env = make_router(n=2)
    env.sims[0].alive = False
    for i in range(6):
        status, payload = env.router.dispatch(
            "/v1/generate", {"prompt": f"p{i}"})
        assert status == 200 and payload["text"] == "ok:r1"
    failovers = env.recorder.snapshot(type="router_failover")
    assert failovers and all(
        e["to_replica"] == "r1" and e["kind"] == "request"
        for e in failovers)
    assert env.sleeps and all(s >= 0 for s in env.sleeps)


def test_shed_is_a_routing_signal_not_a_client_error():
    env = make_router(n=2)
    env.sims[0].shed_next = 1
    env.sims[0].retry_after = 7
    prompt = _affine(env.router, "r0")
    status, payload = env.router.dispatch("/v1/generate", {"prompt": prompt})
    assert status == 200 and payload["text"] == "ok:r1"
    assert metric_line(env.router.registry,
                       'router_sheds_total{replica="r0"}') == 1
    posts = env.sims[0].posts
    status, _ = env.router.dispatch("/v1/generate", {"prompt": prompt})
    assert status == 200 and env.sims[0].posts == posts
    assert env.router.replicas[0].breaker.state == "closed"
    env.clock.advance(7.1)
    status, payload = env.router.dispatch("/v1/generate", {"prompt": prompt})
    assert status == 200 and payload["text"] == "ok:r0"


def test_all_shedding_returns_503_with_max_retry_after():
    env = make_router(n=2)
    env.sims[0].shed_next, env.sims[0].retry_after = 1, 7
    env.sims[1].shed_next, env.sims[1].retry_after = 1, 3
    status, payload = env.router.dispatch("/v1/generate", {"prompt": "x"})
    assert status == 503 and payload["retry_after"] == 7
    assert payload["request_id"]
    assert env.recorder.snapshot(type="router_shed_all")
    assert metric_line(env.router.registry,
                       "router_shed_returned_total") == 1


def test_5xx_burst_opens_breaker_then_failover_serves():
    env = make_router(n=2)
    env.sims[0].fail_next = 10
    prompt = _affine(env.router, "r0")
    for _ in range(5):
        assert env.router.dispatch(
            "/v1/generate", {"prompt": prompt})[0] == 200
    assert env.router.replicas[0].breaker.state == "open"
    assert env.recorder.snapshot(type="breaker_open")
    posts = env.sims[0].posts
    env.router.dispatch("/v1/generate", {"prompt": prompt})
    assert env.sims[0].posts == posts


def test_kill_one_of_two_replicas_zero_client_5xx():
    """Two replicas, one dies mid-load: the survivor's in-flight stream
    drains, one probe round opens the dead breaker, every later request
    answers 200, and the returning replica walks half-open -> closed."""
    env = make_router(n=2, breaker_cooldown_s=5.0)
    router, clock = env.router, env.clock
    router.probe_all()
    for i in range(8):
        assert router.dispatch("/v1/generate", {"prompt": f"w{i}"})[0] == 200
    survivor = _affine(router, "r1", "/v1/chat", stream=True, stem="s")
    err, frames = router.open_stream(
        "/v1/chat", {"prompt": survivor, "stream": True})
    assert err is None
    it = iter(frames)
    assert json.loads(next(it))["replica"] == "r1"
    env.sims[0].alive = False
    rest = [json.loads(f) for f in it]
    assert rest[-1]["done"] is True
    router.probe_all()
    assert router.replicas[0].breaker.state == "open"
    assert router.replicas[0].status == "down"
    assert metric_line(router.registry,
                       'router_breaker_state{replica="r0"}') == 2
    for i in range(10):
        clock.advance(0.3)
        status, payload = router.dispatch(
            "/v1/generate", {"prompt": f"post-kill {i}"})
        assert status == 200 and payload["text"] == "ok:r1"
    err, frames = router.open_stream(
        "/v1/generate", {"prompt": "post-kill stream", "stream": True})
    assert err is None and json.loads(list(frames)[-1])["done"] is True
    env.sims[0].alive = True
    clock.advance(5.1)
    router.probe_all()
    assert router.replicas[0].breaker.state == "closed"
    types = [e["type"] for e in env.recorder.snapshot()
             if e["type"].startswith("breaker_")]
    assert types[-2:] == ["breaker_half_open", "breaker_close"]


# -- streams ----------------------------------------------------------------

def test_stream_pre_first_token_fails_over_transparently():
    env = make_router(n=2)
    env.sims[0].stream_die_after = 0
    prompt = _affine(env.router, "r0", stream=True)
    err, frames = env.router.open_stream(
        "/v1/generate", {"prompt": prompt, "stream": True})
    assert err is None
    out = [json.loads(f) for f in frames]
    assert out[-1]["done"] is True
    assert all(f.get("replica") == "r1" for f in out)
    assert env.recorder.snapshot(type="router_failover")[-1]["kind"] == \
        "stream"


def test_stream_mid_generation_surfaces_error_frame_with_request_id():
    env = make_router(n=2)
    env.sims[0].stream_die_after = 2
    prompt = _affine(env.router, "r0", stream=True)
    rid = "req-mid-stream-1"
    err, frames = env.router.open_stream(
        "/v1/generate", {"prompt": prompt, "stream": True},
        headers={"X-Request-Id": rid})
    assert err is None
    out = [json.loads(f) for f in frames]
    assert [f.get("token") for f in out[:2]] == [0, 1]
    assert out[-1]["error"] and out[-1]["request_id"] == rid
    assert metric_line(env.router.registry,
                       "router_stream_errors_total") == 1
    assert env.recorder.snapshot(
        type="router_stream_error")[-1]["request_id"] == rid


def test_stream_all_shedding_returns_503():
    env = make_router(n=2)
    env.sims[0].shed_next = env.sims[1].shed_next = 1
    err, frames = env.router.open_stream(
        "/v1/generate", {"prompt": "x", "stream": True})
    assert frames is None
    status, payload = err
    assert status == 503 and payload["retry_after"] >= 1


# -- hedging ----------------------------------------------------------------

class BlockingTransport(FakeTransport):
    """r0 blocks POSTs until released: the hedge must win."""

    def __init__(self, sims, slow_name):
        super().__init__(sims)
        self.slow_name = slow_name
        self.release = threading.Event()

    def request(self, base_url, method, path, body=None, headers=None,
                timeout_s=None, cancel=None):
        sim = self.by_url[base_url]
        if method == "POST" and sim.name == self.slow_name:
            self.release.wait(timeout=5.0)
        return sim.request(method, path, body, headers)


def test_hedged_dispatch_second_replica_wins():
    sims = [SimReplica("r0"), SimReplica("r1")]
    transport = BlockingTransport(sims, slow_name="r0")
    recorder = FlightRecorder(capacity=128)
    router = Router(
        transport.endpoints(), transport=transport,
        registry=MetricsRegistry(), recorder=recorder,
        sleep=lambda dt: None, hedge=True, hedge_delay_s=0.005,
        hedge_budget=1.0,
    )
    prompt = _affine(router, "r0")
    try:
        status, payload = router.dispatch(
            "/v1/generate", {"prompt": prompt, "max_new_tokens": 8})
        assert status == 200 and payload["text"] == "ok:r1"
    finally:
        transport.release.set()
    assert metric_line(router.registry, "router_hedges_total") == 1
    assert metric_line(router.registry, "router_hedge_wins_total") == 1
    ev = recorder.snapshot(type="router_hedge")[-1]
    assert ev["primary"] == "r0" and ev["hedge"] == "r1"


def test_hedge_budget_and_eligibility_bounds():
    env = make_router(n=2, hedge=True, hedge_budget=0.1,
                      hedge_max_tokens=32)
    r = env.router
    assert not r._hedge_eligible({"stream": True})
    assert not r._hedge_eligible({"max_new_tokens": 64})
    assert not r._hedge_eligible({"max_new_tokens": 8})
    with r._stats_lock:
        r._nonstream_total = 9
    assert r._hedge_eligible({"max_new_tokens": 8})
    with r._stats_lock:
        r._hedges_fired, r._nonstream_total = 1, 15
    assert not r._hedge_eligible({"max_new_tokens": 8})
    with r._stats_lock:
        r._nonstream_total = 40
    assert r._hedge_eligible({"max_new_tokens": 8})
    r.replicas[1].breaker.trip("dead")
    order = r._ordered("k")
    assert r._hedge_partner(order, order[0]) is None


# -- fleet / health surfaces ------------------------------------------------

def test_healthz_aggregate_degraded_and_down():
    env = make_router(n=2)
    env.router.probe_all()
    code, payload = env.router.health_payload()
    assert (code, payload["status"]) == (200, "ok")
    env.sims[0].alive = False
    env.router.probe_all()
    code, payload = env.router.health_payload()
    assert (code, payload["status"]) == (200, "degraded")
    assert payload["available"] == 1 and payload["breakers_open"] == 1
    env.sims[1].alive = False
    env.router.probe_all()
    assert env.router.health_payload()[0] == 503


def test_fleet_payload_and_top_render():
    env = make_router(n=2)
    env.router.probe_all()
    env.router.dispatch("/v1/generate", {"prompt": "x"})
    env.sims[1].alive = False
    env.router.probe_all()
    fleet = env.router.fleet_payload()
    assert fleet["status"] == "degraded"
    by_name = {r["replica"]: r for r in fleet["replicas"]}
    assert by_name["r1"]["breaker"] == "open"
    assert by_name["r1"]["status"] == "down"
    assert by_name["r0"]["breaker"] == "closed"
    frame = render_top({"series": {}}, source="router", fleet=fleet)
    assert "fleet — degraded (1/2 available" in frame
    assert "! r1" in frame.replace("!  r1", "! r1")
    assert "(no series" not in frame


# -- fleet page index ---------------------------------------------------------

def test_page_report_registered_replicas_only_then_fifo_cap():
    env = make_router(n=2, page_index_capacity=3)
    r = env.router
    assert r.handle_page_report(
        {"replica": "http://evil/x", "keys": ["k1"]}) == \
        {"indexed": 0, "known": False}
    assert r.handle_page_lookup({"keys": ["k1"]})["owner"] is None
    assert r.handle_page_report(
        {"replica": "http://sim/r0", "keys": ["k1", "k2"]}) == \
        {"indexed": 2, "known": True}
    r.handle_page_report({"replica": "http://sim/r1", "keys": ["k2"]})
    assert r.handle_page_lookup({"keys": ["k2"]})["owner"] == "http://sim/r1"
    r.handle_page_report({"replica": "http://sim/r0", "keys": ["k3", "k4"]})
    assert r.handle_page_lookup({"keys": ["k1"]})["owner"] is None
    assert r.handle_page_lookup({"keys": ["k4"]})["owner"] == "http://sim/r0"
    assert metric_line(r.registry, "router_page_index_keys") == 3
    assert metric_line(r.registry, "router_page_reports_total") == 5


def test_page_lookup_contiguous_prefix_have_offset_and_health():
    env = make_router(n=2)
    r = env.router
    r.handle_page_report({"replica": "http://sim/r0", "keys": ["a", "b", "c"]})
    res = r.handle_page_lookup(
        {"keys": ["a", "b", "zz"], "exclude": "http://sim/r1"})
    assert res == {"owner": "http://sim/r0", "keys": ["a", "b"]}
    res = r.handle_page_lookup({"keys": ["a", "b", "c"], "have": 1})
    assert res == {"owner": "http://sim/r0", "keys": ["a", "b", "c"]}
    assert r.handle_page_lookup({"keys": ["a"], "have": 5})["owner"] is None
    assert r.handle_page_lookup(
        {"keys": ["a"], "exclude": "http://sim/r0"})["owner"] is None
    r0 = r.replicas[0]
    r0.status = "down"
    assert r.handle_page_lookup({"keys": ["a"]})["owner"] is None
    r0.status = "ok"
    r0.breaker.trip("probe failed")
    assert r.handle_page_lookup({"keys": ["a"]})["owner"] is None
    env.clock.advance(6.0)
    assert r.handle_page_lookup({"keys": ["a"]})["owner"] is None
    assert r0.breaker.state == "open" and r0.breaker.allow()


def test_fleet_payload_shared_index_columns():
    env = make_router(n=2)
    env.router.handle_page_report(
        {"replica": "http://sim/r0", "keys": ["a", "b"]})
    by = {r["replica"]: r for r in env.router.fleet_payload()["replicas"]}
    assert by["r0"]["shared_pages"] == 2 and by["r0"]["page_reports"] == 2
    assert by["r1"]["shared_pages"] == 0 and by["r1"]["page_reports"] == 0


# -- parity with the JAX router ---------------------------------------------

def _script(env):
    """One scripted run; returns what a client and an operator observe."""
    r, sims, clock = env.router, env.sims, env.clock
    out = []

    def dispatch(tag, n, **body):
        for i in range(n):
            status, payload = r.dispatch(
                "/v1/generate", {"prompt": f"{tag}{i}", **body},
                headers={"X-Request-Id": f"rid-{tag}{i}"})
            out.append((status, payload.get("text"),
                        payload.get("retry_after")))

    def stream(tag, die_after=None):
        for s in sims:
            s.stream_die_after = die_after
        err, frames = r.open_stream(
            "/v1/generate", {"prompt": tag, "stream": True},
            headers={"X-Request-Id": f"rid-{tag}"})
        out.append(("stream", err, None if frames is None
                    else [json.loads(f) for f in frames]))

    r.probe_all()
    dispatch("warm", 12)
    sims[0].fail_next = 5
    dispatch("burst", 8)
    sims[1].shed_next, sims[1].retry_after = 2, 4
    dispatch("shed", 6)
    stream("s-pre", die_after=0)
    stream("s-mid", die_after=1)
    sims[2].alive = False
    clock.advance(0.5)
    r.probe_all()
    out.append(("health", r.health_payload()))
    dispatch("dead", 6)
    sims[0].shed_next = sims[1].shed_next = 3
    dispatch("all-shed", 2)
    clock.advance(6.0)
    sims[2].alive = True
    r.probe_all()
    dispatch("back", 6)
    out.append(("report", r.handle_page_report(
        {"replica": "http://sim/r1", "keys": ["a", "b", "c"]})))
    out.append(("lookup", r.handle_page_lookup(
        {"keys": ["a", "b", "x"], "exclude": "http://sim/r0"})))
    out.append(("health", r.health_payload()))
    out.append(("fleet", r.fleet_payload()))
    events = [{k: v for k, v in e.items() if k not in ("ts", "v")}
              for e in env.recorder.snapshot()]
    return out, env.sleeps, events, r.registry.render_prometheus()


def test_router_parity_with_jax():
    envs = [
        make_router(n=3, router_cls=cls, recorder_cls=rec, registry_cls=reg,
                    rng=random.Random(7), breaker_failures=2)
        for cls, rec, reg in ((JRouter, JRecorder, JRegistry),
                              (Router, FlightRecorder, MetricsRegistry))
    ]
    want, got = (_script(env) for env in envs)
    for part, w, g in zip(("results", "sleeps", "events", "metrics"),
                          want, got):
        assert g == w, part
    results, _, events, _ = got
    assert any(e["type"] == "breaker_open" for e in events)
    assert any(e["type"] == "breaker_close" for e in events)
    assert any(e["type"] == "router_failover" for e in events)


# -- real HTTP: tiny port replicas sharing pages behind the router ----------

ARCH = dict(vocab_size=384, hidden_size=64, num_layers=2, num_heads=2,
            num_kv_heads=1, seq_length=256, intermediate_size=128,
            precision="fp32", prefill_chunk_size=32)
PAGE = 16
SYSTEM = "You are a careful assistant. Answer briefly and cite rules. " * 2


@pytest.fixture()
def fleet(tmp_path):
    servers, httpds, urls = [], [], []
    for _ in range(2):
        engine = build_engine(Config(**ARCH), device="cpu", seed=0)
        srv = ChatServer(
            engine, num_slots=2, page_size=PAGE, prefix_cache_pages=16,
            registry=MetricsRegistry(), recorder=FlightRecorder(capacity=512),
            page_share="http://127.0.0.1:1",  # re-pointed below
        )
        httpd = srv.make_httpd("127.0.0.1", 0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        srv.page_share.self_url = url
        servers.append(srv)
        httpds.append(httpd)
        urls.append(url)
    recorder = FlightRecorder(capacity=512)
    router = Router([("r0", urls[0]), ("r1", urls[1])],
                    registry=MetricsRegistry(), recorder=recorder,
                    sleep=lambda dt: None, max_failovers=1,
                    breaker_cooldown_s=5.0)
    rhttpd = ThreadingHTTPServer(("127.0.0.1", 0), router.make_handler())
    threading.Thread(target=rhttpd.serve_forever, daemon=True).start()
    rurl = f"http://127.0.0.1:{rhttpd.server_address[1]}"
    for srv in servers:
        srv.page_share.router_url = rurl
    router.probe_all()
    yield SimpleNamespace(url=rurl, router=router, servers=servers,
                          httpds=httpds, urls=urls, recorder=recorder)
    for h in [rhttpd] + httpds:
        h.shutdown()
        h.server_close()
    for srv in servers:
        srv.close()


def _chat(user):
    return {"messages": [{"role": "system", "content": SYSTEM},
                         {"role": "user", "content": user}],
            "max_new_tokens": 6, "temperature": 0.0}


def _page_bytes(url, key):
    with urllib.request.urlopen(f"{url}/pages/{key}", timeout=10) as r:
        assert r.headers.get("Content-Type") == "application/octet-stream"
        return r.read()


def _wait(pred, timeout=10.0):
    end = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < end, "timed out"
        time.sleep(0.02)


def test_pages_pulled_over_http_then_failover(fleet):
    f = fleet
    body = _chat("hello")
    head = f.router._ordered(f.router._affinity_key("/v1/chat", body))[0]
    a = [r.name for r in f.router.replicas].index(head.name)
    b = 1 - a
    dec_a = f.servers[a].batcher.decoder
    dec_b = f.servers[b].batcher.decoder
    code, reply_a = _post(f.url, "/v1/chat", body)
    assert code == 200 and REQUEST_ID_RX.fullmatch(reply_a["request_id"])
    # A's flush reported its chain; the router indexes it as A's.
    _wait(lambda: len(f.router._page_index) > 0)
    keys = list(f.router._page_index)
    assert set(f.router._page_index.values()) == {f.urls[a]}
    assert set(keys) == set(dec_a.prefix_cache._index)
    # The same request on B pulls every page A reported.
    code, reply_b = _post(f.urls[b], "/v1/chat", body)
    assert code == 200 and reply_b["reply"] == reply_a["reply"]
    assert dec_b.remote_hits == 1 and dec_b.remote_pull_failures == 0
    assert metric_line(f.servers[b].registry,
                       "serve_prefix_remote_hits_total") == 1
    assert metric_line(f.servers[b].registry,
                       "serve_prefix_remote_pulls_total") == len(keys)
    assert f.servers[b].recorder.snapshot(type="prefix_remote_hit")
    for key in keys:
        assert _page_bytes(f.urls[b], key) == _page_bytes(f.urls[a], key)
    # B's report of the pulled keys makes B their last reporter.
    _wait(lambda: set(f.router._page_index.values()) == {f.urls[b]})
    # A repeat on B is a local hit: no second pull.
    assert _post(f.urls[b], "/v1/chat", _chat("again"))[0] == 200
    assert dec_b.remote_hits == 1
    # Kill A: one probe round opens its breaker; every request is 200.
    kill_replica(SimpleNamespace(httpd=f.httpds[a]))
    f.router.probe_all()
    assert f.router.replicas[a].breaker.state == "open"
    code, health = _get(f.url, "/healthz")
    assert code == 200 and health["status"] == "degraded"
    for i in range(4):
        assert _post(f.url, "/v1/chat", _chat(f"after {i}"))[0] == 200
        assert _post(f.url, "/v1/generate", {"prompt": f"p{i}"})[0] == 200
    f.router.handle_page_report({"replica": f.urls[a], "keys": keys})
    owner = f.router.handle_page_lookup({"keys": keys})["owner"]
    assert owner != f.urls[a]


def test_page_route_refuses_pages_still_being_pulled(fleet):
    """GET /pages/<key> on B while B is pulling that chain from A: the page
    being fetched is in B's index but not yet written, so B answers 404
    (never the arena page's old bytes); the pages already imported answer
    200 with A's bytes."""
    f = fleet
    body = _chat("mid-pull")
    head = f.router._ordered(f.router._affinity_key("/v1/chat", body))[0]
    a = [r.name for r in f.router.replicas].index(head.name)
    b = 1 - a
    assert _post(f.urls[a], "/v1/chat", body)[0] == 200
    _wait(lambda: len(f.router._page_index) > 1)
    client = f.servers[b].page_share
    fetch = client.fetch_page
    seen = []

    def fetch_and_probe(owner, key, timeout_s=None):
        with pytest.raises(urllib.error.HTTPError) as e:
            _page_bytes(f.urls[b], key)
        assert e.value.code == 404
        if seen:
            assert _page_bytes(f.urls[b], seen[-1]) == _page_bytes(
                f.urls[a], seen[-1])
        seen.append(key)
        return fetch(owner, key, timeout_s=timeout_s)

    client.fetch_page = fetch_and_probe
    assert _post(f.urls[b], "/v1/chat", body)[0] == 200
    dec_b = f.servers[b].batcher.decoder
    assert dec_b.remote_hits == 1 and dec_b.remote_pull_failures == 0
    assert len(seen) == len(f.router._page_index) > 1


def test_router_http_surface_end_to_end(fleet):
    f = fleet
    code, body = _post(f.url, "/v1/generate", {"prompt": "hiya",
                                              "max_new_tokens": 4})
    assert code == 200 and body["tokens"] >= 1
    ctype, frames = _post_sse(f.url, "/v1/generate",
                              {"prompt": "hi", "stream": True,
                               "max_new_tokens": 4})
    assert ctype.startswith("text/event-stream")
    assert frames[-1] == "[DONE]" and json.loads(frames[-2])["done"] is True
    code, fl = _get(f.url, "/fleet")
    assert code == 200 and len(fl["replicas"]) == 2
    with urllib.request.urlopen(f.url + "/metrics", timeout=10) as r:
        text = r.read().decode()
    assert "router_requests_total" in text and "router_breaker_state" in text
    assert _post(f.url, "/nope", {})[0] == 404
    key = "ab" * 32
    code, out = _post(f.url, "/pages/report",
                      {"replica": f.urls[0], "keys": [key]})
    assert code == 200 and out == {"indexed": 1, "known": True}
    code, out = _post(f.url, "/pages/lookup",
                      {"keys": [key], "exclude": f.urls[1]})
    assert out == {"owner": f.urls[0], "keys": [key]}
    # A replica's page route: bad keys and absent pages answer 404.
    for path in ("/pages/zz", f"/pages/{key}"):
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f.urls[0] + path, timeout=10)
        assert e.value.code == 404


def test_request_id_correlates_router_and_replica_rings(fleet):
    f = fleet
    rid = "req-corr-42"
    dead = f.router.replicas[0]
    f.httpds[0].shutdown()
    f.httpds[0].server_close()
    prompt = _affine(f.router, dead.name)
    req = urllib.request.Request(
        f.url + "/v1/generate",
        data=json.dumps({"prompt": prompt, "max_new_tokens": 3}).encode(),
        headers={"Content-Type": "application/json", "X-Request-Id": rid})
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.headers.get("X-Request-Id") == rid
        assert json.loads(r.read())["request_id"] == rid
    router_ev = filter_events(f.recorder.snapshot(), request=rid)
    replica_ev = filter_events(f.servers[1].recorder.snapshot(), request=rid)
    assert any(e["type"] == "router_failover" for e in router_ev)
    assert any(e["type"] == "request_received" for e in replica_ev)
    bad = urllib.request.Request(
        f.url + "/v1/generate",
        data=json.dumps({"prompt": "x", "max_new_tokens": 2}).encode(),
        headers={"Content-Type": "application/json",
                 "X-Request-Id": "bad id!! with spaces"})
    with urllib.request.urlopen(bad, timeout=30) as r:
        assert REQUEST_ID_RX.fullmatch(json.loads(r.read())["request_id"])


def test_real_5xx_burst_opens_breaker_then_probe_recovers(fleet):
    f = fleet
    clock = FakeClock()
    for rep in f.router.replicas:
        rep.breaker._clock = clock
    head = f.router._ordered(
        f.router._affinity_key("/v1/generate", {"prompt": "burst"}))[0]
    victim = f.servers[f.urls.index(head.url)]
    with replica_5xx_burst(victim, times=8) as hits:
        for _ in range(5):
            assert _post(f.url, "/v1/generate",
                         {"prompt": "burst", "max_new_tokens": 2})[0] == 200
    assert hits["calls"] >= 3 and head.breaker.state == "open"
    clock.advance(5.1)
    f.router.probe_once(head)
    assert head.breaker.state == "closed"


def test_top_renders_router_fleet_on_the_named_device(fleet, capsys):
    f = fleet
    assert cli.main(["top", "--url", f.url, "--once"]) == 0
    out = capsys.readouterr().out
    assert "fleet — ok (2/2 available" in out and "r1" in out
    assert cli.main(["top", "--url", f.url, "--once", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["fleet"]["replicas"][0]["breaker"] == "closed"
    # `top` is host code: no --device flag, and no card needed.
    with pytest.raises(SystemExit):
        cli.main(["top", "--url", f.url, "--once", "--device", "cpu"])
