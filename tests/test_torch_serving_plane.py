"""The port's serving plane (ChatServer, ContinuousScheduler, MicroBatcher)
against the JAX package's, route by route.

Both servers wrap the same hermetic engine double (a deterministic
StepwiseDecoder double over each side's own PagedKVPool, the pattern of
tests/test_resilience.py), so what is compared is the serving plane
itself: the same request script gives the same status codes and the same
payload keys (the port's /stats adds the scheduler's `decode_seconds`
and `tick_seconds`, and the engine's `quantization` and
`kv_cache_dtype`), the same error texts, 401 without a token, 429 past the tenant bucket (with
retry_after), 503 + Retry-After past the queue depth and while draining,
504 past a deadline, /healthz 503 before the warmup and 200 after, the
same SSE frame sequence, the same fair-share admission order across
tenants, the same lifecycle events in the flight record a drain dumps, the
same /metrics families and the same chat page. One difference is pinned: a
failed warmup keeps the port's /healthz at 503 (the JAX server opens it).
"""

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from luminaai_tpu.config import Config as JConfig
from luminaai_tpu.inference.kv_pool import PagedKVPool as JPool
from luminaai_tpu.monitoring.events import FlightRecorder as JRec
from luminaai_tpu.monitoring.telemetry import MetricsRegistry as JReg
from luminaai_tpu.serving import server as jsrv
from luminaai_tpu.serving.webui import PAGE as JPAGE
from luminaai_tpu_torch.config import Config as TConfig
from luminaai_tpu_torch.inference.kv_pool import PagedKVPool as TPool
from luminaai_tpu_torch.monitoring.events import FlightRecorder as TRec
from luminaai_tpu_torch.monitoring.telemetry import MetricsRegistry as TReg
from luminaai_tpu_torch.serving import server as tsrv
from luminaai_tpu_torch.serving.webui import PAGE as TPAGE

SIDES = {
    "jax": (jsrv, JConfig, JPool, JReg, JRec),
    "torch": (tsrv, TConfig, TPool, TReg, TRec),
}
PORT_EXTRA_STATS = {"decode_seconds", "tick_seconds", "quantization",
                    "kv_cache_dtype"}
USER, PASSWORD = "alice", "Corr3ct-Horse-Battery"


class _Tok:
    class backend:
        @staticmethod
        def encode(text):
            return [ord(c) % 250 for c in text]

    def decode(self, tokens):
        return ",".join(str(t) for t in tokens)


class _Stepper:
    """Deterministic StepwiseDecoder double: lane s emits first, first+1,
    ...; `gate` (an Event) holds prefill until set; `delay` slows decode
    steps; `fail` makes prefill raise."""

    def __init__(self, pool_cls, num_slots=2, slot_tokens=64):
        self.num_slots = num_slots
        self.slot_tokens = slot_tokens
        self.pool = pool_cls(None, num_slots, 1, slot_tokens)
        self.steps = 0
        self._active = [False] * num_slots
        self._next = [0] * num_slots
        self.gate = None
        self.delay = 0.0
        self.fail = False

    def has_free_slot(self):
        return self.pool.has_free()

    def acquire_slot(self):
        return self.pool.alloc()

    def release_slot(self, slot):
        self._active[slot] = False
        self.pool.free(slot)

    def lane_full(self, slot):
        return False

    def prefill_into_slot(self, slot, prompt, max_new_tokens=1,
                          sample_key=None, seed=None):
        if self.gate is not None:
            self.gate.wait(10)
        if self.fail:
            raise RuntimeError("kernel launch failed")
        first = int(prompt[0])
        self._active[slot] = max_new_tokens > 1
        self._next[slot] = first + 1
        self.pool.lengths[slot] = len(prompt)
        return {"token": first, "prompt_tokens": len(prompt),
                "is_stop": False}

    def decode_step(self, sample_key=None):
        time.sleep(self.delay)
        toks = np.zeros((self.num_slots,), np.int64)
        eos = np.zeros((self.num_slots,), bool)
        produced = np.asarray(self._active, bool).copy()
        for s in range(self.num_slots):
            if self._active[s]:
                toks[s] = self._next[s]
                self._next[s] += 1
        self.steps += 1
        return toks, produced, eos


class _Engine:
    def __init__(self, side, slots=2):
        _, cfg_cls, pool_cls, _, _ = SIDES[side]
        self.config = cfg_cls(vocab_size=256, hidden_size=64, num_layers=2,
                              num_heads=4, num_kv_heads=2, seq_length=64,
                              use_flash_attention=False)
        self.tokenizer = _Tok()
        self.stepper = _Stepper(pool_cls, slots)
        self.quantization_info = {}  # both engines carry it

    def make_stepwise(self, **kw):
        return self.stepper

    def encode_chat(self, messages):
        return self.tokenizer.backend.encode(messages[-1]["content"])

    def generate_batch(self, prompts, **kw):
        n = int(kw.get("max_new_tokens") or 3)
        return [([int(p[0]) + i for i in range(n)],
                 {"tokens_generated": n, "stopped": "length"})
                for p in prompts]

    def generate_stream(self, prompt, **kw):
        toks, stats = self.generate_batch([prompt], **kw)[0]
        yield from toks
        yield stats


def _server(side, tmp_path=None, slots=2, **kw):
    mod, _, _, reg_cls, rec_cls = SIDES[side]
    eng = _Engine(side, slots)
    if kw.get("secure"):
        kw.setdefault("bootstrap_user", (USER, PASSWORD))
        kw.setdefault("users_path", str(tmp_path / f"users-{side}.json"))
    srv = mod.ChatServer(eng, registry=reg_cls(), recorder=rec_cls(), **kw)
    return srv, eng


def _shape(code, payload):
    """(status, payload keys, the values that must agree)."""
    keys = set(payload) if isinstance(payload, dict) else {"<text>"}
    same = {k: payload[k] for k in ("error", "status", "stopped", "tokens",
                                    "text", "reply", "retry_after",
                                    "scheduler", "secure", "model")
            if isinstance(payload, dict) and k in payload}
    return code, keys, same


def _script(srv):
    """One request script through handle(); returns the shapes."""
    out = []
    for path in ("/health", "/healthz", "/stats", "/slo",
                 "/metrics/history", "/nothing"):
        code, payload = srv.handle("GET", path, {}, None)
        if path == "/stats":
            payload = {k: v for k, v in payload.items()
                       if k not in PORT_EXTRA_STATS}
        out.append(_shape(code, payload))
    token = None
    if srv.secure:
        out.append(_shape(*srv.handle("POST", "/v1/auth",
                                      {"user": USER, "password": "nope"},
                                      None)))
        out.append(_shape(*srv.handle("POST", "/v1/generate",
                                      {"prompt": "hi"}, None)))
        code, body = srv.handle("POST", "/v1/auth",
                                {"user": USER, "password": PASSWORD}, None)
        out.append((code, set(body)))
        token = body.get("token")
    else:
        out.append(_shape(*srv.handle("POST", "/v1/auth", {}, None)))
    for body in (
        {"prompt": "hello", "max_new_tokens": 4},
        {"message": "hey", "max_new_tokens": 3},
        {"messages": [{"role": "user", "content": "yo"}],
         "max_new_tokens": 2, "temperature": 0.5},
        {"prompt": ""},
        {"prompt": "x", "temperature": "hot"},
        {"messages": [{"role": 1}]},
        {"prompt": "abc", "max_new_tokens": 2, "speculative": True},
    ):
        path = "/v1/chat" if ("message" in body or "messages" in body) \
            else "/v1/generate"
        code, payload = srv.handle("POST", path, body, token)
        if code == 200:
            assert len(payload["request_id"]) == 12
        out.append(_shape(code, payload))
    code, stats = srv.handle("GET", "/stats", {}, None)
    out.append((code, set(stats) - PORT_EXTRA_STATS,
                {k: stats[k] for k in ("requests", "tokens_out")}))
    return out


@pytest.mark.parametrize("secure", [False, True])
@pytest.mark.parametrize("continuous", [True, False])
def test_routes_match_jax(tmp_path, secure, continuous):
    got = {}
    for side in SIDES:
        srv, _ = _server(side, tmp_path, secure=secure,
                         continuous="auto" if continuous else False)
        try:
            got[side] = _script(srv)
        finally:
            srv.drain(2.0)
    assert got["torch"] == got["jax"]
    assert got["torch"][0][0] == 200


@pytest.mark.parametrize("side", list(SIDES))
def test_tenant_bucket_429_and_shed_503(tmp_path, side):
    """Past --tenant-burst a tenant gets 429 with retry_after (the bucket
    charges before the validator); past max_queue_depth 503 with
    retry_after, and the shed skips the gate."""
    srv, eng = _server(side, tmp_path, secure=True, tenant_rate_per_s=0.01,
                       tenant_burst=3, max_queue_depth=1)
    token = srv.handle("POST", "/v1/auth",
                       {"user": USER, "password": PASSWORD}, None)[1]["token"]
    codes = [srv.handle("POST", "/v1/generate", {"prompt": " "}, token)
             for _ in range(4)]
    assert [c for c, _ in codes] == [400, 400, 400, 429]
    assert codes[-1][1]["retry_after"] >= 1
    assert codes[-1][1]["error"] == "tenant rate limit exceeded"
    srv.batcher.queue_depth = lambda: 5
    code, body = srv.handle("POST", "/v1/generate", {"prompt": "x"}, token)
    assert code == 503 and body["retry_after"] >= 1
    assert "overloaded" in body["error"] and "request_id" in body
    assert srv.registry.get("serving_overload_rejections_total").value == 1
    srv.drain(1.0)


def _http(url, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _serve_http(srv):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), srv.make_handler())
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _sse(raw):
    return [json.loads(f[6:]) if f != "data: [DONE]" else "[DONE]"
            for f in raw.decode().split("\n\n") if f.startswith("data: ")]


def _http_script(srv, eng):
    httpd, url = _serve_http(srv)
    out = []
    try:
        code, hdr, body = _http(url + "/")
        out.append((code, hdr["Content-Type"], len(body)))
        code, hdr, body = _http(url + "/metrics")
        names = sorted({line.split()[2] for line in body.decode().splitlines()
                        if line.startswith("# TYPE ")
                        and line.split()[2].startswith(
                            ("serve", "tenant", "kv_pool", "prefix_cache"))})
        out.append((code, hdr["Content-Type"], names))
        code, _, body = _http(url + "/metrics/history?seconds=nan&max_points=3")
        out.append((code, sorted(json.loads(body))))
        code, hdr, body = _http(url + "/v1/generate",
                                {"prompt": "AB", "max_new_tokens": 3},
                                {"X-Request-Id": "req-abc_123"})
        out.append((code, json.loads(body)["request_id"]))
        code, hdr, body = _http(url + "/v1/chat",
                                {"message": "Hi", "stream": True,
                                 "max_new_tokens": 4})
        frames = _sse(body)
        for f in frames:
            if isinstance(f, dict):
                f.pop("latency_s", None)
                f.pop("request_id", None)
        out.append((code, hdr["Content-Type"], frames))
        code, _, body = _http(url + "/v1/generate", None, None)
        out.append((code, sorted(json.loads(body))))
        code, _, body = _http(url + "/nope")
        out.append((code, json.loads(body)))
        srv.batcher.queue_depth = lambda: 500
        code, hdr, body = _http(url + "/v1/generate", {"prompt": "x"})
        out.append((code, hdr.get("Retry-After"), sorted(json.loads(body))))
    finally:
        httpd.shutdown()
        httpd.server_close()
    return out


def test_http_layer_matches_jax():
    got = {}
    for side in SIDES:
        srv, eng = _server(side, max_queue_depth=4)
        got[side] = _http_script(srv, eng)
        srv.drain(1.0)
    assert got["torch"] == got["jax"]
    assert got["torch"][4][2][-1] == "[DONE]"
    assert TPAGE == JPAGE


@pytest.mark.parametrize("side", list(SIDES))
def test_healthz_gate_before_and_after_warmup(side):
    import threading as th

    srv, eng = _server(side, warmup=False)
    srv._ready.clear()
    eng.stepper.gate = th.Event()
    threading.Thread(target=srv._warmup, daemon=True).start()
    code, body = srv.handle("GET", "/healthz", {}, None)
    assert code == 503 and body["status"] == "warming"
    eng.stepper.gate.set()
    for _ in range(200):
        if srv.handle("GET", "/healthz", {}, None)[0] == 200:
            break
        time.sleep(0.01)
    code, body = srv.handle("GET", "/healthz", {}, None)
    assert code == 200 and body["status"] == "ok"
    assert srv.registry.get("serve_ready").value == 1.0
    srv.drain(1.0)


def test_failed_warmup_keeps_port_healthz_at_503():
    """The one pinned difference: a warmup whose kernels fail leaves the
    port's /healthz 503 with the error; the JAX server opens its gate. A
    request served afterwards opens the port's gate."""
    seen = {}
    for side in SIDES:
        srv, eng = _server(side, warmup=False)
        srv._ready.clear()
        eng.stepper.fail = True
        srv._warmup()
        seen[side] = srv.handle("GET", "/healthz", {}, None)
        if side == "torch":
            assert srv.handle("GET", "/healthz", {}, None)[0] == 503
            eng.stepper.fail = False
            assert srv.handle("POST", "/v1/generate", {"prompt": "x"},
                              None)[0] == 200
            assert srv.handle("GET", "/healthz", {}, None)[0] == 200
        srv.drain(1.0)
    assert seen["jax"][0] == 200 and "warmup_error" in seen["jax"][1]
    code, body = seen["torch"]
    assert code == 503 and body["status"] == "warmup_failed"
    assert "kernel launch failed" in body["warmup_error"]


def test_failed_launch_fails_its_request_as_500():
    """A prefill (kernel) failure fails the request: the scheduler hands
    the error to it and the HTTP layer answers 500, on both sides."""
    got = {}
    for side in SIDES:
        srv, eng = _server(side)
        eng.stepper.fail = True
        httpd, url = _serve_http(srv)
        try:
            code, _, body = _http(url + "/v1/generate", {"prompt": "x"})
        finally:
            httpd.shutdown()
            httpd.server_close()
        got[side] = (code, json.loads(body))
        srv.drain(1.0)
    assert got["torch"] == got["jax"] == (
        500, {"error": "kernel launch failed"})


def test_deadline_504_and_timeout_counters():
    got = {}
    for side in SIDES:
        srv, eng = _server(side, request_timeout_s=5.0)
        eng.stepper.delay = 0.02
        code, body = srv.handle("POST", "/v1/generate",
                                {"prompt": "AB", "max_new_tokens": 500,
                                 "timeout_s": 0.1}, None)
        assert code == 504 and "deadline exceeded" in body["error"]
        timed = srv.registry.get("serving_requests_timed_out_total").value
        got[side] = (code, sorted(body), timed,
                     srv._effective_timeout({"timeout_s": 99}),
                     srv._effective_timeout({"timeout_s": -1}))
        srv.drain(2.0)
    assert got["torch"] == got["jax"]


def _fair_order(side):
    mod, _, pool_cls, reg_cls, rec_cls = SIDES[side]
    eng = _Engine(side, slots=1)
    rec = rec_cls()
    sched = mod.ContinuousScheduler(eng, decoder=eng.stepper,
                                    registry=reg_cls(), recorder=rec,
                                    tenant_weights={"b": 2})
    eng.stepper.gate = threading.Event()
    threads = []

    def submit(tenant, first):
        sched.submit([first], {"max_new_tokens": 2, "tenant": tenant})

    for tenant, first in [("a", 1)] + [("a", 10 + i) for i in range(4)] + [
            ("b", 20 + i) for i in range(3)] + [("c", 30)]:
        t = threading.Thread(target=submit, args=(tenant, first))
        t.start()
        threads.append(t)
        time.sleep(0.01)
    eng.stepper.gate.set()
    for t in threads:
        t.join(10)
    return [(e["tenant"], e["prompt_tokens"]) for e in rec.snapshot(
        type="request_admitted")], sched.idle()


def test_tenant_fair_order_matches_jax():
    got = {side: _fair_order(side) for side in SIDES}
    assert got["torch"] == got["jax"]
    # The first request runs alone; then weighted round-robin: a once,
    # b twice (weight 2), c once, a, b, then a's flood drains.
    order = [t for t, _ in got["torch"][0]]
    assert order == ["a", "a", "b", "b", "c", "a", "b", "a", "a"]


def _drain_trail(side, tmp_path):
    srv, eng = _server(side, flight_dir=str(tmp_path / side))
    eng.stepper.delay = 0.005
    res = {}

    def inflight(i):
        res[i] = srv.handle("POST", "/v1/generate",
                            {"prompt": chr(65 + i), "max_new_tokens": 20},
                            None)

    threads = [threading.Thread(target=inflight, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    srv.begin_drain()
    shed = srv.handle("POST", "/v1/generate", {"prompt": "x"}, None)
    health = srv.handle("GET", "/healthz", {}, None)
    for t in threads:
        t.join(10)
    assert srv.drain(5.0) is True
    dumps = sorted((tmp_path / side).glob("flightrec-*-drain.jsonl"))
    assert dumps and sorted((tmp_path / side).glob("tshist-*-drain.json"))
    types = [json.loads(line)["type"] for line in dumps[0].read_text()
             .splitlines()]
    return ([res[i][0] for i in range(2)], [res[i][1]["tokens"]
                                            for i in range(2)],
            shed[0], sorted(shed[1]), health[0], health[1]["status"],
            sorted(set(types)))


def test_drain_matches_jax(tmp_path):
    got = {side: _drain_trail(side, tmp_path) for side in SIDES}
    assert got["torch"] == got["jax"]
    assert got["torch"][:3] == ([200, 200], [20, 20], 503)


@pytest.mark.parametrize("dev,want", [("cuda", 0), ("cuda:1", 1),
                                      ("cpu", None)])
@pytest.mark.parametrize("continuous", [True, False])
def test_workers_make_the_models_card_current(monkeypatch, dev, want,
                                              continuous):
    """The scheduler's and the MicroBatcher's worker threads make the
    model's card their current device before any device call (a bare
    "cuda" is the constructing thread's current card), and then serve."""
    import types

    import torch

    calls = []
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: calls.append(
        (threading.current_thread() is threading.main_thread(), i)))
    srv, eng = _server("torch", continuous="auto" if continuous else False)
    eng.stepper.device = torch.device(dev)
    eng.model = types.SimpleNamespace(device=torch.device(dev))
    srv2 = tsrv.ChatServer(eng, registry=TReg(), recorder=TRec(),
                           continuous="auto" if continuous else False)
    code, body = srv2.handle("POST", "/v1/generate",
                             {"prompt": "AB", "max_new_tokens": 3}, None)
    assert code == 200 and body["tokens"] == 3
    assert calls == ([] if want is None else [(False, want)])
    srv.drain(1.0)
    srv2.drain(1.0)
    srv2.close()
