"""HTTP round trips through the port's ChatServer on the CPU.

A two-layer model (hidden 64, seeded weights, fp32) behind the port's
ThreadingHTTPServer on 127.0.0.1 with an OS-picked port: /health, /stats,
/v1/generate and /v1/chat answer, request errors map to 400/404, and the
tokens a greedy request returns are exactly the tokens the port's own
StepwiseDecoder produces for that prompt outside the server (so the
scheduler adds nothing and drops nothing). Concurrent requests mix whole
and chunked prefill and each still gets its solo answer: lanes of one
decode batch are independent.
"""

import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import pytest

from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.inference.chat import build_engine
from luminaai_tpu_torch.serving.server import ChatServer

ARCH = dict(vocab_size=384, hidden_size=64, num_layers=2, num_heads=2,
            num_kv_heads=1, seq_length=256, intermediate_size=128,
            precision="fp32", prefill_chunk_size=32)
SLOTS, PAGE, BUDGET = 3, 16, 6


@pytest.fixture(scope="module")
def served():
    engine = build_engine(Config(**ARCH), device="cpu", seed=0)
    server = ChatServer(engine, num_slots=SLOTS, page_size=PAGE)
    httpd = server.make_httpd("127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    host, port = httpd.server_address[:2]
    yield engine, server, f"http://{host}:{port}"
    httpd.shutdown()
    httpd.server_close()
    server.close()
    thread.join(10)


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, json.loads(r.read())


def _post(url, body, raw=None):
    data = raw if raw is not None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"}
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _solo_tokens(engine, prompt_ids, budget):
    """The greedy answer of one request on a decoder of its own: the
    first token from prefill, then decode steps until a stop token or the
    budget (the scheduler's finish rules)."""
    dec = engine.make_stepwise(num_slots=1, page_size=PAGE)
    slot = dec.acquire_slot()
    st = dec.start_prefill(slot, prompt_ids, max_new_tokens=budget)
    if st is None:
        info = dec.prefill_into_slot(slot, prompt_ids, max_new_tokens=budget)
    else:
        info = None
        while info is None:
            info = dec.advance_prefill(st)
    if info["is_stop"]:
        return []
    out = [info["token"]]
    while len(out) < budget:
        toks, produced, eos = dec.decode_step()
        if eos[slot] or not produced[slot]:
            break
        out.append(int(toks[slot]))
    return out


def test_health_and_stats(served):
    _, _, url = served
    code, health = _get(url + "/health")
    assert code == 200 and health["status"] == "ok"
    assert health["model"] == {"hidden_size": 64, "num_layers": 2,
                               "vocab_size": 384, "moe": False}
    assert health["device"] == "cpu"
    code, stats = _get(url + "/stats")
    assert code == 200 and stats["scheduler"] == "continuous"
    assert stats["kv_pool"]["num_slots"] == SLOTS
    assert stats["kv_pool"]["page_size"] == PAGE


def test_generate_returns_the_decoders_greedy_tokens(served):
    engine, _, url = served
    prompt = "the quick brown fox"
    code, body = _post(url + "/v1/generate", {
        "prompt": prompt, "max_new_tokens": BUDGET, "temperature": 0,
    })
    assert code == 200, body
    want = _solo_tokens(engine, engine.tokenizer.encode_text(prompt), BUDGET)
    assert body["token_ids"] == want
    assert body["tokens"] == len(want)
    assert body["prompt_tokens"] == len(prompt)
    assert body["stopped"] in ("length", "eos")
    assert body["text"] == engine.tokenizer.decode(want)


def test_chat_round_trip(served):
    engine, _, url = served
    messages = [{"role": "user", "content": "hello there"}]
    code, body = _post(url + "/v1/chat", {
        "messages": messages, "max_new_tokens": BUDGET, "temperature": 0,
    })
    assert code == 200, body
    assert "reply" in body
    assert body["token_ids"] == _solo_tokens(
        engine, engine.encode_chat(messages), BUDGET
    )
    code, body = _post(url + "/v1/chat", {"message": "hi", "max_new_tokens": 2,
                                          "temperature": 0})
    assert code == 200 and body["tokens"] <= 2


def test_concurrent_requests_mix_both_prefill_paths(served):
    """Prompts of 10 and 20 bytes take the whole-prompt prefill, 50 and 90
    the chunked one (chunk 32); four requests on three slots also queue."""
    engine, server, url = served
    prompts = [("abcdefghij" * 9)[:n] for n in (10, 50, 20, 90)]
    steps0 = server.batcher.decoder.steps
    with ThreadPoolExecutor(len(prompts)) as pool:
        replies = list(pool.map(
            lambda p: _post(url + "/v1/generate", {
                "prompt": p, "max_new_tokens": BUDGET, "temperature": 0,
            }),
            prompts,
        ))
    for p, (code, body) in zip(prompts, replies):
        assert code == 200, body
        assert body["token_ids"] == _solo_tokens(
            engine, engine.tokenizer.encode_text(p), BUDGET
        )
    assert server.batcher.decoder.steps > steps0
    _, stats = _get(url + "/stats")
    assert stats["queue_depth"] == 0 and stats["active_lanes"] == 0
    assert stats["kv_pool"]["in_use"] == 0


def test_moe_concurrent_requests_get_their_solo_answers():
    """An MoE engine (4 experts top-2, gmm dispatch) behind the server:
    the MoE layers route decode lanes as groups of their own and each
    prefill (whole or chunk) as the request's own group, so concurrent
    requests still get the solo decoder's greedy tokens (the solo decoder
    matches the JAX decoder: tests/test_torch_generate.py)."""
    cfg = Config(**ARCH, use_moe=True, num_experts=4, moe_top_k=2,
                 moe_dispatch="gmm")
    engine = build_engine(cfg, device="cpu", seed=1)
    assert all(hasattr(b, "moe") for b in engine.model.layers)
    server = ChatServer(engine, num_slots=SLOTS, page_size=PAGE)
    httpd = server.make_httpd("127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    host, port = httpd.server_address[:2]
    url = f"http://{host}:{port}"
    try:
        code, health = _get(url + "/health")
        assert code == 200 and health["model"]["moe"] is True
        prompts = [("abcdefghij" * 9)[:n] for n in (10, 50, 20, 90)]
        with ThreadPoolExecutor(len(prompts)) as pool:
            replies = list(pool.map(
                lambda p: _post(url + "/v1/generate", {
                    "prompt": p, "max_new_tokens": BUDGET,
                    "temperature": 0}),
                prompts,
            ))
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
        thread.join(10)
    for p, (code, body) in zip(prompts, replies):
        assert code == 200, body
        assert body["token_ids"] == _solo_tokens(
            engine, engine.tokenizer.encode_text(p), BUDGET)


def test_request_errors(served):
    _, _, url = served
    assert _post(url + "/v1/generate", {})[0] == 400
    assert _post(url + "/v1/generate", {"prompt": "x",
                                        "temperature": "hot"})[0] == 400
    assert _post(url + "/v1/generate", None, raw=b"{not json")[0] == 400
    assert _post(url + "/v1/generate", None, raw=b"[1, 2]")[0] == 400
    assert _post(url + "/v1/chat", {"messages": [{"role": 1}]})[0] == 400
    assert _post(url + "/v1/nothing", {"prompt": "x"})[0] == 404
    try:
        _get(url + "/nothing")
        raise AssertionError("GET of an unknown path answered 200")
    except urllib.error.HTTPError as e:
        assert e.code == 404


def test_sampling_overrides_are_clamped(served):
    """Out-of-range overrides are clamped (the JAX server's clamps), not
    refused: a huge budget is capped, a negative temperature is greedy."""
    engine, server, url = served
    code, body = _post(url + "/v1/generate", {
        "prompt": "clamp me", "max_new_tokens": 10 ** 9, "temperature": -3,
        "top_p": 7, "top_k": -5, "repetition_penalty": 100, "seed": -1,
    })
    assert code == 200, body
    cap = server.batcher.decoder.token_capacity - 1
    assert 1 <= body["tokens"] <= cap
    clamps = server._OVERRIDE_CLAMPS
    assert clamps["temperature"](-3, None) == 0.0
    assert clamps["top_p"](7, None) == 1.0
    assert clamps["top_k"](-5, None) == 0
    assert clamps["repetition_penalty"](100, None) == 5.0
    assert clamps["max_new_tokens"](10 ** 9, 2048) == 2048
