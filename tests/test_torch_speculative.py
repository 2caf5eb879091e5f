"""GenerationEngine.generate_batch and the speculative paths, against JAX.

Both engines serve the same weights (a flax init, converted with
convert.params_from_flax) in fp32 on the CPU, greedy:

- prompt-lookup drafts: `ngram_propose` and the incremental `_NgramIndex`
  propose what the JAX functions propose;
- `generate_batch` over ragged prompts returns JAX's tokens, stops and
  prompt lengths, and each row equals the port's own single-request
  `generate` (lanes are independent);
- `generate_speculative` returns JAX's tokens and `verify_calls`, and its
  tokens equal greedy `generate` exactly (the JAX package pins this too);
  `generate_stream_speculative` yields the same tokens and stats;
- the `--no-continuous` server (MicroBatcher over generate_batch) and the
  continuous server answer the same greedy requests alike, and a
  {"speculative": true} request returns greedy's reply with its verify
  stats. All comparisons are exact.
"""

import json
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from luminaai_tpu.config import Config as JConfig
from luminaai_tpu.data.tokenizer import ConversationTokenizer as JTok
from luminaai_tpu.inference import generate as jgen
from luminaai_tpu.models.transformer import LuminaTransformer as JModel
from luminaai_tpu_torch.config import Config as TConfig
from luminaai_tpu_torch.convert import params_from_flax
from luminaai_tpu_torch.data.tokenizer import ConversationTokenizer as TTok
from luminaai_tpu_torch.inference import generate as tgen
from luminaai_tpu_torch.models.transformer import LuminaTransformer as TModel
from luminaai_tpu_torch.monitoring.telemetry import MetricsRegistry
from luminaai_tpu_torch.serving.server import ChatServer

ARCH = dict(vocab_size=384, hidden_size=64, num_layers=2, num_heads=2,
            num_kv_heads=1, seq_length=256, intermediate_size=128,
            precision="fp32", max_new_tokens=10, prefill_chunk_size=32,
            temperature=0.0, repetition_penalty=1.0)


def _unbox(params):
    from flax import linen as nn

    return jax.tree.map(
        lambda x: x.unbox() if isinstance(x, nn.meta.AxisMetadata) else x,
        params, is_leaf=lambda x: isinstance(x, nn.meta.AxisMetadata),
    )


@pytest.fixture(scope="module")
def engines():
    jcfg = JConfig(**ARCH, use_flash_attention=False,
                   gradient_checkpointing=False,
                   attention_backend="ragged_xla")
    jmodel = JModel(jcfg)
    params = _unbox(
        jmodel.init(jax.random.key(3), jnp.ones((1, 8), jnp.int32))["params"]
    )
    tcfg = TConfig(**ARCH)
    tmodel = TModel(tcfg, device="cpu").load_params(
        params_from_flax(jax.device_get(params), tcfg))
    return (jgen.GenerationEngine(jmodel, params, JTok(), jcfg),
            tgen.GenerationEngine(tmodel, TTok(), tcfg))


def _repetitive(seed=0, n=60):
    rng = np.random.RandomState(seed)
    motif = [int(t) for t in rng.randint(0, 256, size=7)]
    return (motif * (n // 7 + 1))[:n]


def test_ngram_proposals_match_jax():
    rng = np.random.RandomState(1)
    for trial in range(30):
        h = [int(t) for t in rng.randint(0, 6, size=rng.randint(1, 40))]
        for k in (1, 3, 7):
            want = jgen.ngram_propose(h, k)
            assert tgen.ngram_propose(h, k) == want
            ji, ti = jgen._NgramIndex(h), tgen._NgramIndex(h)
            assert ti.propose(k) == ji.propose(k) == want
        extra = [int(t) for t in rng.randint(0, 6, size=5)]
        for t in extra:
            ji.append(t)
            ti.append(t)
            assert ti.propose(4) == ji.propose(4)


def test_generate_batch_matches_jax(engines):
    jeng, teng = engines
    rng = np.random.RandomState(2)
    prompts = [[int(t) for t in rng.randint(0, 256, size=n)]
               for n in (5, 40, 17, 70)]
    want = jeng.generate_batch(prompts, max_new_tokens=10, temperature=0.0)
    got = teng.generate_batch(prompts, max_new_tokens=10, temperature=0.0)
    assert [t for t, _ in got] == [t for t, _ in want]
    for (_, ts), (_, js) in zip(got, want):
        for key in ("tokens_generated", "prompt_tokens", "stopped",
                    "batch_size"):
            assert ts[key] == js[key]
    for p, (toks, _) in zip(prompts, got):
        assert toks == teng.generate(p, max_new_tokens=10,
                                     temperature=0.0)[0]


def test_generate_speculative_matches_jax_and_greedy(engines):
    jeng, teng = engines
    prompt = _repetitive()
    want, jstats = jeng.generate_speculative(prompt, max_new_tokens=24,
                                             draft_k=4)
    got, tstats = teng.generate_speculative(prompt, max_new_tokens=24,
                                            draft_k=4)
    assert got == want
    assert tstats["verify_calls"] == jstats["verify_calls"]
    assert tstats["tokens_per_verify"] == jstats["tokens_per_verify"]
    assert tstats["stopped"] == jstats["stopped"]
    greedy, _ = teng.generate(prompt, max_new_tokens=24, temperature=0.0,
                              repetition_penalty=1.0)
    assert got == greedy
    *streamed, stats = teng.generate_stream_speculative(
        prompt, max_new_tokens=24, draft_k=4)
    assert streamed == got and stats["verify_calls"] == jstats["verify_calls"]
    assert teng.verify_forwards >= 2 * tstats["verify_calls"]


def _server(engine, **kw):
    srv = ChatServer(engine, registry=MetricsRegistry(), num_slots=3,
                     page_size=16, slo=False, watchdog=None, **kw)
    httpd = srv.make_httpd("127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return srv, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def test_micro_batcher_and_speculative_replies_equal_continuous(engines):
    _, teng = engines
    bodies = [{"prompt": "x" * n + "abc", "max_new_tokens": 8,
               "temperature": 0} for n in (3, 30, 70)]
    replies = {}
    for name, kw in (("continuous", {}), ("micro", {"continuous": False})):
        srv, httpd, url = _server(teng, **kw)
        try:
            with ThreadPoolExecutor(len(bodies)) as pool:
                replies[name] = list(pool.map(
                    lambda b: _post(url + "/v1/generate", b), bodies))
            if name == "continuous":
                spec = _post(url + "/v1/generate", {
                    "prompt": "abcabcabcabcabcabc", "max_new_tokens": 12,
                    "temperature": 0, "repetition_penalty": 1.0,
                    "speculative": True})
                plain = _post(url + "/v1/generate", {
                    "prompt": "abcabcabcabcabcabc", "max_new_tokens": 12,
                    "temperature": 0, "repetition_penalty": 1.0})
        finally:
            httpd.shutdown()
            httpd.server_close()
            srv.close()
        assert srv.continuous == (name == "continuous")
    for (c1, b1), (c2, b2) in zip(replies["continuous"], replies["micro"]):
        assert c1 == c2 == 200
        assert (b1["text"], b1["tokens"]) == (b2["text"], b2["tokens"])
    assert spec[0] == 200 and spec[1]["text"] == plain[1]["text"]
    assert spec[1]["speculative"]["verify_calls"] >= 1
