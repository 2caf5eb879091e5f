"""Cross-replica KV page sharing in the port (serving/page_share.py, the
decoder's remote pull, the export route's core), against the JAX package
where the two can meet.

- Keys: `affinity_key` and `request_prefix_text` equal JAX's over fixed
  prompt, chat and message bodies (NFKC text, short and long prompts,
  prefix budgets).
- Pull inside the port, as the JAX package pins it within itself: a
  replica that pulls another's flushed pages decodes BITWISE like its own
  cold prefill (greedy and seeded); a partial chain extends
  contiguously; dropped pulls and an owner past the deadline degrade to
  local prefill with identical tokens and booked failures; unflushed
  pages are never served; the export core pins pages and refuses queued
  ones.
- Pull across the frameworks: pages a JAX engine computed (weights
  converted by convert.params_from_flax, fp32) are imported into a port
  decoder, whose next-step logits then match its own cold prefill within
  1e-4 of max|logit|.

The decoders serve one flax init in fp32 on the CPU (32-row pages,
32-row prefill chunks); the owner and the puller talk through a loopback
client whose lookup walks the owner's radix index and whose byte fetch
runs the export route's pin -> refuse-unflushed -> export sequence, while
fetch_page (retry, counters, deadline) stays the real code.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from luminaai_tpu.config import Config as JConfig
from luminaai_tpu.data.tokenizer import ConversationTokenizer as JTok
from luminaai_tpu.inference.generate import GenerationEngine as JEngine
from luminaai_tpu.models.transformer import LuminaTransformer as JModel
from luminaai_tpu.serving import page_share as jps
from luminaai_tpu.serving.server import ChatServer as JChatServer
from luminaai_tpu_torch.testing.faults import drop_page_pulls, slow_page_pulls
from luminaai_tpu_torch.config import Config as TConfig
from luminaai_tpu_torch.convert import params_from_flax
from luminaai_tpu_torch.data.tokenizer import ConversationTokenizer as TTok
from luminaai_tpu_torch.inference.generate import GenerationEngine as TEngine
from luminaai_tpu_torch.inference.kv_pool import PAGE_WIRE_MAGIC
from luminaai_tpu_torch.inference.kv_pool import PagedKVPool as TPool
from luminaai_tpu_torch.inference.prefix_cache import page_chain_keys
from luminaai_tpu_torch.models.transformer import LuminaTransformer as TModel
from luminaai_tpu_torch.monitoring.telemetry import MetricsRegistry
from luminaai_tpu_torch.serving import page_share as tps
from luminaai_tpu_torch.serving.server import ChatServer

GREEDY = (0.0, 0, 1.0, 1.0)
SAMPLED = (0.9, 0, 1.0, 1.0)
PS = 32
ARCH = dict(vocab_size=384, hidden_size=64, num_layers=2, num_heads=2,
            num_kv_heads=1, seq_length=256, intermediate_size=128,
            precision="fp32", max_new_tokens=8, prefill_chunk_size=32)
DEC = dict(num_slots=2, page_size=PS, max_slot_tokens=192)

# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------
SYS = {"role": "system", "content": "rules " * 30}
BODIES = {
    "short_prompt": {"prompt": "p7"},
    "block_prompt": {"prompt": "s" * 128 + "tail one"},
    "long_prompt": {"prompt": "the quick brown fox " * 40},
    "nfkc_prompt": {"prompt": "ﬁne ＡＢＣ ①" * 20},
    "chat": {"messages": [SYS, {"role": "user", "content": "hi"}]},
    "chat_other_turn": {"messages": [SYS, {"role": "user", "content": "x"}]},
    "message": {"message": "hello there " * 10},
    "non_str_prompt": {"prompt": 12345},
    "empty": {},
    "empty_messages": {"messages": [], "message": "fallback"},
}


@pytest.mark.parametrize("name", sorted(BODIES))
def test_affinity_key_matches_jax(name):
    body = BODIES[name]
    assert tps.AFFINITY_BLOCK_CHARS == jps.AFFINITY_BLOCK_CHARS
    assert tps.MAX_PAGE_PAYLOAD_BYTES == jps.MAX_PAGE_PAYLOAD_BYTES
    assert tps.request_prefix_text(body) == jps.request_prefix_text(body)
    for path in ("/v1/generate", "/v1/chat"):
        for chars in (0, 64, 100, 256, 1000):
            assert (tps.affinity_key(path, body, chars)
                    == jps.affinity_key(path, body, chars)), (path, chars)


# ---------------------------------------------------------------------------
# engines and the loopback client
# ---------------------------------------------------------------------------
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
        jmodel.init(jax.random.key(0), jnp.ones((1, 8), jnp.int32))["params"]
    )
    jeng = JEngine(jmodel, params, JTok(), jcfg)
    tcfg = TConfig(**ARCH)
    tmodel = TModel(tcfg, device="cpu").load_params(
        params_from_flax(jax.device_get(params), tcfg))
    return jeng, TEngine(tmodel, TTok(), tcfg)


def _mk(engine, cache_pages=6):
    return engine.make_stepwise(**DEC, prefix_cache_pages=cache_pages)


def _prompt(seed, n):
    rng = np.random.RandomState(seed)
    return [int(t) for t in rng.randint(0, 256, size=n)]


def _drive(dec, prompt, budget, seed=0, sample_key=None):
    s = dec.acquire_slot()
    st = dec.start_prefill(s, prompt, max_new_tokens=budget,
                           sample_key=sample_key, seed=seed)
    if st is None:
        info = dec.prefill_into_slot(s, prompt, max_new_tokens=budget,
                                     sample_key=sample_key, seed=seed)
    else:
        info = None
        while info is None:
            info = dec.advance_prefill(st)
    out = [] if info["token"] is None else [info["token"]]
    while dec._active[s] and len(out) < budget:
        toks, produced, eos = dec.decode_step(sample_key)
        if eos[s]:
            break
        if produced[s]:
            out.append(int(toks[s]))
    dec.release_slot(s)
    return out, info


class LoopbackClient(tps.PageShareClient):
    """The port's PageShareClient with its router and owner conversations
    short-circuited into an in-process owner decoder (the port's or the
    JAX package's): lookup walks the owner's radix index; get_bytes runs
    that package's export route core (ChatServer.export_page_by_key)."""

    OWNER_URL = "http://owner:1"

    def __init__(self, owner_dec, **kw):
        kw.setdefault("timeout_s", 10.0)
        super().__init__(router_url="http://router:0",
                         self_url="http://me:2", **kw)
        self.owner_dec = owner_dec
        self.fetches = 0

    def lookup(self, keys, have=0):
        cache = self.owner_dec.prefix_cache
        owned = []
        for k in keys:
            if k not in cache._index:
                break
            owned.append(k)
        if len(owned) <= have:
            return None, []
        return self.OWNER_URL, owned

    def get_bytes(self, base_url, path, timeout_s=None):
        self.fetches += 1
        key = path.rsplit("/", 1)[1]
        dec = self.owner_dec
        # The owner package's own export route core (pin, refuse
        # unwritten pages, export, unpin), as GET /pages/<key> runs it.
        server = ChatServer if isinstance(dec.pool, TPool) else JChatServer
        payload = server.export_page_by_key(
            SimpleNamespace(batcher=SimpleNamespace(decoder=dec)), key)
        return (404, b"") if payload is None else (200, payload)


def _metric(registry, prefix):
    for line in registry.render_prometheus().splitlines():
        if line.startswith(prefix):
            return float(line.rsplit(" ", 1)[1])
    return None


# ---------------------------------------------------------------------------
# pull inside the port
# ---------------------------------------------------------------------------
def test_remote_pull_decode_bitwise_vs_cold(engines):
    """Replica B, cold, pulls replica A's flushed pages and decodes exactly
    what its own cold prefill decodes, greedy and seeded; a repeat
    admission hits locally (one pull per chain), and B then advertises
    the pulled keys."""
    teng = engines[1]
    cold, dec_a, dec_b = _mk(teng, 0), _mk(teng), _mk(teng)
    registry = MetricsRegistry()
    dec_b.page_share = LoopbackClient(dec_a, registry=registry)
    pulled_total = 0
    for i, key in enumerate((GREEDY, SAMPLED)):
        prompt = _prompt(10 + i, 96) + _prompt(20 + i, 9)
        want, _ = _drive(cold, prompt, 8, seed=11, sample_key=key)
        _drive(dec_a, prompt, 8, seed=11, sample_key=key)  # A computes
        dec_a.flush_harvests()  # A's pages land (exportable)
        got, info = _drive(dec_b, prompt, 8, seed=11, sample_key=key)
        assert got == want, key
        prefix, remote = info["prefix"], info["prefix"]["remote"]
        npages = (len(prompt) - 1) // PS
        pulled_total += npages
        assert remote["pulled"] == npages and not remote["failed"]
        assert remote["owner"] == LoopbackClient.OWNER_URL
        assert remote["tokens"] == npages * PS
        assert remote["bytes"] == npages * len(dec_a.pool.export_page(0))
        assert prefix["hit_pages"] == npages
        assert prefix["tokens_saved"] == npages * PS
        assert dec_b.remote_hits == i + 1
        assert dec_b.remote_pull_failures == 0
        assert _metric(registry,
                       "serve_prefix_remote_pulls_total") == pulled_total
        assert _metric(registry, "serve_page_transfer_bytes_total") > 0
        fetches = dec_b.page_share.fetches
        got2, info2 = _drive(dec_b, prompt, 8, seed=11, sample_key=key)
        assert got2 == want
        assert info2["prefix"]["hit_pages"] == npages
        assert info2["prefix"]["remote"] is None
        assert dec_b.page_share.fetches == fetches
        assert set(dec_b.drain_landed_keys()) == set(
            page_chain_keys(prompt, PS, npages))
        # The pulled arena pages hold A's bytes exactly.
        for k in page_chain_keys(prompt, PS, npages):
            pa = dec_a.prefix_cache.pin_key(k)
            pb = dec_b.prefix_cache.pin_key(k)
            assert dec_b.pool.export_page(pb) == dec_a.pool.export_page(pa)
            dec_a.prefix_cache.release([pa])
            dec_b.prefix_cache.release([pb])


def test_remote_pull_int8_decode_bitwise_vs_cold(engines):
    """The same with int8 KV caches (JAX tests/test_page_share.py:231
    parametrises kv_dtype): a page carries each layer's k codes, k scales,
    v codes and v scales, and B's pulled decode equals its cold one
    bitwise."""
    teng = engines[1]
    i8 = TEngine(teng.model, teng.tokenizer,
                 TConfig(**ARCH, kv_cache_dtype="int8"))
    cold, dec_a, dec_b = _mk(i8, 0), _mk(i8), _mk(i8)
    dec_b.page_share = LoopbackClient(dec_a)
    prompt = _prompt(12, 96) + _prompt(22, 9)
    want, _ = _drive(cold, prompt, 8, seed=11)
    _drive(dec_a, prompt, 8, seed=11)
    dec_a.flush_harvests()
    got, info = _drive(dec_b, prompt, 8, seed=11)
    assert got == want
    npages = (len(prompt) - 1) // PS
    page = dec_a.pool.export_page(0)
    assert info["prefix"]["remote"]["pulled"] == npages
    assert info["prefix"]["remote"]["bytes"] == npages * len(page)
    from luminaai_tpu_torch.inference.kv_pool import parse_page_payload

    leaves = parse_page_payload(page)
    assert [x.dtype for x in leaves] == [torch.int8, torch.float32] * (
        2 * ARCH["num_layers"])
    for k in page_chain_keys(prompt, PS, npages):
        pa = dec_a.prefix_cache.pin_key(k)
        pb = dec_b.prefix_cache.pin_key(k)
        assert dec_b.pool.export_page(pb) == dec_a.pool.export_page(pa)
        dec_a.prefix_cache.release([pa])
        dec_b.prefix_cache.release([pb])


def test_partial_remote_chain_extends_contiguously(engines):
    """B holds the first page locally (have > 0): the pull fetches only
    the owner's extension and the admission splices both."""
    teng = engines[1]
    shared = _prompt(30, 96)
    p_short, p_full = shared[:40], shared + _prompt(31, 5)
    want, _ = _drive(_mk(teng, 0), p_full, 6)
    dec_a = _mk(teng)
    _drive(dec_a, p_full, 6)
    dec_a.flush_harvests()
    dec_b = _mk(teng)
    _drive(dec_b, p_short, 6)  # page 0 resident locally
    dec_b.flush_harvests()
    dec_b.page_share = LoopbackClient(dec_a)
    got, info = _drive(dec_b, p_full, 6)
    assert got == want
    npages = (len(p_full) - 1) // PS
    assert info["prefix"]["hit_pages"] == npages
    assert info["prefix"]["remote"]["pulled"] == npages - 1  # not page 0


def _owner_and_cold(teng, prompt, budget):
    want, _ = _drive(_mk(teng, 0), prompt, budget)
    dec_a = _mk(teng)
    _drive(dec_a, prompt, budget)
    dec_a.flush_harvests()
    return want, dec_a


def test_dropped_pulls_degrade_to_local_prefill(engines):
    teng = engines[1]
    prompt = _prompt(40, 96)
    want, dec_a = _owner_and_cold(teng, prompt, 8)
    dec_b = _mk(teng)
    registry = MetricsRegistry()
    client = LoopbackClient(dec_a, registry=registry)
    dec_b.page_share = client
    with drop_page_pulls(client) as stats:
        got, info = _drive(dec_b, prompt, 8)
    assert got == want
    assert stats["dropped"] >= 1
    assert dec_b.remote_pull_failures == 1 and dec_b.remote_hits == 0
    assert info["prefix"]["remote"]["failed"]
    assert info["prefix"]["remote"]["pulled"] == 0
    assert _metric(registry, "serve_prefix_remote_pull_failures_total") >= 1
    # The failed admission computed its own pages: the next one hits.
    got2, info2 = _drive(dec_b, prompt, 8)
    assert got2 == want and info2["prefix"]["hit_pages"] >= 1


def test_slow_owner_hits_deadline_and_keeps_partial_prefix(engines):
    """Every fetch stalls past the pull deadline: at most one page lands,
    the imported prefix stays, the tail is recomputed, the tokens are
    still exact."""
    teng = engines[1]
    prompt = _prompt(50, 96)
    want, dec_a = _owner_and_cold(teng, prompt, 8)
    dec_b = _mk(teng)
    client = LoopbackClient(dec_a, timeout_s=0.25)
    dec_b.page_share = client
    with slow_page_pulls(client, delay_s=0.3) as stats:
        got, info = _drive(dec_b, prompt, 8)
    assert got == want
    assert stats["calls"] >= 1
    remote = info["prefix"]["remote"]
    assert remote["failed"] and remote["pulled"] < (len(prompt) - 1) // PS
    assert dec_b.remote_pull_failures == 1


def test_unflushed_owner_pages_are_never_served(engines):
    """A has inserted its pages but not flushed the harvest copy: the
    export refuses, and B prefills locally instead of splicing garbage."""
    teng = engines[1]
    prompt = _prompt(60, 80)
    want, _ = _drive(_mk(teng, 0), prompt, 6)
    dec_a = _mk(teng)
    _drive(dec_a, prompt, 6)
    assert dec_a._harvest_queue  # the copy is still queued
    dec_b = _mk(teng)
    dec_b.page_share = LoopbackClient(dec_a)
    got, _ = _drive(dec_b, prompt, 6)
    assert got == want
    assert dec_b.remote_hits == 0 and dec_b.remote_pull_failures == 1


def test_export_route_core_pins_and_refuses_queued_pages(engines):
    """ChatServer.export_page_by_key without HTTP: a queued page and an
    unknown key answer None, a flushed page round-trips byte for byte,
    and the pin is always released."""
    teng = engines[1]
    prompt = _prompt(70, 80)
    dec = _mk(teng)
    _drive(dec, prompt, 6)
    chain = page_chain_keys(prompt, PS, (len(prompt) - 1) // PS)
    fake = SimpleNamespace(batcher=SimpleNamespace(decoder=dec))
    assert ChatServer.export_page_by_key(fake, chain[0]) is None  # queued
    dec.flush_harvests()
    payload = ChatServer.export_page_by_key(fake, chain[0])
    assert payload is not None and payload[:4] == PAGE_WIRE_MAGIC
    assert dec.prefix_cache.page_refs() == 0
    assert ChatServer.export_page_by_key(fake, "ab" * 32) is None
    dec2 = _mk(teng)
    assert dec2.pool.import_page(0, payload) == len(payload)
    assert dec2.pool.export_page(0) == payload
    # No prefix cache: nothing is servable.
    nocache = SimpleNamespace(batcher=SimpleNamespace(decoder=_mk(teng, 0)))
    assert ChatServer.export_page_by_key(nocache, chain[0]) is None


# ---------------------------------------------------------------------------
# pull across the frameworks
# ---------------------------------------------------------------------------
TOL = 1e-4  # of max|logit|: fp32 K/V from XLA vs the port's own prefill


def test_pages_pulled_from_jax_decode_within_tolerance(engines):
    jeng, teng = engines
    prompt = _prompt(80, 100) + _prompt(81, 7)
    jdec = jeng.make_stepwise(**DEC, prefix_cache_pages=6)
    _drive(jdec, prompt, 4)
    jdec.flush_harvests()

    def admit(dec):
        s = dec.acquire_slot()
        st = dec.start_prefill(s, prompt, max_new_tokens=4)
        info = None
        while info is None:
            info = dec.advance_prefill(st)
        return s, info, dec.step_logits()[s].clone()

    cold = _mk(teng)
    s_cold, info_cold, want = admit(cold)
    dec_b = _mk(teng)
    dec_b.page_share = LoopbackClient(jdec)
    s_b, info_b, got = admit(dec_b)
    npages = (len(prompt) - 1) // PS
    assert info_b["prefix"]["remote"]["pulled"] == npages
    assert info_b["prefix"]["hit_pages"] == npages
    assert info_b["token"] == info_cold["token"]
    err = float((got - want).abs().max())
    assert err <= TOL * float(want.abs().max()), err
    assert torch.equal(got.argmax(), want.argmax())
