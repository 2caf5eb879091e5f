"""StepwiseDecoder with the radix prefix cache, against the JAX decoder.

Both decoders serve the same weights (a flax init, converted with
convert.params_from_flax) in fp32 on the CPU, with prefill chunks of 32
rows, 16-row pages and a prefix-cache budget small enough to evict. The
same shared-prefix request set goes through both the same way: waves of
admissions (chunked prefill with decode steps interleaved between chunks,
the harvest copies flushed each tick as the scheduler does), greedy decode
to a fixed budget, release. The JAX side runs its 'ragged_xla' backend.

- The greedy tokens are identical, and so are the cache's hits, misses,
  pages spliced, inserts and evictions and each admission's prefix block
  (hit pages, tokens saved, pages harvested).
- Within the port (as the JAX package pins within itself), a lane that
  spliced cached pages decodes bitwise what the same prompt decodes cold:
  the first decode step's logits are equal, and so are the tokens.
- A lane that finishes, is shed or dies mid-prefill unpins its pages
  (release_slot): refcounts return to zero.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from luminaai_tpu.config import Config as JConfig
from luminaai_tpu.data.tokenizer import ConversationTokenizer as JTok
from luminaai_tpu.inference.generate import GenerationEngine as JEngine
from luminaai_tpu.models.transformer import LuminaTransformer as JModel
from luminaai_tpu_torch.config import Config as TConfig
from luminaai_tpu_torch.convert import params_from_flax
from luminaai_tpu_torch.data.tokenizer import ConversationTokenizer as TTok
from luminaai_tpu_torch.inference import generate as tgen
from luminaai_tpu_torch.models.transformer import LuminaTransformer as TModel

ARCH = dict(vocab_size=384, hidden_size=64, num_layers=2, num_heads=2,
            num_kv_heads=1, seq_length=256, intermediate_size=128,
            precision="fp32", max_new_tokens=6, prefill_chunk_size=32)
BUDGET = 6
DEC = dict(num_slots=3, page_size=16, max_slot_tokens=192)


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
    return jeng, tgen.GenerationEngine(tmodel, TTok(), tcfg)


def _prompts(seed=0):
    rng = np.random.RandomState(seed)
    sys_a = [int(t) for t in rng.randint(0, 256, size=53)]
    sys_b = [int(t) for t in rng.randint(0, 256, size=40)]

    def turn(n):
        return [int(t) for t in rng.randint(0, 256, size=n)]

    return [sys_a + turn(20), sys_a + turn(35), sys_a + turn(9),
            sys_b + turn(30), sys_b + turn(12), sys_a + turn(44),
            turn(70), sys_a + turn(27), sys_b + turn(25)]


def _serve(dec, prompts, wave=3):
    """Admit `wave` requests at a time (each prefilled chunk by chunk with
    decode steps of the lanes already admitted in between, harvests
    flushed every tick), decode them to BUDGET tokens, release."""
    tokens, prefixes = [], []
    for w in range(0, len(prompts), wave):
        out, active = {}, []

        def step():
            toks, produced, eos = dec.decode_step()
            dec.flush_harvests()
            for s in active:
                assert not eos[s]
                if produced[s] and len(out[s]) < BUDGET:
                    out[s].append(int(toks[s]))

        for p in prompts[w:w + wave]:
            slot = dec.acquire_slot()
            st = dec.start_prefill(slot, p, max_new_tokens=BUDGET)
            if st is None:
                info = dec.prefill_into_slot(slot, p, max_new_tokens=BUDGET)
            else:
                info = None
                while info is None:
                    if active:
                        step()
                    info = dec.advance_prefill(st)
                    dec.flush_harvests()
            prefixes.append(info.get("prefix"))
            out[slot] = [info["token"]]
            active.append(slot)
        while any(len(t) < BUDGET for t in out.values()):
            step()
        for s in active:
            tokens.append(out[s])
            dec.release_slot(s)
    return tokens, prefixes


CACHE_KEYS = ("hits", "misses", "pages_spliced", "inserts", "evictions",
              "pages_cached", "tokens_saved", "page_refs", "tenants")


def test_prefix_cache_decode_matches_jax(engines):
    jeng, teng = engines
    jdec = jeng.make_stepwise(**DEC, prefix_cache_pages=9)
    tdec = teng.make_stepwise(**DEC, prefix_cache_pages=9)
    assert tdec.total_slots == jdec.total_slots == 4
    prompts = _prompts()
    want, jpre = _serve(jdec, prompts)
    got, tpre = _serve(tdec, prompts)
    assert got == want
    # "remote" (a page pull from another replica) is None without a fleet,
    # on both sides.
    assert all(p["remote"] is None for p in jpre)
    assert tpre == jpre
    js, ts = jdec.prefix_cache.stats(), tdec.prefix_cache.stats()
    assert {k: ts[k] for k in CACHE_KEYS} == {k: js[k] for k in CACHE_KEYS}
    assert ts["hits"] >= 4 and ts["evictions"] > 0
    assert ts["page_refs"] == 0  # every lane unpinned at release
    assert tdec.harvest_flushes == jdec.harvest_flushes
    assert tdec.steps == jdec.steps


def test_cached_decode_equals_cold_bitwise(engines):
    _, teng = engines
    prompts = _prompts(1)
    warm = teng.make_stepwise(**DEC, prefix_cache_pages=12)
    cold = teng.make_stepwise(**DEC)
    for dec in (warm, cold):  # the first request fills the cache
        _serve(dec, prompts[:1])
    lanes = {}
    for name, dec in (("warm", warm), ("cold", cold)):
        slot = dec.acquire_slot()
        st = dec.start_prefill(slot, prompts[1], max_new_tokens=BUDGET)
        info = None
        while info is None:
            info = dec.advance_prefill(st)
        dec.flush_harvests()
        lanes[name] = (dec, slot, info)
    assert lanes["warm"][2]["prefix"]["hit_pages"] == 3
    assert warm._gtable[lanes["warm"][1], 0] >= warm.num_slots * warm.pool.pages
    assert lanes["warm"][2]["token"] == lanes["cold"][2]["token"]
    lw = lanes["warm"][0].step_logits()[lanes["warm"][1]]
    lc = lanes["cold"][0].step_logits()[lanes["cold"][1]]
    assert torch.equal(lw, lc)
    outs = {}
    for name, (dec, slot, info) in lanes.items():
        toks = [info["token"]]
        while len(toks) < BUDGET:
            t, produced, _ = dec.decode_step()
            toks.append(int(t[slot]))
        outs[name] = toks
    assert outs["warm"] == outs["cold"]


def test_release_unpins_mid_prefill_and_waiting_lanes(engines):
    """A lane released mid-prefill drops its pins and its pending claims;
    a follower parked behind it (in-flight dedup) then proceeds."""
    _, teng = engines
    dec = teng.make_stepwise(**DEC, prefix_cache_pages=12)
    p = _prompts(2)
    _serve(dec, p[:1])
    leader = dec.acquire_slot()
    st = dec.start_prefill(leader, p[1][:12] + p[5][12:], max_new_tokens=4)
    assert dec.prefix_cache.stats()["page_refs"] == 3
    follower = dec.acquire_slot()
    st2 = dec.start_prefill(follower, p[1][:12] + p[5][12:] + [7],
                            max_new_tokens=4)
    assert st2.get("waiting")
    assert dec.advance_prefill(st2) is None  # parked behind the leader
    dec.release_slot(leader)
    assert dec.prefix_cache.pending_pages() == 0
    info = None
    while info is None:
        info = dec.advance_prefill(st2)
    assert info["prefix"]["dedup_wait_ticks"] == 2
    dec.release_slot(follower)
    dec.flush_harvests()
    assert dec.prefix_cache.stats()["page_refs"] == 0
    assert st["p0"] == 3
