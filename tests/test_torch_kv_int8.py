"""The int8 KV cache (config.kv_cache_dtype='int8'), the port against the JAX
package and within itself.

Both engines serve one flax init in fp32 on the CPU with int8 caches:
codes [.., C, Hkv, D] and fp32 scales [.., C, Hkv, 1] per side, fresh
rows quantized at insert per row and kv head over head_dim (JAX
models/layers.py:400-431).

- The step-wise decoder's greedy tokens equal the JAX int8 decoder's,
  and the rows it stored equal JAX's codes and scales: scales within 1e-5
  relative, codes within one step on at most 1% of entries. (The fp32 K/V
  rows differ from XLA's in the last ulp, and quantize_act flips a code
  whose value lands within an ulp of a .5 boundary: one scale step of
  one element.)
- The plain version of B5-int8 (what the CPU runs and the card's kernel is
  held against) equals the reference over the fully dequantized pool
  bitwise, though it dequantizes only the rows it reads: local and
  global tables, a resident extent, a window, prefill positions.
- Within the port, as the JAX package pins it for bf16: a prefix hit's
  first int8 decode step equals the cold one's bitwise, and speculative
  decoding (multi-row int8 writes) returns greedy's tokens and JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.linen import meta as flax_meta

from luminaai_tpu.config import Config as JConfig
from luminaai_tpu.data.tokenizer import ConversationTokenizer as JTok
from luminaai_tpu.inference import generate as jgen
from luminaai_tpu.models.transformer import LuminaTransformer as JModel
from luminaai_tpu_torch.config import Config as TConfig
from luminaai_tpu_torch.convert import params_from_flax
from luminaai_tpu_torch.data.tokenizer import ConversationTokenizer as TTok
from luminaai_tpu_torch.inference import generate as tgen
from luminaai_tpu_torch.inference.kv_pool import cache_leaves
from luminaai_tpu_torch.models.transformer import LuminaTransformer as TModel
from luminaai_tpu_torch.ops import ragged_paged_attention as rpa
from luminaai_tpu_torch.ops.quantized import quantize_act

ARCH = dict(vocab_size=384, hidden_size=64, num_layers=2, num_heads=2,
            num_kv_heads=1, seq_length=256, intermediate_size=128,
            precision="fp32", max_new_tokens=12, prefill_chunk_size=32,
            temperature=0.0, repetition_penalty=1.0, kv_cache_dtype="int8")
DEC = dict(num_slots=3, page_size=16, max_slot_tokens=192)
BUDGET = 10


@pytest.fixture(scope="module")
def engines():
    jcfg = JConfig(**ARCH, use_flash_attention=False,
                   gradient_checkpointing=False,
                   attention_backend="ragged_xla")
    jmodel = JModel(jcfg)
    params = flax_meta.unbox(jax.jit(jmodel.init)(
        jax.random.key(0), jnp.ones((1, 8), jnp.int32))["params"])
    tcfg = TConfig(**ARCH)
    tmodel = TModel(tcfg, device="cpu").load_params(
        params_from_flax(jax.device_get(params), tcfg))
    return (jgen.GenerationEngine(jmodel, params, JTok(), jcfg),
            tgen.GenerationEngine(tmodel, TTok(), tcfg))


def _prompt(seed, n):
    return [int(t) for t in np.random.RandomState(seed).randint(0, 256, n)]


def _admit(dec, prompt):
    slot = dec.acquire_slot()
    st = dec.start_prefill(slot, prompt, max_new_tokens=BUDGET)
    if st is None:
        return slot, dec.prefill_into_slot(slot, prompt,
                                           max_new_tokens=BUDGET)
    info = None
    while info is None:
        info = dec.advance_prefill(st)
    dec.flush_harvests()
    return slot, info


def _decode(dec, slots_infos):
    out = {s: [info["token"]] for s, info in slots_infos}
    while any(len(t) < BUDGET for t in out.values()):
        toks, produced, eos = dec.decode_step()
        for s in out:
            assert not eos[s]
            if produced[s] and len(out[s]) < BUDGET:
                out[s].append(int(toks[s]))
    return [out[s] for s, _ in slots_infos]


def test_int8_decoder_matches_jax(engines):
    jeng, teng = engines
    jdec, tdec = jeng.make_stepwise(**DEC), teng.make_stepwise(**DEC)
    prompts = [_prompt(1, 12), _prompt(2, 70), _prompt(3, 45)]
    jadm = [_admit(jdec, p) for p in prompts]
    tadm = [_admit(tdec, p) for p in prompts]
    # The stored rows: int8 codes and fp32 scales, JAX's up to code flips.
    leaves_t = cache_leaves(tdec.pool.caches)
    leaves_j = jax.tree.leaves(jdec.pool.caches)
    assert [tuple(t.shape) for t in leaves_t] == [
        tuple(j.shape) for j in leaves_j]
    assert [t.dtype for t in leaves_t] == [torch.int8, torch.float32] * 4
    for s, (_, info) in enumerate(tadm):
        n = info["prompt_tokens"]
        for t, j in zip(leaves_t, leaves_j):
            flat = (t.shape[0], -1, *t.shape[3:])  # [slots, C, Hkv, D|1]
            a = t.reshape(flat)[s, :n].numpy()
            b = np.asarray(j).reshape(flat)[s, :n]
            if t.dtype == torch.int8:
                diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5)
    assert _decode(tdec, tadm) == _decode(jdec, jadm)


def _pools(seed=0, T=3, P=4, ps=8, hkv=2, d=64, hq=4):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(T, 1, hq, d, generator=g)
    k = quantize_act(torch.randn(T, P * ps, hkv, d, generator=g))
    v = quantize_act(torch.randn(T, P * ps, hkv, d, generator=g))
    return q, k, v


@pytest.mark.parametrize("case", ["extent", "window", "local_table",
                                  "global", "prefill"])
def test_plain_int8_equals_dequantized_reference(case):
    q, k, v = _pools()
    lengths = torch.tensor([5, 17, 9], dtype=torch.int32)
    meta = rpa.LaneMeta(lengths=lengths, page_size=8)
    positions = None
    if case == "extent":
        meta.extent = 24
    elif case == "window":
        meta.window = 6
    elif case == "local_table":
        meta.page_table = torch.tensor([[2, 0, 1, 3], [1, 3, 0, 2],
                                        [3, 2, 1, 0]], dtype=torch.int32)
        meta.identity_pages = False
    elif case == "global":
        meta.page_table = torch.tensor([[7, 1, 2, 3], [7, 5, 6, 0],
                                        [7, 9, 10, 4]], dtype=torch.int32)
        meta.global_pages, meta.identity_pages, meta.extent = True, False, 24
    else:
        q = torch.randn(q.shape[0], 4, q.shape[2], q.shape[3])
        positions = torch.tensor([[1, 2, 3, 4], [14, 15, 16, -1],
                                  [5, 6, 7, 8]])
        meta.lengths = positions.max(1).values.to(torch.int32) + 1
    got = rpa.paged_attention(q, k, v, meta, backend="plain",
                              positions=positions)
    want = rpa.ragged_paged_attention_ref(
        q, rpa.dequantize_kv(k, q.dtype), rpa.dequantize_kv(v, q.dtype),
        meta, positions=positions)
    assert torch.equal(got, want)
    if positions is None:  # the decode wrapper takes the same path
        assert torch.equal(rpa.ragged_paged_attention(q, k, v, meta), want)


def test_int8_prefix_hit_first_decode_equals_cold_bitwise(engines):
    _, teng = engines
    shared = _prompt(7, 53)
    first, second = shared + _prompt(8, 20), shared + _prompt(9, 11)
    warm = teng.make_stepwise(**DEC, prefix_cache_pages=12)
    cold = teng.make_stepwise(**DEC)
    s0, _ = _admit(warm, first)
    warm.release_slot(s0)
    sw, iw = _admit(warm, second)
    sc, ic = _admit(cold, second)
    assert iw["prefix"]["hit_pages"] == 3
    assert iw["token"] == ic["token"]
    lw, lc = warm.step_logits()[sw], cold.step_logits()[sc]
    assert torch.equal(lw, lc)
    assert _decode(warm, [(sw, iw)]) == _decode(cold, [(sc, ic)])


def test_speculative_int8_equals_greedy_and_jax(engines):
    jeng, teng = engines
    motif = _prompt(11, 7)
    prompt = (motif * 9)[:60]
    got, tstats = teng.generate_speculative(prompt, max_new_tokens=20,
                                            draft_k=4)
    greedy, _ = teng.generate(prompt, max_new_tokens=20, temperature=0.0,
                              repetition_penalty=1.0)
    assert got == greedy and tstats["verify_calls"] >= 1
    want, jstats = jeng.generate_speculative(prompt, max_new_tokens=20,
                                             draft_k=4)
    assert got == want
    assert tstats["verify_calls"] == jstats["verify_calls"]
