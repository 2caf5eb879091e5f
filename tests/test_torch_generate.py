"""The port's StepwiseDecoder against the JAX StepwiseDecoder, token for token.

Both decoders serve the same weights (a flax init, converted with
convert.params_from_flax) in fp32 on the CPU, and both are driven through
the same sequence of scheduler calls: a short prompt through
prefill_into_slot, two longer ones through chunked prefill
(start_prefill / advance_prefill) with decode steps interleaved between
chunks, then batched decode steps. Greedy decoding has no randomness, so
the tokens must be identical: 3 requests x 12 tokens, for the dense model
and for an MoE model (sort and gmm dispatch). The JAX side runs its
'ragged_xla' backend (the Pallas kernel's parity with the port's
plain version is tests/test_torch_ragged_attention.py's job).
"""

import numpy as np
import pytest

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

ARCH = dict(vocab_size=384, hidden_size=128, num_layers=2, num_heads=2,
            num_kv_heads=1, seq_length=256, intermediate_size=192,
            precision="fp32", max_new_tokens=12, prefill_chunk_size=32)
BUDGET = 12


def _unbox(params):
    from flax import linen as nn

    return jax.tree.map(
        lambda x: x.unbox() if isinstance(x, nn.meta.AxisMetadata) else x,
        params, is_leaf=lambda x: isinstance(x, nn.meta.AxisMetadata),
    )


@pytest.fixture(scope="module")
def decoders():
    jcfg = JConfig(**ARCH, use_flash_attention=False,
                   gradient_checkpointing=False,
                   attention_backend="ragged_xla")
    jmodel = JModel(jcfg)
    params = _unbox(
        jmodel.init(jax.random.key(0), jnp.ones((1, 8), jnp.int32))["params"]
    )
    jdec = JEngine(jmodel, params, JTok(), jcfg).make_stepwise(
        num_slots=3, page_size=16, max_slot_tokens=192
    )
    tcfg = TConfig(**ARCH)
    tmodel = TModel(tcfg, device="cpu").load_params(
        params_from_flax(jax.device_get(params), tcfg)
    )
    tdec = tgen.GenerationEngine(tmodel, TTok(), tcfg).make_stepwise(
        num_slots=3, page_size=16, max_slot_tokens=192
    )
    return jdec, tdec


def _serve(dec, prompts):
    """Admit the prompts the way the scheduler does (chunks interleaved
    with decode steps), decode until every request has BUDGET tokens."""
    out = {}
    active = []

    def step():
        toks, produced, eos = dec.decode_step()
        for s in active:
            assert not eos[s]
            if produced[s] and len(out[s]) < BUDGET:
                out[s].append(int(toks[s]))

    paths = []
    for p in prompts:
        slot = dec.acquire_slot()
        st = dec.start_prefill(slot, p, max_new_tokens=BUDGET)
        if st is None:
            info = dec.prefill_into_slot(slot, p, max_new_tokens=BUDGET)
            paths.append("whole")
        else:
            paths.append("chunked")
            info = None
            while info is None:
                if active:
                    step()  # lanes already admitted keep decoding
                info = dec.advance_prefill(st)
        out[slot] = [info["token"]]
        active.append(slot)
    while any(len(t) < BUDGET for t in out.values()):
        step()
    return [out[s] for s in sorted(out)], paths


def test_greedy_tokens_identical_to_jax_decoder(decoders):
    jdec, tdec = decoders
    rng = np.random.RandomState(0)
    prompts = [list(rng.randint(0, 256, size=n)) for n in (20, 70, 100)]
    want, jpaths = _serve(jdec, prompts)
    got, tpaths = _serve(tdec, prompts)
    assert jpaths == tpaths == ["whole", "chunked", "chunked"]
    assert [len(t) for t in got] == [BUDGET] * 3
    assert got == want
    assert tdec.steps == jdec.steps
    for s in range(3):
        tdec.release_slot(s)
        jdec.release_slot(s)


@pytest.mark.parametrize("dispatch", ["sort", "gmm"])
def test_moe_greedy_tokens_identical_to_jax_decoder(dispatch):
    """An MoE model (4 experts, top-2 in both layers, no routing noise)
    served through both decoders the same way: the bucketed prefill pads
    with the same ids to the same bucket (padding positions take capacity
    in the prompt's routing group, as in the JAX model), chunked prefill
    routes per chunk, and decode routes each lane as its own group (S = 1,
    capacity 1). Greedy tokens must be identical."""
    kw = dict(ARCH, use_moe=True, num_experts=4, moe_top_k=2,
              routing_noise_std=0.0, moe_dispatch=dispatch)
    jcfg = JConfig(**kw, use_flash_attention=False,
                   gradient_checkpointing=False, scan_layers=False,
                   attention_backend="ragged_xla")
    jmodel = JModel(jcfg)
    params = _unbox(jax.jit(jmodel.init)(
        jax.random.key(2), jnp.ones((1, 8), jnp.int32))["params"])
    jdec = JEngine(jmodel, params, JTok(), jcfg).make_stepwise(
        num_slots=3, page_size=16, max_slot_tokens=192)
    tcfg = TConfig(**kw)
    tmodel = TModel(tcfg, device="cpu").load_params(
        params_from_flax(jax.device_get(params), tcfg))
    tdec = tgen.GenerationEngine(tmodel, TTok(), tcfg).make_stepwise(
        num_slots=3, page_size=16, max_slot_tokens=192)
    rng = np.random.RandomState(3)
    prompts = [list(rng.randint(0, 256, size=n)) for n in (20, 70, 100)]
    want, jpaths = _serve(jdec, prompts)
    got, tpaths = _serve(tdec, prompts)
    assert jpaths == tpaths == ["whole", "chunked", "chunked"]
    assert got == want
    assert tdec.steps == jdec.steps


def test_samplers_match_jax_filters():
    """Repetition penalty, top-k and top-p filter the same logits as the
    JAX samplers; greedy picks the same argmax. The JAX filters take one
    lane's row (its decoder vmaps them over lanes); the port's take the
    [lanes, V] batch, so the JAX side is vmapped here."""
    import torch

    from luminaai_tpu.inference import generate as jgen

    rng = np.random.RandomState(1)
    logits = rng.randn(3, 50).astype(np.float32) * 3
    counts = (rng.rand(3, 50) < 0.2).astype(np.int32)
    tl, tc = torch.as_tensor(logits), torch.as_tensor(counts)
    jl_, jc = jnp.asarray(logits), jnp.asarray(counts)
    np.testing.assert_allclose(
        tgen.apply_repetition_penalty(tl, tc, 1.3).numpy(),
        np.asarray(jgen.apply_repetition_penalty(jl_, jc, 1.3)), rtol=1e-6,
    )
    np.testing.assert_array_equal(
        tgen.apply_top_k(tl, 7).numpy(),
        np.asarray(jax.vmap(lambda r: jgen.apply_top_k(r, 7))(jl_)),
    )
    np.testing.assert_array_equal(
        tgen.apply_top_p(tl, 0.8).numpy(),
        np.asarray(jax.vmap(lambda r: jgen.apply_top_p(r, 0.8))(jl_)),
    )
    greedy = tgen.sample_token(
        tl, tc, [], temperature=0.0, top_k=0, top_p=1.0,
        repetition_penalty=1.0,
    )
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))
    gens = [torch.Generator().manual_seed(5) for _ in range(3)]
    sampled = tgen.sample_token(
        tl, tc, gens, temperature=0.7, top_k=5, top_p=0.9,
        repetition_penalty=1.1,
    )
    kept = tgen.apply_top_p(tgen.apply_top_k(tl / 0.7, 5), 0.9) > -1e29
    assert all(kept[i, int(t)] for i, t in enumerate(sampled))


def test_bucket_len_matches_jax():
    from luminaai_tpu.inference.generate import _bucket_len

    for n in (1, 63, 64, 65, 300, 2048):
        assert tgen._bucket_len(n) == _bucket_len(n)


def test_tokenizer_and_chat_prompt_match_jax():
    """The byte tokenizer's ids, specials and decode, and encode_chat's
    ChatML prompt, are the JAX package's for the same text."""
    from types import SimpleNamespace

    jt, tt = JTok(), TTok()
    assert tt.vocab_size == jt.vocab_size
    assert tt.special_tokens == jt.special_tokens
    assert (tt.eos_token_id, tt.pad_token_id, tt.im_start, tt.im_end) == (
        jt.eos_token_id, jt.pad_token_id, jt.im_start, jt.im_end
    )
    text = "héllo, wörld ✓"
    assert tt.encode_text(text) == jt.encode_text(text)
    ids = [jt.im_start] + jt.encode_text(text) + [jt.im_end, 300]
    for skip in (True, False):
        assert tt.decode(ids, skip_special_tokens=skip) == jt.decode(
            ids, skip_special_tokens=skip
        )
    msgs = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": text},
            {"role": "assistant", "content": "ok"},
            {"role": "mystery", "content": "?"}]
    assert tgen.GenerationEngine.encode_chat(
        SimpleNamespace(tokenizer=tt), msgs
    ) == JEngine.encode_chat(SimpleNamespace(tokenizer=jt), msgs)
