"""The rolling window KV cache and scalar-offset decode, the port against JAX.

Under config.attention_window, with max_len <= seq_length, JAX's
init_cache allocates C = min(max_len, ceil(window / 128) * 128) slots:
slot pos % C holds the freshest row of its residue class, a prefill
keeps its last C live rows and attends its raw rows, decode and the
speculative verify read the cache through the slot mask
(luminaai_tpu/models/layers.py:307-470, :693-707). The JAX engine's
single-request paths pass a scalar cache_index; its generate_batch is a
vmap of them, so every lane rolls on its own.

Both sides build the same flax init in fp32 on the CPU: 2 layers, hidden
64, 4 q over 2 kv heads, seq_length 256, windows 40 and 120 (C = 128, so
a 200-token prompt wraps). Held:
- init_cache shapes (bf16 and int8, rolling and not) equal JAX's;
- the cache slots after a 200-token prefill and after decoding past it
  within 1e-5 relative, and every step's logits within 1e-5 x max|logit|
  (teacher-forced on JAX's greedy tokens);
- the tokens of generate, generate_batch (ragged prompts) and
  generate_speculative, whose verify_calls equal JAX's: with draft_k 16
  the draft is capped at C - window + 1 (9 at window 120);
- int8 KV: the codes of a rolling prefill equal JAX's, scales within
  1e-6 relative;
- a k-row update without slack raises ValueError on both sides, and
  speculation at window 128 (no slack) falls back to the greedy stream;
- without a window, a scalar and a [1] offset give identical logits.
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
from luminaai_tpu_torch.inference.generate import GenerationEngine as TEngine
from luminaai_tpu_torch.models.transformer import LuminaTransformer as TModel

ARCH = dict(vocab_size=384, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, seq_length=256, intermediate_size=128,
            precision="fp32", max_new_tokens=24, use_moe=False)
PROMPT = 200
STEPS = 16


def _unbox(params):
    from flax import linen as nn

    return jax.tree.map(
        lambda x: x.unbox() if isinstance(x, nn.meta.AxisMetadata) else x,
        params, is_leaf=lambda x: isinstance(x, nn.meta.AxisMetadata),
    )


_PAIRS = {}


def _pair(window, kv=None):
    """(JAX engine, port engine) over one flax init."""
    key = (window, kv)
    if key not in _PAIRS:
        kw = dict(ARCH, attention_window=window)
        if kv:
            kw["kv_cache_dtype"] = kv
        jcfg = JConfig(**kw, use_flash_attention=False,
                       gradient_checkpointing=False)
        jmodel = JModel(jcfg)
        params = _unbox(jmodel.init(jax.random.key(0),
                                    jnp.ones((1, 8), jnp.int32))["params"])
        tcfg = TConfig(**kw, use_flash_attention=False)
        tmodel = TModel(tcfg, device="cpu").load_params(
            params_from_flax(jax.device_get(params), tcfg))
        _PAIRS[key] = (JEngine(jmodel, params, JTok(), jcfg),
                       TEngine(tmodel, TTok(), tcfg))
    return _PAIRS[key]


def _prompt(n, seed=0, period=None):
    rng = np.random.RandomState(seed)
    if period:  # repetitive text: prompt lookup finds drafts
        base = list(rng.randint(3, 300, size=period))
        return (base * (n // period + 1))[:n]
    return list(rng.randint(3, 300, size=n))


def _leaves(caches):
    out = []
    for layer in caches:
        for side in layer:
            out += list(side) if isinstance(side, tuple) else [side]
    return [np.asarray(t.detach().numpy() if torch.is_tensor(t) else t)
            for t in out]


def _close(a, b, rtol):
    scale = max(float(np.abs(a).max()), 1e-30)
    assert float(np.abs(a - b).max()) <= rtol * scale, (
        float(np.abs(a - b).max()), scale)


@pytest.mark.parametrize("window", [None, 40, 120])
@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("rolling", [True, False])
def test_init_cache_shapes_equal_jax(window, kv, rolling):
    jeng, teng = _pair(window)
    for max_len in (256, 100, 300):
        jc = jeng.model.init_cache(2, max_len, kv_cache_dtype=kv,
                                   rolling=rolling)
        tc = teng.model.init_cache(2, max_len, kv_cache_dtype=kv,
                                   rolling=rolling)
        assert [x.shape for x in _leaves(jc)] == [
            tuple(x.shape) for x in _leaves(tc)]
        assert [str(x.dtype) for x in _leaves(jc)] == [
            str(x.dtype) for x in _leaves(tc)]
    rows = teng.model.init_cache(1, 256, rolling=rolling)[0][0].shape[1]
    assert rows == (128 if window is not None and rolling else 256)


def _jax_prefill(jeng, prompt):
    bucket = 256
    ids = np.zeros((1, bucket), np.int32)
    ids[0, :len(prompt)] = prompt
    logits, caches = jeng._prefill_fn(bucket)(
        jeng.params, jnp.asarray(ids), jnp.asarray(len(prompt), jnp.int32))
    return np.asarray(logits), caches


def _port_prefill(teng, prompt):
    ids = np.zeros((1, 256), np.int64)
    ids[0, :len(prompt)] = prompt
    caches = teng.init_cache(1, teng.max_context)
    with torch.inference_mode():
        logits = teng._prefill_rows(caches, ids, 0, len(prompt))
    return logits.numpy(), caches


def _jax_step(jeng, caches, token, pos):
    """One scalar-offset decode row through the JAX model (jitted once
    per engine)."""
    if not hasattr(jeng, "_test_step"):
        def step(params, caches, token, pos):
            logits, caches, _ = jeng.model.apply(
                {"params": params}, token[None, None],
                positions=pos[None, None], kv_caches=caches,
                cache_index=pos, deterministic=True,
                lane_meta=jeng._lane_hint())
            return logits[:, -1], caches

        jeng._test_step = jax.jit(step)
    logits, caches = jeng._test_step(jeng.params, caches,
                                     jnp.asarray(token, jnp.int32),
                                     jnp.asarray(pos, jnp.int32))
    return np.asarray(logits), caches


@pytest.mark.parametrize("window", [40, 120])
def test_prefill_and_decode_past_the_wrap_match_jax(window):
    jeng, teng = _pair(window)
    prompt = _prompt(PROMPT)
    jl, jc = _jax_prefill(jeng, prompt)
    tl, tc = _port_prefill(teng, prompt)
    assert _leaves(tc)[0].shape[1] == 128  # C < PROMPT: the cache rolled
    _close(jl, tl, 1e-5)
    for a, b in zip(_leaves(jc), _leaves(tc)):
        _close(a, b, 1e-5)
    token = int(np.argmax(jl[0]))
    for i in range(STEPS):
        pos = PROMPT + i
        jl, jc = _jax_step(jeng, jc, token, pos)
        with torch.inference_mode():
            tl = teng._decode_logits(tc, token, pos).numpy()
        _close(jl, tl, 1e-5)
        token = int(np.argmax(jl[0]))
    for a, b in zip(_leaves(jc), _leaves(tc)):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("window", [40, 120])
def test_generate_and_batch_tokens_equal_jax(window):
    jeng, teng = _pair(window)
    prompt = _prompt(PROMPT, seed=1)
    kw = dict(max_new_tokens=24, temperature=0.0, repetition_penalty=1.0)
    jt, _ = jeng.generate(prompt, **kw)
    tt, tstats = teng.generate(prompt, **kw)
    assert tt == jt and tstats["prompt_tokens"] == PROMPT
    prompts = [_prompt(n, seed=2 + n) for n in (30, 150, 200)]
    jb = jeng.generate_batch(prompts, **kw)
    tb = teng.generate_batch(prompts, **kw)
    assert [t for t, _ in tb] == [t for t, _ in jb]
    # Each lane as its own request, as the JAX vmap runs it.
    assert [t for t, _ in tb][2] == teng.generate(prompts[2], **kw)[0]


@pytest.mark.parametrize("window,draft_k,cap", [(40, 8, 8), (120, 16, 9)])
def test_speculative_tokens_and_verify_calls_equal_jax(window, draft_k,
                                                       cap):
    jeng, teng = _pair(window)
    prompt = _prompt(PROMPT, seed=3, period=23)
    jt, js = jeng.generate_speculative(prompt, max_new_tokens=32,
                                       draft_k=draft_k)
    calls = []
    real = teng._verify

    def verify(caches, ids, start):
        calls.append(len(ids))
        return real(caches, ids, start)

    teng._verify = verify
    try:
        tt, ts = teng.generate_speculative(prompt, max_new_tokens=32,
                                           draft_k=draft_k)
    finally:
        del teng._verify
    assert tt == jt
    assert ts["verify_calls"] == js["verify_calls"] == len(calls)
    assert set(calls) == {cap}
    greedy, _ = teng.generate(prompt, max_new_tokens=32, temperature=0.0,
                              repetition_penalty=1.0)
    assert tt == greedy


def test_int8_rolling_prefill_codes_equal_jax():
    jeng, teng = _pair(120, "int8")
    prompt = _prompt(PROMPT, seed=4)
    _, jc = _jax_prefill(jeng, prompt)
    _, tc = _port_prefill(teng, prompt)
    for i, (a, b) in enumerate(zip(_leaves(jc), _leaves(tc))):
        if a.dtype == np.int8:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
    jt, _ = jeng.generate(prompt, max_new_tokens=16, temperature=0.0,
                          repetition_penalty=1.0)
    assert teng.generate(prompt, max_new_tokens=16, temperature=0.0,
                         repetition_penalty=1.0)[0] == jt


def test_multi_row_update_without_slack_raises_and_speculation_falls_back():
    jeng, teng = _pair(128)  # C == window: no slack
    prompt = _prompt(PROMPT, seed=5, period=17)
    _, jc = _jax_prefill(jeng, prompt)
    _, tc = _port_prefill(teng, prompt)
    ids = [5, 6]
    with pytest.raises(ValueError, match="slack"):
        jeng.model.apply(
            {"params": jeng.params}, jnp.asarray([ids], jnp.int32),
            positions=jnp.asarray([[PROMPT, PROMPT + 1]], jnp.int32),
            kv_caches=jc, cache_index=jnp.asarray(PROMPT, jnp.int32),
            deterministic=True, multi_row_update=True)
    with pytest.raises(ValueError, match="slack"), torch.inference_mode():
        teng._verify(tc, ids, PROMPT)
    jt, js = jeng.generate_speculative(prompt, max_new_tokens=16)
    tt, ts = teng.generate_speculative(prompt, max_new_tokens=16)
    assert tt == jt
    assert "verify_calls" not in ts and "verify_calls" not in js


def test_scalar_and_lane_offsets_identical_without_window():
    _, teng = _pair(None)
    prompt = _prompt(60, seed=6)
    model = teng.model
    outs = []
    for as_lane in (False, True):
        caches = teng.init_cache(1, 256)
        ids = np.zeros((1, 64), np.int64)
        ids[0, :60] = prompt
        with torch.inference_mode():
            teng._prefill_rows(caches, ids, 0, 60)
            got = []
            for i, tok in enumerate((7, 8, 9)):
                pos = 60 + i
                index = torch.tensor([pos]) if as_lane else pos
                logits, _ = model(torch.tensor([[tok]]),
                                  positions=torch.tensor([[pos]]),
                                  kv_caches=caches, cache_index=index)
                got.append(logits.numpy())
        outs.append(got)
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
