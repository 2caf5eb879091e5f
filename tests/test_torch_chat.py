"""The port's single-request generation and chat REPL against the JAX
package's GenerationEngine and ChatInterface.

Both engines hold the same weights (a flax init at init_std 0.3, so
greedy decoding does not collapse onto one token; converted with
convert.params_from_flax) in fp32 on the CPU.

- Greedy `generate` gives the same token ids and `stopped` status as JAX
  `generate`: a prompt inside one 64-row prefill chunk, one longer than a
  chunk, one whose final chunk overhangs the cache and re-anchors to its
  edge (max_context 120), the bucketed path (chunking off), and a stop
  token hit mid-decode.
- `generate_stream` equals `generate` bitwise at a seed with temperature
  > 0 (tokens, then the stats dict with the same `stopped`).
- ChatInterface over either engine: `respond` in the deterministic mode
  and every `handle_command` output equal JAX's.
- `load_model_for_inference(adapter=...)` merges a JAX-saved adapter after
  the bf16 cast, as the JAX loader does.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from luminaai_tpu.config import Config as JConfig
from luminaai_tpu.data.tokenizer import ConversationTokenizer as JTok
from luminaai_tpu.inference import chat as jchat
from luminaai_tpu.inference.generate import GenerationEngine as JEngine
from luminaai_tpu.models.transformer import LuminaTransformer as JModel
from luminaai_tpu.training import adapters as jad
from luminaai_tpu_torch.config import Config as TConfig
from luminaai_tpu_torch.convert import (
    flatten_tree,
    params_from_flax,
    state_dict_to_flax,
)
from luminaai_tpu_torch.data.tokenizer import ConversationTokenizer as TTok
from luminaai_tpu_torch.inference import chat as tchat
from luminaai_tpu_torch.inference.generate import GenerationEngine as TEngine
from luminaai_tpu_torch.models.transformer import LuminaTransformer as TModel
from luminaai_tpu_torch.training.checkpoint import save_params_checkpoint

ARCH = dict(vocab_size=384, hidden_size=64, num_layers=2, num_heads=2,
            num_kv_heads=1, seq_length=256, intermediate_size=128,
            precision="fp32", init_std=0.3, max_new_tokens=16,
            use_moe=False)


def _unbox(params):
    from flax import linen as nn

    return jax.tree.map(
        lambda x: x.unbox() if isinstance(x, nn.meta.AxisMetadata) else x,
        params, is_leaf=lambda x: isinstance(x, nn.meta.AxisMetadata),
    )


@pytest.fixture(scope="module")
def weights():
    jcfg = JConfig(**ARCH, use_flash_attention=False,
                   gradient_checkpointing=False)
    jmodel = JModel(jcfg)
    params = _unbox(jax.jit(jmodel.init)(
        jax.random.key(0), jnp.ones((1, 8), jnp.int32))["params"])
    return jmodel, params, flatten_tree(jax.device_get(params))


def _engines(weights, stop_extra=(), max_context=None, **cfg_kw):
    jmodel, params, flat = weights
    jcfg = JConfig(**{**ARCH, **cfg_kw}, use_flash_attention=False,
                   gradient_checkpointing=False)
    tcfg = TConfig(**{**ARCH, **cfg_kw})
    tmodel = TModel(tcfg, device="cpu").load_params(
        params_from_flax(flat, tcfg))

    class J(JEngine):
        @property
        def _stop_set(self):
            return super()._stop_set | set(stop_extra)

    class T(TEngine):
        @property
        def _stop_set(self):
            return super()._stop_set | set(stop_extra)

    return (J(jmodel, params, JTok(), jcfg, max_context=max_context),
            T(tmodel, TTok(), tcfg, max_context=max_context))


PROMPTS = {
    "one_chunk": (40, None, {}),
    "three_chunks": (150, None, {}),
    "reanchor": (100, 120, {}),
    "bucketed": (100, None, {"prefill_chunk_size": 0}),
}


@pytest.mark.parametrize("case", sorted(PROMPTS))
def test_greedy_generate_equals_jax(weights, case):
    n, max_context, kw = PROMPTS[case]
    prompt = np.random.RandomState(n).randint(3, 380, n).tolist()
    je, te = _engines(weights, max_context=max_context, **kw)
    want, wstats = je.generate(prompt, temperature=0.0)
    got, gstats = te.generate(prompt, temperature=0.0)
    assert got == want and len(set(want)) > 3
    assert gstats["stopped"] == wstats["stopped"] == "length"
    assert gstats["prompt_tokens"] == wstats["prompt_tokens"] == n
    if case == "reanchor":
        # The final chunk [64, 128) overhangs the 120-row cache.
        assert te._prefill_chunk_len() == 64 and n > 64 and 128 > 120


def test_greedy_stop_token_equals_jax(weights):
    """A stop token at the 6th generated position ends both loops there,
    dropped, with stopped 'eos'."""
    prompt = list(range(5, 60))
    free, _ = _engines(weights)[1].generate(prompt, temperature=0.0)
    stop = free[5]
    assert stop not in free[:5]
    je, te = _engines(weights, stop_extra=(stop,))
    want, wstats = je.generate(prompt, temperature=0.0)
    got, gstats = te.generate(prompt, temperature=0.0)
    assert got == want == free[:5]
    assert gstats["stopped"] == wstats["stopped"] == "eos"
    streamed = list(te.generate_stream(prompt, temperature=0.0))
    assert streamed[:-1] == got and streamed[-1]["stopped"] == "eos"


@pytest.mark.parametrize("seed", [0, 11])
def test_generate_stream_equals_generate_bitwise(weights, seed):
    te = _engines(weights)[1]
    prompt = np.random.RandomState(seed).randint(3, 380, 70).tolist()
    kw = dict(temperature=0.9, top_p=0.95, top_k=50, seed=seed,
              max_new_tokens=24)
    tokens, stats = te.generate(prompt, **kw)
    *streamed, last = te.generate_stream(prompt, **kw)
    assert streamed == tokens and all(isinstance(t, int) for t in streamed)
    assert last["stopped"] == stats["stopped"]
    assert last["tokens_generated"] == stats["tokens_generated"] == len(
        tokens)
    assert te.generate(prompt, **kw)[0] == tokens  # reproducible at a seed


COMMANDS = ["/help", "/stats", "/mode precise", "/mode bogus", "/system be brief",
            "/system", "/clear", "/config", "/nope", "/quit"]


def test_chat_interface_equals_jax(weights, tmp_path, monkeypatch):
    je, te = _engines(weights)
    jc, tc = jchat.ChatInterface(engine=je), tchat.ChatInterface(engine=te)
    assert tchat.GENERATION_MODES == jchat.GENERATION_MODES
    for c in (jc, tc):
        c.mode = "deterministic"
    for msg in ("hello there", "and again"):
        (jt, js), (tt, ts) = jc.respond(msg), tc.respond(msg)
        assert tt == jt
        for k in ("tokens_generated", "prompt_tokens", "stopped"):
            assert ts[k] == js[k]
    assert tc.history == jc.history
    for cmd in COMMANDS:
        if cmd == "/stats":  # tok/s depend on the wall clock
            assert tc.handle_command(cmd).split()[:4] == (
                jc.handle_command(cmd).split()[:4])
        else:
            assert tc.handle_command(cmd) == jc.handle_command(cmd), cmd
    monkeypatch.chdir(tmp_path)
    assert tc.handle_command("/save t") == "saved -> t.json"
    jc.handle_command("/save j")
    saved = [json.loads((tmp_path / f"{n}.json").read_text())
             for n in ("t", "j")]
    for s in saved:
        s.pop("stats")
    assert saved[0] == saved[1]
    text, _ = te.chat_response([{"role": "user", "content": "hi"}],
                               temperature=0.0)
    assert text == je.chat_response([{"role": "user", "content": "hi"}],
                                    temperature=0.0)[0]


def test_adapter_merges_after_the_bf16_cast_as_in_jax(weights, tmp_path):
    jmodel, params, flat = weights
    spec = jad.LoRASpec(rank=4, alpha=16.0)
    lora = jad.init_lora_params(params, spec, jax.random.key(1))
    rng = np.random.RandomState(3)
    lora = {k: {"a": ab["a"], "b": jnp.asarray(
        rng.normal(0, 0.05, ab["b"].shape), jnp.float32)}
        for k, ab in lora.items()}
    jad.save_lora(str(tmp_path / "adapter.npz"), lora, spec)
    # The JAX chat loader: bf16 cast of the params, then the merge.
    bf16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
    want = flatten_tree(jax.device_get(jad.merge_lora(bf16, lora, spec)))

    tcfg = TConfig(**ARCH)
    save_params_checkpoint(
        tmp_path / "ckpt", 0, {k: torch.tensor(v) for k, v in flat.items()},
        {"config": tcfg.to_dict()})
    model, cfg = tchat.load_model_for_inference(
        str(tmp_path / "ckpt"), adapter=str(tmp_path / "adapter.npz"),
        device="cpu")
    got = state_dict_to_flax(model.state_dict(), cfg)
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w, dtype=np.float32)
        g = got[k].float().numpy()
        # bf16 values on both sides; an fp32 delta product may round to
        # the neighbouring bf16 value in a rare element.
        ulp = np.abs(w) * 2.0 ** -7 + 1e-30
        assert (np.abs(g - w) <= ulp).all(), k
        assert (g == w).mean() > 0.999, k
