"""Quantized serving trees and models, the port against the JAX package.

- Trees: the port's quantize_for_serving / quantize_tree over a model's
  weights in flax form (convert.state_dict_to_flax) give JAX's codes and
  scales bitwise, leaf for leaf (the fused wqkv quantized through its wq,
  wk and wv leaves, each by its own size and role); the export manifest
  and the fused mapping round-trip; idempotence and re-quantization of a
  storage-layout tree as JAX tests/test_quantization.py:197-310 pins them.
- Models: the int8-compute model (dense and MoE, JAX
  test_quantization.py:312) in fp32 on the CPU, against JAX's logits
  (the storage paths: tests/test_torch_quantized_engine.py).

Tolerance of the int8-compute logits: the int8 products equal JAX's
bitwise for equal inputs (tests/test_torch_quantized.py), but the fp32
parts between them (RMSNorm, RoPE, attention, SiLU) differ from XLA's in
the last ulp, and an activation that lands within an ulp of a .5 code
boundary flips one code, moving that row's product by one scale step
(~1% of its amax / 127). So the logits are held within 2e-2 of
max|logit| absolute (a few code steps through two layers), and greedy
argmax must agree on 95% of the positions (JAX's own test holds the int8
model to 90% against fp32).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from flax.linen import meta as flax_meta

from luminaai_tpu.config import Config as JConfig
from luminaai_tpu.models.transformer import LuminaTransformer as JModel
from luminaai_tpu.training import quantization as jquant
from luminaai_tpu_torch.config import Config as TConfig
from luminaai_tpu_torch.convert import (
    flatten_tree,
    model_tree,
    params_from_flax,
    state_dict_to_flax,
)
from luminaai_tpu_torch.models.layers import QKVParts
from luminaai_tpu_torch.models.transformer import LuminaTransformer as TModel
from luminaai_tpu_torch.ops.quantized import QuantizedTensor
from luminaai_tpu_torch.training import quantization as tquant

import torch

ARCH = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, seq_length=64, batch_size=2, precision="fp32")
MOE = dict(use_moe=True, num_experts=4, moe_top_k=2, routing_noise_std=0.0)
LOGIT_ATOL = 2e-2   # x max|logit|; see the module docstring
ARGMAX_AGREE = 0.95


@functools.lru_cache(maxsize=None)
def _jax_cached(items):
    jcfg = JConfig(**ARCH, **dict(items), use_flash_attention=False,
                   gradient_checkpointing=False)
    jmodel = JModel(jcfg)
    params = flax_meta.unbox(jax.jit(jmodel.init)(
        jax.random.key(0), jnp.ones((1, 8), jnp.int32))["params"])
    return jcfg, jmodel, params


def _jax(kw):
    """(JAX config, model, params) of ARCH + kw, built once per kw."""
    return _jax_cached(tuple(sorted(kw.items())))


def _jq(fn, params, **kw):
    """A JAX tree transform run eagerly, as the JAX engine and `convert`
    run it. (Under jit XLA rewrites w / scale as w * (1 / scale), which
    rounds some codes differently: not the function the package runs.)"""
    return fn(params, **kw)


def _port(kw, params):
    tcfg = TConfig(**ARCH, **kw)
    tmodel = TModel(tcfg, device="cpu").load_params(
        params_from_flax(jax.device_get(params), tcfg))
    return tcfg, tmodel


def _jflat(tree):
    """A JAX tree with QuantizedTensor leaves -> {path: leaf}."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jquant.QuantizedTensor))[0]
    return {"/".join(p.key for p in path): leaf for path, leaf in flat}


def _same_tree(jtree, ttree):
    jflat = _jflat(jtree)
    assert sorted(jflat) == sorted(ttree)
    n = 0
    for path, jl in jflat.items():
        tl = ttree[path]
        if isinstance(jl, jquant.QuantizedTensor):
            assert isinstance(tl, QuantizedTensor), path
            assert (jl.bits, jl.axis, jl.orig_shape) == (
                tl.bits, tl.axis, tl.orig_shape), path
            for a, b in ((jl.q, tl.q), (jl.scale, tl.scale)):
                a = np.asarray(a)
                b = b.detach().numpy()
                assert a.shape == b.shape and a.dtype == b.dtype, path
                np.testing.assert_array_equal(a.view(np.uint8),
                                              b.view(np.uint8), err_msg=path)
            n += 1
        else:
            assert not isinstance(tl, QuantizedTensor), path
            np.testing.assert_array_equal(np.asarray(jl),
                                          tl.detach().numpy(), err_msg=path)
    return n


@pytest.mark.parametrize("moe,min_size", [(False, 4096), (True, 1024)])
def test_serving_tree_equals_jax_bitwise(moe, min_size):
    """min_size 4096 at these widths quantizes wq (4096) and leaves wk, wv
    (2048) in fp32: the port keeps the fused projection's blocks apart."""
    kw = MOE if moe else {}
    _, _, params = _jax(kw)
    jq, jinfo = _jq(jquant.quantize_for_serving, params, min_size=min_size)
    tcfg, tmodel = _port(kw, params)
    tq_, tinfo = tquant.quantize_for_serving(
        state_dict_to_flax(model_tree(tmodel), tcfg), min_size=min_size)
    assert _same_tree(jq, tq_) == jinfo["quantized_leaves"] > 0
    for key in ("quantized_leaves", "total_leaves", "bytes_before",
                "bytes_after", "mode", "bits"):
        assert jinfo[key] == tinfo[key], key
    # Into the model and back: the fused layouts map onto JAX's leaves.
    tmodel.load_params_tree(tq_)
    attn = tmodel.layers[0].attention
    assert isinstance(attn.wqkv, QKVParts if min_size == 4096
                      else QuantizedTensor)
    assert _same_tree(jq, state_dict_to_flax(model_tree(tmodel), tcfg)) > 0


def test_manifest_round_trip_and_jax_export():
    """export -> import gives back the same leaves; JAX's exported tree
    and manifest load through params_from_flax into the same model
    weights as the port's own quantization."""
    _, _, params = _jax(MOE)
    jq, _ = _jq(jquant.quantize_for_serving, params, min_size=1024)
    jplain, jmanifest = jquant.export_quantized_tree(jq)
    tcfg, tmodel = _port(MOE, params)
    tq_, _ = tquant.quantize_for_serving(
        state_dict_to_flax(model_tree(tmodel), tcfg), min_size=1024)
    plain, manifest = tquant.export_quantized_tree(tq_)
    assert manifest == jmanifest
    assert sorted(plain) == sorted(flatten_tree(jax.device_get(jplain)))
    back = tquant.import_quantized_tree(plain, manifest)
    _same_tree(jq, back)
    other = TModel(tcfg, device="cpu").load_params(params_from_flax(
        jax.device_get(jplain), tcfg, manifest=jmanifest))
    _same_tree(jq, state_dict_to_flax(model_tree(other), tcfg))


def test_idempotent_and_requantized_like_jax():
    _, _, params = _jax(MOE)
    tcfg, tmodel = _port(MOE, params)
    flat = state_dict_to_flax(model_tree(tmodel), tcfg)
    q1, i1 = tquant.quantize_for_serving(flat, min_size=1024)
    q2, i2 = tquant.quantize_for_serving(q1, min_size=1024)
    assert i2["quantized_leaves"] == i1["quantized_leaves"]
    assert all(q2[k] is v for k, v in q1.items()
               if isinstance(v, QuantizedTensor))
    s1, j1 = tquant.quantize_tree(flat, bits=8, min_size=1024)
    s2, j2 = tquant.quantize_tree(s1, bits=8, min_size=1024)
    assert j2["quantized_leaves"] == j1["quantized_leaves"]
    s4, _ = tquant.quantize_tree(s1, bits=4, min_size=1024)
    four = [v for v in s4.values() if isinstance(v, QuantizedTensor)]
    assert four and all(v.bits == 4 for v in four)
    # A storage-layout tree re-quantizes into the compute layout, bitwise
    # as JAX re-quantizes its own.
    js1, _ = _jq(jquant.quantize_tree, params, bits=8, min_size=1024)
    jqs, _ = _jq(jquant.quantize_for_serving, js1, min_size=1024)
    qs, _ = tquant.quantize_for_serving(s1, min_size=1024)
    _same_tree(jqs, qs)
    # The int8 model refuses a storage layout it cannot multiply.
    with pytest.raises(ValueError, match="quantize_for_serving"):
        tmodel.load_params_tree(s1)


def _logits_close(jl, tl):
    jl, tl = np.asarray(jl), tl.detach().numpy()
    scale = np.abs(jl).max()
    err = np.abs(jl - tl).max()
    assert err <= LOGIT_ATOL * scale, (err, scale)
    agree = (jl.argmax(-1) == tl.argmax(-1)).mean()
    assert agree >= ARGMAX_AGREE, agree


@pytest.mark.parametrize("use_moe", [False, True])
def test_int8_compute_model_logits_match_jax(use_moe):
    kw = MOE if use_moe else {}
    _, jmodel, params = _jax(kw)
    ids = np.random.RandomState(0).randint(1, 256, (2, 32))
    jq, _ = _jq(jquant.quantize_for_serving, params, min_size=1024)
    jl, _ = jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, x, deterministic=True))(jq, jnp.asarray(ids))
    tcfg, tmodel = _port(kw, params)
    tq_, _ = tquant.quantize_for_serving(
        state_dict_to_flax(model_tree(tmodel), tcfg), min_size=1024)
    tmodel.load_params_tree(tq_)
    with torch.inference_mode():
        tl, _ = tmodel(torch.as_tensor(ids))
    _logits_close(jl, tl)
