"""Storage-only quantization, the port against the JAX package.

- quantize_tree (int8 and packed int4, scales over axis -1): codes and
  scales bitwise JAX's, and their dequantized trees.
- The engine's storage paths: int4, and int8 under scan_layers, are
  storage only in both packages (JAX
  QuantizationManager.prepare_serving_params, tests/test_quantization.py
  :338): the weights quantized once (a scan_layers tree through its
  stacked leaves) and dequantized to the compute dtype. The served
  weights equal JAX's engine's bitwise and the quantization_info counts
  JAX's; from there on the model is the plain one, whose decoding the
  fp32 parity tests (test_torch_generate.py) hold against JAX's, so the
  port's engine only has to generate.
"""

import jax.numpy as jnp
import pytest

from luminaai_tpu.data.tokenizer import ConversationTokenizer as JTok
from luminaai_tpu.inference.generate import GenerationEngine as JEngine
from luminaai_tpu.training import quantization as jquant
from luminaai_tpu_torch.convert import model_tree, state_dict_to_flax
from luminaai_tpu_torch.data.tokenizer import ConversationTokenizer as TTok
from luminaai_tpu_torch.inference.generate import GenerationEngine as TEngine
from luminaai_tpu_torch.ops.quantized import QuantizedTensor
from luminaai_tpu_torch.training import quantization as tquant

import torch

from test_torch_quantized_model import MOE, _jax, _jq, _port, _same_tree


@pytest.mark.parametrize("method,scan", [("int4", False), ("int8", True)])
def test_storage_engines_match_jax(method, scan):
    """The engine applies the config's quantization: int4, and int8 under
    scan_layers, are storage-only (dequantized once), with JAX's
    quantization_info, and serves the same weights as JAX's engine."""
    kw = dict(quantization_method=method, scan_layers=scan,
              prefill_chunk_size=0)
    jcfg, jmodel, params = _jax(kw)
    jengine = JEngine(jmodel, params, JTok(), jcfg)
    tcfg, tmodel = _port(dict(kw, scan_layers=False), params)
    tcfg.scan_layers = scan
    tengine = TEngine(tmodel, TTok(), tcfg)
    assert tengine.quantization_info.get("mode") != "int8_compute"
    for key in ("bits", "quantized_leaves", "total_leaves"):
        assert tengine.quantization_info[key] == \
            jengine.quantization_info[key], key
    assert not any(isinstance(v, QuantizedTensor)
                   for v in model_tree(tmodel).values())
    _same_tree(jengine.params, state_dict_to_flax(model_tree(tmodel), tcfg,
                                                  scanned=scan))
    tokens, stats = tengine.generate([5, 17, 33, 2, 9], max_new_tokens=6,
                                     temperature=0.0, seed=0)
    assert stats["tokens_generated"] == len(tokens) <= 6


@pytest.mark.parametrize("bits", [8, 4])
def test_storage_tree_equals_jax_bitwise(bits):
    """quantize_tree's axis -1 on wq/wk/wv reduces per (row, head) over
    head_dim, as on JAX's [H, heads, d] leaves (not over the fused
    column axis)."""
    _, _, params = _jax(MOE)
    jq, jinfo = _jq(jquant.quantize_tree, params, bits=bits, min_size=1024)
    tcfg, tmodel = _port(MOE, params)
    tq_, tinfo = tquant.quantize_tree(
        state_dict_to_flax(model_tree(tmodel), tcfg), bits=bits,
        min_size=1024)
    assert _same_tree(jq, tq_) == jinfo["quantized_leaves"]
    assert tq_["layer_0/attention/wq"].scale.shape == (64, 4, 1)
    assert jinfo == tinfo
    _same_tree(jquant.dequantize_tree(jq, jnp.float32),
               tquant.dequantize_tree(tq_, torch.float32))
