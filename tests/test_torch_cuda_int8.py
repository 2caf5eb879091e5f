"""B5-int8 (int8 KV codes and fp32 scales read in the decode kernel) and the
int8 products on the card (marked `cuda`; skip without one).

The CUDA kernel has no CPU mode; chip_smoke.py runs the same checks at
the b1 serving shapes. This file imports nothing of JAX:

    python -m pytest tests/test_torch_cuda_int8.py -q --noconftest

Tolerance, kernel vs plain version in bf16: 3e-2 absolute, as B5's (both
multiply the same dequantized bf16 values, bf16(float(code) * scale); the
rest is B5's arithmetic). The int8 products are exact integer GEMMs, so
the card's equal the CPU's bitwise.
"""

import numpy as np
import pytest
import torch

from luminaai_tpu_torch.ops import quantized as tq
from luminaai_tpu_torch.ops import ragged_paged_attention as rpa

pytestmark = pytest.mark.cuda

TOL = 3e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _case(dev, lengths, P, ps, Hq, Hkv, D, global_pages=False, seed=3):
    B = len(lengths)
    rng = np.random.RandomState(seed)

    def t(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32)).to(
            dev, torch.bfloat16)

    q = t(B, 1, Hq, D)
    k, v = tq.quantize_act(t(B, P * ps, Hkv, D)), tq.quantize_act(
        t(B, P * ps, Hkv, D))
    table = np.tile(np.arange(P, dtype=np.int32), (B, 1))
    if global_pages:
        table = np.stack([rng.permutation(B * P)[:P]
                          for _ in range(B)]).astype(np.int32)
    meta = rpa.LaneMeta(
        lengths=torch.as_tensor(np.asarray(lengths, np.int32), device=dev),
        page_table=torch.as_tensor(table, device=dev), page_size=ps,
        identity_pages=not global_pages, global_pages=global_pages)
    return q, k, v, meta


@pytest.mark.parametrize("D,global_pages", [(128, False), (128, True),
                                            (64, False), (256, True),
                                            (512, False), (576, False),
                                            (192, False), (320, True)])
def test_int8_kernel_matches_plain_on_card(dev, D, global_pages):
    P, ps = 6, 64
    q, k, v, meta = _case(dev, [1, 64, 65, P * ps], P, ps, 8, 2, D,
                          global_pages=global_pages)
    n = (rpa.ragged_paged_attention.launches,
         rpa.ragged_paged_attention.launches_int8)
    out = rpa.ragged_paged_attention(q, k, v, meta)
    want = rpa.ragged_paged_attention_plain(q, k, v, meta)
    torch.cuda.synchronize()
    assert (rpa.ragged_paged_attention.launches,
            rpa.ragged_paged_attention.launches_int8) == (n[0], n[1] + 1)
    assert out.shape == q.shape and torch.isfinite(out).all()
    assert (out.float() - want.float()).abs().max().item() <= TOL


def test_int8_wrapper_refuses_wrong_operands(dev):
    q, k, v, meta = _case(dev, [5, 9], 2, 64, 4, 2, 128)
    with pytest.raises(ValueError, match="scales"):
        rpa.ragged_paged_attention(q, k, (v[0], v[1].to(torch.bfloat16)),
                                   meta)
    with pytest.raises(ValueError, match="codes"):
        rpa.ragged_paged_attention(q, (k[0].float(), k[1]), v, meta)


@pytest.mark.parametrize("m", [1, 8, 16, 17, 40])
def test_int8_products_on_card_equal_the_cpu(dev, m):
    rng = np.random.RandomState(m)
    x = torch.as_tensor(rng.randn(m, 256).astype(np.float32))
    w = tq.quantize_array(torch.as_tensor(
        rng.randn(256, 384).astype(np.float32) * 0.02), axis=0)
    want = tq.int8_project(x, w, torch.float32)
    wc = tq.QuantizedTensor(w.q, w.scale, 8, w.axis, w.orig_shape).to(
        dev).mm_layout()
    got = tq.int8_project(x.to(dev), wc, torch.float32)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("bits,axis", [(8, 0), (8, -1), (4, 0), (4, -1)])
def test_quantize_array_on_card_equals_the_cpu(dev, bits, axis):
    """The weight scales and codes (int8 and packed int4) that quantizing
    a model on the card sets equal the CPU's bit for bit."""
    rng = np.random.RandomState(bits * 10 + axis % 3)
    w = torch.as_tensor(rng.randn(256, 384).astype(np.float32) * 0.02)
    want = tq.quantize_array(w, bits=bits, axis=axis)
    got = tq.quantize_array(w.to(dev), bits=bits, axis=axis)
    assert torch.equal(got.scale.cpu(), want.scale)
    assert torch.equal(got.q.cpu(), want.q)


@pytest.mark.parametrize("m", [1, 8, 17, 40])
def test_quantize_act_on_card_equals_the_cpu(dev, m):
    rng = np.random.RandomState(100 + m)
    x = torch.as_tensor(rng.randn(m, 256).astype(np.float32))
    want_q, want_s = tq.quantize_act(x)
    got_q, got_s = tq.quantize_act(x.to(dev))
    assert torch.equal(got_s.cpu(), want_s)
    assert torch.equal(got_q.cpu(), want_q)


@pytest.mark.parametrize("row", [64, 384])
def test_int8_adam_moments_on_card_equal_the_cpu(dev, row):
    """The int8 Adam moments' row codes and scales (optimizer._q8)."""
    from luminaai_tpu_torch.training.optimizer import _q8

    rng = np.random.RandomState(row)
    x = torch.as_tensor(rng.randn(32, 384).astype(np.float32) * 1e-3)
    want_c, want_s = _q8(x, row)
    got_c, got_s = _q8(x.to(dev), row)
    assert torch.equal(got_s.cpu(), want_s)
    assert torch.equal(got_c.cpu(), want_c)
