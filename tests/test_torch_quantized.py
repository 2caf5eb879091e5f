"""The port's int8 ops (luminaai_tpu_torch/ops/quantized.py) against the JAX
package's (luminaai_tpu/ops/quantized.py), bitwise.

The same numpy inputs go through both. Every step of either side is exact
or one IEEE rounding (fp32 amax / qmax, a division, round-half-to-even,
clip, integer products, then y * sx * sw in that order), so codes, scales,
int4 packing and every product must be equal bit for bit on the CPU.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from luminaai_tpu.ops import quantized as jq
from luminaai_tpu_torch.ops import quantized as tq

import torch


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else (
        np.asarray(t))


def _both(w, **kw):
    return (jq.quantize_array(jnp.asarray(w), **kw),
            tq.quantize_array(torch.from_numpy(w), **kw))


def _same(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("bits,shape,axis", [
    (8, (64, 48), -1),
    (8, (64, 48), 0),
    (8, (6, 5, 40), (0, 1)),
    (8, (4, 32, 24), (1,)),
    (4, (16, 64), -1),
    (4, (8, 63), -1),       # odd length along the packed axis
    (4, (9, 32), 0),        # packed along axis 0, odd
    (4, (3, 7, 5), 1),
])
def test_quantize_array_codes_and_scales_bitwise(bits, shape, axis):
    w = (np.random.RandomState(sum(shape) + bits).randn(*shape) * 0.05
         ).astype(np.float32)
    w[0] = 0.0  # an all-zero channel takes scale 1
    jt, tt = _both(w, bits=bits, axis=axis)
    _same(jt.q, tt.q)
    _same(jt.scale, tt.scale)
    assert (jt.bits, jt.axis, jt.orig_shape) == (tt.bits, tt.axis,
                                                 tt.orig_shape)
    for dt, tdt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        a = np.asarray(jt.dequantize(dt).astype(jnp.float32))
        b = tt.dequantize(tdt).float().numpy()
        np.testing.assert_array_equal(a, b)
    assert tt.dequantize(torch.float32).shape == shape


def test_quantize_act_bitwise():
    x = np.random.RandomState(3).randn(3, 5, 96).astype(np.float32) * 3
    x[1, 2] = 0.0
    jx, js = jq.quantize_act(jnp.asarray(x))
    tx, ts = tq.quantize_act(torch.from_numpy(x))
    _same(jx, tx)
    _same(js, ts)
    # bf16 activations (the serving dtype) quantize alike.
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jx, js = jq.quantize_act(xb)
    tx, ts = tq.quantize_act(torch.from_numpy(
        np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16))
    _same(jx, tx)
    _same(js, ts)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_int8_products_bitwise(out):
    jdt = jnp.float32 if out == "f32" else jnp.bfloat16
    tdt = torch.float32 if out == "f32" else torch.bfloat16

    def cmp(a, b):
        _same(np.asarray(a.astype(jnp.float32)), b.float())

    # project: w [K, O1, O2] over axis 0 (the JAX wq layout).
    x = _x(2, 5, 64, seed=1)
    w = _x(64, 4, 16, seed=2) * 0.02
    jw, tw = _both(w, axis=(0,))
    cmp(jq.int8_project(jnp.asarray(x), jw, jdt),
        tq.int8_project(torch.from_numpy(x), tw, tdt))
    # attend: w [V, K] over the last axis, fp32 out.
    e = _x(96, 64, seed=3) * 0.02
    je, te = _both(e, axis=(-1,))
    cmp(jq.int8_attend(jnp.asarray(x), je, jdt),
        tq.int8_attend(torch.from_numpy(x), te, tdt))
    # out_proj: x [.., A, B] . w [A, B, H] over (0, 1).
    xo = _x(2, 5, 4, 16, seed=4)
    wo = _x(4, 16, 48, seed=5) * 0.02
    jwo, two = _both(wo, axis=(0, 1))
    cmp(jq.int8_out_proj(jnp.asarray(xo), jwo, jdt),
        tq.int8_out_proj(torch.from_numpy(xo), two, tdt))
    # expert: x [E, G, C, K] . w [E, K, N] over axis 1 (zero rows, as
    # unfilled capacity slots, quantize to code 0).
    xe = _x(3, 2, 4, 64, seed=6)
    xe[1, 0, 2] = 0.0
    we = _x(3, 64, 40, seed=7) * 0.02
    jwe, twe = _both(we, axis=(1,))
    cmp(jq.int8_expert(jnp.asarray(xe), jwe, jdt),
        tq.int8_expert(torch.from_numpy(xe), twe, tdt))
    # embed_rows: gathered rows of an int8 table.
    toks = np.random.RandomState(8).randint(0, 96, (2, 9))
    cmp(jq.embed_rows(je, jnp.asarray(toks), jdt),
        tq.embed_rows(te, torch.from_numpy(toks), tdt))


def test_the_fused_projection_equals_three_jax_projections():
    """The port's fused wqkv [H, (nq + 2 nkv) d], quantized per column
    over axis 0, gives JAX's wq, wk and wv products (each over axis 0 of
    [H, heads, d]) bitwise: the same activation codes, the same integer
    columns, the same per-column scales."""
    H, nq, nkv, d = 64, 4, 2, 16
    x = _x(2, 3, H, seed=9)
    ws = [_x(H, n, d, seed=10 + i) * 0.02 for i, n in enumerate((nq, nkv,
                                                                 nkv))]
    fused = np.concatenate([w.reshape(H, -1) for w in ws], axis=1)
    tq_fused = tq.quantize_array(torch.from_numpy(fused), axis=(0,))
    y = tq.int8_project(torch.from_numpy(x), tq_fused, torch.float32)
    parts = [np.asarray(jq.int8_project(
        jnp.asarray(x), jq.quantize_array(jnp.asarray(w), axis=(0,)),
        jnp.float32)).reshape(2, 3, -1) for w in ws]
    _same(np.concatenate(parts, axis=-1), y)


def test_layout_mismatch_raises_valueerror():
    w = torch.from_numpy(_x(64, 32))
    with pytest.raises(ValueError, match="quantized over axes"):
        tq.int8_project(torch.ones(2, 64), tq.quantize_array(w, axis=-1),
                        torch.float32)
    with pytest.raises(ValueError, match="8-bit"):
        tq.int8_project(torch.ones(2, 64),
                        tq.quantize_array(w, bits=4, axis=0), torch.float32)
    with pytest.raises(ValueError, match="int8-only"):
        tq.quantize_array(w, bits=4, axis=(0, 1))


def test_quantized_tensor_moves_but_keeps_its_dtypes():
    qt = tq.quantize_array(torch.from_numpy(_x(16, 8)), axis=0)
    holder = torch.nn.Module()
    holder.w = qt
    holder.to(torch.bfloat16)
    assert qt.q.dtype == torch.int8 and qt.scale.dtype == torch.float32
    sd = holder.state_dict()
    assert set(sd) == {"w.q", "w.scale"}
    assert qt.nbytes == 16 * 8 + 8 * 4


def test_int_mm_pads_no_rows_on_the_cpu():
    a = torch.randint(-127, 128, (3, 5), dtype=torch.int8)
    b = torch.randint(-127, 128, (5, 7), dtype=torch.int8)
    np.testing.assert_array_equal(
        tq.int_mm(a, b).numpy(), a.int().numpy() @ b.int().numpy())


@pytest.mark.parametrize("which", ["quantize_array8", "quantize_array4",
                                   "quantize_act", "q8"])
def test_scales_divide_by_a_tensor_with_the_old_bits_on_the_cpu(which):
    """The scales divide amax by a tensor (the card's true quotient); on
    the CPU that gives the bits the Python-number divisor gave."""
    from luminaai_tpu_torch.training.optimizer import _q8

    rng = np.random.RandomState(7)
    x = torch.as_tensor(rng.randn(48, 96).astype(np.float32) * 0.03)
    amax_last = x.abs().amax(dim=-1, keepdim=True)
    if which == "quantize_array8":
        amax0 = x.abs().amax(dim=0, keepdim=True)
        old = torch.where(amax0 > 0, amax0 / 127.0, torch.ones_like(amax0))
        new = tq.quantize_array(x, bits=8, axis=0).scale
    elif which == "quantize_array4":
        old = torch.where(amax_last > 0, amax_last / 7.0,
                          torch.ones_like(amax_last))
        new = tq.quantize_array(x, bits=4, axis=-1).scale
    elif which == "quantize_act":
        old = torch.where(amax_last > 0, amax_last / 127.0,
                          torch.ones_like(amax_last))
        new = tq.quantize_act(x)[1]
    else:
        old = x.reshape(48, 3, 32).abs().amax(dim=-1) / 127.0
        new = _q8(x, 32)[1]
    assert torch.equal(new, old)
