"""The port's flash attention against the JAX package's Pallas flash attention.

Same numpy-seeded fp32 inputs through luminaai_tpu/ops/flash_attention.py
(`flash_attention_with_lse`, block_q = block_kv = 128, interpret mode on
the CPU) and luminaai_tpu_torch/ops/flash_attention.py (on the CPU its
autograd.Function runs the kernels' plain versions, with the same delta
and lse-cotangent folding as on the card). O, lse and dq/dk/dv under a
nonzero lse cotangent are compared over GQA groups 1, 2 and 4, causal and
not, head_dim 64 and 128, at the geometries of tests/test_ops.py.
Tolerances are test_ops.py's: atol 1e-5 forward (O and lse), 5e-4 on
gradients (fp32; the online softmax and the sums run in other orders).
The windowed cases are in test_torch_flash_window.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from luminaai_tpu.ops import flash_attention as jfa
from luminaai_tpu_torch.ops import flash_attention as tfa

FWD_TOL = 1e-5
GRAD_TOL = 5e-4


def compare_with_jax(B, S, Hq, Hkv, D, *, causal=True, window=None, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, g_o = (rng.randn(*shape).astype(np.float32) for shape in (
        (B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, Hq, D)))
    g_lse = rng.randn(B, Hq, S).astype(np.float32)

    def jax_fn(q, k, v):
        return jfa.flash_attention_with_lse(
            q, k, v, causal=causal, block_q=128, block_kv=128, window=window)

    (o_j, lse_j), vjp = jax.vjp(jax_fn, *map(jnp.asarray, (q, k, v)))
    grads_j = vjp((jnp.asarray(g_o), jnp.asarray(g_lse)))

    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    o_t, lse_t = tfa.flash_attention_with_lse(
        *leaves, causal=causal, block_q=128, block_kv=128, window=window)
    ((o_t * torch.as_tensor(g_o)).sum()
     + (lse_t * torch.as_tensor(g_lse)).sum()).backward()

    assert o_t.shape == (B, S, Hq, D) and lse_t.shape == (B, Hq, S)
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j),
                               atol=FWD_TOL)
    np.testing.assert_allclose(lse_t.detach().numpy(), np.asarray(lse_j),
                               atol=FWD_TOL)
    for name, got, want in zip("qkv", leaves, grads_j):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   atol=GRAD_TOL, err_msg=f"d{name}")


CASES = {
    # test_ops.py test_forward_matches_reference: mha / gqa / mqa
    "causal_g1_d128": dict(B=2, S=256, Hq=4, Hkv=4, D=128),
    "causal_g2_d128": dict(B=2, S=256, Hq=4, Hkv=2, D=128),
    "causal_g4_d128": dict(B=2, S=256, Hq=4, Hkv=1, D=128),
    # test_ops.py test_backward_matches_reference
    "causal_g2_d128_backward_geometry": dict(B=1, S=256, Hq=2, Hkv=1, D=128),
    # test_ops.py test_window_changes_result's geometry (full causal)
    "causal_g1_d64": dict(B=1, S=256, Hq=2, Hkv=2, D=64),
    # test_ops.py test_non_causal
    "noncausal_g1_d128": dict(B=1, S=128, Hq=2, Hkv=2, D=128,
                              causal=False),
    "noncausal_g4_d64": dict(B=1, S=256, Hq=4, Hkv=1, D=64, causal=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_matches_jax(case):
    compare_with_jax(**CASES[case], seed=sorted(CASES).index(case))


@pytest.mark.parametrize("want", [64, 128, 256, 512, 768, 1024])
def test_fit_block_and_gate_match_jax(want):
    for seq in (1, 64, 100, 127, 128, 192, 256, 384, 500, 512, 640, 1000,
                1024, 1536, 2048, 3072, 4096):
        assert tfa.fit_block(seq, want) == jfa.fit_block(seq, want), seq
        for d in (32, 64, 96, 128, 256):
            assert tfa.flash_eligible(seq, d, want, 1024) == (
                jfa.flash_eligible(seq, d, want, 1024)), (seq, d)


def test_cpu_tensors_run_the_plain_versions_without_launching():
    q = torch.randn(1, 128, 2, 64)
    k = torch.randn(1, 128, 1, 64)
    before = (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
              tfa.flash_bwd_dkv.launches)
    o, lse = tfa.flash_fwd(q, k, k, scale=0.125)
    want_o, want_lse = tfa.flash_fwd_ref(q, k, k, scale=0.125)
    torch.testing.assert_close(o, want_o, atol=0, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=0, rtol=0)
    assert (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
            tfa.flash_bwd_dkv.launches) == before
