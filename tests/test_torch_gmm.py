"""The port's grouped matmul (ops/gmm.py) against megablox, in fp32 on the CPU.

megablox runs in Pallas interpret mode, as tests/test_moe.py runs it: its
`gmm` (with the custom VJP of megablox/ops.py) and its `tgmm`. The port's
wrappers run their plain versions on a CPU tensor. Inputs are standard
normal draws from a numpy seed; group sizes are ragged, with an empty
group and sum(group_sizes) < M (the tail the MoE path's drops and 128-row
padding leave), M a multiple of 128.

Tolerance 1e-5 (fp32; the two sides sum K products in other orders).
Megablox leaves rows past sum(group_sizes) undefined (in out and in
grad_lhs), so only the kept region is compared; the port writes those rows,
and empty groups of tgmm, as exact zeros. The autograd.Function also passes
torch.autograd.gradcheck in fp64.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas.ops.tpu.megablox import gmm as mb_gmm
from jax.experimental.pallas.ops.tpu.megablox.gmm import tgmm as mb_tgmm

from luminaai_tpu_torch.ops import gmm as tg

TOL = dict(atol=1e-5, rtol=1e-5)
M, K, N = 256, 64, 96
CASES = {
    # name: group sizes (E = 4)
    "ragged_empty_tail": [100, 0, 60, 36],
    "full": [128, 0, 96, 32],
    "one_group": [0, 0, 200, 0],
}


def _inputs(seed, transpose_rhs=False):
    rng = np.random.RandomState(seed)
    lhs = rng.randn(M, K).astype(np.float32)
    shape = (4, N, K) if transpose_rhs else (4, K, N)
    rhs = rng.randn(*shape).astype(np.float32)
    ct = rng.randn(M, N).astype(np.float32)
    return lhs, rhs, ct


@pytest.mark.parametrize("transpose_rhs", [False, True], ids=["nn", "nt"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_gmm_matches_megablox(case, transpose_rhs):
    sizes = np.asarray(CASES[case], np.int32)
    kept = int(sizes.sum())
    lhs, rhs, _ = _inputs(0, transpose_rhs)
    want = np.asarray(mb_gmm(
        jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(sizes),
        preferred_element_type=jnp.float32, transpose_rhs=transpose_rhs,
        interpret=True))
    got = tg.gmm(torch.as_tensor(lhs), torch.as_tensor(rhs),
                 torch.as_tensor(sizes), torch.float32,
                 transpose_rhs=transpose_rhs).numpy()
    np.testing.assert_allclose(got[:kept], want[:kept], **TOL)
    assert np.all(got[kept:] == 0.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tgmm_matches_megablox(case):
    sizes = np.asarray(CASES[case], np.int32)
    lhs, _, ct = _inputs(1)
    want = np.asarray(mb_tgmm(
        jnp.asarray(lhs.T), jnp.asarray(ct), jnp.asarray(sizes),
        preferred_element_type=jnp.float32, interpret=True))
    got = tg.tgmm(torch.as_tensor(lhs).t(), torch.as_tensor(ct),
                  torch.as_tensor(sizes), torch.float32).numpy()
    assert got.shape == (4, K, N)
    for g in range(4):
        if sizes[g]:
            np.testing.assert_allclose(got[g], want[g], **TOL)
        else:
            assert np.all(got[g] == 0.0)


@pytest.mark.parametrize("transpose_rhs", [False, True], ids=["nn", "nt"])
def test_vjp_matches_megablox(transpose_rhs):
    """Gradients through GroupedMatmul against jax.grad through megablox's
    custom VJP, of sum(row_kept * out * ct) (the MoE path's masked use)."""
    sizes = np.asarray(CASES["ragged_empty_tail"], np.int32)
    kept = int(sizes.sum())
    lhs, rhs, ct = _inputs(2, transpose_rhs)
    row_kept = (np.arange(M) < kept)[:, None]

    def jloss(l, r):
        out = mb_gmm(l, r, jnp.asarray(sizes),
                     preferred_element_type=jnp.float32,
                     transpose_rhs=transpose_rhs, interpret=True)
        return jnp.sum(jnp.where(row_kept, out, 0.0) * ct)

    jl, jr = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(lhs),
                                              jnp.asarray(rhs))
    tl = torch.as_tensor(lhs).requires_grad_()
    tr = torch.as_tensor(rhs).requires_grad_()
    out = tg.grouped_matmul(tl, tr, torch.as_tensor(sizes),
                            transpose_rhs=transpose_rhs)
    (torch.where(torch.as_tensor(row_kept), out, 0.0)
     * torch.as_tensor(ct)).sum().backward()
    np.testing.assert_allclose(tl.grad.numpy()[:kept], np.asarray(jl)[:kept],
                               **TOL)
    assert np.all(tl.grad.numpy()[kept:] == 0.0)
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(jr), **TOL)


@pytest.mark.parametrize("transpose_rhs", [False, True], ids=["nn", "nt"])
def test_grouped_matmul_gradcheck_fp64(transpose_rhs):
    rng = np.random.RandomState(3)
    lhs = torch.as_tensor(rng.randn(12, 8)).requires_grad_()
    shape = (3, 6, 8) if transpose_rhs else (3, 8, 6)
    rhs = torch.as_tensor(rng.randn(*shape)).requires_grad_()
    sizes = torch.tensor([5, 0, 4], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda l, r: tg.grouped_matmul(l, r, sizes,
                                       transpose_rhs=transpose_rhs),
        (lhs, rhs))


def test_cpu_wrappers_do_not_count_launches():
    sizes = torch.tensor([3, 5], dtype=torch.int32)
    n0 = (tg.gmm.launches, tg.tgmm.launches)
    tg.gmm(torch.ones(8, 8), torch.ones(2, 8, 8), sizes)
    tg.tgmm(torch.ones(8, 8), torch.ones(8, 8), sizes)
    assert (tg.gmm.launches, tg.tgmm.launches) == n0
