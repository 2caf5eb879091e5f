"""The port's kernels take every shape the JAX package's gates send to its own.

The JAX package routes a shape to its Pallas kernel when its gate admits it:
`flash_eligible` (B1-B3) and `ragged_eligible` (B5). Wherever a gate
admits a shape, the port's kernel-shape check (a pure function of the
shape: `kernel_shape_error`, which the wrappers raise with) must accept it,
at every head_dim the gate admits (flash above 256 and decode above 512
included). Checked on a grid of sequence lengths, head dims, q heads and kv
heads, under the JAX default flash blocks (1024, as config.flash_block_q/kv)
and two smaller ones.
"""

import itertools

import pytest

from luminaai_tpu.ops.flash_attention import flash_eligible as jflash_eligible
from luminaai_tpu.ops.ragged_paged_attention import (
    ragged_eligible as jragged_eligible,
)
from luminaai_tpu_torch.ops import flash_attention as fa
from luminaai_tpu_torch.ops import ragged_paged_attention as rpa

SEQS = sorted({*range(1, 1025, 7), 128, 192, 200, 256, 384, 640, 1000, 1024,
               1536, 2048, 3072, 4096})
HEAD_DIMS = (32, 48, 64, 96, 128, 192, 256, 320, 512, 576)
HEADS = [(1, 1), (2, 1), (3, 1), (4, 2), (6, 2), (5, 5), (16, 4), (16, 8),
         (16, 1), (24, 8), (32, 2), (48, 3)]


@pytest.mark.parametrize("block", [1024, 512, 128])
@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_flash_kernels_take_what_flash_eligible_admits(block, head_dim):
    admitted = 0
    for s, (hq, hkv) in itertools.product(SEQS, HEADS):
        if not jflash_eligible(s, head_dim, block, block):
            continue
        assert fa.flash_eligible(s, head_dim, block, block)
        admitted += 1
        err = fa.kernel_shape_error(2, s, s, hq, hkv, head_dim)
        assert err is None, (s, head_dim, hq, hkv, err)
    assert admitted or head_dim % 64


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_decode_kernel_takes_what_ragged_eligible_admits(head_dim):
    for page_size, s_q, (hq, hkv) in itertools.product(
            (8, 16, 24, 64, 128, 100), (1, 2), HEADS + [(64, 4), (128, 1)]):
        eligible = jragged_eligible(page_size, head_dim, s_q)
        assert rpa.ragged_eligible(page_size, head_dim, s_q) == eligible
        err = rpa.kernel_shape_error(s_q, hq, hkv, head_dim, page_size)
        if eligible:
            assert err is None, (page_size, s_q, hq, hkv, err)
        else:
            assert err is not None


def test_shape_checks_refuse_malformed_heads():
    assert "multiple" in fa.kernel_shape_error(1, 256, 256, 6, 4, 128)
    assert "empty" in fa.kernel_shape_error(1, 0, 256, 4, 4, 128)
    assert "head_dim" in fa.kernel_shape_error(1, 256, 256, 4, 4, 96)
    assert "multiple" in rpa.kernel_shape_error(1, 6, 4, 128, 128)
