"""The port's CUDA kernel on the card (marked `cuda`; skips without one).

The ragged paged decode-attention kernel has no CPU mode, so these run
only where torch.cuda.is_available(); chip_smoke.py runs the same checks
at the b1 serving shapes. This file imports nothing of JAX, so it also
runs on a machine that has torch and a card only:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerance, kernel vs plain version in bf16: 3e-2 absolute on outputs of
magnitude <= max|v| ~ 4.5 (bf16 keeps 8 significant bits; the kernel keeps
fp32 scores and rounds the unnormalised P to bf16, the plain version
rounds the scores and the normalised P).
"""

import numpy as np
import pytest
import torch

from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.inference.chat import build_engine
from luminaai_tpu_torch.ops import ragged_paged_attention as rpa

pytestmark = pytest.mark.cuda

TOL = 3e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, lengths, P, ps, Hq, Hkv, D, *, window=None,
          global_pages=False, seed=5):
    B = len(lengths)
    rng = np.random.RandomState(seed)
    q, k, v = (
        torch.as_tensor(rng.randn(*shape).astype(np.float32)).to(
            dev, torch.bfloat16)
        for shape in ((B, 1, Hq, D), (B, P * ps, Hkv, D), (B, P * ps, Hkv, D))
    )
    table = np.tile(np.arange(P, dtype=np.int32), (B, 1))
    if global_pages:
        table = np.stack(
            [rng.permutation(B * P)[:P] for _ in range(B)]
        ).astype(np.int32)
    meta = rpa.LaneMeta(
        lengths=torch.as_tensor(np.asarray(lengths, np.int32), device=dev),
        page_table=torch.as_tensor(table, device=dev), window=window,
        page_size=ps, identity_pages=not global_pages,
        global_pages=global_pages,
    )
    return q, k, v, meta


@pytest.mark.parametrize("window,global_pages", [(None, False), (300, False),
                                                 (None, True)])
def test_kernel_matches_plain_on_card(dev, window, global_pages):
    P, ps = 8, 128
    q, k, v, meta = _case(dev, [1, 128, 129, P * ps], P, ps, 16, 4, 128,
                          window=window, global_pages=global_pages)
    before = rpa.ragged_paged_attention.launches
    out = rpa.ragged_paged_attention(q, k, v, meta)
    want = rpa.ragged_paged_attention_ref(q, k, v, meta)
    torch.cuda.synchronize()
    assert rpa.ragged_paged_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    err = (out.float() - want.float()).abs().max().item()
    assert err <= TOL, err


def test_kernel_small_pages_and_zero_length_lane(dev):
    """Page size 16, head_dim 64, 8 q heads per kv head; a free lane
    (length 0) gets zeros, as the TPU kernel writes."""
    q, k, v, meta = _case(dev, [0, 5, 16, 17, 64], 4, 16, 8, 1, 64, seed=6)
    out = rpa.ragged_paged_attention(q, k, v, meta)
    want = rpa.ragged_paged_attention_ref(q, k, v, meta)
    torch.cuda.synchronize()
    assert not out[0].any()
    err = (out[1:].float() - want[1:].float()).abs().max().item()
    assert err <= TOL, err


def test_decode_step_runs_the_kernel_once_per_layer(dev):
    """A StepwiseDecoder on the card: one decode step launches the kernel
    once per layer, and its logits match the plain-attention re-run of
    the same step within 1e-2 x max|logit| (bf16 residual stream)."""
    cfg = Config(vocab_size=384, hidden_size=256, num_layers=2, num_heads=4,
                 num_kv_heads=2, seq_length=256, intermediate_size=512,
                 prefill_chunk_size=32)
    engine = build_engine(cfg, device=dev, seed=0)
    dec = engine.make_stepwise(num_slots=3, page_size=16)
    for n in (5, 40, 100):
        slot = dec.acquire_slot()
        prompt = list(range(1, n + 1))
        st = dec.start_prefill(slot, prompt, max_new_tokens=4)
        if st is None:
            dec.prefill_into_slot(slot, prompt, max_new_tokens=4)
        else:
            while dec.advance_prefill(st) is None:
                pass
    before = rpa.ragged_paged_attention.launches
    got = dec.step_logits()
    assert rpa.ragged_paged_attention.launches == before + cfg.num_layers
    want = dec.step_logits("plain")
    assert rpa.ragged_paged_attention.launches == before + cfg.num_layers
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= 1e-2 * want.abs().max().item(), err
    toks, produced, eos = dec.decode_step()
    assert produced.sum() + eos.sum() == 3
