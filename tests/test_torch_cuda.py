"""The port's decode-attention (B5) and grouped-matmul (B4) kernels on the
card (marked `cuda`; skip without one).

The CUDA kernels have no CPU mode, so these run only where
torch.cuda.is_available(); chip_smoke.py runs the same checks at the b1
serving and MoE training shapes. This file imports nothing of JAX, so it
also runs on a machine that has torch and a card only:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerances, kernel vs plain version in bf16:
- B5: 3e-2 absolute on outputs of magnitude <= max|v| ~ 4.5 (bf16 keeps 8
  significant bits; the kernel keeps fp32 scores and rounds the
  unnormalised P to bf16, the plain version rounds the scores and the
  normalised P).
- B4: 1e-2 x max|plain|. Both sides accumulate in fp32 and round once to
  bf16 (2^-8 relative), the sums in other orders, so an element may round
  to the neighbouring bf16 value. Rows past sum(group_sizes) and empty
  groups are exactly zero.
"""

import numpy as np
import pytest
import torch

from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.inference.chat import build_engine
from luminaai_tpu_torch.ops import gmm as tg
from luminaai_tpu_torch.ops import ragged_paged_attention as rpa

pytestmark = pytest.mark.cuda

TOL = 3e-2
GMM_REL = 1e-2


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


def test_kernel_takes_any_group(dev):
    """16 and 12 q heads per kv head (the JAX gate admits any group): the
    group splits over chunks of 8 heads, each matching the plain version;
    and head_dim 576 and 1024 (the gate admits any multiple of 64), in
    512-column output slices."""
    for hq, hkv, d in ((16, 1, 128), (24, 2, 128), (4, 2, 576), (16, 2, 1024)):
        q, k, v, meta = _case(dev, [3, 100, 256], 2, 128, hq, hkv, d, seed=7)
        out = rpa.ragged_paged_attention(q, k, v, meta)
        want = rpa.ragged_paged_attention_ref(q, k, v, meta)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        assert err <= TOL, (hq, hkv, d, err)


# The split-KV kernel's boundaries: a cluster of up to 8 blocks splits
# each lane's band in 64-row tiles (32 above head_dim 128, 16 above 256),
# block `rank` taking tiles [T * rank / n, T * (rank + 1) / n).
SPLIT_CASES = {
    # name: (lengths, pages, page size, Hq, Hkv, D, window)
    # Lengths on both sides of a tile and of the shares of 8 blocks; most
    # lanes leave some blocks an empty share.
    "straddle": ([1, 63, 64, 65, 255, 256, 257, 2048], 16, 128, 16, 4, 128, None),
    # The window's first row inside a share and inside a tile.
    "window_in_share": ([700, 1500, 2048, 333], 16, 128, 16, 4, 128, 333),
    # Free lanes (length 0) beside full lanes: zeros, as the TPU kernel.
    "zero_beside_full": ([0, 2048, 0, 2048], 16, 128, 8, 2, 128, None),
    # A group of 16 q heads in one block (the A rows of its products).
    "group16": ([5, 1000, 2048], 16, 128, 16, 1, 128, None),
    # head_dim 64 (2 column pairs over the warps), 256 (32-row tiles) and
    # 512 (16-row tiles), small pages.
    "d64_pages16": ([17, 130, 511], 32, 16, 8, 2, 64, 100),
    "d256": ([3, 200, 640], 8, 128, 8, 2, 256, None),
    "d512": ([9, 300, 512], 4, 128, 4, 1, 512, 257),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_kv_boundaries(dev, case):
    lengths, P, ps, hq, hkv, d, window = SPLIT_CASES[case]
    q, k, v, meta = _case(dev, lengths, P, ps, hq, hkv, d, window=window,
                          seed=8)
    out = rpa.ragged_paged_attention(q, k, v, meta)
    want = rpa.ragged_paged_attention_ref(q, k, v, meta)
    torch.cuda.synchronize()
    live = torch.as_tensor(lengths, device=dev) > 0
    assert not out[~live].any()
    err = (out[live].float() - want[live].float()).abs().max().item()
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


GMM_CASES = {
    # name: (M, K, N, group sizes): the b1 decode shape cut narrow (16
    # pairs over 8 experts in a 128-row buffer), ragged groups with an
    # empty one and a tail, K and N that are not multiples of the tiles
    # (64-deep stages, 64 x 128 or 128 x 256 output tiles).
    "decode": (128, 256, 512, [2, 3, 1, 0, 4, 2, 3, 1]),
    "ragged_tail": (384, 200, 328, [100, 0, 130, 36]),
    "full": (256, 64, 96, [128, 0, 96, 32]),
    # Group starts off every tile multiple, a one-row group, a group that
    # ends one row into a 128-row tile, M not a multiple of 128.
    "odd_starts": (1000, 136, 264, [37, 1, 129, 0, 250, 65, 300]),
    # 128 x 256 tiles many times the SM count (the persistent blocks walk
    # several tiles each), ragged groups, one ending a row into a tile
    # (2945 = 23 x 128 + 1), a tail of 311 rows.
    "many_tiles": (16384, 520, 2056, [3000, 1, 2500, 0, 4127, 2945, 3500]),
}


def _bf16(dev, rng, *shape):
    return torch.as_tensor(rng.randn(*shape).astype(np.float32)).to(
        dev, torch.bfloat16)


def _gmm_rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("transpose_rhs", [False, True], ids=["nn", "nt"])
@pytest.mark.parametrize("case", sorted(GMM_CASES))
def test_gmm_kernels_match_plain(dev, case, transpose_rhs):
    M, K, N, sizes = GMM_CASES[case]
    E, kept = len(sizes), sum(sizes)
    rng = np.random.RandomState(11)
    lhs = _bf16(dev, rng, M, K)
    rhs = _bf16(dev, rng, *((E, N, K) if transpose_rhs else (E, K, N)))
    dout = _bf16(dev, rng, M, N)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    n0 = (tg.gmm.launches, tg.tgmm.launches)
    out = tg.gmm(lhs, rhs, gs, transpose_rhs=transpose_rhs)
    drhs = tg.tgmm(lhs.t(), dout, gs)
    torch.cuda.synchronize()
    assert (tg.gmm.launches, tg.tgmm.launches) == (n0[0] + 1, n0[1] + 1)
    want = tg.gmm_ref(lhs, rhs, gs, transpose_rhs=transpose_rhs)
    want_drhs = tg.tgmm_ref(lhs.t(), dout, gs)
    assert _gmm_rel(out[:kept], want[:kept]) <= GMM_REL
    assert not out[kept:].any()
    assert _gmm_rel(drhs, want_drhs) <= GMM_REL
    for g, n in enumerate(sizes):
        if n == 0:
            assert not drhs[g].any()


def test_grouped_matmul_autograd_on_card(dev):
    """GroupedMatmul's VJP (gmm with transpose_rhs, tgmm) on the card
    against the same Function through the plain versions on the CPU."""
    M, K, N, sizes = GMM_CASES["ragged_tail"]
    rng = np.random.RandomState(12)
    lhs, rhs = _bf16(dev, rng, M, K), _bf16(dev, rng, len(sizes), K, N)
    ct = _bf16(dev, rng, M, N)
    grads = []
    for where in (dev, torch.device("cpu")):
        gs = torch.tensor(sizes, dtype=torch.int32, device=where)
        l = lhs.detach().clone().to(where).requires_grad_()
        r = rhs.detach().clone().to(where).requires_grad_()
        (tg.grouped_matmul(l, r, gs).float() * ct.to(where).float()
         ).sum().backward()
        grads.append((l.grad.cpu(), r.grad.cpu()))
    torch.cuda.synchronize()
    kept = sum(sizes)
    assert _gmm_rel(grads[0][0][:kept], grads[1][0][:kept]) <= GMM_REL
    assert not grads[0][0][kept:].any()
    assert _gmm_rel(grads[0][1], grads[1][1]) <= GMM_REL


def test_gmm_wrapper_refuses_what_the_kernels_do_not_take(dev):
    rng = np.random.RandomState(13)
    lhs, rhs = _bf16(dev, rng, 128, 64), _bf16(dev, rng, 2, 64, 96)
    gs = torch.tensor([60, 40], dtype=torch.int32, device=dev)
    n0 = tg.gmm.launches
    with pytest.raises(ValueError, match="bf16"):
        tg.gmm(lhs.float(), rhs.float(), gs)
    with pytest.raises(ValueError, match="int32"):
        tg.gmm(lhs, rhs, gs.long())
    with pytest.raises(ValueError, match="multiple of 8"):
        tg.gmm(_bf16(dev, rng, 128, 60), _bf16(dev, rng, 2, 60, 96), gs)
    assert tg.gmm.launches == n0
