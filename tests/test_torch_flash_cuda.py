"""The flash-attention kernels B1-B3 on the card (marked `cuda`; skip here).

csrc/flash_attention.cu has no CPU mode, so these run only where
torch.cuda.is_available(); chip_smoke.py repeats the comparison at the
training shapes. This file imports nothing of JAX, so it also runs on a
machine that has torch and a card only:

    python -m pytest tests/test_torch_flash_cuda.py -q --noconftest

Inputs are bf16 draws of a standard normal. Tolerances, kernel vs plain
version on the same bf16 inputs:
- O, dQ, dK, dV (bf16 outputs): 2e-2 x max|plain|. bf16 keeps 8
  significant bits (2^-8 = 3.9e-3 relative); both sides round P (and dS)
  to bf16, but the kernel rounds P against a running 64-column maximum
  and the plain version against the row's maximum, and the fp32 sums run
  in other orders, so elements differ by a few bf16 ulps of the largest.
- lse (fp32 on both sides from the same fp32 scores): 1e-4 absolute.
"""

import numpy as np
import pytest
import torch

from luminaai_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

REL = 2e-2
LSE_TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, B, Sq, Hq, Hkv, D, Skv=None, seed=0):
    Skv = Sq if Skv is None else Skv
    rng = np.random.RandomState(seed)
    shapes = [(B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D),
              (B, Sq, Hq, D)]
    q, k, v, do = (torch.as_tensor(rng.randn(*s).astype(np.float32)).to(
        dev, torch.bfloat16) for s in shapes)
    g_lse = torch.as_tensor(rng.randn(B, Hq, Sq).astype(np.float32)).to(dev)
    return q, k, v, do, g_lse


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


CASES = {
    # name: (B, Sq, Hq, Hkv, D, causal, window[, Skv]); Skv = Sq unless given
    "causal_g4_d128": (2, 256, 8, 2, 128, True, 0),
    "causal_g8_d128": (1, 256, 8, 1, 128, True, 0),
    "window100_g4_d64": (1, 512, 4, 1, 64, True, 100),
    "window128_g2_d128": (1, 512, 4, 2, 128, True, 128),
    "noncausal_g1_d64": (2, 128, 2, 2, 64, False, 0),
    "noncausal_g2_d128": (1, 256, 4, 2, 128, False, 0),
    # Shapes the JAX gate admits beyond the first kernels' tiling:
    # debug_300m's attention (head_dim 192, group 2, S 1024), a length
    # that is not a multiple of 128, groups of 3 and 16, head_dim 256.
    "causal_g2_d192_s1024": (1, 1024, 4, 2, 192, True, 0),
    "causal_g4_d128_s200": (2, 200, 8, 2, 128, True, 0),
    "causal_g3_d64": (1, 384, 6, 2, 64, True, 0),
    "window50_g3_d128_s200": (1, 200, 3, 1, 128, True, 50),
    "noncausal_g3_d192_s200": (1, 200, 6, 2, 192, False, 0),
    "causal_g16_d256": (1, 256, 16, 1, 256, True, 0),
    # Above head_dim 256 (the 64-column slice kernels): 320 and 512, a
    # window, a partial tile, a group of 3, non-causal.
    "causal_g2_d320_s200": (1, 200, 4, 2, 320, True, 0),
    "window70_g3_d512": (1, 256, 3, 1, 512, True, 70),
    "noncausal_g1_d384": (1, 128, 2, 2, 384, False, 0),
    # The wgmma forward's partial tiles and windows at the main path's
    # head dims and groups: d64 group 2 (flagship MoE), d128 group 4 (b1).
    "causal_g2_d64_s200": (1, 200, 4, 2, 64, True, 0),
    "window64_g2_d64": (2, 512, 4, 2, 64, True, 64),
    "window64_g4_d128_s200": (2, 200, 8, 2, 128, True, 64),
    # The wgmma backward (B2, B3) at the main path's head dims and groups:
    # one b1-like sequence (16 kv tiles, the first with 16 times the last
    # one's causal band), flagship-like group 2 at head_dim 64, a
    # non-causal partial length, and a window over more kv rows than q rows
    # (kv tiles that no q row sees: dK = dV = 0 there).
    "causal_g4_d128_s2048": (1, 2048, 16, 4, 128, True, 0),
    "causal_g2_d64_s1024": (1, 1024, 16, 8, 64, True, 0),
    "noncausal_g4_d128_s200": (1, 200, 8, 2, 128, False, 0),
    "window64_g2_d64_skv512": (1, 256, 4, 2, 64, True, 64, 512),
    # The wgmma B2 at groups that do not divide its 128 rows (padding
    # rows): debug_200m's 3, b14's 5, 6 and 12, a partial length, a
    # window, non-causal, and a group above 128 in two head chunks.
    "causal_g3_d64_s2048": (1, 2048, 12, 4, 64, True, 0),
    "causal_g5_d128_s1000": (1, 1000, 10, 2, 128, True, 0),
    "window90_g6_d64_s500": (2, 500, 12, 2, 64, True, 90),
    "noncausal_g12_d128_s137": (1, 137, 12, 1, 128, False, 0),
    "causal_g130_d64_s64": (1, 64, 130, 1, 64, True, 0),
    # Lengths that are no multiple of 4: B3's lse and delta rows start off
    # a 16-byte boundary, which a TMA box may not (copied by its loading
    # thread instead).
    "causal_g2_d64_s130": (1, 130, 4, 2, 64, True, 0),
    "window40_g4_d128_s201": (1, 201, 8, 2, 128, True, 40),
    # The wgmma B1 at groups that do not tile its rows (padding rows; 128
    # rows, 192 at head_dim 64): b14's 5, b100's 10, b200's 12, 5 at head
    # dims 64, 192 and 256, 3 at 192 and 256, and groups above the rows in
    # two head chunks.
    "causal_g5_d64_s700": (1, 700, 10, 2, 64, True, 0),
    "causal_g10_d128_s600": (1, 600, 10, 1, 128, True, 0),
    "window100_g12_d128_s500": (1, 500, 24, 2, 128, True, 100),
    "causal_g3_d192_s300": (1, 300, 6, 2, 192, True, 0),
    "noncausal_g5_d192_s256": (1, 256, 5, 1, 192, False, 0),
    "causal_g3_d256_s256": (1, 256, 3, 1, 256, True, 0),
    "window80_g5_d256_s400": (2, 400, 10, 2, 256, True, 80),
    "causal_g130_d128_s64": (1, 64, 130, 1, 128, True, 0),
    "causal_g200_d64_s40": (1, 40, 200, 1, 64, True, 0),
    # The wgmma B3 at head_dim 192 and 256: lengths that are no multiple of
    # 4 under a window, and grids that fill the card (no cluster split).
    "window40_g2_d192_s137": (1, 137, 4, 2, 192, True, 40),
    "window40_g4_d256_s137": (1, 137, 4, 1, 256, True, 40),
    "causal_g2_d192_s2048": (4, 2048, 4, 2, 192, True, 0),
    "causal_g2_d256_s2048": (2, 2048, 8, 4, 256, True, 0),
    # The wgmma B2 at head_dim 192 and 256 (2 stages of 64-row K/V tiles,
    # 3 of 32-row tiles): a non-causal Skv that is no multiple of either
    # beside a shorter Sq, and a group above 128 rows at 192 (a second head
    # chunk of one head, the rest padding).
    "noncausal_g2_d256_s137_skv200": (1, 137, 4, 2, 256, False, 0, 200),
    "causal_g129_d192_s64": (1, 64, 129, 1, 192, True, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_match_plain(dev, case):
    B, S, Hq, Hkv, D, causal, window, *skv = CASES[case]
    q, k, v, do, g_lse = _inputs(dev, B, S, Hq, Hkv, D, *skv)
    args = dict(scale=D ** -0.5, causal=causal, window=window)
    n0 = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
          fa.flash_bwd_dkv.launches)
    o, lse = fa.flash_fwd(q, k, v, **args)
    o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, **args)
    delta = ((do.float() * o_ref.float()).sum(-1).transpose(1, 2)
             - g_lse).contiguous()
    dq = fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, **args)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, **args)
    dq_ref = fa.flash_bwd_dq_ref(q, k, v, do, lse_ref, delta, **args)
    dk_ref, dv_ref = fa.flash_bwd_dkv_ref(q, k, v, do, lse_ref, delta, **args)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == tuple(n + 1 for n in n0)
    errs = {
        "o": _rel_err(o, o_ref),
        "dq": _rel_err(dq, dq_ref),
        "dk": _rel_err(dk, dk_ref),
        "dv": _rel_err(dv, dv_ref),
    }
    lse_err = (lse - lse_ref).abs().max().item()
    print(case, errs, "lse", lse_err)
    for t in (o, dq, dk, dv):
        assert torch.isfinite(t.float()).all()
    assert lse_err <= LSE_TOL, lse_err
    assert max(errs.values()) <= REL, errs


@pytest.mark.parametrize("case", ["causal_g4_d128", "causal_g3_d64",
                                  "causal_g2_d192_s1024",
                                  "causal_g2_d320_s200"])
def test_last_kernel_names_the_launched_kernel(dev, case):
    """fa.last_kernel names the kernel family each entry takes at the
    shape (wgmma up to head_dim 256, B3's hd256 kernel above 128, the
    slice kernels above 256), and the profiler's name for the same call
    where the profiler records it."""
    from torch.profiler import ProfilerActivity, profile

    B, S, Hq, Hkv, D, causal, window, *skv = CASES[case]
    q, k, v, do, g_lse = _inputs(dev, B, S, Hq, Hkv, D, *skv)
    args = dict(scale=D ** -0.5, causal=causal, window=window)
    o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, **args)
    delta = ((do.float() * o_ref.float()).sum(-1).transpose(1, 2)
             - g_lse).contiguous()
    family = {"B1": "flash_fwd_wgmma_kernel<",
              "B2": "flash_bwd_dq_wgmma_kernel<",
              "B3": ("flash_bwd_dkv_wgmma_kernel<" if D <= 128
                     else "flash_bwd_dkv_wgmma_hd256_kernel<")}
    if D > 256:
        family = {"B1": "flash_fwd_wide_kernel",
                  "B2": "flash_bwd_dq_wide_kernel",
                  "B3": "flash_bwd_dkv_wide_kernel"}
    for kern, call in (
            ("B1", lambda: fa.flash_fwd(q, k, v, **args)),
            ("B2", lambda: fa.flash_bwd_dq(q, k, v, do, lse_ref, delta,
                                           **args)),
            ("B3", lambda: fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta,
                                            **args))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        named = {e.key.replace("(anonymous namespace)::", "").split("(")[0]
                 .replace("void ", "").strip() for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
        got = fa.last_kernel(kern)
        assert got.startswith(family[kern]), (kern, got)
        assert not named or named == {got}, (kern, named, got)


def test_autograd_function_matches_autograd_through_plain(dev):
    """FlashAttention (kernels, lse cotangent folded into delta) against
    torch autograd through the plain forward, both outputs used."""
    q, k, v, do, g_lse = _inputs(dev, 2, 256, 4, 2, 128, seed=3)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = fa.flash_attention_with_lse(*leaves, window=200)
    ((o.float() * do.float()).sum() + (lse * g_lse).sum()).backward()
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    o_ref, lse_ref = fa.flash_fwd_ref(*plain, scale=128 ** -0.5,
                                      window=200)
    ((o_ref.float() * do.float()).sum() + (lse_ref * g_lse).sum()).backward()
    torch.cuda.synchronize()
    assert _rel_err(o, o_ref) <= REL
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL
    for got, want in zip(leaves, plain):
        assert _rel_err(got.grad, want.grad) <= REL, _rel_err(got.grad,
                                                              want.grad)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q, k, v, do, _ = _inputs(dev, 1, 256, 4, 2, 128)
    args = dict(scale=0.1)
    n0 = fa.flash_fwd.launches
    with pytest.raises(ValueError, match="bf16"):
        fa.flash_fwd(q.float(), k.float(), v.float(), **args)
    with pytest.raises(ValueError, match="strided"):
        fa.flash_fwd(q, k.transpose(1, 2).contiguous().transpose(1, 2), v,
                     **args)
    q96, k96, v96, _, _ = _inputs(dev, 1, 256, 2, 2, 96)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q96, k96, v96, **args)
    q32, k32, v32, _, _ = _inputs(dev, 1, 256, 2, 2, 32)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q32, k32, v32, **args)
    lse = torch.zeros(1, 4, 256, device=dev)
    with pytest.raises(ValueError, match="fp32"):
        fa.flash_bwd_dq(q, k, v, do, lse.half(), lse, **args)
    assert fa.flash_fwd.launches == n0
