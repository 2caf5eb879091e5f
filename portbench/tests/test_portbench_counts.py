"""The yardstick's operation and byte counts against hand-worked shapes,
and the trace reader against a hand-made trace."""

from __future__ import annotations

import pytest

from portbench.lib import flops, trace
from portbench.lib.flops import Shapes

B1 = Shapes(vocab=50304, hidden=2048, layers=8, heads=16, kv_heads=4,
            head_dim=128, ffn=5504, experts=8, top_k=2)


def test_shapes_read_the_configuration():
    s = flops.shapes({"vocab_size": 50304, "hidden_size": 2048,
                      "num_layers": 8, "num_heads": 16, "num_kv_heads": 4,
                      "use_moe": True, "num_experts": 8, "moe_top_k": 2})
    assert s == B1  # intermediate 8/3 x 2048 = 5461 -> 5504


def test_forward_flops_by_hand():
    # One layer, hidden 4, 2 heads of 2 (1 kv head), ffn 3, dense, vocab
    # 5, sequence 3: per token 2*4*(2+2)*2 (wqkv) + 2*2*2*4 (wo) + 2*4*6
    # + 2*3*4 (SwiGLU) = 64 + 32 + 48 + 24 = 168; attention 4*2*2*6 =
    # 96 over the 6 causal pairs; head 2*4*5 = 40 a token.
    s = Shapes(vocab=5, hidden=4, layers=1, heads=2, kv_heads=1,
               head_dim=2, ffn=3, experts=0, top_k=0)
    assert flops.forward_flops_per_sequence(s, 3) == 168 * 3 + 96 + 40 * 3
    moe = Shapes(vocab=5, hidden=4, layers=1, heads=2, kv_heads=1,
                 head_dim=2, ffn=3, experts=8, top_k=2)
    # router 2*4*8 = 64, two experts 2 * 72 = 144 a token.
    assert flops.forward_flops_per_sequence(moe, 3) == (
        (64 + 32 + 64 + 144) * 3 + 96 + 40 * 3)
    assert flops.train_step_flops(s, 2, 3) == 3 * 2 * (
        168 * 3 + 96 + 40 * 3)


def test_flash_bound_at_b1_micro_batch():
    # B1 at q [2, 2048, 16, 128]: 4 x 128 x 2 x 16 x 2048*2049/2 FLOPs.
    f = 4 * 128 * 2 * 16 * 2098176
    assert flops.flash_bound_s("B1", B1, 2, 2048) == pytest.approx(
        f / 989e12)
    assert flops.flash_bound_s("B3", B1, 2, 2048) == pytest.approx(
        2 * f / 989e12)


def test_gmm_bound_at_b1_micro_batch():
    rows = 2 * 2048 * 2
    wi = 2.0 * rows * 2048 * 11008
    wo = 2.0 * rows * 5504 * 2048
    got = flops.gmm_step_bound_s(B1, 2, 2048, recompute_ffn=True)
    # Every product is compute bound at these shapes.
    assert got["B4a"] == pytest.approx((2 * (wi + wo) + wo + wi) / 989e12)
    assert got["B4b"] == pytest.approx((wo + wi) / 989e12)
    assert flops.gmm_launches(True) == {"B4a": 6, "B4b": 2}


def test_lm_head_chunk_by_hand():
    got = flops.lm_head_chunk(B1, 512)
    assert got["flops"] == 2.0 * 512 * 2048 * 50304
    assert got["bytes"] == 512 * 2048 * 2 + 50304 * 2048 * 4 + 512 * 50304 * 4
    assert got["bound_s"] == pytest.approx(max(got["flops"] / 989e12,
                                               got["bytes"] / 3.35e12))


def _ev(cat, name, ts, dur, **kw):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": kw.pop("pid", 1), "tid": kw.pop("tid", 1),
            "args": kw}


def test_trace_reader_scopes_busy_and_kernels():
    events = [
        _ev("user_annotation", "portbench_window", 0, 100),
        _ev("user_annotation", "fused_ce", 10, 20),
        _ev("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 40, 1, correlation=2),
        _ev("kernel", "sgemm", 20, 10, pid=0, tid=7, correlation=1),
        _ev("kernel", "void (anonymous namespace)::grouped_kernel<128, 256,"
            " 2>(x)", 25, 10, pid=0, tid=7, correlation=2),
        _ev("kernel", "flash_fwd_wgmma_kernel<128, false>", 60, 5, pid=0,
            tid=7, correlation=3),
    ]
    tr = trace.read_trace({"traceEvents": events})
    assert tr.device[0].scopes == ["portbench_window", "fused_ce"]
    assert tr.device[1].scopes == ["portbench_window"]
    assert trace.busy_us(tr) == 15 + 5  # [20, 35] and [60, 65]
    assert trace.kernel_launches(tr) == {"B4b": 1, "B1": 1}
    assert trace.scope_time_s(tr, "fused_ce") == pytest.approx(10e-6)
    assert trace.scope_count(tr, "fused_ce") == 1
    bd = trace.breakdown(tr, 0, 100)
    assert bd["device_ops"][0][1] == pytest.approx(10e-6)
    idle = dict(bd["idle_gaps"])
    assert sum(idle.values()) == pytest.approx(80e-6)
