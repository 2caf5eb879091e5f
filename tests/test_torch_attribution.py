"""The port's performance attribution (monitoring/attribution.py) against
the JAX package's, and the kernels' own FLOP counts.

- `classify_op` over a table of the port's CUDA kernel names and profiler
  scopes (B1-B3's flash_* kernels, B4's grouped_kernel, the fused CE, MoE
  and attention scopes, copies, kernels outside every scope), and over
  JAX's own scope paths, where it answers as JAX's does.
- `attribute_trace` and `export_attribution` on the same rows: the same
  record and the same gauges (names, labels, values) as JAX's.
- `rows_from_torch_trace` / `attribute_torch_trace_dir` on a Chrome
  trace: scopes matched to kernels through the launch's correlation id on
  the launching thread, step marks left out, busy time the union of the
  device intervals.
- `analytic_train_flops`, `tree_bytes` and `donation_audit` equal JAX's.
- The kernel wrappers report, for each launch, the FLOPs chip_smoke.py's
  bounds count (`_band_pairs` x 4/6/8 x D for B1/B2/B3, `_gmm_bound` for
  B4a/B4b), only inside an open window: the launch itself stubbed, on CPU
  tensors that claim to be CUDA.
- `compiled_cost_metrics` runs one real train step on the CPU under the
  FLOP counter: the counter's FLOPs, the in-place audit's coverage 1.0,
  and the JAX result's keys.
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from luminaai_tpu.monitoring import attribution as jattr
from luminaai_tpu.monitoring.telemetry import MetricsRegistry as JRegistry
from luminaai_tpu_torch.monitoring import attribution as tattr
from luminaai_tpu_torch.monitoring.telemetry import MetricsRegistry
from luminaai_tpu_torch.ops import _flops
from luminaai_tpu_torch.ops import flash_attention as fa
from luminaai_tpu_torch.ops import gmm as tg

# (scope path, category, kernel name) -> subsystem, as the profiler names
# the port's kernels and the Trainer's trace reader builds the paths.
PORT_TABLE = [
    ("/attention/", "kernel",
     "void (anonymous namespace)::flash_fwd_wgmma_kernel<128, false>"
     "(FwdParams)", "attn_flash_kernels"),
    ("", "kernel", "void (anonymous namespace)::flash_bwd_dq_wgmma_kernel"
     "<192, false>(BwdParams)", "attn_flash_kernels"),
    ("", "kernel", "void flash_bwd_dkv_wgmma_hd256_kernel<256>(BwdParams)",
     "attn_flash_kernels"),
    ("/moe/experts/", "kernel",
     "void (anonymous namespace)::grouped_kernel<false>(GmmParams)",
     "moe_expert_matmul"),
    ("", "kernel", "void (anonymous namespace)::grouped_kernel<true>"
     "(GmmParams)", "moe_expert_matmul"),
    ("/fused_ce/", "kernel",
     "sm90_xmma_gemm_f32f32_tf32f32_f32_nt_n_tilesize128x128x32",
     "ce_loss"),
    ("/moe/", "kernel", "void at::native::radixSortKVInPlace<...>",
     "moe_route_dispatch"),
    ("/moe/experts/", "kernel",
     "void at::native::vectorized_elementwise_kernel<4, silu>",
     "moe_expert_matmul"),
    ("/attention/", "kernel", "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNT",
     "attn_proj_rope"),
    ("", "data formatting", "Memcpy HtoD (Pageable -> Device)",
     "data_formatting"),
    ("", "kernel", "void at::native::vectorized_elementwise_kernel<4, "
     "AddFunctor>", "unattributed(optimizer+dispatch_bwd)"),
    ("/sse_stream/", "kernel", "void at::native::reduce_kernel<512, 1>",
     "other"),
]

# JAX hlo_stats-style rows (framework op name, category, source).
JAX_ROWS = [
    ("jit(step)/transformer/layer_0/attention/pallas_call", "custom-call",
     ""),
    ("jit(step)/loss/bch,vh->bcv", "convolution", ""),
    ("jit(step)/layer_1/moe/egch,ehf->egcf", "convolution", ""),
    ("jit(step)/layer_1/moe/gather", "data formatting", ""),
    ("jit(step)/layer_0/attention/qkv_proj", "convolution", ""),
    ("", "loop fusion", ""),
    ("jit(step)/other/add", "loop fusion", ""),
    ("jit(step)/x", "fusion", "luminaai_tpu/ops/fused.py:120"),
    ("copy.3", "data formatting", ""),
]


@pytest.mark.parametrize("fw,cat,kernel,want", PORT_TABLE,
                         ids=[w + str(i) for i, (*_, w) in
                              enumerate(PORT_TABLE)])
def test_classify_port_kernels(fw, cat, kernel, want):
    assert tattr.classify_op(fw, cat, "", kernel) == want
    assert want in tattr.SUBSYSTEMS


def test_classify_jax_rows_as_jax_does():
    assert tattr.SUBSYSTEMS == jattr.SUBSYSTEMS
    for fw, cat, src in JAX_ROWS:
        assert tattr.classify_op(fw, cat, src) == jattr.classify_op(
            fw, cat, src), fw


def _metric_lines(registry) -> dict:
    out = {}
    for line in registry.render_prometheus().splitlines():
        if line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            out[key] = float(value)
    return out


def test_attribute_and_export_equal_jax(tmp_path):
    rng = np.random.RandomState(0)
    rows = [(fw, cat, src, float(rng.randint(10, 5000)),
             rng.choice(["compute", "memory", "?"]))
            for fw, cat, src in JAX_ROWS * 3]
    jrows = [jattr.OpRow(t, fw, cat, src, b) for fw, cat, src, t, b in rows]
    trows = [tattr.OpRow(t, fw, cat, src, b) for fw, cat, src, t, b in rows]
    ja = jattr.attribute_trace(jrows, n_steps=3, top_k=5)
    ta = tattr.attribute_trace(trows, n_steps=3, top_k=5)
    assert ta.to_dict() == ja.to_dict()
    jreg, treg = JRegistry(), MetricsRegistry()
    jrec = jattr.export_attribution(ja, jreg, str(tmp_path / "j.jsonl"))
    trec = tattr.export_attribution(ta, treg, str(tmp_path / "t.jsonl"))
    assert trec == jrec
    assert (tmp_path / "t.jsonl").read_text() == (
        tmp_path / "j.jsonl").read_text()
    assert _metric_lines(treg) == _metric_lines(jreg)


def _trace():
    """A Chrome trace as torch.profiler writes it: two threads' scopes,
    runtime launches with correlation ids, kernels, a copy."""
    ev = []

    def x(cat, name, ts, dur, tid=1, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "pid": 7,
                   "tid": tid, "ts": ts, "dur": dur, "args": args})

    x("user_annotation", "train_step 4", 0, 1000)
    x("user_annotation", "attention", 10, 100)
    x("user_annotation", "moe", 200, 300)
    x("user_annotation", "experts", 250, 100)
    x("user_annotation", "fused_ce", 600, 100)
    launches = [(20, "flash_fwd_wgmma_kernel<128, false>", 1, 30),
                (60, "nvjet_tst_128x256", 1, 40),
                (210, "radixSortKVInPlace", 1, 20),
                (260, "grouped_kernel<false>", 1, 50),
                (300, "vectorized_elementwise_kernel<silu>", 1, 10),
                (610, "sm90_xmma_gemm_f32f32", 1, 90),
                (800, "vectorized_elementwise_kernel<add>", 1, 25),
                (900, "flash_bwd_dq_wgmma_kernel<128, false>", 2, 35)]
    for i, (t, name, tid, dur) in enumerate(launches):
        x("cuda_runtime", "cudaLaunchKernel", t, 2, tid=tid, correlation=i)
        x("kernel", name, 1000 + 100 * i, dur, tid=99, correlation=i)
    x("cuda_runtime", "cudaMemcpyAsync", 5, 2, correlation=50)
    x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1005, 20, tid=98,
      correlation=50)
    return {"traceEvents": ev}


def test_torch_trace_rows_and_busy(tmp_path):
    rows, busy = tattr.rows_from_torch_trace(_trace())
    got = {r.kernel: (r.fw_name, tattr.classify_op(r.fw_name, r.category,
                                                   r.source, r.kernel))
           for r in rows}
    assert got["flash_fwd_wgmma_kernel<128, false>"] == (
        "/attention/", "attn_flash_kernels")
    assert got["nvjet_tst_128x256"] == ("/attention/", "attn_proj_rope")
    assert got["radixSortKVInPlace"] == ("/moe/", "moe_route_dispatch")
    assert got["grouped_kernel<false>"][1] == "moe_expert_matmul"
    assert got["vectorized_elementwise_kernel<silu>"] == (
        "/moe/experts/", "moe_expert_matmul")
    assert got["sm90_xmma_gemm_f32f32"] == ("/fused_ce/", "ce_loss")
    assert got["vectorized_elementwise_kernel<add>"] == (
        "", "unattributed(optimizer+dispatch_bwd)")
    # Another thread's launch sees none of thread 1's scopes.
    assert got["flash_bwd_dq_wgmma_kernel<128, false>"][0] == ""
    assert got["Memcpy HtoD (Pageable -> Device)"][1] == "data_formatting"
    # Busy: the copy [1005, 1025] overlaps the first kernel [1000, 1030].
    assert busy == sum(r.self_time_us for r in rows) - 20
    (tmp_path / "steps4-6.pt.trace.json").write_text(json.dumps(_trace()))
    attr = tattr.attribute_torch_trace_dir(str(tmp_path), n_steps=2)
    assert attr.n_steps == 2
    assert attr.total_ms_per_step == pytest.approx(
        sum(r.self_time_us for r in rows) / 2 / 1e3)
    assert attr.device_busy_ms_per_step == pytest.approx(busy / 2 / 1e3)
    assert attr.ms_per_step["attn_flash_kernels"] == pytest.approx(
        (30 + 35) / 2 / 1e3)


def test_analytic_flops_tree_bytes_and_donation_equal_jax():
    assert tattr.analytic_train_flops(123_456, 4096) == (
        jattr.analytic_train_flops(123_456, 4096))
    shapes = [((3, 5), "float32"), ((7,), "bfloat16"), ((2, 2, 2), "int8"),
              ((4,), "int32")]
    import jax.numpy as jnp

    jtree = [jnp.zeros(s, d) for s, d in shapes]
    ttree = {"a": [torch.zeros(s, dtype=getattr(torch, d))
                   for s, d in shapes[:2]],
             "b": tuple(torch.zeros(s, dtype=getattr(torch, d))
                        for s, d in shapes[2:])}
    assert tattr.tree_bytes(ttree) == jattr.tree_bytes(jtree)
    for alias in (1000.0, 950.0, 10.0):
        mem = {"alias_bytes": alias, "temp_bytes": 300.0}
        want = jattr.donation_audit(mem, 1000, registry=JRegistry())
        got = tattr.donation_audit(mem, 1000, registry=MetricsRegistry())
        assert got == want


@pytest.mark.parametrize("shape,window", [
    ((2, 256, 4, 2, 128), 0), ((1, 200, 4, 1, 64), 64),
    ((2, 128, 6, 2, 192), 0)])
def test_flash_launch_flops_match_chip_smoke(shape, window):
    b, s, hq, hkv, d = shape
    pairs = b * hq * chip_smoke._band_pairs(s, True, window)
    for kern, per in (("B1", 4), ("B2", 6), ("B3", 8)):
        assert fa.launch_flops(kern, b, s, s, hq, d, True, window) == (
            per * d * pairs)
    assert fa.band_pairs(s, s, False, 0) == chip_smoke._band_pairs(
        s, False, 0)


def test_gmm_launch_flops_match_chip_smoke():
    kept, k, n = 9000 + 8100, 1024, 2816
    for tgmm in (False, True):
        flops = chip_smoke._gmm_bound(kept, 2, k, n, 8, 17408, tgmm)[2]
        assert tg.launch_flops(kept, k, n) == flops


class FakeCuda(torch.Tensor):
    """A CPU tensor that claims to be on the card (the wrappers' gates)."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def stub_launch(monkeypatch):
    calls = []

    class Stream:
        cuda_stream = 0

    def kernel(name, *rest):
        def fn(*args):
            calls.append(name)
            return 0
        return fn

    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    monkeypatch.setattr(fa, "_kernel", kernel)
    monkeypatch.setattr(tg, "_kernel", kernel)
    return calls


def _fake(t):
    return t.contiguous().as_subclass(FakeCuda)


def test_wrappers_report_launch_flops_in_a_window(stub_launch):
    B, S, Hq, Hkv, D = 1, 256, 4, 2, 64
    q = _fake(torch.zeros(B, S, Hq, D, dtype=torch.bfloat16))
    k = _fake(torch.zeros(B, S, Hkv, D, dtype=torch.bfloat16))
    v = _fake(torch.zeros(B, S, Hkv, D, dtype=torch.bfloat16))
    stat = _fake(torch.zeros(B, Hq, S, dtype=torch.float32))
    lhs = _fake(torch.zeros(64, 32, dtype=torch.bfloat16))
    rhs = _fake(torch.zeros(4, 32, 16, dtype=torch.bfloat16))
    gs = _fake(torch.tensor([10, 0, 20, 5], dtype=torch.int32))
    args = dict(scale=0.125, causal=True, window=0)
    fa.flash_fwd(q, k, v, **args)  # outside a window: nothing counted
    with _flops.kernel_flops() as w:
        fa.flash_fwd(q, k, v, **args)
        fa.flash_bwd_dq(q, k, v, q, stat, stat, **args)
        fa.flash_bwd_dkv(q, k, v, q, stat, stat, **args)
        tg.gmm(lhs, rhs, gs)
        tg.tgmm(lhs.t(), _fake(torch.zeros(64, 16, dtype=torch.bfloat16)),
                gs)
    got = _flops.totals(w)
    pairs = B * Hq * chip_smoke._band_pairs(S, True, 0)
    assert got == {"B1": 4 * D * pairs, "B2": 6 * D * pairs,
                   "B3": 8 * D * pairs, "B4a": 2 * 35 * 32 * 16,
                   "B4b": 2 * 35 * 32 * 16}
    assert len(stub_launch) == 6
    assert not _flops.active()


def test_compiled_cost_metrics_on_a_cpu_step(tmp_path):
    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.config import ConfigPresets
    from luminaai_tpu_torch.training.trainer import Trainer

    cfg = ConfigPresets.get("debug", use_moe=False, seq_length=32,
                            batch_size=2, gradient_accumulation_steps=1,
                            slo=False, output_dir=str(tmp_path))
    trainer = Trainer(cfg, cli._synthetic_batches(cfg), device="cpu",
                      seed=0)
    batch = trainer._to_device(next(iter(cli._synthetic_batches(cfg)())))
    reg = MetricsRegistry()
    out = {}

    def step():
        trainer.state, out["m"] = trainer.train_step(trainer.state, batch)

    res = tattr.compiled_cost_metrics(
        step, registry=reg, state=trainer.state,
        analytic_flops=tattr.analytic_train_flops(
            cfg.estimate_active_parameters(), 64))
    trainer.close()
    assert res["available"] and res["cost_model"]["kernel_flops"] == {}
    assert res["cost_model"]["flops_per_step"] == res["cost_model"][
        "aten_flops"] > 0
    assert set(res["mfu_crosscheck"]) == {
        "analytic_flops_per_step", "compiled_flops_per_step", "divergence",
        "flagged", "threshold"}
    assert "loss" in out["m"]
    # The call was the step: the count moved and the moments hold it.
    assert trainer.state.step == 1
    assert any(t.abs().sum() > 0 for t in trainer.state.opt_state.tensors())
    audit = tattr.donation_audit(res["memory"],
                                 tattr.tree_bytes(trainer.state),
                                 registry=reg)
    assert audit["coverage"] == 1.0 and not audit["flagged"]
    names = {line.split("{")[0] for line in _metric_lines(reg)}
    assert {"compiled_flops_per_step", "analytic_flops_per_step",
            "compiled_mfu_divergence", "donation_alias_coverage"} <= names
