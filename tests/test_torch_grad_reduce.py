"""The port's hierarchical gradient reduction (parallel/grad_reduce.py) in
4 gloo processes.

  - GradReducePlan byte counts and bucket layout equal the JAX package's
    make_grad_reduce_plan (exact), and it refuses what JAX refuses;
  - hierarchical_grad_sync over dp4 (one stage, and 2 nodes x 2 cards)
    and dp2 x fsdp2 (2 nodes) equals a flat all-reduce of the same
    gradients within 1e-6 of their magnitude, in fp32, over several
    buckets; with the cross-node hop in bf16 it equals the flat sum
    within 1e-6 where every in-node partial sum is a bf16 value, and
    within bf16's rounding (2^-8 relative) otherwise. The sync is held
    against a flat all-reduce, not against JAX's hierarchical sync
    (ROADMAP C1: JAX's own dp4_fsdp2 sync fails its test);
  - the hierarchical train step (make_hierarchical_grad_fn) equals the
    port's one-rank step (dense widths of tests/test_torch_sharded_step.py,
    rtol 1e-5; parameters as there), at dp4 over 2 nodes and dp2 x
    fsdp2;
  - grad_reduce_probe times a sync and reports its stage.
The ranks are spawned once for the file (tests/torch_mesh_harness.py).
"""

import numpy as np
import pytest

from luminaai_tpu.parallel import grad_reduce as jgr
from luminaai_tpu_torch.parallel import grad_reduce as tgr
from torch_mesh_harness import (
    Ranks,
    assert_close_trace,
    assert_params,
    port_cases,
)

ARCH = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, seq_length=32, intermediate_size=128,
            precision="fp32", batch_size=8, grad_clip_norm=0.5,
            learning_rate=1e-3, warmup_ratio=0.25,
            gradient_checkpointing=False, use_flash_attention=False,
            use_moe=False, grad_reduce="hierarchical",
            grad_reduce_bucket_mb=0.02, grad_reduce_overlap_chunks=3)
CASES = {
    "dp4_dcn2": dict(gradient_dcn_size=2),
    "dp2_fsdp2_dcn2": dict(data_parallel_size=2, fsdp_parallel_size=2,
                           gradient_dcn_size=2),
}
MESHES = {  # (config fields, gradient_dcn_size)
    "dp4": (dict(), 1),
    "dp4_dcn2": (dict(), 2),
    "dp2_fsdp2_dcn2": (dict(data_parallel_size=2, fsdp_parallel_size=2), 2),
}
PLANS = [
    dict(grad_elems=1000, data_size=4, fsdp_size=2, dcn_size=2),
    dict(grad_elems=123457, data_size=8, fsdp_size=1, dcn_size=4,
         bucket_mb=0.1, overlap_chunks=3, dcn_dtype="bf16"),
    dict(grad_elems=7, data_size=2, fsdp_size=2, overlap_chunks=16),
    dict(grad_elems=10 ** 7, data_size=16, fsdp_size=8, dcn_size=4,
         bucket_mb=8.0),
]


def _batches(n=2):
    out = []
    for s in range(n):
        rng = np.random.RandomState(30 + s)
        out.append({"input_ids": rng.randint(
            1, ARCH["vocab_size"], (ARCH["batch_size"], ARCH["seq_length"])
        ).astype(np.int64)})
    return out


def _init():
    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.convert import init_params
    from luminaai_tpu_torch.models.transformer import LuminaTransformer

    cfg = Config(**{k: v for k, v in ARCH.items() if "grad_reduce" not in k})
    m = init_params(LuminaTransformer(cfg, device="cpu", trainable=True), 0)
    return {n: p.detach().clone() for n, p in m.named_parameters()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    init, batches = _init(), _batches()
    cases = [(name, {**ARCH, **kw}, init, batches)
             for name, kw in CASES.items()]
    out = Ranks(4, _ranks_body, (cases,),
                tmp_path_factory.mktemp("r")).join()
    return out


def _ranks_body(rank, n, cases):
    out = port_cases(rank, n, cases)
    out["sync"] = {name: _sync_vs_flat(rank, kw, dcn)
                   for name, (kw, dcn) in MESHES.items()}
    return out


def _sync_vs_flat(rank, kw, dcn):
    """{mode: (largest |hier - flat| / max |flat|, exact-bf16 data?)}."""
    import torch
    import torch.distributed as dist

    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.parallel.mesh import build_mesh

    cfg = Config(gradient_dcn_size=dcn, hidden_size=64, num_heads=4,
                 num_kv_heads=2, **kw)
    mesh = build_mesh(cfg, device=torch.device("cpu"))
    g = torch.Generator().manual_seed(rank)
    shapes = [(64, 96), (1000,), (3, 5, 7), (1,)]
    rand = [torch.randn(s, generator=g) for s in shapes]
    # Small integers: every partial sum is exact in bf16.
    ints = [torch.randint(-8, 9, s, generator=g).float() for s in shapes]
    res = {}
    for mode, grads, dtype in (("fp32", rand, None),
                               ("bf16_exact", ints, "bf16"),
                               ("bf16", rand, "bf16")):
        flat = [t.clone() for t in grads]
        for t in flat:
            dist.all_reduce(t)
        hier = tgr.hierarchical_grad_sync(
            grads, mesh, dcn_size=dcn, bucket_mb=0.001, overlap_chunks=3,
            dcn_dtype=dtype)
        res[mode] = max(float((h - f).abs().max() / f.abs().max())
                        for h, f in zip(hier, flat))
    res["probe"] = tgr.grad_reduce_probe(mesh, payload_mb=0.05, iters=2)
    return res


@pytest.mark.parametrize("kw", PLANS)
def test_grad_reduce_plan_equals_jax(kw):
    assert tgr.make_grad_reduce_plan(**kw).to_dict() == \
        jgr.make_grad_reduce_plan(**kw).to_dict()


def test_grad_reduce_plan_refuses_what_jax_refuses():
    kw = dict(grad_elems=100, data_size=4, fsdp_size=1, dcn_size=3)
    with pytest.raises(ValueError, match="gradient_dcn_size"):
        jgr.make_grad_reduce_plan(**kw)
    with pytest.raises(ValueError, match="gradient_dcn_size"):
        tgr.make_grad_reduce_plan(**kw)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_hierarchical_sync_equals_flat_all_reduce(runs, mesh):
    for r in runs:
        res = r["sync"][mesh]
        assert res["fp32"] <= 1e-6, res
        assert res["bf16_exact"] <= 1e-6, res
        assert res["bf16"] <= 2 ** -6, res
        print(f"{mesh}: fp32 {res['fp32']:.2e}, bf16-dcn {res['bf16']:.2e}")


def test_grad_reduce_probe_reports_its_stage(runs):
    probe = runs[0]["sync"]["dp4_dcn2"]["probe"]
    assert probe["dcn"] == 2 and probe["ici"] == 2
    stage = probe["stages"]["two_stage"]
    assert stage["mean_seconds"] > 0, probe
    single = runs[0]["sync"]["dp4"]["probe"]["stages"]["single_stage"]
    assert single["mean_seconds"] > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_hierarchical_step_matches_one_rank(runs, case):
    trace, params = runs[0][case]
    otrace, oparams = runs[0]["one:" + case]
    worst = assert_close_trace(trace, otrace, 1e-5, case)
    worst_p = assert_params(params, oparams, sum(trace["learning_rate"]),
                            case)
    print(f"{case} vs one rank: metrics rel {worst:.2e}, params abs "
          f"{worst_p:.2e}")
