"""The port's expert parallelism (parallel/expert_dispatch.py, the 'a2a'
and expert-sharded 'gmm' MoE dispatches) in 4 gloo processes, against the
JAX package.

  - DispatchPlan byte counts, pow2 buckets and the hierarchical groups
    equal JAX's (exact);
  - the two-stage hierarchical all-to-all (expert axis 4 as 2 nodes x 2
    cards) equals one flat all-to-all (exact: it moves bytes);
  - a2a_expert_ffn over 1, 2 and 4 overlap chunks gives the same output
    (exact: the chunks only split the bucket rows) and gradients (1e-6 of
    the largest: the weight gradients sum the rows in another order);
  - two train steps at dp2 x ep2 with 4 experts top-2 (routing noise
    off, sequence 32), 'gmm' and 'a2a', against JAX's sharded step on the same mesh
    (loss, ce_loss, tokens and lr rtol 1e-5; grad_norm rtol 1e-4) and
    against the port's one-rank step (rtol 1e-5); parameters as
    tests/test_torch_train_step.py holds them.
The ranks are spawned once for the file (tests/torch_mesh_harness.py).
"""

import numpy as np
import pytest

from luminaai_tpu.parallel import expert_dispatch as jed
from luminaai_tpu_torch.parallel import expert_dispatch as ted
from torch_mesh_harness import (
    Ranks,
    assert_close_trace,
    assert_params,
    jax_init,
    jax_steps,
    port_cases,
)

ARCH = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, seq_length=32, intermediate_size=128,
            precision="fp32", batch_size=8, grad_clip_norm=0.5,
            learning_rate=1e-3, warmup_ratio=0.25,
            gradient_checkpointing=False, use_flash_attention=False,
            use_moe=True, num_experts=4, moe_top_k=2,
            routing_noise_std=0.0, expert_parallel_size=2)
CASES = {
    "dp2_ep2_gmm": dict(moe_dispatch="gmm"),
    "dp2_ep2_a2a": dict(moe_dispatch="a2a"),
}

PLANS = [
    dict(ep=2, dcn_size=1, local_groups=2, seq=64, top_k=2, capacity=40,
         num_experts=4, hidden=64, itemsize=4),
    dict(ep=4, dcn_size=2, local_groups=1, seq=128, top_k=2, capacity=80,
         num_experts=8, hidden=64, itemsize=2, overlap_chunks=3),
    dict(ep=8, dcn_size=2, local_groups=4, seq=2048, top_k=2, capacity=640,
         num_experts=8, hidden=2048, itemsize=2, overlap_chunks=2,
         dp_groups=32),
]


def _batches(n=2):
    out = []
    for s in range(n):
        rng = np.random.RandomState(10 + s)
        out.append({"input_ids": rng.randint(
            1, ARCH["vocab_size"], (ARCH["batch_size"], ARCH["seq_length"])
        ).astype(np.int64)})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    batches = _batches()
    handles, cases = {}, []
    for name, kw in CASES.items():  # one JAX init for both dispatches
        kw = {**ARCH, **kw}
        handles[name], init = jax_init(kw, share=next(
            iter(handles.values()), None))
        cases.append((name, kw, init, batches))
    ranks = Ranks(4, _ranks_body, (cases,), tmp_path_factory.mktemp("r"))
    jax_runs = {name: jax_steps(h, batches) for name, h in handles.items()}
    out = ranks.join()
    one = {name: out[0]["one:" + name] for name, _, _, _ in cases}
    return jax_runs, one, out


def _ranks_body(rank, n, cases):
    out = port_cases(rank, n, cases)
    out["hier"] = _hierarchical_vs_flat()
    out["chunks"] = _chunking_invariance()
    return out


def _mesh(**kw):
    import torch

    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.parallel.mesh import build_mesh

    cfg = Config(**{**ARCH, **kw})
    return cfg, build_mesh(cfg, device=torch.device("cpu"))


def _hierarchical_vs_flat():
    """[ep, rows, H] buckets through the two-stage exchange and through
    one flat all-to-all over the 4-rank expert axis."""
    import torch

    _, mesh = _mesh(expert_parallel_size=4, expert_dcn_size=2,
                    num_experts=4, moe_dispatch="a2a")
    g = torch.Generator().manual_seed(mesh.rank)
    x = torch.randn(4, 3, 8, generator=g)
    flat = ted.hierarchical_all_to_all(x, mesh.group("expert"))
    two = ted.hierarchical_all_to_all(
        x, mesh.group("expert"), tiers=mesh.tier_groups("expert", 2),
        dcn_size=2)
    return torch.equal(flat, two) and not torch.equal(flat, x)


def _chunking_invariance():
    """a2a_expert_ffn's output and gradients at 1, 2 and 4 chunks."""
    import torch

    from luminaai_tpu_torch.models.moe import expert_capacity
    from luminaai_tpu_torch.ops.gmm import gmm_ref

    cfg, mesh = _mesh(expert_parallel_size=4, num_experts=8,
                      moe_dispatch="a2a")
    g = torch.Generator().manual_seed(100 + mesh.rank)
    G, S, H, E, F = 2, 32, 16, 8, 24
    x0 = torch.randn(G, S, H, generator=g)
    probs = torch.softmax(torch.randn(G, S, E, generator=g), -1)
    wi0 = torch.randn(2, H, 2 * F, generator=g) * 0.1
    wo0 = torch.randn(2, F, H, generator=g) * 0.1
    C = expert_capacity(cfg, S)

    def gmm_fn(lhs, rhs, gs, dtype):
        return gmm_ref(lhs, rhs, gs, dtype)

    outs = []
    for chunks in (1, 2, 4):
        x = x0.clone().requires_grad_()
        wi, wo = wi0.clone().requires_grad_(), wo0.clone().requires_grad_()
        plan = ted.make_dispatch_plan(
            ep=4, dcn_size=1, local_groups=G, seq=S, top_k=2, capacity=C,
            num_experts=E, hidden=H, itemsize=4, overlap_chunks=chunks)
        assert plan.n_chunks == chunks
        out, _, _, _ = ted.a2a_expert_ffn(
            x, probs, wi, wo, top_k=2, capacity=C, num_experts=E,
            dtype=torch.float32, gmm_fn=gmm_fn,
            ep_group=mesh.group("expert"), ep_index=mesh.rank, plan=plan)
        out.square().sum().backward()
        outs.append([out.detach(), x.grad, wi.grad, wo.grad])
    # (output exact?, largest gradient difference over the largest
    # gradient): the chunks split the buckets' rows, so only the weight
    # gradients' fp32 sums over rows change order.
    exact = all(torch.equal(outs[0][0], o[0]) for o in outs[1:])
    rel = max(float((a - b).abs().max() / a.abs().max())
              for o in outs[1:] for a, b in zip(outs[0][1:], o[1:]))
    return exact, rel


@pytest.mark.parametrize("kw", PLANS)
def test_dispatch_plan_equals_jax(kw):
    assert ted.make_dispatch_plan(**kw).to_dict() == \
        jed.make_dispatch_plan(**kw).to_dict()


@pytest.mark.parametrize("ep,dcn", [(4, 2), (8, 2), (8, 4), (4, 1)])
def test_hierarchical_groups_and_pow2_equal_jax(ep, dcn):
    assert ted.hierarchical_groups(ep, dcn) == jed.hierarchical_groups(
        ep, dcn)
    for n in (1, 3, 64, 65, 1000):
        assert ted.next_pow2(n) == jed.next_pow2(n)


def test_dispatch_plan_refuses_what_jax_refuses():
    kw = dict(PLANS[1], dcn_size=3)
    with pytest.raises(ValueError, match="expert_dcn_size"):
        jed.make_dispatch_plan(**kw)
    with pytest.raises(ValueError, match="expert_dcn_size"):
        ted.make_dispatch_plan(**kw)


def test_hierarchical_all_to_all_equals_flat(runs):
    assert all(r["hier"] for r in runs[2])


def test_a2a_overlap_chunks_leave_values_unchanged(runs):
    """Outputs equal exactly; gradients within 1e-6 of their largest
    element (fp32 sums over the rows in another order)."""
    for exact, rel in (r["chunks"] for r in runs[2]):
        assert exact
        assert rel <= 1e-6, rel


@pytest.mark.parametrize("case", sorted(CASES))
def test_expert_parallel_step_matches_jax(runs, case):
    jax_runs, _, out = runs
    jtrace, jfinal = jax_runs[case]
    trace, params = out[0][case]
    worst = assert_close_trace(
        {k: v for k, v in trace.items() if k != "grad_norm"}, jtrace, 1e-5,
        case)
    worst_gn = assert_close_trace({"grad_norm": trace["grad_norm"]},
                                  {"grad_norm": jtrace["grad_norm"]}, 1e-4,
                                  case)
    worst_p = assert_params(params, jfinal, sum(trace["learning_rate"]),
                            case)
    print(f"{case} vs JAX: metrics rel {worst:.2e}, grad_norm rel "
          f"{worst_gn:.2e}, params abs {worst_p:.2e}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_expert_parallel_step_matches_one_rank(runs, case):
    _, one, out = runs
    trace, params = out[0][case]
    otrace, oparams = one[case]
    worst = assert_close_trace(trace, otrace, 1e-5, case)
    worst_p = assert_params(params, oparams, sum(trace["learning_rate"]),
                            case)
    print(f"{case} vs one rank: metrics rel {worst:.2e}, params abs "
          f"{worst_p:.2e}")
