"""The port's pipeline stages (parallel/pipeline.py): what the config
refuses, the schedules, and the dense model at pp 2 over 2 gloo ranks
under 1F1B and GPipe against JAX's pp 2 step on 2 of the conftest's CPU
devices and against the port's one-stage step over the same
microbatches; the gmm MoE (which JAX keeps off the pipe axis) through
`virtual_pipeline_step` against the one-stage step.

The JAX reference is its GPipe step, which equals its pp 1 step. JAX's
1F1B step gives the embedding and the final norm other gradients than
its pp 1 step (grad norm 0.803 against 0.509 here, the parameters apart
by up to 2e-3 after two steps without clipping; ROADMAP §C): against it
the port's 1F1B is held on the first step's forward metrics only.

Widths: vocab 256, hidden 64, 4 layers, 4 q over 2 kv heads, sequence
64, fp32, batch 8 without a loss mask (tests/torch_pipe_harness.py), two
steps from JAX's initial weights.

Tolerances: every metric both sides report and the parameters (as
tests/torch_mesh_harness.py's assert_params holds them: every element
within 2 x the summed learning rates + 1e-6, 99.9% within 1e-6) at rtol
1e-5, grad_norm at 1e-4 against JAX (its norm reduces in other orders);
the eval's loss and CE at 1e-5.
"""

import numpy as np
import pytest

from torch_mesh_harness import Ranks, assert_close_trace, jax_init
from torch_pipe_harness import (
    ARCH,
    batches,
    compare,
    init_sd,
    jax_pipe_run,
    pipe_case,
    pipe_cases,
)

from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.parallel import pipeline as pl

CASES = {
    "dense_1f1b": dict(pipeline_parallel_size=2),
    "dense_gpipe": dict(pipeline_parallel_size=2, pipeline_schedule="gpipe"),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's initial weights, then the ranks start; JAX's steps run while
    they work."""
    handles = {}
    handles["gpipe"], init = jax_init(
        {**ARCH, **CASES["dense_gpipe"]}, n_devices=2)
    handles["1f1b"], _ = jax_init({**ARCH, **CASES["dense_1f1b"]},
                                  n_devices=2, share=handles["gpipe"])
    cases = [(name, {**ARCH, **kw}, init) for name, kw in CASES.items()]
    ranks = Ranks(2, pipe_cases, (cases,), tmp_path_factory.mktemp("r"))
    jax_runs = {name: jax_pipe_run(h, {**ARCH, **CASES[f"dense_{name}"]}, 2)
                for name, h in handles.items()}
    return jax_runs, ranks.join()[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_pp2_matches_jax_pp2(runs, case):
    jax_runs, port = runs
    jtrace, jfinal, jev = jax_runs["gpipe"]
    trace, params, ev = port[case]
    w, wp = compare(trace, params, ev, jtrace, jfinal, jev, case, 1e-4)
    print(f"{case} vs JAX pp 2: metrics rel {w:.2e}, params abs {wp:.2e}")


def test_pp2_1f1b_forward_matches_jax_1f1b(runs):
    """The first step's forward metrics of JAX's 1F1B step (its
    gradients are the caveat above)."""
    jax_runs, port = runs
    jtrace, _, jev = jax_runs["1f1b"]
    trace, _, ev = port["dense_1f1b"]
    first = {k: v[:1] for k, v in trace.items()
             if k in ("loss", "ce_loss", "tokens_in_loss")}
    assert_close_trace(first, {k: v[:1] for k, v in jtrace.items()
                               if k in first}, 1e-5, "1f1b forward")
    for k in ("loss", "ce_loss"):
        np.testing.assert_allclose(ev[k], jev[k], rtol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pp2_matches_the_one_stage_step(runs, case):
    _, port = runs
    trace, params, ev = port[case]
    otrace, oparams, oev = port["one:" + case]
    w, wp = compare(trace, params, ev, otrace, oparams, oev, case)
    print(f"{case} vs one stage: metrics rel {w:.2e}, params abs {wp:.2e}")


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
def test_virtual_pipeline_with_gmm_matches_the_one_stage_step(schedule):
    """gmm dispatch, which the JAX config refuses under a pipe axis, plays
    its stages in one process as chip_smoke.py phase 16 does."""
    kw = {**ARCH, "use_moe": True, "num_experts": 4, "moe_pattern": "all",
          "moe_dispatch": "gmm", "pipeline_parallel_size": 2,
          "pipeline_microbatches": 4, "pipeline_schedule": schedule}
    sd = init_sd(kw)
    got = pipe_case(kw, sd, batches(), virtual=True)
    want = pipe_case(kw, sd, batches(), one_stage=True)
    compare(*got, *want, f"gmm virtual {schedule}")


# -- what the config refuses (tests/test_pipeline.py:68-93, :274) -----------

def _cfg(**kw):
    return Config(**{**ARCH, **kw})


def test_homogeneous_layer_stack_required():
    cfg = _cfg(use_moe=True, num_experts=4, moe_pattern="sandwich",
               num_layers=8, pipeline_parallel_size=2)
    ok, why = pl.pipeline_compatible(cfg)
    assert not ok and "segment" in why


def test_constructor_normalizes_scan_and_folds_accumulation():
    assert _cfg(scan_layers=False, pipeline_parallel_size=2).scan_layers
    cfg = _cfg(pipeline_parallel_size=2, gradient_accumulation_steps=2)
    assert cfg.gradient_accumulation_steps == 1
    assert cfg.pipeline_microbatches == 4


@pytest.mark.parametrize("kw, match", [
    (dict(num_layers=5, pipeline_parallel_size=2), "divide evenly"),
    (dict(pipeline_parallel_size=2, expert_parallel_size=2, use_moe=True,
          num_experts=4, moe_pattern="all", pipeline_schedule="gpipe"),
     "1f1b"),
    (dict(pipeline_parallel_size=2, sequence_parallel_size=2,
          pipeline_schedule="gpipe"), "1f1b"),
    (dict(pipeline_parallel_size=2, pipeline_microbatches=3), "divide"),
    (dict(pipeline_parallel_size=2, expert_parallel_size=4, use_moe=True,
          num_experts=4, moe_pattern="all", pipeline_microbatches=4),
     "expert_parallel_size"),
    (dict(pipeline_parallel_size=2, use_moe=True, num_experts=4,
          moe_pattern="all", moe_dispatch="gmm"), "gmm"),
    (dict(pipeline_parallel_size=2, pipeline_schedule="zb"), "schedule"),
])
def test_config_refuses_what_jax_refuses(kw, match):
    with pytest.raises(ValueError, match=match):
        _cfg(**kw)


# -- the schedules -----------------------------------------------------------

@pytest.mark.parametrize("schedule, P, n", [
    ("1f1b", 2, 2), ("1f1b", 2, 4), ("1f1b", 4, 8), ("gpipe", 2, 4),
    ("gpipe", 4, 8)])
def test_schedule_order_and_in_flight(schedule, P, n):
    acts = pl.schedule_actions(schedule, P, n)
    # Every (stage, microbatch) forwards and backwards once, one action a
    # stage a tick, each after what it waits for.
    assert sorted((a.stage, a.micro, a.kind) for a in acts) == sorted(
        (p, m, k) for p in range(P) for m in range(n) for k in "FB")
    at = {(a.kind, a.stage, a.micro): a.tick for a in acts}
    assert len({(a.tick, a.stage) for a in acts}) == len(acts)
    for (kind, p, m), t in at.items():
        if kind == "F" and p > 0:
            assert at[("F", p - 1, m)] < t
        if kind == "B":
            assert at[("F", p, m)] < t
            if p < P - 1:
                assert at[("B", p + 1, m)] < t
    peaks = pl.in_flight_peaks(acts, P)
    if schedule == "1f1b":
        assert peaks == [min(P - p, n) for p in range(P)]
    else:
        assert peaks == [n] * P
    fwd = pl.schedule_actions(schedule, P, n, backward=False)
    assert [a.kind for a in fwd] == ["F"] * (P * n)
