"""The port's pipeline stages with experts, windowed attention and
mixture of depths at pp 2 over 2 gloo ranks, against JAX's pp 2 step on
2 of the conftest's CPU devices and the port's one-stage step over the
same microbatches; the pipelined eval against both.

Cases: MoE on every layer (4 experts, gather dispatch) under 1F1B and
GPipe; attention_window 16 and MoD under 1F1B. The JAX reference is its
GPipe step (its 1F1B step's embedding and final-norm gradients differ
from its pp 1 step's: tests/test_torch_pipeline.py, ROADMAP §C). Widths,
data and tolerances as tests/test_torch_pipeline.py's; the MoE aux loss
and drop rate ride in the compared metrics.
"""

import pytest

from torch_mesh_harness import Ranks, jax_init
from torch_pipe_harness import ARCH, MOE, compare, jax_pipe_run, pipe_cases

KINDS = {"moe": MOE, "window": dict(attention_window=16),
         "mod": dict(use_mod=True)}
CASES = {
    "moe_1f1b": ("moe", dict(pipeline_parallel_size=2)),
    "moe_gpipe": ("moe", dict(pipeline_parallel_size=2,
                              pipeline_schedule="gpipe")),
    "window_1f1b": ("window", dict(pipeline_parallel_size=2)),
    "mod_1f1b": ("mod", dict(pipeline_parallel_size=2)),
}


def _jax_kw(kind):
    return {**ARCH, **KINDS[kind], "pipeline_parallel_size": 2,
            "pipeline_schedule": "gpipe"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    handles, inits = {}, {}
    for kind in KINDS:
        handles[kind], inits[kind] = jax_init(_jax_kw(kind), n_devices=2)
    cases = [(name, {**ARCH, **KINDS[kind], **kw}, inits[kind])
             for name, (kind, kw) in CASES.items()]
    ranks = Ranks(2, pipe_cases, (cases,), tmp_path_factory.mktemp("r"))
    jax_runs = {kind: jax_pipe_run(h, _jax_kw(kind), 2)
                for kind, h in handles.items()}
    return jax_runs, ranks.join()[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_pp2_matches_jax_pp2(runs, case):
    jax_runs, port = runs
    trace, params, ev = port[case]
    w, wp = compare(trace, params, ev, *jax_runs[CASES[case][0]], case,
                    1e-4)
    if case.startswith("moe"):
        assert trace["moe_aux_loss"] and trace["moe_drop_rate"]
    print(f"{case} vs JAX pp 2: metrics rel {w:.2e}, params abs {wp:.2e}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_pp2_matches_the_one_stage_step(runs, case):
    _, port = runs
    w, wp = compare(*port[case], *port["one:" + case], case)
    print(f"{case} vs one stage: metrics rel {w:.2e}, params abs {wp:.2e}")


def test_pipelined_eval_carries_the_moe_aux(runs):
    """The pipelined eval's aux loss (per microbatch, summed over the
    layers) equals the one-stage eval's over the same microbatches."""
    _, port = runs
    ev, oev = port["moe_1f1b"][2], port["one:moe_1f1b"][2]
    assert abs(ev["moe_aux_loss"] - oev["moe_aux_loss"]) <= 1e-5 * abs(
        oev["moe_aux_loss"])
