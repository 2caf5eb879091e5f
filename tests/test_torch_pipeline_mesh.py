"""The port's pipeline stages composed with the other mesh axes over 4
gloo ranks: pp 2 x tp 2 and pp 2 x fsdp 2 under both schedules, pp 2 x
ep 2 and pp 2 x sp 2 under 1F1B (the JAX config refuses GPipe there),
and pp 4 over 8 microbatches; each against the port's one-stage step
over the same microbatches and against JAX's pipelined step on 4 of the
conftest's CPU devices, run in a child process (JAX's own pipeline tests
keep its manual expert and sequence collectives out of a shared CPU
runtime, tests/test_pipeline.py). Every case evaluates its first batch
through the pipelined eval before training (ep and sp included).

The JAX references are GPipe steps where JAX allows them (equal to its pp
1 step); pp x ep and pp x sp exist in JAX under 1F1B only, whose
embedding and final-norm gradients differ from its pp 1 step's
(tests/test_torch_pipeline.py, ROADMAP §C): there the port is held to
JAX on the first step's forward metrics and the eval, and to its own
one-stage step on everything. Widths, data and tolerances as
tests/test_torch_pipeline.py's.
"""

import numpy as np
import pytest

from torch_mesh_harness import Ranks, assert_close_trace, jax_init
from torch_pipe_harness import (
    ARCH,
    MOE,
    compare,
    jax_pipe_child,
    pipe_cases,
)

CASES = {
    "pp2_tp2_1f1b": (False, dict(pipeline_parallel_size=2,
                                 tensor_parallel_size=2)),
    "pp2_tp2_gpipe": (False, dict(pipeline_parallel_size=2,
                                  tensor_parallel_size=2,
                                  pipeline_schedule="gpipe")),
    "pp2_fsdp2_1f1b": (False, dict(pipeline_parallel_size=2,
                                   fsdp_parallel_size=2)),
    "pp2_fsdp2_gpipe": (False, dict(pipeline_parallel_size=2,
                                    fsdp_parallel_size=2,
                                    pipeline_schedule="gpipe")),
    "pp2_ep2_1f1b": (True, dict(pipeline_parallel_size=2,
                                expert_parallel_size=2)),
    "pp2_sp2_1f1b": (False, dict(pipeline_parallel_size=2,
                                 sequence_parallel_size=2)),
    "pp4_n8_1f1b": (False, dict(pipeline_parallel_size=4,
                                pipeline_microbatches=8)),
}
# The JAX step each case is held to, and whether only its forward counts.
JAX_REF = {
    "pp2_tp2_1f1b": ("tp2", False), "pp2_tp2_gpipe": ("tp2", False),
    "pp2_fsdp2_1f1b": ("fsdp2", False), "pp2_fsdp2_gpipe": ("fsdp2", False),
    "pp2_ep2_1f1b": ("ep2", True), "pp2_sp2_1f1b": ("sp2", True),
    "pp4_n8_1f1b": ("pp4", False),
}
JAX_CASES = {
    "tp2": (False, dict(pipeline_parallel_size=2, tensor_parallel_size=2,
                        pipeline_schedule="gpipe")),
    "fsdp2": (False, dict(pipeline_parallel_size=2, fsdp_parallel_size=2,
                          pipeline_schedule="gpipe")),
    "ep2": (True, dict(pipeline_parallel_size=2, expert_parallel_size=2)),
    "sp2": (False, dict(pipeline_parallel_size=2, sequence_parallel_size=2)),
    "pp4": (False, dict(pipeline_parallel_size=4, pipeline_microbatches=8,
                        pipeline_schedule="gpipe")),
}


def _kw(moe, kw):
    return {**ARCH, **(MOE if moe else {}), **kw}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's initial weights (one device, the same seed and widths as every
    mesh's), then the ranks and JAX's child run side by side."""
    inits = {moe: jax_init(_kw(moe, {}), n_devices=1)[1]
             for moe in (False, True)}
    cases = [(name, _kw(moe, kw), inits[moe])
             for name, (moe, kw) in CASES.items()]
    ranks = Ranks(4, pipe_cases, (cases,), tmp_path_factory.mktemp("r"),)
    tmp = tmp_path_factory.mktemp("jax")
    jax_runs = jax_pipe_child(
        {name: _kw(moe, kw) for name, (moe, kw) in JAX_CASES.items()}, 4,
        tmp / "jax.pt")
    for name, (moe, _) in JAX_CASES.items():
        init = jax_runs[name][0]
        assert all(np.array_equal(init[k].numpy(), inits[moe][k].numpy())
                   for k in init), f"JAX's {name} init is another"
    return jax_runs, ranks.join(180)[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_pp_composition_matches_the_one_stage_step(runs, case):
    _, port = runs
    w, wp = compare(*port[case], *port["one:" + case], case)
    print(f"{case} vs one stage: metrics rel {w:.2e}, params abs {wp:.2e}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_pp_composition_matches_jax(runs, case):
    jax_runs, port = runs
    ref, forward_only = JAX_REF[case]
    _, jtrace, jfinal, jev = jax_runs[ref]
    trace, params, ev = port[case]
    if not forward_only:
        w, wp = compare(trace, params, ev, jtrace, jfinal, jev, case, 1e-4)
        print(f"{case} vs JAX: metrics rel {w:.2e}, params abs {wp:.2e}")
        return
    keys = ("loss", "ce_loss", "tokens_in_loss", "moe_aux_loss")
    first = {k: v[:1] for k, v in trace.items() if k in keys}
    assert_close_trace(first, {k: v[:1] for k, v in jtrace.items()
                               if k in first}, 1e-5, case)
    for k in ("loss", "ce_loss"):
        np.testing.assert_allclose(ev[k], jev[k], rtol=1e-5,
                                   err_msg=f"{case}: eval {k}")
