"""The whole composition at once (tests/test_pipeline.py:235): pp 2 x ep 2
x sp 2 over 8 gloo ranks, MoE on every layer (gather dispatch) under
1F1B, against the port's one-stage step over the same microbatches and
against JAX's pipelined step on the conftest's 8 CPU devices (in a child
process, as tests/test_torch_pipeline_mesh.py runs it). JAX has this
composition under 1F1B only, whose embedding and final-norm gradients
differ from its pp 1 step's, and which under sp takes the router
statistics per sequence chunk (ROADMAP §C): the port is held to JAX on
the first step's loss, CE and tokens and the pipelined eval, and to its
own one-stage step on everything, at tests/test_torch_pipeline.py's
tolerances.
"""

import numpy as np
import pytest

from torch_mesh_harness import Ranks, assert_close_trace, jax_init
from torch_pipe_harness import ARCH, MOE, compare, jax_pipe_child, pipe_cases

KW = {**ARCH, **MOE, "pipeline_parallel_size": 2, "expert_parallel_size": 2,
      "sequence_parallel_size": 2}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    init = jax_init({**ARCH, **MOE}, n_devices=1)[1]
    ranks = Ranks(8, pipe_cases, ([("pp2_ep2_sp2", KW, init)],),
                  tmp_path_factory.mktemp("r"))
    tmp = tmp_path_factory.mktemp("jax")
    jax_run = jax_pipe_child({"pp2_ep2_sp2": KW}, 8,
                             tmp / "jax.pt")["pp2_ep2_sp2"]
    assert all(np.array_equal(jax_run[0][k].numpy(), init[k].numpy())
               for k in init)
    return jax_run, ranks.join(240)[0]


def test_pp2_ep2_sp2_matches_the_one_stage_step(runs):
    _, port = runs
    w, wp = compare(*port["pp2_ep2_sp2"], *port["one:pp2_ep2_sp2"],
                    "pp2_ep2_sp2")
    print(f"pp2 x ep2 x sp2 vs one stage: metrics rel {w:.2e}, params abs "
          f"{wp:.2e}")


def test_pp2_ep2_sp2_forward_matches_jax(runs):
    (_, jtrace, _, jev), port = runs
    trace, _, ev = port["pp2_ep2_sp2"]
    # Not the aux loss: inside its 1F1B region under sp JAX takes the
    # router statistics per sequence chunk (0.040010 against the port's
    # 0.039971, which its pp 1 step's whole sequences give; ROADMAP §C).
    keys = ("loss", "ce_loss", "tokens_in_loss")
    first = {k: v[:1] for k, v in trace.items() if k in keys}
    assert_close_trace(first, {k: v[:1] for k, v in jtrace.items()
                               if k in first}, 1e-5, "pp2_ep2_sp2")
    for k in ("loss", "ce_loss"):
        np.testing.assert_allclose(ev[k], jev[k], rtol=1e-5)
