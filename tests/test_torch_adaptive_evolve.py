"""evolve_experts in the port's Trainer against the JAX package's, on the
CPU: the set-up of tests/test_torch_adaptive.py (the same weights and
batches, 4 experts top-2, sort dispatch, no routing noise), an LR override
and a prune of expert 1 after step 1, then a grow after step 2 (its noise
patched to 0 on both sides, so both grow the same expert). Losses within
rtol 1e-5, grad norms within 1e-4, equal `interventions` records; after
each evolution the optimizer count equals the step (no warmup replay),
the override survives both rebuilds, older checkpoints are fenced off and
each evolution banks a forced save.
"""

import functools

import numpy as np

from luminaai_tpu.training import evolution as jevo
from luminaai_tpu_torch.training import checkpoint as ck
from luminaai_tpu_torch.training import evolution as evo
from test_torch_adaptive import run_both

EVOLVE = {
    1: [("adjust_learning_rate", (5e-4,)),
        ("evolve_experts", ("prune_expert", 1))],
    2: [("evolve_experts", ("add_expert",))],
}


def test_evolve_experts_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jevo, "grow_expert",
                        functools.partial(jevo.grow_expert, noise_scale=0.0))
    monkeypatch.setattr(evo, "grow_expert",
                        functools.partial(evo.grow_expert, noise_scale=0.0))
    t, jt, summary, ours, counts, jcounts = run_both(tmp_path, EVOLVE,
                                                     max_steps=3)
    assert counts == jcounts == [(1, 1), (2, 2)]
    assert [iv["kind"] for iv in summary["interventions"]] == [
        "lr_override", "prune_expert", "add_expert"]
    assert [iv.get("num_experts") for iv in summary["interventions"]] == [
        None, 3, 4]
    np.testing.assert_allclose([r["learning_rate"] for r in ours[1:]],
                               [5e-4] * 2, rtol=1e-6)
    assert t.config.num_experts == jt.config.num_experts == 4
    assert t._min_restorable_step == jt._min_restorable_step == 2
    assert ck.committed_steps(tmp_path / "port" / "ckpt") == [1, 2, 3]
    assert t.state.opt_state.count == 3
