"""Born-sharded init (parallel/sharding.py init_sharded_state without a
whole model) in gloo processes: every rank's local parameters equal its
slices of the one-rank `convert.init_params` model at the same seed,
bitwise, and no rank allocates a whole-model tensor.

Meshes: fsdp 2, tp 2, ep 2 and pp 2 over 2 ranks; fsdp 2 x ep 2 and
pp 2 x tp 2 over 4 (tests/torch_mesh_harness.py spawns each world once).
The materializer (`sharding._draw`) is wrapped in each rank to record the
largest tensor it allocates: it must be one parameter's size, and the
rank's local storage below the whole model's.
"""

import pytest

from torch_mesh_harness import Ranks

ARCH = dict(vocab_size=256, hidden_size=64, num_layers=4, num_heads=4,
            num_kv_heads=2, seq_length=64, intermediate_size=128,
            precision="fp32", batch_size=8, use_moe=True, num_experts=4,
            moe_pattern="all", moe_dispatch="gather",
            use_flash_attention=False, gradient_checkpointing=False)
TWO = {"fsdp2": dict(fsdp_parallel_size=2),
       "tp2": dict(tensor_parallel_size=2),
       "ep2": dict(expert_parallel_size=2),
       "pp2": dict(pipeline_parallel_size=2)}
FOUR = {"fsdp2_ep2": dict(fsdp_parallel_size=2, expert_parallel_size=2),
        "pp2_tp2": dict(pipeline_parallel_size=2, tensor_parallel_size=2)}


def _body(rank, n, cases):
    import torch

    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.convert import init_params
    from luminaai_tpu_torch.models.transformer import LuminaTransformer
    from luminaai_tpu_torch.parallel import sharding
    from luminaai_tpu_torch.parallel.mesh import build_mesh
    from luminaai_tpu_torch.training.optimizer import (
        make_optimizer,
        make_schedule,
    )

    drawn = []
    orig = sharding._draw

    def recording(name, shape, config, gen, device):
        t = orig(name, shape, config, gen, device)
        drawn.append(t.numel())
        return t

    sharding._draw = recording
    out = {}
    for name, kw in cases.items():
        cfg = Config(**{**ARCH, **kw})
        mesh = build_mesh(cfg, device=torch.device("cpu"))
        tx = make_optimizer(cfg, 4, make_schedule(cfg, 4))
        drawn.clear()
        model, state = sharding.init_sharded_state(cfg, mesh, tx, 7)
        whole = init_params(LuminaTransformer(
            Config(**ARCH), device="cpu", trainable=True), 7)
        full = dict(whole.named_parameters())
        same = []
        for i, (pname, local) in enumerate(zip(state.names, state.params)):
            want = sharding.take(full[pname].detach(), state.index[i])
            p = state.dparams[i]
            if local is not p:
                want = sharding._fsdp_local(want, p)
            same.append(torch.equal(local, want.reshape(local.shape)))
        out[name] = {
            "bitwise": all(same),
            "largest_drawn": max(drawn),
            "largest_param": max(t.numel() for t in full.values()),
            "local": sum(t.numel() for t in state.params),
            "whole": sum(t.numel() for t in full.values()),
            "names": len(state.names), "all_names": len(state.all_names)}
    sharding._draw = orig
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    two = Ranks(2, _body, (TWO,), tmp_path_factory.mktemp("two"))
    four = Ranks(4, _body, (FOUR,), tmp_path_factory.mktemp("four"))
    return {**_merge(two.join()), **_merge(four.join())}


def _merge(results):
    return {(name, r): rec for r, res in enumerate(results)
            for name, rec in res.items()}


@pytest.mark.parametrize("case", sorted({**TWO, **FOUR}))
def test_born_sharded_ranks_hold_the_one_rank_slices(runs, case):
    recs = [rec for (name, _), rec in runs.items() if name == case]
    assert recs and all(rec["bitwise"] for rec in recs), recs


@pytest.mark.parametrize("case", sorted({**TWO, **FOUR}))
def test_born_sharded_ranks_never_hold_the_whole_model(runs, case):
    for (name, r), rec in runs.items():
        if name != case:
            continue
        # The materializer's largest tensor is one parameter, and a
        # rank's storage is its slices only.
        assert rec["largest_drawn"] == rec["largest_param"], (r, rec)
        assert rec["local"] < rec["whole"], (r, rec)
    if case.startswith("pp2"):
        # A stage holds the embedding, the final norm and its 2 layers.
        assert all(rec["names"] < rec["all_names"]
                   for (name, _), rec in runs.items() if name == case)
