"""The port's mesh (parallel/mesh.py), its config fields, presets and
sharding rules against the JAX package, and the mesh's process groups and
collectives in 4 gloo processes (spawned once for the file,
tests/torch_mesh_harness.py).

  - mesh_shape_from_config: the same sizes and the same refusals as JAX's;
  - the 13 presets field for field (all shared fields but
    attention_backend, which the port fixes to 'ragged'; the port's b1
    keeps one card's batch, 16, and no fsdp axis);
  - the config's mesh validation refuses what JAX's refuses;
  - logical_axis_rules equals JAX's, fallbacks included;
  - rank r sits where JAX's CPU mesh puts device r, and each axis group
    holds the ranks JAX's mesh lines up along that axis;
  - the collective wrappers and the differentiable collectives against
    their definitions (exact);
  - host_step_skew: > 0 across ranks whose clocks are read apart, 0.0
    without a process group.
"""

import dataclasses
import time

import numpy as np
import pytest

import jax

from luminaai_tpu.config import Config as JConfig
from luminaai_tpu.config import ConfigPresets as JPresets
from luminaai_tpu.parallel import mesh as jmesh
from luminaai_tpu.parallel import sharding as jsharding
from luminaai_tpu_torch.config import Config, ConfigPresets
from luminaai_tpu_torch.monitoring.watchdog import host_step_skew
from luminaai_tpu_torch.parallel import mesh as tmesh
from luminaai_tpu_torch.parallel import sharding as tsharding
from torch_mesh_harness import run_ranks

SMALL = dict(hidden_size=64, num_heads=4, num_kv_heads=2)
SHAPES = [
    (dict(), 8), (dict(fsdp_parallel_size=2), 8),
    (dict(fsdp_parallel_size=2, tensor_parallel_size=2), 8),
    (dict(expert_parallel_size=2, data_parallel_size=2), 4),
    (dict(sequence_parallel_size=4), 4),
    (dict(fsdp_parallel_size=64, expert_parallel_size=16), 1024),
]
BAD_SHAPES = [
    (dict(fsdp_parallel_size=3), 8),
    (dict(data_parallel_size=3, fsdp_parallel_size=2), 8),
]
MESHES = {
    "dp2_fsdp2": dict(data_parallel_size=2, fsdp_parallel_size=2),
    "fsdp2_tp2": dict(fsdp_parallel_size=2, tensor_parallel_size=2),
    "ep2_sp2": dict(expert_parallel_size=2, sequence_parallel_size=2),
    "permuted": dict(fsdp_parallel_size=2, tensor_parallel_size=2,
                     mesh_axes=("tensor", "data", "pipe", "fsdp", "expert",
                                "sequence")),
}
REFUSED = [
    dict(use_moe=True, moe_dispatch="a2a"),
    dict(use_moe=True, moe_dispatch="a2a", expert_parallel_size=4,
         expert_dcn_size=3),
    dict(use_moe=True, moe_dispatch="a2a", expert_parallel_size=2,
         sequence_parallel_size=2),
    dict(use_moe=True, moe_dispatch="gmm", sequence_parallel_size=2),
    dict(use_moe=True, moe_dispatch="gmm", tensor_parallel_size=2,
         intermediate_size=129),
    dict(use_moe=True, num_experts=6, expert_parallel_size=4),
    dict(grad_reduce="ring"),
    dict(grad_reduce="hierarchical", sequence_parallel_size=2),
    dict(grad_reduce="hierarchical", use_moe=True, moe_dispatch="gmm"),
    dict(grad_reduce_dcn_dtype="fp8"),
    dict(sequence_parallel_size=3, seq_length=64),
    dict(fsdp_parallel_size=0),
]


@pytest.mark.parametrize("kw,n", SHAPES)
def test_mesh_shape_equals_jax(kw, n):
    assert tmesh.mesh_shape_from_config(Config(**SMALL, **kw), n) == \
        jmesh.mesh_shape_from_config(JConfig(**SMALL, **kw), n)


@pytest.mark.parametrize("kw,n", BAD_SHAPES)
def test_mesh_shape_refuses_what_jax_refuses(kw, n):
    with pytest.raises(ValueError) as jerr:
        jmesh.mesh_shape_from_config(JConfig(**SMALL, **kw), n)
    with pytest.raises(ValueError) as terr:
        tmesh.mesh_shape_from_config(Config(**SMALL, **kw), n)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("name", JPresets.available())
def test_presets_equal_jax_field_for_field(name):
    assert ConfigPresets.available() == JPresets.available()
    t, j = ConfigPresets.get(name).to_dict(), JPresets.get(name).to_dict()
    exempt = {"attention_backend"}
    if name == "b1":  # one card's share: batch 16, no fsdp axis
        exempt |= {"batch_size", "fsdp_parallel_size"}
        assert (t["batch_size"], t["fsdp_parallel_size"]) == (16, 1)
    shared = (set(t) & set(j)) - exempt
    assert len(shared) > 150
    for k in shared:
        jv, tv = j[k], t[k]
        if isinstance(jv, (list, tuple)):
            jv, tv = list(jv), list(tv)
        assert tv == jv, (name, k, tv, jv)
    assert ConfigPresets.get(name).estimate_parameters() == \
        JPresets.get(name).estimate_parameters()


@pytest.mark.parametrize("kw", REFUSED)
def test_mesh_validation_refuses_what_jax_refuses(kw):
    with pytest.raises(AssertionError):
        JConfig(**SMALL, **kw)
    with pytest.raises(ValueError):
        Config(**SMALL, **kw)


def test_sequence_parallelism_turns_ring_attention_on_as_in_jax():
    t, j = Config(**SMALL, sequence_parallel_size=2), JConfig(
        **SMALL, sequence_parallel_size=2)
    assert t.use_ring_attention and j.use_ring_attention


@pytest.mark.parametrize("kw", [dict(), dict(tensor_parallel_size=2),
                                dict(tensor_parallel_size=4),
                                dict(tensor_parallel_size=3, num_heads=6,
                                     hidden_size=48)])
def test_logical_axis_rules_equal_jax(kw):
    base = {**SMALL, **kw}
    assert tsharding.logical_axis_rules(Config(**base)) == \
        jsharding.logical_axis_rules(JConfig(**base))
    assert tsharding.LOGICAL_AXIS_RULES == jsharding.LOGICAL_AXIS_RULES


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(4, _ranks_body, (), tmp_path_factory.mktemp("r"))


def _ranks_body(rank, n):
    import torch

    out = {"layout": {}}
    for name, kw in MESHES.items():
        m = tmesh.build_mesh(Config(**SMALL, **kw),
                             device=torch.device("cpu"))
        out["layout"][name] = {
            "coords": m.coords,
            "groups": {ax: m.group_ranks(ax) for ax in tmesh.GROUP_AXES},
            "describe": tmesh.describe_mesh(m),
        }
    m = tmesh.build_mesh(Config(**SMALL, data_parallel_size=4),
                         device=torch.device("cpu"))
    out["collectives"] = _collectives(m, rank)
    if rank == 1:
        time.sleep(0.3)  # this rank reaches the sync late
    out["skew"] = host_step_skew()
    return out


def _collectives(m, rank):
    import torch

    from luminaai_tpu_torch.parallel import mesh as pm

    g = m.group("data")
    def mine(i):
        return torch.arange(32.).reshape(4, 8) + 100 * i

    # Tiled all-to-all: columns block j of member i -> member j, stacked
    # on rows in member order.
    y = pm.all_to_all(mine(rank), g, split_axis=1, concat_axis=0)
    res = {"a2a": torch.equal(y, torch.cat(
        [mine(i)[:, 2 * rank:2 * rank + 2] for i in range(4)], 0))}
    p = pm.ppermute(torch.full((2,), float(rank)), g,
                    [(i, (i + 1) % 4) for i in range(4)])
    res["ppermute"] = torch.equal(p, torch.full((2,), float((rank - 1) % 4)))
    s = pm.psum_scatter(torch.arange(8.), g)
    res["psum_scatter"] = torch.equal(s, 4 * torch.arange(8.)[2 * rank:
                                                              2 * rank + 2])
    a = pm.all_gather(torch.full((1, 3), float(rank)), g, axis=0)
    res["all_gather"] = torch.equal(a[:, 0], torch.arange(4.))
    res["psum"] = torch.equal(pm.psum(torch.ones(3), g), torch.full((3,), 4.))
    # Differentiable: forward value and the backward's rule.
    v = torch.full((2,), float(rank + 1), requires_grad=True)
    pm.copy_to(v, g).sum().backward()
    res["copy_to"] = torch.equal(v.grad, torch.full((2,), 4.))
    v.grad = None
    r = pm.reduce_from(v, g)
    r.sum().backward()
    res["reduce_from"] = (torch.equal(r.detach(), torch.full((2,), 10.))
                          and torch.equal(v.grad, torch.ones(2)))
    v.grad = None
    gr = pm.gather_rows(v[None], g, 0)
    (gr * torch.arange(4.)[:, None]).sum().backward()
    res["gather_rows"] = (tuple(gr.shape) == (4, 2)
                          and torch.equal(v.grad, torch.full((2,),
                                                             float(rank))))
    v.grad = None
    gs = pm.gather_sum(v[None], g, 0)
    (gs * torch.arange(4.)[:, None]).sum().backward()
    res["gather_sum"] = torch.equal(v.grad, torch.full((2,), 4. * rank))
    v.grad = None
    mo = pm.mean_over(v, g)
    mo.sum().backward()
    res["mean_over"] = (torch.equal(mo.detach(), torch.full((2,), 2.5))
                        and torch.equal(v.grad, torch.ones(2)))
    return res


@pytest.mark.parametrize("name", sorted(MESHES))
def test_ranks_sit_where_jax_puts_devices(ranks, name):
    """Rank r's coordinates are device r's position in JAX's mesh over
    jax.devices()[:4], and each group's ranks are the device ids along
    the group's axes there (in row-major order over them)."""
    cfg = JConfig(**SMALL, **MESHES[name])
    jm = jmesh.build_mesh(cfg, devices=jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    axes = jm.axis_names
    for r, rec in enumerate(ranks):
        layout = rec["layout"][name]
        pos = tuple(layout["coords"][a] for a in axes)
        assert ids[pos] == r, (name, r, pos)
        for group_axes, members in layout["groups"].items():
            idx = [slice(None) if a in group_axes else pos[i]
                   for i, a in enumerate(axes)]
            along = ids[tuple(idx)]
            # Row-major over the group's axes in mesh order.
            order = [a for a in axes if a in group_axes]
            perm = [order.index(a) for a in group_axes]
            want = np.transpose(along, perm).reshape(-1).tolist()
            assert sorted(members) == sorted(want), (name, group_axes)
            assert members == sorted(members)
        assert layout["describe"].startswith("Mesh[")


@pytest.mark.parametrize("op", ["a2a", "ppermute", "psum_scatter",
                                "all_gather", "psum", "copy_to",
                                "reduce_from", "gather_rows", "gather_sum",
                                "mean_over"])
def test_collectives_do_what_they_say(ranks, op):
    assert all(r["collectives"][op] for r in ranks), op


def test_host_step_skew_only_across_ranks(ranks):
    assert all(r["skew"] >= 0.2 for r in ranks), [r["skew"] for r in ranks]
    assert host_step_skew() == 0.0  # no process group here


def test_without_a_process_group_the_mesh_has_one_rank():
    m = tmesh.build_mesh(Config(**SMALL), device="cpu")
    assert m.size == 1 and m.group("data") is None
    assert tmesh.describe_mesh(m) == (
        "Mesh[data=1 × pipe=1 × fsdp=1 × expert=1 × sequence=1 × "
        "tensor=1] on 1 cpu device(s)")
    assert dataclasses.is_dataclass(Config)
