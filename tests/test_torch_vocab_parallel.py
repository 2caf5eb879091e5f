"""The embedding and LM head cut by vocabulary over the tensor ranks
(parallel/sharding.py's 'vocab' -> tensor rule; the vocab-parallel lookup
in models/layers.py Embedder; the vocab-parallel CE in ops/fused.py) in 4
gloo processes, against the JAX package's sharded step on the same mesh
over 4 of the conftest's CPU devices and against the port's one-rank
step.

Widths: vocab 256, hidden 64, 2 layers, 4 q over 2 kv heads, sequence 64,
fp32, batch 8 with a loss mask and loss weights, clipping at 0.5, two
steps. The ranks are spawned once for the file
(tests/torch_mesh_harness.py) and run every case.

- Against JAX on the same mesh: `tp2` (data 2 x tensor 2, tied head,
  z-loss 1e-4) and `fsdp2_tp2_untied` (an untied lm_head, label
  smoothing 0.1).
- Against the port's one-rank step only: `tp2_plain_logits` (the CE over
  Embedder.decode's [B, S, V/tp] logits) and `tp4` (the kv heads whole);
  `pp2_tp2` through the pipelined step and its eval, against the same
  pipeline's stages played in one process (the one-rank pipelined step:
  with a loss mask the pipeline's token-sum CE is not the one-stage
  step's mean of microbatch means, tests/test_torch_pipeline.py).
- Each rank's local embedding and lm_head are its rows [t V/tp,
  (t+1) V/tp) of the one-rank tables, bitwise, in V/tp/fsdp x H elements
  with their moments; the state round-trips through the one-rank layout
  bitwise; a vocabulary that does not divide over the tensor ranks is
  refused in the port where JAX's sharded init refuses it.
- In one process: the virtual forms (`virtual_vocab_ce_sums`,
  `virtual_vocab_lookup`) over n = 1, 2, 4 slices against the whole CE
  and lookup.

Tolerances (tests/test_torch_sharded_step.py's): loss, ce_loss,
tokens_in_loss and the learning rate rtol 1e-5, grad_norm rtol 1e-5
against the one-rank port and 1e-4 against JAX; parameters as
torch_mesh_harness.assert_params holds them. The virtual CE: loss sums
rtol 1e-6, the hidden's and head's gradients within 1e-5 x max|g|; the
virtual lookup exactly.
"""

import numpy as np
import pytest
import torch

from torch_mesh_harness import (
    Ranks,
    assert_close_trace,
    assert_params,
    jax_init,
    jax_steps,
    port_cases,
)
from torch_pipe_harness import compare, pipe_case

ARCH = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, seq_length=64, intermediate_size=128,
            precision="fp32", batch_size=8, grad_clip_norm=0.5,
            learning_rate=1e-3, warmup_ratio=0.25,
            gradient_checkpointing=False, use_flash_attention=False,
            use_moe=False)
CASES = {
    "tp2": dict(tensor_parallel_size=2, z_loss_weight=1e-4),
    "fsdp2_tp2_untied": dict(fsdp_parallel_size=2, tensor_parallel_size=2,
                             tie_word_embeddings=False, label_smoothing=0.1),
}
# Against the port's one-rank step only (the file's time allows two JAX
# meshes, as tests/test_torch_sharded_step.py budgets).
PORT_ONLY = {
    "tp2_plain_logits": dict(tensor_parallel_size=2, fused_lm_head_ce=False),
    "tp4": dict(tensor_parallel_size=4),
}
# scan_layers: the pipelined step decays the stacked norm scales, as JAX's
# does (training/optimizer.py decay_of); its one-process equal must too.
PIPE = {"pp2_tp2": dict(pipeline_parallel_size=2, tensor_parallel_size=2,
                        scan_layers=True)}
# The slice and round-trip checks run on the untied case's mesh.
SLICED = "fsdp2_tp2_untied"
# Refused: 250 rows do not divide over 4 tensor ranks.
INDIVISIBLE = dict(vocab_size=250, num_layers=1, tensor_parallel_size=4)
TABLES = ("embedder.embedding", "embedder.lm_head")


def _batches(n=2):
    out = []
    for s in range(n):
        rng = np.random.RandomState(s)
        shape = (ARCH["batch_size"], ARCH["seq_length"])
        out.append({
            "input_ids": rng.randint(1, ARCH["vocab_size"], shape).astype(
                np.int64),
            "loss_mask": (rng.rand(*shape) > 0.1).astype(np.float32),
            "loss_weights": rng.choice([1.0, 1.5], size=shape).astype(
                np.float32),
        })
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's initial weights first; then the ranks start, and JAX's steps
    run while they work."""
    batches = _batches()
    handles, inits, cases = {}, {}, []
    for name, kw in CASES.items():
        kw = {**ARCH, **kw}
        handles[name], inits[name] = jax_init(kw)
        cases.append((name, kw, inits[name], batches))
    for name, kw in PORT_ONLY.items():  # the same widths' tied weights
        cases.append((name, {**ARCH, **kw}, inits["tp2"], batches))
    pipe = [(name, {**ARCH, **kw}, inits["tp2"])
            for name, kw in PIPE.items()]
    sliced = ({**ARCH, **CASES[SLICED]}, inits[SLICED])
    ranks = Ranks(4, _ranks_body, (cases, pipe, sliced),
                  tmp_path_factory.mktemp("r"))
    jax_runs = {name: jax_steps(h, batches) for name, h in handles.items()}
    out = ranks.join(180)
    one = {name: out[0]["one:" + name] for name, _, _, _ in cases}
    return jax_runs, one, out, inits


def _ranks_body(rank, n, cases, pipe, sliced):
    out = port_cases(rank, n, cases)
    for name, kw, sd in pipe:
        out[name] = pipe_case(kw, sd, _batches())
        if rank == 0:
            out["one:" + name] = pipe_case(kw, sd, _batches(), virtual=True)
    out["slices"] = _slices_and_round_trip(*sliced)
    out["indivisible"] = _indivisible()
    return out


def _slices_and_round_trip(kw, init):
    """Each table's local slice against the one-rank rows, the local
    sizes of the shard and its moments; then one step, gather_full and
    load_full into fresh shards: the same shards, bitwise."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.parallel import train_step as ts
    from luminaai_tpu_torch.parallel.mesh import build_mesh
    from luminaai_tpu_torch.parallel.sharding import init_sharded_state
    from luminaai_tpu_torch.training.optimizer import (
        make_optimizer,
        make_schedule,
    )

    cfg = Config(**kw)
    mesh = build_mesh(cfg, device=torch.device("cpu"))
    sched = make_schedule(cfg, 4)
    tx = make_optimizer(cfg, 4, sched)
    model, state = init_sharded_state(cfg, mesh, tx, 0, params=init)
    tp, t, fsdp = (mesh.shape["tensor"], mesh.coords["tensor"],
                   mesh.shape["fsdp"])
    rows = cfg.vocab_size // tp
    tables = {}
    for name in TABLES:
        i = state.names.index(name)
        p = state.dparams[i]
        whole_slice = p.full_tensor() if isinstance(p, DTensor) else p
        tables[name] = {
            "bitwise": torch.equal(whole_slice.detach(),
                                   init[name][t * rows:(t + 1) * rows]),
            "slice_shape": tuple(whole_slice.shape),
            "numel": state.params[i].numel(),
            "moment_numel": (state.opt_state.mu[i].numel(),
                             state.opt_state.nu[i].numel()),
            "want_numel": -(-rows // fsdp) * cfg.hidden_size,
        }
    step = ts.make_sharded_train_step(cfg, model, sched, tx, mesh)
    b = {k: torch.as_tensor(v) for k, v in _batches(1)[0].items()}
    step(state, ts.shard_batch(b, mesh, cfg))
    buf = [state.gather_full()]
    dist.broadcast_object_list(buf, src=0)
    _, state2 = init_sharded_state(cfg, mesh, tx, 99)
    state2.load_full(buf[0])
    opt, opt2 = state.opt_state, state2.opt_state
    pairs = list(zip(state.params + opt.mu + opt.nu,
                     state2.params + opt2.mu + opt2.nu))
    round_trip = (all(torch.equal(x, y) for x, y in pairs)
                  and opt2.count == opt.count and state2.step == state.step)
    return {"tables": tables, "round_trip": round_trip,
            "whole_shape": tuple(buf[0].params[
                buf[0].names.index("embedder.embedding")].shape)}


def _indivisible():
    """The port's sharded init at a vocabulary that does not divide over
    the tensor ranks: the error's text, or None where it was accepted."""
    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.parallel.mesh import build_mesh
    from luminaai_tpu_torch.parallel.sharding import init_sharded_state
    from luminaai_tpu_torch.training.optimizer import (
        make_optimizer,
        make_schedule,
    )

    cfg = Config(**{**ARCH, **INDIVISIBLE})
    mesh = build_mesh(cfg, device=torch.device("cpu"))
    tx = make_optimizer(cfg, 4, make_schedule(cfg, 4))
    try:
        init_sharded_state(cfg, mesh, tx, 0)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", sorted(CASES))
def test_vocab_parallel_step_matches_jax(runs, case):
    jax_runs, _, port, _ = runs
    jtrace, jfinal = jax_runs[case]
    trace, params = port[0][case]
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


@pytest.mark.parametrize("case", sorted({**CASES, **PORT_ONLY}))
def test_vocab_parallel_step_matches_one_rank(runs, case):
    _, one, port, _ = runs
    trace, params = port[0][case]
    otrace, oparams = one[case]
    worst = assert_close_trace(trace, otrace, 1e-5, case)
    worst_p = assert_params(params, oparams, sum(trace["learning_rate"]),
                            case)
    print(f"{case} vs one rank: metrics rel {worst:.2e}, params abs "
          f"{worst_p:.2e}")


@pytest.mark.parametrize("case", sorted(PIPE))
def test_vocab_parallel_pipeline_matches_one_rank(runs, case):
    """The pipelined step and eval over pp 2 x tp 2 (stage 0's lookup and
    the last stage's CE vocab-parallel) against the same stages played
    in one process."""
    _, _, port, _ = runs
    w, wp = compare(*port[0][case], *port[0]["one:" + case], case)
    print(f"{case} vs one rank: metrics rel {w:.2e}, params abs {wp:.2e}")


@pytest.mark.parametrize("table", TABLES)
def test_each_tensor_rank_holds_its_vocab_rows(runs, table):
    port, inits = runs[2], runs[3]
    V, H = ARCH["vocab_size"], ARCH["hidden_size"]
    for r, res in enumerate(port):
        rec = res["slices"]["tables"][table]
        assert rec["bitwise"], (r, table)
        assert rec["slice_shape"] == (V // 2, H), (r, rec)
        assert rec["numel"] == rec["want_numel"] == V // 2 // 2 * H, rec
        assert rec["moment_numel"] == (rec["numel"],) * 2, rec
    assert tuple(inits[SLICED][table].shape) == (V, H)


def test_vocab_sliced_state_round_trips_through_the_one_rank_layout(runs):
    port = runs[2]
    assert all(res["slices"]["round_trip"] for res in port)
    assert port[0]["slices"]["whole_shape"] == (ARCH["vocab_size"],
                                                ARCH["hidden_size"])


def test_indivisible_vocab_is_refused_as_jax_refuses_it(runs):
    for res in runs[2]:
        msg = res["indivisible"]
        assert msg is not None and "250" in msg and "4" in msg, msg
    with pytest.raises(ValueError):
        jax_init({**ARCH, **INDIVISIBLE})


def _ce_inputs(dtype, V=256, H=64, B=2, S=48, seed=0):
    g = torch.Generator().manual_seed(seed)
    hidden = torch.randn(B, S, H, generator=g).to(dtype).requires_grad_()
    head = (torch.randn(V, H, generator=g) * 0.2).requires_grad_()
    labels = torch.randint(0, V, (B, S), generator=g)
    weights = torch.rand(B, S, generator=g) * (
        torch.rand(B, S, generator=g) > 0.2)
    return hidden, head, labels, weights


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_virtual_vocab_ce_equals_the_whole_ce(n, smoothing, dtype):
    from luminaai_tpu_torch.ops.fused import (
        fused_lm_head_ce_sums,
        virtual_vocab_ce_sums,
    )

    hidden, head, labels, weights = _ce_inputs(dtype)
    kw = dict(label_smoothing=smoothing, chunk_size=16)
    want = fused_lm_head_ce_sums(hidden, head, labels, weights, **kw)
    got = virtual_vocab_ce_sums(hidden, head, labels, weights, n, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g.detach()), float(w.detach()),
                                   rtol=1e-6)

    def grads(sums):
        return torch.autograd.grad(sums[0] + 1e-2 * sums[2], [hidden, head])

    for g, w in zip(grads(got), grads(want)):
        err = float((g.float() - w.float()).abs().max())
        assert err <= 1e-5 * float(w.float().abs().max()), err


@pytest.mark.parametrize("n", [1, 2, 4])
def test_virtual_vocab_lookup_equals_the_whole_lookup(n):
    from luminaai_tpu_torch.ops.fused import virtual_vocab_lookup

    _, table, _, _ = _ce_inputs(torch.float32)
    tokens = torch.randint(0, table.shape[0], (3, 40),
                           generator=torch.Generator().manual_seed(1))
    assert torch.equal(virtual_vocab_lookup(table, tokens, n), table[tokens])
    assert torch.equal(
        virtual_vocab_lookup(table, tokens, n, torch.bfloat16),
        table[tokens].to(torch.bfloat16))
    x = virtual_vocab_lookup(table, tokens, n)
    (g,) = torch.autograd.grad((x * x).sum(), [table])
    (w,) = torch.autograd.grad((table[tokens] ** 2).sum(), [table])
    assert torch.equal(g, w)


def test_virtual_forms_refuse_an_uneven_cut():
    from luminaai_tpu_torch.ops.fused import virtual_vocab_lookup

    with pytest.raises(ValueError):
        virtual_vocab_lookup(torch.zeros(10, 4), torch.zeros(2, 2).long(), 3)


@pytest.mark.parametrize("call", ["encode", "decode"])
def test_a_quantized_table_is_refused_under_tensor_parallelism(call):
    """Serving's int8 tables run on no mesh (as in the JAX package): under
    a tensor group the Embedder refuses them rather than cut them."""
    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.models.layers import Embedder
    from luminaai_tpu_torch.ops.quantized import QuantizedTensor
    from luminaai_tpu_torch.parallel.mesh import MESH_AXES, Mesh, use_mesh

    cfg = Config(**ARCH)
    V, H = cfg.vocab_size, cfg.hidden_size
    emb = Embedder(cfg, dtype=torch.float32, device="cpu")
    del emb.embedding
    emb.embedding = QuantizedTensor(torch.ones(V, H, dtype=torch.int8),
                                    torch.ones(V, 1), 8, (1,), (V, H))
    mesh = Mesh({**{a: 1 for a in MESH_AXES}, "tensor": 2}, MESH_AXES,
                torch.device("cpu"))
    mesh._groups[("tensor",)] = object()  # a group is never reached
    arg = (torch.zeros(1, 4, dtype=torch.long) if call == "encode"
           else torch.zeros(1, 4, H))
    getattr(emb, call)(arg)  # no mesh: the int8 table serves
    with use_mesh(mesh), pytest.raises(ValueError, match="quantized"):
        getattr(emb, call)(arg)
