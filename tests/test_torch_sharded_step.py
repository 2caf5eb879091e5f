"""The port's sharded train step (parallel/sharding.py, FSDP2 over
(data, fsdp), tensor-parallel slices) in 4 gloo processes, against the JAX
package's sharded step on the same mesh over 4 of the conftest's CPU
devices and against the port's one-rank step.

Widths: vocab 256, hidden 64, 2 layers, 4 q over 2 kv heads, sequence 64,
fp32, batch 8 with a loss mask and loss weights, clipping at 0.5, two
steps. The ranks are spawned once for the file (tests/torch_mesh_harness.py)
and run every case.

Tolerances: loss, ce_loss, tokens_in_loss and the learning rate rtol
1e-5, grad_norm rtol 1e-5 against the one-rank port and 1e-4 against JAX
(the norm reduces in other orders there, as tests/test_torch_train_step.py
holds it); parameters as tests/test_torch_train_step.py holds them (every
element within 2 x the summed learning rates + 1e-6, 99.9% within 1e-6).
"""

import numpy as np
import pytest

from torch_mesh_harness import (
    Ranks,
    assert_close_trace,
    assert_params,
    jax_init,
    jax_steps,
    port_cases,
)

ARCH = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, seq_length=64, intermediate_size=128,
            precision="fp32", batch_size=8, grad_clip_norm=0.5,
            learning_rate=1e-3, warmup_ratio=0.25,
            gradient_checkpointing=False, use_flash_attention=False,
            use_moe=False)
CASES = {
    "dp2_fsdp2": dict(data_parallel_size=2, fsdp_parallel_size=2,
                      gradient_accumulation_steps=2),
    "fsdp2_tp2": dict(fsdp_parallel_size=2, tensor_parallel_size=2),
}
# Port against the one-rank port only (the JAX int8 moments are compared
# on one device in tests/test_torch_adam_moments.py; the file's time
# allows two JAX meshes).
PORT_ONLY = {
    # kv heads (2) do not divide over 4 tensor ranks: the JAX fallback.
    "tp4_kv_whole": dict(tensor_parallel_size=4),
    "fsdp2_tp2_int8": dict(fsdp_parallel_size=2, tensor_parallel_size=2,
                           adam_state_quantization="int8"),
}


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
    and the one-rank port run while they work."""
    batches = _batches()
    handles, cases = {}, []
    for name, kw in CASES.items():
        kw = {**ARCH, **kw}
        handles[name], init = jax_init(kw)
        cases.append((name, kw, init, batches))
    for name, kw in PORT_ONLY.items():  # the same widths' initial weights
        cases.append((name, {**ARCH, **kw}, cases[0][2], batches))
    ranks = Ranks(4, _ranks_body, (cases,), tmp_path_factory.mktemp("r"))
    jax_runs = {name: jax_steps(h, batches) for name, h in handles.items()}
    out = ranks.join()
    one = {name: out[0]["one:" + name] for name, _, _, _ in cases}
    return jax_runs, one, out[0], [r["round_trip"] for r in out]


def _ranks_body(rank, n, cases):
    out = port_cases(rank, n, cases)
    out["round_trip"] = _round_trip(rank, n, {**ARCH,
                                              **PORT_ONLY["fsdp2_tp2_int8"]})
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_matches_jax(runs, case):
    jax_runs, _, port, _ = runs
    jtrace, jfinal = jax_runs[case]
    trace, params = port[case]
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
def test_sharded_step_matches_one_rank(runs, case):
    _, one, port, _ = runs
    trace, params = port[case]
    otrace, oparams = one[case]
    worst = assert_close_trace(trace, otrace, 1e-5, case)
    worst_p = assert_params(params, oparams, sum(trace["learning_rate"]),
                            case)
    print(f"{case} vs one rank: metrics rel {worst:.2e}, params abs "
          f"{worst_p:.2e}")


def test_sharded_state_round_trips_through_the_one_rank_layout(runs):
    """gather_full then load_full into fresh shards gives back the same
    shards on every rank (the checkpoint path), with int8 moments and
    FSDP2-sharded 1-D parameters."""
    assert all(runs[3]), runs[3]


def _round_trip(rank, n, kw):
    import torch

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
    model, state = init_sharded_state(cfg, mesh, tx, 3)
    step = ts.make_sharded_train_step(cfg, model, sched, tx, mesh)
    b = {k: torch.as_tensor(v) for k, v in _batches(1)[0].items()}
    step(state, ts.shard_batch(b, mesh, cfg))
    full = state.gather_full()
    buf = [full]
    torch.distributed.broadcast_object_list(buf, src=0)
    model2, state2 = init_sharded_state(cfg, mesh, tx, 99)
    state2.load_full(buf[0])
    opt, opt2 = state.opt_state, state2.opt_state
    pairs = list(zip(state.params, state2.params))
    pairs += list(zip(opt.mu_codes + opt.mu_scales + opt.nu_codes
                      + opt.nu_scales, opt2.mu_codes + opt2.mu_scales
                      + opt2.nu_codes + opt2.nu_scales))
    return (all(torch.equal(a, b) for a, b in pairs)
            and opt2.count == opt.count and state2.step == state.step)
