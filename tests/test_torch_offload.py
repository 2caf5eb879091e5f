"""The optimizer's host offload (config.host_offload_optimizer;
training/optimizer.py `_MomentStream`) on the CPU, where its copies go
host to host.

  - Three steps of the unsharded step with the moments offloaded equal
    the same steps with the moments beside the parameters bitwise
    (parameters and every moment), for the fp32, bf16-mu and int8 forms,
    with the moments in host memory between steps.
  - Against JAX's step on one CPU device with host_offload_optimizer set
    (which JAX ignores off the TPU: luminaai_tpu/parallel/sharding.py
    :263-278), fp32 moments: the metrics at rtol 1e-5 and the parameters
    as tests/test_torch_train_step.py holds them. (The bf16 and int8
    forms are held to the moments beside the parameters bitwise above,
    and those to optax op by op in tests/test_torch_adam_moments.py: a
    jitted JAX step rounds bf16 mu otherwise, ROADMAP §C.)
  - The Trainer after an expert add: the moments re-initialised into
    host memory (JAX init_opt_to_shardings' role), and the steps after it
    bitwise those of the Trainer without offload.
  - The sharded step over 2 gloo ranks (fsdp 2): offloaded equals not
    offloaded bitwise, and gather_full / load_full carry offloaded
    moments.
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
    port_case,
)

ARCH = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, seq_length=32, intermediate_size=128,
            precision="fp32", batch_size=4, learning_rate=1e-2,
            use_moe=True, num_experts=4, moe_pattern="all",
            moe_dispatch="gather", routing_noise_std=0.0,
            gradient_checkpointing=False, use_flash_attention=False)
FORMS = {"fp32": {}, "bf16": dict(adam_mu_dtype="bf16"),
         "int8": dict(adam_state_quantization="int8")}


def _batches(n=3):
    rng = np.random.RandomState(0)
    return [{"input_ids": rng.randint(1, 256, (4, 32)).astype(np.int64)}
            for _ in range(n)]


def _steps(kw, offload: bool):
    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.convert import init_params
    from luminaai_tpu_torch.models.transformer import LuminaTransformer
    from luminaai_tpu_torch.parallel import train_step as ts
    from luminaai_tpu_torch.training.optimizer import (
        make_optimizer,
        make_schedule,
    )

    cfg = Config(**kw, host_offload_optimizer=offload)
    model = init_params(LuminaTransformer(cfg, device="cpu",
                                          trainable=True), 0)
    sched = make_schedule(cfg, 5)
    tx = make_optimizer(cfg, 5, sched)
    state = ts.init_train_state(model, tx, 0)
    step = ts.make_train_step(cfg, model, sched, tx)
    for b in _batches():
        state, _ = step(state, {k: torch.as_tensor(v) for k, v in
                                b.items()})
    return state


@pytest.mark.parametrize("form", sorted(FORMS))
def test_offloaded_steps_equal_the_moments_beside_the_parameters(form):
    kw = {**ARCH, **FORMS[form]}
    beside, off = _steps(kw, False), _steps(kw, True)
    assert off.opt_state.offloaded and not beside.opt_state.offloaded
    assert all(t.device.type == "cpu" for t in off.opt_state.tensors())
    for a, b in zip(beside.params + beside.opt_state.tensors(),
                    off.params + off.opt_state.tensors()):
        assert torch.equal(a, b)


def test_offloaded_steps_match_jax():
    form = "fp32"
    kw = {**ARCH, "host_offload_optimizer": True}
    handle, init = jax_init(kw, n_devices=1, total=5)
    jtrace, jfinal = jax_steps(handle, _batches())
    trace, params = port_case(kw, init, _batches(), total=5, one_rank=True)
    worst = assert_close_trace(
        {k: v for k, v in trace.items() if k != "grad_norm"}, jtrace, 1e-5,
        form)
    assert_close_trace({"grad_norm": trace["grad_norm"]},
                       {"grad_norm": jtrace["grad_norm"]}, 1e-4, form)
    worst_p = assert_params(params, jfinal, sum(trace["learning_rate"]),
                            form)
    print(f"{form} offloaded vs JAX: metrics rel {worst:.2e}, params abs "
          f"{worst_p:.2e}")


def _trainer(tmp, offload):
    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.training.trainer import Trainer

    cfg = Config(**ARCH, host_offload_optimizer=offload, max_steps=6,
                 save_every_n_batches=10**9, output_dir=str(tmp))
    return Trainer(cfg, cli._synthetic_batches(cfg), device="cpu", seed=0)


def test_expert_add_reinitialises_offloaded_moments(tmp_path):
    runs = {}
    for offload in (False, True):
        t = _trainer(tmp_path / str(offload), offload)
        it = iter(t.train_data())
        for i in range(4):
            if i == 2:
                assert t.evolve_experts("add_expert", reason="test")
            t.state, _ = t.train_step(t.state, t._to_device(next(it)))
            t.global_step += 1
        runs[offload] = t.state
        t.close()
    off, beside = runs[True], runs[False]
    assert off.opt_state.offloaded and off.opt_state.count == 4
    assert all(t.device.type == "cpu" for t in off.opt_state.tensors())
    assert off.params[0].shape == beside.params[0].shape
    for a, b in zip(beside.params + beside.opt_state.tensors(),
                    off.params + off.opt_state.tensors()):
        assert torch.equal(a, b)


def _sharded(rank, n, forms):
    import torch.distributed as dist

    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.parallel import train_step as ts
    from luminaai_tpu_torch.parallel.mesh import build_mesh
    from luminaai_tpu_torch.parallel.sharding import init_sharded_state
    from luminaai_tpu_torch.training.optimizer import (
        make_optimizer,
        make_schedule,
    )

    out = {}
    for form in forms:
        got = []
        for offload in (False, True):
            cfg = Config(**ARCH, **FORMS[form], fsdp_parallel_size=2,
                         host_offload_optimizer=offload)
            mesh = build_mesh(cfg, device=torch.device("cpu"))
            sched = make_schedule(cfg, 5)
            tx = make_optimizer(cfg, 5, sched)
            model, state = init_sharded_state(cfg, mesh, tx, 0)
            step = ts.make_sharded_train_step(cfg, model, sched, tx, mesh)
            for b in _batches():
                state, _ = step(state, ts.shard_batch(
                    {k: torch.as_tensor(v) for k, v in b.items()}, mesh,
                    cfg))
            full = state.gather_full()
            box = [full]
            dist.broadcast_object_list(box, src=0)
            state.load_full(box[0])  # back into the (offloaded) shards
            got.append((state.params + state.opt_state.tensors(),
                        state.opt_state.offloaded))
        out[form] = (all(torch.equal(a, b) for a, b in zip(got[0][0],
                                                            got[1][0])),
                     got[1][1], all(t.device.type == "cpu"
                                    for t in got[1][0][len(state.params):]))
    return out


def test_sharded_offloaded_steps_equal_the_moments_beside(tmp_path):
    res = Ranks(2, _sharded, (sorted(FORMS),), tmp_path).join()
    for r in res:
        assert all(all(v) for v in r.values()), r
