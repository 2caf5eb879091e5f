"""The port's ring attention (ops/ring_attention.py) in 4 gloo processes,
against the JAX package's ring attention on a 4-device sequence mesh and
its sharded train step with ring attention.

  - op level, sequence 512 over 4 ranks (128 rows a rank), 4 q over 2 kv
    heads, head_dim 64, fp32: causal, causal with window 200 (steps 1-2
    of the later ranks straddle the band) and non-causal; the flash body
    (flash_attention_with_lse, the plain B1-B3 on the CPU) and the einsum
    body; outputs and dq/dk/dv of sum(o * w) within 2e-5 of JAX's
    einsum ring (use_flash=False: its interpret-mode kernel takes minutes
    here), and the flash body's chunk counts;
  - the virtual ring (virtual_ring_attention, what chip_smoke.py runs on
    one card) equals the 4-process ring: outputs and gradients within
    1e-6;
  - two train steps at dp2 x sp2 (causal) and sp4 (window 24), widths as
    tests/test_torch_sharded_step.py: loss, ce_loss, tokens and lr rtol
    1e-5 and grad_norm 1e-4 against JAX's sharded step, everything rtol
    1e-5 against the port's one-rank step; parameters as there.
The ranks are spawned once for the file (tests/torch_mesh_harness.py).
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
    "dp2_sp2": dict(sequence_parallel_size=2),
    "sp4_window": dict(sequence_parallel_size=4, attention_window=24),
}
OPS = {"causal": (True, None), "window": (True, 200),
       "non_causal": (False, None)}
S, HQ, HKV, D = 512, 4, 2, 64


def _qkvw(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(1, S, h, D).astype(np.float32) * s
            for h, s in ((HQ, 1.0), (HKV, 1.0), (HKV, 1.0), (HQ, 1.0))]


def _batches(n=2):
    out = []
    for s in range(n):
        rng = np.random.RandomState(20 + s)
        out.append({"input_ids": rng.randint(
            1, ARCH["vocab_size"], (ARCH["batch_size"], ARCH["seq_length"])
        ).astype(np.int64)})
    return out


def _jax_ring(causal, window):
    """JAX's ring over a 4-device 'sequence' mesh: (o, dq, dk, dv)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from luminaai_tpu.ops.ring_attention import ring_attention

    q, k, v, w = (jnp.asarray(a) for a in _qkvw())
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("sequence",))
    spec = P(None, "sequence", None, None)

    def f(q, k, v):
        o = ring_attention(q, k, v, mesh, causal=causal, q_spec=spec,
                           kv_spec=spec, window=window)
        return jnp.sum(o * w), o

    (_, o), g = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2),
                                           has_aux=True))(q, k, v)
    return [np.asarray(t) for t in (o, *g)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    batches = _batches()
    handles, cases = {}, []
    for name, kw in CASES.items():
        kw = {**ARCH, **kw}
        handles[name], init = jax_init(kw)
        cases.append((name, kw, init, batches))
    ranks = Ranks(4, _ranks_body, (cases,), tmp_path_factory.mktemp("r"))
    jax_ops = {name: _jax_ring(*cw) for name, cw in OPS.items()}
    jax_runs = {name: jax_steps(h, batches) for name, h in handles.items()}
    out = ranks.join()
    one = {name: out[0]["one:" + name] for name, _, _, _ in cases}
    return jax_runs, one, out, jax_ops


def _ranks_body(rank, n, cases):
    out = port_cases(rank, n, cases)
    out["ops"] = {name: _port_ring(rank, *cw) for name, cw in OPS.items()}
    return out


def _port_ring(rank, causal, window):
    """This rank's (o, dq, dk, dv) rows from the flash and einsum bodies,
    the flash body's chunk kinds, and (rank 0) the virtual ring's."""
    import torch

    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.ops import ring_attention as ra
    from luminaai_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(Config(sequence_parallel_size=4, hidden_size=64,
                             num_heads=4, num_kv_heads=2),
                      device=torch.device("cpu"))
    full = [torch.as_tensor(a) for a in _qkvw()]
    rows = slice(rank * S // 4, (rank + 1) * S // 4)
    res = {}
    for body in ("flash", "einsum"):
        q, k, v = (t[:, rows].clone().requires_grad_() for t in full[:3])
        o = ra.ring_attention(q, k, v, mesh, causal=causal,
                              use_flash=body == "flash", block_q=128,
                              block_kv=128, window=window)
        (o * full[3][:, rows]).sum().backward()
        res[body] = [t.detach() for t in (o, q.grad, k.grad, v.grad)]
    res["kinds"] = [ra.chunk_kind(rank, s, 4, S // 4, causal, window)
                    for s in range(4)]
    if rank == 0:
        q, k, v = (t.clone().requires_grad_() for t in full[:3])
        kinds = {}
        o = ra.virtual_ring_attention(q, k, v, 4, causal=causal,
                                      window=window, block_q=128,
                                      block_kv=128, kinds=kinds)
        (o * full[3]).sum().backward()
        res["virtual"] = [t.detach() for t in (o, q.grad, k.grad, v.grad)]
        res["virtual_kinds"] = kinds
    return res


def _assembled(out, op, body):
    return [np.concatenate([r["ops"][op][body][i].numpy() for r in out],
                           axis=1) for i in range(4)]


@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("body", ["flash", "einsum"])
def test_ring_attention_matches_jax(runs, op, body):
    got = _assembled(runs[2], op, body)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, runs[3][op]):
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=0,
                                   err_msg=f"{op} {body} {name}")


@pytest.mark.parametrize("op", sorted(OPS))
def test_virtual_ring_equals_the_process_ring(runs, op):
    got = _assembled(runs[2], op, "flash")
    virtual = runs[2][0]["ops"][op]["virtual"]
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, virtual):
        np.testing.assert_allclose(g, w.numpy(), atol=1e-6, rtol=0,
                                   err_msg=f"{op} {name}")
    seen = {}
    for r in runs[2]:
        for kind in r["ops"][op]["kinds"]:
            seen[kind] = seen.get(kind, 0) + 1
    assert seen == runs[2][0]["ops"][op]["virtual_kinds"]


def test_chunk_kinds_of_the_three_cases(runs):
    """causal: 4 diagonal + 6 visible, 6 skipped; window 200 over 128-row
    chunks: steps 1 and 2 straddle the band's far edge (nearest pairs 1
    and 129 apart, farthest 255 and 383), step 3 lies past it (257), with
    the 6 future chunks skipped; non-causal: every chunk."""
    kinds = {op: runs[2][0]["ops"][op]["virtual_kinds"] for op in OPS}
    assert kinds["causal"] == {"diagonal": 4, "attend": 6, "skip": 6}
    assert kinds["window"] == {"diagonal": 4, "banded": 5, "skip": 7}
    assert kinds["non_causal"] == {"diagonal": 4, "attend": 12}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sequence_parallel_step_matches_jax(runs, case):
    jax_runs, _, out, _ = runs
    jtrace, jfinal = jax_runs[case]
    trace, params = out[0][case]
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


@pytest.mark.parametrize("case", sorted(CASES))
def test_sequence_parallel_step_matches_one_rank(runs, case):
    _, one, out, _ = runs
    trace, params = out[0][case]
    otrace, oparams = one[case]
    worst = assert_close_trace(trace, otrace, 1e-5, case)
    worst_p = assert_params(params, oparams, sum(trace["learning_rate"]),
                            case)
    print(f"{case} vs one rank: metrics rel {worst:.2e}, params abs "
          f"{worst_p:.2e}")
