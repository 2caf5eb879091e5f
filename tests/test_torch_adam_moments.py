"""The port's bf16 and int8 Adam moments against optax, on the CPU.

The JAX side is the JAX package's make_optimizer (optax.adamw with
mu_dtype=bfloat16, and the chain of scale_by_adam_int8,
add_decayed_weights and the schedule), its update run op by op over a flax init of a 2-layer model
with a MoD layer and an MoE layer (so the decay mask, the fused wqkv's
per-head quantisation rows and every parameter kind are covered). Five
steps of the same numpy gradients, drawn from a seed in the flax layout
and converted with convert.params_from_flax, go through both.

- Updates (new - old parameter) within rtol 1e-5 / atol 1e-7.
- bf16: the stored first moment equals optax's bitwise, every step.
- int8: the codes equal JAX's except at rounding ties (|x/scale mod 1 -
  0.5| < 1e-4 for the value being quantised, recomputed from JAX's
  previous state), where they may differ by 1; the scales within rtol
  1e-6.
- describe_optimizer_memory equals the JAX function's by dtype.

Within the port (exact): a save, restore and resume equals the
uninterrupted run bitwise in both forms; a restore into another form is
refused with a message naming both; expert evolution's moment reset,
rollback, and the LoRA optimizer build the configured form.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from luminaai_tpu.config import Config as JConfig
from luminaai_tpu.models.transformer import LuminaTransformer as JModel
from luminaai_tpu.training import optimizer as jopt
from luminaai_tpu_torch import convert
from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.models.transformer import LuminaTransformer
from luminaai_tpu_torch.monitoring.telemetry import MetricsRegistry
from luminaai_tpu_torch.parallel import train_step as ts
from luminaai_tpu_torch.training import adapters
from luminaai_tpu_torch.training import checkpoint as ck
from luminaai_tpu_torch.training import optimizer as topt

ARCH = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=2,
            num_kv_heads=1, seq_length=32, intermediate_size=96,
            precision="fp32", use_moe=True, num_experts=4, moe_top_k=2,
            moe_pattern="sandwich", dense_start_layers=1,
            dense_end_layers=0, use_mod=True, routing_noise_std=0.0,
            learning_rate=1e-2, weight_decay=0.1, warmup_ratio=0.2,
            gradient_checkpointing=False, use_flash_attention=False,
            batch_size=2)
FORMS = {"bf16": dict(adam_mu_dtype="bf16"),
         "int8": dict(adam_state_quantization="int8")}
STEPS, TOTAL = 5, 10


def _unbox(tree):
    from flax import linen as nn

    return jax.tree.map(
        lambda x: x.unbox() if isinstance(x, nn.meta.AxisMetadata) else x,
        tree, is_leaf=lambda x: isinstance(x, nn.meta.AxisMetadata))


def _setup(form):
    jcfg = JConfig(**ARCH, **FORMS[form])
    params = _unbox(JModel(jcfg).init(jax.random.key(0),
                                      jnp.ones((1, 8), jnp.int32))["params"])
    params = jax.device_get(params)
    cfg = Config(**ARCH, **FORMS[form])
    model = LuminaTransformer(cfg, device="cpu", trainable=True)
    model.load_params(convert.params_from_flax(params, cfg))
    return jcfg, params, cfg, model


def _grads(params, seed):
    """Gradients in the flax layout, their rows' scales spread over four
    decades."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda p: (rng.randn(*p.shape) * 10.0 ** rng.uniform(
            -4, 0, p.shape[:-1] + (1,))).astype(np.float32), params)


def _leaves_by_path(tree):
    return convert.flatten_tree(jax.device_get(tree))


@pytest.mark.parametrize("form", ["bf16", "int8"])
def test_moments_match_optax(form):
    jcfg, params, cfg, model = _setup(form)
    jtx = jopt.make_optimizer(jcfg, TOTAL)
    jstate = jtx.init(params)
    jparams = params
    tx = topt.make_optimizer(cfg, TOTAL)
    state = ts.init_train_state(model, tx, seed=0)
    assert state.opt_state.form == form
    mem_j = jopt.describe_optimizer_memory(jstate)
    mem_t = topt.describe_optimizer_memory(state.opt_state)
    assert mem_t == mem_j, (mem_t, mem_j)

    b1, b2 = jcfg.beta1, jcfg.beta2
    for i in range(STEPS):
        g = _grads(params, i)
        prev = jstate
        # Op by op, the program's semantics: under jit, XLA's CPU compiler
        # drops the bf16 rounding of decay * mu (a float-conversion
        # simplification of that backend), which moves the moment by up
        # to one bf16 rounding of that product.
        upd, jstate = jtx.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        before = [p.detach().clone() for p in state.params]
        tgrads = convert.params_from_flax(g, cfg)
        tx.apply(state.params, [tgrads[n] for n in state.names],
                 state.opt_state)
        want = convert.params_from_flax(jax.device_get(upd), cfg)
        for name, p, b in zip(state.names, state.params, before):
            np.testing.assert_allclose((p.detach() - b).numpy(),
                                       want[name].numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{name} {i}")
        if form == "bf16":
            mu_j = convert.params_from_flax(
                {k: np.asarray(v, np.float32) for k, v in
                 _leaves_by_path(jstate[0].mu).items()}, cfg)
            for name, mu in zip(state.names, state.opt_state.mu):
                assert mu.dtype == torch.bfloat16
                assert torch.equal(mu.float(), mu_j[name]), (name, i)
        else:
            _check_int8(cfg, state, prev[0], jstate[0], g, b1, b2, i)


def _check_int8(cfg, state, prev, new, g, b1, b2, step):
    """Codes equal except at ties; scales within rtol 1e-6."""
    opt = state.opt_state
    flat = {}
    for kind in ("mu", "nu"):
        sd = dict(zip(state.names, getattr(opt, f"{kind}_codes")))
        flat[kind] = convert.state_dict_to_flax(sd, cfg)
    g_flat = convert.flatten_tree(g)
    prev_t = {f: _leaves_by_path(getattr(prev, f)) for f in prev._fields
              if f != "count"}
    new_t = {f: _leaves_by_path(getattr(new, f)) for f in new._fields
             if f != "count"}
    ties = 0
    for path, gj in g_flat.items():
        mu_prev = (prev_t["mu_codes"][path].astype(np.float32)
                   * prev_t["mu_scales"][path][..., None])
        nu_prev = (prev_t["nu_codes"][path].astype(np.float32)
                   * prev_t["nu_scales"][path][..., None])
        mu = np.float32(b1) * mu_prev + np.float32(1 - b1) * gj
        nu_sqrt = np.sqrt(np.float32(b2) * nu_prev * nu_prev
                          + np.float32(1 - b2) * gj * gj)
        for kind, x in (("mu", mu), ("nu", nu_sqrt)):
            codes_j = new_t[f"{kind}_codes"][path]
            scale_j = new_t[f"{kind}_scales"][path]
            codes_t = flat[kind][path].numpy()
            diff = codes_t.astype(np.int32) - codes_j.astype(np.int32)
            safe = np.where(scale_j > 0, scale_j, 1.0)[..., None]
            frac = np.abs(x / safe) % 1.0
            tie = np.abs(frac - 0.5) < 1e-4
            assert np.all((diff == 0) | ((np.abs(diff) == 1) & tie)), (
                kind, path, step, int(np.abs(diff).max()))
            ties += int((diff != 0).sum())
    for kind in ("mu", "nu"):
        sd = dict(zip(state.names, getattr(opt, f"{kind}_scales")))
        for name, s in sd.items():
            assert s.dtype == torch.float32
        # Scales compared through the codes' dequantised values.
        deq = {n: topt._dq8(c, sd[n], r).numpy() for n, c, r in zip(
            state.names, getattr(opt, f"{kind}_codes"), opt.rows)}
        want = {}
        for path, codes in new_t[f"{kind}_codes"].items():
            want[path] = codes.astype(np.float32) * new_t[
                f"{kind}_scales"][path][..., None]
        want_sd = convert.params_from_flax(want, cfg)
        for n in state.names:
            np.testing.assert_allclose(deq[n], want_sd[n].numpy(),
                                       rtol=1e-6, atol=0,
                                       err_msg=f"{kind} {n} {step}")
    assert ties <= 2, ties


# -- within the port --------------------------------------------------------
RUN = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=2,
           num_kv_heads=1, seq_length=32, intermediate_size=96,
           precision="fp32", use_moe=True, num_experts=4, moe_top_k=2,
           routing_noise_std=0.1, gradient_checkpointing=False,
           use_flash_attention=False, batch_size=2, max_steps=10)


def _run(cfg, seed=0):
    model = convert.init_params(
        LuminaTransformer(cfg, device="cpu", trainable=True), seed)
    sched = topt.make_schedule(cfg, 10)
    tx = topt.make_optimizer(cfg, 10, sched)
    st = ts.init_train_state(model, tx, seed)
    return model, st, ts.make_train_step(cfg, model, sched, tx)


def _batches(n):
    rng = np.random.RandomState(7)
    return [{"input_ids": torch.as_tensor(
        rng.randint(1, 250, (2, 32))).long()} for _ in range(n)]


def _moments(state):
    return [t.clone() for t in state.opt_state.tensors()]


@pytest.mark.parametrize("form", ["bf16", "int8"])
def test_save_restore_resume_is_bitwise(form, tmp_path):
    cfg = Config(**RUN, **FORMS[form])
    batches = _batches(4)
    _, full, step = _run(cfg)
    for b in batches:
        full, _ = step(full, b)

    _, part, step = _run(cfg)
    for b in batches[:2]:
        part, _ = step(part, b)
    mgr = ck.CheckpointManager(cfg, str(tmp_path), registry=MetricsRegistry())
    mgr.save(part, 2)
    mgr.wait()
    _, resumed, step = _run(cfg, seed=1)
    mgr.restore(resumed, 2)
    assert resumed.opt_state.form == form
    for b in batches[2:]:
        resumed, _ = step(resumed, b)
    for a, b in zip(full.params, resumed.params):
        assert torch.equal(a, b)
    for a, b in zip(_moments(full), _moments(resumed)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert resumed.opt_state.count == full.opt_state.count == 4


def test_restore_into_another_form_is_refused(tmp_path):
    cfg = Config(**RUN, **FORMS["bf16"])
    _, st, step = _run(cfg)
    st, _ = step(st, _batches(1)[0])
    mgr = ck.CheckpointManager(cfg, str(tmp_path), registry=MetricsRegistry())
    mgr.save(st, 1)
    mgr.wait()
    for other in ({}, FORMS["int8"]):
        ocfg = Config(**RUN, **other)
        _, fresh, _ = _run(ocfg)
        omgr = ck.CheckpointManager(ocfg, str(tmp_path),
                                    registry=MetricsRegistry())
        want = "int8" if other else "fp32"
        with pytest.raises(ck.MomentFormError,
                           match=f"holds bf16 .* asks for {want}"):
            omgr.restore(fresh, 1)
        with pytest.raises(ck.MomentFormError):
            omgr.restore_with_fallback(fresh)
        assert fresh.opt_state.count == 0  # nothing was copied in


def test_moment_state_callers_build_the_configured_form(tmp_path):
    """Expert evolution's reset, rollback and the LoRA optimizer take the
    config's form."""
    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.training.trainer import Trainer

    cfg = Config(**{**RUN, "max_steps": 3, "num_experts": 4,
                    "eval_every_n_batches": 10**6,
                    "save_every_n_batches": 2, "watchdog": False,
                    "health_check_interval": 10**6},
                 output_dir=str(tmp_path), **FORMS["int8"])
    trainer = Trainer(cfg, cli._synthetic_batches(cfg), device="cpu", seed=0,
                      registry=MetricsRegistry())
    trainer.train()
    saved = _moments(trainer.state)
    trainer.checkpoints.wait()
    assert 2 in trainer.checkpoints.all_steps()
    assert trainer.rollback(to_step=3, reason="test")
    assert trainer.state.opt_state.form == "int8"
    assert all(torch.equal(a, b) for a, b in
               zip(_moments(trainer.state), saved))
    assert trainer.evolve_experts("add_expert", reason="test")
    opt = trainer.state.opt_state
    assert opt.form == "int8" and opt.count == trainer.global_step
    assert all(int(c.abs().max()) == 0 for c in opt.mu_codes)
    assert [tuple(c.shape) for c in opt.mu_codes] == [
        tuple(p.shape) for p in trainer.state.params]
    trainer.close()

    for form, want in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        tx = adapters.adam(1e-3, dataclasses.replace(cfg, **{
            "adam_state_quantization": None,
            "adam_mu_dtype": "bf16" if form == "bf16" else None}))
        st = tx.init([torch.zeros(4, 8)])
        assert st.form == form and st.mu[0].dtype == want
    st = adapters.adam(1e-3, cfg).init([torch.zeros(4, 8)])
    assert st.form == "int8" and st.mu_codes[0].dtype == torch.int8
    assert adapters.adam(1e-3).init([torch.zeros(2, 2)]).form == "fp32"
