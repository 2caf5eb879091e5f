"""The port's LoRA adapters against the JAX package's, dense and MoE.

Both sides hold the same base weights (a flax init, converted with
convert.params_from_flax) in fp32 on the CPU, routing noise and dropout
off. The adapter factors are JAX's (drawn by its init_lora_params), so:

- the port's merge of JAX-drawn factors (b made non-zero) equals JAX's
  merge within 1e-6 x max|W|, in flax space and through the model's fused
  tensors;
- an adapter saved by JAX loads in the port, and one saved by the port
  loads in JAX, factors and spec equal;
- the factors' gradients within 1e-5 of their max;
- 3 LoRA steps (JAX make_lora_train_step with optax.adam against the
  port's with its optax-exact Adam): each loss within rtol 1e-5, every
  factor after the steps within rtol 1e-5 plus 1e-3 of its max, which
  Adam's normalisation of near-zero gradients needs (LORA_STEP_CASES);
  the base parameters bitwise untouched and frozen;
- a mismatched adapter is rejected as in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from luminaai_tpu.config import Config as JConfig
from luminaai_tpu.models.transformer import LuminaTransformer as JModel
from luminaai_tpu.training import adapters as jad
from luminaai_tpu_torch.config import Config as TConfig
from luminaai_tpu_torch.convert import (
    flatten_tree,
    flax_to_state_dict,
    params_from_flax,
    state_dict_to_flax,
)
from luminaai_tpu_torch.models.transformer import LuminaTransformer as TModel
from luminaai_tpu_torch.training import adapters as tad

ARCH = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, seq_length=64, intermediate_size=128,
            precision="fp32", routing_noise_std=0.0)
CASES = {
    "dense": (dict(use_moe=False), (r"attention/", r"ffn/")),
    "moe": (dict(use_moe=True, num_experts=4, moe_top_k=2),
            (r"attention/", r"ffn/", r"moe/")),
}


def _unbox(params):
    from flax import linen as nn

    return jax.tree.map(
        lambda x: x.unbox() if isinstance(x, nn.meta.AxisMetadata) else x,
        params, is_leaf=lambda x: isinstance(x, nn.meta.AxisMetadata),
    )


@pytest.fixture(scope="module", params=sorted(CASES))
def setup(request):
    extra, patterns = CASES[request.param]
    jcfg = JConfig(**ARCH, **extra, use_flash_attention=False,
                   gradient_checkpointing=False)
    jmodel = JModel(jcfg)
    ids = np.random.RandomState(0).randint(1, 256, (2, ARCH["seq_length"]))
    params = _unbox(jax.jit(jmodel.init)(
        jax.random.key(0), jnp.asarray(ids, jnp.int32))["params"])
    tcfg = TConfig(**ARCH, **extra)
    flat = flatten_tree(jax.device_get(params))
    return dict(name=request.param, jcfg=jcfg, jmodel=jmodel, params=params,
                tcfg=tcfg, flat=flat, ids=ids, patterns=patterns)


def _torch_lora(lora):
    return {k: {s: torch.tensor(np.asarray(v)) for s, v in ab.items()}
            for k, ab in lora.items()}


def _jax_lora(setup, spec, nonzero_b=False):
    lora = jad.init_lora_params(setup["params"], spec, jax.random.key(1))
    if nonzero_b:
        rng = np.random.RandomState(2)
        lora = {k: {"a": ab["a"], "b": jnp.asarray(
            rng.normal(0, 0.05, ab["b"].shape), jnp.float32)}
            for k, ab in lora.items()}
    return lora


def _spec_pair(setup, **kw):
    kw.setdefault("target_patterns", setup["patterns"])
    return jad.LoRASpec(**kw), tad.LoRASpec(**kw)


def test_merge_of_jax_factors_equals_jax(setup):
    jspec, tspec = _spec_pair(setup, rank=4, alpha=8.0)
    lora = _jax_lora(setup, jspec, nonzero_b=True)
    want = flatten_tree(jax.device_get(
        jad.merge_lora(setup["params"], lora, jspec)))
    base = {k: torch.tensor(v) for k, v in setup["flat"].items()}
    got = tad.merge_lora(base, _torch_lora(lora), tspec)
    assert set(got) == set(want)
    if setup["name"] == "moe":
        assert any("/moe/" in k for k in lora)
    for k in lora:
        w = want[k]
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max())
        assert not np.array_equal(w, setup["flat"][k])
    # Through the model's fused tensors: the merged state_dict equals the
    # conversion of JAX's merged tree.
    cfg = setup["tcfg"]
    model = TModel(cfg, device="cpu").load_params(
        params_from_flax(setup["flat"], cfg))
    merged_sd = flax_to_state_dict(tad.merge_lora(
        state_dict_to_flax(model.state_dict(), cfg), _torch_lora(lora),
        tspec), cfg)
    for name, t in params_from_flax(want, cfg).items():
        np.testing.assert_allclose(merged_sd[name].numpy(), t.numpy(),
                                   rtol=0, atol=1e-6 * t.abs().max().item())


def test_adapter_files_interchange(setup, tmp_path):
    jspec, tspec = _spec_pair(setup, rank=4, alpha=32.0)
    lora = _jax_lora(setup, jspec, nonzero_b=True)
    jad.save_lora(str(tmp_path / "from_jax.npz"), lora, jspec)
    got, spec = tad.load_lora(str(tmp_path / "from_jax.npz"))
    assert spec == tspec and set(got) == set(lora)
    for k in lora:
        for sub in ("a", "b"):
            np.testing.assert_array_equal(got[k][sub].numpy(),
                                          np.asarray(lora[k][sub]))
    tad.save_lora(str(tmp_path / "from_port"), got, spec)
    back, jspec2 = jad.load_lora(str(tmp_path / "from_port.npz"))
    assert jspec2 == jspec and set(back) == set(lora)
    for k in lora:
        for sub in ("a", "b"):
            np.testing.assert_array_equal(np.asarray(back[k][sub]),
                                          np.asarray(lora[k][sub]))


def test_lora_gradients_equal_jax(setup):
    """The factors' gradients of one LoRA loss (b non-zero, so a gets one
    too) within 1e-5 of each factor's largest gradient."""
    from luminaai_tpu.parallel.train_step import make_loss_fn as jloss_fn
    from luminaai_tpu_torch.parallel.train_step import make_loss_fn

    jspec, tspec = _spec_pair(setup, rank=4, alpha=8.0)
    lora = _jax_lora(setup, jspec, nonzero_b=True)
    inner = jloss_fn(setup["jcfg"], setup["jmodel"])
    batch = {"input_ids": jnp.asarray(setup["ids"], jnp.int32)}
    want = jax.jit(jax.grad(lambda lo: inner(
        jad.merge_lora(setup["params"], lo, jspec), batch,
        jax.random.key(0))[0]))(lora)

    cfg = setup["tcfg"]
    model = TModel(cfg, device="cpu", trainable=True).load_params(
        params_from_flax(setup["flat"], cfg)).requires_grad_(False)
    tlora = _torch_lora(lora)
    leaves = [t.requires_grad_(True) for t in tad.lora_leaves(tlora)]
    with tad.installed_weights(
            model, tad.adapted_tensors(model, cfg, tlora, tspec)):
        loss, _ = make_loss_fn(cfg, model)(
            {"input_ids": torch.as_tensor(setup["ids"])}, None)
        grads = torch.autograd.grad(loss, leaves)
    names = [(k, sub) for k in tlora for sub in ("a", "b")]
    for (k, sub), g in zip(names, grads):
        w = np.asarray(want[k][sub])
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=f"{k}::{sub}")


# (learning rate, tolerance of each factor after 3 steps as a share of its
# max, on top of rtol 1e-5). The gradients agree to 1e-6-7e-6 of their
# max (fp32 summation order: XLA's einsums against the port's fused
# projections; test_lora_gradients_equal_jax). Adam's normalised update
# mu_hat / (sqrt(nu_hat) + eps) amplifies that for the few elements whose
# gradient is near zero or changes sign between steps: the worst element
# differed by 4.3e-4 of its factor's max (dense) and 1.0e-4 (MoE) at
# both rates on this CPU; every other element is within rtol 1e-5.
LORA_STEP_CASES = [(1e-4, 1e-3), (1e-2, 1e-3)]


@pytest.mark.parametrize("lr,factor_tol", LORA_STEP_CASES,
                         ids=["lr1e-4", "lr1e-2"])
def test_three_lora_steps_equal_jax(setup, lr, factor_tol):
    jspec, tspec = _spec_pair(setup, rank=4, alpha=8.0)
    lora = _jax_lora(setup, jspec)
    batch = {"input_ids": jnp.asarray(setup["ids"], jnp.int32)}
    tx = optax.adam(lr)
    jstep = jad.make_lora_train_step(setup["jcfg"], setup["jmodel"],
                                     setup["params"], jspec, tx)
    carry = (lora, tx.init(lora))
    jlosses = []
    for i in range(3):
        carry, m = jstep(carry, batch, jax.random.key(i))
        jlosses.append(float(m["loss"]))

    cfg = setup["tcfg"]
    model = TModel(cfg, device="cpu", trainable=True).load_params(
        params_from_flax(setup["flat"], cfg))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    ttx = tad.adam(lr)
    tstep = tad.make_lora_train_step(cfg, model, tspec, ttx)
    tlora = _torch_lora(lora)
    tcarry = (tlora, ttx.init(tad.lora_leaves(tlora)))
    tbatch = {"input_ids": torch.as_tensor(setup["ids"], dtype=torch.int64)}
    tlosses = []
    for _ in range(3):
        tcarry, m = tstep(tcarry, tbatch, torch.Generator().manual_seed(0))
        tlosses.append(float(m["loss"]))
        assert torch.isfinite(m["grad_norm"])

    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert jlosses[-1] < jlosses[0]
    for k, ab in carry[0].items():
        for sub in ("a", "b"):
            want = np.asarray(ab[sub])
            np.testing.assert_allclose(
                tcarry[0][k][sub].detach().numpy(), want, rtol=1e-5,
                atol=factor_tol * np.abs(want).max(), err_msg=f"{k}::{sub}")
        assert float(np.abs(np.asarray(ab["b"])).max()) > 0
    # The base stayed frozen and bitwise unchanged; the parameters are
    # back in their modules after each step.
    for n, p in model.named_parameters():
        assert isinstance(p, torch.nn.Parameter) and not p.requires_grad
        assert torch.equal(p, before[n]), n
    assert set(dict(model.named_parameters())) == set(before)


def test_init_and_count_follow_jax_shapes(setup):
    jspec, tspec = _spec_pair(setup, rank=4)
    jl = _jax_lora(setup, jspec)
    cfg = setup["tcfg"]
    model = TModel(cfg, device="cpu").load_params(
        params_from_flax(setup["flat"], cfg))
    tl = tad.init_lora_params(
        state_dict_to_flax(dict(model.named_parameters()), cfg), tspec, 0)
    assert {k: {s: tuple(t.shape) for s, t in ab.items()}
            for k, ab in tl.items()} == {
        k: {s: tuple(v.shape) for s, v in ab.items()} for k, ab in jl.items()}
    assert tad.lora_param_count(tl) == jad.lora_param_count(jl)
    assert all(float(ab["b"].abs().max()) == 0 for ab in tl.values())


def test_mismatched_adapter_rejected_as_in_jax(setup):
    jspec, tspec = _spec_pair(setup, rank=2)
    lora = _jax_lora(setup, jspec)
    bogus = {f"nonexistent/{k}": v for k, v in lora.items()}
    with pytest.raises(ValueError, match="does not match"):
        jad.merge_lora(setup["params"], bogus, jspec)
    base = {k: torch.tensor(v) for k, v in setup["flat"].items()}
    with pytest.raises(ValueError, match="does not match"):
        tad.merge_lora(base, _torch_lora(bogus), tspec)
    with pytest.raises(ValueError, match="no LoRA targets"):
        tad.init_lora_params(base, tad.LoRASpec(target_patterns=("x/",)), 0)
