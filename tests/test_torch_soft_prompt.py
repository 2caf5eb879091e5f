"""The port's soft-prompt tuning (training/adapters.py) against the JAX
package's (luminaai_tpu/training/adapters.py:245-319).

Both sides hold one flax tree of weights (the port's seeded init through
convert.state_dict_to_flax, loaded back with convert.params_from_flax) in
fp32 on the CPU, routing noise off, and start from the same [P, H]
prompt array:

- three `make_prompt_tuning_step` steps (JAX's with optax.adam against
  the port's with its optax-exact Adam), dense and with 8 experts, on a
  batch with a loss mask: each loss within rtol 1e-5, the prompt after
  every step within 1e-5 plus 1e-3 of its max (Adam's normalisation of
  near-zero gradients, the LoRA rule of ROADMAP §C); the base frozen
  (requires_grad False, no .grad, bitwise unchanged), the Adam moments
  the prompt's alone;
- `prepend_soft_prompt` warns when S + P is not flash-eligible, and not
  when it is;
- `init_soft_prompt` draws rows of the embedding table from a
  torch.Generator.
"""

import logging

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
    init_params,
    params_from_flax,
    state_dict_to_flax,
)
from luminaai_tpu_torch.models.transformer import LuminaTransformer as TModel
from luminaai_tpu_torch.training import adapters as tad

ARCH = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, seq_length=64, intermediate_size=128,
            precision="fp32", routing_noise_std=0.0)
B, S, P, LR = 2, 24, 8, 1e-2


def _nest(flat):
    tree = {}
    for path, v in flat.items():
        *heads, leaf = path.split("/")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = jnp.asarray(v.numpy())
    return tree


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe8"])
def test_prompt_tuning_steps_equal_jax(moe):
    extra = dict(use_moe=moe)
    if moe:
        extra.update(num_experts=8, moe_top_k=2)
    tcfg = TConfig(**ARCH, **extra)
    flat = state_dict_to_flax(
        init_params(TModel(tcfg, device="cpu"), 0).state_dict(), tcfg)
    jcfg = JConfig(**ARCH, **extra, use_flash_attention=False,
                   gradient_checkpointing=False)
    jmodel = JModel(jcfg)
    params = _nest(flat)
    rng = np.random.RandomState(1)
    ids = rng.randint(1, 256, (B, S)).astype(np.int32)
    mask = (rng.rand(B, S) > 0.2).astype(np.float32)
    prompt0 = rng.normal(0, 0.3, (P, ARCH["hidden_size"])).astype(
        np.float32)

    tx = optax.adam(LR)
    jstep = jad.make_prompt_tuning_step(jcfg, jmodel, params, tx)
    jprompt = jnp.asarray(prompt0)
    jcarry = (jprompt, tx.init(jprompt))
    jbatch = {"input_ids": jnp.asarray(ids), "loss_mask": jnp.asarray(mask)}

    model = TModel(tcfg, device="cpu", trainable=True).load_params(
        params_from_flax(flat, tcfg))
    base = {n: p.detach().clone() for n, p in model.named_parameters()}
    ttx = tad.adam(LR)
    prompt = torch.tensor(prompt0)
    state = ttx.init([prompt])
    carry = (prompt, state)
    step = tad.make_prompt_tuning_step(tcfg, model, ttx)
    batch = {"input_ids": torch.as_tensor(ids, dtype=torch.long),
             "loss_mask": torch.as_tensor(mask)}
    for i in range(3):
        jcarry, jm = jstep(jcarry, jbatch)
        carry, m = step(carry, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"step {i}")
        want = np.asarray(jcarry[0])
        np.testing.assert_allclose(carry[0].numpy(), want, rtol=0,
                                   atol=1e-5 + 1e-3 * np.abs(want).max())
        assert float(m["grad_norm"]) > 0
    assert carry[0] is prompt and not prompt.requires_grad
    assert [t.shape for t in state.tensors()] == [prompt.shape] * 2
    for n, p in model.named_parameters():
        assert not p.requires_grad and p.grad is None, n
        assert torch.equal(p, base[n]), n


def test_prepend_warns_when_flash_ineligible(caplog):
    # head_dim 64: the flash gate's multiple.
    cfg = TConfig(**dict(ARCH, hidden_size=128, num_heads=2,
                         num_kv_heads=1), use_moe=False,
                  use_flash_attention=True)
    model = init_params(TModel(cfg, device="cpu"), 0)
    ids = torch.ones((1, 100), dtype=torch.long)
    with caplog.at_level(logging.WARNING, logger=tad.__name__):
        logits, _ = tad.prepend_soft_prompt(model, torch.zeros(20, 128), ids)
    assert logits.shape == (1, 100, ARCH["vocab_size"])
    assert "flash-ineligible" in caplog.text and "seq 120" in caplog.text
    caplog.clear()
    # S + P = 128: eligible (the port's gate is JAX's flash_eligible).
    with caplog.at_level(logging.WARNING, logger=tad.__name__):
        tad.prepend_soft_prompt(model, torch.zeros(28, 128), ids)
    assert "flash-ineligible" not in caplog.text


def test_init_soft_prompt_draws_table_rows():
    cfg = TConfig(**ARCH, use_moe=False)
    model = init_params(TModel(cfg, device="cpu"), 0)
    gen = torch.Generator().manual_seed(5)
    prompt = tad.init_soft_prompt(model, 12, gen)
    table = model.embedder.embedding.detach()
    assert prompt.shape == (12, ARCH["hidden_size"])
    assert prompt.dtype == torch.float32
    for row in prompt:
        assert (table == row).all(dim=1).any()
    again = tad.init_soft_prompt(model, 12,
                                 torch.Generator().manual_seed(5))
    assert torch.equal(prompt, again)
