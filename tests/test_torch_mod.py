"""Mixture of depths (models/mod.py) and the MoD / hybrid MoE+MoD models
against the JAX package, on the CPU in fp32.

- The layer: JAX MoDRouter + apply_mod around a SwiGLU and the port's, on
  the same weights and input (numpy seed). Router indices exactly equal;
  the output, the BCE aux loss and the gradients of sum(out * ct) + aux
  (x, router, bias, wi, wo: the straight-through path included) within
  atol/rtol 1e-5; mod_compute_ratio equal.
- A 3-layer use_mod model and a 3-layer hybrid (use_moe, every_3rd: MoE on
  layer 2, MoD on layers 0-1), weights from a flax init: the JAX train
  step's loss and gradients (rtol 1e-5 loss, 1e-4 grad norm, each
  gradient within 1e-6) and the parameters after one AdamW step (within
  2 lr + 1e-6, 99.9% within 1e-6, as test_torch_train_step.py).
- Greedy decode of the MoD model (its decode path runs the dense SwiGLU,
  as the JAX decoder does): tokens identical to the JAX decoder's.
- Trainer.adjust_mod_capacity (the next step's mod_compute_ratio reads
  the new capacity, the parameters untouched, the intervention recorded),
  mod_statistics, and the orchestrator's phase-scheduled mod_capacity
  decisions, equal to JAX's on the same stream and applied through
  `_execute` on the port's Trainer.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import linen as nn

from luminaai_tpu.config import Config as JConfig
from luminaai_tpu.data.tokenizer import ConversationTokenizer as JTok
from luminaai_tpu.inference.generate import GenerationEngine as JEngine
from luminaai_tpu.models import layers as jlayers
from luminaai_tpu.models import mod as jmod
from luminaai_tpu.models.transformer import LuminaTransformer as JModel
from luminaai_tpu.parallel.train_step import make_loss_fn as jmake_loss
from luminaai_tpu.training import optimizer as jopt
from luminaai_tpu.training import orchestrator as jorch
from luminaai_tpu_torch import cli
from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.convert import flatten_tree, params_from_flax
from luminaai_tpu_torch.data.tokenizer import ConversationTokenizer as TTok
from luminaai_tpu_torch.inference import generate as tgen
from luminaai_tpu_torch.models import mod as tmod
from luminaai_tpu_torch.models.layers import SwiGLU
from luminaai_tpu_torch.models.transformer import LuminaTransformer
from luminaai_tpu_torch.monitoring.telemetry import MetricsRegistry
from luminaai_tpu_torch.ops.fused import global_norm
from luminaai_tpu_torch.parallel import train_step as ts
from luminaai_tpu_torch.training import optimizer as topt
from luminaai_tpu_torch.training import orchestrator as torch_orch
from luminaai_tpu_torch.training.trainer import Trainer

ARCH = dict(vocab_size=384, hidden_size=64, num_layers=3, num_heads=4,
            num_kv_heads=2, seq_length=64, intermediate_size=128,
            precision="fp32", use_mod=True, mod_capacity_factor=0.5,
            routing_noise_std=0.0, gradient_checkpointing=False,
            use_flash_attention=False, batch_size=4, learning_rate=1e-3,
            warmup_ratio=0.25)
HYBRID = dict(use_moe=True, num_experts=4, moe_top_k=2,
              moe_pattern="every_3rd")
TOL = dict(atol=1e-5, rtol=1e-5)


def _unbox(tree):
    return jax.tree.map(
        lambda x: x.unbox() if isinstance(x, nn.meta.AxisMetadata) else x,
        tree, is_leaf=lambda x: isinstance(x, nn.meta.AxisMetadata))


class _JModLayer(nn.Module):
    cfg: JConfig

    @nn.compact
    def __call__(self, x):
        cfg = self.cfg
        ffn = jlayers.SwiGLU(cfg.intermediate_size, dtype=jnp.float32,
                             init_std=cfg.init_std, name="ffn")
        router = jmod.MoDRouter(cfg.mod_capacity_factor,
                                cfg.mod_routing_temperature,
                                dtype=jnp.float32, name="mod_router")
        idx, _, _ = router(x)
        out, metrics = jmod.apply_mod(router, ffn, x)
        return out, metrics, idx


@pytest.mark.parametrize("cf,temp", [(0.5, 1.0), (0.3, 0.7)])
def test_mod_layer_matches_jax(cf, temp):
    kw = dict(ARCH, mod_capacity_factor=cf, mod_routing_temperature=temp)
    jcfg = JConfig(**kw)
    rng = np.random.RandomState(0)
    x = rng.randn(3, 50, 64).astype(np.float32)
    ct = rng.randn(3, 50, 64).astype(np.float32)
    layer = _JModLayer(jcfg)
    params = _unbox(layer.init(jax.random.key(0), jnp.asarray(x)))
    # A non-zero bias exercises its gradient and the sigmoid's offset.
    params["params"]["mod_router"]["bias"] = jnp.asarray([0.3], jnp.float32)

    def loss(p, xx):
        out, m, idx = layer.apply(p, xx)
        return jnp.sum(out * ct) + m["mod_aux_loss"], (out, m, idx)

    (_, (jout, jm, jidx)), (jgp, jgx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    cfg = Config(**kw)
    flat = flatten_tree(jax.device_get(params["params"]))
    ffn = SwiGLU(64, 128, dtype=torch.float32, device="cpu", trainable=True)
    router = tmod.MoDRouter(cfg, dtype=torch.float32, device="cpu",
                            trainable=True)
    with torch.no_grad():
        ffn.wi.copy_(torch.as_tensor(flat["ffn/wi"]))
        ffn.wo.copy_(torch.as_tensor(flat["ffn/wo"]))
        router.router.copy_(torch.as_tensor(flat["mod_router/router"]))
        router.bias.copy_(torch.as_tensor(flat["mod_router/bias"]))
    xt = torch.as_tensor(x).requires_grad_(True)
    idx, _, _ = router(xt)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx.shape[1] == max(1, int(50 * cf))
    out, m = tmod.apply_mod(router, ffn, xt)
    total = (out * torch.as_tensor(ct)).sum() + m["mod_aux_loss"]
    grads = torch.autograd.grad(
        total, [xt, router.router, router.bias, ffn.wi, ffn.wo])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(m["mod_aux_loss"]),
                               float(jm["mod_aux_loss"]), **TOL)
    assert float(m["mod_compute_ratio"]) == float(jm["mod_compute_ratio"])
    jg = jax.device_get(jgp["params"])
    want = [np.asarray(jgx), jg["mod_router"]["router"],
            jg["mod_router"]["bias"], jg["ffn"]["wi"], jg["ffn"]["wo"]]
    for name, g, w in zip(("x", "router", "bias", "wi", "wo"), grads, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)
    # The router learns only through the straight-through gate and the
    # BCE: its gradient is non-zero.
    assert float(grads[1].abs().max()) > 0


def _batch(seed, n=4):
    rng = np.random.RandomState(seed)
    shape = (n, ARCH["seq_length"])
    return {"input_ids": rng.randint(1, 384, shape).astype(np.int32),
            "loss_mask": (rng.rand(*shape) > 0.1).astype(np.float32)}


@pytest.mark.parametrize("kind", ["mod", "hybrid"])
def test_model_step_matches_jax(kind):
    kw = dict(ARCH, **(HYBRID if kind == "hybrid" else {}))
    jcfg = JConfig(**kw)
    jmodel = JModel(jcfg)
    params = jax.device_get(_unbox(jmodel.init(
        jax.random.key(1), jnp.ones((1, 8), jnp.int32))["params"]))
    b = _batch(5)
    loss_fn = jmake_loss(jcfg, jmodel)
    (j_loss, j_metrics), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, {k: jnp.asarray(v)
                                         for k, v in b.items()},
                                jax.random.key(0))
    jtx = jopt.make_optimizer(jcfg, 4)
    upd, _ = jax.jit(jtx.update)(j_grads, jtx.init(params), params)
    j_new = params_from_flax(jax.device_get(optax.apply_updates(params,
                                                                upd)),
                             Config(**kw))

    cfg = Config(**kw)
    model = LuminaTransformer(cfg, device="cpu", trainable=True)
    model.load_params(params_from_flax(params, cfg))
    names = [n for n, _ in model.named_parameters()]
    assert any(".mod_router." in n for n in names)
    if kind == "hybrid":
        assert hasattr(model.layers[2], "moe")
        assert all(hasattr(model.layers[i], "mod_router") for i in (0, 1))
    tb = {"input_ids": torch.as_tensor(b["input_ids"]).long(),
          "loss_mask": torch.as_tensor(b["loss_mask"])}
    loss, metrics = ts.make_loss_fn(cfg, model)(tb)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["mod_aux_loss"]),
                               float(j_metrics["mod_aux_loss"]), rtol=1e-5)
    assert float(metrics["mod_compute_ratio"]) == 0.5
    want = params_from_flax(jax.device_get(j_grads), cfg)
    np.testing.assert_allclose(float(global_norm(list(grads))),
                               float(global_norm(list(want.values()))),
                               rtol=1e-4)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=1e-6,
                                   rtol=1e-4, err_msg=n)

    sched = topt.make_schedule(cfg, 4)
    tx = topt.make_optimizer(cfg, 4, sched)
    state = ts.init_train_state(model, tx, seed=0)
    tx.apply(state.params, list(grads), state.opt_state)
    lr = sched(0)
    for n, p in zip(names, state.params):
        diff = np.abs(p.detach().numpy() - j_new[n].numpy())
        assert diff.max() <= 2 * lr + 1e-6, (n, diff.max())
        assert np.mean(diff <= 1e-6) >= 0.999, n


def test_mod_greedy_decode_matches_jax():
    kw = dict(ARCH, gradient_checkpointing=False, seq_length=256,
              max_new_tokens=12, prefill_chunk_size=32)
    jcfg = JConfig(**kw, scan_layers=False, attention_backend="ragged_xla")
    jmodel = JModel(jcfg)
    params = _unbox(jax.jit(jmodel.init)(
        jax.random.key(2), jnp.ones((1, 8), jnp.int32))["params"])
    tcfg = Config(**kw)
    tmodel = LuminaTransformer(tcfg, device="cpu").load_params(
        params_from_flax(jax.device_get(params), tcfg))
    decs = [JEngine(jmodel, params, JTok(), jcfg).make_stepwise(
                num_slots=2, page_size=16, max_slot_tokens=128),
            tgen.GenerationEngine(tmodel, TTok(), tcfg).make_stepwise(
                num_slots=2, page_size=16, max_slot_tokens=128)]
    rng = np.random.RandomState(4)
    prompts = [list(rng.randint(0, 256, size=n)) for n in (9, 23)]
    out = []
    for dec in decs:
        toks = {}
        for p in prompts:
            slot = dec.acquire_slot()
            toks[slot] = [dec.prefill_into_slot(slot, p,
                                                max_new_tokens=12)["token"]]
        while any(len(t) < 12 for t in toks.values()):
            t, produced, _ = dec.decode_step()
            for s in toks:
                if produced[s] and len(toks[s]) < 12:
                    toks[s].append(int(t[s]))
        out.append([toks[s] for s in sorted(toks)])
    assert out[0] == out[1]


TRAIN = dict(vocab_size=384, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, seq_length=32, intermediate_size=128,
             precision="fp32", use_mod=True, gradient_checkpointing=False,
             use_flash_attention=False, batch_size=2, max_steps=6,
             eval_every_n_batches=10**6, save_every_n_batches=10**6,
             health_check_interval=10**6, watchdog=False, auto_resume=False)


def test_adjust_mod_capacity_and_orchestrator(tmp_path):
    cfg = Config(**TRAIN, output_dir=str(tmp_path),
                 enable_mod_capacity_adaptation=True)
    trainer = Trainer(cfg, cli._synthetic_batches(cfg), device="cpu", seed=0,
                      registry=MetricsRegistry())
    o = torch_orch.AdaptiveTrainingOrchestrator(trainer)
    batch = trainer._to_device(next(iter(cli._synthetic_batches(cfg)())))
    trainer.state, m = trainer.train_step(trainer.state, batch)
    assert float(m["mod_compute_ratio"]) == 0.5
    before = [p.detach().clone() for p in trainer.state.params]
    decision = torch_orch.AdaptiveDecision(
        kind="mod_capacity", params={"new_value": 0.3}, reason="test",
        confidence=0.8, step=1)
    o._execute(decision)
    assert decision.applied and cfg.mod_capacity_factor == 0.3
    assert all(torch.equal(a, b) for a, b in
               zip(before, trainer.state.params))
    assert trainer._interventions[-1]["kind"] == "mod_capacity"
    trainer.state, m = trainer.train_step(trainer.state, batch)
    assert float(m["mod_compute_ratio"]) == int(32 * 0.3) / 32
    trainer.monitor.collector.add_metrics(
        {"mod_compute_ratio": float(m["mod_compute_ratio"])}, 2)
    stats = trainer.mod_statistics()
    assert stats["configured_capacity"] == 0.3
    assert stats["observed_compute_ratio"] == int(32 * 0.3) / 32
    with pytest.raises(ValueError):
        trainer.adjust_mod_capacity(1.5)
    trainer.close()


class _Stub:
    def __init__(self, config):
        self.config = config
        self.total_steps = config.max_steps
        self.global_step = 0
        self._lr_override = None
        self.calls = []
        self.step_callback = None

    def schedule(self, step):
        return self.config.learning_rate

    def adjust_mod_capacity(self, value, reason=""):
        self.calls.append(["adjust_mod_capacity", value, reason])
        self.config.mod_capacity_factor = float(value)


def test_mod_capacity_decisions_equal_jax(tmp_path):
    runs = []
    for mod, cls in ((torch_orch, Config), (jorch, JConfig)):
        cfg = cls(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
                  num_kv_heads=2, seq_length=64, batch_size=8, use_mod=True,
                  max_steps=300, health_check_interval=5,
                  intervention_cooldown_steps=10, enable_adaptive_lr=False,
                  enable_adaptive_wd=False,
                  enable_mod_capacity_adaptation=True,
                  output_dir=str(tmp_path / mod.__name__))
        stub = _Stub(cfg)
        o = mod.AdaptiveTrainingOrchestrator(stub)
        for step in range(5, 300, 5):
            stub.global_step = step
            o.on_metrics(step, {"loss": 2.0 - 0.001 * step,
                                "grad_norm": 1.0})
        runs.append(([d.to_dict() for d in o.decisions], stub.calls))
    assert json.dumps(runs[0], sort_keys=True, default=repr) == json.dumps(
        runs[1], sort_keys=True, default=repr)
    values = [c[1] for c in runs[0][1]]
    assert values == [0.7, 0.5, 0.3], runs[0]


def test_cli_runs_every_lever(tmp_path, capsys):
    """`train --config` with every lever of this slice at once (a hybrid
    MoE+MoD model, gather dispatch, save_attn, bf16 Adam mu, an untied
    head, dropout), then `evaluate`, `finetune` and the
    serving engine from its checkpoint, all on the CPU; `presets` lists
    debug_200m."""
    from luminaai_tpu_torch.inference.chat import load_model_for_inference

    cfg = Config(**{**TRAIN, **HYBRID, "num_layers": 3, "seq_length": 128,
                    "gradient_checkpointing": True,
                    "use_flash_attention": True},
                 moe_dispatch="gather", remat_policy="save_attn",
                 adam_mu_dtype="bf16", tie_word_embeddings=False,
                 dropout=0.1, flash_block_q=128,
                 flash_block_kv=128)
    path = str(tmp_path / "levers.json")
    cfg.save(path)
    run = tmp_path / "run"
    assert cli.main(["train", "--config", path, "--synthetic", "--steps",
                     "2", "--device", "cpu", "--output-dir", str(run)]) == 0
    data = str(tmp_path / "a.jsonl")
    assert cli.main(["data", "sample", "--out", data, "--count", "8"]) == 0
    capsys.readouterr()
    assert cli.main(["evaluate", "--checkpoint", str(run / "checkpoints"),
                     "--data", data, "--device", "cpu"]) == 0
    result = json.loads(capsys.readouterr().out)
    assert np.isfinite(result["eval_loss"]) and result["tokens"] > 0
    assert cli.main(["finetune", "--checkpoint", str(run / "checkpoints"),
                     "--data", data, "--out", str(tmp_path / "ft"),
                     "--steps", "1", "--batch-size", "2",
                     "--device", "cpu"]) == 0
    model, loaded = load_model_for_inference(str(run / "checkpoints"),
                                             device="cpu")
    assert loaded.use_mod and not loaded.tie_word_embeddings
    assert hasattr(model.embedder, "lm_head")
    engine = tgen.GenerationEngine(model, TTok(), loaded)
    dec = engine.make_stepwise(num_slots=1, page_size=16,
                               max_slot_tokens=64)
    slot = dec.acquire_slot()
    dec.prefill_into_slot(slot, list(range(5, 25)), max_new_tokens=4)
    toks, _, _ = dec.decode_step()
    assert 0 <= int(toks[slot]) < loaded.vocab_size
    assert cli.main(["presets"]) == 0
    assert "debug_200m" in capsys.readouterr().out
