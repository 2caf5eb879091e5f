"""`convert` and the int8 serving checkpoint, against the JAX CLI's.

- `convert --to int8` writes JAX's export: the bf16 weights (as the
  loader serves them) quantized for serving, codes and scales bitwise
  JAX's `quantize_for_serving` + `export_quantized_tree`, the same
  manifest and info in the metadata, quantization_method cleared.
- `serve --checkpoint` and `chat` load the export with no
  re-quantization (QuantizedTensor weights, equal logits to the
  in-memory quantized model); `--quantize int8` over it passes through.
- `finetune`, `evaluate` and `convert` refuse it with the JAX loader's
  message (exit 1).
- `convert --to scan` writes JAX's stacked layout (stack_params_for_scan)
  bitwise, `--to plain` restores the per-layer tree; converting to the
  layout a checkpoint already has, and int8 from a scanned one, exit 1.
- The flags are the JAX parser's, plus --device.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta as flax_meta

from luminaai_tpu import cli as jcli
from luminaai_tpu.config import Config as JConfig
from luminaai_tpu.models.transformer import (
    LuminaTransformer as JModel,
    stack_params_for_scan,
)
from luminaai_tpu.training import quantization as jquant
from luminaai_tpu_torch import cli
from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.convert import flatten_tree, model_tree
from luminaai_tpu_torch.inference.chat import (
    load_checkpoint_flax,
    load_model_for_inference,
)
from luminaai_tpu_torch.inference.generate import GenerationEngine
from luminaai_tpu_torch.ops.quantized import QuantizedTensor
from luminaai_tpu_torch.training.checkpoint import save_params_checkpoint

ARCH = dict(vocab_size=384, hidden_size=64, num_layers=3, num_heads=4,
            num_kv_heads=2, seq_length=128, intermediate_size=128,
            precision="fp32", batch_size=4, use_moe=True, num_experts=4,
            moe_top_k=2, moe_pattern="every_3rd", routing_noise_std=0.0)
CPU = ["--device", "cpu"]


def _np(x):
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == jnp.bfloat16 else x


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A params-only checkpoint of a flax init (one MoE layer of three),
    the JAX params and their bf16 cast (what both loaders serve)."""
    d = tmp_path_factory.mktemp("convert")
    jcfg = JConfig(**ARCH, use_flash_attention=False,
                   gradient_checkpointing=False)
    params = flax_meta.unbox(jax.jit(JModel(jcfg).init)(
        jax.random.key(0), jnp.ones((1, 8), jnp.int32))["params"])
    flat = flatten_tree(jax.device_get(params))
    save_params_checkpoint(d / "ckpt", 0,
                           {k: torch.tensor(v) for k, v in flat.items()},
                           {"config": Config(**ARCH).to_dict()})
    bf16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
    out = d / "int8"
    assert cli.main(["convert", "--checkpoint", str(d / "ckpt"), "--to",
                     "int8", "--out", str(out), *CPU]) == 0
    return dict(dir=d, src=d / "ckpt", int8=out, jcfg=jcfg, bf16=bf16)


def _subparser(parser, name):
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            return action.choices[name]
    raise KeyError(name)


def test_convert_takes_the_jax_flags():
    def flags(parser):
        return {(s, a.dest, tuple(a.choices or ()), a.required)
                for a in _subparser(parser, "convert")._actions
                for s in a.option_strings}

    got, want = flags(cli._parser()), flags(jcli.build_parser())
    assert want <= got
    assert {f[0] for f in got - want} == {"--device"}


def test_int8_export_equals_jax_export(ckpt, capsys):
    jq, jinfo = jquant.quantize_for_serving(ckpt["bf16"])
    jplain, jmanifest = jquant.export_quantized_tree(jq)
    want = flatten_tree(jax.device_get(jplain))
    from luminaai_tpu_torch.training.checkpoint import (
        find_checkpoint_step,
        load_state_file,
    )

    step_dir, meta = find_checkpoint_step(str(ckpt["int8"]))
    got = load_state_file(step_dir)["params"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        g = got[k]
        if g.dtype == torch.bfloat16:
            g = g.view(torch.int16).numpy().view(np.uint16)
        else:
            g = g.numpy()
        assert g.dtype == _np(v).dtype, k
        np.testing.assert_array_equal(g, _np(v), err_msg=k)
    assert meta["quantization"]["manifest"] == jmanifest
    assert meta["quantization"]["info"] == pytest.approx(jinfo)
    assert meta["config"]["quantization_method"] is None
    assert meta["converted_from"] == str(ckpt["src"])
    assert cli.main(["verify-checkpoint", str(ckpt["int8"])]) == 0


def test_serve_and_chat_load_the_export_as_saved(ckpt, monkeypatch,
                                                 capsys):
    from luminaai_tpu_torch.serving import server

    served = []
    monkeypatch.setattr(server.ChatServer, "serve_forever",
                        lambda self, host, port: served.append(self))
    assert cli.main(["serve", "--checkpoint", str(ckpt["int8"]), "--port",
                     "0", *CPU]) == 0
    engine = served[-1].engine
    # min_size 4096 at these widths quantizes wq (4096) but not wk, wv
    # (2048): each layer's fused projection holds its blocks apart.
    n_quantized = sum(
        isinstance(v, QuantizedTensor) if not isinstance(v, tuple)
        else sum(isinstance(p, QuantizedTensor) for p in v)
        for v in model_tree(engine.model).values())
    _, _, meta = load_checkpoint_flax(str(ckpt["int8"]),
                                      allow_quantized=True)
    # Per layer wq, wo and the FFN's wi, wo (dense or experts), and the
    # embedding.
    assert n_quantized == len(meta["quantization"]["manifest"]) == 3 * 4 + 1
    assert engine.quantization_info == {}  # nothing re-quantized
    # In memory: the source checkpoint as the loader serves it (bf16),
    # quantized by an engine: the same model, the same logits.
    model, cfg = load_model_for_inference(str(ckpt["src"]), device="cpu")
    cfg.quantization_method = "int8"
    mem = GenerationEngine(model, engine.tokenizer, cfg)
    assert mem.quantization_info["mode"] == "int8_compute"
    ids = torch.tensor([[3, 17, 5, 9, 1, 44]])
    with torch.inference_mode():
        want, _ = mem.model(ids)
        got, _ = engine.model(ids)
    assert torch.equal(got, want)
    # --quantize int8 over an int8 export passes the leaves through;
    # --kv-cache-dtype reaches the engine and /stats.
    assert cli.main(["serve", "--checkpoint", str(ckpt["int8"]), "--port",
                     "0", "--quantize", "int8", "--kv-cache-dtype", "int8",
                     *CPU]) == 0
    srv = served[-1]
    info = srv.engine.quantization_info
    assert info["quantized_leaves"] == len(meta["quantization"]["manifest"])
    status, stats = srv.handle("GET", "/stats", {}, {})[:2]
    assert stats["kv_cache_dtype"] == "int8"
    assert stats["quantization"]["mode"] == "int8_compute"
    capsys.readouterr()
    assert cli.main(["chat", "--checkpoint", str(ckpt["int8"]), "--prompt",
                     "hello", "--max-new-tokens", "4", "--temperature", "0",
                     *CPU]) == 0


@pytest.mark.parametrize("command", ["finetune", "evaluate", "convert"])
def test_full_precision_commands_refuse_the_export(ckpt, command, capsys,
                                                   tmp_path):
    argv = {
        "finetune": ["finetune", "--checkpoint", str(ckpt["int8"]),
                     "--data", "x.jsonl", "--out", str(tmp_path / "ft")],
        "evaluate": ["evaluate", "--checkpoint", str(ckpt["int8"]),
                     "--data", "x.jsonl"],
        "convert": ["convert", "--checkpoint", str(ckpt["int8"]), "--to",
                    "int8", "--out", str(tmp_path / "again")],
    }[command]
    assert cli.main([*argv, *CPU]) == 1
    err = capsys.readouterr().err
    assert "is an int8 SERVING checkpoint (convert --to int8)" in err
    assert "use the source checkpoint instead" in err


def test_scan_and_plain_round_trip_like_jax(ckpt, capsys):
    scan, plain = ckpt["dir"] / "scan", ckpt["dir"] / "plain"
    assert cli.main(["convert", "--checkpoint", str(ckpt["src"]), "--to",
                     "scan", "--out", str(scan), *CPU]) == 0
    assert "converted to scan layout" in capsys.readouterr().out
    flat, cfg, _ = load_checkpoint_flax(str(scan))
    assert cfg.scan_layers
    jcfg = JConfig(**ARCH, use_flash_attention=False,
                   gradient_checkpointing=False, scan_layers=True)
    want = flatten_tree(jax.device_get(
        stack_params_for_scan(jcfg, ckpt["bf16"])))
    assert sorted(flat) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(
            flat[k].view(torch.int16).numpy().view(np.uint16), _np(v),
            err_msg=k)
    assert cli.main(["convert", "--checkpoint", str(scan), "--to", "plain",
                     "--out", str(plain), *CPU]) == 0
    back, cfg2, _ = load_checkpoint_flax(str(plain))
    src, _, _ = load_checkpoint_flax(str(ckpt["src"]))
    assert not cfg2.scan_layers and sorted(back) == sorted(src)
    assert all(torch.equal(back[k], src[k].to(torch.bfloat16)) for k in src)
    # Refusals: the layout it already has; int8 from a scanned tree.
    for source, to, msg in ((scan, "scan", "already in scanned"),
                            (plain, "plain", "already in per-layer"),
                            (scan, "int8", "convert --to plain first")):
        assert cli.main(["convert", "--checkpoint", str(source), "--to", to,
                         "--out", str(ckpt["dir"] / "x"), *CPU]) == 1
        assert msg in capsys.readouterr().err


def test_convert_defaults_to_the_card(ckpt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["convert", "--checkpoint", str(ckpt["src"]), "--to",
                  "int8", "--out", str(ckpt["dir"] / "never")])
    assert not (ckpt["dir"] / "never").exists()
