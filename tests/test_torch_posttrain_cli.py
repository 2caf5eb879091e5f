"""The port's post-training CLI (`data`, `finetune`, `evaluate`, `chat`,
`verify-checkpoint`, `presets`) on the CPU, against the JAX CLI where it
has a counterpart.

- The subcommands take the JAX CLI's flags (plus --device).
- `data sample`, `validate`, `blend` write the same files and print the
  same report as the JAX CLI.
- `evaluate` prints JSON within 1e-5 relative of the JAX `cmd_evaluate`
  body on the same weights and data, `tokens` and `batches` exact.
- `finetune --merge-out` on a params-only checkpoint (dense, and MoE with
  --adapt-experts), then `verify-checkpoint`, `evaluate` (equal to an
  in-memory merge), `chat --prompt` and `serve --checkpoint` on the
  merged checkpoint.
- `verify-checkpoint` exits 0 intact, 1 corrupt, 2 missing; `chat`
  takes the quantizer's flags; `data acquire` without --in exits 1 where
  the download is unavailable.
"""

import argparse
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from luminaai_tpu import cli as jcli
from luminaai_tpu.config import Config as JConfig
from luminaai_tpu.models.transformer import LuminaTransformer as JModel
from luminaai_tpu_torch import cli
from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.convert import flatten_tree, flax_to_state_dict
from luminaai_tpu_torch.inference.chat import load_checkpoint_flax
from luminaai_tpu_torch.models.transformer import LuminaTransformer
from luminaai_tpu_torch.training import adapters
from luminaai_tpu_torch.training.checkpoint import (
    MANIFEST_NAME,
    STATE_NAME,
    save_params_checkpoint,
)

ARCH = dict(vocab_size=384, hidden_size=64, num_layers=2, num_heads=2,
            num_kv_heads=1, seq_length=128, intermediate_size=128,
            precision="fp32", batch_size=4, routing_noise_std=0.0)
CPU = ["--device", "cpu"]


def _unbox(params):
    from flax import linen as nn

    return jax.tree.map(
        lambda x: x.unbox() if isinstance(x, nn.meta.AxisMetadata) else x,
        params, is_leaf=lambda x: isinstance(x, nn.meta.AxisMetadata),
    )


def _subparser(parser, name):
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            return action.choices[name]
    raise KeyError(name)


@pytest.mark.parametrize("command", ["data", "finetune", "evaluate", "chat",
                                     "verify-checkpoint", "presets"])
def test_subcommand_takes_the_jax_flags(command):
    def flags(parser):
        return {s for a in _subparser(parser, command)._actions
                for s in a.option_strings} | {
            a.dest for a in _subparser(parser, command)._actions
            if not a.option_strings}

    want = flags(jcli.build_parser())
    got = flags(cli._parser())
    assert want <= got, want - got
    assert got - want <= {"--device"}


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.fixture(scope="module")
def convs(tmp_path_factory):
    """Two conversation shards (the JAX CLI's sample data) and their
    blend, written by the JAX CLI."""
    d = tmp_path_factory.mktemp("convs")
    jcli.main(["data", "sample", "--out", str(d / "a" / "a.jsonl"),
               "--count", "40"])
    jcli.main(["data", "sample", "--out", str(d / "b" / "b.jsonl"),
               "--count", "24"])
    jcli.main(["data", "blend", "--sources", f"a=0.7={d}/a/*.jsonl",
               f"b=0.3={d}/b/*.jsonl", "--out", str(d / "blend.jsonl")])
    return d


@pytest.mark.parametrize("action", ["sample", "validate", "blend"])
def test_data_actions_equal_jax_cli(action, convs, tmp_path, capsys):
    outs = {}
    for tag, main in (("j", jcli.main), ("t", cli.main)):
        out = tmp_path / f"{tag}.jsonl"
        argv = {
            "sample": ["data", "sample", "--out", str(out), "--count", "17"],
            "validate": ["data", "validate", "--in",
                         str(convs / "blend.jsonl")],
            "blend": ["data", "blend", "--sources",
                      f"a=0.7={convs}/a/*.jsonl",
                      f"b=0.3={convs}/b/*.jsonl", "--out", str(out)],
        }[action]
        rc, printed = _run(main, argv, capsys)
        assert rc == 0
        outs[tag] = (printed.replace(str(out), "OUT"),
                     out.read_text() if out.exists() else None)
    assert outs["t"] == outs["j"]
    if action == "blend":
        assert outs["t"][1].count("\n") == 64


def test_data_blend_and_acquire_refusals(tmp_path, capsys, monkeypatch):
    assert cli.main(["data", "blend"]) == 2
    assert cli.main(["data", "blend", "--sources", "a=1=nothing*"]) == 2
    assert cli.main(["data", "blend", "--sources", "bad"]) == 2
    # `acquire` without --in tries the `datasets` download, and exits 1,
    # as the JAX CLI does, where that is missing (the network probe and
    # the package blocked here: the test contacts no host).
    from luminaai_tpu_torch.data import acquisition

    monkeypatch.setattr(acquisition, "network_available",
                        lambda timeout=2.0: False)
    monkeypatch.setitem(sys.modules, "datasets", None)
    assert cli.main(["data", "acquire", "--out", str(tmp_path)]) == 1
    assert "pass --in DUMP.jsonl" in capsys.readouterr().err


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """A params-only checkpoint of a flax init (dense), and the JAX side."""
    d = tmp_path_factory.mktemp("base")
    jcfg = JConfig(**ARCH, use_moe=False, use_flash_attention=False,
                   gradient_checkpointing=False)
    jmodel = JModel(jcfg)
    params = _unbox(jax.jit(jmodel.init)(
        jax.random.key(0), jnp.ones((1, 8), jnp.int32))["params"])
    flat = flatten_tree(jax.device_get(params))
    cfg = Config(**ARCH, use_moe=False)
    save_params_checkpoint(d / "ckpt", 0,
                           {k: torch.tensor(v) for k, v in flat.items()},
                           {"config": cfg.to_dict()})
    return dict(dir=d / "ckpt", jcfg=jcfg, jmodel=jmodel, params=params)


def _jax_evaluate(jcfg, jmodel, params, data, max_batches):
    """The body of the JAX CLI's cmd_evaluate on in-memory params (its
    loader casts them to bf16)."""
    from luminaai_tpu.data.dataset import (
        ConversationDataset,
        conversation_batches,
    )
    from luminaai_tpu.data.tokenizer import ConversationTokenizer
    from luminaai_tpu.ops.fused import fused_lm_head_cross_entropy
    from luminaai_tpu.parallel.train_step import (
        _shifted_mask_weights,
        shift_labels,
    )

    params = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
    ds = ConversationDataset(data, ConversationTokenizer(
        assistant_loss_weight=jcfg.assistant_loss_weight), jcfg,
        split="eval")

    @jax.jit
    def eval_batch(params, batch):
        hidden, _ = jmodel.apply({"params": params}, batch["input_ids"],
                                 deterministic=True, return_hidden=True)
        labels, valid = shift_labels(batch)
        mask, weights = _shifted_mask_weights(batch, valid)
        _, metrics = fused_lm_head_cross_entropy(
            hidden, params["embedder"]["embedding"], labels,
            loss_mask=mask, loss_weights=weights)
        return metrics

    nll = tokens = 0.0
    n = 0
    for batch in conversation_batches(ds, jcfg.batch_size, seed=0,
                                      drop_last=False):
        if max_batches and n >= max_batches:
            break
        m = eval_batch(params, {k: jnp.asarray(v) for k, v in batch.items()})
        nll += float(m["ce_loss"]) * float(m["tokens_in_loss"])
        tokens += float(m["tokens_in_loss"])
        n += 1
    return nll / tokens, int(tokens), n


@pytest.mark.parametrize("max_batches", [0, 3])
def test_evaluate_json_equals_jax(base, convs, capsys, max_batches):
    data = str(convs / "blend.jsonl")
    rc, out = _run(cli.main, ["evaluate", "--checkpoint", str(base["dir"]),
                              "--data", data, "--max-batches",
                              str(max_batches), *CPU], capsys)
    assert rc == 0
    got = json.loads(out)
    loss, tokens, batches = _jax_evaluate(
        base["jcfg"], base["jmodel"], base["params"], data, max_batches)
    assert (got["tokens"], got["batches"]) == (tokens, batches)
    assert batches == (max_batches or 16)
    assert got["eval_loss"] == pytest.approx(round(loss, 4), rel=1e-5)
    assert got["perplexity"] == pytest.approx(
        round(float(np.exp(min(loss, 20.0))), 2), rel=1e-5)


def test_finetune_merge_then_evaluate_chat_serve(base, convs, tmp_path,
                                                capsys, monkeypatch):
    data = str(convs / "blend.jsonl")
    ft, merged = tmp_path / "ft", tmp_path / "merged"
    before = (base["dir"] / "0" / STATE_NAME).read_bytes()
    rc, out = _run(cli.main, [
        "finetune", "--checkpoint", str(base["dir"]), "--data", data,
        "--out", str(ft), "--rank", "4", "--steps", "3", "--batch-size",
        "4", "--lr", "1e-2", "--merge-out", str(merged), *CPU], capsys)
    assert rc == 0, out
    assert "step 3/3 loss" in out and f"merged checkpoint: {merged}" in out
    assert (base["dir"] / "0" / STATE_NAME).read_bytes() == before
    lora, spec = adapters.load_lora(str(ft / "adapter.npz"))
    assert spec.rank == 4 and any(
        float(ab["b"].abs().max()) > 0 for ab in lora.values())

    assert cli.main(["verify-checkpoint", str(merged)]) == 0
    flat, cfg, meta = load_checkpoint_flax(str(merged))
    assert meta["step"] == 0 and meta["adapter"] == str(ft / "adapter")
    assert cfg.hidden_size == ARCH["hidden_size"]
    capsys.readouterr()

    # evaluate(merged) == the in-memory merge (fp32), cast at load.
    rc, out = _run(cli.main, ["evaluate", "--checkpoint", str(merged),
                              "--data", data, *CPU], capsys)
    assert rc == 0
    base_flat, _, _ = load_checkpoint_flax(str(base["dir"]))
    mem = adapters.merge_lora(base_flat, lora, spec)
    model = LuminaTransformer(cfg, device="cpu").load_params(
        flax_to_state_dict(
            {k: v.to(torch.bfloat16) for k, v in mem.items()}, cfg))
    want = cli.evaluate_model(model, cfg, data)
    got = json.loads(out)
    assert (got["tokens"], got["batches"]) == (want["tokens"],
                                               want["batches"])
    assert got["eval_loss"] == pytest.approx(want["eval_loss"], rel=1e-5)

    rc, out = _run(cli.main, ["chat", "--checkpoint", str(merged),
                              "--prompt", "hello", "--max-new-tokens", "6",
                              "--temperature", "0", *CPU], capsys)
    assert rc == 0 and out.endswith("\n")
    rc, out = _run(cli.main, [
        "chat", "--checkpoint", str(base["dir"]), "--adapter",
        str(ft / "adapter.npz"), "--secure", "--user", "operator",
        "--password", "correct-horse1", "--prompt", "hello",
        "--max-new-tokens", "4", *CPU], capsys)
    assert rc == 0

    from luminaai_tpu_torch.serving import server

    served = []
    monkeypatch.setattr(server.ChatServer, "serve_forever",
                        lambda self, host, port: served.append(self.engine))
    assert cli.main(["serve", "--checkpoint", str(merged), "--port", "0",
                     *CPU]) == 0
    tokens, stats = served[0].generate([5, 6, 7], max_new_tokens=4,
                                       temperature=0.0)
    assert stats["tokens_generated"] == len(tokens) > 0


def test_finetune_adapts_experts(tmp_path, convs, capsys):
    cfg = Config(**{**ARCH, "num_layers": 1}, use_moe=True, num_experts=4,
                 moe_top_k=2, moe_dispatch="gmm")
    model = LuminaTransformer(cfg, device="cpu")
    from luminaai_tpu_torch.convert import init_params, state_dict_to_flax

    init_params(model, 0)
    save_params_checkpoint(tmp_path / "ckpt", 0,
                           state_dict_to_flax(model.state_dict(), cfg),
                           {"config": cfg.to_dict()})
    rc, out = _run(cli.main, [
        "finetune", "--checkpoint", str(tmp_path / "ckpt"), "--data",
        str(convs / "blend.jsonl"), "--out", str(tmp_path / "ft"),
        "--steps", "2", "--adapt-experts", *CPU], capsys)
    assert rc == 0, out
    lora, _ = adapters.load_lora(str(tmp_path / "ft" / "adapter"))
    assert lora["layer_0/moe/wi"]["a"].shape == (4, 64, 8)
    assert "layer_0/moe/router" not in lora


def test_verify_checkpoint_exit_codes(base, tmp_path, capsys):
    import shutil

    ckpt = tmp_path / "ckpt"
    shutil.copytree(base["dir"], ckpt)
    rc, out = _run(cli.main, ["verify-checkpoint", str(ckpt)], capsys)
    assert rc == 0 and "1 ok, 0 corrupt, 0 unmanifested" in out
    rc, out = _run(cli.main, ["verify-checkpoint", str(ckpt), "--json",
                              "--mode", "sample"], capsys)
    assert rc == 0 and json.loads(out)["ok"] == [0]
    assert cli.main(["verify-checkpoint", str(tmp_path / "none")]) == 2
    assert cli.main(["verify-checkpoint", str(ckpt), "--step", "5"]) == 2
    state = ckpt / "0" / STATE_NAME
    raw = bytearray(state.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    state.write_bytes(bytes(raw))
    rc, out = _run(cli.main, ["verify-checkpoint", str(ckpt)], capsys)
    assert rc == 1 and "sha256 mismatch" in out
    (ckpt / "0" / MANIFEST_NAME).unlink()
    assert cli.main(["verify-checkpoint", str(ckpt)]) == 0  # unmanifested
    (tmp_path / "empty").mkdir()
    assert cli.main(["verify-checkpoint", str(tmp_path / "empty")]) == 2


def test_presets_json(capsys):
    rc, out = _run(cli.main, ["presets", "--json"], capsys)
    info = json.loads(out)
    assert rc == 0 and list(info) == [
        "debug", "debug_200m", "debug_300m", "moe_stress_test", "b1", "b7",
        "b14", "b30", "b50", "b75", "b100", "b200", "b300"]  # JAX's 13
    assert info["b1"]["hidden_size"] == 2048 and info["b1"]["num_experts"] == 8
    assert info["debug_200m"]["use_mod"] and not info["debug_200m"]["use_moe"]


@pytest.mark.parametrize("flags,mode", [
    (["--quantize", "int8"], "int8 COMPUTE"),
    (["--quantize", "int4"], "int4 weight round-trip"),
    (["--kv-cache-dtype", "int8"], None),
])
def test_chat_serves_the_quantizer_flags(base, flags, mode, capsys):
    """`chat --quantize` / `--kv-cache-dtype` (refused before quantized
    serving was ported) answer, with the JAX CLI's quantization line."""
    rc = cli.main(["chat", "--checkpoint", str(base["dir"]), "--prompt",
                   "x", "--max-new-tokens", "4", *flags, *CPU])
    err = capsys.readouterr().err
    assert rc == 0
    assert (f"serving with {mode}" in err) if mode else (
        "serving with" not in err)
