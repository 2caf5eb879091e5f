"""Loading a model for inference, and the interactive chat REPL (the port's
counterpart of luminaai_tpu/inference/chat.py).

Weights come from a training checkpoint in the port's own format (a
checkpoints directory or the training output directory holding one; the
newest step whose sha256 manifest verifies, with its config from the
checkpoint's metadata; training/checkpoint.py), from a flax parameter
tree saved as an .npz of '/'-joined keys (convert.flatten_tree; load with
convert.params_from_flax), or from a seed (convert.init_params).

`load_model_for_inference` follows the JAX loader: the saved fp32
parameters are cast to bf16 (the serving precision; the JAX default
inference_precision 'auto') unless keep_master_dtype, and a LoRA adapter
merges AFTER that cast, so both packages round the merged weights alike.
An int8 serving export (`convert --to int8`: codes, scales and the
`quantization` manifest in its metadata) loads as QuantizedTensor
weights with no re-quantization where allow_quantized (chat, serve), and
is refused with the JAX loader's message elsewhere (finetune, evaluate,
convert). `quantize` / `kv_cache_dtype` set the config the engine
quantizes from (the JAX ChatInterface's).

ChatInterface is the JAX REPL: session stats, generation modes, the
/help /stats /mode /system /clear /save /config /quit commands, and a
checkpoint found under experiments/, checkpoints/ or . when none is
given. Each reply samples at the mode's temperature and top_p (the mode
wins over the config's, as in the JAX REPL).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.convert import (
    flax_to_state_dict,
    init_params,
    params_from_flax,
)
from luminaai_tpu_torch.data.tokenizer import ConversationTokenizer
from luminaai_tpu_torch.inference.generate import GenerationEngine
from luminaai_tpu_torch.models.transformer import LuminaTransformer

logger = logging.getLogger(__name__)

GENERATION_MODES = {
    # (temperature, top_p) presets
    "creative": (1.0, 0.95),
    "balanced": (0.8, 0.9),
    "precise": (0.3, 0.7),
    "deterministic": (0.0, 1.0),
}


@dataclasses.dataclass
class SessionStats:
    messages: int = 0
    total_tokens: int = 0
    total_seconds: float = 0.0
    started: float = dataclasses.field(default_factory=time.time)

    def tokens_per_second(self) -> float:
        return self.total_tokens / max(self.total_seconds, 1e-9)

    def avg_response_time(self) -> float:
        return self.total_seconds / max(self.messages, 1)


def find_latest_checkpoint(
    search_dirs: Optional[List[str]] = None,
) -> Optional[Path]:
    """The checkpoints directory under common output roots whose newest
    committed step (training/checkpoint.committed_steps) was written
    last; the loader verifies its manifest."""
    from luminaai_tpu_torch.training.checkpoint import (
        METADATA_NAME,
        committed_steps,
    )

    search_dirs = search_dirs or ["experiments", "checkpoints", "."]
    candidates: List[Tuple[float, str]] = []
    for root in search_dirs:
        rootp = Path(root)
        if not rootp.exists():
            continue
        for meta in rootp.rglob(METADATA_NAME):
            step_dir = meta.parent
            if (step_dir.name.isdigit()
                    and int(step_dir.name) in committed_steps(
                        step_dir.parent)):
                candidates.append((meta.stat().st_mtime,
                                   str(step_dir.parent)))
    if not candidates:
        return None
    return Path(max(candidates)[1])


def load_checkpoint_flax(
    checkpoint: str,
    config: Optional[Config] = None,
    overrides: Optional[Dict[str, Any]] = None,
    mode: str = "full",
    allow_quantized: bool = False,
) -> Tuple[Dict[str, Any], Config, Dict[str, Any]]:
    """({flax path: saved tensor on the CPU}, config, metadata) of the
    newest intact step under `checkpoint` (a training checkpoint or a
    params-only one, such as `finetune --merge-out` writes). The config
    is the one in the checkpoint's metadata (with `overrides` applied)
    unless one is given. An int8 serving export gives QuantizedTensor
    leaves where allow_quantized, and raises ValueError otherwise."""
    from luminaai_tpu_torch.training.checkpoint import (
        find_checkpoint_step,
        load_state_file,
    )

    step_dir, meta = find_checkpoint_step(checkpoint, mode=mode)
    if config is None:
        config = Config.from_dict({**meta["config"], **(overrides or {})})
    tree = load_state_file(step_dir)
    logger.info("loading checkpoint %s (step %s)", step_dir, meta.get("step"))
    params = tree["params"]
    if "quantization" in meta:
        if not allow_quantized:
            raise ValueError(
                f"{checkpoint} is an int8 SERVING checkpoint "
                "(convert --to int8); chat/serve load it, but this "
                "operation needs full-precision weights — use the "
                "source checkpoint instead"
            )
        from luminaai_tpu_torch.training.quantization import (
            import_quantized_tree,
        )

        manifest = meta["quantization"]["manifest"]
        params = import_quantized_tree(params, manifest)
        logger.info("loaded int8 serving checkpoint (%d quantized tensors)",
                    len(manifest))
    return params, config, meta


def load_checkpoint_params(
    checkpoint: str,
    config: Optional[Config] = None,
    overrides: Optional[Dict[str, Any]] = None,
    mode: str = "full",
    allow_quantized: bool = False,
) -> Tuple[Dict[str, Any], Config, int]:
    """(state_dict of the saved parameters on the CPU, config, step) of
    the newest intact step under `checkpoint`."""
    flat, config, meta = load_checkpoint_flax(checkpoint, config,
                                              overrides, mode,
                                              allow_quantized)
    return flax_to_state_dict(flat, config), config, meta["step"]


def load_model_for_inference(
    checkpoint_dir: str,
    config: Optional[Config] = None,
    keep_master_dtype: bool = False,
    adapter: Optional[str] = None,
    device=None,
    overrides: Optional[Dict[str, Any]] = None,
    allow_quantized: bool = False,
) -> Tuple[LuminaTransformer, Config]:
    """(model on `device`, config) from a checkpoint. The parameters are
    cast to bf16 first unless keep_master_dtype (fine-tuning keeps the
    fp32 masters and gets the trainable model: fp32 parameters cast at
    each use); `adapter` (a LoRA .npz) merges after the cast. `overrides`
    apply to the checkpoint's config (serve's --dense/--moe-dispatch).
    An int8 serving export loads only where allow_quantized."""
    from luminaai_tpu_torch.ops.quantized import QuantizedTensor

    flat, config, _ = load_checkpoint_flax(
        checkpoint_dir, config, overrides, allow_quantized=allow_quantized)
    if not keep_master_dtype:
        flat = {k: v if isinstance(v, QuantizedTensor)
                else v.to(torch.bfloat16) for k, v in flat.items()}
    if adapter is not None:
        from luminaai_tpu_torch.training.adapters import load_lora, merge_lora

        if any(isinstance(v, QuantizedTensor) for v in flat.values()):
            raise ValueError(
                f"{checkpoint_dir} holds int8 weights: merge the adapter "
                "into the source checkpoint, then convert --to int8")
        lora, spec = load_lora(adapter)
        flat = merge_lora(flat, lora, spec)
        logger.info("merged LoRA adapter %s (rank %d, %d kernels)",
                    adapter, spec.rank, len(lora))
    model = LuminaTransformer(config, device=device,
                              trainable=keep_master_dtype)
    model.load_params(flax_to_state_dict(flat, config))
    return model, config


def build_engine(
    config: Optional[Config],
    *,
    device=None,
    seed: Optional[int] = None,
    weights: Optional[str] = None,
    checkpoint: Optional[str] = None,
    overrides: Optional[Dict[str, Any]] = None,
) -> GenerationEngine:
    """A GenerationEngine with its model on `device` (None = the card;
    raises where CUDA is absent). Weights: the checkpoint at `checkpoint`
    (config None = the checkpoint's, with `overrides` applied; an int8
    serving export loads as it was saved), else the .npz at `weights`,
    else a random init from `seed` (config.seed when None). The engine
    applies the config's quantization_method and kv_cache_dtype."""
    state_dict = None
    if checkpoint is not None:
        state_dict, config, _ = load_checkpoint_params(
            checkpoint, config, overrides, allow_quantized=True)
    model = LuminaTransformer(config, device=device)
    if state_dict is not None:
        model.load_params(state_dict)
    elif weights is not None:
        with np.load(weights) as npz:
            model.load_params(params_from_flax(dict(npz), config))
    else:
        init_params(model, config.seed if seed is None else seed)
    return GenerationEngine(
        model, ConversationTokenizer(model_name=config.tokenizer_name),
        config,
    )


class ChatInterface:
    """Terminal chat session over GenerationEngine.chat_response."""

    def __init__(
        self,
        checkpoint_dir: Optional[str] = None,
        config: Optional[Config] = None,
        tokenizer: Optional[ConversationTokenizer] = None,
        engine: Optional[GenerationEngine] = None,
        quantize: Optional[str] = None,
        adapter: Optional[str] = None,
        kv_cache_dtype: Optional[str] = None,
        device=None,
    ):
        if engine is not None:
            self.engine = engine
            self.config = engine.config
        else:
            if checkpoint_dir is None:
                found = find_latest_checkpoint()
                if found is None:
                    raise FileNotFoundError(
                        "no checkpoint found; pass checkpoint_dir"
                    )
                checkpoint_dir = str(found)
                logger.info("auto-discovered checkpoint: %s", checkpoint_dir)
            model, config = load_model_for_inference(
                checkpoint_dir, config=config, adapter=adapter,
                device=device, allow_quantized=True,
            )
            if quantize is not None:
                # Serve int8/int4: the engine quantizes from its config.
                config.quantization_method = quantize
            if kv_cache_dtype is not None:
                # int8 decode KV cache: about half the pool's bytes.
                config.kv_cache_dtype = kv_cache_dtype
            self.config = config
            # The checkpoint's tokenizer_name travels in its config.
            tokenizer = tokenizer or ConversationTokenizer(
                model_name=config.tokenizer_name
            )
            self.engine = GenerationEngine(model, tokenizer, config)
        self.tokenizer = self.engine.tokenizer
        self.stats = SessionStats()
        self.mode = "balanced"
        self.system_prompt: Optional[str] = None
        self.history: List[Dict[str, str]] = []

    # -- one exchange ------------------------------------------------------
    def respond(self, user_message: str) -> Tuple[str, Dict[str, Any]]:
        messages: List[Dict[str, str]] = []
        if self.system_prompt:
            messages.append({"role": "system", "content": self.system_prompt})
        messages.extend(self.history)
        messages.append({"role": "user", "content": user_message})
        temperature, top_p = GENERATION_MODES[self.mode]
        text, gen_stats = self.engine.chat_response(
            messages, temperature=temperature, top_p=top_p
        )
        self.history.append({"role": "user", "content": user_message})
        self.history.append({"role": "assistant", "content": text})
        self.stats.messages += 1
        self.stats.total_tokens += gen_stats["tokens_generated"]
        self.stats.total_seconds += gen_stats["seconds"]
        return text, gen_stats

    # -- commands ----------------------------------------------------------
    def handle_command(self, command: str) -> Optional[str]:
        """Returns output text, or None if the REPL should exit."""
        parts = command.strip().split(maxsplit=1)
        cmd = parts[0].lower()
        arg = parts[1] if len(parts) > 1 else ""
        if cmd in ("/quit", "/exit"):
            return None
        if cmd == "/help":
            return (
                "/help /stats /mode <name> /system <prompt> /clear "
                "/save <name> /config /quit\n"
                f"modes: {', '.join(GENERATION_MODES)}"
            )
        if cmd == "/stats":
            s = self.stats
            return (
                f"messages: {s.messages}  tokens: {s.total_tokens}  "
                f"tok/s: {s.tokens_per_second():.1f}  "
                f"avg response: {s.avg_response_time():.2f}s"
            )
        if cmd == "/mode":
            if arg in GENERATION_MODES:
                self.mode = arg
                return f"mode -> {arg}"
            return f"unknown mode {arg!r}; one of {list(GENERATION_MODES)}"
        if cmd == "/system":
            self.system_prompt = arg or None
            return "system prompt " + ("set" if arg else "cleared")
        if cmd == "/clear":
            self.history.clear()
            return "history cleared"
        if cmd == "/save":
            name = arg or f"conversation_{int(time.time())}"
            path = Path(f"{name}.json")
            path.write_text(json.dumps({
                "history": self.history,
                "system_prompt": self.system_prompt,
                "stats": dataclasses.asdict(self.stats),
            }, indent=1))
            return f"saved -> {path}"
        if cmd == "/config":
            c = self.config
            return (
                f"model: {c.num_layers}L x {c.hidden_size}h, "
                f"{c.num_heads}/{c.num_kv_heads} heads, "
                f"moe={c.num_experts if c.use_moe else 'off'}, "
                f"vocab={c.vocab_size}, ctx={c.seq_length}"
            )
        return f"unknown command {cmd!r}; try /help"

    # -- REPL --------------------------------------------------------------
    def run(self) -> None:  # pragma: no cover - interactive
        print("LuminaAI chat. /help for commands, /quit to exit.")
        while True:
            try:
                user = input("\nyou> ").strip()
            except (EOFError, KeyboardInterrupt):
                print()
                break
            if not user:
                continue
            if user.startswith("/"):
                out = self.handle_command(user)
                if out is None:
                    break
                print(out)
                continue
            text, gen_stats = self.respond(user)
            print(f"\nassistant> {text}")
            print(
                f"  [{gen_stats['tokens_generated']} tokens, "
                f"{gen_stats['tokens_per_second']} tok/s]"
            )
