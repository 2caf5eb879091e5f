"""Configuration for the PyTorch/CUDA port (trimmed copy of luminaai_tpu/config.py).

The port keeps its own copy of the fields its serving, training,
training-runtime and adaptive-training slices read (checkpoints, data,
monitoring, retry, watchdog and the orchestrator's switches), with the
JAX package's names, defaults and validation, so a `Config` built with
the same keyword arguments describes the same model and the same training
run on both sides, and `to_dict()` of both agrees on the shared keys
once written as JSON (the port's gives the schedule tuple as a list).
`save` / `load` write and read it as JSON (YAML where `yaml` imports), as
the JAX Config does, and `load` drops the keys this copy does not know, so
a JAX config file loads here. Fields for parallelism and serving extras
stay in the JAX package until the slices that need them are ported. Values
the port does not run yet are accepted here, as the JAX package accepts
them, and refused where a model is built (MoE dispatch modes other than
sort and gmm, mixture of depths: models/transformer.py) or a trainer is
built (parallel/train_step.py `check_trainable`).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

try:  # optional, as in the JAX package: YAML config files where it imports
    import yaml

    _HAS_YAML = True
except ImportError:  # pragma: no cover - depends on the environment
    _HAS_YAML = False

PRECISIONS = ("auto", "fp32", "bf16", "mixed_bf16", "fp16", "mixed_fp16")
LR_SCHEDULES = ("cosine", "linear", "constant", "wsd")
REMAT_POLICY_NAMES = (
    "nothing_saveable", "save_outs", "save_attn", "dots_saveable", "full",
)
MOE_PATTERNS = ("all", "every_3rd", "every_4th", "sandwich", "none")
MOE_DISPATCHES = ("sort", "gather", "einsum", "gmm", "a2a")


@dataclass
class Config:
    """Model + serving configuration (the subset the port reads)."""

    # --- Model architecture ---
    vocab_size: int = 50304
    hidden_size: int = 512
    num_layers: int = 8
    num_heads: int = 8
    num_kv_heads: Optional[int] = 4
    seq_length: int = 1024
    intermediate_size: Optional[int] = None  # auto: 8/3 * hidden, rounded
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    dropout: float = 0.0
    init_std: float = 0.02
    # Flash attention on the no-cache (training) forward. flash_block_q/kv
    # only feed the eligibility gate (ops/flash_attention.flash_eligible),
    # as in the JAX package; the card's kernels use their own tiles.
    use_flash_attention: bool = True
    flash_block_q: int = 1024
    flash_block_kv: int = 1024
    # RoPE rotation math: 'fp32' (exact tables) or 'bf16' (rotation in the
    # compute dtype; only the products round differently).
    rope_dtype: str = "fp32"
    # Chunked prefill: prompts longer than one chunk prefill in fixed
    # chunks of this many tokens, interleaved with decode steps by the
    # scheduler. 0 disables (bucketed prefill for every prompt).
    prefill_chunk_size: int = 64
    # Sliding-window attention width (None = full causal). The slot-paged
    # pool never rolls, so the window is a per-lane band mask.
    attention_window: Optional[int] = None

    # --- MoE (luminaai_tpu/config.py:113-141) ---
    use_moe: bool = False
    num_experts: int = 8
    moe_top_k: int = 2
    capacity_factor: float = 1.25
    load_balancing_weight: float = 0.01
    router_z_loss_weight: float = 1e-3
    routing_temperature: float = 1.0
    # Training-time routing noise and whole-expert dropout, drawn from the
    # train step's torch.Generator (not JAX's numbers).
    routing_noise_std: float = 0.1
    expert_dropout_rate: float = 0.0
    moe_pattern: str = "all"
    dense_start_layers: int = 2
    dense_end_layers: int = 2
    expert_output_scaling: float = 1.0
    # 'sort' = scatter/gather via flat slot ids into capacity buffers and
    # dense expert products; 'gmm' = the dropless grouped matmul (kernel
    # B4). 'gather', 'einsum' and 'a2a' are accepted and refused where the
    # model is built (not ported yet).
    moe_dispatch: str = "sort"

    # --- MoD (accepted, refused where the model is built; not ported) ---
    use_mod: bool = False
    mod_capacity_factor: float = 0.5

    # --- Training ---
    batch_size: int = 8  # sequences per optimizer step
    gradient_accumulation_steps: int = 1
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip_norm: float = 1.0
    max_steps: Optional[int] = None
    warmup_ratio: float = 0.15
    lr_scheduler: str = "cosine"
    use_lr_scheduler: bool = True
    min_lr: float = 1e-6
    precision: str = "auto"  # auto|fp32|bf16|mixed_bf16|fp16|mixed_fp16
    gradient_checkpointing: bool = True
    # nothing_saveable = recompute each block in the backward (the port's
    # torch.utils.checkpoint per block); full = no recomputation. The
    # other JAX policies are accepted and refused by the trainer.
    remat_policy: str = "nothing_saveable"
    adam_mu_dtype: Optional[str] = None  # None = fp32; 'bf16' not ported
    adam_state_quantization: Optional[str] = None  # 'int8' not ported
    z_loss_weight: float = 0.0
    label_smoothing: float = 0.0
    # LM head fused into the CE loss, chunked over the sequence: [B, S, V]
    # logits never exist (ops/fused.py).
    fused_lm_head_ce: bool = True
    loss_chunk_size: int = 256
    eval_every_n_batches: int = 500
    save_every_n_batches: int = 1000
    assistant_loss_weight: float = 1.5

    # --- Data (luminaai_tpu/config.py:290-299) ---
    train_data_path: str = "data/train.jsonl"
    eval_data_path: str = "data/eval.jsonl"
    tokenizer_name: str = "byte"  # byte|bpe:PATH
    num_workers: int = 2
    streaming_threshold_gb: float = 10.0
    pack_sequences: bool = True
    use_native_dataloader: bool = True  # C++ packer (native/) when built

    # --- Generation ---
    max_new_tokens: int = 512
    temperature: float = 0.8
    top_p: float = 0.9
    top_k: int = 50
    repetition_penalty: float = 1.05

    # --- Production / experiment ---
    experiment_name: Optional[str] = None
    output_dir: str = "experiments"
    seed: int = 42
    log_level: str = "INFO"
    save_total_limit: int = 5
    early_stopping_patience: Optional[int] = None
    auto_resume: bool = True
    backup_every_n_hours: int = 6
    max_retries: int = 3

    # --- Monitoring / fault tolerance (luminaai_tpu/config.py:337-420) ---
    health_check_interval: int = 100
    loss_spike_threshold: float = 2.0
    grad_norm_threshold: float = 100.0
    expert_collapse_threshold: float = 0.05
    # Goodput ledger + hang watchdog + step-time anomaly sentinel: the
    # ledger attributes every second of the run to a cause; the watchdog
    # heartbeats at the log-window sync and fires when a beat gap exceeds
    # watchdog_k x (rolling median + MAD), floored at watchdog_floor_s,
    # armed after the first step.
    goodput: bool = True
    watchdog: bool = True
    watchdog_k: float = 10.0
    watchdog_floor_s: float = 30.0
    watchdog_warmup: int = 3
    watchdog_poll_s: float = 1.0
    # A confirmed stall exits 75 (resumable) after dumping stacks and the
    # flight ring.
    watchdog_abort: bool = False
    step_anomaly: bool = True
    step_anomaly_k: float = 4.0
    # Durable I/O: io_retries total attempts per op, delays io_retry_base_s
    # doubling up to io_retry_max_s, the op bounded by io_timeout_s.
    io_retries: int = 4
    io_retry_base_s: float = 0.05
    io_retry_max_s: float = 2.0
    io_timeout_s: Optional[float] = None
    # Restore verifies each step's sha256 manifest: 'full' hashes every
    # file, 'sample' a deterministic subset (sizes always), 'off' none.
    checkpoint_verify: str = "full"
    # Emergency saves fall back here when the checkpoint dir fails.
    checkpoint_local_tier: Optional[str] = None
    # Corrupt records are quarantined (counted, skipped); a quarantine
    # rate above the fence aborts.
    data_quarantine: bool = True
    data_quarantine_max_rate: float = 0.05

    # --- Adaptive control (training/orchestrator.py; JAX config.py:447-474) ---
    enable_adaptive_lr: bool = True
    allow_scheduler_override: bool = True
    min_override_threshold: float = 0.2
    emergency_override_enabled: bool = True
    log_lr_decisions: bool = True
    enable_architecture_evolution: bool = False
    # Runtime capacity-factor / routing-temperature tuning (each change
    # rebuilds the step).
    enable_moe_routing_optimization: bool = True
    # The orchestrator may raise AdamW weight decay on a slow sustained
    # loss rise.
    enable_adaptive_wd: bool = True
    # Gradient-noise-driven growth of the batch (opt-in).
    enable_batch_size_optimization: bool = False
    # Phase-scheduled MoD compute ratio: accepted, but it cannot fire while
    # use_mod is refused where the model is built.
    enable_mod_capacity_adaptation: bool = False
    mod_capacity_schedule: tuple = (0.7, 0.5, 0.3)
    # Learning-velocity curriculum: the orchestrator forwards the
    # recommended difficulty to a loader with set_difficulty (PackedDataset
    # maps it to a doc-length quantile at the next epoch).
    enable_adaptive_curriculum: bool = False
    intervention_cooldown_steps: int = 200

    # --- Chinchilla scaling ---
    use_chinchilla_scaling: bool = False
    tokens_per_param: float = 20.0
    convergence_patience: int = 5

    def __post_init__(self):
        if isinstance(self.mod_capacity_schedule, list):  # from JSON
            self.mod_capacity_schedule = tuple(self.mod_capacity_schedule)
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads
        if self.intermediate_size is None:
            # SwiGLU sizing: 8/3 * hidden, rounded up to a multiple of 128.
            raw = int(8 * self.hidden_size / 3)
            self.intermediate_size = ((raw + 127) // 128) * 128
        self.validate()

    def validate(self) -> None:
        if self.hidden_size % self.num_heads != 0:
            raise ValueError("hidden_size must be divisible by num_heads")
        if self.num_heads % self.num_kv_heads != 0:
            raise ValueError("num_heads must be divisible by num_kv_heads")
        if self.precision not in PRECISIONS:
            raise ValueError(f"invalid precision {self.precision}")
        if self.rope_dtype not in ("fp32", "bf16"):
            raise ValueError(f"invalid rope_dtype {self.rope_dtype}")
        if self.prefill_chunk_size < 0:
            raise ValueError(
                "prefill_chunk_size must be >= 0 (0 disables chunked prefill)"
            )
        if self.attention_window is not None and self.attention_window <= 0:
            raise ValueError(
                f"attention_window must be positive, got "
                f"{self.attention_window}"
            )
        if self.lr_scheduler not in LR_SCHEDULES:
            raise ValueError(f"invalid lr_scheduler {self.lr_scheduler}")
        if self.loss_chunk_size <= 0:
            raise ValueError("loss_chunk_size must be positive")
        if self.remat_policy not in REMAT_POLICY_NAMES:
            raise ValueError(f"invalid remat_policy {self.remat_policy}")
        if self.adam_mu_dtype not in (None, "bf16"):
            raise ValueError(f"invalid adam_mu_dtype {self.adam_mu_dtype}")
        if self.adam_state_quantization not in (None, "int8"):
            raise ValueError(
                f"invalid adam_state_quantization "
                f"{self.adam_state_quantization}"
            )
        if self.adam_state_quantization and self.adam_mu_dtype:
            raise ValueError(
                "adam_state_quantization supersedes adam_mu_dtype; set one"
            )
        if self.watchdog_k <= 0:
            raise ValueError("watchdog_k must be positive")
        if self.watchdog_floor_s <= 0:
            raise ValueError("watchdog_floor_s must be positive")
        if self.watchdog_warmup < 1:
            raise ValueError("watchdog_warmup must be >= 1")
        if self.watchdog_poll_s <= 0:
            raise ValueError("watchdog_poll_s must be positive")
        if self.step_anomaly_k <= 1:
            raise ValueError("step_anomaly_k must be > 1")
        if self.io_retries < 1:
            raise ValueError("io_retries must be >= 1 (1 = no retry)")
        if self.io_retry_base_s <= 0:
            raise ValueError("io_retry_base_s must be positive")
        if self.io_retry_max_s < self.io_retry_base_s:
            raise ValueError("io_retry_max_s must be >= io_retry_base_s")
        if self.io_timeout_s is not None and self.io_timeout_s <= 0:
            raise ValueError("io_timeout_s must be positive")
        if self.checkpoint_verify not in ("full", "sample", "off"):
            raise ValueError(
                f"invalid checkpoint_verify {self.checkpoint_verify!r} "
                "(one of full/sample/off)"
            )
        if not 0.0 < self.data_quarantine_max_rate <= 1.0:
            raise ValueError("data_quarantine_max_rate must be in (0, 1]")
        if self.use_moe:
            # The single-device part of the JAX validation (config.py:658-741).
            if self.moe_top_k > self.num_experts:
                raise ValueError("moe_top_k must be <= num_experts")
            if self.moe_pattern not in MOE_PATTERNS:
                raise ValueError(f"invalid moe_pattern {self.moe_pattern}")
            if not self.capacity_factor > 0:
                raise ValueError("capacity_factor must be positive")
            if self.moe_dispatch not in MOE_DISPATCHES:
                raise ValueError(f"invalid moe_dispatch {self.moe_dispatch}")
            if not 0.0 <= self.expert_dropout_rate <= 0.5:
                raise ValueError("expert_dropout_rate must be in [0, 0.5]")

    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def to_dict(self) -> Dict[str, Any]:
        """The fields as JSON types (the schedule tuple as a list), so a
        checkpoint's metadata reads back equal."""
        d = dataclasses.asdict(self)
        d["mod_capacity_schedule"] = list(self.mod_capacity_schedule)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        """A Config from a to_dict() of either side (a checkpoint's
        metadata): keys this copy does not know are dropped."""
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def save(self, path: str) -> None:
        """Write to_dict() as JSON (YAML for .yaml/.yml where yaml
        imports), as the JAX Config.save does."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        d = self.to_dict()
        with open(path, "w") as f:
            if path.endswith((".yaml", ".yml")) and _HAS_YAML:
                yaml.safe_dump(d, f, sort_keys=False)
            else:
                json.dump(d, f, indent=2)

    @classmethod
    def load(cls, path: str) -> "Config":
        """A Config from a file Config.save (of either side) wrote."""
        with open(path) as f:
            if path.endswith((".yaml", ".yml")) and _HAS_YAML:
                d = yaml.safe_load(f)
            else:
                d = json.load(f)
        return cls.from_dict(d)

    def estimate_parameters(self) -> int:
        """Total parameter count (the JAX Config.estimate_parameters; the
        port ties the LM head to the embedding)."""
        h, v, L = self.hidden_size, self.vocab_size, self.num_layers
        inter = self.intermediate_size
        kv_dim = self.num_kv_heads * self.head_dim()
        attn = h * h + 2 * h * kv_dim + h * h  # q, k, v, o
        ffn_dense = 3 * h * inter  # gate, up, down
        total = v * h + L * (attn + 2 * h) + h  # + norms, final norm
        moe_layers = self.num_moe_layers()
        total += (L - moe_layers) * ffn_dense
        total += moe_layers * (self.num_experts * ffn_dense
                               + h * self.num_experts)
        return total

    def estimate_active_parameters(self) -> int:
        """Per-token parameters: the MoE layers' top-k experts only."""
        total = self.estimate_parameters()
        if not self.use_moe:
            return total
        ffn_dense = 3 * self.hidden_size * self.intermediate_size
        return total - self.num_moe_layers() * (
            self.num_experts - self.moe_top_k) * ffn_dense

    def num_moe_layers(self) -> int:
        if not self.use_moe:
            return 0
        return sum(1 for i in range(self.num_layers) if self.is_moe_layer(i))

    def is_moe_layer(self, layer_idx: int) -> bool:
        """MoE layer placement pattern (the JAX Config.is_moe_layer)."""
        if not self.use_moe or self.moe_pattern == "none":
            return False
        if self.moe_pattern == "all":
            return True
        if self.moe_pattern == "every_3rd":
            return layer_idx % 3 == 2
        if self.moe_pattern == "every_4th":
            return layer_idx % 4 == 3
        if self.moe_pattern == "sandwich":
            return (
                self.dense_start_layers <= layer_idx
                < self.num_layers - self.dense_end_layers
            )
        return False

    def resolve_precision(self) -> str:
        p = self.precision
        if p == "auto":
            return "mixed_bf16"
        if p == "fp16":
            return "bf16"
        if p == "mixed_fp16":
            return "mixed_bf16"
        return p

    def compute_dtype(self) -> torch.dtype:
        """The model's compute dtype, as LuminaTransformer.dtype in the
        JAX package derives it (from the training precision)."""
        return torch.bfloat16 if "bf16" in self.resolve_precision() else (
            torch.float32
        )


class ConfigPresets:
    """The JAX package's presets that the port runs. Each keeps the JAX
    preset's architecture, MoE and training fields; pass `use_moe=False`
    (the CLI's `--dense`) for the dense model at the preset's widths."""

    @staticmethod
    def debug() -> Config:
        return Config(
            vocab_size=1024,
            hidden_size=128,
            num_layers=2,
            num_heads=2,
            num_kv_heads=1,
            seq_length=256,
            intermediate_size=256,
            batch_size=2,
            gradient_accumulation_steps=2,
            learning_rate=5e-5,
            gradient_checkpointing=False,
            use_moe=True,
            num_experts=8,
            moe_top_k=2,
            capacity_factor=1.1,
            load_balancing_weight=0.005,
            eval_every_n_batches=50,
            save_every_n_batches=100,
            experiment_name="debug_run",
            log_level="DEBUG",
            health_check_interval=10,
            save_total_limit=3,
        )

    @staticmethod
    def debug_300m() -> Config:
        return Config(
            vocab_size=50304,
            hidden_size=768,
            num_layers=6,
            num_heads=4,
            num_kv_heads=2,
            seq_length=1024,
            batch_size=16,
            use_moe=True,
            num_experts=8,
            moe_top_k=2,
            experiment_name="debug_300m",
        )

    @staticmethod
    def b1() -> Config:
        return Config(
            vocab_size=50304,
            hidden_size=2048,
            num_layers=16,
            num_heads=16,
            num_kv_heads=4,
            seq_length=2048,
            # The JAX preset's batch 128 (accumulation 8) runs over
            # fsdp_parallel_size=8 chips; the port trains on one card, so
            # it takes one chip's share: 16 sequences, accumulation 8
            # (micro-batch 2 x 2048 tokens), the same per-chip work.
            batch_size=16,
            gradient_accumulation_steps=8,
            use_moe=True,
            num_experts=8,
            moe_top_k=2,
            experiment_name="b1",
        )

    _PRESETS = ("debug", "debug_300m", "b1")

    @classmethod
    def available(cls) -> List[str]:
        return list(cls._PRESETS)

    @classmethod
    def get(cls, name: str, **overrides: Any) -> Config:
        if name not in cls._PRESETS:
            raise ValueError(
                f"Unknown preset: {name}. Available: {cls.available()}"
            )
        return dataclasses.replace(getattr(cls, name)(), **overrides)


def resolve_device(device: Optional[Any] = None) -> torch.device:
    """The port's device rule: None means the card. Raises when CUDA is
    absent; only an explicit CPU device runs on the CPU (the tests)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    return dev
