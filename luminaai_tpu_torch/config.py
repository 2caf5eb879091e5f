"""Configuration for the PyTorch/CUDA port (trimmed copy of luminaai_tpu/config.py).

The port keeps its own copy of the fields its serving, training,
training-runtime and adaptive-training slices read (checkpoints, data,
monitoring, retry, watchdog, the orchestrator's switches and the mesh),
with the JAX package's names, defaults and validation, so a `Config` built
with the same keyword arguments describes the same model and the same
training run on both sides, and `to_dict()` of both agrees on the shared
keys once written as JSON (the port's gives its tuples as lists).
`save` / `load` write and read it as JSON (YAML where `yaml` imports), as
the JAX Config does, and `load` drops the keys this copy does not know, so
a JAX config file loads here. The serving extras stay in the JAX package
until the slices that need them are ported. The mesh fields are JAX's,
validated as JAX validates them (`normalize_parallelism` folds
accumulation into pipeline microbatches, as in JAX). The port's model
loops over
its layers whatever `scan_layers` says: the field names the layout of a
checkpoint's parameter tree (convert.py reads and writes the scanned
trees), and, as in the JAX package, sends int8 serving of such a model
down the storage-only path (training/quantization.py).
"""

from __future__ import annotations

import dataclasses
import json
import math
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
ATTENTION_BACKENDS = ("ragged",)
# The JAX package's XLA attention backends: a JAX config file carrying one
# serves on the port's 'ragged' dispatch (the kernel on the card).
JAX_ONLY_BACKENDS = ("dense", "ragged_xla")


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
    # Accepted and read by no layer, as in the JAX package.
    dropout: float = 0.0
    init_std: float = 0.02
    tie_word_embeddings: bool = True
    use_stable_embedding: bool = True
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
    # Serving attention backend for the length-aware decode paths
    # (ops/ragged_paged_attention.paged_attention): 'ragged' only, the
    # decode kernel (B5) for eligible decode shapes on the card and the
    # plain version on the CPU. The JAX package's values ('dense',
    # 'ragged_xla': its XLA references) read as 'ragged' when a JAX config
    # file is loaded (from_dict); the plain oracle is a per-call argument.
    attention_backend: str = "ragged"
    # Decode KV cache storage: 'bf16' (the compute dtype) or 'int8' (codes
    # [.., C, Hkv, D] plus fp32 per-row scales [.., C, Hkv, 1], quantized
    # at insert; B5 reads both on the card): about half the pool's bytes.
    kv_cache_dtype: str = "bf16"
    # Radix prefix cache over the serving KV pool (inference/
    # prefix_cache.py): budget of content-hash-keyed arena pages shared
    # across lanes; admissions splice the longest cached prompt-prefix page
    # chain into their global page table and prefill only the uncached
    # suffix. 0 disables. Needs chunked prefill.
    prefix_cache_pages: int = 0
    # Max arena pages one tenant may own (0 = unbounded): a hot tenant at
    # quota evicts its OWN pages, never everyone else's.
    prefix_cache_tenant_quota: int = 0
    # Replica router (serving/router.py; luminaai_tpu/config.py:428-433):
    # probes every router_probe_interval_s; a replica's breaker opens after
    # router_breaker_failures consecutive failures and probes half-open
    # after router_breaker_cooldown_s; a failed dispatch retries on up to
    # router_max_failovers other replicas; hedging (route --hedge) fires a
    # second replica for requests of at most router_hedge_max_tokens new
    # tokens, capped at router_hedge_budget of non-stream traffic.
    router_probe_interval_s: float = 2.0
    router_breaker_failures: int = 3
    router_breaker_cooldown_s: float = 5.0
    router_max_failovers: int = 2
    router_hedge_budget: float = 0.1
    router_hedge_max_tokens: int = 32
    # Cross-replica KV page sharing (serving/page_share.py; :443-444):
    # page_pull_timeout_s bounds one whole pull (lookup + transfers)
    # before the admission prefills locally; page_share_max_inflight caps
    # concurrent pulls per replica. ChatServer reads both from the
    # engine's Config unless serve passes a flag. The router URL
    # (serve --page-share) switches sharing on, so JAX's unread
    # `page_share` bool is not copied here.
    page_pull_timeout_s: float = 2.0
    page_share_max_inflight: int = 2

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
    # 'sort' = scatter into capacity buffers by flat slot ids and dense
    # expert products; 'gather' = the same buffers filled by a row gather
    # (gather-only backward); 'einsum' = one-hot dispatch/combine
    # products; 'gmm' = the dropless grouped matmul (kernel B4); 'a2a' =
    # tokens shard over (data, fsdp, expert) and are routed to their
    # experts' ranks by the hierarchical all-to-all
    # (parallel/expert_dispatch.py), needs an expert mesh axis.
    moe_dispatch: str = "sort"
    # a2a only: how much of the expert axis spans nodes (the inter-node
    # tier of the two-stage exchange); 1 = one stage.
    expert_dcn_size: int = 1
    # a2a only: the bucket payload's chunks, so one chunk's exchange runs
    # beside another chunk's expert products.
    moe_a2a_overlap_chunks: int = 2

    # --- MoD (models/mod.py; JAX config.py:172-174) ---
    use_mod: bool = False
    mod_capacity_factor: float = 0.5
    mod_routing_temperature: float = 1.0

    # --- Training ---
    batch_size: int = 8  # sequences per optimizer step
    gradient_accumulation_steps: int = 1
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip_norm: float = 1.0
    num_epochs: int = 3
    max_steps: Optional[int] = None
    warmup_ratio: float = 0.15
    lr_scheduler: str = "cosine"
    use_lr_scheduler: bool = True
    min_lr: float = 1e-6
    precision: str = "auto"  # auto|fp32|bf16|mixed_bf16|fp16|mixed_fp16
    # Weight quantization for serving (training/quantization.py): None |
    # 'int8' (W8A8 products) | 'int4' (packed storage, dequantized at
    # load); the engine applies it (JAX config.py:196-197).
    quantization_method: Optional[str] = None
    quantization_bits: int = 8
    # The parameter tree's layout in checkpoints (JAX scan_layers); the
    # port's model loops over its layers either way.
    scan_layers: bool = False
    gradient_checkpointing: bool = True
    # The JAX REMAT_POLICIES (models/transformer.py): nothing_saveable =
    # recompute each block; save_outs = keep each block's two branch
    # outputs; save_attn = save_outs + the flash forward's (out, lse);
    # dots_saveable = keep the matmul outputs; full = no recomputation.
    remat_policy: str = "nothing_saveable"
    adam_mu_dtype: Optional[str] = None  # None = fp32; 'bf16'
    adam_state_quantization: Optional[str] = None  # None or 'int8'
    z_loss_weight: float = 0.0
    label_smoothing: float = 0.0
    # LM head fused into the CE loss, chunked over the sequence: [B, S, V]
    # logits never exist (ops/fused.py).
    fused_lm_head_ce: bool = True
    loss_chunk_size: int = 256
    eval_every_n_batches: int = 500
    save_every_n_batches: int = 1000
    assistant_loss_weight: float = 1.5

    # --- Parallelism (luminaai_tpu/config.py:236-289) ---
    # One process per card (torchrun); parallel/mesh.py lays the world
    # out over these axes, the last varying fastest. data -1 takes the
    # ranks the others leave.
    mesh_axes: tuple = ("data", "pipe", "fsdp", "expert", "sequence",
                        "tensor")
    data_parallel_size: int = -1
    # Pipeline stages (parallel/pipeline.py): stage p holds layers
    # [p L / P, (p + 1) L / P); 'gpipe' or '1f1b' over
    # pipeline_microbatches (None: one a stage).
    pipeline_parallel_size: int = 1
    pipeline_microbatches: Optional[int] = None
    pipeline_schedule: str = "1f1b"
    fsdp_parallel_size: int = 1
    expert_parallel_size: int = 1
    tensor_parallel_size: int = 1
    sequence_parallel_size: int = 1
    use_ring_attention: bool = False  # required when sequence > 1
    # Gradient reduction over (data, fsdp): 'flat' = FSDP2's own
    # reduce-scatter; 'hierarchical' = parallel/grad_reduce.py's bucketed
    # reduce-scatter inside a node, all-reduce across nodes
    # (gradient_dcn_size groups of the data axis), all-gather back.
    grad_reduce: str = "flat"
    gradient_dcn_size: int = 1
    grad_reduce_bucket_mb: float = 32.0
    grad_reduce_overlap_chunks: int = 2
    grad_reduce_dcn_dtype: Optional[str] = None  # None (fp32) or 'bf16'
    allow_split_physical_axes: bool = False
    # init_process_group from these when torchrun's environment is absent.
    multihost: bool = False
    coordinator_address: Optional[str] = None
    process_id: Optional[int] = None
    num_processes: Optional[int] = None
    # The Adam moments in pinned host memory between steps, streamed to
    # the card a parameter at a time for the update (training/optimizer.py).
    host_offload_optimizer: bool = False

    # --- Data (luminaai_tpu/config.py:290-299) ---
    train_data_path: str = "data/train.jsonl"
    eval_data_path: str = "data/eval.jsonl"
    tokenizer_name: str = "byte"  # byte|bpe:PATH
    num_workers: int = 2
    max_conversations_per_file: int = 10000
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
    # A torch.profiler trace (CPU and CUDA activities, a Chrome trace)
    # of the steps [profile_start_step, profile_start_step +
    # profile_num_steps) into profile_dir (default output_dir/profile); 0
    # disables. The Trainer attributes it per subsystem
    # (monitoring/attribution.py) into registry gauges and
    # attribution.jsonl (JAX config.py:313-320).
    profile_start_step: int = 0
    profile_num_steps: int = 3
    profile_dir: Optional[str] = None
    # Count the first train step's FLOPs (torch's FLOP counter plus the
    # kernel wrappers' own counts) and the allocator's peak, with the
    # analytic-vs-counted cross-check (JAX config.py:326).
    compiled_cost_analysis: bool = False
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
    # SLO engine (monitoring/slo.py; JAX config.py:372-391): a background
    # sampler keeps windowed history of the registry in a fixed-memory ring
    # and the engine judges objectives over fast/slow windows with
    # burn-rate rules; slo_config names a JSON file REPLACING the default
    # objectives. All host side: no device work on the step path.
    slo: bool = True
    slo_sample_interval_s: float = 5.0
    slo_ring_points: int = 720
    slo_max_series: int = 256
    slo_fast_window_s: float = 60.0
    slo_slow_window_s: float = 600.0
    slo_fast_burn: float = 10.0
    slo_slow_burn: float = 2.0
    slo_budget: float = 0.1
    slo_ttft_p95_s: float = 2.0
    slo_decode_p50_s: float = 0.5
    slo_error_rate: float = 0.05
    slo_goodput_fraction: float = 0.5
    slo_step_time_factor: float = 2.0
    slo_config: Optional[str] = None
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
    # Phase-scheduled MoD compute ratio (Trainer.adjust_mod_capacity).
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
        if isinstance(self.mesh_axes, list):
            self.mesh_axes = tuple(self.mesh_axes)
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads
        if self.intermediate_size is None:
            # SwiGLU sizing: 8/3 * hidden, rounded up to a multiple of 128.
            raw = int(8 * self.hidden_size / 3)
            self.intermediate_size = ((raw + 127) // 128) * 128
        self.normalize_parallelism()
        self.validate()

    def normalize_parallelism(self) -> None:
        """The JAX normalize_parallelism (config.py:528-551): sequence
        parallelism rides ring attention; pipeline parallelism slices the
        scanned layer stack, and gradient accumulation folds into pipeline
        microbatches (the same memory effect, no extra bubbles), capped to
        a divisor of the batch."""
        if self.sequence_parallel_size > 1:
            self.use_ring_attention = True
        if self.pipeline_parallel_size > 1:
            self.scan_layers = True
            if self.gradient_accumulation_steps > 1:
                n_micro = (self.pipeline_microbatches
                           or self.pipeline_parallel_size)
                cand = min(n_micro * self.gradient_accumulation_steps,
                           self.batch_size)
                # Ends with cand dividing batch_size, or cand == n_micro
                # (whose divisibility validate() checks).
                while cand > n_micro and self.batch_size % cand:
                    cand -= 1
                self.pipeline_microbatches = cand
                self.gradient_accumulation_steps = 1

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
        if self.kv_cache_dtype not in ("bf16", "int8"):
            raise ValueError(f"invalid kv_cache_dtype {self.kv_cache_dtype}")
        if self.attention_backend not in ATTENTION_BACKENDS:
            raise ValueError(
                f"invalid attention_backend {self.attention_backend}"
            )
        if self.prefix_cache_pages < 0:
            raise ValueError(
                "prefix_cache_pages must be >= 0 (0 disables the prefix cache)"
            )
        if self.prefix_cache_tenant_quota < 0:
            raise ValueError(
                "prefix_cache_tenant_quota must be >= 0 (0 = unbounded)"
            )
        for name, ok in (
            ("router_probe_interval_s", self.router_probe_interval_s > 0),
            ("router_breaker_failures", self.router_breaker_failures >= 1),
            ("router_breaker_cooldown_s", self.router_breaker_cooldown_s > 0),
            ("router_max_failovers", self.router_max_failovers >= 0),
            ("router_hedge_budget", 0.0 <= self.router_hedge_budget <= 1.0),
            ("router_hedge_max_tokens", self.router_hedge_max_tokens >= 1),
            ("page_pull_timeout_s", self.page_pull_timeout_s > 0),
            ("page_share_max_inflight", self.page_share_max_inflight >= 1),
        ):
            if not ok:
                raise ValueError(f"invalid {name} {getattr(self, name)!r}")
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
        if self.slo_sample_interval_s <= 0:
            raise ValueError("slo_sample_interval_s must be positive")
        if self.slo_ring_points < 2:
            raise ValueError("slo_ring_points must be >= 2")
        if self.slo_max_series < 1:
            raise ValueError("slo_max_series must be >= 1")
        if not 0 < self.slo_fast_window_s < self.slo_slow_window_s:
            raise ValueError("slo windows must satisfy 0 < fast < slow")
        if self.slo_fast_burn < 1:
            raise ValueError("slo_fast_burn must be >= 1")
        if self.slo_slow_burn < 1:
            raise ValueError("slo_slow_burn must be >= 1")
        if not 0 < self.slo_budget <= 1:
            raise ValueError("slo_budget must be in (0, 1]")
        if self.slo_ttft_p95_s <= 0:
            raise ValueError("slo_ttft_p95_s must be positive")
        if self.slo_decode_p50_s <= 0:
            raise ValueError("slo_decode_p50_s must be positive")
        if not 0 < self.slo_error_rate <= 1:
            raise ValueError("slo_error_rate must be in (0, 1]")
        if not 0 < self.slo_goodput_fraction <= 1:
            raise ValueError("slo_goodput_fraction must be in (0, 1]")
        if self.slo_step_time_factor <= 1:
            raise ValueError("slo_step_time_factor must be > 1")
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
            self._validate_moe_mesh()
        if self.use_mod:
            if not 0.0 < self.mod_capacity_factor <= 1.0:
                raise ValueError("mod_capacity_factor must be in (0, 1]")
            if not self.mod_capacity_schedule or not all(
                    0.0 < c <= 1.0 for c in self.mod_capacity_schedule):
                raise ValueError(
                    f"mod_capacity_schedule entries must be in (0, 1] "
                    f"(got {self.mod_capacity_schedule})")
        self._validate_mesh()

    def _validate_moe_mesh(self) -> None:
        """The JAX validation of the MoE dispatches against the mesh
        (config.py:664-729)."""
        if self.moe_dispatch == "a2a":
            if self.expert_parallel_size <= 1:
                raise ValueError(
                    "moe_dispatch='a2a' requires an expert mesh axis "
                    "(expert_parallel_size > 1) — token routing needs "
                    "shards to route between; use 'gmm' on a single-"
                    "host/no-ep mesh")
            if self.expert_parallel_size % self.expert_dcn_size:
                raise ValueError(
                    f"expert_dcn_size ({self.expert_dcn_size}) must "
                    f"divide expert_parallel_size "
                    f"({self.expert_parallel_size})")
            if self.moe_a2a_overlap_chunks < 1:
                raise ValueError("moe_a2a_overlap_chunks must be >= 1")
        if self.expert_dcn_size < 1:
            raise ValueError("expert_dcn_size must be >= 1")
        if self.moe_dispatch in ("a2a", "gmm"):
            for name, size in (("pipeline", self.pipeline_parallel_size),
                               ("sequence", self.sequence_parallel_size)):
                if size != 1:
                    raise ValueError(
                        f"moe_dispatch='{self.moe_dispatch}' composes "
                        f"with data/fsdp/expert/tensor mesh axes only "
                        f"({name}_parallel_size={size}); use 'gather' or "
                        f"'sort' there")
            if (self.tensor_parallel_size > 1 and self.intermediate_size
                    % self.tensor_parallel_size):
                raise ValueError(
                    f"moe_dispatch='{self.moe_dispatch}' with tensor "
                    f"parallelism needs intermediate_size divisible by "
                    f"tensor_parallel_size ({self.intermediate_size} % "
                    f"{self.tensor_parallel_size})")

    def _validate_mesh(self) -> None:
        """The JAX validation of the mesh fields (config.py:743-842)."""
        if self.sequence_parallel_size > 1:
            if self.seq_length % self.sequence_parallel_size:
                raise ValueError(
                    "seq_length must divide over sequence_parallel_size")
            if not self.use_ring_attention:
                raise ValueError(
                    "sequence_parallel_size > 1 requires "
                    "use_ring_attention=True (without it every device "
                    "re-gathers the full sequence, defeating sequence "
                    "parallelism)")
        for axis in ("fsdp", "expert", "tensor", "sequence", "pipeline"):
            if getattr(self, f"{axis}_parallel_size") < 1:
                raise ValueError(f"{axis}_parallel_size must be >= 1")
        if self.pipeline_parallel_size > 1:
            if self.pipeline_schedule not in ("1f1b", "gpipe"):
                raise ValueError(
                    f"invalid pipeline_schedule {self.pipeline_schedule}")
            if self.num_layers % self.pipeline_parallel_size:
                raise ValueError(
                    "num_layers must divide evenly over pipeline stages")
            n_micro = self.pipeline_microbatches or self.pipeline_parallel_size
            if self.batch_size % n_micro:
                raise ValueError(
                    "batch_size must divide into pipeline_microbatches")
            if self.gradient_accumulation_steps != 1:
                raise ValueError(
                    "pipeline parallelism replaces grad accumulation: raise "
                    "pipeline_microbatches instead (same memory effect, no "
                    "extra pipeline bubbles)")
            if (self.expert_parallel_size > 1
                    or self.sequence_parallel_size > 1) and (
                    self.pipeline_schedule != "1f1b"):
                raise ValueError(
                    "pp x ep / pp x sp require pipeline_schedule='1f1b' "
                    "(manual expert/sequence parallelism lives in the 1F1B "
                    "region)")
            if (self.expert_parallel_size > 1
                    and (self.batch_size // n_micro)
                    % self.expert_parallel_size):
                raise ValueError(
                    "microbatch size must divide over expert_parallel_size "
                    "under pipeline parallelism (tokens shard over the "
                    "expert axis inside the pipe region)")
        if (self.expert_parallel_size > 1 and self.use_moe
                and self.num_experts % self.expert_parallel_size):
            raise ValueError(
                "num_experts must divide evenly over expert_parallel_size")
        if self.grad_reduce not in ("flat", "hierarchical"):
            raise ValueError(f"invalid grad_reduce {self.grad_reduce}")
        if self.gradient_dcn_size < 1:
            raise ValueError("gradient_dcn_size must be >= 1")
        if self.grad_reduce_overlap_chunks < 1:
            raise ValueError("grad_reduce_overlap_chunks must be >= 1")
        if not self.grad_reduce_bucket_mb > 0:
            raise ValueError("grad_reduce_bucket_mb must be positive")
        if self.grad_reduce_dcn_dtype not in (None, "bf16"):
            raise ValueError(
                f"invalid grad_reduce_dcn_dtype {self.grad_reduce_dcn_dtype}")
        if self.grad_reduce == "hierarchical":
            for name, size in (("pipeline", self.pipeline_parallel_size),
                               ("sequence", self.sequence_parallel_size)):
                if size != 1:
                    raise ValueError(
                        f"grad_reduce='hierarchical' composes with data/"
                        f"fsdp/expert/tensor mesh axes only ({name}_"
                        f"parallel_size={size}); use grad_reduce='flat' "
                        f"there")
            if self.use_moe and self.moe_dispatch in ("gmm", "a2a"):
                raise ValueError(
                    f"grad_reduce='hierarchical' cannot nest the "
                    f"moe_dispatch='{self.moe_dispatch}' shard_map inside "
                    "its manual (data, fsdp) region; use 'sort'/'gather'/"
                    "'einsum' dispatch or grad_reduce='flat'")

    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def to_dict(self) -> Dict[str, Any]:
        """The fields as JSON types (the tuples as lists), so a
        checkpoint's metadata reads back equal."""
        d = dataclasses.asdict(self)
        d["mod_capacity_schedule"] = list(self.mod_capacity_schedule)
        d["mesh_axes"] = list(self.mesh_axes)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        """A Config from a to_dict() of either side (a checkpoint's
        metadata): keys this copy does not know are dropped."""
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in known}
        if kw.get("attention_backend") in JAX_ONLY_BACKENDS:
            kw["attention_backend"] = "ragged"
        return cls(**kw)

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
        """Total parameter count (the JAX Config.estimate_parameters)."""
        h, v, L = self.hidden_size, self.vocab_size, self.num_layers
        inter = self.intermediate_size
        kv_dim = self.num_kv_heads * self.head_dim()
        embed = v * h if self.tie_word_embeddings else 2 * v * h
        attn = h * h + 2 * h * kv_dim + h * h  # q, k, v, o
        ffn_dense = 3 * h * inter  # gate, up, down
        total = embed + L * (attn + 2 * h) + h  # + norms, final norm
        moe_layers = self.num_moe_layers()
        total += (L - moe_layers) * ffn_dense
        total += moe_layers * (self.num_experts * ffn_dense
                               + h * self.num_experts)
        if self.use_mod:
            total += L * h  # MoD routers
        return total

    def estimate_active_parameters(self) -> int:
        """Per-token parameters: the MoE layers' top-k experts only."""
        total = self.estimate_parameters()
        if not self.use_moe:
            return total
        ffn_dense = 3 * self.hidden_size * self.intermediate_size
        return total - self.num_moe_layers() * (
            self.num_experts - self.moe_top_k) * ffn_dense

    def memory_estimate_gb(self) -> Dict[str, float]:
        """Rough device-memory estimate (the JAX Config's): parameters in
        the compute width, fp32 masters + Adam moments, activations of
        one micro-batch (batch_size / gradient_accumulation_steps)."""
        params = self.estimate_parameters()
        bytes_per = 2 if "bf16" in self.resolve_precision() else 4
        param_gb = params * bytes_per / 1e9
        opt_gb = params * (4 + 8) / 1e9
        micro = max(1, self.batch_size
                    // max(1, self.gradient_accumulation_steps))
        act_gb = (
            micro * self.seq_length * self.hidden_size * self.num_layers
            * bytes_per * (2 if not self.gradient_checkpointing else 0.25)
        ) / 1e9
        total = param_gb + opt_gb + act_gb
        return {
            "parameters_gb": round(param_gb, 3),
            "optimizer_gb": round(opt_gb, 3),
            "activations_gb": round(act_gb, 3),
            "total_gb": round(total, 3),
        }

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
            num_epochs=1,
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
    def debug_200m() -> Config:
        return Config(
            vocab_size=50304,
            hidden_size=768,
            num_layers=12,
            num_heads=12,
            num_kv_heads=4,
            seq_length=2048,
            batch_size=32,
            gradient_accumulation_steps=4,
            use_moe=False,
            use_mod=True,
            mod_capacity_factor=0.5,
            experiment_name="debug_200m",
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

    @staticmethod
    def moe_stress_test() -> Config:
        return Config(
            vocab_size=50304,
            hidden_size=512,
            num_layers=8,
            num_heads=8,
            num_kv_heads=4,
            seq_length=1024,
            batch_size=8,
            use_moe=True,
            num_experts=32,
            moe_top_k=2,
            capacity_factor=1.1,
            routing_noise_std=0.2,
            expert_parallel_size=1,
            experiment_name="moe_stress_test",
        )

    @staticmethod
    def b7() -> Config:
        return Config(
            vocab_size=50304,
            hidden_size=4096,
            num_layers=32,
            num_heads=32,
            num_kv_heads=8,
            seq_length=2048,
            batch_size=512,
            gradient_accumulation_steps=16,
            learning_rate=1.5e-4,
            use_moe=True,
            num_experts=8,
            moe_top_k=2,
            fsdp_parallel_size=8,
            expert_parallel_size=8,
            scan_layers=True,
            experiment_name="b7",
        )

    @staticmethod
    def b14() -> Config:
        return Config(
            vocab_size=50304,
            hidden_size=5120,
            num_layers=40,
            num_heads=40,
            num_kv_heads=8,
            seq_length=4096,
            batch_size=512,
            gradient_accumulation_steps=16,
            learning_rate=1.2e-4,
            use_moe=True,
            num_experts=8,
            moe_top_k=2,
            fsdp_parallel_size=16,
            expert_parallel_size=8,
            scan_layers=True,
            experiment_name="b14",
        )

    @staticmethod
    def b30() -> Config:
        return Config(
            vocab_size=50304,
            hidden_size=6656,
            num_layers=48,
            num_heads=52,
            num_kv_heads=13,
            seq_length=4096,
            batch_size=1024,
            gradient_accumulation_steps=32,
            learning_rate=1e-4,
            use_moe=True,
            num_experts=8,
            moe_top_k=2,
            fsdp_parallel_size=32,
            expert_parallel_size=8,
            scan_layers=True,
            experiment_name="b30",
        )

    @staticmethod
    def b50() -> Config:
        return Config(
            vocab_size=50304,
            hidden_size=8192,
            num_layers=48,
            num_heads=64,
            num_kv_heads=8,
            seq_length=4096,
            batch_size=1024,
            gradient_accumulation_steps=32,
            learning_rate=8e-5,
            use_moe=True,
            num_experts=16,
            moe_top_k=2,
            fsdp_parallel_size=32,
            expert_parallel_size=16,
            scan_layers=True,
            experiment_name="b50",
        )

    @staticmethod
    def b75() -> Config:
        return Config(
            vocab_size=50304,
            hidden_size=8192,
            num_layers=64,
            num_heads=64,
            num_kv_heads=8,
            seq_length=8192,
            batch_size=1024,
            gradient_accumulation_steps=32,
            learning_rate=7e-5,
            use_moe=True,
            num_experts=16,
            moe_top_k=2,
            fsdp_parallel_size=64,
            expert_parallel_size=16,
            use_ring_attention=True,
            sequence_parallel_size=1,
            scan_layers=True,
            experiment_name="b75",
        )

    @staticmethod
    def b100() -> Config:
        return Config(
            vocab_size=50304,
            hidden_size=10240,
            num_layers=64,
            num_heads=80,
            num_kv_heads=8,
            seq_length=8192,
            batch_size=2048,
            gradient_accumulation_steps=64,
            learning_rate=6e-5,
            use_moe=True,
            num_experts=32,
            moe_top_k=2,
            fsdp_parallel_size=64,
            expert_parallel_size=32,
            use_ring_attention=True,
            scan_layers=True,
            experiment_name="b100",
        )

    @staticmethod
    def b200() -> Config:
        return Config(
            vocab_size=50304,
            hidden_size=12288,
            num_layers=80,
            num_heads=96,
            num_kv_heads=8,
            seq_length=8192,
            batch_size=2048,
            gradient_accumulation_steps=64,
            learning_rate=5e-5,
            use_moe=True,
            num_experts=64,
            moe_top_k=2,
            fsdp_parallel_size=128,
            expert_parallel_size=64,
            use_ring_attention=True,
            scan_layers=True,
            experiment_name="b200",
        )

    @staticmethod
    def b300() -> Config:
        return Config(
            vocab_size=50304,
            hidden_size=16384,
            num_layers=80,
            num_heads=128,
            num_kv_heads=16,
            seq_length=8192,
            batch_size=4096,
            gradient_accumulation_steps=128,
            learning_rate=4e-5,
            use_moe=True,
            num_experts=64,
            moe_top_k=2,
            fsdp_parallel_size=128,
            expert_parallel_size=64,
            tensor_parallel_size=2,
            use_ring_attention=True,
            scan_layers=True,
            experiment_name="b300",
        )

    # The JAX package's 13 presets. The port's b1 keeps one card's share
    # of the JAX preset's batch and no fsdp axis (see b1); the others are
    # the JAX presets field for field, meshes included.
    _PRESETS = ("debug", "debug_200m", "debug_300m", "moe_stress_test",
                "b1", "b7", "b14", "b30", "b50", "b75", "b100", "b200",
                "b300")

    @classmethod
    def available(cls) -> List[str]:
        return list(cls._PRESETS)

    @classmethod
    def get_preset_info(cls) -> Dict[str, Dict[str, Any]]:
        """Comparison table across the port's presets (the JAX table's
        keys)."""
        info = {}
        for name in cls._PRESETS:
            c = cls.get(name)
            info[name] = {
                "hidden_size": c.hidden_size,
                "num_layers": c.num_layers,
                "total_params": c.estimate_parameters(),
                "active_params": c.estimate_active_parameters(),
                "use_moe": c.use_moe,
                "num_experts": c.num_experts if c.use_moe else 0,
                "use_mod": c.use_mod,
                "seq_length": c.seq_length,
                "memory_gb": c.memory_estimate_gb()["total_gb"],
            }
        return info

    @classmethod
    def get(cls, name: str, **overrides: Any) -> Config:
        if name not in cls._PRESETS:
            raise ValueError(
                f"Unknown preset: {name}. Available: {cls.available()}"
            )
        return dataclasses.replace(getattr(cls, name)(), **overrides)


class ConfigManager:
    """Config tuning against the detected hardware (the JAX
    ConfigManager's optimize_for_hardware, config.py:1361)."""

    @staticmethod
    def optimize_for_hardware(config: Config,
                              n_devices: Optional[int] = None) -> Config:
        """A mesh layout for the detected cards
        (utils/environment.get_device_info): experts sharded first
        (expert axis = gcd(num_experts, cards)), then tensor parallelism
        doubled while one card's share of ~12 bytes a parameter (fp32
        parameters and two moments) exceeds half its memory, the rest of
        the model-sharding ways as fsdp; data 1. The JAX rule, unchanged."""
        from luminaai_tpu_torch.utils.environment import get_device_info

        dev = get_device_info()
        n = n_devices or dev["device_count"]
        hbm_gb = dev.get("memory_per_device_gb") or 16.0
        updates: Dict[str, Any] = {}
        ep = 1
        if config.use_moe:
            ep = math.gcd(config.num_experts, n)
        remaining = n // ep
        updates["expert_parallel_size"] = ep
        updates["data_parallel_size"] = 1
        state_gb = config.estimate_parameters() * 12 / 1e9
        shards = max(1, remaining)
        tp = 1

        def per_chip_gb(tp_size: int) -> float:
            # ~75% of the state shards over fsdp, ~25% (embeddings, fused
            # projections) only over tensor ranks.
            fsdp = max(1, shards // tp_size)
            return state_gb * (0.75 / (tp_size * fsdp) + 0.25 / tp_size)

        while (
            per_chip_gb(tp) > hbm_gb * 0.5
            and tp * 2 <= shards
            and tp < 8
            and config.num_heads % (tp * 2) == 0
        ):
            tp *= 2
        updates["tensor_parallel_size"] = tp
        updates["fsdp_parallel_size"] = shards // tp
        return dataclasses.replace(config, **updates)


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
