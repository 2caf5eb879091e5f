"""Command line of the port: `python -m luminaai_tpu_torch` with the
subcommands serve, route, top, train, resume, data, finetune, evaluate,
chat, convert, report, diagnose, events, analyze, benchmark,
verify-checkpoint and presets.

  python -m luminaai_tpu_torch train --preset b1 --dense \\
      --data corpus.jsonl --packed --steps 1000 --output-dir runs/b1
  python -m luminaai_tpu_torch resume --preset b1 --dense \\
      --data corpus.jsonl --packed --steps 1000 --output-dir runs/b1
  python -m luminaai_tpu_torch serve --checkpoint runs/b1/checkpoints
  python -m luminaai_tpu_torch serve --preset b1 --moe-dispatch gmm --seed 0
  python -m luminaai_tpu_torch serve --preset b1 --dense --seed 0 \\
      --prefix-cache-pages 64 --secure --user U --password P
  python -m luminaai_tpu_torch top --url http://127.0.0.1:5001 --once
  python -m luminaai_tpu_torch serve --preset b1 --dense --replicas 2 \\
      --prefix-cache-pages 64
  python -m luminaai_tpu_torch route --replica http://127.0.0.1:5002 \\
      --replica http://127.0.0.1:5003 --port 5001
  python -m luminaai_tpu_torch train --preset debug --moe-dispatch gmm \\
      --synthetic --steps 3 --device cpu --output-dir /tmp/run
  python -m luminaai_tpu_torch train --config run.json --no-adaptive
  python -m luminaai_tpu_torch data blend --sources a=0.7=a/*.jsonl \\
      b=0.3=b/*.jsonl --out blend.jsonl
  python -m luminaai_tpu_torch finetune --checkpoint runs/b1 \\
      --data blend.jsonl --out ft --steps 100 --merge-out merged
  python -m luminaai_tpu_torch evaluate --checkpoint merged --data eval.jsonl
  python -m luminaai_tpu_torch chat --checkpoint runs/b1 --adapter \\
      ft/adapter.npz --prompt "hello"
  python -m luminaai_tpu_torch serve --preset b1 --dense --quantize int8 \\
      --kv-cache-dtype int8
  python -m luminaai_tpu_torch convert --checkpoint runs/b1 --to int8 \\
      --out runs/b1-int8
  python -m luminaai_tpu_torch train --preset b1 --dense --synthetic \\
      --steps 8 --profile-steps 2 --profile-start 4 --cost-analysis
  python -m luminaai_tpu_torch report training --dir runs/b1
  python -m luminaai_tpu_torch diagnose --preset b1
  python -m luminaai_tpu_torch events --stats runs/b1/checkpoints
  python -m luminaai_tpu_torch data acquire --in oasst_dump.jsonl \\
      --out data/oasst
  python -m luminaai_tpu_torch benchmark          # bench_torch.py, the card
  python -m luminaai_tpu_torch benchmark --ops    # bench_ops_torch.py

The presets are mixture-of-experts models, as in the JAX package; --dense
builds the preset's widths without experts. The model is built on the card
unless --device says otherwise.

Multi-GPU training: `torchrun --nproc-per-node N -m luminaai_tpu_torch
train ... --pp P --fsdp F --tp T --ep E --sp S` (the JAX mesh flags; --dp
-1 takes the ranks left over, --moe-dispatch a2a routes tokens over --ep,
--pp runs pipeline stages, parallel/pipeline.py) runs one process a card
over an NCCL process group (gloo with --device cpu); the Trainer builds
the model born sharded over the mesh (parallel/sharding.py) and only rank
0 logs and writes. The orchestrator and the OOM ladder run over the mesh
too: rank 0 decides, every rank applies.

`train` takes the JAX CLI's flags. It prints the diagnostics banner and a
time estimate at 40% of the card's dense bf16 peak (--quiet skips both);
--epochs sets num_epochs (the Trainer gets no steps_per_epoch, as in the
JAX CLI, so it runs --steps or the config's max_steps); --profile-steps N
captures a torch.profiler trace of N steps from --profile-start (default
3) into --profile-dir (default OUTPUT_DIR/profile) and attributes it per
subsystem (attribution.jsonl beside the trace); --cost-analysis counts the
first step's FLOPs and peak memory; --auto-hardware lays the mesh out for
the detected cards (ConfigManager.optimize_for_hardware); --no-moe,
--attention-window, --watchdog/--no-watchdog, --slo/--no-slo and
--slo-config set their Config fields. It runs under
the AdaptiveTrainingOrchestrator (training/orchestrator.py) unless given
--no-adaptive, as the JAX CLI does: the orchestrator watches the loss,
grad norm and router metrics at each log boundary and may change the LR,
weight decay, clip norm, MoE capacity, routing temperature, expert
dropout, the data curriculum or the number of experts, or roll back; the
summary then carries its `adaptive_decisions` and loss `trajectory`.
--config FILE.json (or .yaml) loads a Config saved by either package in
place of --preset; the other flags override it. --data is a
jsonl of conversations, or with --packed a jsonl of {"text": ...}
documents tokenized once into a memmap TokenCache under
OUTPUT_DIR/cache/ and packed into [batch, seq] rows; without --data it
warns and trains on the synthetic pattern batches. Checkpoints go to
OUTPUT_DIR/checkpoints; a run whose output dir holds one resumes from it
(`resume` is `train` with --resume). The first SIGTERM or SIGINT stops at
the next step boundary with a blocking emergency checkpoint and exit 75
(RESUMABLE_EXIT: rerun `resume` with the same flags); a second one exits
75 at once, saving only when it lands between two steps. `serve --checkpoint DIR` serves the
newest step under DIR whose sha256 manifest verifies, with the model
config saved in it.

The post-training subcommands take the JAX CLI's flags. `data` blends,
samples, converts, validates conversation files, trains a BPE vocabulary
and acquires OASST (`acquire --in DUMP` processes a local raw dump into
chat-format shards offline; without --in it tries the `datasets`
download and exits 1 where that or the network is missing).
`finetune` LoRA-tunes a checkpoint's fp32 weights with the base frozen
(training/adapters.py) and writes the adapter as OUT/adapter.npz + .json
(the JAX format); --merge-out also writes base + adapter as a params-only
checkpoint (step 0, with a manifest) that serve --checkpoint, chat and
evaluate read. `evaluate` prints the JAX CLI's JSON (eval_loss,
perplexity, tokens, batches) over a conversation file. `chat` answers
--prompt once or runs the REPL (inference/chat.py), optionally through
the security layer (--secure). finetune, evaluate and chat run on the
card unless given --device.

`serve` and `chat` take --quantize int8|int4 (int8: W8A8 products over
int8 weights; int4: packed storage dequantized at load) and
--kv-cache-dtype int8 (int8 KV codes and per-row scales, read by the
decode kernel), as the JAX CLI does. `convert --to scan|plain|int8`
rewrites a checkpoint's parameter layout (scanned or per-layer) or
exports it as an int8 serving checkpoint, which serve and chat load
as saved and finetune, evaluate and convert refuse; it quantizes on the
card unless given --device.

`serve` takes the JAX CLI's serving flags (serving/server.py; --trace-jax
mirrors every span as a torch.profiler range):
continuous batching (or --no-continuous micro-batching over
generate_batch), the radix prefix cache
(--prefix-cache-pages), telemetry and spans, SLOs, the hang watchdog,
deadlines, queue-depth shedding, tenant token buckets, --secure auth,
SIGTERM drain with a flight record in --flight-dir; --adapter merges a
LoRA adapter into --checkpoint's weights at load. --page-share ROUTER
joins a fleet's page sharing (serving/page_share.py): the replica reports
its cached prefix pages to the router and pulls a cold chain's pages from
the sibling that owns them. --replicas N runs the one-command fleet: N
`python -m luminaai_tpu_torch serve` children on port+1..port+N, wired to
share pages, behind the replica router (serving/router.py) on --port;
SIGTERM stops the router and drains the children. `route` runs that
router alone over --replica URLs. `serve --replicas` runs on the card
unless given --device cpu (the children inherit it); `route` and `top`
are host code and take no device. Bad --latency-buckets,
a non-positive --healthz-stale-after, and --secure with neither
--user/--password nor a users.json exit 2 before any model load. `top`
renders a server's /metrics/history and /slo or a router's /fleet table
(--url), a tshist dump, or the live ring.

`report training --dir RUN` and `report data FILES` write the JAX HTML
reports (utils/reporting.py). `diagnose` probes the card in a subprocess
(exit 1 without one, as JAX's exits when its backend probe fails), then
prints the host, card and topology, a timed all-reduce over a one-rank
mesh (or the job's), the expert all-to-all and gradient-reduce probes,
the recommended preset and whether --preset fits. `events` queries
flight-record dumps (flightrec-*.jsonl, or the directories holding them)
or the live ring: --type, --grep, --request, --since, --tail, --json,
--stats [--by tenant|request].
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import signal
import sys
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch.distributed as dist

from luminaai_tpu_torch.config import (
    Config,
    ConfigManager,
    ConfigPresets,
    resolve_device,
)

logger = logging.getLogger(__name__)

# Exit code for "stopped on a preemption signal with a resumable
# checkpoint banked" (EX_TEMPFAIL), distinct from success (0) and failure
# (1/2), so an orchestrator reschedules with `resume` instead of alerting.
RESUMABLE_EXIT = 75


def _moe_dispatch_flag(p: argparse.ArgumentParser,
                       a2a: bool = False) -> None:
    # The JAX train flag's choices (luminaai_tpu/cli.py); training also
    # takes the config's 'a2a' (an expert mesh axis, --ep).
    p.add_argument("--moe-dispatch", dest="moe_dispatch",
                   choices=["sort", "gather", "einsum", "gmm"]
                   + (["a2a"] if a2a else []),
                   help="MoE dispatch (default: the config's, 'sort'); "
                        "'gmm' runs the grouped-matmul kernel"
                        + ("; 'a2a' routes tokens to their experts' "
                           "ranks (needs --ep > 1)" if a2a else ""))


def _mesh_flags(t: argparse.ArgumentParser) -> None:
    # The JAX CLI's mesh flags (luminaai_tpu/cli.py:1812-1822). Under
    # torchrun (one process a card) the ranks lay out over these axes.
    t.add_argument("--dp", type=int, help="data axis (-1 = auto)")
    t.add_argument("--pp", type=int,
                   help="pipeline stages (1F1B schedule; pipeline_schedule="
                        "gpipe via --config)")
    t.add_argument("--fsdp", type=int, help="ZeRO-3-style shard ways")
    t.add_argument("--tp", type=int, help="tensor-parallel ways")
    t.add_argument("--ep", type=int, help="expert-parallel ways")
    t.add_argument("--sp", type=int, help="sequence/ring-attention ways")


def _model_overrides(args) -> Dict[str, object]:
    overrides: Dict[str, object] = {}
    if getattr(args, "dense", False):
        overrides["use_moe"] = False
    if args.moe_dispatch is not None:
        overrides["moe_dispatch"] = args.moe_dispatch
    # serve's quantizer flags (the engine applies them from the config).
    if getattr(args, "quantize", None) is not None:
        overrides["quantization_method"] = args.quantize
    if getattr(args, "kv_cache_dtype", None) is not None:
        overrides["kv_cache_dtype"] = args.kv_cache_dtype
    return overrides


def _quantizer_flags(p: argparse.ArgumentParser) -> None:
    # The JAX CLI's serve/chat flags (luminaai_tpu/cli.py).
    p.add_argument("--quantize", choices=["int8", "int4"],
                   help="serve int8 (W8A8 products) or int4 (packed "
                        "storage, dequantized at load) weights")
    p.add_argument("--kv-cache-dtype", dest="kv_cache_dtype",
                   choices=["bf16", "int8"],
                   help="decode KV cache storage (int8: codes + per-row "
                        "scales, about half the pool's bytes)")


def _serve_flags(sv: argparse.ArgumentParser) -> None:
    """`serve`'s flags: the JAX CLI's (luminaai_tpu/cli.py serve), plus
    the port's own model flags (--preset, --dense, --moe-dispatch,
    --weights, --seed, --device)."""
    sv.add_argument("--preset", default="b1",
                    choices=ConfigPresets.available())
    sv.add_argument("--dense", action="store_true",
                    help="serve the preset's widths without experts")
    _moe_dispatch_flag(sv)
    w = sv.add_mutually_exclusive_group()
    w.add_argument("--checkpoint",
                   help="training checkpoint dir (or its output dir): the "
                        "newest step whose manifest verifies, with its "
                        "saved config")
    w.add_argument("--weights", help=".npz of a flax parameter tree "
                                     "('/'-joined keys)")
    w.add_argument("--seed", type=int, default=None,
                   help="random weights from this seed (default: config "
                        "seed)")
    sv.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=5001)
    sv.add_argument("--secure", action="store_true",
                    help="token auth + rate limit + input validation")
    sv.add_argument("--user", help="bootstrap user (secure mode)")
    sv.add_argument("--password", help="bootstrap password (secure mode)")
    sv.add_argument("--adapter",
                    help="LoRA adapter (.npz from finetune) merged at load "
                         "(needs --checkpoint)")
    _quantizer_flags(sv)
    sv.add_argument("--num-slots", dest="num_slots", type=int, default=8,
                    help="continuous-batching KV pool slots "
                         "(concurrent decode lanes)")
    sv.add_argument("--page-size", dest="page_size", type=int, default=128,
                    help="KV pool page granularity in tokens")
    sv.add_argument("--prefill-chunk", dest="prefill_chunk_tokens",
                    type=int, default=None,
                    help="chunked-prefill chunk size in tokens (default: "
                         "the config's prefill_chunk_size; 0 disables)")
    sv.add_argument("--admission-window-ms", dest="admission_window_ms",
                    type=float, default=0.0,
                    help="wait this long for same-key peers before a "
                         "generation's first decode step")
    sv.add_argument("--no-continuous", dest="no_continuous",
                    action="store_true",
                    help="legacy run-to-completion micro-batching "
                         "(generate_batch)")
    sv.add_argument("--no-telemetry", dest="no_telemetry",
                    action="store_true",
                    help="skip hot-path metric recording (/metrics stays "
                         "up but latency histograms stay empty)")
    sv.add_argument("--trace-jsonl", dest="trace_jsonl",
                    help="write request/prefill/stream spans to this "
                         "JSONL file (tracing is off without it)")
    sv.add_argument("--trace-jax", dest="trace_jax", action="store_true",
                    help="mirror spans as torch.profiler record_function "
                         "ranges (visible when a profiler trace is "
                         "captured; the JAX flag's name)")
    sv.add_argument("--latency-buckets", dest="latency_buckets",
                    help="comma-separated histogram bucket bounds in "
                         "seconds (default spans 0.5ms..30s)")
    sv.add_argument("--request-timeout", dest="request_timeout_s",
                    type=float, default=None,
                    help="per-request deadline in seconds: overdue lanes "
                         "are evicted (504 / SSE error). A request's own "
                         "timeout_s can only shorten it. Default: none")
    sv.add_argument("--max-queue-depth", dest="max_queue_depth",
                    type=int, default=128,
                    help="admission queue cap: beyond it, generation "
                         "requests get 503 + Retry-After instead of "
                         "queuing unboundedly (0 disables shedding)")
    sv.add_argument("--drain-grace", dest="drain_grace_s", type=float,
                    default=30.0,
                    help="seconds SIGTERM waits for in-flight generations "
                         "to finish before shutdown")
    sv.add_argument("--flight-dir", dest="flight_dir",
                    help="where drain dumps the wide-event flight record "
                         "(flightrec-*.jsonl; default: the checkpoint "
                         "dir, else the working dir)")
    sv.add_argument("--prefix-cache-pages", dest="prefix_cache_pages",
                    type=int, default=None,
                    help="radix prefix cache budget in KV pool pages: "
                         "admissions splice cached shared-prefix pages "
                         "instead of re-prefilling them; LRU-evicted "
                         "beyond the budget (default: the config's "
                         "prefix_cache_pages; 0 disables)")
    sv.add_argument("--prefix-cache-tenant-quota",
                    dest="prefix_cache_tenant_quota", type=int,
                    default=None,
                    help="max cached pages one tenant may own (0 = "
                         "unbounded)")
    sv.add_argument("--tenant-rate", dest="tenant_rate_per_s",
                    type=float, default=None,
                    help="per-tenant token-bucket admission rate "
                         "(requests/sec refill; unset disables the "
                         "bucket gate)")
    sv.add_argument("--tenant-burst", dest="tenant_burst", type=int,
                    default=None,
                    help="per-tenant token-bucket burst capacity "
                         "(default: ~1s of --tenant-rate)")
    sv.add_argument("--no-watchdog", dest="no_watchdog",
                    action="store_true",
                    help="disable the decode-loop hang watchdog")
    sv.add_argument("--watchdog-abort", dest="watchdog_abort",
                    action="store_true",
                    help="exit 75 (resumable) after a confirmed decode "
                         "hang is dumped")
    sv.add_argument("--watchdog-k", dest="watchdog_k", type=float,
                    default=None,
                    help="robust threshold multiplier over the rolling "
                         "median decode step (default 10)")
    sv.add_argument("--watchdog-floor", dest="watchdog_floor", type=float,
                    default=None,
                    help="minimum stall seconds before the serving "
                         "watchdog can fire (default 30)")
    sv.add_argument("--no-slo", dest="no_slo", action="store_true",
                    help="disable the history ring + SLO burn-rate "
                         "engine (GET /slo and /metrics/history then "
                         "answer 404)")
    sv.add_argument("--slo-config", dest="slo_config",
                    help="JSON file REPLACING the default serve "
                         "objectives")
    sv.add_argument("--healthz-stale-after", dest="healthz_stale_after",
                    type=float, default=None,
                    help="seconds since the last decode tick (while "
                         "busy) after which /healthz reports "
                         "status=degraded (still 200)")
    sv.add_argument("--replicas", type=int, default=1,
                    help="spawn N replica serve processes (ports "
                         "port+1..port+N) fronted by the replica "
                         "router on --port")
    sv.add_argument("--page-share", dest="page_share", default=None,
                    help="router URL for cross-replica KV page sharing: "
                         "report cached prefix-chain keys there and "
                         "pull indexed pages from sibling replicas on "
                         "cold admissions (--replicas wires this)")
    sv.add_argument("--page-share-self", dest="page_share_self",
                    default=None,
                    help="this replica's own base URL, as siblings "
                         "should reach it for GET /pages/<key> "
                         "(default: http://HOST:PORT; --replicas sets it)")
    sv.add_argument("--page-pull-timeout", dest="page_pull_timeout",
                    type=float, default=None,
                    help="seconds one whole remote page pull may take "
                         "(lookup + transfers) before the admission "
                         "prefills locally (default: config "
                         "page_pull_timeout_s)")
    sv.add_argument("--page-share-max-inflight",
                    dest="page_share_max_inflight", type=int,
                    default=None,
                    help="max concurrent remote page pulls per replica "
                         "(default: config page_share_max_inflight); "
                         "further cold admissions prefill locally")


def _route_flags(rt: argparse.ArgumentParser) -> None:
    """`route`'s flags: the JAX CLI's (luminaai_tpu/cli.py route). The
    router is host code: no device flag."""
    rt.add_argument("--replica", dest="replicas", action="append",
                    required=True,
                    help="replica base URL (repeat per replica)")
    rt.add_argument("--host", default="127.0.0.1")
    rt.add_argument("--port", type=int, default=8000)
    rt.add_argument("--probe-interval", dest="probe_interval_s",
                    type=float, default=None,
                    help="seconds between /healthz+/slo probe rounds "
                         "(default: config router_probe_interval_s)")
    rt.add_argument("--breaker-failures", dest="breaker_failures",
                    type=int, default=None,
                    help="consecutive failures opening a replica's "
                         "circuit breaker (default: config)")
    rt.add_argument("--breaker-cooldown", dest="breaker_cooldown_s",
                    type=float, default=None,
                    help="seconds an open breaker waits before its "
                         "half-open probe (default: config)")
    rt.add_argument("--max-failovers", dest="max_failovers", type=int,
                    default=None,
                    help="extra candidates a failed dispatch may try "
                         "(capped at replicas-1; default: config)")
    rt.add_argument("--request-timeout", dest="request_timeout_s",
                    type=float, default=None,
                    help="per-attempt replica timeout in seconds")
    rt.add_argument("--hedge", action="store_true",
                    help="hedged dispatch: fire a second replica for "
                         "short non-stream requests after a p95-based "
                         "delay; first answer wins, loser cancelled")
    rt.add_argument("--hedge-delay", dest="hedge_delay_s", type=float,
                    default=None,
                    help="fixed hedge delay in seconds (default: the "
                         "fleet's observed p95)")
    rt.add_argument("--hedge-budget", dest="hedge_budget", type=float,
                    default=None,
                    help="max hedged fraction of non-stream traffic "
                         "(default: config router_hedge_budget)")
    rt.add_argument("--hedge-max-tokens", dest="hedge_max_tokens",
                    type=int, default=None,
                    help="only hedge requests asking for at most this "
                         "many new tokens (default: config)")
    rt.add_argument("--flight-dir", dest="flight_dir",
                    help="dump the router's wide-event flight record "
                         "here on exit (flightrec-*.jsonl)")


def _train_flags(t: argparse.ArgumentParser) -> None:
    t.add_argument("--preset", default="debug",
                   choices=ConfigPresets.available())
    t.add_argument("--config",
                   help="json/yaml config file (in place of --preset)")
    t.add_argument("--experiment", help="experiment name")
    t.add_argument("--adaptive", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="run under the adaptive orchestrator")
    t.add_argument("--dense", action="store_true",
                   help="train the preset's widths without experts")
    _moe_dispatch_flag(t, a2a=True)
    _mesh_flags(t)
    t.add_argument("--data",
                   help="jsonl conversations (or text with --packed)")
    t.add_argument("--eval-data", dest="eval_data")
    t.add_argument("--packed", action="store_true",
                   help="treat --data as base-training text jsonl")
    t.add_argument("--synthetic", action="store_true",
                   help="train on the synthetic pattern batches")
    t.add_argument("--tokenizer",
                   help="tokenizer backend: byte | bpe:PATH")
    t.add_argument("--output-dir", dest="output_dir")
    t.add_argument("--auto-epochs", action="store_true",
                   help="chinchilla-style step budget from dataset size")
    t.add_argument("--oom-protect", dest="oom_protect",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="backoff ladder on device OOM (microbatch split, "
                        "then batch halving)")
    t.add_argument("--lr", type=float)
    t.add_argument("--batch-size", dest="batch_size", type=int)
    t.add_argument("--seq-length", dest="seq_length", type=int)
    t.add_argument("--steps", type=int, help="max optimizer steps")
    t.add_argument("--grad-accum", dest="grad_accum", type=int)
    t.add_argument("--precision",
                   choices=["fp32", "bf16", "mixed_bf16", "auto"])
    t.add_argument("--no-flash", action="store_true")
    t.add_argument("--seed", type=int, default=None,
                   help="random initial weights from this seed (default: "
                        "config seed)")
    t.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    # The JAX CLI's (luminaai_tpu/cli.py:1728-1806, :1840).
    t.add_argument("--epochs", type=int,
                   help="num_epochs (recorded: the run takes --steps)")
    t.add_argument("--no-moe", dest="no_moe", action="store_true",
                   help="the preset without experts (as --dense)")
    t.add_argument("--attention-window", dest="attention_window", type=int,
                   help="sliding-window attention: attend to the last N "
                        "positions only")
    t.add_argument("--auto-hardware", dest="auto_hardware",
                   action="store_true",
                   help="lay the mesh out for the detected cards")
    t.add_argument("--quiet", action="store_true",
                   help="no diagnostics banner or time estimate")
    prof = t.add_argument_group("performance attribution")
    prof.add_argument("--profile-steps", dest="profile_steps", type=int,
                      help="capture a torch.profiler trace of N steps and "
                           "export the per-subsystem breakdown (gauges + "
                           "attribution.jsonl)")
    prof.add_argument("--profile-start", dest="profile_start", type=int,
                      help="first profiled step (default 3: after the "
                           "kernels' build)")
    prof.add_argument("--profile-dir", dest="profile_dir",
                      help="trace output dir (default OUTPUT_DIR/profile)")
    prof.add_argument("--cost-analysis", dest="cost_analysis",
                      action="store_true",
                      help="count the first step's FLOPs and peak memory "
                           "and cross-check them against 6NT")
    wd = t.add_argument_group("hang watchdog")
    wd.add_argument("--watchdog", dest="watchdog",
                    action=argparse.BooleanOptionalAction, default=None,
                    help="heartbeat hang detection over the train loop "
                         "(default: on)")
    wd.add_argument("--watchdog-abort", dest="watchdog_abort",
                    action="store_true",
                    help="exit 75 (resumable) after a confirmed hang is "
                         "dumped")
    wd.add_argument("--watchdog-k", dest="watchdog_k", type=float,
                    help="threshold multiplier over the rolling median "
                         "step window (default 10)")
    wd.add_argument("--watchdog-floor", dest="watchdog_floor", type=float,
                    help="minimum stall seconds before the watchdog fires "
                         "(default 30)")
    so = t.add_argument_group("SLO engine")
    so.add_argument("--slo", dest="slo",
                    action=argparse.BooleanOptionalAction, default=None,
                    help="windowed history ring + burn-rate alerts over the "
                         "default train objectives (default: on)")
    so.add_argument("--slo-config", dest="slo_config",
                    help="JSON file REPLACING the default objectives")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m luminaai_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    s = sub.add_parser("serve", help="HTTP chat/completion server")
    _serve_flags(s)
    rt = sub.add_parser(
        "route",
        help="data-plane router fronting N serve replicas: health "
             "probing, circuit breakers, affine dispatch + failover, "
             "hedged retries",
    )
    _route_flags(rt)

    tp = sub.add_parser(
        "top",
        help="live operator dashboard over the time-series ring "
             "(sparklines + SLO burn-rate table)",
    )
    tp.add_argument(
        "source", nargs="?",
        help="tshist-*.json history dump, or a directory holding them "
             "(e.g. a flight dir); default: this process's live ring",
    )
    tp.add_argument("--url",
                    help="attach to a serving process instead: polls "
                         "GET /metrics/history + /slo (e.g. "
                         "http://127.0.0.1:5001)")
    tp.add_argument("--once", action="store_true",
                    help="render one frame and exit (scripts, tests)")
    tp.add_argument("--json", action="store_true",
                    help="machine form of the frame (implies --once)")
    tp.add_argument("--interval", type=float, default=2.0,
                    help="refresh seconds for the live view (default 2)")
    tp.add_argument("--window", type=float, default=None,
                    help="restrict rows/tenant sums to the last N "
                         "seconds (default: everything retained)")
    tp.add_argument("--top-k", dest="top_k", type=int, default=4,
                    help="tenants shown in the top-K table (default 4)")

    t = sub.add_parser("train", help="train a model")
    _train_flags(t)
    t.add_argument("--resume", action="store_true")
    t.set_defaults(resume=False)
    r = sub.add_parser("resume", help="resume training from an output dir")
    _train_flags(r)
    r.set_defaults(resume=True)

    c = sub.add_parser("chat", help="interactive chat with a checkpoint")
    c.add_argument("--checkpoint", help="checkpoint dir (auto-discovers latest)")
    c.add_argument("--temperature", type=float, default=0.8)
    c.add_argument("--top-p", dest="top_p", type=float, default=0.9)
    c.add_argument("--max-new-tokens", dest="max_new_tokens", type=int,
                   default=256)
    c.add_argument("--prompt", help="one-shot prompt (non-interactive)")
    c.add_argument("--verbose", action="store_true")
    c.add_argument("--secure", action="store_true",
                   help="require auth; rate-limit and validate inputs")
    c.add_argument("--user")
    c.add_argument("--password")
    _quantizer_flags(c)
    c.add_argument("--adapter",
                   help="LoRA adapter (.npz from finetune) merged at load")
    c.add_argument("--device", default=None,
                   help="torch device (default: the card)")

    ft = sub.add_parser(
        "finetune", help="LoRA fine-tune against a frozen base checkpoint"
    )
    ft.add_argument("--checkpoint", required=True, help="base checkpoint dir")
    ft.add_argument("--data", required=True, help="jsonl conversations")
    ft.add_argument("--out", required=True, help="adapter output dir")
    ft.add_argument("--rank", type=int, default=8)
    ft.add_argument("--alpha", type=float, default=16.0)
    ft.add_argument("--lr", type=float, default=1e-4)
    ft.add_argument("--steps", type=int, default=100)
    ft.add_argument("--batch-size", dest="batch_size", type=int)
    ft.add_argument("--adapt-experts", action="store_true",
                    help="also adapt MoE expert kernels (per-expert factors)")
    ft.add_argument("--merge-out", dest="merge_out",
                    help="also export base+adapter as a merged checkpoint")
    ft.add_argument("--device", default=None,
                    help="torch device (default: the card)")

    d = sub.add_parser("data", help="dataset utilities")
    d.add_argument(
        "action",
        choices=["sample", "oasst", "validate", "acquire", "blend",
                 "train-tokenizer"],
    )
    d.add_argument("--sources", nargs="*",
                   help="blend: name=weight=glob triples")
    d.add_argument("--in", dest="inp")
    d.add_argument("--out")
    d.add_argument("--count", type=int, default=100)
    d.add_argument("--vocab-size", dest="vocab_size", type=int, default=4096,
                   help="train-tokenizer: target vocab (incl. 256 bytes)")
    d.add_argument("--max-per-file", dest="max_per_file", type=int,
                   default=None,
                   help="acquire: records per shard (default: the config's "
                        "max_conversations_per_file)")

    cv = sub.add_parser(
        "convert",
        help="convert checkpoint layout (scan <-> plain) or export an "
             "int8-quantized serving checkpoint",
    )
    cv.add_argument("--checkpoint", required=True)
    cv.add_argument("--to", choices=["scan", "plain", "int8"], required=True)
    cv.add_argument("--out", required=True)
    cv.add_argument("--device", default=None,
                    help="torch device the weights are converted on "
                         "(default: the card)")

    e = sub.add_parser("evaluate", help="perplexity/loss on a dataset")
    e.add_argument("--checkpoint", required=True)
    e.add_argument("--data", required=True, help="jsonl conversations")
    e.add_argument("--batch-size", dest="batch_size", type=int)
    e.add_argument("--max-batches", dest="max_batches", type=int, default=0)
    e.add_argument("--device", default=None,
                   help="torch device (default: the card)")

    vc = sub.add_parser(
        "verify-checkpoint",
        help="verify checkpoint integrity manifests (exit 1 on corruption)",
    )
    vc.add_argument("dir", help="checkpoint directory (holds <step>/ dirs)")
    vc.add_argument("--step", type=int, default=None,
                    help="verify one step only (default: every step)")
    vc.add_argument("--mode", choices=("full", "sample"), default="full",
                    help="full = hash every manifested file; sample = "
                         "sizes for all, hashes for a deterministic "
                         "subset")
    vc.add_argument("--json", action="store_true")

    ps = sub.add_parser("presets", help="list model presets")
    ps.add_argument("--json", action="store_true")

    rp = sub.add_parser("report", help="HTML reports")
    rp.add_argument("kind", choices=["training", "data"])
    rp.add_argument("--dir", help="experiment dir (training report)")
    rp.add_argument("--out")
    rp.add_argument("inputs", nargs="*", help="jsonl files (data report)")

    g = sub.add_parser("diagnose", help="system diagnostics")
    g.add_argument("--preset", help="also check whether PRESET fits")
    g.add_argument("--probe-timeout", type=int, default=90,
                   help="seconds before the card's probe counts as hung")

    an = sub.add_parser(
        "analyze",
        help="static analysis gate: AST lint rules + dispatch audits",
    )
    an.add_argument(
        "paths", nargs="*",
        help="files/dirs to lint (default: the luminaai_tpu_torch package)",
    )
    an.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    an.add_argument("--baseline",
                    help="JSON file of accepted legacy findings")
    an.add_argument("--write-baseline", metavar="FILE",
                    help="write current unwaived findings as a baseline")
    an.add_argument("--no-audit", action="store_true",
                    help="skip the dispatch auditors (lint only)")

    b = sub.add_parser("benchmark", help="run the bench harness")
    b.add_argument("--ops", action="store_true",
                   help="op-level microbenchmarks instead of train "
                        "throughput")

    ev = sub.add_parser(
        "events",
        help="query the wide-event flight recorder (flightrec-*.jsonl "
             "dumps or the live buffer)",
    )
    ev.add_argument(
        "paths", nargs="*",
        help="dump files or directories holding flightrec-*.jsonl "
             "(e.g. a checkpoint dir); default: the in-process buffer",
    )
    ev.add_argument("--tail", type=int, default=0,
                    help="show only the last N matching events")
    ev.add_argument("--grep", help="regex over the serialized record")
    ev.add_argument("--type", dest="etype",
                    help="only events of this type (e.g. request_admitted)")
    ev.add_argument("--request", dest="request_id",
                    help="only events of one request id: its full "
                         "lifecycle")
    ev.add_argument("--since", dest="since",
                    help="only events at/after this floor: an epoch "
                         "timestamp, or a duration ago with an s/m/h/d "
                         "suffix (e.g. 90s, 5m, 2h)")
    ev.add_argument("--stats", action="store_true",
                    help="summarize instead of listing: count + rate per "
                         "event type, first/last timestamps")
    ev.add_argument("--by", dest="stats_by", choices=("tenant", "request"),
                    help="with --stats: group the summary by identity, "
                         "biggest burners first")
    ev.add_argument("--json", action="store_true",
                    help="one JSON record per line; with --stats, the "
                         "summary as one JSON object")
    return p


def _synthetic_batches(cfg: Config, n_batches: int = 200, seed: int = 0):
    """Learnable repeating-pattern batches, drawn exactly as the JAX CLI's
    _synthetic_batches draws them: deterministic per (seed, epoch) from
    numpy RandomState(seed + epoch), inside a PrefetchLoader that passes
    the epoch, so a synthetic run resumes exactly too."""
    from luminaai_tpu_torch.data.dataset import PrefetchLoader

    def gen(epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.RandomState(seed + epoch)
        period = min(64, cfg.vocab_size - 2)
        for _ in range(n_batches):
            starts = rng.randint(0, 32, size=(cfg.batch_size, 1))
            seq = (starts + np.arange(cfg.seq_length)) % period + 1
            yield {"input_ids": seq.astype(np.int32)}

    return PrefetchLoader(gen, prefetch=2)


def make_data(cfg: Config, args):
    """(train_fn, eval_fn, dataset_tokens or None), as the JAX CLI's
    make_data builds them. Over a process group the packed loader yields
    this rank's rows; the others yield the global batch, whose rows the
    Trainer selects (parallel.train_step.shard_batch)."""
    from luminaai_tpu_torch.data.dataset import (
        ConversationDataset,
        PackedDataset,
        PrefetchLoader,
        build_text_cache,
        conversation_batches,
    )
    from luminaai_tpu_torch.data.tokenizer import ConversationTokenizer

    # --data wins; config train_data_path only when the file exists.
    cfg_path = cfg.train_data_path
    data_path = getattr(args, "data", None) or (
        cfg_path if cfg_path and Path(cfg_path).exists() else None
    )
    if getattr(args, "synthetic", False) or not data_path:
        if not getattr(args, "synthetic", False):
            logger.warning("no --data given; training on synthetic data")
        return _synthetic_batches(cfg), None, None

    tokenizer = ConversationTokenizer(
        model_name=cfg.tokenizer_name,
        assistant_loss_weight=cfg.assistant_loss_weight,
    )
    if tokenizer.vocab_size > cfg.vocab_size:
        logger.warning(
            "tokenizer vocab %d > model vocab_size %d; raising model "
            "vocab_size to match", tokenizer.vocab_size, cfg.vocab_size,
        )
        cfg.vocab_size = tokenizer.vocab_size
    if getattr(args, "packed", False):
        cache = build_text_cache(
            data_path,
            str(Path(cfg.output_dir) / "cache" / Path(data_path).stem),
            tokenizer,
        )
        # Over a process group each batch rank reads only its own
        # documents' rows (JAX cli.py:173-187).
        from luminaai_tpu_torch.parallel.mesh import batch_shard

        pi, pc = batch_shard(cfg) if dist.is_initialized() else (0, 1)
        ds = PackedDataset(
            cache, cfg.batch_size, cfg.seq_length,
            pad_id=tokenizer.pad_token_id, eos_id=tokenizer.eos_token_id,
            shuffle_seed=cfg.seed,
            use_native=cfg.use_native_dataloader,
            split_docs=cfg.pack_sequences,
            process_index=pi, process_count=pc,
        )
        return (
            PrefetchLoader(lambda: iter(ds), prefetch=max(1, cfg.num_workers),
                           source=ds),
            None, cache.n_tokens,
        )

    ds = ConversationDataset(data_path, tokenizer, cfg)
    tokens = None
    if not ds.streaming:
        tokens = sum(int(s["loss_mask"].size) for s in ds.samples)

    def train_fn(epoch: int):
        # A permutation per epoch NUMBER: a resumed run replays the same
        # per-epoch shuffles.
        return conversation_batches(ds, cfg.batch_size, seed=cfg.seed + epoch)

    eval_fn = None
    eval_path = getattr(args, "eval_data", None) or (
        cfg.eval_data_path
        if cfg.eval_data_path and Path(cfg.eval_data_path).exists()
        else None
    )
    if eval_path:
        eval_ds = ConversationDataset(eval_path, tokenizer, cfg, split="eval")

        def eval_fn():
            return conversation_batches(eval_ds, cfg.batch_size, seed=0)

    return (
        PrefetchLoader(train_fn, prefetch=max(1, cfg.num_workers)),
        eval_fn, tokens,
    )


def _train_config(args) -> Config:
    overrides = _model_overrides(args)
    for flag, field in [
        ("lr", "learning_rate"),
        ("batch_size", "batch_size"),
        ("seq_length", "seq_length"),
        ("steps", "max_steps"),
        ("precision", "precision"),
        ("output_dir", "output_dir"),
        ("grad_accum", "gradient_accumulation_steps"),
        ("tokenizer", "tokenizer_name"),
        ("experiment", "experiment_name"),
        ("dp", "data_parallel_size"),
        ("pp", "pipeline_parallel_size"),
        ("fsdp", "fsdp_parallel_size"),
        ("tp", "tensor_parallel_size"),
        ("ep", "expert_parallel_size"),
        ("sp", "sequence_parallel_size"),
        ("epochs", "num_epochs"),
        ("attention_window", "attention_window"),
        ("profile_dir", "profile_dir"),
        ("watchdog", "watchdog"),
        ("watchdog_k", "watchdog_k"),
        ("watchdog_floor", "watchdog_floor_s"),
        ("slo", "slo"),
        ("slo_config", "slo_config"),
    ]:
        val = getattr(args, flag)
        if val is not None:
            overrides[field] = val
    if args.no_flash:
        overrides["use_flash_attention"] = False
    if args.no_moe:
        overrides["use_moe"] = False
    if args.cost_analysis:
        overrides["compiled_cost_analysis"] = True
    if args.watchdog_abort:
        overrides["watchdog_abort"] = True
    # The profiling window (JAX cli.py:76-88): either flag alone opens it;
    # --profile-steps without --profile-start starts at step 3, past the
    # first step's kernel builds.
    if args.profile_start:
        overrides["profile_start_step"] = args.profile_start
    if args.profile_steps:
        overrides["profile_num_steps"] = args.profile_steps
    if args.config:
        cfg = dataclasses.replace(Config.load(args.config), **overrides)
    else:
        cfg = ConfigPresets.get(args.preset, **overrides)
    if args.profile_steps and not cfg.profile_start_step:
        cfg.profile_start_step = 3
    if args.auto_hardware:
        cfg = ConfigManager.optimize_for_hardware(cfg)
    return cfg


def _jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, float) and not np.isfinite(obj):
        return str(obj)
    return obj


def _signal_handler(trainer):
    """SIGINT/SIGTERM -> graceful preemption: the FIRST signal only arms
    `trainer.request_stop()`; the loop finishes the step in flight, runs a
    BLOCKING emergency save at the boundary, and `train` exits
    RESUMABLE_EXIT. A SECOND signal exits RESUMABLE_EXIT at once, after an
    emergency save when it lands between steps; inside a step the state
    is mid-update and the newest committed checkpoint stands
    (`Trainer.forced_save`)."""
    seen = {"n": 0}

    def handler(sig, frame):
        seen["n"] += 1
        if seen["n"] == 1:
            print(
                f"\nsignal {sig}: stopping at the next step boundary "
                "(emergency checkpoint + exact data cursor); signal again "
                "to exit at once", flush=True,
            )
            trainer.request_stop(f"signal {sig}")
            return
        print(f"\nsignal {sig} (again): exiting now", flush=True)
        try:
            if trainer.forced_save(f"signal {sig} forced"):
                print("state saved; exiting", flush=True)
            else:
                print("mid-step: resume from the newest committed "
                      "checkpoint", flush=True)
        except Exception as e:
            print(f"emergency save failed: {e}", flush=True)
        sys.exit(RESUMABLE_EXIT)

    return handler


def _install_signal_handlers(trainer) -> None:
    handler = _signal_handler(trainer)
    try:
        signal.signal(signal.SIGINT, handler)
        signal.signal(signal.SIGTERM, handler)
    except ValueError:  # pragma: no cover - not the main thread (tests)
        pass


def train(args) -> int:
    from luminaai_tpu_torch.training.orchestrator import (
        AdaptiveTrainingOrchestrator,
    )
    from luminaai_tpu_torch.training.scaler import ChinchillaScaler
    from luminaai_tpu_torch.training.trainer import Trainer

    resolve_device(args.device)  # the card, or raise before any output
    cfg = _train_config(args)
    # Under torchrun (RANK in the environment) or config.multihost: the
    # process group over the cards, one process a card (NCCL; gloo only
    # with --device cpu). Only rank 0 logs and writes.
    if "RANK" in os.environ or cfg.multihost:
        from luminaai_tpu_torch.parallel.mesh import initialize_multihost

        initialize_multihost(cfg, device=args.device)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    logging.getLogger().setLevel(cfg.log_level if rank0 else "WARNING")
    if rank0 and not args.quiet:
        from luminaai_tpu_torch.utils.environment import format_diagnostics

        print(format_diagnostics())
    if args.resume:
        cfg.auto_resume = True
    train_fn, eval_fn, dataset_tokens = make_data(cfg, args)

    if (args.auto_epochs or cfg.use_chinchilla_scaling) and dataset_tokens:
        # Chinchilla budget -> step count; an explicit --steps wins.
        plan = ChinchillaScaler(cfg).plan(dataset_tokens)
        if args.steps is None:
            cfg.max_steps = plan.recommended_steps
        print(
            f"chinchilla auto-budget: recommended_steps="
            f"{plan.recommended_steps} (dataset {dataset_tokens:,} tokens, "
            f"applied={'yes' if args.steps is None else 'no, --steps set'})"
        )

    steps = cfg.max_steps or 0
    if steps and rank0 and not args.quiet:
        _print_time_estimate(cfg, steps)

    # Provenance before the trainer is built, so a crash still leaves it;
    # a resume never overwrites the original run's record.
    meta_path = Path(cfg.output_dir) / "experiment_metadata.json"
    if rank0 and not (args.resume and meta_path.exists()):
        meta_path.parent.mkdir(parents=True, exist_ok=True)
        meta_path.write_text(json.dumps(_jsonable({
            "experiment_name": cfg.experiment_name,
            "config": cfg.to_dict(),
            "total_params": cfg.estimate_parameters(),
            "active_params": cfg.estimate_active_parameters(),
            "dataset_tokens": dataset_tokens,
            "planned_steps": cfg.max_steps,
            "argv": sys.argv[1:],
        }), indent=2))

    trainer = Trainer(cfg, train_data=train_fn, eval_data=eval_fn,
                      device=args.device, seed=args.seed)
    _install_signal_handlers(trainer)
    # Over a mesh too (JAX cli.py:324-329): rank 0 decides, every rank
    # applies, and an OOM on any rank sends every rank down the same rung.
    if args.adaptive:
        orchestrator = AdaptiveTrainingOrchestrator(trainer)
        summary = orchestrator.run(oom_protect=args.oom_protect)
    elif args.oom_protect:
        summary = trainer.train_with_oom_protection()
    else:
        summary = trainer.train()
    trainer.close()
    if not rank0:
        return RESUMABLE_EXIT if summary.get("preempted") else 0

    out = Path(cfg.output_dir) / "training_summary.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(_jsonable(summary), indent=2))
    final = summary.get("final_metrics", {})
    if summary.get("preempted"):
        print(
            f"training PREEMPTED at step {summary.get('final_step')}: "
            f"emergency checkpoint committed; rerun `resume` to continue "
            f"(exit {RESUMABLE_EXIT} = resumable)"
        )
        return RESUMABLE_EXIT
    print(
        f"training done: steps={summary.get('final_step')} "
        f"final_loss={final.get('loss', float('nan')):.4f}"
    )
    return 0


def _print_time_estimate(cfg: Config, steps: int) -> None:
    """A rough wall-clock estimate before committing compute (JAX
    cli.py:282): 6 x active parameters FLOPs a token at 40% of the
    cards' dense bf16 peak (device_peak_flops; a CPU planning figure
    without a card)."""
    from luminaai_tpu_torch.utils.environment import (
        device_peak_flops,
        get_device_info,
    )

    tok_per_step = cfg.batch_size * cfg.seq_length
    dev = get_device_info()
    est_tps = max(1.0, 0.4 * device_peak_flops() * dev["device_count"]
                  / (6 * max(cfg.estimate_active_parameters(), 1)))
    hours = steps * tok_per_step / est_tps / 3600
    print(
        f"estimated training time: ~{hours:.2f}h for {steps} steps "
        f"({tok_per_step * steps / 1e6:.0f}M tokens at ~{est_tps:,.0f} "
        "tok/s planning rate)"
    )


def build_serve_engine(args):
    """The engine `serve` runs: from --checkpoint (its saved config, the
    moe-dispatch flag applied; with --adapter, cast to bf16 and the LoRA
    adapter merged, as `chat --adapter` loads), --weights or --seed."""
    from luminaai_tpu_torch.inference.chat import build_engine

    if getattr(args, "adapter", None) is not None:
        from luminaai_tpu_torch.data.tokenizer import ConversationTokenizer
        from luminaai_tpu_torch.inference.chat import (
            load_model_for_inference,
        )
        from luminaai_tpu_torch.inference.generate import GenerationEngine

        model, config = load_model_for_inference(
            args.checkpoint, adapter=args.adapter, device=args.device,
            overrides=_model_overrides(args),
        )
        return GenerationEngine(
            model, ConversationTokenizer(model_name=config.tokenizer_name),
            config,
        )
    if args.checkpoint is not None:
        return build_engine(None, device=args.device,
                            checkpoint=args.checkpoint,
                            overrides=_model_overrides(args))
    config = ConfigPresets.get(args.preset, **_model_overrides(args))
    return build_engine(config, device=args.device, seed=args.seed,
                        weights=args.weights)


def _batch_to(batch: Dict[str, np.ndarray], device) -> Dict[str, Any]:
    """A numpy batch as tensors on `device` (input_ids as int64)."""
    import torch

    return {k: torch.as_tensor(v, dtype=torch.int64 if k == "input_ids"
                               else None, device=device)
            for k, v in batch.items()}


def data(args) -> int:
    from luminaai_tpu_torch.data.processing import (
        create_sample_data,
        process_oasst_data,
        validate_data_comprehensive,
    )
    from luminaai_tpu_torch.data.tokenizer import ConversationTokenizer

    if args.action == "sample":
        n = create_sample_data(args.out, num_conversations=args.count)
        print(f"wrote {n} sample conversations to {args.out}")
    elif args.action == "acquire":
        from luminaai_tpu_torch.data.acquisition import DatasetDownloader

        max_per_file = args.max_per_file
        if max_per_file is None:  # the flag overrides the config default
            max_per_file = Config().max_conversations_per_file
        dl = DatasetDownloader(args.out or "data/oasst",
                               max_records_per_file=max_per_file)
        if args.inp:  # the offline path: a local raw OASST dump
            print(json.dumps(_jsonable(dl.process_local_dump(args.inp)),
                             indent=2))
        elif not dl.download_and_process():
            print("download unavailable (offline?); pass --in DUMP.jsonl "
                  "to process a local raw dump", file=sys.stderr)
            return 1
    elif args.action == "train-tokenizer":
        # Offline BPE vocab training; --in takes conversation or
        # plain-text jsonl; --vocab-size is the target vocab.
        from luminaai_tpu_torch.data.bpe import train_bpe

        def texts():
            with open(args.inp) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        row = json.loads(line)
                    except json.JSONDecodeError:
                        yield line
                        continue
                    if isinstance(row, dict) and "messages" in row:
                        for m in row["messages"]:
                            yield str(m.get("content", ""))
                    elif isinstance(row, dict) and "text" in row:
                        yield str(row["text"])
                    else:
                        yield line

        tok = train_bpe(texts(), vocab_size=args.vocab_size)
        tok.save(args.out)
        sample = "The quick brown fox jumps over the lazy dog."
        n_bpe = len(tok.encode(sample))
        print(
            f"trained {tok.n_vocab}-token BPE -> {args.out} "
            f"(sample compression {len(sample.encode()) / max(n_bpe, 1):.2f} "
            "bytes/token; use with --tokenizer "
            f"bpe:{args.out})"
        )
    elif args.action == "oasst":
        n = process_oasst_data(args.inp, args.out)
        print(f"converted {n} conversations -> {args.out}")
    elif args.action == "validate":
        report = validate_data_comprehensive(
            args.inp, ConversationTokenizer()
        )
        print(json.dumps(_jsonable(report), indent=2))
    elif args.action == "blend":
        # Weighted multi-source blend -> one jsonl; --sources takes
        # name=weight=glob triples.
        import glob as globlib

        from luminaai_tpu_torch.data.multi_source import MultiSourcePipeline

        if not args.sources:
            print(
                "blend requires --sources name=weight=glob [...]",
                file=sys.stderr,
            )
            return 2
        weights: Dict[str, float] = {}
        shards: Dict[str, List[str]] = {}
        for spec in args.sources:
            try:
                name, weight, pattern = spec.split("=", 2)
                weights[name] = float(weight)
            except ValueError:
                print(f"bad --sources entry {spec!r}", file=sys.stderr)
                return 2
            shards[name] = sorted(globlib.glob(pattern))
            if not shards[name]:
                print(f"no files match {pattern!r}", file=sys.stderr)
                return 2
        if sum(weights.values()) <= 0:
            print("--sources weights must sum to > 0", file=sys.stderr)
            return 2
        pipeline = MultiSourcePipeline(ConversationTokenizer(), weights)
        out_path = args.out or "blended.jsonl"
        n = 0
        with open(out_path, "w", encoding="utf-8") as f:
            for rec in pipeline.iter_blended(shards):
                f.write(json.dumps(rec, ensure_ascii=False) + "\n")
                n += 1
        print(f"blended {n} documents from {len(shards)} sources -> {out_path}")
    return 0


def finetune(args) -> int:
    """LoRA fine-tuning against a frozen base checkpoint: optimizer state
    exists only for the adapter (training/adapters.py)."""
    import torch

    from luminaai_tpu_torch.convert import state_dict_to_flax
    from luminaai_tpu_torch.data.dataset import (
        ConversationDataset,
        conversation_batches,
    )
    from luminaai_tpu_torch.data.tokenizer import ConversationTokenizer
    from luminaai_tpu_torch.inference.chat import load_model_for_inference
    from luminaai_tpu_torch.training import adapters
    from luminaai_tpu_torch.training.checkpoint import save_params_checkpoint

    dev = resolve_device(args.device)
    # keep_master_dtype: train against (and maybe re-export) the fp32
    # masters; a bf16 round would swallow small deltas at merge time.
    try:
        model, cfg = load_model_for_inference(
            args.checkpoint, keep_master_dtype=True, device=dev)
    except ValueError as e:  # an int8 serving export: no fp32 masters
        print(str(e), file=sys.stderr)
        return 1
    if args.batch_size:
        cfg.batch_size = args.batch_size
    patterns = [r"attention/", r"ffn/"]
    if args.adapt_experts:
        patterns.append(r"moe/")
    spec = adapters.LoRASpec(
        rank=args.rank, alpha=args.alpha, target_patterns=tuple(patterns)
    )
    base = state_dict_to_flax(dict(model.named_parameters()), cfg)
    lora = adapters.init_lora_params(base, spec, cfg.seed)
    n_lora = adapters.lora_param_count(lora)
    base_n = cfg.estimate_parameters()
    print(
        f"adapter: rank {spec.rank}, {n_lora / 1e6:.2f}M "
        f"params ({n_lora / max(base_n, 1):.3%} of base, "
        f"{len(lora)} kernels)"
    )

    tx = adapters.adam(args.lr, cfg)
    step = adapters.make_lora_train_step(cfg, model, spec, tx)
    carry = (lora, tx.init(adapters.lora_leaves(lora)))

    tokenizer = ConversationTokenizer(
        assistant_loss_weight=cfg.assistant_loss_weight
    )
    ds = ConversationDataset(args.data, tokenizer, cfg, split="train")
    # The step's draws (MoE routing noise) per step index, as the JAX
    # CLI folds the step into its key.
    gen = torch.Generator(device=dev)
    done = 0
    last = float("nan")
    while done < args.steps:
        made_progress = False
        for batch in conversation_batches(ds, cfg.batch_size, seed=done):
            if done >= args.steps:
                break
            made_progress = True
            gen.manual_seed(cfg.seed * 1_000_003 + done)
            carry, metrics = step(carry, _batch_to(batch, dev), gen)
            done += 1
            if done % max(1, args.steps // 10) == 0 or done == 1:
                last = float(metrics["loss"])
                print(f"step {done}/{args.steps} loss {last:.4f}")
        if not made_progress:
            print(
                f"no batches: dataset has fewer than batch_size="
                f"{cfg.batch_size} usable samples (pass --batch-size)",
                file=sys.stderr,
            )
            return 1

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    adapters.save_lora(str(out / "adapter"), carry[0], spec)
    print(f"adapter saved: {out / 'adapter'}.npz (final loss {last:.4f})")

    if args.merge_out:
        with torch.no_grad():
            merged = adapters.merge_lora(base, carry[0], spec)
        mout = save_params_checkpoint(
            args.merge_out, 0, merged,
            {"config": cfg.to_dict(), "adapter": str(out / "adapter")},
        ).parent
        print(f"merged checkpoint: {mout}")
    return 0


def evaluate_model(model, cfg: Config, data_path: str,
                   max_batches: int = 0) -> Optional[Dict[str, Any]]:
    """Token-weighted CE over a conversation file's eval batches
    (batch cfg.batch_size, seed 0, drop_last=False): the no-cache
    forward and the fused LM-head CE, as the JAX `cmd_evaluate` body.
    None when no token is in the loss."""
    import torch

    from luminaai_tpu_torch.data.dataset import (
        ConversationDataset,
        conversation_batches,
    )
    from luminaai_tpu_torch.data.tokenizer import ConversationTokenizer
    from luminaai_tpu_torch.ops.fused import fused_lm_head_cross_entropy
    from luminaai_tpu_torch.parallel.train_step import (
        _shifted_mask_weights,
        shift_labels,
    )

    tokenizer = ConversationTokenizer(
        assistant_loss_weight=cfg.assistant_loss_weight
    )
    ds = ConversationDataset(data_path, tokenizer, cfg, split="eval")
    total_nll = total_tokens = 0.0
    n_batches = 0
    with torch.no_grad():
        for batch in conversation_batches(
            ds, cfg.batch_size, seed=0, drop_last=False
        ):
            if max_batches and n_batches >= max_batches:
                break
            batch = _batch_to(batch, model.device)
            hidden, _ = model(batch["input_ids"], deterministic=True,
                              return_hidden=True)
            labels, valid = shift_labels(batch)
            mask, weights = _shifted_mask_weights(batch, valid)
            _, m = fused_lm_head_cross_entropy(
                hidden, model.embedder.head_weight(), labels,
                loss_mask=mask, loss_weights=weights,
            )
            ntok = float(m["tokens_in_loss"])
            total_nll += float(m["ce_loss"]) * ntok
            total_tokens += ntok
            n_batches += 1
    if total_tokens == 0:
        return None
    loss = total_nll / total_tokens
    return {
        "eval_loss": round(loss, 4),
        "perplexity": round(float(np.exp(min(loss, 20.0))), 2),
        "tokens": int(total_tokens),
        "batches": n_batches,
    }


def evaluate(args) -> int:
    """Standalone perplexity/loss of a checkpoint (its bf16 serving
    weights) on a jsonl conversation file."""
    from luminaai_tpu_torch.inference.chat import load_model_for_inference

    resolve_device(args.device)
    try:
        model, cfg = load_model_for_inference(args.checkpoint,
                                              device=args.device)
    except ValueError as e:  # an int8 serving export
        print(str(e), file=sys.stderr)
        return 1
    if args.batch_size:
        cfg.batch_size = args.batch_size
    result = evaluate_model(model, cfg, args.data, args.max_batches)
    if result is None:
        print("no evaluable tokens found", file=sys.stderr)
        return 1
    print(json.dumps(result, indent=2))
    return 0


def chat(args) -> int:
    from luminaai_tpu_torch.inference.chat import ChatInterface

    resolve_device(args.device)
    session = ChatInterface(
        checkpoint_dir=args.checkpoint,
        quantize=args.quantize,
        adapter=args.adapter,
        kv_cache_dtype=args.kv_cache_dtype,
        device=args.device,
    )
    q = session.engine.quantization_info
    if q:
        if q.get("mode") == "int8_compute":
            print(
                f"serving with int8 COMPUTE quantization: "
                f"{q['quantized_leaves']} tensors run int8 products "
                f"(W8A8), {q['compression']:.2f}x smaller resident",
                file=sys.stderr,
            )
        else:
            print(
                f"serving with int{q['bits']} weight round-trip: "
                f"{q['quantized_leaves']} tensors, {q['compression']:.2f}x "
                "smaller at rest (the resident serving copy stays in the "
                "compute dtype)", file=sys.stderr,
            )
    # Generation defaults live on the engine's config; the flags
    # override them for the session.
    session.engine.config.temperature = args.temperature
    session.engine.config.top_p = args.top_p
    session.engine.config.max_new_tokens = args.max_new_tokens

    if args.secure:
        # Authenticated, rate-limited, input-validated path.
        from luminaai_tpu_torch.security import SecureChatSession

        secure = SecureChatSession(session.respond)
        user = args.user or "operator"
        password = args.password
        if password is None:
            import getpass

            password = getpass.getpass(f"password for {user}: ")
        if user not in secure.security.users:
            if not secure.create_user(user, password):
                print("could not create user (weak password?)", file=sys.stderr)
                return 2
        token = secure.authenticate(user, password)
        if token is None:
            print("authentication failed", file=sys.stderr)
            return 2
        if args.prompt:
            out = secure.secure_respond(args.prompt, token)
            if not out["ok"]:
                print(f"rejected: {out['error']}", file=sys.stderr)
                return 1
            print(out["reply"])
            return 0
        print("secure chat — 'quit' to exit")
        while True:  # pragma: no cover - interactive
            try:
                line = input("> ")
            except (EOFError, KeyboardInterrupt):
                break
            if line.strip().lower() in ("quit", "exit"):
                break
            out = secure.secure_respond(line, token)
            print(out["reply"] if out["ok"] else f"[{out['error']}]")
        return 0

    if args.prompt:
        reply, stats = session.respond(args.prompt)
        print(reply)
        if args.verbose:
            print(json.dumps(stats, indent=2), file=sys.stderr)
        return 0
    session.run()
    return 0


def convert(args) -> int:
    """Rewrite a checkpoint's parameter layout, per-layer <-> scanned (the
    same weights; convert.stack_scanned / unstack_scanned), or export it
    as an int8 serving checkpoint (quantize_for_serving: codes and scales
    in the compute layout, the manifest in its metadata; chat and serve
    load it with no re-quantization). As the JAX `convert`, the weights
    are read as the loader serves them (bf16), and an int8 export is
    refused as input. Writes step 0 of --out with a manifest."""
    import torch

    from luminaai_tpu_torch.convert import stack_scanned, unstack_scanned
    from luminaai_tpu_torch.inference.chat import load_checkpoint_flax
    from luminaai_tpu_torch.training.checkpoint import save_params_checkpoint

    dev = resolve_device(args.device)
    try:
        flat, cfg, _ = load_checkpoint_flax(args.checkpoint)
    except ValueError as e:
        # Quantizing quantized codes would write a silently wrong
        # checkpoint.
        print(str(e), file=sys.stderr)
        return 1
    params = {k: v.to(dev, torch.bfloat16) for k, v in flat.items()}
    is_scanned = any(k.startswith("scan_") for k in params)
    out = Path(args.out).absolute()
    meta = {"converted_from": str(args.checkpoint)}
    if args.to == "int8":
        from luminaai_tpu_torch.training.quantization import (
            export_quantized_tree,
            quantize_for_serving,
        )

        if is_scanned:
            print("convert --to plain first (int8 export needs the "
                  "per-layer layout)", file=sys.stderr)
            return 1
        qtree, info = quantize_for_serving(params)
        plain, manifest = export_quantized_tree(qtree)
        new_cfg = dataclasses.replace(cfg, quantization_method=None)
        save_params_checkpoint(out, 0, plain, {
            **meta, "config": new_cfg.to_dict(),
            "quantization": {"manifest": manifest, "info": info}})
        print(f"int8 serving export: {info['quantized_leaves']}/"
              f"{info['total_leaves']} tensors quantized, "
              f"{info['compression']:.2f}x smaller -> {out}")
        return 0
    if args.to == "scan" and is_scanned:
        print("checkpoint is already in scanned layout", file=sys.stderr)
        return 1
    if args.to == "plain" and not is_scanned:
        print("checkpoint is already in per-layer layout", file=sys.stderr)
        return 1
    if args.to == "scan":
        new_cfg = dataclasses.replace(cfg, scan_layers=True)
        new_params = stack_scanned(params, new_cfg)
    else:
        new_cfg = dataclasses.replace(cfg, scan_layers=False)
        new_params = unstack_scanned(params, cfg)
    save_params_checkpoint(out, 0, new_params,
                           {**meta, "config": new_cfg.to_dict()})
    n = sum(t.numel() for t in new_params.values())
    print(f"converted to {args.to} layout: {n / 1e6:.1f}M params -> {out}")
    return 0


def verify_checkpoint(args) -> int:
    """Per-step manifest report of a checkpoint directory. Exit 0 when
    every verified step is intact (unmanifested steps are reported, not
    failed), 1 on any corruption, 2 when the directory or step does not
    exist."""
    from luminaai_tpu_torch.training.checkpoint import verify_checkpoint_dir

    try:
        report = verify_checkpoint_dir(
            args.dir, step=args.step, mode=args.mode
        )
    except FileNotFoundError as e:
        print(str(e), file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(report, default=str))
    else:
        header = f"{'step':>8}  {'status':<14}{'files':>7}{'hashed':>8}  detail"
        print(f"checkpoint manifests under {report['root']} "
              f"(mode={report['mode']})")
        print(header)
        print("-" * len(header))
        for s, rep in sorted(report["steps"].items()):
            detail = ""
            if rep["mismatches"]:
                m = rep["mismatches"][0]
                detail = f"{m['file']}: {m['reason']}"
                if len(rep["mismatches"]) > 1:
                    detail += f" (+{len(rep['mismatches']) - 1} more)"
            print(
                f"{s:>8}  {rep['status']:<14}{rep['files']:>7}"
                f"{rep['hashed']:>8}  {detail}"
            )
        print(
            f"{len(report['ok'])} ok, {len(report['corrupt'])} corrupt, "
            f"{len(report['unmanifested'])} unmanifested"
        )
    if not report["steps"]:
        print(f"no checkpoint steps under {args.dir}", file=sys.stderr)
        return 2
    return 1 if report["corrupt"] else 0


def presets(args) -> int:
    info = ConfigPresets.get_preset_info()
    if args.json:
        print(json.dumps(info, indent=2))
        return 0
    header = (
        f"{'preset':<16}{'hidden':>8}{'layers':>8}{'params':>12}"
        f"{'active':>12}{'experts':>8}{'seq':>8}"
    )
    print(header)
    print("-" * len(header))
    for name, d in info.items():
        print(
            f"{name:<16}{d['hidden_size']:>8}{d['num_layers']:>8}"
            f"{d['total_params'] / 1e6:>10.0f}M{d['active_params'] / 1e6:>10.0f}M"
            f"{d['num_experts']:>8}{d['seq_length']:>8}"
        )
    return 0




def _serve_checks(args):
    """`serve`'s exit-2 checks (the JAX cmd_serve's, before any model
    load): --secure needs a bootstrap user or a users.json, a positive
    --healthz-stale-after, unique positive --latency-buckets; --adapter
    needs --checkpoint. Returns (error message | None, bootstrap,
    buckets)."""
    import math

    bootstrap = None
    if args.secure:
        if bool(args.user) != bool(args.password):
            return ("--secure bootstrap needs BOTH --user and --password",
                    None, None)
        if args.user:
            bootstrap = (args.user, args.password)
        elif not Path("users.json").exists():
            return ("--secure with no --user/--password and no existing "
                    "users.json: nobody could authenticate", None, None)
    if args.healthz_stale_after is not None and args.healthz_stale_after <= 0:
        return (f"--healthz-stale-after needs a positive number of "
                f"seconds, got {args.healthz_stale_after!r}", None, None)
    buckets = None
    if args.latency_buckets:
        try:
            buckets = sorted(
                float(b) for b in args.latency_buckets.split(",")
                if b.strip()
            )
            if (
                not buckets
                or any(not math.isfinite(b) or b <= 0 for b in buckets)
                or len(set(buckets)) != len(buckets)
            ):
                raise ValueError(args.latency_buckets)
        except ValueError:
            return (f"--latency-buckets needs unique positive "
                    f"comma-separated seconds, got "
                    f"{args.latency_buckets!r}", None, None)
    if args.adapter is not None and args.checkpoint is None:
        return "--adapter needs --checkpoint (the base it adapts)", None, None
    return None, bootstrap, buckets


def _fleet_child_argv(argv: List[str], port: int) -> List[str]:
    """A replica's serve argv from the parent's: the same flags, its own
    port, no --replicas (a replica must not recurse), and no page-share
    wiring (the fleet parent re-issues it, pointing at its own router)."""
    drop = ("--replicas", "--port", "--page-share", "--page-share-self")
    out: List[str] = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in drop:
            skip = True
            continue
        if any(a.startswith(d + "=") for d in drop):
            continue
        out.append(a)
    return out + ["--port", str(port)]


def _fleet_ready(procs, urls: List[str], timeout_s: float) -> Optional[str]:
    """Wait until every replica answers /healthz 200; the error (None when
    ready). A child that exits first fails the wait at once, not at the
    deadline."""
    import time

    from luminaai_tpu_torch.serving.router import wait_ready

    deadline = time.monotonic() + timeout_s
    while True:
        dead = [i for i, p in enumerate(procs) if p.poll() is not None]
        if dead:
            return (f"replica(s) {dead} exited with "
                    f"{[procs[i].returncode for i in dead]} before ready")
        try:
            wait_ready(urls, timeout_s=2.0)
            return None
        except TimeoutError as e:
            if time.monotonic() > deadline:
                return str(e)


def _serve_fleet(args) -> int:
    """`serve --replicas N`: N replica `python -m luminaai_tpu_torch serve`
    processes on port+1..port+N, each reporting its cached pages to the
    router and pulling from its siblings, and the replica router on
    --port once all of them answer /healthz. SIGTERM or ^C stops the
    router; the children then get SIGTERM and drain."""
    import subprocess

    from luminaai_tpu_torch.serving.router import Router

    resolve_device(args.device)  # the card, or raise before any child
    cfg = Config()
    n = args.replicas
    ports = [args.port + 1 + i for i in range(n)]
    urls = [f"http://{args.host}:{p}" for p in ports]
    router_url = f"http://{args.host}:{args.port}"
    argv = getattr(args, "argv", None)
    if argv is None:
        argv = sys.argv[1:]
    procs = []
    try:
        for p in ports:
            child = _fleet_child_argv(list(argv), p) + [
                "--page-share", router_url,
                "--page-share-self", f"http://{args.host}:{p}",
            ]
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "luminaai_tpu_torch"] + child
            ))
        print(f"fleet: {n} replica(s) on ports {ports}; waiting for "
              "warmup...", file=sys.stderr)
        err = _fleet_ready(procs, urls, timeout_s=600.0)
        if err is not None:
            print(f"fleet: {err}", file=sys.stderr)
            return 1
        router = Router(
            list(zip([f"r{i}" for i in range(n)], urls)),
            probe_interval_s=cfg.router_probe_interval_s,
            breaker_failures=cfg.router_breaker_failures,
            breaker_cooldown_s=cfg.router_breaker_cooldown_s,
            max_failovers=min(cfg.router_max_failovers, n - 1),
            hedge_budget=cfg.router_hedge_budget,
            hedge_max_tokens=cfg.router_hedge_max_tokens,
            flight_dir=args.flight_dir,
        )
        router.probe_all()
        router.start_probing()
        router.serve_forever(args.host, args.port)
        return 0
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for proc in procs:
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def serve(args) -> int:
    """HTTP chat/completion server over the port (serving/server.py);
    with --replicas N > 1, the one-command fleet (_serve_fleet)."""
    from luminaai_tpu_torch.serving.server import serve as run_server

    err, bootstrap, buckets = _serve_checks(args)
    if err is not None:
        print(err, file=sys.stderr)
        return 2
    if args.replicas > 1:
        return _serve_fleet(args)
    engine = build_serve_engine(args)
    run_server(
        engine,
        checkpoint=args.checkpoint,
        host=args.host,
        port=args.port,
        secure=args.secure,
        bootstrap_user=bootstrap,
        num_slots=args.num_slots,
        page_size=args.page_size,
        continuous=False if args.no_continuous else "auto",
        admission_window_ms=args.admission_window_ms,
        telemetry=not args.no_telemetry,
        trace_jsonl=args.trace_jsonl,
        trace_jax=args.trace_jax,
        latency_buckets=buckets,
        request_timeout_s=args.request_timeout_s,
        max_queue_depth=args.max_queue_depth,
        drain_grace_s=args.drain_grace_s,
        flight_dir=args.flight_dir,
        prefill_chunk_tokens=args.prefill_chunk_tokens,
        prefix_cache_pages=args.prefix_cache_pages,
        prefix_cache_tenant_quota=args.prefix_cache_tenant_quota,
        tenant_rate_per_s=args.tenant_rate_per_s,
        tenant_burst=args.tenant_burst,
        watchdog=not args.no_watchdog,
        watchdog_abort=args.watchdog_abort,
        watchdog_k=args.watchdog_k,
        watchdog_floor_s=args.watchdog_floor,
        slo=not args.no_slo,
        slo_config=args.slo_config,
        healthz_stale_after_s=args.healthz_stale_after,
        page_share=args.page_share,
        page_share_self_url=args.page_share_self,
        page_pull_timeout_s=args.page_pull_timeout,
        page_share_max_inflight=args.page_share_max_inflight,
    )
    return 0


def route(args) -> int:
    """Health-aware data-plane router over N serve replicas
    (serving/router.py): /healthz + /slo probing, per-replica circuit
    breakers, prefix-affine dispatch with bounded failover, shedding as
    a routing signal, optional hedging, and the fleet page index. Flag
    defaults come from the Config's router_* knobs."""
    from luminaai_tpu_torch.serving.router import run_router

    cfg = Config()

    def knob(name, default):
        v = getattr(args, name, None)
        return default if v is None else v

    urls = []
    for u in args.replicas:
        if "://" not in u:
            u = "http://" + u
        urls.append(u.rstrip("/"))
    if len(urls) != len(set(urls)):
        print("duplicate --replica urls", file=sys.stderr)
        return 2
    run_router(
        urls,
        host=args.host,
        port=args.port,
        probe_interval_s=knob("probe_interval_s",
                              cfg.router_probe_interval_s),
        breaker_failures=knob("breaker_failures",
                              cfg.router_breaker_failures),
        breaker_cooldown_s=knob("breaker_cooldown_s",
                                cfg.router_breaker_cooldown_s),
        max_failovers=min(knob("max_failovers", cfg.router_max_failovers),
                          len(urls) - 1),
        request_timeout_s=args.request_timeout_s,
        hedge=args.hedge,
        hedge_delay_s=args.hedge_delay_s,
        hedge_budget=knob("hedge_budget", cfg.router_hedge_budget),
        hedge_max_tokens=knob("hedge_max_tokens",
                              cfg.router_hedge_max_tokens),
        flight_dir=args.flight_dir,
    )
    return 0


def _top_sources(args):
    """Resolve `top`'s data source into (fetch_fn, source_label), as the
    JAX CLI does: fetch_fn() -> (history, slo or None, fleet or None).
    --url probes a replica's /metrics/history and /slo and a router's
    /fleet. Exit-2 errors raise SystemExit."""
    import os
    import urllib.error
    import urllib.request

    from luminaai_tpu_torch.monitoring.timeseries import (
        get_history,
        latest_history_dump,
        load_history,
    )

    if args.url:
        base = args.url.rstrip("/")

        def fetch_url():
            def _get(route):
                try:
                    with urllib.request.urlopen(
                        f"{base}{route}", timeout=10
                    ) as r:
                        return json.loads(r.read())
                except urllib.error.HTTPError:
                    return None

            # --url points at a replica (history + slo) or a router
            # (fleet table): a missing route 404s, which just means the
            # other kind of process.
            history = _get("/metrics/history")
            slo = _get("/slo")
            fleet = _get("/fleet")
            if history is None and fleet is None:
                print(
                    f"{base} answers neither /metrics/history (replica) "
                    "nor /fleet (router)", file=sys.stderr,
                )
                raise SystemExit(2)
            return history or {"series": {}}, slo, fleet

        return fetch_url, base
    if args.source:
        resolved = args.source
        if os.path.isdir(resolved):
            resolved = latest_history_dump(resolved)
            if resolved is None:
                print(f"no tshist-*.json dumps under {args.source}",
                      file=sys.stderr)
                raise SystemExit(2)
        if not os.path.exists(resolved):
            print(f"no such history dump: {resolved}", file=sys.stderr)
            raise SystemExit(2)

        def fetch_file(resolved=resolved):
            try:
                doc = load_history(resolved)
            except (ValueError, json.JSONDecodeError) as e:
                print(f"bad history dump {resolved}: {e}", file=sys.stderr)
                raise SystemExit(2)
            return doc, doc.get("slo"), None

        return fetch_file, resolved

    def fetch_live():
        ring = get_history()
        if ring is None:
            print(
                "no live history ring in this process (start a server "
                "with SLO on, or pass a dump path / --url)",
                file=sys.stderr,
            )
            raise SystemExit(2)
        # Read-only attach: the engine advertised on the ring supplies the
        # verdict table from its cached last evaluation.
        engine = getattr(ring, "slo", None)
        return (ring.snapshot(),
                engine.verdicts() if engine is not None else None, None)

    return fetch_live, "<live ring>"


def top(args) -> int:
    """Operator dashboard over the time-series ring (the JAX `top`):
    sparklines for throughput, latency and occupancy, per-tenant top-K,
    and the SLO burn-rate table, from --url (a server's /metrics/history
    and /slo, or a router's /fleet table), a tshist-*.json dump, or this
    process's live ring. --once renders one frame; --json prints the
    machine form."""
    from luminaai_tpu_torch.monitoring.top import render_top, top_payload

    try:
        fetch, source = _top_sources(args)
    except SystemExit as e:
        return int(e.code or 2)

    def frame():
        try:
            history, slo, fleet = fetch()
        except SystemExit:
            raise
        except Exception as e:
            print(f"fetch failed: {e}", file=sys.stderr)
            raise SystemExit(2)
        if args.json:
            return json.dumps(
                top_payload(history, slo, window_s=args.window,
                            top_k=args.top_k, fleet=fleet),
                default=str,
            )
        return render_top(history, slo, source=source,
                          window_s=args.window, top_k=args.top_k,
                          fleet=fleet)

    try:
        if args.once or args.json:
            print(frame())
            return 0
        import time as _time

        while True:  # refresh loop; ^C exits
            out = frame()
            sys.stdout.write("\x1b[2J\x1b[H" + out)
            sys.stdout.flush()
            _time.sleep(max(0.2, float(args.interval)))
    except KeyboardInterrupt:
        return 0
    except SystemExit as e:
        return int(e.code or 2)


def report(args) -> int:
    """HTML reports (utils/reporting.py)."""
    if args.kind == "training":
        from luminaai_tpu_torch.utils.reporting import create_training_report

        if not args.dir:
            print("report training requires --dir EXPERIMENT_DIR",
                  file=sys.stderr)
            return 2
        out = create_training_report(args.dir, args.out)
        if out is None:
            print(f"no training_summary.json under {args.dir}",
                  file=sys.stderr)
            return 1
        print(f"training report: {out}")
    else:
        from luminaai_tpu_torch.data.tokenizer import ConversationTokenizer
        from luminaai_tpu_torch.utils.reporting import (
            create_data_summary_report,
        )

        out = create_data_summary_report(
            args.inputs, ConversationTokenizer(),
            output_path=args.out or "data_summary_report.html",
        )
        print(f"data report: {out}")
    return 0


def _print_sections(title: Optional[str], sections: Dict[str, Any]) -> None:
    if title:
        print(f"[{title}]")
    for section, vals in sections.items():
        print(f"  {section}:")
        if isinstance(vals, dict):
            for k, v in vals.items():
                print(f"    {k}: {v}")
        else:
            print(f"    {vals}")


@contextlib.contextmanager
def _one_rank_group():
    """A one-rank NCCL process group on the card for diagnose's probes
    where none is initialized, destroyed after them (the job's own group
    otherwise)."""
    if dist.is_initialized():
        yield
        return
    import torch

    from luminaai_tpu_torch.parallel.mesh import current_device

    dev = current_device()
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{_free_tcp_port()}", rank=0,
        world_size=1, device_id=dev)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _free_tcp_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def diagnose(args) -> int:
    """The card's probe first, in a subprocess with a timeout (nothing here
    touches CUDA before it answers; exit 1 when it does not), then the
    host, card and topology, the connectivity and collective probes on a
    mesh (a one-rank NCCL group where none is up), and the recommendation."""
    from luminaai_tpu_torch.utils.environment import (
        check_config_fits,
        connectivity_probe,
        cuda_runtime_diagnostics,
        format_diagnostics,
        recommend_preset,
    )

    rt = cuda_runtime_diagnostics(probe_timeout=args.probe_timeout)
    print(format_diagnostics(
        include_accelerator=rt["backend"]["status"] == "ok"))
    _print_sections("runtime", rt)
    if rt["backend"]["status"] != "ok":
        return 1
    from luminaai_tpu_torch.parallel.expert_dispatch import expert_a2a_probe
    from luminaai_tpu_torch.parallel.grad_reduce import grad_reduce_probe
    from luminaai_tpu_torch.parallel.mesh import build_mesh

    with _one_rank_group():
        mesh = build_mesh(Config())
        conn = connectivity_probe(mesh=None)
        _print_sections("connectivity", conn)
        if not conn["visibility"]["visibility_ok"]:
            print("    WARNING: ranks != nodes x ranks per node: a node is "
                  "missing part of its cards")
        a2a = expert_a2a_probe(mesh)
        print("[expert-a2a]")
        print(f"  mesh: ep={a2a['ep']} (dcn={a2a['dcn']} x ici={a2a['ici']})")
        _print_sections(None, a2a["stages"])
        gr = grad_reduce_probe(mesh)
        print("[grad-reduce]")
        print(f"  mesh: world={gr['world']} (dcn={gr['dcn']} x "
              f"ici={gr['ici']})")
        _print_sections(None, gr["stages"])
    print(f"recommended preset for this fleet: {recommend_preset()}")
    if args.preset:
        fit = check_config_fits(ConfigPresets.get(args.preset))
        print(f"{args.preset}: {json.dumps(fit, indent=2)}")
    return 0


def events(args) -> int:
    """Query the wide-event flight recorder: dump files, directories (the
    newest flightrec-*.jsonl in each), or this process's live ring (JAX
    cmd_events, cli.py:1287)."""
    from luminaai_tpu_torch.monitoring.events import (
        events_stats,
        filter_events,
        format_event,
        get_recorder,
        latest_dump,
        parse_since,
        read_events,
    )

    if args.grep:
        import re

        try:
            re.compile(args.grep)
        except re.error as e:
            print(f"bad --grep regex {args.grep!r}: {e}", file=sys.stderr)
            return 2
    since = None
    if args.since:
        try:
            since = parse_since(args.since)
        except ValueError as e:
            print(f"bad --since value {args.since!r}: {e}", file=sys.stderr)
            return 2

    found: List[Dict[str, Any]] = []
    sources: List[str] = []
    for p in args.paths or []:
        path = p
        if os.path.isdir(p):
            path = latest_dump(p)
            if path is None:
                print(f"no flightrec-*.jsonl dumps under {p}",
                      file=sys.stderr)
                return 2
        if not os.path.exists(path):
            print(f"no such dump: {path}", file=sys.stderr)
            return 2
        found.extend(read_events(path))
        sources.append(path)
    if not args.paths:
        found = get_recorder().snapshot()
        sources.append("<live buffer>")

    total = len(found)
    found = filter_events(
        found, type=args.etype, grep=args.grep, request=args.request_id,
        since=since, tail=args.tail if args.tail else None,
    )
    if args.stats or args.stats_by:
        # --by implies --stats.
        stats = events_stats(found, by=args.stats_by)
        if args.json:
            print(json.dumps(stats, default=str))
        elif stats.get("by"):
            _print_grouped_stats(stats)
        else:
            print(
                f"{stats['total']} event(s) spanning "
                f"{stats['span_s']}s ({_fmt_ts(stats['first_ts'])} .. "
                f"{_fmt_ts(stats['last_ts'])})"
            )
            header = f"{'type':<24}{'count':>8}{'rate/s':>10}  first .. last"
            print(header)
            print("-" * len(header))
            for t, rec in stats["by_type"].items():
                rate = (f"{rec['rate_per_s']:.3f}"
                        if rec["rate_per_s"] is not None else "-")
                print(
                    f"{t:<24}{rec['count']:>8}{rate:>10}  "
                    f"{_fmt_ts(rec['first_ts'])} .. "
                    f"{_fmt_ts(rec['last_ts'])}"
                )
    elif args.json:
        for ev in found:
            print(json.dumps(ev, default=str))
    else:
        for ev in found:
            print(format_event(ev))
    print(f"{len(found)} event(s) shown of {total} from "
          f"{', '.join(sources)}", file=sys.stderr)
    return 0


def _fmt_ts(ts, fmt: str = "%Y-%m-%d %H:%M:%S") -> str:
    import time as _time

    if not isinstance(ts, (int, float)):
        return "?"
    return _time.strftime(fmt, _time.localtime(ts))


def _print_grouped_stats(stats: Dict[str, Any]) -> None:
    """`events --stats --by tenant|request`: biggest burners first, each
    with its rate and top event types (JAX cli.py:1401)."""
    print(
        f"{stats['total']} event(s) spanning {stats['span_s']}s, "
        f"grouped by {stats['by']}"
    )
    header = (
        f"{stats['by']:<26}{'count':>8}{'rate/s':>10}  "
        f"first .. last  top types"
    )
    print(header)
    print("-" * len(header))
    for key, rec in stats["groups"].items():
        rate = (f"{rec['rate_per_s']:.3f}"
                if rec["rate_per_s"] is not None else "-")
        top = ", ".join(
            f"{t}={n}" for t, n in sorted(
                rec["by_type"].items(), key=lambda kv: (-kv[1], kv[0])
            )[:3]
        )
        print(
            f"{key:<26}{rec['count']:>8}{rate:>10}  "
            f"{_fmt_ts(rec['first_ts'], '%H:%M:%S')} .. "
            f"{_fmt_ts(rec['last_ts'], '%H:%M:%S')}  {top}"
        )


def analyze(args) -> int:
    """The static analysis gate (JAX cli.py:1189 cmd_analyze). Source
    layer: analysis/astlint.py's rules with inline `# lumina: disable=LXnnn
    -- reason` waivers. Dispatch layer (skipped by --no-audit): the
    recompile surface, host-sync and sharding-coverage audits of
    analysis/trace_audit.py, run on the CPU. Exit 1 on any unwaived,
    unbaselined finding or failed audit."""
    import luminaai_tpu_torch
    from luminaai_tpu_torch.analysis import astlint

    pkg_dir = os.path.dirname(os.path.abspath(luminaai_tpu_torch.__file__))
    repo_root = os.path.dirname(pkg_dir)
    findings = astlint.lint_paths(args.paths or [pkg_dir], rel_to=repo_root)

    # Baseline: accepted legacy findings keyed rule:path with a count
    # (line numbers shift too easily to key on).
    accepted: Dict[str, int] = {}
    if args.baseline and os.path.exists(args.baseline):
        with open(args.baseline) as fh:
            accepted = dict(json.load(fh).get("accepted", {}))
    budget = dict(accepted)
    unwaived = []
    baselined = 0
    for f in findings:
        if f.waived:
            continue
        key = f"{f.rule}:{f.path}"
        if budget.get(key, 0) > 0:
            budget[key] -= 1
            f.baselined = True
            baselined += 1
            continue
        unwaived.append(f)

    if args.write_baseline:
        counts: Dict[str, int] = {}
        for f in findings:
            if not f.waived:
                key = f"{f.rule}:{f.path}"
                counts[key] = counts.get(key, 0) + 1
        with open(args.write_baseline, "w") as fh:
            json.dump({"accepted": counts}, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"baseline written: {args.write_baseline} "
              f"({sum(counts.values())} accepted finding(s))",
              file=sys.stderr)

    verdicts, audit_report = [], {}
    if not args.no_audit:
        from luminaai_tpu_torch.analysis.trace_audit import run_audits

        verdicts, audit_report = run_audits()
    failed_audits = [v.name for v in verdicts if not v.ok]
    exit_code = 1 if (unwaived or failed_audits) else 0

    if args.json:
        doc = astlint.findings_to_json(findings)
        doc["summary"]["baselined"] = baselined
        doc["summary"]["unwaived"] = len(unwaived)
        doc["audits"] = audit_report
        doc["audit_verdicts"] = [
            {"name": v.name, "ok": v.ok, "detail": v.detail}
            for v in verdicts
        ]
        doc["exit_code"] = exit_code
        print(json.dumps(_jsonable(doc), indent=2))
        return exit_code
    print(astlint.format_findings(findings))
    if baselined:
        print(f"baseline: {baselined} finding(s) accepted as legacy")
    for v in verdicts:
        print(f"audit {v.name}: {'ok' if v.ok else 'FAIL'}")
    for prog, rec in audit_report.get("recompile_surface", {}).get(
            "programs", {}).items():
        print(f"recompile surface [{prog}]: {rec['distinct_signatures']} "
              f"distinct signature(s) across {len(rec['variants'])} "
              "variant(s)")
    if exit_code:
        print(f"analyze: FAIL ({len(unwaived)} unwaived finding(s), "
              f"{len(failed_audits)} failed audit(s))", file=sys.stderr)
    else:
        print("analyze: clean")
    return exit_code


def benchmark(args) -> int:
    """Run the port's bench harness (JAX cli.py:433 cmd_benchmark):
    bench_torch.py, or bench_ops_torch.py with --ops, beside the package,
    in a subprocess; its exit code is returned (2 when it is missing).
    Either prints one JSON line, measured on the card."""
    import subprocess

    root = Path(__file__).resolve().parent.parent
    bench = root / ("bench_ops_torch.py" if args.ops else "bench_torch.py")
    if not bench.exists():
        print(f"benchmark harness not found: {bench}", file=sys.stderr)
        return 2
    return subprocess.call([sys.executable, str(bench)])


COMMANDS = {
    "analyze": analyze,
    "benchmark": benchmark,
    "serve": serve,
    "route": route,
    "top": top,
    "data": data,
    "finetune": finetune,
    "evaluate": evaluate,
    "chat": chat,
    "convert": convert,
    "verify-checkpoint": verify_checkpoint,
    "presets": presets,
    "report": report,
    "diagnose": diagnose,
    "events": events,
}


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    # The argv a `serve --replicas` parent rebuilds its children's from.
    args.argv = list(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(level=logging.INFO)
    if args.command in ("train", "resume"):
        return train(args)
    return COMMANDS[args.command](args)
