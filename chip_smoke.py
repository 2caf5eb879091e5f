#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (luminaai_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. build   every CUDA kernel of the port from the checkout's sources
             (one nvcc per source, started together);
  2. kernels hold each kernel against its plain PyTorch version: the
             decode kernel (B5) at the serving shapes and at a group of
             16 q heads per kv head; the flash-attention forward and
             backward kernels (B1-B3) at the training shapes (causal), a
             window-512 case, a non-causal case, a GQA group of 1 at
             head_dim 64, and the shapes the JAX gate admits that the
             first kernels refused (head_dim 192, 320 and 512, S 200, a
             group of 3), and B1-B3 at the flagship MoE shape (head_dim
             64, q [16, 2048, 16, 64]), at debug_200m's (q [8, 2048,
             12, 64] over 4 kv heads, a group of 3) and at groups that
             do not divide 128 rows (b14's 5 at head_dim 128, 6 at 64):
             B2 on the wgmma kernel at every head_dim up to 256; B5 also at head_dim 576 and at the
             split-KV kernel's share boundaries; the grouped matmul (B4a
             gmm with and without transpose_rhs, B4b tgmm) at the b1
             decode and flagship training shapes, with an empty group and
             a tail that must stay exactly zero, and at the flagship shape
             with 9 experts and with two of 8 groups empty; time kernel / plain /
             library call at every shape, and compute the least time the
             card could take and each kernel's share of it; log which CUDA
             kernel each flash call took (torch.profiler) and require the
             wgmma B1-B3 kernels at every head_dim up to 256;
  3. serve   the b1-width dense model (16 layers, hidden 2048, seeded
             weights) through the port's ContinuousScheduler +
             StepwiseDecoder behind its HTTP server: first-decode-step
             logits with the kernel vs the plain version, then concurrent
             POST /v1/generate requests; the kernel must have launched
             exactly decode steps x layers times;
  4. serve   b1 with its 8 experts (moe_dispatch="gmm", bf16) at
     MoE     SERVE_MOE_LAYERS of its 16 layers: first-decode-step logits
             with B4a vs the plain gmm, a profiled decode step, 8
             concurrent requests with B4a launched exactly 2 x layers x
             (decode steps + prefill forwards);
  5. train   the b1 dense widths at B1_TRAIN_LAYERS of its 16 layers
             through the port's Trainer (what `python -m
             luminaai_tpu_torch train --preset b1 --dense --synthetic`
             runs): batch 16 x 2048, accumulation 8, remat per block,
             seeded fp32 weights, TRAIN_STEPS optimizer steps on the
             synthetic batches. The first step's loss and grad norm with
             the kernels vs the plain attention; every loss and grad norm
             finite, the loss falling, and the kernels launched exactly
             B1 = 2 x layers x 8 per step (forward and its recompute),
             B2 = B3 = layers x 8 per step; step time, tokens/s, model-
             FLOPs share and the card's busy time of one profiled step;
  6. train   bench.py's flagship MoE widths (vocab 32768, hidden 1024, 8
     MoE     experts top-2) at FLAGSHIP_TRAIN_LAYERS of its 10 layers,
             with gmm dispatch and bf16 RoPE: TRAIN_STEPS steps through
             Trainer, the first against the plain gmm (routing noise
             reseeded identically), exact launches per step B1 2 x layers,
             B2 = B3 layers, B4a 6 and B4b 2 a layer, a falling loss, step
             time, tokens/s, model-FLOPs share (active parameters), peak
             memory and the router metrics.
  7. runtime the training runtime through the port's CLI, in child
             processes (this script with --runtime-child, which runs the
             CLI's main and records each step), at the b1 dense widths
             and 2 of its 16 layers (`train --config`; batch 8 x 2048, no
             accumulation): a JSONL text corpus
             written from a seed and packed through a TokenCache with the
             native packer; run A `train --data --packed --steps 6`
             (exit 0) and beside it run B the same, SIGTERM once its log
             shows step 2 (exit 75, emergency checkpoint committed at its
             step boundary); `resume` of B to step 6 (exit 0). Every step's
             packed batch and loss of B equal A's bitwise, and so do the
             final parameters (hashes of both checkpoints); B1 == 8 and
             B2 == B3 == 4 launches per step; the native packer ran;
             csrc/ holds no atomics. Then `serve --checkpoint A` (the
             CLI's engine builder): its first decode step's logits equal
             those of an engine built from run A's final in-memory
             weights bitwise, and 8 concurrent requests through the
             server launch B5 decode steps x 4 times. Step time,
             tokens/s, the goodput split, each save's and restore's
             seconds and GB, and the disk at the start; the runs and
             checkpoints are deleted at the end. (The CLI's `train` runs
             under the adaptive orchestrator: at b1's health-check
             interval no decision fires in 6 steps, and the summaries
             carry `adaptive_decisions` (empty) and `trajectory`.)
  8. adaptive the flagship MoE of phase 6 at ADAPTIVE_LAYERS of its 10
             layers, trained in-process under
             AdaptiveTrainingOrchestrator(trainer).run() from phase 7's
             corpus, packed: one decision of each MoE-path kind injected
             through the orchestrator's _execute at fixed steps (LR x 0.5,
             weight decay x 2, clip, temperature, capacity, expert dropout
             0.1 then 0, curriculum 0.6, add_expert 8 -> 9, prune of the
             least-loaded expert 9 -> 8, rollback to the prune's forced
             save, two more steps). Each decision applied, no
             "intervention ... failed" record, exact B1-B4 launches and a
             finite loss in every step, the LR override holding; the steps
             after expert dropout, add, prune and the rollback against the
             same step through the plain gmm; the optimizer count equal to
             the step after each evolution; the rolled-back parameters
             bitwise those of the forced save. Steady and post-
             intervention step times, E over the run, saves and restore,
             the goodput split, the decisions.
  9. post-   the post-training path through the CLI from phase 7's run A
     training checkpoint (run before phase 8, with run B deleted first):
             in this process `data sample` twice and `data blend`
             (the blend equal to the same blend through the pipeline);
             then in one runtime child, in sequence, `finetune` (LoRA
             rank 8, 6 steps, batch 8 x 2048, --merge-out): exact
             launches per step B1 8, B2 = B3 4 (the
             remat recompute), the first step's loss and adapter grad norm
             within LOSS_RTOL / GRAD_NORM_RTOL of the plain attention's,
             finite losses, the base parameters bitwise unchanged, the
             adapter's b factors non-zero, the merged checkpoint's
             manifest verified; `evaluate` of the base and of the merged
             checkpoint (4 batches, B1 4 per batch, the same tokens and
             batches; the merged eval_loss within 1e-5 of an in-memory
             merge evaluated here); `chat --adapter --prompt` (a reply, B5
             == decode steps x 4, the first decode step's logits through
             B5 within LOGIT_RTOL of the plain attention, generate_stream
             == generate at a seed); B5 at one lane timed beside SDPA.
             After phase 8: `finetune --adapt-experts --steps 3` on its
             newest flagship MoE checkpoint (exact B1-B4 launches per
             step, finite losses, the base unchanged). Step ms, tokens/s,
             adapter parameters, peak memory, evaluate tokens/s, chat
             prefill ms and decode tokens/s, each with the card's name
             and power limit.
 10. serving the serving plane, run after phase 3 on its engine: in
     plane   process, a prefix-cache hit's first decode step against the
             same request decoded cold (1e-2 x max|logit|) and B5's global
             page table against its plain version, timed at that shape;
             then `python -m luminaai_tpu_torch serve --preset b1 --dense
             --seed 0` in three child processes (this script with
             --serve-child, which runs the CLI's main and answers the
             kernels' launch counters on a control port), each with 8
             slots x 2048 rows in 128-row pages, --secure, a tenant bucket
             (20/s, burst 16) and a queue depth of 8: the full server with
             --prefix-cache-pages 64, the same with --no-telemetry
             --no-slo --no-watchdog, and one with the cache off. On the
             full one: /healthz 503 then 200; 401 without a token; a 429
             from a second account's bucket; 503 + Retry-After with 8
             lanes busy and 8 queued; 504 past a deadline; 16 chat
             requests sharing a 1536-character system prompt (12 full
             pages), the first alone, then 8 and 7 at once, streamed:
             prefix hits 15 x 12 pages exactly, B5 decode steps x 16, all
             through the global table; the same traffic on the bare
             server in turns and on the cache-off server (TTFT); SSE equal to
             JSON; a speculative request against greedy (equal up to a
             near-tie); /metrics parsed with the JAX server's serving
             families, /slo, /metrics/history and `top --url`; SIGTERM
             with 4 requests in flight (all 200, exit 0, a flight record).
             In process, --no-continuous (MicroBatcher, one batch of 8)
             against the continuous server, up to a near-tie. With
             phase 4's experts: 8 requests through a server with the
             prefix cache, B4a launched exactly 2 x layers x (decode steps
             + prefill forwards). TTFT p50/p95 with and without the cache,
             host ms a decode tick (the step and its bookkeeping) of the
             full and the bare server, tokens/s.
 11. train_  bench.py's flagship_tuned (phase 6's widths and depth with
     tuned   the save_attn remat policy and bf16 Adam mu) through Trainer,
             6 steps: the first against the plain attention and gmm, B1
             exactly once a layer a step (phase 6: twice), B2 = B3 once,
             B4a 6 and B4b 2 a MoE layer; step time, peak memory and the
             optimizer's bytes by dtype beside phase 6's; then 3 steps
             with int8 Adam moments.
 12. mod     `train --preset debug_200m --synthetic` in process at
             MOD_TRAIN_LAYERS of its 12 layers (mixture of depths at
             capacity 0.5), 6 steps: the first against the plain
             attention, B1 2 x layers x 4 and B2 = B3 layers x 4 a step,
             the kernels the profiler names, mod_compute_ratio 0.5; one
             mod_capacity decision (0.5 -> 0.3) through the
             orchestrator's _execute and the step after it against the
             plain attention; 3 steps of the hybrid MoE+MoD model (8
             experts top-2 gmm on every third layer) with exact B4a/B4b
             launches; `serve --preset debug_200m` in process, 8
             requests, B5 = decode steps x 12, the first decode step
             against the plain attention.
 13. fleet   two `serve --preset b1 --dense --seed 0 --prefix-cache-pages
             64 --page-share ROUTER` replicas (--serve-child, B5's
             counters readable) behind a `route` child over both: the
             router's /healthz 200 and /fleet over both, `top --url
             ROUTER` renders the fleet table; a chat request sharing a
             1536-character system prompt prefills cold on its affine
             replica A through the router, A's flush reports the chain's
             12 keys to the router's page index; the same request on B
             pulls those 12 pages from A (LPG1, 4 MiB each), decodes A's
             tokens, B's GET /pages/<key> bytes equal A's, and a repeat
             on B is a local hit; the longest token gap of a stream B
             decodes while it pulls another chain of A's (the pull
             holds the scheduler's worker); B5 decode steps x 16 on each
             replica,
             all global; A SIGKILLed with 8 non-stream requests in
             flight through the router: its breaker open within one
             probe round, every request 200, /healthz degraded, no
             lookup naming A; `serve --replicas 2` as one command
             answers through its router and exits 0 on SIGTERM with both
             replicas gone. TTFT of B's remote-hit admission against a
             cold prompt of the same length, the pull's ms and MiB/s,
             export and import ms a page (in process).

 14. quant   quantized serving, b1 dense at 16 layers: `serve --preset b1
             --dense --quantize int8 --kv-cache-dtype int8
             --prefix-cache-pages 64` (the CLI's engine builder, served
             in process): the engine's weight and KV pool bytes against
             phase 1's bf16 engine (same seed), the first decode step
             through B5-int8 against the plain version (LOGIT_RTOL) and
             its top-1 agreement with bf16; 8 concurrent requests of
             phase 1's shape, then 8 chat requests sharing phase 10's
             system prompt: B5-int8 exactly decode steps x 16, all through
             the global table, no bf16 B5 launch; /stats names the int8
             compute quantization and the int8 KV; one int8 arena page
             exported and imported (LPG1) with equal bytes; `--quantize
             int4` answering one request; b1's 8 experts at 8 of 16
             layers under int8 (gather dispatch: no B4a launch); `convert
             --to int8` of phase 7's run A checkpoint and `chat --prompt`
             from the export. Tokens/s and ms a decode step beside phase
             1's, and a profiled W8A8 decode step. Phase 2 also holds B5-int8 against its plain version at
             phase 2's local shapes, the phase-10 global-table shape and
             head_dim 576, and times it.

 15. mesh    multi-GPU training on one card, in two parts.
             (a) The sharded path on a one-rank NCCL mesh: `python -m
             torch.distributed.run --standalone --nproc-per-node 1
             chip_smoke.py --mesh-child ...`, which runs `train --config`
             at phase 6's flagship MoE widths (gmm) at MESH_LAYERS of
             their 10 layers for MESH_STEPS steps
             through the port's CLI under torchrun: the Trainer builds the
             mesh, FSDP2-shards the model and runs the sharded step. The
             child first takes one step of the unsharded Trainer on the
             same seed and batch; the sharded first step's loss and grad
             norm must be within MESH_RTOL of it and its B1-B4 launches
             equal; one profiled sharded step must show FSDP2's unshard
             and gradient-reduction ranges beside B1-B4 (and its NCCL
             all-gather / reduce-scatter, where FSDP2 issues them: over
             more than one rank); the
             checkpoint the run writes must restore in the unsharded
             Trainer bitwise. The run trains under the adaptive
             orchestrator (the CLI's default, over a mesh too); its
             summary must carry the decisions. Step time and peak memory
             beside the unsharded Trainer's at the same depth and phase
             6's, each run's peak from a torch.cuda.memory trace of its
             init and first step, named by what holds it (the ranges open
             when each block live at the peak was allocated: the
             Trainer's build, the forward, the backward, the optimizer,
             and FSDP2's own).
             (b) Ring attention over 4 virtual ranks at b75's attention
             widths (q [1, 8192, 64, 128], k/v 8 heads, bf16, 2048 rows a
             rank): every (rank, ring step) through the port's own chunk
             function and merge (ops/ring_attention.py
             virtual_ring_attention), causal, causal with window 2560 and
             non-causal; o and lse against B1 on the whole sequence
             (FLASH_REL_TOL, LSE_TOL), dq/dk/dv through the merged output
             against B2/B3 on the whole sequence, exact B1 launches
             (causal 4 diagonal + 6 visible, window 4, non-causal 16).

 16. pipe    pipeline stages and the optimizer's host offload on one card.
             (a) Phase 6's flagship MoE widths (gmm, bf16 RoPE) at
             PIPE_LAYERS layers, batch 16 x 2048: one step of the
             one-stage step over PIPE_MICRO micro-batches, then the same
             step through parallel/pipeline.py's virtual_pipeline_step
             (PIPE_STAGES stages played in this process, the hops handed
             over locally) under 1F1B and under GPipe, each from the same
             seeded weights: loss and grad norm within MESH_RTOL of the
             one-stage step's, B1-B4 launches equal to its, the most
             microbatches in flight on each stage (1F1B at most P - p,
             GPipe all), each step's peak memory; the pipelined eval
             against the one-stage eval over the same microbatches
             (MESH_RTOL). (b) The flagship at OFFLOAD_LAYERS layers:
             OFFLOAD_STEPS steps of the unsharded Trainer with
             host_offload_optimizer and as many without, same seed and
             batches: the parameters' sha256 equal after the last, every
             moment on the CPU and pinned between steps, the card's peak
             memory lower by at least 80% of the moments' bytes; step
             times beside each other. `--only pipe` runs it alone.

 18. a7      the A5 leftovers, after phase 17. (a) Soft-prompt tuning at
             b1's widths, all 16 layers, no experts, seeded bf16 weights:
             P = 128 virtual tokens (random rows of the embedding table)
             before 4 x 1920 real tokens (S + P = 2048, flash-eligible),
             `make_prompt_tuning_step` 3 Adam steps on one repeated batch:
             B1 2 x 16, B2 = B3 16 a step exactly; the first step's loss
             within LOSS_RTOL and the prompt gradient's norm within
             GRAD_NORM_RTOL of the same step through the plain attention;
             the base parameters' sha256 unchanged and no base gradient;
             the loss falling; step ms. (b) Trainer on phase 6's flagship
             widths at MESH_LAYERS layers (gmm): steps_per_epoch 2 x
             num_epochs 2 over a 2-batch loader (final_step 4, epochs 2),
             the first step under the FLOP counter
             (compiled_cost_analysis: counted against analytic FLOPs, the
             kernels' own counts, peak memory, the in-place audit), a
             profiling window over steps [2, 4) whose torch.profiler trace
             and attribution.jsonl must exist, attribute time to
             attn_flash_kernels, moe_expert_matmul and ce_loss, and sum to
             the trace's card busy time within 2%; summary["slo"]; exact
             B1-B4 launches. (c) Through cli.main in process: `diagnose
             --preset b1` (exit 0, the card named as nvidia-smi names it;
             its probes on a one-rank NCCL group), `report training --dir`
             on (b)'s output (the HTML), `events --stats` over (b)'s flight
             record. `--only a7` runs it after the build alone.

 19. a8      the last JAX modules, after phase 18, at b1's widths (16
             layers, dense, seeded bf16 weights) with attention_window
             1020: the rolling cache holds 1024 slots (init_cache), slack
             4. (1) One 1800-token request, bucket-prefilled at 2048 rows
             through B1 banded (16 launches), then 128 greedy tokens
             through the rolling cache (no B5: the slot mask is plain);
             the same request through a plain-cache engine (B5 16 a
             step): every position's logits, teacher-forced on the plain
             run's tokens, within LOGIT_RTOL x max|logit|; the cache's
             bytes exactly 1024/2048 of the plain one's; step ms of both.
             (2) generate_speculative, draft_k 8: every verify 5 rows (the
             cap C - window + 1), its tokens the greedy ones up to a
             near-tie (the top-2 gap printed where one differs). (3)
             generate_batch over prompts of 300-1800 tokens: each lane's
             tokens its single-request run's, up to a near-tie. (4) int8
             KV: one request through the rolling cache against the plain
             int8 cache (B5-int8). (5) One b1 decode step and one
             2-layer flagship train step under
             torch.cuda.set_sync_debug_mode("warn"), the syncs CUDA
             reports beside detect_host_syncs's count. (6) `analyze
             --json` through the CLI's main (a child process started at
             the phase's start) exits 0. `--only a8` runs it after the
             build alone.

 20. vocab   the embedding and LM head cut by vocabulary over the tensor
             ranks, on virtual ranks (one card holds one NCCL rank), after
             phase 19. (a) At b300's vocabulary and hidden width (V 50304,
             H 16384), 1 x 8192 seeded bf16 hidden rows and an fp32 head:
             ops/fused.py's virtual_vocab_ce_sums over 2 and 4 virtual
             tensor ranks, forward and backward, against
             fused_lm_head_ce_sums (the bf16 values carried in fp32 for
             the gates: loss rel <= 1e-5, d hidden and d head within 1e-4
             x max|g|); virtual_vocab_lookup torch.equal to the whole
             lookup (fp32 and bf16 rows); on the path's own dtypes the
             whole CE's, the 2-rank CE's and one rank's ([V/2, H] slice)
             forward + backward ms and peak memory above the inputs.
             (b) Phase 6's flagship widths at MESH_LAYERS layers: the
             gradients of one batch through the whole CE and through the
             CE over 2 virtual vocab ranks: loss and grad norm within
             MESH_RTOL, every parameter's gradient within 2^-5 x max|g|
             (bf16 gradients), equal non-zero B1-B4 launches and the
             flash library's last kernels the wgmma ones; then one timed
             train step of each (the second of two). `--only vocab` runs
             it after the build and kernel checks.
 21. bench   the port's benchmark harness, after phase 20, as processes of
             its own on the card. (a) `bench_torch.py --child
             ref_debug_moe` (the headline rung: bench.py's debug MoE
             widths, batch 256 x 256, 20 timed steps; its steady-routing
             window, counted-cost step and profiled steps cut by
             BENCH_RUNG_BUDGET): one JSON line; the metric
             train_tokens_per_sec_per_chip_moe8x2 with a value > 0, a
             finite loss, extras.config ref_debug_moe and this card's
             name; B1 = B2 = B3 = 2 layers x 20 steps exactly over the
             timed window, B4a = B4b = 0 (sort dispatch); the kernels the
             flash library recorded last in the child the wgmma ones, and
             the profiler's names, where it recorded any, agreeing. (b)
             Under `--only bench` only: the ladder through `python -m
             luminaai_tpu_torch benchmark`, the op table through
             `benchmark --ops` (its attention suite, B1-B3 against the
             einsum path at [4, 2048, 16/8, 64]: agreement within its
             tolerance, the wgmma kernels last), the flagship and
             flagship_small rungs, `--serve-bench`, `--router-bench` and
             `--smoke`, each line logged whole.

`--only serve,plane,serve_moe` (development runs) runs the build, the
kernel checks and the named phases only (`--only a7` and `--only a8`
skip the kernel checks); its last line then says "partial".

Earlier train phases write their checkpoints under chip_smoke_runs/ too,
and the directory is removed when the script ends.

Output: progress lines, the card's `nvidia-smi` name and power limit, one
{"kernels": [...]} JSON line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or without the luminaai_tpu_torch package beside
this file, it exits non-zero and prints no result. It imports nothing of
JAX and nothing of the luminaai_tpu package.
"""

from __future__ import annotations

import gc
import hashlib
import itertools
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# Serving slice shapes (the b1 preset: 16 q heads over 4 kv heads,
# head_dim 128) and the pool the server runs (8 slots, 128-row pages).
LANES, HQ, HKV, D, PAGE, PAGES = 8, 16, 4, 128, 128, 16
# Training slice: micro-batch 2 x 2048 tokens at the same heads.
MICRO, SEQ = 2, 2048
TRAIN_STEPS = 6
# Depth of the in-process training phases (5, 6, 11, 12): each Trainer run
# ends in a checkpoint of its weights and fp32 moments, written and
# hashed (b1's 16 layers: ~9.7 GB; the flagship's 10: ~9 GB, ~25 s each
# on an H100 host); the widths stay whole.
B1_TRAIN_LAYERS = 2        # of b1's 16 (phase 5)
FLAGSHIP_TRAIN_LAYERS = 2  # of the flagship's 10 (phases 6 and 11)
MOD_TRAIN_LAYERS = 3       # of debug_200m's 12 (phase 12's training)
# Flash kernels vs plain versions, bf16 outputs (O, dQ, dK, dV): within
# 2e-2 x max|plain|. bf16 keeps 8 significant bits; both sides round P
# and dS to bf16, but the kernel rounds P against a running 64-column
# maximum and the plain version against the row's maximum, and the fp32
# sums run in other orders. lse is fp32 on both sides from the same fp32
# scores: within 1e-4 absolute.
FLASH_REL_TOL = 2e-2
LSE_TOL = 1e-4
# First optimizer step, flash kernels vs the plain attention (which rounds
# the scores to bf16 before its fp32 softmax, as the JAX _xla_attention
# does, where the kernels keep fp32 scores): the mean loss within 1e-2
# relative (the loss at a random init is ~ln(V) and moves little with the
# attention's rounding), the pre-clip grad norm within 5e-2 relative (the
# gradients run back through 16 bf16 layers of that rounding).
LOSS_RTOL = 1e-2
GRAD_NORM_RTOL = 5e-2
# Kernel vs plain version, bf16: bf16 keeps 8 significant bits; the kernel
# keeps fp32 scores and rounds the unnormalised P to bf16, the plain
# version rounds the scores and the normalised P, so outputs (|out| <=
# max|v| ~ 4.5) differ by a few bf16 ulps.
KERNEL_TOL = 3e-2
# First-decode-step logits, kernel vs plain attention through 16 bf16
# layers: the attention difference above enters every layer's bf16
# residual stream, so logits move by a few bf16 ulps (2^-8 relative) of
# their largest magnitude. Tolerance: 1e-2 x max|logit| (2.56 ulps).
LOGIT_RTOL = 1e-2
# First-decode-step logits, kernel vs plain, of the W8A8 model (int8
# weights, activations quantized per row at every product): the
# attention difference behind LOGIT_RTOL flips activation codes that sit
# within it of a .5 boundary, each flip moving a product by one code step
# (1/127 of its row's max), over 4 products a layer through 16 layers.
# Measured 1.53e-2 x max|logit| with B5-int8 on an H100 80GB HBM3 at 700
# W, where the bf16 model sat at 0.48e-2 in the same run. The same weights
# over a bf16 pool (bf16 B5 vs plain) are held to the same bound, so what
# it admits is the W8A8 products' amplification, not the int8 kernel;
# B5-int8 itself is held to LOGIT_RTOL under bf16 weights.
W8A8_LOGIT_RTOL = 5e-2
COPIES = 4  # K/V pools the kernel timing rotates through (past the L2)
# Flash shapes the JAX gate admits that the first kernels refused:
# name: (B, S, Hq, Hkv, D, causal, window).
REPAIRED_FLASH = {
    "d192_g2_s1024": (2, 1024, 4, 2, 192, True, 0),
    "s200": (MICRO, 200, HQ, HKV, D, True, 0),
    "group3": (MICRO, 1024, 12, 4, D, True, 0),
    # Above head_dim 256 (the 64-column slice kernels).
    "d320_s256": (1, 256, 4, 2, 320, True, 0),
    "d512_window64": (1, 256, 4, 1, 512, True, 64),
}
# B1 at the flagship MoE training shape (bench.py's widths: 16 q over 8 kv
# heads, head_dim 64, micro-batch 16 x 2048): (B, S, Hq, Hkv, D).
FLAGSHIP_ATTN = (16, 2048, 16, 8, 64)
# debug_200m's attention (12 q over 4 kv heads, a group of 3, head_dim 64,
# micro-batch 8 x 2048). The dispatch rule of csrc/flash_attention.cu sends
# B2 to the wgmma kernel with 3 x 42 rows and 2 padding rows of its 128,
# and B1 to the wgmma kernel (its 192 rows at head_dim 64 are 3 x 64).
DEBUG200M_ATTN = (8, 2048, 12, 4, 64)
# Groups that do not tile B1's and B2's rows (128; B1's 192 at head_dim
# 64), timed beside them: b14's attention (40 q over 8 kv heads, head_dim
# 128, sequence 4096; 5 x 25 rows), a group of 6 at head_dim 64 (B2's 6 x
# 21 rows), b100's and b200's heads at b14's sequence (10 x 12 and 12 x 10
# rows) and a group of 5 at head_dim 64 (B1's 5 x 38 of 192 rows).
# (B, S, Hq, Hkv, D).
GROUP5_ATTN = (1, 4096, 40, 8, 128)
GROUP6_ATTN = (4, 2048, 24, 4, 64)
B100_ATTN = (1, 4096, 80, 8, 128)
B200_ATTN = (1, 4096, 96, 8, 128)
GROUP5_D64_ATTN = (4, 2048, 20, 4, 64)
# Head_dim 192 and 256 (B3 on its wgmma kernel): debug_300m's micro-batch
# (4 q over 2 kv heads, batch 16 x 1024) and a head_dim-256 case.
DEBUG300M_ATTN = (16, 1024, 4, 2, 192)
D256_ATTN = (1, 2048, 8, 2, 256)


def flash_kernels(d: int) -> dict:
    """The CUDA kernels B1-B3 must take at head_dim d (up to 256), as the
    profiler names them: B1 the wgmma forward and B2 the wgmma dQ kernel at
    every group and head_dim, B3 the wgmma kernel at 64 and 128 and its
    head_dim-192/256 kernel above."""
    return {"B1": "flash_fwd_wgmma_kernel",
            "B2": "flash_bwd_dq_wgmma_kernel",
            "B3": ("flash_bwd_dkv_wgmma_hd256_kernel" if d > 128
                   else "flash_bwd_dkv_wgmma_kernel")}


# The kernels at the main paths' head dims (64 and 128).
WGMMA_KERNELS = flash_kernels(128)
# B5 above head_dim 512 (512-column output slices): Hq 8 over Hkv 2.
WIDE_DECODE = (8, 2, 576)
# Rounds whose median is the library's time where single rounds differ by
# more than 2x from run to run (SDPA's backward on an H100).
LIB_ROUNDS = 5
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12    # dense bf16 tensor-core peak
# Training runs and checkpoints (git-ignored; removed when the script ends).
RUN_DIR = Path(__file__).resolve().parent / "chip_smoke_runs"
# Phase 15 (mesh). The sharded first step on a one-rank mesh against the
# unsharded one: the same kernels on the same data; FSDP2's all-gather
# and reduce-scatter of one rank copy the values, and the loss is scaled
# by the reduce group's size (1). Within 1e-5 relative.
MESH_STEPS = 3
MESH_RTOL = 1e-5
# Phase 15 (a) trains the flagship widths at 2 of their 10 layers: its
# checkpoint is written, hashed, read and hashed again within the phase's
# 60 s (10 layers: 9.1 GB and ~60 s of it).
MESH_LAYERS = 2
# b75's attention (64 q over 8 kv heads, head_dim 128, sequence 8192) over
# 4 virtual sequence ranks; the window case's band reaches 2560 rows back.
RING_ATTN = (1, 8192, 64, 8, 128)
RING_RANKS = 4
RING_WINDOW = 2560
RING_B1 = {"causal": 10, "window": 4, "non_causal": 16}
# Phase 16 (pipe): the flagship widths at 4 layers over 2 stages in 4
# microbatches (the one-stage step accumulates over the same 4), and the
# optimizer's host offload at 2 layers for 3 steps.
PIPE_LAYERS, PIPE_STAGES, PIPE_MICRO = 4, 2, 4
OFFLOAD_LAYERS, OFFLOAD_STEPS = 2, 3
# A memory trace keeps this many allocator events (init and one step).
TRACE_EVENTS = 400_000


def _release() -> None:
    import torch

    gc.collect()
    torch.cuda.empty_cache()


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """A line of the run's log, stamped with the seconds since the
    process started (the phases' timeline against the script's limit)."""
    print(f"[chip_smoke +{time.perf_counter() - _T0:.1f}s] {msg}",
          flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """ms a call of fn over back-to-back calls (the port's timer)."""
    from luminaai_tpu_torch.ops import _timing

    return _timing.cuda_ms(fn, iters, warmup)


def graph_ms(fn, iters: int) -> float:
    """ms a call of fn replayed from a CUDA graph of `iters` calls: the
    card's time without the host's between launches (the port's timer)."""
    from luminaai_tpu_torch.ops import _timing

    return _timing.graph_ms(fn, iters)


def kernel_names(fn, tries: int = 6, margin_s: float = 0.01) -> list:
    """The CUDA kernels one call of fn launches, as torch.profiler (CUPTI)
    names them: [] when the profiler records no device events in any of
    `tries` profiled calls. The profiler keeps only the device events that
    fall inside its window on the host's clock, and a session around one
    short call now and then records none (two of five runs of this script
    on an H100 lost one B2 call's record; one lost B1's in three tries in a
    row), so the call sits `margin_s` of idle host time from each end of
    the window, doubled at each try."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for i in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(margin_s * 2 ** i)
            fn()
            torch.cuda.synchronize()
            time.sleep(margin_s * 2 ** i)
        names = sorted({e.key for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA})
        if names:
            if i:
                log(f"  the profiler named the call's kernels at try {i + 1}")
            return names
    return []


def flash_taken(calls: dict) -> dict:
    """{kernel: names} for {"B1"|"B2"|"B3": one call}: the CUDA kernels
    that one call launches as torch.profiler names them (_short), held
    against the kernel the flash library recorded at its launch site
    (flash_attention.last_kernel). Where both name kernels they must agree;
    where the profiler records no device events in all of kernel_names's
    tries (one B2 call lost all six on an H100), the library's record
    stands in and the log says so."""
    from luminaai_tpu_torch.ops import flash_attention as fa

    taken = {}
    for kern, call in calls.items():
        names = [_short(n) for n in kernel_names(call)]
        lib = fa.last_kernel(kern)
        if not names:
            log(f"  {kern}: the profiler recorded no device events in any "
                f"try; the library recorded the launch of {lib}")
            names = [lib]
        elif lib not in names:
            raise AssertionError(f"{kern}: the profiler named {names}, the "
                                 f"library recorded {lib}")
        taken[kern] = names
    return taken


def _short(name: str) -> str:
    """A kernel's name without its namespace and parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].replace("void ", "").strip()


def phase_build() -> None:
    from luminaai_tpu_torch.ops import _build

    secs = _build.build_all()
    log(f"build: {len(_build.SOURCES)} source(s) in {secs:.1f}s")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


def phase_kernels(dev) -> dict:
    """Kernel vs plain version at the slice's shapes; timings and bound."""
    import torch
    import torch.nn.functional as F

    from luminaai_tpu_torch.ops import ragged_paged_attention as rpa

    C = PAGES * PAGE
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(
            *shape, generator=gen, device=dev
        ).to(torch.bfloat16)

    q = randn(LANES, 1, HQ, D)
    k = randn(LANES, C, HKV, D)
    v = randn(LANES, C, HKV, D)
    # Mixed residency: one row, a page boundary from both sides, partial
    # pages, and a full slot.
    lengths = torch.tensor(
        [1, 127, 128, 129, 700, 1500, 2047, 2048], dtype=torch.int32,
        device=dev,
    )
    ident = torch.arange(PAGES, dtype=torch.int32, device=dev).expand(
        LANES, PAGES
    ).contiguous()
    perm = torch.randperm(LANES * PAGES, generator=gen, device=dev)
    cases = {
        "identity": rpa.LaneMeta(lengths=lengths, page_table=ident,
                                 page_size=PAGE),
        "window512": rpa.LaneMeta(lengths=lengths, page_table=ident,
                                  page_size=PAGE, window=512),
        # Lengths on both sides of a 64-row tile and of the shares of the
        # split-KV kernel's blocks.
        "shares": rpa.LaneMeta(
            lengths=torch.tensor([1, 63, 64, 65, 255, 256, 257, 2048],
                                 dtype=torch.int32, device=dev),
            page_table=ident, page_size=PAGE),
        "global": rpa.LaneMeta(
            lengths=lengths,
            page_table=perm.view(LANES, PAGES).to(torch.int32),
            page_size=PAGE, identity_pages=False, global_pages=True,
        ),
    }
    errs = {}
    for name, meta in cases.items():
        out = rpa.ragged_paged_attention(q, k, v, meta)
        want = rpa.ragged_paged_attention_ref(q, k, v, meta)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"kernel output not finite ({name})")
        errs[name] = (out.float() - want.float()).abs().max().item()
        log(f"kernel vs plain [{name}]: max_abs_err={errs[name]:.3e} "
            f"(tol {KERNEL_TOL})")
        if errs[name] > KERNEL_TOL:
            raise AssertionError(f"kernel disagrees with plain ({name})")

    # Any group (repaired in this slice; the JAX gate admits any): 16 q
    # heads over one kv head, held against the plain version and timed.
    q16, k16, v16 = randn(LANES, 1, 16, D), randn(LANES, C, 1, D), randn(
        LANES, C, 1, D)
    meta16 = cases["identity"]
    out = rpa.ragged_paged_attention(q16, k16, v16, meta16)
    want = rpa.ragged_paged_attention_ref(q16, k16, v16, meta16)
    torch.cuda.synchronize()
    errs["group16"] = (out.float() - want.float()).abs().max().item()
    lane_mask = (torch.arange(C, device=dev)[None, :]
                 < lengths[:, None].long())[:, None, None, :]
    g16 = {
        "max_abs_err": errs["group16"],
        "ms": cuda_ms(lambda: rpa.ragged_paged_attention(q16, k16, v16,
                                                         meta16), 100),
        "plain_ms": cuda_ms(lambda: rpa.ragged_paged_attention_ref(
            q16, k16, v16, meta16), 10),
        # Library yardstick: SDPA over the same K/V with the length mask.
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q16.transpose(1, 2), k16.transpose(1, 2), v16.transpose(1, 2),
            attn_mask=lane_mask, enable_gqa=True), 50),
        "shapes": {"lanes": LANES, "hq": 16, "hkv": 1, "head_dim": D},
    }
    log(f"kernel vs plain [group16: Hq 16 over Hkv 1]: max_abs_err="
        f"{errs['group16']:.3e} (tol {KERNEL_TOL}); kernel {g16['ms']:.4f} "
        f"ms, plain {g16['plain_ms']:.4f} ms, library (SDPA) "
        f"{g16['library_ms']:.4f} ms")
    if not torch.isfinite(out).all() or errs["group16"] > KERNEL_TOL:
        raise AssertionError("kernel disagrees with plain (group16)")
    del q16, k16, v16, out, want

    # head_dim above 512 (repaired in this slice: the gate admits any
    # multiple of 64), held against the plain version and timed.
    hq_w, hkv_w, d_w = WIDE_DECODE
    qw, kw, vw = (randn(LANES, 1, hq_w, d_w), randn(LANES, C, hkv_w, d_w),
                  randn(LANES, C, hkv_w, d_w))
    out = rpa.ragged_paged_attention(qw, kw, vw, meta16)
    want = rpa.ragged_paged_attention_ref(qw, kw, vw, meta16)
    torch.cuda.synchronize()
    errs["d576"] = (out.float() - want.float()).abs().max().item()
    wide = {
        "max_abs_err": errs["d576"],
        "ms": cuda_ms(lambda: rpa.ragged_paged_attention(qw, kw, vw, meta16),
                      50),
        "plain_ms": cuda_ms(lambda: rpa.ragged_paged_attention_ref(
            qw, kw, vw, meta16), 10),
        "shapes": {"lanes": LANES, "hq": hq_w, "hkv": hkv_w, "head_dim": d_w},
    }
    log(f"kernel vs plain [d{d_w}: Hq {hq_w} over Hkv {hkv_w}]: max_abs_err="
        f"{errs['d576']:.3e} (tol {KERNEL_TOL}); kernel {wide['ms']:.4f} ms, "
        f"plain {wide['plain_ms']:.4f} ms")
    if not torch.isfinite(out).all() or errs["d576"] > KERNEL_TOL:
        raise AssertionError(f"kernel disagrees with plain (d{d_w})")
    del qw, kw, vw, out, want

    # Timing. One K/V pool here is 33.5 MB, under the H100's 50 MB L2, and
    # the serving caller reads each layer's pool once per step, cold: so
    # each timed call reads the next of COPIES pools (134 MB together).
    meta = cases["identity"]
    pools = [(k, v)] + [(k.clone(), v.clone()) for _ in range(COPIES - 1)]

    def rotating(fn):
        turn = itertools.count()
        return lambda: fn(*pools[next(turn) % COPIES])

    kernel_ms = cuda_ms(rotating(
        lambda kk, vv: rpa.ragged_paged_attention(q, kk, vv, meta)), 200)
    kernel_graph_ms = graph_ms(rotating(
        lambda kk, vv: rpa.ragged_paged_attention(q, kk, vv, meta)),
        8 * COPIES)
    plain_ms = cuda_ms(rotating(
        lambda kk, vv: rpa.ragged_paged_attention_ref(q, kk, vv, meta)), 20)

    # Library yardstick (never called by the port): SDPA over the same K/V,
    # [B, H, S, D] views with a per-lane length mask.
    qs = q.transpose(1, 2)
    mask = (torch.arange(C, device=dev)[None, :] < lengths[:, None].long())
    mask = mask[:, None, None, :]

    def library(kk, vv):
        return F.scaled_dot_product_attention(
            qs, kk.transpose(1, 2), vv.transpose(1, 2), attn_mask=mask,
            enable_gqa=True,
        )

    library_ms = cuda_ms(rotating(library), 50)
    lib_err = (library(k, v).transpose(1, 2).float()
               - rpa.ragged_paged_attention_ref(q, k, v, meta).float()
               ).abs().max().item()
    del pools

    resident = int(lengths.sum().item())
    bytes_moved = (
        resident * HKV * D * 2 * 2           # K and V rows, bf16
        + 2 * LANES * HQ * D * 2             # q in, out
        + LANES * PAGES * 4 + LANES * 4      # table, lengths
    )
    flops = 4 * resident * HQ * D            # QK^T and PV
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    log(f"kernel {kernel_ms:.4f} ms ({kernel_graph_ms:.4f} ms from a CUDA "
        f"graph), plain {plain_ms:.4f} ms, library "
        f"(SDPA) {library_ms:.4f} ms (max diff to plain {lib_err:.3e}), "
        f"bound {max(t_bytes, t_ops):.4f} ms "
        f"({bytes_moved / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    return {
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "luminaai_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "luminaai_tpu/ops/ragged_paged_attention.py:227",
        "tpu_kernel": "_decode_kernel",
        "launches": None,  # filled from the serving run
        "max_abs_err": max(errs.values()),
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "graph_ms": kernel_graph_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
        "shapes": {"lanes": LANES, "hq": HQ, "hkv": HKV, "head_dim": D,
                   "page_size": PAGE, "pages": PAGES,
                   "lengths": [int(x) for x in lengths.tolist()]},
        "repaired": {"group16": g16, f"d{WIDE_DECODE[2]}": wide},
    }


def _int8_pool(side):
    """A bf16 pool side quantized per row and kv head over head_dim (the
    cache's insert): (codes int8, scales fp32 [.., 1])."""
    from luminaai_tpu_torch.ops.quantized import quantize_act

    return quantize_act(side)


def phase_kernels_int8(dev) -> dict:
    """B5-int8 against its plain version (the int8 sides dequantized where
    read, then the reference): phase 2's local shapes, the phase-10
    global-table shape (8 lanes, each on the same 12 arena pages then 1-2
    private ones), and head_dim 576 (the bf16 wide kernel over a
    dequantized scratch of the pages the lanes reach); times kernel,
    plain and library (dequantize + SDPA with the length mask) at the
    local shape and the global one."""
    import torch
    import torch.nn.functional as F

    from luminaai_tpu_torch.ops import ragged_paged_attention as rpa

    C = PAGES * PAGE
    gen = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    q = randn(LANES, 1, HQ, D)
    k, v = _int8_pool(randn(LANES, C, HKV, D)), _int8_pool(
        randn(LANES, C, HKV, D))
    lengths = torch.tensor([1, 127, 128, 129, 700, 1500, 2047, 2048],
                           dtype=torch.int32, device=dev)
    ident = torch.arange(PAGES, dtype=torch.int32, device=dev).expand(
        LANES, PAGES).contiguous()
    perm = torch.randperm(LANES * PAGES, generator=gen, device=dev)
    # The phase-10 shape: every lane's first 12 pages are the same arena
    # pages (lane 7's slot), then its own private pages.
    shared = PLANE_SHARED_PAGES
    gtable = (torch.arange(LANES, device=dev)[:, None] * PAGES
              + torch.arange(PAGES, device=dev)[None, :]).to(torch.int32)
    gtable[:, :shared] = gtable[LANES - 1, :shared]
    glens = torch.tensor([1603, 1610, 1618, 1625, 1633, 1641, 1649, 1656],
                         dtype=torch.int32, device=dev)
    cases = {
        "identity": rpa.LaneMeta(lengths=lengths, page_table=ident,
                                 page_size=PAGE),
        "window512": rpa.LaneMeta(lengths=lengths, page_table=ident,
                                  page_size=PAGE, window=512),
        "shares": rpa.LaneMeta(
            lengths=torch.tensor([1, 63, 64, 65, 255, 256, 257, 2048],
                                 dtype=torch.int32, device=dev),
            page_table=ident, page_size=PAGE),
        "global": rpa.LaneMeta(
            lengths=lengths, page_table=perm.view(LANES, PAGES).to(
                torch.int32), page_size=PAGE, identity_pages=False,
            global_pages=True),
        "global_shared": rpa.LaneMeta(
            lengths=glens, page_table=gtable, page_size=PAGE,
            identity_pages=False, global_pages=True),
    }
    errs = {}
    n0 = rpa.ragged_paged_attention.launches
    for name, meta in cases.items():
        out = rpa.ragged_paged_attention(q, k, v, meta)
        want = rpa.ragged_paged_attention_plain(q, k, v, meta)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"B5-int8 output not finite ({name})")
        errs[name] = (out.float() - want.float()).abs().max().item()
        log(f"B5-int8 vs plain [{name}]: max_abs_err={errs[name]:.3e} "
            f"(tol {KERNEL_TOL})")
        if errs[name] > KERNEL_TOL:
            raise AssertionError(f"B5-int8 disagrees with plain ({name})")
    if rpa.ragged_paged_attention.launches != n0:
        raise AssertionError("an int8 call launched the bf16 kernel")

    # head_dim above 512: the pages the lanes reach, dequantized into a
    # bf16 scratch, through the wide bf16 kernel (counted as int8).
    hq_w, hkv_w, d_w = WIDE_DECODE
    qw = randn(LANES, 1, hq_w, d_w)
    kw_, vw = (_int8_pool(randn(LANES, C, hkv_w, d_w)),
               _int8_pool(randn(LANES, C, hkv_w, d_w)))
    out = rpa.ragged_paged_attention(qw, kw_, vw, cases["identity"])
    want = rpa.ragged_paged_attention_plain(qw, kw_, vw, cases["identity"])
    torch.cuda.synchronize()
    errs[f"d{d_w}"] = (out.float() - want.float()).abs().max().item()
    log(f"B5-int8 vs plain [d{d_w}, bf16 scratch + wide kernel]: "
        f"max_abs_err={errs[f'd{d_w}']:.3e} (tol {KERNEL_TOL})")
    if not torch.isfinite(out).all() or errs[f"d{d_w}"] > KERNEL_TOL:
        raise AssertionError(f"B5-int8 disagrees with plain (d{d_w})")
    del qw, kw_, vw, out, want

    def measure(meta, lens, unique_rows):
        """(kernel, plain, library ms, library error, bound ms, bound_by,
        ms from a CUDA graph) over COPIES pools (past the L2), bytes
        counting each distinct row once."""
        pools = [(k, v)] + [(tuple(t.clone() for t in k),
                             tuple(t.clone() for t in v))
                            for _ in range(COPIES - 1)]
        turn = itertools.count()

        def rotating(fn):
            return lambda: fn(*pools[next(turn) % COPIES])

        ms = cuda_ms(rotating(lambda kk, vv: rpa.ragged_paged_attention(
            q, kk, vv, meta)), 200)
        graph = graph_ms(rotating(lambda kk, vv: rpa.ragged_paged_attention(
            q, kk, vv, meta)), 8 * COPIES)
        plain = cuda_ms(rotating(
            lambda kk, vv: rpa.ragged_paged_attention_plain(
                q, kk, vv, meta)), 20)
        # Library yardstick (never called by the port): the pages each
        # lane reaches gathered through its table and dequantized, then
        # SDPA with the length mask.
        table = meta.kernel_table(PAGES).long()
        n = -(-int(lens.max()) // PAGE)
        idx = table[:, :n].contiguous()
        mask = (torch.arange(n * PAGE, device=dev)[None, :]
                < lens[:, None].long())[:, None, None, :]
        qs = q.transpose(1, 2)

        def library(kk, vv):
            def g(side):
                return rpa.dequantize_kv(tuple(
                    t.view(-1, PAGE, *t.shape[2:])[idx].reshape(
                        LANES, n * PAGE, *t.shape[2:]) for t in side),
                    torch.bfloat16).transpose(1, 2)

            return F.scaled_dot_product_attention(
                qs, g(kk), g(vv), attn_mask=mask, enable_gqa=True)

        lib = cuda_ms(rotating(library), 50)
        lib_err = (library(k, v).transpose(1, 2).float()
                   - rpa.ragged_paged_attention_plain(q, k, v, meta).float()
                   ).abs().max().item()
        del pools
        resident = int(lens.sum().item())
        bytes_moved = (unique_rows * HKV * (D + 4) * 2  # codes + scales
                       + 2 * LANES * HQ * D * 2 + LANES * PAGES * 4
                       + LANES * 4)
        flops = 4 * resident * HQ * D
        t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_BF16_FLOPS * 1e3
        return (ms, plain, lib, lib_err, max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations", graph)

    local = measure(cases["identity"], lengths, int(lengths.sum().item()))
    shared_rows = shared * PAGE
    uniq = shared_rows + int((glens - shared_rows).sum().item())
    glob = measure(cases["global_shared"], glens, uniq)
    for label, m in (("local", local), ("global (phase-10 shape)", glob)):
        log(f"B5-int8 {label}: kernel {m[0]:.4f} ms ({m[6]:.4f} ms from a "
            f"CUDA graph), plain {m[1]:.4f} ms, "
            f"library (dequantize + SDPA) {m[2]:.4f} ms (max diff to plain "
            f"{m[3]:.3e}), bound {m[4]:.4f} ms ({m[5]}), share "
            f"{100 * m[4] / m[0]:.1f}%")
    return {
        "name": "ragged_paged_attention_int8",
        "route": "cuda",
        "source": "luminaai_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "luminaai_tpu/ops/ragged_paged_attention.py:227",
        "tpu_kernel": "_decode_kernel (int8 cache dequantized by "
                      "luminaai_tpu/models/layers.py:400-431)",
        "launches": None,  # filled from phase 14
        "max_abs_err": max(errs.values()),
        "ms": local[0],
        "graph_ms": local[6],
        "plain_ms": local[1],
        "bound_ms": local[4],
        "bound_by": local[5],
        "library_ms": local[2],
        "shapes": {"lanes": LANES, "hq": HQ, "hkv": HKV, "head_dim": D,
                   "page_size": PAGE, "pages": PAGES,
                   "lengths": [int(x) for x in lengths.tolist()]},
        "global_form": {"ms": glob[0], "graph_ms": glob[6],
                        "plain_ms": glob[1],
                        "library_ms": glob[2], "bound_ms": glob[4],
                        "bound_by": glob[5],
                        "lengths": [int(x) for x in glens.tolist()],
                        "shared_pages": shared, "unique_rows": uniq},
    }


def _band_pairs(s: int, causal: bool, window: int) -> int:
    """(q, k) pairs inside the attention band of one (batch, head)."""
    if not causal:
        return s * s
    return sum(q - (max(0, q - window + 1) if window else 0) + 1
               for q in range(s))


def phase_flash_kernels(dev) -> list:
    """B1-B3 vs their plain versions (bf16) at the training shapes and
    three variants; timings, library yardstick and bound at the training
    shapes."""
    import torch
    import torch.nn.functional as F

    from luminaai_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    def inputs(b, s, hq, hkv, d):
        q, k, v, do = (randn(*shape) for shape in (
            (b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d)))
        g_lse = torch.randn(b, hq, s, generator=gen, device=dev)
        return q, k, v, do, g_lse

    def rel(got, want):
        return ((got.float() - want.float()).abs().max()
                / want.float().abs().max()).item()

    cases = {
        # name: (B, S, Hq, Hkv, D, causal, window)
        "train": (MICRO, SEQ, HQ, HKV, D, True, 0),
        "window512": (MICRO, SEQ, HQ, HKV, D, True, 512),
        "noncausal": (1, 1024, HQ, HKV, D, False, 0),
        "group1_d64": (MICRO, 1024, 8, 8, 64, True, 0),
        # Shapes the JAX gate admits that the first kernels refused
        # (repaired in this slice, timed below): debug_300m's attention
        # (head_dim 192, 4 q heads over 2 kv heads, S 1024), a length that
        # is not a multiple of 128, and a group of 3.
        **REPAIRED_FLASH,
    }
    abs_err = {"B1": 0.0, "B2": 0.0, "B3": 0.0}
    repaired, routes = {}, {}
    for name, (b, s, hq, hkv, d, causal, window) in cases.items():
        q, k, v, do, g_lse = inputs(b, s, hq, hkv, d)
        args = dict(scale=d ** -0.5, causal=causal, window=window)
        o, lse = fa.flash_fwd(q, k, v, **args)
        o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, **args)
        delta = ((do.float() * o_ref.float()).sum(-1).transpose(1, 2)
                 - g_lse).contiguous()
        dq = fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, **args)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, **args)
        dq_ref = fa.flash_bwd_dq_ref(q, k, v, do, lse_ref, delta, **args)
        dk_ref, dv_ref = fa.flash_bwd_dkv_ref(q, k, v, do, lse_ref, delta,
                                              **args)
        torch.cuda.synchronize()
        taken = flash_taken({
            "B1": lambda: fa.flash_fwd(q, k, v, **args),
            "B2": lambda: fa.flash_bwd_dq(q, k, v, do, lse_ref, delta,
                                          **args),
            "B3": lambda: fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta,
                                           **args)})
        routes[name] = taken
        log(f"  kernels taken [{name}]: " + "; ".join(
            f"{kern} {', '.join(n) or 'not measured'}"
            for kern, n in taken.items()))
        pairs = {"o": (o, o_ref), "dq": (dq, dq_ref), "dk": (dk, dk_ref),
                 "dv": (dv, dv_ref)}
        for t, _ in pairs.values():
            if not torch.isfinite(t.float()).all():
                raise AssertionError(f"flash kernel output not finite "
                                     f"({name})")
        errs = {key: rel(a, b_) for key, (a, b_) in pairs.items()}
        lse_err = (lse - lse_ref).abs().max().item()
        for kern, keys in (("B1", ("o",)), ("B2", ("dq",)),
                           ("B3", ("dk", "dv"))):
            for key in keys:
                a, b_ = pairs[key]
                abs_err[kern] = max(abs_err[kern], (
                    a.float() - b_.float()).abs().max().item())
        log(f"flash kernels vs plain [{name}: B{b} S{s} Hq{hq} Hkv{hkv} "
            f"D{d}{' causal' if causal else ''}"
            f"{f' window {window}' if window else ''}]: rel err "
            + ", ".join(f"{key} {e:.3e}" for key, e in errs.items())
            + f"; lse abs err {lse_err:.3e} (tol {FLASH_REL_TOL} x max, "
            f"lse {LSE_TOL})")
        if max(errs.values()) > FLASH_REL_TOL or lse_err > LSE_TOL:
            raise AssertionError(f"flash kernels disagree with plain "
                                 f"({name})")
        if name in REPAIRED_FLASH:
            t = {
                "B1": cuda_ms(lambda: fa.flash_fwd(q, k, v, **args), 20),
                "B2": cuda_ms(lambda: fa.flash_bwd_dq(
                    q, k, v, do, lse_ref, delta, **args), 20),
                "B3": cuda_ms(lambda: fa.flash_bwd_dkv(
                    q, k, v, do, lse_ref, delta, **args), 20),
            }
            repaired[name] = {"ms": t, "rel_err": errs,
                              "shape": [b, s, hq, hkv, d]}
            log(f"  repaired shape {name}: B1 {t['B1']:.4f} ms, B2 "
                f"{t['B2']:.4f} ms, B3 {t['B3']:.4f} ms")
        del o, o_ref, dq, dq_ref, dk, dk_ref, dv, dv_ref, pairs
        torch.cuda.empty_cache()

    # Timing at the training shapes (causal, no window).
    b, s, hq, hkv, d = MICRO, SEQ, HQ, HKV, D
    q, k, v, do, _ = inputs(b, s, hq, hkv, d)
    args = dict(scale=d ** -0.5, causal=True, window=0)
    o, lse = fa.flash_fwd_ref(q, k, v, **args)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    ms = {
        "B1": cuda_ms(lambda: fa.flash_fwd(q, k, v, **args), 50),
        "B2": cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta,
                                              **args), 50),
        "B3": cuda_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                               **args), 50),
    }
    plain_ms = {
        "B1": cuda_ms(lambda: fa.flash_fwd_ref(q, k, v, **args), 5, 1),
        "B2": cuda_ms(lambda: fa.flash_bwd_dq_ref(q, k, v, do, lse, delta,
                                                  **args), 5, 1),
        "B3": cuda_ms(lambda: fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta,
                                                   **args), 5, 1),
    }
    # Library yardstick (never called by the port): SDPA forward, and its
    # backward (dQ, dK and dV in one call) for B2 and B3 together.
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    with torch.no_grad():
        lib_fwd = cuda_ms(sdpa, 50)
    out = sdpa()
    # Single rounds of the backward have read 0.29 and 0.79 ms at this
    # shape: the median of LIB_ROUNDS rounds.
    lib_bwd_rounds = [cuda_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), 20)
        for _ in range(LIB_ROUNDS)]
    lib_bwd = statistics.median(lib_bwd_rounds)
    log(f"SDPA backward, {LIB_ROUNDS} rounds (ms): "
        + ", ".join(f"{x:.4f}" for x in lib_bwd_rounds))
    lib_err = (out.detach().transpose(1, 2).float() - o.float()
               ).abs().max().item()
    del out, qt, kt, vt, dot

    pairs = b * hq * _band_pairs(s, True, 0)
    act = b * s * hq * d * 2         # q, o, do or dq, bf16
    kv = b * s * hkv * d * 2         # k or v, bf16
    stat = b * hq * s * 4            # lse or delta, fp32
    work = {  # (flops, bytes): each input read once, each output written once
        "B1": (4 * d * pairs, act + 2 * kv + act + stat),
        "B2": (6 * d * pairs, 2 * act + 2 * kv + 2 * stat + act),
        "B3": (8 * d * pairs, 2 * act + 2 * kv + 2 * stat + 2 * kv),
    }
    meta = {
        "B1": ("flash_fwd", "luminaai_tpu/ops/flash_attention.py:99",
               "_fwd_kernel", lib_fwd),
        "B2": ("flash_bwd_dq", "luminaai_tpu/ops/flash_attention.py:205",
               "_bwd_dq_kernel", lib_bwd),
        "B3": ("flash_bwd_dkv", "luminaai_tpu/ops/flash_attention.py:248",
               "_bwd_dkv_kernel", lib_bwd),
    }
    entries = []
    for kern, (name, replaces, tpu_kernel, lib_ms) in meta.items():
        flops, nbytes = work[kern]
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_BF16_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        log(f"{kern} {name}: kernel {ms[kern]:.4f} ms, plain "
            f"{plain_ms[kern]:.4f} ms, library (SDPA "
            f"{'fwd' if kern == 'B1' else 'bwd'}) {lib_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} "
            f"MB; {100 * bound / ms[kern]:.1f}% of bound)")
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "luminaai_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces,
            "tpu_kernel": tpu_kernel,
            "launches": None,  # filled from the training run
            "max_abs_err": abs_err[kern],
            "ms": ms[kern],
            "plain_ms": plain_ms[kern],
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
            "library_rounds_ms": None if kern == "B1" else lib_bwd_rounds,
            "shapes": {"batch": b, "seq": s, "hq": hq, "hkv": hkv,
                       "head_dim": d, "causal": True},
            "repaired": {name: {"ms": r["ms"][kern], "shape": r["shape"]}
                         for name, r in repaired.items()},
            "kernels_taken": {case: r[kern] for case, r in routes.items()},
        })
    log(f"SDPA forward vs plain B1 output: max abs diff {lib_err:.3e}")
    del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()
    for name, case in cases.items():
        if case[4] <= 256:  # above 256: the 64-column slice kernels
            _require_kernels(routes[name], f"the {name} shape",
                             flash_kernels(case[4]))
    # (label, shape, whether B2 and B3 are timed beside B1)
    for label, shape, backward in (
            ("flagship_d64", FLAGSHIP_ATTN, True),
            ("debug_200m_d64", DEBUG200M_ATTN, True),
            ("group5_d128", GROUP5_ATTN, True),
            ("group6_d64", GROUP6_ATTN, True),
            ("b100_g10_d128", B100_ATTN, False),
            ("b200_g12_d128", B200_ATTN, False),
            ("group5_d64", GROUP5_D64_ATTN, False),
            ("d192_g2_s1024", REPAIRED_FLASH["d192_g2_s1024"][:5], True),
            ("debug_300m_d192", DEBUG300M_ATTN, True),
            ("d256_g4_s2048", D256_ATTN, True)):
        t0 = time.perf_counter()
        at = _flash_at(inputs, rel, shape, label, flash_kernels(shape[4]),
                       backward)
        log(f"  {label}: checked and timed in {time.perf_counter() - t0:.1f} s")
        for e, kern in zip(entries, ("B1", "B2", "B3")):
            e[label] = at[kern]
            e["max_abs_err"] = max(e["max_abs_err"], at[kern]["max_abs_err"])
    return entries


def _require_kernels(taken: dict, where: str,
                     want: dict = WGMMA_KERNELS) -> None:
    """The profiler named each kernel of `want` ({kernel: CUDA kernel
    name}) at least once, and under that name only."""
    for kern, name in want.items():
        if not taken[kern] or not all(name in n for n in taken[kern]):
            raise AssertionError(f"{kern} did not take {name} at {where}: "
                                 f"the profiler named {taken[kern]}")


def _flash_at(inputs, rel, shape, label, expect: dict,
              backward: bool = True) -> dict:
    """B1-B3 at a training shape (B, S, Hq, Hkv, D), causal: each against
    its plain version, the CUDA kernel the profiler names (those of
    `expect`, see _require_kernels), then kernel /
    plain / SDPA (forward for B1, backward for B2 and B3, the median of
    LIB_ROUNDS rounds) ms and the bound; with backward=False only B1 and
    SDPA's forward are timed (B2 and B3 checked, not timed). Above head_dim
    128 the SDPA backend the profiler names is logged, and a backward no
    backend takes is logged and recorded as None. -> {kernel: entry}."""
    import torch
    import torch.nn.functional as F

    from luminaai_tpu_torch.ops import flash_attention as fa

    b, s, hq, hkv, d = shape
    q, k, v, do, g_lse = inputs(b, s, hq, hkv, d)
    args = dict(scale=d ** -0.5, causal=True, window=0)
    o, lse = fa.flash_fwd(q, k, v, **args)
    o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, **args)
    delta = ((do.float() * o_ref.float()).sum(-1).transpose(1, 2)
             - g_lse).contiguous()
    got = {"B1": [o], "B2": [fa.flash_bwd_dq(q, k, v, do, lse_ref, delta,
                                             **args)],
           "B3": list(fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, **args))}
    torch.cuda.synchronize()
    lse_err = (lse - lse_ref).abs().max().item()
    del o, lse
    want = {"B1": [o_ref],
            "B2": [fa.flash_bwd_dq_ref(q, k, v, do, lse_ref, delta, **args)]}
    torch.cuda.empty_cache()
    want["B3"] = list(fa.flash_bwd_dkv_ref(q, k, v, do, lse_ref, delta,
                                           **args))
    torch.cuda.synchronize()
    errs, abs_err = {}, {}
    for kern in got:
        errs[kern] = max(rel(a, w) for a, w in zip(got[kern], want[kern]))
        abs_err[kern] = max((a.float() - w.float()).abs().max().item()
                            for a, w in zip(got[kern], want[kern]))
    del got, want, o_ref
    torch.cuda.empty_cache()
    log(f"B1-B3 vs plain [{label}: B{b} S{s} Hq{hq} Hkv{hkv} D{d} causal]: "
        f"rel err " + ", ".join(f"{kern} {e:.3e}" for kern, e in errs.items())
        + f"; lse abs err {lse_err:.3e} (tol {FLASH_REL_TOL} x max, lse "
        f"{LSE_TOL})")
    if max(errs.values()) > FLASH_REL_TOL or not lse_err <= LSE_TOL:
        raise AssertionError(f"flash kernels disagree with plain ({label})")
    calls = {
        "B1": (lambda: fa.flash_fwd(q, k, v, **args),
               lambda: fa.flash_fwd_ref(q, k, v, **args)),
        "B2": (lambda: fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, **args),
               lambda: fa.flash_bwd_dq_ref(q, k, v, do, lse_ref, delta,
                                           **args)),
        "B3": (lambda: fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, **args),
               lambda: fa.flash_bwd_dkv_ref(q, k, v, do, lse_ref, delta,
                                            **args)),
    }
    taken = flash_taken({kern: kc for kern, (kc, _) in calls.items()})
    log(f"  kernels taken [{label}]: " + "; ".join(
        f"{kern} {', '.join(n) or 'not measured'}" for kern, n in
        taken.items()))
    _require_kernels(taken, label, expect)
    ms, plain_ms = {}, {}
    for kern, (kc, pc) in calls.items():
        if kern != "B1" and not backward:
            continue
        ms[kern] = cuda_ms(kc, 20)
        plain_ms[kern] = cuda_ms(pc, 2, 1) if backward else None
        torch.cuda.empty_cache()
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    with torch.no_grad():
        lib_fwd = cuda_ms(sdpa, 20)
    lib_bwd, lib_bwd_rounds, backend = None, None, None
    if d > 128:  # which SDPA kernels run at this head_dim, both ways
        try:
            backend = kernel_names(lambda: torch.autograd.grad(
                sdpa(), (qt, kt, vt), dot))
        except RuntimeError as exc:  # no backend takes its backward
            backend = kernel_names(sdpa)
            log(f"SDPA backward at the {label} shape: none ({exc})")
            backward = False
        log(f"SDPA kernels at the {label} shape: {', '.join(backend)}")
    if backward:
        out = sdpa()
        lib_bwd_rounds = [cuda_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), 10)
            for _ in range(LIB_ROUNDS)]
        lib_bwd = statistics.median(lib_bwd_rounds)
        log(f"SDPA backward at the {label} shape, {LIB_ROUNDS} rounds (ms): "
            + ", ".join(f"{x:.4f}" for x in lib_bwd_rounds))
        del out
    del qt, kt, vt, dot

    pairs = b * hq * _band_pairs(s, True, 0)
    act, kv, stat = b * s * hq * d * 2, b * s * hkv * d * 2, b * hq * s * 4
    work = {  # (flops, bytes): each input read once, each output written once
        "B1": (4 * d * pairs, act + 2 * kv + act + stat),
        "B2": (6 * d * pairs, 2 * act + 2 * kv + 2 * stat + act),
        "B3": (8 * d * pairs, 2 * act + 2 * kv + 2 * stat + 2 * kv),
    }
    out = {}
    for kern, (flops, nbytes) in work.items():
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_BF16_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        lib_ms = lib_fwd if kern == "B1" else lib_bwd
        out[kern] = {
            "ms": ms.get(kern), "plain_ms": plain_ms.get(kern),
            "library_ms": lib_ms,
            "library_rounds_ms": None if kern == "B1" else lib_bwd_rounds,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": abs_err[kern], "rel_err": errs[kern],
            "kernels_taken": taken[kern], "shape": [b, s, hq, hkv, d]}
        if kern not in ms:
            continue
        log(f"{kern} at the {label} shape: kernel {ms[kern]:.4f} ms, plain "
            f"{_ms(plain_ms[kern])}, library (SDPA "
            f"{'fwd' if kern == 'B1' else 'bwd'}) {_ms(lib_ms)}, bound "
            f"{bound:.4f} ms ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB; "
            f"{100 * bound / ms[kern]:.1f}% of bound)")
    out["B1"]["lse_err"] = lse_err
    if backend is not None:
        out["B1"]["sdpa_kernels"] = backend
    del q, k, v, do, lse_ref, delta
    torch.cuda.empty_cache()
    return out


def _ms(t) -> str:
    return "not measured" if t is None else f"{t:.4f} ms"


# The port's kernels by family, as torch.profiler names them.
KERNEL_FAMILIES = {"B1-B3": "flash_", "B4": "grouped_kernel",
                   "B5": "ragged_decode_kernel"}


def _families(kernels, busy_ms: float) -> dict:
    """{family: [ms, share of busy]} over (name, ms, count) rows."""
    out = {}
    for fam, key in KERNEL_FAMILIES.items():
        ms = sum(t for name, t, _ in kernels if key in name)
        if ms > 0:
            out[fam] = [ms, ms / busy_ms]
    log("  port kernels: " + ", ".join(
        f"{fam} {ms:.3f} ms ({100 * share:.1f}% of busy)"
        for fam, (ms, share) in out.items()))
    return out


def profile_decode(dec, steps: int = 5) -> None:
    """Where one decode step's time goes: host wall per step (synchronised,
    no profiler), then the card's busy time per step and its largest
    kernels from torch.profiler (CUPTI). Prints "not measured" when the
    profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    dec.step_logits()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        dec.step_logits()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            dec.step_logits()
        torch.cuda.synchronize()
    kernels = [
        (e.key, e.self_device_time_total / 1e3 / steps, e.count // steps)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
    ]
    busy_ms = sum(ms for _, ms, _ in kernels)
    if busy_ms <= 0:
        log(f"decode step: host wall {wall_ms:.3f} ms; device time not "
            "measured (the profiler recorded no device events)")
        return
    kernels.sort(key=lambda r: -r[1])
    log(f"decode step (8 lanes): host wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
        f"{sum(n for _, _, n in kernels)} kernel launches")
    for name, ms, n in kernels[:8]:
        log(f"  {ms:8.4f} ms  x{n:<4d} {name[:90]}")
    _families(kernels, busy_ms)


PROMPT_LENGTHS = (10, 40, 64, 65, 150, 300, 450, 600)


def _prompt(n: int, i: int) -> str:
    words = "the quick brown fox jumps over the lazy dog while serving "
    text = (f"request {i}: " + words * (n // len(words) + 1))[:n]
    return text


def _filled_decoder(engine):
    """A decoder of its own (LANES slots) holding the PROMPT_LENGTHS
    prompts, each prefilled whole or in chunks as the decoder chooses."""
    dec = engine.make_stepwise(num_slots=LANES, page_size=PAGE)
    for i, n in enumerate(PROMPT_LENGTHS):
        p = engine.tokenizer.encode_text(_prompt(n, i))
        slot = dec.acquire_slot()
        st = dec.start_prefill(slot, p, max_new_tokens=32)
        if st is None:
            dec.prefill_into_slot(slot, p, max_new_tokens=32)
        else:
            while dec.advance_prefill(st) is None:
                pass
    return dec


def _serve_burst(engine, label: str, health_ok, reset, read):
    """LANES concurrent greedy POST /v1/generate requests (prompts of
    PROMPT_LENGTHS characters, 32 new tokens each) through the port's
    ChatServer. `reset()` sets the launch counters to 0 just before the
    burst, `read()` reads them just after. -> (launches, summary)."""
    from luminaai_tpu_torch.serving.server import ChatServer

    server = ChatServer(engine, num_slots=LANES, page_size=PAGE)
    httpd = server.make_httpd("127.0.0.1", 0)
    host, port = httpd.server_address[:2]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://{host}:{port}"

    def post(body):
        req = urllib.request.Request(
            url + "/v1/generate", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())

    try:
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            health = json.loads(r.read())
        if r.status != 200 or not health_ok(health["model"]):
            raise AssertionError(f"bad /health: {health}")
        post({"prompt": "warm up", "max_new_tokens": 2, "temperature": 0})
        dec = server.batcher.decoder
        steps0, pf0 = dec.steps, dec.prefill_forwards
        dsec0 = server.batcher.decode_seconds
        bodies = [{"prompt": _prompt(n, i), "max_new_tokens": 32,
                   "temperature": 0}
                  for i, n in enumerate(PROMPT_LENGTHS)]
        reset()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(bodies)) as pool:
            replies = list(pool.map(post, bodies))
        wall = time.perf_counter() - t0
        launches = read()
        steps, prefills = dec.steps - steps0, dec.prefill_forwards - pf0
        dsec = server.batcher.decode_seconds - dsec0
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()

    tokens = 0
    for (code, body), n in zip(replies, PROMPT_LENGTHS):
        if code != 200 or not isinstance(body.get("text"), str) or not (
                1 <= body.get("tokens", 0) <= 32):
            raise AssertionError(f"bad {label} reply for a {n}-char prompt: "
                                 f"{body}")
        if body["tokens"] < 32 and body["stopped"] != "eos":
            raise AssertionError(f"{label}: a reply stopped short: {body}")
        tokens += body["tokens"]
    if steps <= 0:
        raise AssertionError(f"{label}: no decode step ran")
    lat = sorted(body["latency_s"] for _, body in replies)
    log(f"{label}: {len(replies)} concurrent requests (prompts "
        f"{min(PROMPT_LENGTHS)}-{max(PROMPT_LENGTHS)} tokens), {tokens} "
        f"tokens in {wall:.3f}s = {tokens / wall:.1f} tok/s; {steps} decode "
        f"steps, {1e3 * dsec / steps:.3f} ms/step, {prefills} prefill "
        f"forwards; peak lanes {stats['max_batch_seen']}; latency median "
        f"{statistics.median(lat):.3f}s, max {lat[-1]:.3f}s")
    return launches, {"requests": len(replies), "tokens": tokens,
                      "wall_s": wall, "decode_steps": steps,
                      "prefill_forwards": prefills,
                      "decode_step_ms": 1e3 * dsec / steps,
                      "tokens_per_s": tokens / wall, "latency_max_s": lat[-1]}


def phase_serve(dev, entry: dict) -> dict:
    import torch

    from luminaai_tpu_torch.config import ConfigPresets
    from luminaai_tpu_torch.inference.chat import build_engine
    from luminaai_tpu_torch.ops import ragged_paged_attention as rpa

    cfg = ConfigPresets.get("b1", use_moe=False)
    t0 = time.perf_counter()
    engine = build_engine(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in engine.model.parameters())
    log(f"engine: b1 dense, {cfg.num_layers} layers, hidden "
        f"{cfg.hidden_size}, {n_params / 1e6:.1f}M params, built in "
        f"{time.perf_counter() - t0:.1f}s")

    # First decode step of the same prompts through a decoder of its own:
    # kernel attention vs plain attention on the same pool state.
    dec = _filled_decoder(engine)
    lk = dec.step_logits()
    lp = dec.step_logits("plain")
    torch.cuda.synchronize()
    if lk.shape != (LANES, cfg.vocab_size) or not torch.isfinite(lk).all():
        raise AssertionError(f"bad decode logits {tuple(lk.shape)}")
    logit_err = (lk - lp).abs().max().item()
    logit_tol = LOGIT_RTOL * lp.abs().max().item()
    agree = int((lk.argmax(-1) == lp.argmax(-1)).sum().item())
    log(f"first decode step logits, kernel vs plain: max_abs_err="
        f"{logit_err:.3e} (tol {logit_tol:.3e} = {LOGIT_RTOL} x max|logit|"
        f"), argmax agree {agree}/{LANES}")
    if logit_err > logit_tol:
        raise AssertionError("decode logits disagree with the plain version")
    profile_decode(dec)
    del dec, lk, lp
    torch.cuda.empty_cache()

    def reset():
        rpa.ragged_paged_attention.launches = 0

    launches, summary = _serve_burst(
        engine, "serve",
        lambda model: model["hidden_size"] == cfg.hidden_size, reset,
        lambda: rpa.ragged_paged_attention.launches)
    want = summary["decode_steps"] * cfg.num_layers
    log(f"kernel launches during serving: {launches} (decode steps x "
        f"layers = {want})")
    if launches != want:
        raise AssertionError("the decode path did not run through the kernel")
    entry["launches"] = launches
    if "plane" in PHASES:
        summary["plane"] = phase_serving_plane(dev, engine, entry)
    return summary


# ---------------------------------------------------------------------------
# Phase 10: the serving plane, `serve` in a child process
# ---------------------------------------------------------------------------
PLANE_USER, PLANE_PASSWORD = "smoke", "Chip-Smoke-Pa55word"
# A second account (its own tenant bucket) drives the 429 check.
PLANE_FLOOD_USER = "flood"
# 1536 system characters + the chat template's 5 tokens before the user
# turn: the shared encoded prefix spans 12 full 128-row pages.
PLANE_SYSTEM_CHARS, PLANE_SHARED_PAGES = 1536, 12
PLANE_REQUESTS, PLANE_NEW_TOKENS, PLANE_ARENA_PAGES = 16, 32, 64
# The tenant bucket holds a flood of 8 lanes + 8 queued; past 8 queued
# requests the server sheds. (The secure gate's sliding window allows 60
# requests a minute per user: each user stays under it.)
PLANE_RATE, PLANE_BURST, PLANE_QUEUE_DEPTH = 20.0, 16, 8
PLANE_READY_S = 300.0  # /healthz must answer 200 this soon after the start
PLANE_TURN_CHARS = (32, 257)  # user turns: 32-256 characters
PLANE_LONG_TOKENS = 96  # the shed and drain requests' budgets
# The served model: the weights of phase 3's engine (build_engine(b1
# dense, seed 0)). A CPU rehearsal points these at a small preset.
PLANE_MODEL = ["--preset", "b1", "--dense", "--seed", "0"]
SPEC_PROMPT = "one two three four five six seven eight nine ten " * 12
# The JAX server's serving metric families, all of which the port's
# /metrics must carry.
SERVING_METRICS = (
    "serve_queue_wait_seconds", "serve_prefill_seconds",
    "serve_ttft_seconds", "serve_decode_step_seconds",
    "serve_token_latency_seconds", "serve_admissions_total",
    "serve_evictions_total", "serve_generations_total",
    "serve_decode_steps_total", "serving_requests_timed_out_total",
    "serving_prefill_chunks_total", "tenant_ttft_seconds",
    "tenant_requests_timed_out_total", "serve_active_lanes",
    "serve_queue_depth", "kv_pool_slots_in_use", "kv_pool_pages_in_use",
    "kv_pool_fragmentation_rows", "serve_prefix_cache_hits_total",
    "serve_prefix_cache_misses_total", "serve_prefill_tokens_saved_total",
    "serve_prefix_remote_hits_total", "prefix_cache_pages_cached",
    "prefix_cache_page_refs", "prefix_cache_evictions",
    "prefix_cache_pages_budget", "serve_http_requests_total",
    "serve_request_seconds", "serve_stream_duration_seconds",
    "serve_tokens_out_total", "serving_overload_rejections_total",
    "tenant_requests_total", "tenant_tokens_in_total",
    "tenant_tokens_out_total", "tenant_requests_shed_total", "serve_ready",
    "serve_draining", "serve_decode_step_seconds_median",
)
_METRIC_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? "
    r"([-+]?[0-9.]+([eE][-+]?[0-9]+)?|NaN|[-+]Inf)$")


def _plane_texts(seed: int = 0):
    """The shared system prompt (PLANE_SYSTEM_CHARS characters of words
    drawn from a seed) and PLANE_REQUESTS user turns of 32-256
    characters, each starting "Request NN: " so every turn leaves the
    shared prefix inside page 12."""
    import numpy as np

    rng = np.random.RandomState(seed)
    words = ("the quick brown fox jumps over a lazy dog while the server "
             "splices cached pages of one shared system prompt").split()

    def text(n):
        out = ""
        while len(out) < n:
            out += words[rng.randint(len(words))] + " "
        return out[:n]

    system = text(PLANE_SYSTEM_CHARS)
    turns = []
    for i in range(PLANE_REQUESTS):
        head = f"Request {i:02d}: "
        turns.append(head + text(int(rng.randint(*PLANE_TURN_CHARS))
                                 - len(head)))
    return system, turns


def _chat_body(system: str, user: str, **kw) -> dict:
    body = {"messages": [{"role": "system", "content": system},
                         {"role": "user", "content": user}],
            "max_new_tokens": PLANE_NEW_TOKENS, "temperature": 0}
    body.update(kw)
    return body


def _call(url: str, path: str, body=None, token=None, timeout=600.0,
          headers=None):
    """One HTTP request -> (status, headers, JSON payload or text)."""
    import urllib.error

    h = {"Content-Type": "application/json", **(headers or {})}
    if token:
        h["Authorization"] = f"Bearer {token}"
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, headers=h)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            code, hdr, raw = r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        code, hdr, raw = e.code, dict(e.headers), e.read()
    try:
        payload = json.loads(raw)
    except ValueError:
        payload = raw.decode(errors="replace")
    return code, hdr, payload


def _stream(url: str, path: str, body: dict, token=None,
            timeout: float = 600.0, times=None) -> dict:
    """One {"stream": true} request: the token ids of its frames, its done
    frame, the client-side time to the first token frame and the wall.
    `times`, when given, gets each token frame's arrival (perf_counter)
    as it comes."""
    h = {"Content-Type": "application/json"}
    if token:
        h["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(
        url + path, data=json.dumps({**body, "stream": True}).encode(),
        headers=h)
    t0 = time.perf_counter()
    ids, done, ttft, errors = [], None, None, []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        code = r.status
        for line in r:
            line = line.strip()
            if not line.startswith(b"data: ") or line == b"data: [DONE]":
                continue
            ev = json.loads(line[6:])
            if "token" in ev:
                if ttft is None:
                    ttft = time.perf_counter() - t0
                if times is not None:
                    times.append(time.perf_counter())
                ids.append(int(ev["token"]))
            elif ev.get("done"):
                done = ev
            elif "error" in ev:
                errors.append(ev["error"])
    return {"code": code, "ids": ids, "done": done, "errors": errors,
            "ttft_s": ttft, "wall_s": time.perf_counter() - t0}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def serve_child(argv: list) -> int:
    """`--serve-child CTRL_PORT -- <cli argv>`: run the port's CLI main
    (`serve ...`) and answer the kernels' launch counters on a control
    port: GET returns them (and the /healthz status the server answered
    as its warmup began), POST sets them to 0."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    sep = argv.index("--")
    ctrl_port, cli_argv = int(argv[0]), argv[sep + 1:]
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.ops import gmm as tg
    from luminaai_tpu_torch.ops import ragged_paged_attention as rpa
    from luminaai_tpu_torch.serving import server as srv

    held = {}
    real_warmup = srv.ChatServer._warmup

    def warmup(self):
        # What /healthz answers as the warmup begins (its readiness gate;
        # __init__ is still running, so not through handle()).
        held["warmup_healthz"] = 200 if self._ready.is_set() else 503
        return real_warmup(self)

    srv.ChatServer._warmup = warmup

    def counts():
        k = rpa.ragged_paged_attention
        return {"B5": k.launches, "B5_global": k.launches_global,
                "B4a": tg.gmm.launches, "B4b": tg.tgmm.launches,
                "warmup_healthz": held.get("warmup_healthz")}

    class Control(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self):
            data = json.dumps(counts()).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            self._send()

        def do_POST(self):
            rpa.ragged_paged_attention.launches = 0
            rpa.ragged_paged_attention.launches_global = 0
            tg.reset_launches()
            self._send()

    ctrl = ThreadingHTTPServer(("127.0.0.1", ctrl_port), Control)
    threading.Thread(target=ctrl.serve_forever, daemon=True).start()
    return cli.main(cli_argv)


class _Proc:
    """A child process CMD run in CWD (default LOG_DIR), its output in
    LOG_DIR/NAME.log."""

    def __init__(self, name: str, cmd: list, log_dir: Path, cwd=None):
        log_dir.mkdir(parents=True, exist_ok=True)
        self.name = name
        self.log_path = log_dir / f"{name}.log"
        self._log = open(self.log_path, "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd, stdout=self._log,
                                     stderr=subprocess.STDOUT,
                                     cwd=str(cwd or log_dir))

    def tail(self, chars: int = 4000) -> str:
        """The end of the child's log, without the /healthz and /slo
        probes."""
        self._log.flush()
        lines = [x for x in self.log_path.read_text().splitlines()
                 if "GET /healthz" not in x and "GET /slo" not in x]
        return "\n".join(lines)[-chars:]

    def stop(self, timeout: float = 120.0) -> int:
        """SIGTERM (drain), then the exit code."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout=timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            self._log.close()


class _ServeChild(_Proc):
    """`python -m luminaai_tpu_torch serve ARGV` in a child process (this
    script with --serve-child), its log in CWD/NAME.log."""

    def __init__(self, name: str, argv: list, cwd: Path,
                 port: int = 0):
        self.ctrl = _free_port()
        self.port = port or _free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        super().__init__(name, [
            sys.executable, "-u", str(Path(__file__).resolve()),
            "--serve-child", str(self.ctrl), "--", "serve", *argv,
            "--port", str(self.port)], cwd)

    def _ctrl(self, post: bool = False) -> dict:
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.ctrl}/", data=b"" if post else None)
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())

    def counts(self) -> dict:
        return self._ctrl()

    def reset(self) -> dict:
        return self._ctrl(post=True)

    def wait_ready(self) -> dict:
        """Poll /healthz until it answers 200: the statuses seen over HTTP
        (in order, deduplicated), the one the server gave as its warmup
        began, and the seconds since the start."""
        seen = []
        while True:
            if self.proc.poll() is not None:
                raise AssertionError(
                    f"{self.name}: serve exited {self.proc.returncode}:\n"
                    f"{self.log_path.read_text()[-3000:]}")
            if time.perf_counter() - self.t0 > PLANE_READY_S:
                raise AssertionError(f"{self.name}: /healthz not 200 after "
                                     f"{PLANE_READY_S}s (saw {seen})")
            try:
                code, _, body = _call(self.url, "/healthz", timeout=5)
            except OSError:
                time.sleep(0.02)
                continue
            if not seen or seen[-1][0] != code:
                seen.append((code, body.get("status")))
            if code == 200:
                return {"http": seen,
                        "warmup": self.counts()["warmup_healthz"],
                        "ready_s": time.perf_counter() - self.t0}
            time.sleep(0.02)

    def stats(self) -> dict:
        return _call(self.url, "/stats")[2]


def _auth(url: str, user: str = PLANE_USER) -> str:
    code, _, body = _call(url, "/v1/auth",
                          {"user": user, "password": PLANE_PASSWORD})
    if code != 200 or not body.get("token"):
        raise AssertionError(f"/v1/auth: {code} {body}")
    return body["token"]


def _quantiles(xs):
    xs = sorted(xs)
    return {"p50": statistics.median(xs),
            "p95": xs[min(len(xs) - 1, math.ceil(0.95 * len(xs)) - 1)]}


def _plane_burst(child: "_ServeChild", token: str, system: str, turns,
                 label: str, want_hits: bool, layers: int) -> dict:
    """The shared-prefix traffic: PLANE_REQUESTS streamed chat requests,
    the first alone (it fills the cache), then 8 and 7 at a time, with a
    pause before each group that refills the tenant bucket. Launch
    counters set to 0 just before, read just after; /stats around it. B5
    must launch decode steps x `layers` times (0 on a CPU rehearsal)."""
    deadline = time.perf_counter() + 120
    while True:  # nothing else in flight
        st = child.stats()
        if not st["active_lanes"] and not st["queue_depth"]:
            break
        if time.perf_counter() > deadline:
            raise AssertionError(f"{label}: server never went idle: {st}")
        time.sleep(0.05)
    before = child.stats()
    child.reset()
    results = [None] * PLANE_REQUESTS

    def one(i):
        results[i] = _stream(child.url, "/v1/chat",
                             _chat_body(system, turns[i]), token)

    t0 = time.perf_counter()
    one(0)
    groups = []
    for group in (range(1, 9), range(9, PLANE_REQUESTS)):
        time.sleep(PLANE_BURST / PLANE_RATE)
        tg0 = time.perf_counter()
        with ThreadPoolExecutor(len(group)) as pool:
            list(pool.map(one, group))
        groups.append((sum(len(results[i]["ids"]) for i in group),
                       time.perf_counter() - tg0))
    wall = time.perf_counter() - t0
    launches = child.counts()
    after = child.stats()
    for i, r in enumerate(results):
        if r["code"] != 200 or r["errors"] or r["done"] is None or (
                len(r["ids"]) < PLANE_NEW_TOKENS
                and r["done"]["stopped"] != "eos"):
            raise AssertionError(f"{label}: request {i} failed: {r}")
    steps = after["decode_steps"] - before["decode_steps"]
    # The whole decode tick (the step and its bookkeeping: telemetry,
    # events, emits, finishes) is what the full server adds to; the step
    # alone is kept beside it.
    tsec = after["tick_seconds"] - before["tick_seconds"]
    dsec = after["decode_seconds"] - before["decode_seconds"]
    pc0, pc1 = before.get("prefix_cache", {}), after.get("prefix_cache", {})
    hits = pc1.get("hits", 0) - pc0.get("hits", 0)
    spliced = pc1.get("pages_spliced", 0) - pc0.get("pages_spliced", 0)
    ttft_all = [r["ttft_s"] for r in results]
    tokens = sum(len(r["ids"]) for r in results)
    out = {
        "requests": len(results), "tokens": tokens, "decode_steps": steps,
        "host_ms_per_step": 1e3 * tsec / max(steps, 1),
        "step_ms_per_step": 1e3 * dsec / max(steps, 1),
        "tokens_per_s_8way": groups[0][0] / groups[0][1],
        "tokens_per_s_all": tokens / wall,
        "ttft_s": _quantiles(ttft_all),
        "ttft_hits_s": _quantiles(ttft_all[1:]),
        "ttft_first_s": ttft_all[0], "prefix_hits": hits,
        "pages_spliced": spliced, "launches": launches,
        "results": results,
    }
    log(f"{label}: {len(results)} requests ({tokens} tokens, {steps} "
        f"decode steps), host {out['host_ms_per_step']:.2f} ms a decode "
        f"tick ({out['step_ms_per_step']:.2f} in the step), {out['tokens_per_s_8way']:.1f} tokens/s over 8 at once; "
        f"TTFT p50 {out['ttft_s']['p50'] * 1e3:.1f} ms, p95 "
        f"{out['ttft_s']['p95'] * 1e3:.1f} ms (the 15 after the first: "
        f"p50 {out['ttft_hits_s']['p50'] * 1e3:.1f}, p95 "
        f"{out['ttft_hits_s']['p95'] * 1e3:.1f}; first "
        f"{ttft_all[0] * 1e3:.1f}); prefix hits {hits}, pages spliced "
        f"{spliced}; launches {launches}")
    want = steps * layers
    if steps <= 0 or launches["B5"] != want:
        raise AssertionError(f"{label}: B5 launched {launches['B5']} times, "
                             f"decode steps x {layers} = {want}")
    if want_hits:
        if launches["B5_global"] != launches["B5"]:
            raise AssertionError(f"{label}: not every decode step took the "
                                 f"global table: {launches}")
        if hits != PLANE_REQUESTS - 1 or spliced != (
                (PLANE_REQUESTS - 1) * PLANE_SHARED_PAGES):
            raise AssertionError(
                f"{label}: prefix hits {hits}, pages spliced {spliced}; want "
                f"{PLANE_REQUESTS - 1} and {PLANE_REQUESTS - 1} x "
                f"{PLANE_SHARED_PAGES}")
    elif launches["B5_global"]:
        raise AssertionError(f"{label}: global-table launches with the "
                             "cache off")
    return out


def _next_logits(engine, ids):
    """The single-request path's fp32 logits [V] after `ids`."""
    import torch

    with torch.inference_mode():
        logits, _ = engine._prefill_chunked(list(ids),
                                            engine._prefill_chunk_len())
    return logits[0]


def _near_tie_check(engine, prompt_ids, want, got, label: str) -> dict:
    """`got` must equal `want` (greedy's tokens) up to a position where
    greedy's top two logits are within LOGIT_RTOL x max|logit|: the first
    tokens equal, and at the first divergence the in-process engine's
    logits after the prompt and want[:i] show a near-tie."""
    if not want or not got or want[0] != got[0]:
        raise AssertionError(f"{label}: first tokens differ: {want[:4]} vs "
                             f"{got[:4]}")
    n = min(len(want), len(got))
    i = next((j for j in range(n) if want[j] != got[j]), None)
    if i is None:
        if len(want) != len(got):
            raise AssertionError(f"{label}: lengths {len(want)} vs "
                                 f"{len(got)}")
        return {"equal": True}
    logits = _next_logits(engine, list(prompt_ids) + list(want[:i]))
    top = logits.topk(2).values
    gap = (top[0] - top[1]).item()
    tol = LOGIT_RTOL * logits.abs().max().item()
    log(f"{label}: diverge at token {i} of {n}: greedy's top-two gap "
        f"{gap:.3e} (near-tie tolerance {tol:.3e})")
    if gap > tol:
        raise AssertionError(f"{label}: divergence at {i} is not a near-tie")
    return {"equal": False, "diverge_at": i, "gap": gap, "tol": tol}


def _plane_in_process(dev, engine, rpa_entry: dict, system: str,
                      turns) -> dict:
    """The prefix-cache path in this process: a hit's first decode step
    against the same request decoded cold (1e-2 x max|logit|), B5's
    global-table launches against the plain version on the lanes' shared
    arena pages, and B5 timed at that shape."""
    import torch

    from luminaai_tpu_torch.ops import ragged_paged_attention as rpa

    def admit(dec, turn):
        ids = engine.encode_chat([{"role": "system", "content": system},
                                  {"role": "user", "content": turn}])
        slot = dec.acquire_slot()
        st = dec.start_prefill(slot, ids, max_new_tokens=PLANE_NEW_TOKENS)
        info = None
        while info is None:
            info = dec.advance_prefill(st)
        dec.flush_harvests()
        return slot, info

    warm = engine.make_stepwise(num_slots=LANES, page_size=PAGE,
                                prefix_cache_pages=PLANE_ARENA_PAGES)
    cold = engine.make_stepwise(num_slots=LANES, page_size=PAGE)
    s0, first = admit(warm, turns[0])
    warm.release_slot(s0)
    slots = [admit(warm, turns[i]) for i in range(1, LANES + 1)]
    hits = [info["prefix"]["hit_pages"] for _, info in slots]
    if hits != [PLANE_SHARED_PAGES] * LANES or first["prefix"]["hit_pages"]:
        raise AssertionError(f"in-process prefix hits {hits}")
    c_slot, _ = admit(cold, turns[1])
    lw = warm.step_logits()
    lw_plain = warm.step_logits("plain")
    lc = cold.step_logits()
    w, c = lw[slots[0][0]], lc[c_slot]
    tol = LOGIT_RTOL * c.abs().max().item()
    hit_err = (w - c).abs().max().item()
    plain_err = (lw - lw_plain).abs().max().item()
    plain_tol = LOGIT_RTOL * lw_plain.abs().max().item()
    log(f"prefix hit vs cold, first decode step: max_abs_err {hit_err:.3e} "
        f"(tol {tol:.3e} = {LOGIT_RTOL} x max|logit|), argmax "
        f"{int(w.argmax())} vs {int(c.argmax())}; B5 global table vs plain "
        f"(8 lanes on {PLANE_SHARED_PAGES} shared arena pages): "
        f"{plain_err:.3e} (tol {plain_tol:.3e})")
    if not torch.isfinite(lw).all() or hit_err > tol or plain_err > plain_tol:
        raise AssertionError("a prefix hit's decode disagrees")

    # B5 alone at this shape: one layer's pool, the decoder's global table.
    lengths = torch.as_tensor(
        [int(warm._pos[s]) + 1 for s in range(LANES)], dtype=torch.int32,
        device=dev)
    meta = rpa.LaneMeta(lengths=lengths, page_table=warm._table,
                        page_size=PAGE, identity_pages=False,
                        global_pages=True)
    k, v = warm._flat[0]
    cfg = engine.config
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim()
    gen = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(LANES, 1, hq, d, generator=gen, device=dev).to(k.dtype)
    out = rpa.ragged_paged_attention(q, k, v, meta)
    ref = rpa.ragged_paged_attention_ref(q, k, v, meta)
    err = (out.float() - ref.float()).abs().max().item()
    ms = ms_graph = plain_ms = None
    if dev.type == "cuda":
        ms = cuda_ms(lambda: rpa.ragged_paged_attention(q, k, v, meta), 200)
        ms_graph = graph_ms(
            lambda: rpa.ragged_paged_attention(q, k, v, meta), 32)
        plain_ms = cuda_ms(
            lambda: rpa.ragged_paged_attention_ref(q, k, v, meta), 20)
    resident = int(lengths.sum().item())
    shared_rows = PLANE_SHARED_PAGES * PAGE
    # Bytes: each K/V row the lanes attend, read once (a shared arena page
    # counts once, however many lanes read it); operations: every lane's
    # own band.
    rows_of_page = {}
    table = warm._table.cpu().tolist()
    for lane, n in enumerate(lengths.tolist()):
        for j in range(-(-n // PAGE)):
            pid = table[lane][j]
            rows_of_page[pid] = max(rows_of_page.get(pid, 0),
                                    min(PAGE, n - j * PAGE))
    unique_rows = sum(rows_of_page.values())
    bytes_moved = (unique_rows * hkv * d * 2 * 2 + 2 * LANES * hq * d * 2
                   + LANES * warm.pool.pages * 4 + LANES * 4)
    flops = 4 * resident * hq * d
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    # Library yardstick (never called by the port): SDPA with the length
    # mask over each lane's pages gathered through the global table, timed
    # with the gather (the same function from the pool) and without it
    # (over K/V gathered beforehand). It gathers only the pages the
    # longest lane reaches, through an index cast once, outside the
    # timing.
    import torch.nn.functional as F

    kp, vp = warm.pool.caches[0]
    n_pages = -(-int(lengths.max()) // PAGE)
    idx = warm._table[:, :n_pages].long().contiguous()

    def gather(t):
        flat = t.view(-1, *t.shape[2:])  # [slots * pages, PAGE, hkv, d]
        return flat[idx].reshape(
            LANES, n_pages * PAGE, hkv, d).transpose(1, 2)

    qs = q.transpose(1, 2)
    mask = (torch.arange(n_pages * PAGE, device=dev)[None, :]
            < lengths[:, None].long())[:, None, None, :]

    def sdpa(kk, vv):
        return F.scaled_dot_product_attention(qs, kk, vv, attn_mask=mask,
                                              enable_gqa=True)

    kg, vg = gather(kp), gather(vp)
    lib_err = (sdpa(kg, vg).transpose(1, 2).float()
               - ref.float()).abs().max().item()
    lib_ms = lib_sdpa_ms = None
    if dev.type == "cuda":
        lib_ms = cuda_ms(lambda: sdpa(gather(kp), gather(vp)), 50)
        lib_sdpa_ms = cuda_ms(lambda: sdpa(kg, vg), 50)
    del kg, vg
    glob = {"ms": ms, "graph_ms": ms_graph, "plain_ms": plain_ms,
            "max_abs_err": err,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms, "library_sdpa_only_ms": lib_sdpa_ms,
            "library_max_abs_err": lib_err,
            "lengths": [int(x) for x in lengths.tolist()],
            "shared_rows_per_lane": shared_rows, "unique_rows": unique_rows}
    log(f"B5 global table at the phase-10 shape (8 lanes, "
        f"{resident} resident rows, {shared_rows} of each lane's on shared "
        f"arena pages, {unique_rows} distinct): {ms} ms ({ms_graph} ms from a "
        f"CUDA graph), plain {plain_ms} "
        f"ms, library (gather through the table + SDPA with the length "
        f"mask) {lib_ms} ms, SDPA alone {lib_sdpa_ms} ms (max diff to "
        f"plain {lib_err:.3e}), bound "
        f"{glob['bound_ms']:.4f} ms, max_abs_err {err:.3e} (tol "
        f"{KERNEL_TOL})")
    if err > KERNEL_TOL:
        raise AssertionError("B5 (global table) disagrees with plain")
    rpa_entry["global_form"] = glob
    return {"hit_vs_cold_err": hit_err, "hit_vs_cold_tol": tol,
            "global_vs_plain_err": plain_err}


def _no_continuous_check(engine) -> dict:
    """`--no-continuous` (MicroBatcher -> generate_batch) against the
    continuous server, in process over the same engine: 8 greedy requests
    at once to each; the MicroBatcher's replies are generate_batch's
    (decoded alike), and each matches the continuous server's tokens up to
    a near-tie (_near_tie_check). The window is 200 ms so the 8 requests
    form one batch."""
    from luminaai_tpu_torch.ops import ragged_paged_attention as rpa
    from luminaai_tpu_torch.serving.server import ChatServer

    kern = rpa.ragged_paged_attention
    prompts = [_prompt(n, i) for i, n in enumerate((10, 20, 30, 40, 50, 60,
                                                    63, 64))]
    ids = [engine.tokenizer.backend.encode(p) for p in prompts]
    out = {}
    for name, kw in (("micro", {"continuous": False, "max_batch": LANES,
                                "batch_window_ms": 200.0}),
                     ("continuous", {})):
        server = ChatServer(engine, num_slots=LANES, page_size=PAGE,
                            slo=False, watchdog=None, **kw)
        httpd = server.make_httpd("127.0.0.1", 0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        bodies = [{"prompt": p, "max_new_tokens": PLANE_NEW_TOKENS,
                   "temperature": 0} for p in prompts]
        try:
            fwd0 = engine.decode_forwards
            kern.launches = kern.launches_global = 0
            with ThreadPoolExecutor(LANES) as pool:
                if name == "micro":
                    out[name] = list(pool.map(
                        lambda b: _call(url, "/v1/generate", b), bodies))
                else:
                    out[name] = list(pool.map(
                        lambda b: _stream(url, "/v1/generate", b), bodies))
            launched = (kern.launches, kern.launches_global)
            fwds = engine.decode_forwards - fwd0
            batches = server.batcher.max_batch_seen
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.close()
        if name == "micro":
            # generate_batch's decode: one B5 launch a layer for each of
            # its batched decode forwards, all in the local-table form.
            cuda = engine.model.device.type == "cuda"
            want = fwds * engine.config.num_layers if cuda else 0
            log(f"--no-continuous: B5 launches {launched[0]} (decode "
                f"forwards {fwds} x layers = {want}), global-table "
                f"launches {launched[1]}")
            if batches != LANES:
                raise AssertionError(
                    f"the MicroBatcher ran batches of {batches}")
            if fwds < 1 or launched != (want, 0):
                raise AssertionError("generate_batch's decode did not run "
                                     "through the kernel")
            out["launches"] = {"B5": launched[0], "B5_global": launched[1],
                               "decode_forwards": fwds}
    direct = engine.generate_batch(ids, max_new_tokens=PLANE_NEW_TOKENS,
                                   temperature=0.0)
    checks = []
    for i, ((code, _, body), (toks, _), cont) in enumerate(
            zip(out["micro"], direct, out["continuous"])):
        if code != 200 or body["text"] != engine.tokenizer.decode(toks) or (
                body["tokens"] != len(toks)):
            raise AssertionError(f"MicroBatcher reply {i} is not "
                                 f"generate_batch's: {body}")
        checks.append(_near_tie_check(engine, ids[i], cont["ids"], toks,
                                      f"no-continuous request {i}"))
    n_equal = sum(c["equal"] for c in checks)
    log(f"--no-continuous: one batch of {LANES} (generate_batch); replies "
        f"equal the continuous server's in {n_equal}/{LANES}, the others "
        f"diverge at a near-tie")
    return {"equal": n_equal, "requests": LANES, **out["launches"]}


def phase_serving_plane(dev, engine, rpa_entry: dict) -> dict:
    """Phase 10: the serving plane. In process: a prefix hit's first decode
    step against the cold request, B5's global table against its plain
    version and timed. Then `serve --preset b1 --dense --seed 0` (the
    weights of `engine`) in three children started together, all with a
    secure gate, a tenant bucket and a queue depth of 8: the full server
    with the prefix cache (64 pages), the same without telemetry, SLOs and
    watchdog ("bare"), and the full server with the cache off. On the full
    one: readiness, 401, /v1/auth, 429, 503 + Retry-After, a 504 deadline;
    the shared-prefix traffic (launches, hits), against the bare one in
    turns (full, then bare) for the host ms a decode step; SSE against JSON, speculative
    against greedy, /metrics, /slo, /metrics/history and `top`, and
    SIGTERM with 4 requests in flight. The cache-off server takes the
    first round's traffic (TTFT). Then --no-continuous in process."""
    t_phase = time.perf_counter()
    # B5 launches a decode step (none where a CPU rehearsal runs this).
    layers = engine.config.num_layers if dev.type == "cuda" else 0
    system, turns = _plane_texts()
    a, b = (engine.encode_chat([{"role": "system", "content": system},
                                {"role": "user", "content": t}])
            for t in turns[:2])
    shared = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
    if shared // PAGE != PLANE_SHARED_PAGES:
        raise AssertionError(f"the shared prefix ({shared} tokens) does not "
                             f"span {PLANE_SHARED_PAGES} full pages")
    inproc = _plane_in_process(dev, engine, rpa_entry, system, turns)
    _release()

    base = [*PLANE_MODEL, "--num-slots",
            str(LANES), "--page-size", str(PAGE), "--secure", "--user",
            PLANE_USER, "--password", PLANE_PASSWORD, "--tenant-rate",
            str(PLANE_RATE), "--tenant-burst", str(PLANE_BURST),
            "--max-queue-depth", str(PLANE_QUEUE_DEPTH)]
    root = RUN_DIR / "plane"
    flight = root / "flight"
    from luminaai_tpu_torch.security.auth import SecurityManager

    (root / "main").mkdir(parents=True)
    if not SecurityManager(persist_path=str(root / "main" / "users.json")
                           ).create_user(PLANE_FLOOD_USER, PLANE_PASSWORD):
        raise AssertionError("could not create the second account")
    child = _ServeChild("serve", base + [
        "--prefix-cache-pages", str(PLANE_ARENA_PAGES),
        "--flight-dir", str(flight)], root / "main")
    others = {
        "bare": _ServeChild("serve_bare", base + [
            "--prefix-cache-pages", str(PLANE_ARENA_PAGES),
            "--no-telemetry", "--no-slo", "--no-watchdog"], root / "bare"),
        "cache_off": _ServeChild("serve_cache_off", base + [
            "--prefix-cache-pages", "0"], root / "cache_off"),
    }
    out = {"in_process": inproc}
    try:
        ready = child.wait_ready()
        log(f"serve child: /healthz {ready['warmup']} as its warmup began, "
            f"over HTTP {ready['http']}, 200 after {ready['ready_s']:.1f}s")
        if ready["warmup"] != 503 or ready["http"][-1][0] != 200:
            raise AssertionError("/healthz did not go 503 -> 200")
        out["ready_s"] = ready["ready_s"]
        url = child.url
        # Auth and limits.
        code, _, body = _call(url, "/v1/chat", _chat_body(system, turns[0]))
        if code != 401:
            raise AssertionError(f"no token: {code} {body}")
        token = _auth(url)
        # The second user's bucket: empty inputs (charged, then refused 400
        # by the validator, no model work) until a 429.
        flood = _auth(url, PLANE_FLOOD_USER)
        refused = None
        for n in range(2 * PLANE_BURST):
            code, hdr, body = _call(url, "/v1/generate", {"prompt": " "},
                                    flood)
            if code == 429:
                refused = (n, body, hdr.get("Retry-After"))
                break
            if code != 400:
                raise AssertionError(f"unexpected {code} {body}")
        if refused is None or "tenant rate limit" not in refused[1][
                "error"] or refused[1].get("retry_after", 0) < 1:
            raise AssertionError(f"no 429 from the tenant bucket: {refused}")
        # Shedding: 8 lanes busy and PLANE_QUEUE_DEPTH requests queued,
        # the next one shed with 503 + Retry-After before the gate.
        long_body = {"prompt": "shed me", "temperature": 0,
                     "max_new_tokens": PLANE_LONG_TOKENS}
        pool = ThreadPoolExecutor(LANES + PLANE_QUEUE_DEPTH)
        futs = [pool.submit(_call, url, "/v1/generate", long_body, token)
                for _ in range(LANES)]
        _wait_for(child, lambda st: st["active_lanes"] == LANES, "8 lanes",
                  futs=futs)
        futs += [pool.submit(_call, url, "/v1/generate", long_body, token)
                 for _ in range(PLANE_QUEUE_DEPTH)]
        _wait_for(child, lambda st: st["queue_depth"] >= PLANE_QUEUE_DEPTH,
                  f"{PLANE_QUEUE_DEPTH} queued requests", futs=futs)
        shed = _call(url, "/v1/generate", long_body, token)
        bad = [f.result()[::2] for f in futs if f.result()[0] != 200]
        pool.shutdown()
        if shed[0] != 503 or int(shed[1].get("Retry-After", 0)) < 1:
            raise AssertionError(f"no 503 + Retry-After: {shed}")
        if bad:
            raise AssertionError(f"admitted requests failed: {bad[:2]}")
        time.sleep(PLANE_BURST / PLANE_RATE + 0.2)
        # A deadline that passes in the queue: 504, as the JAX server.
        code, _, body = _call(url, "/v1/generate",
                              {"prompt": "late", "timeout_s": 1e-4}, token)
        if code != 504 or "deadline exceeded" not in body.get("error", ""):
            raise AssertionError(f"deadline: {code} {body}")
        log(f"gate: 401 without a token; 429 after {refused[0]} charged "
            f"requests (Retry-After {refused[2]}); 503 + Retry-After "
            f"{shed[1].get('Retry-After')} past queue depth "
            f"{PLANE_QUEUE_DEPTH}; 504 past a deadline")
        time.sleep(PLANE_BURST / PLANE_RATE)
        for other in others.values():
            other.wait_ready()
        tokens = {"bare": _auth(others["bare"].url),
                  "cache_off": _auth(others["cache_off"].url)}
        # The full and the bare server in turns.
        rounds = []
        for r, (sys_r, turns_r) in enumerate(((system, turns),)):
            pair = {}
            for key, target, tok in (("full", child, token),
                                     ("bare", others["bare"],
                                      tokens["bare"])):
                burst = _plane_burst(target, tok, sys_r, turns_r,
                                     f"serve {key}, round {r + 1}",
                                     want_hits=True, layers=layers)
                pair[key] = {k: v for k, v in burst.items()
                             if k != "results"}
                if key == "full":
                    launches = burst["launches"]
                    rpa_entry["launches"] = (rpa_entry["launches"] or 0) + (
                        launches["B5"])
                    rpa_entry["launches_plane"] = rpa_entry.get(
                        "launches_plane", 0) + launches["B5"]
                    glob = rpa_entry.setdefault("global_form", {})
                    glob["launches"] = glob.get("launches", 0) + (
                        launches["B5_global"])
            rounds.append(pair)
        out["cache_on"] = rounds[0]["full"]
        out["rounds"] = rounds
        off = others.pop("cache_off")
        burst = _plane_burst(off, tokens["cache_off"], system, turns,
                             "serve, cache off", want_hits=False,
                             layers=layers)
        off.stop()
        out["cache_off"] = {k: v for k, v in burst.items() if k != "results"}
        bare = others.pop("bare")
        bare.stop()
        # SSE against JSON: the same request, after one that caches all of
        # its full pages, so both splice the same chain.
        time.sleep(PLANE_BURST / PLANE_RATE)
        body = _chat_body(system, turns[3] + " again", max_new_tokens=24)
        _call(url, "/v1/chat", body, token)
        code, _, as_json = _call(url, "/v1/chat", body, token)
        streamed = _stream(url, "/v1/chat", body, token)
        if code != 200 or streamed["done"] is None or (
                as_json["reply"] != streamed["done"]["reply"]
                or as_json["tokens"] != len(streamed["ids"])
                or engine.tokenizer.decode(streamed["ids"])
                != as_json["reply"]):
            raise AssertionError(f"SSE differs from JSON: {as_json} vs "
                                 f"{streamed}")
        log(f"SSE: {len(streamed['ids'])} tokens, equal to the JSON reply")
        # Speculative against greedy.
        spec_body = {"prompt": SPEC_PROMPT, "max_new_tokens": 32,
                     "temperature": 0, "repetition_penalty": 1.0}
        child.reset()
        code, _, spec = _call(url, "/v1/generate",
                              {**spec_body, "speculative": True}, token)
        spec_ids = _stream(url, "/v1/generate",
                           {**spec_body, "speculative": True}, token)
        # Its prefill chunks and its k-row verify forwards all take the
        # plain paged attention (Sq > 1), by design: B5 never launches.
        spec_launches = child.counts()
        if spec_launches["B5"] or spec_launches["B5_global"]:
            raise AssertionError(f"B5 ran in a speculative request: "
                                 f"{spec_launches}")
        greedy = _stream(url, "/v1/generate", spec_body, token)
        if code != 200 or "speculative" not in spec or (
                spec_ids["done"].get("speculative") is None):
            raise AssertionError(f"speculative reply: {spec}")
        prompt_ids = engine.tokenizer.backend.encode(SPEC_PROMPT)
        tie = _near_tie_check(engine, prompt_ids, greedy["ids"],
                              spec_ids["ids"], "speculative")
        out["speculative"] = {**spec["speculative"], **tie,
                              "B5": spec_launches["B5"],
                              "B5_global": spec_launches["B5_global"]}
        log(f"speculative: B5 launches {spec_launches['B5']} (global "
            f"{spec_launches['B5_global']}), {spec['tokens']} tokens, "
            f"{spec['speculative']['verify_calls']} verify calls, "
            f"{spec['speculative']['tokens_per_verify']} tokens a verify; "
            f"{'equal to greedy' if tie['equal'] else 'near-tie divergence'}")
        # Observability.
        code, hdr, text = _call(url, "/metrics")
        lines = [x for x in text.splitlines() if x and not x.startswith("#")]
        bad = [x for x in lines if not _METRIC_LINE.match(x)]
        names = {x.split()[2] for x in text.splitlines()
                 if x.startswith("# TYPE ")}
        missing = [m for m in SERVING_METRICS if m not in names]
        values = {x.split()[0]: float(x.split()[1]) for x in lines
                  if "{" not in x}
        if code != 200 or bad or missing or values[
                "serve_prefix_cache_hits_total"] < PLANE_REQUESTS - 1 or (
                values["serving_overload_rejections_total"] < 1) or (
                values["serving_requests_timed_out_total"] < 1):
            raise AssertionError(f"/metrics: {code}, unparsed {bad[:3]}, "
                                 f"missing {missing}")
        code_slo, _, slo = _call(url, "/slo")
        code_h, _, hist = _call(url, "/metrics/history?max_points=20")
        if code_slo != 200 or "serve_ttft_p95" not in slo.get(
                "objectives", {}) or code_h != 200 or not hist.get("series"):
            raise AssertionError(f"/slo {code_slo}, /metrics/history "
                                 f"{code_h}")
        rc, top = _top_once(url)
        if rc != 0 or "lumina top" not in top:
            raise AssertionError(f"top: {rc} {top[-500:]}")
        log(f"/metrics: {len(lines)} samples parsed, all "
            f"{len(SERVING_METRICS)} serving families; /slo "
            f"{sorted(slo['objectives'])}; /metrics/history "
            f"{len(hist['series'])} series; top rendered "
            f"{len(top.splitlines())} lines")
        # Drain: SIGTERM with 4 requests in flight.
        time.sleep(PLANE_BURST / PLANE_RATE)
        pool = ThreadPoolExecutor(4)
        futs = [pool.submit(_call, url, "/v1/generate",
                            {"prompt": f"drain {i}", "temperature": 0,
                             "max_new_tokens": PLANE_LONG_TOKENS}, token)
                for i in range(4)]
        _wait_for(child, lambda st: st["active_lanes"] == 4, "4 lanes",
                  futs=futs)
        t_sig = time.perf_counter()
        rc = child.stop()
        drained = [f.result() for f in futs]
        pool.shutdown()
        dumps = sorted(flight.glob("flightrec-*-drain.jsonl"))
        log(f"drain: exit {rc} {time.perf_counter() - t_sig:.1f}s after "
            f"SIGTERM; in-flight replies {[d[0] for d in drained]} "
            f"({[d[2].get('tokens') for d in drained]} tokens); flight "
            f"record {[d.name for d in dumps]}")
        if rc != 0 or any(d[0] != 200 for d in drained) or not dumps:
            raise AssertionError("drain did not finish the in-flight work")
    except BaseException:
        for c in (child, *others.values()):
            log(f"{c.name} child log (tail):\n{c.tail()}")
        raise
    finally:
        for c in (child, *others.values()):
            c.stop()
    _release()
    on, off = out["cache_on"], out["cache_off"]
    full = [r["full"]["host_ms_per_step"] for r in out["rounds"]]
    bare = [r["bare"]["host_ms_per_step"] for r in out["rounds"]]
    full_step = [r["full"]["step_ms_per_step"] for r in out["rounds"]]
    bare_step = [r["bare"]["step_ms_per_step"] for r in out["rounds"]]
    out["overhead_ms_per_step"] = statistics.mean(full) - statistics.mean(
        bare)
    out["step_overhead_ms_per_step"] = (statistics.mean(full_step)
                                        - statistics.mean(bare_step))
    log(f"TTFT p50/p95 cache on {on['ttft_s']['p50'] * 1e3:.1f}/"
        f"{on['ttft_s']['p95'] * 1e3:.1f} ms, off "
        f"{off['ttft_s']['p50'] * 1e3:.1f}/{off['ttft_s']['p95'] * 1e3:.1f} "
        f"ms; host ms a decode tick (step and bookkeeping), full server "
        f"{', '.join(f'{x:.2f}' for x in full)}, bare "
        f"{', '.join(f'{x:.2f}' for x in bare)} (in turns; mean difference "
        f"{out['overhead_ms_per_step']:+.2f} ms; in the step alone "
        f"{out['step_overhead_ms_per_step']:+.2f} ms)")
    out["no_continuous"] = _no_continuous_check(engine)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"serving plane: phase wall {out['wall_s']:.1f} s ({_smi()})")
    return out


def _top_once(url: str, *extra) -> tuple:
    """(exit code, stdout) of `top --url URL --once` through the CLI's
    main in this process (a child would pay torch's import for one
    frame)."""
    try:
        return _cli_capture(["top", "--url", url, "--once", *extra])
    except SystemExit as e:  # a failed fetch
        return int(e.code or 2), ""


def _wait_for(child: "_ServeChild", cond, what: str, timeout=120.0,
              futs=()):
    """Poll /stats until cond holds (failing early if a request of `futs`
    already came back)."""
    deadline = time.perf_counter() + timeout
    while True:
        st = child.stats()
        if cond(st):
            return st
        back = [f.result()[:3:2] for f in futs if f.done()]
        if back or time.perf_counter() > deadline:
            raise AssertionError(f"never saw {what}: {st}; replies {back}")
        time.sleep(0.01)


def _model_flops_per_step(cfg, n_params: int) -> float:
    """Model FLOPs of one optimizer step (no recompute counted): 3 x the
    forward's 2 x (matmul parameters) per token, with the tied head's
    V x H counted once for the head and the embedding lookup free, plus
    3 x 4 x D flops per attended (q, k) pair per layer and q head."""
    tokens = cfg.batch_size * cfg.seq_length
    # Norm scales are not matmul parameters: two per layer and the final.
    matmul_params = n_params - cfg.hidden_size * (2 * cfg.num_layers + 1)
    pairs = (cfg.batch_size * cfg.num_heads
             * _band_pairs(cfg.seq_length, True, cfg.attention_window or 0))
    return 3 * (2 * matmul_params * tokens
                + 4 * cfg.head_dim() * pairs * cfg.num_layers)


def profile_train_step(trainer, batch, want: dict = WGMMA_KERNELS) -> dict:
    """Card busy time and top kernels of one optimizer step, from
    torch.profiler (CUPTI). The flash kernels it names must be those of
    `want` (see _require_kernels): a profiler that records no device time
    fails the check."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.state, _ = trainer.train_step(trainer.state, batch)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
    ]
    busy_ms = sum(ms for _, ms, _ in kernels)
    if busy_ms <= 0:
        raise AssertionError("profiled train step: the profiler recorded no "
                             "device events, so it names no kernel")
    kernels.sort(key=lambda r: -r[1])
    log(f"profiled train step (under the profiler): host wall "
        f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), "
        f"{sum(n for _, _, n in kernels)} kernel launches")
    for name, ms, n in kernels[:10]:
        log(f"  {ms:9.3f} ms  x{n:<5d} {name[:90]}")
    flash = [[_short(name), ms, n] for name, ms, n in kernels
             if "flash_" in name]
    log("  flash kernels taken: " + ", ".join(
        f"{name} x{n} {ms:.3f} ms" for name, ms, n in flash))
    taken = {"B1": [n for n, _, _ in flash if "fwd" in n],
             "B2": [n for n, _, _ in flash if "bwd_dq" in n],
             "B3": [n for n, _, _ in flash if "bwd_dkv" in n]}
    _require_kernels(taken, "a train step", want)
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "port_kernels": _families(kernels, busy_ms),
            "flash_kernels": flash,
            "top_kernels": [[name[:90], ms, n]
                            for name, ms, n in kernels[:10]]}


def phase_train(dev, entries: list) -> dict:
    import torch

    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.config import ConfigPresets
    from luminaai_tpu_torch.ops import flash_attention as fa
    from luminaai_tpu_torch.ops.fused import global_norm
    from luminaai_tpu_torch.parallel import train_step as ts
    from luminaai_tpu_torch.training.trainer import Trainer

    cfg = ConfigPresets.get("b1", use_moe=False, max_steps=TRAIN_STEPS,
                            num_layers=B1_TRAIN_LAYERS,
                            output_dir=str(RUN_DIR / "train_dense"))
    accum = cfg.gradient_accumulation_steps
    t0 = time.perf_counter()
    trainer = Trainer(cfg, cli._synthetic_batches(cfg), device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in trainer.state.params)
    log(f"trainer: b1 dense, {cfg.num_layers} layers, hidden "
        f"{cfg.hidden_size}, {n_params / 1e6:.1f}M fp32 params, batch "
        f"{cfg.batch_size} x {cfg.seq_length}, accumulation {accum}, "
        f"remat {cfg.remat_policy}, built in {time.perf_counter() - t0:.1f}s")

    # The first step's batch through the plain attention (no kernel), for
    # the comparison with the trainer's first step below.
    first = trainer._to_device(next(iter(cli._synthetic_batches(cfg)())))
    cfg.use_flash_attention = False
    grads, m = ts._accumulate_grads(
        ts.make_loss_fn(cfg, trainer.model), trainer.state.params, first,
        None, accum)
    plain_loss, plain_norm = float(m["loss"]), float(global_norm(grads))
    cfg.use_flash_attention = True
    del grads, m
    torch.cuda.empty_cache()

    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    summary = trainer.train()
    launches = {"B1": fa.flash_fwd.launches, "B2": fa.flash_bwd_dq.launches,
                "B3": fa.flash_bwd_dkv.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    hist = summary["history"]
    for i, h in enumerate(hist, 1):
        log(f"  step {i}: loss {h['loss']:.4f} grad_norm "
            f"{h['grad_norm']:.4f} lr {h['learning_rate']:.3e} "
            f"{h['step_seconds'] * 1e3:.1f} ms "
            f"{h['tokens_per_sec']:.0f} tok/s")
    losses, norms = _check_run(hist, plain_loss, plain_norm,
                               "plain attention")
    per_step = cfg.num_layers * accum
    want = {"B1": 2 * per_step * TRAIN_STEPS, "B2": per_step * TRAIN_STEPS,
            "B3": per_step * TRAIN_STEPS}
    log(f"flash kernel launches during training: {launches} (want {want}: "
        f"{cfg.num_layers} layers x {accum} micro-batches x {TRAIN_STEPS} "
        f"steps, B1 twice for the remat recompute)")
    if launches != want:
        raise AssertionError("the training path did not run through the "
                             "flash kernels as expected")
    for e, kern in zip(entries, ("B1", "B2", "B3")):
        e["launches"] = launches[kern]
        e["launches_per_step"] = launches[kern] // TRAIN_STEPS

    steady = _steady_step(cfg, hist, n_params, "train step", "")
    log(f"  peak memory allocated {peak_gb:.2f} GB")
    prof = profile_train_step(trainer, first)
    trainer.close()
    return {"steps": TRAIN_STEPS, "losses": losses, "grad_norms": norms,
            **steady, "peak_memory_gb": peak_gb,
            "first_step_loss_plain": plain_loss,
            "first_step_grad_norm_plain": plain_norm, **prof}


def _check_run(hist, plain_loss: float, plain_norm: float, what: str,
               steps: int = TRAIN_STEPS, falling: bool = True):
    """`steps` finite losses and grad norms, a falling loss (_short_run),
    and the first step within LOSS_RTOL / GRAD_NORM_RTOL of its re-run
    through `what`. -> (losses, grad norms)."""
    losses = _short_run(hist, steps, "training", falling)
    norms = [h["grad_norm"] for h in hist]
    loss_err = abs(hist[0]["loss"] - plain_loss) / abs(plain_loss)
    norm_err = abs(hist[0]["grad_norm"] - plain_norm) / abs(plain_norm)
    log(f"first step, kernels vs {what}: loss {hist[0]['loss']:.5f} vs "
        f"{plain_loss:.5f} (rel {loss_err:.2e}, tol {LOSS_RTOL}), grad_norm "
        f"{hist[0]['grad_norm']:.5f} vs {plain_norm:.5f} (rel "
        f"{norm_err:.2e}, tol {GRAD_NORM_RTOL})")
    if loss_err > LOSS_RTOL or norm_err > GRAD_NORM_RTOL:
        raise AssertionError(f"the kernels' first step disagrees with the "
                             f"{what}'s")
    return losses, norms


def _steady_step(cfg, hist, n_params: int, label: str, note: str) -> dict:
    """Median host wall of steps 2..TRAIN_STEPS, tokens/s and the
    model-FLOPs share of H100_BF16_FLOPS (n_params: the matmul parameters
    a token runs through)."""
    step_s = statistics.median(h["step_seconds"] for h in hist[1:])
    tokens = cfg.batch_size * cfg.seq_length
    flops = _model_flops_per_step(cfg, n_params)
    mfu = flops / step_s / H100_BF16_FLOPS
    log(f"{label} (steps 2-{TRAIN_STEPS}, median): host wall "
        f"{step_s * 1e3:.1f} ms, {tokens / step_s:.0f} tokens/s, model "
        f"FLOPs{note} {flops / 1e12:.2f} TFLOP/step = {100 * mfu:.2f}% of "
        f"989 TFLOP/s")
    return {"step_ms_median": step_s * 1e3, "tokens_per_s": tokens / step_s,
            "mfu": mfu}


# ---------------------------------------------------------------------------
# The MoE slice: B4 (gmm, tgmm), b1 served with its experts, the bench
# flagship trained.
# ---------------------------------------------------------------------------
# Serving: b1 (hidden 2048, 8 experts of intermediate 5504); a decode step
# at 8 lanes routes 16 (token, expert) pairs into one 128-row buffer.
# Training: bench.py's flagship widths (hidden 1024, 8 experts of 2816); a
# micro-batch of 16 x 2048 tokens is 65,536 pair rows. The hybrid MoE+MoD
# model of phase 12: debug_200m's widths (hidden 768, 8 experts of 2048); a
# micro-batch of 8 x 2048 tokens is 32,768 pair rows.
GMM_CASES = {
    # name: (rows, K, N, group sizes); the decode case leaves one expert
    # untouched and a 112-row tail, the training case a 436-row tail.
    "serve_wi": (128, 2048, 2 * 5504, [2, 3, 1, 0, 4, 2, 3, 1]),
    "serve_wo": (128, 5504, 2048, [2, 3, 1, 0, 4, 2, 3, 1]),
    "train_wi": (65536, 1024, 2 * 2816,
                 [9000, 8100, 7900, 8200, 8300, 7700, 8050, 7850]),
    "train_wo": (65536, 2816, 1024,
                 [9000, 8100, 7900, 8200, 8300, 7700, 8050, 7850]),
    "train_empty": (4096, 1024, 2 * 2816,
                    [1200, 0, 900, 700, 0, 600, 300, 100]),
    # The adaptive phase's expert counts at the flagship training shape:
    # 9 experts after add_expert, and 8 with two whole experts dropped
    # (expert dropout empties their groups).
    "train_e9_wi": (65536, 1024, 2 * 2816,
                    [7300, 7100, 6900, 7200, 7400, 6800, 7250, 6950, 7000]),
    "train_e9_wo": (65536, 2816, 1024,
                    [7300, 7100, 6900, 7200, 7400, 6800, 7250, 6950, 7000]),
    "train_e8_two_empty": (65536, 1024, 2 * 2816,
                           [10900, 0, 10800, 10700, 11000, 0, 10600,
                            10900]),
    # A 218-row tail.
    "debug200m_hybrid_wi": (32768, 768, 2 * 2048,
                            [4500, 4050, 3950, 4100, 4150, 3850, 4025,
                             3925]),
    "debug200m_hybrid_wo": (32768, 2048, 768,
                            [4500, 4050, 3950, 4100, 4150, 3850, 4025,
                             3925]),
}
# B4 kernel vs plain version, bf16 outputs: within 1e-2 x max|plain|. Both
# accumulate in fp32 and round once to bf16 (2^-8 relative), the sums in
# other orders, so an element may land on the neighbouring bf16 value.
GMM_REL_TOL = 1e-2
# bench.py:129-146 (_child_config "flagship"), copied literally, and two
# of flagship_tuned's levers (bench.py:119-128). Phase 6 keeps the
# nothing_saveable policy and fp32 moments; phase 11 adds the other two
# levers (TUNED_LEVERS: save_attn remat and bf16 Adam mu).
FLAGSHIP = dict(
    vocab_size=32768,
    hidden_size=1024,
    num_layers=10,
    num_heads=16,
    num_kv_heads=8,
    seq_length=2048,
    batch_size=16,
    use_moe=True,
    num_experts=8,
    moe_top_k=2,
    capacity_factor=1.25,
    load_balancing_weight=0.01,
    precision="bf16",
    use_flash_attention=True,
    gradient_checkpointing=True,
)
FLAGSHIP_LEVERS = dict(moe_dispatch="gmm", rope_dtype="bf16")


def _plain_gmm(lhs, rhs, group_sizes, out_dtype=None, transpose_rhs=False):
    """The plain grouped matmul (differentiable by autograd) in place of
    the kernel, for the re-runs the kernels' steps are held against."""
    from luminaai_tpu_torch.ops import gmm as tg

    return tg.gmm_ref(lhs, rhs, group_sizes, out_dtype, transpose_rhs)


def _grouped_mm(a, b, group_sizes):
    """One PyTorch call computing B4a (a [M, K], b [E, K, N]) or B4b (a =
    lhs^T [K, M], b = dout [M, N]) on the same operands:
    torch._grouped_mm, a yardstick only (the port never calls it). None
    where this torch lacks it or refuses the operands."""
    import torch

    offs = torch.cumsum(group_sizes, 0, dtype=torch.int32)

    def call():
        return torch._grouped_mm(a, b, offs=offs, out_dtype=torch.bfloat16)

    try:
        call()
        torch.cuda.synchronize()
    except (AttributeError, RuntimeError) as exc:
        log(f"  torch._grouped_mm unavailable: {str(exc).splitlines()[0]}")
        return None
    return call


def _gmm_bound(kept, touched, k, n, e, rows, tgmm=False):
    """(bound ms, bound_by, flops, bytes) of one B4 call: each input byte
    this run's data needs read once (the kept rows; the touched experts'
    weights), each output byte written once, 2 x kept x K x N flops."""
    flops = 2 * kept * k * n
    if tgmm:
        nbytes = kept * k * 2 + kept * n * 2 + e * k * n * 2 + e * 4
    else:
        nbytes = kept * k * 2 + touched * k * n * 2 + rows * n * 2 + e * 4
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", flops, nbytes)


def phase_gmm_kernels(dev) -> list:
    """B4a (gmm, and its transpose_rhs form) and B4b (tgmm) against their
    plain versions at the serving and training shapes; exact zeros in the
    tail and in empty groups; kernel / plain / library times and bounds."""
    import torch

    from luminaai_tpu_torch.ops import gmm as tg

    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    def rel(got, want):
        return ((got.float() - want.float()).abs().max()
                / want.float().abs().max()).item()

    cases, abs_err = {}, {"gmm": 0.0, "tgmm": 0.0}
    for name, (rows, k, n, sizes) in GMM_CASES.items():
        e, kept = len(sizes), sum(sizes)
        touched = sum(1 for x in sizes if x)
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
        lhs, dout = randn(rows, k), randn(rows, n)
        w = randn(e, k, n, scale=0.02)
        checks = {
            "gmm": (lambda: tg.gmm(lhs, w, gs),
                    lambda: tg.gmm_ref(lhs, w, gs)),
            "gmm_t": (lambda: tg.gmm(dout, w, gs, transpose_rhs=True),
                      lambda: tg.gmm_ref(dout, w, gs, transpose_rhs=True)),
            "tgmm": (lambda: tg.tgmm(lhs.t(), dout, gs),
                     lambda: tg.tgmm_ref(lhs.t(), dout, gs)),
        }
        errs = {}
        for key, (kern, plain) in checks.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"{key} output not finite ({name})")
            if key == "tgmm":
                errs[key] = rel(got, want)
                zero_ok = all(not got[g].any() for g, x in enumerate(sizes)
                              if x == 0)
            else:
                errs[key] = rel(got[:kept], want[:kept])
                zero_ok = not got[kept:].any()
            abs_err["tgmm" if key == "tgmm" else "gmm"] = max(
                abs_err["tgmm" if key == "tgmm" else "gmm"],
                (got.float() - want.float()).abs().max().item())
            if errs[key] > GMM_REL_TOL or not zero_ok:
                raise AssertionError(f"{key} disagrees with plain ({name}): "
                                     f"rel {errs[key]:.3e}, zeros {zero_ok}")
            del got, want
        # Per product: kernel ms, bound, and the library's one call on the
        # same operands (torch._grouped_mm; None where it refuses them).
        libs = {"gmm": _grouped_mm(lhs, w, gs),
                "gmm_t": _grouped_mm(dout, w.transpose(1, 2), gs),
                "tgmm": _grouped_mm(lhs.t(), dout, gs)}
        bounds = {"gmm": _gmm_bound(kept, touched, k, n, e, rows)[0],
                  "gmm_t": _gmm_bound(kept, touched, n, k, e, rows)[0],
                  "tgmm": _gmm_bound(kept, touched, k, n, e, rows,
                                     tgmm=True)[0]}
        case = {"rows": rows, "K": k, "N": n, "group_sizes": sizes,
                "rel_err": errs}
        for key, (kern, _) in checks.items():
            case[f"{key}_ms"] = cuda_ms(kern, 20)
            case[f"{key}_bound_ms"] = bounds[key]
            case[f"{key}_bound_share"] = bounds[key] / case[f"{key}_ms"]
            case[f"{key}_library_ms"] = (cuda_ms(libs[key], 20)
                                         if libs[key] else None)
        cases[name] = case
        log(f"B4 [{name}: rows {rows} K {k} N {n} kept {kept}, {touched}/{e}"
            f" experts]: rel err " + ", ".join(f"{a} {b:.2e}" for a, b in
                                               errs.items())
            + f" (tol {GMM_REL_TOL} x max)")
        for key in checks:
            lib_ms = case[f"{key}_library_ms"]
            log(f"  {key}: kernel {case[key + '_ms']:.4f} ms, bound "
                f"{case[key + '_bound_ms']:.4f} ms "
                f"({100 * case[key + '_bound_share']:.1f}% of bound), "
                f"library (torch._grouped_mm) "
                + (f"{lib_ms:.4f} ms" if lib_ms else "not measured"))
        del libs
        if name == "train_wi":
            headline = dict(rows=rows, k=k, n=n, e=e, kept=kept,
                            touched=touched, gs=gs, lhs=lhs, dout=dout, w=w,
                            sizes=sizes)
        else:
            del lhs, dout, w
        torch.cuda.empty_cache()

    # Headline numbers at the training wi shape: the largest B4 work on
    # the main path (forward, recompute and grad products).
    h = headline
    entries = []
    for kern in ("gmm", "tgmm"):
        if kern == "gmm":
            run = lambda: tg.gmm(h["lhs"], h["w"], h["gs"])  # noqa: E731
            plain = lambda: tg.gmm_ref(h["lhs"], h["w"], h["gs"])  # noqa
            lib = _grouped_mm(h["lhs"], h["w"], h["gs"])
        else:
            run = lambda: tg.tgmm(h["lhs"].t(), h["dout"], h["gs"])  # noqa
            plain = lambda: tg.tgmm_ref(h["lhs"].t(), h["dout"],  # noqa
                                        h["gs"])
            lib = _grouped_mm(h["lhs"].t(), h["dout"], h["gs"])
        ms = cuda_ms(run, 20)
        plain_ms = cuda_ms(plain, 3, 1)
        lib_ms = cuda_ms(lib, 20) if lib else None
        bound, bound_by, flops, nbytes = _gmm_bound(
            h["kept"], h["touched"], h["k"], h["n"], h["e"], h["rows"],
            tgmm=kern == "tgmm")
        log(f"B4{'a' if kern == 'gmm' else 'b'} {kern} at the training wi "
            f"shape: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"(torch._grouped_mm) {lib_ms} ms, bound {bound:.4f} ms "
            f"({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB; "
            f"{100 * bound / ms:.1f}% of bound)")
        entries.append({
            "name": kern,
            "route": "cuda",
            "source": "luminaai_tpu_torch/csrc/gmm.cu",
            "replaces": "luminaai_tpu/models/moe.py:806",
            "tpu_kernel": ("megablox gmm (gmm.py:314)" if kern == "gmm"
                           else "megablox tgmm (gmm.py:573)"),
            "launches": None,  # filled from the MoE serving and training
            "max_abs_err": abs_err[kern],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": bound_by,
            "library_ms": lib_ms,
            "library": "torch._grouped_mm",
            "shapes": {"rows": h["rows"], "K": h["k"], "N": h["n"],
                       "group_sizes": h["sizes"]},
            "cases": cases,
        })
    del headline, h
    torch.cuda.empty_cache()
    return entries


# Phase 4 serves b1 with its experts at half its depth (8 of 16 MoE
# layers, 2.3B parameters): the decode step's time is per layer.
SERVE_MOE_LAYERS = 8


def phase_serve_moe(dev, rpa_entry: dict, gmm_entries: list) -> dict:
    """b1 with its 8 experts (moe_dispatch="gmm", seeded bf16 weights) at
    SERVE_MOE_LAYERS layers behind the HTTP server: the first decode
    step's logits against a re-run through the plain gmm, one profiled
    decode step, then 8 concurrent requests with B4a launched exactly 2 x
    layers x (decode steps + prefill forwards) times."""
    import torch

    from luminaai_tpu_torch.config import ConfigPresets
    from luminaai_tpu_torch.inference.chat import build_engine
    from luminaai_tpu_torch.models import moe
    from luminaai_tpu_torch.ops import gmm as tg
    from luminaai_tpu_torch.ops import ragged_paged_attention as rpa

    cfg = ConfigPresets.get("b1", moe_dispatch="gmm",
                            num_layers=SERVE_MOE_LAYERS)
    t0 = time.perf_counter()
    engine = build_engine(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in engine.model.parameters())
    n_moe = cfg.num_moe_layers()
    log(f"engine: b1 with experts ({cfg.num_experts} x top-"
        f"{cfg.moe_top_k}, cf {cfg.capacity_factor}, {n_moe} MoE layers, "
        f"gmm), {n_params / 1e9:.3f}B params "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated), built "
        f"in {time.perf_counter() - t0:.1f}s")

    dec = _filled_decoder(engine)
    # Top-2 routing is discontinuous: the kernel and the plain version
    # round each expert output to bf16 after sums in other orders, so a
    # near-tied second choice may flip between the two runs and move that
    # lane's FFN output by O(1). Record each MoE layer's expert choices in
    # both runs: lanes routed alike in every layer are held to the dense
    # decode tolerance, lanes with a flip are counted and reported.
    routes, real_routing = [], moe.sort_routing

    def recording(probs, top_k, capacity):
        out = real_routing(probs, top_k, capacity)
        routes.append(torch.sort(out[0] // capacity, dim=-1).values)
        return out

    n0 = tg.gmm.launches
    moe.sort_routing = recording
    try:
        lk = dec.step_logits()
        if tg.gmm.launches - n0 != 2 * n_moe:
            raise AssertionError("a decode step did not run B4a twice per "
                                 "MoE layer")
        kernel_routes, routes = routes, []
        moe.GMM_OVERRIDE = _plain_gmm
        lp = dec.step_logits()
    finally:
        moe.GMM_OVERRIDE = None
        moe.sort_routing = real_routing
    torch.cuda.synchronize()
    if lk.shape != (LANES, cfg.vocab_size) or not torch.isfinite(lk).all():
        raise AssertionError(f"bad MoE decode logits {tuple(lk.shape)}")
    same = torch.stack([(a == b).flatten(1).all(1) for a, b in
                        zip(kernel_routes, routes)]).all(0)  # [lanes]
    n_same = int(same.sum().item())
    logit_tol = LOGIT_RTOL * lp.abs().max().item()
    all_err = (lk - lp).abs().max().item()
    logit_err = (lk - lp)[same].abs().max().item() if n_same else math.inf
    agree = int((lk.argmax(-1) == lp.argmax(-1))[same].sum().item())
    log(f"MoE first decode step logits, B4a vs plain gmm: {n_same}/{LANES} "
        f"lanes routed alike in all {n_moe} MoE layers; on those max_abs_err"
        f"={logit_err:.3e} (tol {logit_tol:.3e} = {LOGIT_RTOL} x "
        f"max|logit|), argmax agree {agree}/{n_same}; all lanes max_abs_err"
        f"={all_err:.3e}, argmax agree "
        f"{int((lk.argmax(-1) == lp.argmax(-1)).sum().item())}/{LANES}")
    if not n_same or logit_err > logit_tol or agree != n_same:
        raise AssertionError("MoE decode logits disagree with the plain gmm")
    profile_decode(dec)
    del dec, lk, lp
    torch.cuda.empty_cache()

    def reset():
        tg.reset_launches()
        rpa.ragged_paged_attention.launches = 0
        rpa.ragged_paged_attention.launches_global = 0

    launches, summary = _serve_burst(
        engine, "MoE serve", lambda model: model["moe"], reset,
        lambda: {"B4a": tg.gmm.launches, "B4b": tg.tgmm.launches,
                 "B5": rpa.ragged_paged_attention.launches})
    steps = summary["decode_steps"]
    want = {"B4a": 2 * n_moe * (steps + summary["prefill_forwards"]),
            "B4b": 0, "B5": steps * cfg.num_layers}
    log(f"kernel launches while serving with experts: {launches} (want "
        f"{want}: B4a 2 x {n_moe} MoE layers x (decode steps + prefill "
        f"forwards), B5 decode steps x layers)")
    if launches != want:
        raise AssertionError("MoE serving did not run through the kernels "
                             "as expected")
    gmm_entries[0]["launches"] = (gmm_entries[0]["launches"] or 0) + (
        launches["B4a"])
    gmm_entries[0]["launches_serve"] = launches["B4a"]
    rpa_entry["launches"] = (rpa_entry["launches"] or 0) + launches["B5"]
    rpa_entry["launches_serve_moe"] = launches["B5"]
    cached = _moe_prefix_burst(engine, n_moe, reset, lambda: {
        "B4a": tg.gmm.launches, "B4b": tg.tgmm.launches,
        "B5": rpa.ragged_paged_attention.launches,
        "B5_global": rpa.ragged_paged_attention.launches_global})
    gmm_entries[0]["launches"] += cached["launches"]["B4a"]
    rpa_entry["launches"] += cached["launches"]["B5"]
    del engine
    return {**summary, "first_step_logit_err": logit_err,
            "first_step_lanes_routed_alike": n_same,
            "prefix_cache": cached}


def _moe_prefix_burst(engine, n_moe: int, reset, read) -> dict:
    """Phase 10 with experts: LANES chat requests sharing the phase's
    system prompt through a ChatServer with the prefix cache on, the first
    alone, then the rest at once; B4a launched exactly 2 x MoE layers x
    (decode steps + prefill forwards), B5 decode steps x layers, every one
    with the global table, and LANES - 1 prefix hits."""
    from luminaai_tpu_torch.serving.server import ChatServer

    system, turns = _plane_texts()
    server = ChatServer(engine, num_slots=LANES, page_size=PAGE,
                        prefix_cache_pages=PLANE_ARENA_PAGES, slo=False,
                        watchdog=None)
    httpd = server.make_httpd("127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    dec = server.batcher.decoder
    try:
        if _call(url, "/v1/generate", {"prompt": "warm up",
                                       "max_new_tokens": 2})[0] != 200:
            raise AssertionError("MoE prefix-cache server: warm-up failed")
        steps0, pf0 = dec.steps, dec.prefill_forwards
        reset()
        t0 = time.perf_counter()
        replies = [_call(url, "/v1/chat", _chat_body(system, turns[0]))]
        with ThreadPoolExecutor(LANES - 1) as pool:
            replies += list(pool.map(
                lambda t: _call(url, "/v1/chat", _chat_body(system, t)),
                turns[1:LANES]))
        wall = time.perf_counter() - t0
        launches = read()
        steps, prefills = dec.steps - steps0, dec.prefill_forwards - pf0
        hits = dec.prefix_cache.stats()["hits"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
    if any(code != 200 for code, _, _ in replies):
        raise AssertionError(f"MoE prefix-cache replies: {replies[:2]}")
    want = {"B4a": 2 * n_moe * (steps + prefills), "B4b": 0,
            "B5": steps * engine.config.num_layers,
            "B5_global": steps * engine.config.num_layers}
    tokens = sum(body["tokens"] for _, _, body in replies)
    log(f"MoE serve, prefix cache on: {LANES} requests, {tokens} tokens in "
        f"{wall:.2f}s, {steps} decode steps, {prefills} prefill forwards, "
        f"prefix hits {hits}; launches {launches} (want {want})")
    if launches != want or hits != LANES - 1:
        raise AssertionError("MoE serving with the prefix cache did not run "
                             "through the kernels as expected")
    return {"launches": launches, "decode_steps": steps,
            "prefill_forwards": prefills, "prefix_hits": hits,
            "tokens": tokens, "wall_s": wall}


def phase_train_moe(dev, flash_entries: list, gmm_entries: list) -> dict:
    """The bench flagship widths with experts trained TRAIN_STEPS steps
    through Trainer: the first step against the same step through the
    plain gmm (routing-noise generator reseeded identically), exact B1-B4
    launch counts, finite and falling losses, step time, tokens/s,
    model-FLOPs share (active parameters), peak memory, MoE metrics."""
    import torch

    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.models import moe
    from luminaai_tpu_torch.ops import flash_attention as fa
    from luminaai_tpu_torch.ops import gmm as tg
    from luminaai_tpu_torch.ops.fused import global_norm
    from luminaai_tpu_torch.parallel import train_step as ts
    from luminaai_tpu_torch.training.trainer import Trainer

    cfg = Config(**{**FLAGSHIP, "num_layers": FLAGSHIP_TRAIN_LAYERS},
                 **FLAGSHIP_LEVERS, max_steps=TRAIN_STEPS,
                 output_dir=str(RUN_DIR / "train_moe"))
    accum = cfg.gradient_accumulation_steps
    n_moe = cfg.num_moe_layers()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, cli._synthetic_batches(cfg), device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in trainer.state.params)
    expert_ffn = 3 * cfg.hidden_size * cfg.intermediate_size
    n_active = n_params - n_moe * (cfg.num_experts - cfg.moe_top_k) * (
        expert_ffn)
    log(f"trainer: flagship MoE (bench.py:129-146 + gmm, bf16 RoPE), "
        f"{cfg.num_layers} layers, hidden {cfg.hidden_size}, "
        f"{cfg.num_experts} experts x {cfg.intermediate_size}, "
        f"{n_params / 1e6:.1f}M params ({n_active / 1e6:.1f}M active), "
        f"batch {cfg.batch_size} x {cfg.seq_length}, accumulation {accum}, "
        f"remat {cfg.remat_policy}, built in {time.perf_counter() - t0:.1f}s")

    first = trainer._to_device(next(iter(cli._synthetic_batches(cfg)())))
    gen_state = trainer.state.generator.get_state()
    moe.GMM_OVERRIDE = _plain_gmm
    try:
        grads, m = ts._accumulate_grads(
            ts.make_loss_fn(cfg, trainer.model), trainer.state.params,
            first, trainer.state.generator, accum)
        plain_loss, plain_norm = float(m["loss"]), float(global_norm(grads))
    finally:
        moe.GMM_OVERRIDE = None
    trainer.state.generator.set_state(gen_state)
    del grads, m
    torch.cuda.empty_cache()

    fa.reset_launches()
    tg.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    summary = trainer.train()
    launches = {"B1": fa.flash_fwd.launches, "B2": fa.flash_bwd_dq.launches,
                "B3": fa.flash_bwd_dkv.launches, "B4a": tg.gmm.launches,
                "B4b": tg.tgmm.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    hist = summary["history"]
    for i, h in enumerate(hist, 1):
        log(f"  step {i}: loss {h['loss']:.4f} (aux {h['aux_loss']:.4f}) "
            f"grad_norm {h['grad_norm']:.4f} lr {h['learning_rate']:.3e} "
            f"drop {h['moe_drop_rate']:.4f} {h['step_seconds'] * 1e3:.1f} "
            f"ms {h['tokens_per_sec']:.0f} tok/s")
    losses, norms = _check_run(hist, plain_loss, plain_norm,
                               "MoE step through the plain gmm")
    L, n = cfg.num_layers, accum * TRAIN_STEPS
    want = {"B1": 2 * L * n, "B2": L * n, "B3": L * n,
            "B4a": 6 * n_moe * n, "B4b": 2 * n_moe * n}
    log(f"kernel launches during MoE training: {launches} (want {want}: per "
        f"layer and micro-batch B1 forward + recompute, B2, B3; per MoE "
        f"layer B4a 2 forward + 2 recompute + 2 grad_lhs, B4b 2 grad_rhs)")
    if launches != want:
        raise AssertionError("MoE training did not run through the kernels "
                             "as expected")
    for e, kern in zip(flash_entries, ("B1", "B2", "B3")):
        e["launches"] = (e["launches"] or 0) + launches[kern]
        e["launches_per_step_moe"] = launches[kern] // TRAIN_STEPS
    for e, kern in zip(gmm_entries, ("B4a", "B4b")):
        e["launches"] = (e["launches"] or 0) + launches[kern]
        e["launches_train"] = launches[kern]
        e["launches_per_step"] = launches[kern] // TRAIN_STEPS

    steady = _steady_step(cfg, hist, n_active, "MoE train step",
                          " (active params)")
    last = hist[-1]
    moe_metrics = {k: last[k] for k in last if k.startswith("moe_")
                   or k == "expert_utilization"}
    log(f"  peak memory allocated {peak_gb:.2f} GB; last step "
        f"{json.dumps(moe_metrics)}")
    prof = profile_train_step(trainer, first)
    trainer.close()
    del trainer
    return {"steps": TRAIN_STEPS, "losses": losses, "grad_norms": norms,
            **steady, "peak_memory_gb": peak_gb,
            "first_step_loss_plain": plain_loss,
            "first_step_grad_norm_plain": plain_norm,
            "params": n_params, "active_params": n_active,
            "moe_metrics": moe_metrics, **prof}


# ---------------------------------------------------------------------------
# The training runtime: train from a data file with checkpoints, preempt,
# resume exactly, serve the checkpoint.
# ---------------------------------------------------------------------------
RUNTIME_STEPS = 6
RUNTIME_BATCH = 8  # x 2048 tokens, no accumulation
PREEMPT_AFTER = 2  # SIGTERM once run B's log shows this step
CORPUS_DOCS = 1500  # ~3 MB of text, ~190 packed batches of 8 x 2048


def _write_corpus(path: Path, seed: int = 0) -> int:
    """A JSONL text corpus drawn from `seed`: documents of 50-700 words
    over a 2,000-word vocabulary of random lowercase words. Returns its
    size in bytes."""
    import numpy as np

    rng = np.random.RandomState(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = ["".join(rng.choice(letters, rng.randint(2, 11)))
             for _ in range(2000)]
    with open(path, "w") as f:
        for _ in range(CORPUS_DOCS):
            words = rng.choice(vocab, rng.randint(50, 700))
            f.write(json.dumps({"text": " ".join(words) + "."}) + "\n")
    return path.stat().st_size


def _tensor_digest(tree: dict) -> str:
    """sha256 over a flat {name: CPU tensor} tree, names in order."""
    import torch

    h = hashlib.sha256()
    for name in sorted(tree):
        t = tree[name].contiguous()
        h.update(name.encode() + b"\0" + str(t.dtype).encode())
        h.update(t.view(-1).view(torch.uint8).numpy())  # no copy
    return h.hexdigest()


def _digest_in_background(model) -> dict:
    """_module_digest's value computed on a thread (sha256 releases the
    interpreter lock) from a host copy taken now: {"thread", "digest"}."""
    host = {n: p.detach().cpu() for n, p in model.named_parameters()}
    out: dict = {}

    def run():
        out["digest"] = _tensor_digest(host)

    out["thread"] = threading.Thread(target=run, daemon=True)
    out["thread"].start()
    return out


class _Sink:
    """The record file of the command a runtime child is running."""
    f = None

    def write(self, text: str) -> None:
        self.f.write(text)

    def flush(self) -> None:
        self.f.flush()


def runtime_child(argv: list) -> int:
    """Run the port's CLI main on `argv` (after `--`), recording for each
    optimizer step the sha256 of its input_ids, its loss and grad norm and
    the flash launches it made, and at the end the launch totals, the
    native data-path counts and the checkpoint saves and restores. With
    --logits PATH, also save the first decode step's logits of an engine
    built from the trainer's final in-memory weights. The post-training
    commands are recorded too (_posttrain_hooks): each LoRA step, with
    --compare the first one also through the plain attention; the
    evaluation; and with --chat-checks the chat engine's kernel-vs-plain
    first decode step, stream-vs-generate tokens and timings.

    `--then REC ARGV...` after a command runs another in this process
    once it has exited 0, recorded into REC (the launch counters, the
    peak memory and the records reset between commands): commands in
    sequence pay one process's start-up."""
    sep = argv.index("--")
    opts, cli_argv = argv[:sep], argv[sep + 1:]
    commands = [[opts[0]]]  # [record path, *argv] each
    for a in cli_argv:
        if a == "--then":
            commands.append([])
        else:
            commands[-1].append(a)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np
    import torch

    from luminaai_tpu_torch.ops import flash_attention as fa
    from luminaai_tpu_torch.ops import gmm as tg
    from luminaai_tpu_torch.ops import ragged_paged_attention as rpa
    from luminaai_tpu_torch.training import trainer as tr

    out = _Sink()
    held = {}
    orig_init = tr.Trainer.__init__

    def launches():
        return {"B1": fa.flash_fwd.launches, "B2": fa.flash_bwd_dq.launches,
                "B3": fa.flash_bwd_dkv.launches, "B4a": tg.gmm.launches,
                "B4b": tg.tgmm.launches,
                "B5": rpa.ragged_paged_attention.launches}

    def init(self, *a, **kw):
        orig_init(self, *a, **kw)
        held["trainer"] = self
        step = self.train_step

        def recording(state, batch):
            ids = batch["input_ids"].to(torch.int32).cpu().numpy()
            before = launches()
            state, metrics = step(state, batch)
            loss = float(metrics["loss"])
            after = launches()
            out.write(json.dumps({
                "step": state.step,
                "batch_sha256": hashlib.sha256(
                    np.ascontiguousarray(ids).tobytes()).hexdigest(),
                "loss": loss, "grad_norm": float(metrics["grad_norm"]),
                "launches": {k: after[k] - before[k]
                             for k in ("B1", "B2", "B3")},
            }) + "\n")
            out.flush()
            return state, metrics

        self.train_step = recording

    tr.Trainer.__init__ = init
    _posttrain_hooks(out, held, opts, launches)
    for record, *command in commands:
        held.clear()
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        with open(record, "w") as out.f:
            rc = _runtime_command(command, out, held, opts, launches)
        if rc != 0:
            break
    return rc


def _runtime_command(cli_argv: list, out, held: dict, opts: list,
                     launches) -> int:
    """One command of runtime_child: the CLI's main on cli_argv, then its
    end record."""
    import torch

    from luminaai_tpu_torch import cli, native
    from luminaai_tpu_torch.ops import flash_attention as fa
    from luminaai_tpu_torch.ops import gmm as tg
    from luminaai_tpu_torch.ops import ragged_paged_attention as rpa

    logits_path = Path(opts[opts.index("--logits") + 1]) if (
        "--logits" in opts) else None
    fa.reset_launches()
    tg.reset_launches()
    rpa.ragged_paged_attention.launches = 0
    native.reset_path_counts()
    rc = cli.main(cli_argv)
    t = held.get("trainer")
    ck = t.checkpoints if t is not None else None
    end = {
        "exit": rc, "launches": launches(), "native": native.path_counts(),
        "saves": ck.save_log if ck else [],
        "restores": ck.restore_log if ck else [],
    }
    if torch.cuda.is_available():
        end["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if "lora_model" in held:
        end["base_sha256"] = [held["base_sha256"], _module_digest(
            held["lora_model"])]
        end["lora_params"] = held["lora_params"]
    if "eval" in held:
        end["eval"] = held["eval"]
    if "chat" in held:
        eng = held["chat"].engine
        end["decode_forwards"] = eng.decode_forwards
        end["num_layers"] = eng.config.num_layers
        end["reply"] = (held["chat"].history or [{}])[-1].get("content")
        end["reply_tokens"] = held["chat"].stats.total_tokens
        if "--chat-checks" in opts and rc == 0:
            end["chat"] = _chat_checks(held["chat"], launches)
    out.write(json.dumps(end) + "\n")
    out.flush()
    if logits_path is not None and rc == 0:
        from luminaai_tpu_torch.inference.chat import build_engine

        engine = build_engine(t.config, device=t.device, seed=0)
        engine.model.load_params(t.model.state_dict())
        torch.save(_filled_decoder(engine).step_logits().cpu(), logits_path)
    return rc


def _module_digest(model) -> str:
    """sha256 over a module's parameters by name, copied to the host."""
    return _tensor_digest({n: p.detach().cpu() for n, p in
                           model.named_parameters()})


def _posttrain_hooks(out, held, opts: list, launches) -> None:
    """Instrument the post-training commands in a runtime child: each
    LoRA step's loss, adapter grad norm, launches and synchronised wall
    (with --compare, the first step's loss and grad norm through the plain
    attention first, the generator restored), the base parameters' digest
    before the first step, the evaluation's result and seconds, and the
    chat session."""
    import torch

    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.inference import chat
    from luminaai_tpu_torch.ops.fused import global_norm
    from luminaai_tpu_torch.parallel.train_step import make_loss_fn
    from luminaai_tpu_torch.training import adapters

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    real_make = adapters.make_lora_train_step

    def make(config, model, spec, tx, loss_fn=None):
        step = real_make(config, model, spec, tx, loss_fn)
        held["lora_model"] = model
        held["base_sha256"] = _module_digest(model)
        n = {"step": 0}

        def recording(carry, batch, gen):
            n["step"] += 1
            rec = {"lora_step": n["step"]}
            if n["step"] == 1:
                held["lora_params"] = adapters.lora_param_count(carry[0])
            if n["step"] == 1 and "--compare" in opts:
                state = gen.get_state()
                leaves = [t.requires_grad_(True)
                          for t in adapters.lora_leaves(carry[0])]
                config.use_flash_attention = False
                try:
                    with adapters.installed_weights(
                            model, adapters.adapted_tensors(
                                model, config, carry[0], spec)):
                        loss, _ = make_loss_fn(config, model)(batch, gen)
                        grads = torch.autograd.grad(loss, leaves)
                    rec["plain"] = [float(loss), float(global_norm(grads))]
                finally:
                    config.use_flash_attention = True
                del loss, grads
                gen.set_state(state)
            sync()
            before = launches()
            t0 = time.perf_counter()
            carry, metrics = step(carry, batch, gen)
            loss = float(metrics["loss"])
            sync()
            rec["ms"] = (time.perf_counter() - t0) * 1e3
            after = launches()
            rec.update(loss=loss, grad_norm=float(metrics["grad_norm"]),
                       launches={k: after[k] - before[k] for k in after},
                       tokens=int(batch["input_ids"].numel()))
            out.write(json.dumps(rec) + "\n")
            out.flush()
            return carry, metrics

        return recording

    adapters.make_lora_train_step = make
    real_eval = cli.evaluate_model

    def evaluate_model(model, cfg, data_path, max_batches=0):
        sync()
        before = launches()
        t0 = time.perf_counter()
        result = real_eval(model, cfg, data_path, max_batches)
        sync()
        after = launches()
        held["eval"] = {
            "result": result, "seconds": time.perf_counter() - t0,
            "rows": (result or {}).get("batches", 0) * cfg.batch_size,
            "seq_length": cfg.seq_length,
            "launches": {k: after[k] - before[k] for k in after},
        }
        return result

    cli.evaluate_model = evaluate_model
    real_chat_init = chat.ChatInterface.__init__

    def chat_init(self, *a, **kw):
        real_chat_init(self, *a, **kw)
        held["chat"] = self

    chat.ChatInterface.__init__ = chat_init


CHAT_PROMPT = ("Explain in a few sentences why the sky looks blue at noon "
               "and red at sunset.")
CHAT_NEW_TOKENS = 32


def _chat_checks(session, launches) -> dict:
    """On the chat session's engine, after the CLI's reply: the first
    decode step's logits through the decode kernel vs the plain paged
    attention (the same cache row rewritten identically), generate_stream
    against generate at a seed (temperature 0.8), and the timings of a
    greedy CHAT_NEW_TOKENS-token reply (prefill, decode per token)."""
    import torch

    eng = session.engine
    ids = eng.encode_chat([{"role": "user", "content": CHAT_PROMPT}])
    greedy = eng._resolve_gen_key(CHAT_NEW_TOKENS, 0.0, 1.0, 0, 1.0)

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        first, caches, _, _, length, _ = eng._prefill_and_sample_first(
            ids, greedy, 0)
        sync()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        b5 = launches()["B5"]
        lk = eng._decode_logits(caches, first, length)
        compare_b5 = launches()["B5"] - b5
        lp = eng._decode_logits(caches, first, length, backend="plain")
        rel = ((lk - lp).abs().max() / lp.abs().max()).item()
    del caches
    kw = dict(max_new_tokens=CHAT_NEW_TOKENS, temperature=0.8, top_p=0.9,
              seed=3)
    sampled, _ = eng.generate(ids, **kw)
    *streamed, last = eng.generate_stream(ids, **kw)
    steps0 = eng.decode_forwards
    sync()
    t0 = time.perf_counter()
    tokens, stats = eng.generate(ids, max_new_tokens=CHAT_NEW_TOKENS,
                                 temperature=0.0)
    sync()
    total_ms = (time.perf_counter() - t0) * 1e3
    steps = eng.decode_forwards - steps0
    decode_ms = total_ms - prefill_ms
    return {
        "prompt_tokens": length, "logits_rel_err": rel,
        "logits_finite": bool(torch.isfinite(lk).all()),
        "compare_b5": compare_b5,
        "stream_equal": streamed == sampled
        and last["tokens_generated"] == len(sampled),
        "sampled_tokens": len(sampled),
        "prefill_ms": prefill_ms, "greedy_tokens": len(tokens),
        "decode_steps": steps, "stopped": stats["stopped"],
        "decode_ms_per_token": decode_ms / max(steps, 1),
        "decode_tokens_per_s": steps / max(decode_ms, 1e-9) * 1e3,
    }


def _read_records(path: Path):
    lines = [json.loads(x) for x in path.read_text().splitlines() if x]
    return [r for r in lines if "batch_sha256" in r], (
        lines[-1] if lines and "exit" in lines[-1] else None)


def _run_child(args: list, log_path: Path, timeout: float = 900,
               preempt_after: int = 0):
    """This script as a runtime child; with preempt_after, SIGTERM once
    the log shows that step. -> (exit code, log text)."""
    cmd = [sys.executable, "-u", str(Path(__file__).resolve()),
           "--runtime-child", *args]
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                cwd=str(RUN_DIR))
        sent = False
        t0 = time.perf_counter()
        try:
            for line in proc.stdout:
                logf.write(line)
                m = re.search(r"step (\d+) loss=", line)
                if (preempt_after and not sent and m
                        and int(m.group(1)) >= preempt_after):
                    proc.send_signal(signal.SIGTERM)
                    sent = True
                    log(f"  SIGTERM sent after the log showed step "
                        f"{m.group(1)} ({time.perf_counter() - t0:.1f}s)")
                if time.perf_counter() - t0 > timeout:
                    raise TimeoutError(f"runtime child ran past {timeout}s")
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    text = log_path.read_text()
    log(f"  runtime child {' '.join(args[args.index('--') + 1:][:2])}: exit "
        f"{rc} in {time.perf_counter() - t0:.1f} s")
    if preempt_after and not sent:
        raise AssertionError("run B never logged step "
                             f"{preempt_after}:\n{text[-3000:]}")
    return rc, text


# The runtime phase's model: b1's widths without experts at an eighth of
# its depth (2 of 16 layers: phases 7, 9 and 14 write, hash, load and
# convert its checkpoints several times, and the script must finish
# within its time budget), through `train --config`; per optimizer step
# (one micro-batch) B1 runs each layer's forward and its remat recompute.
RUNTIME_LAYERS = 2
RUNTIME_LAUNCHES = {"B1": 2 * RUNTIME_LAYERS, "B2": RUNTIME_LAYERS,
                    "B3": RUNTIME_LAYERS}


def _runtime_model() -> tuple:
    """train's model flags for phase 7: a saved b1 dense config at
    RUNTIME_LAYERS layers."""
    from luminaai_tpu_torch.config import ConfigPresets

    path = RUN_DIR / "runtime_config.json"
    ConfigPresets.get("b1", use_moe=False,
                      num_layers=RUNTIME_LAYERS).save(str(path))
    return ("--config", str(path), "--batch-size", str(RUNTIME_BATCH),
            "--grad-accum", "1")


def phase_runtime(dev, rpa_entry: dict, flash_entries: list,
                  model_args=None, want=RUNTIME_LAUNCHES) -> dict:
    import torch

    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.ops import ragged_paged_attention as rpa
    from luminaai_tpu_torch.training import checkpoint as ck

    csrc = Path(__file__).resolve().parent / "luminaai_tpu_torch" / "csrc"
    atomics = [f"{p.name}:{i}" for p in sorted(csrc.iterdir())
               for i, line in enumerate(p.read_text().splitlines(), 1)
               if re.search(r"\batomic\w*\s*\(|\bred\.(global|shared)",
                            line.split("//")[0])]
    log(f"runtime: atomics in csrc/: {atomics or 'none'}")
    if atomics:
        raise AssertionError(f"csrc/ holds atomics: {atomics}")

    model_args = model_args or _runtime_model()
    disk = shutil.disk_usage(RUN_DIR)
    log(f"runtime: disk at {RUN_DIR}: {disk.free / 1e9:.1f} GB free of "
        f"{disk.total / 1e9:.1f} GB ({disk.used / 1e9:.1f} GB used)")
    corpus = RUN_DIR / "corpus.jsonl"
    n_bytes = _write_corpus(corpus)
    log(f"runtime: corpus {corpus.name}: {CORPUS_DOCS} documents, "
        f"{n_bytes / 1e6:.2f} MB")

    def cli_args(out: str) -> list:
        return [*model_args, "--data", str(corpus), "--packed", "--steps",
                str(RUNTIME_STEPS), "--seed", "0", "--output-dir",
                str(RUN_DIR / out)]

    # Runs A and B side by side on the card (each its own process, output
    # directory and token cache; the kernels hold no atomics, so a step's
    # values do not depend on what else runs): A's step times are those
    # of a shared card.
    runs = {}

    def run_a():
        t0 = time.perf_counter()
        rc, _ = _run_child([str(RUN_DIR / "a.jsonl"), "--logits",
                            str(RUN_DIR / "a_logits.pt"), "--", "train",
                            *cli_args("A")], RUN_DIR / "a.log")
        runs["A"] = (time.perf_counter() - t0, rc)

    with ThreadPoolExecutor(1) as pool:
        run_a_done = pool.submit(run_a)
        t0 = time.perf_counter()
        rc, text = _run_child([str(RUN_DIR / "b.jsonl"), "--", "train",
                               *cli_args("B")], RUN_DIR / "b.log",
                              preempt_after=PREEMPT_AFTER)
        runs["B"] = (time.perf_counter() - t0, rc)
        run_a_done.result()
    if runs["A"][1] != 0:
        raise AssertionError(f"run A exited {runs['A'][1]}: "
                             f"{(RUN_DIR / 'a.log').read_text()[-3000:]}")
    if rc != 75:
        raise AssertionError(f"preempted run B exited {rc}, not 75: "
                             f"{text[-3000:]}")
    steps_b, _ = _read_records(RUN_DIR / "b.jsonl")
    k = len(steps_b)
    ckpt_b = RUN_DIR / "B" / "checkpoints"
    if ck.committed_steps(ckpt_b) != [k] or ck.verify_step_dir(
            ckpt_b / str(k))["status"] != "ok":
        raise AssertionError(f"run B stopped after step {k} without an "
                             f"intact emergency checkpoint there: "
                             f"{ck.committed_steps(ckpt_b)}")
    log(f"runtime: run B preempted at step {k}, exit 75, emergency "
        f"checkpoint {ckpt_b.name}/{k} verified")
    t0 = time.perf_counter()
    rc, text = _run_child([str(RUN_DIR / "r.jsonl"), "--", "resume",
                           *cli_args("B")], RUN_DIR / "r.log")
    runs["resume"] = (time.perf_counter() - t0, rc)
    if rc != 0:
        raise AssertionError(f"resume of B exited {rc}: {text[-3000:]}")

    steps_a, end_a = _read_records(RUN_DIR / "a.jsonl")
    steps_r, end_r = _read_records(RUN_DIR / "r.jsonl")
    _, end_b = _read_records(RUN_DIR / "b.jsonl")
    got = steps_b + steps_r
    for rec in steps_a:
        log(f"  A step {rec['step']}: loss {rec['loss']!r} grad_norm "
            f"{rec['grad_norm']!r} batch {rec['batch_sha256'][:12]} "
            f"launches {rec['launches']}")
    if len(steps_a) != RUNTIME_STEPS or [r["step"] for r in got] != list(
            range(1, RUNTIME_STEPS + 1)):
        raise AssertionError(f"steps: A {len(steps_a)}, B+resume "
                             f"{[r['step'] for r in got]}")
    for a, b in zip(steps_a, got):
        if (a["batch_sha256"], a["loss"], a["grad_norm"]) != (
                b["batch_sha256"], b["loss"], b["grad_norm"]):
            raise AssertionError(f"step {a['step']}: run A {a} vs the "
                                 f"preempted and resumed run {b}")
    losses = [r["loss"] for r in steps_a]
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"bad losses {losses}")
    log(f"runtime: the {RUNTIME_STEPS} batches and losses of B (steps "
        f"1-{k} before the preemption, {k + 1}-{RUNTIME_STEPS} after the "
        f"resume) equal run A's bitwise")

    bad = [r for r in steps_a + got if r["launches"] != want]
    if bad:
        raise AssertionError(f"flash launches per step {bad[0]['launches']}"
                             f" at step {bad[0]['step']}, want {want}")
    totals = {kern: sum(e["launches"][kern] for e in (end_a, end_b, end_r))
              for kern in want}
    log(f"runtime: flash launches per step {want} in every step of the "
        f"three runs; totals {totals}")
    for e, kern in zip(flash_entries, ("B1", "B2", "B3")):
        e["launches"] = (e["launches"] or 0) + totals[kern]
        e["launches_runtime"] = totals[kern]
    for name, end in (("A", end_a), ("B", end_b), ("resume", end_r)):
        nat = end["native"].get("pack_batch", {})
        if not nat.get("native") or nat.get("numpy"):
            raise AssertionError(f"run {name}: the packer did not run "
                                 f"natively: {end['native']}")
    log(f"runtime: native data path in all runs: {end_a['native']}")

    tree_a = ck.load_state_file(RUN_DIR / "A" / "checkpoints" /
                                str(RUNTIME_STEPS))
    tree_b = ck.load_state_file(ckpt_b / str(RUNTIME_STEPS))
    digest_a, digest_b = (_tensor_digest(tree_a["params"]),
                          _tensor_digest(tree_b["params"]))
    log(f"runtime: final parameters sha256 A {digest_a[:16]}, B "
        f"{digest_b[:16]}")
    if digest_a != digest_b:
        raise AssertionError("the resumed run's final parameters differ "
                             "from the uninterrupted run's")
    del tree_a, tree_b

    saves = [dict(s, run=n) for n, e in (("A", end_a), ("B", end_b),
                                         ("resume", end_r))
             for s in e["saves"]]
    restores = [dict(s, run="resume") for s in end_r["restores"]]
    for s in saves:
        log(f"  save ({s['run']}) step {s['step']}: {s['seconds']:.2f} s "
            f"({s['host_copy_seconds']:.2f} s host copy), "
            f"{s['bytes'] / 1e9:.2f} GB")
    for s in restores:
        log(f"  restore ({s['run']}) step {s['step']}: {s['seconds']:.2f} s"
            f", {s['bytes'] / 1e9:.2f} GB")
    summary_a = json.loads((RUN_DIR / "A" / "training_summary.json")
                           .read_text())
    summary_b = json.loads((RUN_DIR / "B" / "training_summary.json")
                           .read_text())
    for name, summ in (("A", summary_a), ("resume", summary_b)):
        # The CLI trains under the orchestrator; no decision fires in 6
        # steps at b1's health-check interval.
        if summ.get("adaptive_decisions") != [] or "trajectory" not in summ:
            raise AssertionError(f"run {name}'s summary lacks the "
                                 f"orchestrator's keys or decided: "
                                 f"{summ.get('adaptive_decisions')}")
    log("runtime: runs A and resume trained under the orchestrator "
        "(adaptive_decisions [], trajectory "
        f"{summary_a['trajectory']})")
    hist = summary_a["history"]
    step_s = statistics.median(h["step_seconds"] for h in hist[1:])
    cfg = json.loads(
        (RUN_DIR / "A" / "experiment_metadata.json").read_text())["config"]
    tokens = cfg["batch_size"] * cfg["seq_length"]
    gp = summary_a["goodput"]["seconds"]
    gp_r = summary_b["goodput"]["seconds"]

    def split(g):
        return ", ".join(f"{c} {g[c]:.2f} s" for c in g if g[c] > 0)

    log(f"runtime: run A step (steps 2-{RUNTIME_STEPS}, median, beside run "
        f"B) {step_s * 1e3:.1f} ms, {tokens / step_s:.0f} tokens/s; goodput "
        f"of A: {split(gp)}; of the resume: {split(gp_r)}; wall A "
        f"{runs['A'][0]:.1f} s, B {runs['B'][0]:.1f} s, resume "
        f"{runs['resume'][0]:.1f} s")

    # serve --checkpoint: the CLI's engine builder on A's checkpoints.
    args = cli._parser().parse_args(
        ["serve", "--checkpoint", str(RUN_DIR / "A" / "checkpoints"),
         *(["--device", str(dev)] if dev.type != "cuda" else [])])
    t0 = time.perf_counter()
    engine = cli.build_serve_engine(args)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    lk = _filled_decoder(engine).step_logits().cpu()
    mem = torch.load(RUN_DIR / "a_logits.pt")
    same = torch.equal(lk, mem)
    log(f"runtime: serve --checkpoint loaded step {RUNTIME_STEPS} in "
        f"{load_s:.1f} s; first decode step logits vs the engine built "
        f"from run A's in-memory weights: "
        f"{'bitwise equal' if same else 'DIFFERENT'} (max abs diff "
        f"{(lk - mem).abs().max().item():.3e})")
    if not same:
        raise AssertionError("the checkpoint's logits differ from the "
                             "in-memory weights'")

    def reset():
        rpa.ragged_paged_attention.launches = 0

    b5, serve = _serve_burst(
        engine, "serve --checkpoint",
        lambda model: model["hidden_size"] == engine.config.hidden_size,
        reset, lambda: rpa.ragged_paged_attention.launches)
    want_b5 = serve["decode_steps"] * engine.config.num_layers
    log(f"runtime: B5 launches serving the checkpoint {b5} (decode steps x "
        f"layers = {want_b5})")
    if b5 != want_b5:
        raise AssertionError("serving the checkpoint did not run through "
                             "the decode kernel")
    rpa_entry["launches"] = (rpa_entry["launches"] or 0) + b5
    rpa_entry["launches_runtime"] = b5
    del engine
    return {"steps": RUNTIME_STEPS, "preempted_at": k, "losses": losses,
            "step_ms_median": step_s * 1e3, "tokens_per_s": tokens / step_s,
            "goodput_seconds": gp, "goodput_seconds_resume": gp_r,
            "saves": saves, "restores": restores,
            "disk_free_gb": disk.free / 1e9, "corpus_mb": n_bytes / 1e6,
            "run_wall_s": {n: w for n, (w, _) in runs.items()},
            "serve_load_s": load_s, "serve": serve,
            "params_sha256": digest_a}


# ---------------------------------------------------------------------------
# Post-training: blend, LoRA fine-tune, evaluate and chat from phase 7's run A.
# ---------------------------------------------------------------------------
POST_STEPS = 6
POST_RANK = 8
POST_EVAL_BATCHES = 4
# Conversations per shard (`data sample`); the blend of both feeds
# finetune (batch 8) and evaluate.
POST_SHARDS = {"a": (0.7, 160), "b": (0.3, 96)}
# A LoRA step at phase 7's b1 dense config (remat 'nothing_saveable',
# one micro-batch, RUNTIME_LAYERS layers): B1 runs each layer's forward
# and its recompute in the backward, B2 and B3 once each (the adapter
# gradients run back through the attention); no experts, no decode.
POST_LAUNCHES = {"B1": 2 * RUNTIME_LAYERS, "B2": RUNTIME_LAYERS,
                 "B3": RUNTIME_LAYERS, "B4a": 0, "B4b": 0, "B5": 0}
# evaluate: the no-cache forward without gradients, one B1 per layer per
# batch.
EVAL_B1_PER_BATCH = RUNTIME_LAYERS
EVAL_REL_TOL = 1e-5


def _post_child(what: str, args: list, log_path: Path) -> str:
    """_run_child that must exit 0 -> its log."""
    rc, text = _run_child(args, log_path)
    if rc != 0:
        raise AssertionError(f"{what} exited {rc}: {text[-3000:]}")
    return text


def _lora_records(path: Path):
    lines = [json.loads(x) for x in path.read_text().splitlines() if x]
    return [r for r in lines if "lora_step" in r], lines[-1]


def _check_lora_run(steps, end, n_steps: int, want: dict, label: str,
                    compare: bool) -> None:
    """n_steps finite LoRA steps with exactly `want` launches each; with
    `compare`, the first step within LOSS_RTOL / GRAD_NORM_RTOL of its
    re-run through the plain attention; the base parameters' digest the
    same before the first step and after the run."""
    if len(steps) != n_steps:
        raise AssertionError(f"{label}: {len(steps)} LoRA steps, want "
                             f"{n_steps}")
    for r in steps:
        log(f"  {label} step {r['lora_step']}: loss {r['loss']!r} adapter "
            f"grad_norm {r['grad_norm']!r} {r['ms']:.1f} ms launches "
            f"{r['launches']}")
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])):
            raise AssertionError(f"{label}: non-finite step {r}")
        if r["launches"] != want:
            raise AssertionError(f"{label}: launches {r['launches']} at "
                                 f"step {r['lora_step']}, want {want}")
    if compare:
        loss, norm = steps[0]["loss"], steps[0]["grad_norm"]
        pl, pn = steps[0]["plain"]
        le, ne = abs(loss - pl) / abs(pl), abs(norm - pn) / abs(pn)
        log(f"{label}: first step, kernels vs plain attention: loss "
            f"{loss:.5f} vs {pl:.5f} (rel {le:.2e}, tol {LOSS_RTOL}), "
            f"adapter grad_norm {norm:.5f} vs {pn:.5f} (rel {ne:.2e}, tol "
            f"{GRAD_NORM_RTOL})")
        if le > LOSS_RTOL or ne > GRAD_NORM_RTOL:
            raise AssertionError(f"{label}: the kernels' first LoRA step "
                                 "disagrees with the plain attention's")
    before, after = end["base_sha256"]
    log(f"{label}: base parameters sha256 before {before[:16]}, after "
        f"{after[:16]}")
    if before != after:
        raise AssertionError(f"{label}: the frozen base changed")


def _device_ms(fn, iters: int = 50):
    """Kernel time on the card per call of fn (torch.profiler's device
    time summed over the calls' CUDA kernels), apart from the host's
    time to issue it; None when the profiler records no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    return total_us / 1e3 / iters if total_us > 0 else None


def _one_lane_decode(dev, length: int, rpa_entry: dict) -> None:
    """B5 at the chat's shape, one lane: q [1, 1, HQ, D] over a
    [1, 2048, HKV, D] cache holding `length` rows; kernel vs plain, timed
    beside the plain version and SDPA with the length mask, and its
    bound. Each call reads the next of 16 caches (one per layer of a
    decode step, 67 MB together, past the L2)."""
    import torch
    import torch.nn.functional as F

    from luminaai_tpu_torch.ops import ragged_paged_attention as rpa

    C = PAGES * PAGE
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    q = randn(1, 1, HQ, D)
    caches = [(randn(1, C, HKV, D), randn(1, C, HKV, D)) for _ in range(16)]
    meta = rpa.LaneMeta(lengths=torch.tensor([length], dtype=torch.int32,
                                             device=dev), page_size=PAGE)
    k, v = caches[0]
    err = (rpa.ragged_paged_attention(q, k, v, meta).float()
           - rpa.ragged_paged_attention_ref(q, k, v, meta).float()
           ).abs().max().item()
    if err > KERNEL_TOL:
        raise AssertionError(f"B5 at one lane disagrees with plain: {err}")
    turn = itertools.count()
    mask = (torch.arange(C, device=dev) < length)[None, None, None, :]

    def rot(fn):
        return lambda: fn(*caches[next(turn) % len(caches)])

    ms = cuda_ms(rot(lambda kk, vv: rpa.ragged_paged_attention(
        q, kk, vv, meta)), 200)
    plain_ms = cuda_ms(rot(lambda kk, vv: rpa.ragged_paged_attention_ref(
        q, kk, vv, meta)), 50)
    library_ms = cuda_ms(rot(lambda kk, vv: F.scaled_dot_product_attention(
        q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
        attn_mask=mask, enable_gqa=True)), 100)
    # At one lane the host's time to issue a call exceeds the kernel's:
    # the CUDA-event times above are issue bound, so the device time of
    # the kernel and of SDPA's kernels is read from the profiler too.
    device_ms = _device_ms(rot(lambda kk, vv: rpa.ragged_paged_attention(
        q, kk, vv, meta)))
    library_device_ms = _device_ms(rot(
        lambda kk, vv: F.scaled_dot_product_attention(
            q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)))
    bytes_moved = length * HKV * D * 2 * 2 + 2 * HQ * D * 2 + 4 * 2
    flops = 4 * length * HQ * D
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    rpa_entry["one_lane"] = {
        "length": length, "max_abs_err": err, "ms": ms,
        "device_ms": device_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "library_device_ms": library_device_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    log(f"B5 at one lane ({length} rows, the chat's first decode step): "
        f"max_abs_err {err:.3e} (tol {KERNEL_TOL}); kernel {ms:.4f} ms "
        f"(device {device_ms} ms), plain {plain_ms:.4f} ms, library (SDPA "
        f"+ length mask) {library_ms:.4f} ms (device {library_device_ms} "
        f"ms), bound {max(t_bytes, t_ops):.4f} ms")


def phase_posttrain(dev, rpa_entry: dict, flash_entries: list,
                    want: dict = POST_LAUNCHES,
                    eval_b1: int = EVAL_B1_PER_BATCH) -> dict:
    """Phase 9: the post-training path from phase 7's run A checkpoint,
    every command through the CLI: `data sample` x 2 + `data blend` in
    this process (the blend equal to the same blend run through the
    pipeline here), then in one runtime child, in sequence: `finetune`
    (LoRA rank 8, POST_STEPS steps, --merge-out), `evaluate` of the base
    and of the merged checkpoint (the merged one equal to an in-memory
    merge evaluated here), `chat` with the adapter. `want` (the launches
    per LoRA step) and `eval_b1` default to the b1 dense model on the
    card; a CPU rehearsal passes zeros."""
    import torch

    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.convert import flax_to_state_dict
    from luminaai_tpu_torch.data.multi_source import MultiSourcePipeline
    from luminaai_tpu_torch.data.tokenizer import ConversationTokenizer
    from luminaai_tpu_torch.models.transformer import LuminaTransformer
    from luminaai_tpu_torch.training import adapters
    from luminaai_tpu_torch.training import checkpoint as ck

    t_phase = time.perf_counter()
    smi = _smi()
    cuda = dev.type == "cuda"
    dev_args = [] if cuda else ["--device", str(dev)]
    post = RUN_DIR / "post"
    post.mkdir(exist_ok=True)
    ckpt_a = RUN_DIR / "A" / "checkpoints"

    # 1. Data: two shards and their blend, through the CLI's main in
    # this process (host work only: a child's start-up is most of it).
    def data(what: str, argv: list) -> None:
        t0 = time.perf_counter()
        rc = cli.main(["data", *argv])
        log(f"  {what}: exit {rc} in {time.perf_counter() - t0:.1f} s")
        if rc != 0:
            raise AssertionError(f"{what} exited {rc}")

    for name, (_, count) in POST_SHARDS.items():
        data(f"data sample {name}", [
            "sample", "--out", str(post / name / f"{name}.jsonl"),
            "--count", str(count)])
    blend = post / "blend.jsonl"
    sources = [f"{n}={w}={post / n}/*.jsonl"
               for n, (w, _) in POST_SHARDS.items()]
    data("data blend", ["blend", "--sources", *sources, "--out",
                        str(blend)])
    it = MultiSourcePipeline(
        ConversationTokenizer(), {n: w for n, (w, _) in POST_SHARDS.items()}
    ).iter_blended({n: [str(post / n / f"{n}.jsonl")] for n in POST_SHARDS})
    mine = [json.dumps(r, ensure_ascii=False) for r in it]
    if blend.read_text().splitlines() != mine:
        raise AssertionError("the CLI's blend differs from the same blend "
                             "run in-process")
    log(f"posttrain: data blend of {len(mine)} conversations, per source "
        f"{ {str(k): n for k, n in it.per_source.items()} }, equal to the "
        "in-process blend")

    # 2-4 in one runtime child, in sequence: finetune (LoRA on run A's
    # fp32 weights, merged checkpoint out), evaluate of the base and of the
    # merged checkpoint, chat with the adapter (the REPL's one-shot
    # --prompt).
    ft, merged = post / "ft", post / "merged"
    t0 = time.perf_counter()
    evaluate = [
        arg for name, ckpt in (("base", ckpt_a), ("merged", merged))
        for arg in ("--then", str(post / f"eval_{name}.jsonl"), "evaluate",
                    "--checkpoint", str(ckpt), "--data", str(blend),
                    "--max-batches", str(POST_EVAL_BATCHES), *dev_args)]
    _post_child("finetune, evaluate x 2, chat", [
        str(post / "ft.jsonl"), "--compare", "--chat-checks", "--",
        "finetune", "--checkpoint", str(ckpt_a), "--data", str(blend),
        "--out", str(ft), "--rank", str(POST_RANK), "--steps",
        str(POST_STEPS), "--batch-size", "8", "--merge-out", str(merged),
        *dev_args, *evaluate, "--then", str(post / "chat.jsonl"), "chat",
        "--checkpoint", str(ckpt_a), "--adapter", str(ft / "adapter.npz"),
        "--prompt", CHAT_PROMPT, "--temperature", "0", "--max-new-tokens",
        str(CHAT_NEW_TOKENS), *dev_args], post / "post.log")
    child_wall = time.perf_counter() - t0
    steps, ft_end = _lora_records(post / "ft.jsonl")
    _check_lora_run(steps, ft_end, POST_STEPS, want, "finetune",
                    compare=True)
    lora, spec = adapters.load_lora(str(ft / "adapter.npz"))
    zero_b = [k for k, ab in lora.items() if not ab["b"].abs().max() > 0]
    if zero_b:
        raise AssertionError(f"adapter b factors still zero: {zero_b[:4]}")
    report = ck.verify_step_dir(merged / "0")
    if report["status"] != "ok":
        raise AssertionError(f"merged checkpoint: {report}")
    merged_gb = sum(f.stat().st_size for f in (merged / "0").iterdir()) / 1e9
    step_ms = statistics.median(r["ms"] for r in steps[1:])
    tokens = steps[0]["tokens"]
    peak = ft_end.get("peak_gb", 0.0)
    log(f"posttrain: finetune ({smi}): {len(lora)} adapted kernels, "
        f"{ft_end['lora_params'] / 1e6:.2f}M adapter params; step (steps "
        f"2-{POST_STEPS}, median) {step_ms:.1f} ms, "
        f"{tokens / step_ms * 1e3:.0f} tokens/s; peak memory {peak:.2f} "
        f"GB; merged checkpoint verified, {merged_gb:.2f} GB; the child's "
        f"wall (finetune, evaluate x 2, chat) {child_wall:.1f} s")

    # 3. evaluate the base and the merged checkpoint.
    evals = {}
    for name in ("base", "merged"):
        ev = json.loads((post / f"eval_{name}.jsonl").read_text()
                        .splitlines()[-1])["eval"]
        evals[name] = ev
        res = ev["result"]
        tps = ev["rows"] * ev["seq_length"] / ev["seconds"]
        log(f"posttrain: evaluate {name}: {res}; {ev['seconds']:.2f} s "
            f"for {ev['rows']} x {ev['seq_length']} tokens = {tps:.0f} "
            f"tokens/s ({smi}); launches {ev['launches']}")
        if ev["launches"]["B1"] != eval_b1 * res["batches"] or any(
                ev["launches"][k] for k in ("B2", "B3", "B4b", "B5")):
            raise AssertionError(f"evaluate {name}: launches "
                                 f"{ev['launches']}")
    rb, rm = evals["base"]["result"], evals["merged"]["result"]
    if (rb["tokens"], rb["batches"]) != (rm["tokens"], rm["batches"]) or (
            rm["batches"] != POST_EVAL_BATCHES):
        raise AssertionError(f"evaluate: base {rb} vs merged {rm}")
    # The in-memory merge of run A's fp32 weights and the adapter, on the
    # device the finetune merged on, cast to bf16 as the loader casts.
    step_dir, meta = ck.find_checkpoint_step(ckpt_a, mode="sample")
    cfg = Config.from_dict(meta["config"])
    flat = {k: v.to(dev) for k, v in
            ck.load_state_file(step_dir)["params"].items()}
    with torch.no_grad():
        flat = adapters.merge_lora(flat, {k: {s: t.to(dev) for s, t in
                                              ab.items()}
                                          for k, ab in lora.items()}, spec)
    model = LuminaTransformer(cfg, device=dev).load_params(
        flax_to_state_dict({k: v.to(torch.bfloat16)
                            for k, v in flat.items()}, cfg))
    del flat
    mem = cli.evaluate_model(model, cfg, str(blend), POST_EVAL_BATCHES)
    del model
    if cuda:
        _release()
    rel = abs(rm["eval_loss"] - mem["eval_loss"]) / abs(mem["eval_loss"])
    log(f"posttrain: merged checkpoint eval_loss {rm['eval_loss']} vs the "
        f"in-memory merge {mem['eval_loss']} (rel {rel:.2e}, tol "
        f"{EVAL_REL_TOL}); base {rb['eval_loss']}")
    if rel > EVAL_REL_TOL or mem["tokens"] != rm["tokens"]:
        raise AssertionError("the merged checkpoint does not evaluate to "
                             "the in-memory merge")

    # 4. chat with the adapter.
    end = json.loads((post / "chat.jsonl").read_text().splitlines()[-1])
    want_b5 = end["decode_forwards"] * end["num_layers"] if cuda else 0
    c = end["chat"]
    # Token ids past the byte range decode to no text under the byte
    # tokenizer, so the reply is counted in tokens.
    log(f"posttrain: chat reply of {end['reply_tokens']} tokens: "
        f"{end['reply'][:80]!r}")
    log(f"posttrain: chat B5 launches {end['launches']['B5']} (decode "
        f"steps {end['decode_forwards']} x {end['num_layers']} layers = "
        f"{want_b5}); first decode step logits, kernel vs plain: rel "
        f"{c['logits_rel_err']:.2e} of max|logit| (tol {LOGIT_RTOL}); "
        f"generate_stream == generate at seed 3: {c['stream_equal']} "
        f"({c['sampled_tokens']} tokens)")
    log(f"posttrain: chat ({smi}): prompt {c['prompt_tokens']} tokens, "
        f"prefill {c['prefill_ms']:.1f} ms, {c['decode_steps']} decode "
        f"steps at {c['decode_ms_per_token']:.2f} ms of host wall a token "
        f"= {c['decode_tokens_per_s']:.1f} tokens/s")
    if end["reply_tokens"] < 1 or end["decode_forwards"] < 1:
        raise AssertionError("chat gave no reply")
    if end["launches"]["B5"] != want_b5 or any(
            end["launches"][k] for k in ("B2", "B3", "B4b")):
        raise AssertionError(f"chat launches {end['launches']}, want B5 "
                             f"{want_b5}")
    if (not c["logits_finite"] or c["logits_rel_err"] > LOGIT_RTOL
            or not c["stream_equal"]):
        raise AssertionError(f"chat checks failed: {c}")
    if cuda:
        _one_lane_decode(dev, c["prompt_tokens"] + 1, rpa_entry)

    totals = {k: sum(r["launches"][k] for r in steps)
              + evals["base"]["launches"][k]
              + evals["merged"]["launches"][k] + end["launches"][k]
              for k in ("B1", "B2", "B3", "B5")}
    for e, kern in zip(flash_entries, ("B1", "B2", "B3")):
        e["launches"] = (e["launches"] or 0) + totals[kern]
        e["launches_posttrain"] = totals[kern]
    rpa_entry["launches"] = (rpa_entry["launches"] or 0) + totals["B5"]
    rpa_entry["launches_posttrain"] = totals["B5"]
    wall = time.perf_counter() - t_phase
    log(f"posttrain: launches {totals}; phase wall {wall:.1f} s ({smi})")
    return {"finetune_step_ms": step_ms,
            "finetune_tokens_per_s": tokens / step_ms * 1e3,
            "adapter_params": ft_end["lora_params"],
            "finetune_peak_gb": peak, "losses": [r["loss"] for r in steps],
            "merged_gb": merged_gb,
            "eval": {n: e["result"] for n, e in evals.items()},
            "eval_tokens_per_s": {
                n: e["rows"] * e["seq_length"] / e["seconds"]
                for n, e in evals.items()},
            "eval_in_memory": mem, "chat": c, "wall_s": wall, "card": smi}


def phase_posttrain_experts(dev, flash_entries: list, gmm_entries: list,
                            want: dict = None) -> dict:
    """Phase 9, experts: `finetune --adapt-experts --steps 3` on phase 8's
    newest flagship MoE checkpoint, from phase 9's blend. Exact B1-B4
    launches each step (the expert factors' gradients run through tgmm),
    finite losses, the base bitwise unchanged."""
    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.training import adapters
    from luminaai_tpu_torch.training import checkpoint as ck

    smi = _smi()
    cuda = dev.type == "cuda"
    post = RUN_DIR / "post"
    _, meta = ck.find_checkpoint_step(RUN_DIR / "adaptive", mode="sample")
    cfg = Config.from_dict(meta["config"])
    L, n_moe = cfg.num_layers, cfg.num_moe_layers()
    if want is None:
        want = {"B1": 2 * L, "B2": L, "B3": L, "B4a": 6 * n_moe,
                "B4b": 2 * n_moe, "B5": 0}
    _post_child("finetune --adapt-experts", [
        str(post / "ft_moe.jsonl"), "--", "finetune", "--checkpoint",
        str(RUN_DIR / "adaptive"), "--data", str(post / "blend.jsonl"),
        "--out", str(post / "ft_moe"), "--steps", "3", "--adapt-experts",
        *([] if cuda else ["--device", str(dev)])], post / "ft_moe.log")
    steps, end = _lora_records(post / "ft_moe.jsonl")
    _check_lora_run(steps, end, 3, want, "finetune --adapt-experts",
                    compare=False)
    lora, _ = adapters.load_lora(str(post / "ft_moe" / "adapter.npz"))
    experts = sorted(k for k in lora if "/moe/" in k)
    if len(experts) != 2 * n_moe:
        raise AssertionError(f"expert factors for {experts}")
    step_ms = statistics.median(r["ms"] for r in steps[1:])
    log(f"posttrain: finetune --adapt-experts on the flagship MoE step "
        f"{meta['step']} ({cfg.num_experts} experts; {smi}): "
        f"{end['lora_params'] / 1e6:.2f}M adapter params, {len(experts)} "
        f"expert kernels; step (steps 2-3, median) {step_ms:.1f} ms, "
        f"{steps[0]['tokens'] / step_ms * 1e3:.0f} tokens/s; peak memory "
        f"{end.get('peak_gb', 0.0):.2f} GB")
    totals = {k: sum(r["launches"][k] for r in steps)
              for k in ("B1", "B2", "B3", "B4a", "B4b")}
    for e, kern in zip(flash_entries + gmm_entries,
                       ("B1", "B2", "B3", "B4a", "B4b")):
        e["launches"] = (e["launches"] or 0) + totals[kern]
        e["launches_posttrain_moe"] = totals[kern]
    return {"step_ms": step_ms, "losses": [r["loss"] for r in steps],
            "launches": totals, "adapter_params": end["lora_params"],
            "card": smi}


# ---------------------------------------------------------------------------
# Adaptive training: the orchestrator's interventions on the flagship MoE.
# ---------------------------------------------------------------------------
ADAPTIVE_STEPS = 14  # global steps; 15 run (the rollback replays one)
# The flagship MoE at 4 of its 10 layers: three forced saves and a
# restore of its checkpoint (9.1 GB at 10 layers, 88 s of the phase's
# 117 s on an H100 host) would push the script past its time budget.
ADAPTIVE_LAYERS = 4
# Executed step after which each scripted decision runs: (kind, params).
# The weight decay doubles the config's; prune takes the least-loaded
# expert of the step before; rollback goes to the last healthy step,
# fenced to the prune's forced save.
ADAPTIVE_SCRIPT = {
    3: ("lr_adjust", {"factor": 0.5, "action": "decrease"}),
    4: ("weight_decay", None),
    5: ("clip_tighten", {}),
    6: ("temperature_up", {"new_value": 1.25}),
    7: ("capacity_up", {"new_value": 1.5}),
    8: ("expert_dropout", {"rate": 0.1}),
    9: ("expert_dropout", {"rate": 0.0}),
    10: ("curriculum", {"difficulty": 0.6}),
    11: ("add_expert", {}),
    12: ("prune_expert", None),
    13: ("rollback", {}),
}
# Steps held against the same step through the plain gmm: the one after
# each of these decisions.
ADAPTIVE_COMPARE = {8: "expert dropout 0.1", 11: "add_expert",
                    12: "prune_expert", 13: "rollback"}
STEADY_STEPS = (2, 3, 15)  # no intervention just before them


def _smi() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except OSError as exc:
        return f"nvidia-smi unavailable: {exc}"
    return (out.stdout.strip().splitlines()[0] if out.stdout.strip()
            else f"nvidia-smi unavailable: {out.stderr.strip()}")


def _param_digest(trainer) -> str:
    """sha256 over the trainer's parameters by name, copied to the host."""
    return _tensor_digest({n: p.detach().cpu() for n, p in
                           zip(trainer.state.names, trainer.state.params)})


def phase_adaptive(dev, flash_entries: list, gmm_entries: list,
                   model: dict = FLAGSHIP, want: dict = None) -> dict:
    """The flagship MoE trained in-process under
    AdaptiveTrainingOrchestrator(trainer).run() from phase 7's corpus,
    packed. The organic health check cannot fire (health_check_interval
    19 > the steps; the log boundary is every step); one decision of each
    MoE-path kind is injected through the orchestrator's _execute at
    fixed steps. After each: the decision applied, exact B1-B4 launches
    and a finite loss in the next step; after expert dropout, add, prune
    and the rollback that step against the same step through the plain
    gmm (the generator reseeded identically); the optimizer count equal
    to the step after each evolution; the parameters after the rollback
    bitwise those of the prune's forced save. `model` and `want` (the
    launches per step) default to the flagship on the card."""
    import logging
    import types

    import numpy as np
    import torch

    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.models import moe
    from luminaai_tpu_torch.ops import flash_attention as fa
    from luminaai_tpu_torch.ops import gmm as tg
    from luminaai_tpu_torch.ops.fused import global_norm
    from luminaai_tpu_torch.parallel import train_step as ts
    from luminaai_tpu_torch.training import orchestrator as orch_mod
    from luminaai_tpu_torch.training.trainer import Trainer

    t_phase = time.perf_counter()
    smi = _smi()
    corpus = RUN_DIR / "corpus.jsonl"
    cfg = Config(**model, **FLAGSHIP_LEVERS, max_steps=ADAPTIVE_STEPS,
                 health_check_interval=19,
                 output_dir=str(RUN_DIR / "adaptive"))
    train_fn, _, n_tokens = cli.make_data(
        cfg, types.SimpleNamespace(data=str(corpus), packed=True))
    trainer = Trainer(cfg, train_fn, device=dev, seed=0)
    orch = orch_mod.AdaptiveTrainingOrchestrator(trainer)
    L, n_moe = cfg.num_layers, cfg.num_moe_layers()
    if want is None:
        want = {"B1": 2 * L, "B2": L, "B3": L, "B4a": 6 * n_moe,
                "B4b": 2 * n_moe}
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()
    log(f"adaptive: flagship MoE ({smi}), {cfg.num_experts} experts, "
        f"batch {cfg.batch_size} x {cfg.seq_length} packed from "
        f"{corpus.name} ({n_tokens:,} tokens), {ADAPTIVE_STEPS} steps")

    failed = []

    class Failures(logging.Handler):
        def emit(self, record):
            if "failed" in record.getMessage():
                failed.append(record.getMessage())

    handler = Failures(level=logging.ERROR)
    orch_mod.logger.addHandler(handler)

    def launches():
        return {"B1": fa.flash_fwd.launches, "B2": fa.flash_bwd_dq.launches,
                "B3": fa.flash_bwd_dkv.launches, "B4a": tg.gmm.launches,
                "B4b": tg.tgmm.launches}

    steps, compares, digests = [], {}, {}
    pending = {"label": None}
    compare_launches = dict.fromkeys(want, 0)
    # Whole experts expert dropout leaves out of routing in the real step
    # (their B4 groups are empty), summed over the MoE layers.
    real_draw = moe.MoELayer.draw_routing
    dropped = {"live": False, "n": 0}

    def draw(self, G, S, generator, device):
        out = real_draw(self, G, S, generator, device)
        if dropped["live"] and out and "expert_u" in out:
            rate = self.config.expert_dropout_rate
            dropped["n"] += int((out["expert_u"] >= 1.0 - rate).sum())
        return out

    def wrap(real):
        def step(state, batch):
            label, pending["label"] = pending["label"], None
            if label is not None:
                gen = state.generator.get_state()
                before = launches()
                moe.GMM_OVERRIDE = _plain_gmm
                try:
                    grads, m = ts._accumulate_grads(
                        ts.make_loss_fn(trainer.config, trainer.model),
                        state.params, batch, state.generator,
                        trainer.config.gradient_accumulation_steps)
                    plain = (float(m["loss"]), float(global_norm(grads)))
                finally:
                    moe.GMM_OVERRIDE = None
                del grads, m
                for k, v in launches().items():
                    compare_launches[k] += v - before[k]
                state.generator.set_state(gen)
            sync()
            before = launches()
            dropped.update(live=True, n=0)
            t0 = time.perf_counter()
            state, metrics = real(state, batch)
            loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
            ms = (time.perf_counter() - t0) * 1e3
            dropped["live"] = False
            steps.append({
                "n": len(steps) + 1, "step": state.step, "ms": ms,
                "loss": loss, "grad_norm": norm,
                "lr": float(metrics["learning_rate"]),
                "experts": trainer.config.num_experts,
                "drop_rate": float(metrics["moe_drop_rate"]),
                "experts_dropped": dropped["n"],
                "launches": {k: v - before[k]
                             for k, v in launches().items()},
            })
            if label is not None:
                errs = (abs(loss - plain[0]) / abs(plain[0]),
                        abs(norm - plain[1]) / abs(plain[1]))
                compares[label] = {"step": state.step, "loss": loss,
                                   "loss_plain": plain[0],
                                   "grad_norm": norm,
                                   "grad_norm_plain": plain[1],
                                   "loss_rel": errs[0], "norm_rel": errs[1]}
                log(f"  step {state.step} after {label}, B4 vs plain gmm: "
                    f"loss {loss:.5f} vs {plain[0]:.5f} (rel {errs[0]:.2e},"
                    f" tol {LOSS_RTOL}), grad_norm {norm:.5f} vs "
                    f"{plain[1]:.5f} (rel {errs[1]:.2e}, tol "
                    f"{GRAD_NORM_RTOL})")
                if errs[0] > LOSS_RTOL or errs[1] > GRAD_NORM_RTOL:
                    raise AssertionError(f"the step after {label} disagrees"
                                         f" with the plain gmm")
            return state, metrics

        step.wrapped = True
        return step

    def scripted(global_step, metrics, observe=orch.on_metrics):
        observe(global_step, metrics)
        n = len(steps)
        rec = steps[-1]
        if rec["launches"] != want or not (math.isfinite(rec["loss"])
                                           and math.isfinite(
                                               rec["grad_norm"])):
            raise AssertionError(f"step {n}: launches {rec['launches']} "
                                 f"(want {want}), loss {rec['loss']}")
        if n in ADAPTIVE_SCRIPT:
            kind, params = ADAPTIVE_SCRIPT[n]
            if kind == "weight_decay":
                params = {"new_value": 2 * cfg.weight_decay}
            if kind == "prune_expert":
                util = np.asarray(metrics["expert_utilization"])
                params = {"expert_idx": int(util.argmin())}
            decision = orch_mod.AdaptiveDecision(
                kind=kind, params=params, reason=f"scripted at step {n}",
                confidence=1.0, step=trainer.global_step)
            t0 = time.perf_counter()
            orch._execute(decision)
            rec["decision"] = kind
            rec["decision_s"] = time.perf_counter() - t0
            if not decision.applied or failed:
                raise AssertionError(f"decision {kind} at step {n} not "
                                     f"applied: {failed}")
            if kind in ("add_expert", "prune_expert"):
                count = trainer.state.opt_state.count
                if count != trainer.global_step:
                    raise AssertionError(f"optimizer count {count} after "
                                         f"{kind} at step "
                                         f"{trainer.global_step}")
                if kind == "prune_expert":
                    digests["saved"] = (trainer.global_step,
                                        _param_digest(trainer))
            if kind == "rollback":
                digests["restored"] = (trainer.global_step,
                                       _param_digest(trainer))
            if n in ADAPTIVE_COMPARE:
                pending["label"] = ADAPTIVE_COMPARE[n]
        if not getattr(trainer.train_step, "wrapped", False):
            trainer.train_step = wrap(trainer.train_step)

    orch.on_metrics = scripted
    trainer.train_step = wrap(trainer.train_step)
    fa.reset_launches()
    tg.reset_launches()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    moe.MoELayer.draw_routing = draw
    try:
        summary = orch.run()
    finally:
        moe.MoELayer.draw_routing = real_draw
        orch_mod.logger.removeHandler(handler)
    total = launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    if failed:
        raise AssertionError(f"intervention failures logged: {failed}")

    for rec in steps:
        log(f"  step {rec['n']:2d} (global {rec['step']:2d}, E "
            f"{rec['experts']}): loss {rec['loss']:.4f} grad_norm "
            f"{rec['grad_norm']:.4f} lr {rec['lr']:.3e} drop "
            f"{rec['drop_rate']:.4f} {rec['ms']:.1f} ms"
            + (f"; then {rec['decision']} ({rec['decision_s']:.2f} s)"
               if "decision" in rec else ""))
    if len(steps) != ADAPTIVE_STEPS + 1 or summary["final_step"] != (
            ADAPTIVE_STEPS):
        raise AssertionError(f"{len(steps)} steps run, final step "
                             f"{summary['final_step']}")
    if set(compares) != set(ADAPTIVE_COMPARE.values()):
        raise AssertionError(f"compared steps {sorted(compares)}")
    n_drop = [r["experts_dropped"] for r in steps]
    log(f"adaptive: whole experts left out by expert dropout per step "
        f"(summed over {n_moe} MoE layers; their B4 groups empty): {n_drop}")
    if not n_drop[8] or any(n_drop[:8]) or any(n_drop[9:]):
        raise AssertionError("expert dropout did not empty B4 groups in "
                             "exactly the step it was on")
    lr_override = trainer._lr_override
    if any(abs(r["lr"] - lr_override) > 1e-6 * lr_override
           for r in steps[3:]):
        raise AssertionError(f"the LR override {lr_override} did not hold: "
                             f"{[r['lr'] for r in steps]}")
    if digests["saved"] != digests["restored"]:
        raise AssertionError(f"rollback restored {digests['restored']}, the "
                             f"forced save held {digests['saved']}")
    log(f"adaptive: rollback to step {digests['restored'][0]} restored the "
        f"parameters of the prune's forced save bitwise (sha256 "
        f"{digests['saved'][1][:16]})")
    experts = [r["experts"] for r in steps]
    per_step = {k: want[k] * len(steps) for k in want}
    run = {k: total[k] - compare_launches[k] for k in total}
    if run != per_step:
        raise AssertionError(f"launches {run}, want {per_step}")
    log(f"adaptive: launches per step {want} in all {len(steps)} steps; "
        f"totals {run} (plus {compare_launches} in the plain re-runs); E "
        f"over the run {experts}")
    for e, kern in zip(flash_entries + gmm_entries,
                       ("B1", "B2", "B3", "B4a", "B4b")):
        e["launches"] = (e["launches"] or 0) + run[kern]
        e["launches_adaptive"] = run[kern]

    steady = statistics.median(steps[n - 1]["ms"] for n in STEADY_STEPS)
    tokens = cfg.batch_size * cfg.seq_length
    after = {f"{n}:{steps[n - 1]['decision']}": steps[n]["ms"]
             for n in sorted(ADAPTIVE_SCRIPT)}
    log(f"adaptive: steady step (median of steps {STEADY_STEPS}) "
        f"{steady:.1f} ms, {tokens / steady * 1e3:.0f} tokens/s ({smi})")
    for n in sorted(ADAPTIVE_SCRIPT):
        r = steps[n]
        log(f"  step after {steps[n - 1]['decision']}: {r['ms']:.1f} ms "
            f"({100 * (r['ms'] / steady - 1):+.1f}% of steady)")
    ck = trainer.checkpoints
    for s_ in ck.save_log:
        log(f"  save step {s_['step']}: {s_['seconds']:.2f} s "
            f"({s_['host_copy_seconds']:.2f} s host copy), "
            f"{s_['bytes'] / 1e9:.2f} GB")
    for s_ in ck.restore_log:
        log(f"  restore step {s_['step']}: {s_['seconds']:.2f} s, "
            f"{s_['bytes'] / 1e9:.2f} GB")
    gp = summary["goodput"]["seconds"]
    decisions = summary["adaptive_decisions"]
    log("adaptive: goodput " + ", ".join(f"{c} {gp[c]:.2f} s" for c in gp
                                         if gp[c] > 0)
        + f"; peak memory {peak_gb:.2f} GB")
    log(f"adaptive: decisions {json.dumps(decisions)}")
    if len(decisions) != len(ADAPTIVE_SCRIPT) or not all(
            d["applied"] for d in decisions):
        raise AssertionError(f"decisions {decisions}")
    trainer.close()
    wall = time.perf_counter() - t_phase
    log(f"adaptive: phase wall {wall:.1f} s ({smi})")
    return {"steps": steps, "steady_ms": steady,
            "tokens_per_s": tokens / steady * 1e3, "after_ms": after,
            "compares": compares, "experts": experts,
            "experts_dropped": n_drop,
            "saves": ck.save_log, "restores": ck.restore_log,
            "goodput_seconds": gp, "peak_memory_gb": peak_gb,
            "decisions": decisions, "wall_s": wall, "card": smi}


# ---------------------------------------------------------------------------
# Phase 11: bench.py's flagship_tuned levers; phase 12: mixture of depths.
# ---------------------------------------------------------------------------
# flagship_tuned (bench.py:119-128): the flagship widths with gmm, bf16
# RoPE, the save_attn remat policy and bf16 Adam first moments.
TUNED_LEVERS = dict(remat_policy="save_attn", adam_mu_dtype="bf16")
INT8_STEPS = 3
HYBRID_STEPS = 3
# The hybrid MoE+MoD model at debug_200m's widths: experts on every third
# layer (2, 5, 8, 11 of the preset's 12; layer 2 of MOD_TRAIN_LAYERS), MoD
# on the others.
HYBRID = dict(use_moe=True, num_experts=8, moe_top_k=2, moe_dispatch="gmm",
              moe_pattern="every_3rd")


def _first_step_plain(trainer, cfg, batch, plain_gmm: bool):
    """(loss, grad norm) of `batch` through the plain attention (and the
    plain gmm), the step's generator state restored after."""
    import torch

    from luminaai_tpu_torch.models import moe
    from luminaai_tpu_torch.ops.fused import global_norm
    from luminaai_tpu_torch.parallel import train_step as ts

    gen_state = trainer.state.generator.get_state()
    cfg.use_flash_attention = False
    if plain_gmm:
        moe.GMM_OVERRIDE = _plain_gmm
    try:
        grads, m = ts._accumulate_grads(
            ts.make_loss_fn(cfg, trainer.model), trainer.state.params, batch,
            trainer.state.generator, cfg.gradient_accumulation_steps)
        out = float(m["loss"]), float(global_norm(grads))
    finally:
        cfg.use_flash_attention = True
        moe.GMM_OVERRIDE = None
    trainer.state.generator.set_state(gen_state)
    del grads, m
    torch.cuda.empty_cache()
    return out


def _launch_counts():
    from luminaai_tpu_torch.ops import flash_attention as fa
    from luminaai_tpu_torch.ops import gmm as tg

    return {"B1": fa.flash_fwd.launches, "B2": fa.flash_bwd_dq.launches,
            "B3": fa.flash_bwd_dkv.launches, "B4a": tg.gmm.launches,
            "B4b": tg.tgmm.launches}


def _reset_counts() -> None:
    from luminaai_tpu_torch.ops import flash_attention as fa
    from luminaai_tpu_torch.ops import gmm as tg

    fa.reset_launches()
    tg.reset_launches()


def _add_launches(entries: dict, launches: dict, key: str) -> None:
    for kern, e in entries.items():
        if launches.get(kern):
            e["launches"] = (e["launches"] or 0) + launches[kern]
            e[key] = launches[kern]


def _short_run(hist, steps: int, what: str, falling: bool = True) -> list:
    """`steps` finite losses and grad norms, the last loss below the
    first (unless falling is False: two steps under a warmup whose first
    update has lr 0 train on an unchanged model)."""
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    if len(hist) != steps or not all(map(math.isfinite, losses + norms)):
        raise AssertionError(f"bad {what} run: {losses} {norms}")
    if falling and not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: the loss did not fall: {losses}")
    return losses


def phase_train_tuned(dev, entries: dict, moe_run) -> dict:
    """Phase 11: bench.py's flagship_tuned (the flagship widths at
    FLAGSHIP_TRAIN_LAYERS layers, gmm, bf16 RoPE, save_attn, bf16 Adam mu)
    trained TRAIN_STEPS steps through Trainer; then INT8_STEPS steps with
    int8 Adam moments.

    Launches per step (one micro-batch of 16 x 2048): B1 once per layer,
    where phase 6's nothing_saveable re-runs it in the recompute (twice):
    save_attn keeps B1's (O, lse) by name, as the JAX policy keeps
    "flash_out" and "flash_lse". B2 = B3 = once per layer. The JAX policy
    keeps the FFN branch's output ("ffn_out") but not its inside, so the
    backward of each MoE layer recomputes its two expert products: B4a 2
    forward + 2 recompute + 2 grad_lhs = 6 a layer; B4b 2 a layer (phase
    6's counts)."""
    import torch

    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.training.optimizer import (
        describe_optimizer_memory,
    )
    from luminaai_tpu_torch.training.trainer import Trainer

    smi = _smi()
    t_phase = time.perf_counter()
    flagship = {**FLAGSHIP, "num_layers": FLAGSHIP_TRAIN_LAYERS}
    cfg = Config(**flagship, **FLAGSHIP_LEVERS, **TUNED_LEVERS,
                 max_steps=TRAIN_STEPS, output_dir=str(RUN_DIR / "tuned"))
    trainer = Trainer(cfg, cli._synthetic_batches(cfg), device=dev, seed=0)
    n_moe, L = cfg.num_moe_layers(), cfg.num_layers
    n_params = sum(p.numel() for p in trainer.state.params)
    n_active = n_params - n_moe * (cfg.num_experts - cfg.moe_top_k) * (
        3 * cfg.hidden_size * cfg.intermediate_size)
    log(f"trainer: flagship_tuned (bench.py:119-128: gmm, bf16 RoPE, "
        f"{cfg.remat_policy}, bf16 Adam mu), {n_params / 1e6:.1f}M params, "
        f"batch {cfg.batch_size} x {cfg.seq_length}")
    first = trainer._to_device(next(iter(cli._synthetic_batches(cfg)())))
    plain_loss, plain_norm = _first_step_plain(trainer, cfg, first, True)

    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    summary = trainer.train()
    launches = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = summary["history"]
    for i, h in enumerate(hist, 1):
        log(f"  step {i}: loss {h['loss']:.4f} grad_norm "
            f"{h['grad_norm']:.4f} {h['step_seconds'] * 1e3:.1f} ms")
    losses, norms = _check_run(hist, plain_loss, plain_norm,
                               "step through the plain attention and gmm")
    n = cfg.gradient_accumulation_steps * TRAIN_STEPS
    want = {"B1": L * n, "B2": L * n, "B3": L * n, "B4a": 6 * n_moe * n,
            "B4b": 2 * n_moe * n}
    log(f"kernel launches under save_attn: {launches} (want {want}: per "
        f"layer B1 once (phase 6: twice), B2, B3; per MoE layer B4a 6, "
        f"B4b 2)")
    if launches != want:
        raise AssertionError("flagship_tuned did not run through the "
                             "kernels as expected")
    _add_launches(entries, launches, "launches_tuned")
    steady = _steady_step(cfg, hist, n_active, "flagship_tuned step",
                          " (active params)")
    mem = describe_optimizer_memory(trainer.state.opt_state)
    base = moe_run or {}
    log(f"  vs phase 6 (nothing_saveable, fp32 moments): step "
        f"{steady['step_ms_median']:.1f} ms vs "
        f"{base.get('step_ms_median', float('nan')):.1f} ms, peak "
        f"{peak_gb:.2f} GB vs {base.get('peak_memory_gb', float('nan')):.2f}"
        f" GB; optimizer state {json.dumps(mem)} ({smi})")
    prof = profile_train_step(trainer, first)
    trainer.close()
    del trainer, first
    _release()

    cfg8 = Config(**flagship, **FLAGSHIP_LEVERS, remat_policy="save_attn",
                  adam_state_quantization="int8", max_steps=INT8_STEPS,
                  output_dir=str(RUN_DIR / "tuned_int8"))
    trainer = Trainer(cfg8, cli._synthetic_batches(cfg8), device=dev,
                      seed=0)
    torch.cuda.reset_peak_memory_stats()
    summary8 = trainer.train()
    peak8 = torch.cuda.max_memory_allocated() / 1e9
    losses8 = _short_run(summary8["history"], INT8_STEPS, "int8 moments")
    mem8 = describe_optimizer_memory(trainer.state.opt_state)
    ms8 = [h["step_seconds"] * 1e3 for h in summary8["history"]]
    log(f"int8 Adam moments: losses {losses8}, step ms {ms8}, peak "
        f"{peak8:.2f} GB, optimizer state {json.dumps(mem8)}")
    trainer.close()
    del trainer
    wall = time.perf_counter() - t_phase
    log(f"train_tuned: phase wall {wall:.1f} s ({smi})")
    return {"steps": TRAIN_STEPS, "losses": losses, "grad_norms": norms,
            **steady, "peak_memory_gb": peak_gb, "optimizer_memory": mem,
            "first_step_loss_plain": plain_loss,
            "first_step_grad_norm_plain": plain_norm,
            "launches": launches, "int8_losses": losses8,
            "int8_step_ms": ms8, "int8_peak_memory_gb": peak8,
            "int8_optimizer_memory": mem8, "wall_s": wall, **prof}


def phase_mod(dev, entries: dict, rpa_entry: dict) -> dict:
    """Phase 12: `train --preset debug_200m --synthetic` in process (MoD at
    capacity 0.5: 1024 of 2048 tokens a sequence get the FFN), TRAIN_STEPS
    steps; one mod_capacity decision (0.5 -> 0.3) through the
    orchestrator's _execute and the step after it against the plain
    attention; HYBRID_STEPS steps of the hybrid MoE+MoD model at the same
    widths, its first step against the plain attention and gmm; then `serve --preset debug_200m` in process, 8 requests.

    Launches per step (accumulation 4 of 8 x 2048, MOD_TRAIN_LAYERS = 3
    layers, remat per block): B1 2 x 3 x 4 = 24 (forward + recompute), B2
    = B3 = 12; the hybrid's MoE layer (every third: layer 2) adds B4a 6 x
    1 x 4 = 24 and B4b 2 x 1 x 4 = 8.
    The profiler must name WGMMA_KERNELS (all three on wgmma)."""
    import torch

    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.config import ConfigPresets
    from luminaai_tpu_torch.inference.chat import build_engine
    from luminaai_tpu_torch.ops import ragged_paged_attention as rpa
    from luminaai_tpu_torch.training import orchestrator as orch_mod
    from luminaai_tpu_torch.training.trainer import Trainer

    smi = _smi()
    t_phase = time.perf_counter()
    cfg = ConfigPresets.get("debug_200m", max_steps=TRAIN_STEPS,
                            num_layers=MOD_TRAIN_LAYERS,
                            output_dir=str(RUN_DIR / "mod"))
    accum, L = cfg.gradient_accumulation_steps, cfg.num_layers
    trainer = Trainer(cfg, cli._synthetic_batches(cfg), device=dev, seed=0)
    n_params = sum(p.numel() for p in trainer.state.params)
    log(f"trainer: debug_200m (MoD capacity {cfg.mod_capacity_factor}), "
        f"{n_params / 1e6:.1f}M params (JAX estimate "
        f"{cfg.estimate_parameters() / 1e6:.1f}M), batch {cfg.batch_size} x "
        f"{cfg.seq_length}, accumulation {accum}")
    batches = iter(cli._synthetic_batches(cfg)())
    first = trainer._to_device(next(batches))
    plain_loss, plain_norm = _first_step_plain(trainer, cfg, first, False)
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    summary = trainer.train()
    launches = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = summary["history"]
    for i, h in enumerate(hist, 1):
        log(f"  step {i}: loss {h['loss']:.4f} (mod aux "
            f"{h['mod_aux_loss']:.4f}) grad_norm {h['grad_norm']:.4f} "
            f"compute ratio {h['mod_compute_ratio']:.4f} "
            f"{h['step_seconds'] * 1e3:.1f} ms")
    losses, norms = _check_run(hist, plain_loss, plain_norm,
                               "plain attention")
    ratios = {h["mod_compute_ratio"] for h in hist}
    if ratios != {0.5}:
        raise AssertionError(f"mod_compute_ratio {ratios}, want 0.5")
    n = accum * TRAIN_STEPS
    want = {"B1": 2 * L * n, "B2": L * n, "B3": L * n, "B4a": 0, "B4b": 0}
    log(f"kernel launches, debug_200m: {launches} (want {want})")
    if launches != want:
        raise AssertionError("debug_200m did not run through the flash "
                             "kernels as expected")
    _add_launches(entries, launches, "launches_mod")
    steady = _steady_step(cfg, hist, n_params, "debug_200m step",
                          " (dense FFN counted)")
    prof = profile_train_step(trainer, first)

    # One mod_capacity decision, then the step after it against the plain
    # attention on the same batch.
    o = orch_mod.AdaptiveTrainingOrchestrator(trainer)
    decision = orch_mod.AdaptiveDecision(
        kind="mod_capacity", params={"new_value": 0.3},
        reason="chip_smoke: injected", confidence=1.0,
        step=trainer.global_step)
    o._execute(decision)
    if not decision.applied or cfg.mod_capacity_factor != 0.3:
        raise AssertionError(f"mod_capacity decision not applied: "
                             f"{decision.to_dict()}")
    batch = trainer._to_device(next(batches))
    p_loss, p_norm = _first_step_plain(trainer, cfg, batch, False)
    _reset_counts()
    t0 = time.perf_counter()
    trainer.state, m = trainer.train_step(trainer.state, batch)
    after = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
             "mod_compute_ratio": float(m["mod_compute_ratio"]),
             "ms": (time.perf_counter() - t0) * 1e3}
    step_launches = _launch_counts()
    err = (abs(after["loss"] - p_loss) / abs(p_loss),
           abs(after["grad_norm"] - p_norm) / abs(p_norm))
    ratio = int(cfg.seq_length * 0.3) / cfg.seq_length
    log(f"after mod_capacity 0.5 -> 0.3: compute ratio "
        f"{after['mod_compute_ratio']:.4f} (want {ratio:.4f}), loss "
        f"{after['loss']:.5f} vs plain {p_loss:.5f} (rel {err[0]:.2e}), "
        f"grad_norm {after['grad_norm']:.5f} vs {p_norm:.5f} (rel "
        f"{err[1]:.2e}), {after['ms']:.1f} ms, launches {step_launches}")
    step_want = {"B1": 2 * L * accum, "B2": L * accum, "B3": L * accum,
                 "B4a": 0, "B4b": 0}
    if (after["mod_compute_ratio"] != ratio or err[0] > LOSS_RTOL
            or err[1] > GRAD_NORM_RTOL or step_launches != step_want):
        raise AssertionError("the step after the mod_capacity decision "
                             "disagrees")
    _add_launches(entries, step_launches, "launches_mod_decision")
    stats = trainer.mod_statistics()
    trainer.close()
    del trainer, first, batch
    _release()

    hcfg = ConfigPresets.get("debug_200m", **HYBRID, max_steps=HYBRID_STEPS,
                             num_layers=MOD_TRAIN_LAYERS,
                             output_dir=str(RUN_DIR / "hybrid"))
    trainer = Trainer(hcfg, cli._synthetic_batches(hcfg), device=dev, seed=0)
    n_moe = hcfg.num_moe_layers()
    first = trainer._to_device(next(iter(cli._synthetic_batches(hcfg)())))
    h_loss, h_norm = _first_step_plain(trainer, hcfg, first, True)
    _reset_counts()
    hsum = trainer.train()
    hl = _launch_counts()
    hlosses, _ = _check_run(hsum["history"], h_loss, h_norm,
                            "hybrid step through the plain attention and "
                            "gmm", HYBRID_STEPS)
    n = accum * HYBRID_STEPS
    hwant = {"B1": 2 * L * n, "B2": L * n, "B3": L * n,
             "B4a": 6 * n_moe * n, "B4b": 2 * n_moe * n}
    hms = [h["step_seconds"] * 1e3 for h in hsum["history"]]
    log(f"hybrid MoE+MoD ({n_moe} MoE layers, MoD on {L - n_moe}): losses "
        f"{hlosses}, step ms {hms}, launches {hl} (want {hwant})")
    if hl != hwant:
        raise AssertionError("the hybrid model did not run through the "
                             "kernels as expected")
    _add_launches(entries, hl, "launches_hybrid")
    trainer.close()
    del trainer, first
    _release()

    scfg = ConfigPresets.get("debug_200m")
    engine = build_engine(scfg, device=dev, seed=0)
    dec = _filled_decoder(engine)
    lk = dec.step_logits()
    lp = dec.step_logits("plain")
    torch.cuda.synchronize()
    if lk.shape != (LANES, scfg.vocab_size) or not torch.isfinite(lk).all():
        raise AssertionError(f"bad debug_200m decode logits {lk.shape}")
    logit_err = (lk - lp).abs().max().item()
    logit_tol = LOGIT_RTOL * lp.abs().max().item()
    log(f"debug_200m first decode step, kernel vs plain: max_abs_err "
        f"{logit_err:.3e} (tol {logit_tol:.3e})")
    if logit_err > logit_tol:
        raise AssertionError("debug_200m decode logits disagree with the "
                             "plain attention")
    del dec, lk, lp

    def reset():
        rpa.ragged_paged_attention.launches = 0

    b5, served = _serve_burst(
        engine, "debug_200m serve",
        lambda model: model["hidden_size"] == scfg.hidden_size, reset,
        lambda: rpa.ragged_paged_attention.launches)
    if b5 != served["decode_steps"] * scfg.num_layers:
        raise AssertionError(f"B5 {b5}, want decode steps x "
                             f"{scfg.num_layers}")
    rpa_entry["launches"] = (rpa_entry["launches"] or 0) + b5
    rpa_entry["launches_mod_serve"] = b5
    del engine
    wall = time.perf_counter() - t_phase
    log(f"mod: phase wall {wall:.1f} s ({smi})")
    return {"steps": TRAIN_STEPS, "losses": losses, "grad_norms": norms,
            **steady, "peak_memory_gb": peak_gb, "launches": launches,
            "first_step_loss_plain": plain_loss,
            "first_step_grad_norm_plain": plain_norm,
            "after_decision": after, "mod_statistics": stats,
            "hybrid_losses": hlosses, "hybrid_step_ms": hms,
            "hybrid_first_step_loss_plain": h_loss,
            "hybrid_first_step_grad_norm_plain": h_norm,
            "hybrid_launches": hl, "serve": served,
            "first_decode_logit_err": logit_err, "wall_s": wall, **prof}


# ---------------------------------------------------------------------------
# Phase 13: the fleet, `serve --page-share` replicas behind `route`
# ---------------------------------------------------------------------------
# User turns short enough that a chat prompt spans exactly the system
# prompt's PLANE_SHARED_PAGES full pages (its tail page is never keyed).
FLEET_TURN_CHARS = 64
FLEET_NEW_TOKENS = 32
FLEET_KILL_REQUESTS = 8  # non-stream requests in flight when A is killed
FLEET_LIVE_TOKENS = 192  # the stream B decodes while it pulls
FLEET_LAYERS = 16  # B5 launches a decode step (0 on a CPU rehearsal)
# The one-command fleet's replicas (`serve --replicas 2`).
FLEET_CMD_MODEL = PLANE_MODEL


def _fleet_prompt(tok, system: str, user: str) -> list:
    """The prompt ids a replica's chat route builds (encode_chat)."""
    from types import SimpleNamespace

    from luminaai_tpu_torch.inference.generate import GenerationEngine

    return GenerationEngine.encode_chat(
        SimpleNamespace(tokenizer=tok),
        [{"role": "system", "content": system},
         {"role": "user", "content": user}])


def _free_port_run(n: int, avoid=()) -> int:
    """A port p with p..p+n-1 free on loopback now and none in `avoid`."""
    import socket

    for _ in range(100):
        base = _free_port()
        run = range(base, base + n)
        if base + n > 65535 or set(run) & set(avoid):
            continue
        socks = []
        try:
            for port in run:
                sock = socket.socket()
                socks.append(sock)
                sock.bind(("127.0.0.1", port))
            return base
        except OSError:
            continue
        finally:
            for sock in socks:
                sock.close()
    raise AssertionError(f"no run of {n} free ports")


def _argv_value(argv: list, flag: str, default=None):
    return argv[argv.index(flag) + 1] if flag in argv else default


def _device_args(model_argv: list) -> list:
    """`--device X` of a replica's argv, for the router and top (a CPU
    rehearsal runs everything with --device cpu)."""
    if "--device" in model_argv:
        i = model_argv.index("--device")
        return model_argv[i:i + 2]
    return []


def _metric_value(text: str, name: str) -> float:
    for line in text.splitlines():
        if line.startswith(name + " ") or line.startswith(name + "{}"):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def _cli_proc(name: str, argv: list, log_dir: Path) -> _Proc:
    """`python -m luminaai_tpu_torch ARGV` run from the repo root."""
    return _Proc(name, [sys.executable, "-u", "-m", "luminaai_tpu_torch",
                        *argv], log_dir, cwd=Path(__file__).resolve().parent)


def _wait_http(url: str, what: str, procs, ok=lambda code, body: code == 200,
               timeout: float = PLANE_READY_S):
    """Poll GET url until ok(code, body); fail early if a child died."""
    t0 = time.perf_counter()
    while True:
        for p in procs:
            if p.proc.poll() is not None:
                raise AssertionError(f"{what}: a child exited "
                                     f"{p.proc.returncode}:\n{p.tail()}")
        try:
            code, _, body = _call(url, "", timeout=5)
            if ok(code, body):
                return body, time.perf_counter() - t0
        except OSError:
            pass
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{what}: not ready after {timeout}s")
        time.sleep(0.05)


def phase_fleet(dev, rpa_entry: dict) -> dict:
    """Phase 13: two `serve --preset b1 --dense --seed 0` replicas (this
    script's --serve-child, so B5's counters can be read), each with
    --prefix-cache-pages 64 and --page-share pointing at a `route` child
    over both. A chat request through the router prefills cold on its
    affine replica A, whose flush reports the chain's 12 keys; the same
    request on B pulls those 12 pages from A (LPG1 bytes, 4 MiB each),
    decodes A's tokens, and B's GET /pages/<key> bytes equal A's; a repeat
    on B is a local hit. A stream decoding on B while B pulls another of
    A's chains gives the pull's stall (its longest token gap). B5 launches decode steps x 16 on each replica,
    all through the global table. A is SIGKILLed with requests in flight
    through the router: its breaker opens within a probe round, every
    request answers 200, /healthz reads degraded and no lookup names A.
    Then `serve --replicas 2` as one command: a request through its
    router, SIGTERM, exit 0 and both replicas gone. Export and import ms
    a page are timed in this process on a pool of the replicas'
    geometry."""
    import os

    import torch

    from luminaai_tpu_torch.config import Config, ConfigPresets
    from luminaai_tpu_torch.data.tokenizer import ConversationTokenizer
    from luminaai_tpu_torch.inference.kv_pool import (
        PagedKVPool,
        parse_page_payload,
    )
    from luminaai_tpu_torch.inference.prefix_cache import page_chain_keys
    from luminaai_tpu_torch.serving.router import Router

    t_phase = time.perf_counter()
    knobs = Config()
    preset = ConfigPresets.get(_argv_value(PLANE_MODEL, "--preset", "b1"))
    tok = ConversationTokenizer(model_name=preset.tokenizer_name)
    root = RUN_DIR / "fleet"
    root.mkdir(parents=True)
    rport, aport, bport = (_free_port() for _ in range(3))
    fport = _free_port_run(3, avoid=(rport, aport, bport))
    router_url = f"http://127.0.0.1:{rport}"
    urls = [f"http://127.0.0.1:{p}" for p in (aport, bport)]
    base = [*PLANE_MODEL, "--num-slots", str(LANES), "--page-size",
            str(PAGE), "--prefix-cache-pages", str(PLANE_ARENA_PAGES),
            "--page-share", router_url]
    reps = [_ServeChild(f"fleet_r{i}", base + ["--page-share-self", u],
                        root / f"r{i}", port=p)
            for i, (u, p) in enumerate(zip(urls, (aport, bport)))]
    dev_args = _device_args(PLANE_MODEL)
    router = _cli_proc("router", ["route", "--replica", urls[0],
                                  "--replica", urls[1], "--port", str(rport),
                                  *dev_args], root)
    # The one-command fleet starts now too (its replicas warm up while
    # the checks below run), on fport + 1 and fport + 2.
    fleet_cmd = _cli_proc("fleet_cmd", [
        "serve", "--replicas", "2", *FLEET_CMD_MODEL, "--num-slots",
        str(LANES), "--page-size", str(PAGE), "--prefix-cache-pages",
        str(PLANE_ARENA_PAGES), "--port", str(fport), "--flight-dir",
        str(root / "fleet_cmd")], root)
    # The rendezvous order `route` computes (replicas r0, r1 by --replica
    # order), with no traffic: which replica a body is affine to.
    order = Router([("r0", urls[0]), ("r1", urls[1])])

    def affine(body, path="/v1/chat"):
        return urls.index(order._ordered(order._affinity_key(path, body))[0]
                          .url)

    # Texts: a system prompt for the shared chain; a user turn short
    # enough that the prompt's full pages are the system prompt's 12.
    texts = {}
    for name, seed in (("shared", 2), ("cold", 3), ("a_only", 4),
                       ("stall", 5), ("live", 6)):
        system, turns = _plane_texts(seed)
        texts[name] = (system, [t[:FLEET_TURN_CHARS] for t in turns])
    sys_s, turns_s = texts["shared"]
    body = _chat_body(sys_s, turns_s[0], max_new_tokens=FLEET_NEW_TOKENS)
    ids = _fleet_prompt(tok, sys_s, turns_s[0])
    npages = (len(ids) - 1) // PAGE
    if npages != PLANE_SHARED_PAGES:
        raise AssertionError(f"the fleet prompt spans {npages} full pages")
    keys = page_chain_keys(ids, PAGE, npages)
    a = affine(body)
    b = 1 - a
    A, B = reps[a], reps[b]
    out = {"affine": f"r{a}"}
    try:
        # 1. The router comes up over both replicas; top renders it.
        for r in reps:
            ready = r.wait_ready()
            log(f"{r.name}: /healthz 200 after {ready['ready_s']:.1f}s")
        fleet, up_s = _wait_http(
            router_url + "/fleet", "router", [router],
            ok=lambda c, d: c == 200 and isinstance(d, dict) and all(
                x["status"] == "ok" and x["breaker"] == "closed"
                for x in d.get("replicas", [])) and len(d["replicas"]) == 2)
        code, _, health = _call(router_url, "/healthz")
        if code != 200 or health.get("status") != "ok":
            raise AssertionError(f"router /healthz: {code} {health}")
        rc, top = _top_once(router_url, *dev_args)
        if rc != 0 or "fleet — ok (2/2 available" not in top:
            raise AssertionError(f"top over the router: {rc} {top[-800:]}")
        names = [x["replica"] for x in fleet["replicas"]]
        log(f"router: /healthz ok, /fleet {names} closed and ok after "
            f"{up_s:.1f}s; top rendered the fleet table")
        for r in reps:
            r.reset()
        st0 = [r.stats() for r in reps]

        # 2. Cold on A through the router; A reports the chain's 12 keys.
        cold_a = _stream(router_url, "/v1/chat", body)
        cnt_b = B.counts()
        if cold_a["code"] != 200 or cold_a["done"] is None or cnt_b["B5"]:
            raise AssertionError(f"cold request via the router: {cold_a} "
                                 f"(B5 on B {cnt_b['B5']})")
        fleet, _ = _wait_http(
            router_url + "/fleet", "A's report", [router],
            ok=lambda c, d: c == 200
            and d["replicas"][a]["shared_pages"] == npages, timeout=30)
        code, _, look = _call(router_url, "/pages/lookup", {"keys": keys})
        if (fleet["replicas"][a]["page_reports"] != npages
                or look.get("owner") != A.url or look.get("keys") != keys):
            raise AssertionError(f"A's report: {fleet['replicas'][a]}, "
                                 f"lookup {look}")
        log(f"cold on {A.name} via the router: TTFT "
            f"{cold_a['ttft_s'] * 1e3:.1f} ms; A reported {npages} keys, the "
            f"router's index names A for all of them")

        # 3. A cold prompt of the same length on B (another system prompt),
        # then the shared one: B's lookup names A, B pulls 12 pages.
        sys_c, turns_c = texts["cold"]
        cold_b = _stream(B.url, "/v1/chat", _chat_body(
            sys_c, turns_c[0], max_new_tokens=FLEET_NEW_TOKENS))
        _, _, m0 = _call(B.url, "/metrics")
        pull_b = _stream(B.url, "/v1/chat", body)
        _, _, m1 = _call(B.url, "/metrics")

        def delta(name):
            return _metric_value(m1, name) - _metric_value(m0, name)

        pulled = delta("serve_prefix_remote_pulls_total")
        hits = _metric_value(m1, "serve_prefix_remote_hits_total")
        failures = delta("serve_prefix_remote_pull_failures_total")
        nbytes = delta("serve_page_transfer_bytes_total")
        pull_s = delta("serve_page_pull_seconds_sum")
        payloads, export_ms = {}, []
        for k in keys:
            t0 = time.perf_counter()
            with urllib.request.urlopen(f"{A.url}/pages/{k}",
                                        timeout=60) as r:
                payloads[k] = r.read()
            export_ms.append((time.perf_counter() - t0) * 1e3)
        page_bytes = len(payloads[keys[0]])
        same = 0
        for k in keys:
            with urllib.request.urlopen(f"{B.url}/pages/{k}",
                                        timeout=60) as r:
                same += r.read() == payloads[k]
        log(f"pull on {B.name}: {pulled:.0f} pages, {nbytes / 2**20:.1f} MiB "
            f"({page_bytes} B a page), {failures:.0f} failures, remote hits "
            f"{hits:.0f}; fetch time {pull_s * 1e3:.1f} ms "
            f"({nbytes / 2**20 / max(pull_s, 1e-9):.1f} MiB/s); TTFT remote "
            f"hit {pull_b['ttft_s'] * 1e3:.1f} ms vs cold prompt of the same "
            f"length {cold_b['ttft_s'] * 1e3:.1f} ms; pages byte-identical "
            f"on B and A: {same}/{npages}; GET /pages on A "
            f"{statistics.median(export_ms):.2f} ms a page (median)")
        if (pulled != npages or hits != 1 or failures or same != npages
                or nbytes != npages * page_bytes):
            raise AssertionError("B did not pull A's 12 pages byte for byte")
        if pull_b["ids"] != cold_a["ids"]:
            raise AssertionError(f"B's tokens differ from A's: "
                                 f"{pull_b['ids'][:8]} vs {cold_a['ids'][:8]}")
        if any(r["code"] != 200 or r["errors"] for r in (cold_b, pull_b)):
            raise AssertionError(f"B's requests: {cold_b} {pull_b}")

        # 4. The same prompt again on B: a local hit, no second pull.
        pc0 = B.stats().get("prefix_cache", {})
        again = _stream(B.url, "/v1/chat", _chat_body(
            sys_s, turns_s[1], max_new_tokens=FLEET_NEW_TOKENS))
        _, _, m2 = _call(B.url, "/metrics")
        pc1 = B.stats().get("prefix_cache", {})
        if again["code"] != 200 or _metric_value(
                m2, "serve_prefix_remote_pulls_total") != _metric_value(
                m1, "serve_prefix_remote_pulls_total") or _metric_value(
                m2, "serve_prefix_remote_hits_total") != 1 or (
                pc1.get("hits", 0) - pc0.get("hits", 0) != 1):
            raise AssertionError(f"repeat on B: not one local hit ({pc0} -> "
                                 f"{pc1})")
        log(f"repeat on {B.name}: a local hit of "
            f"{pc1.get('pages_spliced', 0) - pc0.get('pages_spliced', 0)} "
            f"pages, no pull; TTFT {again['ttft_s'] * 1e3:.1f} ms")

        def a_owns(texts_name):
            """Send a chain to A directly and wait until the router's
            index names A for all its keys: (A's status, the lookup)."""
            system, turns = texts[texts_name]
            c_ids = _fleet_prompt(tok, system, turns[0])
            c_keys = page_chain_keys(c_ids, PAGE, (len(c_ids) - 1) // PAGE)
            code = _call(A.url, "/v1/chat", _chat_body(
                system, turns[0], max_new_tokens=4))[0]
            deadline = time.perf_counter() + 30
            while True:
                look = _call(router_url, "/pages/lookup", {"keys": c_keys})[2]
                if look.get("owner") == A.url or (
                        time.perf_counter() > deadline):
                    break
                time.sleep(0.05)
            if code != 200 or look.get("owner") != A.url or (
                    look.get("keys") != c_keys):
                raise AssertionError(f"A's chain {texts_name}: {code} {look}")
            return c_keys

        # 4b. What a pull costs the streams B is already decoding. The pull
        # runs inside the admission on the scheduler's one worker (as in
        # the JAX package), so a live stream gets no token until it ends:
        # the longest token gap of a stream decoding on B across a pull of
        # another chain of A's, beside its median gap.
        a_owns("stall")
        sys_t, turns_t = texts["stall"]
        sys_l, turns_l = texts["live"]
        live, times = {}, []
        live_t = threading.Thread(target=lambda: live.update(_stream(
            B.url, "/v1/chat", _chat_body(
                sys_l, turns_l[0], max_new_tokens=FLEET_LIVE_TOKENS),
            times=times)), daemon=True)
        live_t.start()
        while len(times) < 8 and live_t.is_alive():
            time.sleep(0.01)
        _, _, m3 = _call(B.url, "/metrics")
        t_pull0 = time.perf_counter()
        stall = _stream(B.url, "/v1/chat", _chat_body(
            sys_t, turns_t[0], max_new_tokens=4))
        t_pull1 = time.perf_counter()
        _, _, m4 = _call(B.url, "/metrics")
        live_t.join(timeout=300)
        pulled_t = _metric_value(m4, "serve_prefix_remote_pulls_total") - (
            _metric_value(m3, "serve_prefix_remote_pulls_total"))
        gaps = [(t0, t1 - t0) for t0, t1 in zip(times, times[1:])]
        across = [g for t0, g in gaps if t0 < t_pull1 and t0 + g > t_pull0]
        apart = [g for t0, g in gaps if not (t0 < t_pull1
                                            and t0 + g > t_pull0)]
        out["pull_stall"] = {
            "pulled_pages": pulled_t,
            "request_ms": (t_pull1 - t_pull0) * 1e3,
            "longest_gap_ms": max(across) * 1e3 if across else None,
            "median_gap_ms": (statistics.median(apart) * 1e3
                              if apart else None),
            "live_tokens": len(times)}
        if stall["code"] != 200 or live.get("code") != 200 or any(
                r["errors"] for r in (stall, live)):
            raise AssertionError(f"the stall check's requests: {stall} "
                                 f"{live.get('code')}")
        if across:
            log(f"decode on {B.name} during a pull of {pulled_t:.0f} pages: "
                f"a live stream's longest token gap "
                f"{out['pull_stall']['longest_gap_ms']:.1f} ms (median gap "
                f"otherwise {out['pull_stall']['median_gap_ms']:.1f} ms); "
                f"the pulling request took "
                f"{out['pull_stall']['request_ms']:.1f} ms")
        else:
            log(f"decode stall on {B.name} during a pull: not measured (the "
                f"live stream's {len(times)} tokens did not span the pull)")

        # A chain only A holds (sent to A directly), for the lookup after
        # the kill.
        x_keys = a_owns("a_only")

        # 5. B5 on each replica: decode steps x 16, all global.
        launches = {}
        for i, r in enumerate(reps):
            c, st = r.counts(), r.stats()
            steps = st["decode_steps"] - st0[i]["decode_steps"]
            launches[r.name] = {"B5": c["B5"], "B5_global": c["B5_global"],
                                "decode_steps": steps}
            if steps <= 0 or c["B5"] != steps * FLEET_LAYERS or (
                    c["B5_global"] != c["B5"]):
                raise AssertionError(f"{r.name}: B5 {c}, decode steps "
                                     f"{steps} x {FLEET_LAYERS}")
            rpa_entry["launches"] = (rpa_entry["launches"] or 0) + c["B5"]
            glob = rpa_entry.setdefault("global_form", {})
            glob["launches"] = glob.get("launches", 0) + c["B5_global"]
        rpa_entry["launches_fleet"] = sum(x["B5"] for x in launches.values())
        log(f"B5 launches: {launches} (decode steps x {FLEET_LAYERS}, all "
            "through the global table)")

        # 6. SIGKILL A with non-stream requests in flight via the router.
        b_req0 = B.stats()["requests"]
        kill_bodies = []
        for i in range(64):
            kb = {"prompt": f"fleet failover request {i} " * 4,
                  "max_new_tokens": PLANE_LONG_TOKENS, "temperature": 0}
            if affine(kb, "/v1/generate") == a:
                kill_bodies.append(kb)
            if len(kill_bodies) == FLEET_KILL_REQUESTS:
                break
        pool = ThreadPoolExecutor(FLEET_KILL_REQUESTS)
        futs = [pool.submit(_call, router_url, "/v1/generate", kb)
                for kb in kill_bodies]
        _wait_for(A, lambda st: st["active_lanes"] >= 1, "A busy",
                  futs=futs)
        t_kill = time.perf_counter()
        os.kill(A.proc.pid, signal.SIGKILL)
        _, open_s = _wait_http(
            router_url + "/fleet", "A's breaker", [router],
            ok=lambda c, d: isinstance(d, dict)
            and d["replicas"][a]["breaker"] == "open", timeout=60)
        open_s = time.perf_counter() - t_kill
        inflight = [f.result() for f in futs]
        pool.shutdown()
        after = [_call(router_url, "/v1/generate",
                       {"prompt": kb["prompt"] + " again",
                        "max_new_tokens": 8, "temperature": 0})
                 for kb in kill_bodies[:4]]
        after += [_call(router_url, "/v1/chat", _chat_body(
            sys_s, turns_s[2 + i], max_new_tokens=8)) for i in range(2)]
        code_h, _, health = _call(router_url, "/healthz")
        look_x = _call(router_url, "/pages/lookup", {"keys": x_keys})[2]
        served_b = B.stats()["requests"] - b_req0
        bad = [(c, p) for c, _, p in inflight + after if c != 200]
        bound = knobs.router_probe_interval_s + 2.0  # + the probe timeout
        log(f"failover: A SIGKILLed with {FLEET_KILL_REQUESTS} requests in "
            f"flight; breaker open {open_s:.2f}s later (one probe round: "
            f"<= {bound:.1f}s); {len(inflight)} in-flight and {len(after)} "
            f"later requests: {len(bad)} non-200; B served {served_b}; "
            f"router /healthz {code_h} {health.get('status')}; lookup of "
            f"A's own chain -> {look_x.get('owner')}")
        if bad or open_s > bound or code_h != 200 or (
                health.get("status") != "degraded") or look_x.get("owner"):
            raise AssertionError(f"failover: {bad[:2]}")
        if served_b < len(inflight) + len(after):
            raise AssertionError(f"B served {served_b} requests")

        # 7. The one-command fleet: one request through its router, SIGTERM.
        f_url = f"http://127.0.0.1:{fport}"
        _, f_ready = _wait_http(f_url + "/healthz", "serve --replicas",
                                [fleet_cmd])
        code, _, reply = _call(f_url, "/v1/generate",
                               {"prompt": "one command fleet",
                                "max_new_tokens": 8, "temperature": 0})
        _, _, ffleet = _call(f_url, "/fleet")
        t_sig = time.perf_counter()
        rc_fleet = fleet_cmd.stop()
        gone = 0
        for p in (fport + 1, fport + 2):
            try:
                _call(f"http://127.0.0.1:{p}", "/healthz", timeout=5)
            except OSError:
                gone += 1
        log(f"serve --replicas 2: ready {f_ready:.1f}s after the checks "
            f"above began waiting, reply {code} ({reply.get('tokens')} "
            f"tokens), /fleet {[x['replica'] for x in ffleet['replicas']]}; "
            f"SIGTERM -> exit {rc_fleet} in "
            f"{time.perf_counter() - t_sig:.1f}s, replicas gone {gone}/2")
        if code != 200 or rc_fleet != 0 or gone != 2 or len(
                ffleet["replicas"]) != 2:
            raise AssertionError("the one-command fleet did not answer and "
                                 "stop cleanly")
        rc_router = router.stop()
        rc_b = B.stop()
        if rc_router != 0 or rc_b != 0:
            raise AssertionError(f"router exit {rc_router}, B exit {rc_b}")
    except BaseException:
        for c in (*reps, router, fleet_cmd):
            log(f"{c.name} log (tail):\n{c.tail()}")
        raise
    finally:
        for c in (*reps, router, fleet_cmd):
            c.stop(timeout=30)

    # Export and import a page in this process, on a pool of the
    # replicas' geometry (the payload's leaves; 8 lanes + 4 arena slots of
    # 16 pages): the bytes B pulled, imported and exported again byte for
    # byte.
    leaves = parse_page_payload(payloads[keys[0]])
    pages_per_slot = 2048 // PAGE
    slots = LANES + -(-PLANE_ARENA_PAGES // pages_per_slot)
    pool = PagedKVPool(
        [tuple(torch.zeros((slots, pages_per_slot, *leaf.shape),
                           dtype=leaf.dtype, device=dev)
               for leaf in leaves[i:i + 2])
         for i in range(0, len(leaves), 2)], LANES, pages_per_slot, PAGE)
    gids = [LANES * pages_per_slot + j for j in range(npages)]
    imp, exp = [], []
    for gid, k in zip(gids, keys):
        t0 = time.perf_counter()
        pool.import_page(gid, payloads[k])
        imp.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        again_bytes = pool.export_page(gid)
        exp.append((time.perf_counter() - t0) * 1e3)
        if again_bytes != payloads[k]:
            raise AssertionError("a page changed through import -> export")
    del pool
    _release()
    out.update({
        "pages_pulled": pulled, "page_bytes": page_bytes,
        "pull_bytes": nbytes, "pull_fetch_ms": pull_s * 1e3,
        "pull_mib_per_s": nbytes / 2**20 / max(pull_s, 1e-9),
        "ttft_remote_hit_ms": pull_b["ttft_s"] * 1e3,
        "ttft_cold_ms": cold_b["ttft_s"] * 1e3,
        "ttft_cold_on_a_ms": cold_a["ttft_s"] * 1e3,
        "ttft_local_hit_ms": again["ttft_s"] * 1e3,
        "get_page_ms": statistics.median(export_ms),
        "export_ms_per_page": statistics.median(exp),
        "import_ms_per_page": statistics.median(imp),
        "breaker_open_s": open_s, "launches": launches,
        "failover_non_200": len(bad), "wall_s": time.perf_counter() - t_phase,
    })
    log(f"export {out['export_ms_per_page']:.2f} ms, import "
        f"{out['import_ms_per_page']:.2f} ms a page (median of {npages}, in "
        f"process, host wall); fleet: phase wall {out['wall_s']:.1f} s "
        f"({_smi()})")
    return out


# ---------------------------------------------------------------------------
# Phase 14: quantized serving
# ---------------------------------------------------------------------------
QUANT_ARENA_PAGES = 64
QUANT_MOE_LAYERS = 8  # b1's experts at 8 of its 16 layers (the budget)


def _state_bytes(model) -> int:
    """Bytes of a model's weights as it holds them (parameters, and the
    codes and scales of its quantized weights)."""
    return sum(t.numel() * t.element_size()
               for t in model.state_dict().values())


def _pool_bytes(dec) -> int:
    from luminaai_tpu_torch.inference.kv_pool import cache_leaves

    return sum(t.numel() * t.element_size()
               for t in cache_leaves(dec.pool.caches))


def _serve_argv(*extra) -> list:
    from luminaai_tpu_torch import cli

    return cli._parser().parse_args(
        ["serve", "--preset", "b1", "--dense", "--seed", "0", *extra])


def _quant_server(engine, label, reset, read, system, turns):
    """Phase 1's 8 concurrent /v1/generate requests, then 8 chat requests
    sharing phase 10's system prompt, through a ChatServer with the
    prefix cache (what `serve --prefix-cache-pages 64` runs). `reset()`
    zeroes the launch counters just before, `read()` reads them just
    after. -> (launches, summary, server)."""
    from luminaai_tpu_torch.serving.server import ChatServer

    server = ChatServer(engine, num_slots=LANES, page_size=PAGE,
                        prefix_cache_pages=QUANT_ARENA_PAGES)
    httpd = server.make_httpd("127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        code, _, _ = _call(url, "/v1/generate", {
            "prompt": "warm up", "max_new_tokens": 2, "temperature": 0})
        if code != 200:
            raise AssertionError(f"{label}: warmup answered {code}")
        dec = server.batcher.decoder
        steps0, dsec0 = dec.steps, server.batcher.decode_seconds
        gen = [("/v1/generate", {"prompt": _prompt(n, i),
                                 "max_new_tokens": 32, "temperature": 0})
               for i, n in enumerate(PROMPT_LENGTHS)]
        chat = [("/v1/chat", _chat_body(system, turns[i]))
                for i in range(LANES)]
        reset()
        t0 = time.perf_counter()
        replies = []
        for wave in (gen, chat):
            with ThreadPoolExecutor(len(wave)) as pool:
                replies += list(pool.map(
                    lambda pb: _call(url, pb[0], pb[1]), wave))
        wall = time.perf_counter() - t0
        launches = read()
        steps = dec.steps - steps0
        dsec = server.batcher.decode_seconds - dsec0
        _, _, stats = _call(url, "/stats")
    finally:
        httpd.shutdown()
        httpd.server_close()
    bad = [(c, b) for c, _, b in replies if c != 200]
    if bad or steps <= 0:
        raise AssertionError(f"{label}: {len(bad)} failed replies {bad[:2]}, "
                             f"{steps} decode steps")
    tokens = sum(b.get("tokens", 0) for _, _, b in replies)
    summary = {"requests": len(replies), "tokens": tokens,
               "burst_wall_s": wall,
               "decode_steps": steps, "decode_step_ms": 1e3 * dsec / steps,
               "tokens_per_s": tokens / wall, "stats": stats}
    log(f"{label}: {len(replies)} requests (8 generate, 8 chat on a shared "
        f"{PLANE_SYSTEM_CHARS}-character system prompt), {tokens} tokens in "
        f"{wall:.3f}s = {tokens / wall:.1f} tok/s; {steps} decode steps, "
        f"{summary['decode_step_ms']:.3f} ms/step; prefix hits "
        f"{stats.get('prefix_cache', {}).get('hits')}")
    return launches, summary, server


def phase_quant(dev, rpa_int8_entry: dict, gmm_entries: list,
                serve_summary) -> dict:
    """Phase 14: quantized serving on b1 dense at 16 layers (`serve
    --preset b1 --dense --quantize int8 --kv-cache-dtype int8
    --prefix-cache-pages 64`, its engine built by the CLI's builder and
    served in process), then int4, b1's experts under int8, and `convert
    --to int8` of phase 7's checkpoint with `chat` from the export."""
    import torch

    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.config import ConfigPresets
    from luminaai_tpu_torch.inference.chat import build_engine
    from luminaai_tpu_torch.ops import gmm as tg
    from luminaai_tpu_torch.ops import ragged_paged_attention as rpa
    from luminaai_tpu_torch.ops.quantized import QuantizedTensor

    t_phase = time.perf_counter()
    fn = rpa.ragged_paged_attention

    def first_step(dec, kind):
        """The first decode step through the kernel and through the plain
        version: (kernel logits, max abs difference, its LOGIT_RTOL
        bound); the step launches `kind` exactly once a layer."""
        n0 = (fn.launches, fn.launches_int8)
        lk = dec.step_logits()
        lp = dec.step_logits("plain")
        torch.cuda.synchronize()
        got = (fn.launches - n0[0], fn.launches_int8 - n0[1])
        want = {"bf16": (cfg_layers, 0), "int8": (0, cfg_layers)}[kind]
        if got != want or not torch.isfinite(lk).all():
            raise AssertionError(f"{kind} decode step launched {got}")
        return (lk, (lk - lp).abs().max().item(),
                LOGIT_RTOL * lp.abs().max().item())

    # Phase 1's bf16 engine (the same seed): its bytes and first step;
    # then the same weights over an int8 pool, B5-int8 against the plain
    # version within LOGIT_RTOL, as phase 1 holds B5.
    base = build_engine(ConfigPresets.get("b1", use_moe=False), device=dev,
                        seed=0)
    cfg_layers = base.config.num_layers
    dec = _filled_decoder(base)
    l_bf16, _, _ = first_step(dec, "bf16")
    bytes_bf16, pool_bf16 = _state_bytes(base.model), _pool_bytes(dec)
    del dec
    base.configure(kv_cache_dtype="int8")
    _, kv_err, kv_tol = first_step(_filled_decoder(base), "int8")
    log(f"quant: bf16 weights over an int8 KV pool, first decode step "
        f"B5-int8 vs plain max_abs_err {kv_err:.3e} (tol {kv_tol:.3e} = "
        f"{LOGIT_RTOL} x max|logit|)")
    if kv_err > kv_tol:
        raise AssertionError("int8-KV decode logits disagree with plain")
    del base
    _release()

    engine = cli.build_serve_engine(_serve_argv(
        "--quantize", "int8", "--kv-cache-dtype", "int8",
        "--prefix-cache-pages", str(QUANT_ARENA_PAGES)))
    info = engine.quantization_info
    cfg = engine.config
    if info.get("mode") != "int8_compute" or cfg.kv_cache_dtype != "int8":
        raise AssertionError(f"engine not quantized: {info}")
    n_qt = sum(isinstance(m, QuantizedTensor) for m in engine.model.modules())
    bytes_int8 = _state_bytes(engine.model)
    dec = _filled_decoder(engine)
    pool_int8 = _pool_bytes(dec)
    lk, err, tol = first_step(dec, "int8")
    agree = int((lk.argmax(-1) == l_bf16.argmax(-1)).sum().item())
    log("quant: where a W8A8 + int8-KV decode step's time goes:")
    profile_decode(dec)
    del dec
    # The same W8A8 weights over a bf16 pool: bf16 B5 against plain, the
    # yardstick of what the int8 products make of an attention difference.
    engine.configure(kv_cache_dtype="bf16")
    _, bf_err, _ = first_step(_filled_decoder(engine), "bf16")
    engine.configure(kv_cache_dtype="int8")
    w8_tol = W8A8_LOGIT_RTOL / LOGIT_RTOL * tol
    log(f"quant: int8 engine ({n_qt} int8 weights, {info['quantized_leaves']}"
        f"/{info['total_leaves']} leaves): weights {bytes_int8 / 1e9:.3f} GB "
        f"vs bf16 {bytes_bf16 / 1e9:.3f} GB ({bytes_bf16 / bytes_int8:.3f}x);"
        f" KV pool {pool_int8 / 1e6:.1f} MB vs {pool_bf16 / 1e6:.1f} MB "
        f"({pool_int8 / pool_bf16:.4f}x); first decode step, W8A8 weights: "
        f"B5-int8 vs plain max_abs_err {err:.3e}, bf16 B5 vs plain "
        f"{bf_err:.3e} (tol {w8_tol:.3e} = {W8A8_LOGIT_RTOL} x max|logit|);"
        f" top-1 agreement with bf16 {agree}/{LANES}")
    if max(err, bf_err) > w8_tol:
        raise AssertionError("W8A8 decode logits disagree with plain")
    del lk, l_bf16
    _release()

    def reset():
        fn.launches = fn.launches_int8 = fn.launches_global = 0

    system, turns = _plane_texts(1)
    launches, summary, server = _quant_server(
        engine, "quant serve", reset,
        lambda: {"bf16": fn.launches, "int8": fn.launches_int8,
                 "global": fn.launches_global}, system, turns)
    want = summary["decode_steps"] * cfg.num_layers
    log(f"quant: B5 launches {launches} (decode steps x layers = {want})")
    if launches != {"bf16": 0, "int8": want, "global": want}:
        raise AssertionError("the int8 decode path did not run B5-int8 "
                             "through the global table exactly")
    stats = summary.pop("stats")
    if stats.get("kv_cache_dtype") != "int8" or stats.get(
            "quantization", {}).get("mode") != "int8_compute":
        raise AssertionError(f"/stats: {stats.get('quantization')}")
    rpa_int8_entry["launches"] = launches["int8"]

    # One int8 arena page out and back in (LPG1): its size and bytes.
    pool = server.batcher.decoder.pool
    arena0 = LANES * pool.pages
    last = (server.batcher.decoder.total_slots * pool.pages) - 1
    t0 = time.perf_counter()
    page = pool.export_page(arena0)
    export_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    pool.import_page(last, page)
    import_ms = 1e3 * (time.perf_counter() - t0)
    leaf_bytes = cfg.num_layers * 2 * PAGE * cfg.num_kv_heads * (
        cfg.head_dim() + 4)
    if pool.export_page(last) != page or len(page) < leaf_bytes:
        raise AssertionError("int8 page export/import is not byte exact")
    log(f"quant: one int8 page {len(page)} B ({leaf_bytes} B of leaves + "
        f"{len(page) - leaf_bytes} B header), export {export_ms:.2f} ms, "
        f"import {import_ms:.2f} ms, bytes equal after the round trip")
    server.close()
    del server, engine, pool
    _release()

    # --quantize int4: packed storage, dequantized once at load; one
    # request through its server.
    from luminaai_tpu_torch.serving.server import ChatServer

    engine4 = cli.build_serve_engine(_serve_argv("--quantize", "int4"))
    q4 = engine4.quantization_info
    server4 = ChatServer(engine4, num_slots=LANES, page_size=PAGE)
    httpd = server4.make_httpd("127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        code, _, reply = _call(f"http://127.0.0.1:{httpd.server_address[1]}",
                               "/v1/generate", {"prompt": _prompt(64, 1),
                                                "max_new_tokens": 8,
                                                "temperature": 0})
    finally:
        httpd.shutdown()
        httpd.server_close()
        server4.close()
    if q4.get("bits") != 4 or code != 200:
        raise AssertionError(f"int4 engine: {q4}, {code} {reply}")
    log(f"quant: int4 engine ({q4['quantized_leaves']} leaves, "
        f"{q4['compression']:.2f}x at rest) answered 200 with "
        f"{reply.get('tokens')} tokens")
    del engine4, server4
    _release()

    # b1's experts under int8: gather dispatch, no B4a launch.
    moe_cfg = ConfigPresets.get("b1", num_layers=QUANT_MOE_LAYERS,
                                moe_dispatch="gmm",
                                quantization_method="int8")
    moe = build_engine(moe_cfg, device=dev, seed=0)
    g0 = tg.gmm.launches
    toks, st = moe.generate(moe.tokenizer.encode_text(_prompt(300, 2)),
                            max_new_tokens=8, temperature=0.0)
    torch.cuda.synchronize()
    b4a = tg.gmm.launches - g0
    n_experts = sum(hasattr(b, "moe") and isinstance(b.moe.wi,
                                                     QuantizedTensor)
                    for b in moe.model.layers)
    log(f"quant: b1 MoE at {QUANT_MOE_LAYERS} layers, int8 experts on "
        f"{n_experts} layers: {st['tokens_generated']} tokens, B4a launches "
        f"{b4a} (gather dispatch)")
    if b4a or n_experts != moe_cfg.num_moe_layers():
        raise AssertionError("int8 experts did not run gather dispatch")
    del moe
    _release()

    # convert --to int8 of phase 7's checkpoint, then chat from it.
    conv = {}
    src = RUN_DIR / "A"
    if src.exists():
        out = RUN_DIR / "A_int8"
        t0 = time.perf_counter()
        rc = cli.main(["convert", "--checkpoint", str(src), "--to", "int8",
                       "--out", str(out)])
        conv["convert_s"] = time.perf_counter() - t0
        rc_chat = cli.main(["chat", "--checkpoint", str(out), "--prompt",
                            "hello there", "--max-new-tokens", "8",
                            "--temperature", "0"])
        conv["export_mb"] = sum(f.stat().st_size for f in out.rglob("*")
                                if f.is_file()) / 1e6
        log(f"quant: convert --to int8 of phase 7's checkpoint rc {rc} in "
            f"{conv['convert_s']:.1f}s ({conv['export_mb']:.1f} MB), chat "
            f"from the export rc {rc_chat}")
        if rc or rc_chat:
            raise AssertionError("convert --to int8 / chat failed")
        shutil.rmtree(out)
    out = {
        "weight_bytes": {"bf16": bytes_bf16, "int8": bytes_int8,
                         "ratio": bytes_bf16 / bytes_int8},
        "pool_bytes": {"bf16": pool_bf16, "int8": pool_int8,
                       "ratio": pool_int8 / pool_bf16},
        "first_step_err": err, "first_step_bf16_kv_err": bf_err,
        "first_step_w8a8_tol": w8_tol, "first_step_kv_only_err": kv_err,
        "first_step_kv_only_tol": kv_tol,
        "top1_agree": agree, "launches": launches, **summary,
        "page_bytes": len(page), "page_export_ms": export_ms,
        "page_import_ms": import_ms, "int4": q4, "moe_b4a": b4a,
        "convert": conv, "wall_s": time.perf_counter() - t_phase,
    }
    if serve_summary:
        out["bf16_serve"] = {k: serve_summary[k] for k in (
            "tokens_per_s", "decode_step_ms")}
    log(f"quant: {summary['tokens_per_s']:.1f} tok/s, "
        f"{summary['decode_step_ms']:.3f} ms a decode step (phase 1: "
        f"{out.get('bf16_serve')}); phase wall {out['wall_s']:.1f} s "
        f"({_smi()})")
    return out


# ---------------------------------------------------------------------------
# Phase 15: multi-GPU training on one card (the sharded path on a one-rank
# NCCL mesh; ring attention over virtual ranks).
# ---------------------------------------------------------------------------
def _mesh_launches():
    from luminaai_tpu_torch.ops import flash_attention as fa
    from luminaai_tpu_torch.ops import gmm as tg

    return {"B1": fa.flash_fwd.launches, "B2": fa.flash_bwd_dq.launches,
            "B3": fa.flash_bwd_dkv.launches, "B4a": tg.gmm.launches,
            "B4b": tg.tgmm.launches}


def _comm_events(prof) -> dict:
    """The profile's collective events: CPU-side ranges naming FSDP2's
    all-gather / reduce-scatter and NCCL's ops, and CUDA kernels whose
    name says nccl."""
    import torch

    cpu, dev = {}, {}
    for e in prof.key_averages():
        key = e.key
        low = key.lower()
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if "nccl" in low:
                dev[key[:80]] = [e.count, e.self_device_time_total / 1e3]
        elif "fsdp::" in low or "nccl:" in low:
            cpu[key[:80]] = e.count
    return {"cpu": cpu, "cuda": dev}


def _trace_start(cuda: bool) -> int:
    """Record the caching allocator's events and the record_function
    ranges open around them (no Python stacks: capturing them inside a
    checkpoint's recompute in the backward raised SystemError on the
    card's torch 2.11) from here; returns the bytes allocated before."""
    import torch

    if not cuda:
        return 0
    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(
        max_entries=TRACE_EVENTS, context=None,
        global_record_annotations=True)
    return torch.cuda.memory_allocated()


# The ranges mesh_child opens around the phases of a run (_annotate).
TRACE_RANGES = ("init", "forward", "backward", "optimizer")


def _annotate() -> None:
    """Open a record_function range (TRACE_RANGES) around the Trainer's
    build, the model's forward, autograd's backward and the optimizer's
    update, for _trace_account to name what allocated each block."""
    import torch
    from torch.profiler import record_function

    from luminaai_tpu_torch.models.transformer import LuminaTransformer
    from luminaai_tpu_torch.training import optimizer as topt
    from luminaai_tpu_torch.training import trainer as tr

    def wrap(owner, attr, name):
        fn = getattr(owner, attr)

        def ranged(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)

        setattr(owner, attr, ranged)

    wrap(tr.Trainer, "__init__", "init")
    wrap(LuminaTransformer, "forward", "forward")
    wrap(torch.Tensor, "backward", "backward")
    wrap(torch.autograd, "grad", "backward")
    wrap(topt.AdamW, "apply", "optimizer")
    wrap(topt.AdamWInt8, "apply", "optimizer")


def _ranges(annotations):
    """[(start_us, end_us, name)] of the recorded record_function ranges
    (this script's and FSDP2's)."""
    open_, out = {}, []
    for a in annotations or []:
        name = a.get("name", "")
        if name not in TRACE_RANGES and not name.startswith("FSDP::"):
            continue
        if a.get("stage") == "START":
            open_.setdefault(name, []).append(a["time_us"])
        elif open_.get(name):
            out.append((open_[name].pop(), a["time_us"], name))
    return out


def _holder(t_us, ranges) -> str:
    """The ranges open at t_us: this script's, outermost first, then
    FSDP2's innermost ('-' for none)."""
    mine = [(s, n) for s, e, n in ranges if s <= t_us <= e
            and n in TRACE_RANGES]
    fsdp = [(s, n) for s, e, n in ranges if s <= t_us <= e
            and n.startswith("FSDP::")]
    parts = [n for _, n in sorted(mine)]
    if fsdp:
        parts.append(max(fsdp)[1])
    return "/".join(parts) or "-"


def _trace_account(cuda: bool, base: int, top: int = 10) -> dict:
    """Stop the trace; the peak of the bytes allocated over it and what
    held them then: the blocks live at the peak grouped by the ranges
    open when each was allocated (_holder), largest first, the bytes
    allocated before the trace under 'before'."""
    import torch

    if not cuda:
        return {"peak_gb": 0.0, "held_gb": {}}
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    events = snap["device_traces"][0]
    ranges = _ranges(snap.get("external_annotations"))

    def replay(upto):
        live, cur, best, at = {}, 0, -1, -1
        for i, e in enumerate(events[:upto]):
            if e["action"] == "alloc":
                live[e["addr"]] = e
                cur += e["size"]
                if cur > best:
                    best, at = cur, i
            elif e["action"] == "free_completed":
                old = live.pop(e["addr"], None)
                if old is not None:
                    cur -= old["size"]
        return live, best, at

    _, best, at = replay(len(events))
    live, _, _ = replay(at + 1)
    held = {"before": base}
    for e in live.values():
        key = _holder(e.get("time_us", -1), ranges)
        held[key] = held.get(key, 0) + e["size"]
    order = sorted(held.items(), key=lambda kv: -kv[1])[:top]
    return {"peak_gb": (base + max(best, 0)) / 1e9, "events": len(events),
            "ranges": len(ranges),
            "held_gb": {k: round(v / 1e9, 4) for k, v in order}}


def mesh_child(argv: list) -> int:
    """Phase 15 (a), under torchrun with one process: REC -- <train argv>.
    One unsharded Trainer step on the run's seed and first batch, then
    the CLI's `train` (which starts the NCCL group and trains over the
    mesh) recording each step, then one profiled sharded step, then the
    group torn down and the run's checkpoint restored in the unsharded
    Trainer. Writes one JSON record to REC."""
    sep = argv.index("--")
    rec_path, cli_argv = Path(argv[0]), argv[sep + 1:]
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.ops import flash_attention as fa
    from luminaai_tpu_torch.ops import gmm as tg
    from luminaai_tpu_torch.training import trainer as tr

    cfg_path = Path(cli_argv[cli_argv.index("--config") + 1])
    out_dir = Path(cli_argv[cli_argv.index("--output-dir") + 1])
    device = (cli_argv[cli_argv.index("--device") + 1]
              if "--device" in cli_argv else "cuda")  # cpu: a rehearsal
    cfg = Config.load(str(cfg_path))
    cfg.output_dir = str(out_dir.parent / "mesh_plain")
    rec: dict = {}

    def digest(names, tensors):
        return _tensor_digest({n: t.detach().cpu()
                               for n, t in zip(names, tensors)})

    cuda = device != "cpu"
    _annotate()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0

    # The unsharded Trainer (no process group yet): its first step on the
    # run's seed and first batch, and a second step for its time.
    t0 = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    base = _trace_start(cuda)
    plain = tr.Trainer(cfg, cli._synthetic_batches(cfg), device=device,
                       seed=0)
    rec["unsharded_init"] = digest(plain.state.names, plain.state.params)
    batches = iter(cli._synthetic_batches(cfg)())
    batch = plain._to_device(next(batches))
    fa.reset_launches()
    tg.reset_launches()
    _, m = plain.train_step(plain.state, batch)
    rec["unsharded"] = {"loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"]),
                        "launches": _mesh_launches(),
                        "trace": _trace_account(cuda, base)}
    second = plain._to_device(next(batches))
    sync()
    t1 = time.perf_counter()
    _, m = plain.train_step(plain.state, second)
    float(m["loss"])
    rec["unsharded"]["step2_ms"] = (time.perf_counter() - t1) * 1e3
    rec["unsharded"]["peak_gb"] = peak_gb()
    plain.close()
    # `_` holds the unsharded state: drop it before the sharded run is
    # measured (kept alive, it counted in the sharded run's peak).
    del plain, m, second, _
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rec["t_unsharded_s"] = time.perf_counter() - t0

    held, steps = {}, []
    orig_init = tr.Trainer.__init__

    def init(self, *a, **kw):
        orig_init(self, *a, **kw)
        held["trainer"] = self
        rec["sharded_init"] = digest(self.state.names, self.state.params)
        step = self.train_step

        def recording(state, batch):
            before = _mesh_launches()
            sync()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            loss = float(metrics["loss"])
            ms = (time.perf_counter() - t0) * 1e3
            if not steps:  # the trace covers the init and this step
                rec["trace"] = _trace_account(cuda, held["base"])
            after = _mesh_launches()
            steps.append({"loss": loss,
                          "grad_norm": float(metrics["grad_norm"]),
                          "ms": ms,
                          "launches": {k: after[k] - before[k]
                                       for k in after}})
            return state, metrics

        self.train_step = recording

    tr.Trainer.__init__ = init
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    held["base"] = _trace_start(cuda)
    t0 = time.perf_counter()
    rc = cli.main(cli_argv)
    rec["t_train_s"] = time.perf_counter() - t0
    tr.Trainer.__init__ = orig_init
    rec["exit"] = rc
    summary = json.loads((out_dir / "training_summary.json").read_text())
    rec["adaptive_decisions"] = summary.get("adaptive_decisions")
    rec["steps"] = list(steps)
    rec["peak_gb"] = peak_gb()
    t = held["trainer"]
    rec["mesh"] = repr(t.mesh)
    rec["world"] = dist.get_world_size()
    rec["backend"] = dist.get_backend()
    rec["fsdp_sharded"] = type(t.state.dparams[0]).__name__
    saved = digest(t.state.names, t.state.params)
    rec["saved_step"] = t.state.step
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    with profile(activities=acts) as prof:
        t.train_step(t.state, batch)
        sync()
    rec["comm"] = _comm_events(prof)
    rec["profiled_kernels"] = sorted({
        _short(e.key) for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and ("flash_" in e.key or "grouped_kernel" in e.key)})
    del t, held["trainer"]
    dist.destroy_process_group()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # The one-rank run's checkpoint in the unsharded Trainer.
    t0 = time.perf_counter()
    cfg2 = Config.load(str(cfg_path))
    cfg2.output_dir = str(out_dir)
    restored = tr.Trainer(cfg2, cli._synthetic_batches(cfg2),
                          device=device, seed=1,
                          checkpoint_dir=str(out_dir / "checkpoints"))
    rec["restored_step"] = restored.state.step
    rec["restore_bitwise"] = digest(restored.state.names,
                                    restored.state.params) == saved
    restored.close()
    rec["t_restore_s"] = time.perf_counter() - t0
    rec_path.write_text(json.dumps(rec))
    return 0 if rc == 0 else 1


def phase_mesh(dev, flash_entries: list, gmm_entries: list,
               moe_run) -> dict:
    """Phase 15: (a) the sharded path on a one-rank NCCL mesh through
    `train` under torchrun (mesh_child); (b) ring attention over
    RING_RANKS virtual ranks at b75's attention widths."""
    from luminaai_tpu_torch.config import Config

    t_phase = time.perf_counter()
    run = RUN_DIR / "mesh"
    run.mkdir(parents=True, exist_ok=True)
    cfg = Config(**{**FLAGSHIP, "num_layers": MESH_LAYERS},
                 **FLAGSHIP_LEVERS, max_steps=MESH_STEPS,
                 output_dir=str(run / "out"))
    cfg.save(str(run / "flagship.json"))
    rec_path = run / "record.json"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", str(Path(__file__).resolve()),
           "--mesh-child", str(rec_path), "--", "train", "--config",
           str(run / "flagship.json"), "--synthetic", "--steps",
           str(MESH_STEPS), "--seed", "0", "--output-dir",
           str(run / "out")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          cwd=str(RUN_DIR), timeout=600)
    child_s = time.perf_counter() - t0
    (run / "child.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0 or not rec_path.exists():
        raise AssertionError(f"mesh child exited {proc.returncode}:\n"
                             f"{(proc.stdout + proc.stderr)[-4000:]}")
    rec = json.loads(rec_path.read_text())
    first, plain = rec["steps"][0], rec["unsharded"]
    loss_err = abs(first["loss"] - plain["loss"]) / abs(plain["loss"])
    norm_err = abs(first["grad_norm"] - plain["grad_norm"]) / abs(
        plain["grad_norm"])
    log(f"mesh (a): the flagship widths at {MESH_LAYERS} of 10 layers; "
        f"{rec['mesh']}, backend {rec['backend']}, world {rec['world']}, "
        f"parameters {rec['fsdp_sharded']}; child {child_s:.1f} s (exit "
        f"{rec['exit']}; unsharded Trainer {rec['t_unsharded_s']:.1f} s, "
        f"train {rec['t_train_s']:.1f} s, restore "
        f"{rec['t_restore_s']:.1f} s)")
    log(f"  first sharded step vs unsharded: loss {first['loss']:.7f} vs "
        f"{plain['loss']:.7f} (rel {loss_err:.2e}), grad_norm "
        f"{first['grad_norm']:.7f} vs {plain['grad_norm']:.7f} (rel "
        f"{norm_err:.2e}), tol {MESH_RTOL}; same initial weights: "
        f"{rec['sharded_init'] == rec['unsharded_init']}")
    if rec["sharded_init"] != rec["unsharded_init"]:
        raise AssertionError("the sharded run starts from other weights")
    if loss_err > MESH_RTOL or norm_err > MESH_RTOL:
        raise AssertionError("the sharded first step disagrees with the "
                             "unsharded one")
    log(f"  launches, first step: sharded {first['launches']} unsharded "
        f"{plain['launches']}")
    if first["launches"] != plain["launches"] or min(
            plain["launches"].values()) == 0:
        raise AssertionError("the sharded step did not launch B1-B4 as the "
                             "unsharded one does")
    comm = rec["comm"]
    log(f"  profiled sharded step: collectives (host) {comm['cpu']}, "
        f"(card) {comm['cuda']}; port kernels {rec['profiled_kernels']}")
    # FSDP2 ran: its unshard before each unit's forward and its gradient
    # reduction after each unit's backward are in the profile. Its
    # all-gather and reduce-scatter themselves go to NCCL only over more
    # than one rank (FSDP2 copies the shard in place of a one-rank
    # all-gather); they are required wherever they were issued.
    ranges = " ".join(comm["cpu"])
    for part in ("FSDP::pre_forward", "FSDP::post_backward_reduce"):
        if part not in ranges:
            raise AssertionError(f"{part} not in the sharded step's profile")
    names = (ranges + " " + " ".join(comm["cuda"])).lower()
    collectives = {
        "all_gather": "all_gather" in names or "allgather" in names,
        "reduce_scatter": ("reduce_scatter" in names
                           or "reducescatter" in names),
        # HSDP's gradient all-reduce over the replicate dimension.
        "all_reduce": "all_reduce" in names or "allreduce" in names}
    log(f"  FSDP2 collectives issued: {collectives} (world {rec['world']})")
    if rec["world"] > 1 and not (collectives["all_gather"]
                                 and collectives["reduce_scatter"]):
        raise AssertionError("no FSDP2 all-gather / reduce-scatter in the "
                             "sharded step's profile")
    kinds = " ".join(rec["profiled_kernels"])
    for part in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "grouped_kernel"):
        if part not in kinds:
            raise AssertionError(f"{part} not in the sharded step's "
                                 "profile")
    losses = [s["loss"] for s in rec["steps"]]
    if len(losses) != MESH_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"sharded run: {losses}")
    step_ms = statistics.median(s["ms"] for s in rec["steps"][1:])
    p6 = moe_run or {}
    log(f"  losses {losses}; sharded step {step_ms:.1f} ms (steps "
        f"2-{MESH_STEPS}, median) vs the unsharded Trainer's second step "
        f"{plain['step2_ms']:.1f} ms at the same depth (phase 6, "
        f"{FLAGSHIP_TRAIN_LAYERS} layers: {p6.get('step_ms_median', float('nan')):.1f} ms); peak "
        f"memory {rec['peak_gb']:.2f} GB vs {plain['peak_gb']:.2f} GB "
        f"unsharded (phase 6: {p6.get('peak_memory_gb', float('nan')):.2f}"
        f" GB)")
    tr_s, tr_u = rec["trace"], plain["trace"]
    log(f"  traced peak (init and first step): sharded "
        f"{tr_s['peak_gb']:.3f} GB, held by {tr_s['held_gb']}; unsharded "
        f"{tr_u['peak_gb']:.3f} GB, held by {tr_u['held_gb']}")
    above = {k: round(v - tr_u["held_gb"].get(k, 0.0), 4)
             for k, v in tr_s["held_gb"].items()
             if v - tr_u["held_gb"].get(k, 0.0) > 0.01}
    log(f"  sharded above unsharded at the peaks, by holder: {above}")
    log(f"  run under the orchestrator (the CLI's default over a mesh): "
        f"adaptive_decisions {rec['adaptive_decisions']}")
    if rec["adaptive_decisions"] is None:
        raise AssertionError("the mesh run's summary carries no "
                             "adaptive_decisions: the orchestrator did not "
                             "run")
    log(f"  checkpoint of step {rec['saved_step']} restored in the "
        f"unsharded Trainer at step {rec['restored_step']}, bitwise: "
        f"{rec['restore_bitwise']}")
    if not rec["restore_bitwise"] or rec["restored_step"] != rec[
            "saved_step"]:
        raise AssertionError("the one-rank checkpoint did not restore "
                             "bitwise in the unsharded Trainer")
    launched = {k: sum(s["launches"][k] for s in rec["steps"])
                for k in plain["launches"]}
    for e, kern in zip(flash_entries + gmm_entries,
                       ("B1", "B2", "B3", "B4a", "B4b")):
        e["launches"] = (e["launches"] or 0) + launched[kern]
        e["launches_mesh"] = launched[kern]
    out = {"first_step_loss_rel": loss_err,
           "first_step_grad_norm_rel": norm_err, "losses": losses,
           "step_ms_median": step_ms, "peak_memory_gb": rec["peak_gb"],
           "unsharded_step_ms": plain["step2_ms"],
           "unsharded_peak_memory_gb": plain["peak_gb"],
           "traced_peak_gb": tr_s["peak_gb"],
           "traced_unsharded_peak_gb": tr_u["peak_gb"],
           "held_gb": tr_s["held_gb"], "unsharded_held_gb": tr_u["held_gb"],
           "launches": launched, "comm": comm, "collectives": collectives,
           "child_s": child_s}
    out["ring"] = _virtual_ring(dev, flash_entries)
    shutil.rmtree(run, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"mesh phase: {out['wall_s']:.1f} s ({_smi()})")
    return out


def _virtual_ring(dev, flash_entries: list) -> dict:
    """Phase 15 (b): the ring of RING_RANKS virtual ranks at RING_ATTN
    against B1-B3 on the whole sequence, per case."""
    import torch

    from luminaai_tpu_torch.ops import flash_attention as fa
    from luminaai_tpu_torch.ops import ring_attention as ra

    B, S, Hq, Hkv, Dh = RING_ATTN
    g = torch.Generator(device=dev).manual_seed(15)
    q, k, v = (torch.randn(B, S, h, Dh, generator=g, device=dev,
                           dtype=torch.bfloat16) for h in (Hq, Hkv, Hkv))
    w = torch.randn(B, S, Hq, Dh, generator=g, device=dev,
                    dtype=torch.bfloat16)
    res = {}
    for case, (causal, window) in {"causal": (True, None),
                                   "window": (True, RING_WINDOW),
                                   "non_causal": (False, None)}.items():
        def whole():
            return fa.flash_attention_with_lse(
                q, k, v, causal=causal, window=window, block_q=128,
                block_kv=128)

        def ring(kinds=None):
            return ra.virtual_ring_attention(
                q, k, v, RING_RANKS, causal=causal, window=window,
                block_q=128, block_kv=128, kinds=kinds, return_lse=True)

        qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
        o_ref, lse_ref = fa.flash_attention_with_lse(
            qr, kr, vr, causal=causal, window=window, block_q=128,
            block_kv=128)
        (o_ref.float() * w.float()).sum().backward()
        ref = [o_ref.detach(), qr.grad, kr.grad, vr.grad]
        qv, kv_, vv = (t.clone().requires_grad_() for t in (q, k, v))
        kinds = {}
        fa.reset_launches()
        o, lse = ra.virtual_ring_attention(
            qv, kv_, vv, RING_RANKS, causal=causal, window=window,
            block_q=128, block_kv=128, kinds=kinds, return_lse=True)
        torch.cuda.synchronize()
        b1 = fa.flash_fwd.launches
        (o.float() * w.float()).sum().backward()
        torch.cuda.synchronize()
        b2, b3 = fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches
        got = [o.detach(), qv.grad, kv_.grad, vv.grad]
        errs = {}
        for name, a, b in zip(("o", "dq", "dk", "dv"), got, ref):
            errs[name] = float((a.float() - b.float()).abs().max()
                               / b.float().abs().max())
        errs["lse"] = float((lse.detach() - lse_ref.detach()).abs().max())
        with torch.no_grad():
            ms = cuda_ms(ring, 3, warmup=1)
            ms_whole = cuda_ms(whole, 3, warmup=1)
        log(f"mesh (b) ring {case}: chunks {kinds}; B1 {b1} (want "
            f"{RING_B1[case]}), B2 {b2}, B3 {b3}; max rel err "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + f"; forward {ms:.3f} ms vs B1 on the whole sequence "
            f"{ms_whole:.3f} ms")
        if b1 != RING_B1[case] or b2 != b1 or b3 != b1:
            raise AssertionError(f"ring {case}: B1-B3 launched {b1}, {b2}, "
                                 f"{b3}, want {RING_B1[case]} each")
        if max(errs[n] for n in ("o", "dq", "dk", "dv")) > FLASH_REL_TOL \
                or errs["lse"] > LSE_TOL:
            raise AssertionError(f"ring {case} disagrees with B1-B3 on "
                                 f"the whole sequence: {errs}")
        res[case] = {"kinds": kinds, "B1": b1, "errs": errs,
                     "ring_fwd_ms": ms, "whole_fwd_ms": ms_whole}
        del qr, kr, vr, qv, kv_, vv, o, lse, got, ref, o_ref, lse_ref
        _release()
    return res


# ---------------------------------------------------------------------------
# Phase 16: pipeline stages played in one process, and the optimizer's
# host offload.
# ---------------------------------------------------------------------------
def _pipe_eval_one(cfg, model, batch) -> dict:
    """The one-stage eval averaged over the pipeline's microbatches (the
    pipelined eval routes each microbatch as its own batch)."""
    import torch

    from luminaai_tpu_torch.parallel import train_step as ts

    ev = ts.make_eval_step(cfg, model)
    B = batch["input_ids"].shape[0] // PIPE_MICRO
    ms = [ev(None, {k: v[i * B:(i + 1) * B] for k, v in batch.items()})
          for i in range(PIPE_MICRO)]
    return {k: float(torch.stack([m[k] for m in ms]).mean())
            for k in ("loss", "ce_loss")}


def _pipe_runs(dev) -> dict:
    """Phase 16 (a): one step of the one-stage step and of the virtual
    pipeline under each schedule from the same seeded weights, and each
    one's eval before its step."""
    import torch

    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.convert import init_params
    from luminaai_tpu_torch.models.transformer import LuminaTransformer
    from luminaai_tpu_torch.parallel import pipeline as pl
    from luminaai_tpu_torch.parallel import train_step as ts
    from luminaai_tpu_torch.training.optimizer import (
        make_optimizer,
        make_schedule,
    )

    cfg = Config(**{**FLAGSHIP, "num_layers": PIPE_LAYERS}, **FLAGSHIP_LEVERS,
                 gradient_accumulation_steps=PIPE_MICRO, max_steps=3)
    raw = next(iter(cli._synthetic_batches(cfg)()))
    batch = {k: torch.as_tensor(v).long().to(dev) for k, v in raw.items()}
    runs = {}
    for name in ("one", "1f1b", "gpipe"):
        model = init_params(LuminaTransformer(cfg, device=dev,
                                              trainable=True), 0)
        sched = make_schedule(cfg, 3)
        tx = make_optimizer(cfg, 3, sched)
        state = ts.init_train_state(model, tx, 0)
        if name == "one":
            step = ts.make_train_step(cfg, model, sched, tx)
            ev = _pipe_eval_one(cfg, model, batch)
        else:
            step = pl.virtual_pipeline_step(cfg, model, sched, tx,
                                            PIPE_STAGES, PIPE_MICRO, name)
            m = pl.virtual_pipeline_eval(cfg, model, PIPE_STAGES, PIPE_MICRO,
                                         name)(None, batch)
            ev = {k: float(m[k]) for k in ("loss", "ce_loss")}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        state, m = step(state, batch)
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        launches = _launch_counts()
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()  # a second step, timed
        state, m = step(state, batch)
        float(m["loss"])
        ms = (time.perf_counter() - t0) * 1e3
        runs[name] = {
            "loss": loss, "grad_norm": norm, "ms": ms, "eval": ev,
            "launches": launches, "peak_gb": peak / 1e9,
            "step_peak_gb": (peak - base) / 1e9,
            "in_flight": getattr(step, "in_flight", None)}
        del model, state, step, m
        _release()
    return runs


def _offload_runs(dev) -> dict:
    """Phase 16 (b): OFFLOAD_STEPS steps of the unsharded Trainer with the
    optimizer's moments on the card and offloaded to pinned host memory."""
    import torch

    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.training.trainer import Trainer

    out = {}
    for off in (False, True):
        cfg = Config(**{**FLAGSHIP, "num_layers": OFFLOAD_LAYERS},
                     **FLAGSHIP_LEVERS, max_steps=OFFLOAD_STEPS,
                     host_offload_optimizer=off,
                     output_dir=str(RUN_DIR / "offload"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(cfg, cli._synthetic_batches(cfg), device=dev,
                          seed=0)
        opt = trainer.state.opt_state
        moments = opt.tensors()
        rec = {"moment_bytes": sum(t.numel() * t.element_size()
                                   for t in moments),
               "ms": [], "losses": [], "launches": None,
               "on_host_pinned": []}
        _reset_counts()
        for raw in itertools.islice(iter(cli._synthetic_batches(cfg)()),
                                    OFFLOAD_STEPS):
            batch = trainer._to_device(raw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.state, m = trainer.train_step(trainer.state, batch)
            rec["losses"].append(float(m["loss"]))
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["on_host_pinned"].append(all(
                t.device.type == "cpu" and t.is_pinned()
                for t in trainer.state.opt_state.tensors()))
        rec["launches"] = _launch_counts()
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        rec["digest"] = _tensor_digest({
            n: p.detach().cpu() for n, p in zip(trainer.state.names,
                                                trainer.state.params)})
        trainer.close()
        del trainer, opt, moments
        _release()
        out["offload" if off else "card"] = rec
    return out


def phase_pipe(dev, flash_entries: list, gmm_entries: list) -> dict:
    """Phase 16: (a) the virtual pipeline against the one-stage step,
    (b) the optimizer's host offload against the moments on the card."""
    t_phase = time.perf_counter()
    runs = _pipe_runs(dev)
    one = runs["one"]
    want_flight = {"1f1b": [PIPE_STAGES - p for p in range(PIPE_STAGES)],
                   "gpipe": [PIPE_MICRO] * PIPE_STAGES}
    log(f"pipe (a): flagship widths at {PIPE_LAYERS} layers, batch "
        f"{FLAGSHIP['batch_size']} x {FLAGSHIP['seq_length']}, "
        f"{PIPE_STAGES} stages x {PIPE_MICRO} microbatches (one-stage: "
        f"accumulation {PIPE_MICRO}): loss {one['loss']:.7f}, grad_norm "
        f"{one['grad_norm']:.7f}, second step {one['ms']:.1f} ms, peak "
        f"{one['peak_gb']:.2f} GB ({one['step_peak_gb']:.2f} GB over the "
        f"weights and moments), launches {one['launches']}")
    for name in ("1f1b", "gpipe"):
        r = runs[name]
        rl = abs(r["loss"] - one["loss"]) / abs(one["loss"])
        rn = abs(r["grad_norm"] - one["grad_norm"]) / abs(one["grad_norm"])
        re_ = {k: abs(r["eval"][k] - one["eval"][k]) / abs(one["eval"][k])
               for k in ("loss", "ce_loss")}
        r.update(loss_rel=rl, grad_norm_rel=rn, eval_rel=re_)
        log(f"  {name}: loss {r['loss']:.7f} (rel {rl:.2e}), grad_norm "
            f"{r['grad_norm']:.7f} (rel {rn:.2e}), eval loss rel "
            f"{re_['loss']:.2e} / ce {re_['ce_loss']:.2e} (tol "
            f"{MESH_RTOL}); in flight per stage {r['in_flight']} (want "
            f"{want_flight[name]}); second step {r['ms']:.1f} ms; peak "
            f"{r['peak_gb']:.2f} GB ({r['step_peak_gb']:.2f} GB over the "
            f"weights and moments); launches {r['launches']}")
        if max(rl, rn, *re_.values()) > MESH_RTOL:
            raise AssertionError(f"the {name} pipeline disagrees with the "
                                 "one-stage step")
        if r["launches"] != one["launches"] or min(
                one["launches"].values()) == 0:
            raise AssertionError(f"the {name} pipeline did not launch "
                                 "B1-B4 as the one-stage step does")
        if r["in_flight"] != want_flight[name]:
            raise AssertionError(f"{name}: in flight {r['in_flight']}")
    saved = runs["gpipe"]["step_peak_gb"] - runs["1f1b"]["step_peak_gb"]
    log(f"  1F1B's step peak below GPipe's by {saved:.3f} GB")

    off = _offload_runs(dev)
    card, host = off["card"], off["offload"]
    moment_gb = card["moment_bytes"] / 1e9
    drop = card["peak_gb"] - host["peak_gb"]
    ms_card = statistics.median(card["ms"][1:])
    ms_host = statistics.median(host["ms"][1:])
    log(f"pipe (b): flagship widths at {OFFLOAD_LAYERS} layers, "
        f"{OFFLOAD_STEPS} Trainer steps: moments {moment_gb:.3f} GB; peak "
        f"{card['peak_gb']:.3f} GB on the card vs {host['peak_gb']:.3f} GB "
        f"offloaded (lower by {drop:.3f} GB, {drop / moment_gb:.1%} of the "
        f"moments); step {ms_card:.1f} vs {ms_host:.1f} ms (steps 2-"
        f"{OFFLOAD_STEPS}, median); moments on the CPU and pinned after "
        f"each step: {host['on_host_pinned']}; parameters' sha256 equal: "
        f"{card['digest'] == host['digest']}; losses {card['losses']} vs "
        f"{host['losses']}")
    if card["digest"] != host["digest"]:
        raise AssertionError("offloaded moments gave other parameters")
    if not all(host["on_host_pinned"]) or any(card["on_host_pinned"]):
        raise AssertionError("the moments were not where they should be")
    if drop < 0.8 * moment_gb:
        raise AssertionError("the offload did not lower the card's peak by "
                             "80% of the moments' bytes")
    if host["launches"] != card["launches"]:
        raise AssertionError("the offloaded steps launched other kernels")
    launched = {k: sum(r["launches"][k] for r in runs.values())
                + card["launches"][k] + host["launches"][k]
                for k in one["launches"]}
    for e, kern in zip(flash_entries + gmm_entries,
                       ("B1", "B2", "B3", "B4a", "B4b")):
        e["launches"] = (e["launches"] or 0) + launched[kern]
        e["launches_pipe"] = launched[kern]
    shutil.rmtree(RUN_DIR / "offload", ignore_errors=True)
    wall = time.perf_counter() - t_phase
    log(f"pipe phase: {wall:.1f} s ({_smi()})")
    return {"pipeline": runs, "one_f_one_b_peak_saving_gb": saved,
            "offload": {"moment_gb": moment_gb,
                        "peak_card_gb": card["peak_gb"],
                        "peak_offload_gb": host["peak_gb"],
                        "step_ms_card": ms_card,
                        "step_ms_offload": ms_host},
            "launches": launched, "wall_s": wall}


# ---------------------------------------------------------------------------
# Phase 17: the groups and head dims the first kernels left to mma.sync,
# trained on the card
# ---------------------------------------------------------------------------
GROUPS_STEPS = 3  # (a) debug_300m
# (b) b14's attention widths, dense: 2 of its 40 layers (b14 trains on 16+
# cards: fsdp 16 x expert 8), micro-batch 1 x 4096, one card's mesh, two
# Trainer steps.
B14_LAYERS, B14_STEPS = 2, 2


def _groups_run(dev, cfg, label: str, steps: int, plain_gmm: bool,
                loop: bool) -> dict:
    """`steps` Trainer steps of cfg: the first against the same step
    through the plain attention (and the plain gmm), exact B1-B4 launches,
    the flash kernels the profiler names (flash_kernels(head_dim)), step
    times and peak memory. With loop=True the steps run through
    Trainer.train_step on the loop's first batches, without train()'s
    closing checkpoint (a 0.8B-parameter model's fp32 state is 9.6 GB to
    write and hash), and the loss need not fall (two steps under a warmup
    whose first update has lr 0)."""
    import torch

    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.training.trainer import Trainer

    t0 = time.perf_counter()
    trainer = Trainer(cfg, cli._synthetic_batches(cfg), device=dev, seed=0)
    n_params = sum(p.numel() for p in trainer.state.params)
    L, n_moe = cfg.num_layers, cfg.num_moe_layers()
    d = cfg.hidden_size // cfg.num_heads
    log(f"trainer: {label}, {L} layers, hidden {cfg.hidden_size}, "
        f"{cfg.num_heads} q over {cfg.num_kv_heads} kv heads (head_dim {d}), "
        f"{n_moe} MoE layers ({cfg.moe_dispatch}), {n_params / 1e6:.1f}M "
        f"params, batch {cfg.batch_size} x {cfg.seq_length}, accumulation "
        f"{cfg.gradient_accumulation_steps}")
    batches = iter(cli._synthetic_batches(cfg)())
    first = trainer._to_device(next(batches))
    t_built = time.perf_counter()
    plain_loss, plain_norm = _first_step_plain(trainer, cfg, first, plain_gmm)
    t_plain = time.perf_counter()
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    if loop:
        hist, batch = [], first
        for i in range(steps):
            torch.cuda.synchronize()
            t_step = time.perf_counter()
            trainer.state, m = trainer.train_step(trainer.state, batch)
            torch.cuda.synchronize()
            hist.append({"loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"]),
                         "step_seconds": time.perf_counter() - t_step})
            if i + 1 < steps:
                batch = trainer._to_device(next(batches))
    else:
        hist = trainer.train()["history"]
    launches = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t_trained = time.perf_counter()
    ms = [h["step_seconds"] * 1e3 for h in hist]
    for i, h in enumerate(hist, 1):
        log(f"  step {i}: loss {h['loss']:.4f} grad_norm "
            f"{h['grad_norm']:.4f} {ms[i - 1]:.1f} ms")
    losses, norms = _check_run(
        hist, plain_loss, plain_norm,
        "plain attention" + (" and gmm" if plain_gmm else ""), steps,
        not loop)
    n = cfg.gradient_accumulation_steps * steps
    want = {"B1": 2 * L * n, "B2": L * n, "B3": L * n,
            "B4a": 6 * n_moe * n, "B4b": 2 * n_moe * n}
    log(f"kernel launches, {label}: {launches} (want {want}); step ms "
        f"{[round(x, 1) for x in ms]}, peak {peak_gb:.2f} GB")
    if launches != want:
        raise AssertionError(f"{label} did not run through the kernels as "
                             "expected")
    prof = profile_train_step(trainer, first, flash_kernels(d))
    trainer.close()
    del trainer, first
    _release()
    log(f"  {label}: built in {t_built - t0:.1f} s, plain first step "
        f"{t_plain - t_built:.1f} s, {steps} steps"
        f"{'' if loop else ' and the closing checkpoint'} "
        f"{t_trained - t_plain:.1f} s, profiled step and teardown "
        f"{time.perf_counter() - t_trained:.1f} s")
    return {"steps": steps, "losses": losses, "grad_norms": norms,
            "step_ms": ms, "peak_memory_gb": peak_gb, "params": n_params,
            "first_step_loss_plain": plain_loss,
            "first_step_grad_norm_plain": plain_norm, "launches": launches,
            **prof}


def phase_groups(dev, entries: dict, b14: bool) -> dict:
    """Phase 17: (a) `train --preset debug_300m --synthetic --moe-dispatch
    gmm` in process (its config and data through the CLI's own builders):
    full widths and depth (6 layers of hidden 768, 4 q over 2 kv heads at
    head_dim 192, 8 experts top-2, batch 16 x 1024), GROUPS_STEPS steps;
    B1 on flash_fwd_wgmma_kernel, B2 on flash_bwd_dq_wgmma_kernel, B3 on
    flash_bwd_dkv_wgmma_hd256_kernel, B4 through gmm. (b) b14's attention
    widths dense (hidden 5120, 40 q over 8 kv heads, a group of 5 at
    head_dim 128) at B14_LAYERS layers, micro-batch 1 x 4096, B14_STEPS
    steps through Trainer.train_step; B1 on flash_fwd_wgmma_kernel with
    padding rows. Each first step against the plain attention (and gmm),
    launches exact. (b) runs only when b14 is true (`--only groups`): with
    it the whole script ran past its 930 s budget on an H100 (968.4 s);
    phase 2 still holds B1-B3 at b14's attention."""
    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.config import ConfigPresets

    smi = _smi()
    t_phase = time.perf_counter()
    args = cli._parser().parse_args([
        "train", "--preset", "debug_300m", "--synthetic", "--moe-dispatch",
        "gmm", "--steps", str(GROUPS_STEPS), "--output-dir",
        str(RUN_DIR / "groups_300m")])
    cfg = cli._train_config(args)
    a = _groups_run(dev, cfg, "debug_300m", GROUPS_STEPS, True, False)
    _add_launches(entries, a["launches"], "launches_groups_300m")
    out = {"debug_300m": a}
    if not b14:
        out["wall_s"] = time.perf_counter() - t_phase
        log(f"groups: phase wall {out['wall_s']:.1f} s, (b) b14 under "
            f"`--only groups` alone ({smi})")
        return out
    cfg = ConfigPresets.get(
        "b14", use_moe=False, num_layers=B14_LAYERS, batch_size=1,
        gradient_accumulation_steps=1, fsdp_parallel_size=1,
        expert_parallel_size=1, max_steps=B14_STEPS,
        output_dir=str(RUN_DIR / "groups_b14"))
    b = _groups_run(dev, cfg, f"b14 dense at {B14_LAYERS} of 40 layers",
                    B14_STEPS, False, True)
    _add_launches(entries, b["launches"], "launches_groups_b14")
    out.update(b14=b, wall_s=time.perf_counter() - t_phase)
    log(f"groups: phase wall {out['wall_s']:.1f} s ({smi})")
    return out


# ---------------------------------------------------------------------------
# Phase 18: the A5 leftovers (soft prompts, the trainer's profiling window,
# epochs and SLO stack, diagnose / report / events)
# ---------------------------------------------------------------------------
# (a) Soft-prompt tuning at b1's widths (16 layers, dense): P virtual tokens
# before BATCH x S real ones (S + P = 2048, flash-eligible), PROMPT_STEPS
# Adam steps at PROMPT_LR on one repeated batch.
PROMPT_P, PROMPT_S, PROMPT_BATCH = 128, 1920, 4
PROMPT_STEPS, PROMPT_LR = 3, 1e-2
# (b) The Trainer on the flagship MoE widths at MESH_LAYERS layers: epochs
# of A7_EPOCH_STEPS batches, a profiling window of A7_PROFILE_STEPS steps
# from step A7_PROFILE_START, the first step under the FLOP counter.
A7_EPOCH_STEPS, A7_EPOCHS = 2, 2
A7_PROFILE_START, A7_PROFILE_STEPS = 2, 2
# The attributed self time a step must be within this share of the
# trace's card busy time a step (kernels on one stream do not overlap).
A7_BUSY_RTOL = 0.02


def _prompt_tuning(dev, entries: dict) -> dict:
    """(a): `make_prompt_tuning_step` at b1's widths on the card."""
    import numpy as np
    import torch

    from luminaai_tpu_torch.config import ConfigPresets
    from luminaai_tpu_torch.convert import init_params
    from luminaai_tpu_torch.models.transformer import LuminaTransformer
    from luminaai_tpu_torch.training import adapters

    cfg = ConfigPresets.get("b1", use_moe=False)
    t0 = time.perf_counter()
    model = init_params(LuminaTransformer(cfg, device=dev), 0)
    base = _digest_in_background(model)
    t_built = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    prompt = adapters.init_soft_prompt(model, PROMPT_P, gen)
    rng = np.random.RandomState(0)
    ids = torch.as_tensor(rng.randint(1, cfg.vocab_size,
                                      (PROMPT_BATCH, PROMPT_S)),
                          dtype=torch.long, device=dev)
    batch = {"input_ids": ids}
    tx = adapters.adam(PROMPT_LR)
    step = adapters.make_prompt_tuning_step(cfg, model, tx)
    # The first step's loss and prompt gradient through the plain
    # attention, on a copy of the prompt (the step updates in place).
    cfg.use_flash_attention = False
    try:
        _, m = step((prompt.clone(), tx.init([prompt])), batch)
        plain_loss, plain_norm = float(m["loss"]), float(m["grad_norm"])
    finally:
        cfg.use_flash_attention = True
    del m
    torch.cuda.empty_cache()
    t_plain = time.perf_counter()
    carry = (prompt, tx.init([prompt]))
    _reset_counts()
    hist = []
    for _ in range(PROMPT_STEPS):
        torch.cuda.synchronize()
        t_step = time.perf_counter()
        carry, m = step(carry, batch)
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        hist.append({"loss": loss, "grad_norm": norm,
                     "step_seconds": time.perf_counter() - t_step})
    launches = _launch_counts()
    t_steps = time.perf_counter()
    L = cfg.num_layers
    # B1 twice a layer (the forward and the remat recompute), B2 and B3 once.
    want = {"B1": 2 * L * PROMPT_STEPS, "B2": L * PROMPT_STEPS,
            "B3": L * PROMPT_STEPS, "B4a": 0, "B4b": 0}
    ms = [h["step_seconds"] * 1e3 for h in hist]
    log(f"a7 (a) soft prompt: b1 dense, {L} layers, P {PROMPT_P} + S "
        f"{PROMPT_S} = {PROMPT_P + PROMPT_S} rows x {PROMPT_BATCH}; losses "
        f"{[round(h['loss'], 5) for h in hist]}, prompt grad norms "
        f"{[round(h['grad_norm'], 5) for h in hist]}, step ms "
        f"{[round(x, 1) for x in ms]}; launches {launches} (want {want})")
    if launches != want:
        raise AssertionError("soft-prompt tuning did not run through B1-B3 "
                             "as expected")
    loss_err = abs(hist[0]["loss"] - plain_loss) / abs(plain_loss)
    norm_err = abs(hist[0]["grad_norm"] - plain_norm) / abs(plain_norm)
    log(f"  first step, kernels vs the plain attention: loss rel "
        f"{loss_err:.2e} (tol {LOSS_RTOL}), prompt grad norm rel "
        f"{norm_err:.2e} (tol {GRAD_NORM_RTOL})")
    if loss_err > LOSS_RTOL or norm_err > GRAD_NORM_RTOL:
        raise AssertionError("the soft-prompt step disagrees with the plain "
                             "attention's")
    if not all(map(math.isfinite, [h["loss"] for h in hist])) or not (
            hist[-1]["loss"] < hist[0]["loss"]):
        raise AssertionError("soft-prompt tuning: the loss did not fall")
    grads = [n for n, p in model.named_parameters()
             if p.requires_grad or p.grad is not None]
    if grads:
        raise AssertionError(f"the base model holds gradients: {grads[:3]}")
    _add_launches(entries, launches, "launches_a7_prompt")
    # The base's digest after the steps, hashed while (b) runs: the
    # caller compares it with the one from before (`base`).
    after = _digest_in_background(model)
    del model, carry, step
    _release()
    log(f"  (a): built {t_built - t0:.1f} s, plain step "
        f"{t_plain - t_built:.1f} s, {PROMPT_STEPS} steps "
        f"{t_steps - t_plain:.1f} s, checks {time.perf_counter() - t_steps:.1f}"
        f" s")
    return {"losses": [h["loss"] for h in hist],
            "grad_norms": [h["grad_norm"] for h in hist], "step_ms": ms,
            "first_step_loss_plain": plain_loss,
            "first_step_grad_norm_plain": plain_norm,
            "launches": launches, "digests": (base, after)}


def _same_base(digests) -> str:
    """Wait for (a)'s two background digests; raise unless equal."""
    for d in digests:
        d["thread"].join()
    before, after = (d["digest"] for d in digests)
    log(f"a7 (a) base parameters' sha256 before and after the steps: "
        f"{before[:16]}, {after[:16]}")
    if before != after:
        raise AssertionError("soft-prompt tuning moved the base parameters")
    return before


def _a7_trainer(dev, entries: dict) -> dict:
    """(b): the Trainer with epochs, a profiling window, the SLO stack and
    the first step's cost analysis, at the flagship widths."""
    import torch

    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.training.trainer import Trainer

    out_dir = RUN_DIR / "a7"
    cfg = Config(**{**FLAGSHIP, "num_layers": MESH_LAYERS},
                 **FLAGSHIP_LEVERS, num_epochs=A7_EPOCHS,
                 profile_start_step=A7_PROFILE_START,
                 profile_num_steps=A7_PROFILE_STEPS,
                 compiled_cost_analysis=True, output_dir=str(out_dir),
                 # A log boundary every step: router_health events for
                 # (c)'s flight record.
                 health_check_interval=10)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, cli._synthetic_batches(cfg,
                                                  n_batches=A7_EPOCH_STEPS),
                      device=dev, seed=0, steps_per_epoch=A7_EPOCH_STEPS)
    t_built = time.perf_counter()
    _reset_counts()
    summary = trainer.train()
    launches = _launch_counts()
    t_train = time.perf_counter()
    trainer._dump_flight_record("a7")
    costs = trainer._compiled_costs or {}
    ckpt_dir = str(trainer.checkpoints.dir)
    trainer.close()
    (out_dir / "training_summary.json").write_text(
        json.dumps(cli._jsonable(summary), indent=2))
    n = A7_EPOCH_STEPS * A7_EPOCHS
    L, n_moe = cfg.num_layers, cfg.num_moe_layers()
    want = {"B1": 2 * L * n, "B2": L * n, "B3": L * n, "B4a": 6 * n_moe * n,
            "B4b": 2 * n_moe * n}
    log(f"a7 (b) trainer: flagship widths at {L} layers, final_step "
        f"{summary['final_step']}, epochs {summary['epochs']}, launches "
        f"{launches} (want {want}); step ms "
        f"{[round(h['step_seconds'] * 1e3, 1) for h in summary['history']]}")
    if (summary["final_step"], summary["epochs"]) != (n, A7_EPOCHS):
        raise AssertionError("the trainer did not stop after its epochs")
    if launches != want:
        raise AssertionError("the trainer's steps did not run through the "
                             "kernels as expected")
    if "slo" not in summary:
        raise AssertionError("the trainer's summary carries no SLO verdicts")
    prof_dir = out_dir / "profile"
    traces = sorted(p.name for p in prof_dir.glob("*.pt.trace.json"))
    records = (prof_dir / "attribution.jsonl").read_text().splitlines()
    rec = json.loads(records[-1])
    subs = {k: v["ms_per_step"] for k, v in rec["subsystems"].items()}
    busy = rec["device_busy_ms_per_step"]
    total = rec["total_ms_per_step"]
    log(f"  profile window: {traces}, n_steps {rec['n_steps']}, attributed "
        f"{total:.3f} ms a step against {busy:.3f} ms busy; subsystems "
        f"(ms a step) {subs}")
    for o in rec["top_ops"][:5]:
        log(f"    {o['ms_per_step']:8.3f} ms  {o['fw_name']}")
    if traces != [f"steps{A7_PROFILE_START}-"
                  f"{A7_PROFILE_START + A7_PROFILE_STEPS}.pt.trace.json"] or (
            rec["n_steps"] != A7_PROFILE_STEPS):
        raise AssertionError("the profiling window wrote no trace of its "
                             "steps")
    for name in ("attn_flash_kernels", "moe_expert_matmul", "ce_loss"):
        if not subs.get(name, 0) > 0:
            raise AssertionError(f"the window attributes nothing to {name}")
    if not busy > 0 or abs(total - busy) > A7_BUSY_RTOL * busy:
        raise AssertionError("the attributed time is not the card's busy "
                             "time")
    xc = costs.get("mfu_crosscheck") or {}
    mem = costs.get("memory") or {}
    audit = costs.get("donation_audit") or {}
    log(f"  first step under the FLOP counter: counted "
        f"{xc.get('compiled_flops_per_step', 0):.4e} FLOPs (aten "
        f"{(costs.get('cost_model') or {}).get('aten_flops', 0):.4e}, "
        f"kernels {(costs.get('cost_model') or {}).get('kernel_flops')}), "
        f"analytic 6NT {xc.get('analytic_flops_per_step', 0):.4e}, "
        f"divergence {xc.get('divergence')} (flagged {xc.get('flagged')}); "
        f"peak {mem.get('peak_bytes', 0) / 1e9:.2f} GB; in-place coverage "
        f"{audit.get('coverage')}")
    if not costs.get("available") or xc.get("divergence") is None:
        raise AssertionError("the first step's cost analysis is missing")
    if set((costs.get("cost_model") or {}).get("kernel_flops") or {}) != {
            "B1", "B2", "B3", "B4a", "B4b"}:
        raise AssertionError("the kernels reported no FLOPs to the counter")
    _add_launches(entries, launches, "launches_a7_trainer")
    _release()
    log(f"  (b): built {t_built - t0:.1f} s, trained {t_train - t_built:.1f}"
        f" s (goodput {summary['goodput'].get('seconds')}), checks and "
        f"teardown {time.perf_counter() - t_train:.1f} s")
    return {"summary_keys": sorted(summary), "launches": launches,
            "attribution": rec, "costs": costs, "out_dir": str(out_dir),
            "ckpt_dir": ckpt_dir,
            "step_ms": [h["step_seconds"] * 1e3 for h in summary["history"]]}


def _cli_capture(argv: list) -> tuple:
    """(exit code, stdout) of the CLI's main, in this process."""
    import contextlib
    import io

    from luminaai_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def phase_a7(dev, entries: dict) -> dict:
    """Phase 18: (a) soft-prompt tuning at b1's widths, (b) the Trainer's
    epochs, profiling window, attribution, SLO stack and cost analysis at
    the flagship widths, (c) `diagnose`, `report training` and `events
    --stats` through the CLI's main."""
    smi = _smi()
    t_phase = time.perf_counter()
    out = {"prompt": _prompt_tuning(dev, entries)}
    b = _a7_trainer(dev, entries)
    out["prompt"]["base_sha256"] = _same_base(out["prompt"].pop("digests"))
    out["trainer"] = {k: v for k, v in b.items() if k != "costs"}
    out["trainer"]["divergence"] = (b["costs"].get("mfu_crosscheck")
                                    or {}).get("divergence")
    t_c = time.perf_counter()
    rc, text = _cli_capture(["diagnose", "--preset", "b1"])
    t_diag = time.perf_counter()
    card = smi.split(",")[0].strip()
    log(f"a7 (c) diagnose: exit {rc}; " + "; ".join(
        ln.strip() for ln in text.splitlines()
        if "device_kind" in ln or "mean_seconds" in ln
        or "probe_seconds" in ln or "recommended" in ln)[:700])
    if rc != 0 or card not in text:
        raise AssertionError(f"diagnose failed or did not name {card!r}")
    report = Path(b["out_dir"]) / "training_report.html"
    rc_r, _ = _cli_capture(["report", "training", "--dir", b["out_dir"]])
    rc_e, ev = _cli_capture(["events", "--stats", b["ckpt_dir"]])
    log(f"  report exit {rc_r} ({report.stat().st_size if report.exists() else 0}"
        f" bytes); events --stats exit {rc_e}: "
        + " | ".join(ev.strip().splitlines()[:4]))
    if rc_r != 0 or not report.exists() or rc_e != 0 or (
            "router_health" not in ev):
        raise AssertionError("report or events failed")
    out["cli_s"] = time.perf_counter() - t_c
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"a7: phase wall {out['wall_s']:.1f} s (CLI part {out['cli_s']:.1f}"
        f" s, diagnose {t_diag - t_c:.1f} s) ({smi})")
    return out


# Phase 19: the last JAX modules (the rolling window cache with
# scalar-offset decode, the host-sync audit on the card, `analyze`)
# ---------------------------------------------------------------------------
# b1's widths with a window of 1020: C = ceil(1020 / 128) * 128 = 1024
# slots, slack 4, so speculation's draft_k 8 is capped at 5.
A8_WINDOW = 1020
A8_PROMPT, A8_NEW = 1800, 128
A8_DRAFT_K, A8_SPEC_NEW = 8, 48
A8_LANES, A8_LANE_NEW = (300, 800, 1300, 1800), 16
A8_INT8_NEW = 8
A8_TRAIN_LAYERS = 2


def _a8_model(dev):
    """(model, config) of b1 dense with the window, seeded bf16 weights."""
    from luminaai_tpu_torch.config import ConfigPresets
    from luminaai_tpu_torch.convert import init_params
    from luminaai_tpu_torch.models.transformer import LuminaTransformer

    cfg = ConfigPresets.get("b1", use_moe=False)
    cfg.attention_window = A8_WINDOW
    model = init_params(LuminaTransformer(cfg, device=dev), 0)
    return model, cfg


def _greedy_run(engine, prompt, n_new, forced=None, time_steps=False):
    """Prefill `prompt` and decode n_new - 1 rows after the first token:
    (tokens, per-step fp32 logits on the host, step ms, caches). With
    `forced`, row i feeds forced[i] (teacher forcing) and tokens are
    this run's own argmaxes."""
    import numpy as np
    import torch

    prompt = list(prompt)
    L = len(prompt)
    bucket = min(max(64, 1 << (L - 1).bit_length()), engine.max_context)
    ids = np.zeros((1, bucket), dtype=np.int64)
    ids[0, :L] = prompt
    caches = engine.init_cache(1, engine.max_context)
    logits = engine._prefill_rows(caches, ids, 0, L)
    rows, tokens, ms = [logits.float().cpu()], [], []
    tok = int(logits.argmax(-1))
    tokens.append(tok)
    for i in range(n_new - 1):
        feed = forced[i] if forced is not None else tok
        if time_steps:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = engine._decode_logits(caches, feed, L + i)
        tok = int(logits.argmax(-1))
        if time_steps:
            ms.append((time.perf_counter() - t0) * 1e3)
        rows.append(logits.float().cpu())
        tokens.append(tok)
    return tokens, rows, ms, caches


def _cache_bytes(caches) -> int:
    n = 0
    for layer in caches:
        for side in layer:
            for t in (side if isinstance(side, tuple) else (side,)):
                n += t.numel() * t.element_size()
    return n


def _near_tie_at(got, want, rows, what):
    """The index where `got` first leaves `want` (None where they agree
    over got's length), held to be a near-tie of `rows` (the reference
    run's logits): its top-2 gap within LOGIT_RTOL x max|logit|."""
    for j, (a, b) in enumerate(zip(got, want)):
        if a != b:
            top = rows[j][0].topk(2).values
            gap = float(top[0] - top[1])
            bound = LOGIT_RTOL * float(rows[j].abs().max())
            log(f"  {what}: token {j} differs ({a} vs {b}); the reference's "
                f"top-2 logit gap there {gap:.4f} (near-tie bound "
                f"{bound:.4f})")
            if gap > bound:
                raise AssertionError(f"{what} left the greedy tokens at "
                                     f"{j} where no near-tie was")
            return j
    if len(got) > len(want):
        raise AssertionError(f"{what}: more tokens than the reference")
    return None


def _sync_warnings(fn) -> dict:
    """Synchronizing CUDA operations fn makes, as
    torch.cuda.set_sync_debug_mode("warn") reports them: their count and
    where each was made (the warning's line, and the innermost frame in
    luminaai_tpu_torch/ that led to it)."""
    import traceback
    import warnings

    import torch

    sites = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        port = next((f"{Path(fr.filename).name}:{fr.lineno} {fr.name}"
                     for fr in reversed(traceback.extract_stack())
                     if "/luminaai_tpu_torch/" in fr.filename), "-")
        sites.append(f"{Path(filename).name}:{lineno} <- {port}")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return {"count": len(sites), "sites": sorted(set(sites))}


def _a8_syncs(dev, plain, caches, tok, pos) -> dict:
    """(5): one b1 decode step (the plain cache, B5) and one 2-layer
    flagship train step, CUDA's sync reports beside detect_host_syncs."""
    import torch

    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.analysis.trace_audit import detect_host_syncs
    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.training.trainer import Trainer

    out = {}
    step = lambda: plain._decode_logits(caches, tok, pos)  # noqa: E731
    with torch.inference_mode():
        step()
        out["decode"] = {"cuda_sync_warnings": _sync_warnings(step),
                         "detected": detect_host_syncs(step)}
    cfg = Config(**{**FLAGSHIP, "num_layers": A8_TRAIN_LAYERS},
                 **FLAGSHIP_LEVERS, max_steps=3,
                 output_dir=str(RUN_DIR / "a8"))
    trainer = Trainer(cfg, cli._synthetic_batches(cfg), device=dev, seed=0)
    raw = next(iter(cli._synthetic_batches(cfg)()))
    batch = trainer._to_device(raw)

    def train_step():
        trainer.state, _ = trainer.train_step(trainer.state, batch)

    train_step()
    out["train"] = {"cuda_sync_warnings": _sync_warnings(train_step),
                    "detected": detect_host_syncs(train_step)}
    trainer.close()
    del trainer
    for k, v in out.items():
        det = v["detected"]
        cuda = v["cuda_sync_warnings"]
        log(f"a8 (5) host syncs, {k} step: CUDA's sync debug mode "
            f"{cuda['count']} at {cuda['sites']}; detect_host_syncs "
            f"{det['total']} "
            f"{det['by_op']} at "
            f"{[(x['site'], x['count']) for x in det['sites']]}")
    return out


def phase_a8(dev, entries: dict, rpa_entry: dict,
             rpa_int8_entry: dict) -> dict:
    """Phase 19: the rolling window cache at b1's widths against the plain
    cache, speculation's draft cap, generate_batch's rolling lanes, int8
    KV, host syncs on the card, and `analyze`."""
    import os

    smi = _smi()
    t_phase = time.perf_counter()
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    analyze = subprocess.Popen(
        [sys.executable, "-m", "luminaai_tpu_torch", "analyze", "--json"],
        cwd=str(Path(__file__).resolve().parent), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out = _a8_card(dev, entries, rpa_entry, rpa_int8_entry, smi)
        text, err = analyze.communicate(timeout=300)
    finally:
        if analyze.poll() is None:
            analyze.kill()
            analyze.wait()
    doc = json.loads(text) if analyze.returncode in (0, 1) else {}
    verdicts = {v["name"]: v["ok"] for v in doc.get("audit_verdicts", [])}
    surface = doc.get("audits", {}).get("recompile_surface", {})
    log(f"a8 (6) analyze --json: exit {analyze.returncode}, "
        f"{doc.get('summary', {}).get('unwaived')} unwaived finding(s), "
        f"verdicts {verdicts}, surface "
        f"{ {p: r['distinct_signatures'] for p, r in surface.get('programs', {}).items()} }"
        + ("" if analyze.returncode == 0 else f"; stderr {err[-600:]}"))
    if analyze.returncode != 0:
        raise AssertionError("analyze did not exit 0")
    out["analyze_exit"] = analyze.returncode
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"a8: phase wall {out['wall_s']:.1f} s ({smi})")
    return out


def _a8_card(dev, entries, rpa_entry, rpa_int8_entry, smi) -> dict:
    import dataclasses

    import numpy as np
    import torch

    from luminaai_tpu_torch.data.tokenizer import ConversationTokenizer
    from luminaai_tpu_torch.inference.generate import GenerationEngine
    from luminaai_tpu_torch.ops import ragged_paged_attention as rpa

    class PlainCacheEngine(GenerationEngine):
        """The engine over the plain position-addressed cache."""

        def init_cache(self, batch, rows, rolling=True):
            return super().init_cache(batch, rows, rolling=False)

    t0 = time.perf_counter()
    model, cfg = _a8_model(dev)
    tok = ConversationTokenizer()
    roll = GenerationEngine(model, tok, dataclasses.replace(cfg))
    plain = PlainCacheEngine(model, tok, dataclasses.replace(cfg))
    rng = np.random.RandomState(19)
    prompt = list(rng.randint(10, cfg.vocab_size, A8_PROMPT))
    out = {}
    with torch.inference_mode():
        # (1) plain cache: greedy tokens, B5 a layer a step.
        b5 = rpa.ragged_paged_attention.launches
        p_tok, p_rows, p_ms, p_caches = _greedy_run(plain, prompt, A8_NEW,
                                                    time_steps=True)
        b5_plain = rpa.ragged_paged_attention.launches - b5
        # The rolling cache, teacher-forced on the plain tokens.
        _reset_counts()
        b5 = rpa.ragged_paged_attention.launches
        r_tok, r_rows, r_ms, r_caches = _greedy_run(
            roll, prompt, A8_NEW, forced=p_tok, time_steps=True)
        b5_roll = rpa.ragged_paged_attention.launches - b5
        b1 = _launch_counts()["B1"]
        errs = [float((a - b).abs().max()) / float(b.abs().max())
                for a, b in zip(r_rows, p_rows)]
        C = r_caches[0][0].shape[1]
        bytes_roll, bytes_plain = _cache_bytes(r_caches), _cache_bytes(
            p_caches)
        L = cfg.num_layers
        log(f"a8 (1) b1 dense, window {A8_WINDOW}: rolling cache {C} slots, "
            f"{bytes_roll / 2**20:.1f} MiB against {bytes_plain / 2**20:.1f} "
            f"MiB plain; prefill of {A8_PROMPT} tokens (one bucket): B1 "
            f"{b1} (want {L}); decode B5 {b5_roll} rolling (want 0), "
            f"{b5_plain} plain (want {L * (A8_NEW - 1)}); logits vs plain, "
            f"teacher-forced, max rel err {max(errs):.3e} at position "
            f"{int(np.argmax(errs))} (tol {LOGIT_RTOL}); decode step ms "
            f"median rolling {statistics.median(r_ms):.2f}, plain "
            f"{statistics.median(p_ms):.2f} ({smi})")
        slots = -(-A8_WINDOW // 128) * 128
        if C != slots or C * bytes_plain != bytes_roll * plain.max_context:
            raise AssertionError("the rolling cache is not half the plain "
                                 "cache")
        if b1 != L or b5_roll != 0 or b5_plain != L * (A8_NEW - 1):
            raise AssertionError("phase 19's kernel launches are off")
        if max(errs) > LOGIT_RTOL:
            raise AssertionError("rolling logits left the plain cache's")
        _add_launches(entries, {"B1": b1}, "launches_a8")
        rpa_entry["launches"] = (rpa_entry["launches"] or 0) + b5_plain
        rpa_entry["launches_a8"] = b5_plain
        # The rolling run's own greedy tokens: the plain ones up to the
        # first argmax that differs (a near-tie), then its own there.
        j = _near_tie_at(r_tok, p_tok, p_rows, "rolling vs plain greedy")
        greedy = p_tok if j is None else p_tok[:j] + [r_tok[j]]
        out["decode"] = {"cache_slots": C, "cache_bytes": bytes_roll,
                         "plain_cache_bytes": bytes_plain,
                         "logit_rel_err": max(errs),
                         "step_ms_rolling": statistics.median(r_ms),
                         "step_ms_plain": statistics.median(p_ms),
                         "B1": b1, "B5_plain": b5_plain}
        del p_caches, r_caches
        t1 = time.perf_counter()

        # (2) speculation: every verify capped at C - window + 1 rows.
        widths = []
        verify = roll._verify

        def counted(caches, ids, start):
            widths.append(len(ids))
            return verify(caches, ids, start)

        roll._verify = counted
        try:
            s_tok, stats = roll.generate_speculative(
                prompt, max_new_tokens=A8_SPEC_NEW, draft_k=A8_DRAFT_K)
        finally:
            del roll._verify
        cap = C - A8_WINDOW + 1
        log(f"a8 (2) speculative, draft_k {A8_DRAFT_K}: {len(widths)} "
            f"verify calls, widths {sorted(set(widths))} (cap {cap}), "
            f"{stats.get('tokens_per_verify')} tokens a verify")
        if set(widths) != {cap}:
            raise AssertionError("the draft cap did not hold")
        _near_tie_at(s_tok[:len(greedy)], greedy, r_rows,
                     "speculative vs greedy")
        out["speculative"] = {"verify_calls": len(widths), "width": cap,
                              "tokens_per_verify":
                                  stats.get("tokens_per_verify")}
        t2 = time.perf_counter()

        # (3) generate_batch: each lane against its single-request run.
        lanes = [prompt[:n] for n in A8_LANES]
        batch = roll.generate_batch(lanes, max_new_tokens=A8_LANE_NEW,
                                    temperature=0.0,
                                    repetition_penalty=1.0)
        diffs = []
        for n, lane, (b_tok, _) in zip(A8_LANES, lanes, batch):
            one, rows, _, _ = _greedy_run(roll, lane, A8_LANE_NEW)
            diffs.append(_near_tie_at(b_tok, one, rows, f"lane of {n}"))
        log(f"a8 (3) generate_batch, {len(lanes)} rolling lanes of "
            f"{list(A8_LANES)} tokens, {A8_LANE_NEW} new: first differing "
            f"token per lane {diffs} (None: equal)")
        out["batch"] = {"first_difference": diffs}
        t3 = time.perf_counter()

        # (4) int8 KV: the rolling cache against the plain int8 cache.
        cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
        roll8 = GenerationEngine(model, tok, cfg8)
        plain8 = PlainCacheEngine(model, tok, dataclasses.replace(cfg8))
        b5i = rpa.ragged_paged_attention.launches_int8
        q_tok, q_rows, _, q_caches = _greedy_run(plain8, prompt,
                                                 A8_INT8_NEW)
        b5_int8 = rpa.ragged_paged_attention.launches_int8 - b5i
        _, r8_rows, _, r8_caches = _greedy_run(roll8, prompt, A8_INT8_NEW,
                                               forced=q_tok)
        err8 = max(float((a - b).abs().max()) / float(b.abs().max())
                   for a, b in zip(r8_rows, q_rows))
        codes = r8_caches[0][0][0]
        log(f"a8 (4) int8 KV: rolling codes {tuple(codes.shape)} "
            f"{codes.dtype}, logits vs the plain int8 cache max rel err "
            f"{err8:.3e} (tol {LOGIT_RTOL}); B5-int8 {b5_int8} (want "
            f"{L * (A8_INT8_NEW - 1)})")
        if codes.dtype != torch.int8 or codes.shape[1] != C or (
                err8 > LOGIT_RTOL) or b5_int8 != L * (A8_INT8_NEW - 1):
            raise AssertionError("the int8 rolling cache is off")
        rpa_int8_entry["launches"] = (rpa_int8_entry["launches"] or 0) + (
            b5_int8)
        rpa_int8_entry["launches_a8"] = b5_int8
        out["int8"] = {"logit_rel_err": err8, "B5_int8": b5_int8}
        del q_caches, r8_caches
        t4 = time.perf_counter()

        # (5) host syncs on the card.
        caches = plain.init_cache(1, plain.max_context)
        ids = np.zeros((1, 2048), dtype=np.int64)
        ids[0, :A8_PROMPT] = prompt
        plain._prefill_rows(caches, ids, 0, A8_PROMPT)
    out["syncs"] = _a8_syncs(dev, plain, caches, p_tok[0], A8_PROMPT)
    del caches, model, roll, plain
    _release()
    t5 = time.perf_counter()
    log(f"  a8 walls: (1) {t1 - t0:.1f} s, (2) {t2 - t1:.1f} s, (3) "
        f"{t3 - t2:.1f} s, (4) {t4 - t3:.1f} s, (5) {t5 - t4:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 20: the embedding and LM head cut by vocabulary, over virtual
# tensor ranks
# ---------------------------------------------------------------------------
# (a) b300's vocabulary and hidden width (the one preset with tensor
# parallelism: vocab 50304, hidden 16384, tp 2), one micro-batch of 8192
# rows: (V, H, rows).
VOCAB_CE = (50304, 16384, 8192)
VOCAB_RANKS = (2, 4)
VOCAB_LOSS_RTOL = 1e-5
VOCAB_GRAD_TOL = 1e-4  # x max|g|, the hidden's and the head's gradients
# One virtual rank's CE peak over the whole CE's, predicted below this.
VOCAB_PEAK_PREDICTED = 0.6
# (b) the flagship step with its loss over this many virtual tensor ranks.
# Its parameters' gradients come out of bf16 products: the CE's other order
# of fp32 sums (~1e-7) moves some of them by whole bf16 steps (2^-8 of an
# element), so each is held to 8 such steps of its largest element.
VOCAB_FLAGSHIP_RANKS = 2
VOCAB_STEP_GRAD_TOL = 2.0 ** -5


def _timed(fn):
    """(fn(), host ms around it, ended by a synchronise)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _max_rel(got, want) -> float:
    """max|got - want| over max|want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


def _vocab_ce_card(dev) -> dict:
    """Phase 20 (a): the vocab-parallel CE's body (ops/fused.py) over n
    virtual tensor ranks against the whole fused CE, forward and
    backward, at b300's vocabulary and hidden width; the vocab-parallel
    lookup against the whole one; one virtual rank's peak memory against
    the whole CE's.

    The gates run the seeded bf16 hidden rows and the head's bf16 values
    carried in fp32: the CE's arithmetic is the bf16 path's (fp32
    products of bf16 values), and its gradients are not rounded to bf16
    at the end, a rounding that turns the vocab-parallel sums' other order
    (~1e-7) into whole bf16 steps of the largest elements. Times and peaks
    are the path's own: bf16 hidden rows, fp32 head."""
    import torch

    from luminaai_tpu_torch.ops import fused

    V, H, N = VOCAB_CE
    g = torch.Generator(device=dev).manual_seed(0)
    hidden = torch.randn(1, N, H, generator=g, device=dev).to(torch.bfloat16)
    head = torch.randn(V, H, generator=g, device=dev) * 0.02
    labels = torch.randint(0, V, (1, N), generator=g, device=dev)
    weights = (torch.rand(1, N, generator=g, device=dev) > 0.1).float()

    def run(rows, table, n=None):
        """(loss, d rows, d table, ms, peak bytes above the inputs) of the
        whole CE (n None) or the CE over n virtual vocab ranks -> the mean
        NLL plus a z-loss, forward and backward."""
        h = rows.detach().requires_grad_()
        w = table.detach().requires_grad_()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        def fwd_bwd():
            if n is None:
                s = fused.fused_lm_head_ce_sums(h, w, labels, weights)
            else:
                s = fused.virtual_vocab_ce_sums(h, w, labels, weights, n)
            loss = (s[0] + 1e-4 * s[2]) / s[1].clamp(min=1.0)
            return (loss.detach(),) + torch.autograd.grad(loss, [h, w])

        (loss, gh, gw), ms = _timed(fwd_bwd)
        peak = torch.cuda.max_memory_allocated() - base
        return float(loss), gh, gw, ms, peak

    out = {}
    rows32, head32 = hidden.float(), head.to(torch.bfloat16).float()
    whole = run(rows32, head32)
    for n in VOCAB_RANKS:
        got = run(rows32, head32, n)
        errs = {"loss": abs(got[0] - whole[0]) / abs(whole[0]),
                "d_hidden": _max_rel(got[1], whole[1]),
                "d_head": _max_rel(got[2], whole[2])}
        log(f"vocab (a) CE over {n} virtual ranks at V {V}, H {H}, {N} "
            f"rows (bf16 values in fp32): loss {got[0]:.7f} vs "
            f"{whole[0]:.7f} (rel {errs['loss']:.2e}, tol "
            f"{VOCAB_LOSS_RTOL}); d hidden {errs['d_hidden']:.2e}, d head "
            f"{errs['d_head']:.2e} x max|g| (tol {VOCAB_GRAD_TOL})")
        if errs["loss"] > VOCAB_LOSS_RTOL or max(
                errs["d_hidden"], errs["d_head"]) > VOCAB_GRAD_TOL:
            raise AssertionError(f"the CE over {n} virtual vocab ranks "
                                 f"disagrees with the whole CE: {errs}")
        out[f"n{n}"] = errs
        del got
    del whole, rows32, head32
    _release()
    # The path's dtypes; one rank's work is its [V/2, H] slice with its
    # own logits and gradients (its collectives' buffers are [rows] and
    # [rows, 2]).
    half = head[:V // 2].clone()
    times = {}
    for name, table, n in (("whole", head, None), ("n2", head, 2),
                           ("rank", half, 1)):
        r = run(hidden, table, n)
        times[name] = (r[3], r[4])
        del r
        _release()
    ratio = times["rank"][1] / times["whole"][1]
    log(f"vocab (a) bf16 hidden, fp32 head: forward + backward "
        f"{times['whole'][0]:.1f} ms whole, {times['n2'][0]:.1f} ms over 2 "
        f"virtual ranks, {times['rank'][0]:.1f} ms one rank's [{V // 2}, "
        f"{H}] slice; peak above the inputs {times['rank'][1] / 1e9:.3f} GB "
        f"one rank vs {times['whole'][1] / 1e9:.3f} GB whole (ratio "
        f"{ratio:.3f}, predicted <= {VOCAB_PEAK_PREDICTED})")
    out.update(whole_ms=times["whole"][0], n2_ms=times["n2"][0],
               rank_ms=times["rank"][0],
               whole_peak_gb=times["whole"][1] / 1e9,
               rank_peak_gb=times["rank"][1] / 1e9, peak_ratio=ratio)
    del half
    for dtype in (torch.float32, torch.bfloat16):
        want = head[labels].to(dtype)
        for n in VOCAB_RANKS:
            got = fused.virtual_vocab_lookup(head, labels, n, dtype)
            if not torch.equal(got, want):
                raise AssertionError(f"the lookup over {n} virtual vocab "
                                     f"ranks differs from the whole one "
                                     f"({dtype})")
    log(f"vocab (a) lookup over {VOCAB_RANKS} virtual ranks equal to the "
        f"whole lookup (fp32 and bf16 rows, {N} tokens)")
    return out


def _vocab_flagship(dev, kernels: bool = True) -> dict:
    """Phase 20 (b): one flagship step at MESH_LAYERS layers whose loss goes
    through the vocab-parallel CE over VOCAB_FLAGSHIP_RANKS virtual ranks,
    against the same step through the whole CE: loss, grad norm and every
    parameter's gradient, B1-B4 launches (the wrappers' counters and the
    flash library's record), then one timed train step of each."""
    import torch

    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.convert import init_params
    from luminaai_tpu_torch.models.transformer import LuminaTransformer
    from luminaai_tpu_torch.ops import flash_attention as fa
    from luminaai_tpu_torch.ops import fused
    from luminaai_tpu_torch.parallel import train_step as ts
    from luminaai_tpu_torch.training.optimizer import (
        make_optimizer,
        make_schedule,
    )

    cfg = Config(**{**FLAGSHIP, "num_layers": MESH_LAYERS},
                 **FLAGSHIP_LEVERS, max_steps=3)
    raw = next(iter(cli._synthetic_batches(cfg)()))
    batch = {k: torch.as_tensor(v).long().to(dev) for k, v in raw.items()}
    model = init_params(LuminaTransformer(cfg, device=dev, trainable=True), 0)
    sched = make_schedule(cfg, 3)
    tx = make_optimizer(cfg, 3, sched)
    state = ts.init_train_state(model, tx, 0)

    def virtual_loss(b, generator=None):
        hidden, aux = model(b["input_ids"], deterministic=False,
                            return_hidden=True, generator=generator)
        labels, valid = ts.shift_labels(b)
        mask, weights = ts._shifted_mask_weights(b, valid)
        w = mask if weights is None else mask * weights
        sums = fused.virtual_vocab_ce_sums(
            hidden, model.embedder.head_weight(), labels, w,
            VOCAB_FLAGSHIP_RANKS, label_smoothing=cfg.label_smoothing,
            chunk_size=cfg.loss_chunk_size)
        loss, metrics = fused.ce_from_sums(*sums,
                                           z_loss_weight=cfg.z_loss_weight)
        total = loss + aux.get("aux_loss", 0.0)
        metrics["loss"] = total.detach()
        return total, metrics

    losses = {"whole": ts.make_loss_fn(cfg, model), "virtual": virtual_loss}
    runs = {}
    for name, loss_fn in losses.items():
        gen = torch.Generator(device=dev).manual_seed(0)
        _reset_counts()
        (grads, metrics), ms = _timed(lambda: ts._accumulate_grads(
            loss_fn, state.params, batch, gen,
            cfg.gradient_accumulation_steps))
        runs[name] = {"grads": grads, "loss": float(metrics["loss"]),
                      "grad_norm": float(fused.global_norm(grads)),
                      "launches": _launch_counts(), "grad_ms": ms,
                      "last": ({k: fa.last_kernel(k)
                                for k in ("B1", "B2", "B3")}
                               if kernels else {})}
    whole, virt = runs["whole"], runs["virtual"]
    rl = abs(virt["loss"] - whole["loss"]) / abs(whole["loss"])
    rn = abs(virt["grad_norm"] - whole["grad_norm"]) / whole["grad_norm"]
    worst = max((_max_rel(g, w), n) for g, w, n in zip(
        virt["grads"], whole["grads"], state.names))
    fro = max((float((g.float() - w.float()).norm()
                     / w.float().norm().clamp(min=1e-30)), n)
              for g, w, n in zip(virt["grads"], whole["grads"], state.names))
    want = flash_kernels(cfg.head_dim())
    log(f"vocab (b) flagship at {MESH_LAYERS} layers, loss over "
        f"{VOCAB_FLAGSHIP_RANKS} virtual vocab ranks: loss "
        f"{virt['loss']:.7f} vs {whole['loss']:.7f} (rel {rl:.2e}), "
        f"grad_norm {virt['grad_norm']:.7f} vs {whole['grad_norm']:.7f} "
        f"(rel {rn:.2e}; tol {MESH_RTOL}); worst gradient {worst[0]:.2e} x "
        f"max|g| ({worst[1]}; tol {VOCAB_STEP_GRAD_TOL}), {fro[0]:.2e} "
        f"of its norm ({fro[1]}); "
        f"launches "
        f"{virt['launches']} vs {whole['launches']}; last flash kernels "
        f"{virt['last']} vs {whole['last']}; forward + backward "
        f"{virt['grad_ms']:.1f} vs {whole['grad_ms']:.1f} ms")
    if max(rl, rn) > MESH_RTOL or worst[0] > VOCAB_STEP_GRAD_TOL:
        raise AssertionError("the flagship step over virtual vocab ranks "
                             "disagrees with the whole-CE step")
    if virt["launches"] != whole["launches"] or (
            kernels and min(whole["launches"].values()) == 0):
        raise AssertionError("the virtual-vocab step did not launch B1-B4 "
                             "as the whole-CE step does")
    for k, name in want.items():
        if kernels and not (virt["last"][k] == whole["last"][k]
                            and virt["last"][k].startswith(name)):
            raise AssertionError(f"{k}: the flash library recorded "
                                 f"{virt['last'][k]} / {whole['last'][k]}, "
                                 f"want {name}")
    whole_launches, virt_launches = whole["launches"], virt["launches"]
    del runs, whole, virt
    _release()
    steps = {}
    total = {k: a + b for (k, a), b in zip(whole_launches.items(),
                                           virt_launches.values())}
    for name, loss_fn in losses.items():
        step = ts.make_train_step(cfg, model, sched, tx, loss_fn=loss_fn)
        ms = []
        for _ in range(2):
            _reset_counts()
            (_, m), t = _timed(lambda: step(state, batch))
            float(m["loss"])
            ms.append(t)
            for k, v in _launch_counts().items():
                total[k] += v
        steps[name] = ms[-1]
    log(f"vocab (b) train step (second of two): {steps['virtual']:.1f} ms "
        f"over {VOCAB_FLAGSHIP_RANKS} virtual vocab ranks vs "
        f"{steps['whole']:.1f} ms through the whole CE")
    return {"loss_rel": rl, "grad_norm_rel": rn, "worst_grad": worst[0],
            "step_ms": steps, "launches": total}


def phase_vocab(dev, entries: dict, kernels: bool = True) -> dict:
    """Phase 20: the vocab-parallel CE and lookup over virtual tensor ranks
    at b300's widths (a), and a flagship step through the vocab-parallel
    CE against the whole CE (b)."""
    smi = _smi()
    t_phase = time.perf_counter()
    out = {"ce": _vocab_ce_card(dev)}
    out["flagship"] = _vocab_flagship(dev, kernels)
    _add_launches(entries, out["flagship"]["launches"], "launches_vocab")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"vocab: phase wall {out['wall_s']:.1f} s ({smi})")
    return out


# Phase 21 (bench): the headline rung's layers and timed steps, and the
# seconds each harness child may take.
BENCH_LAYERS, BENCH_STEPS = 2, 20
BENCH_CHILD_TIMEOUT = 120
# The rung child's budget: past 75% of it the steady-routing window stops
# and past 85% the counted-cost and profiled steps are skipped
# (bench_torch.py), so (a) keeps the timed window and its checks within
# ~25 s; (b) runs them all.
BENCH_RUNG_BUDGET = 14
# Under --only bench: (label, argv after `python3`, timeout s).
BENCH_FULL = (
    ("ladder", ["-m", "luminaai_tpu_torch", "benchmark"], 2400),
    ("ops", ["-m", "luminaai_tpu_torch", "benchmark", "--ops"], 1200),
    ("flagship", ["bench_torch.py", "--child", "flagship"], 900),
    ("flagship_small", ["bench_torch.py", "--child", "flagship_small"], 600),
    ("serve", ["bench_torch.py", "--serve-bench"], 600),
    ("router", ["bench_torch.py", "--router-bench"], 600),
    ("smoke", ["bench_torch.py", "--smoke"], 600),
)


def _json_lines(text: str) -> list:
    out = []
    for line in text.splitlines():
        if line.strip().startswith("{"):
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                pass
    return out


def _bench_proc(argv: list, env: dict = None) -> subprocess.Popen:
    repo = Path(__file__).resolve().parent
    return subprocess.Popen([sys.executable, *argv], cwd=repo,
                            env={**os.environ, **(env or {})},
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _bench_wait(proc, label: str, timeout: float) -> tuple:
    """(stdout, stderr) of a harness child; its exit code must be 0."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"bench {label}: no end within {timeout} s")
    if proc.returncode != 0:
        raise AssertionError(f"bench {label}: exit {proc.returncode}: "
                             f"{err[-1500:]}")
    return out, err


def _bench_route(last: dict, profiled: list, label: str) -> None:
    """The flash kernels a child's library recorded last must be the wgmma
    ones at head_dim 64; where the child's profiler named flash kernels,
    each recorded one must be among them (flash_taken's rule)."""
    for kern, want in flash_kernels(64).items():
        got = last.get(kern, "")
        if not got.startswith(want):
            raise AssertionError(f"bench {label}: {kern} last launched "
                                 f"{got!r}, want {want}")
        if profiled and got not in profiled:
            raise AssertionError(f"bench {label}: the profiler named "
                                 f"{profiled}, the library recorded {got}")


def _bench_ops_check(table: dict, card: str) -> dict:
    """The attention suite of an op-table line: rows on this card, its
    agreement check within its tolerance, the wgmma kernels last."""
    check = table.get("checks", {}).get("attention", {})
    rows = {r["op"]: r["ms"] for r in table.get("results", [])
            if r.get("suite", "attention") == "attention"}
    log(f"bench attention suite: {rows}; agreement {check}; last flash "
        f"{table.get('flash_last_kernel')}")
    if (table.get("device") != card or not rows or not check
            or max(check["max_rel_err"].values()) > check["tolerance"]):
        raise AssertionError(f"bench: bad op-table line {json.dumps(table)}")
    _bench_route(table.get("flash_last_kernel", {}), [], "ops attention")
    return rows


def phase_bench(dev, entries: dict, full: bool) -> dict:
    """Phase 21: bench_torch.py's headline rung as a child on the card (a);
    under --only bench the whole harness (b), the op table's attention
    suite checked. Launches are the child's own counters."""
    import torch

    smi = _smi()
    card = torch.cuda.get_device_name(0)
    t_phase = time.perf_counter()
    rung = _bench_proc(["bench_torch.py", "--child", "ref_debug_moe"],
                       {"BENCH_CHILD_BUDGET_S": str(BENCH_RUNG_BUDGET)})
    out_r, _ = _bench_wait(rung, "ref_debug_moe", BENCH_CHILD_TIMEOUT)
    lines = _json_lines(out_r)
    if len(lines) != 1:
        raise AssertionError(f"bench: want one JSON line, got {len(lines)}")
    res = lines[0]
    ex = res.get("extras", {})
    n = BENCH_LAYERS * BENCH_STEPS
    want = {"B1": n, "B2": n, "B3": n, "B4a": 0, "B4b": 0}
    log(f"bench (a) ref_debug_moe: {res.get('value')} tokens/s "
        f"(vs_baseline {res.get('vs_baseline')}), step {ex.get('step_ms')} "
        f"ms, loss {ex.get('loss')}, mfu {ex.get('mfu')}, compile_s "
        f"{ex.get('compile_s')}, launches {ex.get('launches')} (want "
        f"{want}), last flash {ex.get('flash_last_kernel')}, profiled "
        f"{ex.get('profiled_flash_kernels')}, card {ex.get('card')}")
    if not (res.get("metric") == "train_tokens_per_sec_per_chip_moe8x2"
            and res.get("value", 0) > 0
            and math.isfinite(ex.get("loss", math.nan))
            and ex.get("config") == "ref_debug_moe"
            and ex.get("device") == card
            and str(ex.get("card", "")).startswith(card)
            and ex.get("steps") == BENCH_STEPS
            and ex.get("layers") == BENCH_LAYERS):
        raise AssertionError(f"bench: bad headline line {json.dumps(res)}")
    if ex.get("launches") != want:
        raise AssertionError("bench: the rung's timed window did not launch "
                             "B1-B3 exactly layers x steps times")
    _bench_route(ex.get("flash_last_kernel", {}),
                 ex.get("profiled_flash_kernels", []), "ref_debug_moe")
    _add_launches(entries, ex["launches"], "launches_bench")
    out = {"ref_debug_moe": {k: ex.get(k) for k in (
        "step_ms", "mfu", "compile_s", "launches")},
        "tokens_per_sec": res["value"]}
    out["wall_a_s"] = time.perf_counter() - t_phase
    log(f"bench (a): {out['wall_a_s']:.1f} s ({smi})")
    if full:
        for label, argv, timeout in BENCH_FULL:
            t0 = time.perf_counter()
            proc = _bench_proc(argv)
            try:
                stdout, stderr = proc.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                stdout, stderr = proc.communicate()
            secs = time.perf_counter() - t0
            for line in stdout.splitlines():
                log(f"bench (b) {label}: {line}")
            if proc.returncode != 0:
                log(f"bench (b) {label}: stderr {stderr[-2000:]}")
            if proc.returncode != 0 or not _json_lines(stdout):
                raise AssertionError(f"bench (b) {label}: exit "
                                     f"{proc.returncode}")
            log(f"bench (b) {label}: exit 0 in {secs:.1f} s")
            if label == "ops":
                out["attention_ms"] = _bench_ops_check(
                    _json_lines(stdout)[-1], card)
            if label == "ladder":  # its sidecars, written beside the script
                for name in ("DENSE_BENCH.json", "REF_TABLE.json"):
                    path = Path(__file__).resolve().parent / (
                        "bench_torch_out") / name
                    log(f"bench (b) {name}: "
                        + json.dumps(json.loads(path.read_text())))
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"bench: phase wall {out['wall_s']:.1f} s ({smi})")
    return out


ALL_PHASES = ("serve", "plane", "serve_moe", "train", "train_moe",
              "runtime", "posttrain", "adaptive", "posttrain_moe",
              "train_tuned", "mod", "fleet", "quant", "mesh", "pipe",
              "groups", "a7", "a8", "vocab", "bench")
PHASES = set(ALL_PHASES)


def main() -> int:
    if sys.argv[1:2] == ["--runtime-child"]:
        return runtime_child(sys.argv[2:])
    if sys.argv[1:2] == ["--serve-child"]:
        return serve_child(sys.argv[2:])
    if sys.argv[1:2] == ["--mesh-child"]:
        return mesh_child(sys.argv[2:])
    if sys.argv[1:2] == ["--only"]:
        # Development runs: the build and kernel phases and the named ones
        # (comma-separated, of ALL_PHASES); the result line says "partial".
        PHASES.intersection_update(sys.argv[2].split(","))
    repo = Path(__file__).resolve().parent
    if not (repo / "luminaai_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: luminaai_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    RUN_DIR.mkdir()
    try:
        return _main(repo)
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)


def _bytecode_cache() -> None:
    """Compiled bytecode for this run's processes, under RUN_DIR. Where
    the interpreter is told to write none (PYTHONDONTWRITEBYTECODE), each
    child process compiles torch's modules from source again, for `import
    torch` and for the torch._dynamo import that the first
    torch.utils.checkpoint call makes (it reads torch._dynamo.config), so
    every training child pays both. Set before the first import of torch;
    every child inherits it."""
    prefix = str(RUN_DIR / "pycache")
    sys.pycache_prefix = prefix
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)


def _main(repo: Path) -> int:
    _bytecode_cache()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    # fp32 products are compared below: keep them full fp32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    partial = PHASES != set(ALL_PHASES)
    done = {}
    try:
        phase_build()
        entry = phase_kernels(dev)
        entry_int8 = phase_kernels_int8(dev)
        flash_entries = phase_flash_kernels(dev) if not partial or (
            PHASES - {"serve", "plane", "serve_moe", "fleet", "quant",
                      "a7", "a8"}) else []
        gmm_entries = phase_gmm_kernels(dev) if not partial or (
            PHASES - {"serve", "plane", "train", "runtime",
                      "posttrain", "fleet", "quant", "a7", "a8"}) else []
        if "serve" in PHASES:  # phase 3, and phase 10 ("plane") after it
            done["serve"] = phase_serve(dev, entry)
            _release()
        if "serve_moe" in PHASES:
            done["serve_moe"] = phase_serve_moe(dev, entry, gmm_entries)
            _release()
        if "train" in PHASES:
            done["train"] = phase_train(dev, flash_entries)
            shutil.rmtree(RUN_DIR / "train_dense")
            _release()
        if "train_moe" in PHASES:
            done["train_moe"] = phase_train_moe(dev, flash_entries,
                                                gmm_entries)
            shutil.rmtree(RUN_DIR / "train_moe")
            _release()
        if "mesh" in PHASES:
            done["mesh"] = phase_mesh(dev, flash_entries, gmm_entries,
                                      done.get("train_moe"))
            _release()
        if "pipe" in PHASES:
            done["pipe"] = phase_pipe(dev, flash_entries, gmm_entries)
            _release()
        if "runtime" in PHASES:
            done["runtime"] = phase_runtime(dev, entry, flash_entries)
            # Run B goes; run A's checkpoint feeds phase 9, its corpus
            # phase 8.
            shutil.rmtree(RUN_DIR / "B")
            _release()
        if "posttrain" in PHASES:
            done["posttrain"] = phase_posttrain(dev, entry, flash_entries)
            shutil.rmtree(RUN_DIR / "post" / "merged")
            _release()
        if "quant" in PHASES:  # converts phase 7's run A checkpoint
            done["quant"] = phase_quant(dev, entry_int8, gmm_entries,
                                        done.get("serve"))
            _release()
        shutil.rmtree(RUN_DIR / "A", ignore_errors=True)
        if "adaptive" in PHASES:
            done["adaptive"] = phase_adaptive(
                dev, flash_entries, gmm_entries,
                model={**FLAGSHIP, "num_layers": ADAPTIVE_LAYERS})
            _release()
        if "posttrain_moe" in PHASES:
            done["posttrain_moe"] = phase_posttrain_experts(
                dev, flash_entries, gmm_entries)
            _release()
        by_kernel = dict(zip(("B1", "B2", "B3", "B4a", "B4b"),
                             flash_entries + gmm_entries))
        if "train_tuned" in PHASES:
            done["train_tuned"] = phase_train_tuned(
                dev, by_kernel, done.get("train_moe"))
            shutil.rmtree(RUN_DIR / "tuned", ignore_errors=True)
            shutil.rmtree(RUN_DIR / "tuned_int8", ignore_errors=True)
            _release()
        if "mod" in PHASES:
            done["mod"] = phase_mod(dev, by_kernel, entry)
            _release()
        if "groups" in PHASES:
            done["groups"] = phase_groups(dev, by_kernel, partial)
            shutil.rmtree(RUN_DIR / "groups_300m", ignore_errors=True)
            shutil.rmtree(RUN_DIR / "groups_b14", ignore_errors=True)
            _release()
        if "a7" in PHASES:
            done["a7"] = phase_a7(dev, by_kernel)
            shutil.rmtree(RUN_DIR / "a7", ignore_errors=True)
            _release()
        if "a8" in PHASES:
            done["a8"] = phase_a8(dev, by_kernel, entry, entry_int8)
            shutil.rmtree(RUN_DIR / "a8", ignore_errors=True)
            _release()
        if "vocab" in PHASES:
            done["vocab"] = phase_vocab(dev, by_kernel)
            _release()
        if "bench" in PHASES:
            done["bench"] = phase_bench(dev, by_kernel, partial)
            _release()
        if "fleet" in PHASES:
            done["fleet"] = phase_fleet(dev, entry)
    finally:
        shutil.rmtree(RUN_DIR, ignore_errors=True)
    log(f"all phases passed in {time.perf_counter() - t0:.1f}s: "
        + "; ".join(f"{k} {json.dumps(v, default=str)}"
                    for k, v in done.items()))

    print(_smi())
    print(json.dumps({"kernels": [entry, entry_int8, *flash_entries,
                                  *gmm_entries]}))
    if partial:
        print(json.dumps({"ok": False, "partial": sorted(PHASES)}))
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
