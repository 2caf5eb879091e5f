"""The port's resilience contract, driven through the port's own fault
injectors (luminaai_tpu_torch/testing/faults.py), as tests/test_resilience.py
drives the JAX package through its injectors.

- fail_step_at's default (torch.cuda.OutOfMemoryError) engages the OOM
  ladder: the micro-batches split and the run completes;
- preempt_at_step: the stopped run resumes in a fresh Trainer and trains
  the uninterrupted run's batches and losses bit for bit;
- sigterm_at_step: a real SIGTERM through the CLI's handler stops the run
  at the step boundary with a committed checkpoint;
- the restore walks back past a latest step that is truncated, deleted,
  written truncated, bit-flipped or whose manifest is torn;
- hang_step_at: the watchdog detects the stall, dumps stacks and the
  flight ring, books it as `hang`, and the run completes. The watchdog
  reads an injected clock that jumps 600 s when the stall begins, so no
  load on the machine can hide the stall behind slow steps;
- slow_tick trips the serving watchdog (the same injected clock) and
  slow_decode lets a deadline evict a lane;
- flaky_storage: checkpoint saves and restores retry through the retry
  seam, and the run's losses equal a clean run's.
"""

import glob
import json
import signal
import time

import numpy as np
import pytest
import torch

from luminaai_tpu_torch import cli
from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.data import dataset as ds
from luminaai_tpu_torch.data.tokenizer import ConversationTokenizer
from luminaai_tpu_torch.inference.kv_pool import PagedKVPool
from luminaai_tpu_torch.monitoring.events import FlightRecorder, read_events
from luminaai_tpu_torch.monitoring.telemetry import MetricsRegistry
from luminaai_tpu_torch.monitoring.watchdog import HangWatchdog
from luminaai_tpu_torch.serving.server import (
    ContinuousScheduler,
    RequestTimeout,
)
from luminaai_tpu_torch.testing import faults
from luminaai_tpu_torch.training.trainer import Trainer

pytestmark = pytest.mark.faults

WORDS = ("a resumed run must train the very batches the preempted one "
         "would have trained next").split()
TINY = dict(vocab_size=384, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, seq_length=32, intermediate_size=128,
            precision="fp32", batch_size=8, use_flash_attention=False,
            gradient_checkpointing=False, use_moe=False, max_steps=6,
            learning_rate=1e-3, eval_every_n_batches=10**6,
            save_every_n_batches=10**6, health_check_interval=10,
            watchdog=False)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    root = tmp_path_factory.mktemp("resilience")
    rng = np.random.RandomState(0)
    corpus = root / "c.jsonl"
    with open(corpus, "w") as f:
        for _ in range(60):
            f.write(json.dumps(
                {"text": " ".join(rng.choice(WORDS, rng.randint(3, 40)))})
                + "\n")
    return ds.build_text_cache(str(corpus), str(root / "cache"),
                               ConversationTokenizer())


def _trainer(tmp_path, name, cache, registry=None, **kw):
    cfg = Config(**{**TINY, "output_dir": str(tmp_path / name), **kw})
    tok = ConversationTokenizer()
    d = ds.PackedDataset(cache, cfg.batch_size, cfg.seq_length,
                         pad_id=tok.pad_token_id, eos_id=tok.eos_token_id,
                         shuffle_seed=cfg.seed)
    loader = ds.PrefetchLoader(lambda: iter(d), prefetch=2, source=d)
    return Trainer(cfg, loader, device="cpu", seed=0,
                   checkpoint_dir=str(tmp_path / name / "ckpt"),
                   registry=registry or MetricsRegistry())


def _record(trainer, sink):
    """(input batch, loss) per executed step."""
    orig = trainer.train_step

    def wrap(state, batch):
        ids = batch["input_ids"]
        ids = np.asarray(ids.cpu() if torch.is_tensor(ids) else ids).copy()
        out = orig(state, batch)
        sink.append((ids, float(out[1]["loss"])))
        return out

    trainer.train_step = wrap


def test_injected_oom_engages_the_ladder(tmp_path, cache):
    t = _trainer(tmp_path, "oom", cache, max_steps=4)
    assert t.config.gradient_accumulation_steps == 1
    with faults.fail_step_at(t, 2) as stats:
        summary = t.train_with_oom_protection()
    t.close()
    assert stats["raised"] == 1
    assert summary["final_step"] == 4
    assert t.config.gradient_accumulation_steps == 2
    assert summary["interventions"][0]["kind"] == "microbatch_split"


def test_preempt_and_resume_bitwise(tmp_path, cache):
    ref = []
    ta = _trainer(tmp_path, "a", cache)
    _record(ta, ref)
    assert ta.train()["final_step"] == 6
    ta.close()

    got = []
    tb = _trainer(tmp_path, "b", cache)
    _record(tb, got)
    with faults.preempt_at_step(tb, 3) as stats:
        sb = tb.train()
    tb.close()
    assert stats["calls"] == 3
    assert sb["preempted"] is True and sb["final_step"] == 3
    assert (tmp_path / "b" / "ckpt" / "3").is_dir()

    tb2 = _trainer(tmp_path, "b", cache)
    assert tb2.global_step == 3 and tb2._resumed_exact_data_state
    _record(tb2, got)
    assert tb2.train()["final_step"] == 6
    tb2.close()
    assert len(got) == len(ref) == 6
    for i, ((ba, la), (bb, lb)) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(ba, bb, err_msg=f"batch {i}")
        assert la == lb, f"loss {i}: {la} != {lb}"


def test_sigterm_stops_at_the_step_boundary(tmp_path, cache):
    t = _trainer(tmp_path, "s", cache)
    previous = signal.signal(signal.SIGTERM, cli._signal_handler(t))
    try:
        with faults.sigterm_at_step(t, 2) as stats:
            summary = t.train()
    finally:
        signal.signal(signal.SIGTERM, previous)
    t.close()
    assert stats["calls"] == 2
    assert summary["preempted"] is True and summary["final_step"] == 2
    t2 = _trainer(tmp_path, "s", cache)
    assert t2.global_step == 2 and t2._resumed_exact_data_state
    t2.close()


@pytest.mark.parametrize("damage", ["truncate", "delete", "truncated_writes",
                                    "bitflip", "torn_manifest"])
def test_restore_walks_back_past_a_damaged_step(tmp_path, cache, damage):
    ckpt = tmp_path / damage / "ckpt"
    if damage == "truncated_writes":
        t = _trainer(tmp_path, damage, cache, max_steps=2,
                     save_every_n_batches=2)
        t.train()
        t.close()
        t = _trainer(tmp_path, damage, cache, max_steps=4,
                     save_every_n_batches=2)
        with faults.truncated_checkpoint_writes(t.checkpoints) as stats:
            t.train()
        assert stats["saves"] >= 1
    else:
        t = _trainer(tmp_path, damage, cache, max_steps=4,
                     save_every_n_batches=2)
        t.train()
        if damage in ("truncate", "delete"):
            assert faults.corrupt_checkpoint(ckpt, 4, mode=damage) == 1
        elif damage == "bitflip":
            assert faults.bitflip_checkpoint(ckpt, 4).endswith("state.pt")
        else:
            faults.torn_manifest(ckpt, 4)
    t.close()
    assert t.checkpoints.all_steps() == [2, 4]
    t2 = _trainer(tmp_path, damage, cache, max_steps=4)
    assert t2.global_step == 2 and t2._resumed_exact_data_state
    assert t2.checkpoints._m_fallbacks.value >= 1
    t2.close()


def _jumping_clock(stats_of, key, after):
    """time.monotonic, 600 s ahead once the injector's stats say the
    stall has begun."""
    return lambda: time.monotonic() + (
        600.0 if stats_of.get("s", {}).get(key, 0) > after else 0.0)


def test_watchdog_detects_hang_dumps_and_continues(tmp_path, cache):
    rec, reg = FlightRecorder(), MetricsRegistry()
    t = _trainer(tmp_path, "wd", cache, max_steps=8, watchdog=True,
                 watchdog_floor_s=0.4, watchdog_k=3.0, watchdog_warmup=2,
                 watchdog_poll_s=0.05, registry=reg)
    t.recorder = t.watchdog.recorder = rec
    holder = {}
    t.watchdog._clock = _jumping_clock(holder, "hangs", 0)
    with faults.hang_step_at(t, 6, seconds=1.0) as stats:
        holder["s"] = stats
        summary = t.train()
    t.close()
    assert stats["hangs"] == 1
    evs = rec.snapshot(type="hang_suspected")
    assert evs and evs[0]["kind"] == "training"
    assert evs[0]["stalled_s"] > evs[0]["threshold_s"] > 0
    assert summary["final_step"] == 8
    assert reg.snapshot()["training_hangs_total"] >= 1
    assert summary["goodput"]["seconds"]["hang"] > 0
    ckpt = str(tmp_path / "wd" / "ckpt")
    stacks = glob.glob(ckpt + "/stacks-*hang.txt")
    dumps = glob.glob(ckpt + "/flightrec-*hang*.jsonl")
    assert stacks and dumps
    assert any(e["type"] == "hang_suspected"
               for e in read_events(dumps[0]))


class _Tok:
    class backend:
        @staticmethod
        def encode(text):
            return [ord(c) % 250 for c in text]

    def decode(self, tokens):
        return ",".join(str(t) for t in tokens)


class _Stepper:
    """A deterministic StepwiseDecoder double over a real PagedKVPool:
    each lane emits first, first + 1, ..."""

    def __init__(self, num_slots=2, slot_tokens=64):
        self.num_slots = num_slots
        self.slot_tokens = slot_tokens
        self.pool = PagedKVPool(None, num_slots, 1, slot_tokens)
        self.steps = 0
        self._active = [False] * num_slots
        self._next = [0] * num_slots

    def has_free_slot(self):
        return self.pool.has_free()

    def acquire_slot(self):
        return self.pool.alloc()

    def release_slot(self, slot):
        self._active[slot] = False
        self.pool.free(slot)

    def lane_full(self, slot):
        return False

    def prefill_into_slot(self, slot, prompt, max_new_tokens=1,
                          sample_key=None, seed=None):
        first = int(prompt[0])
        self._active[slot] = max_new_tokens > 1
        self._next[slot] = first + 1
        self.pool.lengths[slot] = len(prompt)
        return {"token": first, "prompt_tokens": len(prompt),
                "is_stop": False}

    def decode_step(self, sample_key=None):
        time.sleep(0.005)
        toks = np.zeros((self.num_slots,), np.int64)
        eos = np.zeros((self.num_slots,), bool)
        produced = np.asarray(self._active, bool).copy()
        for s in range(self.num_slots):
            if self._active[s]:
                toks[s] = self._next[s]
                self._next[s] += 1
        self.steps += 1
        return toks, produced, eos


class _Engine:
    def __init__(self):
        self.config = Config(vocab_size=256, hidden_size=64, num_layers=2,
                             num_heads=4, num_kv_heads=2, seq_length=64,
                             use_flash_attention=False)
        self.tokenizer = _Tok()
        self.stepper = _Stepper(2)

    def make_stepwise(self, **kw):
        return self.stepper

    def encode_chat(self, messages):
        return self.tokenizer.backend.encode(messages[-1]["content"])


def test_slow_decode_past_the_deadline_evicts_the_lane():
    reg = MetricsRegistry()
    eng = _Engine()
    sched = ContinuousScheduler(eng, decoder=eng.stepper, registry=reg)
    with faults.slow_decode(eng.stepper, 0.05) as stats:
        with pytest.raises(RequestTimeout):
            sched.submit([40], {"max_new_tokens": 500, "timeout_s": 0.2})
    assert stats["steps"] >= 1
    assert reg.get("serving_requests_timed_out_total").value == 1
    toks, _ = sched.submit([50], {"max_new_tokens": 3})
    assert toks == [50, 51, 52]


def test_slow_tick_trips_the_serving_watchdog(tmp_path):
    rec, reg = FlightRecorder(), MetricsRegistry()
    eng = _Engine()
    holder = {}
    wd = HangWatchdog(kind="serving", registry=reg, recorder=rec,
                      dump_dir=str(tmp_path), k=3.0, floor_s=0.25,
                      warmup=2, poll_s=0.03,
                      clock=_jumping_clock(holder, "steps", 6))
    sched = ContinuousScheduler(eng, decoder=eng.stepper, registry=reg,
                                recorder=rec, watchdog=wd)
    with faults.slow_tick(eng.stepper, delay_s=0.5, after=6) as stats:
        holder["s"] = stats
        toks, _ = sched.submit([40], {"max_new_tokens": 10})
    wd.close()
    assert toks == list(range(40, 50))  # the lane still finished
    evs = rec.snapshot(type="hang_suspected")
    assert evs and evs[0]["kind"] == "serving"
    assert reg.snapshot()["serving_hangs_total"] >= 1


def test_flaky_storage_retries_checkpoint_io(tmp_path, cache):
    ref = []
    ta = _trainer(tmp_path, "clean", cache, max_steps=4,
                  save_every_n_batches=2)
    _record(ta, ref)
    ta.train()
    ta.close()

    got = []
    tb = _trainer(tmp_path, "flaky", cache, max_steps=4,
                  save_every_n_batches=2)
    _record(tb, got)
    with faults.flaky_storage(times=3, ops=("checkpoint",)) as stats:
        tb.train()
        tb.close()
    assert stats["raised"] == 3
    assert tb.checkpoints.all_steps() == [2, 4]
    assert [loss for _, loss in got] == [loss for _, loss in ref]
    with faults.flaky_storage(times=2, ops=("checkpoint_restore",)) as st:
        tc = _trainer(tmp_path, "flaky", cache, max_steps=4)
    assert st["raised"] == 2 and tc.global_step == 4
    tc.close()
