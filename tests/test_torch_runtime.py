"""The port's training runtime on the CPU: monitoring, retry, Trainer,
kill-and-resume, the CLI's train / resume / serve --checkpoint.

Against the JAX package:
- the RetryPolicy delay ladder (seeded jitter) and the sleeps of a retried
  call are equal;
- the same registry operations render the same Prometheus text; the same
  goodput transitions on an injected clock give the same snapshot;
- the port's Trainer and JAX's run 3 steps from the same packed data file
  with the same initial weights (convert.params_from_flax of the JAX
  trainer's): losses within rtol 1e-5, grad_norm within rtol 1e-4 (the
  tolerances of tests/test_torch_train_step.py; fp32, reductions in other
  orders); the trained batches are equal.

Within the port (exact):
- kill at step 4 of 8, resume in a fresh Trainer: the trained batches and
  losses equal an uninterrupted run's bit for bit, and so do the final
  parameters;
- a second signal exits 75 and commits only whole steps: inside a step
  (the optimizer mid-way through its in-place loop) it saves nothing,
  between two steps it saves the last whole one;
- a corrupt latest checkpoint: the Trainer resumes from the older one
  with its exact data cursor;
- the OOM ladder splits the micro-batches on torch.cuda.OutOfMemoryError;
- `train --data --packed` exits 0; the same run with a SIGTERM after step
  2 exits 75 with a committed emergency checkpoint; `resume` exits 0 and
  lands on the uninterrupted run's parameters; `serve --checkpoint` builds
  an engine whose weights and first decode step equal those of an engine
  built from the trainer's in-memory weights.
"""

import json
import logging
import os
import random
import signal

import jax
import numpy as np
import pytest
import torch

from luminaai_tpu.config import Config as JConfig
from luminaai_tpu.data import dataset as jds
from luminaai_tpu.monitoring.goodput import GoodputLedger as JLedger
from luminaai_tpu.monitoring.telemetry import MetricsRegistry as JRegistry
from luminaai_tpu.training.trainer import Trainer as JTrainer
from luminaai_tpu.utils import retry as jretry
from luminaai_tpu_torch import cli
from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.convert import params_from_flax
from luminaai_tpu_torch.data import dataset as ds
from luminaai_tpu_torch.data.tokenizer import ConversationTokenizer
from luminaai_tpu_torch.models.transformer import LuminaTransformer
from luminaai_tpu_torch.monitoring.goodput import GoodputLedger
from luminaai_tpu_torch.monitoring.telemetry import MetricsRegistry
from luminaai_tpu_torch.training import checkpoint as ck
from luminaai_tpu_torch.training import optimizer as optimizer_mod
from luminaai_tpu_torch.training import trainer as trainer_mod
from luminaai_tpu_torch.training.trainer import Trainer
from luminaai_tpu_torch.utils import retry

WORDS = ("a resumed run must train the very batches the preempted one "
         "would have trained next").split()
TINY = dict(vocab_size=384, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, seq_length=32, intermediate_size=128,
            precision="fp32", batch_size=8, use_flash_attention=False,
            gradient_checkpointing=False, use_moe=False, max_steps=8,
            learning_rate=1e-3, eval_every_n_batches=10**6,
            save_every_n_batches=10**6, health_check_interval=10,
            watchdog=False)


def _corpus(path, seed=0, n=120):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for _ in range(n):
            f.write(json.dumps(
                {"text": " ".join(rng.choice(WORDS, rng.randint(3, 40)))})
                + "\n")
    return str(path)


def _loader(mod, cache, cfg):
    tok = ConversationTokenizer()
    d = mod.PackedDataset(cache, cfg.batch_size, cfg.seq_length,
                          pad_id=tok.pad_token_id, eos_id=tok.eos_token_id,
                          shuffle_seed=cfg.seed)
    return mod.PrefetchLoader(lambda: iter(d), prefetch=2, source=d)


def _record(trainer, sink):
    """(input batch, loss, grad_norm) per executed step."""
    orig = trainer.train_step

    def wrap(state, batch):
        ids = np.asarray(batch["input_ids"].cpu() if torch.is_tensor(
            batch["input_ids"]) else batch["input_ids"]).copy()
        out = orig(state, batch)
        sink.append((ids, float(out[1]["loss"]), float(out[1]["grad_norm"])))
        return out

    trainer.train_step = wrap


@pytest.fixture
def restore_process_state():
    """The CLI installs signal handlers and sets the root log level."""
    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT,
                                                 signal.SIGTERM)}
    level = logging.getLogger().level
    yield
    for s, h in handlers.items():
        signal.signal(s, h)
    logging.getLogger().setLevel(level)


def test_retry_ladder_matches_jax():
    ours = retry.RetryPolicy(max_attempts=6, base_delay_s=0.05,
                             max_delay_s=0.5, rng=random.Random(3),
                             registry=MetricsRegistry())
    theirs = jretry.RetryPolicy(max_attempts=6, base_delay_s=0.05,
                                max_delay_s=0.5, rng=random.Random(3),
                                registry=JRegistry())
    assert ([ours.delay_for_attempt(a) for a in range(1, 7)]
            == [theirs.delay_for_attempt(a) for a in range(1, 7)])

    def flaky(n, err):
        left = {"n": n}

        def fn():
            if left["n"]:
                left["n"] -= 1
                raise err("transient")
            return "ok"
        return fn

    sleeps = ([], [])
    for policy, sink, mod in ((ours, sleeps[0], retry),
                              (theirs, sleeps[1], jretry)):
        policy._sleep = sink.append
        policy._rng = random.Random(9)
        assert policy.call(flaky(3, mod.TransientIOError), op="t") == "ok"
        with pytest.raises(FileNotFoundError):  # permanent: no retry
            policy.call(flaky(1, FileNotFoundError), op="t")
    assert sleeps[0] == sleeps[1] and len(sleeps[0]) == 3


def _registry_ops(r):
    c = r.counter("io_retries_total", "Retries, by op", labelnames=("op",))
    c.labels(op="checkpoint_save").inc()
    c.labels(op="data_open").inc(3)
    r.gauge("train_tokens_per_sec", "Throughput").set(1234.5)
    r.gauge("live", "A pulled gauge").set_function(lambda: 7.0)
    h = r.histogram("train_step_seconds", "Step time",
                    buckets=(0.1, 0.5, 1.0, 5.0))
    for v in (0.05, 0.3, 0.3, 0.7, 2.0, 9.0):
        h.observe(v)
    h.observe(0.2, count=4)
    return r.render_prometheus()


def test_prometheus_text_matches_jax():
    ours, theirs = _registry_ops(MetricsRegistry()), _registry_ops(JRegistry())
    assert ours == theirs
    assert "io_retries_total{op=\"data_open\"} 3" in ours


def test_goodput_ledger_matches_jax():
    def run(cls):
        t = {"now": 0.0}
        led = cls(registry=None, clock=lambda: t["now"])
        led.start("idle")
        for cause, dt in (("compile", 2.0), ("productive", 5.0),
                          ("data_wait", 0.5), ("productive", 3.0),
                          ("checkpoint", 1.5)):
            t["now"] += 0.25
            led.switch(cause)
            t["now"] += dt
        led.reattribute("resume_replay", 0.5)
        led.stop()
        return led.snapshot()

    assert run(GoodputLedger) == run(JLedger)


def _jax_params_and_trainer(tmp_path, cfg_kw, loader):
    jcfg = JConfig(**{**cfg_kw, "output_dir": str(tmp_path / "jax"),
                      "slo": False, "max_steps": 3})
    jt = JTrainer(jcfg, train_data=loader,
                  checkpoint_dir=str(tmp_path / "jax" / "ckpt"))
    return jt, jax.device_get(jt.state.params)


def test_trainer_matches_jax_from_a_packed_file(tmp_path):
    path = _corpus(tmp_path / "corpus.jsonl")
    cfg = Config(**{**TINY, "max_steps": 3,
                    "output_dir": str(tmp_path / "port")})
    jcfg_kw = dict(TINY)
    tok = ConversationTokenizer()
    cache = ds.build_text_cache(path, str(tmp_path / "cache"), tok)
    jcache = jds.TokenCache(str(tmp_path / "cache")).open()

    jt, jparams = _jax_params_and_trainer(
        tmp_path, jcfg_kw, _loader(jds, jcache, cfg))
    theirs = []
    _record(jt, theirs)
    jt.train()
    jt.close()

    model = LuminaTransformer(cfg, device="cpu", trainable=True)
    model.load_params(params_from_flax(jparams, cfg))
    t = Trainer(cfg, _loader(ds, cache, cfg), model=model, device="cpu")
    ours = []
    _record(t, ours)
    summary = t.train()
    t.close()

    assert len(ours) == len(theirs) == 3 and summary["final_step"] == 3
    for i, ((ia, la, ga), (ib, lb, gb)) in enumerate(zip(ours, theirs)):
        np.testing.assert_array_equal(ia, ib, err_msg=f"batch {i}")
        np.testing.assert_allclose(la, lb, rtol=1e-5, err_msg=f"loss {i}")
        np.testing.assert_allclose(ga, gb, rtol=1e-4, err_msg=f"norm {i}")
    for key in ("final_step", "epochs", "elapsed_sec", "tokens_seen",
                "tokens_per_sec", "final_metrics", "health",
                "interventions", "preempted", "resumed_exact_data_state",
                "goodput"):
        assert key in summary, key
    assert summary["goodput"]["seconds"]["compile"] > 0


def _port_trainer(tmp_path, name, cache, **kw):
    cfg = Config(**{**TINY, "output_dir": str(tmp_path / name), **kw})
    return Trainer(cfg, _loader(ds, cache, cfg), device="cpu", seed=0,
                   checkpoint_dir=str(tmp_path / name / "ckpt"))


def _final_params(trainer):
    return [p.detach().clone() for p in trainer.state.params]


def test_kill_and_resume_is_bitwise(tmp_path):
    cache = ds.build_text_cache(_corpus(tmp_path / "c.jsonl", n=60),
                                str(tmp_path / "cache"),
                                ConversationTokenizer())
    ref = []
    ta = _port_trainer(tmp_path, "a", cache)
    _record(ta, ref)
    assert ta.train()["final_step"] == 8
    ta.close()

    got = []
    tb = _port_trainer(tmp_path, "b", cache)
    _record(tb, got)
    orig = tb.train_step

    def preempt_at_4(state, batch):
        out = orig(state, batch)
        if len(got) == 4:
            tb.request_stop("injected preemption")
        return out

    tb.train_step = preempt_at_4
    sb = tb.train()
    tb.close()
    assert sb["preempted"] is True and sb["final_step"] == 4
    assert (tmp_path / "b" / "ckpt" / "4").is_dir()

    tb2 = _port_trainer(tmp_path, "b", cache)
    assert tb2.global_step == 4 and tb2._resumed_exact_data_state
    _record(tb2, got)
    sb2 = tb2.train()
    tb2.close()
    assert sb2["final_step"] == 8 and sb2["resumed_exact_data_state"]
    assert sb2["goodput"]["seconds"]["checkpoint"] > 0
    assert len(got) == len(ref) == 8
    for i, ((ba, la, _), (bb, lb, _)) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(ba, bb, err_msg=f"batch {i}")
        assert la == lb, f"loss {i}: {la} != {lb}"
    for a, b in zip(_final_params(ta), _final_params(tb2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("where", ["mid_step", "between_steps"])
def test_second_signal_commits_only_whole_steps(tmp_path, monkeypatch,
                                                where):
    """Both signals land in step 3: inside the optimizer's in-place loop
    (one parameter already stepped), or while the loader hands over its
    batch. Every committed checkpoint holds the parameters of a whole
    step: mid-step nothing is saved, between steps step 2 is."""
    cache = ds.build_text_cache(_corpus(tmp_path / "c.jsonl", n=60),
                                str(tmp_path / "cache"),
                                ConversationTokenizer())
    t = _port_trainer(tmp_path, where, cache, save_every_n_batches=1)
    handler = cli._signal_handler(t)
    whole = {}
    orig = t.train_step

    def record(state, batch):
        out = orig(state, batch)
        whole[out[0].step] = [p.detach().clone() for p in out[0].params]
        return out

    t.train_step = record

    def signal_twice():
        handler(signal.SIGTERM, None)  # the first: stop at the boundary
        if where == "mid_step":
            with torch.no_grad():
                t.state.params[0].add_(1.0)  # one tensor updated
        handler(signal.SIGTERM, None)

    if where == "mid_step":
        real_apply = optimizer_mod.AdamW.apply

        def torn_apply(self, params, grads, state):
            if state.count == 2:
                signal_twice()
            return real_apply(self, params, grads, state)

        monkeypatch.setattr(optimizer_mod.AdamW, "apply", torn_apply)
    else:
        real_to_device = t._to_device
        fetched = []

        def to_device(batch):
            fetched.append(1)
            if len(fetched) == 3:
                signal_twice()
            return real_to_device(batch)

        t._to_device = to_device
    with pytest.raises(SystemExit) as exc:
        t.train()
    assert exc.value.code == cli.RESUMABLE_EXIT
    assert t.checkpoints.all_steps() == [1, 2]
    emergency = "emergency" in t.checkpoints.load_metadata(2)["metrics"]
    assert emergency == (where == "between_steps")
    for step in (1, 2):
        state = t.checkpoints.restore(t.state, step)
        assert state.step == step
        for a, b in zip(state.params, whole[step]):
            assert torch.equal(a, b), (where, step)
    t.close()


def test_corrupt_latest_checkpoint_walks_back(tmp_path):
    cache = ds.build_text_cache(_corpus(tmp_path / "c.jsonl", n=60),
                                str(tmp_path / "cache"),
                                ConversationTokenizer())
    t = _port_trainer(tmp_path, "r", cache, max_steps=4,
                      save_every_n_batches=2)
    t.train()
    t.close()
    assert t.checkpoints.all_steps() == [2, 4]
    state = tmp_path / "r" / "ckpt" / "4" / ck.STATE_NAME
    data = bytearray(state.read_bytes())
    data[-100] ^= 1
    state.write_bytes(bytes(data))
    t2 = _port_trainer(tmp_path, "r", cache, max_steps=4)
    assert t2.global_step == 2 and t2._resumed_exact_data_state
    assert t2.checkpoints._m_fallbacks.value >= 1
    t2.close()


def test_oom_ladder_splits_microbatches(tmp_path, monkeypatch):
    real = trainer_mod.make_train_step
    raised = []

    def make(*a, **kw):
        step = real(*a, **kw)

        def oom_once(state, batch):
            if not raised:
                raised.append(1)
                raise torch.cuda.OutOfMemoryError("CUDA out of memory")
            return step(state, batch)
        return oom_once

    monkeypatch.setattr(trainer_mod, "make_train_step", make)
    cfg = Config(**{**TINY, "max_steps": 2,
                    "output_dir": str(tmp_path / "o")})
    t = Trainer(cfg, cli._synthetic_batches(cfg), device="cpu", seed=0)
    summary = t.train_with_oom_protection()
    t.close()
    assert summary["final_step"] == 2
    assert cfg.gradient_accumulation_steps == 2
    assert summary["interventions"][0]["kind"] == "microbatch_split"


def _cli_args(corpus, out, steps=6):
    return ["--preset", "debug", "--dense", "--data", corpus, "--packed",
            "--steps", str(steps), "--batch-size", "2", "--seq-length", "64",
            "--device", "cpu", "--output-dir", str(out)]


def test_cli_train_preempt_resume_and_serve(tmp_path, monkeypatch,
                                            restore_process_state):
    corpus = _corpus(tmp_path / "corpus.jsonl", n=80)
    assert cli.main(["train", *_cli_args(corpus, tmp_path / "A")]) == 0
    summary_a = json.loads((tmp_path / "A" / "training_summary.json")
                           .read_text())
    assert summary_a["final_step"] == 6 and not summary_a["preempted"]
    meta = json.loads((tmp_path / "A" / "experiment_metadata.json")
                      .read_text())
    assert meta["dataset_tokens"] > 0 and meta["planned_steps"] == 6

    real = trainer_mod.make_train_step
    trainers = []

    def make(*a, **kw):
        step = real(*a, **kw)
        calls = {"n": 0}

        def sigterm_after_2(state, batch):
            out = step(state, batch)
            calls["n"] += 1
            if calls["n"] == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return sigterm_after_2

    monkeypatch.setattr(trainer_mod, "make_train_step", make)
    assert cli.main(["train", *_cli_args(corpus, tmp_path / "B")]) == 75
    monkeypatch.setattr(trainer_mod, "make_train_step", real)
    ckpt_b = tmp_path / "B" / "checkpoints"
    assert ck.committed_steps(ckpt_b) == [2]
    assert ck.verify_step_dir(ckpt_b / "2")["status"] == "ok"
    assert json.loads((tmp_path / "B" / "training_summary.json")
                      .read_text())["preempted"] is True

    orig_init = Trainer.__init__

    def keep(self, *a, **kw):
        orig_init(self, *a, **kw)
        trainers.append(self)

    monkeypatch.setattr(Trainer, "__init__", keep)
    assert cli.main(["resume", *_cli_args(corpus, tmp_path / "B")]) == 0
    resumed = trainers[-1]
    assert resumed._resumed_exact_data_state
    losses_a = [h["loss"] for h in summary_a["history"]]
    losses_b = [h["loss"] for h in json.loads(
        (tmp_path / "B" / "training_summary.json").read_text())["history"]]
    assert losses_b == losses_a[2:]
    tree_a = ck.load_state_file(tmp_path / "A" / "checkpoints" / "6")
    tree_b = ck.load_state_file(ckpt_b / "6")
    for name, t in tree_a["params"].items():
        assert torch.equal(t, tree_b["params"][name]), name

    # serve --checkpoint: the saved weights, and the same first decode
    # step as an engine built from the resumed trainer's memory.
    args = cli._parser().parse_args(
        ["serve", "--checkpoint", str(ckpt_b), "--device", "cpu"])
    engine = cli.build_serve_engine(args)
    assert engine.config.to_dict() == resumed.config.to_dict()
    from luminaai_tpu_torch.inference.chat import build_engine

    mem = build_engine(resumed.config, device="cpu", seed=1)
    mem.model.load_params(resumed.model.state_dict())
    for (k, a), b in zip(engine.model.state_dict().items(),
                         mem.model.state_dict().values()):
        assert torch.equal(a, b), k
    logits = []
    for eng in (engine, mem):
        dec = eng.make_stepwise(num_slots=2, page_size=16)
        for text in ("resume exactly", "the very batches"):
            slot = dec.acquire_slot()
            dec.prefill_into_slot(slot, eng.tokenizer.encode_text(text),
                                  max_new_tokens=4)
        logits.append(dec.step_logits())
    assert torch.equal(logits[0], logits[1])
