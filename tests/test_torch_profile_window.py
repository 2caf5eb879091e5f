"""The Trainer's epochs, SLO stack and profiling window, and
utils/profiling.py, on the CPU.

- `Trainer(steps_per_epoch=3)` with num_epochs 2 over a 3-batch loader
  stops at step 6 after 2 epochs (JAX trainer.py:155-163, :1270-1273);
  its summary carries `epochs` and an `slo` block with the keys JAX's
  Trainer builds it from (its SLO stack's verdicts and ring stats, the
  train objectives).
- A profiling window (profile_start_step 2, profile_num_steps 2) writes a
  torch.profiler Chrome trace whose step marks are exactly the steps
  [2, 4), and attribution.jsonl beside it (n_steps 2); the trace carries
  the model's scopes (attention, moe/experts, fused_ce). A span tracer
  records the Trainer's checkpoint_save span.
- profiling_context writes a trace, profile_function / StepTimer /
  SectionTimer count and time.
"""

import glob
import json
import os

import numpy as np

from luminaai_tpu.config import Config as JConfig
from luminaai_tpu.monitoring.slo import build_slo_stack as jbuild_slo_stack
from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.monitoring.tracing import SpanTracer
from luminaai_tpu_torch.training.trainer import Trainer
from luminaai_tpu_torch.utils import profiling

TINY = dict(vocab_size=384, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, seq_length=32, intermediate_size=128,
            precision="fp32", batch_size=8, use_flash_attention=False,
            gradient_checkpointing=False, learning_rate=1e-3,
            eval_every_n_batches=10**6, save_every_n_batches=10**6,
            health_check_interval=10, watchdog=False, num_epochs=2)


def _batches(n=3, seed=0):
    rng = np.random.RandomState(seed)
    out = [{"input_ids": rng.randint(1, 384, (8, 32)).astype(np.int32)}
           for _ in range(n)]
    return lambda: iter(out)


def test_epochs_stop_at_steps_per_epoch_times_num_epochs(tmp_path):
    t = Trainer(Config(**TINY, use_moe=False,
                       output_dir=str(tmp_path / "port")),
                _batches(), device="cpu", seed=0, steps_per_epoch=3)
    assert t.total_steps == 6
    got = t.train()
    t.close()
    assert (got["final_step"], got["epochs"]) == (6, 2)
    # The JAX Trainer's summary["slo"] (trainer.py:1307-1316): its
    # engine's verdicts and its ring's stats, built from the same config.
    ring, engine = jbuild_slo_stack(JConfig(**TINY, use_moe=False),
                                    program="train")
    ring.sample_once()
    want = {**engine.verdicts(), "ring": ring.stats()}
    assert set(got["slo"]) == set(want)
    assert set(got["slo"]["ring"]) == set(want["ring"])
    assert set(got["slo"]["objectives"]) == set(want["objectives"])


def test_profile_window_is_exactly_its_steps(tmp_path):
    cfg = Config(**TINY, use_moe=True, num_experts=4, moe_top_k=2,
                 moe_dispatch="gmm", output_dir=str(tmp_path),
                 profile_start_step=2, profile_num_steps=2, max_steps=5)
    spans = tmp_path / "spans.jsonl"
    tracer = SpanTracer(jsonl_path=str(spans))
    t = Trainer(cfg, _batches(), device="cpu", seed=0, tracer=tracer)
    summary = t.train()
    t.close()
    tracer.close()
    assert summary["final_step"] == 5
    traces = glob.glob(str(tmp_path / "profile" / "*.pt.trace.json"))
    assert [os.path.basename(p) for p in traces] == ["steps2-4.pt.trace.json"]
    with open(traces[0]) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert {n for n in names if n.startswith("train_step")} == {
        "train_step 2", "train_step 3"}
    assert {"attention", "moe", "experts", "fused_ce"} <= names
    records = (tmp_path / "profile" / "attribution.jsonl").read_text()
    rec = [json.loads(line) for line in records.splitlines()]
    assert len(rec) == 1 and rec[0]["n_steps"] == 2
    assert [json.loads(line)["name"] for line in spans.read_text()
            .splitlines()] == ["checkpoint_save"]


def test_profiling_utilities(tmp_path):
    with profiling.profiling_context(str(tmp_path), name="region"):
        with profiling.annotate("work"):
            sum(range(1000))
    with open(tmp_path / "region.pt.trace.json") as f:
        assert any(e.get("name") == "work"
                   for e in json.load(f)["traceEvents"])
    with profiling.profiling_context(None):
        pass

    @profiling.profile_function
    def f(x):
        return x * 2

    assert f(3) == 6 and f(4) == 8
    assert f.summary()["count"] == 2
    timer = profiling.StepTimer()
    timer.start()
    w = timer.stop(n_steps=4, n_tokens=400)
    assert w["steps"] == 4 and w["tokens"] == 400 and w["seconds"] >= 0
    assert timer.summary()["windows"] == 1
    sections = profiling.SectionTimer()
    for _ in range(2):
        with sections.section("data"):
            pass
    assert sections.summary()["data"]["count"] == 2
