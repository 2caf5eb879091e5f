"""The curriculum data path and the adaptive CLI of the port, on the CPU.

- PackedDataset under set_difficulty 0.3 / 0.6 / 1.0 / None (shuffled and
  in file order) yields the JAX PackedDataset's batches exactly over an
  epoch; a mid-epoch state_dict carries the difficulty, and resuming from
  it (in either package) continues the stream exactly. PrefetchLoader
  forwards set_difficulty to its source and checkpoints the same state as
  JAX's.
- `train --synthetic --steps 4` runs under the AdaptiveTrainingOrchestrator
  by default (its meta history is written, the summary carries
  adaptive_decisions and trajectory, with the JAX CLI summary's key set
  plus the port's per-step history), and `--no-adaptive` does not.
- `train --config FILE.json` trains the configuration a JAX Config.save
  wrote (`--experiment` names the run); Config.save / load round-trip.
"""

import json
import logging
import signal

import numpy as np
import pytest

from luminaai_tpu import cli as jcli
from luminaai_tpu.config import Config as JConfig
from luminaai_tpu.data import dataset as jds
from luminaai_tpu_torch import cli
from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.data import dataset as ds
from luminaai_tpu_torch.data.tokenizer import ConversationTokenizer

WORDS = ("short and long documents enter the curriculum by their length "
         "quantile").split()


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("curriculum")
    rng = np.random.RandomState(1)
    path = tmp / "corpus.jsonl"
    with open(path, "w") as f:
        for _ in range(150):
            n = int(rng.choice([4, 12, 40, 90]))
            f.write(json.dumps({"text": " ".join(rng.choice(WORDS, n))})
                    + "\n")
    ours = ds.build_text_cache(str(path), str(tmp / "cache"),
                               ConversationTokenizer())
    return ours, jds.TokenCache(str(tmp / "cache")).open()


def _dataset(mod, cache, shuffle):
    tok = ConversationTokenizer()
    return mod.PackedDataset(cache, 4, 32, pad_id=tok.pad_token_id,
                             eos_id=tok.eos_token_id,
                             shuffle_seed=7 if shuffle else None)


def _epoch(d):
    return [b["input_ids"].copy() for b in d]


@pytest.mark.parametrize("shuffle", [True, False],
                         ids=["shuffled", "file_order"])
@pytest.mark.parametrize("difficulty", [0.3, 0.6, 1.0, None])
def test_curriculum_batches_equal_jax(caches, difficulty, shuffle):
    cache, jcache = caches
    ours, theirs = _dataset(ds, cache, shuffle), _dataset(jds, jcache,
                                                          shuffle)
    if difficulty is not None:
        ours.set_difficulty(difficulty)
        theirs.set_difficulty(difficulty)
    a, b = _epoch(ours), _epoch(theirs)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    full = _epoch(_dataset(ds, cache, shuffle))
    if difficulty is not None and difficulty < 1.0:
        assert len(a) < len(full)  # the long tail is held back
    else:
        assert len(a) == len(full)

    # Mid-epoch: the state carries the difficulty; resuming it in either
    # package continues the stream exactly.
    d = _dataset(ds, cache, shuffle)
    d.set_difficulty(difficulty if difficulty is not None else 1.0)
    if difficulty is None:
        d.difficulty = None
    it = iter(d)
    head = [next(it)["input_ids"].copy() for _ in range(2)]
    state = json.loads(json.dumps(d.state_dict()))
    assert state["difficulty"] == difficulty
    assert state == theirs.state_dict() | {"batch_index": 2, "epoch": 0}
    for mod, c in ((ds, cache), (jds, jcache)):
        r = _dataset(mod, c, not shuffle)  # the state restores the seed
        r.load_state_dict(state)
        rest = _epoch(r)
        assert len(head) + len(rest) == len(a)
        for x, y in zip(head + rest, a):
            np.testing.assert_array_equal(x, y)


def test_prefetch_loader_forwards_difficulty(caches):
    cache, jcache = caches
    loaders = []
    for mod, c in ((ds, cache), (jds, jcache)):
        d = _dataset(mod, c, True)
        pl = mod.PrefetchLoader(lambda d=d: iter(d), prefetch=2, source=d)
        assert pl.set_difficulty(0.6) is True
        assert d.difficulty == 0.6
        loaders.append(pl)
    assert loaders[0].state_dict() == loaders[1].state_dict()
    assert loaders[0].state_dict()["source"]["difficulty"] == 0.6
    assert ds.PrefetchLoader(lambda: iter([])).set_difficulty(0.5) is False


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


SMALL = ["--preset", "debug", "--synthetic", "--steps", "4",
         "--batch-size", "8", "--seq-length", "32"]


def test_train_is_adaptive_by_default(tmp_path, restore_process_state):
    out = tmp_path / "adaptive"
    # --no-slo as the JAX run below: the port's CLI takes it since it runs
    # the Trainer's SLO stack (whose verdicts add the summary's "slo").
    assert cli.main(["train", *SMALL, "--moe-dispatch", "gmm", "--device",
                     "cpu", "--no-slo", "--output-dir", str(out)]) == 0
    summary = json.loads((out / "training_summary.json").read_text())
    assert summary["adaptive_decisions"] == []
    assert "trajectory" in summary
    meta = [json.loads(x) for x in
            (out / "meta_history.jsonl").read_text().splitlines()]
    assert len(meta) == 1 and meta[0]["use_moe"] is True
    assert meta[0]["final_loss"] == summary["final_metrics"]["loss"]

    # The JAX CLI's summary of a run at these widths has the same keys
    # (the port adds its per-step history).
    jout = tmp_path / "jax"
    assert jcli.main(["train", *SMALL, "--no-moe", "--quiet", "--no-slo",
                      "--output-dir", str(jout)]) == 0
    jsummary = json.loads((jout / "training_summary.json").read_text())
    assert set(summary) - {"history"} == set(jsummary)

    plain = tmp_path / "plain"
    assert cli.main(["train", *SMALL, "--no-adaptive", "--device", "cpu",
                     "--output-dir", str(plain)]) == 0
    summary = json.loads((plain / "training_summary.json").read_text())
    assert "adaptive_decisions" not in summary
    assert "trajectory" not in summary
    assert not (plain / "meta_history.jsonl").exists()


def test_train_loads_a_config_file(tmp_path, restore_process_state):
    path = str(tmp_path / "tiny.json")
    JConfig(vocab_size=384, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, seq_length=32, intermediate_size=128,
            batch_size=4, use_moe=False, learning_rate=2e-3,
            health_check_interval=10).save(path)
    cfg = Config.load(path)
    assert (cfg.hidden_size, cfg.num_layers, cfg.learning_rate) == (
        64, 2, 2e-3)
    cfg.save(str(tmp_path / "again.json"))
    assert Config.load(str(tmp_path / "again.json")) == cfg

    out = tmp_path / "run"
    assert cli.main(["train", "--config", path, "--synthetic", "--steps",
                     "3", "--experiment", "tiny_from_file", "--device",
                     "cpu", "--output-dir", str(out)]) == 0
    meta = json.loads((out / "experiment_metadata.json").read_text())
    loaded = meta["config"]
    assert (loaded["hidden_size"], loaded["vocab_size"],
            loaded["batch_size"], loaded["learning_rate"],
            loaded["use_moe"]) == (64, 384, 4, 2e-3, False)
    assert loaded["experiment_name"] == "tiny_from_file"
    assert loaded["max_steps"] == 3
    summary = json.loads((out / "training_summary.json").read_text())
    assert summary["final_step"] == 3 and "adaptive_decisions" in summary
