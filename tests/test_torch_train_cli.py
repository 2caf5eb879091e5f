"""The port's `train` entry point and Trainer on the CPU.

- `python -m luminaai_tpu_torch train --preset debug --dense --synthetic
  --steps 3 --device cpu` runs (bf16 compute, the flash path's plain
  versions) and ends with the JAX CLI's `training done` line; the MoE
  preset with `--moe-dispatch gmm` lowers its loss in 3 steps. Each run
  writes into an output directory of its own (checkpoints, logs,
  summary).
- Without --data, `train` warns and trains on the synthetic batches, as
  the JAX CLI does.
- The synthetic batches are the JAX CLI's, epoch by epoch.
- A Trainer on the debug dense widths (fp32, lr 1e-2) lowers the loss on
  the synthetic pattern and returns the JAX summary keys.
"""

import itertools
import json
import logging
import os
import re
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np

from luminaai_tpu import cli as jcli
from luminaai_tpu.config import ConfigPresets as JPresets
from luminaai_tpu_torch import cli
from luminaai_tpu_torch.config import ConfigPresets
from luminaai_tpu_torch.training.trainer import Trainer

ROOT = Path(__file__).resolve().parent.parent


def test_train_cli_runs_on_the_cpu(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "luminaai_tpu_torch", "train", "--preset",
         "debug", "--dense", "--synthetic", "--steps", "3", "--device",
         "cpu", "--output-dir", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = proc.stdout.strip().splitlines()[-1]
    m = re.fullmatch(r"training done: steps=3 final_loss=(\S+)", last)
    assert m and np.isfinite(float(m.group(1))), last
    assert len(re.findall(r"step \d+ loss=", proc.stderr)) == 3


def test_train_cli_trains_the_moe_preset_on_the_cpu(tmp_path):
    """The debug preset with its 8 experts, gmm dispatch (the grouped
    matmul's plain version on the CPU): 3 steps lower the loss."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "luminaai_tpu_torch", "train", "--preset",
         "debug", "--moe-dispatch", "gmm", "--synthetic", "--steps", "3",
         "--device", "cpu", "--output-dir", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    losses = [float(x) for x in re.findall(r"step \d+ loss=(\S+)",
                                           proc.stderr)]
    assert len(losses) == 3 and all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses


def test_train_cli_without_data_trains_on_synthetic_batches(tmp_path,
                                                           caplog):
    """As the JAX CLI's make_data: no --data (and no config data file) is
    a warning, and the run trains on the synthetic batches."""
    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT,
                                                 signal.SIGTERM)}
    level = logging.getLogger().level
    try:
        with caplog.at_level(logging.WARNING, logger="luminaai_tpu_torch"):
            rc = cli.main(["train", "--preset", "debug", "--dense",
                           "--steps", "2", "--batch-size", "2",
                           "--seq-length", "64", "--device", "cpu",
                           "--output-dir", str(tmp_path)])
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
        logging.getLogger().setLevel(level)
    assert rc == 0
    assert "no --data given; training on synthetic data" in caplog.text
    summary = json.loads((tmp_path / "training_summary.json").read_text())
    assert summary["final_step"] == 2 and summary["preempted"] is False


def test_synthetic_batches_are_the_jax_clis():
    cfg = ConfigPresets.get("debug", batch_size=3, seq_length=40)
    jcfg = JPresets.get("debug")
    jcfg.batch_size, jcfg.seq_length = 3, 40
    ours, theirs = cli._synthetic_batches(cfg), jcli._synthetic_batches(jcfg)
    for _ in range(2):  # two epochs
        for a, b in zip(itertools.islice(ours(), 4),
                        itertools.islice(theirs(), 4)):
            np.testing.assert_array_equal(a["input_ids"], b["input_ids"])


def test_trainer_lowers_the_loss(tmp_path):
    cfg = ConfigPresets.get("debug", use_moe=False, precision="fp32",
                            learning_rate=1e-2, max_steps=8, batch_size=4,
                            seq_length=128, warmup_ratio=0.1,
                            output_dir=str(tmp_path))
    trainer = Trainer(cfg, cli._synthetic_batches(cfg), device="cpu", seed=0)
    summary = trainer.train()
    assert summary["final_step"] == 8
    losses = [h["loss"] for h in summary["history"]]
    assert all(np.isfinite(losses)) and losses[-1] < 0.8 * losses[0], losses
    assert summary["history"][0]["learning_rate"] == 0.0
    for key in ("final_step", "epochs", "elapsed_sec", "tokens_seen",
                "tokens_per_sec", "final_metrics"):
        assert key in summary
    assert summary["tokens_seen"] == 8 * 4 * 128
