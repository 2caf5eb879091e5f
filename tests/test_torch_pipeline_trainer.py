"""The Trainer and the CLI under pipeline stages (training/trainer.py's
pipeline branches, checkpoints over stages) in 2 gloo processes at pp 2,
the widths of tests/torch_pipe_harness.py:

  - the OOM ladder's microbatch split under pp raises the pipeline
    microbatches (2 -> 4; JAX trainer.py:643-660), and a batch-size change
    keeps the microbatch's rows (:709-717); the run after the split equals
    a 1-process run accumulating over the same micro-batches;
  - a pp 2 run stopped at step 2 and resumed to step 4 equals the
    uninterrupted pp 2 run bitwise (parameters and moments);
  - its checkpoint restores in the 1-process Trainer bitwise, and a
    1-process checkpoint restores into a pp 2 run bitwise;
  - `train --pp 2` under torchrun with gloo trains and writes its summary
    (under the orchestrator, the default).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from torch_mesh_harness import Ranks, assert_params
from torch_pipe_harness import ARCH

PP = dict(pipeline_parallel_size=2, max_steps=4, save_every_n_batches=2,
          eval_every_n_batches=10**9, health_check_interval=100, seed=0)


def _trainer(out_dir, **kw):
    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.training.trainer import Trainer

    cfg = Config(**{**ARCH, **PP, **kw}, output_dir=str(out_dir))
    return Trainer(cfg, cli._synthetic_batches(cfg), device="cpu")


def _whole(trainer):
    """(names, params, moments) of the whole state (rank 0; None
    elsewhere)."""
    state = trainer.state
    if getattr(state, "sharded", False):
        state = state.gather_full()
        if state is None:
            return None
    opt = state.opt_state
    return (list(state.names), [t.detach().clone() for t in state.params],
            [t.detach().clone() for t in opt.tensors()], int(state.step))


def _ranks_body(rank, n, root):
    import torch.distributed as dist

    out = {}
    # Uninterrupted run A, then B stopped at 2 and resumed to 4.
    a = _trainer(f"{root}/A")
    a.train()
    out["A"] = _whole(a)
    a.close()
    b = _trainer(f"{root}/B")
    step = b.train_step

    def stop_after_two(state, batch):
        if b.global_step == 1:
            b.request_stop("test")  # honoured at step 2's boundary
        return step(state, batch)

    b.train_step = stop_after_two
    out["B_preempted"] = b.train()["preempted"]
    b.close()
    b2 = _trainer(f"{root}/B")
    out["B_resumed_at"] = b2.global_step
    b2.train()
    out["B"] = _whole(b2)
    b2.close()
    dist.barrier()
    # A 1-process checkpoint (written by the parent) into pp 2.
    one = _trainer(f"{root}/one", auto_resume=True)
    out["one_restored"] = _whole(one)
    one.close()
    # The microbatch split and a batch-size change under pp.
    s = _trainer(f"{root}/split", save_every_n_batches=10**9)
    it = iter(s.train_data())
    s.state, _ = s.train_step(s.state, s._to_device(next(it)))
    s.adjust_microbatch(2, reason="test")
    out["split_micro"] = s.config.pipeline_microbatches
    s.state, _ = s.train_step(s.state, s._to_device(next(it)))
    out["split"] = _whole(s)
    s.adjust_batch_size(16, reason="test")
    out["batch16_micro"] = s.config.pipeline_microbatches
    s.close()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pp_trainer")
    one = _trainer(root / "one", pipeline_parallel_size=1,
                   gradient_accumulation_steps=2)
    for batch in list(one.train_data())[:2]:
        one.state, _ = one.train_step(one.state, one._to_device(batch))
        one.global_step += 1
    one.save_checkpoint(force=True)
    one.checkpoints.wait()
    one_state = _whole(one)
    one.close()
    ranks = Ranks(2, _ranks_body, (str(root),), root / "ranks")
    # The 1-process split run: accumulation 2, then 4 (the same
    # micro-batches as pp 2's 2, then 4).
    split = _trainer(root / "one_split", pipeline_parallel_size=1,
                     gradient_accumulation_steps=2,
                     save_every_n_batches=10**9)
    it = iter(split.train_data())
    split.state, _ = split.train_step(split.state,
                                      split._to_device(next(it)))
    split.adjust_microbatch(2)
    split.state, _ = split.train_step(split.state,
                                      split._to_device(next(it)))
    split_state = _whole(split)
    split.close()
    return ranks.join(180), one_state, split_state, root


def _equal(a, b):
    return a[0] == b[0] and a[3] == b[3] and all(
        torch.equal(x, y) for x, y in zip(a[1] + a[2], b[1] + b[2]))


def test_pp_stop_and_resume_is_bitwise(runs):
    res = runs[0][0]
    assert res["B_preempted"] and res["B_resumed_at"] == 2
    assert res["A"][3] == res["B"][3] == 4
    assert _equal(res["A"], res["B"])


def test_pp_checkpoint_restores_in_the_one_process_trainer(runs):
    res, root = runs[0][0], runs[3]
    one = _trainer(root / "A", pipeline_parallel_size=1, auto_resume=True,
                   gradient_accumulation_steps=2)
    got = _whole(one)
    one.close()
    assert got[3] == 4 and _equal(got, res["A"])


def test_one_process_checkpoint_restores_into_pp(runs):
    res, one_state = runs[0][0], runs[1]
    assert _equal(res["one_restored"], one_state)


def test_microbatch_split_under_pp_raises_the_microbatches(runs):
    res, split_state = runs[0][0], runs[2]
    assert res["split_micro"] == 4
    # The batch doubles; the microbatch keeps its 2 rows.
    assert res["batch16_micro"] == 8
    names, params, _, step = res["split"]
    assert step == split_state[3] == 2
    worst = assert_params(dict(zip(names, params)),
                          dict(zip(split_state[0], split_state[1])),
                          2 * ARCH["learning_rate"], "pp split")
    print(f"pp 2 split vs 1 process: params abs {worst:.2e}")


def test_train_pp2_under_torchrun(tmp_path):
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(repo), OMP_NUM_THREADS="1")
    out = tmp_path / "run"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "luminaai_tpu_torch", "train",
         "--preset", "debug", "--dense", "--pp", "2", "--batch-size", "8",
         "--grad-accum", "2", "--seq-length", "64", "--synthetic",
         "--steps", "2", "--device", "cpu", "--output-dir", str(out)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads((out / "training_summary.json").read_text())
    assert summary["final_step"] == 2 and "adaptive_decisions" in summary
    meta = json.loads((out / "experiment_metadata.json").read_text())
    # The accumulation folded into 4 pipeline microbatches.
    assert meta["config"]["pipeline_microbatches"] == 4
    assert meta["config"]["gradient_accumulation_steps"] == 1
