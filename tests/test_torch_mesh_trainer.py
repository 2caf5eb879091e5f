"""The port's Trainer and CLI over a process group (training/trainer.py,
cli.py `train` / `resume` under torchrun), in 2 gloo processes spawned once
for the file (tests/torch_mesh_harness.py), at the debug preset's dense
widths in fp32, sequence 64, batch 4, fsdp 2, synthetic batches.

  - a 2-rank `train --synthetic --steps 4` stopped after step 2 (a stop
    armed on rank 0 only stops both ranks at the same boundary, with one
    emergency checkpoint written by rank 0) and resumed equals the
    uninterrupted 2-rank run bitwise: every step's loss and the final
    checkpoint's parameters and moments;
  - that step-2 checkpoint resumes on 1 process, and a 1-process step-2
    checkpoint resumes on 2 ranks: both finish within rtol 1e-5 of the
    uninterrupted run (losses; parameters as tests/test_torch_train_step.py
    holds them);
  - per-rank data: local_rows splits a global batch into disjoint shares
    that cover it and keep each micro-batch's rows together; the packed
    loader's per-rank batches (batch_shard's index and count) equal the
    JAX loader's per-process batches;
  - rank 0 alone writes the run's files;
  - `train --sp 2`, `--tp 2` and `--ep 2 --moe-dispatch a2a` train.
"""

import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch

from luminaai_tpu.data import dataset as jds
from luminaai_tpu_torch.data import dataset as ds
from luminaai_tpu_torch.parallel.train_step import local_rows
from torch_mesh_harness import assert_params, run_ranks

FLAGS = ["--preset", "debug", "--dense", "--batch-size", "4",
         "--grad-accum", "1", "--seq-length", "64", "--synthetic",
         "--steps", "4", "--device", "cpu", "--no-adaptive", "--seed", "0",
         "--lr", "1e-3", "--precision", "fp32"]


def _cli(out, extra=(), stop_at=None, resume=False, flags=FLAGS):
    """cli.main train/resume into `out`; stop_at arms a stop on rank 0
    (or the only process) after that step. Returns (exit code, the
    losses of the steps this run took)."""
    import torch.distributed as dist

    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.training import trainer as tr

    rank = dist.get_rank() if dist.is_initialized() else 0
    losses = []
    orig = tr.Trainer._make_train_step

    def make(self, schedule):
        step = orig(self, schedule)

        def wrapped(state, batch):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            if stop_at is not None and rank == 0 and state.step == stop_at:
                self.request_stop("test")
            return state, m

        return wrapped

    tr.Trainer._make_train_step = make
    level = logging.getLogger().level  # train sets the config's level
    try:
        rc = cli.main(["resume" if resume else "train", *flags,
                       "--output-dir", str(out), *extra])
    finally:
        tr.Trainer._make_train_step = orig
        logging.getLogger().setLevel(level)
    return rc, losses


def _ranks_body(rank, n, root):
    os.environ["RANK"] = str(rank)  # as torchrun sets it
    out = {}
    out["U"] = _cli(f"{root}/U", ["--fsdp", "2"])
    out["S_stop"] = _cli(f"{root}/S", ["--fsdp", "2"], stop_at=2)
    if rank == 0:  # the step-2 checkpoint, for the 1-process resume
        shutil.copytree(f"{root}/S", f"{root}/A")
    torch.distributed.barrier()
    out["S_resume"] = _cli(f"{root}/S", ["--fsdp", "2"], resume=True)
    out["B_resume"] = _cli(f"{root}/B", ["--fsdp", "2"], resume=True)
    out["files"] = sorted(os.listdir(f"{root}/U"))
    # The other mesh flags through the same entry point, 2 steps each.
    for name, extra in (("sp", ["--sp", "2", "--steps", "2"]),
                        ("tp", ["--tp", "2", "--steps", "2"]),
                        ("a2a", ["--ep", "2", "--moe-dispatch", "a2a",
                                 "--steps", "2"])):
        if name == "a2a":
            extra = [a for a in FLAGS if a != "--dense"] + extra
        out[name] = _cli(f"{root}/{name}", extra, flags=FLAGS if name
                         != "a2a" else ())
    return out


def _final(root, name):
    from luminaai_tpu_torch.training.checkpoint import load_state_file

    tree = load_state_file(f"{root}/{name}/checkpoints/4", mmap=False)
    return tree


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("runs")
    # B: one process, stopped after step 2 (its checkpoint resumes on 2).
    b_stop = _cli(root / "B", stop_at=2)
    ranks = run_ranks(2, _ranks_body, (str(root),),
                      tmp_path_factory.mktemp("r"))
    a_resume = _cli(root / "A", resume=True)
    return root, ranks, b_stop, a_resume


def test_two_rank_stop_and_resume_equals_the_uninterrupted_run(runs):
    root, ranks, _, _ = runs
    rc_u, loss_u = ranks[0]["U"]
    rc_s, loss_s = ranks[0]["S_stop"]
    rc_r, loss_r = ranks[0]["S_resume"]
    assert rc_u == 0 and rc_s == 75 and rc_r == 0
    assert (rc_s, rc_r) == (ranks[1]["S_stop"][0], ranks[1]["S_resume"][0])
    assert len(loss_s) == 2 and len(loss_r) == 2
    assert loss_s + loss_r == loss_u  # bitwise
    u, s = _final(root, "U"), _final(root, "S")
    for part in ("params",):
        for k, t in u[part].items():
            assert torch.equal(t, s[part][k]), k
    for k in ("mu", "nu"):
        for name, t in u["opt_state"][k].items():
            assert torch.equal(t, s["opt_state"][k][name]), (k, name)
    assert u["step"] == s["step"] == 4


def test_checkpoints_move_between_one_and_two_ranks(runs):
    root, ranks, b_stop, a_resume = runs
    _, loss_u = ranks[0]["U"]
    assert b_stop[0] == 75 and a_resume[0] == 0
    rc_b, loss_b = ranks[0]["B_resume"]
    assert rc_b == 0
    np.testing.assert_allclose(b_stop[1] + loss_b, loss_u, rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["S_stop"][1] + a_resume[1], loss_u,
                               rtol=1e-5)
    from luminaai_tpu_torch.config import ConfigPresets
    from luminaai_tpu_torch.convert import flax_to_state_dict

    cfg = ConfigPresets.get("debug", use_moe=False)
    u = flax_to_state_dict(_final(root, "U")["params"], cfg)
    lr_sum = 4e-3
    for name in ("A", "B"):
        got = flax_to_state_dict(_final(root, name)["params"], cfg)
        assert_params(got, u, lr_sum, name)


@pytest.mark.parametrize("case", ["sp", "tp", "a2a"])
def test_the_mesh_flags_train(runs, case):
    """`train --sp 2` (ring attention), `--tp 2` and `--ep 2
    --moe-dispatch a2a` (the debug preset's experts) over 2 ranks: exit
    0, finite falling-or-flat losses, the same on both ranks."""
    _, ranks, _, _ = runs
    (rc, losses), (rc1, losses1) = ranks[0][case], ranks[1][case]
    assert rc == rc1 == 0
    assert len(losses) == 2 and losses == losses1
    assert all(np.isfinite(losses))


def test_only_rank_zero_writes(runs):
    root, ranks, _, _ = runs
    files = ranks[0]["files"]
    assert "training_summary.json" in files and "checkpoints" in files
    summary = json.loads((root / "U" / "training_summary.json").read_text())
    assert summary["final_step"] == 4
    assert not list((root / "U").glob("**/rank*"))


@pytest.mark.parametrize("B,accum,n", [(8, 1, 2), (8, 2, 2), (16, 4, 4),
                                       (12, 3, 2)])
def test_local_rows_are_disjoint_and_cover_the_batch(B, accum, n):
    shares = [local_rows(B, accum, n, i).tolist() for i in range(n)]
    flat = sorted(sum(shares, []))
    assert flat == list(range(B))
    mb = B // accum
    for i, rows in enumerate(shares):
        # Micro-batch j of rank i lies inside the one-rank micro-batch j.
        for j in range(accum):
            part = rows[j * mb // n:(j + 1) * mb // n]
            assert all(j * mb <= r < (j + 1) * mb for r in part)


def test_local_rows_refuse_a_batch_that_does_not_split():
    with pytest.raises(ValueError):
        local_rows(8, 2, 3, 0)


def test_packed_rank_batches_equal_jax_process_batches(tmp_path):
    rng = np.random.RandomState(4)
    docs = [rng.randint(1, 250, size=rng.randint(3, 90)).tolist()
            for _ in range(60)]
    cache = ds.TokenCache(str(tmp_path / "c")).build(iter(docs))
    jcache = jds.TokenCache(str(tmp_path / "c")).open()
    streams = []
    for pi in range(2):
        kw = dict(batch_size=4, seq_length=32, pad_id=0, eos_id=255,
                  shuffle_seed=3, process_index=pi, process_count=2)
        ours = [b["input_ids"] for b in ds.PackedDataset(cache, **kw)]
        theirs = [b["input_ids"] for b in jds.PackedDataset(jcache, **kw)]
        assert len(ours) == len(theirs) > 0
        for a, b in zip(ours, theirs):
            assert a.shape == (2, 32)
            np.testing.assert_array_equal(a, b)
        streams.append(ours)
    assert not np.array_equal(streams[0][0], streams[1][0])
