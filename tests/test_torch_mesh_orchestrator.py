"""The orchestrator and the OOM ladder over a mesh (training/orchestrator.py,
training/trainer.py) in 2 gloo processes: rank 0 decides, one broadcast
carries its decision, every rank applies it.

  - decisions that rebuild sharded state (add_expert, prune_expert,
    rollback to the prune's forced save) injected through the
    orchestrator's health check at fixed steps (rank 1 proposes other
    decisions, which must lose to rank 0's): both ranks record the same
    interventions at the same steps, and the 2-rank run's parameters
    after it equal a 1-process run that took the same decisions
    (fsdp 2, MoE with 4 experts, gather dispatch; parameters as
    tests/test_torch_train_step.py holds them);
  - an OOM raised on rank 1 only (its step raising
    torch.cuda.OutOfMemoryError once, after the step's collectives) sends
    both ranks down the same rung (a microbatch split at the same step,
    the OOM ladder's rebuild of the sharded step);
  - `train` over a mesh runs the orchestrator by default (its summary
    carries adaptive_decisions) and `--no-adaptive` the bare loop.
"""

import json

import pytest

from torch_mesh_harness import Ranks, assert_params

ARCH = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, seq_length=32, intermediate_size=128,
            precision="fp32", batch_size=8, use_moe=True, num_experts=4,
            moe_pattern="all", moe_dispatch="gather", moe_top_k=2,
            routing_noise_std=0.0, learning_rate=1e-3,
            gradient_checkpointing=False, use_flash_attention=False,
            health_check_interval=1, intervention_cooldown_steps=0,
            save_every_n_batches=2, eval_every_n_batches=10**9, max_steps=8,
            seed=0)
# step -> the decision rank 0's health check proposes there.
SCRIPT = {2: ("add_expert", {}), 4: ("prune_expert", {"expert_idx": 1}),
          6: ("rollback", {})}


def _run(out_dir: str, mesh_kw: dict):
    """Train ARCH under the orchestrator with SCRIPT injected: (the
    interventions, the whole final parameters on rank 0)."""
    import torch.distributed as dist

    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.training.orchestrator import (
        AdaptiveDecision,
        AdaptiveTrainingOrchestrator,
    )
    from luminaai_tpu_torch.training.trainer import Trainer

    rank = dist.get_rank() if dist.is_initialized() else 0
    cfg = Config(**ARCH, **mesh_kw, output_dir=out_dir)
    trainer = Trainer(cfg, cli._synthetic_batches(cfg), device="cpu")
    orch = AdaptiveTrainingOrchestrator(trainer)
    script = dict(SCRIPT)  # each fires once (the rollback replays steps)

    def decide(step):
        if rank != 0:  # never applied: rank 0's decision is broadcast
            return AdaptiveDecision("lr_emergency", {}, "rank 1", 0.9, step)
        if step not in script:
            return None
        kind, params = script.pop(step)
        return AdaptiveDecision(kind, dict(params), "forced", 0.9, step)

    orch._decide = decide
    summary = orch.run(oom_protect=False)
    state = trainer.state
    if getattr(state, "sharded", False):
        full = state.gather_full()
        params = None if full is None else dict(zip(full.names,
                                                    full.params))
    else:
        params = dict(zip(state.names, [p.detach().clone()
                                        for p in state.params]))
    inter = [(i["step"], i["kind"]) for i in trainer._interventions]
    decisions = [(d["step"], d["kind"], d["applied"])
                 for d in summary["adaptive_decisions"]]
    trainer.close()
    return inter, decisions, params


def _oom_run(out_dir: str):
    """Train 4 steps under the OOM ladder with rank 1's second step
    raising an OOM once: (interventions, accumulation, final step)."""
    import torch
    import torch.distributed as dist

    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.training.trainer import Trainer

    cfg = Config(**{**ARCH, "max_steps": 4, "fsdp_parallel_size": 2,
                    "save_every_n_batches": 10**9}, output_dir=out_dir)
    trainer = Trainer(cfg, cli._synthetic_batches(cfg), device="cpu")
    fired = []
    orig = trainer._make_train_step

    def make(schedule):
        step = orig(schedule)

        def oom_once(state, batch):
            out = step(state, batch)
            if (dist.get_rank() == 1 and trainer.global_step == 1
                    and not fired):
                fired.append(1)
                raise torch.cuda.OutOfMemoryError("injected on rank 1")
            return out

        return oom_once

    trainer._make_train_step = make
    trainer.train_step = make(trainer._active_schedule)
    summary = trainer.train_with_oom_protection()
    inter = [(i["step"], i["kind"], i.get("to"))
             for i in trainer._interventions]
    trainer.close()
    return inter, cfg.gradient_accumulation_steps, summary["final_step"]


def _cli_run(out_dir: str, adaptive: bool) -> int:
    from luminaai_tpu_torch import cli

    return cli.main(["train", "--preset", "debug", "--dense", "--fsdp", "2",
                     "--batch-size", "4", "--grad-accum", "1",
                     "--seq-length", "32", "--synthetic", "--steps", "2",
                     "--device", "cpu", "--seed", "0", "--output-dir",
                     out_dir] + ([] if adaptive else ["--no-adaptive"]))


def _ranks_body(rank, n, root):
    import torch.distributed as dist

    out = {"decisions": _run(f"{root}/mesh", {"fsdp_parallel_size": 2})}
    dist.barrier()
    out["oom"] = _oom_run(f"{root}/oom")
    dist.barrier()
    out["cli"] = [_cli_run(f"{root}/cli_{a}", a) for a in (True, False)]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("orch")
    ranks = Ranks(2, _ranks_body, (str(root),), root / "ranks")
    one = _run(str(root / "one"), {})
    return ranks.join(180), one, root


def test_mesh_decisions_are_rank_zeros_and_taken_alike(runs):
    results, one, _ = runs
    inter0, dec0, _ = results[0]["decisions"]
    inter1, dec1, _ = results[1]["decisions"]
    # The rollback lands on the prune's forced save (step 4).
    assert inter0 == [(2, "add_expert"), (4, "prune_expert"),
                      (4, "rollback")], inter0
    assert inter0 == inter1 and dec0 == dec1
    assert all(applied for _, _, applied in dec0)
    assert inter0 == one[0]  # the 1-process run took the same decisions


def test_mesh_run_after_rebuilds_equals_one_process(runs):
    results, one, _ = runs
    params = results[0]["decisions"][2]
    lr = ARCH["learning_rate"] * ARCH["max_steps"]
    worst = assert_params(params, one[2], lr, "orchestrated mesh run")
    print(f"2 ranks vs 1 process after the decisions: params abs "
          f"{worst:.2e}")


def test_oom_on_one_rank_sends_both_down_the_same_rung(runs):
    results, _, _ = runs
    (i0, a0, s0), (i1, a1, s1) = (r["oom"] for r in results)
    assert i0 == i1 == [(1, "microbatch_split", 2)], (i0, i1)
    assert a0 == a1 == 2 and s0 == s1 == 4


def test_train_over_a_mesh_runs_the_orchestrator_by_default(runs):
    results, _, root = runs
    assert all(r["cli"] == [0, 0] for r in results)
    adaptive = json.loads((root / "cli_True" / "training_summary.json")
                          .read_text())
    bare = json.loads((root / "cli_False" / "training_summary.json")
                      .read_text())
    assert adaptive["final_step"] == bare["final_step"] == 2
    assert "adaptive_decisions" in adaptive
    assert "adaptive_decisions" not in bare
