"""Checkpoint management (port of luminaai_tpu/training/checkpoint.py).

The JAX package saves through orbax; the port has a format of its own
and keeps the manager's contract:

  - Layout: <dir>/<step>/state.pt (one `torch.save` file of CPU tensors:
    the parameters and the AdamW moments, each named by its flax path as
    convert.state_dict_to_flax names it (fp32 moments; with bf16 mu the
    same names with "form": "bf16"; int8 moments as "mu_codes" /
    "nu_codes" by flax path and their row scales "mu_scales" /
    "nu_scales" by state_dict name, "form": "int8"), the optimizer count,
    the step
    and the train step's torch.Generator state, which the MoE routing
    noise draws from), <dir>/<step>/metadata.json (config, metrics,
    data_state, as the JAX metadata) and <dir>/<step>/manifest.sha256.json
    (per-file sha256, version 1, written tmp + fsync + rename), plus
    <dir>/checkpoint_history.json.
  - A step is written into <dir>/<step>.tmp-<pid>/ and renamed into place
    once its files and manifest are on disk: a step directory is either
    absent or complete (a kill mid-write leaves only a tmp directory,
    which discovery ignores and the next save of that step replaces).
  - `save` copies the state from the card to host memory before it
    returns; the file write, fsync, manifest and commit then run on a
    background thread. The next save, `wait`, `restore`,
    `emergency_save` and `close` join it (and re-raise its error).
  - Rotation keeps `save_total_limit` steps: the newest, then the best by
    eval_loss (steps without one rank last, older first).
  - Restore verifies the manifest first (CheckpointIntegrityError on a
    mismatch); `restore_with_fallback` walks back past corrupt or partial
    steps; `emergency_save` blocks until the commit has landed and falls
    back to `config.checkpoint_local_tier` when the primary dir fails.
  - `save_params_checkpoint` writes a step with the parameters only (no
    moments; `finetune --merge-out`), committed the same way;
    `verify_checkpoint_dir` reports every step's manifest
    (`verify-checkpoint`).

The restore copies into the live state (parameters, moments, count,
step, generator) in place, bit for bit. A step whose moments are of
another form than the live state's (the config's) is refused with a
message naming both; it is never reinitialised.

Over a process group the state is a parallel.sharding.ShardedTrainState:
`save` gathers the shards into the one-rank layout (every rank takes
part; rank 0 alone writes, its answer to "already saved?" broadcast), and
`restore` reads the one-rank file on every rank and copies each rank's
slices in, so a checkpoint moves between N ranks and 1 either way.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import random
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from luminaai_tpu_torch.monitoring.telemetry import MetricsRegistry, get_registry
from luminaai_tpu_torch.utils.retry import RetryPolicy

logger = logging.getLogger(__name__)

STATE_NAME = "state.pt"
METADATA_NAME = "metadata.json"
FORMAT = "luminaai_tpu_torch.checkpoint/1"


class MomentFormError(ValueError):
    """A step's Adam moments are of another form than the config's: no
    fallback walks past it, and nothing is reinitialised."""
# A committed step renamed aside while a forced save replaces it:
# "<step>.old-<pid>".
ASIDE = ".old-"

# -- integrity manifests (docs/resilience.md "Durable I/O") -----------------
# Every committed step directory carries a per-file sha256 manifest,
# written atomically (tmp + fsync + rename). Restore verifies it BEFORE
# the bytes are deserialized: a bitflipped file becomes a detected
# mismatch that `restore_with_fallback` walks past like any corruption.
MANIFEST_NAME = "manifest.sha256.json"
MANIFEST_VERSION = 1
# Sampled fast mode: hash at most this many files (deterministic choice
# per step); every file's SIZE is still checked.
SAMPLE_MAX_HASHED = 4


class CheckpointIntegrityError(RuntimeError):
    """A checkpoint's bytes do not match its integrity manifest (bit
    corruption, torn write, missing file). Treated exactly like a
    corrupt checkpoint: `restore_with_fallback` walks back past it."""


def _hash_file(path: Path, chunk: int = 1 << 24) -> str:
    h = hashlib.sha256()
    with path.open("rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def _manifest_files(step_dir: Path) -> List[Path]:
    return [
        f
        for f in sorted(step_dir.rglob("*"))
        if f.is_file()
        and f.name != MANIFEST_NAME
        and not f.name.endswith(".tmp")
    ]


def _fsync_write(path: Path, payload: bytes) -> None:
    with path.open("wb") as fh:
        fh.write(payload)
        fh.flush()
        os.fsync(fh.fileno())


def write_manifest(
    step_dir: Path, retry: Optional[RetryPolicy] = None
) -> Path:
    """Hash every file under `step_dir` and write the manifest atomically
    (tmp + fsync + rename): a reader either sees no manifest or a
    complete one, never a torn one that verifies garbage."""
    step_dir = Path(step_dir)
    hash_one = (
        (lambda f: retry.call(_hash_file, f, op="manifest_write"))
        if retry is not None
        else _hash_file
    )
    files = {
        f.relative_to(step_dir).as_posix(): {
            "sha256": hash_one(f),
            "size": f.stat().st_size,
        }
        for f in _manifest_files(step_dir)
    }
    doc = {
        "version": MANIFEST_VERSION,
        "algo": "sha256",
        "created_at": time.time(),
        "files": files,
    }
    payload = json.dumps(doc, indent=1).encode()
    tmp = step_dir / (MANIFEST_NAME + ".tmp")
    out = step_dir / MANIFEST_NAME

    def _write():
        _fsync_write(tmp, payload)
        os.replace(tmp, out)

    if retry is not None:
        retry.call(_write, op="manifest_write")
    else:
        _write()
    return out


def verify_step_dir(step_dir: Path, mode: str = "full") -> Dict[str, Any]:
    """Check `step_dir` against its manifest. Returns
    {"status": "ok"|"corrupt"|"unmanifested", "mode", "files",
     "hashed", "mismatches": [{"file", "reason"}, ...]}.

    `full` hashes every manifested file; `sample` checks every file's
    size but hashes only a deterministic per-step subset. A missing
    manifest is "unmanifested" (restored with a warning); an unreadable
    or torn manifest is "corrupt"."""
    step_dir = Path(step_dir)
    report: Dict[str, Any] = {
        "path": str(step_dir),
        "mode": mode,
        "files": 0,
        "hashed": 0,
        "mismatches": [],
    }
    manifest_path = step_dir / MANIFEST_NAME
    if not manifest_path.is_file():
        report["status"] = "unmanifested"
        return report
    try:
        doc = json.loads(manifest_path.read_text())
        files = doc["files"]
        assert isinstance(files, dict)
    except Exception as e:
        report["status"] = "corrupt"
        report["mismatches"].append(
            {"file": MANIFEST_NAME, "reason": f"torn_manifest ({e})"}
        )
        return report
    names = sorted(files)
    report["files"] = len(names)
    if mode == "sample" and len(names) > SAMPLE_MAX_HASHED:
        rnd = random.Random(step_dir.name)
        to_hash = set(rnd.sample(names, SAMPLE_MAX_HASHED))
    else:
        to_hash = set(names)
    for rel in names:
        want = files[rel]
        f = step_dir / rel
        if not f.is_file():
            report["mismatches"].append({"file": rel, "reason": "missing"})
            continue
        size = f.stat().st_size
        if size != want.get("size"):
            report["mismatches"].append(
                {"file": rel, "reason": f"size {size} != {want.get('size')}"}
            )
            continue
        if rel in to_hash:
            report["hashed"] += 1
            if _hash_file(f) != want.get("sha256"):
                report["mismatches"].append(
                    {"file": rel, "reason": "sha256 mismatch"}
                )
    report["status"] = "corrupt" if report["mismatches"] else "ok"
    return report


def committed_steps(root) -> List[int]:
    """The committed step directories under `root`, ascending."""
    root = Path(root)
    if not root.is_dir():
        return []
    return sorted(
        int(p.name) for p in root.iterdir() if p.is_dir() and p.name.isdigit()
    )


def commit_step(root: Path, step: int, tree: Dict[str, Any],
                meta: Dict[str, Any]) -> int:
    """Write one step into a tmp directory under `root` (state,
    metadata, manifest, each fsynced) and rename it into place. Returns
    the bytes written. A failed attempt commits nothing; when it rewrites
    a committed step (a forced save), that step stays whole until the
    new one is renamed into its place."""
    root = Path(root)
    tmp = root / f"{step}.tmp-{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    state_path = tmp / STATE_NAME
    with state_path.open("wb") as fh:
        torch.save(tree, fh)
        fh.flush()
        os.fsync(fh.fileno())
    _fsync_write(tmp / METADATA_NAME,
                 json.dumps(meta, indent=1, default=str).encode())
    write_manifest(tmp)
    final = root / str(step)
    aside = root / f"{step}{ASIDE}{os.getpid()}"
    if final.exists():
        if aside.exists():
            shutil.rmtree(aside)
        os.replace(final, aside)
    try:
        os.replace(tmp, final)
    except BaseException:
        if aside.exists() and not final.exists():
            os.replace(aside, final)
        raise
    fd = os.open(root, os.O_RDONLY)
    try:
        os.fsync(fd)  # the rename itself is durable
    finally:
        os.close(fd)
    if aside.exists():
        shutil.rmtree(aside, ignore_errors=True)
    return sum(f.stat().st_size for f in final.iterdir())


def save_params_checkpoint(root, step: int, params: Dict[str, torch.Tensor],
                           meta: Dict[str, Any]) -> Path:
    """A params-only checkpoint (no optimizer state) in this format:
    <root>/<step>/ with {flax path: tensor} parameters, `meta` (it must
    hold the config) and a manifest. Serving, chat and evaluate load it;
    training cannot resume from it. Returns the step directory."""
    root = Path(root).absolute()
    root.mkdir(parents=True, exist_ok=True)
    tree = {"format": FORMAT,
            "params": {k: v.detach().to("cpu").contiguous()
                       for k, v in params.items()},
            "step": int(step)}
    commit_step(root, step, tree, {"step": int(step), **meta})
    return root / str(step)


def verify_checkpoint_dir(
    root, step: Optional[int] = None, mode: str = "full"
) -> Dict[str, Any]:
    """Verify the manifest of every step (or one step) under `root`:
    {"root", "mode", "steps": {step: verify_step_dir report}, "ok",
    "corrupt", "unmanifested"} with the step lists sorted. Raises
    FileNotFoundError when `root` or the step does not exist."""
    root = Path(root)
    if not root.is_dir():
        raise FileNotFoundError(f"no checkpoint directory {root}")
    steps = committed_steps(root)
    if step is not None:
        if step not in steps:
            raise FileNotFoundError(f"no step {step} under {root}")
        steps = [step]
    out: Dict[str, Any] = {
        "root": str(root),
        "mode": mode,
        "steps": {},
        "ok": [],
        "corrupt": [],
        "unmanifested": [],
    }
    for s in steps:
        report = verify_step_dir(root / str(s), mode=mode)
        out["steps"][s] = report
        out[report["status"]].append(s)
    return out


def load_state_file(step_dir, mmap: bool = True) -> Dict[str, Any]:
    """The tensors of a step's state.pt on the CPU (memory-mapped: only
    what is read is paged in)."""
    return torch.load(
        Path(step_dir) / STATE_NAME, map_location="cpu", mmap=mmap,
        weights_only=True,
    )


def _reason_label(reason: str) -> str:
    """Collapse freeform emergency-save reasons into a bounded label set
    (Prometheus label cardinality must not scale with log messages)."""
    low = (reason or "").lower()
    if "preempt" in low or "sigterm" in low or "signal" in low:
        return "preemption"
    if "finite" in low or "nan" in low:
        return "non_finite"
    if "oom" in low or "resource" in low:
        return "oom"
    return "other"


def _host_tree(state, config: Config) -> Dict[str, Any]:
    """The state's tensors copied to host memory, named by flax path."""

    def named(tensors) -> Dict[str, torch.Tensor]:
        sd = {n: t.detach().to("cpu", copy=True)
              for n, t in zip(state.names, tensors)}
        return {k: v.contiguous()
                for k, v in state_dict_to_flax(sd, config).items()}

    if not state.names:
        raise ValueError("TrainState.names is empty: build the state with "
                         "parallel.train_step.init_train_state")
    opt = state.opt_state
    if opt.form == "int8":
        opt_tree = {
            "form": "int8",
            "count": int(opt.count),
            "mu_codes": named(opt.mu_codes),
            "nu_codes": named(opt.nu_codes),
            "mu_scales": {n: t.detach().to("cpu", copy=True)
                          for n, t in zip(state.names, opt.mu_scales)},
            "nu_scales": {n: t.detach().to("cpu", copy=True)
                          for n, t in zip(state.names, opt.nu_scales)},
        }
    else:
        opt_tree = {"count": int(opt.count), "mu": named(opt.mu),
                    "nu": named(opt.nu)}
        if opt.form != "fp32":
            opt_tree["form"] = opt.form
    return {
        "format": FORMAT,
        "params": named(state.params),
        "opt_state": opt_tree,
        "step": int(state.step),
        "generator": state.generator.get_state().clone(),
    }


class CheckpointManager:
    """Save/restore TrainState with rotation, best-k tracking and resume.

    Layout: <dir>/<step>/ (state.pt + metadata.json + manifest), and
    <dir>/checkpoint_history.json (step, eval_loss, time per save).
    """

    def __init__(
        self,
        config: Config,
        checkpoint_dir: str = "checkpoints",
        registry: Optional[MetricsRegistry] = None,
        recorder=None,
    ):
        self.config = config
        self.dir = Path(checkpoint_dir).absolute()
        self.dir.mkdir(parents=True, exist_ok=True)
        # Over a process group only rank 0 writes (the ranks' states are
        # gathered to it); every rank reads.
        self.writer = not dist.is_initialized() or dist.get_rank() == 0
        if self.writer:
            self._recover_aside()
        self.history_file = self.dir / "checkpoint_history.json"
        self.history: List[Dict[str, Any]] = self._load_history()
        r = self._registry = registry or get_registry()
        # None -> resolve the process recorder at emit time.
        self._recorder = recorder
        self._retry = RetryPolicy.from_config(
            config, registry=r, recorder=recorder
        )
        self._writer: Optional[threading.Thread] = None
        # A background write error, re-raised at the next join so a lost
        # step can never pass silently.
        self._async_error: Optional[BaseException] = None
        # (step, seconds, bytes) of the saves and restores this process
        # ran: the save's host copy + write + commit, the restore's
        # verify + read.
        self.save_log: List[Dict[str, float]] = []
        self.restore_log: List[Dict[str, float]] = []
        self._m_fallbacks = r.counter(
            "checkpoint_restore_fallbacks_total",
            "Corrupt/partial checkpoints skipped while walking back to "
            "the newest intact one on restore",
        )
        self._m_emergency = r.counter(
            "emergency_saves_total",
            "Blocking emergency checkpoints, by (bounded) reason",
            labelnames=("reason",),
        )
        self._m_manifest = r.counter(
            "checkpoint_manifest_mismatch_total",
            "Checkpoints whose bytes failed sha256 manifest verification "
            "at restore (bit corruption / torn write)",
        )
        self._m_unmanifested = r.counter(
            "checkpoint_unmanifested_restores_total",
            "Restores of checkpoints without an integrity manifest",
        )
        self._m_local_tier = r.counter(
            "checkpoint_local_tier_saves_total",
            "Emergency saves that fell back to the local-tier directory "
            "after the primary checkpoint dir failed",
        )
        self._m_failures_commit = r.counter(
            "io_failures_total",
            "Storage ops that raised to the caller (permanent error or "
            "retry ladder exhausted), by op",
            labelnames=("op",),
        ).labels(op="checkpoint_commit")
        self.best_loss = min(
            (h["eval_loss"] for h in self.history
             if h.get("eval_loss") is not None),
            default=float("inf"),
        )

    # -- save -----------------------------------------------------------
    def save(
        self,
        state,
        step: int,
        metrics: Optional[Dict[str, float]] = None,
        force: bool = False,
        data_state: Optional[Dict[str, Any]] = None,
    ) -> bool:
        """Save the train state at `step`: copied to host memory before
        this returns, written and committed on a background thread.

        `data_state` is the loader's exact-resume cursor (epoch, batch
        index, shuffle seed); it rides in the JSON metadata so
        `Trainer.maybe_resume` can fast-forward the data stream to the
        exact batch after this step."""
        self._join_writer()
        metrics = {
            k: float(v)
            for k, v in (metrics or {}).items()
            if np.isscalar(v) or getattr(v, "ndim", 1) == 0
        }
        dup = step in self.all_steps() and not force
        if getattr(state, "sharded", False) and state.mesh.size > 1:
            # Rank 0's answer for every rank: the save is collective.
            flag = torch.tensor([float(dup)], device=state.mesh.device)
            dist.broadcast(flag, 0)
            dup = bool(flag.item())
        if dup:
            return False  # already checkpointed (periodic duplicate)
        meta: Dict[str, Any] = {
            "step": step,
            "config": self.config.to_dict(),
            "metrics": metrics,
            "timestamp": time.time(),
        }
        if data_state is not None:
            meta["data_state"] = data_state
        t0 = time.perf_counter()
        if getattr(state, "sharded", False):
            # Every rank gathers its shards (collective); rank 0 writes.
            state = state.gather_full()
        if not self.writer:
            return True
        tree = _host_tree(state, self.config)
        copy_s = time.perf_counter() - t0

        def write():
            try:
                nbytes = self._retry.call(
                    self._commit, tree, meta, step, op="checkpoint_save"
                )
            except BaseException as e:
                self._m_failures_commit.inc()
                self._async_error = e
                self._emit(
                    "io_failure", op="checkpoint_commit",
                    error=f"{type(e).__name__}: {str(e)[:160]}",
                )
                logger.error("checkpoint commit of step %d failed: %s",
                             step, e)
                return
            self.save_log.append({
                "step": step, "seconds": time.perf_counter() - t0,
                "host_copy_seconds": copy_s, "bytes": nbytes,
            })
            self._rotate(keep=step)

        self._writer = threading.Thread(target=write, daemon=True,
                                        name="ckpt-writer")
        self._writer.start()
        eval_loss = metrics.get("eval_loss")
        self.history.append(
            {"step": step, "eval_loss": eval_loss, "time": time.time()}
        )
        if eval_loss is not None and eval_loss < self.best_loss:
            self.best_loss = eval_loss
        self._save_history()
        return True

    def _commit(self, tree: Dict[str, Any], meta: Dict[str, Any],
                step: int) -> int:
        return commit_step(self.dir, step, tree, meta)

    def _recover_aside(self) -> None:
        """A kill between a forced save's two renames leaves the old step
        only under its aside name: put it back. An aside beside its
        committed step is stale."""
        for p in self.dir.iterdir():
            step, sep, _ = p.name.partition(ASIDE)
            if not (sep and step.isdigit() and p.is_dir()):
                continue
            if (self.dir / step).exists():
                shutil.rmtree(p, ignore_errors=True)
            else:
                os.replace(p, self.dir / step)
                logger.warning("restored checkpoint step %s from %s", step,
                               p.name)

    def _rotate(self, keep: int) -> None:
        """Keep save_total_limit steps: `keep` (the step just saved),
        then the best by eval_loss, steps without one last, newer
        first."""
        limit = max(1, self.config.save_total_limit)
        steps = self.all_steps()
        if len(steps) <= limit:
            return
        loss = {h["step"]: h.get("eval_loss") for h in self.history}

        def rank(s):
            e = loss.get(s)
            return (e is None, e if e is not None else 0.0, -s)

        others = sorted((s for s in steps if s != keep), key=rank)
        for s in others[limit - 1:]:
            self.delete(s)

    def wait(self) -> None:
        """Block until the pending save has committed (call before exit);
        re-raises its error."""
        self._join_writer()

    def _join_writer(self) -> None:
        t = self._writer
        if t is not None:
            t.join()
            self._writer = None
        err, self._async_error = self._async_error, None
        if err is not None:
            raise err

    def verify_step(self, step: int, mode: Optional[str] = None
                    ) -> Dict[str, Any]:
        """Manifest verification report for one step; mode defaults to
        config.checkpoint_verify."""
        mode = mode or getattr(self.config, "checkpoint_verify", "full")
        return verify_step_dir(self.dir / str(step), mode=mode)

    def _verify_before_restore(self, step: int) -> None:
        """Integrity gate: raise CheckpointIntegrityError on a manifest
        mismatch (counted + flight event; restore_with_fallback walks
        back past it); warn and proceed for an unmanifested step."""
        mode = getattr(self.config, "checkpoint_verify", "full")
        if mode == "off":
            return
        report = self.verify_step(step, mode)
        if report["status"] == "corrupt":
            self._m_manifest.inc()
            self._emit(
                "manifest_mismatch", step=step, mode=report["mode"],
                mismatches=report["mismatches"][:8],
            )
            raise CheckpointIntegrityError(
                f"checkpoint step {step} failed manifest verification "
                f"({len(report['mismatches'])} mismatch(es), first: "
                f"{report['mismatches'][0]}) — the bytes on disk are not "
                "the bytes that were saved"
            )
        if report["status"] == "unmanifested":
            self._m_unmanifested.inc()
            logger.warning(
                "checkpoint step %d has no integrity manifest: restoring "
                "unverified", step,
            )

    def _emit(self, type: str, **fields) -> None:
        try:
            rec = self._recorder
            if rec is None:
                from luminaai_tpu_torch.monitoring.events import get_recorder

                rec = get_recorder()
            rec.emit(type, **fields)
        except Exception:  # pragma: no cover - telemetry never raises
            logger.debug("event emit failed", exc_info=True)

    # -- restore --------------------------------------------------------
    def restore(self, state, step: Optional[int] = None):
        """Verify the step's manifest, then copy its parameters, moments,
        optimizer count, step and generator state into `state` in place.
        Returns `state`."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        self.wait()
        t0 = time.perf_counter()
        self._verify_before_restore(step)
        step_dir = self.dir / str(step)
        tree = self._retry.call(load_state_file, step_dir,
                                op="checkpoint_restore")
        if tree.get("format") != FORMAT:
            raise ValueError(f"{step_dir / STATE_NAME} is not a "
                             f"{FORMAT} file")

        def by_name(flat) -> Dict[str, torch.Tensor]:
            sd = flax_to_state_dict(flat, self.config)
            missing = [n for n in state.names if n not in sd]
            if missing or len(sd) != len(state.names):
                raise ValueError(f"checkpoint step {step} does not match "
                                 f"the model (missing {missing[:4]})")
            return sd

        sharded = state if getattr(state, "sharded", False) else None
        if sharded is not None:
            # Every rank reads the whole state and keeps its shards.
            state = sharded.host_template()
        saved = tree["opt_state"]
        opt = state.opt_state
        form = saved.get("form", "fp32")
        if form != opt.form:
            raise MomentFormError(
                f"checkpoint step {step} holds {form} Adam moments; the "
                f"config asks for {opt.form} moments (adam_mu_dtype="
                f"{self.config.adam_mu_dtype!r}, adam_state_quantization="
                f"{self.config.adam_state_quantization!r}): train on with "
                f"the saved form or start a new run")
        pairs = [(state.params, by_name(tree["params"]))]
        if form == "int8":
            pairs += [(opt.mu_codes, by_name(saved["mu_codes"])),
                      (opt.nu_codes, by_name(saved["nu_codes"])),
                      (opt.mu_scales, saved["mu_scales"]),
                      (opt.nu_scales, saved["nu_scales"])]
        else:
            pairs += [(opt.mu, by_name(saved["mu"])),
                      (opt.nu, by_name(saved["nu"]))]
        with torch.no_grad():
            for live, src_by_name in pairs:
                for name, dst in zip(state.names, live):
                    src = src_by_name[name]
                    if dst.shape != src.shape or dst.dtype != src.dtype:
                        raise ValueError(
                            f"checkpoint step {step}: {name} is "
                            f"{tuple(src.shape)} {src.dtype}, the model's "
                            f"{tuple(dst.shape)} {dst.dtype}")
                    dst.copy_(src)
        opt.count = int(saved["count"])
        state.step = int(tree["step"])
        state.generator.set_state(tree["generator"])
        if sharded is not None:
            sharded.load_full(state)
            state = sharded
        if state.params and state.params[0].is_cuda:
            torch.cuda.synchronize(state.params[0].device)
        self.restore_log.append({
            "step": step, "seconds": time.perf_counter() - t0,
            "bytes": sum(f.stat().st_size for f in step_dir.iterdir()),
        })
        return state

    def restore_with_fallback(
        self,
        state,
        step: Optional[int] = None,
        min_step: int = 0,
    ):
        """Restore the newest INTACT checkpoint at or before `step`,
        walking back past corrupt or partial ones and counting each skip
        into `checkpoint_restore_fallbacks_total`. Returns
        (restored_state, used_step, n_skipped); raises the LAST restore
        error only when every candidate fails."""
        candidates = [
            s for s in sorted(self.all_steps(), reverse=True)
            if (step is None or s <= step) and s >= min_step
        ]
        if not candidates:
            raise FileNotFoundError(
                f"no restorable checkpoints under {self.dir} "
                f"(step<={step}, min_step={min_step})"
            )
        last_exc: Optional[BaseException] = None
        for i, s in enumerate(candidates):
            try:
                restored = self.restore(state, s)
                if i > 0:
                    logger.warning(
                        "restored step %d after skipping %d corrupt/partial "
                        "newer checkpoint(s)", s, i,
                    )
                return restored, s, i
            except MomentFormError:
                raise
            except Exception as e:
                last_exc = e
                self._m_fallbacks.inc()
                logger.warning(
                    "checkpoint at step %d failed to restore (%s: %s); "
                    "falling back to an older step",
                    s, type(e).__name__, str(e)[:200],
                )
        raise last_exc  # every candidate failed

    def load_metadata(self, step: Optional[int] = None) -> Dict[str, Any]:
        if step is None:
            step = self.latest_step()
        path = self.dir / str(step) / METADATA_NAME
        return json.loads(
            self._retry.call(path.read_text, op="checkpoint_restore")
        )

    # -- discovery --------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        steps = set(self.all_steps())
        scored = [(h["eval_loss"], h["step"]) for h in self.history
                  if h.get("eval_loss") is not None and h["step"] in steps]
        return min(scored)[1] if scored else self.latest_step()

    def all_steps(self) -> List[int]:
        return committed_steps(self.dir)

    def get_resume_step(self) -> Optional[int]:
        """Auto-resume point if enabled."""
        if not self.config.auto_resume:
            return None
        return self.latest_step()

    # -- maintenance ----------------------------------------------------
    def delete(self, step: int) -> bool:
        try:
            shutil.rmtree(self.dir / str(step))
            return True
        except Exception as e:  # pragma: no cover
            logger.warning("delete of step %d failed: %s", step, e)
            return False

    def emergency_save(
        self,
        state,
        step: int,
        reason: str = "",
        data_state: Optional[Dict[str, Any]] = None,
    ) -> bool:
        """Blocking last-chance save: returns only once the commit has
        landed (the caller's next move is usually an exit). When the
        primary dir fails and `config.checkpoint_local_tier` names a
        directory, the save falls back there."""
        self._m_emergency.labels(reason=_reason_label(reason)).inc()
        ok = False
        try:
            ok = self.save(
                state, step, metrics={"emergency": 1.0}, force=True,
                data_state=data_state,
            )
        except Exception as e:
            logger.error("emergency save failed: %s", e)
        finally:
            try:
                self.wait()  # BLOCK until the commit has fully landed
            except Exception as e:
                logger.error("emergency save commit failed: %s", e)
                ok = False
        if not ok:
            ok = self._emergency_local_tier(state, step, reason, data_state)
        if ok:
            logger.warning(
                "emergency checkpoint at step %d (%s) committed", step, reason
            )
        return ok

    def _emergency_local_tier(self, state, step: int, reason: str,
                              data_state) -> bool:
        """Blocking save into the configured local-tier directory after
        the primary dir failed. Never raises: this runs on the exit
        path."""
        tier = getattr(self.config, "checkpoint_local_tier", None)
        if not tier:
            return False
        try:
            local = CheckpointManager(
                self.config, str(Path(tier) / self.dir.name),
                registry=self._registry, recorder=self._recorder,
            )
            try:
                ok = local.save(
                    state, step, metrics={"emergency": 1.0}, force=True,
                    data_state=data_state,
                )
            finally:
                local.close()  # blocking commit
            if ok:
                self._m_local_tier.inc()
                self._emit(
                    "local_tier_save", step=step, reason=reason,
                    dir=str(Path(tier) / self.dir.name),
                )
                logger.warning(
                    "emergency save fell back to local tier %s (step %d)",
                    tier, step,
                )
            return ok
        except Exception as e:
            logger.error("local-tier emergency save failed: %s", e)
            return False

    # -- history --------------------------------------------------------
    def _load_history(self) -> List[Dict[str, Any]]:
        if self.history_file.exists():
            try:
                return json.loads(self.history_file.read_text())
            except Exception:  # pragma: no cover
                return []
        return []

    def _save_history(self) -> None:
        self.history_file.write_text(json.dumps(self.history, indent=1))

    def close(self) -> None:
        self.wait()


def find_checkpoint_step(checkpoint_dir, mode: str = "full"):
    """(step_dir, metadata) of the newest step under `checkpoint_dir` (a
    checkpoints directory, or a training output directory holding one)
    whose manifest verifies; older steps are tried when the newer are
    corrupt. Raises FileNotFoundError when none verifies."""
    root = Path(checkpoint_dir).absolute()
    if not committed_steps(root) and (root / "checkpoints").is_dir():
        root = root / "checkpoints"
    steps = committed_steps(root)
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {checkpoint_dir}")
    for step in reversed(steps):
        step_dir = root / str(step)
        report = verify_step_dir(step_dir, mode=mode)
        if report["status"] == "corrupt":
            logger.warning("checkpoint step %d failed its manifest (%s); "
                           "trying an older step", step,
                           report["mismatches"][:2])
            continue
        if report["status"] == "unmanifested":
            logger.warning("checkpoint step %d has no integrity manifest: "
                           "loading it unverified", step)
        meta = json.loads((step_dir / METADATA_NAME).read_text())
        return step_dir, meta
    raise FileNotFoundError(
        f"no checkpoint under {root} passes its manifest")
