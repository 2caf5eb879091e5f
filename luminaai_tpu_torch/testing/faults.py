"""Fault injectors for the port (PyTorch counterpart of
luminaai_tpu/testing/faults.py): make failure modes reproducible on a
laptop.

The recovery paths (OOM backoff ladder, instability rollback, emergency
save, restore fallback-walk, serving drain/deadline eviction) are only a
contract if they can be exercised deliberately; these monkeypatch-style
injectors do that without touching production code paths. Every injector
is a context manager that restores what it wrapped — and restores
NOTHING if the wrapped attribute was legitimately replaced mid-test
(e.g. the OOM ladder rebuilding `trainer.train_step` is the behavior
under test, not collateral to undo).

Each injector has the JAX one's name and signature and wraps the port's
seam: `Trainer.train_step` and `request_stop` (training/trainer.py),
`CheckpointManager.save` and its step layout (<dir>/<step>/state.pt plus
a sha256 manifest, training/checkpoint.py), utils/retry.set_fault_hook,
`PageShareClient.fetch_page` (serving/page_share.py), `ChatServer.handle`
/ `start_stream` (serving/server.py) and the decoders' `decode_step`
(inference/generate.py). `fail_step_at` raises torch.cuda.OutOfMemoryError
by default, the error the port's OOM ladder catches.

Used by the port's tests (pytest marker: `faults`).
"""

from __future__ import annotations

import contextlib
import logging
import os
import signal as _signal
import threading
import time
from pathlib import Path
from typing import Callable, Iterator, Optional

logger = logging.getLogger(__name__)


def _restore(obj, name, wrapper, original) -> None:
    """Put `original` back only if our wrapper is still installed — a
    recovery path that legitimately rebuilt the attribute (the thing
    under test) must keep its rebuilt version."""
    if getattr(obj, name, None) is wrapper:
        setattr(obj, name, original)


@contextlib.contextmanager
def fail_step_at(
    trainer,
    step_no: int,
    exc_factory: Optional[Callable[[], BaseException]] = None,
    times: int = 1,
) -> Iterator[dict]:
    """Make the trainer's `step_no`-th train_step CALL (1-based, counted
    from entry) raise — default a torch.cuda.OutOfMemoryError, so
    `train_with_oom_protection`'s backoff ladder engages. Raises `times`
    consecutive calls, then passes through. Yields a stats dict
    ({'calls', 'raised'})."""
    if exc_factory is None:
        import torch

        def exc_factory():
            return torch.cuda.OutOfMemoryError(
                "CUDA out of memory: injected fault"
            )

    stats = {"calls": 0, "raised": 0}
    original = trainer.train_step

    def wrapper(state, batch):
        stats["calls"] += 1
        if stats["calls"] >= step_no and stats["raised"] < times:
            stats["raised"] += 1
            raise exc_factory()
        return original(state, batch)

    trainer.train_step = wrapper
    try:
        yield stats
    finally:
        _restore(trainer, "train_step", wrapper, original)


@contextlib.contextmanager
def preempt_at_step(trainer, step_no: int) -> Iterator[dict]:
    """Call `trainer.request_stop()` right after the `step_no`-th train
    step completes — the in-process equivalent of a SIGTERM landing
    mid-step: the loop must finish the step, run a BLOCKING emergency
    save at the boundary, and return with summary['preempted']=True."""
    stats = {"calls": 0}
    original = trainer.train_step

    def wrapper(state, batch):
        stats["calls"] += 1
        out = original(state, batch)
        if stats["calls"] == step_no:
            trainer.request_stop("injected preemption")
        return out

    trainer.train_step = wrapper
    try:
        yield stats
    finally:
        _restore(trainer, "train_step", wrapper, original)


@contextlib.contextmanager
def sigterm_at_step(trainer, step_no: int) -> Iterator[dict]:
    """Deliver a REAL SIGTERM to this process right after the
    `step_no`-th train step — exercises the installed signal handler end
    to end (cli._install_signal_handlers → request_stop → emergency
    save → RESUMABLE_EXIT). Only for subprocess-based tests: the default
    SIGTERM disposition kills the process."""
    stats = {"calls": 0}
    original = trainer.train_step

    def wrapper(state, batch):
        stats["calls"] += 1
        out = original(state, batch)
        if stats["calls"] == step_no:
            os.kill(os.getpid(), _signal.SIGTERM)
        return out

    trainer.train_step = wrapper
    try:
        yield stats
    finally:
        _restore(trainer, "train_step", wrapper, original)


def corrupt_checkpoint(
    checkpoint_dir, step: int, mode: str = "truncate"
) -> int:
    """Corrupt an on-disk checkpoint the way a kill-mid-commit or
    disk-full does: `truncate` halves every state file (state.pt: a
    partial write), `delete` removes them. Returns the number of files
    damaged; raises if the step directory does not exist (a typo must
    not silently 'pass')."""
    from luminaai_tpu_torch.training.checkpoint import STATE_NAME

    step_dir = Path(checkpoint_dir) / str(step)
    if not step_dir.is_dir():
        raise FileNotFoundError(f"no checkpoint step dir {step_dir}")
    root = step_dir
    damaged = 0
    for f in sorted(root.rglob(STATE_NAME)):
        if not f.is_file():
            continue
        if mode == "delete":
            f.unlink()
            damaged += 1
        else:
            size = f.stat().st_size
            if size > 1:
                with f.open("r+b") as fh:
                    fh.truncate(max(1, size // 2))
                damaged += 1
    if damaged == 0:
        raise RuntimeError(f"nothing to corrupt under {root}")
    logger.warning("corrupted %d file(s) in %s (%s)", damaged, root, mode)
    return damaged


@contextlib.contextmanager
def truncated_checkpoint_writes(manager) -> Iterator[dict]:
    """Make every save through this CheckpointManager land truncated on
    disk (the commit 'succeeds' but the bytes are partial) — the failure
    a restore-side integrity walk must survive. Yields {'saves': n}."""
    stats = {"saves": 0}
    original = manager.save

    def wrapper(state, step, *args, **kwargs):
        ok = original(state, step, *args, **kwargs)
        manager.wait()  # let the async commit land before damaging it
        try:
            corrupt_checkpoint(manager.dir, step)
            stats["saves"] += 1
        except (FileNotFoundError, RuntimeError):
            pass  # save was skipped (duplicate step): nothing written
        return ok

    manager.save = wrapper
    try:
        yield stats
    finally:
        _restore(manager, "save", wrapper, original)


@contextlib.contextmanager
def hang_step_at(
    trainer, step_no: int, seconds: float = 2.0, times: int = 1
) -> Iterator[dict]:
    """Stall the `step_no`-th train_step CALL (1-based) for `seconds` of
    wall clock before executing it — what a stuck collective or a
    wedged compile helper looks like from the host loop's seat. The step
    eventually completes, so the watchdog's detect→dump→continue path
    and (with an injected exit fn) detect→abort are both drivable from
    one injector. Stalls `times` consecutive calls. Yields
    {'calls', 'hangs'}."""
    stats = {"calls": 0, "hangs": 0}
    original = trainer.train_step

    def wrapper(state, batch):
        stats["calls"] += 1
        if stats["calls"] >= step_no and stats["hangs"] < times:
            stats["hangs"] += 1
            time.sleep(seconds)
        return original(state, batch)

    trainer.train_step = wrapper
    try:
        yield stats
    finally:
        _restore(trainer, "train_step", wrapper, original)


@contextlib.contextmanager
def slow_tick(decoder, delay_s: float = 0.5, after: int = 3) -> Iterator[dict]:
    """Serving hang injector: every decode_step AFTER the `after`-th
    stalls `delay_s`. The fast warmup ticks build the serving watchdog's
    rolling stats, then the tick time jumps — so what trips is the
    ROBUST threshold crossing, not absolute slowness (contrast
    slow_decode, which slows every step uniformly for deadline-eviction
    tests). Yields {'steps'}."""
    stats = {"steps": 0}
    original = decoder.decode_step

    def wrapper(*args, **kwargs):
        stats["steps"] += 1
        if stats["steps"] > after:
            time.sleep(delay_s)
        return original(*args, **kwargs)

    decoder.decode_step = wrapper
    try:
        yield stats
    finally:
        _restore(decoder, "decode_step", wrapper, original)


@contextlib.contextmanager
def flaky_storage(
    times: int = 3,
    ops: Optional[tuple] = None,
    error_factory: Optional[Callable[[str], BaseException]] = None,
) -> Iterator[dict]:
    """Make the first `times` durable-I/O operations raise a TRANSIENT
    error before the real call runs, then succeed — a flaky GCS/NFS
    mount as seen from the retry seam (utils/retry.set_fault_hook), so
    the whole backoff ladder is exercised through the REAL call sites
    (checkpoint save/restore, jsonl opens, token-cache reads) without
    monkeypatching `builtins.open`. `ops` filters to op-name prefixes
    (e.g. ("checkpoint",) or ("data",)). Yields {'calls', 'raised'}."""
    from luminaai_tpu_torch.utils import retry as _retry

    if error_factory is None:
        def error_factory(op):
            return _retry.TransientIOError(
                f"injected transient storage fault ({op})"
            )

    stats = {"calls": 0, "raised": 0}

    def hook(op: str) -> None:
        stats["calls"] += 1
        if ops is not None and not any(op.startswith(p) for p in ops):
            return
        if stats["raised"] < times:
            stats["raised"] += 1
            raise error_factory(op)

    prev = _retry.set_fault_hook(hook)
    try:
        yield stats
    finally:
        _retry.set_fault_hook(prev)


def bitflip_checkpoint(checkpoint_dir, step: int) -> str:
    """Flip ONE byte mid-file in the step's largest state file WITHOUT
    changing its size — silent bit corruption: the file still loads
    where the byte is a tensor's, every size check passes, and only the
    sha256 integrity manifest can tell. Returns the damaged file's path;
    raises if the step (or something to flip) does not exist."""
    from luminaai_tpu_torch.training.checkpoint import (
        MANIFEST_NAME,
        STATE_NAME,
    )

    step_dir = Path(checkpoint_dir) / str(step)
    if not step_dir.is_dir():
        raise FileNotFoundError(f"no checkpoint step dir {step_dir}")
    candidates = [
        f for f in sorted(step_dir.rglob("*"))
        if f.is_file() and f.name != MANIFEST_NAME
        and not f.name.endswith(".tmp") and f.stat().st_size > 0
    ]
    # Prefer the tensor bytes: a flipped metadata byte often breaks the
    # parse (loud), a flipped shard byte changes a weight (silent).
    state_files = [f for f in candidates if f.name == STATE_NAME]
    pool = state_files or candidates
    if not pool:
        raise RuntimeError(f"nothing to bitflip under {step_dir}")
    target = max(pool, key=lambda f: f.stat().st_size)
    mid = target.stat().st_size // 2
    with target.open("r+b") as fh:
        fh.seek(mid)
        byte = fh.read(1)
        fh.seek(mid)
        fh.write(bytes([byte[0] ^ 0xFF]))
    logger.warning("bitflipped %s at offset %d", target, mid)
    return str(target)


def torn_manifest(checkpoint_dir, step: int) -> str:
    """Truncate the step's integrity manifest halfway — the torn-write
    artifact of a writer killed mid-rename-less flush. Verification
    must classify it as corruption (walk back), never as 'no manifest,
    proceed unverified'. Returns the manifest path."""
    from luminaai_tpu_torch.training.checkpoint import MANIFEST_NAME

    m = Path(checkpoint_dir) / str(step) / MANIFEST_NAME
    if not m.is_file():
        raise FileNotFoundError(f"no manifest at {m}")
    data = m.read_bytes()
    m.write_bytes(data[: max(1, len(data) // 2)])
    logger.warning("tore manifest %s to %d bytes", m, max(1, len(data) // 2))
    return str(m)


def kill_replica(replica) -> None:
    """Kill one serving replica the unclean way. A subprocess replica
    (anything with a .pid) gets a real SIGKILL — mid-stream sockets are
    severed with no FIN-and-drain courtesy. An in-process replica (a
    ThreadingHTTPServer, or anything with an .httpd) has its listening
    socket closed immediately, so every NEW connection is refused like a
    dead host's would be; in-flight handler threads keep their already-
    accepted sockets (in-process tests drive mid-stream death through
    the router's transport seam instead, and the multi-process smoke
    exercises the real-SIGKILL shape end to end)."""
    pid = getattr(replica, "pid", None)
    if pid is not None:
        os.kill(int(pid), _signal.SIGKILL)
        return
    httpd = getattr(replica, "httpd", replica)
    try:
        httpd.socket.close()  # refuse new connections NOW
    except OSError:
        pass
    # Unblock the accept loop without waiting on in-flight handlers
    # (shutdown() joins the poll loop; a fault injector must not).
    threading.Thread(target=httpd.shutdown, daemon=True).start()
    logger.warning("killed in-process replica on %s",
                   getattr(httpd, "server_address", "?"))


@contextlib.contextmanager
def replica_5xx_burst(server, times: int = 5,
                      status: int = 500) -> Iterator[dict]:
    """Make one ChatServer's next `times` generation requests (JSON and
    SSE alike) answer `status` before any model work — the flapping-
    dependency shape a fronting router's circuit breaker must absorb:
    the burst opens the breaker, the half-open probe after the cooldown
    finds the burst exhausted and closes it. Yields
    {'calls', 'failed'}."""
    stats = {"calls": 0, "failed": 0}
    orig_handle = server.handle
    orig_stream = server.start_stream

    def handle(method, path, body, token, request_id=None):
        if method == "POST" and path in ("/v1/generate", "/v1/chat"):
            stats["calls"] += 1
            if stats["failed"] < times:
                stats["failed"] += 1
                return status, {"error": "injected replica fault"}
        return orig_handle(method, path, body, token,
                           request_id=request_id)

    def start_stream(path, body, token, request_id=None):
        stats["calls"] += 1
        if stats["failed"] < times:
            stats["failed"] += 1
            return (status, {"error": "injected replica fault"}), None
        return orig_stream(path, body, token, request_id=request_id)

    server.handle = handle
    server.start_stream = start_stream
    try:
        yield stats
    finally:
        _restore(server, "handle", handle, orig_handle)
        _restore(server, "start_stream", start_stream, orig_stream)


@contextlib.contextmanager
def slow_replica(server_or_engine, delay_s: float = 0.2) -> Iterator[dict]:
    """Inflate every decode tick on ONE replica's engine — the slow-
    replica fleet shape hedged dispatch exists for: the affine target
    still answers, just late, so only a hedge (not a failover) recovers
    the tail. Wraps the engine's generate / generate_batch /
    generate_stream; pass a ChatServer or the engine itself. Yields
    {'calls'}."""
    engine = getattr(server_or_engine, "engine", server_or_engine)
    stats = {"calls": 0}
    wrapped = []

    def _wrap(name):
        original = getattr(engine, name, None)
        if original is None:
            return
        if name == "generate_stream":
            def wrapper(*args, **kwargs):
                stats["calls"] += 1
                for ev in original(*args, **kwargs):
                    time.sleep(delay_s)
                    yield ev
        else:
            def wrapper(*args, **kwargs):
                stats["calls"] += 1
                time.sleep(delay_s)
                return original(*args, **kwargs)
        setattr(engine, name, wrapper)
        wrapped.append((name, wrapper, original))

    for name in ("generate", "generate_batch", "generate_stream"):
        _wrap(name)
    try:
        yield stats
    finally:
        for name, wrapper, original in wrapped:
            _restore(engine, name, wrapper, original)


@contextlib.contextmanager
def drop_page_pulls(client, times: int = 0) -> Iterator[dict]:
    """Make a PageShareClient's page fetches fail with a connection
    error — the dead/unreachable owner shape the remote-hit admission
    must degrade from: the pull books a failure, the admission falls
    back to local prefill, and the client sees nothing. `times=0`
    drops every fetch; `times=N` drops the first N then passes
    through. Yields {'calls', 'dropped'}."""
    stats = {"calls": 0, "dropped": 0}
    original = client.fetch_page

    def wrapper(owner_url, key, timeout_s=None):
        stats["calls"] += 1
        if times == 0 or stats["dropped"] < times:
            stats["dropped"] += 1
            # Book the failure through the client's own accounting so
            # serve_prefix_remote_pull_failures_total still increments.
            client._observe_pull(key, owner_url, client._clock(),
                                 ok=False, nbytes=0)
            raise OSError("injected page pull drop")
        return original(owner_url, key, timeout_s=timeout_s)

    client.fetch_page = wrapper
    try:
        yield stats
    finally:
        _restore(client, "fetch_page", wrapper, original)


@contextlib.contextmanager
def slow_page_pulls(client, delay_s: float = 0.5) -> Iterator[dict]:
    """Stall every page fetch `delay_s` before it runs — the congested/
    half-dead owner shape the transfer deadline exists for: with
    delay_s above the client's timeout budget, the pull chain runs out
    of deadline partway and the admission degrades to local prefill
    for the rest. Yields {'calls'}."""
    stats = {"calls": 0}
    original = client.fetch_page

    def wrapper(owner_url, key, timeout_s=None):
        stats["calls"] += 1
        time.sleep(delay_s)
        return original(owner_url, key, timeout_s=timeout_s)

    client.fetch_page = wrapper
    try:
        yield stats
    finally:
        _restore(client, "fetch_page", wrapper, original)


@contextlib.contextmanager
def slow_decode(decoder, delay_s: float = 0.2) -> Iterator[dict]:
    """Slow/stuck-lane injector: every decode_step stalls `delay_s`, so a
    serving request with a deadline goes overdue mid-decode and the
    scheduler's eviction path fires. Yields {'steps': n}."""
    stats = {"steps": 0}
    original = decoder.decode_step

    def wrapper(*args, **kwargs):
        stats["steps"] += 1
        time.sleep(delay_s)
        return original(*args, **kwargs)

    decoder.decode_step = wrapper
    try:
        yield stats
    finally:
        _restore(decoder, "decode_step", wrapper, original)
