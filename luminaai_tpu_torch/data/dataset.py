"""Datasets: jsonl conversations, memmap token cache, packed batches,
prefetching loader (the port's copy of luminaai_tpu/data/dataset.py; plain
numpy, so the same files, seeds and cursors give the JAX package's
batches bit for bit).

  - The token store is a flat int32 memmap + offset table (built once,
    mmap'd thereafter); batch assembly is the native C++ packer
    (native/dataloader.cpp) with a bit-identical numpy version: one
    packer call per batch instead of DataLoader workers.
  - Batches are [batch, seq] numpy arrays; the trainer moves them to the
    card. The multi-process shard arguments (process_index,
    process_count) are kept for the multi-GPU slice.
  - Prefetch is a background thread keeping `prefetch` batches ready.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.data.tokenizer import ConversationTokenizer
from luminaai_tpu_torch.native import pack_batch, shuffle_indices
from luminaai_tpu_torch.utils.retry import RetryPolicy, io_call

logger = logging.getLogger(__name__)

CACHE_VERSION = 1

# -- degraded-mode loading (docs/resilience.md "Durable I/O") ---------------
# A corrupt or truncated record is quarantined — counted, flight-evented,
# skipped — and the run continues; a quarantine RATE above the fence
# aborts, so silent data loss can't masquerade as health. Events are
# capped per reader so a garbage file can't flood the flight ring.
QUARANTINE_MIN_RECORDS = 20  # fence only judges after this many records
_QUARANTINE_EVENT_CAP = 16   # per-reader flight-event budget


class DataCorruptionError(RuntimeError):
    """Corrupt data encountered with quarantine off, or the quarantine
    rate crossed the fence (the stream is rotten, not merely scuffed)."""


class TokenCacheError(RuntimeError):
    """A TokenCache failed open-time consistency validation. The message
    says what to do; downstream index crashes no longer speak for it."""


def _quarantine_counter():
    from luminaai_tpu_torch.monitoring.telemetry import get_registry

    return get_registry().counter(
        "data_records_quarantined_total",
        "Corrupt/truncated data records skipped by degraded-mode "
        "loading, by bounded reason",
        labelnames=("reason",),
    )


def _quarantine_event(**fields) -> None:
    try:
        from luminaai_tpu_torch.monitoring.events import get_recorder

        get_recorder().emit("data_quarantine", **fields)
    except Exception:  # pragma: no cover - telemetry never kills loading
        logger.debug("data_quarantine event emit failed", exc_info=True)


# ---------------------------------------------------------------------------
# Token cache (memmap)
# ---------------------------------------------------------------------------
class TokenCache:
    """Flat token stream + document offsets on disk.

    Files: <stem>.tokens.bin (int32), <stem>.offsets.npy (int64 n+1),
    <stem>.meta.json. Build once from any doc iterator; reopen is mmap-fast
    (ref dataset caching + memmap fast path).
    """

    def __init__(self, stem: str):
        self.stem = Path(stem)
        self.tokens_path = self.stem.with_suffix(".tokens.bin")
        self.offsets_path = self.stem.with_suffix(".offsets.npy")
        self.meta_path = self.stem.with_suffix(".meta.json")
        self.tokens: Optional[np.ndarray] = None
        self.offsets: Optional[np.ndarray] = None
        self.meta: Dict[str, Any] = {}

    def exists(self) -> bool:
        return (
            self.tokens_path.exists()
            and self.offsets_path.exists()
            and self.meta_path.exists()
        )

    def build(
        self, docs: Iterator[Sequence[int]], meta: Optional[Dict] = None
    ) -> "TokenCache":
        self.stem.parent.mkdir(parents=True, exist_ok=True)
        offsets = [0]
        n = 0
        with self.tokens_path.open("wb") as f:
            for doc in docs:
                arr = np.asarray(doc, dtype=np.int32)
                arr.tofile(f)
                n += arr.size
                offsets.append(n)
        np.save(self.offsets_path, np.asarray(offsets, dtype=np.int64))
        self.meta = {
            "version": CACHE_VERSION,
            "n_docs": len(offsets) - 1,
            "n_tokens": n,
            **(meta or {}),
        }
        self.meta_path.write_text(json.dumps(self.meta))
        return self.open()

    def open(self, validate: bool = True) -> "TokenCache":
        """mmap the cache files (through the durable-I/O retry layer)
        and validate their mutual consistency: a truncated `.tokens`
        file or stale offset table used to surface as an index crash
        deep inside the packer; now it is ONE actionable error here."""
        self.meta = json.loads(
            io_call(self.meta_path.read_text, op="data_open")
        )
        try:
            self.tokens = io_call(
                np.memmap, self.tokens_path, dtype=np.int32, mode="r",
                op="data_open",
            )
        except ValueError as e:
            # A byte count that is not a multiple of int32 is itself the
            # truncation evidence — same actionable error, not numpy's.
            # (A zero-byte file is a different defect: an empty or
            # failed build, not a truncated one.)
            size = self.tokens_path.stat().st_size
            detail = (
                ".tokens.bin is empty (zero tokens — empty or failed "
                "build)"
                if size == 0
                else f".tokens.bin size {size} is not a whole number of "
                     f"int32 tokens ({e}) — truncated .tokens.bin"
            )
            raise TokenCacheError(
                f"token cache {self.stem} failed validation: {detail}; "
                f"delete {self.stem}.* and rebuild the cache "
                "(build_text_cache(..., rebuild=True))"
            ) from e
        self.offsets = io_call(np.load, self.offsets_path, op="data_open")
        if validate:
            self.validate()
        return self

    def validate(self) -> None:
        """Offsets/tokens/meta consistency; raises TokenCacheError with
        the repair instruction instead of letting a downstream packer
        index crash speak for the corruption."""
        problems = []
        off = self.offsets
        if off is None or getattr(off, "ndim", None) != 1 or len(off) < 1:
            problems.append("offset table empty or malformed")
        else:
            if int(off[0]) != 0:
                problems.append(f"first offset is {int(off[0])}, not 0")
            if len(off) > 1 and bool(np.any(np.diff(off) < 0)):
                problems.append("offset table not monotone nondecreasing")
            n_tok = int(self.tokens.size)
            if int(off[-1]) > n_tok:
                problems.append(
                    f"last offset {int(off[-1])} exceeds token count "
                    f"{n_tok} (truncated .tokens.bin)"
                )
            meta_docs = self.meta.get("n_docs")
            if meta_docs is not None and meta_docs != len(off) - 1:
                problems.append(
                    f"meta n_docs {meta_docs} != offset table's "
                    f"{len(off) - 1} (stale meta)"
                )
        if problems:
            raise TokenCacheError(
                f"token cache {self.stem} failed validation: "
                + "; ".join(problems)
                + f" — delete {self.stem}.* and rebuild the cache "
                "(build_text_cache(..., rebuild=True))"
            )

    @property
    def n_docs(self) -> int:
        return len(self.offsets) - 1

    @property
    def n_tokens(self) -> int:
        return int(self.offsets[-1])


# ---------------------------------------------------------------------------
# Conversation dataset (chat finetuning)
# ---------------------------------------------------------------------------
def read_jsonl(
    path: str,
    max_records: Optional[int] = None,
    quarantine: bool = True,
    max_quarantine_rate: float = 0.05,
    retry: Optional[RetryPolicy] = None,
) -> Iterator[Dict]:
    """jsonl records with degraded-mode loading (docs/resilience.md).

    Opens through the durable-I/O retry layer and reads BINARY: a
    truncated trailing line — the normal artifact of a preempted writer,
    which used to crash this reader when the cut landed mid-UTF-8
    sequence — is always skipped with a counter. Mid-file corruption is
    quarantined (counter + `data_quarantine` flight event, stream
    continues) while `quarantine` is on, else raises
    DataCorruptionError. A quarantine rate above `max_quarantine_rate`
    (judged after QUARANTINE_MIN_RECORDS) aborts the read either way:
    past the fence the file is rotten, and silently training on its
    survivors would masquerade as health.

    JsonlIndex.record mirrors this contract for random access (it
    cannot stream through here) — a contract change must land in both
    places."""
    f = io_call(open, path, "rb", op="data_open", policy=retry)
    good = bad = events = 0
    with f:
        for i, raw in enumerate(f):
            if max_records is not None and i >= max_records:
                break
            line = raw.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError as e:  # JSONDecodeError / UnicodeDecodeError
                bad += 1
                truncated_tail = not raw.endswith(b"\n")
                reason = (
                    "truncated_tail" if truncated_tail else "bad_record"
                )
                if not truncated_tail and not quarantine:
                    raise DataCorruptionError(
                        f"{path}:{i + 1}: corrupt jsonl record ({e}); "
                        "enable config.data_quarantine to skip corrupt "
                        "records, or repair the file"
                    ) from e
                _quarantine_counter().labels(reason=reason).inc()
                if events < _QUARANTINE_EVENT_CAP:
                    events += 1
                    _quarantine_event(
                        path=str(path), line=i + 1, reason=reason,
                    )
                logger.warning(
                    "%s:%d %s skipped (%d quarantined so far)",
                    path, i + 1, reason, bad,
                )
                total = good + bad
                if (
                    not truncated_tail
                    and total >= QUARANTINE_MIN_RECORDS
                    and bad / total > max_quarantine_rate
                ):
                    raise DataCorruptionError(
                        f"{path}: quarantine rate {bad}/{total} exceeds "
                        f"the {max_quarantine_rate:.0%} fence — refusing "
                        "to silently train on the survivors of a rotten "
                        "file; repair or regenerate it"
                    ) from e
                continue
            good += 1
            yield rec


class JsonlIndex:
    """mmap-backed random access to jsonl records.

    The native newline scanner (native.index_lines, C memchr off the GIL)
    builds a byte-offset table once; record(i) then seeks and parses one
    line, so multi-GB corpora support shuffled access at O(1) memory —
    the piece the reference delegated to Arrow's memory-mapped tables
    (ref core/dataset.py FastStreamingBaseTrainingDataset role).
    """

    def __init__(
        self,
        path: str,
        quarantine: bool = True,
        max_quarantine_rate: float = 0.05,
    ):
        import mmap

        self.path = path
        # Same degraded-mode contract as read_jsonl: quarantine off makes
        # a corrupt record fatal, and a quarantine rate past the fence
        # aborts either way (docs/resilience.md "Durable I/O").
        self.quarantine = quarantine
        self.max_quarantine_rate = max_quarantine_rate
        self._good = 0
        self._bad = 0
        self._f = io_call(open, path, "rb", op="data_open")
        size = os.fstat(self._f.fileno()).st_size
        self._mm = (
            mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
            if size else b""
        )
        from luminaai_tpu_torch.native import index_lines

        self.starts = index_lines(self._mm)
        self._size = size

    def __len__(self) -> int:
        return len(self.starts)

    def raw(self, i: int) -> bytes:
        beg = int(self.starts[i])
        end = (
            int(self.starts[i + 1]) if i + 1 < len(self.starts) else self._size
        )
        return self._mm[beg:end]

    def record(self, i: int) -> Optional[Dict]:
        raw = self.raw(i)
        line = raw.strip()
        if not line:
            return None
        try:
            rec = json.loads(line)
        except ValueError as e:  # JSONDecodeError / UnicodeDecodeError
            # Same contract as read_jsonl: a truncated trailing line
            # (last record, no final newline — the preempted-writer
            # artifact) is ALWAYS skipped; only mid-file corruption is
            # fatal with quarantine off or counted against the fence.
            if i == len(self.starts) - 1 and not raw.endswith(b"\n"):
                _quarantine_counter().labels(
                    reason="truncated_tail"
                ).inc()
                logger.warning(
                    "%s: truncated trailing record %d skipped",
                    self.path, i,
                )
                return None
            if not self.quarantine:
                raise DataCorruptionError(
                    f"{self.path}: corrupt jsonl record {i} ({e}); "
                    "enable config.data_quarantine to skip corrupt "
                    "records, or repair the file"
                ) from e
            self._bad += 1
            _quarantine_counter().labels(reason="bad_record").inc()
            logger.warning("%s: bad json at record %d skipped", self.path, i)
            total = self._good + self._bad
            if (
                total >= QUARANTINE_MIN_RECORDS
                and self._bad / total > self.max_quarantine_rate
            ):
                raise DataCorruptionError(
                    f"{self.path}: quarantine rate {self._bad}/{total} "
                    f"exceeds the {self.max_quarantine_rate:.0%} fence — "
                    "refusing to silently train on the survivors of a "
                    "rotten file; repair or regenerate it"
                ) from e
            return None
        self._good += 1
        return rec

    def iter_shuffled(self, seed: int) -> Iterator[Dict]:
        from luminaai_tpu_torch.native import shuffle_indices

        for i in shuffle_indices(len(self.starts), seed):
            rec = self.record(int(i))
            if rec is not None:
                yield rec

    def close(self) -> None:
        if self._mm:
            self._mm.close()
        self._f.close()


class ConversationDataset:
    """jsonl conversations → fixed-length tokenized samples w/ loss weights
    (ref FastConversationDataset, core/dataset.py:337).

    Eager for small files; `streaming_threshold_gb` switches to on-the-fly
    iteration (ref FastStreamingBaseTrainingDataset, :241).
    """

    def __init__(
        self,
        data_path: str,
        tokenizer: ConversationTokenizer,
        config: Config,
        split: str = "train",
    ):
        self.path = data_path
        self.tokenizer = tokenizer
        self.config = config
        self.split = split
        size_gb = Path(data_path).stat().st_size / 1e9
        self.streaming = size_gb > config.streaming_threshold_gb
        self.samples: List[Dict[str, np.ndarray]] = []
        self.skipped = 0
        if not self.streaming:
            self._load_eager()

    def _read(self) -> Iterator[Dict]:
        """This dataset's jsonl stream with the config's degraded-mode
        loading switches applied."""
        return read_jsonl(
            self.path,
            quarantine=getattr(self.config, "data_quarantine", True),
            max_quarantine_rate=getattr(
                self.config, "data_quarantine_max_rate", 0.05
            ),
            retry=RetryPolicy.from_config(self.config),
        )

    def _load_eager(self) -> None:
        for conv in self._read():
            enc = self.tokenizer.encode_conversation(
                conv,
                max_length=self.config.seq_length,
                pad_to_length=self.config.seq_length,
            )
            if enc is None:
                self.skipped += 1
                continue
            self.samples.append(enc)
        logger.info(
            "%s: %d conversations (%d skipped)",
            self.path, len(self.samples), self.skipped,
        )

    def __len__(self) -> int:
        if self.streaming:
            raise TypeError("streaming dataset has no length")
        return len(self.samples)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self.samples[idx]

    def iter_samples(
        self, shuffle_seed: Optional[int] = None
    ) -> Iterator[Dict[str, np.ndarray]]:
        if not self.streaming:
            yield from self.samples
            return
        if shuffle_seed is not None:
            # Shuffled streaming: mmap + native newline index gives O(1)-
            # memory random access instead of sequential-only epochs.
            index = JsonlIndex(
                self.path,
                quarantine=getattr(self.config, "data_quarantine", True),
                max_quarantine_rate=getattr(
                    self.config, "data_quarantine_max_rate", 0.05
                ),
            )
            try:
                convs: Iterator[Dict] = index.iter_shuffled(shuffle_seed)
                for conv in convs:
                    enc = self.tokenizer.encode_conversation(
                        conv,
                        max_length=self.config.seq_length,
                        pad_to_length=self.config.seq_length,
                    )
                    if enc is not None:
                        yield enc
            finally:
                index.close()
            return
        for conv in self._read():
            enc = self.tokenizer.encode_conversation(
                conv,
                max_length=self.config.seq_length,
                pad_to_length=self.config.seq_length,
            )
            if enc is not None:
                yield enc

    def stats(self) -> Dict[str, Any]:
        if self.streaming:
            return {"streaming": True, "path": self.path}
        lens = [int(s["loss_mask"].sum()) for s in self.samples]
        return {
            "streaming": False,
            "n_samples": len(self.samples),
            "skipped": self.skipped,
            "mean_assistant_tokens": float(np.mean(lens)) if lens else 0.0,
        }


# ---------------------------------------------------------------------------
# Packed dataset (base training over a TokenCache)
# ---------------------------------------------------------------------------
class PackedDataset:
    """Contiguous packed batches from a TokenCache via the native packer
    (ref FastBaseTrainingDataset chunking, :118).

    Multi-process: pass `process_index`/`process_count` and each process
    reads ONLY its own document shard (strided over the shared doc order)
    and yields LOCAL [batch_size/process_count, S] batches; no process
    ever materializes (or even reads) another process's rows. Hosts stay in lockstep via a metadata-only
    batch-count cap computed identically on every host; a host whose
    shard packs short wraps around its own shard rather than desyncing
    the collective.
    """

    def __init__(
        self,
        cache: TokenCache,
        batch_size: int,
        seq_length: int,
        pad_id: int = 0,
        eos_id: int = -1,
        shuffle_seed: Optional[int] = None,
        use_native: bool = True,
        split_docs: bool = True,
        process_index: int = 0,
        process_count: int = 1,
    ):
        if cache.tokens is None:
            cache.open()
        if not 0 <= process_index < process_count:
            raise ValueError(
                f"process_index {process_index} not in [0, {process_count})"
            )
        if batch_size % process_count != 0:
            raise ValueError(
                f"global batch {batch_size} not divisible by "
                f"process_count {process_count}"
            )
        self.cache = cache
        self.batch_size = batch_size
        self.seq_length = seq_length
        self.pad_id = pad_id
        self.eos_id = eos_id
        self.shuffle_seed = shuffle_seed
        self.use_native = use_native
        # pack_sequences=False semantics: a document never straddles rows
        # (truncate-to-row instead of contiguous-stream packing).
        self.split_docs = split_docs
        self.process_index = process_index
        self.process_count = process_count
        self.local_batch = batch_size // process_count
        self.difficulty: Optional[float] = None
        # Exact-resume position: epoch = completed passes, batch_index =
        # batches yielded in the pass currently underway. load_state_dict
        # arms a one-shot fast-forward applied by the next __iter__.
        self._epoch = 0
        self._batch_index = 0
        self._resume_skip = 0

    def batches_per_epoch(self) -> int:
        per_batch = self.batch_size * self.seq_length
        return max(1, self.cache.n_tokens // per_batch)

    def set_difficulty(self, difficulty: float) -> None:
        """Length-quantile curriculum (the orchestrator's consumer of the
        AdaptiveCurriculum signal): difficulty d admits documents up to
        the d-quantile of the doc length distribution, short docs first.
        Deterministic from shared metadata, so multi-process shards stay
        disjoint and in lockstep. Applies to the NEXT epoch's iteration:
        __iter__ snapshots the value once, so the lockstep cap and every
        wrap re-walk of a running epoch use the same filter."""
        self.difficulty = float(np.clip(difficulty, 0.0, 1.0))

    # Sentinel: helpers read self.difficulty unless an iterator passes its
    # epoch snapshot explicitly.
    _LIVE = object()

    def _global_order(self, difficulty=_LIVE) -> np.ndarray:
        """The one doc order every host derives identically (shared seed),
        so the per-host strides below are disjoint + exhaustive; with a
        difficulty below 1, only the docs up to its length quantile."""
        if difficulty is PackedDataset._LIVE:
            difficulty = self.difficulty
        n = self.cache.n_docs
        if self.shuffle_seed is not None:
            order = np.asarray(shuffle_indices(n, self.shuffle_seed))
        else:
            order = np.arange(n)
        if difficulty is not None and difficulty < 1.0:
            doclens = np.diff(self.cache.offsets)
            cutoff = np.quantile(doclens, max(difficulty, 0.05))
            keep = doclens[order] <= cutoff
            if keep.any():  # never filter down to an empty epoch
                order = order[keep]
        return order

    def _doc_order(self, host: int, wrap: int = 0,
                   difficulty=_LIVE) -> np.ndarray:
        """Doc ids host `host` walks this epoch (its stride of the global
        order). `wrap` permutes the host's OWN shard for a re-walk after
        an early pack-out — never a different global order, so a wrapped
        host still reads only its shard, and the re-walk isn't a
        byte-identical replay."""
        shard = self._global_order(difficulty)[host::self.process_count]
        if wrap and len(shard) > 1:
            perm = np.asarray(shuffle_indices(
                len(shard), (self.shuffle_seed or 0) + 7919 * wrap
            ))
            shard = shard[perm]
        return shard

    def _lockstep_batches(self, difficulty=_LIVE) -> int:
        """Per-epoch batch count every host agrees on, from metadata only:
        min over hosts of (shard tokens // local batch tokens). Computed
        identically everywhere (shared offsets table + shared seed), so
        no communication is needed to stay in lockstep."""
        doclens = np.diff(self.cache.offsets)
        order = self._global_order(difficulty)
        per_batch = self.local_batch * self.seq_length
        return min(
            int(doclens[order[q::self.process_count]].sum()) // per_batch
            for q in range(self.process_count)
        )

    # -- exact-resume state (docs/resilience.md) -------------------------
    def state_dict(self) -> Dict[str, Any]:
        """Checkpointable iteration position. Everything that determines
        the batch stream is here: the shared shuffle seed, the difficulty
        (the curriculum filter changes the doc order), and the (epoch,
        batch_index) cursor. Restoring it and re-iterating yields the
        exact continuation of the interrupted stream."""
        return {
            "kind": "packed",
            "epoch": self._epoch,
            "batch_index": self._batch_index,
            "shuffle_seed": self.shuffle_seed,
            "difficulty": self.difficulty,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore a `state_dict()` position. The next `__iter__` fast-
        forwards by packing-and-discarding `batch_index` batches — O(k)
        numpy work, no tokens trained twice or skipped — then streams the
        remainder of that epoch bitwise-identically."""
        if state.get("kind", "packed") != "packed":
            raise ValueError(
                f"state kind {state.get('kind')!r} is not a PackedDataset "
                "state"
            )
        if "shuffle_seed" in state:
            self.shuffle_seed = state["shuffle_seed"]
        if state.get("difficulty") is not None:
            self.set_difficulty(float(state["difficulty"]))
        else:
            self.difficulty = None
        self._epoch = int(state.get("epoch", 0))
        self._resume_skip = int(state.get("batch_index", 0))
        self._batch_index = self._resume_skip

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        skip = self._resume_skip
        self._resume_skip = 0
        self._batch_index = 0
        n = 0
        for b in self._iter_epoch():
            n += 1
            if n <= skip:
                continue  # fast-forward: re-pack, don't re-serve
            self._batch_index = n
            yield b
        self._epoch += 1
        self._batch_index = 0

    def _iter_epoch(self) -> Iterator[Dict[str, np.ndarray]]:
        # Snapshot once: a mid-epoch set_difficulty must not change the
        # wrap re-walk order after the lockstep cap was computed from the
        # old one (a host would run short and desync the others).
        difficulty = self.difficulty
        filtered = difficulty is not None and difficulty < 1.0
        if (self.process_count == 1 and self.shuffle_seed is None
                and not filtered):
            # Fast path: sequential cursor straight over the memmap, no
            # per-doc copies.
            offsets = self.cache.offsets
            tokens = self.cache.tokens
            doc, tok = 0, 0
            n_docs = len(offsets) - 1
            while doc < n_docs:
                out, mask, doc, tok = pack_batch(
                    tokens, offsets, doc,
                    self.batch_size, self.seq_length,
                    pad_id=self.pad_id, eos_id=self.eos_id,
                    split_docs=self.split_docs, start_token=tok,
                    use_native=self.use_native,
                )
                if mask.sum() == 0:
                    break
                yield {
                    "input_ids": out,
                    "loss_mask": mask.astype(np.float32),
                }
            return
        if self.process_count == 1:
            yield from self._iter_docs(
                self._doc_order(0, difficulty=difficulty), self.batch_size
            )
            return
        # Multi-host: fixed agreed batch count; wrap own shard if it packs
        # short (possible in truncate mode, where row-boundary waste makes
        # the metadata estimate an upper bound).
        cap = self._lockstep_batches(difficulty)
        count = 0
        wrap = 0
        while count < cap:
            produced = False
            order = self._doc_order(self.process_index, wrap,
                                    difficulty=difficulty)
            for b in self._iter_docs(order, self.local_batch):
                produced = True
                yield b
                count += 1
                if count >= cap:
                    return
            wrap += 1
            if not produced:
                return  # empty shard: cap was 0 anyway

    def _iter_docs(
        self, order: np.ndarray, rows: int
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Walk `order`'s docs through a sliding window of per-doc slices
        copied from the memmap — never materializing the corpus (the old
        gather-everything path OOM'd on multi-GB caches). The window holds
        just enough docs for one batch plus the carry of a split doc, so
        peak memory is O(rows·seq + longest doc)."""
        offsets = self.cache.offsets
        tokens = self.cache.tokens
        need = rows * (self.seq_length + 1)
        buf_docs: List[np.ndarray] = []
        buf_tokens = 0
        pi = 0
        while True:
            while buf_tokens < need and pi < len(order):
                d = int(order[pi])
                pi += 1
                # No retry wrap here: a storage fault on a memmap
                # page-in surfaces as SIGBUS (process death), never a
                # catchable OSError, so a retry could not fire — and
                # this is the packing hot loop. The retry layer covers
                # the POSIX reads (cache open, offsets, meta).
                arr = np.asarray(tokens[offsets[d]:offsets[d + 1]])
                if arr.size:
                    buf_docs.append(arr)
                    buf_tokens += arr.size
            if not buf_docs:
                break
            cat = (
                np.concatenate(buf_docs) if len(buf_docs) > 1 else buf_docs[0]
            )
            local_offsets = np.concatenate(
                [[0], np.cumsum([a.size for a in buf_docs])]
            ).astype(np.int64)
            out, mask, next_doc, next_tok = pack_batch(
                cat, local_offsets, 0,
                rows, self.seq_length,
                pad_id=self.pad_id, eos_id=self.eos_id,
                split_docs=self.split_docs, start_token=0,
                use_native=self.use_native,
            )
            if mask.sum() == 0:
                break
            yield {
                "input_ids": out,
                "loss_mask": mask.astype(np.float32),
            }
            # Carry unconsumed docs (the tail of a split doc re-enters as a
            # fresh doc head, preserving eos-at-doc-end semantics).
            rest: List[np.ndarray] = []
            if next_doc < len(buf_docs):
                head = buf_docs[next_doc][next_tok:]
                if head.size:
                    rest.append(head)
                rest.extend(buf_docs[next_doc + 1:])
            buf_docs = rest
            buf_tokens = sum(a.size for a in buf_docs)
            if not buf_docs and pi >= len(order):
                break


# ---------------------------------------------------------------------------
# Prefetching loader
# ---------------------------------------------------------------------------
class PrefetchLoader:
    """Background-thread prefetch of host batches (ref FastDataLoader
    prefetch, core/dataset.py:807). Device placement stays with the caller
    (Trainer._to_device).

    Exact-resume: `state_dict()/load_state_dict()` checkpoint the epoch
    cursor (and the source's own state when it has one); after a load,
    the next iteration replays the stored epoch's iterator and discards
    the first `batch_index` batches, so a deterministic `batch_fn` —
    every loader in this repo — continues the interrupted stream with no
    batch replayed or dropped. `batch_fn` may take an `epoch` argument
    (per-epoch shuffles stay reproducible across a restart); zero-arg
    callables keep working.
    """

    _DONE = object()

    def __init__(
        self,
        batch_fn: Callable[..., Iterator[Dict[str, np.ndarray]]],
        prefetch: int = 2,
        source: Optional[Any] = None,
    ):
        self.batch_fn = batch_fn
        self.prefetch = max(1, prefetch)
        # The dataset behind batch_fn: its own state (shuffle seed,
        # difficulty) rides in state_dict, and curriculum signals
        # (set_difficulty) are forwarded to it.
        self.source = source
        self._epoch = 0  # next epoch to hand out
        self._consuming = 0  # epoch the current/most recent iterator serves
        self._yielded = 0  # batches yielded to the consumer this epoch
        self._resume_skip = 0
        # Wall clock burned replaying (skipping) already-trained batches
        # after a resume — the goodput ledger's `resume_replay` cause.
        # Accumulates across epochs; the trainer drains it via
        # consume_resume_replay_seconds() (docs/observability.md).
        self._resume_replay_s = 0.0
        import inspect

        try:
            sig = inspect.signature(batch_fn)
            self._epoch_aware = any(
                p.name == "epoch"
                or p.kind is inspect.Parameter.VAR_POSITIONAL
                for p in sig.parameters.values()
            )
        except (TypeError, ValueError):  # builtins / C callables
            self._epoch_aware = False

    def set_difficulty(self, difficulty: float) -> bool:
        """Forward a curriculum difficulty to the source; False when it
        has no curriculum."""
        target = getattr(self.source, "set_difficulty", None)
        if callable(target):
            target(difficulty)
            return True
        return False

    def consume_resume_replay_seconds(self) -> float:
        """Drain the wall clock spent fast-forwarding past resumed
        batches since the last call (0.0 when no resume replay ran).
        The trainer reattributes it from data_wait to resume_replay in
        the goodput ledger."""
        s, self._resume_replay_s = self._resume_replay_s, 0.0
        return s

    # -- exact-resume state (docs/resilience.md) -------------------------
    def state_dict(self) -> Dict[str, Any]:
        """Loader position + the source's own state (seed and difficulty
        for PackedDataset). epoch/batch_index count batches YIELDED to the
        consumer, so a standalone round-trip continues the stream
        exactly. The trainer still overwrites them with its
        trained-batch cursor at save time — its device prefetch consumes
        one batch ahead of what actually entered a step."""
        state: Dict[str, Any] = {
            "kind": "prefetch",
            "epoch": self._consuming,
            "batch_index": self._yielded,
        }
        src_sd = getattr(self.source, "state_dict", None)
        if callable(src_sd):
            src = dict(src_sd())
            # The loader's skip-based fast-forward supersedes the
            # source's cursor; keep only the stream-determining fields.
            src.pop("epoch", None)
            src.pop("batch_index", None)
            src.pop("kind", None)
            state["source"] = src
        return state

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._epoch = int(state.get("epoch", 0))
        self._consuming = self._epoch
        self._resume_skip = int(state.get("batch_index", 0))
        self._yielded = self._resume_skip
        src = state.get("source")
        src_ld = getattr(self.source, "load_state_dict", None)
        if src and callable(src_ld):
            src_ld(dict(src))

    def _start_epoch(self) -> Iterator[Dict[str, np.ndarray]]:
        """One epoch's host iterator; passes the epoch number to batch_fn
        when it accepts one (per-epoch reshuffles survive a restart)."""
        epoch = self._epoch
        self._epoch += 1
        self._consuming = epoch
        if self._epoch_aware:
            return self.batch_fn(epoch)
        return self.batch_fn()

    def __call__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.__iter__()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        error: List[BaseException] = []
        stop = threading.Event()
        host_iter = self._start_epoch()
        skip = self._resume_skip
        self._resume_skip = 0
        self._yielded = skip  # position within this epoch's stream

        def put(item) -> bool:
            # Bounded put that aborts when the consumer is gone, so an
            # abandoned iterator (early stop, rollback) can't strand the
            # worker blocked on a full queue with its file handle open.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in host_iter:
                    if not put(b):
                        return
            except BaseException as e:  # pragma: no cover - propagated below
                error.append(e)
            finally:
                put(self._DONE)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        t_replay0 = time.perf_counter() if skip > 0 else None

        def _bank_replay():
            # Bank the replay wall clock for the goodput ledger's
            # resume_replay cause — on the normal skip-exhausted
            # transition AND from the finally, so an epoch ending (or
            # the consumer abandoning the iterator) mid-replay doesn't
            # silently leave the time misattributed as data_wait.
            nonlocal t_replay0
            if t_replay0 is not None:
                self._resume_replay_s += time.perf_counter() - t_replay0
                t_replay0 = None

        try:
            while True:
                item = q.get()
                if item is self._DONE:
                    break
                if skip > 0:
                    # Resume fast-forward: these batches were consumed by
                    # the interrupted run before its checkpoint landed.
                    skip -= 1
                    if skip == 0:
                        _bank_replay()
                    continue
                self._yielded += 1
                yield item
            if error:
                raise error[0]
            # Epoch fully consumed: position is the start of the next one.
            self._consuming = self._epoch
            self._yielded = 0
        finally:
            _bank_replay()  # epoch ended / consumer gone mid-replay
            stop.set()
            t.join(timeout=5.0)


# ---------------------------------------------------------------------------
# Assembly helpers
# ---------------------------------------------------------------------------
def conversation_batches(
    dataset: ConversationDataset,
    batch_size: int,
    seed: int = 0,
    drop_last: bool = True,
    process_index: int = 0,
    process_count: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Group per-conversation samples into batches.

    Multi-host: `batch_size` stays the GLOBAL batch; host p yields LOCAL
    [batch_size/process_count, S] batches from its stride of the shared
    shuffled order. Batch
    counts are capped identically on every host, so collectives stay in
    lockstep. (Eager datasets still tokenize the full file on each host
    at load; the per-host win here is batch assembly + transfer, matching
    the ref's DistributedSampler granularity.)
    """
    if batch_size % process_count != 0:
        raise ValueError(
            f"global batch {batch_size} not divisible by process_count "
            f"{process_count}"
        )
    if not drop_last and process_count > 1:
        # Lockstep genuinely requires dropping the final partial round —
        # honoring drop_last=False would desync host batch counts.
        raise ValueError(
            "drop_last=False is incompatible with multi-host sharding"
        )
    local = batch_size // process_count
    if dataset.streaming:
        if process_count == 1:
            buf: List[Dict[str, np.ndarray]] = []
            # Streaming epochs shuffle too, via the mmap'd line index.
            for s in dataset.iter_samples(shuffle_seed=seed):
                buf.append(s)
                if len(buf) == batch_size:
                    yield _stack(buf)
                    buf = []
            if buf and not drop_last:
                yield _stack(buf)
            return
        # Multi-host streaming: no host knows the sample count up front,
        # so lockstep is guaranteed by round-buffering one GLOBAL batch
        # and yielding this host's rows — a round only counts when full,
        # so every host yields the identical number of batches.
        buf = []
        for s in dataset.iter_samples(shuffle_seed=seed):
            buf.append(s)
            if len(buf) == batch_size:
                yield _stack(
                    buf[process_index * local:(process_index + 1) * local]
                )
                buf = []
        return
    idx = shuffle_indices(len(dataset), seed)
    if process_count == 1:
        for i in range(0, len(idx) - batch_size + 1, batch_size):
            yield _stack([dataset[int(j)] for j in idx[i:i + batch_size]])
        return
    # Shared order, per-host stride; the shortest shard (= len//pc, since
    # strided shard sizes differ by <=1) caps every host at the same
    # batch count.
    shard = idx[process_index::process_count]
    n_batches = len(idx) // process_count // local
    for b in range(n_batches):
        rows = shard[b * local:(b + 1) * local]
        yield _stack([dataset[int(j)] for j in rows])


def _stack(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {
        k: np.stack([s[k] for s in samples]) for k in samples[0].keys()
    }


def build_text_cache(
    jsonl_path: str,
    cache_stem: str,
    tokenizer: ConversationTokenizer,
    text_key: str = "text",
    rebuild: bool = False,
    quarantine: bool = True,
    max_quarantine_rate: float = 0.05,
) -> TokenCache:
    """Tokenize a jsonl of {text_key: str} docs into a TokenCache."""
    cache = TokenCache(cache_stem)
    if cache.exists() and not rebuild:
        return cache.open()

    def docs():
        for rec in read_jsonl(
            jsonl_path, quarantine=quarantine,
            max_quarantine_rate=max_quarantine_rate,
        ):
            text = rec.get(text_key)
            if text:
                yield tokenizer.encode_text(text) + [tokenizer.eos_token_id]

    return cache.build(docs(), meta={"source": jsonl_path})
