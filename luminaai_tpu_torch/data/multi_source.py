"""Multi-source corpus pipeline: per-source cleaners + shard writers + blend.

Covers the reference multi_source_dataset.py (ref: Src/Main_Scripts/
multi_source_dataset.py — Wikipedia:277, Gutenberg:511, ArXiv:616,
StackOverflow:729, PubMed:852, OpenWebText:1012, PhilPapers:1125,
CC-News:1229 processors, each cleaning raw dumps into jsonl shards).
Split TPU-side into:

  - pure cleaners (offline-testable; the reference interleaves them with
    urllib downloads),
  - processors that turn a LOCAL dump/file into jsonl text shards
    (`create_dataset_files` parity) — network fetch is gated behind
    `allow_network` since training images typically have no egress,
  - `MultiSourcePipeline` that blends shard sets by weight into one
    TokenCache for PackedDataset (the reference concatenates files).

The port's copy of luminaai_tpu/data/multi_source.py: the blend draws
from np.random.RandomState(seed) as there, so both packages blend the
same record sequence; shard reads go through the port's read_jsonl and
the dedup hashes through its native FNV-1a binding.
"""

from __future__ import annotations

import html
import json
import logging
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from luminaai_tpu_torch.utils.retry import io_call

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Cleaners (pure text → text)
# ---------------------------------------------------------------------------
def clean_wiki_text(text: str) -> str:
    """MediaWiki markup → plain text (ref :316 clean_wiki_text)."""
    text = re.sub(r"\{\{[^{}]*\}\}", "", text)  # templates (one level deep,
    text = re.sub(r"\{\{[^{}]*\}\}", "", text)  # run twice for nesting)
    text = re.sub(r"\{\|.*?\|\}", "", text, flags=re.S)  # tables
    text = re.sub(r"\[\[(?:File|Image|Category):[^\]]*\]\]", "", text)
    text = re.sub(r"\[\[[^|\]]*\|([^\]]*)\]\]", r"\1", text)  # [[a|b]] → b
    text = re.sub(r"\[\[([^\]]*)\]\]", r"\1", text)  # [[a]] → a
    text = re.sub(r"\[https?://\S+\s+([^\]]*)\]", r"\1", text)
    text = re.sub(r"<ref[^>]*/>", "", text)
    text = re.sub(r"<ref[^>]*>.*?</ref>", "", text, flags=re.S)
    text = re.sub(r"<[^>]+>", "", text)  # remaining html
    text = re.sub(r"'{2,}", "", text)  # bold/italic quotes
    text = re.sub(r"^[=\s]*(.*?)[=\s]*$", r"\1", text, flags=re.M)  # headings
    text = html.unescape(text)
    text = re.sub(r"\n{3,}", "\n\n", text)
    return text.strip()


_GUTENBERG_START = re.compile(
    r"\*{3}\s*START OF (?:THE|THIS) PROJECT GUTENBERG[^\n]*\*{3}", re.I
)
_GUTENBERG_END = re.compile(
    r"\*{3}\s*END OF (?:THE|THIS) PROJECT GUTENBERG[^\n]*\*{3}", re.I
)


def clean_gutenberg_text(text: str) -> str:
    """Strip Project Gutenberg boilerplate (ref :552)."""
    m = _GUTENBERG_START.search(text)
    if m:
        text = text[m.end():]
    m = _GUTENBERG_END.search(text)
    if m:
        text = text[: m.start()]
    text = re.sub(r"\r\n", "\n", text)
    text = re.sub(r"\n{3,}", "\n\n", text)
    return text.strip()


def clean_html_text(text: str) -> str:
    """HTML → plain text (ref StackOverflow :775 clean_html)."""
    text = re.sub(r"<pre><code>(.*?)</code></pre>", r"\n```\n\1\n```\n",
                  text, flags=re.S)
    text = re.sub(r"<code>(.*?)</code>", r"`\1`", text, flags=re.S)
    text = re.sub(r"<[^>]+>", " ", text)
    text = html.unescape(text)
    text = re.sub(r"[ \t]{2,}", " ", text)
    text = re.sub(r"\n{3,}", "\n\n", text)
    return text.strip()


def clean_latex_abstract(text: str) -> str:
    """ArXiv abstract cleanup (ref :666 create_dataset_files inline)."""
    text = re.sub(r"\$+[^$]*\$+", " [MATH] ", text)
    text = re.sub(r"\\[a-zA-Z]+\{([^}]*)\}", r"\1", text)
    text = re.sub(r"\\[a-zA-Z]+", " ", text)
    text = re.sub(r"\s{2,}", " ", text)
    return text.strip()


# ---------------------------------------------------------------------------
# Processors
# ---------------------------------------------------------------------------
@dataclass
class SourceSpec:
    """One corpus source: name, cleaner, quality filter."""

    name: str
    cleaner: Callable[[str], str]
    min_chars: int = 200
    max_chars: int = 500_000

    def process_record(self, raw: str) -> Optional[str]:
        text = self.cleaner(raw)
        if len(text) < self.min_chars:
            return None
        return text[: self.max_chars]


SOURCES: Dict[str, SourceSpec] = {
    "wikipedia": SourceSpec("wikipedia", clean_wiki_text),
    "gutenberg": SourceSpec("gutenberg", clean_gutenberg_text, min_chars=1000),
    "arxiv": SourceSpec("arxiv", clean_latex_abstract, min_chars=100),
    "stackoverflow": SourceSpec("stackoverflow", clean_html_text, min_chars=100),
    "pubmed": SourceSpec("pubmed", clean_latex_abstract, min_chars=100),
    "openwebtext": SourceSpec("openwebtext", clean_html_text),
    "philpapers": SourceSpec("philpapers", clean_latex_abstract, min_chars=100),
    "ccnews": SourceSpec("ccnews", clean_html_text),
}


class SourceProcessor:
    """Turn a local raw dump (jsonl or plain text files) into cleaned jsonl
    shards (ref per-source create_dataset_files). Fetching raw dumps needs
    egress and is out of scope here by design — point `inputs` at local
    files instead."""

    def __init__(self, source: str):
        if source not in SOURCES:
            raise ValueError(f"unknown source {source!r}; one of {list(SOURCES)}")
        self.spec = SOURCES[source]

    def iter_clean(
        self, inputs: Sequence[str], text_key: str = "text",
        dedup: bool = False, dedup_chunk: int = 512,
    ) -> Iterator[Dict[str, Any]]:
        """Cleaned records; dedup=True drops exact duplicates by 64-bit
        content hash (web corpora like CC-News and OpenWebText repeat
        articles across dumps). Hashing batches `dedup_chunk` texts per
        native FNV-1a call so per-call ctypes overhead amortizes."""
        if not dedup:
            yield from self._iter_raw(inputs, text_key)
            return

        from luminaai_tpu_torch.native import content_hashes

        seen: set = set()
        chunk: List[str] = []

        def flush():
            if not chunk:
                return
            hashes = content_hashes([t.encode("utf-8") for t in chunk])
            for text, h in zip(chunk, hashes):
                h = int(h)
                if h not in seen:
                    seen.add(h)
                    yield {"text": text, "source": self.spec.name}
            chunk.clear()

        for rec in self._iter_raw(inputs, text_key):
            chunk.append(rec["text"])
            if len(chunk) >= dedup_chunk:
                yield from flush()
        yield from flush()

    def _iter_raw(
        self, inputs: Sequence[str], text_key: str
    ) -> Iterator[Dict[str, Any]]:
        for path in inputs:
            p = Path(path)
            if p.suffix == ".jsonl":
                with io_call(
                    p.open, encoding="utf-8", errors="replace",
                    op="data_open",
                ) as f:
                    for line in f:
                        try:
                            rec = json.loads(line)
                        except json.JSONDecodeError:
                            continue
                        raw = rec.get(text_key) or ""
                        text = self.spec.process_record(raw)
                        if text:
                            yield {"text": text, "source": self.spec.name}
            else:
                text = self.spec.process_record(p.read_text(errors="replace"))
                if text:
                    yield {"text": text, "source": self.spec.name}

    def create_dataset_files(
        self,
        inputs: Sequence[str],
        output_dir: str,
        num_files: int = 1,
        mb_per_file: float = 50.0,
        text_key: str = "text",
        dedup: bool = False,
    ) -> List[str]:
        """Write cleaned jsonl shards, size-capped (ref :457 etc.);
        dedup drops exact duplicates across the inputs (iter_clean)."""
        out_dir = Path(output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        limit = int(mb_per_file * 1e6)
        paths: List[str] = []
        f = None
        written = 0
        idx = 0
        try:
            for rec in self.iter_clean(inputs, text_key, dedup=dedup):
                if f is None or written >= limit:
                    if f:
                        f.close()
                    if idx >= num_files:
                        break
                    path = out_dir / f"{self.spec.name}_{idx:04d}.jsonl"
                    paths.append(str(path))
                    f = path.open("w", encoding="utf-8")
                    written = 0
                    idx += 1
                line = json.dumps(rec) + "\n"
                f.write(line)
                written += len(line)
        finally:
            if f:
                f.close()
        logger.info("%s: wrote %d shard(s)", self.spec.name, len(paths))
        return paths


# ---------------------------------------------------------------------------
# Blending
# ---------------------------------------------------------------------------
class MultiSourcePipeline:
    """Weighted blend of cleaned shard sets into one token cache.

    (ref main() concatenates per-source files with MB quotas; here the blend
    is by document-level round-robin proportional to weights, which keeps
    sources interleaved for shuffle-free streaming.)
    """

    def __init__(
        self,
        tokenizer,
        weights: Dict[str, float],
        quarantine: bool = True,
        max_quarantine_rate: float = 0.05,
    ):
        self.tokenizer = tokenizer
        total = sum(weights.values())
        self.weights = {k: v / total for k, v in weights.items()}
        # Degraded-mode loading contract for shard reads (same switches
        # as config.data_quarantine / data_quarantine_max_rate).
        self.quarantine = quarantine
        self.max_quarantine_rate = max_quarantine_rate

    def iter_blended(
        self,
        shards: Dict[str, Sequence[str]],
        seed: int = 0,
        state: Optional[Dict[str, Any]] = None,
    ) -> "BlendIterator":
        """Deterministic weighted blend. Returns a `BlendIterator`, which
        iterates like the old generator but also exposes
        `state_dict()/load_state_dict()` (per-source mixture positions +
        total emitted count) so a blend interrupted mid-stream resumes at
        the exact record it stopped at (docs/resilience.md)."""
        it = BlendIterator(self, shards, seed=seed)
        if state:
            it.load_state_dict(state)
        return it

    @staticmethod
    def _iter_shards(
        paths: Sequence[str],
        quarantine: bool = True,
        max_quarantine_rate: float = 0.05,
    ) -> Iterator[Dict[str, Any]]:
        # Delegates to read_jsonl so shard reads carry the WHOLE
        # degraded-mode contract (retried opens, truncated-tail skip,
        # quarantine-off fatality, rate fence) — one implementation,
        # not a drifting copy.
        from luminaai_tpu_torch.data.dataset import read_jsonl

        for p in paths:
            yield from read_jsonl(
                p, quarantine=quarantine,
                max_quarantine_rate=max_quarantine_rate,
            )

    def build_cache(
        self, shards: Dict[str, Sequence[str]], cache_stem: str, seed: int = 0
    ):
        """Tokenize the blend into a TokenCache for PackedDataset."""
        from luminaai_tpu_torch.data.dataset import TokenCache

        def docs():
            for rec in self.iter_blended(shards, seed):
                text = rec.get("text")
                if text:
                    yield self.tokenizer.encode_text(text) + [
                        self.tokenizer.eos_token_id
                    ]

        return TokenCache(cache_stem).build(
            docs(), meta={"weights": self.weights}
        )


class BlendIterator:
    """Resumable deterministic blend over per-source shard iterators.

    The draw sequence is fully determined by (seed, weights, shard
    contents), so the checkpointable position is just the emitted-record
    count plus per-source cursors for observability; `load_state_dict`
    fast-forwards by re-drawing and discarding `emitted` records — exact
    continuation, no record blended twice or skipped."""

    def __init__(self, pipeline: "MultiSourcePipeline",
                 shards: Dict[str, Sequence[str]], seed: int = 0):
        self.pipeline = pipeline
        self.shards = shards
        self.seed = seed
        self.emitted = 0
        self.per_source: Dict[str, int] = {}
        self._skip = 0

    def state_dict(self) -> Dict[str, Any]:
        return {
            "kind": "blend",
            "seed": self.seed,
            "emitted": self.emitted,
            "per_source": dict(self.per_source),
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if state.get("kind", "blend") != "blend":
            raise ValueError(f"not a blend state: {state.get('kind')!r}")
        self.seed = int(state.get("seed", self.seed))
        self._skip = int(state.get("emitted", 0))

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        skip = self._skip
        self._skip = 0
        self.emitted = 0
        self.per_source = {}
        iters = {
            name: MultiSourcePipeline._iter_shards(
                paths,
                quarantine=self.pipeline.quarantine,
                max_quarantine_rate=self.pipeline.max_quarantine_rate,
            )
            for name, paths in self.shards.items()
            if name in self.pipeline.weights
        }
        rng = np.random.RandomState(self.seed)
        names = list(iters)
        probs = np.asarray([self.pipeline.weights[n] for n in names])
        probs = probs / probs.sum()
        while iters:
            name = rng.choice(names, p=probs)
            try:
                rec = next(iters[name])
            except StopIteration:
                del iters[name]
                idx = names.index(name)
                names.pop(idx)
                probs = np.delete(probs, idx)
                if probs.sum() == 0:
                    break
                probs = probs / probs.sum()
                continue
            self.emitted += 1
            self.per_source[name] = self.per_source.get(name, 0) + 1
            if self.emitted <= skip:
                continue  # fast-forward past already-blended records
            yield rec
