"""Dataset acquisition: OASST tree extraction, shard writing, downloads
(port of luminaai_tpu/data/acquisition.py, the whole file).

The processing pipeline (message tree -> conversation paths -> quality
filter -> chat-format jsonl shards) is pure and runs offline:
`DatasetDownloader.process_local_dump` over a local raw OASST dump is what
`data acquire --in DUMP` runs. The network edge is isolated behind
`fetch_raw` (resume through a url-keyed partial with Range + If-Range,
sha256 streamed alongside, an injectable opener), `network_available`
and `download_and_process` (huggingface `datasets`; False, never a raise,
when it or the network is missing), so a host without a network
processes local dumps instead of failing mid-pipeline. "ref :N" marks
the line of the original project's Dataset_download.py each function
covers, as in the JAX file.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import socket
import urllib.request
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

logger = logging.getLogger(__name__)

OASST_DATASET = "OpenAssistant/oasst2"

# Descriptive UA: several corpus hosts (reddit especially) reject
# urllib's default Python-urllib/3.x agent outright.
_USER_AGENT = "luminaai-tpu-dataloader/1.0 (research corpus acquisition)"

# Raw-dump URL templates for the multi-source pipeline's corpora (ref
# multi_source_dataset.py WikipediaProcessor.download_dump etc.).
SOURCE_URLS: Dict[str, str] = {
    "wikipedia": (
        "https://dumps.wikimedia.org/{lang}/latest/"
        "{lang}-latest-pages-articles.xml.bz2"
    ),
    "gutenberg": "https://www.gutenberg.org/files/{book_id}/{book_id}-0.txt",
    "arxiv": (
        "http://export.arxiv.org/api/query?search_query=cat:{category}"
        "&max_results={max_results}"
    ),
    "stackoverflow": (
        "https://api.stackexchange.com/2.3/questions?site=stackoverflow"
        "&tagged={tag}&pagesize={page_size}&filter=withbody"
    ),
    # (ref multi_source_dataset.py:860 PubMed eutils, :1020 reddit as the
    # OpenWebText-style source, :1134 OpenAlex for PhilPapers' role, :1249
    # RSS feeds for CC-News's role.)
    "pubmed": (
        "https://eutils.ncbi.nlm.nih.gov/entrez/eutils/esearch.fcgi"
        "?db=pubmed&term={term}&retmax={retmax}&retmode=json"
    ),
    "openwebtext": (
        "https://www.reddit.com/r/{subreddit}/top.json"
        "?limit={limit}&t=week"
    ),
    "philpapers": (
        "https://api.openalex.org/works?filter=concepts.id:{concept}"
        "&per-page={per_page}"
    ),
    "ccnews": "{feed_url}",
}


# ---------------------------------------------------------------------------
# Pure processing (offline): OASST message tree → conversation paths
# ---------------------------------------------------------------------------
def build_conversation_tree(
    messages: List[Dict],
) -> Tuple[Dict[str, Dict], List[str]]:
    """Message list → {id: {data, children}} map + root ids (ref :49)."""
    message_map: Dict[str, Dict] = {}
    for msg in messages:
        message_map[msg["message_id"]] = {"data": msg, "children": []}
    roots = []
    for msg in messages:
        parent_id = msg.get("parent_id")
        if parent_id and parent_id in message_map:
            message_map[parent_id]["children"].append(msg["message_id"])
        else:
            roots.append(msg["message_id"])
    return message_map, roots


def extract_conversation_paths(
    message_map: Dict[str, Dict], root_id: str
) -> List[List[Dict]]:
    """All root→node paths with ≥2 messages (ref :72). Iterative DFS —
    OASST trees can be deep enough to threaten the recursion limit."""
    paths: List[List[Dict]] = []
    if root_id not in message_map:
        return paths
    stack: List[Tuple[str, List[Dict]]] = [(root_id, [])]
    while stack:
        node_id, prefix = stack.pop()
        node = message_map.get(node_id)
        if node is None:
            continue
        path = prefix + [node["data"]]
        if len(path) >= 2:
            paths.append(path)
        for child_id in node["children"]:
            stack.append((child_id, path))
    return paths


def format_conversation(messages: List[Dict]) -> Dict:
    """Path → structured conversation record (ref :98)."""
    conversation = {
        "conversation_id": messages[0].get("message_tree_id", ""),
        "messages": [],
        "total_turns": len(messages),
        "languages": sorted({m.get("lang", "en") for m in messages}),
    }
    for i, msg in enumerate(messages):
        conversation["messages"].append({
            "turn": i + 1,
            "role": (msg.get("role") or "").lower(),
            "content": (msg.get("text") or "").strip(),
            "message_id": msg.get("message_id", ""),
            "rank": msg.get("rank", 0) or 0,
            "synthetic": bool(msg.get("synthetic", False)),
        })
    return conversation


def filter_quality_conversations(
    conversations: List[Dict], strict: bool = False
) -> List[Dict]:
    """Quality gate (ref :124): role alternation sanity, non-empty content,
    length bounds; strict mode also requires English and ≥2 exchanges."""
    kept = []
    for conv in conversations:
        msgs = conv.get("messages", [])
        if len(msgs) < 2:
            continue
        roles = [m.get("role") for m in msgs]
        if roles[0] != "prompter" and roles[0] != "user":
            continue
        if not any(r == "assistant" for r in roles):
            continue
        # Paths are emitted at every tree depth; drop prefixes that end on
        # an unanswered prompt (no assistant-loss signal in the final turn).
        if roles[-1] != "assistant":
            continue
        contents = [(m.get("content") or "") for m in msgs]
        if any(not c.strip() for c in contents):
            continue
        total_chars = sum(len(c) for c in contents)
        if total_chars < 20 or total_chars > 100_000:
            continue
        if strict:
            if len(msgs) < 4:
                continue
            if conv.get("languages") and "en" not in conv["languages"]:
                continue
        kept.append(conv)
    return kept


def oasst_to_chat_format(conversation: Dict) -> Dict:
    """OASST roles → the repo's chat schema ({'messages': [{role, content}]},
    prompter→user) consumed by ConversationTokenizer."""
    role_map = {"prompter": "user", "assistant": "assistant", "user": "user"}
    return {
        "messages": [
            {"role": role_map.get(m["role"], m["role"]),
             "content": m["content"]}
            for m in conversation["messages"]
        ]
    }


def analyze_conversations(
    conversations: List[Dict], split_name: str = ""
) -> Dict[str, Any]:
    """Corpus stats (ref :166)."""
    if not conversations:
        return {"split": split_name, "count": 0}
    turns = [c.get("total_turns", len(c.get("messages", [])))
             for c in conversations]
    chars = [
        sum(len(m.get("content") or "") for m in c.get("messages", []))
        for c in conversations
    ]
    return {
        "split": split_name,
        "count": len(conversations),
        "avg_turns": sum(turns) / len(turns),
        "max_turns": max(turns),
        "avg_chars": sum(chars) / len(chars),
        "total_mb": sum(chars) / 1e6,
    }


def save_conversations_with_size_limit(
    conversations: Iterable[Dict],
    output_dir: str,
    base_name: str = "conversations",
    max_mb_per_file: float = 100.0,
    max_records_per_file: Optional[int] = None,
) -> List[str]:
    """Shard jsonl writer (ref :203): rotates at the size limit and/or the
    record-count limit (config.max_conversations_per_file)."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    limit = max_mb_per_file * 1e6
    paths: List[str] = []
    f = None
    written = 0
    records = 0
    try:
        for conv in conversations:
            if f is None or written > limit or (
                max_records_per_file and records >= max_records_per_file
            ):
                if f is not None:
                    f.close()
                path = out / f"{base_name}_{len(paths):04d}.jsonl"
                paths.append(str(path))
                f = open(path, "w", encoding="utf-8")
                written = 0
                records = 0
            line = json.dumps(conv, ensure_ascii=False) + "\n"
            f.write(line)
            written += len(line.encode("utf-8"))
            records += 1
    finally:
        if f is not None:
            f.close()
    return paths


# ---------------------------------------------------------------------------
# Network edge (gated)
# ---------------------------------------------------------------------------
def network_available(timeout: float = 2.0) -> bool:
    """Cheap reachability probe; False on a host without a network."""
    try:
        socket.create_connection(("8.8.8.8", 53), timeout=timeout).close()
        return True
    except OSError:
        return False


def _part_path(dest: str, url: str) -> str:
    """URL-keyed partial sidecar: a leftover partial can only ever resume
    the SAME url (different params → different partial), so a Range-
    honoring server can never splice two downloads into one file."""
    tag = hashlib.sha1(url.encode()).hexdigest()[:10]
    return f"{dest}.{tag}.part"


def fetch_raw(
    url: str, dest: str, timeout: float = 60.0,
    _opener: Optional[Callable] = None,
    expected_sha256: Optional[str] = None,
    resume: bool = True,
) -> Optional[str]:
    """Download url → dest with resume + checksum; None when unreachable.

    - Streams to a url-keyed `.part` sidecar and renames on success, so a
      failed re-fetch can never clobber an earlier good download at dest.
    - Resume: a leftover partial restarts the transfer with an HTTP Range
      + If-Range request (validator = the ETag/Last-Modified captured
      when the partial was started, kept in a `.meta` sidecar). If-Range
      makes a changed remote serve the WHOLE file (status 200) instead of
      splicing two versions; a partial with no stored validator is
      discarded rather than trusted. 416 (partial >= remote size, e.g. a
      republished 'latest' dump that shrank) also discards and refetches.
      A failed transfer KEEPS the partial for the next attempt (the
      reference's urlretrieve redownloads dumps from scratch each time,
      ref multi_source_dataset.py:287).
    - Integrity: sha256 streams alongside the download (no second disk
      pass) and is recorded in `<dest>.sha256`; pass expected_sha256 to
      verify (mismatch deletes the corrupt file and returns None).
    - Success removes every other `<dest>.*.part` sibling (stale partials
      from old parameter sets don't accumulate).

    `_opener(url, headers)` is injectable for tests; defaults to urllib.
    """
    opener = _opener or (
        lambda u, h: urllib.request.urlopen(
            urllib.request.Request(
                u, headers={"User-Agent": _USER_AGENT, **h}
            ),
            timeout=timeout,
        )
    )
    part = _part_path(dest, url)
    meta = part + ".meta"
    offset = 0
    validator = None
    if resume:
        try:
            offset = os.path.getsize(part)
            with open(meta) as f:
                validator = f.read().strip() or None
        except OSError:
            validator = None
        if offset and not validator:
            # No validator captured for this partial: resuming could
            # silently splice two versions of the remote file. Start over.
            logger.info("partial without validator; refetching %s whole", url)
            offset = 0
    headers = {}
    if offset:
        headers["Range"] = f"bytes={offset}-"
        headers["If-Range"] = validator
    digest = hashlib.sha256()
    if offset:
        with open(part, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                digest.update(chunk)
    try:
        with opener(url, headers) as resp:
            mode = "ab" if offset else "wb"
            if offset and getattr(resp, "status", 206) == 200:
                # Range ignored OR If-Range detected a changed remote:
                # full body incoming.
                mode, offset = "wb", 0
                digest = hashlib.sha256()
            if mode == "wb":
                resp_headers = getattr(resp, "headers", None)
                new_validator = resp_headers and (
                    resp_headers.get("ETag")
                    or resp_headers.get("Last-Modified")
                )
                with open(meta, "w") as f:
                    f.write(new_validator or "")
            with open(part, mode) as f:
                while True:
                    chunk = resp.read(1 << 20)
                    if not chunk:
                        break
                    f.write(chunk)
                    digest.update(chunk)
    except Exception as e:
        if offset and getattr(e, "code", None) == 416:
            # Range not satisfiable: the partial is stale (remote shrank
            # or we died after the last byte). Discard and refetch whole.
            logger.warning(
                "range not satisfiable for %s; discarding partial", url
            )
            for path in (part, meta):
                try:
                    os.unlink(path)
                except OSError:
                    pass
            return fetch_raw(
                url, dest, timeout, _opener, expected_sha256, resume=False
            )
        logger.error("download failed for %s: %s", url, e)
        logger.info(
            "offline? process a local dump instead: "
            "DatasetDownloader.process_local_dump(path) "
            "(partial kept for resume: %s)", part,
        )
        return None

    hexdigest = digest.hexdigest()
    if expected_sha256 and hexdigest != expected_sha256.lower():
        logger.error(
            "checksum mismatch for %s: got %s want %s — discarding",
            url, hexdigest, expected_sha256,
        )
        for path in (part, meta):
            try:
                os.unlink(path)
            except OSError:
                pass
        return None
    os.replace(part, dest)
    # GC: this url's meta plus any stale partials from other urls that
    # mapped to the same dest (old parameter sets never resumed again).
    import glob as _glob

    for stale in _glob.glob(f"{dest}.*.part") + _glob.glob(
        f"{dest}.*.part.meta"
    ):
        try:
            os.unlink(stale)
        except OSError:
            pass
    with open(dest + ".sha256", "w") as f:
        f.write(f"{hexdigest}  {os.path.basename(dest)}\n")
    return dest


class DatasetDownloader:
    """OASST acquisition pipeline (ref :278 download_and_process).

    download_and_process(): fetch via `datasets` when the environment has
    network; otherwise returns False with guidance. process_messages():
    the offline core — raw message rows → filtered chat-format shards.
    """

    def __init__(
        self,
        output_dir: str,
        max_mb_per_file: float = 100.0,
        max_records_per_file: Optional[int] = None,
    ):
        self.output_dir = Path(output_dir)
        self.max_mb_per_file = max_mb_per_file
        self.max_records_per_file = max_records_per_file

    def process_messages(
        self, messages: List[Dict], split_name: str = "train",
        strict: bool = False,
    ) -> Dict[str, Any]:
        """Raw OASST rows → quality-filtered chat jsonl shards + stats."""
        message_map, roots = build_conversation_tree(messages)
        raw_paths: List[List[Dict]] = []
        for root in roots:
            raw_paths.extend(extract_conversation_paths(message_map, root))
        formatted = [format_conversation(p) for p in raw_paths]
        kept = filter_quality_conversations(formatted, strict=strict)
        chat = [oasst_to_chat_format(c) for c in kept]
        files = save_conversations_with_size_limit(
            chat, str(self.output_dir), base_name=split_name,
            max_mb_per_file=self.max_mb_per_file,
            max_records_per_file=self.max_records_per_file,
        )
        stats = analyze_conversations(kept, split_name)
        stats["files"] = files
        logger.info("%s: %d paths -> %d kept -> %d files",
                    split_name, len(raw_paths), len(kept), len(files))
        return stats

    def process_local_dump(
        self, dump_path: str, split_name: str = "train", strict: bool = False
    ) -> Dict[str, Any]:
        """Offline entry: a local jsonl of raw OASST message rows. Corrupt
        lines are skipped with a warning (read_jsonl), not fatal — dumps
        from interrupted downloads commonly have a truncated tail."""
        from luminaai_tpu_torch.data.dataset import read_jsonl

        return self.process_messages(
            list(read_jsonl(dump_path)), split_name, strict
        )

    def download_and_process(
        self, dataset_name: str = OASST_DATASET, strict: bool = False
    ) -> bool:
        """Network path (ref :278): huggingface `datasets` load → process.
        Returns False (never raises) when the environment is offline."""
        if not network_available():
            # Advisory only: proxied environments can fail the raw TCP probe
            # while HTTPS egress works — let load_dataset decide.
            logger.warning(
                "network probe failed; attempting download of %s anyway "
                "(process_local_dump() is the offline path)", dataset_name,
            )
        try:
            from datasets import load_dataset  # optional dependency

            ds = load_dataset(dataset_name)
        except Exception as e:
            logger.error("failed to load %s: %s", dataset_name, e)
            return False
        for split in ("train", "validation"):
            if split not in ds:
                continue
            self.process_messages(list(ds[split]), split, strict)
        return True


def fetch_source(
    source: str, output_dir: str, _opener: Optional[Callable] = None,
    expected_sha256: Optional[str] = None, resume: bool = True, **params
) -> Optional[str]:
    """Fetch one multi-source corpus dump (ref multi_source_dataset.py
    *Processor.download_* methods — all eight sources). Returns the local
    path or None offline; resumes partials and records sha256 (fetch_raw).
    """
    if source not in SOURCE_URLS:
        raise ValueError(
            f"unknown source {source!r}; known: {sorted(SOURCE_URLS)}"
        )
    defaults = {
        "lang": "simplewiki", "book_id": "1342", "category": "cs.LG",
        "max_results": 100, "tag": "python", "page_size": 100,
        "term": "machine+learning", "retmax": 100,
        "subreddit": "machinelearning", "limit": 100,
        "concept": "C138885662",  # OpenAlex: philosophy
        "per_page": 100,
        "feed_url": "http://feeds.bbci.co.uk/news/rss.xml",
    }
    defaults.update(params)
    url = SOURCE_URLS[source].format(**defaults)
    dest = str(Path(output_dir) / f"{source}_raw.dat")
    Path(output_dir).mkdir(parents=True, exist_ok=True)
    return fetch_raw(
        url, dest, _opener=_opener, expected_sha256=expected_sha256,
        resume=resume,
    )
