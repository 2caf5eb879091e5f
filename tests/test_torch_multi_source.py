"""The port's multi-source blend, cleaners, processing and native content
hashes against the JAX package's: exact equality throughout.

- The blended record sequence for several weightings and seeds, and a
  BlendIterator resumed from a state_dict (the port's and the JAX
  package's states interchange), equal JAX's record for record.
- build_cache's token cache equals JAX's token for token.
- Dedup drops the same records; `native.content_hashes` (C++ FNV-1a and
  its plain version) equals JAX's on the same documents.
- The cleaners on the JAX tests' inputs, SourceProcessor shards, OASST
  conversion, validation and the sample data equal JAX's output.
"""

import json

import numpy as np
import pytest

from luminaai_tpu import native as jnative
from luminaai_tpu.data import multi_source as jms
from luminaai_tpu.data import processing as jproc
from luminaai_tpu.data.tokenizer import ConversationTokenizer as JTok
from luminaai_tpu_torch import native as tnative
from luminaai_tpu_torch.data import multi_source as tms
from luminaai_tpu_torch.data import processing as tproc
from luminaai_tpu_torch.data.tokenizer import ConversationTokenizer as TTok


def _shards(tmp_path, sizes, files_per_source=2):
    """{name: [paths]} of jsonl text shards written from a seed; some
    records repeat, one line is corrupt (quarantined by read_jsonl)."""
    rng = np.random.RandomState(0)
    shards = {}
    for name, n in sizes.items():
        paths = []
        for f in range(files_per_source):
            p = tmp_path / f"{name}_{f}.jsonl"
            with p.open("w") as fh:
                for i in range(n):
                    words = rng.randint(0, 50, rng.randint(3, 30))
                    fh.write(json.dumps({
                        "text": f"{name} {f}.{i} " + " ".join(
                            f"w{w}" for w in words),
                        "source": name}) + "\n")
                if f == 0:
                    fh.write("{not json\n")
                    fh.write(json.dumps({"text": f"{name} 0.0 w1"}) + "\n")
            paths.append(str(p))
        shards[name] = paths
    return shards


BLENDS = [
    ({"wikipedia": 3.0, "arxiv": 1.0}, 0),
    ({"wikipedia": 0.7, "arxiv": 0.3}, 7),
    ({"wikipedia": 1.0, "arxiv": 1.0, "pubmed": 2.0}, 3),
    ({"wikipedia": 1.0, "arxiv": 0.0, "pubmed": 1.0}, 1),
]


@pytest.mark.parametrize("weights,seed", BLENDS,
                         ids=[f"blend{i}" for i in range(len(BLENDS))])
def test_blended_sequence_equals_jax(tmp_path, weights, seed):
    shards = _shards(tmp_path, {"wikipedia": 40, "arxiv": 12, "pubmed": 25})
    j = jms.MultiSourcePipeline(JTok(), weights).iter_blended(shards, seed)
    t = tms.MultiSourcePipeline(TTok(), weights).iter_blended(shards, seed)
    got, want = list(t), list(j)
    assert got == want and len(want) > 50
    assert t.state_dict() == j.state_dict()


@pytest.mark.parametrize("stop", [1, 17, 60])
def test_blend_resume_equals_jax(tmp_path, stop):
    """Stop after `stop` records, resume from the state: the tail equals
    the uninterrupted blend's, from either package's state."""
    shards = _shards(tmp_path, {"wikipedia": 30, "arxiv": 20})
    weights = {"wikipedia": 2.0, "arxiv": 1.0}
    full = list(jms.MultiSourcePipeline(JTok(), weights).iter_blended(
        shards, seed=5))
    states = []
    for mod, tok in ((jms, JTok()), (tms, TTok())):
        it = mod.MultiSourcePipeline(tok, weights).iter_blended(shards, 5)
        head = []
        for rec in it:
            head.append(rec)
            if len(head) == stop:
                break
        assert head == full[:stop]
        states.append(json.loads(json.dumps(it.state_dict())))
    assert states[0] == states[1]
    for state in states:
        rest = list(tms.MultiSourcePipeline(TTok(), weights).iter_blended(
            shards, seed=0, state=state))
        assert rest == full[stop:]


def test_build_cache_equals_jax(tmp_path):
    shards = _shards(tmp_path, {"wikipedia": 30, "arxiv": 10})
    weights = {"wikipedia": 3.0, "arxiv": 1.0}
    jc = jms.MultiSourcePipeline(JTok(), weights).build_cache(
        shards, str(tmp_path / "j" / "blend"))
    tc = tms.MultiSourcePipeline(TTok(), weights).build_cache(
        shards, str(tmp_path / "t" / "blend"))
    assert (tc.n_docs, tc.n_tokens) == (jc.n_docs, jc.n_tokens)
    np.testing.assert_array_equal(np.asarray(tc.tokens),
                                  np.asarray(jc.tokens))
    np.testing.assert_array_equal(np.asarray(tc.offsets),
                                  np.asarray(jc.offsets))
    assert tc.meta["weights"] == jc.meta["weights"]


DOCS = [b"", b"a", b"hello world", "héllo wörld ✓".encode(),
        bytes(range(256)), b"\x00" * 33, b"hello world"]


@pytest.mark.parametrize("native", [True, False], ids=["native", "plain"])
def test_content_hashes_equal_jax(native):
    rng = np.random.RandomState(1)
    docs = DOCS + [rng.bytes(int(n)) for n in rng.randint(0, 4000, 40)]
    got = tnative.content_hashes(docs, use_native=native)
    want = jnative.content_hashes(docs, use_native=False)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jnative.content_hashes(docs, use_native=True))
    path = "native" if native and tnative.native_available() else "numpy"
    assert tnative.path_counts()["content_hashes"][path] >= 1


@pytest.mark.parametrize("chunk", [1, 4, 512])
def test_dedup_equals_jax(tmp_path, chunk):
    raw = tmp_path / "dump.jsonl"
    with raw.open("w") as f:
        for i in range(40):
            body = f"<p>article {i % 13}</p> " + "text " * 40
            f.write(json.dumps({"text": body}) + "\n")
    recs = {}
    for mod in (jms, tms):
        recs[mod] = list(mod.SourceProcessor("ccnews").iter_clean(
            [str(raw)], dedup=True, dedup_chunk=chunk))
    assert recs[tms] == recs[jms]
    assert len(recs[tms]) == 13


WIKI = ("{{Infobox|x=1}} '''Python''' is a [[programming language|language]]"
        " created by [[Guido van Rossum]].<ref>cite</ref>\n== History ==\n"
        "It appeared in 1991. [[File:x.png]] [https://a.b link] "
        "{|\n|table\n|} &amp; <b>bold</b>\n\n\n\nend")
GUTENBERG = ("junk header\n*** START OF THE PROJECT GUTENBERG EBOOK X ***\n"
             "Actual book text here.\r\n\n\n\nMore.\n*** END OF THE PROJECT "
             "GUTENBERG EBOOK X ***\nlicense junk")
HTML = ("<p>Use <code>print()</code> here.</p><pre><code>x = 1</code></pre>"
        "&amp; more   spaces\n\n\n\nend")
LATEX = r"We show $x^2$ and $$\int f$$ with \textbf{bold} and \cite{a}  ok"

CLEANERS = [
    ("clean_wiki_text", WIKI),
    ("clean_gutenberg_text", GUTENBERG),
    ("clean_html_text", HTML),
    ("clean_latex_abstract", LATEX),
]


@pytest.mark.parametrize("name,text", CLEANERS, ids=[c[0] for c in CLEANERS])
def test_cleaners_equal_jax(name, text):
    assert getattr(tms, name)(text) == getattr(jms, name)(text)


def test_source_processor_shards_equal_jax(tmp_path):
    raw = tmp_path / "wiki_raw.jsonl"
    with raw.open("w") as f:
        for i in range(30):
            f.write(json.dumps({
                "text": f"'''Article {i}''' is about [[topic {i}]]. " * 20
            }) + "\n")
    out = {}
    for tag, mod in (("j", jms), ("t", tms)):
        paths = mod.SourceProcessor("wikipedia").create_dataset_files(
            [str(raw)], str(tmp_path / tag), num_files=2, mb_per_file=0.01)
        out[tag] = [open(p).read() for p in paths]
    assert out["t"] == out["j"] and len(out["t"]) == 2
    with pytest.raises(ValueError):
        tms.SourceProcessor("tiktok")


def test_processing_equals_jax(tmp_path):
    raw = tmp_path / "oasst.jsonl"
    with raw.open("w") as f:
        f.write(json.dumps({"messages": [
            {"role": "prompter", "content": "hello"},
            {"role": "assistant", "content": "hi!"},
        ]}) + "\n")
        f.write(json.dumps({"conversation_id": "c2", "messages": [
            {"role": "Human", "content": " q "},
            {"role": "bot", "content": "a"},
            {"role": "system", "content": ""},
        ]}) + "\n")
        f.write(json.dumps({"messages": [
            {"role": "prompter", "content": "only one side"},
        ]}) + "\n")
        f.write("not json\n")
    for tag, mod in (("j", jproc), ("t", tproc)):
        assert mod.process_oasst_data(str(raw), str(tmp_path / f"{tag}.jsonl")) == 2
        assert mod.create_sample_data(str(tmp_path / f"{tag}_s.jsonl"), 12) == 12

    def strip_time(path):
        recs = [json.loads(x) for x in open(path)]
        for r in recs:
            r["metadata"].pop("processed_at")
        return recs

    assert strip_time(tmp_path / "t.jsonl") == strip_time(tmp_path / "j.jsonl")
    assert (tmp_path / "t_s.jsonl").read_text() == (
        tmp_path / "j_s.jsonl").read_text()
    for name in ("t.jsonl", "t_s.jsonl", str(raw)):
        path = str(tmp_path / name)
        assert tproc.validate_data_comprehensive(path, TTok()) == (
            jproc.validate_data_comprehensive(path, JTok()))
