"""The port's data layer against the JAX package's (both plain numpy).

Inputs are files the test writes from numpy seeds. Everything here is
exact: the same files, seeds and cursors must give the same batches, ids,
masks, weights and merges bit for bit.

- PackedDataset (shuffled and sequential, split and truncated documents,
  native and numpy packers) over two epochs, and its state_dict /
  load_state_dict resume mid-epoch, through a PrefetchLoader too;
- ConversationDataset + conversation_batches (ids, loss_mask,
  loss_weights) over two epoch seeds;
- the native library: shuffle_indices, pack_batch and index_lines
  against JAX's, and the packer's two paths against each other; the
  path each call took is counted;
- the BPE: merges and encodings of a vocabulary trained on the same text
  (native and Python merge loops), and the tokenizer's bpe: backend;
- read_jsonl's quarantine contract (a corrupt record, a truncated tail).
"""

import json

import numpy as np
import pytest

from luminaai_tpu.config import Config as JConfig
from luminaai_tpu.data import bpe as jbpe
from luminaai_tpu.data import dataset as jds
from luminaai_tpu.data.tokenizer import ConversationTokenizer as JTokenizer
from luminaai_tpu import native as jnative
from luminaai_tpu_torch import native
from luminaai_tpu_torch.config import Config
from luminaai_tpu_torch.data import bpe
from luminaai_tpu_torch.data import dataset as ds
from luminaai_tpu_torch.data.tokenizer import ConversationTokenizer

WORDS = ("the model trains on packed rows of text while the card waits "
         "for nothing; checkpoints land and resume exactly").split()


def _docs(seed=0, n=60):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 250, size=rng.randint(3, 90)).tolist()
            for _ in range(n)]


def _text_jsonl(path, seed=0, n=40):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for _ in range(n):
            words = rng.choice(WORDS, size=rng.randint(4, 60))
            f.write(json.dumps({"text": " ".join(words)}) + "\n")
    return str(path)


def _stream(d, epochs=2):
    out = []
    for _ in range(epochs):
        out.extend((b["input_ids"].copy(), b["loss_mask"].copy()) for b in d)
    return out


def _assert_streams_equal(a, b):
    assert len(a) == len(b) > 0
    for i, ((ia, ma), (ib, mb)) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(ia, ib, err_msg=f"batch {i} ids")
        np.testing.assert_array_equal(ma, mb, err_msg=f"batch {i} mask")


@pytest.mark.parametrize("shuffle_seed", [None, 3])
@pytest.mark.parametrize("split_docs", [True, False])
@pytest.mark.parametrize("use_native", [True, False])
def test_packed_dataset_matches_jax(tmp_path, shuffle_seed, split_docs,
                                    use_native):
    docs = _docs()
    ours = ds.TokenCache(str(tmp_path / "ours")).build(iter(docs))
    theirs = jds.TokenCache(str(tmp_path / "theirs")).build(iter(docs))
    assert ours.tokens_path.read_bytes() == theirs.tokens_path.read_bytes()
    kw = dict(batch_size=3, seq_length=24, pad_id=0, eos_id=255,
              shuffle_seed=shuffle_seed, split_docs=split_docs,
              use_native=use_native)
    ref = _stream(jds.PackedDataset(theirs, **kw))
    _assert_streams_equal(_stream(ds.PackedDataset(ours, **kw)), ref)

    # Stop mid-epoch, resume from the state_dict in a fresh dataset.
    d = ds.PackedDataset(ours, **kw)
    it = iter(d)
    got = [(b["input_ids"].copy(), b["loss_mask"].copy())
           for b in (next(it) for _ in range(4))]
    state = d.state_dict()
    assert state["epoch"] == 0 and state["batch_index"] == 4
    it.close()
    d2 = ds.PackedDataset(ours, **kw)
    d2.load_state_dict(json.loads(json.dumps(state)))
    got += _stream(d2)
    _assert_streams_equal(got[:len(ref)], ref)


def test_prefetch_loader_resume_matches_jax(tmp_path):
    """The trainer's loader: PrefetchLoader over a shuffled PackedDataset.
    Its state after k batches, loaded into a fresh loader, continues the
    JAX loader's stream across the epoch boundary."""
    docs = _docs(1)
    cache = ds.TokenCache(str(tmp_path / "c")).build(iter(docs))
    jcache = jds.TokenCache(str(tmp_path / "c")).open()
    kw = dict(batch_size=2, seq_length=32, pad_id=0, eos_id=255,
              shuffle_seed=7)

    def loader(mod, c):
        d = mod.PackedDataset(c, **kw)
        return mod.PrefetchLoader(lambda: iter(d), prefetch=2, source=d)

    ref = _stream(loader(jds, jcache))
    pl = loader(ds, cache)
    it = iter(pl)
    got = [(b["input_ids"].copy(), b["loss_mask"].copy())
           for b in (next(it) for _ in range(5))]
    state = pl.state_dict()
    assert state["epoch"] == 0 and state["batch_index"] == 5
    assert state["source"]["shuffle_seed"] == 7
    it.close()
    pl2 = loader(ds, cache)
    pl2.load_state_dict(state)
    got += _stream(pl2)
    _assert_streams_equal(got[:len(ref)], ref)
    assert pl2.consume_resume_replay_seconds() > 0.0


def test_conversation_batches_match_jax(tmp_path):
    rng = np.random.RandomState(2)
    path = tmp_path / "conv.jsonl"
    with open(path, "w") as f:
        for i in range(24):
            msgs = [{"role": "user",
                     "content": " ".join(rng.choice(WORDS, 5))},
                    {"role": "assistant",
                     "content": " ".join(rng.choice(WORDS, rng.randint(2, 30)))}]
            if i % 5 == 0:
                msgs.append({"role": "user", "content": "and then?"})
            f.write(json.dumps({"messages": msgs}) + "\n")
        f.write(json.dumps({"messages": []}) + "\n")  # invalid: skipped
    cfg = Config(seq_length=96)
    jcfg = JConfig(seq_length=96)
    ours = ds.ConversationDataset(str(path), ConversationTokenizer(), cfg)
    theirs = jds.ConversationDataset(str(path), JTokenizer(), jcfg)
    assert len(ours) == len(theirs) == 24 and ours.skipped == 1
    for seed in (0, 1):
        a = list(ds.conversation_batches(ours, 4, seed=seed))
        b = list(jds.conversation_batches(theirs, 4, seed=seed))
        assert len(a) == len(b) == 6
        for x, y in zip(a, b):
            assert x.keys() == y.keys() == {"input_ids", "loss_mask",
                                            "loss_weights"}
            for k in x:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("n,seed", [(1, 0), (100, 7), (1000, 12345)])
@pytest.mark.parametrize("use_native", [True, False])
def test_shuffle_indices_match_jax(n, seed, use_native):
    np.testing.assert_array_equal(
        native.shuffle_indices(n, seed, use_native=use_native),
        jnative.shuffle_indices(n, seed, use_native=use_native))


@pytest.mark.parametrize("eos,split", [(-1, True), (99, True), (99, False)])
def test_pack_batch_matches_jax(eos, split):
    docs = _docs(3, 12)
    tokens = np.concatenate([np.asarray(d) for d in docs]).astype(np.int32)
    offsets = np.concatenate(
        [[0], np.cumsum([len(d) for d in docs])]).astype(np.int64)
    doc = tok = 0
    while doc < len(docs):
        args = (tokens, offsets, doc, 3, 20, 0, eos, split)
        a = native.pack_batch(*args, start_token=tok, use_native=True)
        b = native.pack_batch(*args, start_token=tok, use_native=False)
        c = jnative.pack_batch(*args, start_token=tok, use_native=True)
        for x, y in ((a, b), (a, c)):
            np.testing.assert_array_equal(x[0], y[0])
            np.testing.assert_array_equal(x[1], y[1])
            assert x[2:] == y[2:]
        doc, tok = a[2], a[3]


def test_native_paths_are_counted():
    native.reset_path_counts()
    tokens = np.arange(1, 30, dtype=np.int32)
    offsets = np.array([0, 10, 29], dtype=np.int64)
    native.pack_batch(tokens, offsets, 0, 2, 8, 0)
    native.pack_batch(tokens, offsets, 0, 2, 8, 0, use_native=False)
    native.shuffle_indices(5, 1)
    counts = native.path_counts()
    assert native.native_available()
    assert counts["pack_batch"] == {"native": 1, "numpy": 1}
    assert counts["shuffle_indices"] == {"native": 1, "numpy": 0}
    assert native.BUILD_DIR.name == "_build"
    assert native.BUILD_DIR.parent.parent.name == "luminaai_tpu_torch"


def test_index_lines_match_jax():
    rng = np.random.RandomState(4)
    lines = [" ".join(rng.choice(WORDS, rng.randint(0, 9)))
             for _ in range(50)]
    for data in ("\n".join(lines).encode(), ("\n".join(lines) + "\n").encode()):
        for use_native in (True, False):
            np.testing.assert_array_equal(
                native.index_lines(data, use_native=use_native),
                jnative.index_lines(data, use_native=True))


@pytest.mark.parametrize("use_native", [True, False])
def test_bpe_matches_jax(tmp_path, use_native):
    rng = np.random.RandomState(5)
    texts = [" ".join(rng.choice(WORDS, 40)) for _ in range(30)]
    ours = bpe.train_bpe(texts, vocab_size=300, use_native=use_native)
    theirs = jbpe.train_bpe(texts, vocab_size=300, use_native=True)
    assert ours.merges == theirs.merges and len(ours.merges) > 20
    probe = "the card waits; packed rows resume exactly 123"
    assert ours.encode(probe) == theirs.encode(probe)
    assert ours.decode(ours.encode(probe)) == probe
    path = str(tmp_path / "tok.json")
    ours.save(path)
    tok, jtok = (ConversationTokenizer(model_name=f"bpe:{path}"),
                 JTokenizer(model_name=f"bpe:{path}"))
    assert tok.vocab_size == jtok.vocab_size
    assert tok.special_tokens == jtok.special_tokens
    assert tok.encode_text(probe) == jtok.encode_text(probe)
    conv = {"messages": [{"role": "user", "content": probe},
                         {"role": "assistant", "content": "rows resume"}]}
    a, b = tok.encode_conversation(conv), jtok.encode_conversation(conv)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(NotImplementedError, match="not ported"):
        ConversationTokenizer(model_name="tiktoken:cl100k_base")


def test_read_jsonl_quarantine_matches_jax(tmp_path):
    path = tmp_path / "rough.jsonl"
    good = [json.dumps({"text": f"doc {i}"}) for i in range(30)]
    body = "\n".join(good[:10] + ["{not json"] + good[10:]) + "\n"
    path.write_text(body + '{"text": "cut')  # truncated trailing record
    ours = list(ds.read_jsonl(str(path)))
    theirs = list(jds.read_jsonl(str(path)))
    assert ours == theirs and len(ours) == 30
    with pytest.raises(ds.DataCorruptionError):
        list(ds.read_jsonl(str(path), quarantine=False))
    with pytest.raises(jds.DataCorruptionError):
        list(jds.read_jsonl(str(path), quarantine=False))


def test_build_text_cache_matches_jax(tmp_path):
    path = _text_jsonl(tmp_path / "corpus.jsonl")
    ours = ds.build_text_cache(path, str(tmp_path / "o"),
                               ConversationTokenizer())
    theirs = jds.build_text_cache(path, str(tmp_path / "t"), JTokenizer())
    assert ours.n_docs == theirs.n_docs == 40
    np.testing.assert_array_equal(np.asarray(ours.tokens),
                                  np.asarray(theirs.tokens))
    np.testing.assert_array_equal(ours.offsets, theirs.offsets)
    # A second build reopens the cache (no re-tokenization).
    again = ds.build_text_cache(path, str(tmp_path / "o"),
                                ConversationTokenizer())
    assert again.n_tokens == ours.n_tokens
