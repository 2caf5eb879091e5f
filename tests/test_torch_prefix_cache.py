"""The port's RadixPrefixCache and B5 launch counters.

- The chained page keys are byte for byte the JAX package's (sha256 over
  the previous key and the page's token ids).
- Seeded random sequences of lookup, acquire, insert, release, pin,
  forget and the in-flight dedup claims leave the port's cache in the same
  state as the JAX package's: every call returns the same value, and
  stats(), pages_cached(), page_refs() and tenant_pages() agree after
  every operation (exact: the cache is host bookkeeping on both sides).
- B5's wrapper counts a launch in `launches`, and a launch with a global
  page table also in `launches_global` (through a fake launcher: the
  kernel runs only on the card).
"""

import numpy as np
import pytest
import torch

from luminaai_tpu.inference import prefix_cache as jpc
from luminaai_tpu_torch.inference import prefix_cache as tpc
from luminaai_tpu_torch.ops import ragged_paged_attention as rpa


def test_chain_keys_are_byte_equal():
    rng = np.random.RandomState(0)
    for n, ps in ((0, 4), (7, 4), (64, 16), (300, 32), (129, 128)):
        toks = [int(t) for t in rng.randint(0, 50304, size=n)]
        for limit in (None, 1, 3):
            assert tpc.page_chain_keys(toks, ps, limit) == (
                jpc.page_chain_keys(toks, ps, limit)
            )


class _Recorder:
    def __init__(self):
        self.events = []

    def emit(self, type, **fields):
        self.events.append((type, fields))


def _state(cache):
    return (cache.stats(), cache.pages_cached(), cache.page_refs(),
            {t: cache.tenant_pages(t) for t in ("a", "b", "anon")},
            cache.pending_pages(), round(cache.hit_rate(), 6))


@pytest.mark.parametrize("seed,quota", [(0, 0), (1, 3), (2, 0), (3, 2)])
def test_random_operation_sequences_match_jax(seed, quota):
    rng = np.random.RandomState(seed)
    ps = 4
    arena = list(range(100, 112))  # 12 arena pages
    jrec, trec = _Recorder(), _Recorder()
    jc = jpc.RadixPrefixCache(arena, ps, tenant_quota=quota, recorder=jrec)
    tc = tpc.RadixPrefixCache(arena, ps, tenant_quota=quota, recorder=trec)
    # Prompts sharing prefixes of various depths, so chains branch.
    stems = [[int(t) for t in rng.randint(0, 20, size=12)] for _ in range(3)]
    prompts = []
    for _ in range(10):
        stem = stems[rng.randint(3)][: rng.randint(4, 13)]
        prompts.append(stem + [int(t) for t in
                               rng.randint(0, 20, size=rng.randint(0, 10))])
    held = []  # page-id lists acquired or pinned, to release later
    claims = []
    for step in range(160):
        op = rng.choice(["lookup", "acquire", "insert", "release", "pin",
                         "forget", "claim", "release_pending", "pending",
                         "wait"])
        p = prompts[rng.randint(len(prompts))]
        tenant = ["a", "b", "anon"][rng.randint(3)]
        if op == "lookup":
            out = (jc.lookup(p), tc.lookup(p))
        elif op == "acquire":
            out = (jc.acquire(p), tc.acquire(p))
            held.append(out[0][0])
        elif op == "insert":
            keys = jpc.page_chain_keys(p, ps)
            frm = rng.randint(0, max(1, len(keys)))
            out = (jc.insert(p, from_page=frm, tenant=tenant),
                   tc.insert(p, from_page=frm, tenant=tenant))
        elif op == "release" and held:
            ids = held.pop(rng.randint(len(held)))
            out = (jc.release(ids), tc.release(ids))
        elif op == "pin":
            ids = [int(i) for i in rng.choice(arena, size=2)]
            out = (jc.pin_pages(ids), tc.pin_pages(ids))
            held.append(ids)
        elif op == "forget":
            ids = [int(i) for i in rng.choice(arena, size=1)]
            out = (jc.forget(ids), tc.forget(ids))
        elif op == "claim":
            keys = jpc.page_chain_keys(p, ps)
            out = (jc.claim_pending(keys, owner=step),
                   tc.claim_pending(keys, owner=step))
            claims.append(out[0])
        elif op == "release_pending" and claims:
            keys = claims.pop(rng.randint(len(claims)))
            out = (jc.release_pending(keys), tc.release_pending(keys))
        elif op == "pending":
            keys = jpc.page_chain_keys(p, ps)
            out = (jc.has_pending_prefix(keys), tc.has_pending_prefix(keys))
        else:
            out = (jc.note_dedup_wait(), tc.note_dedup_wait())
        assert out[0] == out[1], (step, op)
        assert _state(jc) == _state(tc), (step, op)
    assert jrec.events == trec.events
    assert jc.stats()["inserts"] > 0


class _FakeCuda(torch.Tensor):
    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("global_pages", [False, True])
def test_b5_counts_launches_by_table_form(monkeypatch, global_pages):
    """Each launch adds one to `launches`; a global-table launch also to
    `launches_global`. A refused launch (non-zero CUDA error) counts
    nowhere."""
    calls = []

    def fake_kernel(*args):
        calls.append(args)
        return 0 if len(calls) == 1 else 700

    monkeypatch.setattr(rpa, "_kernel_fn", lambda: fake_kernel)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    B, T, P, ps = 2, 3, 2, 8
    q = torch.zeros(B, 1, 4, 64, dtype=torch.bfloat16).as_subclass(_FakeCuda)
    kv = torch.zeros(T if global_pages else B, P * ps, 2, 64,
                     dtype=torch.bfloat16)
    table = torch.tensor([[0, 1], [4, 5]], dtype=torch.int32)
    meta = rpa.LaneMeta(lengths=torch.tensor([3, 9], dtype=torch.int32),
                        page_table=table, page_size=ps,
                        global_pages=global_pages,
                        identity_pages=not global_pages)
    monkeypatch.setattr(rpa.ragged_paged_attention, "launches", 0)
    monkeypatch.setattr(rpa.ragged_paged_attention, "launches_global", 0)
    rpa.ragged_paged_attention(q, kv, kv, meta)
    assert rpa.ragged_paged_attention.launches == 1
    assert rpa.ragged_paged_attention.launches_global == int(global_pages)
    # The kernel got the whole pool under a global table: T * P pages.
    assert calls[0][12] == (T if global_pages else B) * P
    with pytest.raises(RuntimeError, match="launch failed"):
        rpa.ragged_paged_attention(q, kv, kv, meta)
    assert rpa.ragged_paged_attention.launches == 1
    assert rpa.ragged_paged_attention.launches_global == int(global_pages)
