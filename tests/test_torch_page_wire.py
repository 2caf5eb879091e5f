"""The LPG1 page wire format (inference/kv_pool.py) against the JAX pool's.

Both pools hold the same K/V (made from a numpy seed; bf16, fp32, and
int8: codes [.., head_dim] plus fp32 scales [.., 1] per side, the JAX
int8 cache tree's leaves), laid out [slots, pages, page_size, kv_heads,
head_dim] per layer and side, with arena slots past the lane range as the
prefix cache carves them.

- A port page's LPG1 bytes equal JAX's `PagedKVPool.export_page` bytes,
  header and leaves, byte for byte (exact: no tolerance).
- JAX bytes imported into the port and exported again are byte-identical,
  and so are port bytes imported into JAX.
- `parse_page_payload` rejects every framing violation the JAX parser
  rejects, and a payload whose leaves do not fit the pool raises before
  any tensor changes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from luminaai_tpu.inference import kv_pool as jkv
from luminaai_tpu_torch.inference import kv_pool as tkv

LAYERS, SLOTS, LANES, PAGES, PS, HKV, HD = 2, 3, 2, 4, 8, 2, 16


def _pools(dtype, seed=0):
    """The same K/V in a JAX pool and a port pool (LANES lane slots, the
    rest arena)."""
    rng = np.random.RandomState(seed)
    jc, tc = [], []
    for _ in range(LAYERS):
        jpair, tpair = [], []
        for _ in range(2):
            x = rng.randn(SLOTS, PAGES, PS, HKV, HD).astype(np.float32)
            if dtype == "int8":
                codes = rng.randint(-127, 128, x.shape).astype(np.int8)
                scales = rng.rand(*x.shape[:-1], 1).astype(np.float32)
                j = (jnp.asarray(codes), jnp.asarray(scales))
                t = (torch.from_numpy(codes.copy()),
                     torch.from_numpy(scales.copy()))
            elif dtype == "bfloat16":
                j = jnp.asarray(x).astype(jnp.bfloat16)
                bits = np.asarray(j).view(np.uint16).view(np.int16).copy()
                t = torch.from_numpy(bits).view(torch.bfloat16)
            else:
                j, t = jnp.asarray(x), torch.from_numpy(x.copy())
            jpair.append(j)
            tpair.append(t)
        jc.append(tuple(jpair))
        tc.append(tuple(tpair))
    return (jkv.PagedKVPool(jc, LANES, PAGES, PS),
            tkv.PagedKVPool(tc, LANES, PAGES, PS))


GIDS = (0, 5, LANES * PAGES + 1, SLOTS * PAGES - 1)  # lanes and arena


DTYPES = ["bfloat16", "float32", "int8"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_export_bytes_equal_jax(dtype):
    jp, tp = _pools(dtype)
    assert tkv.PAGE_WIRE_MAGIC == jkv.PAGE_WIRE_MAGIC
    for gid in GIDS:
        want = jp.export_page(gid)
        got = tp.export_page(gid)
        assert got == want, gid
        leaves = tkv.parse_page_payload(got)
        per_side = 2 if dtype == "int8" else 1  # codes and scales
        assert len(leaves) == 2 * per_side * LAYERS
        shapes = [(PS, HKV, HD), (PS, HKV, 1)][:per_side] * 2 * LAYERS
        assert [tuple(x.shape) for x in leaves] == shapes


@pytest.mark.parametrize("dtype", DTYPES)
def test_import_round_trips_both_ways(dtype):
    jp, tp = _pools(dtype, seed=1)
    jp2, tp2 = _pools(dtype, seed=2)  # other bytes everywhere
    for src, dst in ((GIDS[1], GIDS[2]), (GIDS[3], 0)):
        jbytes = jp.export_page(src)
        # JAX -> port -> bytes.
        assert tp2.import_page(dst, jbytes) == len(jbytes)
        assert tp2.export_page(dst) == jbytes
        # port -> JAX -> bytes.
        tbytes = tp.export_page(src)
        assert jp2.import_page(dst, tbytes) == len(tbytes)
        assert jp2.export_page(dst) == tbytes
    # Parsed leaves are the pool's values, in layer order (k, v per layer;
    # int8: k codes, k scales, v codes, v scales).
    leaves = tkv.parse_page_payload(tp.export_page(GIDS[1]))
    slot, page = divmod(GIDS[1], PAGES)
    flat = tkv.cache_leaves(tp.caches)
    for leaf, t in zip(leaves, flat):
        assert torch.equal(leaf, t[slot, page])


def _framed(header: bytes) -> bytes:
    return tkv.PAGE_WIRE_MAGIC + len(header).to_bytes(4, "big") + header


GOOD_HEADER = (b'{"page_size": 4, "leaves": [{"shape": [2, 1, 1], '
               b'"dtype": "float32"}]}')
BODY = np.zeros((2, 1, 1), np.float32).tobytes()

# The violations JAX's parser rejects (tests/test_page_share.py), plus a
# header that is not JSON.
VIOLATIONS = {
    "magic": (b"NOPE" + b"\x00" * 16, "magic"),
    "short_header": (tkv.PAGE_WIRE_MAGIC + b"\x00\x00", "truncated"),
    "short_body": (_framed(GOOD_HEADER) + BODY[:-1], "truncated"),
    "trailing": (_framed(GOOD_HEADER) + BODY + b"x", "trailing"),
    "bad_json": (_framed(b"{not json"), "header"),
}


@pytest.mark.parametrize("case", sorted(VIOLATIONS))
def test_parse_rejects_framing_violations(case):
    payload, match = VIOLATIONS[case]
    with pytest.raises(ValueError, match=match):
        jkv.parse_page_payload(payload)
    with pytest.raises(ValueError, match=match):
        tkv.parse_page_payload(payload)
    leaves = tkv.parse_page_payload(_framed(GOOD_HEADER) + BODY)
    assert len(leaves) == 1 and tuple(leaves[0].shape) == (2, 1, 1)
    assert leaves[0].dtype == torch.float32


def test_parse_rejects_unknown_dtype_and_bad_leaf():
    # An unknown name, a numpy dtype no cache holds (int16), a negative or
    # missing shape, a header that is not an object.
    for header in (
        b'{"page_size": 4, "leaves": [{"shape": [2], "dtype": "nope"}]}',
        b'{"page_size": 4, "leaves": [{"shape": [1], "dtype": "int16"}]}',
        b'{"page_size": 4, "leaves": [{"shape": [-2], "dtype": "float32"}]}',
        b'{"page_size": 4, "leaves": [{"dtype": "float32"}]}',
        b'[1, 2]',
    ):
        with pytest.raises(ValueError):
            tkv.parse_page_payload(_framed(header) + b"\x00\x00")


def _mutate_last_leaf(payload: bytes, **meta) -> bytes:
    """Re-frame a payload with its last leaf's header entry changed (the
    body resized to match, so only the leaf check can refuse it)."""
    import json

    hlen = int.from_bytes(payload[4:8], "big")
    header = json.loads(payload[8:8 + hlen])
    body = payload[8 + hlen:]
    last = header["leaves"][-1]
    old_n = int(np.prod(last["shape"])) * np.dtype(last["dtype"]).itemsize
    last.update(meta)
    new_n = int(np.prod(last["shape"])) * np.dtype(last["dtype"]).itemsize
    body = body[:len(body) - old_n] + b"\x01" * new_n
    return _framed(json.dumps(header).encode()) + body


@pytest.mark.parametrize("fault", ["shape", "dtype", "leaves", "gid"])
def test_mismatched_payload_raises_before_any_write(fault):
    _, tp = _pools("bfloat16", seed=3)
    good = tp.export_page(GIDS[1])
    before = [t.clone() for kv in tp.caches for t in kv]
    gid = GIDS[2]
    if fault == "shape":
        bad = _mutate_last_leaf(good, shape=[PS, HKV, HD // 2])
    elif fault == "dtype":
        bad = _mutate_last_leaf(good, dtype="float32")
    elif fault == "leaves":
        bad = _mutate_last_leaf(good)[:-(PS * HKV * HD * 2)]
        import json

        hlen = int.from_bytes(bad[4:8], "big")
        header = json.loads(bad[8:8 + hlen])
        header["leaves"] = header["leaves"][:-1]
        bad = _framed(json.dumps(header).encode()) + bad[8 + hlen:]
    else:
        bad, gid = good, SLOTS * PAGES  # one past the physical pool
    with pytest.raises(ValueError, match="leaf|leaves|outside"):
        tp.import_page(gid, bad)
    after = [t for kv in tp.caches for t in kv]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
