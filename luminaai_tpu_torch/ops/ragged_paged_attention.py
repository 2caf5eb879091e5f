"""Ragged paged attention for the serving decode path (PyTorch + CUDA).

Counterpart of luminaai_tpu/ops/ragged_paged_attention.py. Three pieces:

- `ragged_paged_attention_ref`: the plain PyTorch version, a line-for-line
  counterpart of the JAX package's `ragged_paged_attention_xla`: page-table
  gather (local or global ids), per-lane length mask, `positions` for
  multi-row prefill chunks, optional sliding window. The CPU path, the
  prefill path (Sq > 1), and the oracle the kernel is held against.
- `ragged_paged_attention`: the wrapper of the Hopper kernel
  (csrc/ragged_paged_attention.cu, which replaces the TPU kernel
  `_decode_kernel`). On a CUDA tensor it launches the kernel, counting the
  launch in `ragged_paged_attention.launches`, and a launch with a global
  page table (the prefix cache's aliased arena pages) also in
  `ragged_paged_attention.launches_global`; on a CPU tensor it runs the
  plain version. It never falls back from the card.
- `paged_attention`: the backend dispatcher. 'ragged' takes the kernel for
  eligible decode shapes; prefill chunks take the plain version (the JAX
  package leaves them to XLA); an ineligible decode shape on the card
  raises. 'plain' always takes the plain version (the oracle run).

The kernel reads the pool in place: k/v arrive as the whole per-layer pool
and each lane's band is found through its page table, so nothing is
sliced, gathered or transposed per step.

int8 KV (config.kv_cache_dtype='int8'): each of k and v is a pair (codes
int8 [T, C, Hkv, D], scales fp32 [T, C, Hkv, 1]). On the card the wrapper
launches B5-int8 (`lumina_ragged_paged_attention_int8`), which reads the
codes and scales through the page table and dequantizes them where its
products use them (K's operand fragments in registers, each warp's V
columns in a shared region of its own); it counts in
`ragged_paged_attention.launches_int8`, the
bf16 kernel in `.launches`, and a launch of either over a global table
also in `.launches_global`. The plain version dequantizes, as the JAX
layer does before its attention, bf16(float(code) * scale), but only the
rows it reads: the lanes' resident extent, or the pages a global table
names. Nothing dequantizes the whole pool.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import torch

NEG_INF = -1e30


@dataclasses.dataclass
class LaneMeta:
    """Per-lane attention metadata for length-aware decode/prefill.

    lengths: [B] int32 rows resident per lane INCLUDING rows written by the
      current call (decode at position p => lengths = p + 1). 0 marks a lane
      with nothing attendable (its output is garbage the caller ignores).
      None makes the struct a backend hint only: the attention layer
      derives lengths/window/page_size itself and honours `backend`.
    page_table: [B, P] int32; logical page j of lane b lives at physical
      page `page_table[b, j]` of the lane's own page axis, or at global
      page id `slot * P_slot + page` under `global_pages`.
    backend: 'ragged' (kernel) | 'plain' | None (the layer's default).
    window: sliding-window width (None = full causal).
    page_size: rows per page.
    identity_pages: the table is the pool's identity layout, so the plain
      version may skip its gather (the kernel always follows the table).
    extent: resident-extent bound in rows (page aligned); the plain version
      reads only the first `extent` rows (or logical pages under
      global_pages). Every lane's length must be <= extent.
    global_pages: table entries are global (slot, page) ids into the whole
      pool [T, C, Hkv, D].
    """

    lengths: Optional[torch.Tensor] = None
    page_table: Optional[torch.Tensor] = None
    backend: Optional[str] = None
    window: Optional[int] = None
    page_size: int = 128
    identity_pages: bool = True
    extent: Optional[int] = None
    global_pages: bool = False
    # The kernel's [B, P] table of global ids, built once per LaneMeta and
    # shared by every layer's launch.
    _kernel_table: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def kernel_table(self, pages_per_slot: int) -> torch.Tensor:
        """Global page ids for the kernel: the table itself under
        global_pages, `b * P + table[b, j]` for a local table, the identity
        layout when there is no table."""
        if self._kernel_table is None:
            B = self.lengths.shape[0]
            dev = self.lengths.device
            if self.global_pages:
                table = self.page_table.to(torch.int32)
            else:
                if self.page_table is None:
                    local = torch.arange(
                        pages_per_slot, dtype=torch.int32, device=dev
                    ).expand(B, pages_per_slot)
                else:
                    local = self.page_table[:, :pages_per_slot].to(torch.int32)
                base = torch.arange(B, dtype=torch.int32, device=dev)
                table = base[:, None] * pages_per_slot + local
            self._kernel_table = table.contiguous()
        return self._kernel_table


def ragged_eligible(page_size: int, head_dim: int, s_q: int) -> bool:
    """When the decode kernel applies: one q row per lane, 8-row aligned
    pages, head_dim a multiple of 64 (the JAX package's gate, kept so both
    packages route the same shapes to their kernels)."""
    return s_q == 1 and page_size % 8 == 0 and head_dim % 64 == 0


def kernel_shape_error(s_q: int, Hq: int, Hkv: int, D: int,
                       page_size: int) -> Optional[str]:
    """Why the decode kernel refuses this shape, or None when it takes it
    (a pure function of the shape: the wrapper raises with its message).
    The kernel takes any group and any head_dim the gate admits (above 512
    in 512-column output slices)."""
    if not ragged_eligible(page_size, D, s_q):
        return (f"no kernel for s_q={s_q}, page_size={page_size}, "
                f"head_dim={D} (ragged_eligible)")
    if Hq <= 0 or Hkv <= 0 or Hq % Hkv:
        return f"Hq={Hq} is not a multiple of Hkv={Hkv}"
    return None


def cache_rows(side) -> int:
    """Rows C of a cache side [T, C, Hkv, D]: a tensor or an int8 (codes,
    scales) pair."""
    return (side[0] if isinstance(side, tuple) else side).shape[1]


def dequantize_kv(side, dtype) -> torch.Tensor:
    """bf16(float(code) * scale) (in `dtype`) of an int8 (codes, scales)
    side: the JAX layer's read of an int8 cache."""
    codes, scales = side
    return (codes.to(torch.float32) * scales).to(dtype)


def implied_page_size(cache_rows: int) -> int:
    """Page size for a LaneMeta derived inside the attention layer: the
    largest 8-aligned power of two dividing the cache extent, capped at
    128; the full extent when none divides it."""
    ps = 128
    while ps >= 8:
        if cache_rows % ps == 0:
            return ps
        ps //= 2
    return cache_rows


# ---------------------------------------------------------------------------
# Plain PyTorch version (oracle, CPU path, prefill path)
# ---------------------------------------------------------------------------
def ragged_paged_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    meta: LaneMeta,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Length-masked paged attention, reference semantics.

    q: [B, Sq, Hq, D]; k/v: [B, C, Hkv, D] flat with C == P * page_size
    (the caller's resident-extent slice), or the whole pool [T, C, Hkv, D]
    under meta.global_pages. positions: [B, Sq] absolute q positions for
    prefill chunks (-1 rows are padding and fully masked); decode (Sq == 1)
    derives the q position from lengths.
    """
    B, Sq, n_q, d = q.shape
    C, n_kv = k.shape[1], k.shape[2]
    ps = meta.page_size
    if meta.global_pages:
        # Global gather: [T, C] pool rows -> [T*P_all, ps] physical pages ->
        # [B, P_l, ps] logical pages per lane (extent-sliced table).
        T, P_all = k.shape[0], C // ps
        table = meta.page_table.long()
        if meta.extent is not None and meta.extent < C:
            table = table[:, : meta.extent // ps]
        P_l = table.shape[1]
        k = k.reshape(T * P_all, ps, n_kv, d)[table].reshape(
            B, P_l * ps, n_kv, d
        )
        v = v.reshape(T * P_all, ps, n_kv, d)[table].reshape(
            B, P_l * ps, n_kv, d
        )
        C = P_l * ps
    elif meta.page_table is not None and not meta.identity_pages:
        # Physical gather through the page table off the lane's own pages.
        P = C // ps
        table = meta.page_table[:, :P].long()
        lanes = torch.arange(B, device=q.device)[:, None]
        k = k.reshape(B, P, ps, n_kv, d)[lanes, table].reshape(B, C, n_kv, d)
        v = v.reshape(B, P, ps, n_kv, d)[lanes, table].reshape(B, C, n_kv, d)

    g = n_q // n_kv
    qg = q.reshape(B, Sq, n_kv, g, d)
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * scale

    lengths = meta.lengths.long()
    if positions is not None:
        qp = positions.long()[:, :, None]  # [B, Sq, 1]; -1 rows mask all
    else:
        qp = (lengths[:, None, None] - Sq) + torch.arange(
            Sq, device=q.device
        )[None, :, None]
    kp = torch.arange(C, device=q.device)[None, None, :]
    mask = (kp <= qp) & (kp < lengths[:, None, None])
    if meta.window is not None:
        mask = mask & (qp - kp < meta.window)
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, n_q, d)


def _dequantized_read(dtype, k, v, meta):
    """The int8 sides dequantized where the plain version reads them: a
    global table's named pages (extent-sliced) gathered first, the result
    then read as a local identity layout; otherwise the rows as given
    (ragged_paged_attention_plain has sliced them to the extent)."""
    if not meta.global_pages:
        return dequantize_kv(k, dtype), dequantize_kv(v, dtype), meta
    ps = meta.page_size
    T, C = k[0].shape[:2]
    table = meta.page_table.long()
    if meta.extent is not None and meta.extent < C:
        table = table[:, : meta.extent // ps]
    B, P_l = table.shape

    def gather(t):
        pages = t.reshape(T * (C // ps), ps, *t.shape[2:])
        return pages[table].reshape(B, P_l * ps, *t.shape[2:])

    k = dequantize_kv(tuple(gather(t) for t in k), dtype)
    v = dequantize_kv(tuple(gather(t) for t in v), dtype)
    meta = dataclasses.replace(meta, page_table=None, identity_pages=True,
                               extent=None, global_pages=False,
                               _kernel_table=None)
    return k, v, meta


def ragged_paged_attention_plain(q, k, v, meta, positions=None):
    """The plain version over the resident extent: local-table callers
    hand over the whole lane rows, so slice them to meta.extent here (a
    view); global tables slice their table inside the reference. int8
    sides are dequantized over what is read."""
    if (
        not meta.global_pages
        and meta.extent is not None
        and meta.extent < cache_rows(k)
    ):
        n = meta.extent
        k, v = [tuple(t[:, :n] for t in x) if isinstance(x, tuple)
                else x[:, :n] for x in (k, v)]
    if isinstance(k, tuple):
        k, v, meta = _dequantized_read(q.dtype, k, v, meta)
    return ragged_paged_attention_ref(q, k, v, meta, positions=positions)


# ---------------------------------------------------------------------------
# Hopper kernel wrapper
# ---------------------------------------------------------------------------
_FN_ARGS = {"lumina_ragged_paged_attention": 6,
            "lumina_ragged_paged_attention_int8": 8}


def _kernel_fn(name: str = "lumina_ragged_paged_attention"):
    from luminaai_tpu_torch.ops import _build

    lib = _build.load("ragged_paged_attention")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * _FN_ARGS[name] + [i] * 8
                       + [ctypes.c_float, p])
        fn.restype = ctypes.c_int
    return fn


def _check_side(name, side, shape, device):
    """An int8 side: contiguous int8 codes `shape` and fp32 scales
    `shape[:-1] + (1,)` on `device`."""
    codes, scales = side
    want = {"codes": (codes, torch.int8, shape),
            "scales": (scales, torch.float32, shape[:-1] + (1,))}
    for part, (t, dtype, sh) in want.items():
        if t.dtype != dtype or not t.is_contiguous() or tuple(t.shape) != sh:
            raise ValueError(
                f"{name} {part} must be contiguous {dtype} {sh}, got "
                f"{t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} {part} is on {t.device}, q on {device}")


def _wide_int8_scratch(k, v, meta, dtype):
    """Head dims above 512 have no int8 kernel: the pages the lanes reach
    (up to their longest length) dequantized into a bf16 scratch pool, and
    its [B, P] table of scratch page ids."""
    ps = meta.page_size
    T, C = k[0].shape[:2]
    n = max(1, -(-int(meta.lengths.max().item()) // ps))
    ids = meta.kernel_table(C // ps)[:, :n].long().reshape(-1)

    def gather(side):
        return dequantize_kv(tuple(
            t.reshape(T * (C // ps), ps, *t.shape[2:]).index_select(0, ids)
            for t in side), dtype).contiguous()

    B = meta.lengths.shape[0]
    table = torch.arange(B * n, dtype=torch.int32,
                         device=ids.device).view(B, n)
    return gather(k), gather(v), table


def ragged_paged_attention(
    q: torch.Tensor,
    k,
    v,
    meta: LaneMeta,
) -> torch.Tensor:
    """Page-table-native decode attention.

    q: [B, 1, Hq, D]; k/v: [T, C, Hkv, D] with C == P * meta.page_size: the
    lanes' own rows (T == B, local table) or the whole pool (global table);
    or int8 (codes, scales) pairs of those shapes. Returns [B, 1, Hq, D].
    On the card: bf16 q, contiguous, one kernel launch (B5, or B5-int8 for
    int8 sides). On the CPU: the plain version.
    """
    if not q.is_cuda:
        return ragged_paged_attention_plain(q, k, v, meta)
    int8 = isinstance(k, tuple)
    B, Sq, Hq, D = q.shape
    shape = tuple((k[0] if int8 else k).shape)
    T, C, Hkv = shape[:3]
    ps = meta.page_size
    if Sq != 1:
        raise ValueError("the decode kernel takes one q row per lane")
    err = kernel_shape_error(Sq, Hq, Hkv, D, ps)
    if err or C % ps:
        raise ValueError(err or f"pool rows C={C} are not whole pages of "
                                f"{ps}")
    if meta.lengths is None or meta.lengths.shape != (B,):
        raise ValueError("the decode kernel needs per-lane lengths [B]")
    if not meta.global_pages and T != B:
        raise ValueError(f"local page tables need one k/v row per lane: {T} != {B}")
    if q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise ValueError(f"q must be contiguous bf16, got {q.dtype}")
    if shape[3] != D:
        raise ValueError(f"k {shape} does not match q's head_dim {D}")
    if int8:
        for name, side in (("k", k), ("v", v)):
            _check_side(name, side, shape, q.device)
    else:
        for name, t in (("k", k), ("v", v)):
            if t.dtype != torch.bfloat16 or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous bf16, got {t.dtype}")
            if t.device != q.device:
                raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if k.shape != v.shape:
            raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} mismatch")
    P_slot = C // ps
    table = meta.kernel_table(P_slot)
    lengths = meta.lengths
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        lengths = lengths.to(torch.int32).contiguous()
    if table.device != q.device or lengths.device != q.device:
        raise ValueError("page table and lengths must be on q's device")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tail = (int(meta.window or 0), 1.0 / math.sqrt(D), stream)
    if int8 and D > 512:
        k, v, table = _wide_int8_scratch(k, v, meta, q.dtype)
        name, counted = "int8 (wide)", "launches_int8"
        err = _kernel_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), B, Hq, Hkv, D, ps,
            table.shape[1], table.numel(), *tail)
    elif int8:
        name, counted = "int8", "launches_int8"
        err = _kernel_fn("lumina_ragged_paged_attention_int8")(
            q.data_ptr(), k[0].data_ptr(), k[1].data_ptr(), v[0].data_ptr(),
            v[1].data_ptr(), table.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), B, Hq, Hkv, D, ps, table.shape[1], T * P_slot,
            *tail)
    else:
        name, counted = "bf16", "launches"
        err = _kernel_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, D, ps, table.shape[1], T * P_slot, *tail)
    if err != 0:
        raise RuntimeError(
            f"ragged_paged_attention ({name}) launch failed: CUDA error {err}")
    setattr(ragged_paged_attention, counted,
            getattr(ragged_paged_attention, counted) + 1)
    if meta.global_pages:
        ragged_paged_attention.launches_global += 1
    return out


ragged_paged_attention.launches = 0
ragged_paged_attention.launches_int8 = 0
ragged_paged_attention.launches_global = 0


def paged_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    meta: LaneMeta,
    *,
    backend: str = "ragged",
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Backend dispatcher:

    'ragged'  the kernel for eligible decode shapes (B5-int8 for int8
              sides); prefill chunks (Sq > 1) take the plain version,
              which dequantizes only the rows it reads; an ineligible decode shape
              on the card raises (there is no kernel for it, and the card
              path never falls back)
    'plain'   always the plain version (the oracle)
    """
    Sq, D = q.shape[1], q.shape[3]
    if backend == "ragged":
        if ragged_eligible(meta.page_size, D, Sq):
            return ragged_paged_attention(q, k, v, meta)
        if q.is_cuda and Sq == 1:
            raise ValueError(
                f"decode shape page_size={meta.page_size}, head_dim={D} is "
                "not eligible for the ragged kernel"
            )
    elif backend != "plain":
        raise ValueError(f"unknown attention backend {backend!r}")
    return ragged_paged_attention_plain(
        q, k, v, meta, positions=positions if Sq > 1 else None)
