// Ragged paged decode attention for Hopper (sm_90a): B5.
//
// Replaces the TPU kernel luminaai_tpu/ops/ragged_paged_attention.py
// `_decode_kernel` (launched by `ragged_paged_attention`). It computes the
// same function: one query row per lane at position lengths[b]-1, attending
// over the lane's resident rows of the slot-paged KV pool through its page
// table, with an optional sliding window; fp32 scores and online softmax,
// P rounded to bf16 before the P.V product, output divided by the running
// denominator (a lane with length 0 writes zeros).
//
// Layouts (all contiguous, bf16 unless stated):
//   q       [B, Hq, D]                     one decode row per lane
//   k, v    [n_pages, page_size, Hkv, D]   the whole pool, pages addressed
//                                          by GLOBAL id (slot * P_slot + p)
//   table   [B, P] int32                   global page id of each lane's
//                                          logical page j
//   lengths [B] int32                      rows resident per lane
//   out     [B, Hq, D]
//
// Bound. Decode attention is memory bound: the least time is the resident
// K/V bytes, sum(lengths) * Hkv * D * 2 (K and V) * 2 bytes per layer, over
// 3.35 TB/s on an H100 SXM (13.7 MB, 4.1 us at the b1 decode shape of
// chip_smoke.py: 8 lanes of 1-2048 rows, 4 kv heads, head_dim 128).
//
// Design: split-KV over a thread-block cluster (head_dim up to 512). The
// first kernel ran one block per (kv head, lane, chunk of 8 q heads): 32
// blocks on 132 SMs at b1 decode, the longest lane's 1 MB of K/V through
// one SM, tiles loaded synchronously and scored by a serial dot product per
// thread. Here one cluster of `split` blocks (1-8, chosen on the host from
// B x Hkv x head chunks alone, aiming at two blocks per SM: 8 at b1 decode,
// 256 blocks) serves each (kv head, lane, chunk of up to 16 q heads); block
// `rank` takes a contiguous share of the lane's band [start, length) in
// tiles of R rows (64 up to head_dim 128, 32 up to 256, 16 up to 512; a
// tile's K and V are ~34 KB). Lengths stay on the device: a block whose
// share is empty contributes the state (max -inf, sum 0).
// - K/V rows are resolved through the page table and fetched by cp.async
//   16-byte copies (rows past the band zero-filled) into a 3-tile ring, so
//   two tiles' loads are in flight while one computes. TMA cannot follow a
//   page table row by row; cp.async serves the gather.
// - Scores and P.V run on tensor cores (mma.sync m16n8k16, operands by
//   ldmatrix), the chunk's q heads as the 16 A rows, so a group of 16 reads
//   K/V once. Each of the 4 warps computes the whole tile's scores and the
//   same softmax state (no cross-warp exchange per tile) and owns a quarter
//   of the output columns.
// - The blocks' partial (max, sum, fp32 output) states meet through
//   distributed shared memory: after a cluster barrier every rank reads all
//   ranks' (max, sum), weighs their outputs and writes its slice of the
//   group's output columns; a second barrier keeps the shared memory alive
//   until all reads are done. One launch, no device scratch.
//
// int8 KV (B5-int8, `lumina_ragged_paged_attention_int8`): the pool holds
// int8 codes [n_pages, page_size, Hkv, D] and fp32 per-row scales
// [n_pages, page_size, Hkv, 1] (quantized at insert over head_dim, the JAX
// int8 cache). The split kernel's template flag kInt8 swaps its loads and
// its B operands; the grid, the cluster merge, the 16-head A rows and the
// warps' output columns stay. The code rows (half a bf16 tile's bytes) and
// the tile's R scales per side go through the same page table by cp.async
// into a 3-stage ring, and the codes become bf16(float(code) * scale),
// rounded to nearest even (the plain version's `dequantize_kv`), where
// they are used, with one block barrier a tile (the ring's):
// - K, the B operand of S = Q K^T, which every warp needs whole: each lane
//   dequantizes its own B fragments in registers from 16-byte reads of the
//   code ring. q's columns are placed in shared memory so that a lane's
//   four k slots of four consecutive k steps are 16 consecutive codes of
//   one K row (q_slot); no bf16 K tile, no ldmatrix of K.
// - V, the B operand of O += P V, of which each warp reads only its D / 4
//   columns: each warp dequantizes those columns into a warp-private bf16
//   region (__syncwarp, not __syncthreads) that ldmatrix.trans reads as
//   before. A register path would need a byte transpose (the fragment
//   holds two rows of one column) and was not taken.
// A warp converts while the others run their products. K's conversions are
// repeated by each of the 4 warps (the price of no exchange): (4 R D + R
// D) codes a block a tile, about 3.75 instructions a code (prmt, fsub,
// fmul, half a cvt). Bound: sum(lengths) * Hkv * (D + 4) * 2 bytes a layer
// (about 52% of the bf16 bound at head_dim 128). At the b1 decode shape
// the kernel takes ~12x that bound, as bf16 B5 takes ~7x its own: a
// block walks a few tiles (the longest lane's 32 over 8 ranks), so the
// chain of page-table, copy and merge latencies sets the time; dequantizing
// one shared bf16 tile between two block barriers instead was 1.4x slower
// (PERF.md). Head dims above 512 reach no int8 kernel: the wrapper
// dequantizes only the pages the lanes reach into a bf16 scratch and
// launches the wide kernel below.
//
// Head dims above 512 (any multiple of 8 the gate admits) take
// ragged_decode_kernel_wide, the first kernel's design: one block per (kv
// head, lane, chunk of 8 q heads, 512-column output slice), the scores
// summed over D in 512-column chunks of q and K staged one at a time (the
// slices recompute the scores; no preset uses such head dims).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// Split-KV kernel (head_dim <= 512)
// ---------------------------------------------------------------------------
constexpr int kHeads = 16;     // q heads per block: the A rows of the products
constexpr int kStages = 3;     // tiles in the cp.async ring
constexpr int kMaxSplit = 8;   // blocks per cluster (the portable limit)
constexpr int kSplitDim = 512;
constexpr int kPad = 8;        // bf16 per shared row: conflict-free ldmatrix

// K/V rows per tile for a head_dim.
int split_rows(int D) { return D <= 128 ? 64 : D <= 256 ? 32 : 16; }

// Shared memory of the split kernel. bf16: q rows, then the ring of bf16
// K/V tiles (the final fp32 state reuses it). int8: q rows, each warp's
// bf16 V region (R rows of its D / 4 columns), the ring of int8 code tiles
// (the final state reuses it), the ring's fp32 scales. Both end with the
// merge's (max, sum, weights).
size_t split_smem(int R, int D, bool int8) {
  const size_t ld = D + kPad;
  const size_t state = kHeads * D * sizeof(float);
  size_t body;
  if (int8) {
    const size_t ring = kStages * 2 * R * D;
    body = kWarps * R * (D / 4 + kPad) * sizeof(bf16) + (ring > state ? ring : state) +
           kStages * 2 * R * sizeof(float);
  } else {
    const size_t ring = kStages * 2 * R * ld * sizeof(bf16);
    body = ring > state ? ring : state;
  }
  return kHeads * ld * sizeof(bf16) + body +
         sizeof(float) * (2 * kHeads + kHeads * kMaxSplit);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes (one fp32 scale); bytes 0 zero-fills.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// Four int8 codes (one 32-bit word, code j in byte j) times one scale ->
// two packed bf16 pairs (codes 0, 1 and 2, 3), bf16(float(code) * scale)
// rounded to nearest even, the plain version's dequantize_kv. float(code)
// is exact without a conversion instruction: byte ^ 0x80 is code + 128,
// placed in the mantissa of 2^23, and 2^23 + 128 subtracted.
__device__ __forceinline__ void dequant4(uint32_t codes, float scale, uint32_t& lo,
                                         uint32_t& hi) {
  const uint32_t biased = codes ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float x = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540u + j));
    f[j] = __fmul_rn(__fsub_rn(x, 8388736.f), scale);
  }
  lo = pack_f32(f[0], f[1]);
  hi = pack_f32(f[2], f[3]);
}

// The int8 ring's 16-byte chunk c of tile row r lies at chunk c ^
// code_swizzle(r, D) of the row, so that the S product's reads (8 lanes: 2
// rows x 4 chunks) and the V dequantize's (8 lanes: 8 rows, one chunk) hit
// 8 distinct bank groups. A row of D % 128 == 64 bytes already puts its odd
// rows in the other half of the banks.
__device__ __forceinline__ int code_swizzle(int r, int D) {
  return D % 128 == 0 ? ((r & 1) << 2) | ((r >> 1) & 3) : (r >> 1) & 3;
}

// Where B5-int8 keeps q column c (even; c + 1 follows it) in its shared q
// rows: c = 64 j + 16 t4 + 4 m + 2 hi + e is k slot 8 hi + 2 t4 + e of
// mma k step 4 j + m. Lane (g, t4) then finds its B fragment of step 4 j
// + m in bytes 4 m .. 4 m + 3 of chunk 4 j + t4 of its K row: one 16-byte
// load serves four k steps. (The reduction over head_dim runs in another
// order; each q . k product is the same.)
__device__ __forceinline__ int q_slot(int c) {
  return (4 * (c / 64) + ((c >> 2) & 3)) * 16 + ((c >> 1) & 1) * 8 + 2 * ((c >> 4) & 3);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. trans: each thread gets a column pair instead.
template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  if constexpr (kTrans) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
  }
}

// c += A(16x16, row) * B(16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Grid (split, Hkv x head chunks, B), clusters of (split, 1, 1). k and v
// are bf16 rows, or int8 code rows with k_scale / v_scale under kInt8.
template <int R, bool kInt8>
__global__ void __launch_bounds__(kThreads, 2)
ragged_decode_kernel_split(const bf16* __restrict__ q, const void* __restrict__ k,
                           const void* __restrict__ v, const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale, const int* __restrict__ table,
                           const int* __restrict__ lengths, bf16* __restrict__ out, int Hq,
                           int Hkv, int D, int page_size, int P, int n_pages, int window,
                           float scale) {
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int G = Hq / Hkv, chunks = (G + kHeads - 1) / kHeads;
  const int h = blockIdx.y / chunks, g0 = (blockIdx.y % chunks) * kHeads;
  const int b = blockIdx.z;
  const int group = min(kHeads, G - g0);
  const int q_head0 = h * G + g0;
  const int ld = D + kPad;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  extern __shared__ uint4 smem_u4[];
  bf16* q_sm = reinterpret_cast<bf16*>(smem_u4);  // [kHeads][ld]
  // bf16: ring = kStages x (K [R][ld], V [R][ld]). int8: ring = the warps'
  // V regions kWarps x [R][ldv], then the int8 code ring kStages x (K
  // [R][D], V [R][D], chunks swizzled) and its scales kStages x (K [R], V
  // [R]).
  bf16* ring = q_sm + kHeads * ld;
  const int ldv = D / 4 + kPad;
  const size_t state_bytes = static_cast<size_t>(kHeads) * D * sizeof(float);
  int8_t* codes = nullptr;
  float* scales = nullptr;
  float* o_sm;  // fp32 [kHeads][D]: the block's final state
  float* m_sm;
  if constexpr (kInt8) {
    codes = reinterpret_cast<int8_t*>(ring + kWarps * R * ldv);
    const size_t ring_bytes = static_cast<size_t>(kStages) * 2 * R * D;
    scales = reinterpret_cast<float*>(codes + (ring_bytes > state_bytes ? ring_bytes
                                                                         : state_bytes));
    o_sm = reinterpret_cast<float*>(codes);
    m_sm = scales + kStages * 2 * R;
  } else {
    const size_t ring_bytes = static_cast<size_t>(kStages) * 2 * R * ld * sizeof(bf16);
    o_sm = reinterpret_cast<float*>(ring);
    m_sm = reinterpret_cast<float*>(reinterpret_cast<char*>(ring) +
                                    (ring_bytes > state_bytes ? ring_bytes : state_bytes));
  }
  float* l_sm = m_sm + kHeads;
  float* w_sm = l_sm + kHeads;  // [kHeads][kMaxSplit]: each rank's weight

  int length = lengths[b];
  length = max(0, min(length, P * page_size));
  const int start = window > 0 ? max(length - window, 0) : 0;
  const int tiles = (length - start + R - 1) / R;
  const int t_begin = tiles * rank / split, t_end = tiles * (rank + 1) / split;
  const int n_t = t_end - t_begin;
  const int* lane_table = table + static_cast<size_t>(b) * P;

  // The chunk's q rows; rows past the group are zeros. int8: each column
  // pair at its q_slot.
  const bf16* q_lane = q + (static_cast<size_t>(b) * Hq + q_head0) * D;
  if constexpr (kInt8) {
    for (int i = tid; i < kHeads * (D / 2); i += kThreads) {
      const int hh = i / (D / 2), c = 2 * (i - hh * (D / 2));
      uint32_t val = 0u;
      if (hh < group) val = *reinterpret_cast<const uint32_t*>(q_lane + hh * D + c);
      *reinterpret_cast<uint32_t*>(q_sm + hh * ld + q_slot(c)) = val;
    }
  } else {
    for (int i = tid; i < kHeads * (D / 8); i += kThreads) {
      const int hh = i / (D / 8), c = i - hh * (D / 8);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (hh < group) val = *reinterpret_cast<const uint4*>(q_lane + hh * D + c * 8);
      *reinterpret_cast<uint4*>(q_sm + hh * ld + c * 8) = val;
    }
  }

  // The pool row (page-table resolved) of band row kp, or 0 past the band.
  auto pool_row = [&](int kp) -> size_t {
    if (kp >= length) return 0;
    int phys = lane_table[kp / page_size];
    phys = min(max(phys, 0), n_pages - 1);
    return (static_cast<size_t>(phys) * page_size + kp % page_size) * Hkv + h;
  };

  // cp.async the K and V rows of band tile `t` into ring slot `st` (rows
  // past the band zero-filled: int8 codes and scales 0 dequantize to 0).
  auto load = [&](int t, int st) {
    const int row0 = start + t * R;
    if constexpr (kInt8) {
      int8_t* k_st = codes + static_cast<size_t>(st) * 2 * R * D;
      int8_t* v_st = k_st + R * D;
      const int8_t* kc = static_cast<const int8_t*>(k);
      const int8_t* vc = static_cast<const int8_t*>(v);
      for (int c = tid; c < R * (D / 16); c += kThreads) {
        const int r = c / (D / 16), cc = c - r * (D / 16);
        const int kp = row0 + r;
        const size_t off = pool_row(kp) * D + cc * 16;
        const int bytes = kp < length ? 16 : 0;
        const int dst = r * D + (cc ^ code_swizzle(r, D)) * 16;
        cp_async16(k_st + dst, kc + off, bytes);
        cp_async16(v_st + dst, vc + off, bytes);
      }
      float* ks_st = scales + static_cast<size_t>(st) * 2 * R;
      for (int r = tid; r < R; r += kThreads) {
        const int kp = row0 + r;
        const size_t row = pool_row(kp);
        const int bytes = kp < length ? 4 : 0;
        cp_async4(ks_st + r, k_scale + row, bytes);
        cp_async4(ks_st + R + r, v_scale + row, bytes);
      }
    } else {
      bf16* k_st = ring + static_cast<size_t>(st) * 2 * R * ld;
      bf16* v_st = k_st + R * ld;
      const bf16* kb = static_cast<const bf16*>(k);
      const bf16* vb = static_cast<const bf16*>(v);
      for (int c = tid; c < R * (D / 8); c += kThreads) {
        const int r = c / (D / 8), cc = c - r * (D / 8);
        const int kp = row0 + r;
        const size_t off = pool_row(kp) * D + cc * 8;
        const int bytes = kp < length ? 16 : 0;  // zero-fill rows past the band
        cp_async16(k_st + r * ld + cc * 8, kb + off, bytes);
        cp_async16(v_st + r * ld + cc * 8, vb + off, bytes);
      }
    }
  };

  // Warp `warp` owns output columns [c_w, c_w + D / 4): D / 64 pairs of
  // 8-column tiles, at most kPairs (2 up to head_dim 128, 8 at 512).
  constexpr int kPairs = 128 / R;
  const int c_w = warp * (D / 4), pairs = D / 64;
  const float scale_log2 = scale * 1.4426950408889634f;
  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};
  float o[2 * kPairs][4];
#pragma unroll
  for (int n = 0; n < 2 * kPairs; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_t) load(t_begin + i, i);
    cp_async_commit();
  }
  for (int i = 0; i < n_t; ++i) {
    cp_async_wait<kStages - 2>();  // tile i has landed (this thread's copies)
    __syncthreads();               // ... and every thread's; slot i - 1 is free
    if (i + kStages - 1 < n_t) load(t_begin + i + kStages - 1, (i + kStages - 1) % kStages);
    cp_async_commit();

    const int rows = min(R, length - (start + (t_begin + i) * R));
    const int mrow = (lane >> 3), r8 = lane & 7;
    // The B operand of P V: the stage's V tile at the warp's columns (bf16),
    // or the warp's own region of dequantized V (int8).
    const bf16* v_op;
    int v_ld;

    // S = Q K^T: the chunk's 16 heads x the tile's R rows.
    float s[R / 8][4];
#pragma unroll
    for (int n = 0; n < R / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    if constexpr (kInt8) {
      // K's B fragments dequantized in registers: lane (g, t4) reads chunk
      // 4 j + t4 of rows 8 n + g (16 codes, four k steps; see q_slot) and
      // multiplies them by the row's scale. No bf16 K tile, no barrier.
      const int8_t* kc = codes + static_cast<size_t>(i % kStages) * 2 * R * D;
      const float* ksc = scales + static_cast<size_t>(i % kStages) * 2 * R;
      const int swz = code_swizzle(g, D);  // code_swizzle(8 n + g, D) for every n
      float kscale[R / 8];
#pragma unroll
      for (int n = 0; n < R / 8; ++n) kscale[n] = ksc[8 * n + g];
      for (int j = 0; j < D / 64; ++j) {
        uint32_t a[4][4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          ldmatrix_x4<false>(a[m], q_sm + ((mrow & 1) * 8 + r8) * ld + (4 * j + m) * 16 +
                                       (mrow >> 1) * 8);
        }
#pragma unroll
        for (int n = 0; n < R / 8; ++n) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              kc + (8 * n + g) * D + ((4 * j + t4) ^ swz) * 16);
          const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            uint32_t b0, b1;
            dequant4(w[m], kscale[n], b0, b1);
            mma(s[n], a[m], b0, b1);
          }
        }
      }

      // This warp's D / 4 columns of V dequantized into its own region for
      // the ldmatrix.trans of P V (a lane converts one row's 16-code chunk
      // at a time, 8 lanes on 8 rows); only this warp reads the region, so
      // __syncwarp orders it.
      const int8_t* vc = kc + R * D;
      const float* vsc = ksc + R;
      const int nch = D / 64, ch0 = warp * nch;
      bf16* v_w = ring + warp * R * ldv;
      __syncwarp();  // this warp's reads of the previous tile are done
      for (int u = lane; u < R * nch; u += 32) {
        const int r = u % R, ch = u / R;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            vc + r * D + ((ch0 + ch) ^ code_swizzle(r, D)) * 16);
        const float sc = vsc[r];
        uint32_t w[8];
        dequant4(raw.x, sc, w[0], w[1]);
        dequant4(raw.y, sc, w[2], w[3]);
        dequant4(raw.z, sc, w[4], w[5]);
        dequant4(raw.w, sc, w[6], w[7]);
        uint4* dst = reinterpret_cast<uint4*>(v_w + r * ldv + ch * 16);
        dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
        dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
      __syncwarp();
      v_op = v_w;
      v_ld = ldv;
    } else {
      const bf16* k_st = ring + static_cast<size_t>(i % kStages) * 2 * R * ld;
#pragma unroll 4
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4<false>(a, q_sm + ((mrow & 1) * 8 + r8) * ld + kk * 16 + (mrow >> 1) * 8);
#pragma unroll
        for (int p = 0; p < R / 16; ++p) {
          uint32_t bk[4];
          ldmatrix_x4<false>(bk, k_st + (16 * p + (mrow >> 1) * 8 + r8) * ld + kk * 16 +
                                     (mrow & 1) * 8);
          mma(s[2 * p], a, bk[0], bk[1]);
          mma(s[2 * p + 1], a, bk[2], bk[3]);
        }
      }
      v_op = k_st + R * ld + c_w;
      v_ld = ld;
    }

    // Online softmax in base 2 (every warp holds the same state).
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < R / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (8 * n + 2 * t4 + (e & 1) >= rows) x = kNegInf;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_i[r], quad_max(mx[r]));
      alpha[r] = exp2_approx(m_i[r] - m_new);
      m_i[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < R / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx(s[n][e] - m_i[e >> 1]);
        s[n][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_i[r] = l_i[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
    for (int n = 0; n < 2 * kPairs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];

    // O[:, warp's columns] += bf16(P) V.
#pragma unroll
    for (int j = 0; j < R / 16; ++j) {
      const uint32_t a[4] = {pack_f32(s[2 * j][0], s[2 * j][1]),
                             pack_f32(s[2 * j][2], s[2 * j][3]),
                             pack_f32(s[2 * j + 1][0], s[2 * j + 1][1]),
                             pack_f32(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int pp = 0; pp < kPairs; ++pp) {
        if (pp < pairs) {
          uint32_t bv[4];
          ldmatrix_x4<true>(bv, v_op + (16 * j + (mrow & 1) * 8 + r8) * v_ld + 16 * pp +
                                    (mrow >> 1) * 8);
          mma(o[2 * pp], a, bv[0], bv[1]);
          mma(o[2 * pp + 1], a, bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds this block's state next

  // This block's state: fp32 O [kHeads][D], max and sum per head.
#pragma unroll
  for (int n = 0; n < 2 * kPairs; ++n) {
    if (n < 2 * pairs) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        *reinterpret_cast<float2*>(o_sm + (g + 8 * r) * D + c_w + 8 * n + 2 * t4) =
            make_float2(o[n][2 * r], o[n][2 * r + 1]);
      }
    }
  }
  if (warp == 0 && t4 == 0) {
    m_sm[g] = m_i[0];
    m_sm[g + 8] = m_i[1];
    l_sm[g] = l_i[0];
    l_sm[g + 8] = l_i[1];
  }
  cluster.sync();

  // Merge: weights exp2(m_j - M) / L per rank j, then this rank's slice of
  // the group's output elements, 4 columns per step, from every rank's O.
  if (tid < group) {
    float M = kNegInf;
    for (int j = 0; j < split; ++j) M = fmaxf(M, *cluster.map_shared_rank(m_sm + tid, j));
    float w[kMaxSplit], L = 0.f;
    for (int j = 0; j < split; ++j) {
      w[j] = exp2_approx(*cluster.map_shared_rank(m_sm + tid, j) - M);
      L += w[j] * *cluster.map_shared_rank(l_sm + tid, j);
    }
    const float inv = 1.f / (L == 0.f ? 1.f : L);
    for (int j = 0; j < split; ++j) w_sm[tid * kMaxSplit + j] = w[j] * inv;
  }
  __syncthreads();
  const int units = group * D / 4;
  const int u_end = units * (rank + 1) / split;
  bf16* out_chunk = out + (static_cast<size_t>(b) * Hq + q_head0) * D;
  for (int u = units * rank / split + tid; u < u_end; u += kThreads) {
    const int e0 = 4 * u, hh = e0 / D;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < split; ++j) {
      const float4 x = *reinterpret_cast<const float4*>(cluster.map_shared_rank(o_sm + e0, j));
      const float wj = w_sm[hh * kMaxSplit + j];
      acc.x += wj * x.x;
      acc.y += wj * x.y;
      acc.z += wj * x.z;
      acc.w += wj * x.w;
    }
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out_chunk + e0);
    dst[0] = __floats2bfloat162_rn(acc.x, acc.y);
    dst[1] = __floats2bfloat162_rn(acc.z, acc.w);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// ---------------------------------------------------------------------------
// head_dim above 512: the first kernel's design over 512-column slices
// ---------------------------------------------------------------------------
constexpr int kWideGroup = 8;  // q heads per block
constexpr int kWideTile = 64;  // K/V rows staged per tile
constexpr int kWideDim = 512;  // columns of one pass (scores chunk, output slice)
constexpr int kWideCols = kWideDim / kThreads;  // output columns per thread

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Grid (Hkv, B, head chunks x slices). Four blocks per SM as the register
// budget (128 a thread): without the hint ptxas spilled.
__global__ void __launch_bounds__(kThreads, 4)
ragged_decode_kernel_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const int* __restrict__ table,
                          const int* __restrict__ lengths, bf16* __restrict__ out, int Hq,
                          int Hkv, int D, int page_size, int P, int n_pages, int window,
                          float scale) {
  const int h = blockIdx.x;  // kv head
  const int b = blockIdx.y;  // lane
  const int slices = (D + kWideDim - 1) / kWideDim;
  const int g0 = (blockIdx.z / slices) * kWideGroup;  // first q head of the chunk
  const int c0 = (blockIdx.z % slices) * kWideDim;    // first output column
  const int vc = min(kWideDim, D - c0);               // output columns
  const int dc = kWideDim;                            // q / K columns staged
  const int group = min(kWideGroup, Hq / Hkv - g0);   // q heads of this block
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int k_stride = dc + 2;  // padded K row, in bf16 elements

  // Shared memory: fp32 regions first (q rows, scores/probabilities, the
  // per-head running max / denominator / rescale), then the bf16 tiles.
  extern __shared__ float4 smem_raw[];
  float* q_sm = reinterpret_cast<float*>(smem_raw);      // [group, dc]
  float* s_sm = q_sm + group * dc;                         // [group, kWideTile]
  float* m_sm = s_sm + group * kWideTile;                  // [kWideGroup]
  float* l_sm = m_sm + kWideGroup;                         // [kWideGroup]
  float* a_sm = l_sm + kWideGroup;                         // [kWideGroup]
  bf16* k_sm = reinterpret_cast<bf16*>(a_sm + kWideGroup);  // [kWideTile, dc+2]
  bf16* v_sm = k_sm + kWideTile * k_stride;                 // [kWideTile, vc]

  int length = lengths[b];
  length = max(0, min(length, P * page_size));
  const int start = window > 0 ? max(length - window, 0) : 0;

  const int q_head0 = h * (Hq / Hkv) + g0;
  const bf16* q_lane = q + (static_cast<size_t>(b) * Hq + q_head0) * D;
  if (tid < kWideGroup) {
    m_sm[tid] = kNegInf;
    l_sm[tid] = 0.f;
    a_sm[tid] = 0.f;
  }

  float acc[kWideGroup][kWideCols];
#pragma unroll
  for (int g = 0; g < kWideGroup; ++g)
#pragma unroll
    for (int c = 0; c < kWideCols; ++c) acc[g][c] = 0.f;
  __syncthreads();

  const int* lane_table = table + static_cast<size_t>(b) * P;

  for (int t0 = start; t0 < length; t0 += kWideTile) {
    const int rows = min(kWideTile, length - t0);

    // Scores summed over D in chunks of dc columns of q and K; V's output
    // slice [c0, c0 + vc) staged with the first chunk.
    for (int d0 = 0; d0 < D; d0 += dc) {
      const int w = min(dc, D - d0);
      for (int i = tid; i < group * w; i += kThreads) {
        const int g = i / w;
        q_sm[g * dc + i - g * w] = __bfloat162float(q_lane[g * D + d0 + i - g * w]);
      }
      for (int c = tid; c < rows * (w / 8); c += kThreads) {
        const int r = c / (w / 8);
        const int cc = c - r * (w / 8);
        const int kp = t0 + r;
        int phys = lane_table[kp / page_size];
        phys = min(max(phys, 0), n_pages - 1);
        const size_t row =
            ((static_cast<size_t>(phys) * page_size + kp % page_size) * Hkv + h) * D;
        const uint4 kk = *reinterpret_cast<const uint4*>(k + row + d0 + cc * 8);
        uint32_t* kdst = reinterpret_cast<uint32_t*>(k_sm + r * k_stride + cc * 8);
        kdst[0] = kk.x;
        kdst[1] = kk.y;
        kdst[2] = kk.z;
        kdst[3] = kk.w;
      }
      if (d0 == 0) {
        for (int c = tid; c < rows * (vc / 8); c += kThreads) {
          const int r = c / (vc / 8);
          const int cc = c - r * (vc / 8);
          const int kp = t0 + r;
          int phys = lane_table[kp / page_size];
          phys = min(max(phys, 0), n_pages - 1);
          const size_t row =
              ((static_cast<size_t>(phys) * page_size + kp % page_size) * Hkv + h) * D;
          *reinterpret_cast<uint4*>(v_sm + r * vc + cc * 8) =
              *reinterpret_cast<const uint4*>(v + row + c0 + cc * 8);
        }
      }
      __syncthreads();
      const bool last = d0 + dc >= D;
      for (int i = tid; i < group * kWideTile; i += kThreads) {
        const int g = i / kWideTile;
        const int r = i - g * kWideTile;
        float s = kNegInf;
        if (r < rows) {
          const __nv_bfloat162* kr =
              reinterpret_cast<const __nv_bfloat162*>(k_sm + r * k_stride);
          const float* qg = q_sm + g * dc;
          float dot = d0 == 0 ? 0.f : s_sm[i];
          for (int d2 = 0; d2 < w / 2; ++d2) {
            const float2 kf = __bfloat1622float2(kr[d2]);
            dot = fmaf(qg[2 * d2], kf.x, dot);
            dot = fmaf(qg[2 * d2 + 1], kf.y, dot);
          }
          s = last ? dot * scale : dot;
        }
        s_sm[i] = s;
      }
      __syncthreads();  // the next chunk overwrites q and K
    }

    // Online softmax update, one warp per q head. The denominator sums the
    // fp32 probabilities; P.V uses them rounded to bf16.
    for (int g = warp; g < group; g += kThreads / 32) {
      float* sg = s_sm + g * kWideTile;
      float mx = kNegInf;
      for (int r = lane; r < kWideTile; r += 32) mx = fmaxf(mx, sg[r]);
      mx = warp_max(mx);
      const float m_prev = m_sm[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int r = lane; r < kWideTile; r += 32) {
        const float p = r < rows ? expf(sg[r] - m_new) : 0.f;
        sum += p;
        sg[r] = __bfloat162float(__float2bfloat16(p));
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_sm[g] = l_sm[g] * alpha + sum;
        m_sm[g] = m_new;
        a_sm[g] = alpha;
      }
    }
    __syncthreads();

    // acc[g][d] = acc[g][d] * alpha_g + sum_r p[g][r] * v[r][d]; each V
    // element is read from shared memory once for all q heads.
#pragma unroll
    for (int c = 0; c < kWideCols; ++c) {
      const int d = tid + c * kThreads;
      if (d < vc) {
#pragma unroll
        for (int g = 0; g < kWideGroup; ++g)
          if (g < group) acc[g][c] *= a_sm[g];
        for (int r = 0; r < rows; ++r) {
          const float vr = __bfloat162float(v_sm[r * vc + d]);
#pragma unroll
          for (int g = 0; g < kWideGroup; ++g)
            if (g < group) acc[g][c] = fmaf(s_sm[g * kWideTile + r], vr, acc[g][c]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites the staged rows
  }

  bf16* out_lane = out + (static_cast<size_t>(b) * Hq + q_head0) * D + c0;
#pragma unroll
  for (int c = 0; c < kWideCols; ++c) {
    const int d = tid + c * kThreads;
    if (d < vc) {
#pragma unroll
      for (int g = 0; g < kWideGroup; ++g) {
        if (g < group) {
          const float l = l_sm[g];
          const float safe = l == 0.f ? 1.f : l;
          out_lane[g * D + d] = __float2bfloat16(acc[g][c] / safe);
        }
      }
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int R, bool kInt8>
cudaError_t launch_split(const void* q, const void* k, const void* v, const void* k_scale,
                         const void* v_scale, const void* table, const void* lengths,
                         void* out, int B, int Hq, int Hkv, int D, int page_size, int P,
                         int n_pages, int window, float scale, cudaStream_t stream) {
  const size_t smem = split_smem(R, D, kInt8);
  cudaError_t err = allow_smem(ragged_decode_kernel_split<R, kInt8>, smem);
  if (err != cudaSuccess) return err;
  // Blocks per (kv head, lane, head chunk): about two blocks per SM, from
  // the shapes alone (the lengths stay on the device).
  const int chunks = (Hq / Hkv + kHeads - 1) / kHeads;
  const long long units = 1LL * B * Hkv * chunks;
  const long long fill = 2LL * sm_count() / units;
  const int split = static_cast<int>(fill < 1 ? 1 : fill > kMaxSplit ? kMaxSplit : fill);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, Hkv * chunks, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ragged_decode_kernel_split<R, kInt8>,
                           static_cast<const bf16*>(q), k, v,
                           static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                           static_cast<const int*>(table), static_cast<const int*>(lengths),
                           static_cast<bf16*>(out), Hq, Hkv, D, page_size, P, n_pages, window,
                           scale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t launch_wide(const void* q, const void* k, const void* v, const void* table,
                        const void* lengths, void* out, int B, int Hq, int Hkv, int D,
                        int page_size, int P, int n_pages, int window, float scale,
                        cudaStream_t stream) {
  const int G = Hq / Hkv, group = G < kWideGroup ? G : kWideGroup;
  const size_t smem = sizeof(float) * (group * kWideDim + group * kWideTile + 3 * kWideGroup) +
                      sizeof(bf16) * (kWideTile * (kWideDim + 2) + kWideTile * kWideDim);
  const cudaError_t err = allow_smem(ragged_decode_kernel_wide, smem);
  if (err != cudaSuccess) return err;
  const int slices = (D + kWideDim - 1) / kWideDim;
  const dim3 grid(Hkv, B, (G + kWideGroup - 1) / kWideGroup * slices);
  ragged_decode_kernel_wide<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(table), static_cast<const int*>(lengths), static_cast<bf16*>(out),
      Hq, Hkv, D, page_size, P, n_pages, window, scale);
  return cudaGetLastError();
}

// The split kernel at the tile rows of head_dim D (D a multiple of 64, at
// most 512).
template <bool kInt8>
cudaError_t dispatch_split(const void* q, const void* k, const void* v, const void* k_scale,
                           const void* v_scale, const void* table, const void* lengths,
                           void* out, int B, int Hq, int Hkv, int D, int page_size, int P,
                           int n_pages, int window, float scale, cudaStream_t s) {
  switch (split_rows(D)) {
    case 64:
      return launch_split<64, kInt8>(q, k, v, k_scale, v_scale, table, lengths, out, B, Hq, Hkv,
                                     D, page_size, P, n_pages, window, scale, s);
    case 32:
      return launch_split<32, kInt8>(q, k, v, k_scale, v_scale, table, lengths, out, B, Hq, Hkv,
                                     D, page_size, P, n_pages, window, scale, s);
    default:
      return launch_split<16, kInt8>(q, k, v, k_scale, v_scale, table, lengths, out, B, Hq, Hkv,
                                     D, page_size, P, n_pages, window, scale, s);
  }
}

bool bad_shape(int B, int Hq, int Hkv, int D, int page_size, int P, int n_pages) {
  return B <= 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 || D <= 0 || D % 8 != 0 ||
         page_size <= 0 || P <= 0 || n_pages <= 0;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError(): the
// Python wrapper raises on anything but cudaSuccess (0). Shapes are checked
// by the wrapper; this re-checks only what would make the launch unsafe.
int lumina_ragged_paged_attention(const void* q, const void* k, const void* v,
                                  const void* table, const void* lengths, void* out,
                                  int B, int Hq, int Hkv, int D, int page_size, int P,
                                  int n_pages, int window, float scale, void* stream) {
  if (bad_shape(B, Hq, Hkv, D, page_size, P, n_pages)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D > kSplitDim) {
    err = launch_wide(q, k, v, table, lengths, out, B, Hq, Hkv, D, page_size, P, n_pages, window,
                      scale, s);
  } else if (D % 64 != 0) {
    err = cudaErrorInvalidValue;  // the split kernel's warps own 16-column pairs
  } else {
    err = dispatch_split<false>(q, k, v, nullptr, nullptr, table, lengths, out, B, Hq, Hkv, D,
                                page_size, P, n_pages, window, scale, s);
  }
  return static_cast<int>(err);
}

// B5-int8: k_codes / v_codes int8 [n_pages, page_size, Hkv, D], k_scales /
// v_scales fp32 [n_pages, page_size, Hkv, 1]; head_dim a multiple of 64 up
// to 512 (the wrapper takes wider heads through a bf16 scratch).
int lumina_ragged_paged_attention_int8(const void* q, const void* k_codes, const void* k_scales,
                                       const void* v_codes, const void* v_scales,
                                       const void* table, const void* lengths, void* out, int B,
                                       int Hq, int Hkv, int D, int page_size, int P, int n_pages,
                                       int window, float scale, void* stream) {
  if (bad_shape(B, Hq, Hkv, D, page_size, P, n_pages) || D > kSplitDim || D % 64 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(dispatch_split<true>(q, k_codes, v_codes, k_scales, v_scales, table,
                                               lengths, out, B, Hq, Hkv, D, page_size, P,
                                               n_pages, window, scale,
                                               static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
