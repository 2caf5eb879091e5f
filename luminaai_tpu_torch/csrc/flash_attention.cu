// Flash attention forward and backward for Hopper (sm_90a): B1, B2, B3.
//
// Replaces the TPU kernels of luminaai_tpu/ops/flash_attention.py:
//   B1 `_fwd_kernel`      (pallas_call in `_fwd`)  -> flash_fwd_wgmma_kernel
//   B2 `_bwd_dq_kernel`   (pallas_call in `_bwd`)  -> flash_bwd_dq_wgmma_kernel
//   B3 `_bwd_dkv_kernel`  (pallas_call in `_bwd`)  -> flash_bwd_dkv_wgmma_kernel
//                                                     (flash_bwd_dkv_wgmma_hd256_kernel
//                                                     at head_dim 192 and 256)
// and, above head_dim 256, the 64-column slice kernels at the end.
// They compute the same functions: GQA attention, causal or not, with an
// optional sliding-window band; fp32 scores and an online softmax; P
// rounded to bf16 before P.V and P^T.dO; dS = P*(dP - delta)*scale rounded
// to bf16 before dS.K and dS^T.Q; a zero row sum gives output 0 (safe_l).
// lse is written compact, [B, Hq, Sq] fp32 (the TPU's 128-lane replication
// of the row statistics is a tiling artifact and is not carried over).
//
// Layouts (contiguous): q, dq, o, do [B, Sq, Hq, D] bf16; k, v, dk, dv
// [B, Skv, Hkv, D] bf16; lse, delta [B, Hq, Sq] fp32. delta is
// rowsum(dO * O) minus the lse cotangent, computed by the caller.
//
// Which shapes take which kernel. At head_dim 64, 128, 192 and 256, any
// group, every kernel is wgmma fed by a TMA ring (their notes are at the
// kernels): B1 flash_fwd_wgmma_kernel and B2 flash_bwd_dq_wgmma_kernel,
// where a group whose HB = min(G, rows) heads do not divide the block's
// rows (128; B1's 192 at head_dim 64) and G leaves padding rows (b14's 5 x
// 25 of 128, b100's 10 x 12, b200's 12 x 10); B3 flash_bwd_dkv_wgmma_kernel
// at 64 and 128 and flash_bwd_dkv_wgmma_hd256_kernel at 192 and 256. Above
// head_dim 256 the 64-column slice kernels take every shape. Which kernel
// runs is decided by the shape alone, in the entry points.
//
// The slice kernels (head_dim above 256, which no preset of either package
// uses) are the first, mma.sync designs. Every matrix product is a
// warp-level mma.sync m16n8k16 (bf16 in, fp32 accumulate). Each warp owns
// 16 rows of its output; the accumulators stay in registers in the
// instruction's documented fragment layout (thread lane holds rows lane/4
// and lane/4 + 8, columns 2*(lane%4) + {0, 1} of each 8-column tile), so
// the softmax statistics of a row live in the 4 threads of a quad and P /
// dS go from the score accumulators straight into A fragments without
// touching shared memory. Tiles are staged in shared memory with 16-byte
// loads; rows are padded by 8 bf16 so the fragment loads are free of bank
// conflicts. The forward and dQ slice kernels: one block of 8 warps per
// (batch, kv head, q tile, head chunk, 64-column slice) over 128 (q head,
// position) rows: HB = min(G, 128) q heads of the GQA group times P = 128 /
// HB positions (row r is head r / P at position q0 + r % P), so each K/V
// tile staged in shared memory serves every head of the block (the TPU
// grid ran one q head per step and fetched each K/V block once per q
// head); rows past the group or past Sq are staged as zeros and never
// stored. The loop over 64-row K/V tiles inside the block stands in for
// the TPU's sequential kv grid axis; it starts at the window's band (the
// TPU's _kv_block_offset) and stops at the diagonal (the TPU's
// _block_needed), and each element is masked as the TPU's _band_mask does;
// a partial last K/V tile is staged with zeros and masked past Skv. The
// dK/dV slice kernel: one block of 4 warps per (batch, kv head, 64-row kv
// tile, 64-column slice) looping over the group's q heads and the band's
// 32-row q tiles, the GQA group reduced in its fp32 registers (no [B, Hq,
// S, D] fp32 buffer, no atomics; the TPU path wrote per-q-head fp32 dK/dV
// and summed the group afterwards), as every B3 kernel here does.
//
// Shapes: any head_dim that is a multiple of 64 (a template each for 64,
// 128, 192 and 256; above 256 the 64-column slice kernels at the end of
// this file); any q heads per kv head; any sequence lengths (partial tiles
// masked). That covers every shape the JAX gate `flash_eligible` admits.
//
// Bound. At the training shapes (q [2, 2048, 16, 128], k/v [2, 2048, 4,
// 128], causal) each kernel is bound by operations, not bytes: B1 does
// 4*B*Hq*D*(S^2/2) flops (~34 GFLOP, ~0.035 ms at 989 TFLOP/s bf16) over
// ~42 MB (~0.013 ms at 3.35 TB/s); B2 does 6*B*Hq*D*(S^2/2) (~52 GFLOP) and
// B3 8*B*Hq*D*(S^2/2) (~69 GFLOP). At the flagship MoE shape (q [16, 2048,
// 16, 64], k/v [16, 2048, 8, 64]) B1 does ~137.5 GFLOP (~0.139 ms); at
// debug_200m's (q [8, 2048, 12, 64], k/v [8, 2048, 4, 64]) B2 does ~77
// GFLOP (~0.078 ms), and its padding rows (2 of 128) add 1.6% to the
// products' work; at debug_300m's (q [16, 1024, 4, 192], k/v [16, 1024, 2,
// 192]) B2 does ~38.7 GFLOP (~0.039 ms). The mma.sync kernels reached well
// under half of the wgmma peak and loaded tiles synchronously: 3-12% of
// their bounds (PERF.md); the wgmma kernels replaced them at every group
// and head_dim up to 256.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kWarps = 8;                // B1, B2
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;       // (q head, position) rows per block
constexpr int kWarps3 = 4;               // B3
constexpr int kThreads3 = kWarps3 * 32;
constexpr int kTileKv3 = kWarps3 * 16;   // kv rows per B3 block
constexpr int kTileQ3 = 32;              // q rows per B3 loop step
constexpr int kPad = 8;                  // bf16 padding per shared row
constexpr float kNegInf = -1e30f;        // the TPU kernels' NEG_INF

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += A(16x16, row) * B(16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A fragment of the 16 rows at `rows` (row stride ld), k columns
// [16*kk, 16*kk + 16).
struct AFrag {
  uint32_t r[4];
};

__device__ __forceinline__ AFrag a_rows(const bf16* rows, int ld, int kk, int lane) {
  const int g = lane >> 2, c = kk * 16 + 2 * (lane & 3);
  AFrag f;
  f.r[0] = ld32(rows + g * ld + c);
  f.r[1] = ld32(rows + (g + 8) * ld + c);
  f.r[2] = ld32(rows + g * ld + c + 8);
  f.r[3] = ld32(rows + (g + 8) * ld + c + 8);
  return f;
}

// A fragment from fp32 accumulators of two neighbouring 8-column tiles
// (lo = columns [16j, 16j+8), hi = [16j+8, 16j+16)), rounded to bf16.
__device__ __forceinline__ AFrag a_acc(const float (&lo)[4], const float (&hi)[4]) {
  AFrag f;
  f.r[0] = pack_f32(lo[0], lo[1]);
  f.r[1] = pack_f32(lo[2], lo[3]);
  f.r[2] = pack_f32(hi[0], hi[1]);
  f.r[3] = pack_f32(hi[2], hi[3]);
  return f;
}

// B fragment B[k][n] = M[n][k] for M's rows [8*nt, 8*nt + 8) (n) and
// columns [16*kk, 16*kk + 16) (k): K in Q.K^T, V in dO.V^T.
__device__ __forceinline__ void b_rows(const bf16* m, int ld, int nt, int kk, int lane,
                                       uint32_t& b0, uint32_t& b1) {
  const bf16* p = m + (nt * 8 + (lane >> 2)) * ld + kk * 16 + 2 * (lane & 3);
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// B fragment B[k][n] = M[k][n] for M's rows [16*kk, 16*kk + 16) (k) and
// columns [8*nt, 8*nt + 8) (n): V in P.V, K in dS.K.
__device__ __forceinline__ void b_cols(const bf16* m, int ld, int kk, int nt, int lane,
                                       uint32_t& b0, uint32_t& b1) {
  const bf16* p = m + (kk * 16 + 2 * (lane & 3)) * ld + nt * 8 + (lane >> 2);
  b0 = pack_bf16(p[0], p[ld]);
  b1 = pack_bf16(p[8 * ld], p[9 * ld]);
}

// Whether key position kpos (< Skv) is inside query position qpos's band.
__device__ __forceinline__ bool in_band(int qpos, int kpos, int Skv, int causal, int window) {
  if (kpos >= Skv) return false;
  if (!causal) return true;
  return qpos >= kpos && (window <= 0 || qpos - kpos < window);
}

// Copy `rows` rows of D bf16 (source row stride src_ld elements) into
// shared memory rows of stride D + kPad, 16 bytes per thread per step;
// rows at or past `valid` are written as zeros and never read.
template <int D>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, size_t src_ld, int rows,
                                      int valid, int tid, int nthreads) {
  constexpr int kChunks = D / 8;
  for (int c = tid; c < rows * kChunks; c += nthreads) {
    const int r = c / kChunks, cc = c - r * kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * src_ld + cc * 8);
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + cc * 8) = val;
  }
}

// The (q head, position) rows of a B1/B2 block: row r holds head
// h0 + r / P at position q0 + r % P; rows past nh * P heads' worth or past
// Sq are padding.
struct Rows {
  int P, nh, h0, q0;
  __device__ __forceinline__ bool valid(int r, int Sq) const {
    return r < nh * P && q0 + r % P < Sq;
  }
  __device__ __forceinline__ int head(int r) const { return h0 + r / P; }
  __device__ __forceinline__ int pos(int r) const { return q0 + r % P; }
};

__device__ __forceinline__ Rows block_rows(int G, int hk, int chunk) {
  const int HB = min(G, kRows), P = kRows / HB;
  Rows rows;
  rows.P = P;
  rows.q0 = (gridDim.x - 1 - blockIdx.x) * P;  // longest causal tiles first
  const int g0 = chunk * HB;
  rows.nh = min(HB, G - g0);
  rows.h0 = hk * G + g0;
  return rows;
}

// Stage columns [c0, c0 + DC) of the block's 128 (q head, position) rows of
// a [B, Sq, Hq, D] tensor.
template <int DC>
__device__ __forceinline__ void stage_group(bf16* dst, const bf16* src, int b, int Sq, int Hq,
                                            int D, int c0, const Rows& rows, int tid) {
  constexpr int kChunks = DC / 8;
  for (int c = tid; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c - r * kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (rows.valid(r, Sq)) {
      val = *reinterpret_cast<const uint4*>(
          src + ((static_cast<size_t>(b) * Sq + rows.pos(r)) * Hq + rows.head(r)) * D + c0 +
          cc * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * (DC + kPad) + cc * 8) = val;
  }
}

// Online softmax over one tile of fp32 scores s (the warp's 16 rows x TK
// kv columns from kv0): scale, mask, fold into the running max m_i and sum
// l_i, rescale the NA 8-column output tiles in acc; s becomes P (fp32).
template <int TK, int NA>
__device__ __forceinline__ void softmax_step(float (&s)[TK / 8][4], float (&acc)[NA][4],
                                             float (&m_i)[2], float (&l_i)[2],
                                             const int (&qpos)[2], int kv0, int t, int Skv,
                                             int causal, int window, float scale) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < TK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kpos = kv0 + n * 8 + 2 * t + (e & 1);
      float x = s[n][e] * scale;
      if (!in_band(qpos[e >> 1], kpos, Skv, causal, window)) x = kNegInf;
      s[n][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m_i[r], quad_max(mx[r]));
    alpha[r] = expf(m_i[r] - m_new);
    m_i[r] = m_new;
  }
#pragma unroll
  for (int n = 0; n < TK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(s[n][e] - m_i[e >> 1]);
      s[n][e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_i[r] = l_i[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
}

// dS = P * (dP - delta) * scale for one tile (B2), P recomputed from lse;
// s (the scores) becomes dS.
template <int TK>
__device__ __forceinline__ void ds_step(float (&s)[TK / 8][4], const float (&dp)[TK / 8][4],
                                        const float (&lse_r)[2], const float (&delta_r)[2],
                                        const int (&qpos)[2], int kv0, int t, int Skv,
                                        int causal, int window, float scale) {
#pragma unroll
  for (int n = 0; n < TK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const int kpos = kv0 + n * 8 + 2 * t + (e & 1);
      float x = s[n][e] * scale;
      if (!in_band(qpos[r], kpos, Skv, causal, window)) x = kNegInf;
      const float p = expf(x - lse_r[r]);
      s[n][e] = p * (dp[n][e] - delta_r[r]) * scale;
    }
}

// P^T and dS^T for one B3 step (the warp's 16 kv rows x kTileQ3 q columns
// from q0): st (the transposed scores) becomes P^T, dpt becomes dS^T; q
// columns past Sq contribute 0.
__device__ __forceinline__ void pds_step(float (&st)[kTileQ3 / 8][4],
                                         float (&dpt)[kTileQ3 / 8][4], const float* lse_sm,
                                         const float* delta_sm, const int (&kpos)[2], int q0,
                                         int t, int Sq, int Skv, int causal, int window,
                                         float scale) {
  const bool partial = q0 + kTileQ3 > Sq;
#pragma unroll
  for (int n = 0; n < kTileQ3 / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n * 8 + 2 * t + (e & 1);
      float p = 0.f, ds = 0.f;
      if (!partial || q0 + col < Sq) {
        float x = st[n][e] * scale;
        if (!in_band(q0 + col, kpos[e >> 1], Skv, causal, window)) x = kNegInf;
        p = expf(x - lse_sm[col]);
        ds = p * (dpt[n][e] - delta_sm[col]) * scale;
      }
      st[n][e] = p;
      dpt[n][e] = ds;
    }
}

// Range [begin, end) of K/V rows a q tile [qlo, qhi] needs, begin aligned
// to the kv tile.
template <int TK>
__device__ __forceinline__ void kv_range(int qlo, int qhi, int Skv, int causal, int window,
                                         int& begin, int& end) {
  end = causal ? min(Skv, qhi + 1) : Skv;
  begin = (causal && window > 0) ? max(0, qlo - window + 1) : 0;
  begin = (begin / TK) * TK;
}

// ---------------------------------------------------------------------------
// B1 on Hopper: wgmma fed by a TMA ring (head_dim 64-256, any group)
// ---------------------------------------------------------------------------
// Bound: operations (0.0348 ms at the b1 training shape, 0.139 ms at the
// flagship MoE shape, at 989 TFLOP/s); the softmax's exponentials (16 a
// clock per SM) come within 5% of the products' time at head_dim 64.
// One block per (batch, kv head, q tile, head chunk) of kConsumers + 1
// warpgroups, over 64 x kConsumers (q head, position) rows, position-major:
// row r is head h0 + r % HB at position q0 + r / HB (HB = min(G, rows)),
// the order in which a 4-D TMA box (64 columns, HB heads, P positions, 1)
// of q [B, Sq, Hq, D] lands; positions past Sq arrive as zeros and are
// never stored, so a partial last q tile needs no staging code. P =
// floor(rows / HB): a group that does not tile the rows (b14's 5: 5 x 25 =
// 125 of 128) leaves rows past HB P as padding rows, zeroed once before the
// first product; they take position Sq (no lse, no O store) and reach no
// other row, since a row's softmax and its row of P V depend on that row
// alone (3 of 128 rows at b14: 2.4% more products). A group above the rows
// that they do not divide takes ceil(G / HB) head chunks, the last one's
// heads past the group padding too. The groups that tile keep an
// instantiation without that bookkeeping (kPadRows false). The last
// warpgroup (one thread) loads Q once and keeps a ring of K/V stages in
// flight (full/empty mbarriers, setmaxnreg hands its registers to the
// others); each consumer warpgroup owns 64 rows: S = Q K^T by wgmma from
// shared memory (both K-major), the online softmax in registers (base 2,
// the scale folded into one FFMA), P rounded to bf16 in registers as the A
// operand of O += P V (wgmma RS, V MN-major). The consumers take turns
// issuing their products (named barriers), so one's softmax runs under
// another's products. Smem layouts, 128-byte swizzled 64 x 64-element boxes:
//   Q  [D / 64][rows]              (K-major A; a warpgroup's rows 8 KB in)
//   K  [D / 64][kTK rows]          (K-major B of Q K^T)
//   V  [kTK / 64][D / 64]          (MN-major B of P V: LBO one box)
// Tried and dropped (PERF.md, PR 5): overlapping the softmax of tile t with
// P V of tile t - 1 inside a warpgroup made ptxas serialize the wgmmas
// (C7515, C7520) and ran slower at both main-path shapes.
template <int D>
struct Fwd {
  static constexpr int kTK = D <= 128 ? 128 : 64;  // kv rows per stage
  static constexpr int kStages = D <= 64 ? 4 : D <= 192 ? 3 : 2;
  static constexpr int kChunks = D / 64;           // 64-column boxes per row
  // Consumer warpgroups of 64 rows: 3 at head_dim 64 (the softmax's
  // exponentials and conversions outweigh its products there, so more warps
  // hide their latency), else 2.
  static constexpr int kConsumers = D <= 64 ? 3 : 2;
  static constexpr int kRowsW = 64 * kConsumers;  // (q head, position) rows
  static constexpr int kQBytes = kRowsW * D * 2;
  static constexpr int kTileBytes = kTK * D * 2;   // K or V of one stage
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kSmemBytes =
      1024 + kQBytes + kStages * kStageBytes + (2 * kStages + 1) * 8;
  static constexpr int kThreads = 128 * (kConsumers + 1);
};

// O [64 x D] += bf16(P) [64 x TK] V [TK x D] for one consumer warpgroup: P
// from registers (packed A fragments), V MN-major in 64-row boxes; issued
// and committed as one wgmma group.
template <int D, int TK>
__device__ __forceinline__ void pv_product(float (&acc)[D / 2], const uint32_t (&pa)[TK / 16][4],
                                           const uint8_t* v_st) {
  const uint64_t dv = smem_desc(v_st, kBoxBytes, 8 * kSwizzleRowBytes);
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk) {
    wgmma_rs<D, 1>(acc, pa[kk],
                   desc_advance(dv, (kk / 4) * (D / 64) * kBoxBytes +
                                        (kk % 4) * 16 * kSwizzleRowBytes));
  }
  wgmma_commit();
}

// kPadRows: the group does not tile the block's rows (padding rows, as in
// B2 below); the groups that do take an instantiation without that
// bookkeeping.
template <int D, bool kPadRows>
__global__ void __launch_bounds__(Fwd<D>::kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
                       float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv, int causal,
                       int window, float scale) {
  using F = Fwd<D>;
  constexpr int TK = F::kTK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = q_sm + F::kQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + F::kStages * F::kStageBytes);
  uint64_t* empty = full + F::kStages;
  uint64_t* q_full = empty + F::kStages;

  constexpr int kRowsW = F::kRowsW, kConsumers = F::kConsumers;
  // HB heads x P positions land as rows [0, HB P); rows past them (a group
  // that does not tile the rows, e.g. 5 x 25 = 125 of 128) are padding.
  const int G = Hq / Hkv, HB = min(G, kRowsW), P = kRowsW / HB;
  const int rows = kPadRows ? HB * P : kRowsW;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * P;  // longest causal tiles first
  const int h0 = hk * G + blockIdx.z * HB;
  const int qhi = min(q0 + P, Sq) - 1;
  int kv_begin, kv_end;
  kv_range<TK>(q0, qhi, Skv, causal, window, kv_begin, kv_end);
  const int tiles = (kv_end - kv_begin + TK - 1) / TK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < F::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);  // one arrival per consumer warpgroup
    }
    mbar_init(q_full, 1);
    fence_barrier_init();
  }
  if constexpr (kPadRows) {
    // The padding rows of every Q stack (the boxes never write them)
    // become zeros once, so their scores stay finite; the products read
    // them through the async proxy.
    const int pad = (kRowsW - rows) * kSwizzleRowBytes / 16;  // 16-byte units a stack
    for (int i = threadIdx.x; i < F::kChunks * pad; i += F::kThreads) {
      const int st = i / pad;
      *reinterpret_cast<uint4*>(q_sm + (st * kRowsW + rows) * kSwizzleRowBytes +
                                (i - st * pad) * 16) = make_uint4(0u, 0u, 0u, 0u);
    }
    fence_proxy_async();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kConsumers) {
    // Producer: Q once, then K and V tiles through the ring.
    regs_dealloc<kConsumers == 2 ? 40 : 24>();
    if (threadIdx.x == 128 * kConsumers) {
      // The box's real bytes: rows [0, HB P) of each stack.
      mbar_arrive_expect_tx(q_full, kPadRows ? F::kChunks * rows * kSwizzleRowBytes
                                             : F::kQBytes);
      for (int c = 0; c < F::kChunks; ++c)
        tma_load_4d(q_sm + c * kRowsW * kSwizzleRowBytes, &map_q, q_full, c * 64, h0, q0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < tiles; ++t) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* k_st = ring + stage * F::kStageBytes;
        uint8_t* v_st = k_st + F::kTileBytes;
        mbar_arrive_expect_tx(&full[stage], F::kStageBytes);
        const int kv0 = kv_begin + t * TK;
        for (int rb = 0; rb < TK / 64; ++rb) {
          for (int c = 0; c < F::kChunks; ++c) {
            tma_load_4d(k_st + c * TK * kSwizzleRowBytes + rb * kBoxBytes, &map_k, &full[stage],
                        c * 64, hk, kv0 + rb * 64, b);
            tma_load_4d(v_st + (rb * F::kChunks + c) * kBoxBytes, &map_v, &full[stage], c * 64,
                        hk, kv0 + rb * 64, b);
          }
        }
        if (++stage == F::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    regs_alloc<kConsumers == 2 ? 232 : 160>();
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int lane = tid & 31, t4 = lane & 3;
    int qpos[2], head[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg * 64 + (tid >> 5) * 16 + (lane >> 2) + 8 * h;
      qpos[h] = q0 + r / HB;
      head[h] = h0 + r % HB;
      // A padding row (past HB P, or a head past the group in a partial
      // last chunk) takes position Sq: stored nowhere. Its softmax and its
      // row of P V depend on that row alone, so no other row reads it.
      if (kPadRows && (r >= rows || head[h] >= (hk + 1) * G)) qpos[h] = Sq;
    }
    const float c = scale * 1.4426950408889634f;
    float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    fence_regs(acc);
    const uint64_t dq = smem_desc(q_sm + wg * 64 * kSwizzleRowBytes, 16, 8 * kSwizzleRowBytes);
    mbar_wait(q_full, 0);

    // The warpgroups take turns issuing S = Q K^T (warpgroup w waits at
    // named barrier 1 + w, then lets the next one go), so one's softmax runs
    // while another's products do.
    int stage = 0;
    uint32_t phase = 0;
    if (wg == kConsumers - 1) named_barrier_arrive(1, 256);  // warpgroup 0 issues first
    for (int t = 0; t < tiles; ++t) {
      const int kv0 = kv_begin + t * TK;
      mbar_wait(&full[stage], phase);
      named_barrier(1 + wg, 256);  // this warpgroup's turn

      // S = Q K^T for the warpgroup's 64 rows x TK kv columns.
      float s[TK / 2];
      const uint64_t dk = smem_desc(ring + stage * F::kStageBytes, 16, 8 * kSwizzleRowBytes);
      wgmma_fence();
      wgmma_ss_zero<TK, 0, 0>(s, dq, dk);
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;  // 16 bf16 into the swizzled row
        wgmma<TK, 0, 0>(s, desc_advance(dq, (kk / 4) * kRowsW * kSwizzleRowBytes + col),
                        desc_advance(dk, (kk / 4) * TK * kSwizzleRowBytes + col));
      }
      wgmma_commit();
      if (wg + 1 < kConsumers || t + 1 < tiles) {
        named_barrier_arrive(1 + (wg + 1) % kConsumers, 256);  // the next one's turn
      }
      wgmma_wait<0>();
      fence_regs(s);

      // Online softmax in base 2, the scale folded into one FFMA: rows keep
      // the raw max m, p = 2^(s c - m c) with c = scale log2(e), and l sums
      // this thread's columns (the quad's sum is taken once, at the end).
      // Tiles wholly inside every row's band (the block's lowest position
      // past the tile, the window's far edge before it) skip the masks.
      const bool interior =
          kv0 + TK <= Skv &&
          (!causal || (kv0 + TK - 1 <= q0 && (window <= 0 || qhi - kv0 < window)));
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < TK / 2; ++i) {
        if (!interior) {
          const int kpos = kv0 + 8 * (i / 4) + 2 * t4 + (i & 1);
          if (!in_band(qpos[(i >> 1) & 1], kpos, Skv, causal, window)) s[i] = kNegInf;
        }
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
      float alpha[2], mc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_i[r], quad_max(mx[r]));
        alpha[r] = exp2_approx((m_i[r] - m_new) * c);
        // A row with no key of its band yet: its masked p must be 0 (an
        // fma against a rounded -1e30 c would leave a huge exponent).
        mc[r] = m_new == kNegInf ? 0.f : m_new * c;
        m_i[r] = m_new;
        l_i[r] *= alpha[r];
      }
      uint32_t pa[TK / 16][4];
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = 8 * kk + 2 * i, r = i & 1;  // columns e, e + 1 of row r
          const float p0 = exp2_approx(fmaf(s[e], c, -mc[r]));
          const float p1 = exp2_approx(fmaf(s[e + 1], c, -mc[r]));
          l_i[r] += p0 + p1;
          pa[kk][i] = pack_f32(p0, p1);
        }
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // O += bf16(P) V, P from registers.
      fence_regs(acc);
      wgmma_fence();
      pv_product<D, TK>(acc, pa, ring + stage * F::kStageBytes + F::kTileBytes);
      wgmma_wait<0>();
      fence_regs(acc);
      if (tid == 0) mbar_arrive(&empty[stage]);
      if (++stage == F::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l = quad_sum(l_i[r]);
      if (qpos[r] >= Sq) continue;
      const float safe = l == 0.f ? 1.f : l;
      if (t4 == 0) {
        lse[(static_cast<size_t>(b) * Hq + head[r]) * Sq + qpos[r]] =
            (m_i[r] * c + log2f(safe)) * 0.6931471805599453f;
      }
      const float inv = 1.f / safe;
      bf16* out = o + ((static_cast<size_t>(b) * Sq + qpos[r]) * Hq + head[r]) * D + 2 * t4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B2 (head_dim 64-256) and B3 (head_dim 64 and 128) on Hopper: wgmma fed by
// a TMA ring
// ---------------------------------------------------------------------------
// Bound: operations (B2 6 and B3 8 flops per head_dim per attended (q, k)
// pair: 0.0521 and 0.0695 ms at the b1 training shape, 0.209 and 0.278 ms
// at the flagship MoE shape, B2 0.0391 ms at debug_300m's micro-batch (q
// [16, 1024, 4, 192]), at 989 TFLOP/s). Each block runs two consumer
// warpgroups; each runs its two score products by wgmma from shared memory
// and its gradient product(s) by wgmma with the A operand from registers,
// and leaves a step's gradient products in flight under its next step's
// score products. A ring of TMA tiles (full/empty mbarriers) feeds them.
// - No producer warp: ptxas allocates registers for the launch bound, 168 a
//   thread at 12 warps (3 a scheduler) with or without setmaxnreg, which
//   spilled B3's two head_dim-128 fp32 accumulators (64 + 64 a thread) and
//   serialized the wgmmas once a product stayed in flight. At 8 warps every
//   thread may hold 255. Thread 0 also issues the loads. A warpgroup
//   releases step j's stage at step j + 1, once the gradient product that
//   read it has completed; at step j the producer refills the stage of step
//   j - kLag (released by both warpgroups) with step j - kLag + kStages. B3
//   and B2 at head_dim 64/128 (4 stages) take kLag 2: the stage was
//   released a step earlier, so one warpgroup may run a step ahead of the
//   other. B2 at 192 and 256 (2 and 3 stages) take kLag 1 (the rule of the
//   head_dim-192/256 B3 kernel below): the producer first releases step j -
//   1 itself, then waits for the other warpgroup to release it. Measured
//   (PERF.md): kLag 1 at 4 stages ran B2 4-12% slower at head_dim 64/128,
//   and kLag 2 over head_dim 256's 3 stages no faster than kLag 1.
// - Every tile is a 128-byte-swizzled [D / 64][rows] stack of 64 x 64 boxes
//   (a row's 64-column chunks one rows-tall stack apart; 32-row tiles at
//   B2's head_dim 256 stack 32 x 64 boxes). Used K-major (the reduction over
//   D) a tile is an A or B operand with SBO 1024; the same bytes used
//   MN-major (the reduction over rows, N over D) are a B operand with LBO =
//   one stack (rows x 128 bytes) and SBO 1024, a k step 16 rows (2048
//   bytes). So one copy serves both products: K in B2 (S = Q K^T, dQ += dS
//   K), Q and dO in B3 (S^T = K Q^T, dK += dS^T Q).
// - P = 2^(S c - lse log2 e), c = scale log2 e: one FFMA and ex2 per
//   element. Tiles wholly inside every row's band skip the masks.
// B2 (dQ): one block per (batch, kv head, q tile, head chunk) over 128
// position-major (q head, position) rows, 64 per warpgroup: row r is head
// h0 + r % HB at position q0 + r / HB, HB = min(G, 128), P = floor(128 /
// HB) positions a block (one 4-D box per 64 columns brings Q and dO once).
// A group that does not divide 128 leaves 128 - HB P padding rows (3 x 42
// = 126 rows at debug_200m's group of 3, 5 x 25 = 125 at b14's 5): each
// 64-column stack stays 128 rows tall, so both warpgroups' descriptors keep
// their offsets; the padding rows are zeroed once, take position Sq (no
// lse or delta read, no store), and reach no other row, since a row of dQ
// = dS K depends on its own row of dS alone. A group above 128 that 128
// does not divide takes ceil(G / 128) chunks, the last one's heads past
// the group padding too. K/V tiles through the ring, from the window's
// band to the diagonal: 128 rows at head_dim 64, 64 at 128 and 192, 32 at
// 256. Per tile: S = Q K^T and dP = dO V^T (SS, N = the tile's rows), P
// while dP runs, dS = P (dP - delta) scale in registers, dQ += bf16(dS) K
// (RS, K MN-major, N = D). At head_dim 192 and 256 the full-width dQ
// accumulator (96 or 128 fp32 a thread) stays in each warpgroup, and
// shared memory sets the tile: Q and dO for 128 rows take 96 or 128 KB of
// the block's 227, which leaves 2 stages of 64-row K/V tiles at 192 (48 KB
// a stage) and 3 stages of 32-row tiles at 256 (32 KB a stage; a 64-row
// stage would be 64 KB, and two do not fit). A thread then holds the dQ
// accumulator, one tile's S and dP (TK / 2 each) and the last tile's bf16
// dS (TK / 4) while that dQ product runs: 176 registers at 192, 168 at 256.
// The cost at 256: the score products run m64n32k16, each reading 3 KB of
// shared memory for 64 K flops. At 192, 4 stages of 32-row tiles (the same
// bytes) ran 17% slower than 2 of 64 rows (PERF.md).
// B3 (dK, dV): one block (or cluster, below) per (batch, kv head, 128 kv
// rows), 64 per warpgroup, longest causal band first; K and V are loaded
// once, and the
// ring streams Q and dO tiles of 64 rows (128 at head_dim 64; taken 64
// columns at a time) with their lse and delta (a flat fp32 TMA box of
// TQ + 4 floats from the step's first row rounded down to 16 bytes, where
// a box may start; the consumers read from (row & 3) on), for every
// q head of the group and every q tile of the band (from the diagonal on,
// to the window's far edge); both warpgroups read each stage. Per step: S^T
// = K Q^T and dP^T = V dO^T (SS), P^T and dS^T in registers, dV +=
// bf16(P^T) dO and dK += bf16(dS^T) Q (RS, dO and Q MN-major); q columns
// past Sq contribute 0. The group is summed in the fp32 accumulators.
// Filling the card: at the b1 shape B x Hkv x kv tiles is 128 blocks for
// 132 SMs, and the first kv tile's causal band is 16 times the last one's,
// so that block sets the kernel's time. While the tiles number fewer than
// the SMs, a cluster of two blocks shares each tile: rank r takes the r-th
// half of its (q head, q tile) steps; rank 0 writes dK and rank 1 dV, each
// the sum of rank 0's fp32 partial and rank 1's: each rank pushes the
// partial it does not write into the other's shared memory by remote
// stores between two cluster barriers (one launch, deterministic, no
// atomics, no scratch). Tried and slower (PERF.md): clusters of 4, a merge
// that pulled the partials by remote loads, one generic over 2 or 4 ranks,
// and 64-row tiles whose two warpgroups took alternate steps (each stage
// then read by one warpgroup: twice the tile traffic).
template <int D>
struct BwdDq {
  // kv rows per stage, and stages: what shared memory leaves beside Q and dO.
  static constexpr int kTK = D <= 64 ? 128 : D <= 192 ? 64 : 32;
  static constexpr int kStages = D <= 128 ? 4 : D <= 192 ? 2 : 3;
  static constexpr int kLag = kStages == 4 ? 2 : 1;  // the refill's (note above)
  static constexpr int kBoxRows = kTK < 64 ? kTK : 64;  // rows of a K or V box
  static constexpr int kChunks = D / 64;
  static constexpr int kConsumers = 2;
  static constexpr int kRowsW = 64 * kConsumers;  // (q head, position) rows
  static constexpr int kQBytes = kRowsW * D * 2;  // Q or dO
  static constexpr int kTileBytes = kTK * D * 2;  // K or V of one stage
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kSmemBytes =
      1024 + 2 * kQBytes + kStages * kStageBytes + (2 * kStages + 1) * 8;
  static constexpr int kThreads = 128 * kConsumers;  // thread 0 also loads
  static_assert(kSmemBytes <= 232448, "shared memory of one block");
  static_assert(kLag >= 1 && kLag < kStages, "the refill loads a later step");
};

template <int D>
struct BwdDkv {
  static constexpr int kTQ = D <= 64 ? 128 : 64;   // q rows per stage
  static constexpr int kSub = 64;                  // q columns per product
  static constexpr int kStages = 4;
  static constexpr int kChunks = D / 64;
  static constexpr int kConsumers = 2;
  static constexpr int kRowsKv = 64 * kConsumers;  // kv rows per block
  static constexpr int kKvBytes = kRowsKv * D * 2;  // K or V
  static constexpr int kTileBytes = kTQ * D * 2;    // Q or dO of one stage
  static constexpr int kStageBytes = 2 * kTileBytes;
  // lse or delta of one stage: a 1-D box of kTQ + 4 floats from the row
  // rounded down to 16 bytes (where a box may start), in a slot of kStatSlot
  // floats (128-byte aligned).
  static constexpr int kStatBox = kTQ + 4;
  static constexpr int kStatBytes = kStatBox * 4;
  static constexpr int kStatSlot = kTQ + 32;
  static constexpr int kSmemBytes = 1024 + 2 * kKvBytes + kStages * kStageBytes +
                                    kStages * 2 * kStatSlot * 4 + (2 * kStages + 1) * 8;
  static constexpr int kThreads = 128 * kConsumers;  // thread 0 also loads
  static_assert(kStages * kStageBytes >= kConsumers * 64 * D * 4, "the merge parks over the ring");
};

// kPadRows: the group does not divide the 128 rows (padding rows); the
// groups that do take an instantiation without that bookkeeping.
template <int D, bool kPadRows>
__global__ void __launch_bounds__(BwdDq<D>::kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_do,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv, int causal,
                          int window, float scale) {
  using F = BwdDq<D>;
  constexpr int TK = F::kTK, kRowsW = F::kRowsW, kConsumers = F::kConsumers;
  constexpr int kStages = F::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* do_sm = q_sm + F::kQBytes;
  uint8_t* ring = do_sm + F::kQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * F::kStageBytes);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  // HB heads x P positions land as rows [0, HB P); rows past them (a group
  // that does not divide 128, e.g. 3 x 42 = 126) are padding.
  const int G = Hq / Hkv, HB = min(G, kRowsW), P = kRowsW / HB;
  const int rows = kPadRows ? HB * P : kRowsW;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * P;  // longest causal tiles first
  const int h0 = hk * G + blockIdx.z * HB;
  const int qhi = min(q0 + P, Sq) - 1;
  int kv_begin, kv_end;
  kv_range<TK>(q0, qhi, Skv, causal, window, kv_begin, kv_end);
  const int tiles = kv_end > kv_begin ? (kv_end - kv_begin + TK - 1) / TK : 0;

  const bool producer = threadIdx.x == 0;
  // K/V tile t into stage t % kStages, in boxes of kBoxRows rows.
  auto load_tile = [&](int t) {
    constexpr int kBox = F::kBoxRows;
    const int s = t % kStages, kv0 = kv_begin + t * TK;
    uint8_t* k_st = ring + s * F::kStageBytes;
    uint8_t* v_st = k_st + F::kTileBytes;
    mbar_arrive_expect_tx(&full[s], F::kStageBytes);
    for (int rb = 0; rb < TK / kBox; ++rb) {
      for (int c = 0; c < F::kChunks; ++c) {
        const int off = (c * TK + rb * kBox) * kSwizzleRowBytes;
        tma_load_4d(k_st + off, &map_k, &full[s], c * 64, hk, kv0 + rb * kBox, b);
        tma_load_4d(v_st + off, &map_v, &full[s], c * 64, hk, kv0 + rb * kBox, b);
      }
    }
  };
  // At tile t: the stage of tile t - kLag, once both warpgroups released
  // it, with tile t - kLag + kStages.
  auto refill = [&](int t) {
    constexpr int kLag = F::kLag;
    if (producer && t >= kLag && t - kLag + kStages < tiles) {
      mbar_wait(&empty[(t - kLag) % kStages], ((t - kLag) / kStages) & 1);
      load_tile(t - kLag + kStages);
    }
  };
  if (producer) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(q_full, 1);
    fence_barrier_init();
    // Q and dO once (rows [0, HB P) of each 128-row stack), and the first
    // kStages K/V tiles.
    mbar_arrive_expect_tx(q_full, kPadRows ? 2 * F::kChunks * rows * kSwizzleRowBytes
                                           : 2 * F::kQBytes);
    for (int c = 0; c < F::kChunks; ++c) {
      tma_load_4d(q_sm + c * kRowsW * kSwizzleRowBytes, &map_q, q_full, c * 64, h0, q0, b);
      tma_load_4d(do_sm + c * kRowsW * kSwizzleRowBytes, &map_do, q_full, c * 64, h0, q0, b);
    }
    for (int t = 0; t < min(tiles, kStages); ++t) load_tile(t);
  }
  if constexpr (kPadRows) {
    // The padding rows of every Q and dO stack (the boxes never write
    // them) become zeros once, so their scores stay finite; the products
    // read them through the async proxy.
    constexpr int kStacks = 2 * F::kChunks;
    const int pad = (kRowsW - rows) * kSwizzleRowBytes / 16;  // 16-byte units a stack
    for (int i = threadIdx.x; i < kStacks * pad; i += F::kThreads) {
      const int st = i / pad;
      *reinterpret_cast<uint4*>(q_sm + (st * kRowsW + rows) * kSwizzleRowBytes +
                                (i - st * pad) * 16) = make_uint4(0u, 0u, 0u, 0u);
    }
    fence_proxy_async();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int lane = tid & 31, t4 = lane & 3;
  constexpr float kLog2e = 1.4426950408889634f;
  int qpos[2], head[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wg * 64 + (tid >> 5) * 16 + (lane >> 2) + 8 * h;
    qpos[h] = q0 + r / HB;
    head[h] = h0 + r % HB;
    // A padding row (past HB P, or a head past the group in a partial last
    // chunk) takes position Sq: read nowhere, stored nowhere.
    if (kPadRows && (r >= rows || head[h] >= (hk + 1) * G)) qpos[h] = Sq;
    const bool ok = qpos[h] < Sq;  // rows past Sq: Q and dO arrive as zeros
    const size_t i = (static_cast<size_t>(b) * Hq + head[h]) * Sq + (ok ? qpos[h] : 0);
    lse2[h] = ok ? lse[i] * kLog2e : 0.f;
    dlt[h] = ok ? delta[i] : 0.f;
  }
  const float c = scale * kLog2e;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  const uint64_t q_a = smem_desc(q_sm + wg * 64 * kSwizzleRowBytes, 16, 8 * kSwizzleRowBytes);
  const uint64_t do_a = smem_desc(do_sm + wg * 64 * kSwizzleRowBytes, 16, 8 * kSwizzleRowBytes);
  mbar_wait(q_full, 0);

  // Tile t: S and dP as two wgmma groups; P while dP runs; dS; the dQ
  // product left in flight under the next tile's S and dP. A warpgroup
  // releases tile t's stage once its dQ product has completed (at tile
  // t + 1). The producer refills under the score products where the stage
  // was released a tile earlier (kLag 2: the other warpgroup may run up to
  // a tile behind), else right after releasing it itself (kLag 1).
  for (int t = 0; t < tiles; ++t) {
    const int s = t % kStages, kv0 = kv_begin + t * TK;
    mbar_wait(&full[s], (t / kStages) & 1);
    const uint8_t* k_st = ring + s * F::kStageBytes;
    const uint64_t k_b = smem_desc(k_st, 16, 8 * kSwizzleRowBytes);
    const uint64_t v_b = smem_desc(k_st + F::kTileBytes, 16, 8 * kSwizzleRowBytes);

    // S = Q K^T and dP = dO V^T for the warpgroup's 64 rows x TK kv columns.
    float sc[TK / 2], dp[TK / 2];
    wgmma_fence();
    wgmma_ss_zero<TK, 0, 0>(sc, q_a, k_b);
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;  // 16 bf16 into the swizzled row
      wgmma<TK, 0, 0>(sc, desc_advance(q_a, (kk / 4) * kRowsW * kSwizzleRowBytes + col),
                      desc_advance(k_b, (kk / 4) * TK * kSwizzleRowBytes + col));
    }
    wgmma_commit();
    wgmma_ss_zero<TK, 0, 0>(dp, do_a, v_b);
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma<TK, 0, 0>(dp, desc_advance(do_a, (kk / 4) * kRowsW * kSwizzleRowBytes + col),
                      desc_advance(v_b, (kk / 4) * TK * kSwizzleRowBytes + col));
    }
    wgmma_commit();
    if constexpr (F::kLag > 1) refill(t);
    wgmma_wait<1>();  // the previous dQ product and S
    fence_regs(sc);
    fence_regs(acc);
    if (t > 0 && tid == 0) mbar_arrive(&empty[(t - 1) % kStages]);
    if constexpr (F::kLag == 1) refill(t);

    // P = 2^(S c - lse log2 e) in place; masked only on tiles that some
    // row's band cuts or that run past Skv.
    const bool interior =
        kv0 + TK <= Skv &&
        (!causal || (kv0 + TK - 1 <= q0 && (window <= 0 || qhi - kv0 < window)));
#pragma unroll
    for (int e = 0; e < TK / 2; ++e) {
      const int r = (e >> 1) & 1;  // column 8 (e / 4) + 2 t4 + (e & 1) of row r
      float p = exp2_approx(fmaf(sc[e], c, -lse2[r]));
      if (!interior) {
        const int kpos = kv0 + 8 * (e / 4) + 2 * t4 + (e & 1);
        if (!in_band(qpos[r], kpos, Skv, causal, window)) p = 0.f;
      }
      sc[e] = p;
    }
    wgmma_wait<0>();
    fence_regs(dp);
    // dS = P (dP - delta) scale, rounded to bf16 as the A operand.
    uint32_t da[TK / 16][4];
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = 8 * kk + 2 * i, r = i & 1;
        da[kk][i] = pack_f32(sc[e] * (dp[e] - dlt[r]) * scale,
                             sc[e + 1] * (dp[e + 1] - dlt[r]) * scale);
      }
    }

    // dQ += bf16(dS) K: dS from registers, K MN-major (the same bytes).
    const uint64_t k_m = smem_desc(k_st, TK * kSwizzleRowBytes, 8 * kSwizzleRowBytes);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      wgmma_rs<D, 1>(acc, da[kk], desc_advance(k_m, kk * 16 * kSwizzleRowBytes));
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= Sq) continue;
    bf16* out = dq + ((static_cast<size_t>(b) * Sq + qpos[r]) * Hq + head[r]) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// B3's output: a warpgroup's 64 kv rows. park_rows writes the fp32
// accumulator to shared memory ([element][thread]; local or another
// rank's); store_rows writes the rows below Skv once in bf16.
template <int D>
__device__ __forceinline__ void park_rows(const float (&acc)[D / 2], float* dst) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dst[i * 128] = acc[i];
}

template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], bf16* out,
                                           const int (&kpos)[2], int t4, int b, int Skv,
                                           int Hkv, int hk) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kpos[r] >= Skv) continue;
    bf16* o = out + ((static_cast<size_t>(b) * Skv + kpos[r]) * Hkv + hk) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// Two consecutive floats of shared memory, p 8-byte aligned where kAligned.
template <bool kAligned>
__device__ __forceinline__ float2 lds_pair(const float* p) {
  if constexpr (kAligned) return *reinterpret_cast<const float2*>(p);
  return make_float2(p[0], p[1]);
}

// Grid (kv tiles x split, B x Hkv), clusters of (split, 1, 1).
// kAligned (Sq % 4 == 0): every step's first lse/delta row starts its box,
// and a pair of stats is one 8-byte load. Other lengths read from (row & 3)
// on, two 4-byte loads a pair: on an H100 that offset and those loads
// cost 1-3% at Sq 2048, and a run-time choice between the two ways spills
// registers (PERF.md).
template <int D, bool kAligned>
__global__ void __launch_bounds__(BwdDkv<D>::kThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_do,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_lse,
                           const __grid_constant__ CUtensorMap map_delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv, int Hq,
                           int Hkv, int causal, int window, float scale) {
  using F = BwdDkv<D>;
  constexpr int TQ = F::kTQ, kSub = F::kSub, kStages = F::kStages;
  constexpr int kRowsKv = F::kRowsKv, kConsumers = F::kConsumers;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* v_sm = k_sm + F::kKvBytes;
  uint8_t* ring = v_sm + F::kKvBytes;
  // [stage][lse, delta][kStatSlot]
  float* stats = reinterpret_cast<float*>(ring + kStages * F::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + kStages * 2 * F::kStatSlot);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int G = Hq / Hkv;
  const int kv0 = (blockIdx.x / split) * kRowsKv;  // longest causal tiles first
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;

  // The q tiles that can see these kv rows (from the diagonal on, up to the
  // window's far edge), the (q head, q tile) steps, and this rank's share.
  int q_begin = 0, q_end = Sq;
  if (causal) {
    q_begin = (kv0 / TQ) * TQ;
    if (window > 0) q_end = min(Sq, kv0 + kRowsKv - 1 + window);
  }
  const int nq = q_end > q_begin ? (q_end - q_begin + TQ - 1) / TQ : 0;
  const int s_begin = G * nq * rank / split;
  const int n = G * nq * (rank + 1) / split - s_begin;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const bool producer = threadIdx.x == 0;
  // Step j of the share into stage j % kStages: Q, dO, lse and delta.
  auto load_step = [&](int j) {
    const int s = j % kStages, i = s_begin + j;
    const int hq = hk * G + i / nq, q0 = q_begin + (i % nq) * TQ;
    uint8_t* q_st = ring + s * F::kStageBytes;
    uint8_t* do_st = q_st + F::kTileBytes;
    float* st = stats + s * 2 * F::kStatSlot;
    mbar_arrive_expect_tx(&full[s], F::kStageBytes + 2 * F::kStatBytes);
    for (int rb = 0; rb < TQ / 64; ++rb) {
      for (int c = 0; c < F::kChunks; ++c) {
        const int off = c * TQ * kSwizzleRowBytes + rb * kBoxBytes;
        tma_load_4d(q_st + off, &map_q, &full[s], c * 64, hq, q0 + rb * 64, b);
        tma_load_4d(do_st + off, &map_do, &full[s], c * 64, hq, q0 + rb * 64, b);
      }
    }
    // The boxes start at the row rounded down to 16 bytes (Sq % 4 != 0
    // leaves rows off it); rows past Sq bring the next head's values (or
    // zeros): masked.
    const int row = ((b * Hq + hq) * Sq + q0) & ~3;
    tma_load_1d(st, &map_lse, &full[s], row);
    tma_load_1d(st + F::kStatSlot, &map_delta, &full[s], row);
  };

  if (producer) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(kv_full, 1);
    fence_barrier_init();
    // K and V once, and the first kStages steps.
    mbar_arrive_expect_tx(kv_full, 2 * F::kKvBytes);
    for (int rb = 0; rb < kRowsKv / 64; ++rb) {
      for (int c = 0; c < F::kChunks; ++c) {
        const int off = c * kRowsKv * kSwizzleRowBytes + rb * kBoxBytes;
        tma_load_4d(k_sm + off, &map_k, kv_full, c * 64, hk, kv0 + rb * 64, b);
        tma_load_4d(v_sm + off, &map_v, kv_full, c * 64, hk, kv0 + rb * 64, b);
      }
    }
    for (int j = 0; j < min(n, kStages); ++j) load_step(j);
  }
  __syncthreads();

  const int lane = tid & 31, t4 = lane & 3;
  constexpr float kLog2e = 1.4426950408889634f;
  const int kv_lo = kv0 + wg * 64;
  int kpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) kpos[h] = kv_lo + (tid >> 5) * 16 + (lane >> 2) + 8 * h;
  const float c = scale * kLog2e;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  fence_regs(dk_acc);
  fence_regs(dv_acc);
  const uint64_t k_a = smem_desc(k_sm + wg * 64 * kSwizzleRowBytes, 16, 8 * kSwizzleRowBytes);
  const uint64_t v_a = smem_desc(v_sm + wg * 64 * kSwizzleRowBytes, 16, 8 * kSwizzleRowBytes);
  mbar_wait(kv_full, 0);

  // Step j, kSub q columns at a time: S^T and dP^T as two wgmma groups; P^T
  // while dP^T runs; dS^T; the dV and dK products left in flight under the
  // next S^T and dP^T. A warpgroup releases step j's stage once the
  // products that read it have completed (at step j + 1); the producer
  // thread refills the stage of step j - 2 with step j + 2, so the other
  // warpgroup may run up to a step behind without stalling it.
  for (int j = 0; j < n; ++j) {
    const int s = j % kStages;
    const int q_tile = q_begin + ((s_begin + j) % nq) * TQ;
    const int hq = hk * G + (s_begin + j) / nq;
    mbar_wait(&full[s], (j / kStages) & 1);
    const uint8_t* q_st = ring + s * F::kStageBytes;
    const uint8_t* do_st = q_st + F::kTileBytes;
    // The step's first row sits (row & 3) floats into its boxes.
    const int off = kAligned ? 0 : ((b * Hq + hq) * Sq + q_tile) & 3;
    const float* lse_st = stats + s * 2 * F::kStatSlot + off;
    const float* dl_st = lse_st + F::kStatSlot;
#pragma unroll
    for (int h0 = 0; h0 < TQ; h0 += kSub) {
      const int q0 = q_tile + h0;
      const uint64_t q_b = smem_desc(q_st + h0 * kSwizzleRowBytes, 16, 8 * kSwizzleRowBytes);
      const uint64_t do_b = smem_desc(do_st + h0 * kSwizzleRowBytes, 16, 8 * kSwizzleRowBytes);

      // S^T = K Q^T and dP^T = V dO^T: the warpgroup's 64 kv rows x kSub q columns.
      float st[kSub / 2], dpt[kSub / 2];
      wgmma_fence();
      wgmma_ss_zero<kSub, 0, 0>(st, k_a, q_b);
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma<kSub, 0, 0>(st, desc_advance(k_a, (kk / 4) * kRowsKv * kSwizzleRowBytes + col),
                          desc_advance(q_b, (kk / 4) * TQ * kSwizzleRowBytes + col));
      }
      wgmma_commit();
      wgmma_ss_zero<kSub, 0, 0>(dpt, v_a, do_b);
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma<kSub, 0, 0>(dpt, desc_advance(v_a, (kk / 4) * kRowsKv * kSwizzleRowBytes + col),
                          desc_advance(do_b, (kk / 4) * TQ * kSwizzleRowBytes + col));
      }
      wgmma_commit();
      if (h0 == 0 && producer && j >= 2 && j + 2 < n) {
        mbar_wait(&empty[(j - 2) % kStages], ((j - 2) / kStages) & 1);
        load_step(j + 2);
      }
      wgmma_wait<1>();  // the previous dV, dK products and S^T
      fence_regs(st);
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      if (h0 == 0 && j > 0 && tid == 0) mbar_arrive(&empty[(j - 1) % kStages]);

      // P^T in place; masked only on tiles that some pair's band cuts or
      // that run past Sq.
      const bool interior =
          q0 + kSub <= Sq &&
          (!causal || (q0 >= kv_lo + 63 && (window <= 0 || q0 + kSub - 1 - kv_lo < window)));
#pragma unroll
      for (int e = 0; e < kSub / 2; e += 2) {
        const int r = (e >> 1) & 1;            // kv row kpos[r]
        const int col = 8 * (e / 4) + 2 * t4;  // q columns col, col + 1
        const float2 l2 = lds_pair<kAligned>(lse_st + h0 + col);
        const float lq[2] = {l2.x, l2.y};
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float p = exp2_approx(fmaf(st[e + u], c, -lq[u] * kLog2e));
          if (!interior) {
            const int q = q0 + col + u;
            const bool keep =
                q < Sq && (!causal || (q >= kpos[r] && (window <= 0 || q - kpos[r] < window)));
            if (!keep) p = 0.f;
          }
          st[e + u] = p;
        }
      }
      wgmma_wait<0>();
      fence_regs(dpt);
      // bf16(P^T) and bf16(dS^T), dS^T = P^T (dP^T - delta) scale, as the A
      // operands.
      uint32_t pa[kSub / 16][4], da[kSub / 16][4];
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int e = 8 * kk + 2 * jj;
          const int col = 16 * kk + 8 * (jj >> 1) + 2 * t4;
          const float2 d2 = lds_pair<kAligned>(dl_st + h0 + col);
          pa[kk][jj] = pack_f32(st[e], st[e + 1]);
          da[kk][jj] = pack_f32(st[e] * (dpt[e] - d2.x) * scale,
                                st[e + 1] * (dpt[e + 1] - d2.y) * scale);
        }
      }

      // dV += bf16(P^T) dO and dK += bf16(dS^T) Q: A from registers, dO and
      // Q MN-major (the same bytes as above).
      const uint64_t do_m =
          smem_desc(do_st + h0 * kSwizzleRowBytes, TQ * kSwizzleRowBytes, 8 * kSwizzleRowBytes);
      const uint64_t q_m =
          smem_desc(q_st + h0 * kSwizzleRowBytes, TQ * kSwizzleRowBytes, 8 * kSwizzleRowBytes);
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        wgmma_rs<D, 1>(dv_acc, pa[kk], desc_advance(do_m, kk * 16 * kSwizzleRowBytes));
      }
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        wgmma_rs<D, 1>(dk_acc, da[kk], desc_advance(q_m, kk * 16 * kSwizzleRowBytes));
      }
      wgmma_commit();
    }
  }
  wgmma_wait<0>();
  fence_regs(dv_acc);
  fence_regs(dk_acc);

  if (split == 1) {
    store_rows<D>(dk_acc, dk, kpos, t4, b, Skv, Hkv, hk);
    store_rows<D>(dv_acc, dv, kpos, t4, b, Skv, Hkv, hk);
    return;
  }
  // Two ranks: rank 0 writes dK, rank 1 dV, each rank 0's partial plus rank
  // 1's. Each pushes the partial it does not write into the other's shared
  // memory (over the ring, [warpgroup][element][thread]): remote stores,
  // between a barrier that frees the rings and one that lands the stores.
  float* park = reinterpret_cast<float*>(ring) + wg * 64 * D + tid;
  cluster.sync();
  float* peer = cluster.map_shared_rank(park, rank ^ 1);
  if (rank == 0) {
    park_rows<D>(dv_acc, peer);
  } else {
    park_rows<D>(dk_acc, peer);
  }
  cluster.sync();
  if (rank == 0) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] += park[i * 128];
    store_rows<D>(dk_acc, dk, kpos, t4, b, Skv, Hkv, hk);
  } else {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dv_acc[i] = park[i * 128] + dv_acc[i];
    store_rows<D>(dv_acc, dv, kpos, t4, b, Skv, Hkv, hk);
  }
}

// ---------------------------------------------------------------------------
// B3 on Hopper at head_dim 192 and 256: one warpgroup a gradient
// ---------------------------------------------------------------------------
// Bound: operations, 8 flops per head_dim per attended (q, k) pair (51.5
// GFLOP, 0.0521 ms at debug_300m's micro-batch, q [16, 1024, 4, 192], at
// 989 TFLOP/s). The head_dim-128 layout above keeps full-width dK and dV
// in each warpgroup: D / 2 + D / 2 fp32 registers a thread, 192 or 256
// here before the scores, past the 255 a thread may hold. So here the two
// warpgroups of a block share its 64 kv rows and split the work by
// gradient: warpgroup 0 runs S^T = K Q^T, makes P^T (masked, fp32) and
// accumulates dV += bf16(P^T) dO; warpgroup 1 runs dP^T = V dO^T, takes
// P^T from warpgroup 0 through shared memory (fp32, [element][thread]:
// the two accumulators' layouts are the same) and accumulates dK +=
// bf16(dS^T) Q with dS^T = P^T (dP^T - delta) scale. Each thread then
// holds one D / 2 accumulator (96 or 128 registers) beside a 64-column
// score tile, no product is recomputed, and every gradient product spans
// the full head_dim in one wgmma (N 192 or 256), so no operand starts
// inside a 64-column box (a column split at 96 would). The hand-off is
// 16 KB a step through two named barriers: 1 (P^T written; warpgroup 0
// arrives, 1 waits) and 2 (P^T read; 1 arrives, 0 waits before its next
// write). Not taken: (a) two ranks of a cluster splitting the output
// columns, each recomputing both score products over the full D (1.5x
// B3's products, and at head_dim 192 the half-way column 96 starts inside
// a box); (b) FlashAttention-3's split of the score tile, which hands both
// P^T and dS^T over and splits the output columns (the same column
// problem at 192).
// Otherwise as the kernel above: K and V loaded once; a ring of kStages
// Q / dO / lse / delta stages of 64 q rows for every (q head, q tile) step
// of the band (from the diagonal on, to the window's far edge), the group
// summed in the fp32 accumulators; each warpgroup leaves its gradient
// product in flight under its next score product and releases a stage
// once both products that read it are done. The producer is warpgroup 1's
// first thread (the warpgroup that trails): at step j it refills step j -
// 1's stage with step j - 1 + kStages. A cluster of two blocks shares a kv
// tile while the tiles number fewer than the SMs, and merges as above
// (rank 0 writes dK, rank 1 dV, rank 0's partial first in each sum).
template <int D>
struct BwdDkvHd {
  static constexpr int kTQ = 64;                   // q rows per stage
  static constexpr int kStages = D <= 192 ? 3 : 2;
  static constexpr int kChunks = D / 64;
  static constexpr int kRowsKv = 64;               // kv rows per block
  static constexpr int kKvBytes = kRowsKv * D * 2;  // K or V
  static constexpr int kTileBytes = kTQ * D * 2;    // Q or dO of one stage
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kPBytes = kRowsKv * kTQ * 4;  // P^T in fp32
  static constexpr int kStatBox = kTQ + 4;          // as BwdDkv
  static constexpr int kStatBytes = kStatBox * 4;
  static constexpr int kStatSlot = kTQ + 32;
  static constexpr int kSmemBytes = 1024 + 2 * kKvBytes + kStages * kStageBytes + kPBytes +
                                    kStages * 2 * kStatSlot * 4 + (2 * kStages + 1) * 8;
  static constexpr int kThreads = 256;
  static_assert(kSmemBytes <= 232448, "shared memory of one block");
  static_assert(kStages * kStageBytes >= kRowsKv * D * 4, "the merge parks over the ring");
};

template <int D, bool kAligned>
__global__ void __launch_bounds__(BwdDkvHd<D>::kThreads, 1)
flash_bwd_dkv_wgmma_hd256_kernel(const __grid_constant__ CUtensorMap map_q,
                                 const __grid_constant__ CUtensorMap map_do,
                                 const __grid_constant__ CUtensorMap map_k,
                                 const __grid_constant__ CUtensorMap map_v,
                                 const __grid_constant__ CUtensorMap map_lse,
                                 const __grid_constant__ CUtensorMap map_delta,
                                 bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv,
                                 int Hq, int Hkv, int causal, int window, float scale) {
  using F = BwdDkvHd<D>;
  constexpr int TQ = F::kTQ, kStages = F::kStages, kRowsKv = F::kRowsKv;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* v_sm = k_sm + F::kKvBytes;
  uint8_t* ring = v_sm + F::kKvBytes;
  float* p_sm = reinterpret_cast<float*>(ring + kStages * F::kStageBytes);  // [element][thread]
  float* stats = p_sm + kRowsKv * TQ;  // [stage][lse, delta][kStatSlot]
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + kStages * 2 * F::kStatSlot);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int G = Hq / Hkv;
  const int kv0 = (blockIdx.x / split) * kRowsKv;  // longest causal tiles first
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;

  // The q tiles that can see these kv rows, the (q head, q tile) steps, and
  // this rank's share.
  int q_begin = 0, q_end = Sq;
  if (causal) {
    q_begin = (kv0 / TQ) * TQ;
    if (window > 0) q_end = min(Sq, kv0 + kRowsKv - 1 + window);
  }
  const int nq = q_end > q_begin ? (q_end - q_begin + TQ - 1) / TQ : 0;
  const int s_begin = G * nq * rank / split;
  const int n = G * nq * (rank + 1) / split - s_begin;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const bool producer = threadIdx.x == 128;
  // Step j of the share into stage j % kStages: Q, dO, lse and delta.
  auto load_step = [&](int j) {
    const int s = j % kStages, i = s_begin + j;
    const int hq = hk * G + i / nq, q0 = q_begin + (i % nq) * TQ;
    uint8_t* q_st = ring + s * F::kStageBytes;
    float* st = stats + s * 2 * F::kStatSlot;
    mbar_arrive_expect_tx(&full[s], F::kStageBytes + 2 * F::kStatBytes);
    for (int c = 0; c < F::kChunks; ++c) {
      tma_load_4d(q_st + c * TQ * kSwizzleRowBytes, &map_q, &full[s], c * 64, hq, q0, b);
      tma_load_4d(q_st + F::kTileBytes + c * TQ * kSwizzleRowBytes, &map_do, &full[s], c * 64,
                  hq, q0, b);
    }
    const int row = ((b * Hq + hq) * Sq + q0) & ~3;  // as in the kernel above
    tma_load_1d(st, &map_lse, &full[s], row);
    tma_load_1d(st + F::kStatSlot, &map_delta, &full[s], row);
  };

  if (producer) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per warpgroup
    }
    mbar_init(kv_full, 1);
    fence_barrier_init();
    // K and V once, and the first kStages steps.
    mbar_arrive_expect_tx(kv_full, 2 * F::kKvBytes);
    for (int c = 0; c < F::kChunks; ++c) {
      tma_load_4d(k_sm + c * kBoxBytes, &map_k, kv_full, c * 64, hk, kv0, b);
      tma_load_4d(v_sm + c * kBoxBytes, &map_v, kv_full, c * 64, hk, kv0, b);
    }
    for (int j = 0; j < min(n, kStages); ++j) load_step(j);
  }
  __syncthreads();

  const int lane = tid & 31, t4 = lane & 3;
  constexpr float kLog2e = 1.4426950408889634f;
  int kpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) kpos[h] = kv0 + (tid >> 5) * 16 + (lane >> 2) + 8 * h;
  const float c = scale * kLog2e;
  float acc[D / 2];  // warpgroup 0: dV; warpgroup 1: dK
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  // The score product's A operand: K (warpgroup 0) or V (warpgroup 1).
  const uint64_t a_k = smem_desc(wg == 0 ? k_sm : v_sm, 16, 8 * kSwizzleRowBytes);
  mbar_wait(kv_full, 0);

  for (int j = 0; j < n; ++j) {
    const int s = j % kStages;
    const int q0 = q_begin + ((s_begin + j) % nq) * TQ;
    const int hq = hk * G + (s_begin + j) / nq;
    mbar_wait(&full[s], (j / kStages) & 1);
    const uint8_t* q_st = ring + s * F::kStageBytes;
    const uint8_t* do_st = q_st + F::kTileBytes;
    const int off = kAligned ? 0 : ((b * Hq + hq) * Sq + q0) & 3;
    const float* lse_st = stats + s * 2 * F::kStatSlot + off;
    const float* dl_st = lse_st + F::kStatSlot;

    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1): 64 kv rows
    // x TQ q columns, both operands K-major.
    const uint64_t b_k = smem_desc(wg == 0 ? q_st : do_st, 16, 8 * kSwizzleRowBytes);
    float sc[TQ / 2];
    wgmma_fence();
    wgmma_ss_zero<TQ, 0, 0>(sc, a_k, b_k);
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma<TQ, 0, 0>(sc, desc_advance(a_k, (kk / 4) * kRowsKv * kSwizzleRowBytes + col),
                      desc_advance(b_k, (kk / 4) * TQ * kSwizzleRowBytes + col));
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's gradient product
    fence_regs(acc);
    if (j > 0 && tid == 0) mbar_arrive(&empty[(j - 1) % kStages]);
    if (producer && j > 0 && j - 1 + kStages < n) {
      mbar_wait(&empty[(j - 1) % kStages], ((j - 1) / kStages) & 1);
      load_step(j - 1 + kStages);
    }
    wgmma_wait<0>();
    fence_regs(sc);

    uint32_t a[TQ / 16][4];  // the gradient product's A operand, bf16
    if (wg == 0) {
      // P^T in place; masked only on tiles that some pair's band cuts or
      // that run past Sq.
      const bool interior =
          q0 + TQ <= Sq &&
          (!causal || (q0 >= kv0 + kRowsKv - 1 && (window <= 0 || q0 + TQ - 1 - kv0 < window)));
#pragma unroll
      for (int e = 0; e < TQ / 2; e += 2) {
        const int r = (e >> 1) & 1;            // kv row kpos[r]
        const int col = 8 * (e / 4) + 2 * t4;  // q columns col, col + 1
        const float2 l2 = lds_pair<kAligned>(lse_st + col);
        const float lq[2] = {l2.x, l2.y};
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float p = exp2_approx(fmaf(sc[e + u], c, -lq[u] * kLog2e));
          if (!interior) {
            const int q = q0 + col + u;
            const bool keep =
                q < Sq && (!causal || (q >= kpos[r] && (window <= 0 || q - kpos[r] < window)));
            if (!keep) p = 0.f;
          }
          sc[e + u] = p;
        }
      }
      if (j > 0) named_barrier(2, 256);  // warpgroup 1 has read the last P^T
#pragma unroll
      for (int i = 0; i < TQ / 2; ++i) p_sm[i * 128 + tid] = sc[i];
      named_barrier_arrive(1, 256);
#pragma unroll
      for (int kk = 0; kk < TQ / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) a[kk][i] = pack_f32(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
    } else {
      named_barrier(1, 256);  // this step's P^T
#pragma unroll
      for (int kk = 0; kk < TQ / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = 8 * kk + 2 * i;
          const int col = 16 * kk + 8 * (i >> 1) + 2 * t4;
          const float2 d2 = lds_pair<kAligned>(dl_st + col);
          a[kk][i] = pack_f32(p_sm[e * 128 + tid] * (sc[e] - d2.x) * scale,
                              p_sm[(e + 1) * 128 + tid] * (sc[e + 1] - d2.y) * scale);
        }
      }
      if (j + 1 < n) named_barrier_arrive(2, 256);
    }

    // dV += bf16(P^T) dO (warpgroup 0) or dK += bf16(dS^T) Q (warpgroup 1):
    // A from registers, B MN-major (the same bytes as above).
    const uint64_t b_m =
        smem_desc(wg == 0 ? do_st : q_st, TQ * kSwizzleRowBytes, 8 * kSwizzleRowBytes);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TQ / 16; ++kk) {
      wgmma_rs<D, 1>(acc, a[kk], desc_advance(b_m, kk * 16 * kSwizzleRowBytes));
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc);

  bf16* out = wg == 0 ? dv : dk;
  if (split == 1) {
    store_rows<D>(acc, out, kpos, t4, b, Skv, Hkv, hk);
    return;
  }
  // Two ranks: rank 0 writes dK (its warpgroup 1 adds rank 1's), rank 1 dV
  // (its warpgroup 0 adds rank 0's); the other two warpgroups push their
  // partials into the writer's shared memory (over the ring).
  float* park = reinterpret_cast<float*>(ring) + tid;
  cluster.sync();
  if (wg == rank) park_rows<D>(acc, cluster.map_shared_rank(park, rank ^ 1));
  cluster.sync();
  if (wg != rank) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = rank == 0 ? acc[i] + park[i * 128]
                                                       : park[i * 128] + acc[i];
    store_rows<D>(acc, out, kpos, t4, b, Skv, Hkv, hk);
  }
}

// ---------------------------------------------------------------------------
// head_dim above 256 (any multiple of 64): B1-B3 over 64-column slices
// ---------------------------------------------------------------------------
// The kernels above keep whole rows of Q (B1, B2: and dO) or K and V (B3) in
// shared memory and whole output rows in registers; above head_dim 256
// neither fits. Here each block owns one 64-column slice of its output
// (grid.z), accumulates the scores over D in 64-column chunks staged one at
// a time, and recomputes them for every slice. No preset of either package
// uses these head dims; speed is not the point, the same results are.
constexpr int kSlice = 64;
constexpr int kLdS = kSlice + kPad;

__global__ void __launch_bounds__(kThreads)
flash_fwd_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv, int D,
                      int causal, int window, float scale) {
  constexpr int TK = 64;
  extern __shared__ uint4 smem_u4[];
  bf16* q_sm = reinterpret_cast<bf16*>(smem_u4);  // [kRows][kLdS]: a chunk of Q
  bf16* k_sm = q_sm + kRows * kLdS;                // [TK][kLdS]: a chunk of K
  bf16* v_sm = k_sm + TK * kLdS;                   // [TK][kLdS]: V's slice

  const int slices = D / kSlice, c0 = (blockIdx.z % slices) * kSlice;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const Rows rows = block_rows(Hq / Hkv, hk, blockIdx.z / slices);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const int row[2] = {wr + g, wr + g + 8};
  const int qpos[2] = {rows.pos(row[0]), rows.pos(row[1])};
  const bf16* q_w = q_sm + wr * kLdS;

  int kv_begin, kv_end;
  kv_range<TK>(rows.q0, min(rows.q0 + rows.P, Sq) - 1, Skv, causal, window, kv_begin, kv_end);
  const size_t kv_ld = static_cast<size_t>(Hkv) * D;
  const bf16* k_bh = k + (static_cast<size_t>(b) * Skv * Hkv + hk) * D;
  const bf16* v_bh = v + (static_cast<size_t>(b) * Skv * Hkv + hk) * D;

  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};
  float acc[kSlice / 8][4];
#pragma unroll
  for (int n = 0; n < kSlice / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += TK) {
    // S = Q K^T, summed over D in 64-column chunks.
    float s[TK / 8][4];
#pragma unroll
    for (int n = 0; n < TK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kSlice) {
      __syncthreads();  // the previous chunk (and tile) is consumed
      stage_group<kSlice>(q_sm, q, b, Sq, Hq, D, d0, rows, tid);
      stage<kSlice>(k_sm, k_bh + kv0 * kv_ld + d0, kv_ld, TK, Skv - kv0, tid, kThreads);
      if (d0 == 0) stage<kSlice>(v_sm, v_bh + kv0 * kv_ld + c0, kv_ld, TK, Skv - kv0, tid, kThreads);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kSlice / 16; ++kk) {
        const AFrag a = a_rows(q_w, kLdS, kk, lane);
#pragma unroll
        for (int n = 0; n < TK / 8; ++n) {
          uint32_t b0, b1;
          b_rows(k_sm, kLdS, n, kk, lane, b0, b1);
          mma(s[n], a.r[0], a.r[1], a.r[2], a.r[3], b0, b1);
        }
      }
    }
    softmax_step<TK, kSlice / 8>(s, acc, m_i, l_i, qpos, kv0, t, Skv, causal, window, scale);
    // acc += bf16(P) V[:, slice].
#pragma unroll
    for (int j = 0; j < TK / 16; ++j) {
      const AFrag a = a_acc(s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int n = 0; n < kSlice / 8; ++n) {
        uint32_t b0, b1;
        b_cols(v_sm, kLdS, j, n, lane, b0, b1);
        mma(acc[n], a.r[0], a.r[1], a.r[2], a.r[3], b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!rows.valid(row[r], Sq)) continue;
    const int hq = rows.head(row[r]);
    const float safe = l_i[r] == 0.f ? 1.f : l_i[r];
    if (t == 0 && c0 == 0) {
      lse[(static_cast<size_t>(b) * Hq + hq) * Sq + qpos[r]] = m_i[r] + logf(safe);
    }
    bf16* out = o + ((static_cast<size_t>(b) * Sq + qpos[r]) * Hq + hq) * D + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < kSlice / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * r] / safe, acc[n][2 * r + 1] / safe);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv, int D,
                         int causal, int window, float scale) {
  constexpr int TK = 64;
  extern __shared__ uint4 smem_u4[];
  bf16* q_sm = reinterpret_cast<bf16*>(smem_u4);  // [kRows][kLdS]: chunks
  bf16* do_sm = q_sm + kRows * kLdS;               // [kRows][kLdS]
  bf16* k_sm = do_sm + kRows * kLdS;               // [TK][kLdS]
  bf16* v_sm = k_sm + TK * kLdS;                   // [TK][kLdS]
  bf16* ks_sm = v_sm + TK * kLdS;                  // [TK][kLdS]: K's slice

  const int slices = D / kSlice, c0 = (blockIdx.z % slices) * kSlice;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const Rows rows = block_rows(Hq / Hkv, hk, blockIdx.z / slices);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const int row[2] = {wr + g, wr + g + 8};
  const int qpos[2] = {rows.pos(row[0]), rows.pos(row[1])};
  const bf16* q_w = q_sm + wr * kLdS;
  const bf16* do_w = do_sm + wr * kLdS;

  float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!rows.valid(row[r], Sq)) continue;
    const size_t i = (static_cast<size_t>(b) * Hq + rows.head(row[r])) * Sq + qpos[r];
    lse_r[r] = lse[i];
    delta_r[r] = delta[i];
  }

  int kv_begin, kv_end;
  kv_range<TK>(rows.q0, min(rows.q0 + rows.P, Sq) - 1, Skv, causal, window, kv_begin, kv_end);
  const size_t kv_ld = static_cast<size_t>(Hkv) * D;
  const bf16* k_bh = k + (static_cast<size_t>(b) * Skv * Hkv + hk) * D;
  const bf16* v_bh = v + (static_cast<size_t>(b) * Skv * Hkv + hk) * D;

  float acc[kSlice / 8][4];
#pragma unroll
  for (int n = 0; n < kSlice / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += TK) {
    // S = Q K^T and dP = dO V^T, summed over D in 64-column chunks.
    float s[TK / 8][4], dp[TK / 8][4];
#pragma unroll
    for (int n = 0; n < TK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kSlice) {
      __syncthreads();
      stage_group<kSlice>(q_sm, q, b, Sq, Hq, D, d0, rows, tid);
      stage_group<kSlice>(do_sm, dout, b, Sq, Hq, D, d0, rows, tid);
      stage<kSlice>(k_sm, k_bh + kv0 * kv_ld + d0, kv_ld, TK, Skv - kv0, tid, kThreads);
      stage<kSlice>(v_sm, v_bh + kv0 * kv_ld + d0, kv_ld, TK, Skv - kv0, tid, kThreads);
      if (d0 == 0) stage<kSlice>(ks_sm, k_bh + kv0 * kv_ld + c0, kv_ld, TK, Skv - kv0, tid, kThreads);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kSlice / 16; ++kk) {
        const AFrag aq = a_rows(q_w, kLdS, kk, lane);
        const AFrag ado = a_rows(do_w, kLdS, kk, lane);
#pragma unroll
        for (int n = 0; n < TK / 8; ++n) {
          uint32_t b0, b1;
          b_rows(k_sm, kLdS, n, kk, lane, b0, b1);
          mma(s[n], aq.r[0], aq.r[1], aq.r[2], aq.r[3], b0, b1);
          b_rows(v_sm, kLdS, n, kk, lane, b0, b1);
          mma(dp[n], ado.r[0], ado.r[1], ado.r[2], ado.r[3], b0, b1);
        }
      }
    }
    ds_step<TK>(s, dp, lse_r, delta_r, qpos, kv0, t, Skv, causal, window, scale);
    // dQ[:, slice] += bf16(dS) K[:, slice].
#pragma unroll
    for (int j = 0; j < TK / 16; ++j) {
      const AFrag a = a_acc(s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int n = 0; n < kSlice / 8; ++n) {
        uint32_t b0, b1;
        b_cols(ks_sm, kLdS, j, n, lane, b0, b1);
        mma(acc[n], a.r[0], a.r[1], a.r[2], a.r[3], b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!rows.valid(row[r], Sq)) continue;
    bf16* out = dq + ((static_cast<size_t>(b) * Sq + qpos[r]) * Hq + rows.head(row[r])) * D +
                c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < kSlice / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

__global__ void __launch_bounds__(kThreads3)
flash_bwd_dkv_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv, int Hq,
                          int Hkv, int D, int causal, int window, float scale) {
  extern __shared__ uint4 smem_u4[];
  bf16* k_sm = reinterpret_cast<bf16*>(smem_u4);  // [kTileKv3][kLdS]: chunks
  bf16* v_sm = k_sm + kTileKv3 * kLdS;             // [kTileKv3][kLdS]
  bf16* q_sm = v_sm + kTileKv3 * kLdS;             // [kTileQ3][kLdS]
  bf16* do_sm = q_sm + kTileQ3 * kLdS;             // [kTileQ3][kLdS]
  bf16* qs_sm = do_sm + kTileQ3 * kLdS;            // [kTileQ3][kLdS]: Q's slice
  bf16* dos_sm = qs_sm + kTileQ3 * kLdS;           // [kTileQ3][kLdS]: dO's slice
  float* lse_sm = reinterpret_cast<float*>(dos_sm + kTileQ3 * kLdS);  // [kTileQ3]
  float* delta_sm = lse_sm + kTileQ3;                                   // [kTileQ3]

  const int G = Hq / Hkv;
  const int c0 = blockIdx.z * kSlice;
  const int kv0 = blockIdx.x * kTileKv3;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kpos[2] = {kv0 + warp * 16 + g, kv0 + warp * 16 + g + 8};
  const bf16* k_w = k_sm + warp * 16 * kLdS;
  const bf16* v_w = v_sm + warp * 16 * kLdS;

  const size_t kv_ld = static_cast<size_t>(Hkv) * D;
  const size_t kv_base = (static_cast<size_t>(b) * Skv + kv0) * kv_ld + static_cast<size_t>(hk) * D;
  int q_begin = 0, q_end = Sq;
  if (causal) {
    q_begin = (kv0 / kTileQ3) * kTileQ3;
    if (window > 0) q_end = min(Sq, kv0 + kTileKv3 - 1 + window);
  }

  float dk_acc[kSlice / 8][4], dv_acc[kSlice / 8][4];
#pragma unroll
  for (int n = 0; n < kSlice / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const size_t q_ld = static_cast<size_t>(Hq) * D;
  for (int gi = 0; gi < G; ++gi) {
    const int hq = hk * G + gi;
    const float* lse_h = lse + (static_cast<size_t>(b) * Hq + hq) * Sq;
    const float* delta_h = delta + (static_cast<size_t>(b) * Hq + hq) * Sq;
    for (int q0 = q_begin; q0 < q_end; q0 += kTileQ3) {
      const size_t q_base = (static_cast<size_t>(b) * Sq + q0) * q_ld + static_cast<size_t>(hq) * D;
      // S^T = K Q^T and dP^T = V dO^T, summed over D in 64-column chunks.
      float st[kTileQ3 / 8][4], dpt[kTileQ3 / 8][4];
#pragma unroll
      for (int n = 0; n < kTileQ3 / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
      for (int d0 = 0; d0 < D; d0 += kSlice) {
        __syncthreads();
        stage<kSlice>(k_sm, k + kv_base + d0, kv_ld, kTileKv3, Skv - kv0, tid, kThreads3);
        stage<kSlice>(v_sm, v + kv_base + d0, kv_ld, kTileKv3, Skv - kv0, tid, kThreads3);
        stage<kSlice>(q_sm, q + q_base + d0, q_ld, kTileQ3, Sq - q0, tid, kThreads3);
        stage<kSlice>(do_sm, dout + q_base + d0, q_ld, kTileQ3, Sq - q0, tid, kThreads3);
        if (d0 == 0) {
          stage<kSlice>(qs_sm, q + q_base + c0, q_ld, kTileQ3, Sq - q0, tid, kThreads3);
          stage<kSlice>(dos_sm, dout + q_base + c0, q_ld, kTileQ3, Sq - q0, tid, kThreads3);
          if (tid < kTileQ3) {
            const bool ok = q0 + tid < Sq;
            lse_sm[tid] = ok ? lse_h[q0 + tid] : 0.f;
            delta_sm[tid] = ok ? delta_h[q0 + tid] : 0.f;
          }
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kSlice / 16; ++kk) {
          const AFrag ak = a_rows(k_w, kLdS, kk, lane);
          const AFrag av = a_rows(v_w, kLdS, kk, lane);
#pragma unroll
          for (int n = 0; n < kTileQ3 / 8; ++n) {
            uint32_t b0, b1;
            b_rows(q_sm, kLdS, n, kk, lane, b0, b1);
            mma(st[n], ak.r[0], ak.r[1], ak.r[2], ak.r[3], b0, b1);
            b_rows(do_sm, kLdS, n, kk, lane, b0, b1);
            mma(dpt[n], av.r[0], av.r[1], av.r[2], av.r[3], b0, b1);
          }
        }
      }
      pds_step(st, dpt, lse_sm, delta_sm, kpos, q0, t, Sq, Skv, causal, window, scale);
      // dV[:, slice] += bf16(P^T) dO[:, slice], dK[:, slice] += bf16(dS^T) Q[:, slice].
#pragma unroll
      for (int j = 0; j < kTileQ3 / 16; ++j) {
        const AFrag ap = a_acc(st[2 * j], st[2 * j + 1]);
        const AFrag ads = a_acc(dpt[2 * j], dpt[2 * j + 1]);
#pragma unroll
        for (int n = 0; n < kSlice / 8; ++n) {
          uint32_t b0, b1;
          b_cols(dos_sm, kLdS, j, n, lane, b0, b1);
          mma(dv_acc[n], ap.r[0], ap.r[1], ap.r[2], ap.r[3], b0, b1);
          b_cols(qs_sm, kLdS, j, n, lane, b0, b1);
          mma(dk_acc[n], ads.r[0], ads.r[1], ads.r[2], ads.r[3], b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kpos[r] >= Skv) continue;
    const size_t off = (static_cast<size_t>(b) * Skv + kpos[r]) * kv_ld +
                       static_cast<size_t>(hk) * D + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < kSlice / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8) =
          __floats2bfloat162_rn(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8) =
          __floats2bfloat162_rn(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

bool shape_ok(int B, int Sq, int Skv, int Hq, int Hkv, int D) {
  if (B <= 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0) return false;
  if (D <= 0 || D % kSlice != 0) return false;
  return Sq > 0 && Skv > 0;
}

// The CUDA kernel each entry (0 B1, 1 B2, 2 B3) launched last in this
// process, named as the profiler names it: a record of the route taken that
// does not depend on CUPTI delivering the launch's activity record.
char g_last_kernel[3][64];

// Records `name` (with its template arguments, "" for none) for `entry`
// after a launch that reported no error; passes the error through.
cudaError_t note_launch(cudaError_t err, int entry, const char* name, const char* args) {
  if (err == cudaSuccess) {
    snprintf(g_last_kernel[entry], sizeof(g_last_kernel[entry]), "%s%s", name, args);
  }
  return err;
}

// "<D, true>" or "<D, false>".
struct TemplateArgs {
  char text[24];
  TemplateArgs(int d, bool flag) {
    snprintf(text, sizeof(text), "<%d, %s>", d, flag ? "true" : "false");
  }
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// B1/B2 grid: (q tiles, batch x kv heads, head chunks of the group).
dim3 group_grid(int B, int Sq, int Hq, int Hkv) {
  const int G = Hq / Hkv;
  const int HB = G < kRows ? G : kRows, P = kRows / HB;
  return dim3((Sq + P - 1) / P, B * Hkv, (G + HB - 1) / HB);
}

// Whether the group tiles `rows` (q head, position) rows of a wgmma block:
// HB = min(G, rows) heads divide the rows and the group.
bool group_tiles(int rows, int Hq, int Hkv) {
  const int G = Hq / Hkv, HB = G < rows ? G : rows;
  return rows % HB == 0 && G % HB == 0;
}

// The tensor map of a [B, S, H, D] bf16 tensor (q, k, v, dO), in boxes of
// 64 columns x `heads` heads x `rows` positions.
bool bshd_map(CUtensorMap* map, const void* base, int B, int S, int H, int D, int heads,
           int rows) {
  using u64 = uint64_t;
  const u64 dims[4] = {static_cast<u64>(D), static_cast<u64>(H), static_cast<u64>(S),
                       static_cast<u64>(B)};
  const u64 strides[3] = {static_cast<u64>(D), static_cast<u64>(H) * D,
                          static_cast<u64>(S) * H * D};
  const uint32_t box[4] = {64, static_cast<uint32_t>(heads), static_cast<uint32_t>(rows), 1};
  return tensor_map(map, base, 4, dims, strides, box);
}

// B1 at head_dim 64-256, any group: padding rows where the group does not
// tile the block's rows.
template <int D>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o, void* lse,
                             int B, int Sq, int Skv, int Hq, int Hkv, int causal, int window,
                             float scale, cudaStream_t stream) {
  using F = Fwd<D>;
  const int G = Hq / Hkv, HB = G < F::kRowsW ? G : F::kRowsW, P = F::kRowsW / HB;
  CUtensorMap mq, mk, mv;
  if (!bshd_map(&mq, q, B, Sq, Hq, D, HB, P) || !bshd_map(&mk, k, B, Skv, Hkv, D, 1, 64) ||
      !bshd_map(&mv, v, B, Skv, Hkv, D, 1, 64)) {
    return cudaErrorInvalidValue;
  }
  const bool pad = !group_tiles(F::kRowsW, Hq, Hkv);
  auto* kernel = pad ? flash_fwd_wgmma_kernel<D, true> : flash_fwd_wgmma_kernel<D, false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + P - 1) / P, B * Hkv, (G + HB - 1) / HB);
  kernel<<<grid, F::kThreads, F::kSmemBytes, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), static_cast<float*>(lse), Sq, Skv, Hq, Hkv, causal,
      window, scale);
  return note_launch(cudaGetLastError(), 0, "flash_fwd_wgmma_kernel", TemplateArgs(D, pad).text);
}

template <int D, bool kPadRows>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int B, int Sq,
                            int Skv, int Hq, int Hkv, int causal, int window, float scale,
                            cudaStream_t stream) {
  using F = BwdDq<D>;
  const int G = Hq / Hkv, HB = G < F::kRowsW ? G : F::kRowsW, P = F::kRowsW / HB;
  CUtensorMap mq, mdo, mk, mv;
  if (!bshd_map(&mq, q, B, Sq, Hq, D, HB, P) || !bshd_map(&mdo, dout, B, Sq, Hq, D, HB, P) ||
      !bshd_map(&mk, k, B, Skv, Hkv, D, 1, F::kBoxRows) ||
      !bshd_map(&mv, v, B, Skv, Hkv, D, 1, F::kBoxRows)) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<D, kPadRows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      F::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + P - 1) / P, B * Hkv, (G + HB - 1) / HB);
  flash_bwd_dq_wgmma_kernel<D, kPadRows><<<grid, F::kThreads, F::kSmemBytes, stream>>>(
      mq, mdo, mk, mv, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), Sq, Skv, Hq, Hkv, causal, window, scale);
  return note_launch(cudaGetLastError(), 1, "flash_bwd_dq_wgmma_kernel",
                     TemplateArgs(D, kPadRows).text);
}

// B3's wgmma kernels: the head_dim 64/128 one, or the head_dim 192/256 one.
template <int D, bool kAligned>
auto dkv_wgmma_kernel() {
  if constexpr (D <= 128) {
    return flash_bwd_dkv_wgmma_kernel<D, kAligned>;
  } else {
    return flash_bwd_dkv_wgmma_hd256_kernel<D, kAligned>;
  }
}

template <int D>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int B,
                             int Sq, int Skv, int Hq, int Hkv, int causal, int window,
                             float scale, cudaStream_t stream) {
  using F = std::conditional_t<(D <= 128), BwdDkv<D>, BwdDkvHd<D>>;
  CUtensorMap mq, mdo, mk, mv, mlse, mdelta;
  const uint64_t stats = static_cast<uint64_t>(B) * Hq * Sq;
  if (!bshd_map(&mq, q, B, Sq, Hq, D, 1, 64) || !bshd_map(&mdo, dout, B, Sq, Hq, D, 1, 64) ||
      !bshd_map(&mk, k, B, Skv, Hkv, D, 1, 64) || !bshd_map(&mv, v, B, Skv, Hkv, D, 1, 64) ||
      !tensor_map_f32(&mlse, lse, stats, F::kStatBox) ||
      !tensor_map_f32(&mdelta, delta, stats, F::kStatBox)) {
    return cudaErrorInvalidValue;
  }
  const bool aligned = Sq % 4 == 0;
  auto* kernel = aligned ? dkv_wgmma_kernel<D, true>() : dkv_wgmma_kernel<D, false>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F::kSmemBytes);
  if (err != cudaSuccess) return err;
  // Two blocks share each kv tile while the tiles number fewer than the
  // SMs (from the shapes alone): the b1 shape's 128.
  const int tiles = (Skv + F::kRowsKv - 1) / F::kRowsKv;
  const int split = 1LL * tiles * B * Hkv < sm_count() ? 2 : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * split, B * Hkv, 1);
  cfg.blockDim = dim3(F::kThreads);
  cfg.dynamicSmemBytes = F::kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, mq, mdo, mk, mv, mlse, mdelta,
                           static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Skv, Hq, Hkv,
                           causal, window, scale);
  return note_launch(err != cudaSuccess ? err : cudaGetLastError(), 2,
                     D <= 128 ? "flash_bwd_dkv_wgmma_kernel" : "flash_bwd_dkv_wgmma_hd256_kernel",
                     TemplateArgs(D, aligned).text);
}

// Above head_dim 256: grid.z also walks the 64-column output slices.
cudaError_t launch_fwd_wide(const void* q, const void* k, const void* v, void* o, void* lse,
                            int B, int Sq, int Skv, int Hq, int Hkv, int D, int causal,
                            int window, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (kRows + 2 * 64) * kLdS;
  dim3 grid = group_grid(B, Sq, Hq, Hkv);
  grid.z *= D / kSlice;
  flash_fwd_wide_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), Sq, Skv, Hq, Hkv, D, causal, window,
      scale);
  return note_launch(cudaGetLastError(), 0, "flash_fwd_wide_kernel", "");
}

cudaError_t launch_dq_wide(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq, int B, int Sq, int Skv,
                           int Hq, int Hkv, int D, int causal, int window, float scale,
                           cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (2 * kRows + 3 * 64) * kLdS;
  cudaError_t err = allow_smem(flash_bwd_dq_wide_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid = group_grid(B, Sq, Hq, Hkv);
  grid.z *= D / kSlice;
  flash_bwd_dq_wide_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), Sq, Skv, Hq, Hkv, D, causal,
      window, scale);
  return note_launch(cudaGetLastError(), 1, "flash_bwd_dq_wide_kernel", "");
}

cudaError_t launch_dkv_wide(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dk, void* dv, int B,
                            int Sq, int Skv, int Hq, int Hkv, int D, int causal, int window,
                            float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(bf16) * (2 * kTileKv3 + 4 * kTileQ3) * kLdS + sizeof(float) * 2 * kTileQ3;
  dim3 grid((Skv + kTileKv3 - 1) / kTileKv3, B * Hkv, D / kSlice);
  flash_bwd_dkv_wide_kernel<<<grid, kThreads3, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq,
      Skv, Hq, Hkv, D, causal, window, scale);
  return note_launch(cudaGetLastError(), 2, "flash_bwd_dkv_wide_kernel", "");
}

// One switch over the head dims: a template each up to 256, the 64-column
// slices above.
#define LUMINA_BY_DIM(D, CALL, WIDE)                  \
  switch (D) {                                        \
    case 64: return static_cast<int>(CALL(64));       \
    case 128: return static_cast<int>(CALL(128));     \
    case 192: return static_cast<int>(CALL(192));     \
    case 256: return static_cast<int>(CALL(256));     \
    default: return static_cast<int>(WIDE);           \
  }

}  // namespace

extern "C" {

// Each entry launches one kernel on `stream` and returns cudaGetLastError()
// (the Python wrapper raises on anything but cudaSuccess, 0). Shapes are
// checked by the wrapper; these re-check only what would make the launch
// unsafe. window <= 0 means no window.

int lumina_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                     int Sq, int Skv, int Hq, int Hkv, int D, int causal, int window,
                     float scale, void* stream) {
  if (!shape_ok(B, Sq, Skv, Hq, Hkv, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(DD) \
  launch_fwd_wgmma<DD>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, causal, window, scale, s)
  LUMINA_BY_DIM(D, CALL,
                launch_fwd_wide(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, D, causal, window, scale, s))
#undef CALL
}

int lumina_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, int B, int Sq, int Skv,
                        int Hq, int Hkv, int D, int causal, int window, float scale,
                        void* stream) {
  if (!shape_ok(B, Sq, Skv, Hq, Hkv, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // head_dim 64-256, any group: the wgmma kernel (with padding rows where
  // the group does not divide its 128).
  const bool pad = !group_tiles(BwdDq<64>::kRowsW, Hq, Hkv);
#define LAUNCH(DD, PAD)                                                                  \
  launch_dq_wgmma<DD, PAD>(q, k, v, dout, lse, delta, dq, B, Sq, Skv, Hq, Hkv, causal, window, \
                           scale, s)
#define CALL(DD) (pad ? LAUNCH(DD, true) : LAUNCH(DD, false))
  LUMINA_BY_DIM(D, CALL,
                launch_dq_wide(q, k, v, dout, lse, delta, dq, B, Sq, Skv, Hq, Hkv, D, causal,
                               window, scale, s))
#undef CALL
#undef LAUNCH
}

int lumina_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, int B, int Sq,
                         int Skv, int Hq, int Hkv, int D, int causal, int window, float scale,
                         void* stream) {
  if (!shape_ok(B, Sq, Skv, Hq, Hkv, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(DD)                                                                              \
  launch_dkv_wgmma<DD>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Skv, Hq, Hkv, causal, window, \
                       scale, s)
  LUMINA_BY_DIM(D, CALL,
                launch_dkv_wide(q, k, v, dout, lse, delta, dk, dv, B, Sq, Skv, Hq, Hkv, D,
                                causal, window, scale, s))
#undef CALL
}

// The kernel entry (0 B1, 1 B2, 2 B3) launched last in this process, as
// the profiler names it ("" before its first launch).
const char* lumina_flash_last_kernel(int entry) {
  return entry >= 0 && entry < 3 ? g_last_kernel[entry] : "";
}

}  // extern "C"
