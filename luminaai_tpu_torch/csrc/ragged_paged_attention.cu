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

size_t split_smem(int R, int D) {
  const size_t ld = D + kPad;
  const size_t ring = kStages * 2 * R * ld * sizeof(bf16);
  const size_t state = kHeads * D * sizeof(float);  // reuses the ring
  return kHeads * ld * sizeof(bf16) + (ring > state ? ring : state) +
         sizeof(float) * (2 * kHeads + kHeads * kMaxSplit);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
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

// Grid (split, Hkv x head chunks, B), clusters of (split, 1, 1).
template <int R>
__global__ void __launch_bounds__(kThreads, 2)
ragged_decode_kernel_split(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const int* __restrict__ table,
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
  bf16* ring = q_sm + kHeads * ld;                 // kStages x (K [R][ld], V [R][ld])
  const size_t ring_elems = static_cast<size_t>(kStages) * 2 * R * ld;
  const size_t state_elems = static_cast<size_t>(kHeads) * D * 2;  // fp32 [kHeads][D]
  float* m_sm = reinterpret_cast<float*>(ring + (ring_elems > state_elems ? ring_elems
                                                                           : state_elems));
  float* l_sm = m_sm + kHeads;
  float* w_sm = l_sm + kHeads;  // [kHeads][kMaxSplit]: each rank's weight

  int length = lengths[b];
  length = max(0, min(length, P * page_size));
  const int start = window > 0 ? max(length - window, 0) : 0;
  const int tiles = (length - start + R - 1) / R;
  const int t_begin = tiles * rank / split, t_end = tiles * (rank + 1) / split;
  const int n_t = t_end - t_begin;
  const int* lane_table = table + static_cast<size_t>(b) * P;

  // The chunk's q rows; rows past the group are zeros.
  const bf16* q_lane = q + (static_cast<size_t>(b) * Hq + q_head0) * D;
  for (int i = tid; i < kHeads * (D / 8); i += kThreads) {
    const int hh = i / (D / 8), c = i - hh * (D / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (hh < group) val = *reinterpret_cast<const uint4*>(q_lane + hh * D + c * 8);
    *reinterpret_cast<uint4*>(q_sm + hh * ld + c * 8) = val;
  }

  // cp.async the K and V rows of band tile `t` into ring slot `st`.
  auto load = [&](int t, int st) {
    bf16* k_st = ring + static_cast<size_t>(st) * 2 * R * ld;
    bf16* v_st = k_st + R * ld;
    const int row0 = start + t * R;
    for (int c = tid; c < R * (D / 8); c += kThreads) {
      const int r = c / (D / 8), cc = c - r * (D / 8);
      const int kp = row0 + r;
      size_t off = 0;
      if (kp < length) {
        int phys = lane_table[kp / page_size];
        phys = min(max(phys, 0), n_pages - 1);
        off = ((static_cast<size_t>(phys) * page_size + kp % page_size) * Hkv + h) * D + cc * 8;
      }
      const int bytes = kp < length ? 16 : 0;  // zero-fill rows past the band
      cp_async16(k_st + r * ld + cc * 8, k + off, bytes);
      cp_async16(v_st + r * ld + cc * 8, v + off, bytes);
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

    const bf16* k_st = ring + static_cast<size_t>(i % kStages) * 2 * R * ld;
    const bf16* v_st = k_st + R * ld;
    const int rows = min(R, length - (start + (t_begin + i) * R));

    // S = Q K^T: the chunk's 16 heads x the tile's R rows.
    float s[R / 8][4];
#pragma unroll
    for (int n = 0; n < R / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    const int mrow = (lane >> 3), r8 = lane & 7;
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
          ldmatrix_x4<true>(bv, v_st + (16 * j + (mrow & 1) * 8 + r8) * ld + c_w + 16 * pp +
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
  float* o_sm = reinterpret_cast<float*>(ring);
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

template <int R>
cudaError_t launch_split(const void* q, const void* k, const void* v, const void* table,
                         const void* lengths, void* out, int B, int Hq, int Hkv, int D,
                         int page_size, int P, int n_pages, int window, float scale,
                         cudaStream_t stream) {
  const size_t smem = split_smem(R, D);
  cudaError_t err = allow_smem(ragged_decode_kernel_split<R>, smem);
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
  err = cudaLaunchKernelEx(&cfg, ragged_decode_kernel_split<R>, static_cast<const bf16*>(q),
                           static_cast<const bf16*>(k), static_cast<const bf16*>(v),
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

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError(): the
// Python wrapper raises on anything but cudaSuccess (0). Shapes are checked
// by the wrapper; this re-checks only what would make the launch unsafe.
int lumina_ragged_paged_attention(const void* q, const void* k, const void* v,
                                  const void* table, const void* lengths, void* out,
                                  int B, int Hq, int Hkv, int D, int page_size, int P,
                                  int n_pages, int window, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 || D <= 0 || D % 8 != 0 ||
      page_size <= 0 || P <= 0 || n_pages <= 0) {
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
    switch (split_rows(D)) {
      case 64:
        err = launch_split<64>(q, k, v, table, lengths, out, B, Hq, Hkv, D, page_size, P,
                               n_pages, window, scale, s);
        break;
      case 32:
        err = launch_split<32>(q, k, v, table, lengths, out, B, Hq, Hkv, D, page_size, P,
                               n_pages, window, scale, s);
        break;
      default:
        err = launch_split<16>(q, k, v, table, lengths, out, B, Hq, Hkv, D, page_size, P,
                               n_pages, window, scale, s);
        break;
    }
  }
  return static_cast<int>(err);
}

}  // extern "C"
