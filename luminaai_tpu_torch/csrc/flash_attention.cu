// Flash attention forward and backward for Hopper (sm_90a): B1, B2, B3.
//
// Replaces the TPU kernels of luminaai_tpu/ops/flash_attention.py:
//   B1 `_fwd_kernel`      (pallas_call in `_fwd`)  -> flash_fwd_kernel
//   B2 `_bwd_dq_kernel`   (pallas_call in `_bwd`)  -> flash_bwd_dq_kernel
//   B3 `_bwd_dkv_kernel`  (pallas_call in `_bwd`)  -> flash_bwd_dkv_kernel
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
// Products. Every matrix product is a warp-level mma.sync m16n8k16 (bf16
// in, fp32 accumulate). Each warp owns 16 rows of its output; the
// accumulators stay in registers in the instruction's documented fragment
// layout (thread lane holds rows lane/4 and lane/4 + 8, columns
// 2*(lane%4) + {0, 1} of each 8-column tile), so the softmax statistics of
// a row live in the 4 threads of a quad and P / dS go from the score
// accumulators straight into A fragments without touching shared memory.
// Tiles are staged in shared memory with 16-byte loads; rows are padded by
// 8 bf16 so the fragment loads are free of bank conflicts.
//
// B1 (forward) and B2 (dQ): one block of 8 warps per (batch, kv head, q
// tile, head chunk). The block holds 128 (q head, position) rows: HB =
// min(G, 128) q heads of the GQA group times P = 128 / HB positions (row r
// is head r / P at position q0 + r % P), so each K/V tile staged in shared
// memory serves every head of the block (the TPU grid ran one q head per
// step and fetched each K/V block once per q head). Every row carries its
// own head and position, so any group size tiles: G = 3 gives 3 x 42 rows
// and 2 padding rows; rows past the group or past Sq are staged as zeros
// and never stored. The loop over K/V tiles (64 rows, 32 above head_dim
// 128 to keep the accumulators in registers) inside the block stands in
// for the TPU's sequential kv grid axis; it starts at the window's band
// (the TPU's _kv_block_offset) and stops at the diagonal (the TPU's
// _block_needed), and each element is masked as the TPU's _band_mask does;
// a partial last K/V tile is staged with zeros and masked past Skv.
// B3 (dK, dV): one block of 4 warps per (batch, kv head, 64-row kv tile,
// column half); the block loops over the group's q heads and, from the
// diagonal on, over the band's 32-row q tiles, accumulating dK and dV in
// fp32 registers, so the GQA group is reduced in the kernel (no [B, Hq, S,
// D] fp32 buffer, no atomics; the TPU path wrote per-q-head fp32 dK/dV and
// summed the group afterwards). Above head_dim 128 two blocks split the
// output columns (each recomputes the scores) so the two accumulators fit
// the register file.
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
// B3 8*B*Hq*D*(S^2/2) (~69 GFLOP). These kernels use mma.sync, which on
// Hopper reaches well under half of the wgmma peak, and load tiles
// synchronously (no cp.async/TMA pipeline); wgmma with a TMA-fed ring of
// tiles and warp specialisation is the later redesign that approaches it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;                // B1, B2
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;       // (q head, position) rows per block
constexpr int kWarps3 = 4;               // B3
constexpr int kThreads3 = kWarps3 * 32;
constexpr int kTileKv3 = kWarps3 * 16;   // kv rows per B3 block
constexpr int kTileQ3 = 32;              // q rows per B3 loop step
constexpr int kPad = 8;                  // bf16 padding per shared row
constexpr float kNegInf = -1e30f;        // the TPU kernels' NEG_INF

// K/V rows per B1/B2 tile, and output columns per B3 block.
template <int D>
__host__ __device__ constexpr int tile_kv() { return D <= 128 ? 64 : 32; }
template <int D>
__host__ __device__ constexpr int cols3() { return D <= 128 ? D : D / 2; }

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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
// B1: forward
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                 int Sq, int Skv, int Hq, int Hkv, int causal, int window, float scale) {
  constexpr int LD = D + kPad;
  constexpr int TK = tile_kv<D>();
  extern __shared__ uint4 smem_u4[];
  bf16* q_sm = reinterpret_cast<bf16*>(smem_u4);  // [kRows][LD]
  bf16* k_sm = q_sm + kRows * LD;                  // [TK][LD]
  bf16* v_sm = k_sm + TK * LD;                     // [TK][LD]

  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const Rows rows = block_rows(Hq / Hkv, hk, blockIdx.z);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;  // first block row of the warp
  const int row[2] = {wr + g, wr + g + 8};
  const int qpos[2] = {rows.pos(row[0]), rows.pos(row[1])};
  const bf16* q_w = q_sm + wr * LD;

  stage_group<D>(q_sm, q, b, Sq, Hq, D, 0, rows, tid);

  int kv_begin, kv_end;
  kv_range<TK>(rows.q0, min(rows.q0 + rows.P, Sq) - 1, Skv, causal, window, kv_begin, kv_end);
  const size_t kv_ld = static_cast<size_t>(Hkv) * D;
  const bf16* k_bh = k + (static_cast<size_t>(b) * Skv * Hkv + hk) * D;
  const bf16* v_bh = v + (static_cast<size_t>(b) * Skv * Hkv + hk) * D;

  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += TK) {
    __syncthreads();  // the previous tile is consumed
    stage<D>(k_sm, k_bh + kv0 * kv_ld, kv_ld, TK, Skv - kv0, tid, kThreads);
    stage<D>(v_sm, v_bh + kv0 * kv_ld, kv_ld, TK, Skv - kv0, tid, kThreads);
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x TK kv columns.
    float s[TK / 8][4];
#pragma unroll
    for (int n = 0; n < TK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const AFrag a = a_rows(q_w, LD, kk, lane);
#pragma unroll
      for (int n = 0; n < TK / 8; ++n) {
        uint32_t b0, b1;
        b_rows(k_sm, LD, n, kk, lane, b0, b1);
        mma(s[n], a.r[0], a.r[1], a.r[2], a.r[3], b0, b1);
      }
    }

    softmax_step<TK, D / 8>(s, acc, m_i, l_i, qpos, kv0, t, Skv, causal, window, scale);

    // acc += bf16(P) V.
#pragma unroll
    for (int j = 0; j < TK / 16; ++j) {
      const AFrag a = a_acc(s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        b_cols(v_sm, LD, j, n, lane, b0, b1);
        mma(acc[n], a.r[0], a.r[1], a.r[2], a.r[3], b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!rows.valid(row[r], Sq)) continue;
    const int hq = rows.head(row[r]);
    const float safe = l_i[r] == 0.f ? 1.f : l_i[r];
    if (t == 0) {
      lse[(static_cast<size_t>(b) * Hq + hq) * Sq + qpos[r]] = m_i[r] + logf(safe);
    }
    bf16* out = o + ((static_cast<size_t>(b) * Sq + qpos[r]) * Hq + hq) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * r] / safe, acc[n][2 * r + 1] / safe);
    }
  }
}

// ---------------------------------------------------------------------------
// B2: dQ
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv, int causal,
                    int window, float scale) {
  constexpr int LD = D + kPad;
  constexpr int TK = tile_kv<D>();
  extern __shared__ uint4 smem_u4[];
  bf16* q_sm = reinterpret_cast<bf16*>(smem_u4);  // [kRows][LD]
  bf16* do_sm = q_sm + kRows * LD;                 // [kRows][LD]
  bf16* k_sm = do_sm + kRows * LD;                 // [TK][LD]
  bf16* v_sm = k_sm + TK * LD;                     // [TK][LD]

  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const Rows rows = block_rows(Hq / Hkv, hk, blockIdx.z);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const int row[2] = {wr + g, wr + g + 8};
  const int qpos[2] = {rows.pos(row[0]), rows.pos(row[1])};
  const bf16* q_w = q_sm + wr * LD;
  const bf16* do_w = do_sm + wr * LD;

  stage_group<D>(q_sm, q, b, Sq, Hq, D, 0, rows, tid);
  stage_group<D>(do_sm, dout, b, Sq, Hq, D, 0, rows, tid);
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

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += TK) {
    __syncthreads();
    stage<D>(k_sm, k_bh + kv0 * kv_ld, kv_ld, TK, Skv - kv0, tid, kThreads);
    stage<D>(v_sm, v_bh + kv0 * kv_ld, kv_ld, TK, Skv - kv0, tid, kThreads);
    __syncthreads();

    // S = Q K^T and dP = dO V^T.
    float s[TK / 8][4], dp[TK / 8][4];
#pragma unroll
    for (int n = 0; n < TK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const AFrag aq = a_rows(q_w, LD, kk, lane);
      const AFrag ado = a_rows(do_w, LD, kk, lane);
#pragma unroll
      for (int n = 0; n < TK / 8; ++n) {
        uint32_t b0, b1;
        b_rows(k_sm, LD, n, kk, lane, b0, b1);
        mma(s[n], aq.r[0], aq.r[1], aq.r[2], aq.r[3], b0, b1);
        b_rows(v_sm, LD, n, kk, lane, b0, b1);
        mma(dp[n], ado.r[0], ado.r[1], ado.r[2], ado.r[3], b0, b1);
      }
    }
    // dS = P * (dP - delta) * scale, P recomputed from lse.
    ds_step<TK>(s, dp, lse_r, delta_r, qpos, kv0, t, Skv, causal, window, scale);
    // dQ += bf16(dS) K.
#pragma unroll
    for (int j = 0; j < TK / 16; ++j) {
      const AFrag a = a_acc(s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        b_cols(k_sm, LD, j, n, lane, b0, b1);
        mma(acc[n], a.r[0], a.r[1], a.r[2], a.r[3], b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!rows.valid(row[r], Sq)) continue;
    bf16* out = dq + ((static_cast<size_t>(b) * Sq + qpos[r]) * Hq + rows.head(row[r])) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// B3: dK, dV
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads3)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv, int Hq,
                     int Hkv, int causal, int window, float scale) {
  constexpr int LD = D + kPad;
  constexpr int DN = cols3<D>();  // output columns of this block
  extern __shared__ uint4 smem_u4[];
  bf16* k_sm = reinterpret_cast<bf16*>(smem_u4);  // [kTileKv3][LD]
  bf16* v_sm = k_sm + kTileKv3 * LD;               // [kTileKv3][LD]
  bf16* q_sm = v_sm + kTileKv3 * LD;               // [kTileQ3][LD]
  bf16* do_sm = q_sm + kTileQ3 * LD;               // [kTileQ3][LD]
  float* lse_sm = reinterpret_cast<float*>(do_sm + kTileQ3 * LD);  // [kTileQ3]
  float* delta_sm = lse_sm + kTileQ3;                                // [kTileQ3]

  const int G = Hq / Hkv;
  const int kv0 = blockIdx.x * kTileKv3;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int nt0 = DN == D ? 0 : blockIdx.z * (DN / 8);  // first 8-column output tile
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kpos[2] = {kv0 + warp * 16 + g, kv0 + warp * 16 + g + 8};

  const size_t kv_ld = static_cast<size_t>(Hkv) * D;
  const size_t kv_base = (static_cast<size_t>(b) * Skv + kv0) * kv_ld + static_cast<size_t>(hk) * D;
  stage<D>(k_sm, k + kv_base, kv_ld, kTileKv3, Skv - kv0, tid, kThreads3);
  stage<D>(v_sm, v + kv_base, kv_ld, kTileKv3, Skv - kv0, tid, kThreads3);
  const bf16* k_w = k_sm + warp * 16 * LD;
  const bf16* v_w = v_sm + warp * 16 * LD;

  // q rows that can see this kv tile: from the diagonal on, up to the
  // window's far edge.
  int q_begin = 0, q_end = Sq;
  if (causal) {
    q_begin = (kv0 / kTileQ3) * kTileQ3;
    if (window > 0) q_end = min(Sq, kv0 + kTileKv3 - 1 + window);
  }

  float dk_acc[DN / 8][4], dv_acc[DN / 8][4];
#pragma unroll
  for (int n = 0; n < DN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const size_t q_ld = static_cast<size_t>(Hq) * D;
  for (int gi = 0; gi < G; ++gi) {
    const int hq = hk * G + gi;
    const float* lse_h = lse + (static_cast<size_t>(b) * Hq + hq) * Sq;
    const float* delta_h = delta + (static_cast<size_t>(b) * Hq + hq) * Sq;
    for (int q0 = q_begin; q0 < q_end; q0 += kTileQ3) {
      __syncthreads();  // the previous q tile is consumed (K/V staged first time)
      const size_t q_base = (static_cast<size_t>(b) * Sq + q0) * q_ld + static_cast<size_t>(hq) * D;
      stage<D>(q_sm, q + q_base, q_ld, kTileQ3, Sq - q0, tid, kThreads3);
      stage<D>(do_sm, dout + q_base, q_ld, kTileQ3, Sq - q0, tid, kThreads3);
      if (tid < kTileQ3) {
        const bool ok = q0 + tid < Sq;
        lse_sm[tid] = ok ? lse_h[q0 + tid] : 0.f;
        delta_sm[tid] = ok ? delta_h[q0 + tid] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: the warp's 16 kv rows x 32 q columns.
      float st[kTileQ3 / 8][4], dpt[kTileQ3 / 8][4];
#pragma unroll
      for (int n = 0; n < kTileQ3 / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const AFrag ak = a_rows(k_w, LD, kk, lane);
        const AFrag av = a_rows(v_w, LD, kk, lane);
#pragma unroll
        for (int n = 0; n < kTileQ3 / 8; ++n) {
          uint32_t b0, b1;
          b_rows(q_sm, LD, n, kk, lane, b0, b1);
          mma(st[n], ak.r[0], ak.r[1], ak.r[2], ak.r[3], b0, b1);
          b_rows(do_sm, LD, n, kk, lane, b0, b1);
          mma(dpt[n], av.r[0], av.r[1], av.r[2], av.r[3], b0, b1);
        }
      }
      // P^T (kept in st) and dS^T (in dpt).
      pds_step(st, dpt, lse_sm, delta_sm, kpos, q0, t, Sq, Skv, causal, window, scale);
      // dV += bf16(P^T) dO and dK += bf16(dS^T) Q, this block's columns.
#pragma unroll
      for (int j = 0; j < kTileQ3 / 16; ++j) {
        const AFrag ap = a_acc(st[2 * j], st[2 * j + 1]);
        const AFrag ads = a_acc(dpt[2 * j], dpt[2 * j + 1]);
#pragma unroll
        for (int n = 0; n < DN / 8; ++n) {
          uint32_t b0, b1;
          b_cols(do_sm, LD, j, nt0 + n, lane, b0, b1);
          mma(dv_acc[n], ap.r[0], ap.r[1], ap.r[2], ap.r[3], b0, b1);
          b_cols(q_sm, LD, j, nt0 + n, lane, b0, b1);
          mma(dk_acc[n], ads.r[0], ads.r[1], ads.r[2], ads.r[3], b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kpos[r] >= Skv) continue;
    const size_t off = (static_cast<size_t>(b) * Skv + kpos[r]) * kv_ld +
                       static_cast<size_t>(hk) * D + nt0 * 8 + 2 * t;
#pragma unroll
    for (int n = 0; n < DN / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8) =
          __floats2bfloat162_rn(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8) =
          __floats2bfloat162_rn(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
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

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                       int Sq, int Skv, int Hq, int Hkv, int causal, int window, float scale,
                       cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (kRows + 2 * tile_kv<D>()) * (D + kPad);
  cudaError_t err = allow_smem(flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<D><<<group_grid(B, Sq, Hq, Hkv), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), Sq, Skv, Hq, Hkv, causal, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int B, int Sq, int Skv,
                      int Hq, int Hkv, int causal, int window, float scale,
                      cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (2 * kRows + 2 * tile_kv<D>()) * (D + kPad);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D><<<group_grid(B, Sq, Hq, Hkv), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), Sq, Skv, Hq, Hkv, causal,
      window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int B, int Sq,
                       int Skv, int Hq, int Hkv, int causal, int window, float scale,
                       cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (2 * kTileKv3 + 2 * kTileQ3) * (D + kPad) +
                      sizeof(float) * 2 * kTileQ3;
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Skv + kTileKv3 - 1) / kTileKv3, B * Hkv, D / cols3<D>());
  flash_bwd_dkv_kernel<D><<<grid, kThreads3, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq,
      Skv, Hq, Hkv, causal, window, scale);
  return cudaGetLastError();
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
  return cudaGetLastError();
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
  return cudaGetLastError();
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
  return cudaGetLastError();
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
#define CALL(DD) launch_fwd<DD>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, causal, window, scale, s)
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
#define CALL(DD)                                                                         \
  launch_dq<DD>(q, k, v, dout, lse, delta, dq, B, Sq, Skv, Hq, Hkv, causal, window, scale, \
                s)
  LUMINA_BY_DIM(D, CALL,
                launch_dq_wide(q, k, v, dout, lse, delta, dq, B, Sq, Skv, Hq, Hkv, D, causal,
                               window, scale, s))
#undef CALL
}

int lumina_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, int B, int Sq,
                         int Skv, int Hq, int Hkv, int D, int causal, int window, float scale,
                         void* stream) {
  if (!shape_ok(B, Sq, Skv, Hq, Hkv, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(DD)                                                                       \
  launch_dkv<DD>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Skv, Hq, Hkv, causal, window, \
                 scale, s)
  LUMINA_BY_DIM(D, CALL,
                launch_dkv_wide(q, k, v, dout, lse, delta, dk, dv, B, Sq, Skv, Hq, Hkv, D,
                                causal, window, scale, s))
#undef CALL
}

}  // extern "C"
