// Grouped matrix multiplication for Hopper (sm_90a): B4a (gmm) and B4b (tgmm).
//
// Replaces the megablox TPU kernels the JAX package reaches through
// luminaai_tpu/models/moe.py `_pick_gmm` (jax/experimental/pallas/ops/tpu/
// megablox/gmm.py: `gmm` :314, `tgmm` :573; the VJP of ops.py `_gmm_bwd`
// calls gmm with transpose_rhs for grad_lhs and tgmm for grad_rhs):
//   B4a gmm_kernel:  out[rows of g] = lhs[rows of g] @ rhs[g]   (rhs [E, K, N])
//                    or  lhs[rows of g] @ rhs[g]^T               (rhs [E, N, K],
//                    transpose_rhs: the grad_lhs product dout @ w^T, read in
//                    place through the addressing, never materialised);
//                    rows at or past sum(group_sizes) are written as zeros.
//   B4b tgmm_kernel: out[g] = lhs[rows of g]^T @ dout[rows of g]  ([E, K, N]);
//                    an empty group is written as zeros.
// Rows are grouped in order: group g owns the next group_sizes[g] rows.
// Layouts (contiguous, bf16 unless stated): lhs [M, K], dout [M, N], out
// [M, N] or [E, K, N]; group_sizes [E] int32 on the device.
//
// Design. group_sizes is read on the device only (the JAX path never syncs,
// and a host read per layer would stall decode): the grid is sized for the
// worst case and each block finds its work from a prefix sum over the E
// group sizes, which its first thread computes (E is small: 8 here).
// B4a tiles each group separately (megablox instead masks rows of tiles
// that straddle a group boundary): block x enumerates the row tiles of all
// groups in order, TM = 128 rows from the group's first row, then the zero
// tiles of the tail; a row tile never mixes two groups' weights. Grid x =
// ceil(M / TM) + E + 1 covers any group sizes; blocks past the work exit.
// Each block owns a 128 x 128 output tile and loops over K in 32-column
// steps: an A tile of lhs rows and a B tile of the group's weights staged in
// shared memory with 16-byte loads (zeros past the group's rows and past K),
// then 8 warps of mma.sync m16n8k16 (bf16 in, fp32 accumulate), each warp a
// 32 x 64 sub-tile in registers, rounded to bf16 once on the way out.
// B4b runs one block per (128 x 128 tile of [K, N], group); the block walks
// the group's rows in 32-row steps, staging lhs and dout rows, and
// accumulates lhs^T dout in registers: the reduction over a group's rows is
// the loop, so no atomics and no second pass.
//
// Bound. Serving decode at b1 (8 lanes x top-2 = 16 pair rows over 8
// experts) reads each touched expert's weights once: wi [8, 2048, 11008]
// is 360.6 MB (0.108 ms at 3.35 TB/s), wo 180.3 MB; bytes bind it, and
// this kernel reads each weight tile exactly once per touched group. The
// training products (65,536 pair rows at the flagship widths, e.g. 756
// GFLOP for wi) are bound by operations (0.76 ms at 989 TFLOP/s); mma.sync
// with synchronous tile loads reaches well under half of that peak, and
// wgmma with a TMA-fed ring of tiles is the later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps: 4 (rows) x 2 (columns) of 32 x 64
constexpr int kTM = 128;       // output rows per block
constexpr int kTN = 128;       // output columns per block
constexpr int kTK = 32;        // reduction step
constexpr int kPad = 8;        // bf16 padding per shared row

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
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment A[i][j] = M[16*mt + i][16*kk + j] (M row-major, stride ld).
__device__ __forceinline__ void a_rows(const bf16* m, int ld, int mt, int kk, int lane,
                                       uint32_t (&a)[4]) {
  const int g = lane >> 2, c = kk * 16 + 2 * (lane & 3);
  const bf16* p = m + (mt * 16 + g) * ld + c;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// A fragment A[i][j] = M[16*kk + j][16*mt + i]: M holds A transposed (tgmm's
// lhs rows, whose columns are the output rows).
__device__ __forceinline__ void a_cols(const bf16* m, int ld, int mt, int kk, int lane,
                                       uint32_t (&a)[4]) {
  const int g = lane >> 2, c = 2 * (lane & 3);
  const bf16* p = m + (kk * 16 + c) * ld + mt * 16 + g;
  a[0] = pack_bf16(p[0], p[ld]);
  a[1] = pack_bf16(p[8], p[ld + 8]);
  a[2] = pack_bf16(p[8 * ld], p[9 * ld]);
  a[3] = pack_bf16(p[8 * ld + 8], p[9 * ld + 8]);
}

// B fragment B[k][n] = M[16*kk + k][8*nt + n] (M row-major [k][n]).
__device__ __forceinline__ void b_cols(const bf16* m, int ld, int kk, int nt, int lane,
                                       uint32_t& b0, uint32_t& b1) {
  const bf16* p = m + (kk * 16 + 2 * (lane & 3)) * ld + nt * 8 + (lane >> 2);
  b0 = pack_bf16(p[0], p[ld]);
  b1 = pack_bf16(p[8 * ld], p[9 * ld]);
}

// B fragment B[k][n] = M[8*nt + n][16*kk + k] (M row-major [n][k]).
__device__ __forceinline__ void b_rows(const bf16* m, int ld, int nt, int kk, int lane,
                                       uint32_t& b0, uint32_t& b1) {
  const bf16* p = m + (nt * 8 + (lane >> 2)) * ld + kk * 16 + 2 * (lane & 3);
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// Copy a [rows x cols] tile (cols a multiple of 8) of a row-major source
// (row stride src_ld) into shared memory (row stride cols + kPad), 16 bytes
// per thread per step; rows at or past vrows and columns at or past vcols
// (a multiple of 8) are written as zeros and never read.
template <int kRowsT, int kColsT>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, size_t src_ld, int vrows,
                                      int vcols, int tid) {
  constexpr int kChunks = kColsT / 8;
  for (int c = tid; c < kRowsT * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c - r * kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < vrows && col < vcols) val = *reinterpret_cast<const uint4*>(src + r * src_ld + col);
    *reinterpret_cast<uint4*>(dst + r * (kColsT + kPad) + col) = val;
  }
}

// The work of B4a block x: rows [row0, row0 + nrows) of group `group`, or a
// zero tile of the tail (group -1), or nothing (group -2).
struct Work {
  int group, row0, nrows;
};

__device__ __forceinline__ Work find_work(const int* __restrict__ group_sizes, int E, int M) {
  __shared__ Work work;
  if (threadIdx.x == 0) {
    const int t = blockIdx.x;
    Work w{-2, 0, 0};
    int start = 0, tiles = 0;
    for (int g = 0; g < E; ++g) {
      const int end = min(M, start + max(0, group_sizes[g]));
      const int n = (end - start + kTM - 1) / kTM;
      if (w.group == -2 && t < tiles + n) {
        w.group = g;
        w.row0 = start + (t - tiles) * kTM;
        w.nrows = min(kTM, end - w.row0);
      }
      tiles += n;
      start = end;
    }
    if (w.group == -2) {  // the zero tiles of rows [start, M)
      const int row0 = start + (t - tiles) * kTM;
      if (row0 < M) w = Work{-1, row0, min(kTM, M - row0)};
    }
    work = w;
  }
  __syncthreads();
  return work;
}

// Store the fp32 accumulators of a warp's 32 x 64 sub-tile as bf16: rows
// below nrows of `out` (row stride ld), columns below ncols (relative to
// the tile; ncols is even, so a column pair is whole or out).
__device__ __forceinline__ void store_tile(bf16* out, size_t ld, int nrows, int ncols,
                                           const float (&acc)[2][8][4], int wm, int wn,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 32 + i * 16 + g + 8 * h;
      if (r >= nrows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = wn * 64 + j * 8 + 2 * t;
        if (col < ncols) {
          *reinterpret_cast<__nv_bfloat162*>(out + r * ld + col) =
              __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
    }
}

// ---------------------------------------------------------------------------
// B4a: gmm (and its transpose_rhs form)
// ---------------------------------------------------------------------------
template <bool kTrans>
__global__ void __launch_bounds__(kThreads)
gmm_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ rhs,
           const int* __restrict__ group_sizes, bf16* __restrict__ out, int M, int K, int N,
           int E) {
  constexpr int LDA = kTK + kPad;
  constexpr int LDB = kTrans ? kTK + kPad : kTN + kPad;
  __shared__ __align__(16) bf16 a_sm[kTM * LDA];
  __shared__ __align__(16) bf16 b_sm[kTrans ? kTN * LDB : kTK * LDB];

  const Work w = find_work(group_sizes, E, M);
  if (w.group == -2) return;
  const int n0 = blockIdx.y * kTN;
  const int ncols = min(kTN, N - n0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  bf16* out_tile = out + static_cast<size_t>(w.row0) * N + n0;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if (w.group >= 0) {
    const bf16* a_src = lhs + static_cast<size_t>(w.row0) * K;
    const bf16* wg = rhs + static_cast<size_t>(w.group) * K * N;
    for (int k0 = 0; k0 < K; k0 += kTK) {
      __syncthreads();  // the previous step's tiles are consumed
      stage<kTM, kTK>(a_sm, a_src + k0, K, w.nrows, K - k0, tid);
      if (kTrans) {  // rhs[g] is [N, K]: stage rows n0.. , columns k0..
        stage<kTN, kTK>(b_sm, wg + static_cast<size_t>(n0) * K + k0, K, ncols, K - k0, tid);
      } else {       // rhs[g] is [K, N]: stage rows k0.., columns n0..
        stage<kTK, kTN>(b_sm, wg + static_cast<size_t>(k0) * N + n0, N, K - k0, ncols, tid);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk) {
        uint32_t a[2][4];
        a_rows(a_sm, LDA, wm * 2, kk, lane, a[0]);
        a_rows(a_sm, LDA, wm * 2 + 1, kk, lane, a[1]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t b0, b1;
          if (kTrans) {
            b_rows(b_sm, LDB, wn * 8 + j, kk, lane, b0, b1);
          } else {
            b_cols(b_sm, LDB, kk, wn * 8 + j, lane, b0, b1);
          }
          mma(acc[0][j], a[0], b0, b1);
          mma(acc[1][j], a[1], b0, b1);
        }
      }
    }
  }
  // Tail tiles store the zero accumulators.
  store_tile(out_tile, N, w.nrows, ncols, acc, wm, wn, lane);
}

// ---------------------------------------------------------------------------
// B4b: tgmm
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
tgmm_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ dout,
            const int* __restrict__ group_sizes, bf16* __restrict__ out, int M, int K, int N) {
  constexpr int kRM = 32;  // group rows per step (the reduction)
  constexpr int LD = kTM + kPad;
  __shared__ __align__(16) bf16 l_sm[kRM * LD];  // [rows][K columns of the tile]
  __shared__ __align__(16) bf16 d_sm[kRM * LD];  // [rows][N columns of the tile]
  __shared__ int range[2];

  const int g = blockIdx.z;
  if (threadIdx.x == 0) {
    int start = 0;
    for (int e = 0; e < g; ++e) start = min(M, start + max(0, group_sizes[e]));
    range[0] = start;
    range[1] = min(M, start + max(0, group_sizes[g]));
  }
  __syncthreads();
  const int start = range[0], end = range[1];
  const int n0 = blockIdx.x * kTN, k0 = blockIdx.y * kTM;
  const int ncols = min(kTN, N - n0), krows = min(kTM, K - k0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int m0 = start; m0 < end; m0 += kRM) {
    __syncthreads();
    stage<kRM, kTM>(l_sm, lhs + static_cast<size_t>(m0) * K + k0, K, end - m0, krows, tid);
    stage<kRM, kTN>(d_sm, dout + static_cast<size_t>(m0) * N + n0, N, end - m0, ncols, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kRM / 16; ++kk) {
      uint32_t a[2][4];
      a_cols(l_sm, LD, wm * 2, kk, lane, a[0]);
      a_cols(l_sm, LD, wm * 2 + 1, kk, lane, a[1]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b0, b1;
        b_cols(d_sm, LD, kk, wn * 8 + j, lane, b0, b1);
        mma(acc[0][j], a[0], b0, b1);
        mma(acc[1][j], a[1], b0, b1);
      }
    }
  }
  // An empty group stores the zero accumulators.
  store_tile(out + (static_cast<size_t>(g) * K + k0) * N + n0, N, krows, ncols, acc, wm, wn,
             lane);
}

bool dims_ok(int M, int K, int N, int E) {
  return M > 0 && E > 0 && K > 0 && N > 0 && K % 8 == 0 && N % 8 == 0;
}

}  // namespace

extern "C" {

// Each entry launches one kernel on `stream` and returns cudaGetLastError()
// (the Python wrapper raises on anything but cudaSuccess, 0). Shapes are
// checked by the wrapper; these re-check only what would make the launch
// unsafe.

int lumina_gmm(const void* lhs, const void* rhs, const void* group_sizes, void* out, int M,
               int K, int N, int E, int transpose_rhs, void* stream) {
  if (!dims_ok(M, K, N, E)) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((M + kTM - 1) / kTM + E + 1, (N + kTN - 1) / kTN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* l = static_cast<const bf16*>(lhs);
  const bf16* r = static_cast<const bf16*>(rhs);
  const int* gs = static_cast<const int*>(group_sizes);
  bf16* o = static_cast<bf16*>(out);
  if (transpose_rhs) {
    gmm_kernel<true><<<grid, kThreads, 0, s>>>(l, r, gs, o, M, K, N, E);
  } else {
    gmm_kernel<false><<<grid, kThreads, 0, s>>>(l, r, gs, o, M, K, N, E);
  }
  return static_cast<int>(cudaGetLastError());
}

int lumina_tgmm(const void* lhs, const void* dout, const void* group_sizes, void* out, int M,
                int K, int N, int E, int /*unused*/, void* stream) {
  if (!dims_ok(M, K, N, E)) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + kTN - 1) / kTN, (K + kTM - 1) / kTM, E);
  tgmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(lhs), static_cast<const bf16*>(dout),
      static_cast<const int*>(group_sizes), static_cast<bf16*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
