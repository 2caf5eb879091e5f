// Grouped matrix multiplication for Hopper (sm_90a): B4a (gmm) and B4b (tgmm).
//
// Replaces the megablox TPU kernels the JAX package reaches through
// luminaai_tpu/models/moe.py `_pick_gmm` (jax/experimental/pallas/ops/tpu/
// megablox/gmm.py: `gmm` :314, `tgmm` :573; the VJP of ops.py `_gmm_bwd`
// calls gmm with transpose_rhs for grad_lhs and tgmm for grad_rhs):
//   B4a gmm:  out[rows of g] = lhs[rows of g] @ rhs[g]   (rhs [E, K, N])
//             or  lhs[rows of g] @ rhs[g]^T               (rhs [E, N, K],
//             transpose_rhs: the grad_lhs product dout @ w^T, read in place
//             through the addressing, never materialised); rows at or past
//             sum(group_sizes) are written as zeros.
//   B4b tgmm: out[g] = lhs[rows of g]^T @ dout[rows of g]  ([E, K, N]); an
//             empty group is written as zeros.
// Rows are grouped in order: group g owns the next group_sizes[g] rows.
// Layouts (contiguous, bf16 unless stated): lhs [M, K], dout [M, N], out
// [M, N] or [E, K, N]; group_sizes [E] int32 on the device.
//
// Bound. The training products (65,536 pair rows at the flagship widths:
// 2 x 65,100 x 1024 x 5632 = 751 GFLOP for wi) are bound by operations,
// 0.76 ms at 989 TFLOP/s bf16; only wgmma reaches that rate. Serving decode
// (16 pair rows over the experts of one 128-row buffer) is bound by bytes:
// each touched expert's weights read once (b1 wi: 7 x 2048 x 11008 bf16 =
// 316 MB, 0.094 ms at 3.35 TB/s), which takes some 3 MB of loads in flight
// across the card.
//
// Design (hopper.cuh holds the barrier, TMA, wgmma and tensor-map
// helpers). One kernel template serves the three products. Persistent blocks, one or two per SM,
// walk the output tiles; in each, a producer warpgroup (one thread) keeps a
// ring of shared-memory stages filled by TMA (cp.async.bulk.tensor, 128-byte
// swizzle, full/empty mbarrier pairs), running ahead across tile boundaries,
// and one or two consumer warpgroups run wgmma m64nNk16 (bf16 in, fp32
// accumulate in registers) on each stage as it lands, keeping one stage's
// products in flight while the next arrives, then store their rows. A stage
// holds a 64-deep slice of the reduction:
//   gmm         A = lhs rows (K-major), B = rhs[g] as [K, N] (N-major, wgmma
//               trans-b) or, under transpose_rhs, as [N, K] (K-major);
//   tgmm        A = lhs^T, staged from lhs rows (M-major, trans-a), B = dout
//               rows (N-major, trans-b); the reduction runs over the group's
//               rows.
// Tiles: 128 x 256 for the training products (two consumer warpgroups of 64
// rows, setmaxnreg moves registers from the producer to them; 3 stages of
// 48 KB and 64 KB of staging through which whole 64-row slices leave by TMA
// store, overlapped with the next tile's products); 64 x 128 with 4 stages,
// stores from registers and two blocks per SM where 128 x 256 tiles could
// not fill the card (decode, short prefills), so that every SM streams
// weights.
// group_sizes is read on the device only (no host sync): each block derives
// its tiles from a prefix sum over the E sizes.
// Group boundaries. gmm tiles each group from its first row (a TMA box may
// start at any row); the A rows of a tile past the group's end belong to the
// next group and reach only output rows the epilogue never stores (a 64-row
// slice that crosses the group's end takes stores from registers predicated
// on the group's rows, never a TMA store); tail tiles store zeros. tgmm's row
// steps also start at the group's first row; in the last step the rows past
// the group's end are zeroed in shared memory (both operands) after the load
// lands, then fence.proxy.async makes the zeros visible to wgmma. K and N
// need only be multiples of 8: boxes past the tensor's edge are zero-filled
// by TMA, boxes wholly past it are not loaded (their products reach only
// columns or rows that are not stored).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

enum Mode { kNN = 0, kNT = 1, kTN = 2 };  // gmm, gmm transpose_rhs, tgmm

constexpr int kBK = 64;  // reduction depth of a stage: one swizzled row

template <int BM, int BN, int kMode>
struct Tiling {
  static constexpr int kConsumers = BM / 64;  // consumer warpgroups
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kMinBlocks = kConsumers > 1 ? 1 : 2;  // per SM
  // The 128 x 256 tiles store whole 64-row slices through shared memory
  // with TMA, overlapped with the next tile's products (the training
  // products write up to 0.74 GB a call); that staging takes the room of a
  // fourth stage.
  static constexpr bool kTmaStore = kConsumers > 1;
  static constexpr int kStages = kTmaStore ? 3 : 4;
  static constexpr int kABytes = BM * kBK * 2;
  static constexpr int kBBytes = BN * kBK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStagingBytes = kTmaStore ? kConsumers * 64 * BN * 2 : 0;
  static constexpr int kSmemBytes =
      1024 + kStages * kStageBytes + kStagingBytes + 2 * kStages * 8;
  // Operand majors: trans flags, bytes per 16-deep k step, leading offsets.
  static constexpr int kTransA = kMode == kTN;
  static constexpr int kTransB = kMode != kNT;
  static constexpr uint32_t kStepA = kTransA ? 16 * kSwizzleRowBytes : 32;
  static constexpr uint32_t kStepB = kTransB ? 16 * kSwizzleRowBytes : 32;
  static constexpr uint32_t kLboA = kTransA ? kBoxBytes : 16;
  static constexpr uint32_t kLboB = kTransB ? kBoxBytes : 16;
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// Rows [start, end) of group g: sizes clipped at 0 and at M, in order.
__device__ __forceinline__ void group_rows(const int* __restrict__ gs, int g, int M, int& start,
                                           int& end) {
  start = 0;
  for (int e = 0; e < g; ++e) start = min(M, start + max(0, __ldg(gs + e)));
  end = min(M, start + max(0, __ldg(gs + g)));
}

// B4a row tiles: each group's rows in tiles of BM from its first row, then
// the zero tiles of the tail [sum(group_sizes), M).
struct RowTile {
  int group, row0, nrows;  // group -1: a zero tile of the tail
};

template <int BM>
__device__ int gmm_row_tiles(const int* __restrict__ gs, int E, int M) {
  int start = 0, tiles = 0;
  for (int g = 0; g < E; ++g) {
    const int end = min(M, start + max(0, __ldg(gs + g)));
    tiles += cdiv(end - start, BM);
    start = end;
  }
  return tiles + cdiv(M - start, BM);
}

template <int BM>
__device__ RowTile gmm_row_tile(const int* __restrict__ gs, int E, int M, int t) {
  int start = 0;
  for (int g = 0; g < E; ++g) {
    const int end = min(M, start + max(0, __ldg(gs + g)));
    const int n = cdiv(end - start, BM);
    if (t < n) {
      const int row0 = start + t * BM;
      return RowTile{g, row0, min(BM, end - row0)};
    }
    t -= n;
    start = end;
  }
  const int row0 = start + t * BM;
  return RowTile{-1, row0, min(BM, M - row0)};
}

// One output tile: rows [row0, row0 + nrows) of `out`, the product's
// reduction steps, and (tgmm) the group's rows.
struct Tile {
  int group, row0, nrows, n0, steps, start, end;
};

template <int BM, int BN, int kMode>
__device__ __forceinline__ Tile tile_of(const int* __restrict__ gs, int t, int M, int K, int N,
                                        int E) {
  const int col_tiles = cdiv(N, BN);
  Tile w;
  w.n0 = (t % col_tiles) * BN;
  if constexpr (kMode == kTN) {
    const int k_tiles = cdiv(K, BM), rest = t / col_tiles;
    w.group = rest / k_tiles;
    w.row0 = (rest % k_tiles) * BM;  // rows of out[g]: the K dimension
    w.nrows = min(BM, K - w.row0);
    group_rows(gs, w.group, M, w.start, w.end);
    w.steps = cdiv(w.end - w.start, kBK);
  } else {
    const RowTile r = gmm_row_tile<BM>(gs, E, M, t / col_tiles);
    w.group = r.group;
    w.row0 = r.row0;
    w.nrows = r.nrows;
    w.start = w.end = 0;
    w.steps = r.group >= 0 ? cdiv(K, kBK) : 0;
  }
  return w;
}

// Zero rows [valid, 64) of `boxes` consecutive 64 x 64 boxes at p.
__device__ __forceinline__ void zero_rows(uint8_t* p, int boxes, int valid, int tid,
                                          int nthreads) {
  const int per_box = (kBK - valid) * (kSwizzleRowBytes / 16);
  for (int i = tid; i < boxes * per_box; i += nthreads) {
    const int box = i / per_box, c = i - box * per_box;
    *reinterpret_cast<uint4*>(p + box * kBoxBytes + valid * kSwizzleRowBytes + c * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// Store a warpgroup's 64 x BN accumulators as bf16: rows below `rows` of
// dst (row stride ld), columns below `cols` (a multiple of 8).
template <int BN>
__device__ __forceinline__ void store_tile(bf16* dst, size_t ld, int rows, int cols,
                                           const float (&acc)[BN / 2], int tid) {
  const int r = (tid >> 5) * 16 + ((tid & 31) >> 2), c = 2 * (tid & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= rows) continue;
    bf16* row = dst + static_cast<size_t>(r + 8 * h) * ld + c;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (j * 8 < cols) {
        *reinterpret_cast<__nv_bfloat162*>(row + j * 8) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// Write a warpgroup's 64 x BN accumulators as bf16 into BN / 64 boxes of 64
// rows x 64 columns at dst, 128-byte swizzled as the output's tensor map
// expects (16-byte chunk c of row r at chunk c ^ (r % 8)).
template <int BN>
__device__ __forceinline__ void stage_tile(uint8_t* dst, const float (&acc)[BN / 2], int tid) {
  const int r = (tid >> 5) * 16 + ((tid & 31) >> 2), q = tid & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      uint8_t* p = dst + (j / 8) * kBoxBytes + row * kSwizzleRowBytes +
                   (((j % 8) ^ (row & 7)) * 16) + q * 4;
      *reinterpret_cast<__nv_bfloat162*>(p) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// The producer: one thread fills the ring, tile after tile.
template <int BM, int BN, int kMode>
__device__ __forceinline__ void produce(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                        const int* __restrict__ gs, uint8_t* smem,
                                        uint64_t* full, uint64_t* empty, int tiles, int M,
                                        int K, int N, int E) {
  using T = Tiling<BM, BN, kMode>;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile w = tile_of<BM, BN, kMode>(gs, t, M, K, N, E);
    // 64-wide boxes wholly past the tensor's edge are not loaded.
    const int b_boxes = min(BN / 64, cdiv(N - w.n0, 64));
    const int a_boxes = kMode == kTN ? min(BM / 64, cdiv(K - w.row0, 64)) : 0;
    const uint32_t bytes = kMode == kNT   ? T::kStageBytes
                           : kMode == kNN ? T::kABytes + b_boxes * kBoxBytes
                                          : (a_boxes + b_boxes) * kBoxBytes;
    for (int s = 0; s < w.steps; ++s) {
      mbar_wait(&empty[stage], phase ^ 1);
      uint8_t* a = smem + stage * T::kStageBytes;
      uint8_t* b = a + T::kABytes;
      uint64_t* bar = &full[stage];
      mbar_arrive_expect_tx(bar, bytes);
      if constexpr (kMode == kTN) {
        const int r0 = w.start + s * kBK;
        for (int i = 0; i < a_boxes; ++i)
          tma_load_2d(a + i * kBoxBytes, map_a, bar, w.row0 + 64 * i, r0);
        for (int j = 0; j < b_boxes; ++j)
          tma_load_2d(b + j * kBoxBytes, map_b, bar, w.n0 + 64 * j, r0);
      } else {
        const int k0 = s * kBK;
        tma_load_2d(a, map_a, bar, k0, w.row0);
        if constexpr (kMode == kNN) {
          for (int j = 0; j < b_boxes; ++j)
            tma_load_3d(b + j * kBoxBytes, map_b, bar, w.n0 + 64 * j, k0, w.group);
        } else {
          tma_load_3d(b, map_b, bar, k0, w.n0, w.group);
        }
      }
      if (++stage == T::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// A consumer warpgroup: rows [64 wg, 64 wg + 64) of every tile.
template <int BM, int BN, int kMode>
__device__ __forceinline__ void consume(const CUtensorMap* map_out, const int* __restrict__ gs,
                                        bf16* __restrict__ out, uint8_t* smem, uint64_t* full,
                                        uint64_t* empty, int tiles, int M, int K, int N,
                                        int E) {
  using T = Tiling<BM, BN, kMode>;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  uint8_t* staging = smem + T::kStages * T::kStageBytes + wg * 64 * BN * 2;
  float acc[BN / 2];
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile w = tile_of<BM, BN, kMode>(gs, t, M, K, N, E);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    fence_regs(acc);
    int prev = -1;
    for (int s = 0; s < w.steps; ++s) {
      mbar_wait(&full[stage], phase);
      uint8_t* a = smem + stage * T::kStageBytes;
      if constexpr (kMode == kTN) {
        // The last step of a group: rows past its end contribute zero.
        const int valid = w.end - (w.start + s * kBK);
        if (valid < kBK) {
          zero_rows(a, (BM + BN) / 64, valid, threadIdx.x, T::kConsumers * 128);
          fence_proxy_async();
          named_barrier(1, T::kConsumers * 128);
        }
      }
      const uint64_t da = smem_desc(a + wg * kBoxBytes, T::kLboA, 8 * kSwizzleRowBytes);
      const uint64_t db = smem_desc(a + T::kABytes, T::kLboB, 8 * kSwizzleRowBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wgmma<BN, T::kTransA, T::kTransB>(acc, desc_advance(da, kk * T::kStepA),
                                          desc_advance(db, kk * T::kStepB));
      }
      wgmma_commit();
      // The previous stage's products are done: hand its buffers back.
      wgmma_wait<1>();
      if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == T::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);
    fence_regs(acc);
    // Zero tiles (the gmm tail, an empty tgmm group) store the zeros.
    const int row0 = w.row0 + wg * 64, my_rows = w.nrows - wg * 64;
    // Through shared memory and TMA (clipping at the tensor's edges): tgmm's
    // rows of out[g], a gmm tail tile, or 64 rows that all belong to this
    // group. A gmm tile's rows past its group (the next group's) take the
    // predicated stores below instead.
    const bool whole = (kMode == kTN || w.group < 0) ? my_rows > 0 : my_rows >= 64;
    if (T::kTmaStore && whole) {
      if (tid == 0) tma_store_wait_read();  // the previous tile's store
      named_barrier(2 + wg, 128);
      stage_tile<BN>(staging, acc, tid);
      fence_proxy_async();
      named_barrier(2 + wg, 128);
      if (tid == 0) {
        for (int j = 0; j < BN / 64 && w.n0 + 64 * j < N; ++j) {
          if constexpr (kMode == kTN) {
            tma_store_3d(map_out, staging + j * kBoxBytes, w.n0 + 64 * j, row0, w.group);
          } else {
            tma_store_2d(map_out, staging + j * kBoxBytes, w.n0 + 64 * j, row0);
          }
        }
        tma_store_commit();
      }
    } else {
      const size_t first = kMode == kTN ? (static_cast<size_t>(w.group) * K + row0) * N
                                        : static_cast<size_t>(row0) * N;
      store_tile<BN>(out + first + w.n0, N, w.nrows - wg * 64, min(BN, N - w.n0), acc, tid);
    }
  }
  if (T::kTmaStore && tid == 0) tma_store_wait();
}

template <int BM, int BN, int kMode>
__global__ void __launch_bounds__(Tiling<BM, BN, kMode>::kThreads,
                                  Tiling<BM, BN, kMode>::kMinBlocks)
grouped_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_b,
               const __grid_constant__ CUtensorMap map_out, const int* __restrict__ gs,
               bf16* __restrict__ out, int M, int K, int N, int E) {
  using T = Tiling<BM, BN, kMode>;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled boxes want 1024-byte aligned buffers.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + T::kStages * T::kStageBytes + T::kStagingBytes);
  uint64_t* empty = full + T::kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], T::kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int col_tiles = cdiv(N, BN);
  const int tiles = kMode == kTN ? E * cdiv(K, BM) * col_tiles
                                 : gmm_row_tiles<BM>(gs, E, M) * col_tiles;
  if (threadIdx.x / 128 == T::kConsumers) {
    if constexpr (T::kConsumers > 1) regs_dealloc<40>();
    if (threadIdx.x % 128 == 0) {
      produce<BM, BN, kMode>(&map_a, &map_b, gs, smem, full, empty, tiles, M, K, N, E);
    }
  } else {
    if constexpr (T::kConsumers > 1) regs_alloc<232>();
    consume<BM, BN, kMode>(&map_out, gs, out, smem, full, empty, tiles, M, K, N, E);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
// map_out: the output ([M, N], or [E, K, N] for tgmm) in 64 x 64 boxes,
// read only where Tiling::kTmaStore.
template <int BM, int BN, int kMode>
cudaError_t launch(const CUtensorMap& a, const CUtensorMap& b, const CUtensorMap& map_out,
                   const void* gs, void* out, int M, int K, int N, int E, int sms,
                   cudaStream_t stream) {
  using T = Tiling<BM, BN, kMode>;
  const cudaError_t err = cudaFuncSetAttribute(
      grouped_kernel<BM, BN, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return err;
  // Persistent blocks: at most one per tile (the row tiles of gmm are at
  // most ceil(M / BM) + E + 1 whatever the group sizes).
  const long long col_tiles = cdiv(N, BN);
  const long long most = kMode == kTN ? static_cast<long long>(E) * cdiv(K, BM) * col_tiles
                                      : (static_cast<long long>(cdiv(M, BM)) + E + 1) * col_tiles;
  const int grid = static_cast<int>(std::min<long long>(most, 1LL * sms * T::kMinBlocks));
  grouped_kernel<BM, BN, kMode><<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      a, b, map_out, static_cast<const int*>(gs), static_cast<bf16*>(out), M, K, N, E);
  return cudaGetLastError();
}

bool dims_ok(int M, int K, int N, int E) {
  return M > 0 && E > 0 && K > 0 && N > 0 && K % 8 == 0 && N % 8 == 0;
}

}  // namespace

extern "C" {

// Each entry launches one kernel on `stream` and returns cudaGetLastError()
// (the Python wrapper raises on anything but cudaSuccess, 0); a tensor map
// that cuTensorMapEncodeTiled refuses returns cudaErrorInvalidValue. Shapes
// are checked by the wrapper; these re-check only what would make the launch
// unsafe.

int lumina_gmm(const void* lhs, const void* rhs, const void* group_sizes, void* out, int M,
               int K, int N, int E, int transpose_rhs, void* stream) {
  if (!dims_ok(M, K, N, E)) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  // 128 x 256 tiles where they fill the card twice over; else 64 x 128.
  const bool big = 1LL * cdiv(M, 128) * cdiv(N, 256) >= 2LL * sms;
  const uint32_t bm = big ? 128 : 64, bn = big ? 256 : 128;
  CUtensorMap a, b, o;
  const uint64_t a_dims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t a_strides[1] = {static_cast<uint64_t>(K)};
  const uint32_t a_box[2] = {64, bm};
  const uint64_t o_dims[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(M)};
  const uint64_t o_strides[1] = {static_cast<uint64_t>(N)};
  const uint32_t o_box[2] = {64, 64};
  const uint64_t kn = static_cast<uint64_t>(K) * N;
  bool ok = tensor_map(&a, lhs, 2, a_dims, a_strides, a_box) &&
            tensor_map(&o, out, 2, o_dims, o_strides, o_box);
  if (transpose_rhs) {  // rhs[g] is [N, K]: boxes of BN rows x 64 K
    const uint64_t dims[3] = {static_cast<uint64_t>(K), static_cast<uint64_t>(N),
                              static_cast<uint64_t>(E)};
    const uint64_t strides[2] = {static_cast<uint64_t>(K), kn};
    const uint32_t box[3] = {64, bn, 1};
    ok = ok && tensor_map(&b, rhs, 3, dims, strides, box);
  } else {  // rhs[g] is [K, N]: boxes of 64 K x 64 N
    const uint64_t dims[3] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K),
                              static_cast<uint64_t>(E)};
    const uint64_t strides[2] = {static_cast<uint64_t>(N), kn};
    const uint32_t box[3] = {64, 64, 1};
    ok = ok && tensor_map(&b, rhs, 3, dims, strides, box);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (transpose_rhs) {
    err = big ? launch<128, 256, kNT>(a, b, o, group_sizes, out, M, K, N, E, sms, s)
              : launch<64, 128, kNT>(a, b, o, group_sizes, out, M, K, N, E, sms, s);
  } else {
    err = big ? launch<128, 256, kNN>(a, b, o, group_sizes, out, M, K, N, E, sms, s)
              : launch<64, 128, kNN>(a, b, o, group_sizes, out, M, K, N, E, sms, s);
  }
  return static_cast<int>(err);
}

int lumina_tgmm(const void* lhs, const void* dout, const void* group_sizes, void* out, int M,
                int K, int N, int E, int /*unused*/, void* stream) {
  if (!dims_ok(M, K, N, E)) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  // Boxes of 64 rows x 64 columns of lhs (K), of dout (N) and of out[g].
  CUtensorMap a, b, o;
  const uint64_t a_dims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t a_strides[1] = {static_cast<uint64_t>(K)};
  const uint64_t b_dims[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(M)};
  const uint64_t b_strides[1] = {static_cast<uint64_t>(N)};
  const uint64_t o_dims[3] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K),
                              static_cast<uint64_t>(E)};
  const uint64_t o_strides[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K) * N};
  const uint32_t box[3] = {64, 64, 1};
  if (!tensor_map(&a, lhs, 2, a_dims, a_strides, box) ||
      !tensor_map(&b, dout, 2, b_dims, b_strides, box) ||
      !tensor_map(&o, out, 3, o_dims, o_strides, box)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch<128, 256, kTN>(a, b, o, group_sizes, out, M, K, N, E, sms,
                                                static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
