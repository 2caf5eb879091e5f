// Ragged paged decode attention for Hopper (sm_90a).
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
// Design. One block per (kv head, lane, chunk of up to 8 q heads of the
// group); the block holds those query rows, so each K/V row is read from
// device memory once per kv head for groups of up to 8 (the TPU grid ran
// (lane, q head, page) and fetched each page once per q head); a larger
// group (any size: the JAX gate admits any) splits over grid.z, each chunk
// reading the K/V rows again. The block walks only the lane's band [start, length) in
// tiles of TILE rows, resolving each row's page through the table; rows
// past the length or before the window are never read. A tile of K and V
// is staged in shared memory with coalesced 16-byte loads (K rows padded by
// one 32-bit word so the per-row dot products are free of bank conflicts),
// then: scores (one thread per (q head, row)), the softmax update (one warp
// per q head), and P.V (one thread per output column).
//
// Head dims above 512 (any multiple of 8 the gate admits) take the kWide
// instance: grid.z also walks 512-column slices of the output, and each
// block sums the scores over D in 512-column chunks of q and K staged one at
// a time (the slices recompute the scores; no preset uses such head dims).
//
// Bound. Decode attention is memory bound: the least time is the resident
// K/V bytes, sum(lengths) * Hkv * D * 2 (K and V) * 2 bytes per layer, over
// 3.35 TB/s on an H100 SXM. With 8 lanes x 4 kv heads the grid is only 32
// blocks on 132 SMs, so one SM streams a whole lane's K/V for its head; a
// split-KV second pass (several blocks per lane merging partial softmax
// states) is the obvious later redesign to fill the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kTile = 64;      // K/V rows staged per shared-memory tile
constexpr int kMaxGroup = 8;   // q heads per block (a chunk of the group)
constexpr int kMaxDim = 512;   // head_dim of one pass (scores chunk, output slice)
constexpr int kCols = kMaxDim / kThreads;  // output columns per thread
constexpr float kNegInf = -1e30f;

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

// Four blocks per SM as the register budget (128 a thread): without the
// hint ptxas kept 72 registers and spilled, 33% slower at the b1 decode
// shape on an H100.
template <bool kWide>
__global__ void __launch_bounds__(kThreads, 4)
ragged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ table,
                     const int* __restrict__ lengths,
                     __nv_bfloat16* __restrict__ out,
                     int Hq, int Hkv, int D, int page_size, int P,
                     int n_pages, int window, float scale) {
  const int h = blockIdx.x;  // kv head
  const int b = blockIdx.y;  // lane
  // Wide: grid.z walks (head chunk, 512-column output slice) pairs.
  const int slices = kWide ? (D + kMaxDim - 1) / kMaxDim : 1;
  const int g0 = (blockIdx.z / slices) * kMaxGroup;  // first q head of the chunk
  const int c0 = (blockIdx.z % slices) * kMaxDim;    // first output column
  const int vc = kWide ? min(kMaxDim, D - c0) : D;   // output columns
  const int dc = kWide ? kMaxDim : D;                // q / K columns staged
  const int group = min(kMaxGroup, Hq / Hkv - g0);  // q heads of this block
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int k_stride = dc + 2;  // padded K row, in bf16 elements

  // Shared memory: fp32 regions first (q rows, scores/probabilities, the
  // per-head running max / denominator / rescale), then the bf16 tiles.
  extern __shared__ float4 smem_raw[];
  float* q_sm = reinterpret_cast<float*>(smem_raw);      // [group, dc]
  float* s_sm = q_sm + group * dc;                         // [group, kTile]
  float* m_sm = s_sm + group * kTile;                      // [kMaxGroup]
  float* l_sm = m_sm + kMaxGroup;                          // [kMaxGroup]
  float* a_sm = l_sm + kMaxGroup;                          // [kMaxGroup]
  __nv_bfloat16* k_sm =
      reinterpret_cast<__nv_bfloat16*>(a_sm + kMaxGroup);  // [kTile, dc+2]
  __nv_bfloat16* v_sm = k_sm + kTile * k_stride;           // [kTile, vc]

  int length = lengths[b];
  length = max(0, min(length, P * page_size));
  const int start = window > 0 ? max(length - window, 0) : 0;

  const int q_head0 = h * (Hq / Hkv) + g0;
  const __nv_bfloat16* q_lane = q + (static_cast<size_t>(b) * Hq + q_head0) * D;
  if (!kWide) {
    for (int i = tid; i < group * D; i += kThreads) q_sm[i] = __bfloat162float(q_lane[i]);
  }
  if (tid < kMaxGroup) {
    m_sm[tid] = kNegInf;
    l_sm[tid] = 0.f;
    a_sm[tid] = 0.f;
  }

  float acc[kMaxGroup][kCols];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[g][c] = 0.f;
  __syncthreads();

  const int chunks_per_row = D / 8;  // 16-byte chunks of one K/V row
  const int* lane_table = table + static_cast<size_t>(b) * P;

  for (int t0 = start; t0 < length; t0 += kTile) {
    const int rows = min(kTile, length - t0);

    if (!kWide) {
      // Stage K and V rows [t0, t0 + rows) of kv head h.
      for (int c = tid; c < rows * chunks_per_row; c += kThreads) {
        const int r = c / chunks_per_row;
        const int cc = c - r * chunks_per_row;
        const int kp = t0 + r;
        int phys = lane_table[kp / page_size];
        phys = min(max(phys, 0), n_pages - 1);
        const size_t off =
            ((static_cast<size_t>(phys) * page_size + kp % page_size) * Hkv + h) * D + cc * 8;
        const uint4 kk = *reinterpret_cast<const uint4*>(k + off);
        const uint4 vv = *reinterpret_cast<const uint4*>(v + off);
        uint32_t* kdst = reinterpret_cast<uint32_t*>(k_sm + r * k_stride + cc * 8);
        kdst[0] = kk.x;
        kdst[1] = kk.y;
        kdst[2] = kk.z;
        kdst[3] = kk.w;
        *reinterpret_cast<uint4*>(v_sm + r * D + cc * 8) = vv;
      }
      __syncthreads();

      // Scores: s[g][r] = (q_g . k_r) * scale, fp32 accumulation.
      for (int i = tid; i < group * kTile; i += kThreads) {
        const int g = i / kTile;
        const int r = i - g * kTile;
        float s = kNegInf;
        if (r < rows) {
          const __nv_bfloat162* kr =
              reinterpret_cast<const __nv_bfloat162*>(k_sm + r * k_stride);
          const float* qg = q_sm + g * D;
          float dot = 0.f;
          for (int d2 = 0; d2 < D / 2; ++d2) {
            const float2 kf = __bfloat1622float2(kr[d2]);
            dot = fmaf(qg[2 * d2], kf.x, dot);
            dot = fmaf(qg[2 * d2 + 1], kf.y, dot);
          }
          s = dot * scale;
        }
        s_sm[i] = s;
      }
      __syncthreads();
    } else {
      // Scores summed over D in chunks of dc columns of q and K; V's
      // output slice [c0, c0 + vc) staged with the first chunk.
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
        for (int i = tid; i < group * kTile; i += kThreads) {
          const int g = i / kTile;
          const int r = i - g * kTile;
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
    }

    // Online softmax update, one warp per q head. The denominator sums the
    // fp32 probabilities; P.V uses them rounded to bf16.
    for (int g = warp; g < group; g += kThreads / 32) {
      float* sg = s_sm + g * kTile;
      float mx = kNegInf;
      for (int r = lane; r < kTile; r += 32) mx = fmaxf(mx, sg[r]);
      mx = warp_max(mx);
      const float m_prev = m_sm[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int r = lane; r < kTile; r += 32) {
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
    for (int c = 0; c < kCols; ++c) {
      const int d = tid + c * kThreads;
      if (d < vc) {
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g)
          if (g < group) acc[g][c] *= a_sm[g];
        for (int r = 0; r < rows; ++r) {
          const float vr = __bfloat162float(v_sm[r * vc + d]);
#pragma unroll
          for (int g = 0; g < kMaxGroup; ++g)
            if (g < group) acc[g][c] = fmaf(s_sm[g * kTile + r], vr, acc[g][c]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites the staged rows
  }

  __nv_bfloat16* out_lane = out + (static_cast<size_t>(b) * Hq + q_head0) * D + c0;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int d = tid + c * kThreads;
    if (d < vc) {
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < group) {
          const float l = l_sm[g];
          const float safe = l == 0.f ? 1.f : l;
          out_lane[g * D + d] = __float2bfloat16(acc[g][c] / safe);
        }
      }
    }
  }
}

size_t shared_bytes(int group, int D) {
  const int dc = D > kMaxDim ? kMaxDim : D;  // q / K columns, V columns
  return sizeof(float) * (group * dc + group * kTile + 3 * kMaxGroup) +
         sizeof(__nv_bfloat16) * (kTile * (dc + 2) + kTile * dc);
}

template <bool kWide>
cudaError_t launch(const void* q, const void* k, const void* v, const void* table,
                   const void* lengths, void* out, int B, int Hq, int Hkv, int D, int page_size,
                   int P, int n_pages, int window, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = shared_bytes(G < kMaxGroup ? G : kMaxGroup, D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ragged_decode_kernel<kWide>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int slices = kWide ? (D + kMaxDim - 1) / kMaxDim : 1;
  dim3 grid(Hkv, B, (G + kMaxGroup - 1) / kMaxGroup * slices);
  ragged_decode_kernel<kWide><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out), Hq, Hkv, D,
      page_size, P, n_pages, window, scale);
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
  return static_cast<int>(
      D > kMaxDim ? launch<true>(q, k, v, table, lengths, out, B, Hq, Hkv, D, page_size, P,
                                 n_pages, window, scale, s)
                  : launch<false>(q, k, v, table, lengths, out, B, Hq, Hkv, D, page_size, P,
                                  n_pages, window, scale, s));
}

}  // extern "C"
