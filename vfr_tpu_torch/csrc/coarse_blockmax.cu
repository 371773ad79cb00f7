// Stage-1 block maxima of the coarse-to-fine retriever, Hopper sm_90a.
//
// Replaces: vfr_tpu/ops/pallas/coarse_kernel.py::_kernel (:63, K4).  Same
// function:
//   sb[q, g] = max over rows r of the contiguous block g (rows
//              g*BR .. g*BR + BR - 1) of  2 * round(q[q]) . m[r] - msq[r]
// with q rounded once to m's dtype, products of the rounded values and
// sums in f32.  Rows r >= N read as m = 0, msq = 1e30 (the Pallas path's
// padding), so no padded copy of the operand is made.
//
// What bounds it on this card: bytes, N*d*2 + N*4 + Q*d*4 + Q*G*4 (161 MB
// at N = 2.1M, d = 32, Q = 256: 48 us at 3.35 TB/s), against 2*Q*N*d
// operations (35 us at the bf16 tensor-core rate).  This kernel runs its
// products as f32 FMAs outside the tensor cores, so its own floor is the
// f32 rate: ~0.5 ms at that size.  mma.sync / wgmma is later work.
//
// Design.  The TPU kernel's grid walks [128-query x 16384-row] tiles and
// reduces a [bq, bn] score tile in VMEM.  Here one CTA (8 warps) owns a
// tile of 64 queries and a contiguous range of whole BR-row blocks, so the
// max is a reduction inside the CTA (per thread over its rows, then warp
// shuffles) with no atomics and no second pass.  Per block the CTA stages
// the BR rows (as f32) and their msq in shared memory; the query tile is
// staged once.  Lane l of each warp owns rows l, l+32, ... of the block
// and the warp owns 8 queries, so a thread keeps 8 x BR/32 running sums
// and reads its 4 depth values of each operand as one float4 (rows padded
// to a 16-byte stride that leaves 8 consecutive lanes on distinct banks;
// the query read is a broadcast).  Query tiles run fastest in the grid, so
// the CTAs that read one range of m run together and share it through L2.
// The [Q, N] scores never leave registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int QT = 64;              // queries per CTA
constexpr int QPW = QT / WARPS;     // queries per warp

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float round_like(float v, const float*) {
  return v;
}
__device__ __forceinline__ float round_like(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// R = rows per lane (block_rows = 32 * R).  Shared: the query tile
// [QT][ld], the block [32R][ld] (ld = round4(d) + 4 floats), msq [32R].
template <typename T, int R>
__global__ void __launch_bounds__(THREADS)
coarse_blockmax_kernel(const float* __restrict__ q,     // [Q, d] f32
                       const T* __restrict__ m,         // [N, d]
                       const float* __restrict__ msq,   // [N]
                       float* __restrict__ out,         // [Q, G]
                       int Q, int N, int d, int G, int blocks_per_cta) {
  constexpr int BR = 32 * R;
  extern __shared__ __align__(16) float smem[];
  const int dp = (d + 3) / 4 * 4;
  const int ld = dp + 4;
  float* qs = smem;
  float* ms = qs + QT * ld;
  float* msqs = ms + BR * ld;
  const int q0 = blockIdx.x * QT;
  for (int i = threadIdx.x; i < QT * dp; i += THREADS) {
    const int qq = i / dp, k = i % dp;
    const int qi = q0 + qq;
    qs[qq * ld + k] =
        (qi < Q && k < d) ? round_like(q[(size_t)qi * d + k], m) : 0.0f;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g_begin = blockIdx.y * blocks_per_cta;
  const int g_end = min(G, g_begin + blocks_per_cta);
  for (int g = g_begin; g < g_end; ++g) {
    __syncthreads();   // the query tile is in; the last block's readers done
    const size_t row0 = (size_t)g * BR;
    for (int i = threadIdx.x; i < BR * dp; i += THREADS) {
      const int r = i / dp, k = i % dp;
      const size_t row = row0 + r;
      ms[r * ld + k] =
          (row < (size_t)N && k < d) ? load_f(m + row * d + k) : 0.0f;
    }
    for (int i = threadIdx.x; i < BR; i += THREADS) {
      const size_t row = row0 + i;
      msqs[i] = row < (size_t)N ? msq[row] : 1e30f;
    }
    __syncthreads();
    float acc[QPW][R];
#pragma unroll
    for (int a = 0; a < QPW; ++a)
#pragma unroll
      for (int r = 0; r < R; ++r) acc[a][r] = 0.0f;
    const float* qw = qs + warp * QPW * ld;
    for (int k = 0; k < dp; k += 4) {
      float4 mv[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        mv[r] = *reinterpret_cast<const float4*>(ms + (lane + 32 * r) * ld + k);
#pragma unroll
      for (int a = 0; a < QPW; ++a) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + a * ld + k);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float s = acc[a][r];
          s = fmaf(qv.x, mv[r].x, s);
          s = fmaf(qv.y, mv[r].y, s);
          s = fmaf(qv.z, mv[r].z, s);
          s = fmaf(qv.w, mv[r].w, s);
          acc[a][r] = s;
        }
      }
    }
    float mine = 0.0f;   // lane a keeps query a's block max
#pragma unroll
    for (int a = 0; a < QPW; ++a) {
      float best = 2.0f * acc[a][0] - msqs[lane];
#pragma unroll
      for (int r = 1; r < R; ++r)
        best = fmaxf(best, 2.0f * acc[a][r] - msqs[lane + 32 * r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, off));
      if (lane == a) mine = best;
    }
    const int qi = q0 + warp * QPW + lane;
    if (lane < QPW && qi < Q) out[(size_t)qi * G + g] = mine;
  }
}

template <typename T, int R>
int launch(const float* q, const void* m, const float* msq, float* out,
           int Q, int N, int d, int G, cudaStream_t stream) {
  const int ld = (d + 3) / 4 * 4 + 4;
  const size_t smem = ((size_t)(QT + 32 * R) * ld + 32 * R) * sizeof(float);
  auto kernel = coarse_blockmax_kernel<T, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int q_tiles = (Q + QT - 1) / QT;
  // ~2048 CTAs in all: several waves over 132 SMs, each CTA a contiguous
  // run of blocks
  int ctas = 2048 / q_tiles;
  ctas = ctas < 1 ? 1 : (ctas > G ? G : ctas);
  const int per_cta = (G + ctas - 1) / ctas;
  dim3 grid(q_tiles, (G + per_cta - 1) / per_cta);
  kernel<<<grid, THREADS, smem, stream>>>(
      q, static_cast<const T*>(m), msq, out, Q, N, d, G, per_cta);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_rows(const float* q, const void* m, const float* msq,
                  float* out, int Q, int N, int d, int G, int block_rows,
                  cudaStream_t stream) {
  switch (block_rows) {
    case 32: return launch<T, 1>(q, m, msq, out, Q, N, d, G, stream);
    case 64: return launch<T, 2>(q, m, msq, out, Q, N, d, G, stream);
    case 128: return launch<T, 4>(q, m, msq, out, Q, N, d, G, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// sb [Q, G] = per-block maxima, G = ceil(N / block_rows).  q [Q, d] f32;
// m [N, d] bf16 (m_bf16 = 1) or f32; msq [N] f32; block_rows 32, 64 or 128.
extern "C" int vfr_coarse_blockmax(const float* q, const void* m,
                                   const float* msq, float* out, int Q, int N,
                                   int d, int block_rows, int m_bf16,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = (N + block_rows - 1) / block_rows;
  if (Q <= 0 || G <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (m_bf16)
    return dispatch_rows<__nv_bfloat16>(q, m, msq, out, Q, N, d, G,
                                        block_rows, s);
  return dispatch_rows<float>(q, m, msq, out, Q, N, d, G, block_rows, s);
}
