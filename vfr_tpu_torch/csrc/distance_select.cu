// Fused distance + strided-bin candidate selection, Hopper sm_90a.
//
// Replaces: vfr_tpu/ops/pallas/select_kernel.py::_kernel (:41), entry
// pallas_distance_select (:73).  Same semantics:
//   D[q, r] = sum_s w_s * (|m_s[r]|^2 + |q_s|^2 - 2 * m_s[r].round(q_s))
// with q rounded to m's dtype for the product, f32 accumulation, |q_s|^2
// from the f32 q.  Rows are grouped by the 4096-row tile (block_n) of the
// reference, whatever this kernel's own tiling: row r lies in tile
// r / block_n and bin (r % block_n) % bins, bins = block_n / bin_size, and
// its candidate column is tile * bins + bin.  Each (q, column) keeps the
// minimum distance and its row; ties go to the lowest row (rows of a bin
// are visited in ascending order with a strict <).  Rows past N read as
// m = 0, |m|^2 = 1e30 (the reference's padding), without a padded copy.
//
// What bounds it on this card: it reads the index once (215 MB f32 or
// 107.5 MB bf16 at S=2, N=210,000, d=128) and does 2*S*Q*N*d flops (27.5
// GFLOP at Q=256).  With f32 products that is operations at the f32 rate;
// with a bf16 index it is bytes.  This first version does the products
// with plain f32 FMAs and is well above either bound.
//
// Design.  A block takes 64 queries (resident in shared memory, already
// rounded, with their f32 |q|^2) and 64 consecutive bins of one tile.  It
// walks a = 0 .. bin_size-1; at each a the 64 bins' rows are the 64
// contiguous rows tile*block_n + a*bins + b0 .. +63, streamed through
// shared memory in 32-wide depth chunks.  Each thread owns 4 queries x 4
// bins and keeps their running (min, row) in registers, so the [Q, N]
// distance matrix never reaches device memory.  Output is [Q, C] directly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QT = 64;   // queries per block
constexpr int NB = 64;   // bins per block
constexpr int KC = 32;   // depth chunk of the streamed index rows

template <typename MT>
__device__ __forceinline__ float mload(const MT* p);

template <>
__device__ __forceinline__ float mload<float>(const float* p) {
  return *p;
}

template <>
__device__ __forceinline__ float mload<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename MT>
__device__ __forceinline__ float round_to(float v);

template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename MT, int S>
__global__ void __launch_bounds__(256)
distance_select_kernel(const float* __restrict__ q,     // [S, Q, d]
                       const MT* __restrict__ m,        // [S, N, d]
                       const float* __restrict__ msq,   // [S, N]
                       float w0, float w1,
                       float* __restrict__ vals,        // [Q, C]
                       int* __restrict__ rows,          // [Q, C]
                       int Q, int N, int d, int bin_size, int block_n,
                       int groups_per_tile, int C) {
  extern __shared__ float smem[];
  float* qs = smem;                          // [S][d][QT]  rounded q
  float* qsq = qs + S * d * QT;              // [S][QT]     f32 |q|^2
  float* ms = qsq + S * QT;                  // [KC][NB + 1] index chunk
  const int bins = block_n / bin_size;
  const int tile = blockIdx.y / groups_per_tile;
  const int b0 = (blockIdx.y % groups_per_tile) * NB;
  const int q0 = blockIdx.x * QT;
  const int tq = threadIdx.x / 16;           // queries tq*4 .. tq*4+3
  const int tb = threadIdx.x % 16;           // bins tb + 16*jj

  for (int i = threadIdx.x; i < S * d * QT; i += 256) {
    const int s = i / (d * QT), rem = i % (d * QT);
    const int ql = rem / d, k = rem % d;
    const int qi = q0 + ql;
    qs[(s * d + k) * QT + ql] =
        qi < Q ? round_to<MT>(q[((size_t)s * Q + qi) * d + k]) : 0.0f;
  }
  for (int i = threadIdx.x; i < S * QT; i += 256) {
    const int s = i / QT, ql = i % QT;
    const int qi = q0 + ql;
    float acc = 0.0f;
    if (qi < Q) {
      const float* qrow = q + ((size_t)s * Q + qi) * d;
      for (int k = 0; k < d; ++k) acc += qrow[k] * qrow[k];
    }
    qsq[s * QT + ql] = acc;
  }

  float best[4][4];
  int best_row[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      best[i][jj] = INFINITY;
      best_row[i][jj] = tile * block_n + b0 + tb + 16 * jj;
    }

  for (int a = 0; a < bin_size; ++a) {
    const long long rbase = (long long)tile * block_n + (long long)a * bins + b0;
    float dot[S][4][4];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) dot[s][i][jj] = 0.0f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      for (int k0 = 0; k0 < d; k0 += KC) {
        __syncthreads();
        for (int i = threadIdx.x; i < NB * KC; i += 256) {
          const int lb = i / KC, kk = i % KC;
          const long long r = rbase + lb;
          const int k = k0 + kk;
          const bool ok = (b0 + lb < bins) && r < N && k < d;
          ms[kk * (NB + 1) + lb] =
              ok ? mload(m + ((size_t)s * N + r) * d + k) : 0.0f;
        }
        __syncthreads();
        const int kmax = min(KC, d - k0);
        for (int kk = 0; kk < kmax; ++kk) {
          float qv[4], mv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) qv[i] = qs[(s * d + k0 + kk) * QT + tq * 4 + i];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) mv[jj] = ms[kk * (NB + 1) + tb + 16 * jj];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) dot[s][i][jj] += qv[i] * mv[jj];
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const long long r = rbase + tb + 16 * jj;
      float mq[S];
#pragma unroll
      for (int s = 0; s < S; ++s) mq[s] = r < N ? msq[(size_t)s * N + r] : 1e30f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float acc = 0.0f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float term = mq[s] + qsq[s * QT + tq * 4 + i] - 2.0f * dot[s][i][jj];
          acc = (s == 0) ? w0 * term : acc + w1 * term;
        }
        if (acc < best[i][jj]) {
          best[i][jj] = acc;
          best_row[i][jj] = (int)r;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tq * 4 + i;
    if (qi >= Q) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int bin = b0 + tb + 16 * jj;
      if (bin >= bins) continue;
      const size_t o = (size_t)qi * C + (size_t)tile * bins + bin;
      vals[o] = best[i][jj];
      rows[o] = best_row[i][jj];
    }
  }
}

template <typename MT, int S>
int launch(const float* q, const void* m, const float* msq, float w0,
           float w1, float* vals, int* rows, int Q, int N, int d,
           int bin_size, int block_n, cudaStream_t stream) {
  const int bins = block_n / bin_size;
  const int tiles = (N + block_n - 1) / block_n;
  const int groups = (bins + NB - 1) / NB;
  const int C = tiles * bins;
  const size_t smem =
      sizeof(float) * ((size_t)S * d * QT + S * QT + KC * (NB + 1));
  cudaError_t err = cudaFuncSetAttribute(
      distance_select_kernel<MT, S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + QT - 1) / QT, tiles * groups);
  distance_select_kernel<MT, S><<<grid, 256, smem, stream>>>(
      q, static_cast<const MT*>(m), msq, w0, w1, vals, rows, Q, N, d,
      bin_size, block_n, groups, C);
  return (int)cudaGetLastError();
}

}  // namespace

// q [S, Q, d] f32; m [S, N, d] bf16 (m_bf16 = 1) or f32; msq [S, N] f32;
// S is 1 or 2 with stream weights w0, w1; block_n % bin_size == 0.
// Outputs vals, rows [Q, C], C = ceil(N / block_n) * (block_n / bin_size).
extern "C" int vfr_distance_select(const float* q, const void* m,
                                   const float* msq, float w0, float w1,
                                   int S, int Q, int N, int d, int bin_size,
                                   int block_n, int m_bf16, float* vals,
                                   int* rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S == 1) {
    return m_bf16 ? launch<__nv_bfloat16, 1>(q, m, msq, w0, w1, vals, rows,
                                             Q, N, d, bin_size, block_n, s)
                  : launch<float, 1>(q, m, msq, w0, w1, vals, rows, Q, N, d,
                                     bin_size, block_n, s);
  }
  if (S == 2) {
    return m_bf16 ? launch<__nv_bfloat16, 2>(q, m, msq, w0, w1, vals, rows,
                                             Q, N, d, bin_size, block_n, s)
                  : launch<float, 2>(q, m, msq, w0, w1, vals, rows, Q, N, d,
                                     bin_size, block_n, s);
  }
  return (int)cudaErrorInvalidValue;
}
