// Pieces shared by the query-recurrence kernels (lstm_recurrence.cu, K1;
// gru_recurrence.cu, K3): the hoisted input product gx = round(x) @ W_ih +
// bias over all B*T rows, as tiled f32 FMAs (f32 weights) or as WMMA
// 16x16x16 bf16 -> f32 fragments fed by a 3-stage cp.async pipeline (bf16
// weights), and the cp.async helpers the step kernels use.  Included by
// each kernel source (each is its own shared library), never compiled
// alone; kernels/build.py hashes it into every library's name.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// ---------------------------------------------------------------------------
// f32-weight path: tiled FMAs.

constexpr int PM = 64;   // input projection tile: rows
constexpr int PN = 64;   //                        gate columns
constexpr int PK = 16;   //                        depth

// f32 weights: gx[m, n] = sum_k x[m, k] * w[k, n] + bias[n];  m = b*T + t
__global__ void __launch_bounds__(256)
input_proj_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ gx,
                  int M, int N, int K) {
  __shared__ float As[PK][PM + 1];   // +1: conflict-free transposed store
  __shared__ float Bs[PK][PN];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * PM;
  const int n0 = blockIdx.x * PN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += PK) {
    for (int i = threadIdx.x; i < PM * PK; i += 256) {
      const int mm = i / PK, kk = i % PK;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K)
                       ? x[(size_t)gm * K + gk] : 0.0f;
    }
    for (int i = threadIdx.x; i < PK * PN; i += 256) {
      const int kk = i / PN, nn = i % PN;
      const int gk = k0 + kk, gn = n0 + nn;
      Bs[kk][nn] = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < PK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) gx[(size_t)gm * N + gn] = acc[i][j] + bias[gn];
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path (bf16 weights): WMMA 16x16x16 bf16 -> f32 fragments fed
// by a 3-stage cp.async pipeline.  Operands reach shared memory as bf16
// with 16-byte copies: x is rounded once into a zero-padded bf16 copy, and
// every step also writes h_t rounded to bf16 for the next step's product.

using namespace nvcuda;
using Bf16 = __nv_bfloat16;

constexpr int STAGES = 3;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;     // 0 source bytes: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// xb[m, k] = bf16(x[m, k]) for k < K, 0 for K <= k < Kp (Kp % 8 == 0)
__global__ void to_bf16_padded(const float* __restrict__ x,
                               Bf16* __restrict__ xb, int M, int K, int Kp) {
  const size_t n = (size_t)M * Kp;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t m = i / Kp;
    const int k = (int)(i % Kp);
    xb[i] = k < K ? __float2bfloat16_rn(x[m * K + k]) : __float2bfloat16(0.0f);
  }
}

constexpr int TM = 64;    // input product tile: rows    (4 warps: 2 x 2,
constexpr int TN = 128;   //                     columns  32 x 64 each)
constexpr int TK = 32;    //                     depth
constexpr int TA_LD = TK + 8;
constexpr int TB_LD = TN + 8;
constexpr int TC_LD = TN + 4;
constexpr int TA_STAGE = TM * TA_LD;
constexpr int TB_STAGE = TK * TB_LD;
constexpr size_t PROJ_SMEM =
    STAGES * (TA_STAGE + TB_STAGE) * sizeof(Bf16) + TM * TC_LD * sizeof(float);

// gx[m, n] = sum_k xb[m, k] * w[k, n] + bias[n];  m = b*T + t.  Needs
// N % 8 == 0 (16-byte rows of w).
__global__ void __launch_bounds__(128)
input_proj_wmma(const Bf16* __restrict__ xb, const Bf16* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ gx,
                int M, int N, int K, int Kp) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Bf16* As = reinterpret_cast<Bf16*>(smem_raw);
  Bf16* Bs = As + STAGES * TA_STAGE;
  float* Cs = reinterpret_cast<float*>(Bs + STAGES * TB_STAGE);
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 64;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int nk = (Kp + TK - 1) / TK;
  auto load = [&](int stage, int kc) {
    const int k0 = kc * TK;
    Bf16* a = As + stage * TA_STAGE;
    Bf16* bs = Bs + stage * TB_STAGE;
    for (int i = threadIdx.x; i < TM * (TK / 8); i += 128) {
      const int r = i / (TK / 8), kv = (i % (TK / 8)) * 8;
      const int m = m0 + r, k = k0 + kv;
      const bool ok = m < M && k < Kp;
      cp_async16(a + r * TA_LD + kv, ok ? xb + (size_t)m * Kp + k : xb, ok);
    }
    for (int i = threadIdx.x; i < TK * (TN / 8); i += 128) {
      const int kk = i / (TN / 8), col = (i % (TN / 8)) * 8;
      const int k = k0 + kk, n = n0 + col;
      const bool ok = k < K && n < N;
      cp_async16(bs + kk * TB_LD + col, ok ? w + (size_t)k * N + n : w, ok);
    }
  };
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load(st, st);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kc + STAGES - 1 < nk) load((kc + STAGES - 1) % STAGES, kc + STAGES - 1);
    cp_async_commit();
    const Bf16* a = As + (kc % STAGES) * TA_STAGE;
    const Bf16* bs = Bs + (kc % STAGES) * TB_STAGE;
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, Bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, Bf16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a + (wm + 16 * i) * TA_LD + kk, TA_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * TB_LD + wn + 16 * j, TB_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * TC_LD + wn + 16 * j,
                              acc[i][j], TC_LD, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < TM * TN; i += 128) {
    const int mm = i / TN, nn = i % TN;
    const int m = m0 + mm, n = n0 + nn;
    if (m < M && n < N) gx[(size_t)m * N + n] = Cs[mm * TC_LD + nn] + bias[n];
  }
}

// The hoisted input product of one layer: gx [B*T, N] = round(x) @ w_ih +
// bias, on the tensor cores (bf16 weights; xb is the caller's bf16 scratch
// [B*T, round8(E)]) or as f32 FMAs.  Returns a cudaError_t.
inline int input_product(const float* x, const void* w_ih, const float* bias,
                         Bf16* xb, float* gx, int M, int N, int E, bool bf16,
                         cudaStream_t stream) {
  if (bf16) {
    const int Kp = (E + 7) / 8 * 8;
    cudaError_t err = cudaFuncSetAttribute(
        input_proj_wmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)PROJ_SMEM);
    if (err != cudaSuccess) return (int)err;
    to_bf16_padded<<<1024, 256, 0, stream>>>(x, xb, M, E, Kp);
    dim3 pgrid((N + TN - 1) / TN, (M + TM - 1) / TM);
    input_proj_wmma<<<pgrid, 128, PROJ_SMEM, stream>>>(
        xb, static_cast<const Bf16*>(w_ih), bias, gx, M, N, E, Kp);
  } else {
    dim3 pgrid((N + PN - 1) / PN, (M + PM - 1) / PM);
    input_proj_kernel<<<pgrid, 256, 0, stream>>>(
        x, static_cast<const float*>(w_ih), bias, gx, M, N, E);
  }
  return (int)cudaGetLastError();
}

}  // namespace
