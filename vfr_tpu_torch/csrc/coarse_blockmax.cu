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
// operations (35 us at the bf16 tensor-core rate).  After the tensor cores
// take the products, what is left is the epilogue over Q*N scores (537 M at
// that size): it has to be a single instruction per score.
//
// Two variants; the host's plan (ops/kernels/select_plan.py) picks one from
// shapes and dtype, nothing is decided by trying a launch.
//
// `mma` (bf16 rows, d a multiple of 16 up to 64).  Queries are the M operand
// of mma.sync m16n8k16 and index rows the N operand, so a thread holds, for
// its 4 query rows, 2 index rows of every 8-row tile: the max over a block
// is a running fmax in registers, finished by two shuffles inside the quad
// (the TPU kernel's "queries on sublanes, rows on lanes").  One CTA (8
// warps x 32 queries) holds up to 256 queries as bf16 A fragments in
// registers for its whole life, so the operand is read once; it walks a
// contiguous range of 128-row stages that reach shared memory as bf16, 16
// bytes a thread, through a 4-stage cp.async ring (rows padded by 16 bytes:
// ldmatrix then reads 8 rows from 8 distinct bank groups), msq riding in the
// same stage.  The epilogue is one fma (2 acc - msq, rounded once as in
// the plain version) and one fmax per score.  Starting the accumulator at
// -msq[r]/2 instead (one fmax per score) was measured and dropped: every
// k-step then rounds at the magnitude of msq/2, and the result missed the
// 1e-5 tolerance at d = 64 (1.5e-5).  The tensor core sums a k-step's 16
// products with truncation, a few ulp of the sum: where |q.m| is much
// larger than the result (unnormalised queries) that shows as ~1e-5 of
// max(|value|, 1); with the unit-norm queries of the serving path it is
// ~2e-7.  Block maxima are staged per warp in shared memory and written out
// as runs of consecutive blocks per query.
//
// `simt` (f32 rows, other widths).  The TPU kernel's grid walks [128-query
// x 16384-row] tiles and
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
// In both variants the [Q, N] scores never leave registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_common.cuh"

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

// ---------------------------------------------------------------------------
// The `mma` variant.  See the header note.

constexpr int MQ = 256;       // queries per CTA: 8 warps x 2 m16 tiles
constexpr int MROWS = 128;    // index rows of one ring stage
constexpr int MSTAGES = 4;    // ring stages
constexpr int MFLUSH = 8;     // stages between two writes of the maxima

// KS = d / 16 k-steps, BR = block_rows.  Grid (ceil(Q / 256), CTAs over
// stage ranges); shared: MSTAGES x (128 rows of 2d + 16 bytes | 128 msq),
// then per warp [32][8 * 128 / BR + 1] staged maxima.
template <int KS, int BR>
__global__ void __launch_bounds__(256, 2)
coarse_blockmax_mma(const float* __restrict__ q,             // [Q, d] f32
                    const __nv_bfloat16* __restrict__ m,     // [N, d]
                    const float* __restrict__ msq,           // [N]
                    float* __restrict__ out,                 // [Q, G]
                    int Q, int N, int G, int stages_per_cta) {
  constexpr int DC = 16 * KS;
  constexpr int RB = DC * 2 + 16;               // padded row bytes
  constexpr int STAGE = MROWS * RB + MROWS * 4;
  constexpr int CPR = 2 * KS;                   // 16-byte pieces of a row
  constexpr int OPS = MROWS / BR;               // block maxima per stage
  constexpr int OUTW = MFLUSH * OPS;
  constexpr int TPB = BR / 8;                   // 8-row tiles per block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t ring = smem_u32(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float* outs = reinterpret_cast<float*>(smem_raw + MSTAGES * STAGE) +
                warp * 32 * (OUTW + 1);
  const int q0 = blockIdx.x * MQ + warp * 32;

  // this warp's 32 queries as bf16 A fragments, for the CTA's whole life
  uint32_t afr[2][KS][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + mt * 16 + g + 8 * (i % 2);
        const int k = ks * 16 + 2 * t + 8 * (i / 2);
        float2 v = make_float2(0.0f, 0.0f);
        if (qi < Q)
          v = *reinterpret_cast<const float2*>(q + (size_t)qi * DC + k);
        afr[mt][ks][i] = pack_bf16(v.x, v.y);
      }

  const int n_stages = (N + MROWS - 1) / MROWS;
  const int s_begin = blockIdx.y * stages_per_cta;
  const int n = min(n_stages, s_begin + stages_per_cta) - s_begin;

  auto load = [&](int slot, int s) {
    const uint32_t base = ring + slot * STAGE;
    const size_t row0 = (size_t)s * MROWS;
    for (int i = threadIdx.x; i < MROWS * CPR; i += 256) {
      const int r = i / CPR, pc = i % CPR;
      const bool ok = row0 + r < (size_t)N;
      cp_async16_s(base + r * RB + pc * 16,
                   ok ? m + (row0 + r) * DC + pc * 8 : m, ok);
    }
    if (threadIdx.x < MROWS / 4) {
      const size_t r = row0 + 4 * threadIdx.x;
      const uint32_t dst = base + MROWS * RB + 16 * threadIdx.x;
      if (r + 3 < (size_t)N) {
        cp_async16_s(dst, msq + r, true);
      } else {      // the ragged end of the operand: rows past N never win
        float* p = reinterpret_cast<float*>(smem_raw + slot * STAGE +
                                            MROWS * RB) + 4 * threadIdx.x;
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = r + i < (size_t)N ? msq[r + i] : 1e30f;
      }
    }
  };

#pragma unroll
  for (int i = 0; i < MSTAGES - 1; ++i) {
    if (i < n) load(i, s_begin + i);
    cp_async_commit();
  }
  float mx[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) mx[mt][0] = mx[mt][1] = -INFINITY;
  int n_out = 0;                                 // maxima staged in outs
  int g_flush = s_begin * OPS;                   // block of outs[.][0]
  for (int i = 0; i < n; ++i) {
    cp_async_wait<MSTAGES - 2>();
    __syncthreads();         // stage i is in; stage i-1's readers are done
    if (i + MSTAGES - 1 < n)
      load((i + MSTAGES - 1) % MSTAGES, s_begin + i + MSTAGES - 1);
    cp_async_commit();
    const uint32_t stage = ring + (i % MSTAGES) * STAGE;
    const float* msqs = reinterpret_cast<const float*>(
        smem_raw + (i % MSTAGES) * STAGE + MROWS * RB);
#pragma unroll
    for (int nt = 0; nt < MROWS / 8; ++nt) {
      // B fragments of rows nt*8 .. +7 over the whole depth
      uint32_t b[2 * KS];
      const uint32_t baddr =
          stage + (nt * 8 + lane % 8) * RB + (lane / 8) * 16;
#pragma unroll
      for (int j = 0; j < 2 * KS; j += 4) {
        if (j + 4 <= 2 * KS) {
          uint32_t r4[4];
          ldmatrix_x4(r4, baddr + j * 16);
          b[j] = r4[0]; b[j + 1] = r4[1]; b[j + 2] = r4[2]; b[j + 3] = r4[3];
        } else {
          // two matrices left: lanes 0-15 give the addresses
          ldmatrix_x2(b[j], b[j + 1],
                      stage + (nt * 8 + lane % 8) * RB +
                          (j + (lane / 8) % 2) * 16);
        }
      }
      const float2 hm = *reinterpret_cast<const float2*>(msqs + nt * 8 + 2 * t);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float acc[4];
        mma_bf16(acc, afr[mt][0], b[0], b[1], 0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int ks = 1; ks < KS; ++ks)
          mma_bf16(acc, afr[mt][ks], b[2 * ks], b[2 * ks + 1]);
        mx[mt][0] = fmaxf(mx[mt][0], fmaxf(fmaf(2.0f, acc[0], -hm.x),
                                           fmaf(2.0f, acc[1], -hm.y)));
        mx[mt][1] = fmaxf(mx[mt][1], fmaxf(fmaf(2.0f, acc[2], -hm.x),
                                           fmaf(2.0f, acc[3], -hm.y)));
      }
      if ((nt + 1) % TPB == 0) {                 // a block is complete
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v = mx[mt][h];
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
            if (t == 0)
              outs[(mt * 16 + g + 8 * h) * (OUTW + 1) + n_out + nt / TPB] = v;
            mx[mt][h] = -INFINITY;
          }
      }
    }
    n_out += OPS;
    if (n_out == OUTW || i == n - 1) {
      __syncwarp();
      for (int idx = lane; idx < 32 * n_out; idx += 32) {
        const int qq = idx / n_out, j = idx % n_out;
        const int qi = q0 + qq, gi = g_flush + j;
        if (qi < Q && gi < G)
          out[(size_t)qi * G + gi] = outs[qq * (OUTW + 1) + j];
      }
      __syncwarp();
      g_flush += n_out;
      n_out = 0;
    }
  }
  cp_async_wait<0>();
}

template <int KS, int BR>
int launch_mma(const float* q, const void* m, const float* msq, float* out,
               int Q, int N, int G, int stages_per_cta, int grid_y, int smem,
               cudaStream_t stream) {
  constexpr int STAGE = MROWS * (32 * KS + 16) + MROWS * 4;
  constexpr int NEED =
      MSTAGES * STAGE + 8 * 32 * (MFLUSH * (MROWS / BR) + 1) * 4;
  const int n_stages = (N + MROWS - 1) / MROWS;
  if (smem < NEED || stages_per_cta < 1 ||
      (long long)grid_y * stages_per_cta < n_stages)
    return (int)cudaErrorInvalidValue;
  auto kernel = coarse_blockmax_mma<KS, BR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + MQ - 1) / MQ, grid_y);
  kernel<<<grid, 256, smem, stream>>>(
      q, static_cast<const __nv_bfloat16*>(m), msq, out, Q, N, G,
      stages_per_cta);
  return (int)cudaGetLastError();
}

template <int KS>
int dispatch_rows_mma(const float* q, const void* m, const float* msq,
                      float* out, int Q, int N, int G, int block_rows,
                      int stages_per_cta, int grid_y, int smem,
                      cudaStream_t stream) {
  switch (block_rows) {
    case 32:
      return launch_mma<KS, 32>(q, m, msq, out, Q, N, G, stages_per_cta,
                                grid_y, smem, stream);
    case 64:
      return launch_mma<KS, 64>(q, m, msq, out, Q, N, G, stages_per_cta,
                                grid_y, smem, stream);
    case 128:
      return launch_mma<KS, 128>(q, m, msq, out, Q, N, G, stages_per_cta,
                                 grid_y, smem, stream);
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

// The `mma` variant: m bf16 [N, d], d in {16, 32, 48, 64}, m and msq 16-byte
// aligned.  The plan (stages per CTA, grid, shared memory bytes) comes from
// the caller; what the kernel cannot run is refused with an error code.
extern "C" int vfr_coarse_blockmax_mma(const float* q, const void* m,
                                       const float* msq, float* out, int Q,
                                       int N, int d, int block_rows,
                                       int stages_per_cta, int grid_y,
                                       int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = (N + block_rows - 1) / block_rows;
  if (Q <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(msq) |
       reinterpret_cast<uintptr_t>(q)) % 16)
    return (int)cudaErrorMisalignedAddress;
  switch (d) {
    case 16:
      return dispatch_rows_mma<1>(q, m, msq, out, Q, N, G, block_rows,
                                  stages_per_cta, grid_y, smem, s);
    case 32:
      return dispatch_rows_mma<2>(q, m, msq, out, Q, N, G, block_rows,
                                  stages_per_cta, grid_y, smem, s);
    case 48:
      return dispatch_rows_mma<3>(q, m, msq, out, Q, N, G, block_rows,
                                  stages_per_cta, grid_y, smem, s);
    case 64:
      return dispatch_rows_mma<4>(q, m, msq, out, Q, N, G, block_rows,
                                  stages_per_cta, grid_y, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
