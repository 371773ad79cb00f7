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
// GFLOP at Q=256).  With a bf16 index that is bytes (0.035 ms).  With an f32
// index the products need f32 accuracy, which the tensor cores give only as
// three TF32 products (below): operations, 3 x the TF32 time (0.17 ms), still
// under the f32 SIMT time (0.41 ms).
//
// Two variants; the host's plan (ops/kernels/select_plan.py) picks one from
// shapes and dtype, nothing is decided by trying a launch.
//
// `mma` (bins a multiple of 64, d a multiple of 16).  The geometry that
// makes it cheap: row tile*block_n + a*bins + b lies in bin b, so the 64
// contiguous rows of one `a` hit 64 consecutive bins once each, and an MMA
// tile of [queries x those rows] has one (query, bin) pair per accumulator
// element.  The running (min, a) over a is then a compare-and-select on the
// accumulator registers, in ascending a with a strict < (lowest row wins a
// tie): no staging tile, no shuffle, no atomics, and the [Q, N] distances
// never reach device memory.  The products are warpgroup MMAs (wgmma
// m64n64): the queries are the A operand from registers (64 per warpgroup,
// two warpgroups, 128 queries per CTA, resident in shared memory for the
// CTA's life and rounded to the index dtype once), the 64 index rows of an
// a-step are the B operand read from shared memory by descriptor (128-byte
// rows with the 128-byte swizzle), so no thread loads a fragment of the
// index at all.  The rows of the CTA's `a` range stream through a cp.async
// ring, 16 bytes a thread.  What an iteration of the ring costs is mostly a
// chain of latencies (copy wait, proxy fence, block barrier, fragment loads,
// wgmma issue and wait), measured at ~1000 cycles whatever it holds, so a
// stage holds several 128-byte chunks: a whole a-step of a bf16 index (4
// stages), two chunks of an f32 index (3 stages).
//   bf16 index: wgmma k16 bf16 -> f32, A fragments by ldmatrix.
//   f32 index: one TF32 pass is a different result (10-bit mantissa), so
//     each operand is split x = hi + lo with hi = x truncated to TF32 and lo
//     = x - hi (exact; the tensor core reads it truncated to TF32), and each
//     k-step adds lo*hi + hi*lo + hi*hi into the f32 accumulator, small
//     terms first (wgmma k8 tf32).  The tensor core reads the raw f32 index
//     rows truncated, which is hi; each thread writes lo of the 32 bytes it
//     copied itself into a second tile; the query fragments are split in
//     registers.  What is dropped is lo*lo and the truncation of lo: ~2^-20
//     of a product.
//   Two streams share one accumulator without touching the rounded query:
//     the stream with the smaller |w| runs first, the accumulator is scaled
//     by w_first / w_second (|ratio| <= 1) and the second stream adds on, so
//     key = (w0 msq0[r] + w1 msq1[r]) - 2 w_second * acc.  The per-query
//     constant sum_s w_s |q_s|^2 does not change an argmin and is added
//     once at the end.  A small pre-pass computes both constants (rows past
//     N get 1e30 as in the reference's padding).
//   Work is cut into units of (tile, 64-bin group, 128-query tile, `a`
//   range): the host's plan splits the a range so that the units fill the
//   card's CTA slots evenly.  With more than one a range per bin, each
//   writes its partial (min, row) and a combine pass takes them in
//   ascending a with a strict <, which keeps the lowest-row rule.
//
// `simt` (everything else): f32 FMAs, the first design.  A block takes 64
// queries (resident in shared memory, already
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

#include "mma_common.cuh"

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

// ---------------------------------------------------------------------------
// The `mma` variant.  See the header note.

constexpr int SQ = 128;       // queries per CTA: 2 warpgroups x 64
constexpr int SR = 64;        // index rows per a-step: one per bin of a group
constexpr int SCH = 128;      // bytes of a row in one chunk
constexpr int WTILE = SR * SCH;      // one operand tile: 64 rows x 128 bytes

struct SelectArgs {
  const float* q;        // [S, Q, d]
  const void* qb;        // bf16 index: [S, Q, dpad] q rounded, zero padded
  const void* m;         // [S, N, d]
  const float* cr;       // [tiles * block_n]  sum_s w_s msq_s[r]; 1e30 past N
  const float* cq;       // [Q]                sum_s w_s |q_s|^2
  float* vals;           // [P, Q, C] (P = 1: the output itself)
  int* rows;
  int S, Q, N, d, bin_size, bins, block_n, groups, C;
  int P, per_a;          // a ranges per bin, a values per range
  int first;             // the stream that runs first
  float ratio, scale;    // w_first / w_second, -2 w_second
};

// cr, cq and the bf16 copy of q (one launch, before the main kernel).
__global__ void select_prep(const float* __restrict__ q,
                            const float* __restrict__ msq, float w0, float w1,
                            float* __restrict__ cr, float* __restrict__ cq,
                            __nv_bfloat16* __restrict__ qb, int S, int Q,
                            int N, int d, int dpad, int n_pad) {
  const size_t tid = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  const size_t nthreads = (size_t)gridDim.x * blockDim.x;
  if (qb != nullptr)     // the queries rounded once, zero padded to dpad
    for (size_t j = tid; j < (size_t)S * Q * dpad; j += nthreads) {
      const int k = (int)(j % dpad);
      qb[j] = __float2bfloat16_rn(k < d ? q[j / dpad * d + k] : 0.0f);
    }
  for (size_t i = tid; i < (size_t)n_pad; i += nthreads) {
    float v = w0 * (i < (size_t)N ? msq[i] : 1e30f);
    if (S == 2) v += w1 * (i < (size_t)N ? msq[(size_t)N + i] : 1e30f);
    cr[i] = v;
  }
  const int lane = threadIdx.x % 32;           // one warp per query
  for (size_t qi = tid / 32; qi < (size_t)Q; qi += nthreads / 32) {
    float v = 0.0f;
    for (int s = 0; s < S; ++s) {
      const float* row = q + ((size_t)s * Q + qi) * d;
      float acc = 0.0f;
      for (int k = lane; k < d; k += 32) acc += row[k] * row[k];
#pragma unroll
      for (int o = 16; o > 0; o /= 2)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      v += (s == 0 ? w0 : w1) * acc;
    }
    if (lane == 0) cq[qi] = v;
  }
}

// What one iteration of the ring costs is mostly a chain of latencies (copy
// wait, fence, block barrier, fragment loads, wgmma issue and wait), not
// bandwidth or tensor time, so a stage holds several 128-byte chunks: CPS
// of them per barrier.
template <typename MT>
struct Ring {
  static constexpr bool BF = sizeof(MT) == 2;
  static constexpr int CPS = BF ? 4 : 2;              // chunks per stage
  static constexpr int NST = BF ? 4 : 3;              // stages
  static constexpr int CHB = BF ? WTILE : 2 * WTILE;  // f32: raw rows | lo
  static constexpr int STB = CPS * CHB;
  static constexpr int QPAD = BF ? 16 : 0;   // f32 query rows are swizzled
};

template <typename MT>
__global__ void __launch_bounds__(256, 1)
distance_select_mma(const SelectArgs p) {
  using R = Ring<MT>;
  constexpr bool BF = R::BF;
  constexpr int ES = sizeof(MT);
  constexpr int KC = SCH / ES;                 // elements of one chunk
  constexpr int CPS = R::CPS, NST = R::NST, CHB = R::CHB, STB = R::STB;
  extern __shared__ unsigned char smem_raw[];
  const int d = p.d, S = p.S, N = p.N, Q = p.Q;
  const int nc = (d + KC - 1) / KC;            // chunks per stream
  const int qrb = nc * SCH + R::QPAD;          // bytes of a query row
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  unsigned char* ringp = smem_raw + (ring - raw);
  const uint32_t qs_u = ring + NST * STB;
  const unsigned char* qsp = ringp + NST * STB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wg = warp / 4, w = warp % 4;

  int u = blockIdx.x;
  const int q_tiles = (Q + SQ - 1) / SQ;
  const int qt = u % q_tiles;  u /= q_tiles;
  const int pi = u % p.P;      u /= p.P;
  const int grp = u % p.groups;
  const int tile = u / p.groups;
  const int q0 = qt * SQ;
  const int a0 = pi * p.per_a;
  const int a1 = min(p.bin_size, a0 + p.per_a);
  const size_t row_base = (size_t)tile * p.block_n + (size_t)grp * SR;

  {   // the resident query tile, slot 0 = the stream that runs first: 16-byte
      // copies in the ring's first group.  bf16 rows are padded by 16 bytes
      // (ldmatrix); in an f32 row the piece pc of a 128-byte chunk sits at
      // pc ^ (row & 7), so that the scalar fragment loads of 8 rows x 4
      // words hit 32 banks.
    const int ppr = nc * (SCH / 16);
    const size_t src_row = BF ? (size_t)nc * SCH : (size_t)d * ES;
    const unsigned char* src0 =
        static_cast<const unsigned char*>(BF ? p.qb : (const void*)p.q);
    for (int i = threadIdx.x; i < S * SQ * ppr; i += 256) {
      const int pc = i % ppr, rest = i / ppr;
      const int ql = rest % SQ, slot = rest / SQ;
      const int s = slot == 0 ? p.first : 1 - p.first;
      const int qi = q0 + ql;
      const bool ok = qi < Q && (size_t)pc * 16 < src_row;
      const int dpc = BF ? pc : (pc & ~7) | ((pc ^ ql) & 7);
      cp_async16_s(qs_u + (slot * SQ + ql) * qrb + dpc * 16,
                   ok ? src0 + ((size_t)s * Q + qi) * src_row + pc * 16 : src0,
                   ok);
    }
  }

  const int n_chunks = (a1 - a0) * S * nc;
  const int n_iter = (n_chunks + CPS - 1) / CPS;
  int pa = a0, ps = 0, pc = 0;                 // producer position
  const int lrow = threadIdx.x / 8, lpiece = threadIdx.x % 8;
  // this thread's two pieces of a chunk: rows lrow, lrow + 32 (same r & 7)
  const uint32_t loff = lrow * SCH + ((lpiece ^ (lrow & 7)) << 4);
  auto load = [&](int stage) {                 // CPS chunks, fewer at the end
#pragma unroll
    for (int c = 0; c < CPS; ++c) {
      if (pa >= a1) break;
      const int s = ps == 0 ? p.first : 1 - p.first;
      const size_t r0 = row_base + (size_t)pa * p.bins;
      const int kbyte = pc * SCH + lpiece * 16;
      const bool k_ok = kbyte < d * ES;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = lrow + 32 * j;
        const bool ok = k_ok && r0 + r < (size_t)N;
        const unsigned char* src =
            static_cast<const unsigned char*>(p.m) +
            (((size_t)s * N + r0 + r) * d) * ES + kbyte;
        cp_async16_s(ring + stage * STB + c * CHB + loff + j * 32 * SCH,
                     ok ? (const void*)src : p.m, ok);
      }
      if (++pc == nc) { pc = 0; if (++ps == S) { ps = 0; ++pa; } }
    }
  };
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (i < n_iter) load(i);
    cp_async_commit();
  }

  float acc[32], best[32];
  int best_a[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    acc[i] = 0.0f;
    best[i] = INFINITY;
    best_a[i] = a0;
  }

  // A registers of chunk (slot, chunk) of this warp's 16 queries
  const int arow = wg * 64 + w * 16;
  auto load_a = [&](uint32_t* ah, uint32_t* al, int slot, int chunk) {
    if constexpr (BF) {
      const uint32_t base =
          qs_u + (slot * SQ + arow + lane % 8 + 8 * ((lane / 8) % 2)) * qrb +
          chunk * SCH + (lane / 16) * 16;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t r4[4];
        ldmatrix_x4(r4, base + ks * 32);
#pragma unroll
        for (int i = 0; i < 4; ++i) ah[ks * 4 + i] = r4[i];
      }
    } else {
      // rows arow + g and + 8 share (row & 7) = g
      const unsigned char* base =
          qsp + (size_t)(slot * SQ + arow + g) * qrb + chunk * SCH + t * 4;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = *reinterpret_cast<const float*>(
              base + 8 * (i % 2) * qrb + (((2 * ks + i / 2) ^ g) << 4));
          const uint32_t hi = __float_as_uint(x) & 0xffffe000u;
          ah[ks * 4 + i] = hi;
          al[ks * 4 + i] = __float_as_uint(x - __uint_as_float(hi));
        }
    }
  };

  int ca = a0, cs = 0, cc = 0;                 // consumer position
  const bool scale_first = S == 2 && p.ratio != 1.0f;
  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<NST - 2>();
    const int st = it % NST;
    if constexpr (!BF) {   // lo of the bytes this thread copied itself
#pragma unroll
      for (int c = 0; c < CPS; ++c)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          unsigned char* src = ringp + st * STB + c * CHB + loff + j * 32 * SCH;
          const float4 x = *reinterpret_cast<const float4*>(src);
          float4 lo;
          lo.x = x.x - __uint_as_float(__float_as_uint(x.x) & 0xffffe000u);
          lo.y = x.y - __uint_as_float(__float_as_uint(x.y) & 0xffffe000u);
          lo.z = x.z - __uint_as_float(__float_as_uint(x.z) & 0xffffe000u);
          lo.w = x.w - __uint_as_float(__float_as_uint(x.w) & 0xffffe000u);
          *reinterpret_cast<float4*>(src + WTILE) = lo;
        }
    }
    fence_async_smem();
    __syncthreads();       // stage `it` is in; stage it-1's products are done
    if (it + NST - 1 < n_iter) load((it + NST - 1) % NST);
    cp_async_commit();
    uint32_t ah[CPS][16], al[CPS][BF ? 1 : 16];
#pragma unroll
    for (int c = 0; c < CPS; ++c) {
      if (ca >= a1) break;
      const bool last = cc == nc - 1 && cs == S - 1;
      float2 crv[8];
      if (last) {          // this a-step's row constants, ahead of their use
        const float* crp = p.cr + row_base + (size_t)ca * p.bins + 2 * t;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          crv[j] = __ldg(reinterpret_cast<const float2*>(crp + j * 8));
      }
      load_a(ah[c], al[c], cs, cc);
      const int fresh = (cc == 0 && cs == 0) ? 0 : 1;   // 0: overwrite acc
      const uint64_t bd = smem_desc(ring + st * STB + c * CHB);
      wgmma_fence();
      if constexpr (BF) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_bf16_ra(acc, &ah[c][ks * 4], bd + 2 * ks, ks == 0 ? fresh : 1);
      } else {
        const uint64_t bl = smem_desc(ring + st * STB + c * CHB + WTILE);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {       // small terms first
          wgmma_tf32_ra(acc, &al[c][ks * 4], bd + 2 * ks, ks == 0 ? fresh : 1);
          wgmma_tf32_ra(acc, &ah[c][ks * 4], bl + 2 * ks, 1);
          wgmma_tf32_ra(acc, &ah[c][ks * 4], bd + 2 * ks, 1);
        }
      }
      wgmma_commit();
      if (cc == nc - 1 && (last || scale_first)) {
        wgmma_wait<0>();
        if (!last) {       // the first stream is done: weigh it
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[i] *= p.ratio;
        } else {           // the a-step is done: running (min, a)
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const float key = fmaf(acc[i], p.scale,
                                   i % 2 ? crv[i / 4].y : crv[i / 4].x);
            if (key < best[i]) {
              best[i] = key;
              best_a[i] = ca;
            }
          }
        }
      }
      if (++cc == nc) { cc = 0; if (++cs == S) { cs = 0; ++ca; } }
    }
    wgmma_wait<0>();       // before the barrier that frees this stage
  }
  cp_async_wait<0>();

  float* vals = p.vals + (size_t)pi * Q * p.C;
  int* rows = p.rows + (size_t)pi * Q * p.C;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = q0 + arow + g + 8 * rr;
    if (qi >= Q) continue;
    const float cqv = p.cq[qi];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int b = grp * SR + j * 8 + 2 * t;
      const size_t o = (size_t)qi * p.C + (size_t)tile * p.bins + b;
      const int r0 = tile * p.block_n + b;
      const int i0 = 4 * j + 2 * rr;
      *reinterpret_cast<float2*>(vals + o) =
          make_float2(best[i0] + cqv, best[i0 + 1] + cqv);
      *reinterpret_cast<int2*>(rows + o) = make_int2(
          r0 + best_a[i0] * p.bins, r0 + 1 + best_a[i0 + 1] * p.bins);
    }
  }
}

// The partial (min, row) of the P a-ranges of every bin, in ascending a:
// a strict < keeps the lowest row of a tie.
__global__ void select_combine(const float* __restrict__ pv,
                               const int* __restrict__ pr,
                               float* __restrict__ vals,
                               int* __restrict__ rows, int P, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = pv[i];
    int r = pr[i];
    for (int k = 1; k < P; ++k) {
      const float vk = pv[k * n + i];
      if (vk < v) { v = vk; r = pr[k * n + i]; }
    }
    vals[i] = v;
    rows[i] = r;
  }
}

template <typename MT>
int launch_mma(SelectArgs a, const float* msq, float w0, float w1,
               float* cr, float* cq, void* qb, float* vals, int* rows, float* pv,
               int* pr, int smem, cudaStream_t stream) {
  constexpr int KC = SCH / (int)sizeof(MT);
  const int nc = (a.d + KC - 1) / KC;
  using R = Ring<MT>;
  const bool bf = sizeof(MT) == 2;
  const int need =
      1024 + a.S * SQ * (nc * SCH + R::QPAD) + R::NST * R::STB;
  const int tiles = (a.N + a.block_n - 1) / a.block_n;
  if (smem < need || a.bins % SR || a.d % 16 || a.P < 1 || a.per_a < 1 ||
      (long long)a.P * a.per_a < a.bin_size ||
      (long long)(a.P - 1) * a.per_a >= a.bin_size)
    return (int)cudaErrorInvalidValue;
  const int n_pad = tiles * a.block_n;
  if (bf && qb == nullptr) return (int)cudaErrorInvalidValue;
  select_prep<<<(n_pad + 255) / 256, 256, 0, stream>>>(
      a.q, msq, w0, w1, cr, cq, bf ? static_cast<__nv_bfloat16*>(qb) : nullptr,
      a.S, a.Q, a.N, a.d, nc * KC, n_pad);
  a.qb = qb;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto kernel = distance_select_mma<MT>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  a.cr = cr;
  a.cq = cq;
  a.vals = a.P > 1 ? pv : vals;
  a.rows = a.P > 1 ? pr : rows;
  const int q_tiles = (a.Q + SQ - 1) / SQ;
  const long long units = (long long)q_tiles * a.P * a.groups * tiles;
  kernel<<<(unsigned)units, 256, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (a.P > 1) {
    const size_t n = (size_t)a.Q * a.C;
    select_combine<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        pv, pr, vals, rows, a.P, n);
    err = cudaGetLastError();
  }
  return (int)err;
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

// The `mma` variant: bins = block_n / bin_size a multiple of 64, d a multiple
// of 16, all pointers 16-byte aligned.  a_splits ranges of per_a values of
// `a` per bin (a_splits > 1 needs the partial buffers pv, pr [a_splits, Q,
// C]); cr [ceil(N / block_n) * block_n], cq [Q] and, for a bf16 index, qb
// [S, Q, d rounded up to 64] bf16 are scratch.  The plan
// (a_splits, per_a, shared memory bytes) comes from the caller; what the
// kernel cannot run is refused with an error code.
extern "C" int vfr_distance_select_mma(
    const float* q, const void* m, const float* msq, float w0, float w1,
    int S, int Q, int N, int d, int bin_size, int block_n, int m_bf16,
    int a_splits, int per_a, int smem, float* cr, float* cq, void* qb,
    float* pv, int* pr, float* vals, int* rows, void* stream) {
  if (S < 1 || S > 2 || Q <= 0 || N <= 0 || bin_size < 1 ||
      block_n % bin_size)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(cr) |
       reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(qb) |
       reinterpret_cast<uintptr_t>(vals) | reinterpret_cast<uintptr_t>(rows) |
       reinterpret_cast<uintptr_t>(pv) | reinterpret_cast<uintptr_t>(pr)) % 16)
    return (int)cudaErrorMisalignedAddress;
  SelectArgs a = {};
  a.q = q;
  a.m = m;
  a.S = S; a.Q = Q; a.N = N; a.d = d;
  a.bin_size = bin_size;
  a.block_n = block_n;
  a.bins = block_n / bin_size;
  a.groups = a.bins / SR;
  a.C = (N + block_n - 1) / block_n * a.bins;
  a.P = a_splits;
  a.per_a = per_a;
  // the stream with the smaller |w| first, so that |ratio| <= 1
  a.first = (S == 2 && fabsf(w0) > fabsf(w1)) ? 1 : 0;
  const float w_first = S == 1 ? 0.0f : (a.first == 0 ? w0 : w1);
  const float w_second = S == 1 ? w0 : (a.first == 0 ? w1 : w0);
  a.ratio = w_second != 0.0f ? w_first / w_second : 0.0f;
  a.scale = -2.0f * w_second;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return m_bf16 ? launch_mma<__nv_bfloat16>(a, msq, w0, w1, cr, cq, qb, vals,
                                            rows, pv, pr, smem, s)
                : launch_mma<float>(a, msq, w0, w1, cr, cq, qb, vals, rows,
                                    pv, pr, smem, s);
}
