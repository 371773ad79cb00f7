// Pieces shared by the query-recurrence kernels (lstm_recurrence.cu, K1;
// gru_recurrence.cu, K3).  Included by each kernel source (each is its own
// shared library), never compiled alone; kernels/build.py hashes it into
// every library's name.
//
// 1. The `persistent` variant (bf16 weights): rnn_persistent<Cell, ...>, one
//    cooperative launch per layer that walks all T steps.  By the roofline a
//    recurrence is bound by the tensor cores, but 2*B*4H*H flops per step is
//    ~2 us of the bf16 peak; what a step really costs is what it fetches
//    again and how often the grid is launched: the step-per-launch design
//    re-read W_hh from L2 for every step and every batch-row block (~80 MB
//    per step) and paid a launch per step.  Here a block owns 16 hidden
//    units x all gates x one batch group of 64 or 128 rows and keeps, for
//    the whole sequence,
//      - its [H x 16*G] slice of W_hh (and, when it fits, its [E x 16*G]
//        slice of W_ih: the `fused input` form, which removes the gx round
//        trip through device memory) in shared memory, re-tiled once into
//        K-major rows with the 128-byte swizzle that wgmma reads;
//      - c, the f32 h carry and the pooled sum of its cells in registers.
//    Per step a block reads only the bf16 h tile of its batch group
//    (cp.async.cg through a ring of 64-deep chunks, so L1 never serves a
//    stale h), multiplies with wgmma m64n(16*G)k16 (bf16 x bf16 -> f32,
//    sums in registers) and updates its cells on the accumulator registers:
//    columns are laid out gate-major in groups of 16, so a thread owns all
//    gates of its cells and no staging tile is needed.  Steps are separated
//    by one grid-wide barrier (a monotone counter in device memory: arrive
//    with red.release after the h stores, spin with ld.acquire before the
//    next h loads; the launch is cooperative, so all blocks are
//    co-resident); h_t goes to buffer (t+1) % 2.  Between arrive and wait
//    a warpgroup computes the input part of the next step (or fetches its
//    gx), which does not depend on h.  Each warpgroup owns one 64-row tile
//    and each of its warps the ring rows its quarter of the wgmma reads, so
//    the ring needs no block barrier, and a tile with no live row at step t
//    skips its loads and products.  This split (u = 16, one block per SM)
//    was taken over u = 8 x full batch (twice the h traffic) and over
//    clusters with multicast: measured on the card, L2 is not what bounds
//    a step.  With 8 warps on an SM the product loop is bound by
//    instruction issue, so it is kept to a few dozen instructions per
//    chunk, and the gates use ex2.approx / rcp.approx.
// 2. The `stepwise` variant's shared pieces: the hoisted input product gx =
//    round(x) @ W_ih + bias over all B*T rows, as tiled f32 FMAs (f32
//    weights) or as WMMA 16x16x16 bf16 -> f32 fragments fed by a 3-stage
//    cp.async pipeline (bf16 weights), and the cp.async helpers.  The
//    persistent variant uses the same input product when W_ih's slice does
//    not fit beside W_hh's.
// The cp.async helpers, the shared-memory descriptor and the wgmma fences
// come from mma_common.cuh, which every kernel source of the port shares.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// The persistent variant's gate functions: ex2.approx and rcp.approx, a few
// instructions each (absolute error ~1e-6) where tanhf and the exact
// division cost the 256-thread block ~1.6 us per step.
__device__ __forceinline__ float fast_sigmoid(float v) {
  return __fdividef(1.0f, 1.0f + __expf(-v));
}
__device__ __forceinline__ float fast_tanh(float v) {
  return 1.0f - 2.0f * __fdividef(1.0f, 1.0f + __expf(2.0f * v));
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


// ---------------------------------------------------------------------------
// The persistent variant (bf16 weights).  See the header note.

constexpr int PU = 16;            // hidden units per block
constexpr int PKC = 64;           // depth of one chunk: a 128-byte row
constexpr int PTILE = 64 * 128;   // bytes of one ring stage: 64 rows
constexpr int PSTAGES = 3;        // ring stages of one warpgroup (6 measured
                                  // no faster: the ring is not the limit)

struct PersistentArgs {
  const float* gx;        // [B*T, G*H] f32, x W_ih + b_ih (unfused input)
  const Bf16* xb;         // [B*T, Ep] bf16, zero padded   (fused input)
  const Bf16* w_ih;       // [E, G*H]
  const Bf16* w_hh;       // [H, G*H]
  const float* b_ih;      // [G*H] (the LSTM's single bias)
  const float* b_hh;      // [G*H], null for the LSTM
  const int* lengths;     // [B]
  Bf16* hb;               // [2, B, H] scratch
  float* hs;              // [B, T, H] (hs mode)
  float* h_last;          // [B, H]
  float* pooled;          // [B, H] (pool mode)
  unsigned* counter;      // zeroed: the grid barrier
  int B, T, E, Ep, H;
  int pool;               // 1: pooled mode (fused mean), 0: hs mode
  long long* timeline;    // null, or [T, 5] %globaltimer stamps (see stamp)
};

// Where a step's time goes, without a profiler: thread 0 of block (0, 0)
// writes the nanosecond timer after (0) the barrier wait, (1) the recurrent
// product, (2) the cell update, (3) the h stores and the barrier arrive,
// (4) the next step's input part.  Off (one predictable branch) when
// `timeline` is null.
__device__ __forceinline__ void stamp(const PersistentArgs& p, int t,
                                      int slot) {
  if (p.timeline != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
      threadIdx.x == 0) {
    long long now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    p.timeline[t * 5 + slot] = now;
  }
}


__device__ __forceinline__ void group_sync(int id) {   // one warpgroup
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// D[64 x N] += A[64 x 16] * B[16 x N], A and B from shared memory.
__device__ __forceinline__ void wgmma_k16(float (&d)[32], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_k16(float (&d)[24], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(1)
      : "memory");
}

__device__ __forceinline__ void grid_arrive(unsigned* counter) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(counter),
               "r"(1u)
               : "memory");
}

// Spin until `target` arrivals.  The launch is cooperative, so every block
// is resident; a wait of about a second means a fault and traps.
__device__ __forceinline__ void grid_wait(const unsigned* counter,
                                          unsigned target) {
  const long long t0 = clock64();
  while (true) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                 : "=r"(v) : "l"(counter) : "memory");
    if (v >= target) return;
    if (clock64() - t0 > 2000000000LL) __trap();
  }
}

// acc += A @ W over `nk` chunks for one warpgroup.  A thread copies, per
// chunk, 16 bytes of each of its four loader rows: src[pp] points at the
// row's first piece of this thread (null where the row is past B), of
// which the first `nvalid` chunks lie inside the row; dst[pp] is the
// piece's swizzled offset inside a stage.  W's chunks start at `wsm`.  A
// warp loads exactly the 16 tile rows its quarter of the wgmma reads, so
// the ring needs no barrier across warps: a warp waits for its own copies,
// issues chunk kc's wgmmas, and only then waits for chunk kc-1's to free a
// stage, which keeps the tensor cores fed across chunks.  The loop is kept
// to a few dozen instructions per chunk (running pointers, stage and
// descriptor offsets): with 8 warps on an SM it is issue-bound otherwise.
template <int NR>
__device__ __forceinline__ void chunk_product(
    float (&acc)[NR], const Bf16* const (&src)[4], const void* dummy,
    int nvalid, int nk, uint32_t ring, const uint32_t (&dst)[4],
    uint32_t wsm) {
  constexpr uint32_t WCH = NR * 2 * 128;       // bytes of one W chunk
  auto load = [&](uint32_t stage_base, int kc) {
    const bool in_row = kc < nvalid;
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) {
      const bool ok = in_row && src[pp] != nullptr;
      cp_async16_s(stage_base + dst[pp],
                   ok ? (const void*)(src[pp] + kc * PKC) : dummy, ok);
    }
  };
#pragma unroll
  for (int st = 0; st < PSTAGES - 1; ++st) {
    if (st < nk) load(ring + st * PTILE, st);
    cp_async_commit();
  }
  uint64_t da = smem_desc(ring), db = smem_desc(wsm);
  int mm = 0, ld = PSTAGES - 1;                // stages of chunk kc, kc+S-1
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<PSTAGES - 2>();          // this lane's part of chunk kc
    fence_async_smem();
    __syncwarp();                          // ... and the warp's 16 rows
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < PKC / 16; ++j) wgmma_k16(acc, da + 2 * j, db + 2 * j);
    wgmma_commit();
    wgmma_wait<1>();                       // chunk kc-1 has read its stage
    if (kc + PSTAGES - 1 < nk) load(ring + ld * PTILE, kc + PSTAGES - 1);
    cp_async_commit();
    db += WCH >> 4;
    if (++mm == PSTAGES) { mm = 0; da -= (PSTAGES - 1) * (PTILE >> 4); }
    else da += PTILE >> 4;
    if (++ld == PSTAGES) ld = 0;
  }
  cp_async_wait<0>();
  wgmma_wait<0>();
}

// One layer, all T steps.  Grid (ceil(H/16), ceil(B/(64*NWG))), 128*NWG
// threads, launched cooperatively.  Cell gives G and the gate math.
template <class Cell, bool FUSE, int NWG>
__global__ void __launch_bounds__(128 * NWG, 1)
rnn_persistent(const PersistentArgs p) {
  constexpr int G = Cell::G;
  constexpr int N = PU * G;
  constexpr int NR = 8 * G;                    // accumulator registers
  constexpr uint32_t WCH = N * 128;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t wsm = (raw + 1023u) & ~1023u;
  unsigned char* wptr = smem_raw + (wsm - raw);
  const int B = p.B, T = p.T, H = p.H;
  const size_t GH = (size_t)G * H;
  const int nkx = FUSE ? p.Ep / PKC : 0;
  const int nkh = (H + PKC - 1) / PKC;
  const int j0 = blockIdx.x * PU;
  const int wg = threadIdx.x / 128, wt = threadIdx.x % 128;
  const int row0 = (blockIdx.y * NWG + wg) * 64;
  const uint32_t ring = wsm + (nkx + nkh) * WCH + wg * PSTAGES * PTILE;
  const bool pool = p.pool != 0;

  // The block's slices of W_ih (fused input) and W_hh, once: element (n, k)
  // of chunk c at c*WCH + n*128 + (((k/8) ^ (n%8)) * 16) + (k%8)*2, with
  // n = 16*gate + unit.  A thread reads 8 units of 8 consecutive k (8 loads
  // of 16 bytes), transposes them in registers and stores, per unit, the 16
  // bytes of its 8 k: one swizzled piece.
  constexpr int NG = N / 8;
  for (int i = threadIdx.x; i < (nkx + nkh) * 8 * NG; i += 128 * NWG) {
    const int kg = i / NG, n8 = i % NG;
    const int chunk = kg / 8, piece = kg % 8;
    const int g = n8 / 2, j = j0 + (n8 % 2) * 8;
    uint4 v[8];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int k = kg * 8 + kk;               // over [x chunks | h chunks]
      v[kk] = make_uint4(0u, 0u, 0u, 0u);
      if (j < H) {
        if (chunk < nkx) {
          if (k < p.E)
            v[kk] = __ldg(reinterpret_cast<const uint4*>(p.w_ih + k * GH +
                                                         g * H + j));
        } else if (k - nkx * PKC < H) {
          v[kk] = __ldg(reinterpret_cast<const uint4*>(
              p.w_hh + (k - nkx * PKC) * GH + g * H + j));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      uint32_t o[4];
#pragma unroll
      for (int h2 = 0; h2 < 4; ++h2) {
        const uint32_t lo = reinterpret_cast<const uint16_t*>(&v[2 * h2])[u];
        const uint32_t hi =
            reinterpret_cast<const uint16_t*>(&v[2 * h2 + 1])[u];
        o[h2] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(wptr + chunk * WCH + (n8 * 8 + u) * 128 +
                                ((piece ^ u) << 4)) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
  fence_async_smem();
  __syncthreads();

  // This thread's cells: rows r[rr] (rr = 0, 1), units j0 + 8*jj + 2*q + e.
  // Gate g of cell (jj, rr, e) is accumulator register 4*(2g+jj) + 2*rr + e.
  const int lane = wt % 32, q = lane % 4;
  int orow[2], len[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row0 + 16 * (wt / 32) + lane / 4 + 8 * rr;
    orow[rr] = r < B ? r : -1;
    len[rr] = r < B ? min(max(p.lengths[r], 0), T) : 0;
  }
  // the tile's longest row: past it the whole tile is dead and skips its
  // products (a batch tail padded with short rows, a bucket of short ones)
  int tile_len = max(len[0], len[1]);
#pragma unroll
  for (int o = 16; o > 0; o /= 2)
    tile_len = max(tile_len, __shfl_xor_sync(0xffffffffu, tile_len, o));
  int* s_len = reinterpret_cast<int*>(wptr + (nkx + nkh) * WCH);   // the ring
  if (lane == 0) s_len[threadIdx.x / 32] = tile_len;
  __syncthreads();
  tile_len = max(max(s_len[4 * wg], s_len[4 * wg + 1]),
                 max(s_len[4 * wg + 2], s_len[4 * wg + 3]));
  __syncthreads();          // s_len is read; the ring may be written
  bool unit_ok[2];
  float bi[G][2][2], bh[G][2][2];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int j = j0 + 8 * jj + 2 * q;
    unit_ok[jj] = j < H;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        bi[g][jj][e] = (FUSE && unit_ok[jj]) ? p.b_ih[g * H + j + e] : 0.0f;
        bh[g][jj][e] = (p.b_hh != nullptr && unit_ok[jj])
                           ? p.b_hh[g * H + j + e] : 0.0f;
      }
  }
  // loader rows of this thread: tile rows 16*warp + lane/8 + 4*pp (its own
  // warp's quarter of the tile), of which it copies piece lane % 8 of every
  // chunk to the swizzled offset ldst[pp] of a stage
  const int piece = lane % 8;
  int lrow[4];
  uint32_t ldst[4];
#pragma unroll
  for (int pp = 0; pp < 4; ++pp) {
    const int tr = 16 * (wt / 32) + lane / 8 + 4 * pp;
    lrow[pp] = row0 + tr < B ? row0 + tr : -1;
    ldst[pp] = tr * 128 + ((piece ^ (tr & 7)) << 4);
  }
  // chunks of a row of H (of Ep) elements that hold this thread's piece
  const int nvalid_h = (H - piece * 8 + PKC - 1) / PKC;
  const int nvalid_x = (p.Ep - piece * 8 + PKC - 1) / PKC;

  float gi[NR], acc[NR];
  float h[8], c[8], sum[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = c[i] = sum[i] = 0.0f;

  // The input part of step t into gi: x_t W_ih + b_ih.
  auto input_part = [&](int t) {
    if (FUSE) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              gi[4 * (2 * g + jj) + 2 * rr + e] = bi[g][jj][e];
      const Bf16* rows[4];
#pragma unroll
      for (int pp = 0; pp < 4; ++pp)
        rows[pp] = lrow[pp] < 0
                       ? nullptr
                       : p.xb + ((size_t)lrow[pp] * T + t) * p.Ep + piece * 8;
      chunk_product<NR>(gi, rows, p.w_hh, nvalid_x, nkx, ring, ldst, wsm);
    } else {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float* g_row =
            p.gx + ((size_t)max(orow[rr], 0) * T + t) * GH;
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            float2 v = make_float2(0.0f, 0.0f);
            if (orow[rr] >= 0 && unit_ok[jj])
              v = *reinterpret_cast<const float2*>(g_row + g * H + j0 +
                                                   8 * jj + 2 * q);
            gi[4 * (2 * g + jj) + 2 * rr] = v.x;
            gi[4 * (2 * g + jj) + 2 * rr + 1] = v.y;
          }
      }
    }
  };

  const unsigned per_step = gridDim.x * gridDim.y * NWG;
  if (tile_len > 0) input_part(0);
  for (int t = 0; t < T; ++t) {
    if (t > 0) {
      if (wt == 0) grid_wait(p.counter, per_step * (unsigned)t);
      group_sync(wg + 1);
    }
    stamp(p, t, 0);
    if (tile_len > t) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              acc[4 * (2 * g + jj) + 2 * rr + e] = bh[g][jj][e];
      if (t > 0) {               // h_{-1} = 0: no product at step 0
        const Bf16* hprev = p.hb + (size_t)(t % 2) * B * H;
        const Bf16* rows[4];
#pragma unroll
        for (int pp = 0; pp < 4; ++pp)
          rows[pp] = lrow[pp] < 0
                         ? nullptr
                         : hprev + (size_t)lrow[pp] * H + piece * 8;
        chunk_product<NR>(acc, rows, p.w_hh, nvalid_h, nkh, ring, ldst,
                          wsm + nkx * WCH);
      }
      stamp(p, t, 1);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ci = 4 * jj + 2 * rr + e;
            float a[G], b[G];
#pragma unroll
            for (int g = 0; g < G; ++g) {
              a[g] = gi[4 * (2 * g + jj) + 2 * rr + e];
              b[g] = acc[4 * (2 * g + jj) + 2 * rr + e];
            }
            float c_new = c[ci];
            const float h_new = Cell::update(a, b, h[ci], c_new);
            const bool live = t < len[rr];
            h[ci] = live ? h_new : h[ci];
            c[ci] = live ? c_new : c[ci];
            sum[ci] += live ? h[ci] : 0.0f;
          }
    }
    stamp(p, t, 2);
    // h_t for the other blocks' next product, and hs
    Bf16* hnext = p.hb + (size_t)((t + 1) % 2) * B * H;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (orow[rr] < 0) continue;
      const int r = row0 + 16 * (wt / 32) + lane / 4 + 8 * rr;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        if (!unit_ok[jj]) continue;
        const int j = j0 + 8 * jj + 2 * q;
        const float h0 = h[4 * jj + 2 * rr], h1 = h[4 * jj + 2 * rr + 1];
        if (t + 1 < T)
          *reinterpret_cast<__nv_bfloat162*>(hnext + (size_t)r * H + j) =
              __floats2bfloat162_rn(h0, h1);
        if (!pool)
          *reinterpret_cast<float2*>(
              p.hs + ((size_t)orow[rr] * T + t) * H + j) = make_float2(h0, h1);
      }
    }
    if (t + 1 < T) {
      group_sync(wg + 1);
      if (wt == 0) grid_arrive(p.counter);
      stamp(p, t, 3);
      if (tile_len > t + 1) input_part(t + 1);
      stamp(p, t, 4);
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (orow[rr] < 0) continue;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      if (!unit_ok[jj]) continue;
      const size_t o = (size_t)orow[rr] * H + j0 + 8 * jj + 2 * q;
      const float h0 = h[4 * jj + 2 * rr], h1 = h[4 * jj + 2 * rr + 1];
      *reinterpret_cast<float2*>(p.h_last + o) = make_float2(h0, h1);
      if (pool) {
        const float inv = 1.0f / fmaxf((float)len[rr], 1.0f);
        *reinterpret_cast<float2*>(p.pooled + o) = make_float2(
            sum[4 * jj + 2 * rr] * inv, sum[4 * jj + 2 * rr + 1] * inv);
      }
    }
  }
}

// Host side of one persistent layer: the input's bf16 copy (fused input)
// or the hoisted input product, then one cooperative launch.  The plan
// (nwg, fuse, grid, smem) comes from the caller; what the device
// cannot run is refused with an error code, never rerouted.
template <class Cell>
int launch_persistent(const float* x, PersistentArgs a, Bf16* xb, float* gx,
                      int nwg, int fuse, int grid_x, int grid_y, int smem,
                      cudaStream_t stream) {
  using Kernel = void (*)(const PersistentArgs);
  Kernel table[2][2] = {
      {rnn_persistent<Cell, false, 1>, rnn_persistent<Cell, false, 2>},
      {rnn_persistent<Cell, true, 1>, rnn_persistent<Cell, true, 2>}};
  const size_t need =
      1024 +
      ((size_t)(a.H + PKC - 1) / PKC * PKC + (fuse ? a.Ep : 0)) * PU *
          Cell::G * 2 +
      (size_t)nwg * PSTAGES * PTILE;
  if (a.H % 8 != 0 || nwg < 1 || nwg > 2 || (size_t)smem < need ||
      grid_x != (a.H + PU - 1) / PU ||
      grid_y != (a.B + 64 * nwg - 1) / (64 * nwg))
    return (int)cudaErrorInvalidValue;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  Kernel kernel = table[fuse ? 1 : 0][nwg - 1];
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, reinterpret_cast<const void*>(kernel), 128 * nwg, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm * sms < grid_x * grid_y)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  const int M = a.B * a.T;
  if (fuse) {
    to_bf16_padded<<<1024, 256, 0, stream>>>(x, xb, M, a.E, a.Ep);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    a.xb = xb;
  } else {
    const int perr = input_product(x, a.w_ih, a.b_ih, xb, gx, M,
                                   Cell::G * a.H, a.E, true, stream);
    if (perr != 0) return perr;
    a.gx = gx;
  }
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(grid_x, grid_y), dim3(128 * nwg),
                                    params, (size_t)smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
