// The f32 score product C[Q, N] = A[Q, K] . M[N, K]^T (queries against the
// stream-concatenated index rows), every product in 3 x TF32 split
// arithmetic on the tensor cores, Hopper sm_90a.
//
// Replaces: no Pallas kernel.  The JAX package leaves the score to XLA's dot
// (vfr_tpu/parallel/sharding.py::fused_corpus_scores); on the card the port
// ran it as cuBLAS's f32 SIMT GEMM (FFMA, no tensor core), the largest
// single cost of an f32 serving batch.  This kernel is that product, and
// nothing else: the `- msq` pass stays the next kernel.
//
// What bounds it on this card: operations.  At the flagship batch (Q = 256,
// N = 210,000, K = 2 x 128) it does 2 Q N K = 27.5 GFLOP; at f32 accuracy
// the tensor cores give that as three TF32 products, 82.6 GFLOP at 495
// TFLOP/s = 0.167 ms.  The bytes (215 MB of index read, 215 MB of scores
// written) take 0.129 ms at 3.35 TB/s and overlap the products.
//
// How the design approaches the bound, and keeps f32 accuracy:
//   * Split arithmetic.  Each operand is x = hi + lo: hi is x as the tensor
//     core reads it (the low 13 mantissa bits ignored, i.e. truncated); lo
//     = x - hi, rounded to TF32 so that the tensor core's own truncation of
//     lo loses nothing more.  Each k-step multiplies lo.hi + hi.lo +
//     hi.hi; only lo.lo (at most 2^-20 of a product) is dropped.  (hi
//     rounded to nearest instead cut the worst error by 3-18% on an H100
//     at no measurable cost; the accumulators' truncation, below, weighs
//     more, so hi stays the bits the core reads, with no rewrite.)
//   * The tensor cores truncate each sum they accumulate.  Into one f32
//     accumulator over K = 256 (96 steps of the same sign) that bias grows
//     to 3.7-12.6x torch.matmul's f32 rounding (measured on an H100).  So
//     each stage's products (24 steps in the wide tile below, 12 in a
//     pack's) go into a fresh accumulator, added to a running sum in
//     registers, rounded to nearest: the partial sums are smaller and of
//     either sign, and the worst error stays within 0.4-2.4x torch.matmul's
//     (the larger at a few queries, whose library product sums very
//     accurately).  Two accumulators instead, or one read while the next
//     stage's products ran, made ptxas serialize every wgmma.
//   * Two tile shapes, picked by the host's plan from Q.
//     `wide` (Q > 64): 128 queries against 64 index rows a tile, each
//     consumer warpgroup 64 of the queries as the A operand from registers
//     (each thread its raw f32 fragments of all of K: 128 registers, hi
//     the raw bits, lo split per k-step; no loads in the loop) against the
//     rows as the B operand, K-major from shared memory (m's rows are
//     K-contiguous, the layout wgmma wants for TF32); the index is read
//     once per 128 queries.  ptxas still runs each warpgroup's wgmmas one
//     at a time there, short of registers; the two warpgroups overlap.
//     `pack` (Q <= 16 or <= 64, a daemon's pack): transposed, 128 index
//     rows a tile, each warpgroup 64 of them as A (read from the ring into
//     registers and split there) against the pack's queries as B (n = 16
//     or 64; hi and lo tiles resident in shared memory): no lo pass over
//     the index, and the padded queries cost no tensor time.
//   * The index rows stream through a ring of 128-byte-swizzled stages (the
//     layout the descriptors read) filled by a producer warpgroup with
//     cp.async (16 bytes a thread).  It lags LAG stages behind its own
//     copies, then (wide) writes lo of the bytes each thread copied, fences
//     them to the tensor cores' proxy and arrives on the stage's `full`
//     mbarrier; the two consumer warpgroups wait on it and release the
//     stage on its `empty` mbarrier once its rows are used.  Registers move
//     to the consumers (setmaxnreg).  No lo copy of the index exists in
//     device memory.
//   * Persistent blocks over (query tile, row tile) units, in an order that
//     has the blocks of one row tile run at once (the second read of a tile
//     comes from L2); the epilogue stores each warp's sums straight to C,
//     8 rows x 32 contiguous bytes a store instruction, evict-first (the
//     scores do not fit L2 and must not push the index out), while the
//     producer already fills the next tile's stages.
//
// One launch per product; no reduction pass follows it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr int KCH = 32;                    // K values of a chunk (128 bytes)
constexpr int K_MAX = 256;                 // the query registers: 8 chunks
constexpr int LAG = 3;                     // a producer's copies in flight
constexpr int CONSUMER_WARPS = 8;          // two warpgroups, warps 0-7
constexpr int PRODUCERS = 128;             // a warpgroup, warps 8-11
constexpr int THREADS = 32 * CONSUMER_WARPS + PRODUCERS;
constexpr int PASS_ROWS = PRODUCERS / 8;   // rows a pass of the producers

// The wide tile: QT queries against SR index rows; a stage holds CPS
// chunks (32 K values each) of the SR rows, raw tiles then their lo tiles.
// Each consumer warpgroup holds 64 of the queries for all of K (KQ k-steps
// of A fragments) and multiplies them against the SR rows (n = SR).
struct Wide {
  static constexpr int QT = 128;
  static constexpr int SR = 64;
  static constexpr int CPS = 2;
  static constexpr int KQ = 32;
  static constexpr int ACC = SR / 2;             // accumulator registers
  static constexpr int NST = 6;                  // ring stages
  static constexpr bool LO = true;               // the ring holds lo tiles
  static constexpr int CHUNK_B = SR * 128;       // one chunk's tile
  static constexpr int STAGE_B = 2 * CPS * CHUNK_B;
  static constexpr int SMEM = 1024 + NST * STAGE_B + 2 * NST * 8;
};

// A pack of at most NQ queries (16 or 64), transposed: 128 index rows a
// tile, each consumer warpgroup 64 of them as the A operand (m64, loaded
// from the ring's raw rows into registers and split there), the queries'
// hi and lo tiles as the B operand (n = NQ), resident in shared memory.
// The ring holds raw rows only: the producer copies and nothing more.
template <int NQ>
struct Pack {
  static constexpr int SR = 128;
  static constexpr int CPS = 1;
  static constexpr int NST = NQ == 16 ? 12 : 6;
  static constexpr bool LO = false;
  static constexpr int CHUNK_B = SR * 128;
  static constexpr int STAGE_B = CHUNK_B;
  static constexpr int QCH_B = NQ * 128;         // a chunk of the query tile
  static constexpr int QUERY_B = 2 * (K_MAX / KCH) * QCH_B;   // hi | lo
  static constexpr int SMEM = 1024 + NST * STAGE_B + QUERY_B + 2 * NST * 8;
};

struct ScoreArgs {
  const float* a;      // [Q, K] queries, row stride lda
  const float* m;      // [N, K] index rows, row stride ldm (16-byte rows)
  float* c;            // [Q, N] scores, row stride ldc
  int lda, ldm, ldc;
  int Q, N, K;
  int chunks;          // ceil(K / 32)
  int q_tiles, units;  // units = q_tiles * ceil(N / SR)
  int vec2;            // ldc even: float2 stores
};

// lo of x against hi = x truncated to TF32 (as the tensor core reads x),
// rounded to TF32 to nearest, ties away from zero (cvt.rna's value for
// finite x, in two integer operations instead of its emulation)
__device__ __forceinline__ uint32_t lo_of(uint32_t x) {
  const float lo = __uint_as_float(x) - __uint_as_float(x & 0xffffe000u);
  return (__float_as_uint(lo) + 0x1000u) & 0xffffe000u;
}

// the registers r as the compiler sees them: no use of them is moved above
// this point, nor any write below it
template <int N>
__device__ __forceinline__ void fence_operand(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// the 256 consumer threads (named barrier 1)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// D[64 x 16] (+)= A[64 x 8 tf32] * B, as mma_common.cuh's wgmma_tf32_ra
// (n64): d[4j + 2rr + e] = D[16w + g + 8rr][8j + 2t + e], j < 2.
__device__ __forceinline__ void wgmma_tf32_ra_n16(float (&d)[8],
                                                  const uint32_t* a,
                                                  uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate)
      : "memory");
}

// n = 2 ACC
template <int ACC>
__device__ __forceinline__ void wgmma_tf32(float (&d)[ACC],
                                           const uint32_t* a, uint64_t b,
                                           int accumulate) {
  if constexpr (ACC == 32)
    wgmma_tf32_ra(d, a, b, accumulate);
  else
    wgmma_tf32_ra_n16(d, a, b, accumulate);
}

// The producer warpgroup.  Stage it of the ring holds the CPS chunks of
// K from chunk CPS * (it % stages) on of the rows of the block's unit
// it / stages.  Thread tid copies 16-byte piece tid % 8 of rows tid / 8 +
// PASS_ROWS j of each chunk, swizzled as the descriptor reads them, and
// later (S::LO) writes lo of the same bytes.
template <class S>
__device__ __forceinline__ void produce(const ScoreArgs& p, uint32_t ring,
                                        unsigned char* ringp, uint32_t full0,
                                        uint32_t empty0, int tid) {
  constexpr int J = S::SR / PASS_ROWS;
  const int piece = tid % 8, r0 = tid / 8;
  const uint32_t soff = r0 * 128 + ((piece ^ (r0 & 7)) << 4);
  const int stages = (p.chunks + S::CPS - 1) / S::CPS;
  int s = 0, ph = 0;        // stage and phase of the next copy
  int fs = 0;               // stage of the oldest copy not yet finished
  int pending = 0;          // copies issued, not yet finished
  auto finish = [&]() {     // (lo of) the oldest stage; it is then full
#pragma unroll
    for (int c = 0; c < S::CPS; ++c)
#pragma unroll
      for (int j = 0; j < (S::LO ? J : 0); ++j) {
        unsigned char* at = ringp + fs * S::STAGE_B + c * S::CHUNK_B + soff +
                            j * PASS_ROWS * 128;
        const float4 x = *reinterpret_cast<const float4*>(at);
        *reinterpret_cast<float4*>(at + S::CPS * S::CHUNK_B) =
            make_float4(__uint_as_float(lo_of(__float_as_uint(x.x))),
                        __uint_as_float(lo_of(__float_as_uint(x.y))),
                        __uint_as_float(lo_of(__float_as_uint(x.z))),
                        __uint_as_float(lo_of(__float_as_uint(x.w))));
      }
    fence_async_smem();     // this thread's copies and stores -> wgmma
    mbar_arrive(full0 + 8 * fs);
    if (++fs == S::NST) fs = 0;
    --pending;
  };
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const long long n0 = (long long)(u / p.q_tiles) * S::SR;
    for (int st = 0; st < stages; ++st) {
      mbar_wait(empty0 + 8 * s, ph ^ 1);
#pragma unroll
      for (int c = 0; c < S::CPS; ++c) {
        const int k = (st * S::CPS + c) * KCH + piece * 4;
        const bool k_ok = k < p.K;
        const uint32_t dst = ring + s * S::STAGE_B + c * S::CHUNK_B + soff;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const long long r = n0 + r0 + PASS_ROWS * j;
          const bool ok = k_ok && r < p.N;
          cp_async16_s(dst + j * PASS_ROWS * 128,
                       ok ? (const void*)(p.m + r * p.ldm + k)
                          : (const void*)p.m,
                       ok);
        }
      }
      cp_async_commit();
      if (++s == S::NST) { s = 0; ph ^= 1; }
      if (++pending > LAG) {
        cp_async_wait<LAG>();
        finish();
      }
    }
  }
  cp_async_wait<0>();
  while (pending > 0) finish();
}

// A wide tile's consumer warpgroup (cw = 0, 1): queries 64 cw .. 64 cw + 63
// of the tile.  Each stage's products (small terms first) go into a fresh
// f32 accumulator of the tensor cores, then into the running sum, rounded
// to nearest.
__device__ __forceinline__ void consume_wide(const ScoreArgs& p,
                                             uint32_t ring, uint32_t full0,
                                             uint32_t empty0, int cw,
                                             int tid) {
  using S = Wide;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int arow = 64 * cw + 16 * warp + g;      // and arow + 8
  const int stages = (p.chunks + S::CPS - 1) / S::CPS;
  uint32_t qa[S::KQ][4];   // raw query fragments: hi as the core reads them
  float acc[S::ACC], sum[S::ACC];
#pragma unroll
  for (int i = 0; i < S::ACC; ++i) acc[i] = sum[i] = 0.0f;
  int cur_qt = -1;
  int s = 0, ph = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const int qt = u % p.q_tiles;
    const long long n0 = (long long)(u / p.q_tiles) * S::SR;
    if (qt != cur_qt) {    // the products of the last tile are all done
      cur_qt = qt;
#pragma unroll
      for (int kk = 0; kk < S::KQ; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = qt * S::QT + arow + 8 * (i % 2);
          const int k = 8 * kk + t + 4 * (i / 2);
          // a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]
          qa[kk][i] = (r < p.Q && k < p.K)
                          ? __float_as_uint(p.a[(long long)r * p.lda + k])
                          : 0u;
        }
    }
#pragma unroll
    for (int st = 0; st < K_MAX / KCH / S::CPS; ++st) {
      if (st >= stages) break;
      mbar_wait(full0 + 8 * s, ph);
#pragma unroll
      for (int c = 0; c < S::CPS; ++c) {
        const uint32_t tile = ring + s * S::STAGE_B + c * S::CHUNK_B;
        const uint64_t bh = smem_desc(tile);
        const uint64_t bl = smem_desc(tile + S::CPS * S::CHUNK_B);
        const int k0 = (st * S::CPS + c) * 4;    // this chunk's k-steps
        uint32_t al[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int e = 0; e < 4; ++e) al[ks][e] = lo_of(qa[k0 + ks][e]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {         // small terms first
          wgmma_tf32<S::ACC>(acc, al[ks], bh + 2 * ks, c > 0 || ks > 0);
          wgmma_tf32<S::ACC>(acc, qa[k0 + ks], bl + 2 * ks, 1);
          wgmma_tf32<S::ACC>(acc, qa[k0 + ks], bh + 2 * ks, 1);
        }
        wgmma_commit();
      }
      // the stage's products are done: into the sum, and release it
      wgmma_wait<0>();
      fence_operand(acc);
#pragma unroll
      for (int i = 0; i < S::ACC; ++i) sum[i] = st ? sum[i] + acc[i] : acc[i];
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
      if (++s == S::NST) { s = 0; ph ^= 1; }
    }

    // d[4 j + 2 rr + e] = D[arow + 8 rr][8 j + 2 t + e]
    const long long col0 = n0 + 2 * t;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int q = qt * S::QT + arow + 8 * rr;
      if (q >= p.Q) continue;
      float* crow = p.c + (long long)q * p.ldc;
#pragma unroll
      for (int j = 0; j < S::ACC / 4; ++j) {
        const int i = 4 * j + 2 * rr;
        const long long col = col0 + 8 * j;
        if (p.vec2 && col + 1 < p.N) {
          __stcs(reinterpret_cast<float2*>(crow + col),
                 make_float2(sum[i], sum[i + 1]));
        } else {
          if (col < p.N) __stcs(crow + col, sum[i]);
          if (col + 1 < p.N) __stcs(crow + col + 1, sum[i + 1]);
        }
      }
    }
  }
}

// A pack's consumer warpgroup (cw = 0, 1): index rows 64 cw .. 64 cw + 63
// of each 128-row tile against the pack's queries.  A thread reads its A
// fragments of a chunk as four 16-byte loads, rows R and R + 8 at pieces
// 2 t and 2 t + 1 (conflict-free in the swizzled rows); so the k-steps of
// a chunk take its K values in a permuted order, k = 32 c + 8 (j % 4) + 4
// (ks / 2) + 2 (ks % 2) + j / 4 for logical column j of k-step ks, and the
// query tiles are written in that order.
template <int NQ>
__device__ __forceinline__ void consume_pack(const ScoreArgs& p,
                                             const unsigned char* ringp,
                                             uint32_t qtile,
                                             unsigned char* qtilep,
                                             uint32_t full0, uint32_t empty0,
                                             int cw, int tid) {
  using S = Pack<NQ>;
  constexpr int ACC = NQ / 2;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = 64 * cw + 16 * warp + g;     // index rows row0, row0 + 8
  // the query tiles (hi: the raw bits, lo), the B operand's K-major rows
  // with the 128-byte swizzle, once: a pack is one query tile
  for (int i = threadIdx.x; i < NQ * K_MAX; i += 256) {
    const int r = i / K_MAX, k = i % K_MAX, w = k % KCH;
    const int ks = 2 * ((w / 4) % 2) + (w / 2) % 2, j = w / 8 + 4 * (w % 2);
    const int byte = ks * 32 + j * 4;
    const int off = (k / KCH) * S::QCH_B + r * 128 +
                    ((((byte >> 4) ^ (r & 7))) << 4) + (byte & 15);
    const uint32_t x = (r < p.Q && k < p.K)
                           ? __float_as_uint(p.a[(long long)r * p.lda + k])
                           : 0u;
    *reinterpret_cast<uint32_t*>(qtilep + off) = x;
    *reinterpret_cast<uint32_t*>(qtilep + S::QUERY_B / 2 + off) = lo_of(x);
  }
  fence_async_smem();
  consumers_sync();
  float acc[ACC], sum[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = sum[i] = 0.0f;
  int s = 0, ph = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const long long n0 = (long long)u * S::SR;
#pragma unroll
    for (int st = 0; st < K_MAX / KCH; ++st) {
      if (st >= p.chunks) break;
      mbar_wait(full0 + 8 * s, ph);
      const unsigned char* tile = ringp + s * S::STAGE_B;
      uint32_t x[2][2][4];                       // [b][rr]: k 8 t + 4 b + e
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int R = row0 + 8 * rr;
          const uint4 v = *reinterpret_cast<const uint4*>(
              tile + R * 128 + (((2 * t + b) ^ (R & 7)) << 4));
          x[b][rr][0] = v.x; x[b][rr][1] = v.y;
          x[b][rr][2] = v.z; x[b][rr][3] = v.w;
        }
      // the stage's rows are in registers: release it
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
      if (++s == S::NST) { s = 0; ph ^= 1; }
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int b = ks / 2, h = ks % 2;
        // a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]
        ah[ks][0] = x[b][0][2 * h];
        ah[ks][1] = x[b][1][2 * h];
        ah[ks][2] = x[b][0][2 * h + 1];
        ah[ks][3] = x[b][1][2 * h + 1];
#pragma unroll
        for (int e = 0; e < 4; ++e) al[ks][e] = lo_of(ah[ks][e]);
      }
      wgmma_fence();
      const uint64_t bh = smem_desc(qtile + st * S::QCH_B);
      const uint64_t bl = smem_desc(qtile + S::QUERY_B / 2 + st * S::QCH_B);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {           // small terms first
        wgmma_tf32<ACC>(acc, al[ks], bh + 2 * ks, ks > 0);
        wgmma_tf32<ACC>(acc, ah[ks], bl + 2 * ks, 1);
        wgmma_tf32<ACC>(acc, ah[ks], bh + 2 * ks, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(acc);
#pragma unroll
      for (int i = 0; i < ACC; ++i) sum[i] = st ? sum[i] + acc[i] : acc[i];
    }
    // d[4 j + 2 rr + e] = D[row0 + 8 rr][8 j + 2 t + e]: index row, query
#pragma unroll
    for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 8 * j + 2 * t + e;
        if (q >= p.Q) continue;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const long long col = n0 + row0 + 8 * rr;
          if (col < p.N)
            __stcs(p.c + (long long)q * p.ldc + col, sum[4 * j + 2 * rr + e]);
        }
      }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
score_gemm_tf32x3(const ScoreArgs p) {
  using S = Wide;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  unsigned char* ringp = smem_raw + (ring - raw);
  const uint32_t full0 = ring + S::NST * S::STAGE_B;
  const uint32_t empty0 = full0 + S::NST * 8;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S::NST; ++i) {
      mbar_init(full0 + 8 * i, PRODUCERS);        // the producer's threads
      mbar_init(empty0 + 8 * i, CONSUMER_WARPS);  // one lane a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    produce<S>(p, ring, ringp, full0, empty0, threadIdx.x - 256);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consume_wide(p, ring, full0, empty0, wg, threadIdx.x % 128);
  }
}

template <int NQ>
__global__ void __launch_bounds__(THREADS, 1)
score_gemm_tf32x3_pack(const ScoreArgs p) {
  using S = Pack<NQ>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  unsigned char* ringp = smem_raw + (ring - raw);
  const uint32_t qtile = ring + S::NST * S::STAGE_B;
  unsigned char* qtilep = ringp + S::NST * S::STAGE_B;
  const uint32_t full0 = qtile + S::QUERY_B;
  const uint32_t empty0 = full0 + S::NST * 8;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S::NST; ++i) {
      mbar_init(full0 + 8 * i, PRODUCERS);        // the producer's threads
      mbar_init(empty0 + 8 * i, CONSUMER_WARPS);  // one lane a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    produce<S>(p, ring, ringp, full0, empty0, threadIdx.x - 256);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consume_pack<NQ>(p, ringp, qtile, qtilep, full0, empty0, wg,
                     threadIdx.x % 128);
  }
}

template <class K>
int launch(K kernel, int smem, const ScoreArgs& p, int grid,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// c [Q, N] = a [Q, K] . m [N, K]^T in f32 (3 x TF32).  K a multiple of 8,
// at most 256; m 16-byte aligned with ldm a multiple of 4; a's and c's
// rows contiguous.  The plan from the caller: shape (0 wide: 128 queries x
// 64 rows a tile; 1, 2: a pack of at most 16 or 64 queries x 128 rows),
// grid (a multiple of the query tiles while they fit the card).  What the
// kernel cannot run is refused with an error code.
extern "C" int vfr_score_gemm(const float* a, const float* m, float* c,
                              int Q, int N, int K, int lda, int ldm, int ldc,
                              int shape, int grid, void* stream) {
  const int qts[3] = {Wide::QT, 16, 64};
  const int srs[3] = {Wide::SR, Pack<16>::SR, Pack<64>::SR};
  if (Q <= 0 || N <= 0 || K <= 0 || K % 8 || K > K_MAX || lda < K ||
      ldm < K || ldm % 4 || ldc < N || grid <= 0 || shape < 0 || shape > 2 ||
      (shape > 0 && Q > qts[shape]))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(m) % 16 ||
      reinterpret_cast<uintptr_t>(a) % 4 || reinterpret_cast<uintptr_t>(c) % 8)
    return (int)cudaErrorMisalignedAddress;
  ScoreArgs p = {};
  p.a = a;
  p.m = m;
  p.c = c;
  p.lda = lda;
  p.ldm = ldm;
  p.ldc = ldc;
  p.Q = Q;
  p.N = N;
  p.K = K;
  p.chunks = (K + KCH - 1) / KCH;
  p.q_tiles = (Q + qts[shape] - 1) / qts[shape];
  const long long units =
      (long long)p.q_tiles * ((N + srs[shape] - 1) / srs[shape]);
  if (units >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  p.units = (int)units;
  p.vec2 = ldc % 2 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (shape) {
    case 0:
      return launch(score_gemm_tf32x3, Wide::SMEM, p, grid, s);
    case 1:
      return launch(score_gemm_tf32x3_pack<16>, Pack<16>::SMEM, p, grid, s);
    default:
      return launch(score_gemm_tf32x3_pack<64>, Pack<64>::SMEM, p, grid, s);
  }
}
