// LSTM recurrence for the query tower (one layer per call), Hopper sm_90a.
//
// Replaces: vfr_tpu/ops/pallas/lstm_kernel.py::_kernel_pooled (:78, K1a,
// pool="mean") and ::_kernel (:60, K1b, hs-emitting), both around ::_step
// (:26).  Same semantics: x and h are rounded to the weights' dtype before
// each product, products accumulate in f32, gates in (i, f, g, o) order,
// c' = f*c + i*g, h' = o*tanh(c'), and rows with t >= len keep (h, c).
// Pooled mode returns h_last and sum_{t<len} h_t / max(len, 1); hs mode
// writes h_t for every t (the frozen carry on padded steps) and h_last.
//
// What bounds it on this card: by the roofline the gate products,
// 2*live_steps*4H*(E+H) flops against ~20 MB of bytes, so operations at the
// bf16 tensor-core rate.  In practice a step's product is ~2 us of that
// rate, and a step costs what it has to fetch again and how often the
// grid has to be launched or synchronised.
//
// Design.  Three variants, chosen by the caller's plan (ops/kernels/
// rnn_plan.py) from shapes and device properties:
//   persistent_bulk  (bf16 weights, both slices resident;
//      lstm_persistent_bulk below) replaces `persistent` wherever it fits
//      past a daemon pack, with the same bits.  `persistent`'s step on an H100 is 8.75 us: the
//      recurrent product 5.0 of it against 2.28 for the tensor cores alone,
//      bound by instruction issue (four cp.async a thread and chunk with
//      their addresses and predicates, 8 warps an SM), and the next step's
//      x W_ih (1.75 us) between the barrier's arrive and wait.  Here one
//      thread moves each [128 rows x 64 k] bf16 chunk (16 KB, pre-swizzled
//      as wgmma reads it) by one bulk copy into a three-stage mbarrier
//      ring, from an h buffer every block writes chunk-major and from a
//      chunk-major bf16 copy of x made before the launch.  The block's
//      [64 gate rows x K] W slice is the wgmma's A operand and the batch
//      rows its N (two warpgroups of 64 rows; one warpgroup on all 128
//      measured slower), so a cell's four gates sit in two lanes and meet
//      by one shuffle.  x_{t+1}'s chunks need no barrier: their products
//      run while it completes.  What bounds it now is the ring: the 48 KB
//      of shared memory beside the 168 KB of slices keep two copies in
//      flight, ~200 ns a chunk against ~140 of tensor-core time (a step
//      6.25 us).
//   persistent  (bf16 weights; rnn_common.cuh::rnn_persistent with the
//      LstmCell below) what the TPU kernel keeps in VMEM stays on chip for
//      all T steps: a block's [H x 64] slice of W_hh (and of W_ih, when it
//      fits) lives in shared memory, c / h / the pooled sum in registers;
//      one cooperative launch per layer with one grid barrier per step;
//      the recurrent product is wgmma m64n64k16 with the four gates of a
//      cell in one thread's accumulator registers; 64-row tiles with no
//      live row skip their product.
//   stepwise  (f32 weights, or shapes whose slice does not fit shared
//      memory or whose grid exceeds the SMs) the input product gx =
//      round(x) @ W_ih + b hoisted over all T, then one launch per step:
//      each block owns 32 hidden units and 32 batch rows and computes all
//      four gate columns of round(h_{t-1}) @ W_hh (WMMA bf16 fragments fed
//      by a 3-stage cp.async ring, or tiled f32 FMAs), h ping-pongs
//      between two buffers, c and the pooled sum are updated in place by
//      their owning thread.  W_hh is re-read from L2 every step.
// Kernels launch on the caller's stream, allocate nothing, and the host
// entry points return the first CUDA error.

#include "rnn_common.cuh"

namespace {

// Cell update + frozen-carry select + output for element (b, j) at step
// t, given the four h_{t-1} @ W_hh gate sums; gx already holds x W_ih + b.
template <bool POOL>
__device__ __forceinline__ void finish_cell(
    const float* __restrict__ gx, const int* __restrict__ lengths,
    const float* __restrict__ h_prev, float* __restrict__ h_next,
    float* __restrict__ c, float* __restrict__ seq,
    float* __restrict__ h_last, float* __restrict__ pooled,
    __nv_bfloat16* __restrict__ hb_next, int T, int H, int t, int b, int j,
    float ai, float af, float ag, float ao) {
  const float* g_row = gx + ((size_t)b * T + t) * 4 * (size_t)H;
  const float ig = sigmoidf(g_row[j] + ai);
  const float fg = sigmoidf(g_row[H + j] + af);
  const float gg = tanhf(g_row[2 * H + j] + ag);
  const float og = sigmoidf(g_row[3 * H + j] + ao);
  const size_t e = (size_t)b * H + j;
  const float c_old = c[e];
  const float h_old = h_prev[e];
  const float c_new = fg * c_old + ig * gg;
  const float h_new = og * tanhf(c_new);
  const int len = lengths[b];
  const bool live = t < len;
  const float h = live ? h_new : h_old;
  c[e] = live ? c_new : c_old;
  h_next[e] = h;
  if (hb_next != nullptr) hb_next[e] = __float2bfloat16_rn(h);
  if (POOL) {
    const float s = seq[e] + (live ? h : 0.0f);
    seq[e] = s;
    if (t == T - 1) pooled[e] = s / fmaxf((float)len, 1.0f);
  } else {
    seq[((size_t)b * T + t) * H + j] = h;
  }
  if (t == T - 1) h_last[e] = h;
}

constexpr int SB = 32;   // step kernel tile: batch rows
constexpr int SJ = 32;   //                   hidden units (x4 gate columns)
constexpr int SK = 32;   //                   depth
constexpr int SR = 8;    // batch rows per thread (128 threads = 4 warps)

// One step with f32 weights on plain FMAs.
template <bool POOL>
__global__ void __launch_bounds__(128)
lstm_step_kernel(const float* __restrict__ gx,       // [B, T, 4H]
                 const float* __restrict__ whh,      // [H, 4H]
                 const int* __restrict__ lengths,    // [B]
                 const float* __restrict__ h_prev,   // [B, H]
                 float* __restrict__ h_next,         // [B, H]
                 float* __restrict__ c,              // [B, H] in place
                 float* __restrict__ seq,            // hs [B, T, H] | sum [B, H]
                 float* __restrict__ h_last,         // [B, H]
                 float* __restrict__ pooled,         // [B, H] (POOL only)
                 int B, int T, int H, int t) {
  __shared__ float Hs[SK][SB + 1];
  __shared__ float Ws[SK][4 * SJ];
  const int tj = threadIdx.x % 32;       // hidden unit within the tile
  const int tr = threadIdx.x / 32;       // warp: rows tr*SR .. tr*SR+SR-1
  const int j0 = blockIdx.x * SJ;
  const int b0 = blockIdx.y * SB;
  const int G = 4 * H;
  float acc[SR][4] = {};
  for (int k0 = 0; k0 < H; k0 += SK) {
    for (int i = threadIdx.x; i < SB * SK; i += 128) {
      const int r = i / SK, kk = i % SK;
      const int b = b0 + r, k = k0 + kk;
      Hs[kk][r] = (b < B && k < H)
                      ? h_prev[(size_t)b * H + k] : 0.0f;
    }
    for (int i = threadIdx.x; i < SK * 4 * SJ; i += 128) {
      const int kk = i / (4 * SJ), col = i % (4 * SJ);
      const int g = col / SJ, u = col % SJ;
      const int k = k0 + kk, j = j0 + u;
      Ws[kk][col] = (k < H && j < H)
                        ? whh[(size_t)k * G + g * H + j] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < SK; ++kk) {
      float hv[SR], wv[4];
#pragma unroll
      for (int r = 0; r < SR; ++r) hv[r] = Hs[kk][tr * SR + r];
#pragma unroll
      for (int g = 0; g < 4; ++g) wv[g] = Ws[kk][g * SJ + tj];
#pragma unroll
      for (int r = 0; r < SR; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] += hv[r] * wv[g];
    }
    __syncthreads();
  }
  const int j = j0 + tj;
  if (j >= H) return;
#pragma unroll
  for (int r = 0; r < SR; ++r) {
    const int b = b0 + tr * SR + r;
    if (b < B)
      finish_cell<POOL>(gx, lengths, h_prev, h_next, c, seq, h_last, pooled,
                        nullptr, T, H, t, b, j, acc[r][0], acc[r][1],
                        acc[r][2], acc[r][3]);
  }
}

constexpr int WB = 32;    // step tile: batch rows
constexpr int WJ = 32;    //            hidden units; warp g owns gate g
constexpr int WK = 64;    //            depth
constexpr int WC = 4 * WJ;
constexpr int WA_LD = WK + 8;
constexpr int WB_LD = WC + 8;
constexpr int WC_LD = WC + 4;
constexpr int WA_STAGE = WB * WA_LD;
constexpr int WB_STAGE = WK * WB_LD;
constexpr size_t STEP_SMEM =
    STAGES * (WA_STAGE + WB_STAGE) * sizeof(Bf16) + WB * WC_LD * sizeof(float);

// One step: gates of (rows b0.., units j0..) = hb_prev @ W_hh columns
// {g*H + j}, then the cell update.  Needs H % 8 == 0 (16-byte rows).
template <bool POOL>
__global__ void __launch_bounds__(128)
lstm_step_wmma(const float* __restrict__ gx, const Bf16* __restrict__ whh,
               const int* __restrict__ lengths,
               const float* __restrict__ h_prev,
               const Bf16* __restrict__ hb_prev, float* __restrict__ h_next,
               Bf16* __restrict__ hb_next, float* __restrict__ c,
               float* __restrict__ seq, float* __restrict__ h_last,
               float* __restrict__ pooled, int B, int T, int H, int t) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Bf16* As = reinterpret_cast<Bf16*>(smem_raw);
  Bf16* Bs = As + STAGES * WA_STAGE;
  float* Cs = reinterpret_cast<float*>(Bs + STAGES * WB_STAGE);
  const int g = threadIdx.x / 32;
  const int j0 = blockIdx.x * WJ;
  const int b0 = blockIdx.y * WB;
  const size_t G = 4 * (size_t)H;
  const int nk = (H + WK - 1) / WK;
  auto load = [&](int stage, int kc) {
    const int k0 = kc * WK;
    Bf16* a = As + stage * WA_STAGE;
    Bf16* bs = Bs + stage * WB_STAGE;
    for (int i = threadIdx.x; i < WB * (WK / 8); i += 128) {
      const int r = i / (WK / 8), kv = (i % (WK / 8)) * 8;
      const int b = b0 + r, k = k0 + kv;
      const bool ok = b < B && k < H;
      cp_async16(a + r * WA_LD + kv, ok ? hb_prev + (size_t)b * H + k : hb_prev,
                 ok);
    }
    for (int i = threadIdx.x; i < WK * (WC / 8); i += 128) {
      const int kk = i / (WC / 8), col = (i % (WC / 8)) * 8;
      const int gg = col / WJ, j = j0 + col % WJ, k = k0 + kk;
      const bool ok = k < H && j < H;
      cp_async16(bs + kk * WB_LD + col, ok ? whh + k * G + gg * H + j : whh,
                 ok);
    }
  };
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
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
    const Bf16* a = As + (kc % STAGES) * WA_STAGE;
    const Bf16* bs = Bs + (kc % STAGES) * WB_STAGE;
#pragma unroll
    for (int kk = 0; kk < WK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, Bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, Bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a + 16 * i * WA_LD + kk, WA_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * WB_LD + g * WJ + 16 * j,
                               WB_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + 16 * i * WC_LD + g * WJ + 16 * j,
                              acc[i][j], WC_LD, wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < WB * WJ; e += 128) {
    const int r = e / WJ, u = e % WJ;
    const int b = b0 + r, j = j0 + u;
    const float* cr = Cs + r * WC_LD;
    if (b < B && j < H)
      finish_cell<POOL>(gx, lengths, h_prev, h_next, c, seq, h_last, pooled,
                        hb_next, T, H, t, b, j, cr[u], cr[WJ + u],
                        cr[2 * WJ + u], cr[3 * WJ + u]);
  }
}

// ---------------------------------------------------------------------------

int run_layer_f32(const float* x, const float* w_ih, const float* w_hh,
                  const float* b, const int* lengths, float* gx, float* h_a,
                  float* h_b, float* c, float* seq, float* h_last,
                  float* pooled, int B, int T, int E, int H, int pool,
                  cudaStream_t stream) {
  int err = input_product(x, w_ih, b, nullptr, gx, B * T, 4 * H, E, false,
                          stream);
  if (err != 0) return err;
  dim3 sgrid((H + SJ - 1) / SJ, (B + SB - 1) / SB);
  for (int t = 0; t < T; ++t) {
    const float* hp = (t % 2 == 0) ? h_a : h_b;
    float* hn = (t % 2 == 0) ? h_b : h_a;
    if (pool) {
      lstm_step_kernel<true><<<sgrid, 128, 0, stream>>>(
          gx, w_hh, lengths, hp, hn, c, seq, h_last, pooled, B, T, H, t);
    } else {
      lstm_step_kernel<false><<<sgrid, 128, 0, stream>>>(
          gx, w_hh, lengths, hp, hn, c, seq, h_last, pooled, B, T, H, t);
    }
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return 0;
}

int run_layer_bf16(const float* x, const Bf16* w_ih, const Bf16* w_hh,
                   const float* b, const int* lengths, Bf16* xb, float* gx,
                   float* h_a, float* h_b, Bf16* hb_a, Bf16* hb_b, float* c,
                   float* seq, float* h_last, float* pooled, int B, int T,
                   int E, int H, int pool, cudaStream_t stream) {
  if (H % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(lstm_step_wmma<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)STEP_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(lstm_step_wmma<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)STEP_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int perr = input_product(x, w_ih, b, xb, gx, B * T, 4 * H, E, true,
                                 stream);
  if (perr != 0) return perr;
  dim3 sgrid((H + WJ - 1) / WJ, (B + WB - 1) / WB);
  for (int t = 0; t < T; ++t) {
    const bool even = t % 2 == 0;
    const float* hp = even ? h_a : h_b;
    float* hn = even ? h_b : h_a;
    const Bf16* hbp = even ? hb_a : hb_b;
    Bf16* hbn = even ? hb_b : hb_a;
    if (pool) {
      lstm_step_wmma<true><<<sgrid, 128, STEP_SMEM, stream>>>(
          gx, w_hh, lengths, hp, hbp, hn, hbn, c, seq, h_last, pooled, B, T,
          H, t);
    } else {
      lstm_step_wmma<false><<<sgrid, 128, STEP_SMEM, stream>>>(
          gx, w_hh, lengths, hp, hbp, hn, hbn, c, seq, h_last, pooled, B, T,
          H, t);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Gate math of the persistent variant: a = x W_ih + b, g = h W_hh.
struct LstmCell {
  static constexpr int G = 4;
  static __device__ __forceinline__ float update(const float (&a)[4],
                                                 const float (&g)[4],
                                                 float h_old, float& c) {
    const float ig = fast_sigmoid(a[0] + g[0]);
    const float fg = fast_sigmoid(a[1] + g[1]);
    const float gg = fast_tanh(a[2] + g[2]);
    const float og = fast_sigmoid(a[3] + g[3]);
    c = fg * c + ig * gg;
    return og * fast_tanh(c);
  }
};

// ---------------------------------------------------------------------------
// The persistent_bulk variant.  See the header note.

constexpr int BROWS = 128;                 // batch rows of a block
constexpr int BCHUNK = BROWS * PKC * 2;    // bytes of a [128 x 64] bf16 chunk
constexpr int BSTAGES = 3;                 // ring stages: 48 KB, all the
                                           // shared memory beside the slices
constexpr int BWCH = 4 * PU * PKC * 2;     // bytes of a [64 x 64] W chunk
constexpr int BN = 64;                     // rows of a consumer warpgroup
constexpr int BCONS = 2 * 128;             // two consumer warpgroups
constexpr int BTHREADS = BCONS + 32;       // + the producer warp
constexpr int BTILE = BROWS * PU * 4;      // bytes of the f32 h staging tile

// Byte offset of (row n, depth k) inside a chunk: 128-byte rows whose
// 16-byte pieces are swizzled by the row's low 3 bits, the layout wgmma
// reads with the 128-byte swizzle (address bits 4-6 ^= bits 7-9).
__device__ __forceinline__ uint32_t chunk_byte(int n, int k) {
  return n * 128 + (((k >> 3) ^ (n & 7)) << 4) + ((k & 7) << 1);
}

// Row of the block's W slice (the wgmma's M) that holds gate `gate` (i, f,
// g, o) of unit `unit` (0..15).  Accumulator row 16w + q + 8rr of a
// warpgroup lives in warp w, lanes 4q..4q+3, register half rr: so a thread
// holds gates 2b, 2b+1 (b = q % 2) of unit 4w + q/2 and lane ^ 4 the other
// two gates of the same unit and batch columns.
__device__ __forceinline__ int bulk_row(int gate, int unit) {
  return 16 * (unit >> 2) + 2 * (unit & 3) + (gate >> 1) + 8 * (gate & 1);
}

__device__ __forceinline__ void consumers_sync() {   // named barrier 1
  asm volatile("bar.sync 1, %0;\n" ::"n"(BCONS) : "memory");
}

// x [B, T, E] f32 -> bf16 chunks xc[(t * nbg + g) * nkx + c]: rows 128g..,
// depth 64c.. of x_t, zero past B and E, swizzled as chunk_byte.  One
// 16-byte piece per iteration.
__global__ void to_bf16_chunked(const float* __restrict__ x,
                                uint4* __restrict__ xc, int B, int T, int E,
                                int nbg, int nkx) {
  const size_t n = (size_t)T * nbg * nkx * (BCHUNK / 16);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)((i >> 3) & (BROWS - 1));
    size_t rest = i >> 10;                   // the chunk
    const int c = (int)(rest % nkx);
    rest /= nkx;
    const int b = (int)(rest % nbg) * BROWS + r;
    const int t = (int)(rest / nbg);
    const int k0 = c * PKC + (((int)(i & 7) ^ (r & 7)) << 3);
    const float* src = x + ((size_t)b * T + t) * E;
    uint32_t o[4];
#pragma unroll
    for (int h2 = 0; h2 < 4; ++h2) {
      const int k = k0 + 2 * h2;
      o[h2] = pack_bf16(b < B && k < E ? src[k] : 0.0f,
                        b < B && k + 1 < E ? src[k + 1] : 0.0f);
    }
    xc[i] = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// One layer, all T steps.  Grid (ceil(H/16), ceil(B/128)), 288 threads,
// launched cooperatively.  Thread 256 is the producer: for each live step
// it copies x_t's chunks into the ring and then, past the grid barrier,
// h_{t-1}'s.  Threads 0..255 consume, warpgroup wg on rows 64wg..64wg+63
// of each chunk: four wgmma m64n64k16 a chunk with the W chunk as A and
// its half of the ring stage as B, x's chunks into an accumulator started
// at the bias, h's into one started at 0; then the cell update, h_t
// through a staging tile into the chunk-major hb (and hs), and the arrive
// at the batch group's barrier.  x_{t+1}'s chunks do not wait for the
// barrier, so their products run while it completes.  The wait for a
// chunk and the stage's release carry no branch the compiler sees
// (mma_common.cuh), and the role and the batch group's length are made
// warp-uniform by a shuffle: otherwise ptxas serializes the products
// (C7520).
__global__ void __launch_bounds__(BTHREADS, 1)
lstm_persistent_bulk(const PersistentArgs p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t wsm = (raw + 1023u) & ~1023u;
  unsigned char* wptr = smem_raw + (wsm - raw);
  const int B = p.B, T = p.T, H = p.H;
  const size_t GH = 4 * (size_t)H;
  const int nkx = p.Ep / PKC, nkh = (H + PKC - 1) / PKC;
  const int nbg = gridDim.y, bg = blockIdx.y;
  const int j0 = blockIdx.x * PU;
  const int row0 = bg * BROWS;
  const uint32_t ring = wsm + (nkx + nkh) * BWCH;
  float* stile = reinterpret_cast<float*>(wptr + (nkx + nkh) * BWCH +
                                          BSTAGES * BCHUNK);
  const uint32_t full = ring + BSTAGES * BCHUNK + BTILE;   // + 8s
  const uint32_t empty = full + 8 * BSTAGES;               // + 8s
  const int tid = threadIdx.x;

  // The block's slices of W_ih and W_hh, once, as A: element (m, k) of
  // chunk c at c*BWCH + chunk_byte(m, k), m = bulk_row(gate, unit).  A
  // thread reads 8 units of one gate at 8 consecutive k (8 loads of 16
  // bytes) and stores, per unit, the 16 bytes of its 8 k.
  for (int i = tid; i < (nkx + nkh) * 8 * 8; i += BTHREADS) {
    const int kg = i / 8, n8 = i % 8;
    const int chunk = kg / 8, piece = kg % 8;
    const int g = n8 / 2, u0 = (n8 % 2) * 8, j = j0 + u0;
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
      const int m = bulk_row(g, u0 + u);
      *reinterpret_cast<uint4*>(wptr + chunk * BWCH + m * 128 +
                                ((piece ^ (m & 7)) << 4)) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
  // hb's depth padding [H, 64*nkh) belongs to no block: the last column
  // group zeroes it in both buffers, before its first barrier arrive
  const int pad = (nkh * PKC - H) / 8;        // 16-byte pieces a row
  if (blockIdx.x == gridDim.x - 1) {
    for (int i = tid; i < 2 * BROWS * pad; i += BTHREADS) {
      const int par = i / (BROWS * pad), n = (i / pad) % BROWS;
      const int k = H % PKC + (i % pad) * 8;   // in the last chunk
      *reinterpret_cast<uint4*>(
          reinterpret_cast<unsigned char*>(p.hb) +
          ((size_t)(par * nbg + bg) * nkh + nkh - 1) * BCHUNK +
          chunk_byte(n, k)) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // the batch group's longest row: past it the block skips its products
  int* s_len = reinterpret_cast<int*>(stile);
  int tile_len = (tid < BROWS && row0 + tid < B)
                     ? min(max(p.lengths[row0 + tid], 0), T) : 0;
#pragma unroll
  for (int o = 16; o > 0; o /= 2)
    tile_len = max(tile_len, __shfl_xor_sync(0xffffffffu, tile_len, o));
  if (tid % 32 == 0) s_len[tid / 32] = tile_len;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < BSTAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, BCONS / 32);   // a lane of each consumer warp
    }
    mbar_init_fence();
  }
  fence_async_smem();
  __syncthreads();
  tile_len = __shfl_sync(0xffffffffu, max(max(s_len[0], s_len[1]),
                                          max(s_len[2], s_len[3])), 0);
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  __syncthreads();          // s_len is read; the staging tile may be written
  // the barrier of a batch group: its blocks alone exchange h, and they
  // share its longest row, so a group whose rows have all ended stops
  // arriving and waiting together
  const unsigned per_group = gridDim.x;

  if (warp == BCONS / 32) {   // the producer warp
    if (tid != BCONS) return;
    const unsigned char* xs = reinterpret_cast<const unsigned char*>(p.xb);
    const unsigned char* hsrc = reinterpret_cast<const unsigned char*>(p.hb);
    int stage = 0;
    uint32_t phase = 0;
    auto put = [&](const unsigned char* src) {
      mbar_wait(empty + 8 * stage, phase ^ 1);
      mbar_expect_tx(full + 8 * stage, BCHUNK);
      bulk_copy_g2s(ring + stage * BCHUNK, src, BCHUNK, full + 8 * stage);
      if (++stage == BSTAGES) { stage = 0; phase ^= 1; }
    };
    for (int t = 0; t < tile_len; ++t) {
      const unsigned char* xt = xs + (size_t)(t * nbg + bg) * nkx * BCHUNK;
      for (int c = 0; c < nkx; ++c) put(xt + (size_t)c * BCHUNK);
      if (t > 0) {
        grid_wait(p.counter + bg, per_group * (unsigned)t);
        fence_async_global();     // the other blocks' h stores, acquired
        const unsigned char* ht =
            hsrc + (size_t)((t % 2) * nbg + bg) * nkh * BCHUNK;
        for (int c = 0; c < nkh; ++c) put(ht + (size_t)c * BCHUNK);
      }
    }
    return;
  }

  // This thread's cells: unit 4w + q/2 (gates 2b, 2b+1 in its registers,
  // b = q % 2), batch rows n = 64wg + 8*(2jj + b) + 2*t4 + e of the group
  // (it keeps the columns of even j8 for b = 0, odd for b = 1, and gives
  // lane ^ 4 its gates of the others).  Register 4*j8 + 2*rr + e of acc is
  // D[row 16w + q + 8rr][column 8*j8 + 2*t4 + e] of its warpgroup.
  const int wg = warp / 4, w = warp % 4, lane = tid % 32, q = lane / 4;
  const int t4 = lane % 4;
  const int bsel = q & 1, unit = 4 * w + (q >> 1), j = j0 + unit;
  const bool unit_ok = j < H;
  auto col = [&](int ci) {        // the group row of cell ci
    return BN * wg + 16 * (ci / 2) + 8 * bsel + 2 * t4 + ci % 2;
  };
  float bias[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    bias[rr] = unit_ok ? p.b_ih[(2 * bsel + rr) * H + j] : 0.0f;
  int len[8];
  float h[8], c[8], sum[8];
#pragma unroll
  for (int ci = 0; ci < 8; ++ci) {
    const int r = row0 + col(ci);
    len[ci] = r < B ? min(max(p.lengths[r], 0), T) : 0;
    h[ci] = c[ci] = sum[ci] = 0.0f;
  }
  // the input part (from the bias) and the recurrent part (from 0) in
  // accumulators of their own, summed before the gates as rnn_persistent
  // sums them: the two variants give the same bits
  float gi[32], acc[32];
  int stage = 0;
  uint32_t phase = 0;
  const uint64_t dring = smem_desc(ring + wg * BN * 128);
  // d += the nk chunks of W from `dw` times the ring's next nk chunks
  auto consume = [&](float (&d)[32], uint64_t dw, int nk) {
    int prev = 0;
    for (int kc = 0; kc < nk; ++kc) {
      mbar_wait_asm(full + 8 * stage, phase);
      __syncwarp();
      wgmma_fence();
      const uint64_t db = dring + stage * (BCHUNK >> 4);
#pragma unroll
      for (int k16 = 0; k16 < PKC / 16; ++k16)
        wgmma_k16(d, dw + 2 * k16, db + 2 * k16);
      wgmma_commit();
      wgmma_wait<1>();                      // chunk kc-1 has read its stage
      mbar_arrive_if(empty + 8 * prev, kc > 0 && lane == 0);
      prev = stage;
      if (++stage == BSTAGES) { stage = 0; phase ^= 1; }
      dw += BWCH >> 4;
    }
    wgmma_wait<0>();
    mbar_arrive_if(empty + 8 * prev, lane == 0);
  };
  const uint64_t dwx = smem_desc(wsm), dwh = smem_desc(wsm + nkx * BWCH);
  const bool pool = p.pool != 0;
  unsigned char* hb = reinterpret_cast<unsigned char*>(p.hb);

  for (int t = 0; t < T; ++t) {
    if (t < tile_len) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        gi[i] = bias[(i >> 1) & 1];
        acc[i] = 0.0f;
      }
      consume(gi, dwx, nkx);
      if (t > 0) {
        stamp(p, t - 1, 4);
        mbar_wait_asm(full + 8 * stage, phase);   // past the grid barrier
      }
      stamp(p, t, 0);
      if (t > 0) consume(acc, dwh, nkh);
      stamp(p, t, 1);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float own[2], other[2];
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int ie = 4 * (2 * jj) + 2 * rr + e, io = ie + 4;
            const float even = gi[ie] + acc[ie], odd = gi[io] + acc[io];
            own[rr] = bsel ? odd : even;
            other[rr] = __shfl_xor_sync(0xffffffffu, bsel ? even : odd, 4);
          }
          // the gates (i, f, g, o) of cell ci, through LstmCell's update
          const float z[4] = {bsel ? other[0] : own[0],
                              bsel ? other[1] : own[1],
                              bsel ? own[0] : other[0],
                              bsel ? own[1] : other[1]};
          const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          const int ci = 2 * jj + e;
          float c_new = c[ci];
          const float h_new = LstmCell::update(z, zero, h[ci], c_new);
          const bool live = t < len[ci];
          h[ci] = live ? h_new : h[ci];
          c[ci] = live ? c_new : c[ci];
          sum[ci] += live ? h[ci] : 0.0f;
        }
    }
    stamp(p, t, 2);
    // h_t through the staging tile, f32 [128 rows][16 units], 4-unit
    // groups swizzled by (row / 2) % 4 (2-way bank conflicts on the writes,
    // none on the reads): a thread then stores a row's 8 units of h_t, 16
    // bytes of bf16 to hb and (hs mode) 32 bytes of f32 to hs
#pragma unroll
    for (int ci = 0; ci < 8; ++ci) {
      const int n = col(ci);
      stile[n * PU + ((w ^ t4) << 2) + (q >> 1)] = h[ci];
    }
    consumers_sync();
    {
      const int n = tid >> 1, hh = tid & 1;
      const int r = row0 + n, jv = j0 + 8 * hh;
      if (r < B && jv < H) {
        const int sw = (n >> 1) & 3;
        const float4 v0 = *reinterpret_cast<const float4*>(
            stile + n * PU + (((2 * hh) ^ sw) << 2));
        const float4 v1 = *reinterpret_cast<const float4*>(
            stile + n * PU + (((2 * hh + 1) ^ sw) << 2));
        if (!pool) {
          float4* dst = reinterpret_cast<float4*>(
              p.hs + ((size_t)r * T + t) * H + jv);
          dst[0] = v0;
          dst[1] = v1;
        }
        // only a live next step reads h_t: a step past the group's rows
        // writes none, so it cannot reach the buffer a block still behind
        // reads (it passed no barrier)
        if (t + 1 < tile_len)
          *reinterpret_cast<uint4*>(
              hb + ((size_t)(((t + 1) % 2) * nbg + bg) * nkh + jv / PKC) *
                       BCHUNK +
              chunk_byte(n, jv % PKC)) =
              make_uint4(pack_bf16(v0.x, v0.y), pack_bf16(v0.z, v0.w),
                         pack_bf16(v1.x, v1.y), pack_bf16(v1.z, v1.w));
      }
    }
    if (t + 1 < T) {
      consumers_sync();        // every h_t store, and the tile read
      if (tid == 0 && t + 1 < tile_len) grid_arrive(p.counter + bg);
    }
    stamp(p, t, 3);
  }
#pragma unroll
  for (int ci = 0; ci < 8; ++ci) {
    const int r = row0 + col(ci);
    if (r >= B || !unit_ok) continue;
    const size_t o = (size_t)r * H + j;
    p.h_last[o] = h[ci];
    if (pool) p.pooled[o] = sum[ci] * (1.0f / fmaxf((float)len[ci], 1.0f));
  }
}

// Host side of one persistent_bulk layer: x's chunk-major bf16 copy, then
// one cooperative launch.  What the device cannot run is refused with an
// error code, never rerouted.
int launch_persistent_bulk(const float* x, PersistentArgs a, Bf16* xc,
                           int grid_x, int grid_y, int smem,
                           cudaStream_t stream) {
  const int nkx = a.Ep / PKC, nkh = (a.H + PKC - 1) / PKC;
  const size_t need = 1024 + (size_t)(nkx + nkh) * BWCH +
                      BSTAGES * BCHUNK + BTILE + 16 * BSTAGES;
  if (a.H % 8 != 0 || a.Ep % PKC != 0 || (size_t)smem < need ||
      grid_x != (a.H + PU - 1) / PU || grid_y != (a.B + BROWS - 1) / BROWS)
    return (int)cudaErrorInvalidValue;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  const void* kernel = reinterpret_cast<const void*>(lstm_persistent_bulk);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      BTHREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm * sms < grid_x * grid_y)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  to_bf16_chunked<<<1024, 256, 0, stream>>>(
      x, reinterpret_cast<uint4*>(xc), a.B, a.T, a.E, grid_y, nkx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  a.xb = xc;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid_x, grid_y),
                                    dim3(BTHREADS), params, (size_t)smem,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// One LSTM layer, persistent variant (bf16 weights, H % 8 == 0).  x
// [B, T, E] f32; w_ih [E, 4H], w_hh [H, 4H] bf16; b [4H] f32; lengths [B]
// int32.  Scratch: xb
// bf16 [B*T, Ep] (fuse = 1, Ep = E rounded up to 64) or [B*T, round8(E)]
// with gx f32 [B*T, 4H] (fuse = 0); hb bf16 [2, B, H]; counter, one zeroed
// uint32.  hs [B, T, H] (pool = 0); h_last [B, H]; pooled [B, H] (pool =
// 1).  The plan: nwg warpgroups of 64 rows per block, grid and dynamic
// shared memory bytes.  timeline: null, or [T, 5] int64 for
// the per-step time stamps (rnn_common.cuh::stamp).
extern "C" int vfr_lstm_layer_persistent(
    const float* x, const void* w_ih, const void* w_hh, const float* b,
    const int* lengths, void* xb, float* gx, void* hb, unsigned* counter,
    float* hs, float* h_last, float* pooled, int B, int T, int E, int H,
    int pool, int nwg, int fuse, int grid_x, int grid_y,
    int smem, void* stream, long long* timeline) {
  PersistentArgs a{};
  a.w_ih = static_cast<const Bf16*>(w_ih);
  a.w_hh = static_cast<const Bf16*>(w_hh);
  a.b_ih = b;
  a.b_hh = nullptr;
  a.lengths = lengths;
  a.hb = static_cast<Bf16*>(hb);
  a.hs = hs;
  a.h_last = h_last;
  a.pooled = pooled;
  a.counter = counter;
  a.B = B; a.T = T; a.E = E; a.Ep = (E + PKC - 1) / PKC * PKC; a.H = H;
  a.pool = pool;
  a.timeline = timeline;
  return launch_persistent<LstmCell>(x, a, static_cast<Bf16*>(xb), gx, nwg,
                                     fuse, grid_x, grid_y, smem,
                                     static_cast<cudaStream_t>(stream));
}

// One LSTM layer, persistent_bulk variant (bf16 weights, H % 8 == 0, both
// slices resident).  Arguments as vfr_lstm_layer_persistent's; scratch: xc
// bf16 [T * grid_y * nkx chunks of 128 x 64] (nkx = ceil(E / 64)) and hb
// bf16 [2 * grid_y * ceil(H / 64) chunks of 128 x 64], both written by the
// launch; counter, grid_y zeroed uint32s.  Grid (ceil(H / 16),
// ceil(B / 128)).
extern "C" int vfr_lstm_layer_persistent_bulk(
    const float* x, const void* w_ih, const void* w_hh, const float* b,
    const int* lengths, void* xc, void* hb, unsigned* counter, float* hs,
    float* h_last, float* pooled, int B, int T, int E, int H, int pool,
    int grid_x, int grid_y, int smem, void* stream, long long* timeline) {
  PersistentArgs a{};
  a.w_ih = static_cast<const Bf16*>(w_ih);
  a.w_hh = static_cast<const Bf16*>(w_hh);
  a.b_ih = b;
  a.lengths = lengths;
  a.hb = static_cast<Bf16*>(hb);
  a.hs = hs;
  a.h_last = h_last;
  a.pooled = pooled;
  a.counter = counter;
  a.B = B; a.T = T; a.E = E; a.Ep = (E + PKC - 1) / PKC * PKC; a.H = H;
  a.pool = pool;
  a.timeline = timeline;
  return launch_persistent_bulk(x, a, static_cast<Bf16*>(xc), grid_x,
                                grid_y, smem,
                                static_cast<cudaStream_t>(stream));
}

// One LSTM layer, stepwise variant.  x [B, T, E] f32; w_ih [E, 4H], w_hh
// [H, 4H] in bf16
// (weights_bf16 = 1, needs H % 8 == 0) or f32; b [4H] f32; lengths [B]
// int32.  Scratch from the caller: gx [B, T, 4H] f32; h_a, h_b, c [B, H]
// f32 with h_a and c zeroed; for bf16 weights also xb [B*T, round8(E)]
// and hb_a, hb_b [B, H] bf16 with hb_a zeroed (unused, may be null, for
// f32 weights).  seq is hs [B, T, H] (pool = 0) or a zeroed sum [B, H]
// (pool = 1).  Outputs: h_last [B, H]; pooled [B, H] when pool = 1.
extern "C" int vfr_lstm_layer(const float* x, const void* w_ih,
                              const void* w_hh, const float* b,
                              const int* lengths, void* xb, float* gx,
                              float* h_a, float* h_b, void* hb_a, void* hb_b,
                              float* c, float* seq, float* h_last,
                              float* pooled, int B, int T, int E, int H,
                              int weights_bf16, int pool, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (weights_bf16) {
    return run_layer_bf16(x, static_cast<const Bf16*>(w_ih),
                          static_cast<const Bf16*>(w_hh), b, lengths,
                          static_cast<Bf16*>(xb), gx, h_a, h_b,
                          static_cast<Bf16*>(hb_a), static_cast<Bf16*>(hb_b),
                          c, seq, h_last, pooled, B, T, E, H, pool, s);
  }
  return run_layer_f32(x, static_cast<const float*>(w_ih),
                       static_cast<const float*>(w_hh), b, lengths, gx, h_a,
                       h_b, c, seq, h_last, pooled, B, T, E, H, pool, s);
}
