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
// Design.  Two variants, chosen by the caller's plan (ops/kernels/
// rnn_plan.py) from shapes and device properties:
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
