// GRU recurrence for the query tower (one layer per call), Hopper sm_90a.
//
// Replaces: vfr_tpu/ops/pallas/gru_kernel.py::_kernel_pooled (:79, K3a,
// pool="mean") and ::_kernel (:62, K3b, hs-emitting), both around ::_step
// (:28).  Same semantics: x and h are rounded to the weights' dtype before
// each product, products accumulate in f32, gates in torch's (r, z, n)
// order with the two biases kept apart:
//   gi = x W_ih + b_ih,  gh = h W_hh + b_hh,
//   r = sigmoid(gi_r + gh_r),  z = sigmoid(gi_z + gh_z),
//   n = tanh(gi_n + r * gh_n),  h' = (1 - z) * n + z * h,
// and rows with t >= len keep h.  b_hn stays inside r * (...): merging it
// into b_ih would change n.  Pooled mode returns h_last and
// sum_{t<len} h_t / max(len, 1); hs mode writes h_t for every t (the
// frozen carry on padded steps) and h_last.
//
// What bounds it on this card: by the roofline the gate products,
// 2*live_steps*3H*(E+H) flops against ~16 MB of weights and activations,
// so operations at the bf16 tensor-core rate; in practice what a step
// fetches again and how often the grid is launched or synchronised.
//
// Design: K1's (lstm_recurrence.cu) with three gates, in the same two
// variants chosen by the caller's plan (ops/kernels/rnn_plan.py):
//   persistent  (bf16 weights; rnn_common.cuh::rnn_persistent with the
//      GruCell below) the block's [H x 48] slice of W_hh (and of W_ih, when
//      it fits) resident in shared memory, h and the pooled sum in
//      registers, one cooperative launch per layer with one grid barrier
//      per step, wgmma m64n48k16 with r, z, n of a cell in one thread's
//      accumulator registers.  The input part and the recurrent part keep
//      separate accumulators (b_ih starts the one, b_hh the other), so
//      b_hn stays inside r * (...).
//   stepwise  (f32 weights, or shapes the resident design does not take)
//      the hoisted input product (rnn_common.cuh), then one launch per
//      step: each block owns 32 hidden units and 32 batch rows and the
//      three gate columns of round(h_{t-1}) @ W_hh (WMMA bf16 -> f32, three
//      warps, warp g owns gate g, 3-stage cp.async ring; or f32 FMAs); h
//      ping-pongs between two buffers.
// Kernels launch on the caller's stream, allocate nothing, and the host
// entry points return the first CUDA error.

#include "rnn_common.cuh"

namespace {

// Gate math + frozen-carry select + output for element (b, j) at step t,
// given the three h_{t-1} @ W_hh sums (without b_hh); gx holds x W_ih + b_ih.
template <bool POOL>
__device__ __forceinline__ void finish_gru(
    const float* __restrict__ gx, const float* __restrict__ b_hh,
    const int* __restrict__ lengths, const float* __restrict__ h_prev,
    float* __restrict__ h_next, float* __restrict__ seq,
    float* __restrict__ h_last, float* __restrict__ pooled,
    Bf16* __restrict__ hb_next, int T, int H, int t, int b, int j, float ar,
    float az, float an) {
  const float* g_row = gx + ((size_t)b * T + t) * 3 * (size_t)H;
  const float r = sigmoidf(g_row[j] + (ar + b_hh[j]));
  const float z = sigmoidf(g_row[H + j] + (az + b_hh[H + j]));
  const float n = tanhf(g_row[2 * H + j] + r * (an + b_hh[2 * H + j]));
  const size_t e = (size_t)b * H + j;
  const float h_old = h_prev[e];
  const float h_new = (1.0f - z) * n + z * h_old;
  const int len = lengths[b];
  const bool live = t < len;
  const float h = live ? h_new : h_old;
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

constexpr int SB = 32;   // f32 step tile: batch rows
constexpr int SJ = 32;   //                hidden units (x3 gate columns)
constexpr int SK = 32;   //                depth
constexpr int SR = 8;    // batch rows per thread (128 threads = 4 warps)

// One step with f32 weights on plain FMAs.
template <bool POOL>
__global__ void __launch_bounds__(128)
gru_step_kernel(const float* __restrict__ gx,       // [B, T, 3H]
                const float* __restrict__ whh,      // [H, 3H]
                const float* __restrict__ b_hh,     // [3H]
                const int* __restrict__ lengths,    // [B]
                const float* __restrict__ h_prev,   // [B, H]
                float* __restrict__ h_next,         // [B, H]
                float* __restrict__ seq,            // hs [B, T, H] | sum [B, H]
                float* __restrict__ h_last,         // [B, H]
                float* __restrict__ pooled,         // [B, H] (POOL only)
                int B, int T, int H, int t) {
  __shared__ float Hs[SK][SB + 1];
  __shared__ float Ws[SK][3 * SJ];
  const int tj = threadIdx.x % 32;       // hidden unit within the tile
  const int tr = threadIdx.x / 32;       // warp: rows tr*SR .. tr*SR+SR-1
  const int j0 = blockIdx.x * SJ;
  const int b0 = blockIdx.y * SB;
  const int G = 3 * H;
  float acc[SR][3] = {};
  for (int k0 = 0; k0 < H; k0 += SK) {
    for (int i = threadIdx.x; i < SB * SK; i += 128) {
      const int r = i / SK, kk = i % SK;
      const int b = b0 + r, k = k0 + kk;
      Hs[kk][r] = (b < B && k < H) ? h_prev[(size_t)b * H + k] : 0.0f;
    }
    for (int i = threadIdx.x; i < SK * 3 * SJ; i += 128) {
      const int kk = i / (3 * SJ), col = i % (3 * SJ);
      const int g = col / SJ, u = col % SJ;
      const int k = k0 + kk, j = j0 + u;
      Ws[kk][col] = (k < H && j < H) ? whh[(size_t)k * G + g * H + j] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < SK; ++kk) {
      float hv[SR], wv[3];
#pragma unroll
      for (int r = 0; r < SR; ++r) hv[r] = Hs[kk][tr * SR + r];
#pragma unroll
      for (int g = 0; g < 3; ++g) wv[g] = Ws[kk][g * SJ + tj];
#pragma unroll
      for (int r = 0; r < SR; ++r)
#pragma unroll
        for (int g = 0; g < 3; ++g) acc[r][g] += hv[r] * wv[g];
    }
    __syncthreads();
  }
  const int j = j0 + tj;
  if (j >= H) return;
#pragma unroll
  for (int r = 0; r < SR; ++r) {
    const int b = b0 + tr * SR + r;
    if (b < B)
      finish_gru<POOL>(gx, b_hh, lengths, h_prev, h_next, seq, h_last, pooled,
                       nullptr, T, H, t, b, j, acc[r][0], acc[r][1],
                       acc[r][2]);
  }
}

constexpr int WB = 32;    // tensor-core step tile: batch rows
constexpr int WJ = 32;    //                        hidden units
constexpr int WK = 64;    //                        depth
constexpr int WT = 96;    // threads: 3 warps, warp g owns gate g
constexpr int WC = 3 * WJ;
constexpr int WA_LD = WK + 8;
constexpr int WB_LD = WC + 8;
constexpr int WC_LD = WC + 4;
constexpr int WA_STAGE = WB * WA_LD;
constexpr int WB_STAGE = WK * WB_LD;
constexpr size_t STEP_SMEM =
    STAGES * (WA_STAGE + WB_STAGE) * sizeof(Bf16) + WB * WC_LD * sizeof(float);

// One step: gate sums of (rows b0.., units j0..) = hb_prev @ W_hh columns
// {g*H + j}, then the gate math.  Needs H % 8 == 0 (16-byte rows).
template <bool POOL>
__global__ void __launch_bounds__(WT)
gru_step_wmma(const float* __restrict__ gx, const Bf16* __restrict__ whh,
              const float* __restrict__ b_hh, const int* __restrict__ lengths,
              const float* __restrict__ h_prev,
              const Bf16* __restrict__ hb_prev, float* __restrict__ h_next,
              Bf16* __restrict__ hb_next, float* __restrict__ seq,
              float* __restrict__ h_last, float* __restrict__ pooled, int B,
              int T, int H, int t) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Bf16* As = reinterpret_cast<Bf16*>(smem_raw);
  Bf16* Bs = As + STAGES * WA_STAGE;
  float* Cs = reinterpret_cast<float*>(Bs + STAGES * WB_STAGE);
  const int g = threadIdx.x / 32;
  const int j0 = blockIdx.x * WJ;
  const int b0 = blockIdx.y * WB;
  const size_t G = 3 * (size_t)H;
  const int nk = (H + WK - 1) / WK;
  auto load = [&](int stage, int kc) {
    const int k0 = kc * WK;
    Bf16* a = As + stage * WA_STAGE;
    Bf16* bs = Bs + stage * WB_STAGE;
    for (int i = threadIdx.x; i < WB * (WK / 8); i += WT) {
      const int r = i / (WK / 8), kv = (i % (WK / 8)) * 8;
      const int b = b0 + r, k = k0 + kv;
      const bool ok = b < B && k < H;
      cp_async16(a + r * WA_LD + kv, ok ? hb_prev + (size_t)b * H + k : hb_prev,
                 ok);
    }
    for (int i = threadIdx.x; i < WK * (WC / 8); i += WT) {
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
  for (int e = threadIdx.x; e < WB * WJ; e += WT) {
    const int r = e / WJ, u = e % WJ;
    const int b = b0 + r, j = j0 + u;
    const float* cr = Cs + r * WC_LD;
    if (b < B && j < H)
      finish_gru<POOL>(gx, b_hh, lengths, h_prev, h_next, seq, h_last, pooled,
                       hb_next, T, H, t, b, j, cr[u], cr[WJ + u],
                       cr[2 * WJ + u]);
  }
}

// ---------------------------------------------------------------------------

int run_layer_f32(const float* x, const float* w_ih, const float* w_hh,
                  const float* b_ih, const float* b_hh, const int* lengths,
                  float* gx, float* h_a, float* h_b, float* seq,
                  float* h_last, float* pooled, int B, int T, int E, int H,
                  int pool, cudaStream_t stream) {
  int err = input_product(x, w_ih, b_ih, nullptr, gx, B * T, 3 * H, E,
                          false, stream);
  if (err != 0) return err;
  dim3 sgrid((H + SJ - 1) / SJ, (B + SB - 1) / SB);
  for (int t = 0; t < T; ++t) {
    const float* hp = (t % 2 == 0) ? h_a : h_b;
    float* hn = (t % 2 == 0) ? h_b : h_a;
    if (pool) {
      gru_step_kernel<true><<<sgrid, 128, 0, stream>>>(
          gx, w_hh, b_hh, lengths, hp, hn, seq, h_last, pooled, B, T, H, t);
    } else {
      gru_step_kernel<false><<<sgrid, 128, 0, stream>>>(
          gx, w_hh, b_hh, lengths, hp, hn, seq, h_last, pooled, B, T, H, t);
    }
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return 0;
}

int run_layer_bf16(const float* x, const Bf16* w_ih, const Bf16* w_hh,
                   const float* b_ih, const float* b_hh, const int* lengths,
                   Bf16* xb, float* gx, float* h_a, float* h_b, Bf16* hb_a,
                   Bf16* hb_b, float* seq, float* h_last, float* pooled,
                   int B, int T, int E, int H, int pool,
                   cudaStream_t stream) {
  if (H % 8 != 0) return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(
      gru_step_wmma<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)STEP_SMEM);
  if (err != 0) return err;
  err = (int)cudaFuncSetAttribute(
      gru_step_wmma<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)STEP_SMEM);
  if (err != 0) return err;
  err = input_product(x, w_ih, b_ih, xb, gx, B * T, 3 * H, E, true, stream);
  if (err != 0) return err;
  dim3 sgrid((H + WJ - 1) / WJ, (B + WB - 1) / WB);
  for (int t = 0; t < T; ++t) {
    const bool even = t % 2 == 0;
    const float* hp = even ? h_a : h_b;
    float* hn = even ? h_b : h_a;
    const Bf16* hbp = even ? hb_a : hb_b;
    Bf16* hbn = even ? hb_b : hb_a;
    if (pool) {
      gru_step_wmma<true><<<sgrid, WT, STEP_SMEM, stream>>>(
          gx, w_hh, b_hh, lengths, hp, hbp, hn, hbn, seq, h_last, pooled, B,
          T, H, t);
    } else {
      gru_step_wmma<false><<<sgrid, WT, STEP_SMEM, stream>>>(
          gx, w_hh, b_hh, lengths, hp, hbp, hn, hbn, seq, h_last, pooled, B,
          T, H, t);
    }
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return 0;
}

// Gate math of the persistent variant: a = x W_ih + b_ih, g = h W_hh +
// b_hh; b_hn stays inside r * (...).
struct GruCell {
  static constexpr int G = 3;
  static __device__ __forceinline__ float update(const float (&a)[3],
                                                 const float (&g)[3],
                                                 float h_old, float&) {
    const float r = fast_sigmoid(a[0] + g[0]);
    const float z = fast_sigmoid(a[1] + g[1]);
    const float n = fast_tanh(a[2] + r * g[2]);
    return (1.0f - z) * n + z * h_old;
  }
};

}  // namespace

// One GRU layer, persistent variant (bf16 weights, H % 8 == 0).  Arguments
// as vfr_lstm_layer_persistent (lstm_recurrence.cu) with three gates and
// the two biases b_ih, b_hh [3H].
extern "C" int vfr_gru_layer_persistent(
    const float* x, const void* w_ih, const void* w_hh, const float* b_ih,
    const float* b_hh, const int* lengths, void* xb, float* gx, void* hb,
    unsigned* counter, float* hs, float* h_last, float* pooled, int B, int T,
    int E, int H, int pool, int nwg, int fuse,
    int grid_x, int grid_y, int smem, void* stream, long long* timeline) {
  PersistentArgs a{};
  a.w_ih = static_cast<const Bf16*>(w_ih);
  a.w_hh = static_cast<const Bf16*>(w_hh);
  a.b_ih = b_ih;
  a.b_hh = b_hh;
  a.lengths = lengths;
  a.hb = static_cast<Bf16*>(hb);
  a.hs = hs;
  a.h_last = h_last;
  a.pooled = pooled;
  a.counter = counter;
  a.B = B; a.T = T; a.E = E; a.Ep = (E + PKC - 1) / PKC * PKC; a.H = H;
  a.pool = pool;
  a.timeline = timeline;
  return launch_persistent<GruCell>(x, a, static_cast<Bf16*>(xb), gx, nwg,
                                    fuse, grid_x, grid_y, smem,
                                    static_cast<cudaStream_t>(stream));
}

// One GRU layer, stepwise variant.  x [B, T, E] f32; w_ih [E, 3H], w_hh
// [H, 3H] in bf16
// (weights_bf16 = 1, needs H % 8 == 0) or f32; b_ih, b_hh [3H] f32;
// lengths [B] int32.  Scratch from the caller: gx [B, T, 3H] f32; h_a, h_b
// [B, H] f32 with h_a zeroed; for bf16 weights also xb [B*T, round8(E)]
// and hb_a, hb_b [B, H] bf16 with hb_a zeroed (unused, may be null, for
// f32 weights).  seq is hs [B, T, H] (pool = 0) or a zeroed sum [B, H]
// (pool = 1).  Outputs: h_last [B, H]; pooled [B, H] when pool = 1.
extern "C" int vfr_gru_layer(const float* x, const void* w_ih,
                             const void* w_hh, const float* b_ih,
                             const float* b_hh, const int* lengths, void* xb,
                             float* gx, float* h_a, float* h_b, void* hb_a,
                             void* hb_b, float* seq, float* h_last,
                             float* pooled, int B, int T, int E, int H,
                             int weights_bf16, int pool, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (weights_bf16) {
    return run_layer_bf16(x, static_cast<const Bf16*>(w_ih),
                          static_cast<const Bf16*>(w_hh), b_ih, b_hh, lengths,
                          static_cast<Bf16*>(xb), gx, h_a, h_b,
                          static_cast<Bf16*>(hb_a), static_cast<Bf16*>(hb_b),
                          seq, h_last, pooled, B, T, E, H, pool, s);
  }
  return run_layer_f32(x, static_cast<const float*>(w_ih),
                       static_cast<const float*>(w_hh), b_ih, b_hh, lengths,
                       gx, h_a, h_b, seq, h_last, pooled, B, T, E, H, pool, s);
}
