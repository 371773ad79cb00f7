// The core of a KDA (Kimi Delta Attention) token mixer, for the Kimi
// Linear query tower (ops/kernels/kda_kernel.py::kda_attend): from the
// conv'd q, k, v (columns of qkv [Bsz, T, ld], read in place), the
// per-channel log decay g [Bsz, T, H D] and beta [Bsz, T, H] (f32) to the
// recurrence's output o [Bsz, T, H D] (f32), in one launch.  Per head:
//
//   q, k <- q / sqrt(|q|^2 + eps), k / sqrt(|k|^2 + eps)
//   S_t = (I - beta_t k_t k_t^T) Diag(exp g_t) S_{t-1} + beta_t k_t v_t^T
//   o_t = scale S_t^T q_t,  S_0 = 0
//
// Every query starts from S_0 = 0 and is at most one chunk (kChunk = 64
// tokens) long, so the kernel takes the recurrence's matrix form over the
// chunk (the delta rule's WY / UT form) and never forms the D x D state.
// With G_t the running sum of g over the chunk (per channel),
//
//   A_ts = sum_c k_t[c] k_s[c] exp(G_t[c] - G_s[c])    (s < t)
//   B_ts = sum_c q_t[c] k_s[c] exp(G_t[c] - G_s[c])    (s <= t)
//   (I + Diag(beta) A) U = Diag(beta) V                 (forward solve)
//   o_t = scale sum_{s <= t} B_ts u_s
//
// The per-channel decay is taken pair by pair, exp(G_t - G_s) with s <= t:
// never above 1, so no decay overflows or underflows to a wrong value
// however strong it is (a decay relative to one reference token of the
// chunk, exp(G_t - G_r) exp(G_r - G_s), overflows f32 once a channel's
// decay over the chunk passes e^88).
//
// One block of 128 threads a (sequence, head).  The block loads its head's
// live rows into shared memory (f32), normalises q and k (a warp a token),
// forms A and B (a warp a pair (t, s), its lanes over the channels, then a
// shuffle reduction), and each thread solves for and reads out its own
// channel's column of U and o, so the solve needs no barrier.  Rows past a
// sequence's length are written as 0.  Everything in f32.
//
// The name keeps "rnn_" for one reason: the benchmark's trace reader
// (vfrbench/trace.py::replays) finds a serving batch's graph replay by a
// recurrence kernel's name, and the Kimi Linear cell's mfu.batch reads
// nothing without one.

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;      // the longest sequence: one chunk
constexpr int kMaxDim = 128;    // head width: at most one channel a thread

template <typename E>
struct Args {
  const E* qkv;
  const float* g;
  const float* beta;
  const long long* lengths;
  float* o;
  int T, ld, H, D;
  float scale, eps;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Shared memory (floats): q, k, v (then U in v's place) and G, each
// [L][D]; A and B [L][L]; beta [L].  L is the launch's T.
__host__ __device__ inline size_t smem_floats(int L, int D) {
  return 4 * static_cast<size_t>(L) * D + 2 * static_cast<size_t>(L) * L + L;
}

// DW = D / 32: channels a lane holds in the pair loop.
template <typename E, int DW>
__global__ void __launch_bounds__(kThreads)
    kda_rnn_chunk(const Args<E> a) {
  constexpr int D = DW * 32;
  extern __shared__ float smem[];
  const int L = a.T;
  float* qs = smem;
  float* ks = qs + L * D;
  float* vs = ks + L * D;       // v, then U
  float* gs = vs + L * D;       // g, then its running sum G
  float* am = gs + L * D;       // A [t][s]
  float* bm = am + L * L;       // B [t][s]
  float* bs = bm + L * L;       // beta

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const long long len = a.lengths[b];
  const int n = len < 0 ? 0 : (len > L ? L : static_cast<int>(len));
  const int HD = a.H * D;

  // load the live rows
  for (int i = tid; i < n * D; i += kThreads) {
    const int t = i / D, c = i % D;
    const E* row = a.qkv + (static_cast<long long>(b) * L + t) * a.ld;
    qs[i] = to_f(row[h * D + c]);
    ks[i] = to_f(row[HD + h * D + c]);
    vs[i] = to_f(row[2 * HD + h * D + c]);
    gs[i] = a.g[(static_cast<long long>(b) * L + t) * HD + h * D + c];
  }
  for (int t = tid; t < n; t += kThreads)
    bs[t] = a.beta[(static_cast<long long>(b) * L + t) * a.H + h];
  __syncthreads();

  // G: the running sum of g over the chunk, a thread a channel
  if (tid < D) {
    float acc = 0.f;
    for (int t = 0; t < n; ++t) {
      acc += gs[t * D + tid];
      gs[t * D + tid] = acc;
    }
  }
  // q and k to unit length, a warp a token
  for (int t = warp; t < n; t += kWarps) {
    float sq = 0.f, sk = 0.f;
#pragma unroll
    for (int j = 0; j < DW; ++j) {
      const float x = qs[t * D + lane + 32 * j], y = ks[t * D + lane + 32 * j];
      sq += x * x;
      sk += y * y;
    }
    const float rq = rsqrtf(warp_sum(sq) + a.eps);
    const float rk = rsqrtf(warp_sum(sk) + a.eps);
#pragma unroll
    for (int j = 0; j < DW; ++j) {
      qs[t * D + lane + 32 * j] *= rq;
      ks[t * D + lane + 32 * j] *= rk;
    }
  }
  __syncthreads();

  // A (s < t) and B (s <= t), a warp a pair
  const int pairs = n * (n + 1) / 2;
  for (int p = warp; p < pairs; p += kWarps) {
    int t = static_cast<int>((sqrtf(8.f * p + 1.f) - 1.f) * 0.5f);
    while (t * (t + 1) / 2 > p) --t;
    while ((t + 1) * (t + 2) / 2 <= p) ++t;
    const int s = p - t * (t + 1) / 2;
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int j = 0; j < DW; ++j) {
      const int c = lane + 32 * j;
      const float ke = ks[s * D + c] * expf(gs[t * D + c] - gs[s * D + c]);
      sa += ks[t * D + c] * ke;
      sb += qs[t * D + c] * ke;
    }
    sa = warp_sum(sa);
    sb = warp_sum(sb);
    if (lane == 0) {
      am[t * L + s] = sa;
      bm[t * L + s] = sb;
    }
  }
  __syncthreads();

  // the forward solve and the read-out, a thread a channel
  if (tid < D) {
    const int c = tid;
    for (int t = 0; t < n; ++t) {
      float acc = vs[t * D + c];
      for (int s = 0; s < t; ++s) acc -= am[t * L + s] * vs[s * D + c];
      vs[t * D + c] = bs[t] * acc;
    }
    float* out = a.o + static_cast<long long>(b) * L * HD + h * D + c;
    for (int t = 0; t < n; ++t) {
      float acc = 0.f;
      for (int s = 0; s <= t; ++s) acc += bm[t * L + s] * vs[s * D + c];
      out[static_cast<long long>(t) * HD] = a.scale * acc;
    }
    for (int t = n; t < L; ++t) out[static_cast<long long>(t) * HD] = 0.f;
  }
}

template <typename E, int DW>
cudaError_t launch(const Args<E>& a, int Bsz, cudaStream_t stream) {
  const size_t smem = smem_floats(a.T, DW * 32) * sizeof(float);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kernel = kda_rnn_chunk<E, DW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(Bsz * a.H), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch(const Args<E>& a, int Bsz, cudaStream_t s) {
  switch (a.D) {
    case 32: return launch<E, 1>(a, Bsz, s);
    case 64: return launch<E, 2>(a, Bsz, s);
    case 96: return launch<E, 3>(a, Bsz, s);
    case 128: return launch<E, 4>(a, Bsz, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename E>
Args<E> args(const void* qkv, const float* g, const float* beta,
             const long long* lengths, float* o, int T, int ld, int H, int D,
             float scale, float eps) {
  Args<E> a;
  a.qkv = static_cast<const E*>(qkv);
  a.g = g;
  a.beta = beta;
  a.lengths = lengths;
  a.o = o;
  a.T = T;
  a.ld = ld;
  a.H = H;
  a.D = D;
  a.scale = scale;
  a.eps = eps;
  return a;
}

}  // namespace

// qkv [Bsz, T, ld] at bf16 (bf16 = 1) or f32: q in columns [0, H D), k in
// [H D, 2 H D), v in [2 H D, 3 H D); g [Bsz, T, H D] and beta [Bsz, T, H]
// f32, lengths [Bsz] int64; o [Bsz, T, H D] f32.  Returns a CUDA error
// code (cudaErrorInvalidValue for shapes the kernel does not take: T at
// most 64, D one of 32, 64, 96, 128, ld at least 3 H D).
extern "C" int vfr_kda_chunk(const void* qkv, const float* g,
                             const float* beta, const long long* lengths,
                             float* o, int Bsz, int T, int ld, int H, int D,
                             int bf16, float scale, float eps, void* stream) {
  if (Bsz <= 0 || T <= 0 || T > kChunk || H <= 0 || D <= 0 ||
      D > kMaxDim || D % 32 || static_cast<long long>(Bsz) * H > INT_MAX ||
      static_cast<long long>(ld) < 3LL * H * D)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return static_cast<int>(dispatch(
        args<__nv_bfloat16>(qkv, g, beta, lengths, o, T, ld, H, D, scale,
                            eps),
        Bsz, s));
  return static_cast<int>(dispatch(
      args<float>(qkv, g, beta, lengths, o, T, ld, H, D, scale, eps), Bsz,
      s));
}
