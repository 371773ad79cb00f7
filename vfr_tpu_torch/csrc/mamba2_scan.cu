// The Mamba-2 mixer between its two GEMMs, for the Nemotron-H query tower
// (ops/kernels/mamba2_kernel.py::mamba2_chain): from in_proj's product
// zxd [Bsz, T, ld] (z, xBC and dt as column ranges of each row, read in
// place) to out_proj's operand y [Bsz, T, H P], in one launch:
//
//   xBC = silu(conv_b + the depthwise causal conv of xBC with conv_w)
//   dt  = softplus(dt + dt_bias),  A = -exp(A_log)
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,  y_t = h_t C_t + D x_t
//   g   = y silu(z),  y_out = g / RMS(g over a group's H P / G channels)
//                             * gate_norm
//
// Every step in f32; the one rounding is y_out's, to zxd's type (bf16 or
// f32).  Tokens past a sequence's length are written as 0 (their scan
// output is 0, so is the norm's).  Inputs: conv_w [conv, K] and conv_b
// [conv] (or null) and gate_norm [H P] at zxd's type; dt_bias, A_log, D
// [H] f32; lengths [Bsz] int64.
//
// It replaces no Pallas kernel: the JAX package has no decoder-LM tower.
// It was added because the chain was seven PyTorch passes over f32
// [Bsz, T, 6144] tensors around a scan-only kernel, ~3.6 GB of device
// traffic a block at the published widths for ~0.18 GB of inputs and
// outputs.
//
// One block of 128 threads a (sequence, head); a group's H / G heads are
// one thread-block cluster (at most 8, the portable size).  A block
// convolves its head's P x channels and its share (N G / H channels) of
// its group's B and C, so every element of zxd is read once.  The scan
// runs in its matrix ("quadratic") form over chunks of up to 32 tokens,
// in f32 FMAs:
//
//   y_t = sum_{s <= t} exp(sum_{s < u <= t} dt_u A) (C_t . B_s) dt_s x_s
//         + D x_t
//
// C_t . B_s is summed over the cluster: each block's partial dot over its
// share of B and C is read by the others through distributed shared
// memory.  The [T, T] products stay in shared memory, and at T <= 32 (the
// bulk cells' queries are at most 24 tokens) the P x N state is never
// formed.  A longer sequence carries the state from chunk to chunk in
// shared memory (each block then gathers its group's B and C from the
// cluster).  The group norm's sum of squares is the second exchange: each
// block's per-token partial, summed over the cluster in rank order.
//
// Bound at the bulk cells' shape (256 queries of 4-24 tokens, 64 heads of
// 64, 8 groups of state 128): bytes, zxd's live rows read once and y
// written once (~0.04 ms); the matrix form's f32 operations take a fifth
// of that.  The recurrent form would need 5 P N operations a token and
// head (~0.14 ms of f32 FMAs).  On an H100 (700 W) it takes ~0.35 ms
// there: latency, each block waiting at three cluster barriers between
// short phases, 6 blocks an SM at 80 registers.
//
// The name keeps "rnn_" for one reason: the benchmark's trace reader
// (vfrbench/trace.py::replays) finds a serving batch's graph replay by a
// recurrence kernel's name, and the Nemotron-H cell's mfu.batch reads
// nothing without one.

#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 6;    // resident blocks an SM: <= 80 registers
constexpr int kChunk = 32;       // tokens a chunk: the side of its products
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kMaxTaps = 8;

template <typename E>
struct Args {
  const E* zxd;
  const E* conv_w;
  const E* conv_b;
  const float* dt_bias;
  const float* A_log;
  const float* D;
  const E* norm_w;
  const long long* lengths;
  E* y;
  int T, ld, H, G, N, K, HG, NS;
  float eps;
  bool vec;     // 16-byte global accesses
  bool multi;   // T > kChunk: the state is carried between chunks
};

__host__ __device__ inline int up4(int v) { return (v + 3) & ~3; }

// Row stride of a block's B and C shares: 16-byte rows (the share's tail
// padded with 0), and rows 4 banks apart, so that 4-wide reads of
// neighbouring rows do not collide.
__host__ __device__ inline int share_stride(int NS) { return up4(NS) + 4; }

// Shared-memory offsets (floats; every array starts 16-byte aligned).
struct Layout {
  int raw, w, bias, nw, x, b, c, z, dt, cum, ein, wl, pcb, wm, ss, scale;
  int state, fb, fc, total;
};

// es: bytes of zxd's element.  raw holds a chunk's rows of zxd as read:
// the block's x, B and C columns of n + K - 1 tokens, then z of n.
__host__ __device__ inline Layout layout(int P, int NS, int N, int K, int L,
                                         int es, bool multi) {
  Layout l;
  const int CL = P + 2 * NS, L4 = up4(L), NSp = share_stride(NS);
  int o = 0;
  l.raw = o;   o += up4(((L + K - 1) * CL + L * P) * es / 4 + 1);
  l.w = o;     o += up4(CL * K);       // conv taps, [K][CL]
  l.bias = o;  o += up4(CL);
  l.nw = o;    o += up4(P);            // gate_norm of the head
  l.x = o;     o += L4 * P;            // conv'd x [L4][P], rows past n 0
  l.b = o;     o += L * NSp;           // conv'd B share [L][NSp]
  l.c = o;     o += L * NSp;           // conv'd C share
  l.z = o;     o += L * P;             // silu(z), then g, [L][P]
  l.dt = o;    o += L4;
  l.cum = o;   o += 2 * L4;            // sum_{u <= t} dt_u A, in f64
  l.ein = o;   o += L4;                // exp(sum_{u <= t} dt_u A)
  l.wl = o;    o += L4;                // the chunk's last row of weights
  l.pcb = o;   o += L * L4;            // partial C_t . B_s (the cluster's)
  l.wm = o;    o += L * L4;            // weights of x_s in y_t
  l.ss = o;    o += L4;                // partial sums of squares (cluster)
  l.scale = o; o += L4;
  l.state = l.fb = l.fc = o;
  if (multi) {
    l.state = o; o += P * N;
    l.fb = o;    o += L * N;
    l.fc = o;    o += L * N;
  }
  l.total = o;
  return l;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float v, float* out) { *out = v; }
__device__ __forceinline__ void put(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

template <int V, typename E>
__device__ __forceinline__ void store(E* p, const float (&v)[V]) {
  if constexpr (V * sizeof(E) == 16) {
    uint4 raw;
    E* e = reinterpret_cast<E*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) put(v[i], e + i);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) put(v[i], p + i);
  }
}

// V consecutive floats of shared memory, 16 bytes at a time where V allows
// (V > 1 only at 16-byte aligned addresses).
template <int V>
__device__ __forceinline__ void ldf(const float* p, float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}

template <int V>
__device__ __forceinline__ void stf(float* p, const float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}

__device__ __forceinline__ float silu(float v) {
  return v / (1.f + expf(-v));
}

__device__ __forceinline__ float softplus(float v) {   // PyTorch's, beta 1
  return v > 20.f ? v : log1pf(expf(v));
}

// The conv row (and, past di, zxd's column) of block channel c: the
// head's x, then the block's share of its group's B, then of C.
__device__ __forceinline__ int conv_row(int c, int P, int NS, int h, int g,
                                        int rank, int di, int G, int N) {
  if (c < P) return h * P + c;
  if (c < P + NS) return di + g * N + rank * NS + (c - P);
  return di + G * N + g * N + rank * NS + (c - P - NS);
}

template <int V, typename E>
__device__ __forceinline__ void fetch(E* dst, const E* src) {
  if constexpr (V * sizeof(E) == 16) {
    __pipeline_memcpy_async(dst, src, 16);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) dst[e] = src[e];
  }
}

template <int V, typename E>
__device__ __forceinline__ void lds(const E* p, float (&v)[V]) {
  if constexpr (V * sizeof(E) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const E* e = reinterpret_cast<const E*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f(p[i]);
  }
}

// Phase A: a chunk's n live tokens from zxd into shared memory.  Its rows
// are copied as they are (every copy in flight at once, the conv's K - 1
// earlier tokens too, zeros before the first), then x, B and C go through
// the conv and SiLU, z through SiLU, dt through its softplus.  V elements
// an access.
template <int V, typename E, int P>
__device__ __forceinline__ void stage(const Args<E>& a, float* sm,
                                      const Layout& l, size_t row0, int t0,
                                      int n, int h, int g, int rank,
                                      float A, float dtb) {
  const int NS = a.NS, K = a.K, di = a.H * P, CL = P + 2 * NS;
  const int NSp = share_stride(NS), conv = di + 2 * a.G * a.N;
  const int cv = CL / V;
  E* raw = reinterpret_cast<E*>(sm + l.raw);
  E* rawz = raw + (n + K - 1) * CL;
  for (int i = threadIdx.x; i < (n + K - 1) * cv; i += kThreads) {
    const int r = i / cv, c = (i % cv) * V;
    const int tt = t0 - (K - 1) + r;
    if (tt < 0) {
#pragma unroll
      for (int e = 0; e < V; ++e) put(0.f, raw + r * CL + c + e);
    } else {
      fetch<V>(raw + r * CL + c,
               a.zxd + (row0 + tt) * a.ld + di +
                   conv_row(c, P, NS, h, g, rank, di, a.G, a.N));
    }
  }
  for (int i = threadIdx.x; i < n * (P / V); i += kThreads) {
    const int t = i / (P / V), p = (i % (P / V)) * V;
    fetch<V>(rawz + t * P + p, a.zxd + (row0 + t0 + t) * a.ld + h * P + p);
  }
  __pipeline_commit();
  if (threadIdx.x < 32) {
    // dt, and the running sums of dt A by a scan over the warp (n <= 32)
    // in f64: a difference of two is then each span's sum to f32 rounding
    const int t = threadIdx.x;
    float d = 0.f;
    if (t < n)
      d = softplus(to_f(a.zxd[(row0 + t0 + t) * a.ld + di + conv + h]) +
                   dtb);
    double cum = static_cast<double>(d * A);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, cum, o);
      if (t >= o) cum += u;
    }
    if (t < n) {
      sm[l.dt + t] = d;
      reinterpret_cast<double*>(sm + l.cum)[t] = cum;
    }
  }
  for (int i = threadIdx.x; i < (up4(n) - n) * P; i += kThreads)
    sm[l.x + n * P + i] = 0.f;
  if (NS % 4)                           // the shares' padding
    for (int i = threadIdx.x; i < n * (up4(NS) - NS); i += kThreads) {
      const int t = i / (up4(NS) - NS), k = NS + i % (up4(NS) - NS);
      sm[l.b + t * NSp + k] = 0.f;
      sm[l.c + t * NSp + k] = 0.f;
    }
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int i = threadIdx.x; i < n * cv; i += kThreads) {
    const int t = i / cv, c = (i % cv) * V;
    float v[V], w[V], acc[V];
    ldf<V>(sm + l.bias + c, acc);
    for (int j = 0; j < K; ++j) {         // raw row t + j: token t - K + 1 + j
      lds<V>(raw + (t + j) * CL + c, v);
      ldf<V>(sm + l.w + j * CL + c, w);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = fmaf(v[e], w[e], acc[e]);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = silu(acc[e]);
    stf<V>(c < P        ? sm + l.x + t * P + c
           : c < P + NS ? sm + l.b + t * NSp + (c - P)
                        : sm + l.c + t * NSp + (c - P - NS), acc);
  }
  for (int i = threadIdx.x; i < n * (P / V); i += kThreads) {
    const int t = i / (P / V), p = (i % (P / V)) * V;
    float v[V];
    lds<V>(rawz + t * P + p, v);
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = silu(v[e]);
    stf<V>(sm + l.z + t * P + p, v);
  }
}

// A chunk's nt rows of y: the n live ones scaled, the rest 0.
template <int V, typename E, int P>
__device__ __forceinline__ void write_rows(const Args<E>& a, const float* sm,
                                           const Layout& l, E* y0, int n,
                                           int nt) {
  const int di = a.H * P;
  for (int i = threadIdx.x; i < nt * (P / V); i += kThreads) {
    const int t = i / (P / V), p = (i % (P / V)) * V;
    float v[V];
    if (t < n) {
      const float s = sm[l.scale + t];
      float w[V];
      ldf<V>(sm + l.z + t * P + p, v);
      ldf<V>(sm + l.nw + p, w);
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = v[e] * s * w[e];
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = 0.f;
    }
    store<V>(y0 + static_cast<size_t>(t) * di + p, v);
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename E, int P>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mamba2_rnn_scan(const Args<E> a) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int R = kThreads / P;               // threads a column of y
  constexpr int KT = (kChunk + R - 1) / R;      // tokens a thread
  constexpr int V = 16 / sizeof(E);
  const int tid = threadIdx.x;
  const int H = a.H, HG = a.HG, NS = a.NS, N = a.N, K = a.K, T = a.T;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int g = h / HG;
  const int rank = h % HG;                      // the cluster's block rank
  const int di = H * P, CL = P + 2 * NS, NSp = share_stride(NS);
  const int L = min(T, kChunk), L4 = up4(L);
  const Layout l = layout(P, NS, N, K, L, sizeof(E), a.multi);
  const int len = static_cast<int>(
      min(max(a.lengths[b], 0LL), static_cast<long long>(T)));

  for (int i = tid; i < CL * K; i += kThreads) {
    const int j = i / CL, c = i % CL;
    sm[l.w + i] = to_f(a.conv_w[static_cast<size_t>(
        conv_row(c, P, NS, h, g, rank, di, a.G, N)) * K + j]);
  }
  for (int c = tid; c < CL; c += kThreads)
    sm[l.bias + c] = a.conv_b == nullptr ? 0.f : to_f(a.conv_b[
        conv_row(c, P, NS, h, g, rank, di, a.G, N)]);
  for (int p = tid; p < P; p += kThreads)
    sm[l.nw + p] = to_f(a.norm_w[h * P + p]);
  if (a.multi)
    for (int i = tid; i < P * N; i += kThreads) sm[l.state + i] = 0.f;
  const float A = -expf(a.A_log[h]);
  const float Dh = a.D[h];
  const float dtb = a.dt_bias[h];
  const float inv_group = 1.f / static_cast<float>(P * HG);
  const size_t row0 = static_cast<size_t>(b) * T;
  const int p = tid % P, tq = tid / P;
  const int warp = tid / 32, lane = tid % 32;
  bool exchanged = false;

  for (int t0 = 0; t0 < T; t0 += L) {
    const int nt = min(L, T - t0);
    const int n = max(0, min(nt, len - t0));
    E* y0 = a.y + (row0 + t0) * di + h * P;
    __syncthreads();                  // the last chunk's rows are written
    if (n == 0) {
      if (a.vec) write_rows<V, E, P>(a, sm, l, y0, 0, nt);
      else write_rows<1, E, P>(a, sm, l, y0, 0, nt);
      continue;
    }
    exchanged = true;
    const bool carry = a.multi && t0 + nt < len;   // a live chunk follows
    if (a.vec) stage<V, E, P>(a, sm, l, row0, t0, n, h, g, rank, A, dtb);
    else stage<1, E, P>(a, sm, l, row0, t0, n, h, g, rank, A, dtb);
    __syncthreads();

    // Phase B: the partial dots C_t . B_s over the block's share, and the
    // weights exp(sum_{s < u <= t} dt_u A) dt_s (0 past t and past n).
    const int n4 = up4(n);
    const double* cum = reinterpret_cast<const double*>(sm + l.cum);
    for (int i = tid; i < n * n4; i += kThreads) {
      const int t = i / n4, s = i % n4;
      float cb = 0.f, e = 0.f;
      if (s <= t) {
        const float* ct = sm + l.c + t * NSp;
        const float* bs = sm + l.b + s * NSp;
        for (int k = 0; k < NS; k += 4) {
          const float4 cv = *reinterpret_cast<const float4*>(ct + k);
          const float4 bv = *reinterpret_cast<const float4*>(bs + k);
          cb = fmaf(cv.x, bv.x, cb);
          cb = fmaf(cv.y, bv.y, cb);
          cb = fmaf(cv.z, bv.z, cb);
          cb = fmaf(cv.w, bv.w, cb);
        }
        e = expf(static_cast<float>(cum[t] - cum[s])) * sm[l.dt + s];
        if (t == n - 1) sm[l.wl + s] = e;
      }
      sm[l.pcb + t * L4 + s] = cb;
      sm[l.wm + t * L4 + s] = e;
    }
    if (a.multi) {
      for (int t = tid; t < n; t += kThreads)
        sm[l.ein + t] = expf(static_cast<float>(cum[t]));
    }
    cluster.sync();                   // every block's partial dots are in

    // Phase C: the weights times the group's C_t . B_s (rank order); with
    // a state, the group's B and C rows gathered from the cluster.
    for (int i = tid; i < n * n; i += kThreads) {
      const int t = i / n, s = i % n;
      if (s > t) continue;
      float cb = 0.f;
      for (int q = 0; q < HG; ++q)
        cb += cluster.map_shared_rank(sm, q)[l.pcb + t * L4 + s];
      sm[l.wm + t * L4 + s] *= cb;
    }
    if (a.multi) {
      for (int i = tid; i < n * N; i += kThreads) {
        const int t = i / N, m = i % N;
        const float* rem = cluster.map_shared_rank(sm, m / NS);
        sm[l.fb + t * N + m] = rem[l.b + t * NSp + m % NS];
        sm[l.fc + t * N + m] = rem[l.c + t * NSp + m % NS];
      }
    }
    __syncthreads();

    // Phase D: y_t = sum_s w_ts x_s (+ the carried state's part) + D x_t,
    // then g = y silu(z) in place of silu(z).  A thread: column p of y,
    // tokens tq, tq + R, ..., four at a time.
    for (int k0 = 0; k0 < KT && tq + R * k0 < n; k0 += 4) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const int last = min(n - 1, tq + R * (k0 + 3));
      for (int s = 0; s <= last; s += 4) {
        float xv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = sm[l.x + (s + j) * P + p];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int t = tq + R * (k0 + k);
          if (t < n && s <= t) {
            const float4 w =
                *reinterpret_cast<const float4*>(sm + l.wm + t * L4 + s);
            acc[k] = fmaf(w.x, xv[0], acc[k]);
            acc[k] = fmaf(w.y, xv[1], acc[k]);
            acc[k] = fmaf(w.z, xv[2], acc[k]);
            acc[k] = fmaf(w.w, xv[3], acc[k]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = tq + R * (k0 + k);
        if (t >= n) continue;
        if (a.multi && t0 > 0) {
          float v = 0.f;
          for (int m = 0; m < N; ++m)
            v = fmaf(sm[l.fc + t * N + m], sm[l.state + p * N + m], v);
          acc[k] = fmaf(sm[l.ein + t], v, acc[k]);
        }
        sm[l.z + t * P + p] *= fmaf(Dh, sm[l.x + t * P + p], acc[k]);
      }
    }
    if (carry) {
      // The state at the chunk's end: exp(sum_u dt_u A) h + sum_s w_(n-1)s
      // x_s B_s^T, after every read of the state above.
      __syncthreads();
      const float decay = sm[l.ein + n - 1];
      for (int i = tid; i < P * N; i += kThreads) {
        const int pp = i / N, m = i % N;
        float v = decay * sm[l.state + i];
        for (int s = 0; s < n; ++s)
          v = fmaf(sm[l.wl + s] * sm[l.x + s * P + pp], sm[l.fb + s * N + m],
                   v);
        sm[l.state + i] = v;
      }
    }
    __syncthreads();

    // Phase E: each token's sum of g^2 over the head, then over the
    // cluster (rank order), and the norm's scale.
    for (int t = warp; t < n; t += kThreads / 32) {
      float v = 0.f;
      for (int pp = lane; pp < P; pp += 32) {
        const float gv = sm[l.z + t * P + pp];
        v = fmaf(gv, gv, v);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) sm[l.ss + t] = v;
    }
    cluster.sync();                   // every block's sums are in
    for (int t = tid; t < n; t += kThreads) {
      float tot = 0.f;
      for (int q = 0; q < HG; ++q)
        tot += cluster.map_shared_rank(sm, q)[l.ss + t];
      sm[l.scale + t] = rsqrtf(tot * inv_group + a.eps);
    }
    // The last exchange: no block leaves while another reads its sums.  A
    // chunk that carries needs no such barrier: the next chunk's first
    // exchange comes before its sums are rewritten.
    if (!carry) cluster_arrive();
    __syncthreads();
    if (a.vec) write_rows<V, E, P>(a, sm, l, y0, n, nt);
    else write_rows<1, E, P>(a, sm, l, y0, n, nt);
  }
  if (exchanged) cluster_wait();
}

template <typename E, int P>
cudaError_t launch(const Args<E>& a, int Bsz, cudaStream_t stream) {
  const int L = a.T < kChunk ? a.T : kChunk;
  const size_t smem =
      sizeof(float) *
      layout(P, a.NS, a.N, a.K, L, sizeof(E), a.multi).total;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kernel = mamba2_rnn_scan<E, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(Bsz * a.H));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.HG;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch(const Args<E>& a, int Bsz, int P, cudaStream_t s) {
  switch (P) {
    case 8: return launch<E, 8>(a, Bsz, s);
    case 16: return launch<E, 16>(a, Bsz, s);
    case 32: return launch<E, 32>(a, Bsz, s);
    case 64: return launch<E, 64>(a, Bsz, s);
    case 128: return launch<E, 128>(a, Bsz, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename E>
Args<E> args(const void* zxd, const void* conv_w, const void* conv_b,
             const float* dt_bias, const float* A_log, const float* D,
             const void* norm_w, const long long* lengths, void* y, int T,
             int ld, int H, int P, int G, int N, int K, float eps) {
  Args<E> a;
  a.zxd = static_cast<const E*>(zxd);
  a.conv_w = static_cast<const E*>(conv_w);
  a.conv_b = static_cast<const E*>(conv_b);
  a.dt_bias = dt_bias;
  a.A_log = A_log;
  a.D = D;
  a.norm_w = static_cast<const E*>(norm_w);
  a.lengths = lengths;
  a.y = static_cast<E*>(y);
  a.T = T;
  a.ld = ld;
  a.H = H;
  a.G = G;
  a.N = N;
  a.K = K;
  a.HG = H / G;
  a.NS = N / a.HG;
  a.eps = eps;
  const size_t es = sizeof(E);
  a.vec = reinterpret_cast<uintptr_t>(zxd) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(y) % 16 == 0 && ld * es % 16 == 0 &&
          P * es % 16 == 0 && a.NS * es % 16 == 0;
  a.multi = T > kChunk;
  return a;
}

}  // namespace

// zxd [Bsz, T, ld] at bf16 (bf16 = 1) or f32: z in columns [0, H P), xBC
// in [H P, 2 H P + 2 G N), dt in the next H.  Returns a CUDA error code
// (cudaErrorInvalidValue for shapes the kernel does not take: H a
// multiple of G with at most 8 heads a group, N a multiple of H / G, P a
// power of two in 8..128, 1..8 conv taps, ld at least 2 H P + 2 G N + H).
extern "C" int vfr_mamba2_chain(const void* zxd, const void* conv_w,
                                const void* conv_b, const float* dt_bias,
                                const float* A_log, const float* D,
                                const void* norm_w, const long long* lengths,
                                void* y, int Bsz, int T, int ld, int H, int P,
                                int G, int N, int K, int bf16, float eps,
                                void* stream) {
  if (Bsz <= 0 || T <= 0 || H <= 0 || G <= 0 || N <= 0 || H % G ||
      H / G > kMaxCluster || N % (H / G) || K < 1 || K > kMaxTaps ||
      static_cast<long long>(Bsz) * H > INT_MAX ||
      static_cast<long long>(ld) < 2LL * H * P + 2LL * G * N + H)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return static_cast<int>(dispatch(
        args<__nv_bfloat16>(zxd, conv_w, conv_b, dt_bias, A_log, D, norm_w,
                            lengths, y, T, ld, H, P, G, N, K, eps),
        Bsz, P, s));
  return static_cast<int>(dispatch(
      args<float>(zxd, conv_w, conv_b, dt_bias, A_log, D, norm_w, lengths, y,
                  T, ld, H, P, G, N, K, eps),
      Bsz, P, s));
}
