// The Mamba-2 SSD scan in its recurrent form (a linear RNN over each
// head's P x N state), for the Nemotron-H query tower
// (ops/kernels/mamba2_kernel.py).
//
// It replaces no Pallas kernel: the JAX package has no decoder-LM tower.
// It was added because a query of at most 24 tokens is one short
// recurrence a (sequence, head): the state (64 x 128 f32 at the published
// widths) stays in registers for the whole sequence, and x, B, C and dt
// are read once, where the scan's matrix ("quadratic") form writes and
// reads its [T, T] decay and C.B products and its f32 temporaries through
// device memory.
//
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t + D x_t
//
// from a zero state; y_t = 0 past the sequence's length.  Inputs f32:
// x, B and C as column ranges of one [Bsz, T, ld] row block (the
// convolution's output, x of head h at columns h*P.., B and C of group g
// at g*N..), dt [Bsz, T, H] (after the softplus), A [H] (negative), D [H],
// lengths [Bsz] int32; y [Bsz, T, H, P] f32.
//
// One block of 256 threads a (sequence, head).  Thread t owns state row
// p = t / R and the S = N / R columns n = t % R + j R (R = 256 / P threads
// a row).  The block stages up to kSteps tokens of x, B, C and dt in
// shared memory at once (asynchronous copies, all in flight together, then
// one barrier), then runs them in order: each thread updates its S states
// and its part of y_t[p] (two partial sums), summed over the row's R
// threads by shuffles.  Bound: operations (5 P N
// f32 a head and token) at the published widths; the bytes (x, B, C, dt
// in, y out) take about a third of that time.

#include <climits>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSteps = 32;   // tokens staged in shared memory at once

template <int S>
__global__ void __launch_bounds__(kThreads)
mamba2_rnn_scan(const float* __restrict__ x, const float* __restrict__ bm,
                const float* __restrict__ cm, int ld,
                const float* __restrict__ dt, const float* __restrict__ A,
                const float* __restrict__ Dskip,
                const int* __restrict__ lengths, float* __restrict__ y,
                int T, int H, int P, int G, int N) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int g = h / (H / G);
  const int R = kThreads / P;        // threads a state row
  const int tid = threadIdx.x;
  const int p = tid / R;
  const int r = tid % R;
  float* sx = smem;                          // [kSteps][P]
  float* sb = sx + kSteps * P;               // [kSteps][N]
  float* sc = sb + kSteps * N;               // [kSteps][N]
  float* sdt = sc + kSteps * N;              // [kSteps]

  const int len = min(max(lengths[b], 0), T);
  const float a_h = A[h];
  const float d_h = Dskip[h];
  float st[S];
#pragma unroll
  for (int j = 0; j < S; ++j) st[j] = 0.f;

  const size_t row0 = static_cast<size_t>(b) * T;
  float* yb = y + (row0 * H + h) * P;        // y[b, 0, h, 0]
  for (int t0 = 0; t0 < T; t0 += kSteps) {
    const int n_t = min(kSteps, T - t0);
    const int n_live = max(0, min(n_t, len - t0));
    __syncthreads();                         // the last chunk is read
    for (int i = tid; i < n_live * P; i += kThreads) {
      const int s = i / P, c = i % P;
      __pipeline_memcpy_async(sx + s * P + c,
                              x + (row0 + t0 + s) * ld + h * P + c, 4);
    }
    for (int i = tid; i < n_live * N; i += kThreads) {
      const int s = i / N, c = i % N;
      const size_t at = (row0 + t0 + s) * ld + g * N + c;
      __pipeline_memcpy_async(sb + s * N + c, bm + at, 4);
      __pipeline_memcpy_async(sc + s * N + c, cm + at, 4);
    }
    for (int i = tid; i < n_live; i += kThreads)
      __pipeline_memcpy_async(sdt + i, dt + (row0 + t0 + i) * H + h, 4);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int s = 0; s < n_t; ++s) {
      float out = 0.f;
      if (s < n_live) {
        const float dts = sdt[s];
        const float decay = expf(dts * a_h);
        const float xp = sx[s * P + p];
        const float u = dts * xp;
        float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
        for (int j = 0; j < S; ++j) {
          const int n = r + j * R;
          st[j] = fmaf(st[j], decay, u * sb[s * N + n]);
          if (j & 1)
            acc1 = fmaf(st[j], sc[s * N + n], acc1);
          else
            acc0 = fmaf(st[j], sc[s * N + n], acc0);
        }
        float acc = acc0 + acc1;
        for (int o = R / 2; o > 0; o >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, o, R);
        out = fmaf(d_h, xp, acc);
      }
      if (r == 0) yb[static_cast<size_t>(t0 + s) * H * P + p] = out;
    }
  }
}

template <int S>
cudaError_t launch(const float* x, const float* bm, const float* cm, int ld,
                   const float* dt, const float* A, const float* D,
                   const int* lengths, float* y, int Bsz, int T, int H,
                   int P, int G, int N, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kSteps * (P + 2 * N + 1);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  mamba2_rnn_scan<S><<<Bsz * H, kThreads, smem, stream>>>(
      x, bm, cm, ld, dt, A, D, lengths, y, T, H, P, G, N);
  return cudaGetLastError();
}

}  // namespace

// x, bm, cm: column ranges of one [Bsz, T, ld] f32 block; returns a CUDA
// error code (cudaErrorInvalidValue for shapes the kernel does not take:
// P a power of two in 8..256, N a multiple of 256 / P with at most 64
// states a thread, H a multiple of G).
extern "C" int vfr_mamba2_scan(const float* x, const float* bm,
                               const float* cm, const float* dt,
                               const float* A, const float* D,
                               const int* lengths, float* y, int Bsz, int T,
                               int H, int P, int G, int N, int ld,
                               void* stream) {
  if (Bsz <= 0 || T <= 0 || H <= 0 || G <= 0 || H % G || P < 8 ||
      P > kThreads || (P & (P - 1)) || N <= 0 ||
      static_cast<long long>(Bsz) * H > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int R = kThreads / P;
  if (N % R) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N / R) {
    case 1: return launch<1>(x, bm, cm, ld, dt, A, D, lengths, y, Bsz, T, H, P, G, N, s);
    case 2: return launch<2>(x, bm, cm, ld, dt, A, D, lengths, y, Bsz, T, H, P, G, N, s);
    case 4: return launch<4>(x, bm, cm, ld, dt, A, D, lengths, y, Bsz, T, H, P, G, N, s);
    case 8: return launch<8>(x, bm, cm, ld, dt, A, D, lengths, y, Bsz, T, H, P, G, N, s);
    case 16: return launch<16>(x, bm, cm, ld, dt, A, D, lengths, y, Bsz, T, H, P, G, N, s);
    case 32: return launch<32>(x, bm, cm, ld, dt, A, D, lengths, y, Bsz, T, H, P, G, N, s);
    case 64: return launch<64>(x, bm, cm, ld, dt, A, D, lengths, y, Bsz, T, H, P, G, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
