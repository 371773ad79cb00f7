// Top-k of long f32 rows in jax.lax.top_k's order, Hopper sm_90a.
//
// Replaces no Pallas kernel: the JAX package leaves this select to
// jax.lax.top_k (XLA).  Its order is value descending in the total order of
// the f32 bits (-NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN), equal
// values lowest index first.  Here every value becomes a unique 64-bit key,
// computed in registers:
//   high word  the f32 bits in that total order, as an unsigned integer
//              (ops/topk.py::ordered_bits plus 2^31);
//   low word   ~column (0xFFFFFFFF - column).
// The largest key is then the largest value, and of equal values the one of
// the lowest column.  No two keys are equal, so the k largest keys are the
// answer with nothing left to tie-break, and the value comes back bit for
// bit from the high word.
//
// What bounds it on this card: bytes.  The [Q, N] scores are read once (215
// MB at Q = 256, N = 210,000: 64 us at 3.35 TB/s) and [Q, k] values and
// rows written once.  The design keeps every other cost below that read.
//
// Pass 1, `row_topk_filter`, grid Q x P: a block streams one slice of one
// row once, 16-byte loads that bypass L1 and leave L2 first (__ldcs), with a
// ring of three 2,048-value chunks in registers: two stay in flight while
// one is filtered; a slice's unaligned head and tail (a row of N not a
// multiple of 4) are read as scalars.  Each key is compared with the
// block's threshold, held in a register: no key below it can be among the
// slice's k largest.  The few keys that pass are appended to a buffer in
// shared memory, each thread's in a row, placed by a warp scan of the
// threads' counts (one atomic a warp).  Once the buffer holds enough, the
// block sorts it together with its k best so far (bitonic, in shared
// memory; the stages under 64 keys apart inside one warp), keeps the k best
// and raises the threshold to the k-th.  The first threshold comes before
// any sort: the k-th largest of the threads' maxima over the ring's first
// three chunks is below at least k keys of the slice, so those chunks pass
// only a few keys in a hundred.  On scores of real data about k (1 + ln(slice
// / k)) keys pass in all, and the pass costs little more than its bytes.  A
// row already ascending passes every key and sorts at every chunk: right,
// and slow.  The block writes its k best keys, sorted (0, below every real
// key, where the slice holds fewer), to the [Q, P, k] scratch.
//
// Pass 2, `row_topk_merge`, one block a row: the row's P lists of k keys,
// each sorted, merge two at a time in shared memory (the larger of A[i] and
// B[k - 1 - i], then a bitonic merge), log2 P levels; the k best are written
// as values (f32, from the high word) and rows (int64, from the low word).
//
// The host's plan (ops/kernels/topk_kernel.py::plan_row_topk) gives P and
// the slice length from shapes and the SM count.  Nothing is allocated here
// and nothing is read on the host: the wrapper gives the scratch and the
// outputs, and both launches go to the caller's stream.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKMax = 256;          // ops/kernels/topk_kernel.py::K_MAX
constexpr int kCap = 4096;          // keys of the shared buffer (32 KB)
constexpr int kVec = 2;             // float4 a thread loads a chunk
constexpr int kRing = 3;            // chunks in registers: two in flight
constexpr int kChunk4 = kThreads * kVec;       // float4 a chunk (2,048 values)
// The buffer holds the k best, the candidates of one chunk (at most 2,048
// values and the 6 scalars of a slice's edges) and those that stayed below
// the flush count (at most 256, at k = 256): 256 + 256 + 2,054 <= kCap.
// The first threshold's thread maxima sit at its top, above anything
// appended then.
static_assert(kKMax + 256 + kChunk4 * 4 + 6 <= kCap - kThreads,
              "the shared buffer cannot hold a chunk");
static_assert(kKMax <= kThreads, "the first threshold needs k <= threads");
static_assert(kRing == 3, "pass 1's loop is unrolled by three");
static_assert(4 * kVec < 31, "a thread's pass mask holds its chunk values");

__device__ __forceinline__ uint32_t order_bits(float v) {
  const uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float value_of(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}

__device__ __forceinline__ u64 make_key(float v, int col) {
  return (static_cast<u64>(order_bits(v)) << 32) |
         static_cast<u64>(~static_cast<uint32_t>(col));
}

// Candidates kept below this many go unsorted: k + count is then one power
// of two, at least 128 (a small k sorts often and keeps its threshold
// tight, so fewer warps find a key to append).
__device__ __forceinline__ int flush_count(int k) {
  int p = 128;
  while (p < 2 * k) p <<= 1;
  return p - k;
}

// One compare-exchange of the bitonic network: pair i of the stage (size,
// stride), ordered so that the final merge leaves a[] descending.
__device__ __forceinline__ void exchange(u64* a, int i, int stride,
                                         int size) {
  const int lo = ((i & ~(stride - 1)) << 1) | (i & (stride - 1));
  const int hi = lo + stride;
  const u64 x = a[lo], y = a[hi];
  if (((lo & size) == 0) ? (x < y) : (x > y)) {
    a[lo] = y;
    a[hi] = x;
  }
}

// Sort a[0, n) descending, n a power of two >= 2; ends with a barrier.
// Stages whose pairs lie 64 keys apart or more run over the block, a
// barrier each; the others stay inside 64-key segments, one warp a segment
// (a lane a pair), with the warp's own sync between them.
__device__ void sort_desc(u64* a, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pairs = n >> 1, segs = (pairs + 31) >> 5;
  for (int s = warp; s < segs; s += kWarps) {
    const int i = s * 32 + lane;
    for (int size = 2; size <= min(n, 64); size <<= 1)
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        if (i < pairs) exchange(a, i, stride, size);
        __syncwarp();
      }
  }
  __syncthreads();
  for (int size = 128; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride >= 64; stride >>= 1) {
      for (int i = threadIdx.x; i < pairs; i += kThreads)
        exchange(a, i, stride, size);
      __syncthreads();
    }
    for (int s = warp; s < segs; s += kWarps) {
      for (int stride = 32; stride > 0; stride >>= 1) {
        exchange(a, s * 32 + lane, stride, size);
        __syncwarp();
      }
    }
    __syncthreads();
  }
}

// Sort the k best with the `n_cand` candidates behind them, keep the k best
// at buf[0, k) and empty the candidates.  Every thread calls it with the
// same n_cand; returns the new threshold (0 while fewer than k real keys
// were seen).
__device__ u64 flush(u64* buf, int* count, int k, int n_cand) {
  const int n = k + n_cand;
  int p2 = 2;
  while (p2 < n) p2 <<= 1;
  for (int i = n + threadIdx.x; i < p2; i += kThreads) buf[i] = 0;
  __syncthreads();
  if (threadIdx.x == 0) *count = 0;     // seen by all after sort's barriers
  sort_desc(buf, p2);
  return buf[k - 1];
}

// One barrier for the appends, one to agree: flush when the candidates
// reach the flush count.  Returns the threshold, raised or as it was.
__device__ __forceinline__ u64 flush_if_full(u64* buf, int* count, int k,
                                             int flush_at, u64 thr) {
  __syncthreads();
  if (__syncthreads_or(threadIdx.x == 0 && *count >= flush_at)) {
    const int n_cand = *count;
    thr = flush(buf, count, k, n_cand);
  }
  return thr;
}

__device__ __forceinline__ void load_chunk(const float4* body, int nv, int c,
                                           float4 (&v)[kVec]) {
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    const int i = c * kChunk4 + u * kThreads + threadIdx.x;
    v[u] = i < nv ? __ldcs(body + i) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// What a block of pass 1 streams: the float4 body of its slice (nv of them
// from column a0) and the key of the thread's edge scalar (0: none).
struct Slice {
  const float4* body;
  int nv;
  int a0;
  u64 ekey;
};

// The largest of `mx` and the keys of chunk c, held in v.
__device__ __forceinline__ u64 chunk_max(const Slice& sl,
                                         const float4 (&v)[kVec], int c,
                                         u64 mx) {
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    const int i = c * kChunk4 + u * kThreads + threadIdx.x;
    const float* f = reinterpret_cast<const float*>(&v[u]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const u64 key = i < sl.nv ? make_key(f[j], sl.a0 + 4 * i + j) : 0;
      mx = key > mx ? key : mx;
    }
  }
  return mx;
}

// Filter chunk c, held in v, against the threshold and append what passes
// at buf[k + count ...]: each thread's passing keys in a row, placed by a
// warp scan of the threads' counts, one atomic a warp.  Then load chunk c +
// kRing into v (the ring's other chunks stay in flight) and flush when the
// candidates reach the flush count.  Returns the threshold.
__device__ __forceinline__ u64 filter_chunk(const Slice& sl, float4 (&v)[kVec],
                                            int c, int chunks, u64* buf,
                                            int* count, int k, int flush_at,
                                            u64 thr) {
  const int t = threadIdx.x, lane = t & 31;
  unsigned mask = c == 0 && sl.ekey != 0 && sl.ekey >= thr ? 1u << 31 : 0u;
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    const int i = c * kChunk4 + u * kThreads + t;
    const float* f = reinterpret_cast<const float*>(&v[u]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (i < sl.nv && make_key(f[j], sl.a0 + 4 * i + j) >= thr)
        mask |= 1u << (4 * u + j);
  }
  if (__any_sync(0xffffffffu, mask != 0)) {
    const int n = __popc(mask);
    int upto = n;                       // the warp's inclusive scan
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, upto, o);
      if (lane >= o) upto += y;
    }
    int base = 0;
    if (lane == 31) base = atomicAdd(count, upto);
    int at = k + __shfl_sync(0xffffffffu, base, 31) + upto - n;
    if (mask >> 31) buf[at++] = sl.ekey;
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int i = c * kChunk4 + u * kThreads + t;
      const float* f = reinterpret_cast<const float*>(&v[u]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if ((mask >> (4 * u + j)) & 1u)
          buf[at++] = make_key(f[j], sl.a0 + 4 * i + j);
    }
  }
  if (c + kRing < chunks) load_chunk(sl.body, sl.nv, c + kRing, v);
  return flush_if_full(buf, count, k, flush_at, thr);
}

__global__ void __launch_bounds__(kThreads)
row_topk_filter(const float* __restrict__ x, u64* __restrict__ cand, int N,
                int k, int slices, int slice_len) {
  __shared__ u64 buf[kCap];
  __shared__ int count;
  const int row = blockIdx.x / slices, slice = blockIdx.x % slices;
  const float* xr = x + static_cast<size_t>(row) * N;
  const int s0 = slice * slice_len, s1 = min(N, s0 + slice_len);
  // the float4 body [a0, a1) and the scalar edges [s0, a0), [a1, s1)
  const int mis =
      static_cast<int>((reinterpret_cast<uintptr_t>(xr + s0) >> 2) & 3);
  const int a0 = min(s1, s0 + ((4 - mis) & 3));
  const int nv = (s1 - a0) >> 2;
  const int a1 = a0 + 4 * nv;
  const int t = threadIdx.x;
  Slice sl{reinterpret_cast<const float4*>(xr + a0), nv, a0, 0};

  for (int i = t; i < k; i += kThreads) buf[i] = 0;
  if (t == 0) count = 0;
  const int flush_at = flush_count(k);
  const int chunks = max(1, (nv + kChunk4 - 1) / kChunk4);

  // the ring: three chunks in registers, each reloaded as soon as it is
  // filtered (the loop below is unrolled by three, so no chunk moves
  // between registers while its loads are in flight)
  float4 v0[kVec], v1[kVec], v2[kVec];
  load_chunk(sl.body, nv, 0, v0);
  load_chunk(sl.body, nv, 1, v1);
  load_chunk(sl.body, nv, 2, v2);
  // threads 0-2 take the head's scalars, 4-6 the tail's
  int ecol = -1;
  if (t < a0 - s0) ecol = s0 + t;
  else if (t >= 4 && t - 4 < s1 - a1) ecol = a1 + t - 4;
  if (ecol >= 0) sl.ekey = make_key(__ldcs(xr + ecol), ecol);

  // the first threshold: the k-th largest of the threads' maxima over the
  // ring's three chunks (0, passing everything, where fewer than k threads
  // hold a value)
  u64 mx = sl.ekey;
  mx = chunk_max(sl, v0, 0, mx);
  mx = chunk_max(sl, v1, 1, mx);
  mx = chunk_max(sl, v2, 2, mx);
  u64* maxima = buf + kCap - kThreads;
  maxima[t] = mx;
  __syncthreads();
  sort_desc(maxima, kThreads);
  u64 thr = maxima[k - 1];

  for (int c = 0; c < chunks; c += kRing) {
    thr = filter_chunk(sl, v0, c, chunks, buf, &count, k, flush_at, thr);
    if (c + 1 < chunks)
      thr = filter_chunk(sl, v1, c + 1, chunks, buf, &count, k, flush_at, thr);
    if (c + 2 < chunks)
      thr = filter_chunk(sl, v2, c + 2, chunks, buf, &count, k, flush_at, thr);
  }
  __syncthreads();
  const int n_cand = count;
  if (n_cand > 0) flush(buf, &count, k, n_cand);
  u64* out = cand + static_cast<size_t>(blockIdx.x) * k;
  for (int i = t; i < k; i += kThreads) out[i] = buf[i];
}

__global__ void __launch_bounds__(kThreads)
row_topk_merge(const u64* __restrict__ cand, int slices, int k,
               float* __restrict__ vals, long long* __restrict__ idx) {
  __shared__ u64 buf[kCap];
  const int t = threadIdx.x;
  int kp = 2;                           // a list's slot: k keys, 0-padded
  while (kp < k) kp <<= 1;
  const int half = kp >> 1;
  const int group = kCap / kp;          // slots a round holds (>= 16)
  const u64* cr = cand + static_cast<size_t>(blockIdx.x) * slices * k;
  for (int next = 0; next < slices;) {
    // slot 0 keeps the best so far after the first round
    const int first = next == 0 ? 0 : 1;
    const int n_new = min(group - first, slices - next);
    int lists = 1;
    while (lists < first + n_new) lists <<= 1;
    for (int e = t; e < (lists - first) * kp; e += kThreads) {
      const int s = e / kp, j = e - s * kp;
      buf[(first + s) * kp + j] =
          s < n_new && j < k ? cr[static_cast<size_t>(next + s) * k + j] : 0;
    }
    __syncthreads();
    for (int w = 1; w < lists; w <<= 1) {
      // slot 2wm takes the kp best of itself and slot 2wm + w: the larger
      // of A[i] and B[kp - 1 - i] is bitonic, then merged descending
      const int work = lists / (2 * w) * half;
      for (int e = t; e < work; e += kThreads) {
        const int m = e / half, i = e - m * half;
        u64* A = buf + 2 * w * m * kp;
        const u64* B = A + w * kp;
        const u64 a1 = A[i], b1 = B[kp - 1 - i];
        const u64 a2 = A[kp - 1 - i], b2 = B[i];
        A[i] = a1 > b1 ? a1 : b1;
        A[kp - 1 - i] = a2 > b2 ? a2 : b2;
      }
      __syncthreads();
      for (int stride = half; stride > 0; stride >>= 1) {
        for (int e = t; e < work; e += kThreads) {
          const int m = e / half, i = e - m * half;
          exchange(buf + 2 * w * m * kp, i, stride, 2 * kCap);
        }
        __syncthreads();
      }
    }
    next += n_new;
  }
  const size_t o = static_cast<size_t>(blockIdx.x) * k;
  for (int i = t; i < k; i += kThreads) {
    const u64 key = buf[i];
    vals[o + i] = value_of(static_cast<uint32_t>(key >> 32));
    idx[o + i] = static_cast<long long>(~static_cast<uint32_t>(key));
  }
}

}  // namespace

// x [Q, N] f32, rows contiguous; cand [Q, slices, k] int64 scratch; vals [Q,
// k] f32 and idx [Q, k] int64 out.  Slice s covers columns [s * slice_len,
// min(N, (s + 1) * slice_len)); the plan must cover the row with no empty
// slice.  Returns the launches' CUDA error code (0 when both launched).
extern "C" int vfr_row_topk(const float* x, void* cand, float* vals,
                            void* idx, int Q, int N, int k, int slices,
                            int slice_len, void* stream) {
  if (Q <= 0 || N <= 0 || k < 1 || k > kKMax || k > N || slices < 1 ||
      slice_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(slices - 1) * slice_len >= N ||
      static_cast<long long>(slices) * slice_len < N ||
      static_cast<long long>(Q) * slices > INT_MAX ||
      static_cast<long long>(slices) * k > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(x) % 4 ||
      reinterpret_cast<uintptr_t>(cand) % 8 ||
      reinterpret_cast<uintptr_t>(idx) % 8)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  row_topk_filter<<<Q * slices, kThreads, 0, s>>>(
      x, static_cast<u64*>(cand), N, k, slices, slice_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  row_topk_merge<<<Q, kThreads, 0, s>>>(
      static_cast<const u64*>(cand), slices, k, vals,
      static_cast<long long*>(idx));
  return static_cast<int>(cudaGetLastError());
}
