// Pieces shared by every kernel source of the port: the asynchronous copy
// (cp.async) helpers that feed the shared-memory rings, the bulk copies and
// mbarriers of the LSTM's persistent_bulk ring, the shared-memory
// descriptor and fences of the warpgroup products (wgmma), and the warp-level
// tensor-core instructions (ldmatrix, mma.sync) of the distance-select (K2)
// and coarse block-max (K4) kernels.  Included by each kernel source (each
// is its own shared library), never compiled alone; kernels/build.py hashes
// every csrc/*.cuh into every library's name.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, past L1; pred false: the 16 bytes are zeroed
// (0 source bytes are read, the address only has to be valid).
__device__ __forceinline__ void cp_async16_s(uint32_t dst, const void* gmem,
                                             bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  cp_async16_s(smem_u32(smem), gmem, pred);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// K-major operand tile of 128-byte rows with the 128-byte swizzle: groups
// of 8 rows 1024 bytes apart; the tile is 1024-byte aligned.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;
  d |= (uint64_t)(1024 >> 4) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Orders this thread's view of device memory, generic stores of other
// threads included once acquired, before its later bulk copies read it.
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Bulk asynchronous copies (one thread moves a contiguous run of bytes,
// a multiple of 16, global -> shared) that report to an mbarrier, an
// 8-byte barrier in shared memory given by its address.  A barrier's
// phase completes when its arrivals are counted and the bytes it was told
// to expect have landed; mbar_wait(bar, parity) waits for the phase of
// that parity (0 for the first) and traps after about a second.
// mbar_wait_asm's loop and mbar_arrive_if's predicate live inside the
// asm, so the compiler sees no branch where they sit between a
// warpgroup's asynchronous products (a branch there makes ptxas
// serialize them).
__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"((int)pred)
      : "memory");
}
__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > 2000000000LL) __trap();
}
// The same wait with its loop inside the asm.
__device__ __forceinline__ void mbar_wait_asm(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "MBAR_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra MBAR_DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, 2000000000;\n"
      "@p trap;\n"
      "bra MBAR_WAIT;\n"
      "MBAR_DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src,
                                              unsigned bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// Four (two) 8x8 matrices of 16-bit elements from shared memory: lane l
// gives the address of row l % 8 of matrix l / 8 (16 bytes); the thread
// receives, of matrix j, the two elements 2*(l%4), +1 of row l/4 in r[j].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1,
                                            uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// The mma wrappers are plain (not volatile) asm: they have no side effect,
// so the compiler may interleave independent accumulator chains.
//
// D[16x8] = A[16x16] * B[16x8] + C, bf16 operands, f32 sums.  With g =
// lane / 4, t = lane % 4: a0 = A[g][2t..], a1 = A[g+8][2t..], a2 =
// A[g][2t+8..], a3 = A[g+8][2t+8..]; b0 = B[2t..][g], b1 = B[2t+8..][g];
// d0, d1 = D[g][2t, 2t+1], d2, d3 = D[g+8][2t, 2t+1].
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1, float c0,
                                         float c1, float c2, float c3) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c0), "f"(c1), "f"(c2), "f"(c3));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  mma_bf16(d, a, b0, b1, d[0], d[1], d[2], d[3]);
}

// D[64 x 64] (+)= A[64 x 8 tf32 | 64 x 16 bf16] * B, A from registers (warp w
// of the warpgroup holds rows 16w .. 16w+15 in the mma.sync A layout above;
// tf32: a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4], the
// low 13 mantissa bits of each 32-bit operand ignored),
// B [64 x 32 bytes] K-major from shared memory by descriptor, f32 sums in
// d[4j + 2rr + e] = D[16w + g + 8rr][8j + 2t + e].  accumulate = 0 overwrites D.
#define VFR_D32(d)                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),  \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),           \
  "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),           \
  "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),           \
  "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define VFR_D32_REGS                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

__device__ __forceinline__ void wgmma_tf32_ra(float (&d)[32],
                                              const uint32_t* a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " VFR_D32_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : VFR_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate)
      : "memory");
}

__device__ __forceinline__ void wgmma_bf16_ra(float (&d)[32],
                                              const uint32_t* a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VFR_D32_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : VFR_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace
