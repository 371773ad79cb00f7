// What the tensor cores alone allow a persistent recurrence step (a
// stand-alone program, not part of any library): every SM runs the wgmma
// sequence of one step of rnn_common.cuh::rnn_persistent at H = 1024 (16
// chunks of 4 k16 products per 64-row tile, commit and wait per chunk) on
// shared memory that is already there: no loads, no barrier, no cell
// update.  The step's recurrent product cannot be faster than this.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -o wgmma_rate \
//        wgmma_rate.cu && ./wgmma_rate
// prints one line per shape; `python3 chip_smoke.py --phases wgmma_rate`
// builds and runs it.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;
  d |= (uint64_t)(1024 >> 4) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

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

__device__ __forceinline__ void wgmma_k16(float (&d)[64], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1)
      : "memory");
}

// N: columns of one wgmma; each warpgroup of the block issues `chunks`
// chunks of four m64nNk16 per step on one accumulator.
template <int N>
__global__ void __launch_bounds__(256, 1)
rate_kernel(float* out, int steps, int chunks) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  for (int i = threadIdx.x; i < 160 * 1024 / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(smem_raw)[i] = 0u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  const uint64_t da = smem_desc(base + (threadIdx.x / 128) * 8192);
  for (int s = 0; s < steps; ++s) {
    for (int kc = 0; kc < chunks; ++kc) {
      const uint64_t db = smem_desc(base + 16384 + (kc % 8) * (N * 128));
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma_k16(acc, da + 2 * j, db + 2 * j);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sum += acc[i];
  if (sum != 0.0f) out[0] = sum;      // zeros in, zeros out: never taken
}

template <int N>
int run(const char* what, int threads, int chunks) {
  float* out = nullptr;
  const int smem = 200 * 1024, steps = 200;
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  if (cudaMalloc(&out, sizeof(float)) != cudaSuccess) return 1;
  cudaFuncSetAttribute(rate_kernel<N>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  rate_kernel<N><<<sms, threads, smem>>>(out, 10, chunks);
  cudaEvent_t t0, t1;
  cudaEventCreate(&t0);
  cudaEventCreate(&t1);
  cudaEventRecord(t0);
  rate_kernel<N><<<sms, threads, smem>>>(out, steps, chunks);
  cudaEventRecord(t1);
  cudaEventSynchronize(t1);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, t0, t1);
  const int err = (int)cudaGetLastError();
  const double us = ms * 1e3 / steps;
  const double flops = 2.0 * 64 * N * 16 * 4 * chunks * (threads / 128) * sms;
  printf("{\"what\": \"%s\", \"n\": %d, \"warpgroups\": %d, \"chunks\": %d, "
         "\"us_per_step\": %.4f, \"tflops\": %.1f, \"cuda_error\": %d}\n",
         what, N, threads / 128, chunks, us, flops / us * 1e-6, err);
  cudaFree(out);
  return err;
}

int main() {
  int err = 0;
  err |= run<64>("two 64-row tiles, m64n64k16 (the LSTM step)", 256, 16);
  err |= run<64>("one 64-row tile, m64n64k16", 128, 16);
  err |= run<128>("one warpgroup, m64n128k16", 128, 16);
  err |= run<128>("two warpgroups, m64n128k16, half of K each", 256, 8);
  return err != 0;
}
