// Does other work overlap with wgmma on one SM? A microbenchmark for the
// design of csrc/distilled.cuh, on one NVIDIA GPU of compute capability 9.0a.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o wgmma_overlap_bench tools/wgmma_overlap_bench.cu && ./wgmma_overlap_bench
//
// One block per SM. Warpgroup 0 runs chains of 16 wgmma m64n128k16 (bf16,
// float32 sums in registers; A from registers as the trunk has it, or from
// shared memory) and the other warpgroups run a loop of independent float
// or integer multiply-adds. Each is timed alone and then both together;
// the printed table says whether the times add or overlap.
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

#include "../neuralplane_tpu_torch/csrc/wgmma.cuh"

using namespace np_wgmma;

// d[64] (+)= A[64, 16] . B[16, 128] with A and B from shared memory.
__device__ __forceinline__ void mma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// Two bf16 values of either sign with magnitudes in [2^-7, 2), from a hash
// of i: operands whose bits toggle as real data's do.
__device__ __forceinline__ uint32_t random_bf16_pair(uint32_t i) {
  uint32_t h = i * 2654435761u;
  h ^= h >> 15;
  h *= 2246822519u;
  h ^= h >> 13;
  return 0x3c003c00u + (h & 0x83ff83ffu);
}

constexpr int SMEM = 131072;
constexpr int CHAIN = 16;      // wgmma per chain: K = 256
enum Other { NONE, FLOAT_FMA, INT_MAD };

// mma: 0 none, 1 A from registers, 2 A from shared memory.
template <int MMA, int OTHER>
__global__ void bench(long long* cycles, int mma_iters, int other_iters, float* sink) {
  extern __shared__ __align__(128) unsigned char smem[];
  for (int i = threadIdx.x; i < SMEM / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(smem)[i] = random_bf16_pair(i);
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int wg = threadIdx.x / 128;
  const long long t0 = clock64();
  long long t1 = t0;
  if (wg == 0) {
    if (MMA != 0) {
      float d[64] = {};
      uint32_t a[CHAIN][4];
      for (int k = 0; k < CHAIN; ++k)
        for (int i = 0; i < 4; ++i) a[k][i] = random_bf16_pair(SMEM + (threadIdx.x * CHAIN + k) * 4 + i);
      const uint64_t desc_b = make_desc(smem, 16 * 256, 128);
      const uint64_t desc_a = make_desc(smem + SMEM / 2, 16 * 64, 128);
      for (int it = 0; it < mma_iters; ++it) {
        fence();
#pragma unroll
        for (int k = 0; k < CHAIN; ++k) {
          if (MMA == 1) mma_m64n128k16(d, a[k], advance(desc_b, k * 32 * 256), k > 0);
          else mma_m64n128k16_ss(d, advance(desc_a, k * 32 * 64), advance(desc_b, k * 32 * 256), k > 0);
        }
        commit();
        wait_all();
      }
      t1 = clock64();
      float s = 0.0f;
      for (int i = 0; i < 64; ++i) s += d[i];
      if (s == 123.456f) sink[0] = s;
    }
  } else if (OTHER == FLOAT_FMA) {
    float x[8];
    for (int i = 0; i < 8; ++i) x[i] = threadIdx.x * 0.001f + i;
    for (int it = 0; it < other_iters; ++it)
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = fmaf(x[i], 1.0001f, 0.5f);
    t1 = clock64();
    float s = 0.0f;
    for (int i = 0; i < 8; ++i) s += x[i];
    if (s == 123.456f) sink[0] = s;
  } else if (OTHER == INT_MAD) {
    unsigned x[8];
    for (int i = 0; i < 8; ++i) x[i] = threadIdx.x + i;
    for (int it = 0; it < other_iters; ++it)
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = x[i] * 2654435761u + 12345u;
    t1 = clock64();
    unsigned s = 0;
    for (int i = 0; i < 8; ++i) s += x[i];
    if (s == 12345u) sink[0] = (float)s;
  }
  if (threadIdx.x % 128 == 0 && blockIdx.x == 0) cycles[wg] = t1 - t0;
}

template <int MMA, int OTHER>
void run(const char* what, int warpgroups, long long* d_cycles, float* sink) {
  const int mma_iters = 2000, other_iters = 6000;
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaFuncSetAttribute(bench<MMA, OTHER>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float ms = 0.0f;
  for (int rep = 0; rep < 2; ++rep) {   // the first launch warms up
    cudaEventRecord(e0);
    bench<MMA, OTHER><<<sms, 128 * warpgroups, SMEM>>>(d_cycles, mma_iters, other_iters, sink);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
  }
  long long h[4] = {};
  cudaMemcpy(h, d_cycles, sizeof(long long) * warpgroups, cudaMemcpyDeviceToHost);
  printf("%-46s %d warpgroups: %.4f ms; cycles: wgmma warpgroup %lld (%.1f per wgmma), "
         "other %lld; %s\n", what, warpgroups, ms, h[0], (double)h[0] / (CHAIN * mma_iters),
         h[1], cudaGetErrorString(cudaGetLastError()));
}

int main() {
  if (cudaSetDevice(0) != cudaSuccess) {
    fprintf(stderr, "needs an NVIDIA GPU\n");
    return 2;
  }
  long long* d_cycles;
  float* sink;
  cudaMalloc(&d_cycles, 64);
  cudaMalloc(&sink, 8);
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("%s, %d SMs\n", prop.name, prop.multiProcessorCount);
  for (int wgs = 2; wgs <= 3; ++wgs) {
    run<1, NONE>("wgmma, A from registers, alone", wgs, d_cycles, sink);
    run<2, NONE>("wgmma, A from shared memory, alone", wgs, d_cycles, sink);
    run<0, FLOAT_FMA>("float multiply-adds alone", wgs, d_cycles, sink);
    run<1, FLOAT_FMA>("wgmma (registers) + float multiply-adds", wgs, d_cycles, sink);
    run<2, FLOAT_FMA>("wgmma (shared memory) + float multiply-adds", wgs, d_cycles, sink);
    run<0, INT_MAD>("integer multiply-adds alone", wgs, d_cycles, sink);
    run<1, INT_MAD>("wgmma (registers) + integer multiply-adds", wgs, d_cycles, sink);
  }
  return 0;
}
