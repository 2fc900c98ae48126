// nlplant_distilled: xdot = f(s, u) for the F-16 on the distilled aero
// surrogate, one thread block per 64 aircraft.
//
// Replaces the TPU kernel neuralplane_tpu/ops/aero_pallas.py:
// nlplant_pallas_distilled (_xdot_kernel_distilled, with
// distilled_feature_rows and distilled_coeff_rows).
//
// Bound. Per aircraft the trunk does 2 * (256*68 + 256*256 + 64*324) =
// 207,360 FLOP on bf16 operands and the kernel moves 17 floats in and 12
// out (116 B). At n = 10^6 that is 2.07e11 FLOP (0.21 ms at 989 TFLOP/s
// dense bf16) against 1.16e8 B (0.035 ms at 3.35 TB/s): the tensor cores
// bound it.
//
// Design. The three products run on tensor cores (mma.sync m16n8k16 bf16,
// float32 accumulators in registers, distilled.cuh); features and hidden
// layers stay in shared memory, and the weights stream from L2 through
// shared memory in 3-stage cp.async chunks, each used for all 64 aircraft
// of the block. The elementwise nlplant is one thread per aircraft, in
// registers. State and control rows are staged through shared memory so
// that the [n, 12] / [n, 5] reads and the [n, 12] write are coalesced.
#include <cuda_runtime.h>

#include "distilled.cuh"
#include "nlplant.cuh"

using namespace np_dist;

__global__ void __launch_bounds__(NP_THREADS, 2)
nlplant_distilled_kernel(const float* __restrict__ s, const float* __restrict__ u,
                         float* __restrict__ xdot, int n, Weights w, bool hidden_bf16) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem sm = smem_layout(smem_raw);
  const int t = threadIdx.x;
  const int i0 = blockIdx.x * NP_M;
  const int nv = min(NP_M, n - i0);  // valid aircraft in this block

  // coalesced loads of the block's [nv, 12] and [nv, 5] rows
  float* s_st = sm.io;               // [NP_M][12]
  float* u_st = sm.io + NP_M * 12;   // [NP_M][5]
  for (int e = t; e < nv * 12; e += NP_THREADS) s_st[e] = s[(size_t)i0 * 12 + e];
  for (int e = t; e < nv * 5; e += NP_THREADS) u_st[e] = u[(size_t)i0 * 5 + e];
  __syncthreads();

  float sv[12], uv[5];
  if (t < NP_M) {
    const bool valid = t < nv;
#pragma unroll
    for (int j = 0; j < 12; ++j) sv[j] = valid ? s_st[t * 12 + j] : 0.0f;
#pragma unroll
    for (int j = 0; j < 5; ++j) uv[j] = valid ? u_st[t * 5 + j] : 0.0f;
    sm.abe[3 * t + 0] = sv[7] * np_f16::R2D;
    sm.abe[3 * t + 1] = sv[8] * np_f16::R2D;
    sm.abe[3 * t + 2] = uv[1];
  }
  __syncthreads();
  build_features(sm);
  __syncthreads();
  trunk(sm, w, hidden_bf16);

  if (t < nv) {
    float c[N_COEF], xd[12];
    coefficients(sm, w, t, c);
    np_f16::nlplant_core(sv, uv, c, xd);
#pragma unroll
    for (int j = 0; j < 12; ++j) s_st[t * 12 + j] = xd[j];
  }
  __syncthreads();
  for (int e = t; e < nv * 12; e += NP_THREADS) xdot[(size_t)i0 * 12 + e] = s_st[e];
}

extern "C" {

const char* np_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int np_nlplant_distilled(const float* s, const float* u, float* xdot, int n,
                         const bf16* W1, const float* b1, const bf16* W2,
                         const float* b2, const bf16* W3, const float* b3,
                         const float* mu, const float* sd, int H, int hidden_bf16,
                         void* stream) {
  if (H != NP_H) return (int)cudaErrorInvalidValue;
  const size_t smem = SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      nlplant_distilled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Weights w{W1, b1, W2, b2, W3, b3, mu, sd};
  const int blocks = (n + NP_M - 1) / NP_M;
  nlplant_distilled_kernel<<<blocks, NP_THREADS, smem, (cudaStream_t)stream>>>(
      s, u, xdot, n, w, hidden_bf16 != 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
