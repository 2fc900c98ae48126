// nlplant_distilled: xdot = f(s, u) for the F-16 on the distilled aero
// surrogate.
//
// Replaces the TPU kernel neuralplane_tpu/ops/aero_pallas.py:
// nlplant_pallas_distilled (_xdot_kernel_distilled, with
// distilled_feature_rows and distilled_coeff_rows).
//
// Bound. Per aircraft the trunk needs 2 * (256*68 + 256*256 + 43*324) =
// 193,752 FLOP on bf16 operands (the bound counts these; with the padding
// the kernel multiplies, 2 * (256*80 + 256*256 + 48*336) = 204,288) and the
// kernel moves 17 floats in and 12 out (116 B). At n = 10^6 that is 1.94e11
// FLOP (0.196 ms at 989 TFLOP/s dense bf16) against 1.16e8 B (0.035 ms at
// 3.35 TB/s): the tensor cores bound it.
//
// Design (distilled.cuh). One persistent block per SM keeps all weights in
// shared memory; warps 0-3 run the three products as wgmma with the
// features and both hidden layers in registers; each thread of warps 4-11
// owns one aircraft: it reads its [12] and [5] rows, hands (alpha, beta,
// el) to the multiplier, takes back its 43 coefficients, runs nlplant in
// registers and writes its [12] row as three 16-byte stores. The two sides
// meet only through mbarriers.
#include <cuda_runtime.h>

#include "distilled.cuh"
#include "nlplant.cuh"

using namespace np_dist;

template <bool HB>
__global__ void __launch_bounds__(NP_THREADS, 1)
nlplant_distilled_kernel(const float* __restrict__ s, const float* __restrict__ u,
                         float* __restrict__ xdot, int n,
                         const unsigned char* __restrict__ image) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem sm = block_setup(smem_raw, image);
  const int tiles = (n + NP_M - 1) / NP_M;
  if (threadIdx.x < MUL_THREADS) {
    take_registers<MUL_REGS>();
    multiplier_loop<HB>(sm, tiles);
  } else {
    give_registers<PAIR_REGS>();
    const Owner o = owner();
    int j = o.pair;
    for (int tile = blockIdx.x + o.pair * gridDim.x; tile < tiles;
         tile += N_PAIRS * gridDim.x, j += N_PAIRS) {
      const int i = tile * NP_M + o.row;
      const bool valid = i < n;
      float sv[12], uv[5];
      if (valid) {
        const float4* row = reinterpret_cast<const float4*>(s + (size_t)i * 12);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float4 v = row[k];
          sv[4 * k] = v.x; sv[4 * k + 1] = v.y; sv[4 * k + 2] = v.z; sv[4 * k + 3] = v.w;
        }
#pragma unroll
        for (int k = 0; k < 5; ++k) uv[k] = u[(size_t)i * 5 + k];
      } else {  // a row past n: zeros, so that the surrogate runs on finite values
#pragma unroll
        for (int k = 0; k < 12; ++k) sv[k] = 0.0f;
#pragma unroll
        for (int k = 0; k < 5; ++k) uv[k] = 0.0f;
      }
      post_inputs(sm, o, j, sv[7] * np_f16::R2D, sv[8] * np_f16::R2D, uv[1]);
      float c[N_COEF];
      take_coefficients(sm, o, j, c);
      if (valid) {
        float xd[12];
        np_f16::nlplant_core(sv, uv, c, xd);
        float4* row = reinterpret_cast<float4*>(xdot + (size_t)i * 12);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          row[k] = make_float4(xd[4 * k], xd[4 * k + 1], xd[4 * k + 2], xd[4 * k + 3]);
      }
    }
  }
}

extern "C" {

const char* np_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// `image` is DistilledAeroWeights.packed().
int np_nlplant_distilled(const float* s, const float* u, float* xdot, int n,
                         const unsigned char* image, int H, int hidden_bf16, void* stream) {
  if (H != NP_H) return (int)cudaErrorInvalidValue;
  const auto kernel = hidden_bf16 ? nlplant_distilled_kernel<true>
                                  : nlplant_distilled_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_blocks(n), NP_THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(s, u, xdot, n,
                                                                          image);
  return (int)cudaGetLastError();
}

}  // extern "C"
