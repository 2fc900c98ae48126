// aero_grouped: the 43-net aero ensemble in three fused kernels, one warp
// per 32 aircraft, persistent blocks.
//
// Replaces the TPU kernels of neuralplane_tpu/ops/aero_pallas.py:
//   np_aero_coeffs     aero_coeffs_pallas_ft (_aero_kernel_t) and
//                      aero_coeffs_pallas_t / aero_coeffs_pallas
//                      (_aero_kernel): the 43 raw coefficients, [K, n] or
//                      [n, K] by a flag;
//   np_aero_totals     aero_totals_pallas_ft (_aero_totals_kernel_t): the
//                      query, then coeff_buildup, [10, n] -> [6, n];
//   np_nlplant_grouped nlplant_pallas_ft (_xdot_kernel): xdot = f(s, u),
//                      both hidden_bf16 modes.
//
// Bound at n = 10^6 (real work: 57,620 FLOP per aircraft on bf16 operands
// = 0.058 ms at 989 TFLOP/s): the coefficient query moves 12 + 172 B per
// aircraft (0.055 ms at 3.35 TB/s), the totals 40 + 24 B (0.019 ms), xdot
// 68 + 48 B (0.035 ms): the operations bound all three, the query only
// just.
//
// Design. The sweep is grouped.cuh: weights resident in shared memory,
// activations in registers, every lane ends with the 43 coefficients of
// one aircraft in the warp's scratch. What follows is elementwise, one
// lane per aircraft (nlplant.cuh). Feature-major rows are read and written
// directly (a warp's 32 aircraft are one 128-byte line); [n, 12], [n, 5]
// and [n, K] rows are staged through the warp's scratch so that global
// accesses are coalesced. Warps never wait for each other after the
// weights are in.
#include <cuda_runtime.h>

#include "grouped.cuh"
#include "nlplant.cuh"

using namespace np_grp;

__global__ void __launch_bounds__(GRP_THREADS, 1)
aero_coeffs_kernel(const float* __restrict__ alpha, const float* __restrict__ beta,
                   const float* __restrict__ el, const uint2* __restrict__ frags,
                   const float* __restrict__ vec, float* __restrict__ out, int n,
                   bool row_major) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem sm = load_weights(smem_raw, frags, vec);
  const int lane = threadIdx.x & 31, row = own_row();
  const int tiles = (n + TILE - 1) / TILE;
  for (int tile = blockIdx.x * GRP_WARPS + (threadIdx.x >> 5); tile < tiles;
       tile += gridDim.x * GRP_WARPS) {
    const int base = tile * TILE, i = base + row;
    const bool valid = i < n;
    sweep<false>(sm, valid ? alpha[i] : 0.0f, valid ? beta[i] : 0.0f, valid ? el[i] : 0.0f);
    __syncwarp();
    if (row_major) {  // the tile's [nv, K] rows are contiguous in out
      const int nv = min(TILE, n - base);
      for (int e = lane; e < nv * N_NETS; e += 32) {
        const int r = e / N_NETS, k = e - r * N_NETS;
        out[(size_t)base * N_NETS + e] = sm.cw[k * TILE + r];
      }
    } else if (base + lane < n) {
#pragma unroll 1
      for (int k = 0; k < N_NETS; ++k) out[(size_t)k * n + base + lane] = sm.cw[k * TILE + lane];
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(GRP_THREADS, 1)
aero_totals_kernel(const float* __restrict__ feats, const uint2* __restrict__ frags,
                   const float* __restrict__ vec, float* __restrict__ out, int n) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem sm = load_weights(smem_raw, frags, vec);
  const int row = own_row();
  const int tiles = (n + TILE - 1) / TILE;
  for (int tile = blockIdx.x * GRP_WARPS + (threadIdx.x >> 5); tile < tiles;
       tile += gridDim.x * GRP_WARPS) {
    const int i = tile * TILE + row;
    const bool valid = i < n;
    float f[10];  // alpha beta el dlef dail drud P Q R 1/(2 vt)
#pragma unroll
    for (int j = 0; j < 10; ++j) f[j] = valid ? feats[(size_t)j * n + i] : 0.0f;
    sweep<false>(sm, f[0], f[1], f[2]);
    if (valid) {
      float c[N_NETS], tot[6];
      coefficients(sm, c);
      np_f16::coeff_buildup(c, f[3], f[4], f[5], f[6], f[7], f[8], f[1],
                            (float)np_f16::CBAR * f[9], (float)np_f16::B_SPAN * f[9], tot);
#pragma unroll
      for (int j = 0; j < 6; ++j) out[(size_t)j * n + i] = tot[j];
    }
  }
}

template <bool HB>
__global__ void __launch_bounds__(GRP_THREADS, 1)
nlplant_grouped_kernel(const float* __restrict__ s, const float* __restrict__ u,
                       const uint2* __restrict__ frags, const float* __restrict__ vec,
                       float* __restrict__ xdot, int n) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem sm = load_weights(smem_raw, frags, vec);
  const int lane = threadIdx.x & 31, row = own_row();
  const int tiles = (n + TILE - 1) / TILE;
  float* s_st = sm.cw;               // [TILE][12]
  float* u_st = sm.cw + TILE * 12;   // [TILE][5]
  for (int tile = blockIdx.x * GRP_WARPS + (threadIdx.x >> 5); tile < tiles;
       tile += gridDim.x * GRP_WARPS) {
    const int base = tile * TILE, nv = min(TILE, n - base);
    const bool valid = row < nv;
    // coalesced loads of the tile's [nv, 12] and [nv, 5] rows
    for (int e = lane; e < nv * 12; e += 32) s_st[e] = s[(size_t)base * 12 + e];
    for (int e = lane; e < nv * 5; e += 32) u_st[e] = u[(size_t)base * 5 + e];
    __syncwarp();
    float sv[12], uv[5];
#pragma unroll
    for (int j = 0; j < 12; ++j) sv[j] = valid ? s_st[row * 12 + j] : 0.0f;
#pragma unroll
    for (int j = 0; j < 5; ++j) uv[j] = valid ? u_st[row * 5 + j] : 0.0f;
    __syncwarp();  // the sweep overwrites the staging
    sweep<HB>(sm, sv[7] * np_f16::R2D, sv[8] * np_f16::R2D, uv[1]);
    float xd[12];
    if (valid) {
      float c[N_NETS];
      coefficients(sm, c);
      np_f16::nlplant_core(sv, uv, c, xd);
    }
    __syncwarp();  // every lane has read its coefficients
    if (valid) {
#pragma unroll
      for (int j = 0; j < 12; ++j) s_st[row * 12 + j] = xd[j];
    }
    __syncwarp();
    for (int e = lane; e < nv * 12; e += 32) xdot[(size_t)base * 12 + e] = s_st[e];
    __syncwarp();
  }
}

template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)SMEM_BYTES);
}

extern "C" {

const char* np_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int np_aero_coeffs(const float* alpha, const float* beta, const float* el,
                   const uint2* frags, const float* vec, float* out, int n, int row_major,
                   void* stream) {
  cudaError_t err = allow_smem(aero_coeffs_kernel);
  if (err != cudaSuccess) return (int)err;
  aero_coeffs_kernel<<<grid_blocks(n), GRP_THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      alpha, beta, el, frags, vec, out, n, row_major != 0);
  return (int)cudaGetLastError();
}

int np_aero_totals(const float* feats, const uint2* frags, const float* vec, float* out,
                   int n, void* stream) {
  cudaError_t err = allow_smem(aero_totals_kernel);
  if (err != cudaSuccess) return (int)err;
  aero_totals_kernel<<<grid_blocks(n), GRP_THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      feats, frags, vec, out, n);
  return (int)cudaGetLastError();
}

int np_nlplant_grouped(const float* s, const float* u, const uint2* frags, const float* vec,
                       float* xdot, int n, int hidden_bf16, void* stream) {
  cudaError_t err = hidden_bf16 ? allow_smem(nlplant_grouped_kernel<true>)
                                : allow_smem(nlplant_grouped_kernel<false>);
  if (err != cudaSuccess) return (int)err;
  const int blocks = grid_blocks(n);
  if (hidden_bf16)
    nlplant_grouped_kernel<true><<<blocks, GRP_THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        s, u, frags, vec, xdot, n);
  else
    nlplant_grouped_kernel<false><<<blocks, GRP_THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        s, u, frags, vec, xdot, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
