// task_step: the task layer of the three control tasks on its own, one
// thread per aircraft.
//
// Replaces the TPU kernel neuralplane_tpu/ops/task_pallas.py:task_step_pallas
// (_make_kernel over task_rows): from the post-step state and control, the
// step-start xdot, the targets and the step count to the noiseless 22-slot
// observation, the done and bad flags, the reward and the six per-condition
// counts.
//
// Bound. No products: per aircraft 33 words in (state 12, control 5, xdot
// 12, 3 targets, step count) and 94 bytes out (observation 22 floats,
// reward, 2 flags), 226 B, ~0.067 ms at n = 10^6 and 3.35 TB/s. The bytes
// bound it.
//
// Design. The arithmetic is task.cuh:task_rows, shared with the step
// kernels. The [n, 12], [n, 5] and [n, 22] rows are staged through shared
// memory so that every global access is coalesced; the counts are warp
// ballots and one int32 atomicAdd per warp and condition.
#include <cuda_runtime.h>

#include "task.cuh"

constexpr int TS_THREADS = 256;
constexpr int TS_STAGE = 12 + 5 + 12;  // floats staged in per aircraft

// Must match neuralplane_tpu_torch/ops/task_cuda.py:TaskParams.
struct TaskParams {
  int n, variant, max_check, min_check;
  float airspeed, acc_limit, alt_limit, max_mach, min_mach;
  float min_alpha, max_alpha, min_beta, max_beta;
};

__global__ void __launch_bounds__(TS_THREADS)
task_step_kernel(const float* __restrict__ s, const float* __restrict__ u,
                 const float* __restrict__ xdot, const float* __restrict__ tg0,
                 const float* __restrict__ tg1, const float* __restrict__ tg2,
                 const int* __restrict__ sc, TaskParams p, float* __restrict__ obs,
                 bool* __restrict__ done, bool* __restrict__ bad,
                 float* __restrict__ reward, int* __restrict__ counts) {
  __shared__ float stage[TS_THREADS * TS_STAGE];
  static_assert(22 <= TS_STAGE, "the observation rows reuse the input staging");
  const int t = threadIdx.x;
  const int i0 = blockIdx.x * TS_THREADS;
  const int nv = min(TS_THREADS, p.n - i0);
  const int i = i0 + t;
  float* s_st = stage;                       // [TS_THREADS][12]
  float* x_st = stage + TS_THREADS * 12;     // [TS_THREADS][12]
  float* u_st = stage + TS_THREADS * 24;     // [TS_THREADS][5]
  for (int e = t; e < nv * 12; e += TS_THREADS) {
    s_st[e] = s[(size_t)i0 * 12 + e];
    x_st[e] = xdot[(size_t)i0 * 12 + e];
  }
  for (int e = t; e < nv * 5; e += TS_THREADS) u_st[e] = u[(size_t)i0 * 5 + e];
  __syncthreads();

  const bool valid = t < nv;
  bool conds[6] = {false, false, false, false, false, false};
  float o[22];
  if (valid) {
    float sv[12], xv[12], uv[5];
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      sv[j] = s_st[t * 12 + j];
      xv[j] = x_st[t * 12 + j];
    }
#pragma unroll
    for (int j = 0; j < 5; ++j) uv[j] = u_st[t * 5 + j];
    const float tr[3] = {tg0[i], tg1[i], tg2[i]};
    const np_task::TaskConsts tc{p.airspeed, p.acc_limit, p.alt_limit, p.max_mach,
                                 p.min_mach, p.min_alpha, p.max_alpha, p.min_beta,
                                 p.max_beta, p.max_check, p.min_check};
    bool d, b;
    float rew;
    np_task::task_rows(p.variant, tc, sv, uv, xv, tr, sc[i], o, conds, d, b, rew);
    done[i] = d;
    bad[i] = b;
    reward[i] = rew;
  }
  // per-condition counts over valid rows
  const int lane = t & 31;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const unsigned bits = __ballot_sync(0xffffffffu, conds[k]);
    if (lane == 0 && bits) atomicAdd(counts + k, __popc(bits));
  }
  __syncthreads();  // every thread has read its inputs
  if (valid) {
#pragma unroll
    for (int j = 0; j < 22; ++j) stage[t * 22 + j] = o[j];
  }
  __syncthreads();
  for (int e = t; e < nv * 22; e += TS_THREADS) obs[(size_t)i0 * 22 + e] = stage[e];
}

extern "C" {

const char* np_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// counts [6] is zeroed by the caller.
int np_task_step(const float* s, const float* u, const float* xdot, const float* tg0,
                 const float* tg1, const float* tg2, const int* sc, TaskParams p,
                 float* obs, bool* done, bool* bad, float* reward, int* counts,
                 void* stream) {
  const int blocks = (p.n + TS_THREADS - 1) / TS_THREADS;
  task_step_kernel<<<blocks, TS_THREADS, 0, (cudaStream_t)stream>>>(
      s, u, xdot, tg0, tg1, tg2, sc, p, obs, done, bad, reward, counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
