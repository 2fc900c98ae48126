// env_step: the whole F-16 control-task env step, in two kernels that
// share everything but the surrogate: the distilled trunk (a multiplier
// warpgroup and 256 aircraft-owning threads per SM) and the 43-net ensemble
// (one warp per 32 aircraft).
//
// Replaces the TPU kernel neuralplane_tpu/ops/step_pallas.py:env_step_pallas
// (_step_kernel) in its distilled and its grouped mode; its task layer is
// the device twin of neuralplane_tpu/ops/task_pallas.py:task_rows.
//
// Per aircraft: optional Philox draws (init uniforms + target resample),
// masked reset select, actuator lag, distilled surrogate (tensor cores),
// nlplant, Euler, and the task layer (22-slot observation with optional
// Box-Muller sensor noise, six terminations, reward, per-condition counts).
// xdot, features and hidden layers never leave the chip.
//
// Bound. The surrogate needs 2 * (256*68 + 256*256 + 43*324) = 193,752 FLOP
// per aircraft on bf16 operands (the bound counts these); with the padding
// the kernel multiplies, 2 * (256*80 + 256*256 + 48*336) = 204,288. The
// step reads ~28 floats (state 12, control 5, action 4, mask, 2 init draws,
// 3 targets, step count) and writes ~42 (state 12, control 5, observation
// 22, reward, 2 flags), ~0.3 KB per aircraft. At n = 10^6: 1.94e11 FLOP
// (0.196 ms at 989 TFLOP/s dense bf16) against ~0.3 GB (~0.09 ms at 3.35
// TB/s): the tensor cores bound it.
//
// Design (distilled.cuh). One persistent block per SM keeps all weights in
// shared memory; warps 0-3 run the three products as wgmma with every
// activation in registers; each thread of warps 4-11 owns one aircraft from
// the reset select to the task layer, draws its own noise, and meets the
// multiplier only through mbarriers: no block-wide barrier in the tile
// loop. Feature-major state reads and writes are coalesced across the
// pair's 64 threads; the [n, 22] observation row leaves as 11 8-byte stores
// of its owner. The six counts are warp ballots, then one atomicAdd per
// warp and condition into int32. Random draws: Philox4x32-10 keyed by two
// seed words read from device memory (no host sync per step), counter
// (aircraft, draw block).
//
// Grouped mode. The 43-net sweep (grouped.cuh) takes the trunk's place:
// 57,620 FLOP per aircraft (0.058 ms at n = 10^6) against the same ~0.3 KB
// (~0.08 ms), so the bytes bound it. Every lane owns one aircraft from the
// reset select to the task layer and draws its own noise; the warp's
// scratch stages the [32, 22] observation rows. Shared memory: 215,344
// bytes a block (127,280 of weights, 5,504 of scratch for each of 16
// warps), one persistent block per SM.
#include <cuda_runtime.h>

#include "distilled.cuh"
#include "grouped.cuh"
#include "nlplant.cuh"
#include "philox.cuh"
#include "task.cuh"

using namespace np_dist;

// Must match neuralplane_tpu_torch/ops/step_cuda.py:StepParams.
struct StepParams {
  int n, variant, reset_draws, hidden_bf16, H, max_check, min_check, random_inc;
  float noise_scale, dt, init_T;
  float airspeed, acc_limit, alt_limit, max_mach, min_mach;
  float min_alpha, max_alpha, min_beta, max_beta;
  float min_alt, alt_span, min_vt, vt_span;
  float max_hdg_inc, max_alt_inc, max_vu_inc, max_pitch_inc, min_dist, dist_span;
};

struct StepIO {
  const float* sf;      // [12][n]
  const float* uf;      // [5][n]
  const float* act;     // [n][4]
  const bool* mask;     // [n]
  const float* alt_init;  // [n] or null (reset_draws)
  const float* vt_init;   // [n] or null
  const float* tg[3];   // [n] each
  const int* sc;        // [n]
  const int* seed;      // [2] or null
  float* sf_out;        // [12][n]
  float* uf_out;        // [5][n]
  float* obs;           // [n][22]
  bool* done;           // [n]
  bool* bad;            // [n]
  float* reward;        // [n]
  int* counts;          // [6], zeroed by the caller
  float* tg_out[3];     // [n] each, reset_draws only
};

constexpr double PI_D = 3.141592653589793;
constexpr float THRUST_SCALE = (float)(0.225 * 76300.0 / 0.3048);
constexpr float SURFACE_SCALE = 45.0f;

// Targets of a reset aircraft from its init draws and the uniforms
// d2, d3, d4 (step_pallas.py:_resample_targets).
__device__ __forceinline__ void resample_targets(const StepParams& p, float d2, float d3,
                                                 float d4, float alt0, float vt0,
                                                 float t[3]) {
  if (p.variant == np_task::HEADING) {
    float d_hdg, d_alt, d_vt;
    if (p.random_inc) {
      d_hdg = (d2 - 0.5f) * 2.0f * p.max_hdg_inc;
      d_alt = (d3 - 0.5f) * 2.0f * p.max_alt_inc;
      d_vt = (d4 - 0.5f) * 2.0f * p.max_vu_inc;
    } else {  // reference fixed increments
      d_hdg = (float)(2.0 * PI_D / 3.0);
      d_alt = 1000.0f;
      d_vt = 0.0f;
    }
    t[0] = alt0 + d_alt;
    t[1] = np_task::wrap_pi(0.0f + d_hdg);
    t[2] = vt0 + d_vt;
  } else if (p.variant == np_task::CONTROL) {
    t[0] = np_task::wrap_pi((d2 - 0.5f) * 2.0f * p.max_pitch_inc);
    t[1] = np_task::wrap_pi((d3 - 0.5f) * 2.0f * p.max_hdg_inc);
    t[2] = vt0 + (d4 - 0.5f) * 2.0f * p.max_vu_inc;
  } else {
    const float dist = d2 * p.dist_span + p.min_dist;
    const float th1 = d3 * (float)(PI_D / 3.0) - (float)(PI_D / 6.0);
    const float th2 = d4 * (float)(PI_D / 3.0) - (float)(PI_D / 6.0);
    t[0] = dist * cosf(th1) * cosf(th2);
    t[1] = dist * cosf(th1) * sinf(th2);
    t[2] = alt0 + dist * sinf(th1);
  }
}

// Steps 0-2 for the valid aircraft i: optional Philox draws (init uniforms
// and target resample), masked reset select, actuator lag.
__device__ __forceinline__ void step_inputs(const StepIO& io, const StepParams& p, int i,
                                            float s[12], float u[5], float tr[3], int& sc) {
  const int n = p.n;
  const bool m = io.mask[i];
  float alt0, vt0;
  if (p.reset_draws) {
    // 0. init draws and target resample (blocks 0 and 1 of the counter)
    const uint2 key = make_uint2((uint32_t)io.seed[0], (uint32_t)io.seed[1]);
    const float4 d0 = np_rng::uniform4(key, (uint32_t)i, 0u);
    const float4 d1 = np_rng::uniform4(key, (uint32_t)i, 1u);
    alt0 = p.min_alt + d0.x * p.alt_span;
    vt0 = p.min_vt + d0.y * p.vt_span;
    float tn[3];
    resample_targets(p, d0.z, d0.w, d1.x, alt0, vt0, tn);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      tr[k] = m ? tn[k] : io.tg[k][i];
      io.tg_out[k][i] = tr[k];
    }
  } else {
    alt0 = io.alt_init[i];
    vt0 = io.vt_init[i];
#pragma unroll
    for (int k = 0; k < 3; ++k) tr[k] = io.tg[k][i];
  }
  // 1. masked reset select
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const float init = j == 2 ? alt0 : (j == 6 ? vt0 : 0.0f);
    s[j] = m ? init : io.sf[(size_t)j * n + i];
  }
  // 2. actuator lag on the post-reset control; lef pinned to 0
  const float4 a = reinterpret_cast<const float4*>(io.act)[i];
  const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float prev = m ? (j == 0 ? p.init_T : 0.0f) : io.uf[(size_t)j * n + i];
    const float scale = j == 0 ? THRUST_SCALE : SURFACE_SCALE;
    u[j] = 0.9f * prev + 0.1f * fminf(fmaxf(av[j], -1.0f), 1.0f) * scale;
  }
  u[4] = 0.0f;
  sc = io.sc[i];
}

// A row past n: zeros, so that the surrogate runs on finite values.
__device__ __forceinline__ void zero_inputs(float s[12], float u[5], float tr[3]) {
#pragma unroll
  for (int j = 0; j < 12; ++j) s[j] = 0.0f;
#pragma unroll
  for (int j = 0; j < 5; ++j) u[j] = 0.0f;
  tr[0] = tr[1] = tr[2] = 0.0f;
}

// Sensor noise, item q in {0, 1, 2} of aircraft i: counter blocks 2 + q
// (radii) and 5 + q (angles) give the Box-Muller pairs of observation
// slots k and 12 + k, k = 4q..4q+3, written to dst[22].
__device__ __forceinline__ void noise_item(uint2 key, uint32_t i, int q, float noise_scale,
                                           float* dst) {
  const float4 ur = np_rng::uniform4(key, i, 2u + q);
  const float4 ut = np_rng::uniform4(key, i, 5u + q);
  const float rad_u[4] = {ur.x, ur.y, ur.z, ur.w}, ang_u[4] = {ut.x, ut.y, ut.z, ut.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int k = 4 * q + c;
    const float rad = sqrtf(-2.0f * logf(fmaxf(rad_u[c], 1e-7f)));
    const float th = (float)(2.0 * PI_D) * ang_u[c];
    dst[k] = rad * cosf(th) * noise_scale;
    if (12 + k < 22) dst[12 + k] = rad * sinf(th) * noise_scale;
  }
}

// Steps 3b-5 for the valid aircraft i, from its raw coefficients: nlplant,
// Euler, the task layer, and every output but the observation, which comes
// back noiseless in obs[22] with the six conditions.
__device__ __forceinline__ void step_outputs(const StepIO& io, const StepParams& p, int i,
                                             const float s[12], const float u[5],
                                             const float tr[3], int sc,
                                             const float c[np_f16::N_COEF], float obs[22],
                                             bool conds[6]) {
  const int n = p.n;
  float xd[12], sn[12];
  np_f16::nlplant_core(s, u, c, xd);
  // 4. Euler
#pragma unroll
  for (int j = 0; j < 12; ++j) sn[j] = s[j] + p.dt * xd[j];
  // 5. task layer at the post-step state with the step-start xdot
  const np_task::TaskConsts tc{p.airspeed, p.acc_limit, p.alt_limit, p.max_mach,
                               p.min_mach, p.min_alpha, p.max_alpha, p.min_beta,
                               p.max_beta, p.max_check, p.min_check};
  bool done, bad;
  float rew;
  np_task::task_rows(p.variant, tc, sn, u, xd, tr, sc, obs, conds, done, bad, rew);
#pragma unroll
  for (int j = 0; j < 12; ++j) io.sf_out[(size_t)j * n + i] = sn[j];
#pragma unroll
  for (int j = 0; j < 5; ++j) io.uf_out[(size_t)j * n + i] = u[j];
  io.done[i] = done;
  io.bad[i] = bad;
  io.reward[i] = rew;
}

// Whole warp: per-condition counts, one atomicAdd per warp and condition.
__device__ __forceinline__ void add_counts(int* counts, const bool conds[6]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const unsigned bits = __ballot_sync(0xffffffffu, conds[k]);
    if (lane == 0 && bits) atomicAdd(counts + k, __popc(bits));
  }
}

// Sensor noise of aircraft i added to its observation.
__device__ __forceinline__ void add_noise(const StepIO& io, const StepParams& p, int i,
                                          float obs[22]) {
  const uint2 key = make_uint2((uint32_t)io.seed[0], (uint32_t)io.seed[1]);
  float nz[22];
#pragma unroll
  for (int q = 0; q < 3; ++q) noise_item(key, (uint32_t)i, q, p.noise_scale, nz);
#pragma unroll
  for (int j = 0; j < 22; ++j) obs[j] = obs[j] + nz[j];
}

// The distilled mode. Warps 0-3 multiply (distilled.cuh); every thread of
// warps 4-11 owns aircraft `row` of its pair's tile.
template <bool HB>
__global__ void __launch_bounds__(NP_THREADS, 1)
env_step_kernel(StepIO io, const unsigned char* __restrict__ image, StepParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem sm = block_setup(smem_raw, image);
  const int n = p.n;
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
      float s[12], u[5], tr[3];
      int sc = 0;
      if (valid) step_inputs(io, p, i, s, u, tr, sc);
      else zero_inputs(s, u, tr);
      // 3. surrogate at (post-reset s, lagged u)
      post_inputs(sm, o, j, s[7] * np_f16::R2D, s[8] * np_f16::R2D, u[1]);
      float c[N_COEF];
      take_coefficients(sm, o, j, c);
      bool conds[6] = {false, false, false, false, false, false};
      if (valid) {
        float obs[22];
        step_outputs(io, p, i, s, u, tr, sc, c, obs, conds);
        if (p.noise_scale > 0.0f) add_noise(io, p, i, obs);
        float2* row = reinterpret_cast<float2*>(io.obs + (size_t)i * 22);
#pragma unroll
        for (int k = 0; k < 11; ++k) row[k] = make_float2(obs[2 * k], obs[2 * k + 1]);
      }
      add_counts(io.counts, conds);
    }
  }
}

// The grouped mode: the same step on the 43-net ensemble. Every lane owns
// the aircraft np_grp::own_row() of its warp's tile.
template <bool HB>
__global__ void __launch_bounds__(np_grp::GRP_THREADS, 1)
env_step_grouped_kernel(StepIO io, const uint2* __restrict__ frags,
                        const float* __restrict__ vec, StepParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const np_grp::Smem sm = np_grp::load_weights(smem_raw, frags, vec);
  const int lane = threadIdx.x & 31, row = np_grp::own_row();
  const int n = p.n;
  const int tiles = (n + np_grp::TILE - 1) / np_grp::TILE;
  for (int tile = blockIdx.x * np_grp::GRP_WARPS + (threadIdx.x >> 5); tile < tiles;
       tile += gridDim.x * np_grp::GRP_WARPS) {
    const int base = tile * np_grp::TILE, nv = min(np_grp::TILE, n - base);
    const int i = base + row;
    const bool valid = row < nv;
    float s[12], u[5], tr[3];
    int sc = 0;
    if (valid) step_inputs(io, p, i, s, u, tr, sc);
    else zero_inputs(s, u, tr);
    // 3. surrogate at (post-reset s, lagged u)
    np_grp::sweep<HB>(sm, s[7] * np_f16::R2D, s[8] * np_f16::R2D, u[1]);
    bool conds[6] = {false, false, false, false, false, false};
    float obs[22];
    if (valid) {
      float c[np_grp::N_NETS];
      np_grp::coefficients(sm, c);
      step_outputs(io, p, i, s, u, tr, sc, c, obs, conds);
      if (p.noise_scale > 0.0f) add_noise(io, p, i, obs);
    }
    add_counts(io.counts, conds);
    __syncwarp();  // every lane has read its coefficients
    if (valid) {
#pragma unroll
      for (int j = 0; j < 22; ++j) sm.cw[row * 22 + j] = obs[j];
    }
    __syncwarp();
    for (int e = lane; e < nv * 22; e += 32) io.obs[(size_t)base * 22 + e] = sm.cw[e];
    __syncwarp();
  }
}

extern "C" {

const char* np_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

static StepIO step_io(const float* sf, const float* uf, const float* act, const bool* mask,
                      const float* alt_init, const float* vt_init, const float* tg0,
                      const float* tg1, const float* tg2, const int* sc, const int* seed,
                      float* sf_out, float* uf_out, float* obs, bool* done, bool* bad,
                      float* reward, int* counts, float* tg0_out, float* tg1_out,
                      float* tg2_out) {
  StepIO io;
  io.sf = sf; io.uf = uf; io.act = act; io.mask = mask;
  io.alt_init = alt_init; io.vt_init = vt_init;
  io.tg[0] = tg0; io.tg[1] = tg1; io.tg[2] = tg2;
  io.sc = sc; io.seed = seed;
  io.sf_out = sf_out; io.uf_out = uf_out; io.obs = obs;
  io.done = done; io.bad = bad; io.reward = reward; io.counts = counts;
  io.tg_out[0] = tg0_out; io.tg_out[1] = tg1_out; io.tg_out[2] = tg2_out;
  return io;
}

// The distilled mode: `image` is DistilledAeroWeights.packed().
int np_env_step(const float* sf, const float* uf, const float* act, const bool* mask,
                const float* alt_init, const float* vt_init, const float* tg0,
                const float* tg1, const float* tg2, const int* sc, const int* seed,
                const unsigned char* image, StepParams p, float* sf_out, float* uf_out,
                float* obs, bool* done, bool* bad, float* reward, int* counts,
                float* tg0_out, float* tg1_out, float* tg2_out, void* stream) {
  if (p.H != NP_H) return (int)cudaErrorInvalidValue;
  const auto kernel = p.hidden_bf16 ? env_step_kernel<true> : env_step_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const StepIO io = step_io(sf, uf, act, mask, alt_init, vt_init, tg0, tg1, tg2, sc, seed,
                            sf_out, uf_out, obs, done, bad, reward, counts, tg0_out,
                            tg1_out, tg2_out);
  kernel<<<grid_blocks(p.n), NP_THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(io, image, p);
  return (int)cudaGetLastError();
}

// The grouped mode: `frags` and `vec` are GroupedAeroWeights.packed().
int np_env_step_grouped(const float* sf, const float* uf, const float* act,
                        const bool* mask, const float* alt_init, const float* vt_init,
                        const float* tg0, const float* tg1, const float* tg2,
                        const int* sc, const int* seed, const uint2* frags,
                        const float* vec, StepParams p, float* sf_out, float* uf_out,
                        float* obs, bool* done, bool* bad, float* reward, int* counts,
                        float* tg0_out, float* tg1_out, float* tg2_out, void* stream) {
  const size_t smem = np_grp::SMEM_BYTES;
  cudaError_t err =
      p.hidden_bf16
          ? cudaFuncSetAttribute(env_step_grouped_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
          : cudaFuncSetAttribute(env_step_grouped_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const StepIO io = step_io(sf, uf, act, mask, alt_init, vt_init, tg0, tg1, tg2, sc, seed,
                            sf_out, uf_out, obs, done, bad, reward, counts, tg0_out,
                            tg1_out, tg2_out);
  const int blocks = np_grp::grid_blocks(p.n);
  const cudaStream_t st = (cudaStream_t)stream;
  if (p.hidden_bf16)
    env_step_grouped_kernel<true><<<blocks, np_grp::GRP_THREADS, smem, st>>>(io, frags, vec, p);
  else
    env_step_grouped_kernel<false><<<blocks, np_grp::GRP_THREADS, smem, st>>>(io, frags, vec, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
