// Philox4x32-10 counter-based generator (Salmon et al., "Parallel random
// numbers: as easy as 1, 2, 3", SC'11), written out for the step kernel.
//
// Replaces the TPU hardware PRNG of neuralplane_tpu/ops/step_pallas.py
// (pltpu.prng_seed / prng_random_bits). Every draw is a pure function of
// (key, counter): the key is the two seed words the caller draws on the
// device for each step, the counter is (aircraft index, draw block, 0, 0).
// So no two aircraft or draw blocks share a stream within a step, with no
// per-tile seeding and no birthday collisions between tiles.
#pragma once
#include <cstdint>

namespace np_rng {

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(M0, ctr.x), lo0 = M0 * ctr.x;
    const uint32_t hi1 = __umulhi(M1, ctr.z), lo1 = M1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += W0;
    key.y += W1;
  }
  return ctr;
}

// [0, 1) with 23 random mantissa bits: the same mantissa fill as the TPU
// kernel's _uniform_rows (bits >> 9 | 0x3F800000, minus 1).
__device__ __forceinline__ float bits_to_unit(uint32_t b) {
  return __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
}

// Four uniforms for (aircraft i, draw block blk).
__device__ __forceinline__ float4 uniform4(uint2 key, uint32_t i, uint32_t blk) {
  const uint4 r = philox4x32_10(make_uint4(i, blk, 0u, 0u), key);
  return make_float4(bits_to_unit(r.x), bits_to_unit(r.y), bits_to_unit(r.z),
                     bits_to_unit(r.w));
}

}  // namespace np_rng
