// The 43-net aero ensemble for one warp tile of 32 aircraft: 43 chains of
// [3 -> 20 -> 20 -> 10 -> 1] ReLU nets on tensor cores, activations in
// registers from the inputs to the coefficients. Twin of
// neuralplane_tpu_torch/ops/aero_grouped_cuda.py:grouped_coeff_rows and of
// the TPU's neuralplane_tpu/ops/aero_pallas.py:aero_coeff_rows.
//
// Packing. The TPU kernel packs 6 nets into a block-diagonal 128 x 128 tile
// to fill its matrix unit (661,504 FLOP per aircraft for 57,620 FLOP of
// nets). Here one net is one chain of mma.sync products whose K is padded
// 3 -> 8 and 20 -> 16 + 8 (an m16n8k16 and an m16n8k8 step) and whose N is
// padded 20 -> 24 and 10 -> 16: 13 tile products per net and 16 aircraft,
// 2,304 FLOP per net and aircraft, 99,932 per aircraft with the readout
// (1.73x the nets' own work).
//
// Layout. A warp owns 32 aircraft as two m16 tiles. The accumulator layout
// of m16n8 (lane 4g + t holds columns 2t, 2t + 1 of rows g and g + 8) is
// the A-operand layout of the next product, so a layer's output is rounded
// to bf16, packed in pairs and fed straight back: no activation touches
// shared memory. The readout (a 10-long dot) is four products per lane and
// two shuffles across the quad. Lane 4g + t owns aircraft
// 16 (t / 2) + 8 (t % 2) + g of the tile: one of the four rows its quad
// holds, so every lane keeps exactly the coefficients of its own aircraft
// and writes them to the warp's scratch cw[43][32].
//
// Weights. All 43 nets are 113,520 bytes as packed by
// ops/aero.py:GroupedAeroWeights.packed (bf16 B fragments in lane order,
// float32 biases and readout): they sit in shared memory for the whole
// block, which is persistent (one block per SM, warps stride over tiles).
//
// Rounding points (the TPU kernel's): inputs to bf16; bf16 x bf16 products
// summed in float32; with hidden_bf16 the sum is rounded to bf16, the bias
// is rounded to bf16, and add and ReLU run in bf16; without it ReLU(sum + b)
// in float32, rounded to bf16 for the next product; the readout is bf16 h3
// times bf16 W4 summed in float32, plus the float32 b4.
#pragma once
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "distilled.cuh"

namespace np_grp {

constexpr int N_NETS = 43;
constexpr int TILE = 32;              // aircraft per warp tile
constexpr int GRP_WARPS = 16;         // warps per block
constexpr int GRP_THREADS = 32 * GRP_WARPS;
constexpr int FRAG_PAIRS = 9;         // uint2 of B fragments per lane and net
constexpr int VEC = 84;               // floats per net: b1[24] b2[24] b3[16] W4[16] b4 pad
constexpr int OFF_B2 = 24, OFF_B3 = 48, OFF_W4 = 64, OFF_B4 = 80;
constexpr int SCRATCH = N_NETS * TILE;  // floats of scratch per warp

constexpr size_t SMEM_FRAGS = (size_t)N_NETS * FRAG_PAIRS * 32 * 8;
constexpr size_t SMEM_VEC = (size_t)N_NETS * VEC * 4;
constexpr size_t SMEM_BYTES = SMEM_FRAGS + SMEM_VEC + (size_t)GRP_WARPS * SCRATCH * 4;
static_assert(SMEM_FRAGS % 16 == 0 && SMEM_VEC % 16 == 0, "16-byte copies");
static_assert(SMEM_BYTES <= 232448, "a block's shared memory on sm_90");
static_assert(TILE * 22 <= SCRATCH, "the [32][22] observation staging fits the scratch");

struct Smem {
  const uint2* frags;  // [N_NETS][FRAG_PAIRS][32]
  const float* vec;    // [N_NETS][VEC]
  float* cw;           // this warp's scratch: coefficients [N_NETS][TILE], or I/O staging
};

// All threads: copy the packed weights into shared memory and return the
// block's layout; ends with a barrier.
__device__ __forceinline__ Smem load_weights(unsigned char* smem,
                                             const uint2* __restrict__ g_frags,
                                             const float* __restrict__ g_vec) {
  const uint4* src = reinterpret_cast<const uint4*>(g_frags);
  uint4* dst = reinterpret_cast<uint4*>(smem);
  for (int e = threadIdx.x; e < (int)(SMEM_FRAGS / 16); e += blockDim.x)
    np_dist::cp_async16(dst + e, src + e);
  src = reinterpret_cast<const uint4*>(g_vec);
  dst = reinterpret_cast<uint4*>(smem + SMEM_FRAGS);
  for (int e = threadIdx.x; e < (int)(SMEM_VEC / 16); e += blockDim.x)
    np_dist::cp_async16(dst + e, src + e);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  Smem s;
  s.frags = reinterpret_cast<const uint2*>(smem);
  s.vec = reinterpret_cast<const float*>(smem + SMEM_FRAGS);
  s.cw = reinterpret_cast<float*>(smem + SMEM_FRAGS + SMEM_VEC)
         + (threadIdx.x >> 5) * SCRATCH;
  return s;
}

// The aircraft of the warp tile that this lane owns.
__device__ __forceinline__ int own_row() {
  const int lane = threadIdx.x & 31, t = lane & 3;
  return 16 * (t >> 1) + 8 * (t & 1) + (lane >> 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a . b, m16n8k8 and m16n8k16, bf16 operands, float32 accumulators.
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t* a, uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One accumulator tile (columns 2t, 2t + 1 of rows g and g + 8) through
// bias and ReLU, packed as two words of the next product's A operand.
template <bool HB>
__device__ __forceinline__ void hidden_pair(const float (&c)[4], float2 b, uint32_t& row_g,
                                            uint32_t& row_g8) {
  __nv_bfloat162 lo, hi;
  if (HB) {
    const __nv_bfloat162 bb = __floats2bfloat162_rn(b.x, b.y);
    const __nv_bfloat162 zero = __floats2bfloat162_rn(0.0f, 0.0f);
    lo = __hmax2(__hadd2(__floats2bfloat162_rn(c[0], c[1]), bb), zero);
    hi = __hmax2(__hadd2(__floats2bfloat162_rn(c[2], c[3]), bb), zero);
  } else {
    lo = __floats2bfloat162_rn(fmaxf(c[0] + b.x, 0.0f), fmaxf(c[1] + b.y, 0.0f));
    hi = __floats2bfloat162_rn(fmaxf(c[2] + b.x, 0.0f), fmaxf(c[3] + b.y, 0.0f));
  }
  row_g = *reinterpret_cast<const uint32_t*>(&lo);
  row_g8 = *reinterpret_cast<const uint32_t*>(&hi);
}

// Every lane of the warp calls it with the (alpha_deg, beta_deg, el) of the
// aircraft it owns (own_row); on return sm.cw[k * TILE + own_row()] holds
// coefficient k of that aircraft, written by this lane itself.
template <bool HB>
__device__ __forceinline__ void sweep(const Smem& sm, float alpha_deg, float beta_deg,
                                      float el) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31, t = lane & 3;
  // layer-1 A operand (m16n8k8): lane (g, 0) holds (alpha, beta) and lane
  // (g, 1) holds (el, 0) of rows g and g + 8, fetched from their owners
  const uint32_t p_ab = pack_bf16(alpha_deg, beta_deg), p_e = pack_bf16(el, 0.0f);
  uint32_t xa[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int owner = (lane & ~3) | (2 * m + half);
      const uint32_t ab = __shfl_sync(FULL, p_ab, owner), e = __shfl_sync(FULL, p_e, owner);
      xa[m][half] = t == 0 ? ab : (t == 1 ? e : 0u);
    }

  const int row = own_row();
#pragma unroll 1
  for (int k = 0; k < N_NETS; ++k) {
    const uint2* f = sm.frags + (k * FRAG_PAIRS) * 32 + lane;
    const float* v = sm.vec + k * VEC + 2 * t;
    uint2 q[FRAG_PAIRS];
#pragma unroll
    for (int i = 0; i < FRAG_PAIRS; ++i) q[i] = f[i * 32];
    const uint32_t w1[3] = {q[0].x, q[0].y, q[1].x};
    const uint32_t w2b[3] = {q[1].y, q[2].x, q[2].y};
    const uint32_t w3b[2] = {q[3].x, q[3].y};

    // h[m]: words 0-3 the m16n8k16 A operand (columns 0-15), 4-5 the
    // m16n8k8 one (columns 16-23)
    uint32_t h[2][6];
    {  // layer 1: [32, 8] x [8, 24]
      float acc[2][3][4] = {};
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int m = 0; m < 2; ++m) mma_k8(acc[m][j], xa[m][0], xa[m][1], w1[j]);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float2 b = *reinterpret_cast<const float2*>(v + 8 * j);
#pragma unroll
        for (int m = 0; m < 2; ++m) hidden_pair<HB>(acc[m][j], b, h[m][2 * j], h[m][2 * j + 1]);
      }
    }
    {  // layer 2: [32, 24] x [24, 24]
      float acc[2][3][4] = {};
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_k16(acc[m][j], h[m], q[4 + j].x, q[4 + j].y);
          mma_k8(acc[m][j], h[m][4], h[m][5], w2b[j]);
        }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float2 b = *reinterpret_cast<const float2*>(v + OFF_B2 + 8 * j);
#pragma unroll
        for (int m = 0; m < 2; ++m) hidden_pair<HB>(acc[m][j], b, h[m][2 * j], h[m][2 * j + 1]);
      }
    }
    float y[2][2];  // [m][half]: this quad's partial readout of rows g + 8 half
    {  // layer 3: [32, 24] x [24, 16], then the readout over its 16 columns
      float acc[2][2][4] = {};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_k16(acc[m][j], h[m], q[7 + j].x, q[7 + j].y);
          mma_k8(acc[m][j], h[m][4], h[m][5], w3b[j]);
        }
#pragma unroll
      for (int m = 0; m < 2; ++m) y[m][0] = y[m][1] = 0.0f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 b = *reinterpret_cast<const float2*>(v + OFF_B3 + 8 * j);
        const float2 w4 = *reinterpret_cast<const float2*>(v + OFF_W4 + 8 * j);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          uint32_t h3[2];
          hidden_pair<HB>(acc[m][j], b, h3[0], h3[1]);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float2 hv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&h3[half]));
            y[m][half] = y[m][half] + hv.x * w4.x + hv.y * w4.y;
          }
        }
      }
    }
    const float b4 = sm.vec[k * VEC + OFF_B4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float p = y[m][half];
        p = p + __shfl_xor_sync(FULL, p, 1);
        p = p + __shfl_xor_sync(FULL, p, 2);
        y[m][half] = p + b4;
      }
    // lane (g, t) owns row 16 (t / 2) + 8 (t % 2) + g
    const float mine = t == 0 ? y[0][0] : (t == 1 ? y[0][1] : (t == 2 ? y[1][0] : y[1][1]));
    sm.cw[k * TILE + row] = mine;
  }
}

// The coefficients of this lane's aircraft, after sweep().
__device__ __forceinline__ void coefficients(const Smem& sm, float c[N_NETS]) {
  const int row = own_row();
#pragma unroll
  for (int k = 0; k < N_NETS; ++k) c[k] = sm.cw[k * TILE + row];
}

// Blocks of a persistent launch over n aircraft.
inline int grid_blocks(int n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  const int tiles = (n + TILE - 1) / TILE;
  const int want = (tiles + GRP_WARPS - 1) / GRP_WARPS;
  return want < sms ? want : sms;
}

}  // namespace np_grp
