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
// padded 20 -> 24 and 10 -> 16, and the readout is one more m16n8k16 product
// whose B operand holds W4 in all eight columns: 14 tile products per net and
// 16 aircraft, 2,560 FLOP per net and aircraft, 110,080 per aircraft (1.91x
// the nets' own work).
//
// Layout. A warp owns 32 aircraft as two m16 tiles. The accumulator layout
// of m16n8 (lane 4g + t holds columns 2t, 2t + 1 of rows g and g + 8) is
// the A-operand layout of the next product, so a layer's output is rounded
// to bf16, packed in pairs and fed straight back: no activation touches
// shared memory. After the readout product every lane of a quad holds the
// finished dots of rows g and g + 8 of both tiles. Lane 4g + t owns aircraft
// 16 (t / 2) + 8 (t % 2) + g of the tile: one of the four rows its quad
// holds, so it selects its own, adds b4 and writes it to the warp's scratch
// cw[43][32]; every lane ends with exactly the coefficients of its aircraft.
//
// Weights. All 43 nets are 127,280 bytes as packed by
// ops/aero.py:GroupedAeroWeights.packed (bf16 B fragments in lane order, the
// biases a lane adds laid out by t, as bf16x2 words rounded on the host and
// as float32): they sit in shared memory for the whole block, which is
// persistent (one block per SM, warps stride over tiles).
//
// What bounds it on an H100, and what the design does about it. The real
// work (57,620 FLOP per aircraft) is 0.058 ms at n = 10^6 on the data
// sheet's tensor-core rate, but mma.sync reaches about half of that rate
// (an m16n8k16 holds an SM sub-partition's tensor pipe for ~8 cycles, an
// m16n8k8 for ~4) and the padded chain is 12 + 16 of them per net and warp
// tile: 0.27 ms with nothing else running. Loads, selects and address
// arithmetic hide under the products; the instructions of the float pipe
// (convert, bias, ReLU) do not, and the rounding points need 64 of them per
// net and warp tile in the bf16 mode: 0.36 ms for both together
// (tools/mma_chain_bench.cu). So every instruction that is not a product is
// counted: the readout is a product (no unpack-multiply-add, no shuffle),
// the biases arrive pre-rounded in two 16-byte loads, convert-bias-ReLU is
// two instructions per pair in the bf16 mode (cvt, fma.relu with a constant
// one) and three in the float32 mode (two adds, cvt.relu), and a sum starts
// from a constant-zero C operand instead of cleared registers. More work per
// warp (64 aircraft, two nets interleaved) does not help, nor does wgmma at
// this tile size: the chain is bound by the tensor pipe's throughput, not
// by latency.
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
constexpr int FRAG_PAIRS = 10;        // uint2 of B fragments per lane and net
constexpr int BIAS_PAIRS = 8;         // column pairs a lane adds a bias to: 3 + 3 + 2 tiles
constexpr int NET_WORDS = 672;        // words per net in frags: fragments, then bias words
constexpr int VEC = 68;               // floats per net: biases [4 t][16], b4, padding
constexpr int OFF_B4 = 64;
constexpr int SCRATCH = N_NETS * TILE;  // floats of scratch per warp
static_assert(NET_WORDS == FRAG_PAIRS * 64 + 4 * BIAS_PAIRS && OFF_B4 == 4 * 2 * BIAS_PAIRS,
              "the layout of ops/aero.py:GroupedAeroWeights.packed");

constexpr size_t SMEM_FRAGS = (size_t)N_NETS * NET_WORDS * 4;
constexpr size_t SMEM_VEC = (size_t)N_NETS * VEC * 4;
constexpr size_t SMEM_BYTES = SMEM_FRAGS + SMEM_VEC + (size_t)GRP_WARPS * SCRATCH * 4;
static_assert(SMEM_FRAGS % 16 == 0 && SMEM_VEC % 16 == 0, "16-byte copies");
static_assert(SMEM_BYTES <= 232448, "a block's shared memory on sm_90");
static_assert(TILE * 22 <= SCRATCH, "the [32][22] observation staging fits the scratch");

struct Smem {
  const uint2* frags;  // [N_NETS]: [FRAG_PAIRS][32] fragment pairs, [4 t][BIAS_PAIRS] bias words
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

// d = a . b + c, m16n8k8 and m16n8k16, bf16 operands, float32 sums. c may
// be d itself (the sum goes on) or a constant zero, which starts a sum
// without a move to clear it.
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0,
                                       const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t* a, uint32_t b0,
                                        uint32_t b1, const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c[0]), "f"(c[1]),
        "f"(c[2]), "f"(c[3]));
}

// A lane's biases of one net: the column pairs (8 j + 2 t, 8 j + 2 t + 1) of
// b1 (j = 0-2), b2 (j = 0-2) and b3 (j = 0-1), as packed() lays them out by
// t. bf16 hidden: eight bf16x2 words, rounded on the host. float32 hidden:
// sixteen floats. t16 is PER_T * t, the lane's offset in 16-byte units.
template <bool HB>
struct Bias;
template <>
struct Bias<true> {
  uint32_t w[BIAS_PAIRS];
  static constexpr int PER_T = 2;  // 16-byte units per t
  __device__ __forceinline__ Bias(const Smem& sm, int k, int t16) {
    const uint4* p = reinterpret_cast<const uint4*>(sm.frags + k * (NET_WORDS / 2)
                                                    + FRAG_PAIRS * 32) + t16;
    const uint4 lo = p[0], hi = p[1];
    w[0] = lo.x; w[1] = lo.y; w[2] = lo.z; w[3] = lo.w;
    w[4] = hi.x; w[5] = hi.y; w[6] = hi.z; w[7] = hi.w;
  }
};
template <>
struct Bias<false> {
  float2 f[BIAS_PAIRS];
  static constexpr int PER_T = 4;
  __device__ __forceinline__ Bias(const Smem& sm, int k, int t16) {
    const float4* p = reinterpret_cast<const float4*>(sm.vec + k * VEC) + t16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = p[i];
      f[2 * i] = make_float2(v.x, v.y);
      f[2 * i + 1] = make_float2(v.z, v.w);
    }
  }
};

// One accumulator tile (columns 2t, 2t + 1 of rows g and g + 8) through
// bias and ReLU, packed as two words of the next product's A operand.
// bf16 hidden: the sum rounded to bf16, then ReLU(x + b) in bf16 as one
// instruction (x * 1 + b rounded once, the two roundings of the rule).
__device__ __forceinline__ void hidden_pair(const float (&c)[4], const Bias<true>& b, int i,
                                            uint32_t& row_g, uint32_t& row_g8) {
  const uint32_t one_bits = 0x3f803f80u;  // (1, 1) in bf16
  const __nv_bfloat162 one = *reinterpret_cast<const __nv_bfloat162*>(&one_bits);
  const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(&b.w[i]);
  const __nv_bfloat162 lo = __hfma2_relu(__floats2bfloat162_rn(c[0], c[1]), one, bb);
  const __nv_bfloat162 hi = __hfma2_relu(__floats2bfloat162_rn(c[2], c[3]), one, bb);
  row_g = *reinterpret_cast<const uint32_t*>(&lo);
  row_g8 = *reinterpret_cast<const uint32_t*>(&hi);
}

// float32 hidden: ReLU(sum + b) in float32, then bf16 (ReLU commutes with
// the rounding: one instruction does both for two values). The bias as the
// first product's C operand would save the four adds, but the tensor core
// truncates where it aligns its addends: with the bias inside its sum, 30x
// as many hidden units landed on the other side of a bf16 rounding.
__device__ __forceinline__ void hidden_pair(const float (&c)[4], const Bias<false>& b, int i,
                                            uint32_t& row_g, uint32_t& row_g8) {
  row_g = np_dist::pack_bf16_relu(c[0] + b.f[i].x, c[1] + b.f[i].y);
  row_g8 = np_dist::pack_bf16_relu(c[2] + b.f[i].x, c[3] + b.f[i].y);
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

  const int row = own_row(), t16 = Bias<HB>::PER_T * t;
  const bool odd = t & 1, upper = t & 2;
  const float ZERO[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
  for (int k = 0; k < N_NETS; ++k) {
    const uint2* f = sm.frags + k * (NET_WORDS / 2) + lane;
    const Bias<HB> b(sm, k, t16);
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
      float acc[2][3][4];
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int m = 0; m < 2; ++m) mma_k8(acc[m][j], xa[m][0], xa[m][1], w1[j], ZERO);
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int m = 0; m < 2; ++m) hidden_pair(acc[m][j], b, j, h[m][2 * j], h[m][2 * j + 1]);
    }
    {  // layer 2: [32, 24] x [24, 24]
      float acc[2][3][4];
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_k16(acc[m][j], h[m], q[4 + j].x, q[4 + j].y, ZERO);
          mma_k8(acc[m][j], h[m][4], h[m][5], w2b[j], acc[m][j]);
        }
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int m = 0; m < 2; ++m) hidden_pair(acc[m][j], b, 3 + j, h[m][2 * j], h[m][2 * j + 1]);
    }
    {  // layer 3: [32, 24] x [24, 16]; its 16 columns are the readout's A operand
      float acc[2][2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_k16(acc[m][j], h[m], q[7 + j].x, q[7 + j].y, ZERO);
          mma_k8(acc[m][j], h[m][4], h[m][5], w3b[j], acc[m][j]);
        }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int m = 0; m < 2; ++m) hidden_pair(acc[m][j], b, 6 + j, h[m][2 * j], h[m][2 * j + 1]);
    }
    // the readout as a product: every column of its B operand is W4, so each
    // lane of a quad gets the finished dots of rows g and g + 8 as y[0], y[2]
    float y[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) mma_k16(y[m], h[m], q[9].x, q[9].y, ZERO);
    // lane (g, t) owns row 16 (t / 2) + 8 (t % 2) + g
    const float lo = odd ? y[0][2] : y[0][0], hi = odd ? y[1][2] : y[1][0];
    sm.cw[k * TILE + row] = (upper ? hi : lo) + sm.vec[k * VEC + OFF_B4];
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
