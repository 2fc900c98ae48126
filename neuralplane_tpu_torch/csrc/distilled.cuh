// Distilled aero surrogate: hinge features and the [68 -> 256 -> 256] trunk
// with its [43, 256 + 68] readout on Hopper's warpgroup tensor-core
// instructions. Twin of neuralplane_tpu_torch/surrogates/distill.py:trunk_z
// and of the TPU's neuralplane_tpu/ops/aero_pallas.py:
// distilled_feature_rows / distilled_coeff_rows.
//
// Block. One persistent block of 384 threads per SM walks over tiles of
// NP_M = 64 aircraft (tile = blockIdx.x, + gridDim.x, ...). All weights sit
// in its shared memory for the whole launch, in the byte image that
// ops/aero.py:DistilledAeroWeights.packed() lays out on the host (207,936
// bytes, copied once with cp.async): W1 [256][80], W2 [256][256] and W3
// [48][336] as wgmma B operands (wgmma.cuh: core matrices of 8 x 8 bf16,
// k block major), then b3, out_std, out_mean [48] and b1, b2 [256] in
// float32, then b1, b2 rounded to bf16 (what the hidden_bf16 mode adds).
//
// Roles. Warps 0-3 are the multiplier warpgroup: per tile it runs the three
// products as wgmma m64n128k16 / m64n48k16 with the sums in registers, and
// turns a layer's sums (bias, ReLU, bf16 rounding, packed in pairs) into
// the A fragments of the next product in registers: no activation touches
// shared memory. Warps 4-11 are four pairs of warps; every thread of a pair
// owns one aircraft of the pair's tile from its inputs to its outputs, so
// all elementwise work (reset select, lag, hinge features, nlplant, Euler,
// task layer, draws) runs on lanes that own an aircraft, beside the tensor
// cores. Pair p takes the block's tiles p, p + 4, ... setmaxnreg moves
// registers from the owners (136 each) to the multiplier (232), which holds
// 64 sums, two layers of A fragments and the features at once. The
// multiplier is the one serial chain of the block, so whatever an owner can
// do for it, the owner does: it computes its aircraft's 80 features (every
// column index a constant) and writes them as the words of the first
// product's A fragments.
//
// Hand-over, through mbarriers only (no block-wide barrier in the tile
// loop). One slot holds a tile's feature fragments, feat[20 words][128
// multiplier threads]. go[p]: the multiplier has the previous tile's
// fragments in registers, the slot is free for pair p's next tile.
// full[p]: the 64 threads of pair p have written their rows. ready[p]: the
// multiplier has written that tile's 43 raw readout sums per aircraft to
// the coefficient buffer. empty: the 64 owners have read it.
//
// Rounding points (the TPU kernel's): features in float32 by division by
// IN_SCALE, then bf16; bf16 x bf16 products summed in float32; with
// hidden_bf16 the sum is rounded to bf16, the bias is rounded to bf16, and
// add and ReLU run in bf16 (the bf16 sum of two bf16 values equals their
// float32 sum rounded to bf16: it is exact in float32 unless one is below
// 2^-16 of the other, and then both give the larger); without it
// ReLU(sum + b) in float32, rounded to bf16 for the next product; the
// readout keeps its float32 sum.
#pragma once
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace np_dist {

using bf16 = __nv_bfloat16;

constexpr int NP_M = 64;               // aircraft per tile
constexpr int NP_H = 256;              // hidden width the kernels are built for
constexpr int F_PAD = 80;              // features padded to 5 x 16 (zeros)
constexpr int K3 = NP_H + F_PAD;       // readout depth: [hidden ; features]
constexpr int OUT_N = 48;              // readout rows in the image, 43 real
constexpr int NH = 128;                // hidden units per product
constexpr int N_COEF = 43;
constexpr int MUL_THREADS = 128;       // the multiplier warpgroup
constexpr int N_PAIRS = 4;             // pairs of elementwise warps
constexpr int NP_THREADS = MUL_THREADS + N_PAIRS * NP_M;
constexpr int MUL_REGS = 232, PAIR_REGS = 136;  // registers per thread by role

// Byte offsets of the weight image (ops/aero.py: IMG_*).
constexpr int IMG_W1 = 0;
constexpr int IMG_W2 = IMG_W1 + NP_H * F_PAD * 2;
constexpr int IMG_W3 = IMG_W2 + NP_H * NP_H * 2;
constexpr int IMG_B3 = IMG_W3 + OUT_N * K3 * 2;
constexpr int IMG_SD = IMG_B3 + OUT_N * 4;
constexpr int IMG_MU = IMG_SD + OUT_N * 4;
constexpr int IMG_B1 = IMG_MU + OUT_N * 4;
constexpr int IMG_B2 = IMG_B1 + NP_H * 4;
constexpr int IMG_B1H = IMG_B2 + NP_H * 4;    // b1, b2 rounded to bf16
constexpr int IMG_B2H = IMG_B1H + NP_H * 2;
constexpr int IMG_BYTES = IMG_B2H + NP_H * 2;
// Behind the image: the coefficient buffer, the feature slot, the barriers.
constexpr int FEAT_WORDS = F_PAD / 16 * 4;   // A-fragment words per thread
constexpr int SMEM_COEF = IMG_BYTES;
constexpr int SMEM_FEAT = SMEM_COEF + NP_M * N_COEF * 4;
constexpr int SMEM_BARS = SMEM_FEAT + FEAT_WORDS * MUL_THREADS * 4;
constexpr int N_BARS = 3 * N_PAIRS + 1;
constexpr int SMEM_BYTES = SMEM_BARS + N_BARS * 8;
static_assert(IMG_BYTES % 16 == 0, "16-byte copies");
static_assert(SMEM_BARS % 8 == 0, "mbarriers are 8-byte aligned");
static_assert(SMEM_BYTES <= 232448, "a block's shared memory on sm_90");
static_assert(MUL_THREADS * MUL_REGS + N_PAIRS * NP_M * PAIR_REGS <= 65536,
              "an SM's registers");

// Knots: np.linspace(-20, 90, 45)[1:-1], linspace(-30, 30, 17)[1:-1],
// linspace(-25, 25, 9)[1:-1]; every knot is exact in float32.
constexpr int N_ALPHA_K = 43, N_BETA_K = 15, N_EL_K = 7;

struct Smem {
  const bf16* W1;     // wgmma B images
  const bf16* W2;
  const bf16* W3;
  const float* b1;    // [NP_H]
  const float* b2;    // [NP_H]
  const bf16* b1h;    // [NP_H], b1 and b2 rounded to bf16
  const bf16* b2h;
  const float* b3;    // [OUT_N]
  const float* sd;    // [OUT_N]
  const float* mu;    // [OUT_N]
  float* coef;        // [NP_M][N_COEF] readout sums, one row per aircraft
  uint32_t* feat;     // [FEAT_WORDS][MUL_THREADS] first product's A fragments
  uint64_t* go;       // [N_PAIRS]
  uint64_t* full;     // [N_PAIRS]
  uint64_t* ready;    // [N_PAIRS]
  uint64_t* empty;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// One arrival; this thread's earlier shared-memory writes are visible to
// whoever waits for the phase.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of parity `parity` is complete (a new barrier counts
// as having completed a phase of parity 1). A barrier that does not complete
// within 2^35 cycles (some 20 s; a launch takes milliseconds) is a fault of
// the hand-over: trap instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  long long t0 = 0;
  for (;;) {
    unsigned ok;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(ok)
        : "r"(addr), "r"(parity)
        : "memory");
    if (ok) return;
    const long long now = clock64();
    if (t0 == 0) t0 = now;
    else if (now - t0 > (1ll << 35)) __trap();
  }
}

// All threads of the block, once: copy the weight image, set up the
// barriers and return the layout; ends with the launch's only block barrier.
__device__ __forceinline__ Smem block_setup(unsigned char* smem,
                                            const unsigned char* __restrict__ image) {
  Smem s;
  s.W1 = reinterpret_cast<const bf16*>(smem + IMG_W1);
  s.W2 = reinterpret_cast<const bf16*>(smem + IMG_W2);
  s.W3 = reinterpret_cast<const bf16*>(smem + IMG_W3);
  s.b1 = reinterpret_cast<const float*>(smem + IMG_B1);
  s.b2 = reinterpret_cast<const float*>(smem + IMG_B2);
  s.b1h = reinterpret_cast<const bf16*>(smem + IMG_B1H);
  s.b2h = reinterpret_cast<const bf16*>(smem + IMG_B2H);
  s.b3 = reinterpret_cast<const float*>(smem + IMG_B3);
  s.sd = reinterpret_cast<const float*>(smem + IMG_SD);
  s.mu = reinterpret_cast<const float*>(smem + IMG_MU);
  s.coef = reinterpret_cast<float*>(smem + SMEM_COEF);
  s.feat = reinterpret_cast<uint32_t*>(smem + SMEM_FEAT);
  s.go = reinterpret_cast<uint64_t*>(smem + SMEM_BARS);
  s.full = s.go + N_PAIRS;
  s.ready = s.full + N_PAIRS;
  s.empty = s.ready + N_PAIRS;
  const uint4* src = reinterpret_cast<const uint4*>(image);
  uint4* dst = reinterpret_cast<uint4*>(smem);
  for (int e = threadIdx.x; e < IMG_BYTES / 16; e += blockDim.x) cp_async16(dst + e, src + e);
  asm volatile("cp.async.commit_group;\n" ::);
  if (threadIdx.x == 0) {
    for (int p = 0; p < N_PAIRS; ++p) {
      mbar_init(s.go + p, MUL_THREADS);
      mbar_init(s.full + p, NP_M);
      mbar_init(s.ready + p, MUL_THREADS);
    }
    mbar_init(s.empty, NP_M);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  // the tensor cores read shared memory through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  return s;
}

// A role's share of the SM's registers (all four warps of a warpgroup).
template <int REGS>
__device__ __forceinline__ void take_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void give_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// x / d rounded to float32, for d in {35, 18, 15}, without the division's
// instruction sequence: with r = 1 / d rounded to float, q0 = x r is within
// an ulp of the quotient, the remainder x - q0 d is exact in one fused
// multiply-add, and q0 + rem r, fused, is the correctly rounded quotient
// (Markstein's final division step; it holds binade by binade, and was
// checked against the float32 division for every x of 29 binades and the
// three divisors). This is what distill.featurize computes with a division.
__device__ __forceinline__ float div_scale(float x, float d, float r) {
  const float q0 = x * r;
  return __fmaf_rn(__fmaf_rn(-q0, d, x), r, q0);
}

// Feature f of one aircraft (distill.featurize): scaled coordinates, then
// relu hinges at the knots, each divided by its coordinate's IN_SCALE.
// Callers pass a constant f, so the branches fold away.
__device__ __forceinline__ float feature(int f, float a, float b, float e) {
  constexpr float RA = 1.0f / 35.0f, RB = 1.0f / 18.0f, RE = 1.0f / 15.0f;
  if (f == 0) return div_scale(a - 35.0f, 35.0f, RA);
  if (f == 1) return div_scale(b, 18.0f, RB);
  if (f == 2) return div_scale(e, 15.0f, RE);
  f -= 3;
  if (f < N_ALPHA_K)
    return div_scale(fmaxf(a - (-20.0f + 2.5f * (float)(f + 1)), 0.0f), 35.0f, RA);
  f -= N_ALPHA_K;
  if (f < N_BETA_K)
    return div_scale(fmaxf(b - (-30.0f + 3.75f * (float)(f + 1)), 0.0f), 18.0f, RB);
  f -= N_BETA_K;
  if (f < N_EL_K)
    return div_scale(fmaxf(e - (-25.0f + 6.25f * (float)(f + 1)), 0.0f), 15.0f, RE);
  return 0.0f;  // padding columns 68..79
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two float32 values, ReLU, rounded to bf16 and packed, in one instruction
// (ReLU commutes with the rounding).
__device__ __forceinline__ uint32_t pack_bf16_relu(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// Four sums of one 8-column block (columns 2t, 2t + 1 of rows g and g + 8)
// through bias and ReLU, as two words of the next product's A fragment.
// hidden_bf16: ReLU(x + b) in bf16 as one instruction, x * 1 + b rounded once.
__device__ __forceinline__ void hidden_pair(const float* c, __nv_bfloat162 b, uint32_t& row_g,
                                            uint32_t& row_g8) {
  const __nv_bfloat162 one = __floats2bfloat162_rn(1.0f, 1.0f);
  const __nv_bfloat162 lo = __hfma2_relu(__floats2bfloat162_rn(c[0], c[1]), one, b);
  const __nv_bfloat162 hi = __hfma2_relu(__floats2bfloat162_rn(c[2], c[3]), one, b);
  row_g = *reinterpret_cast<const uint32_t*>(&lo);
  row_g8 = *reinterpret_cast<const uint32_t*>(&hi);
}

// The float32-hidden mode: ReLU(x + b) in float32, then bf16.
__device__ __forceinline__ void hidden_pair(const float* c, float2 b, uint32_t& row_g,
                                            uint32_t& row_g8) {
  row_g = pack_bf16_relu(c[0] + b.x, c[1] + b.y);
  row_g8 = pack_bf16_relu(c[2] + b.x, c[3] + b.y);
}

// One half (NH = 128 units) of a hidden layer's sums -> the A fragments of
// the next product: h[kb] covers units 16 kb .. 16 kb + 15 of the half.
// BIAS is bf16 (hidden_bf16) or float.
template <typename BIAS>
__device__ __forceinline__ void hidden_half(float (&acc)[NH / 2],
                                            const BIAS* __restrict__ bias, int t,
                                            uint32_t (*h)[4]) {
  using Pair = typename std::conditional<std::is_same<BIAS, float>::value, float2,
                                         __nv_bfloat162>::type;
#pragma unroll
  for (int i = 0; i < NH / 2; ++i) np_wgmma::pin(acc[i]);
#pragma unroll
  for (int j = 0; j < NH / 8; ++j) {
    const Pair b = *reinterpret_cast<const Pair*>(bias + 8 * j + 2 * t);
    hidden_pair(&acc[4 * j], b, h[j >> 1][2 * (j & 1)], h[j >> 1][2 * (j & 1) + 1]);
  }
}

// One hidden layer: out = act(A[64, 16 KB] . W^T + bias), as two products
// of NH = 128 units each, so that sums, A fragments and the finished half
// fit the warpgroup's registers together. `desc` names W's image.
template <typename BIAS, int KB>
__device__ __forceinline__ void hidden_layer(const uint32_t (&a)[KB][4], uint64_t desc,
                                             const BIAS* __restrict__ bias, int t,
                                             float (&acc)[NH / 2],
                                             uint32_t (&out)[NP_H / 16][4]) {
  using namespace np_wgmma;
#pragma unroll
  for (int half = 0; half < NP_H / NH; ++half) {
    fence();
#pragma unroll
    for (int kb = 0; kb < KB; ++kb)  // rows of W: 128 bytes per 8; k: 32 N bytes per 16
      mma_m64n128k16(acc, a[kb], advance(desc, half * NH * 16 + kb * 32 * NP_H), kb > 0);
    commit();
    wait_all();
    hidden_half(acc, bias + half * NH, t, out + half * (NH / 16));
  }
}

// The multiplier warpgroup's whole life: for each of the block's tiles, in
// order, wait for its feature fragments, run the trunk, and hand the 43
// readout sums of each aircraft to the tile's owners.
template <bool HB>
__device__ __forceinline__ void multiplier_loop(const Smem& sm, int tiles) {
  using namespace np_wgmma;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int r0 = 16 * (threadIdx.x >> 5) + (lane >> 2), r1 = r0 + 8;  // its rows
  // leading (k) offset 16 N bytes, stride (n) offset 128 bytes
  const uint64_t d1 = make_desc(sm.W1, 16 * NP_H, 128);
  const uint64_t d2 = make_desc(sm.W2, 16 * NP_H, 128);
  const uint64_t d3 = make_desc(sm.W3, 16 * OUT_N, 128);
  float acc[NH / 2] = {};
  int j = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++j) {
    const int p = j % N_PAIRS;
    mbar_wait(sm.full + p, (j / N_PAIRS) & 1);
    uint32_t fa[F_PAD / 16][4];
#pragma unroll
    for (int kb = 0; kb < F_PAD / 16; ++kb)
#pragma unroll
      for (int i = 0; i < 4; ++i) fa[kb][i] = sm.feat[(4 * kb + i) * MUL_THREADS + threadIdx.x];
    mbar_arrive(sm.go + (j + 1) % N_PAIRS);
    uint32_t h1[NP_H / 16][4], h2[NP_H / 16][4];
    if (HB) {
      hidden_layer(fa, d1, sm.b1h, t, acc, h1);
      hidden_layer(h1, d2, sm.b2h, t, acc, h2);
    } else {
      hidden_layer(fa, d1, sm.b1, t, acc, h1);
      hidden_layer(h1, d2, sm.b2, t, acc, h2);
    }
    // readout over [hidden ; features]
    float z[OUT_N / 2] = {};
    fence();
#pragma unroll
    for (int kb = 0; kb < NP_H / 16; ++kb)
      mma_m64n48k16(z, h2[kb], advance(d3, kb * 32 * OUT_N), kb > 0);
#pragma unroll
    for (int kb = 0; kb < F_PAD / 16; ++kb)
      mma_m64n48k16(z, fa[kb], advance(d3, (NP_H / 16 + kb) * 32 * OUT_N), 1);
    commit();
    wait_all();
#pragma unroll
    for (int i = 0; i < OUT_N / 2; ++i) pin(z[i]);
    // hand over: sums of rows r0 and r1, columns 8 jj + 2t, + 1
    mbar_wait(sm.empty, (j & 1) ^ 1);
    float* cr = sm.coef;
#pragma unroll
    for (int jj = 0; jj < OUT_N / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * jj + 2 * t + (e & 1);
        if (col < N_COEF) cr[((e >> 1) ? r1 : r0) * N_COEF + col] = z[4 * jj + e];
      }
    mbar_arrive(sm.ready + p);
  }
}

// The elementwise side of the hand-over. A thread of warps 4-11 is row
// `row` of pair `pair`; its pair's k-th tile is number pair + N_PAIRS k in
// the block's order.
struct Owner {
  int pair, row;
};

__device__ __forceinline__ Owner owner() {
  const int q = threadIdx.x - MUL_THREADS;
  return Owner{q / NP_M, q % NP_M};
}

// Give the multiplier this aircraft's features for the block's j-th tile:
// row 16 w + 8 h + g of the tile is held by multiplier thread 32 w + 4 g + t
// for the columns 16 kb + 8 c + 2 t, + 1, as word 4 kb + 2 c + h.
__device__ __forceinline__ void post_inputs(const Smem& sm, Owner o, int j, float alpha_deg,
                                            float beta_deg, float el) {
  // pair 0 never waits for its first tile: a new barrier counts as having
  // completed a phase of parity 1
  const int k = j / N_PAIRS;
  mbar_wait(sm.go + o.pair, o.pair == 0 ? (k & 1) ^ 1 : k & 1);
  const int h = (o.row >> 3) & 1;
  uint32_t* dst = sm.feat + h * MUL_THREADS + 32 * (o.row >> 4) + 4 * (o.row & 7);
#pragma unroll
  for (int kb = 0; kb < F_PAD / 16; ++kb)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int f = 16 * kb + 8 * c + 2 * t;
        dst[(4 * kb + 2 * c) * MUL_THREADS + t] =
            pack_bf16(feature(f, alpha_deg, beta_deg, el),
                      feature(f + 1, alpha_deg, beta_deg, el));
      }
  mbar_arrive(sm.full + o.pair);
}

// Wait for the tile (the block's j-th) and take this aircraft's raw
// coefficients: (z + b3) * sd + mu.
__device__ __forceinline__ void take_coefficients(const Smem& sm, Owner o, int j,
                                                  float c[N_COEF]) {
  mbar_wait(sm.ready + o.pair, (j / N_PAIRS) & 1);
  const float* cr = sm.coef + o.row * N_COEF;
#pragma unroll
  for (int k = 0; k < N_COEF; ++k) c[k] = cr[k];
  mbar_arrive(sm.empty);
#pragma unroll
  for (int k = 0; k < N_COEF; ++k) c[k] = (c[k] + sm.b3[k]) * sm.sd[k] + sm.mu[k];
}

// Blocks of a persistent launch over n aircraft: one per SM, fewer when
// there are fewer tiles.
inline int grid_blocks(int n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  const int tiles = (n + NP_M - 1) / NP_M;
  return tiles < sms ? tiles : sms;
}

}  // namespace np_dist
