// What bounds the 43-net sweep of csrc/grouped.cuh on one SM: the tensor
// pipe through mma.sync, the other instructions, or the dependent chain? A
// microbenchmark on one NVIDIA GPU of compute capability 9.0a.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v \
//        -o mma_chain_bench tools/mma_chain_bench.cu && ./mma_chain_bench
//
// One block per SM, and per warp ROUNDS x 43 trips: one trip is one net
// [3 -> 20 -> 20 -> 10 -> 1] on one warp tile, as the sweep runs it, so a
// launch costs what the sweep costs at n = 10^6 aircraft on 132 SMs
// (31,250 tiles of 32 over 132 x 16 warps = 14.8 rounds; the wgmma form
// has half as many aircraft in flight and runs twice the rounds). A trip is four
// dependent stages of 6, 6 x 2, 4 x 2 and 2 products per two m16 tiles (12
// m16n8k16 and 16 m16n8k8, bf16 operands, float32 sums), and between the
// stages the sums become the next stage's A operand in registers. Timed:
//   - the products alone, with the ten loads of their B fragments (the next
//     A operand is the bits of the sums: no instruction between the stages,
//     the values mean nothing; one xor per m16 tile and trip reads the
//     result, or ptxas drops the chain), as the sweep's mix and with all 28
//     as m16n8k8 or all as m16n8k16;
//   - everything else of a trip alone (fragment, bias and b4 loads, convert,
//     bias and ReLU, owner select, store);
//   - both together, in both hidden modes (bf16: cvt + fma.relu on
//     pre-rounded bias words; float32: the bias as the first product's C
//     operand and one cvt.relu for two sums, the cheapest form there is: the
//     sweep adds the bias after the sum instead, which costs it four adds
//     per tile and keeps the rounding flips rare);
//   - the same with 8 warps of 64 aircraft (four m16 tiles a warp), with
//     two nets interleaved per trip, and with every m16n8k16 run as two
//     m16n8k8 on the same operand words (40 products a trip);
//   - the same nets as wgmma m64n24k16 / m64n16k16 / m64n8k16 with A from
//     registers: four warpgroups per SM, 64 aircraft per warpgroup, the B
//     operands of all 43 nets resident in shared memory (no-swizzle core
//     matrices, csrc/wgmma.cuh), alone and with the bf16 elementwise work.
// The weights are hashed bits of bf16 magnitude [2^-7, 2): times, not values.
#include <cstdint>
#include <cstdio>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../neuralplane_tpu_torch/csrc/wgmma.cuh"

namespace {

constexpr int N_NETS = 43;
constexpr int ROUNDS = 15;
constexpr int WG_ROUNDS = 30;                    // 15,625 tiles of 64 over 132 x 4 warpgroups
constexpr int THREADS = 512;
constexpr int FRAG_PAIRS = 10;                   // uint2 of B fragments per lane and net
constexpr int NET_WORDS = FRAG_PAIRS * 64 + 32;  // + bf16x2 bias words [4 t][8]
constexpr int VEC = 68;                          // float32 biases [4 t][16], b4, padding
constexpr int NETS_PAD = N_NETS + 1;             // two nets per trip run 44
constexpr int SCRATCH_FLOATS = 16 * N_NETS * 32; // 512 aircraft per block
constexpr int SMEM_MMA = NETS_PAD * (NET_WORDS + VEC) * 4 + SCRATCH_FLOATS * 4;
// the wgmma form: per net W1 [24][16], W2 [24][32], W3 [16][32], W4 [8][16]
constexpr int WG_L1 = 0, WG_L2 = 768, WG_L3 = 2304, WG_L4 = 3328, WG_NET = 3584;
constexpr int WG_BIAS = N_NETS * WG_NET;         // then bias words [43][4][8], b4 [43]
constexpr int WG_B4 = WG_BIAS + N_NETS * 128;
constexpr int WG_SCRATCH = WG_B4 + 256;
constexpr int SMEM_WG = WG_SCRATCH + 4 * N_NETS * 64 * 4;
static_assert(SMEM_MMA <= 232448 && SMEM_WG <= 232448, "a block's shared memory on sm_90");

enum Prod { P_NONE, P_MIX, P_K8, P_K16, P_SPLIT };
enum Elem { E_NONE, E_BF16, E_F32 };

__device__ __forceinline__ uint32_t random_bf16_pair(uint32_t i) {
  uint32_t h = i * 2654435761u;
  h ^= h >> 15;
  h *= 2246822519u;
  h ^= h >> 13;
  return 0x3c003c00u + (h & 0x83ff83ffu);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Loads that the compiler keeps even where their value is not used.
__device__ __forceinline__ uint2 lds64(const void* p) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(smem_addr(p)));
  return v;
}
__device__ __forceinline__ uint4 lds128(const void* p) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(smem_addr(p)));
  return v;
}
__device__ __forceinline__ float lds32f(const void* p) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(smem_addr(p)));
  return v;
}

// d = a . b + c (d and c may be the same registers).
__device__ __forceinline__ void mma8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0,
                                     const float (&c)[4]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};\n"
               : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
               : "r"(a0), "r"(a1), "r"(b0), "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1, const float (&c)[4]) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
               : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c[0]),
                 "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// One product of the chain: the slot's own shape in the sweep's mix, every
// slot as k8 or as k16, or the mix with each k16 as two k8 (40 products).
template <int PROD, bool K16_SLOT>
__device__ __forceinline__ void product(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1, const float (&c)[4]) {
  if ((PROD == P_MIX && K16_SLOT) || PROD == P_K16) {
    mma16(d, a, b0, b1, c);
  } else if (PROD == P_SPLIT && K16_SLOT) {  // the same operands as two k8 products
    mma8(d, a[0], a[1], b0, c);
    mma8(d, a[2], a[3], b1, d);
  } else {
    mma8(d, a[0], a[1], b0, c);
  }
}

__device__ __forceinline__ uint32_t pack_bf16_relu(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// Four sums (columns 2t, 2t + 1 of rows g and g + 8) -> two words of the
// next A operand. `bias` is the bf16x2 word of the two columns.
template <int ELEM>
__device__ __forceinline__ void hidden(const float (&c)[4], uint32_t bias, uint32_t& lo,
                                       uint32_t& hi) {
  if (ELEM == E_NONE) {
    lo = __float_as_uint(c[0]);
    hi = __float_as_uint(c[2]);
  } else if (ELEM == E_BF16) {
    const __nv_bfloat162 one = __floats2bfloat162_rn(1.0f, 1.0f);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&bias);
    const __nv_bfloat162 l = __hfma2_relu(__floats2bfloat162_rn(c[0], c[1]), one, b);
    const __nv_bfloat162 h = __hfma2_relu(__floats2bfloat162_rn(c[2], c[3]), one, b);
    lo = *reinterpret_cast<const uint32_t*>(&l);
    hi = *reinterpret_cast<const uint32_t*>(&h);
  } else {
    lo = pack_bf16_relu(c[0], c[1]);
    hi = pack_bf16_relu(c[2], c[3]);
  }
}

// The first product's C operand: zero, or the float32 bias of the columns.
template <int ELEM>
__device__ __forceinline__ void first_c(const float* bf, int idx, float (&c)[4]) {
  if (ELEM == E_F32) {
    c[0] = c[2] = bf[2 * idx];
    c[1] = c[3] = bf[2 * idx + 1];
  } else {
    c[0] = c[1] = c[2] = c[3] = 0.0f;
  }
}

// MT m16 tiles per warp (2: 16 warps of 32 aircraft; 4: 8 warps of 64), NI
// nets interleaved per trip.
template <int PROD, int ELEM, int MT, int NI>
__global__ void __launch_bounds__(THREADS, 1) chain(long long* cycles, float* sink) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TILE = 16 * MT;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);  // [NETS_PAD][NET_WORDS]
  float* vec = reinterpret_cast<float*>(words + NETS_PAD * NET_WORDS);  // [NETS_PAD][VEC]
  for (int i = threadIdx.x; i < NETS_PAD * NET_WORDS; i += blockDim.x)
    words[i] = random_bf16_pair(i);
  for (int i = threadIdx.x; i < NETS_PAD * VEC; i += blockDim.x)
    vec[i] = (float)(random_bf16_pair(i + 77777) & 0xffffu) / 65536.0f - 0.5f;
  __syncthreads();
  const int lane = threadIdx.x & 31, t = lane & 3, warp = threadIdx.x >> 5;
  float* cw = vec + NETS_PAD * VEC + warp * N_NETS * TILE;
  const int row = 8 * (t & 1) + (lane >> 2);  // + 16 (t / 2) + 32 p

  uint32_t a1[MT][4];  // layer-1 A operand: columns 0-2 real
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    a1[m][0] = a1[m][2] = t < 2 ? random_bf16_pair(900000 + threadIdx.x * 8 + m) : 0u;
    a1[m][1] = a1[m][3] = t < 2 ? random_bf16_pair(910000 + threadIdx.x * 8 + m) : 0u;
  }
  // without products, a stage's sums are the words before it, each pair once
  constexpr int PERM[3][4] = {{0, 1, 2, 3}, {4, 5, 1, 0}, {3, 2, 5, 4}};
  uint32_t keep = 0u;
  const long long t0 = clock64();
  for (int r = 0; r < ROUNDS; ++r) {
#pragma unroll 1
    for (int k = 0; k < N_NETS; k += NI) {
      uint2 q[NI][FRAG_PAIRS];
      uint32_t bb[NI][8];
      float bf[NI][16];
      float b4[NI];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const uint32_t* f = words + (k + ni) * NET_WORDS;
#pragma unroll
        for (int i = 0; i < FRAG_PAIRS; ++i)
          q[ni][i] = lds64(f + i * 64 + 2 * lane);
        if (ELEM == E_BF16) {
          const uint4 lo = lds128(f + FRAG_PAIRS * 64 + 8 * t);
          const uint4 hi = lds128(f + FRAG_PAIRS * 64 + 8 * t + 4);
          bb[ni][0] = lo.x; bb[ni][1] = lo.y; bb[ni][2] = lo.z; bb[ni][3] = lo.w;
          bb[ni][4] = hi.x; bb[ni][5] = hi.y; bb[ni][6] = hi.z; bb[ni][7] = hi.w;
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) bb[ni][i] = 0u;
        }
        if (ELEM == E_F32) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint4 v = lds128(vec + (k + ni) * VEC + 16 * t + 4 * i);
            bf[ni][4 * i] = __uint_as_float(v.x);
            bf[ni][4 * i + 1] = __uint_as_float(v.y);
            bf[ni][4 * i + 2] = __uint_as_float(v.z);
            bf[ni][4 * i + 3] = __uint_as_float(v.w);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 16; ++i) bf[ni][i] = 0.0f;
        }
        b4[ni] = ELEM == E_NONE ? 0.0f : lds32f(vec + (k + ni) * VEC + 64);
      }

      uint32_t h[NI][MT][6];
      {  // layer 1: 3 column tiles, k8 in the mix
        float acc[NI][MT][3][4];
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const uint32_t w1[3] = {q[ni][0].x, q[ni][0].y, q[ni][1].x};
#pragma unroll
          for (int j = 0; j < 3; ++j)
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              if (PROD == P_NONE) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {  // 24 distinct pairs of the loaded words
                  const int i = (12 * m + 4 * j + e) % 19;
                  acc[ni][m][j][e] = __uint_as_float((i & 1) ? q[ni][i >> 1].y : q[ni][i >> 1].x);
                }
              } else {
                float c[4];
                first_c<ELEM>(bf[ni], j, c);
                product<PROD, false>(acc[ni][m][j], a1[m], w1[j], w1[j], c);
              }
            }
        }
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int j = 0; j < 3; ++j)
#pragma unroll
            for (int m = 0; m < MT; ++m)
              hidden<ELEM>(acc[ni][m][j], bb[ni][j], h[ni][m][2 * j], h[ni][m][2 * j + 1]);
      }
      {  // layer 2: 3 column tiles, k16 then k8
        float acc[NI][MT][3][4];
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const uint32_t w2b[3] = {q[ni][1].y, q[ni][2].x, q[ni][2].y};
#pragma unroll
          for (int j = 0; j < 3; ++j)
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              if (PROD == P_NONE) {
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[ni][m][j][e] = __uint_as_float(h[ni][m][PERM[j][e]]);
              } else {
                const uint32_t ha[4] = {h[ni][m][0], h[ni][m][1], h[ni][m][2], h[ni][m][3]};
                const uint32_t hb[4] = {h[ni][m][4], h[ni][m][5], h[ni][m][4], h[ni][m][5]};
                float c[4];
                first_c<ELEM>(bf[ni], 3 + j, c);
                product<PROD, true>(acc[ni][m][j], ha, q[ni][4 + j].x, q[ni][4 + j].y, c);
                product<PROD, false>(acc[ni][m][j], hb, w2b[j], w2b[j], acc[ni][m][j]);
              }
            }
        }
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int j = 0; j < 3; ++j)
#pragma unroll
            for (int m = 0; m < MT; ++m)
              hidden<ELEM>(acc[ni][m][j], bb[ni][3 + j], h[ni][m][2 * j], h[ni][m][2 * j + 1]);
      }
      uint32_t h3[NI][MT][4];
      {  // layer 3: 2 column tiles, k16 then k8
        float acc[NI][MT][2][4];
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const uint32_t w3b[2] = {q[ni][3].x, q[ni][3].y};
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              if (PROD == P_NONE) {
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[ni][m][j][e] = __uint_as_float(h[ni][m][PERM[j][e]]);
              } else {
                const uint32_t ha[4] = {h[ni][m][0], h[ni][m][1], h[ni][m][2], h[ni][m][3]};
                const uint32_t hb[4] = {h[ni][m][4], h[ni][m][5], h[ni][m][4], h[ni][m][5]};
                float c[4];
                first_c<ELEM>(bf[ni], 6 + j, c);
                product<PROD, true>(acc[ni][m][j], ha, q[ni][7 + j].x, q[ni][7 + j].y, c);
                product<PROD, false>(acc[ni][m][j], hb, w3b[j], w3b[j], acc[ni][m][j]);
              }
            }
        }
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int m = 0; m < MT; ++m)
              hidden<ELEM>(acc[ni][m][j], bb[ni][6 + j], h3[ni][m][2 * j], h3[ni][m][2 * j + 1]);
      }
      // the readout as one product per m16 tile: every column of B is W4, so
      // y[0] and y[2] are the finished dots of rows g and g + 8
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        float y[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (PROD == P_NONE) {
#pragma unroll
            for (int e = 0; e < 4; ++e) y[m][e] = __uint_as_float(h3[ni][m][e]);
          } else {
            const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            product<PROD, true>(y[m], h3[ni][m], q[ni][9].x, q[ni][9].y, zero);
          }
        }
        if (ELEM == E_NONE) {  // keeps the chain alive: ptxas drops a product nobody reads
#pragma unroll
          for (int m = 0; m < MT; ++m) keep ^= __float_as_uint(y[m][0]) ^ __float_as_uint(y[m][2]);
        }
        if (ELEM != E_NONE && k + ni < N_NETS) {
#pragma unroll
          for (int p = 0; p < MT / 2; ++p) {
            const float lo = (t & 1) ? y[2 * p][2] : y[2 * p][0];
            const float hi = (t & 1) ? y[2 * p + 1][2] : y[2 * p + 1][0];
            cw[(k + ni) * TILE + 32 * p + 16 * (t >> 1) + row] = ((t & 2) ? hi : lo) + b4[ni];
          }
        }
      }
    }
  }
  const long long t1 = clock64();
  float s = 0.0f;
  for (int i = lane; i < N_NETS * TILE; i += 32) s += cw[i];
  if (s == 123.456f || keep == 0x12345678u) sink[0] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) cycles[0] = t1 - t0;
}

// --- the wgmma form ---

__device__ __forceinline__ void wg_n24(float (&d)[12], const uint32_t (&a)[4], uint64_t desc,
                                       int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
__device__ __forceinline__ void wg_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t desc,
                                       int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
__device__ __forceinline__ void wg_n8(float (&d)[4], const uint32_t (&a)[4], uint64_t desc,
                                      int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// Four warpgroups per block, each with one tile of 64 aircraft per trip (256
// aircraft in flight per SM, so WG_ROUNDS = 2 ROUNDS for the same n): 6
// wgmma per net, four waits. The quad of lanes (g, 0..3) holds rows g and
// g + 8 of its warp's 16: lanes t = 0, 1 keep one finished coefficient each.
template <int ELEM>
__global__ void __launch_bounds__(THREADS, 1) chain_wgmma(long long* cycles, float* sink) {
  using namespace np_wgmma;
  extern __shared__ __align__(128) unsigned char smem[];
  for (int i = threadIdx.x; i < WG_SCRATCH / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(smem)[i] = random_bf16_pair(i);
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int lane = threadIdx.x & 31, t = lane & 3, wg = threadIdx.x >> 7;
  const uint32_t* bias = reinterpret_cast<const uint32_t*>(smem + WG_BIAS);
  const float* b4s = reinterpret_cast<const float*>(smem + WG_B4);
  float* cw = reinterpret_cast<float*>(smem + WG_SCRATCH) + wg * N_NETS * 64;
  const int row = 16 * ((threadIdx.x >> 5) & 3) + 8 * (t & 1) + (lane >> 2);
  const uint32_t a1[4] = {t < 2 ? random_bf16_pair(900000 + threadIdx.x) : 0u,
                          t < 2 ? random_bf16_pair(910000 + threadIdx.x) : 0u, 0u, 0u};
  float acc[12] = {}, a3[8] = {}, y[4] = {};
  uint32_t keep = 0u;
  const long long t0 = clock64();
  for (int r = 0; r < WG_ROUNDS; ++r) {
#pragma unroll 1
    for (int k = 0; k < N_NETS; ++k) {
      const unsigned char* net = smem + k * WG_NET;
      uint32_t bb[8];
      float b4 = 0.0f;
      if (ELEM == E_BF16) {
        const uint4 lo = lds128(bias + k * 32 + 8 * t), hi = lds128(bias + k * 32 + 8 * t + 4);
        bb[0] = lo.x; bb[1] = lo.y; bb[2] = lo.z; bb[3] = lo.w;
        bb[4] = hi.x; bb[5] = hi.y; bb[6] = hi.z; bb[7] = hi.w;
        b4 = lds32f(b4s + k);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) bb[i] = 0u;
      }
      uint32_t h[8];
      h[6] = h[7] = 0u;  // columns 24-31 of the padded K = 32
      // layer 1: [64, 16] x [16, 24]
      fence();
      wg_n24(acc, a1, make_desc(net + WG_L1, 16 * 24, 128), 0);
      commit();
      wait_all();
#pragma unroll
      for (int i = 0; i < 12; ++i) pin(acc[i]);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float c[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]};
        hidden<ELEM>(c, bb[j], h[2 * j], h[2 * j + 1]);
      }
      // layer 2: [64, 32] x [32, 24]
      {
        const uint32_t ha[4] = {h[0], h[1], h[2], h[3]}, hb[4] = {h[4], h[5], h[6], h[7]};
        const uint64_t d2 = make_desc(net + WG_L2, 16 * 24, 128);
        fence();
        wg_n24(acc, ha, d2, 0);
        wg_n24(acc, hb, advance(d2, 32 * 24), 1);
        commit();
        wait_all();
      }
#pragma unroll
      for (int i = 0; i < 12; ++i) pin(acc[i]);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float c[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]};
        hidden<ELEM>(c, bb[3 + j], h[2 * j], h[2 * j + 1]);
      }
      // layer 3: [64, 32] x [32, 16]
      {
        const uint32_t ha[4] = {h[0], h[1], h[2], h[3]}, hb[4] = {h[4], h[5], h[6], h[7]};
        const uint64_t d3 = make_desc(net + WG_L3, 16 * 16, 128);
        fence();
        wg_n16(a3, ha, d3, 0);
        wg_n16(a3, hb, advance(d3, 32 * 16), 1);
        commit();
        wait_all();
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) pin(a3[i]);
      uint32_t h3[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float c[4] = {a3[4 * j], a3[4 * j + 1], a3[4 * j + 2], a3[4 * j + 3]};
        hidden<ELEM>(c, bb[6 + j], h3[2 * j], h3[2 * j + 1]);
      }
      // readout: [64, 16] x [16, 8], every column W4
      fence();
      wg_n8(y, h3, make_desc(net + WG_L4, 16 * 8, 128), 0);
      commit();
      wait_all();
#pragma unroll
      for (int i = 0; i < 4; ++i) pin(y[i]);
      if (ELEM != E_NONE && t < 2) cw[k * 64 + row] = ((t & 1) ? y[2] : y[0]) + b4;
      if (ELEM == E_NONE) keep ^= __float_as_uint(y[0]) ^ __float_as_uint(y[2]);
    }
  }
  const long long t1 = clock64();
  float s = 0.0f;
  for (int i = threadIdx.x & 127; i < N_NETS * 64; i += 128) s += cw[i];
  if (s == 123.456f || keep == 0x12345678u) sink[0] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) cycles[0] = t1 - t0;
}

template <typename Kernel>
void run(const char* what, Kernel kernel, int threads, int smem, int trips, long long* d_cycles,
         float* sink) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float ms = 0.0f, best = 1e30f;
  for (int rep = 0; rep < 4; ++rep) {  // the first launch warms up
    cudaEventRecord(e0);
    kernel<<<sms, threads, smem>>>(d_cycles, sink);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
    if (rep > 0 && ms < best) best = ms;
  }
  long long h = 0;
  cudaMemcpy(&h, d_cycles, sizeof(long long), cudaMemcpyDeviceToHost);
  printf("%-58s %4d threads: %.4f ms (last %.4f); %7.1f cycles per trip of warp 0; %s\n", what,
         threads, best, ms, (double)h / trips, cudaGetErrorString(cudaGetLastError()));
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
}

}  // namespace

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
  printf("%s, %d SMs; one launch = the sweep's work at n = 10^6 on 132 SMs "
         "(%d rounds x %d nets per warp)\n", prop.name, prop.multiProcessorCount, ROUNDS, N_NETS);
  const int T1 = ROUNDS * N_NETS, T2 = ROUNDS * ((N_NETS + 1) / 2), TW = WG_ROUNDS * N_NETS;
  run("products alone, the sweep's mix (12 k16 + 16 k8)", chain<P_MIX, E_NONE, 2, 1>, 512,
      SMEM_MMA, T1, d_cycles, sink);
  run("products alone, all 28 as m16n8k8", chain<P_K8, E_NONE, 2, 1>, 512, SMEM_MMA, T1,
      d_cycles, sink);
  run("products alone, all 28 as m16n8k16", chain<P_K16, E_NONE, 2, 1>, 512, SMEM_MMA, T1,
      d_cycles, sink);
  run("products alone, mix, 8 warps x 64 aircraft", chain<P_MIX, E_NONE, 4, 1>, 256, SMEM_MMA,
      T1, d_cycles, sink);
  run("products alone, mix, two nets interleaved", chain<P_MIX, E_NONE, 2, 2>, 512, SMEM_MMA,
      T2, d_cycles, sink);
  run("products alone, each k16 as two k8 (40 k8)", chain<P_SPLIT, E_NONE, 2, 1>, 512, SMEM_MMA,
      T1, d_cycles, sink);
  run("everything else alone, bf16 hidden", chain<P_NONE, E_BF16, 2, 1>, 512, SMEM_MMA, T1,
      d_cycles, sink);
  run("everything else alone, float32 hidden", chain<P_NONE, E_F32, 2, 1>, 512, SMEM_MMA, T1,
      d_cycles, sink);
  run("together, bf16 hidden", chain<P_MIX, E_BF16, 2, 1>, 512, SMEM_MMA, T1, d_cycles, sink);
  run("together, float32 hidden (bias as C)", chain<P_MIX, E_F32, 2, 1>, 512, SMEM_MMA, T1,
      d_cycles, sink);
  run("together, bf16 hidden, each k16 as two k8", chain<P_SPLIT, E_BF16, 2, 1>, 512, SMEM_MMA,
      T1, d_cycles, sink);
  run("together, float32 hidden, each k16 as two k8", chain<P_SPLIT, E_F32, 2, 1>, 512, SMEM_MMA,
      T1, d_cycles, sink);
  run("together, bf16 hidden, two k8, 8 warps x 64 aircraft", chain<P_SPLIT, E_BF16, 4, 1>, 256,
      SMEM_MMA, T1, d_cycles, sink);
  run("together, bf16 hidden, 8 warps x 64 aircraft", chain<P_MIX, E_BF16, 4, 1>, 256, SMEM_MMA,
      T1, d_cycles, sink);
  run("together, float32 hidden, 8 warps x 64 aircraft", chain<P_MIX, E_F32, 4, 1>, 256,
      SMEM_MMA, T1, d_cycles, sink);
  run("together, bf16 hidden, two nets interleaved", chain<P_MIX, E_BF16, 2, 2>, 512, SMEM_MMA,
      T2, d_cycles, sink);
  run("together, float32 hidden, two nets interleaved", chain<P_MIX, E_F32, 2, 2>, 512, SMEM_MMA,
      T2, d_cycles, sink);
  run("wgmma n24/n16/n8, A from registers, alone", chain_wgmma<E_NONE>, 512, SMEM_WG, TW,
      d_cycles, sink);
  run("wgmma n24/n16/n8 + bf16 hidden elementwise", chain_wgmma<E_BF16>, 512, SMEM_WG, TW,
      d_cycles, sink);
  return 0;
}
