// Distilled aero surrogate for one block of NP_M aircraft: hinge features
// and the [68 -> 256 -> 256] trunk with its [64, 256 + 68] readout on tensor
// cores. Twin of neuralplane_tpu_torch/surrogates/distill.py:trunk_z and of
// the TPU's neuralplane_tpu/ops/aero_pallas.py:distilled_feature_rows /
// distilled_coeff_rows.
//
// Layout. A block owns NP_M = 64 aircraft and NP_THREADS = 256 threads
// (8 warps). The features (bf16, [64][F_LD]) and one hidden layer (bf16,
// [64][H_LD]) live in shared memory. Each product C[64, N] = A[64, K] W^T
// runs on mma.sync m16n8k16 (bf16 operands from ldmatrix, float32
// accumulators in registers). The hidden layers use a 2 x 4 warp grid, each
// warp a 32 x 64 tile (16 accumulators of 4 floats); the readout a 4 x 2
// grid of 16 x 32 tiles. The weights (~200 KB in all, L2-resident) stream
// through shared memory in chunks of all N rows x 32 K, three stages of
// cp.async in flight, each chunk used for all 64 aircraft of the block.
// Since a layer's accumulators stay in registers until its K loop ends, the
// second hidden layer overwrites the first in place, and the readout's raw
// accumulators go to the same region coefficient-major ([64 coef][64
// aircraft], float32), where the thread of each aircraft reads its 43
// coefficients without bank conflicts.
//
// Rounding points (the TPU kernel's): features in float32 by division by
// IN_SCALE, then bf16; bf16 x bf16 products summed in float32; with
// hidden_bf16 the accumulator is rounded to bf16, the bias is rounded to
// bf16, their sum is rounded to bf16, then ReLU; without it ReLU(acc + b)
// in float32, rounded to bf16 for the next product; the readout keeps its
// float32 accumulator.
#pragma once
#include <cstdint>
#include <cuda_bf16.h>

namespace np_dist {

using bf16 = __nv_bfloat16;

constexpr int NP_M = 64;              // aircraft per block
constexpr int NP_THREADS = 256;       // 8 warps
constexpr int NP_H = 256;             // hidden width the kernels are built for
constexpr int F_PAD = 80;             // features padded to 5 x 16 (zeros)
constexpr int F_LD = F_PAD + 8;       // shared-memory row pitches (+8: no
constexpr int H_LD = NP_H + 8;        // ldmatrix bank conflicts)
constexpr int OUT = 64;               // readout rows, 43 real
constexpr int N_COEF = 43;
constexpr int KC = 32;                // K per weight chunk
constexpr int WC_LD = KC + 8;         // chunk row pitch
constexpr int STAGES = 3;             // weight chunks in flight
constexpr int WCHUNK = NP_H * WC_LD;  // elements per chunk buffer (N <= NP_H)

// Knots: np.linspace(-20, 90, 45)[1:-1], linspace(-30, 30, 17)[1:-1],
// linspace(-25, 25, 9)[1:-1]; every knot is exact in float32.
constexpr int N_ALPHA_K = 43, N_BETA_K = 15, N_EL_K = 7;

struct Weights {
  const bf16* W1;   // [H][F_PAD]
  const float* b1;  // [H]
  const bf16* W2;   // [H][H]
  const float* b2;  // [H]
  const bf16* W3;   // [OUT][H + F_PAD]
  const float* b3;  // [OUT]
  const float* mu;  // [OUT]
  const float* sd;  // [OUT]
};

struct Smem {
  bf16* feat;    // [NP_M][F_LD]
  bf16* h;       // [NP_M][H_LD], first then second hidden layer
  float* cT;     // [OUT][NP_M] readout accumulators, coefficient-major (over h)
  bf16* wbuf;    // [STAGES][NP_H][WC_LD] weight chunks
  float* io;     // [NP_M][22] staging for coalesced row-major I/O (over wbuf,
                 // used only before and after the trunk)
  float* abe;    // [NP_M][3], alpha_deg, beta_deg, el
};

__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) & ~size_t(127); }

constexpr size_t SMEM_FEAT = align128(NP_M * F_LD * 2);
constexpr size_t SMEM_H = align128(NP_M * H_LD * 2);
constexpr size_t SMEM_W = align128(STAGES * WCHUNK * 2);
constexpr size_t SMEM_BYTES = SMEM_FEAT + SMEM_H + SMEM_W + align128(NP_M * 3 * 4);
static_assert(OUT * NP_M * 4 <= SMEM_H, "cT must fit over the hidden layer");
static_assert(NP_M * 22 * 4 <= SMEM_W, "I/O staging must fit over the weight chunks");

__device__ inline Smem smem_layout(unsigned char* p) {
  Smem s;
  s.feat = reinterpret_cast<bf16*>(p);
  s.h = reinterpret_cast<bf16*>(p + SMEM_FEAT);
  s.cT = reinterpret_cast<float*>(p + SMEM_FEAT);
  s.wbuf = reinterpret_cast<bf16*>(p + SMEM_FEAT + SMEM_H);
  s.io = reinterpret_cast<float*>(p + SMEM_FEAT + SMEM_H);
  s.abe = reinterpret_cast<float*>(p + SMEM_FEAT + SMEM_H + SMEM_W);
  return s;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x / d rounded to float32, for d in {35, 18, 15}: the product with the
// double reciprocal, rounded once to float, is the correctly rounded
// quotient. (x / d is never a float rounding midpoint: a midpoint m has 25
// significant bits and the odd part of d would give d m more than 24, so
// |x / d - m| >= 2^-25 |m| / 35, far above the ~2^-52 relative error of the
// double product.) This is what distill.featurize computes with a float32
// division, without the division's instruction sequence.
__device__ __forceinline__ float div_scale(float x, double inv_d) {
  return __double2float_rn((double)x * inv_d);
}

// Feature f of one aircraft (distill.featurize): scaled coordinates, then
// relu hinges at the knots, each divided by its coordinate's IN_SCALE.
__device__ __forceinline__ float feature(int f, float a, float b, float e) {
  constexpr double INV_A = 1.0 / 35.0, INV_B = 1.0 / 18.0, INV_E = 1.0 / 15.0;
  if (f == 0) return div_scale(a - 35.0f, INV_A);
  if (f == 1) return div_scale(b, INV_B);
  if (f == 2) return div_scale(e, INV_E);
  f -= 3;
  if (f < N_ALPHA_K) return div_scale(fmaxf(a - (-20.0f + 2.5f * (float)(f + 1)), 0.0f), INV_A);
  f -= N_ALPHA_K;
  if (f < N_BETA_K) return div_scale(fmaxf(b - (-30.0f + 3.75f * (float)(f + 1)), 0.0f), INV_B);
  f -= N_BETA_K;
  if (f < N_EL_K) return div_scale(fmaxf(e - (-25.0f + 6.25f * (float)(f + 1)), 0.0f), INV_E);
  return 0.0f;  // padding columns 68..79
}

// All threads: smem.abe -> smem.feat (bf16). Thread t takes aircraft
// t % NP_M and every (NP_THREADS / NP_M)-th pair of feature columns, so the
// lanes of a warp evaluate the same feature (no divergence) and store two
// bf16 at a time. Caller syncs before and after.
__device__ __forceinline__ void build_features(const Smem& sm) {
  constexpr int PARTS = NP_THREADS / NP_M;
  const int r = threadIdx.x % NP_M;
  const float a = sm.abe[3 * r], b = sm.abe[3 * r + 1], e = sm.abe[3 * r + 2];
  __nv_bfloat162* row = reinterpret_cast<__nv_bfloat162*>(sm.feat + r * F_LD);
  for (int q = threadIdx.x / NP_M; q < F_PAD / 2; q += PARTS)
    row[q] = __floats2bfloat162_rn(feature(2 * q, a, b, e), feature(2 * q + 1, a, b, e));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a . b for one m16n8k16 tile, bf16 operands, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// All threads: rows [0, N) x columns [k0, k0 + kw) of W (row-major, ldw)
// -> dst [N][WC_LD], as 16-byte cp.async copies, committed as one group
// (an empty group when kw == 0, so that every thread commits once per
// chunk slot).
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* __restrict__ W, int ldw,
                                           int N, int k0, int kw) {
  const int segs = kw / 8;
  for (int e = threadIdx.x; e < N * segs; e += NP_THREADS) {
    const int row = e / segs, seg = e - row * segs;
    cp_async16(dst + row * WC_LD + seg * 8, W + (size_t)row * ldw + k0 + seg * 8);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// acc[MW][NW] = [A1 | A2][row0 .. row0 + 16 MW, 0 .. K1 + K2) . W^T for
// this warp's columns col0 .. col0 + 8 NW. W is row-major [N][ldw] and
// streams through sm.wbuf in chunks of all N rows x KC columns of K. Every
// thread of the block calls it; it returns after a barrier, with every
// weight copy done and every warp past its last read of A.
template <int MW, int NW>
__device__ __forceinline__ void gemm(const Smem& sm, const bf16* A1, int lda1, int K1,
                                     const bf16* A2, int lda2, int K2,
                                     const bf16* __restrict__ W, int ldw, int N, int row0,
                                     int col0, float (&acc)[MW][NW][4]) {
  const int lane = threadIdx.x & 31;
  const int K = K1 + K2;
  const int chunks = (K + KC - 1) / KC;
#pragma unroll
  for (int m = 0; m < MW; ++m)
#pragma unroll
    for (int j = 0; j < NW; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.0f;
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c)
    load_chunk(sm.wbuf + c * WCHUNK, W, ldw, N, c * KC, c < chunks ? min(KC, K - c * KC) : 0);
  for (int c = 0; c < chunks; ++c) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncthreads();  // chunk c is in; every warp is done with chunk c - 1
    const int cn = c + STAGES - 1;
    load_chunk(sm.wbuf + (cn % STAGES) * WCHUNK, W, ldw, N, cn * KC,
               cn < chunks ? min(KC, K - cn * KC) : 0);
    const bf16* wc = sm.wbuf + (c % STAGES) * WCHUNK;
    const int k0 = c * KC, kw = min(KC, K - k0);
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      if (kk >= kw) break;
      const int k = k0 + kk;
      const bf16* A = k < K1 ? A1 + k : A2 + (k - K1);
      const int lda = k < K1 ? lda1 : lda2;
      uint32_t a[MW][4];
#pragma unroll
      for (int m = 0; m < MW; ++m)
        ldmatrix_x4(a[m], A + (row0 + 16 * m + (lane & 15)) * lda + ((lane >> 4) << 3));
#pragma unroll
      for (int j = 0; j < NW; j += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, wc + (col0 + 8 * j + (lane & 7) + ((lane >> 4) << 3)) * WC_LD + kk
                           + (((lane >> 3) & 1) << 3));
#pragma unroll
        for (int m = 0; m < MW; ++m) {
          mma_bf16(acc[m][j], a[m], b[0], b[1]);
          mma_bf16(acc[m][j + 1], a[m], b[2], b[3]);
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// Hidden layer: h = ReLU(acc + bias) with the rounding points of the file
// header, written as bf16 into sm.h. Accumulator element (m, j, e) sits at
// row row0 + 16 m + lane / 4 + 8 (e / 2), column col0 + 8 j + 2 (lane % 4)
// + e % 2 (the m16n8k16 layout).
template <int MW, int NW>
__device__ __forceinline__ void hidden_epilogue(const Smem& sm, const float (&acc)[MW][NW][4],
                                                const float* __restrict__ bias,
                                                bool hidden_bf16, int row0, int col0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int col = col0 + 8 * j + 2 * (lane & 3);
    const float2 bb = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
    for (int m = 0; m < MW; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 16 * m + (lane >> 2) + 8 * half;
        float v0 = acc[m][j][2 * half], v1 = acc[m][j][2 * half + 1];
        if (hidden_bf16) {
          v0 = bf16_round(bf16_round(v0) + bf16_round(bb.x));
          v1 = bf16_round(bf16_round(v1) + bf16_round(bb.y));
        } else {
          v0 = v0 + bb.x;
          v1 = v1 + bb.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(sm.h + row * H_LD + col) =
            __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
      }
  }
}

// sm.feat -> sm.cT: the three products. Every thread of the block calls it;
// it returns after a barrier, with sm.cT complete.
__device__ __forceinline__ void trunk(const Smem& sm, const Weights& w, bool hidden_bf16) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  {  // hidden layers: warp grid 2 (rows) x 4 (columns), 32 x 64 per warp
    const int row0 = 32 * (warp >> 2), col0 = 64 * (warp & 3);
    float acc[2][8][4];
    gemm<2, 8>(sm, sm.feat, F_LD, F_PAD, nullptr, 0, 0, w.W1, F_PAD, NP_H, row0, col0, acc);
    hidden_epilogue<2, 8>(sm, acc, w.b1, hidden_bf16, row0, col0);
    __syncthreads();
    gemm<2, 8>(sm, sm.h, H_LD, NP_H, nullptr, 0, 0, w.W2, NP_H, NP_H, row0, col0, acc);
    hidden_epilogue<2, 8>(sm, acc, w.b2, hidden_bf16, row0, col0);
    __syncthreads();
  }
  {  // readout over [hidden ; features]: warp grid 4 x 2, 16 x 32 per warp
    const int row0 = 16 * (warp >> 1), col0 = 32 * (warp & 1);
    float acc[1][4][4];
    gemm<1, 4>(sm, sm.h, H_LD, NP_H, sm.feat, F_LD, F_PAD, w.W3, NP_H + F_PAD, OUT, row0,
               col0, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (lane >> 2) + 8 * (e >> 1);
        const int col = col0 + 8 * j + 2 * (lane & 3) + (e & 1);
        sm.cT[col * NP_M + row] = acc[0][j][e];
      }
    __syncthreads();
  }
}

// Raw coefficients of the aircraft in block row t: (z + b3) * sd + mu.
__device__ __forceinline__ void coefficients(const Smem& sm, const Weights& w, int t,
                                             float c[N_COEF]) {
#pragma unroll
  for (int k = 0; k < N_COEF; ++k)
    c[k] = (sm.cT[k * NP_M + t] + w.b3[k]) * w.sd[k] + w.mu[k];
}

}  // namespace np_dist
