// Hopper warpgroup matrix multiply (wgmma.mma_async, sm_90a only) as the
// distilled trunk uses it: a warpgroup of 4 warps multiplies a 64-row A tile
// held in registers with a B tile read from shared memory, and keeps the
// float32 sums in registers.
//
// B layout ("K-major", no swizzle). B is W[N][K] with K contiguous, cut into
// core matrices of 8 rows (n) x 8 columns (k) = 8 x 16 bytes, each stored as
// 128 contiguous bytes (row n % 8 at byte 16 (n % 8)). The descriptor names
// the byte distance between core matrices that are neighbours in k (the
// "leading" offset) and in n (the "stride" offset). One instruction reads
// k = 16: two core-matrix columns.
//
// Register layouts. Warp w of the warpgroup holds rows 16 w .. 16 w + 15;
// lane 4 g + t holds, of A, the m16n8k16 fragment (a0: row g, columns 2t,
// 2t + 1; a1: row g + 8, same columns; a2, a3: the same rows, columns + 8)
// and, of the sums, for every 8 columns j: d[4j], d[4j + 1] = row g,
// columns 8j + 2t, 8j + 2t + 1; d[4j + 2], d[4j + 3] = row g + 8. So the
// sums of columns 16 kb .. 16 kb + 15, rounded and packed in pairs, are the
// A fragment of k block kb of the next product.
#pragma once
#include <cstdint>

namespace np_wgmma {

// Shared-memory matrix descriptor, no swizzle: start address, leading (k)
// and stride (n) byte offsets, each in units of 16 bytes in a 14-bit field.
__device__ __forceinline__ uint64_t make_desc(const void* smem, uint32_t k_bytes,
                                              uint32_t n_bytes) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(k_bytes >> 4) << 16)
         | ((uint64_t)(n_bytes >> 4) << 32);
}

// The descriptor moved on by `bytes` (a multiple of 16) inside its matrix.
__device__ __forceinline__ uint64_t advance(uint64_t desc, uint32_t bytes) {
  return desc + (uint64_t)(bytes >> 4);
}

// Registers written by ordinary instructions become visible to the next
// wgmma of this warpgroup.
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Every wgmma committed so far is done: its sums may be read and its A
// registers written.
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving a use of `x` across this point (a wgmma
// reads and writes its registers after the instruction has been started).
__device__ __forceinline__ void pin(float& x) { asm volatile("" : "+f"(x)::"memory"); }

// d[64] (+)= A[64, 16] . B[16, 128]: A from registers (the m16n8k16 fragment of
// each warp's 16 rows), B from shared memory through `desc`, bf16 operands,
// float32 sums. scale_d == 0 starts a new sum (d is not read).
__device__ __forceinline__ void mma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d[24] (+)= A[64, 16] . B[16, 48]: A from registers (the m16n8k16 fragment of
// each warp's 16 rows), B from shared memory through `desc`, bf16 operands,
// float32 sums. scale_d == 0 starts a new sum (d is not read).
__device__ __forceinline__ void mma_m64n48k16(float (&d)[24], const uint32_t (&a)[4],
                                               uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

}  // namespace np_wgmma
