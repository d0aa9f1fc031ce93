// Hopper tile primitives of the redesigned attention kernels (the bf16
// d=64 bodies of flash_attention_bwd.cu, and through wgmma_attention.cuh of
// flash_attention_fwd.cu, frame_attention_fwd.cu and
// blockdiag_attention_fwd.cu):
// 128-byte-swizzled [64 x 64] bf16 tiles in shared memory filled by
// cp.async, their wgmma descriptors, and the two warpgroup products
// m64n64k16 (bf16 in, fp32 accumulators in registers) those kernels use:
//   ss:  D (+)= A B^T, A and B both [64 x 64] tiles read from shared memory,
//        each row holding the 64 contraction elements (K-major);
//   rs:  D (+)= A B,   A from registers (the bf16 fragment of an earlier
//        accumulator), B a [64 (contraction) x 64] tile whose rows hold
//        the 64 output columns (MN-major, read transposed); or B^T from a
//        K-major tile as ss reads it; and at N = 8 (m64n8k16), the A/B
//        kernels' product of p with a column of ones.
//
// A warpgroup is the 128 threads of one block. Thread t = 32 w + l holds,
// of a [64 x 64] fp32 accumulator d[32], the elements
//   d[4 j + 2 h + c]  at row 16 w + l / 4 + 8 h, column 8 j + 2 (l % 4) + c
// for j in 0..7, h, c in {0, 1}. The A operand of the k-th 16-column slice
// of such an accumulator, rounded to bf16, is {pack(d[8k], d[8k+1]),
// pack(d[8k+2], d[8k+3]), pack(d[8k+4], d[8k+5]), pack(d[8k+6], d[8k+7])}:
// the register layouts agree, so P and dS never pass through shared memory
// on their way into a product.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace vtm {
namespace wg {

constexpr int kRows = 64;                 // rows of a tile; its columns are 64 bf16 = 128 bytes
constexpr int kThreads = 128;             // one warpgroup
constexpr int kTileBytes = kRows * 128;   // 8 KB
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (columns 8c..8c+7) of row r in a tile
// whose base is 1024-byte aligned: the 128-byte swizzle (chunk ^ row % 8),
// the pattern wgmma's SWIZZLE_128B descriptors read.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// Rows [row0, row0 + 64) of a bf16 [rows x 64] slice (row stride in
// elements, last dim contiguous) into the swizzled tile at shared address
// dst with cp.async, 16 bytes a copy, coalesced along rows. Rows at or past
// `end` are zero-filled (the copy reads nothing for them).
__device__ __forceinline__ void load_tile_async(uint32_t dst, const __nv_bfloat16* src,
                                                long long row_stride, int row0, int end) {
#pragma unroll
  for (int i = 0; i < kRows * 8 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 3, c = idx & 7;
    const bool ok = row0 + r < end;
    const __nv_bfloat16* g = src + (ok ? (row0 + r) * row_stride + c * 8 : 0);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst + swz(r, c)), "l"(g),
                 "r"(ok ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Make this thread's shared-memory writes (plain stores and completed
// cp.async copies) visible to wgmma, which reads through the async proxy.
// A __syncthreads must follow before another thread's wgmma reads them.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma descriptors of a swizzled tile at shared address `addr` (1024-byte
// aligned, plus 32 bytes per 16-column step for the K-major form):
// start address, leading byte offset, stride byte offset (both in 16-byte
// units), layout SWIZZLE_128B.
//   K-major: rows are M or N, 8-row groups 1024 bytes apart (SBO); the
//            leading offset is unused by the swizzled form.
//   MN-major: rows are the contraction index, 8-row groups 1024 bytes
//            apart (SBO); the leading offset would step to a second 64-wide
//            column block, which an N = 64 product does not have.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// wgmma's .aligned forms need the warp converged: the branches before
// them (masks, ragged edges) may have split it.
__device__ __forceinline__ void wg_fence() {
  __syncwarp();
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving register reads or writes of an accumulator
// across the asynchronous products (before wg_fence, after wg_wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define VTM_WG_D32                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define VTM_WG_D32_OUT(d)                                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),           \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),   \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),             \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),             \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (+)= a b^T over 16 contraction columns; a, b: K-major descriptors.
// accumulate == 0 overwrites d.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VTM_WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : VTM_WG_D32_OUT(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= a b over 16 contraction rows; a: this thread's four registers of
// the bf16 A fragment; b: MN-major descriptor (read transposed), or with
// kTransB = 0 a K-major one (d (+)= a b^T, as mma_ss reads b).
template <int kTransB = 1>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t* a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VTM_WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : VTM_WG_D32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(kTransB));
}

// d (+)= a b^T at N = 8 (m64n8k16): d[4] holds, for this thread, row
// 16 w + l / 4 + 8 h, column 2 (l % 4) + c at d[2 h + c]; b is a K-major
// descriptor of 8 rows (one 1024-byte swizzle atom).
__device__ __forceinline__ void mma_rs_n8(float (&d)[4], const uint32_t* a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#undef VTM_WG_D32
#undef VTM_WG_D32_OUT

// d = a b^T over the full 64-column contraction: four 16-column steps, the
// descriptors advancing 32 bytes along each K-major row.
__device__ __forceinline__ void product_ss(float (&d)[32], uint32_t a_tile, uint32_t b_tile) {
#pragma unroll
  for (int k = 0; k < 4; ++k) mma_ss(d, desc_sw128(a_tile + 32 * k), desc_sw128(b_tile + 32 * k), k);
}

// d (+)= a b over 64 contraction rows: a as 16 registers (four steps of
// four), b an MN-major tile advancing 16 rows (2048 bytes) a step.
__device__ __forceinline__ void product_rs(float (&d)[32], const uint32_t (&a)[16], uint32_t b_tile,
                                           bool accumulate) {
#pragma unroll
  for (int k = 0; k < 4; ++k) mma_rs(d, a + 4 * k, desc_sw128(b_tile + 2048 * k), accumulate || k > 0);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The bf16 A fragment of an fp32 accumulator (see the header note).
__device__ __forceinline__ void to_a_fragment(const float (&d)[32], uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = pack_bf16(d[2 * i], d[2 * i + 1]);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Row and column of accumulator element i for this thread (header note).
__device__ __forceinline__ int acc_row(int i) {
  return 16 * (threadIdx.x / 32) + (threadIdx.x % 32) / 4 + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) { return 8 * (i >> 2) + 2 * (threadIdx.x % 4) + (i & 1); }

// A [64 x 64] accumulator times `scale`, rounded to bf16, into the swizzled
// staging tile at `stage` (generic pointer), then rows [row0, row0 + 64)
// below `end` out to device memory (row stride in elements) with 16-byte
// stores. Brackets itself with __syncthreads: the stage may alias a tile
// the products just read.
__device__ __forceinline__ void store_tile(const float (&d)[32], float scale, unsigned char* stage,
                                           __nv_bfloat16* dst, long long row_stride, int row0, int end) {
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = acc_row(i), c = acc_col(i);
    *reinterpret_cast<uint32_t*>(stage + swz(r, c >> 3) + (c & 7) * 2) =
        pack_bf16(d[i] * scale, d[i + 1] * scale);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRows * 8 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 3, c = idx & 7;
    if (row0 + r < end)
      *reinterpret_cast<uint4*>(dst + (row0 + r) * row_stride + c * 8) =
          *reinterpret_cast<const uint4*>(stage + swz(r, c));
  }
}

// A 1024-byte aligned base in dynamic shared memory (the launch asks for
// 1 KB more than the layout needs).
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* smem) {
  const uint32_t a = smem_addr(smem);
  return smem + (((a + 1023) & ~1023u) - a);
}

}  // namespace wg
}  // namespace vtm
