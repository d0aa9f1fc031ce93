// Tile helpers shared by the attention kernels of this directory
// (flash_attention_fwd.cu, flash_attention_bwd.cu, frame_attention_fwd.cu,
// frame_attention_bwd.cu, the two blockdiag_attention sources and the three
// ab_ sources): dtype conversion, the 16-byte staging of a
// 64-row tile of q, k, v or do into shared memory, and the tile products
// and register accumulators of the two backward kernels.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace vtm {

constexpr int kTileRows = 64;     // rows of every staged q, k or v tile
constexpr int kTileThreads = 128; // 4 warps stage a tile together
constexpr float kMask = -1e30f;   // the logit of a key past the end of its row or frame
static_assert(kTileRows == (kTileThreads / 32) * 16, "each warp owns a 16-row strip");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else {
    return __float2bfloat16(x);
  }
}

// Stage rows [row0, row0 + 64) of one (b, h) slice into shared memory
// (leading dimension `ld` elements) with 16-byte loads, zero-filling rows
// at or past `end`. When kScale is set the values are multiplied by
// `scale` and rounded back to T (q * scale in T).
template <typename T, int D, bool kScale>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, long long row_stride,
                                          int row0, int end, float scale) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecsPerRow = D / kVec;
  for (int i = threadIdx.x; i < kTileRows * kVecsPerRow; i += kTileThreads) {
    const int r = i / kVecsPerRow;
    const int c = (i % kVecsPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < end) {
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c);
      if constexpr (kScale) {
        T* e = reinterpret_cast<T*>(&val);
#pragma unroll
        for (int j = 0; j < kVec; ++j) e[j] = from_float<T>(to_float(e[j]) * scale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// ---- the backward kernels' tiles ------------------------------------------
// A block of 4 warps works on a [64 query x 64 key] tile pair; warp w owns
// rows [16 w, 16 w + 16) of whatever it computes, and in the fp32 path lane
// l owns half `l & 1` of row `16 w + l / 2`. `cols` (a multiple of 16 in
// the bf16 path) is how many of the 64 key columns hold a key: the 16-wide
// groups past it are skipped, and what is left there is never read as a
// key (the callers mask by key index).

// Shared-memory layout: four staged [64 x D] tiles in T, the fp32 s and dp
// tiles, and p_lo / ds_lo in T. Row pads of 16 bytes break bank conflicts
// and keep every 16-row fragment origin 32-byte aligned, as wmma requires.
// After the main loop the s and dp regions together stage one [64 x D]
// fp32 result on its way to device memory.
template <typename T, int D>
struct BwdLayout {
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int ld_x = D + kPad;          // q, k, v, do tiles (T)
  static constexpr int ld_s = kTileRows + 4;     // s, dp (fp32)
  static constexpr int ld_p = kTileRows + kPad;  // p_lo, ds_lo (T)
  static constexpr int ld_o = D + 4;             // staged result (fp32)
  static constexpr size_t x_bytes = size_t(kTileRows) * ld_x * sizeof(T);
  static constexpr size_t s_bytes = size_t(kTileRows) * ld_s * sizeof(float);
  static constexpr size_t p_bytes = size_t(kTileRows) * ld_p * sizeof(T);
  static constexpr size_t s_off = 4 * x_bytes;
  static constexpr size_t dp_off = s_off + s_bytes;
  static constexpr size_t p_off = dp_off + s_bytes;
  static constexpr size_t ds_off = p_off + p_bytes;
  static constexpr size_t bytes = ds_off + p_bytes;
  static_assert(x_bytes % 128 == 0 && s_bytes % 128 == 0 && p_bytes % 128 == 0,
                "shared regions must stay 128-byte aligned");
  static_assert(size_t(kTileRows) * ld_o * sizeof(float) <= 2 * s_bytes,
                "the staged result must fit the s and dp regions");
};

// out[r, j] = sum_d a[r, d] * b[j, d] for this warp's 16 rows r and the
// first `cols` rows j of b, in fp32. a, b: [64 x D] tiles with leading
// dimension ld_x; out: [64 x 64] with leading dimension ld_s.
template <typename T, int D>
__device__ __forceinline__ void product_abt(const T* a, const T* b, float* out, int wrow, int row,
                                            int half, int cols = kTileRows) {
  using L = BwdLayout<T, D>;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    namespace wmma = nvcuda::wmma;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
#pragma unroll
    for (int nt = 0; nt < kTileRows / 16; ++nt) {
      if (nt * 16 >= cols) break;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::load_matrix_sync(fa, a + wrow * L::ld_x + kk * 16, L::ld_x);
        // b^T as a column-major [d, j] operand: element (d, j) at b[j * ld + d]
        wmma::load_matrix_sync(fb, b + nt * 16 * L::ld_x + kk * 16, L::ld_x);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(out + wrow * L::ld_s + nt * 16, acc, L::ld_s, wmma::mem_row_major);
    }
  } else {
    const T* ar = a + row * L::ld_x;
    for (int j = half * 32; j < half * 32 + 32 && j < cols; ++j) {
      const T* br = b + j * L::ld_x;
      float acc = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) acc = fmaf(ar[d], br[d], acc);
      out[row * L::ld_s + j] = acc;
    }
  }
}

// A [16 x D] fp32 sum held in registers: this warp's 16 rows of
//   acc += a b        (kTransA false: a is [64 rows x 64], row-major)
//   acc += a^T b      (kTransA true:  a is [64 x 64 rows], so a^T's row r is a's column r)
// with b a [64 x D] tile, summed over the first `depth` of the 64 shared
// indices. bf16: wmma fragments; fp32: each lane keeps half a row.
template <typename T, int D>
struct Accum;

template <int D>
struct Accum<__nv_bfloat16, D> {
  using T = __nv_bfloat16;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> f[D / 16];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) nvcuda::wmma::fill_fragment(f[dt], 0.f);
  }

  template <bool kTransA>
  __device__ __forceinline__ void add(const T* a, int lda, const T* b, int ldb, int wrow, int,
                                      int, int depth = kTileRows) {
    namespace wmma = nvcuda::wmma;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb;
#pragma unroll
    for (int kk = 0; kk < kTileRows / 16; ++kk) {
      if (kk * 16 >= depth) break;
      if constexpr (kTransA) {
        // a^T as a column-major operand: element (r, j) at a[j * lda + r]
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::col_major> fa;
        wmma::load_matrix_sync(fa, a + kk * 16 * lda + wrow, lda);
#pragma unroll
        for (int dt = 0; dt < D / 16; ++dt) {
          wmma::load_matrix_sync(fb, b + kk * 16 * ldb + dt * 16, ldb);
          wmma::mma_sync(f[dt], fa, fb, f[dt]);
        }
      } else {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, a + wrow * lda + kk * 16, lda);
#pragma unroll
        for (int dt = 0; dt < D / 16; ++dt) {
          wmma::load_matrix_sync(fb, b + kk * 16 * ldb + dt * 16, ldb);
          wmma::mma_sync(f[dt], fa, fb, f[dt]);
        }
      }
    }
  }

  // stage[r, :] = acc * scale for this warp's rows
  __device__ __forceinline__ void store(float* stage, int ld, int wrow, int, int, float scale) {
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) {
#pragma unroll
      for (int i = 0; i < f[dt].num_elements; ++i) f[dt].x[i] *= scale;
      nvcuda::wmma::store_matrix_sync(stage + wrow * ld + dt * 16, f[dt], ld,
                                      nvcuda::wmma::mem_row_major);
    }
  }
};

template <int D>
struct Accum<float, D> {
  float f[D / 2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int d = 0; d < D / 2; ++d) f[d] = 0.f;
  }

  template <bool kTransA>
  __device__ __forceinline__ void add(const float* a, int lda, const float* b, int ldb, int,
                                      int row, int half, int depth = kTileRows) {
    const float* bh = b + half * (D / 2);
    for (int j = 0; j < depth; ++j) {
      const float aj = kTransA ? a[j * lda + row] : a[row * lda + j];
#pragma unroll
      for (int d = 0; d < D / 2; ++d) f[d] = fmaf(aj, bh[j * ldb + d], f[d]);
    }
  }

  __device__ __forceinline__ void store(float* stage, int ld, int, int row, int half,
                                        float scale) {
#pragma unroll
    for (int d = 0; d < D / 2; ++d) stage[row * ld + half * (D / 2) + d] = f[d] * scale;
  }
};

// Rows [row0, row0 + 64) of a staged [64 x D] fp32 result -> device memory
// in T, skipping rows at or past `end`.
template <typename T, int D>
__device__ __forceinline__ void write_rows(T* dst, long long row_stride, const float* stage,
                                           int ld, int row0, int end) {
  for (int i = threadIdx.x; i < kTileRows * D; i += kTileThreads) {
    const int r = i / D;
    const int c = i % D;
    if (row0 + r < end) dst[(row0 + r) * row_stride + c] = from_float<T>(stage[r * ld + c]);
  }
}

__device__ __forceinline__ float logit(float qk, float scale, const float* bias, int key) {
  return fmaf(qk, scale, bias ? bias[key] : 0.f);
}

// The dynamic shared-memory limit of `kernel`, raised to `bytes` once per
// device: `done` is the caller's static flag array, one per kernel
// instantiation (launchers of K1, K2 and K3).
constexpr int kMaxDevices = 64;

template <typename K>
cudaError_t allow_smem_once(K kernel, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

}  // namespace vtm
