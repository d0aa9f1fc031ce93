// Tile helpers shared by the attention kernels of this directory
// (flash_attention_fwd.cu, flash_attention_bwd.cu, frame_attention_fwd.cu):
// dtype conversion and the 16-byte staging of a 64-row tile of q, k, v or
// do into shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace vtm {

constexpr int kTileRows = 64;     // rows of every staged q, k or v tile
constexpr int kTileThreads = 128; // 4 warps stage a tile together

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

}  // namespace vtm
