// The forward tile loop of the Hopper attention kernels, shared by K1
// (flash_attention_fwd.cu), K3 (frame_attention_fwd.cu) and K5a
// (blockdiag_attention_fwd.cu) in their bf16 d = 64 case, and the pair
// rules both directions use (the backward loop, wgmma_attention_bwd.cuh,
// walks the same rules).
//
// A block of one warpgroup (128 threads) owns 64 query rows and walks the
// keys of one or more frames, each frame with a softmax of its own. Per
// 64-key tile:
//   * k and v come through a two-stage ring filled by cp.async: the next
//     tile, of this frame or the next, is in flight while this one is used.
//   * S = (q * scale) k^T is a wgmma product with fp32 accumulators in
//     registers. The key bias is added, and the mask applied, where the
//     running max is taken, in log2 units; p = exp2(x - m), rounded to bf16
//     in registers, is the A operand of o += p v (v read transposed from
//     shared memory).
//   * The mask is evaluated only where it can bite: on a frame's ragged last
//     tile (keys past the frame's end), or on every tile under a rule that
//     masks pairs inside a frame (K5a's packed frames).
// At a frame's end o / l leaves through a swizzled bf16 stage with 16-byte
// stores, with the row's natural-log log-sum-exp (m + log2 l) ln 2 when
// asked for (one per row and frame: the backward's residual), and the
// running max and denominator restart.
//
// Rounding: q * scale is rounded to bf16 before q k^T, as the plain
// versions do; the unnormalised p (each <= 1 against the running max) is
// rounded to bf16 and the fp32 sum divided at the end, where the TPU
// kernels round the normalised p. Both sit within bf16's rounding of the
// fp32 result.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "attention_tiles.cuh"
#include "wgmma_tiles.cuh"

namespace vtm {
namespace wg {

constexpr float kLn2 = 0.6931471805599453f;

// What one block walks. Rows of q and out, and keys of k, v and bias, count
// from the pointers given, already offset to the block's (b, h) slice and
// first frame; strides are in elements and the last dim is contiguous.
struct Walk {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  long long q_stride, k_stride, v_stride;
  const float* bias;  // key j's bias at bias[j] (read only by the biased instance)
  __nv_bfloat16* out;
  long long out_stride, out_frame_stride;  // frame f's output at out + f * out_frame_stride
  float* lse;         // row r's log-sum-exp in frame f at lse[f * lse_frame_stride + r], or null
  long long lse_frame_stride;
  int row0;           // the block's first query row
  int rows;           // rows at or past this are zero-filled and not stored
  int frames;         // frame f holds keys [f * frame_len, (f + 1) * frame_len)
  int frame_len;
  float scale;
};

// The pair rule of a walk: window(r) is the range [lo, hi) of the frame's
// keys that reach row r, biased(r) whether row r takes the bias; rows and
// keys count from the frame's first. kEveryTile rules are applied on every
// tile; the others only on a frame's ragged last tile, where keys past the
// frame's end are dropped. Windows are symmetric (row r reaches key c iff
// row c's window holds r), so the backward's key tiles read window(c) as
// the queries that reach key c. skips_first_row(): the first row of each
// window takes no bias (TimeSformer's CLS query under exclude_first_row).
struct AllPairs {
  static constexpr bool kEveryTile = false;
  __device__ __forceinline__ int2 window(int) const { return make_int2(0, 0x7fffffff); }
  __device__ __forceinline__ bool biased(int) const { return true; }
  __device__ __forceinline__ bool skips_first_row() const { return false; }
};

// One frame's rows (K5a and K5b at frames of more than 32 tokens): every
// key of the frame reaches every row; row 0 skips the bias under
// exclude_first_row.
struct FrameRows {
  static constexpr bool kEveryTile = false;
  bool exclude_first_row;
  __device__ __forceinline__ int2 window(int) const { return make_int2(0, 0x7fffffff); }
  __device__ __forceinline__ bool biased(int r) const { return !(exclude_first_row && r == 0); }
  __device__ __forceinline__ bool skips_first_row() const { return exclude_first_row; }
};

// Whole frames of s_len tokens packed into one tile (K5a and K5b at s <=
// 32): row r sees the keys of its own frame only, and row 0 of each frame
// skips the bias under exclude_first_row. One division a row (a division a
// pair cost about 5 us a call at s = 10, PERF.md).
struct PackedFrames {
  static constexpr bool kEveryTile = true;
  int s_len;
  bool exclude_first_row;
  __device__ __forceinline__ int2 window(int r) const {
    const int lo = r / s_len * s_len;
    return make_int2(lo, lo + s_len);
  }
  __device__ __forceinline__ bool biased(int r) const { return !(exclude_first_row && r % s_len == 0); }
  __device__ __forceinline__ bool skips_first_row() const { return exclude_first_row; }
};

// K5a's and K5b's launch plan (ops/flash_attention.py::blockdiag_plan):
// frames_per_block > 1 packs whole frames into one tile, and then
// tiles_per_frame is 1; otherwise a block is tile blockIdx.x %
// tiles_per_frame of frame blockIdx.x / tiles_per_frame. The same plan
// gives the backward's query tiles (dq) and key tiles (dk, dv).
struct BlockdiagPlan {
  int frames_per_block, tiles_per_frame, blocks;

  // every frame's every row exactly once
  bool covers(int frames, int s_len) const {
    const int g = frames_per_block;
    if (g > 1) return g * s_len <= kRows && tiles_per_frame == 1 && blocks == (frames + g - 1) / g;
    return g == 1 && tiles_per_frame == (s_len + kRows - 1) / kRows &&
           static_cast<long long>(blocks) == static_cast<long long>(frames) * tiles_per_frame;
  }
};

// Shared memory of a walk: the q tile, the ring's two stages of (k, v), the
// output stage; 1 KB more for the 1024-byte alignment the swizzle needs.
struct WalkSmem {
  static constexpr int kQ = 0;
  static constexpr int kRing = kTileBytes;  // stage s: k, v at kRing + 2 s tiles
  static constexpr int kOut = kRing + 4 * kTileBytes;
  static constexpr int kLaunchBytes = kOut + kTileBytes + 1024;
};

template <bool kBias, class Rule>
__device__ __forceinline__ void attend(const Walk& w, const Rule& rule, unsigned char* smem_raw) {
  using L = WalkSmem;
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_addr(smem);
  const int n_tiles = (w.frame_len + kRows - 1) / kRows;  // key tiles a frame
  const int total = w.frames * n_tiles;
  const bool ragged = w.frame_len % kRows != 0;

  auto load_kv = [&](int g, int stage) {
    const int key0 = (g / n_tiles) * w.frame_len;
    const int row = key0 + (g % n_tiles) * kRows;
    const uint32_t dst = base + L::kRing + 2 * stage * kTileBytes;
    load_tile_async(dst, w.k, w.k_stride, row, key0 + w.frame_len);
    load_tile_async(dst + kTileBytes, w.v, w.v_stride, row, key0 + w.frame_len);
    cp_async_commit();
  };
  load_kv(0, 0);

  // q * scale rounded to bf16, swizzled, while the first tile loads
#pragma unroll
  for (int i = 0; i < kRows * 8 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 3, c = idx & 7;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (w.row0 + r < w.rows) {
      val = *reinterpret_cast<const uint4*>(w.q + (w.row0 + r) * w.q_stride + c * 8);
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * w.scale);
    }
    *reinterpret_cast<uint4*>(smem + L::kQ + swz(r, c)) = val;
  }
  fence_async_shared();

  // the two rows this thread holds: their bias and the keys that reach them
  int rows_of[2], key_lo[2], key_hi[2];
  bool biased[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    rows_of[hh] = acc_row(2 * hh);
    biased[hh] = rule.biased(w.row0 + rows_of[hh]);
    const int2 win = rule.window(w.row0 + rows_of[hh]);
    key_lo[hh] = win.x;
    key_hi[hh] = min(win.y, w.frame_len);
  }

  float o[32], m2[2], l[2];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  m2[0] = m2[1] = kMask;
  l[0] = l[1] = 0.f;

  for (int g = 0; g < total; ++g) {
    const int stage = g & 1;
    const int f = g / n_tiles;
    const int c0 = (g % n_tiles) * kRows;  // first key of the tile within its frame
    if (g + 1 < total) {
      load_kv(g + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();

    const uint32_t k_tile = base + L::kRing + 2 * stage * kTileBytes;
    float s[32];
    fence_regs(s);
    wg_fence();
    product_ss(s, base + L::kQ, k_tile);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);

    // logits in log2 units, the bias added and the mask applied where the
    // max is taken. This thread's 16 key columns: 8 j + 2 (l % 4) + c.
    const bool edge = Rule::kEveryTile || (ragged && c0 + kRows > w.frame_len);
    float bias_col[16];
    if constexpr (kBias) {
      const float* bias = w.bias + static_cast<long long>(f) * w.frame_len + c0;
#pragma unroll
      for (int jc = 0; jc < 16; ++jc) {
        const int col = acc_col(4 * (jc >> 1) + (jc & 1));
        bias_col[jc] = (!edge || c0 + col < w.frame_len) ? __ldg(bias + col) : 0.f;
      }
    }
    float mx[2] = {kMask, kMask};
    auto logits = [&](auto masked) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        float x = s[i];
        if constexpr (kBias) x += biased[hh] ? bias_col[2 * (i >> 2) + (i & 1)] : 0.f;
        x *= kLog2e;
        if constexpr (decltype(masked)::value) {
          const int key = c0 + acc_col(i);
          if (key < key_lo[hh] || key >= key_hi[hh]) x = kMask;
        }
        s[i] = x;
        mx[hh] = fmaxf(mx[hh], x);
      }
    };
    if (edge) {
      logits(std::true_type());
    } else {
      logits(std::false_type());
    }
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m2[hh], mx[hh]);
      corr[hh] = fast_exp2(m2[hh] - m_new);
      m2[hh] = m_new;
      l[hh] *= corr[hh];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      s[i] = fast_exp2(s[i] - m2[hh]);
      l[hh] += s[i];
      o[i] *= corr[hh];
    }
    uint32_t p_lo[16];
    to_a_fragment(s, p_lo);

    fence_regs(o);
    fence_regs(p_lo);
    wg_fence();
    product_rs(o, p_lo, k_tile + kTileBytes, true);
    wg_commit();
    wg_wait<0>();
    fence_regs(o);

    if (c0 + kRows >= w.frame_len) {
      // the frame's end: out_f = o / l, then a fresh softmax for the next frame
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
        l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      }
      if (w.lse != nullptr && threadIdx.x % 4 == 0) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = w.row0 + rows_of[hh];
          if (row < w.rows) w.lse[f * w.lse_frame_stride + row] = (m2[hh] + log2f(l[hh])) * kLn2;
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l[hh] = 1.f / l[hh];
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= l[(i >> 1) & 1];
      store_tile(o, 1.f, smem + L::kOut, w.out + f * w.out_frame_stride, w.out_stride, w.row0, w.rows);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      m2[0] = m2[1] = kMask;
      l[0] = l[1] = 0.f;
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
}

}  // namespace wg
}  // namespace vtm
