// The forward tile loop of the Hopper attention kernels, shared by K1
// (flash_attention_fwd.cu), K3 (frame_attention_fwd.cu) and K5a
// (blockdiag_attention_fwd.cu) in their bf16 d = 64 case, and by the A/B
// variants T4 and T11 (ab_dense_variants.cu) and T8 and T9 (ab_chain.cu)
// through a softmax policy (Softmax below, the default, is K1's, K3's and
// K5a's), and the pair rules both directions use (the backward loop,
// wgmma_attention_bwd.cuh, walks the same rules).
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
  // Under a policy with kHeads, frame f is a head of its own: its q, k and v
  // at + f * these, its keys rows [0, frame_len) there; set by no other.
  long long q_frame_stride, k_frame_stride, v_frame_stride;
  const float* bias;  // key j's bias at bias[j] (read only by the biased instance)
  // Under kFold, key j's bias as two bf16 numbers hi[j] + lo[j] (null: none)
  const __nv_bfloat16* bias_hi;
  const __nv_bfloat16* bias_lo;
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

// Where a walk's softmax does its work: a policy, the last template argument
// of attend. K1, K3 and K5a take Softmax. The A/B kernels of
// ab_dense_variants.cu each move one step of it elsewhere, which is what
// they measure:
//   kHeads  frames are heads (T4's pair): each its own q, k, v and output
//           columns, one key bias for all; q is restaged at a frame's end
//   kOnes   the denominator is p 1, an m64n8k16 product per k-step of p v
//           against 8 columns of ones, rescaled as o is: the fp32 sum of the
//           bf16-rounded p (T11), where Softmax sums the fp32 p
//   kFold   bias and mask come through q k^T, one more k16 step of
//           [1, 1, 0...] (A, in registers) against each key's
//           [hi, lo, 0...] (B, staged with the key tile); keys past the
//           frame's end get hi = bf16(-1e30) and lo its residual, so no
//           bias is added and no mask applied (T11 v2_fold, v2_nomax)
//   kMax    a running max; without it p = exp2(x), which overflows on large
//           logits by design (v2_nomax, for measurement only)
//   kExp    p = exp(x - m); without it identity in place of exp, in natural
//           units (no log2e): p = x - m, corr = m_old - m_new, a masked key
//           p = 0, and out = o / max(|l|, 1e-6) (T8 linear); without a max
//           too, p is the logits themselves and l stays 0 (T8 nosmax). Both
//           for measurement only: they are not attention
//   kStageBias  the key bias comes with its keys: each ring stage has a
//           slot of 64 fp32 values, filled by cp.async in the tile's commit
//           group (keys past the frame's end zero-filled), and the logits
//           read the bias from it, so no device-memory load sits between
//           q k^T's wait and the max (T9 2d); without it each thread reads
//           its 16 values with __ldg after the product. The same numbers
struct Softmax {
  static constexpr bool kHeads = false, kOnes = false, kFold = false, kMax = true, kExp = true,
                        kStageBias = false;
};
struct HeadPairs : Softmax {
  static constexpr bool kHeads = true;
};
struct OnesColumn : Softmax {
  static constexpr bool kOnes = true;
};
struct FoldedBias : OnesColumn {
  static constexpr bool kFold = true;
};
struct FoldedNoMax : FoldedBias {
  static constexpr bool kMax = false;
};
struct LinearChain : Softmax {
  static constexpr bool kExp = false;
};
struct NoSoftmax : LinearChain {
  static constexpr bool kMax = false;
};
struct StagedBias : Softmax {
  static constexpr bool kStageBias = true;
};

// A policy's shared memory: WalkSmem's, then the ones (1 KB: the 8 rows of
// 128 bytes that p 1 reads as a K-major B, each k-step 32 bytes further
// along them). The fold tile, a K-major swizzled tile whose columns
// [16 s, 16 s + 16) hold ring stage s's keys' [hi, lo, 0...], shares the
// output stage: a frame's outputs pass through it after that frame's last
// products, and the next tile's columns are written after them. So a
// folded walk keeps 4 blocks an SM (50 KB each), as K1's does. kStageBias:
// after those, ring stage s's bias slot (64 fp32, 256 B) at kBiasSlots +
// 256 s; 512 B more, still 4 blocks an SM (4 x (50,688 + 1,024) B).
template <class Mode>
struct ModeSmem {
  static constexpr int kOnesBytes = Mode::kOnes ? 1024 : 0;
  static constexpr int kOnesTile = WalkSmem::kOut + kTileBytes;
  static constexpr int kFoldTile = WalkSmem::kOut;
  static constexpr int kBiasSlotBytes = kRows * 4;
  static constexpr int kBiasSlots = kOnesTile + kOnesBytes;
  static constexpr int kBiasBytes = Mode::kStageBias ? 2 * kBiasSlotBytes : 0;
  static constexpr int kLaunchBytes = WalkSmem::kLaunchBytes + kOnesBytes + kBiasBytes;
  static_assert(kBiasSlots % 16 == 0, "the bias slots take 16-byte copies");
};

template <bool kBias, class Rule, class Mode = Softmax>
__device__ __forceinline__ void attend(const Walk& w, const Rule& rule, unsigned char* smem_raw) {
  using L = WalkSmem;
  using M = ModeSmem<Mode>;
  static_assert(!(kBias && Mode::kFold), "a folded walk takes its bias through q k^T");
  // Without a max the mask has to come through q k^T, unless p is the logits
  // themselves: load_tile_async zero-fills the keys past the end, so they
  // give s = 0 exactly and add nothing to p v.
  constexpr bool kRawLogits = !Mode::kMax && !Mode::kExp;
  static_assert(Mode::kMax || Mode::kFold || kRawLogits, "without a max the mask has to come through q k^T");
  static_assert(Mode::kExp || !(kBias || Mode::kHeads || Mode::kOnes || Mode::kFold),
                "the chain's policies take no bias, no heads, no ones column");
  static_assert(!Mode::kStageBias || (kBias && !Mode::kFold && !Mode::kHeads),
                "a staged bias is the biased walk's one row of key biases, not folded, not per head");
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_addr(smem);
  const int n_tiles = (w.frame_len + kRows - 1) / kRows;  // key tiles a frame
  const int total = w.frames * n_tiles;
  const bool ragged = w.frame_len % kRows != 0;

  auto load_kv = [&](int g, int stage) {
    const uint32_t dst = base + L::kRing + 2 * stage * kTileBytes;
    if constexpr (Mode::kHeads) {
      const int f = g / n_tiles;
      const int row = (g % n_tiles) * kRows;
      load_tile_async(dst, w.k + f * w.k_frame_stride, w.k_stride, row, w.frame_len);
      load_tile_async(dst + kTileBytes, w.v + f * w.v_frame_stride, w.v_stride, row, w.frame_len);
    } else {
      const int key0 = (g / n_tiles) * w.frame_len;
      const int row = key0 + (g % n_tiles) * kRows;
      load_tile_async(dst, w.k, w.k_stride, row, key0 + w.frame_len);
      load_tile_async(dst + kTileBytes, w.v, w.v_stride, row, key0 + w.frame_len);
      if constexpr (Mode::kStageBias) {
        // the tile's 64 bias values, 16 bytes a thread (w.bias + row is
        // 16-byte aligned: the caller's part), the keys past the frame's
        // end zero-filled
        if (threadIdx.x < kRows / 4) {
          const int key = row + 4 * static_cast<int>(threadIdx.x);
          const int valid = max(0, min(4, key0 + w.frame_len - key));
          const float* src = w.bias + (valid > 0 ? key : 0);
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                           base + M::kBiasSlots + stage * M::kBiasSlotBytes + 16 * threadIdx.x),
                       "l"(src), "r"(4 * valid)
                       : "memory");
        }
      }
    }
    cp_async_commit();
  };
  load_kv(0, 0);

  // q * scale rounded to bf16, swizzled (while the first tile loads)
  auto stage_q = [&](const __nv_bfloat16* q) {
#pragma unroll
    for (int i = 0; i < kRows * 8 / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx >> 3, c = idx & 7;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (w.row0 + r < w.rows) {
        val = *reinterpret_cast<const uint4*>(q + (w.row0 + r) * w.q_stride + c * 8);
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * w.scale);
      }
      *reinterpret_cast<uint4*>(smem + L::kQ + swz(r, c)) = val;
    }
  };
  stage_q(w.q);

  // kOnes: the tile of ones. kFold: key c of tile g's frame as the pair
  // (hi, lo) in one register (threads < 64, one key each), loaded a tile
  // ahead and stored into its stage's columns of the fold tile after the
  // products; the A operand [1, 1, 0...] of the fold step in registers (the
  // A fragment's columns 0 and 1 are on the threads with l % 4 == 0).
  uint32_t fold_a[4] = {0u, 0u, 0u, 0u};
  auto fold_pair = [&](int g) -> uint32_t {
    const int c = (g % n_tiles) * kRows + static_cast<int>(threadIdx.x);
    if (c >= w.frame_len) {
      const __nv_bfloat16 hi = __float2bfloat16(kMask);
      return pack_bf16(__bfloat162float(hi), kMask - __bfloat162float(hi));
    }
    if (w.bias_hi == nullptr) return 0u;
    const long long j = static_cast<long long>(g / n_tiles) * w.frame_len + c;
    return static_cast<uint32_t>(__bfloat16_as_ushort(w.bias_hi[j])) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(w.bias_lo[j])) << 16);
  };
  auto store_fold = [&](uint32_t pair, int stage) {  // the slice's two 16-byte chunks of this key's row
    if (threadIdx.x < kRows) {
      *reinterpret_cast<uint4*>(smem + M::kFoldTile + swz(threadIdx.x, 2 * stage)) = make_uint4(pair, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(smem + M::kFoldTile + swz(threadIdx.x, 2 * stage + 1)) = make_uint4(0u, 0u, 0u, 0u);
    }
  };
  if constexpr (Mode::kOnes) {
    const uint32_t ones = pack_bf16(1.f, 1.f);
    if (threadIdx.x < M::kOnesBytes / 16)
      *reinterpret_cast<uint4*>(smem + M::kOnesTile + 16 * threadIdx.x) = make_uint4(ones, ones, ones, ones);
  }
  if constexpr (Mode::kFold) {
    if (threadIdx.x % 4 == 0) fold_a[0] = fold_a[1] = pack_bf16(1.f, 1.f);
    if (threadIdx.x < kRows) store_fold(fold_pair(0), 0);
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
  float l_ones[4] = {0.f, 0.f, 0.f, 0.f};  // kOnes: p 1, this thread's rows at [2 hh]
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  m2[0] = m2[1] = kMask;
  l[0] = l[1] = 0.f;

  for (int g = 0; g < total; ++g) {
    const int stage = g & 1;
    const int f = g / n_tiles;
    const int c0 = (g % n_tiles) * kRows;  // first key of the tile within its frame
    uint32_t fold_next = 0u;
    if (g + 1 < total) {
      load_kv(g + 1, stage ^ 1);
      if constexpr (Mode::kFold) {
        if (threadIdx.x < kRows) fold_next = fold_pair(g + 1);
      }
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
    if constexpr (Mode::kFold) mma_rs<0>(s, fold_a, desc_sw128(base + M::kFoldTile + 32 * stage), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);

    // logits in log2 units (natural ones without kExp), the bias added and
    // the mask applied where the max is taken; none of it when p is the raw
    // logits. This thread's 16 key columns: 8 j + 2 (l % 4) + c.
    const bool edge = !Mode::kFold && (Rule::kEveryTile || (ragged && c0 + kRows > w.frame_len));
    float bias_col[16];
    if constexpr (Mode::kStageBias) {
      // this thread's columns in pairs, from the stage's slot (zero past the
      // frame's end, as the edge rule below gives)
      const float* slot = reinterpret_cast<const float*>(smem + M::kBiasSlots + stage * M::kBiasSlotBytes);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 pair = *reinterpret_cast<const float2*>(slot + acc_col(4 * j));
        bias_col[2 * j] = pair.x;
        bias_col[2 * j + 1] = pair.y;
      }
    } else if constexpr (kBias) {
      const float* bias = w.bias + (Mode::kHeads ? 0LL : static_cast<long long>(f) * w.frame_len) + c0;
#pragma unroll
      for (int jc = 0; jc < 16; ++jc) {
        const int col = acc_col(4 * (jc >> 1) + (jc & 1));
        bias_col[jc] = (!edge || c0 + col < w.frame_len) ? __ldg(bias + col) : 0.f;
      }
    }
    float mx[2] = {kMask, kMask};
    auto outside = [&](int i, int hh) {
      const int key = c0 + acc_col(i);
      return key < key_lo[hh] || key >= key_hi[hh];
    };
    auto logits = [&](auto masked) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        float x = s[i];
        if constexpr (kBias) x += biased[hh] ? bias_col[2 * (i >> 2) + (i & 1)] : 0.f;
        if constexpr (Mode::kExp) x *= kLog2e;
        if constexpr (decltype(masked)::value) {
          if (outside(i, hh)) x = kMask;
        }
        s[i] = x;
        mx[hh] = fmaxf(mx[hh], x);
      }
    };
    if constexpr (!kRawLogits) {
      if (edge) {
        logits(std::true_type());
      } else {
        logits(std::false_type());
      }
    }
    if constexpr (Mode::kMax) {
      float corr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float m_new = fmaxf(m2[hh], mx[hh]);
        if constexpr (Mode::kExp) {
          corr[hh] = fast_exp2(m2[hh] - m_new);
        } else {
          corr[hh] = m2[hh] - m_new;  // the first tile's, about -1e30, scales o = 0, l = 0 to -0
        }
        m2[hh] = m_new;
        if constexpr (Mode::kOnes) {
          l_ones[2 * hh] *= corr[hh];
          l_ones[2 * hh + 1] *= corr[hh];
        } else {
          l[hh] *= corr[hh];
        }
      }
      if constexpr (Mode::kExp) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int hh = (i >> 1) & 1;
          s[i] = fast_exp2(s[i] - m2[hh]);
          if constexpr (!Mode::kOnes) l[hh] += s[i];
          o[i] *= corr[hh];
        }
      } else {
        // identity in place of exp: p = x - m_new, and a masked key (x =
        // kMask) weighs nothing
        auto differences = [&](auto masked) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int hh = (i >> 1) & 1;
            s[i] -= m2[hh];
            if constexpr (decltype(masked)::value) {
              if (outside(i, hh)) s[i] = 0.f;
            }
            l[hh] += s[i];
            o[i] *= corr[hh];
          }
        };
        if (edge) {
          differences(std::true_type());
        } else {
          differences(std::false_type());
        }
      }
    } else if constexpr (Mode::kExp) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = fast_exp2(s[i]);
    }
    uint32_t p_lo[16];
    to_a_fragment(s, p_lo);

    fence_regs(o);
    fence_regs(p_lo);
    if constexpr (Mode::kOnes) fence_regs(l_ones);
    wg_fence();
    product_rs(o, p_lo, k_tile + kTileBytes, true);
    if constexpr (Mode::kOnes) {
#pragma unroll
      for (int k = 0; k < 4; ++k) mma_rs_n8(l_ones, p_lo + 4 * k, desc_sw128(base + M::kOnesTile + 32 * k), 1);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    if constexpr (Mode::kOnes) fence_regs(l_ones);

    const bool frame_end = c0 + kRows >= w.frame_len;
    if (frame_end) {
      // the frame's end: out_f = o / l, then a fresh softmax for the next frame
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if constexpr (Mode::kOnes) {
          l[hh] = l_ones[2 * hh];  // every column of p 1 is the row's sum
        } else {
          l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
          l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
        }
      }
      if constexpr (Mode::kExp) {
        if (w.lse != nullptr && threadIdx.x % 4 == 0) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = w.row0 + rows_of[hh];
            const float m = Mode::kMax ? m2[hh] : 0.f;
            if (row < w.rows) w.lse[f * w.lse_frame_stride + row] = (m + log2f(l[hh])) * kLn2;
          }
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) l[hh] = 1.f / l[hh];
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] *= l[(i >> 1) & 1];
      } else {
        // the chain's division rule: l may be negative or near 0 (linear)
        // or 0 (nosmax)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) l[hh] = fmaxf(fabsf(l[hh]), 1e-6f);
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] /= l[(i >> 1) & 1];
      }
      store_tile(o, 1.f, smem + L::kOut, w.out + f * w.out_frame_stride, w.out_stride, w.row0, w.rows);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      m2[0] = m2[1] = kMask;
      l[0] = l[1] = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) l_ones[i] = 0.f;
      if constexpr (Mode::kHeads) {
        // the next head's q: store_tile's barrier has every warp past this
        // frame's products, and the barriers below come before the next
        if (f + 1 < w.frames) {
          stage_q(w.q + (f + 1) * w.q_frame_stride);
          fence_async_shared();
        }
      }
    }
    if constexpr (Mode::kFold) {
      if (g + 1 < total) {
        if (frame_end) __syncthreads();  // store_tile's last reads of the stage the fold tile shares
        store_fold(fold_next, stage ^ 1);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
}

}  // namespace wg
}  // namespace vtm
