// The backward tile loop of the Hopper attention kernels, shared by K2
// (flash_attention_bwd.cu), K4 (frame_attention_bwd.cu) and K5b
// (blockdiag_attention_bwd.cu) in their bf16 d = 64 case: the gradients of
//   out_f = softmax(q k_f^T * scale + bias_f) v_f       for each frame f
// given do_f and the forward's residuals, out_f and lse_f (the natural-log
// log-sum-exp of each row's logits in frame f, which the forward loop of
// wgmma_attention.cuh writes). Per 64 x 64 tile pair:
//   s  = (q k^T) * scale + bias          fp32, from the unscaled q
//   p  = exp(s - lse)                    fp32, in log2 units
//   dp = do v^T,  ds = p (dp - delta),  delta = rowsum(do_f * out_f)
//   dq += ds_lo k,  dk += ds_lo^T q,  dv += p_lo^T do,  dbias += ds
// with p_lo, ds_lo rounded to bf16 in registers, fp32 sums cast once.
//
// Two loops, one block of one warpgroup (128 threads) each, no atomics:
//   * attend_bwd_dq: the block owns 64 query rows and walks F frames of
//     frame_len keys, summing dq over every frame in registers. In each
//     frame's first tile it takes the frame's do tile (two slots, by frame
//     parity, so the next frame's tile loads while this one is read), its
//     lse and delta = rowsum(do_f * out_f), which it computed while that
//     do tile was in flight and also writes to a scratch for the dk/dv
//     loop. Three products a tile pair: s, dp, dq += ds k.
//   * attend_bwd_dkdv: the block owns 64 keys of one frame and walks that
//     frame's query tiles with their do tiles, lse and delta, computing
//     s^T = k q^T and dp^T = v do^T so that p^T and ds^T sit in the
//     accumulators of their key rows: rounded to bf16 in registers, they
//     are the A operands of dv += p^T do and dk += ds^T q, and the dbias
//     sums are row sums in registers. Four products a tile pair.
// Streamed tiles (k, v for dq; q, do for dk/dv) pass through a two-stage
// cp.async ring, so the next tile's copy overlaps this tile's products.
// S, dP, P and dS never reach shared memory. Masks run only where they can
// bite, chosen once a tile (warp-uniform, so no wgmma sits in a divergent
// branch): keys past a frame's end on its ragged last tile (dq), the pair
// windows of packed frames on every tile, and the row that takes no bias
// under exclude_first_row (dk/dv: on the query tile that holds it).
// Queries past the walk's rows have lse = +inf in the dk/dv loop (p = 0),
// and are neither stored nor summed.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "attention_tiles.cuh"
#include "wgmma_attention.cuh"
#include "wgmma_tiles.cuh"

namespace vtm {
namespace wg {

// What one backward block walks. Query rows of q, do, out, lse, delta and
// dq count from their pointers; keys of k, v, bias, dk, dv and dbias from
// theirs: all already offset to the block's (b, h) slice and its first
// frame. Strides are in elements and the last dim is contiguous. The dk/dv
// loop walks one frame: its key pointers and do, lse and delta are given
// at that frame.
struct BwdWalk {
  const __nv_bfloat16 *q, *k, *v, *go, *out;
  long long q_stride, k_stride, v_stride, go_stride, out_stride;
  long long go_frame_stride, out_frame_stride;  // frame f's do and out at + f * stride
  const float* bias;  // key j's bias at bias[j] (read only by the biased instances)
  const float* lse;   // row r, frame f at lse[f * row_frame_stride + r]
  float* delta;       // the same layout: written by the dq loop, read by the dk/dv loop
  long long row_frame_stride;
  __nv_bfloat16 *dq, *dk, *dv;
  long long dq_stride, dk_stride, dv_stride;
  float* dbias;       // key j's column sum at dbias[j], or null
  int row0;           // dq: the block's first query row
  int rows;           // queries at or past this are zero-filled and not stored
  int key0;           // dk/dv: the block's first key within its frame
  int frames;         // dq: frame f holds keys [f * frame_len, (f + 1) * frame_len)
  int frame_len;
  float scale;
};

// The walk of slice bh = b * H + h from row (and key) `row0` on, as every
// backward's Args lay it out: q, k, v, do, out, dq, dk, dv through their
// (batch, head, row) strides; the bias [B, N] and dbias [B, H, N]; lse and
// delta [B, H, frames, N]. The dq loop walks `frames` frames of
// `frame_len` keys and stops at `rows` rows; the kernel sets the block's
// own row0 or key0 and, where do and out have frames, their frame strides.
template <class Args>
__device__ __forceinline__ BwdWalk slice_walk(const Args& p, int bh, long long row0, int frames, int frame_len,
                                              int rows) {
  const int b = bh / p.num_heads;
  const int h = bh % p.num_heads;
  const long long residuals = static_cast<long long>(bh) * frames * p.n + row0;
  BwdWalk w;
  w.q = p.q + b * p.st.q[0] + h * p.st.q[1] + row0 * p.st.q[2];
  w.k = p.k + b * p.st.k[0] + h * p.st.k[1] + row0 * p.st.k[2];
  w.v = p.v + b * p.st.v[0] + h * p.st.v[1] + row0 * p.st.v[2];
  w.go = p.go + b * p.st.go[0] + h * p.st.go[1] + row0 * p.st.go[2];
  w.out = p.out + b * p.st.o[0] + h * p.st.o[1] + row0 * p.st.o[2];
  w.q_stride = p.st.q[2];
  w.k_stride = p.st.k[2];
  w.v_stride = p.st.v[2];
  w.go_stride = p.st.go[2];
  w.out_stride = p.st.o[2];
  w.go_frame_stride = w.out_frame_stride = 0;
  w.bias = p.key_bias ? p.key_bias + static_cast<long long>(b) * p.n + row0 : nullptr;
  w.lse = p.lse + residuals;
  w.delta = p.delta + residuals;
  w.row_frame_stride = p.n;
  w.dq = p.dq + b * p.st.dq[0] + h * p.st.dq[1] + row0 * p.st.dq[2];
  w.dk = p.dk + b * p.st.dk[0] + h * p.st.dk[1] + row0 * p.st.dk[2];
  w.dv = p.dv + b * p.st.dv[0] + h * p.st.dv[1] + row0 * p.st.dv[2];
  w.dq_stride = p.st.dq[2];
  w.dk_stride = p.st.dk[2];
  w.dv_stride = p.st.dv[2];
  w.dbias = p.dbias ? p.dbias + static_cast<long long>(bh) * p.n + row0 : nullptr;
  w.row0 = w.key0 = 0;
  w.rows = rows;
  w.frames = frames;
  w.frame_len = frame_len;
  w.scale = p.scale;
  return w;
}

// Shared memory of both loops: two resident tiles, the ring's two stages
// of two streamed tiles, 1 KB of per-row values ([2][2][64] floats), and for
// the dq loop over several frames a second do slot; 1 KB more for the
// 1024-byte alignment the swizzle needs.
struct BwdSmem {
  static constexpr int kResident0 = 0;                  // q (dq) / k (dk, dv)
  static constexpr int kResident1 = kTileBytes;         // do of even frames (dq) / v (dk, dv)
  static constexpr int kRing = 2 * kTileBytes;          // stage s: two tiles at kRing + 2 s tiles
  static constexpr int kRowValues = kRing + 4 * kTileBytes;
  static constexpr int kOddDo = kRowValues + 2 * 2 * 64 * 4;  // do of odd frames (dq)
  static constexpr int kLaunchBytes = kOddDo + 1024;          // one frame
  static constexpr int kFramesLaunchBytes = kOddDo + kTileBytes + 1024;
};

__device__ __forceinline__ uint32_t bwd_ring(uint32_t base, int stage, int which) {
  return base + BwdSmem::kRing + (2 * stage + which) * kTileBytes;
}

// delta = rowsum(do * out) of query row `qrow` as row_delta<bf16, 64>
// (attention_tiles.cuh) takes it: the same products summed in the same
// order, so the same bits; but this lane's 64 bytes of each row come in
// eight 16-byte loads issued together, one memory latency where the scalar
// loop waits for four. 0 at or past `end`.
__device__ __forceinline__ float row_delta_64(const __nv_bfloat16* go, long long go_stride,
                                              const __nv_bfloat16* out, long long o_stride, int qrow,
                                              int end, int half) {
  float acc = 0.f;
  if (qrow < end) {
    const uint4* g = reinterpret_cast<const uint4*>(go + qrow * go_stride + half * 32);
    const uint4* o = reinterpret_cast<const uint4*>(out + qrow * o_stride + half * 32);
    uint4 gv[4], ov[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      gv[i] = g[i];
      ov[i] = o[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat16* ge = reinterpret_cast<const __nv_bfloat16*>(&gv[i]);
      const __nv_bfloat16* oe = reinterpret_cast<const __nv_bfloat16*>(&ov[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc = fmaf(__bfloat162float(ge[j]), __bfloat162float(oe[j]), acc);
    }
  }
  return acc + __shfl_xor_sync(0xffffffffu, acc, 1);
}

template <bool kBias, class Rule>
__device__ __forceinline__ void attend_bwd_dq(const BwdWalk& w, const Rule& rule, unsigned char* smem_raw) {
  using L = BwdSmem;
  using bf16 = __nv_bfloat16;
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_addr(smem);
  // [frame parity][lse in log2 units, delta][64 rows]
  float* rows_s = reinterpret_cast<float*>(smem + L::kRowValues);
  const int tid = threadIdx.x;
  const int n_tiles = (w.frame_len + kRows - 1) / kRows;  // key tiles a frame
  const int total = w.frames * n_tiles;
  const bool ragged = w.frame_len % kRows != 0;

  auto do_tile = [&](int f) { return base + ((f & 1) ? L::kOddDo : L::kResident1); };
  auto load_kv = [&](int g, int stage) {
    const int key0 = (g / n_tiles) * w.frame_len;
    const int row = key0 + (g % n_tiles) * kRows;
    load_tile_async(bwd_ring(base, stage, 0), w.k, w.k_stride, row, key0 + w.frame_len);
    load_tile_async(bwd_ring(base, stage, 1), w.v, w.v_stride, row, key0 + w.frame_len);
  };
  auto load_do = [&](int f) {
    load_tile_async(do_tile(f), w.go + f * w.go_frame_stride, w.go_stride, w.row0, w.rows);
  };
  // frame f's residuals of row tid / 2: the even lane its delta (also to the
  // scratch), the odd lane its lse in log2 units (loaded first, so that its
  // latency overlaps the delta's loads)
  auto frame_rows = [&](int f) {
    const int r = tid >> 1;
    const int qrow = w.row0 + r;
    const float lse = ((tid & 1) && qrow < w.rows) ? w.lse[f * w.row_frame_stride + qrow] : 0.f;
    const float d = row_delta_64(w.go + f * w.go_frame_stride, w.go_stride, w.out + f * w.out_frame_stride,
                                 w.out_stride, qrow, w.rows, tid & 1);
    float* dst = rows_s + (f & 1) * 128;
    if ((tid & 1) == 0) {
      dst[64 + r] = d;
      if (qrow < w.rows) w.delta[f * w.row_frame_stride + qrow] = d;
    } else {
      dst[r] = lse * kLog2e;
    }
  };

  load_tile_async(base + L::kResident0, w.q, w.q_stride, w.row0, w.rows);
  load_do(0);
  load_kv(0, 0);
  cp_async_commit();
  frame_rows(0);

  // this thread's two accumulator rows, r0 and r0 + 8: their bias and the
  // keys that reach them
  const int r0 = acc_row(0);
  int key_lo[2], key_hi[2];
  bool biased[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = w.row0 + r0 + 8 * hh;
    biased[hh] = rule.biased(row);
    const int2 win = rule.window(row);
    key_lo[hh] = win.x;
    key_hi[hh] = min(win.y, w.frame_len);
  }
  const float scale2 = w.scale * kLog2e;

  float dq[32], lse2[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};  // the frame's, set at its first tile
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;

  for (int g = 0; g < total; ++g) {
    const int stage = g & 1;
    const int f = g / n_tiles;
    const int c0 = (g % n_tiles) * kRows;  // first key of the tile within its frame
    if (g + 1 < total) {
      load_kv(g + 1, stage ^ 1);
      const bool next_frame = (g + 1) % n_tiles == 0;
      if (next_frame) load_do(f + 1);
      cp_async_commit();
      if (next_frame) frame_rows(f + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();
    if (c0 == 0) {
      const float* src = rows_s + (f & 1) * 128;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        lse2[hh] = src[r0 + 8 * hh];
        delta_r[hh] = src[64 + r0 + 8 * hh];
      }
    }

    const uint32_t k_tile = bwd_ring(base, stage, 0);
    float s[32], dp[32];
    fence_regs(s);
    fence_regs(dp);
    wg_fence();
    product_ss(s, base + L::kResident0, k_tile);
    product_ss(dp, do_tile(f), bwd_ring(base, stage, 1));
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // ds = p (dp - delta), p = exp2(s scale log2e + bias log2e - lse log2e).
    // This thread's 16 key columns: 8 j + 2 (l % 4) + c.
    const bool edge = Rule::kEveryTile || (ragged && c0 + kRows > w.frame_len);
    float bias2[16];
    if constexpr (kBias) {
      const float* bias = w.bias + static_cast<long long>(f) * w.frame_len + c0;
#pragma unroll
      for (int jc = 0; jc < 16; ++jc) {
        const int col = acc_col(4 * (jc >> 1) + (jc & 1));
        bias2[jc] = (!edge || c0 + col < w.frame_len) ? __ldg(bias + col) * kLog2e : 0.f;
      }
    }
    auto grads = [&](auto masked) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        float b2 = 0.f;
        if constexpr (kBias) b2 = biased[hh] ? bias2[2 * (i >> 2) + (i & 1)] : 0.f;
        float prob = fast_exp2(fmaf(s[i], scale2, b2) - lse2[hh]);
        if constexpr (decltype(masked)::value) {
          const int key = c0 + acc_col(i);
          if (key < key_lo[hh] || key >= key_hi[hh]) prob = 0.f;
        }
        dp[i] = prob * (dp[i] - delta_r[hh]);
      }
    };
    if (edge) {
      grads(std::true_type());
    } else {
      grads(std::false_type());
    }
    uint32_t ds_lo[16];
    to_a_fragment(dp, ds_lo);

    fence_regs(dq);
    fence_regs(ds_lo);
    wg_fence();
    product_rs(dq, ds_lo, k_tile, true);
    wg_commit();
    wg_wait<0>();
    fence_regs(dq);
    __syncthreads();  // every warp is done with this stage (and do slot) before it is refilled
  }
  store_tile(dq, w.scale, smem + L::kResident0, w.dq, w.dq_stride, w.row0, w.rows);
}

template <bool kBias, class Rule>
__device__ __forceinline__ void attend_bwd_dkdv(const BwdWalk& w, const Rule& rule, unsigned char* smem_raw) {
  using L = BwdSmem;
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t base = smem_addr(smem);
  float* rows_s = reinterpret_cast<float*>(smem + L::kRowValues);  // [stage][lse, delta][64]
  const int tid = threadIdx.x;
  const int n_tiles = (w.rows + kRows - 1) / kRows;  // query tiles

  // the q tile's lse (in log2 units; +inf past the rows, so p = 0 there) and delta
  auto load_rows = [&](int stage, int q0) {
    const int r = tid & 63;
    const int qrow = q0 + r;
    float* dst = rows_s + stage * 128 + (tid >> 6) * 64;
    if (tid < 64) {
      dst[r] = qrow < w.rows ? w.lse[qrow] * kLog2e : INFINITY;
    } else {
      dst[r] = qrow < w.rows ? w.delta[qrow] : 0.f;
    }
  };

  load_tile_async(base + L::kResident0, w.k, w.k_stride, w.key0, w.frame_len);
  load_tile_async(base + L::kResident1, w.v, w.v_stride, w.key0, w.frame_len);
  load_tile_async(bwd_ring(base, 0, 0), w.q, w.q_stride, 0, w.rows);
  load_tile_async(bwd_ring(base, 0, 1), w.go, w.go_stride, 0, w.rows);
  cp_async_commit();
  load_rows(0, 0);

  // this thread's two accumulator rows are keys r0 and r0 + 8: their bias,
  // and the queries that reach them (the rules' windows are symmetric)
  const int r0 = acc_row(0);
  float bias2[2];
  int row_lo[2], row_hi[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = w.key0 + r0 + 8 * hh;
    bias2[hh] = (kBias && key < w.frame_len) ? w.bias[key] * kLog2e : 0.f;
    const int2 win = rule.window(key);
    row_lo[hh] = win.x;
    row_hi[hh] = min(win.y, w.rows);
  }
  const float scale2 = w.scale * kLog2e;

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  float db[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    const int q0 = t * kRows;
    if (t + 1 < n_tiles) {
      load_tile_async(bwd_ring(base, stage ^ 1, 0), w.q, w.q_stride, q0 + kRows, w.rows);
      load_tile_async(bwd_ring(base, stage ^ 1, 1), w.go, w.go_stride, q0 + kRows, w.rows);
      cp_async_commit();
      load_rows(stage ^ 1, q0 + kRows);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();

    // s^T = k q^T and dp^T = v do^T: rows are this block's keys, columns queries
    float s[32], dp[32];
    fence_regs(s);
    fence_regs(dp);
    wg_fence();
    product_ss(s, base + L::kResident0, bwd_ring(base, stage, 0));
    product_ss(dp, base + L::kResident1, bwd_ring(base, stage, 1));
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const float* lse_s = rows_s + stage * 128;
    const float* delta_s = lse_s + 64;
    // masked: a query outside a key's window weighs nothing, and the first
    // row of a window takes no bias and adds nothing to dbias
    const bool edge = Rule::kEveryTile || (kBias && rule.skips_first_row() && q0 == 0);
    auto grads = [&](auto masked) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = acc_col(i);
        const int hh = (i >> 1) & 1;
        float b2 = bias2[hh];
        bool biased_col = true, reaches = true;
        if constexpr (decltype(masked)::value) {
          const int col = q0 + c;
          reaches = col >= row_lo[hh] && col < row_hi[hh];
          biased_col = !(rule.skips_first_row() && col == row_lo[hh]);
          if (!biased_col) b2 = 0.f;
        }
        float prob = fast_exp2(fmaf(s[i], scale2, b2) - lse_s[c]);
        if (!reaches) prob = 0.f;
        const float ds = prob * (dp[i] - delta_s[c]);
        if (biased_col) db[hh] += ds;
        s[i] = prob;
        dp[i] = ds;
      }
    };
    if (edge) {
      grads(std::true_type());
    } else {
      grads(std::false_type());
    }
    uint32_t p_lo[16], ds_lo[16];
    to_a_fragment(s, p_lo);
    to_a_fragment(dp, ds_lo);

    // dv += p^T do, dk += ds^T q: do and q read transposed (MN-major)
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(p_lo);
    fence_regs(ds_lo);
    wg_fence();
    product_rs(dv, p_lo, bwd_ring(base, stage, 1), true);
    product_rs(dk, ds_lo, bwd_ring(base, stage, 0), true);
    wg_commit();
    wg_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  if (kBias && w.dbias != nullptr) {
    // a key row's sum is spread over the four lanes of a quad
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float x = db[hh];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      const int key = w.key0 + r0 + 8 * hh;
      if ((tid & 3) == 0 && key < w.frame_len) w.dbias[key] = x;
    }
  }
  store_tile(dk, w.scale, smem + L::kRing, w.dk, w.dk_stride, w.key0, w.frame_len);
  store_tile(dv, 1.f, smem + L::kRing + kTileBytes, w.dv, w.dv_stride, w.key0, w.frame_len);
}

}  // namespace wg
}  // namespace vtm
