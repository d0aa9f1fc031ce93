// Block-diagonal (per-frame) attention backward for Hopper (sm_90a): the
// gradients of
//   out[b, f*s + i, h, :] = softmax_j(q_i k_j^T * scale + m_i * key_bias[b, f*s + j]) v_j
// (i, j in [0, s): the queries of frame f attend only to the keys of frame
// f; the row mask m_i is 1, or with exclude_first_row m_0 = 0) with respect
// to q, k, v and key_bias, given do = d(loss)/d(out), token-major
// [B, F*s, H*d] and read through its strides, and the forward's residuals:
// out itself (the same layout) and lse, fp32 [B, H, F*s], the log-sum-exp
// of each row's logits, which K5a (blockdiag_attention_fwd.cu) writes when
// a gradient is wanted.
//
// Replaces the Pallas TPU kernel of vtm/ops/flash_attention.py::
// _blockdiag_backward (kernel _make_blockdiag_bwd_kernel, the custom_vjp of
// tome_blockdiag_attention). Its math and rounding points, per
// (b, h, frame), with the row statistics taken from the residuals:
//   s  = (q k^T) * scale + m * bias      fp32, from the unscaled q
//   p  = exp(s - lse)                    fp32, normalised by the saved lse
//   dp = do v^T                          fp32
//   delta = rowsum(do * out),  ds = p * (dp - delta)
//   dq = scale * (ds_lo k)               ds_lo, p_lo: ds, p rounded to the
//   dk = scale * (ds_lo^T q)             input dtype before the products;
//   dv = p_lo^T do                       fp32 sums, cast once at the end
//   dbias[b, h, key] = sum over the queries the bias reached (m_i = 1) of
//                      the unrounded ds
// delta = rowsum(do * out) equals the TPU kernel's rowsum(p * dp) since
// out = p v. The sum of dbias over heads is left to the caller.
//
// What bounds it on the H100: at B8 H12 d64 F8 s197 the five products are
// 10*B*H*F*s^2*d = 19 GFLOP against about 155 MB of q/k/v/do/out/dq/dk/dv
// and the lse, about 125 FLOP per byte: below the card's ~295 FLOP/byte
// bf16 ridge, so device memory bounds it (0.046 ms) as long as no [s, s]
// tile leaves the chip; the merged layers (s = 179 ... 10) more so.
//
// Design. The TPU program holds a whole frame's [s_pad, s_pad] fp32 tiles
// of s and dp in VMEM, so dq, dk and dv of a (head, frame) are local writes
// of one program. Two such tiles at s = 197 are over a block's shared
// memory here, so each sum gets one owner among 64 x 64 tiles instead, with
// no atomics (two runs give the same bits) and for any frame length. Both
// kernels follow K5a's launch plan (ops/flash_attention.py::blockdiag_plan,
// passed as three ints and checked here):
//   * blockdiag_bwd_dq, one block per planned query tile: delta = rowsum(
//     do * out) of its rows (also written to a [B, H, F*s] scratch), then
//     one pass over the keys of its frames summing dq: three products a
//     tile pair.
//   * blockdiag_bwd_dkdv, launched after it on the same stream, one block
//     per planned key tile: over the query tiles of its frames it sums dk,
//     dv and the dbias column sums, the rows the bias does not reach left
//     out of dbias: four products a tile pair.
// Rows and keys at or past a frame's end are staged as zeros, weigh
// nothing (p = 0) and are never stored.
// Two bodies:
//   * bf16 at d = 64, the head dimension of every ViT-B path: the Hopper
//     backward tile loop of wgmma_attention_bwd.cuh (shared with K2 and
//     K4), one warpgroup a block, every product a wgmma m64n64k16 with S,
//     dP, P and dS in registers and a two-stage cp.async ring. Frames of
//     more than 32 tokens: frame-aligned 64-row tiles (s = 197: four, the
//     last with 5 rows and 5 keys), keys past the frame's end masked on its
//     last tile, row 0 of the frame out of the bias on the tile that holds
//     it. Frames of at most 32 tokens: 64 // s whole frames packed into one
//     query tile and one key tile, each row's keys (and each key's rows)
//     the window of its own frame, found once a thread and compared on the
//     accumulators on every tile; a clip's last block holds F mod g frames.
//     The biased and unbiased, packed and frame-aligned cases are instances
//     chosen at compile time.
//   * every other case (fp32, and bf16 at d = 16, 32, 128): the first
//     version's body, one frame's 64-row tile a block, in the same residual
//     form (no statistics pass): nvcuda::wmma 16x16x16 for bf16 with S,
//     dP, P and dS in shared memory, fp32 FMAs on the CUDA cores so that
//     fp32 gradients stay within fp32 rounding of the plain version; the
//     16-wide groups past a frame's end are skipped in every product, and
//     what they leave stale in shared memory is never read as a key or a
//     query.
// TMA, several heads a block and warp specialisation are left for later
// versions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

#include "attention_tiles.cuh"
#include "wgmma_attention_bwd.cuh"

namespace {

using vtm::Accum;
using vtm::from_float;
using vtm::load_tile;
using vtm::logit;
using vtm::product_abt;
using vtm::row_delta;
using vtm::write_rows;
template <typename T, int D>
using Layout = vtm::BwdLayout<T, D>;
using Plan = vtm::wg::BlockdiagPlan;

constexpr int kTile = vtm::kTileRows;        // rows of a q tile and keys of a k tile
constexpr int kThreads = vtm::kTileThreads;  // 4 warps, each owning a 16-row strip

// Element strides (batch, head, row) of q, k, v, do, out and of the outputs
// dq, dk, dv; the last dim is contiguous everywhere.
struct Strides {
  long long q[3], k[3], v[3], go[3], o[3], dq[3], dk[3], dv[3];
};

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  const float* key_bias;  // [B, N] or null
  const T* go;
  const T* out;      // the forward's output
  const float* lse;  // [B, H, N]: the forward's row log-sum-exp
  T* dq;
  T* dk;
  T* dv;
  float* dbias;  // [B, H, N] or null
  float* delta;  // [B, H, N] scratch: rowsum(do * out), written by the dq kernel
  int batch, num_heads, n, frames, s_len, exclude_first_row;
  Plan plan;
  float scale;
  Strides st;
};

// rows (or keys) of the tile at x0 that lie inside a frame of `end` rows,
// rounded up to the 16-wide groups the tensor-core path works in
__device__ __forceinline__ int live(int x0, int end) {
  const int left = end - x0;
  return left >= kTile ? kTile : (left + 15) / 16 * 16;
}

// ======================= first-version body (fp32, bf16 d != 64) ==========

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) blockdiag_bwd_dq_kernel(Args<T> p) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = reinterpret_cast<T*>(smem + L::x_bytes);
  T* ks = reinterpret_cast<T*>(smem + 2 * L::x_bytes);
  T* vs = reinterpret_cast<T*>(smem + 3 * L::x_bytes);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);
  float* dps = reinterpret_cast<float*>(smem + L::dp_off);
  T* dss = reinterpret_cast<T*>(smem + L::ds_off);

  const int s_len = p.s_len;
  const int bh = blockIdx.y;
  const int b = bh / p.num_heads;
  const int h = bh % p.num_heads;
  const int f = blockIdx.x / p.plan.tiles_per_frame;
  const int q0 = (blockIdx.x % p.plan.tiles_per_frame) * kTile;  // within the frame
  const long long frame0 = static_cast<long long>(f) * s_len;
  // everything below indexes rows and keys within the frame: [0, s_len)
  const T* qb = p.q + b * p.st.q[0] + h * p.st.q[1] + frame0 * p.st.q[2];
  const T* kb = p.k + b * p.st.k[0] + h * p.st.k[1] + frame0 * p.st.k[2];
  const T* vb = p.v + b * p.st.v[0] + h * p.st.v[1] + frame0 * p.st.v[2];
  const T* gob = p.go + b * p.st.go[0] + h * p.st.go[1] + frame0 * p.st.go[2];
  const T* ob = p.out + b * p.st.o[0] + h * p.st.o[1] + frame0 * p.st.o[2];
  const long long rows = static_cast<long long>(bh) * p.n + frame0;  // the frame's residuals

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow = warp * 16;          // first row of this warp's strip
  const int row = wrow + (lane >> 1);  // the row this lane owns
  const int half = lane & 1;           // which half of the row's 64 keys
  const bool valid = q0 + row < s_len;
  // the row mask: with exclude_first_row, row 0 of the frame sees no bias
  const float* bias = nullptr;
  if (p.key_bias != nullptr && !(p.exclude_first_row && q0 + row == 0))
    bias = p.key_bias + static_cast<long long>(b) * p.n + frame0;

  load_tile<T, D, false>(qs, L::ld_x, qb, p.st.q[2], q0, s_len, 0.f);
  load_tile<T, D, false>(dos, L::ld_x, gob, p.st.go[2], q0, s_len, 0.f);
  const float delta = row_delta<T, D>(gob, p.st.go[2], ob, p.st.o[2], q0 + row, s_len, half);
  const float lse = valid ? p.lse[rows + q0 + row] : 0.f;
  if (half == 0 && valid) p.delta[rows + q0 + row] = delta;

  const float* srow = ss + row * L::ld_s + half * 32;
  const float* dprow = dps + row * L::ld_s + half * 32;
  T* dsrow = dss + row * L::ld_p + half * 32;

  // one pass: dq = scale * sum over the frame's key tiles of ds_lo k
  Accum<T, D> dq;
  dq.zero();
  for (int k0 = 0; k0 < s_len; k0 += kTile) {
    const int cols = live(k0, s_len);
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D, false>(ks, L::ld_x, kb, p.st.k[2], k0, s_len, 0.f);
    load_tile<T, D, false>(vs, L::ld_x, vb, p.st.v[2], k0, s_len, 0.f);
    __syncthreads();
    product_abt<T, D>(qs, ks, ss, wrow, row, half, cols);
    product_abt<T, D>(dos, vs, dps, wrow, row, half, cols);
    __syncwarp();
    for (int j = 0; j < 32; ++j) {
      const int key = k0 + half * 32 + j;
      float ds = 0.f;
      if (key < s_len) {
        const float prob = expf(logit(srow[j], p.scale, bias, key) - lse);
        ds = prob * (dprow[j] - delta);
      }
      dsrow[j] = from_float<T>(ds);
    }
    __syncwarp();
    dq.template add<false>(dss, L::ld_p, ks, L::ld_x, wrow, row, half, cols);
  }
  __syncthreads();  // every warp is done with s and dp: they become the stage
  dq.store(ss, L::ld_o, wrow, row, half, p.scale);
  __syncthreads();
  write_rows<T, D>(p.dq + b * p.st.dq[0] + h * p.st.dq[1] + frame0 * p.st.dq[2], p.st.dq[2], ss,
                   L::ld_o, q0, s_len);
}

// ---- dk, dv and dbias: one block owns a key tile's sums over its frame's queries
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) blockdiag_bwd_dkdv_kernel(Args<T> p) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = reinterpret_cast<T*>(smem + L::x_bytes);
  T* ks = reinterpret_cast<T*>(smem + 2 * L::x_bytes);
  T* vs = reinterpret_cast<T*>(smem + 3 * L::x_bytes);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);
  float* dps = reinterpret_cast<float*>(smem + L::dp_off);
  T* ps = reinterpret_cast<T*>(smem + L::p_off);
  T* dss = reinterpret_cast<T*>(smem + L::ds_off);

  const int s_len = p.s_len;
  const int bh = blockIdx.y;
  const int b = bh / p.num_heads;
  const int h = bh % p.num_heads;
  const int f = blockIdx.x / p.plan.tiles_per_frame;
  const int k0 = (blockIdx.x % p.plan.tiles_per_frame) * kTile;  // within the frame
  const int cols = live(k0, s_len);
  const long long frame0 = static_cast<long long>(f) * s_len;
  const T* qb = p.q + b * p.st.q[0] + h * p.st.q[1] + frame0 * p.st.q[2];
  const T* kb = p.k + b * p.st.k[0] + h * p.st.k[1] + frame0 * p.st.k[2];
  const T* vb = p.v + b * p.st.v[0] + h * p.st.v[1] + frame0 * p.st.v[2];
  const T* gob = p.go + b * p.st.go[0] + h * p.st.go[1] + frame0 * p.st.go[2];
  const float* frame_bias =
      p.key_bias ? p.key_bias + static_cast<long long>(b) * p.n + frame0 : nullptr;
  const bool masked_rows = frame_bias != nullptr && p.exclude_first_row;
  const long long rows_at = static_cast<long long>(bh) * p.n + frame0;  // the frame's residuals
  const float* lse = p.lse + rows_at;
  const float* delta = p.delta + rows_at;
  const bool want_dbias = p.dbias != nullptr;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow = warp * 16;  // s, dp: this warp's query rows; dk, dv: its key rows
  const int row = wrow + (lane >> 1);
  const int half = lane & 1;
  const bool owns_keys = wrow < cols;  // this warp's 16 key rows hold a key

  load_tile<T, D, false>(ks, L::ld_x, kb, p.st.k[2], k0, s_len, 0.f);
  load_tile<T, D, false>(vs, L::ld_x, vb, p.st.v[2], k0, s_len, 0.f);

  Accum<T, D> dk, dv;
  dk.zero();
  dv.zero();
  float db = 0.f;  // threads 0..63: the column sum of ds for key k0 + threadIdx.x

  const float* srow = ss + row * L::ld_s + half * 32;
  float* dprow = dps + row * L::ld_s + half * 32;
  T* prow = ps + row * L::ld_p + half * 32;
  T* dsrow = dss + row * L::ld_p + half * 32;

  for (int q0 = 0; q0 < s_len; q0 += kTile) {
    const int rows = live(q0, s_len);  // query rows of this tile, by 16
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D, false>(qs, L::ld_x, qb, p.st.q[2], q0, s_len, 0.f);
    load_tile<T, D, false>(dos, L::ld_x, gob, p.st.go[2], q0, s_len, 0.f);
    __syncthreads();
    product_abt<T, D>(qs, ks, ss, wrow, row, half, cols);
    product_abt<T, D>(dos, vs, dps, wrow, row, half, cols);
    __syncwarp();
    const bool valid = q0 + row < s_len;
    const bool biased_row = !(masked_rows && q0 + row == 0);  // the row mask
    const float* bias = biased_row ? frame_bias : nullptr;
    const float lse_i = valid ? lse[q0 + row] : 0.f;
    const float delta_i = valid ? delta[q0 + row] : 0.f;
    for (int j = 0; j < 32; ++j) {
      const int key = k0 + half * 32 + j;
      float prob = 0.f, ds = 0.f;
      if (valid && key < s_len) {
        prob = expf(logit(srow[j], p.scale, bias, key) - lse_i);
        ds = prob * (dprow[j] - delta_i);
      }
      prow[j] = from_float<T>(prob);
      dsrow[j] = from_float<T>(ds);
      // unrounded, for the dbias column sums: only the rows the bias reached
      dprow[j] = biased_row ? ds : 0.f;
    }
    __syncthreads();  // dk, dv and dbias read every query row of the tile
    if (owns_keys) {
      dv.template add<true>(ps, L::ld_p, dos, L::ld_x, wrow, row, half, rows);
      dk.template add<true>(dss, L::ld_p, qs, L::ld_x, wrow, row, half, rows);
    }
    if (want_dbias && threadIdx.x < kTile) {
      for (int r = 0; r < kTile; ++r) db += dps[r * L::ld_s + threadIdx.x];
    }
  }
  if (want_dbias && threadIdx.x < kTile && k0 + threadIdx.x < s_len)
    p.dbias[static_cast<long long>(bh) * p.n + frame0 + k0 + threadIdx.x] = db;

  __syncthreads();  // every warp is done with s and dp: they become the stage
  dk.store(ss, L::ld_o, wrow, row, half, p.scale);
  __syncthreads();
  write_rows<T, D>(p.dk + b * p.st.dk[0] + h * p.st.dk[1] + frame0 * p.st.dk[2], p.st.dk[2], ss,
                   L::ld_o, k0, s_len);
  __syncthreads();
  dv.store(ss, L::ld_o, wrow, row, half, 1.f);
  __syncthreads();
  write_rows<T, D>(p.dv + b * p.st.dv[0] + h * p.st.dv[1] + frame0 * p.st.dv[2], p.st.dv[2], ss,
                   L::ld_o, k0, s_len);
}

// ======================= Hopper body (bf16, d = 64) =======================

namespace wg = vtm::wg;
using bf16 = __nv_bfloat16;

// The walk of planned block blockIdx.x: the rows and keys of its frame (or
// of its g packed frames, one tile of each), every pointer offset to its
// first frame's first row. `tile` is the block's 64-row tile within its
// frame (0 when packed): its query tile (dq) or key tile (dk, dv).
template <bool kPacked>
__device__ __forceinline__ wg::BwdWalk planned_walk(const Args<bf16>& p, int& tile) {
  int f0, len;  // the block's first frame, and the rows (= keys) its walk covers
  if constexpr (kPacked) {
    f0 = blockIdx.x * p.plan.frames_per_block;
    len = min(p.plan.frames_per_block, p.frames - f0) * p.s_len;
    tile = 0;
  } else {
    f0 = blockIdx.x / p.plan.tiles_per_frame;
    len = p.s_len;
    tile = (blockIdx.x % p.plan.tiles_per_frame) * wg::kRows;
  }
  return wg::slice_walk(p, blockIdx.y, static_cast<long long>(f0) * p.s_len, 1, len, len);
}

template <bool kBias, bool kPacked>
__global__ void __launch_bounds__(wg::kThreads) blockdiag_bwd_dq_wgmma(Args<bf16> p) {
  extern __shared__ unsigned char smem[];
  int tile;
  wg::BwdWalk w = planned_walk<kPacked>(p, tile);
  w.row0 = tile;
  if constexpr (kPacked) {
    wg::attend_bwd_dq<kBias>(w, wg::PackedFrames{p.s_len, p.exclude_first_row != 0}, smem);
  } else {
    wg::attend_bwd_dq<kBias>(w, wg::FrameRows{p.exclude_first_row != 0}, smem);
  }
}

template <bool kBias, bool kPacked>
__global__ void __launch_bounds__(wg::kThreads) blockdiag_bwd_dkdv_wgmma(Args<bf16> p) {
  extern __shared__ unsigned char smem[];
  int tile;
  wg::BwdWalk w = planned_walk<kPacked>(p, tile);
  w.key0 = tile;
  if constexpr (kPacked) {
    wg::attend_bwd_dkdv<kBias>(w, wg::PackedFrames{p.s_len, p.exclude_first_row != 0}, smem);
  } else {
    wg::attend_bwd_dkdv<kBias>(w, wg::FrameRows{p.exclude_first_row != 0}, smem);
  }
}

// ======================= launch ===========================================

template <bool kBias, bool kPacked>
cudaError_t launch_wgmma(const Args<bf16>& args, const dim3& grid, cudaStream_t stream) {
  constexpr int bytes = wg::BwdSmem::kLaunchBytes;
  return vtm::launch_bwd_pair<blockdiag_bwd_dq_wgmma<kBias, kPacked>, blockdiag_bwd_dkdv_wgmma<kBias, kPacked>>(
      args, grid, grid, wg::kThreads, bytes, bytes, stream);
}

// Both kernels: one block per planned block (a 64-row tile of a frame, or
// g packed frames) and b * h.
template <typename T, int D>
cudaError_t launch(const Args<T>& args, cudaStream_t stream) {
  const dim3 grid(args.plan.blocks, args.batch * args.num_heads);
  if constexpr (std::is_same<T, bf16>::value && D == 64) {
    const bool packed = args.plan.frames_per_block > 1;
    if (args.key_bias)
      return packed ? launch_wgmma<true, true>(args, grid, stream) : launch_wgmma<true, false>(args, grid, stream);
    return packed ? launch_wgmma<false, true>(args, grid, stream) : launch_wgmma<false, false>(args, grid, stream);
  } else {
    if (args.plan.frames_per_block != 1) return cudaErrorInvalidValue;  // the first body packs nothing
    constexpr int bytes = static_cast<int>(Layout<T, D>::bytes);
    return vtm::launch_bwd_pair<blockdiag_bwd_dq_kernel<T, D>, blockdiag_bwd_dkdv_kernel<T, D>>(
        args, grid, grid, kThreads, bytes, bytes, stream);
  }
}

template <typename T>
cudaError_t dispatch_head_dim(int head_dim, const Args<T>& args, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(args, stream);
    case 32: return launch<T, 32>(args, stream);
    case 64: return launch<T, 64>(args, stream);
    case 128: return launch<T, 128>(args, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
Args<T> make_args(const void* q, const void* k, const void* v, const void* key_bias,
                  const void* go, const void* out, const void* lse, void* dq, void* dk, void* dv,
                  void* dbias, void* delta, int batch, int num_heads, int n, int frames,
                  int exclude_first_row, const Plan& plan, float scale, const long long* strides) {
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.key_bias = static_cast<const float*>(key_bias);
  a.go = static_cast<const T*>(go);
  a.out = static_cast<const T*>(out);
  a.lse = static_cast<const float*>(lse);
  a.dq = static_cast<T*>(dq);
  a.dk = static_cast<T*>(dk);
  a.dv = static_cast<T*>(dv);
  a.dbias = static_cast<float*>(dbias);
  a.delta = static_cast<float*>(delta);
  a.batch = batch;
  a.num_heads = num_heads;
  a.n = n;
  a.frames = frames;
  a.s_len = n / frames;
  a.exclude_first_row = exclude_first_row;
  a.plan = plan;
  a.scale = scale;
  std::memcpy(&a.st, strides, sizeof(a.st));
  return a;
}

}  // namespace

// C entry point, bound with ctypes by vtm_torch/ops/flash_attention.py.
//   dtype: 0 = bf16, 1 = fp32 (q, k, v, go, out, dq, dk and dv share it)
//   key_bias: fp32 [batch, n] contiguous, or null for the unbiased form
//   go, out: the cotangent of the token-major output and that output, both
//            read as [batch, heads, n, d] through their strides
//   lse: the forward's fp32 [batch, num_heads, n] contiguous row
//        log-sum-exp
//   dbias: fp32 [batch, num_heads, n] contiguous, or null when not wanted
//   delta: fp32 [batch, num_heads, n] contiguous scratch
//   frames: divides n; exclude_first_row: 1 keeps the bias off row 0 of
//           every frame, and that row out of dbias
//   frames_per_block, tiles_per_frame, blocks: K5a's launch plan
//   (ops/flash_attention.py::blockdiag_plan); frames_per_block > 1 only for
//   the bf16 d = 64 body
//   strides: 24 element strides, (batch, head, row) of q, k, v, go, out, dq,
//            dk, dv
// Returns the cudaError_t of the launches (0 on success).
extern "C" int vtm_blockdiag_attention_bwd(int dtype, int head_dim, const void* q, const void* k,
                                           const void* v, const void* key_bias, const void* go,
                                           const void* out, const void* lse, void* dq, void* dk,
                                           void* dv, void* dbias, void* delta, int batch,
                                           int num_heads, int n, int frames, int exclude_first_row,
                                           int frames_per_block, int tiles_per_frame, int blocks,
                                           float scale, const long long* strides, void* stream) {
  if (frames < 1 || n < 1 || n % frames != 0) return cudaErrorInvalidValue;
  const Plan plan{frames_per_block, tiles_per_frame, blocks};
  if (!plan.covers(frames, n / frames)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_head_dim<__nv_bfloat16>(
          head_dim,
          make_args<__nv_bfloat16>(q, k, v, key_bias, go, out, lse, dq, dk, dv, dbias, delta, batch,
                                   num_heads, n, frames, exclude_first_row, plan, scale, strides),
          s);
    case 1:
      return dispatch_head_dim<float>(
          head_dim,
          make_args<float>(q, k, v, key_bias, go, out, lse, dq, dk, dv, dbias, delta, batch,
                           num_heads, n, frames, exclude_first_row, plan, scale, strides),
          s);
    default:
      return cudaErrorInvalidValue;
  }
}
