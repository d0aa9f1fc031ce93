// Per-frame (trajectory) attention backward for Hopper (sm_90a): the
// gradients of
//   out[b, i, f, h, :] = sum_{j in frame f} softmax_j(q_i . k_j * scale + key_bias[b, j]) v_j
// over q, k, v [B, H, N, d] (frame f = the contiguous keys [f*s, (f+1)*s),
// s = N / F, a softmax of its own per frame) with respect to q, k, v and
// key_bias, given the token-major cotangent do [B, N, F, H, d] and the
// forward's residuals: out itself and lse, the log-sum-exp of each row's
// logits in each frame, fp32 [B, H, F, N], which K3
// (frame_attention_fwd.cu) writes when a gradient is wanted.
//
// Replaces the Pallas TPU kernels of vtm/ops/flash_attention.py::
// _frame_backward_tm_s8 (kernel _make_frame_bwd_s8_kernel, the custom_vjp
// of tome_frame_attention) and its lane-major twin _frame_backward_tm
// (_make_frame_bwd_kernel), which compute the same math in two TPU
// layouts. Their math and rounding points, per (b, h, f), with the row
// statistics taken from the residuals:
//   s  = (q k_f^T) * scale + bias_f      fp32, from the unscaled q
//   p  = exp(s - lse_f)                  fp32, normalised by the saved lse
//   dp = do_f v_f^T                      fp32
//   delta_f = rowsum(do_f * out_f),  ds = p * (dp - delta_f)
//   dq   = scale * sum_f ds_lo k_f       ds_lo, p_lo: ds, p rounded to the
//   dk_f = scale * ds_lo^T q             input dtype before the products;
//   dv_f = p_lo^T do_f                   fp32 sums, cast once at the end
//   dbias[b, h, key] = sum over queries of the unrounded ds
// delta_f = rowsum(do_f * out_f) equals the TPU kernels' rowsum(p * dp)
// since out_f = p v_f. The sum of dbias over heads is left to the caller.
// Every head count and every frame length is covered (the TPU wrapper
// leaves its fused kernel for odd head counts and long rows).
//
// What bounds it on the H100: at B8 H12 N1568 F8 d64 the five products are
// 10*B*H*N^2*d = 151 GFLOP (0.153 ms at the bf16 peak) against about 425 MB
// (q, k, v read, dq, dk, dv written, and do and out, each F times the size
// of q, read once: 0.127 ms): the tensor cores bound it, as long as no
// [N, N] tile leaves the chip.
//
// Design. Blocks run in any order and each sum has one owner: there are no
// atomics, and two runs give the same bits. The TPU program holds a whole
// K/V row, takes one [blk_q, s] tile per frame, and leans on its grid
// running the q blocks in order so that dk/dv/dbias stay resident; here:
//   * frame_bwd_dq, one block per (b*h, 64-row q tile): stages q once and
//     walks the F frames' key tiles in turn, summing dq over all of them
//     in registers. At each frame it takes that frame's do tile (rows of d
//     contiguous elements read through do's strides, no transpose), its
//     lse and delta_f = rowsum(do_f * out_f), which it also writes to a
//     [B, H, F, N] fp32 scratch. Three products a tile pair.
//   * frame_bwd_dkdv, launched after it on the same stream, one block per
//     (b*h, frame, 64-key tile of the frame): keeps its k/v tile, walks all
//     q tiles with the frame's do tiles, lse and delta, and sums dk, dv and
//     the dbias column sums over the queries. Four products a tile pair.
//   Keys past the frame's end are zero-filled, weigh nothing (p = 0 on the
//   frame's ragged last tile) and are not stored; query rows past N are
//   zero-filled and not stored.
// Two bodies:
//   * bf16 at d = 64, the head dimension of every ViT-B path: the Hopper
//     backward tile loop of wgmma_attention_bwd.cuh (shared with K2 and
//     K5b). One warpgroup (128 threads) a block, every product a wgmma
//     m64n64k16 with fp32 accumulators in registers: S, dP, P and dS stay
//     in registers (P and dS are the A operands of the next products), the
//     streamed tiles pass through a two-stage cp.async ring, and the next
//     frame's do tile loads while this frame's is read. The biased and
//     unbiased cases are two instances chosen at compile time.
//   * every other case (fp32, and bf16 at d = 16, 32, 128): the first
//     version's body, in the same residual form (no statistics pass):
//     nvcuda::wmma 16x16x16 for bf16 with S, dP, P and dS in shared memory,
//     fp32 FMAs on the CUDA cores so that fp32 gradients stay within fp32
//     rounding of the plain version; a frame's ragged last key tile
//     multiplies only its 16-wide key groups that hold a key.
// TMA, warp specialisation and a persistent grid are left for later
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

constexpr int kTile = vtm::kTileRows;        // rows of a q tile and keys of a k tile
constexpr int kThreads = vtm::kTileThreads;  // 4 warps, each owning a 16-row strip

// Element strides (batch, head, row) of q, k, v, (batch, head, row, frame)
// of do and out, and (batch, head, row) of the outputs dq, dk, dv; the last
// dim is contiguous everywhere.
struct Strides {
  long long q[3], k[3], v[3], go[4], o[4], dq[3], dk[3], dv[3];
};

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  const float* key_bias;  // [B, N] or null
  const T* go;
  const T* out;      // the forward's output
  const float* lse;  // [B, H, F, N]: the forward's per-frame row log-sum-exp
  T* dq;
  T* dk;
  T* dv;
  float* dbias;  // [B, H, N] or null
  float* delta;  // [B, H, F, N] scratch: rowsum(do_f * out_f), written by the dq kernel
  int batch, num_heads, n, frames, s_len;
  float scale;
  Strides st;
};

// columns of the key tile at k0 that hold a key of the frame ending at
// key_end, rounded up to the 16-wide groups the tensor-core path works in
__device__ __forceinline__ int live_cols(int k0, int key_end) {
  const int left = key_end - k0;
  return left >= kTile ? kTile : (left + 15) / 16 * 16;
}

// ======================= first-version body (fp32, bf16 d != 64) ==========

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) frame_bwd_dq_kernel(Args<T> p) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = reinterpret_cast<T*>(smem + L::x_bytes);
  T* ks = reinterpret_cast<T*>(smem + 2 * L::x_bytes);
  T* vs = reinterpret_cast<T*>(smem + 3 * L::x_bytes);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);
  float* dps = reinterpret_cast<float*>(smem + L::dp_off);
  T* dss = reinterpret_cast<T*>(smem + L::ds_off);

  const int n = p.n;
  const int bh = blockIdx.y;
  const int b = bh / p.num_heads;
  const int h = bh % p.num_heads;
  const int q0 = blockIdx.x * kTile;
  const T* qb = p.q + b * p.st.q[0] + h * p.st.q[1];
  const T* kb = p.k + b * p.st.k[0] + h * p.st.k[1];
  const T* vb = p.v + b * p.st.v[0] + h * p.st.v[1];
  const T* gob = p.go + b * p.st.go[0] + h * p.st.go[1];
  const T* ob = p.out + b * p.st.o[0] + h * p.st.o[1];
  const float* bias = p.key_bias ? p.key_bias + static_cast<long long>(b) * n : nullptr;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow = warp * 16;          // first row of this warp's strip
  const int row = wrow + (lane >> 1);  // the row this lane owns
  const int half = lane & 1;           // which half of the row's 64 keys
  const bool valid = q0 + row < n;

  load_tile<T, D, false>(qs, L::ld_x, qb, p.st.q[2], q0, n, 0.f);

  const float* srow = ss + row * L::ld_s + half * 32;
  const float* dprow = dps + row * L::ld_s + half * 32;
  T* dsrow = dss + row * L::ld_p + half * 32;

  Accum<T, D> dq;  // summed over the keys of every frame
  dq.zero();
  for (int f = 0; f < p.frames; ++f) {
    const int key0 = f * p.s_len;
    const int key_end = key0 + p.s_len;
    const long long rows = (static_cast<long long>(bh) * p.frames + f) * n;  // frame f's residuals
    __syncthreads();  // the previous frame's readers of do are done
    load_tile<T, D, false>(dos, L::ld_x, gob + f * p.st.go[3], p.st.go[2], q0, n, 0.f);
    const float delta =
        row_delta<T, D>(gob + f * p.st.go[3], p.st.go[2], ob + f * p.st.o[3], p.st.o[2], q0 + row, n, half);
    const float lse = valid ? p.lse[rows + q0 + row] : 0.f;
    if (half == 0 && valid) p.delta[rows + q0 + row] = delta;

    // dq += sum over the frame's key tiles of ds_lo k
    for (int k0 = key0; k0 < key_end; k0 += kTile) {
      const int cols = live_cols(k0, key_end);
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, D, false>(ks, L::ld_x, kb, p.st.k[2], k0, key_end, 0.f);
      load_tile<T, D, false>(vs, L::ld_x, vb, p.st.v[2], k0, key_end, 0.f);
      __syncthreads();
      product_abt<T, D>(qs, ks, ss, wrow, row, half, cols);
      product_abt<T, D>(dos, vs, dps, wrow, row, half, cols);
      __syncwarp();
      for (int j = 0; j < 32; ++j) {
        const int key = k0 + half * 32 + j;
        float ds = 0.f;
        if (key < key_end) {
          const float prob = expf(logit(srow[j], p.scale, bias, key) - lse);
          ds = prob * (dprow[j] - delta);
        }
        dsrow[j] = from_float<T>(ds);
      }
      __syncwarp();
      dq.template add<false>(dss, L::ld_p, ks, L::ld_x, wrow, row, half, cols);
    }
  }
  __syncthreads();  // every warp is done with s and dp: they become the stage
  dq.store(ss, L::ld_o, wrow, row, half, p.scale);
  __syncthreads();
  write_rows<T, D>(p.dq + b * p.st.dq[0] + h * p.st.dq[1], p.st.dq[2], ss, L::ld_o, q0, n);
}

// ---- dk, dv and dbias: one block owns a key tile's sums over all queries --
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) frame_bwd_dkdv_kernel(Args<T> p) {
  const int tiles_per_frame = (p.s_len + kTile - 1) / kTile;
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

  const int n = p.n;
  const int bh = blockIdx.y;
  const int b = bh / p.num_heads;
  const int h = bh % p.num_heads;
  const int f = blockIdx.x / tiles_per_frame;
  const int k0 = f * p.s_len + (blockIdx.x % tiles_per_frame) * kTile;
  const int key_end = (f + 1) * p.s_len;
  const int cols = live_cols(k0, key_end);
  const T* qb = p.q + b * p.st.q[0] + h * p.st.q[1];
  const T* kb = p.k + b * p.st.k[0] + h * p.st.k[1];
  const T* vb = p.v + b * p.st.v[0] + h * p.st.v[1];
  const T* gob = p.go + b * p.st.go[0] + h * p.st.go[1] + f * p.st.go[3];
  const float* bias = p.key_bias ? p.key_bias + static_cast<long long>(b) * n : nullptr;
  const long long rows = (static_cast<long long>(bh) * p.frames + f) * n;  // frame f's residuals
  const float* lse = p.lse + rows;
  const float* delta = p.delta + rows;
  const bool want_dbias = p.dbias != nullptr;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow = warp * 16;  // s, dp: this warp's query rows; dk, dv: its key rows
  const int row = wrow + (lane >> 1);
  const int half = lane & 1;
  const bool owns_keys = wrow < cols;  // this warp's 16 key rows hold a key

  load_tile<T, D, false>(ks, L::ld_x, kb, p.st.k[2], k0, key_end, 0.f);
  load_tile<T, D, false>(vs, L::ld_x, vb, p.st.v[2], k0, key_end, 0.f);

  Accum<T, D> dk, dv;
  dk.zero();
  dv.zero();
  float db = 0.f;  // threads 0..63: the column sum of ds for key k0 + threadIdx.x

  const float* srow = ss + row * L::ld_s + half * 32;
  float* dprow = dps + row * L::ld_s + half * 32;
  T* prow = ps + row * L::ld_p + half * 32;
  T* dsrow = dss + row * L::ld_p + half * 32;

  for (int q0 = 0; q0 < n; q0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D, false>(qs, L::ld_x, qb, p.st.q[2], q0, n, 0.f);
    load_tile<T, D, false>(dos, L::ld_x, gob, p.st.go[2], q0, n, 0.f);
    __syncthreads();
    product_abt<T, D>(qs, ks, ss, wrow, row, half, cols);
    product_abt<T, D>(dos, vs, dps, wrow, row, half, cols);
    __syncwarp();
    const bool valid = q0 + row < n;
    const float lse_i = valid ? lse[q0 + row] : 0.f;
    const float delta_i = valid ? delta[q0 + row] : 0.f;
    for (int j = 0; j < 32; ++j) {
      const int key = k0 + half * 32 + j;
      float prob = 0.f, ds = 0.f;
      if (valid && key < key_end) {
        prob = expf(logit(srow[j], p.scale, bias, key) - lse_i);
        ds = prob * (dprow[j] - delta_i);
      }
      prow[j] = from_float<T>(prob);
      dsrow[j] = from_float<T>(ds);
      dprow[j] = ds;  // unrounded, for the dbias column sums
    }
    __syncthreads();  // dk, dv and dbias read every query row of the tile
    if (owns_keys) {
      dv.template add<true>(ps, L::ld_p, dos, L::ld_x, wrow, row, half);
      dk.template add<true>(dss, L::ld_p, qs, L::ld_x, wrow, row, half);
    }
    if (want_dbias && threadIdx.x < kTile) {
      for (int r = 0; r < kTile; ++r) db += dps[r * L::ld_s + threadIdx.x];
    }
  }
  if (want_dbias && threadIdx.x < kTile && k0 + threadIdx.x < key_end)
    p.dbias[static_cast<long long>(bh) * n + k0 + threadIdx.x] = db;

  __syncthreads();  // every warp is done with s and dp: they become the stage
  dk.store(ss, L::ld_o, wrow, row, half, p.scale);
  __syncthreads();
  write_rows<T, D>(p.dk + b * p.st.dk[0] + h * p.st.dk[1], p.st.dk[2], ss, L::ld_o, k0, key_end);
  __syncthreads();
  dv.store(ss, L::ld_o, wrow, row, half, 1.f);
  __syncthreads();
  write_rows<T, D>(p.dv + b * p.st.dv[0] + h * p.st.dv[1], p.st.dv[2], ss, L::ld_o, k0, key_end);
}

// ======================= Hopper body (bf16, d = 64) =======================

namespace wg = vtm::wg;
using bf16 = __nv_bfloat16;

// The (b, h) slice's walk over all F frames (the dq kernel's), with the
// frame-major residuals [F, N] of the slice.
__device__ __forceinline__ wg::BwdWalk frame_walk(const Args<bf16>& p) {
  wg::BwdWalk w = wg::slice_walk(p, blockIdx.y, 0, p.frames, p.s_len, p.n);
  w.go_frame_stride = p.st.go[3];
  w.out_frame_stride = p.st.o[3];
  return w;
}

template <bool kBias>
__global__ void __launch_bounds__(wg::kThreads) frame_bwd_dq_wgmma(Args<bf16> p) {
  extern __shared__ unsigned char smem[];
  wg::BwdWalk w = frame_walk(p);
  w.row0 = blockIdx.x * wg::kRows;
  wg::attend_bwd_dq<kBias>(w, wg::AllPairs(), smem);
}

// one block per (frame, 64-key tile of the frame): the walk is that
// frame's, over all N queries
template <bool kBias>
__global__ void __launch_bounds__(wg::kThreads) frame_bwd_dkdv_wgmma(Args<bf16> p) {
  extern __shared__ unsigned char smem[];
  wg::BwdWalk w = frame_walk(p);
  const int tiles_per_frame = (p.s_len + wg::kRows - 1) / wg::kRows;
  const int f = blockIdx.x / tiles_per_frame;
  const long long key0 = static_cast<long long>(f) * p.s_len;  // the frame's first key
  w.k += key0 * w.k_stride;
  w.v += key0 * w.v_stride;
  if (kBias) w.bias += key0;
  w.go += f * w.go_frame_stride;
  w.lse += f * w.row_frame_stride;
  w.delta += f * w.row_frame_stride;
  w.dk += key0 * w.dk_stride;
  w.dv += key0 * w.dv_stride;
  if (w.dbias) w.dbias += key0;
  w.key0 = (blockIdx.x % tiles_per_frame) * wg::kRows;
  w.frames = 1;
  wg::attend_bwd_dkdv<kBias>(w, wg::AllPairs(), smem);
}

// ======================= launch ===========================================

// The dq kernel: one block per (64-row q tile, b * h); the dk/dv kernel:
// one per (frame, 64-key tile of the frame; b * h).
template <typename T, int D>
cudaError_t launch(const Args<T>& args, cudaStream_t stream) {
  const int bh = args.batch * args.num_heads;
  const dim3 dq_grid((args.n + kTile - 1) / kTile, bh);
  const dim3 dkdv_grid(args.frames * ((args.s_len + kTile - 1) / kTile), bh);
  if constexpr (std::is_same<T, bf16>::value && D == 64) {
    // the dq kernel's shared memory holds a second do slot, used when frames > 1
    constexpr int dq_bytes = wg::BwdSmem::kFramesLaunchBytes, bytes = wg::BwdSmem::kLaunchBytes;
    if (args.key_bias)
      return vtm::launch_bwd_pair<frame_bwd_dq_wgmma<true>, frame_bwd_dkdv_wgmma<true>>(
          args, dq_grid, dkdv_grid, wg::kThreads, dq_bytes, bytes, stream);
    return vtm::launch_bwd_pair<frame_bwd_dq_wgmma<false>, frame_bwd_dkdv_wgmma<false>>(
        args, dq_grid, dkdv_grid, wg::kThreads, dq_bytes, bytes, stream);
  } else {
    constexpr int bytes = static_cast<int>(Layout<T, D>::bytes);
    return vtm::launch_bwd_pair<frame_bwd_dq_kernel<T, D>, frame_bwd_dkdv_kernel<T, D>>(
        args, dq_grid, dkdv_grid, kThreads, bytes, bytes, stream);
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
                  void* dbias, void* delta, int batch, int num_heads, int n, int frames, float scale,
                  const long long* strides) {
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
  a.scale = scale;
  std::memcpy(&a.st, strides, sizeof(a.st));
  return a;
}

}  // namespace

// C entry point, bound with ctypes by vtm_torch/ops/flash_attention.py.
//   dtype: 0 = bf16, 1 = fp32 (q, k, v, go, out, dq, dk and dv share it)
//   key_bias: fp32 [batch, n] contiguous, or null for the unbiased form
//   go: the cotangent of the token-major output [batch, n, frames, heads, d]
//   out, lse: the forward's token-major output and its fp32
//             [batch, num_heads, frames, n] contiguous per-frame row
//             log-sum-exp
//   dbias: fp32 [batch, num_heads, n] contiguous, or null when not wanted
//   delta: fp32 [batch, num_heads, frames, n] contiguous scratch
//   frames: divides n
//   strides: 26 element strides: (batch, head, row) of q, k, v, then
//            (batch, head, row, frame) of go and of out, then (batch, head,
//            row) of dq, dk, dv
// Returns the cudaError_t of the launches (0 on success).
extern "C" int vtm_frame_attention_bwd(int dtype, int head_dim, const void* q, const void* k,
                                       const void* v, const void* key_bias, const void* go,
                                       const void* out, const void* lse, void* dq, void* dk,
                                       void* dv, void* dbias, void* delta, int batch,
                                       int num_heads, int n, int frames, float scale,
                                       const long long* strides, void* stream) {
  if (frames < 1 || n < 1 || n % frames != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_head_dim<__nv_bfloat16>(
          head_dim,
          make_args<__nv_bfloat16>(q, k, v, key_bias, go, out, lse, dq, dk, dv, dbias, delta,
                                   batch, num_heads, n, frames, scale, strides),
          s);
    case 1:
      return dispatch_head_dim<float>(
          head_dim,
          make_args<float>(q, k, v, key_bias, go, out, lse, dq, dk, dv, dbias, delta, batch,
                           num_heads, n, frames, scale, strides),
          s);
    default:
      return cudaErrorInvalidValue;
  }
}
