// Per-frame (trajectory) attention backward for Hopper (sm_90a): the
// gradients of
//   out[b, i, f, h, :] = sum_{j in frame f} softmax_j(q_i . k_j * scale + key_bias[b, j]) v_j
// over q, k, v [B, H, N, d] (frame f = the contiguous keys [f*s, (f+1)*s),
// s = N / F, a softmax of its own per frame) with respect to q, k, v and
// key_bias, given the token-major cotangent do [B, N, F, H, d].
//
// Replaces the Pallas TPU kernels of vtm/ops/flash_attention.py::
// _frame_backward_tm_s8 (kernel _make_frame_bwd_s8_kernel, the custom_vjp
// of tome_frame_attention) and its lane-major twin _frame_backward_tm
// (_make_frame_bwd_kernel), which compute the same math in two TPU
// layouts. The math and its rounding points are theirs, per (b, h, f):
//   s  = (q k_f^T) * scale + bias_f      fp32, from the unscaled q
//   p  = softmax(s)                      fp32, normalised
//   dp = do_f v_f^T                      fp32
//   delta = rowsum(p * dp),  ds = p * (dp - delta)
//   dq   = scale * sum_f ds_lo k_f       ds_lo, p_lo: ds, p rounded to the
//   dk_f = scale * ds_lo^T q             input dtype before the products;
//   dv_f = p_lo^T do_f                   fp32 sums, cast once at the end
//   dbias[b, h, key] = sum over queries of the unrounded ds
// The sum of dbias over heads is left to the caller. Every head count and
// every frame length is covered (the TPU wrapper leaves its fused kernel
// for odd head counts and long rows).
//
// What bounds it on the H100: at B8 H12 N1568 F8 d64 the five products are
// 10*B*H*N^2*d = 151 GFLOP (0.153 ms at the bf16 peak) against about 270 MB
// (q, k, v read, dq, dk, dv written, and do, F times the size of q, read
// once: 0.081 ms): the tensor cores bound it, as long as no [N, N] tile
// leaves the chip.
//
// Design (first version: simple, right and the same from run to run):
//   The TPU program holds a whole K/V row, takes one [blk_q, s] tile per
//   frame, and leans on its grid running the q blocks in order so that
//   dk/dv/dbias stay resident; it also wants a head-major transpose of the
//   cotangent and padded copies of k and v. Here blocks run in any order,
//   so each sum has one owner and there are no atomics, as in the dense
//   backward (flash_attention_bwd.cu), whose tile code this file shares
//   (attention_tiles.cuh):
//   * frame_bwd_dq_kernel, one block per (b*h, 64-row q tile), stages q
//     once and loops over the frames. Per frame it stages that frame's do
//     tile (rows of d contiguous elements read through do's strides, no
//     transpose) and walks the frame's key tiles twice: pass 1 finds each
//     row's max m, denominator l and delta with an online softmax (keys
//     past the frame's end get the logit -1e30) and writes them to
//     [3, B, H, F, N] fp32 scratch; pass 2 recomputes s and dp, forms ds and
//     adds ds_lo k to dq, which stays in registers across all frames.
//   * frame_bwd_dkdv_kernel, one block per (b*h, frame, 64-key tile of the
//     frame), keeps its K/V tile in shared memory, walks all q tiles in
//     order with the frame's do tiles, recomputes s and dp from the saved
//     statistics, and sums dk, dv (registers) and the dbias column sums
//     over the queries. Query rows past N are staged as zeros; keys past
//     the frame's end are zero-filled, weigh nothing and are not stored.
//   * a frame's last key tile is ragged (s = 196, 178, ..., 34 on the
//     merged path): only its 16-wide key groups that hold a key are
//     multiplied.
//   That is nine [64 x 64 x d] products per tile pair where five are
//   needed, the price of owning every sum.
//   * bf16 runs the products on the tensor cores (nvcuda::wmma 16x16x16,
//     fp32 accumulation); fp32 runs them as FMAs on the CUDA cores so that
//     fp32 gradients stay within fp32 rounding of the plain version.
// A whole-frame softmax row in shared memory (one pass less), wgmma and TMA
// are left for later versions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "attention_tiles.cuh"

namespace {

using vtm::Accum;
using vtm::from_float;
using vtm::load_tile;
using vtm::logit;
using vtm::product_abt;
using vtm::write_rows;
template <typename T, int D>
using Layout = vtm::BwdLayout<T, D>;

constexpr int kTile = vtm::kTileRows;        // rows of a q tile and keys of a k tile
constexpr int kThreads = vtm::kTileThreads;  // 4 warps, each owning a 16-row strip
constexpr float kMask = vtm::kMask;

// Element strides (batch, head, row) of q, k, v and of the outputs dq, dk,
// dv, and (batch, head, row, frame) of do; the last dim is contiguous
// everywhere.
struct Strides {
  long long q[3], k[3], v[3], go[4], dq[3], dk[3], dv[3];
};

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  const float* key_bias;  // [B, N] or null
  const T* go;
  T* dq;
  T* dk;
  T* dv;
  float* dbias;  // [B, H, N] or null
  float* stats;  // [3, B, H, F, N]: row max, row denominator, delta per frame
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

// ---- dq, and the per-frame row statistics every tile of ds needs ----------
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
  const float* bias = p.key_bias ? p.key_bias + static_cast<long long>(b) * n : nullptr;
  const long long plane = static_cast<long long>(p.batch) * p.num_heads * p.frames * n;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow = warp * 16;          // first row of this warp's strip
  const int row = wrow + (lane >> 1);  // the row this lane owns
  const int half = lane & 1;           // which half of the row's 64 keys

  load_tile<T, D, false>(qs, L::ld_x, qb, p.st.q[2], q0, n, 0.f);

  float* srow = ss + row * L::ld_s + half * 32;
  const float* dprow = dps + row * L::ld_s + half * 32;
  T* dsrow = dss + row * L::ld_p + half * 32;

  Accum<T, D> dq;  // summed over the keys of every frame
  dq.zero();
  for (int f = 0; f < p.frames; ++f) {
    const int key0 = f * p.s_len;
    const int key_end = key0 + p.s_len;
    __syncthreads();  // the previous frame's readers of do are done
    load_tile<T, D, false>(dos, L::ld_x, gob + f * p.st.go[3], p.st.go[2], q0, n, 0.f);

    // ---- pass 1: m, l and delta = sum_j p_j dp_j of this lane's row -------
    float m_i = kMask, l_i = 0.f, a_i = 0.f;
    for (int k0 = key0; k0 < key_end; k0 += kTile) {
      const int cols = live_cols(k0, key_end);
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, D, false>(ks, L::ld_x, kb, p.st.k[2], k0, key_end, 0.f);
      load_tile<T, D, false>(vs, L::ld_x, vb, p.st.v[2], k0, key_end, 0.f);
      __syncthreads();
      product_abt<T, D>(qs, ks, ss, wrow, row, half, cols);
      product_abt<T, D>(dos, vs, dps, wrow, row, half, cols);
      __syncwarp();
      float mx = kMask;
      for (int j = 0; j < 32; ++j) {
        const int key = k0 + half * 32 + j;
        const float s = key < key_end ? logit(srow[j], p.scale, bias, key) : kMask;
        srow[j] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_i, mx);
      const float corr = expf(m_i - m_new);
      float sum = 0.f, acc = 0.f;
      for (int j = 0; j < 32; ++j) {
        if (k0 + half * 32 + j < key_end) {  // past the end dp was never computed
          const float e = expf(srow[j] - m_new);
          sum += e;
          acc = fmaf(e, dprow[j], acc);
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      l_i = l_i * corr + sum;
      a_i = a_i * corr + acc;
      m_i = m_new;
    }
    const float delta = a_i / l_i;
    if (half == 0 && q0 + row < n) {
      float* st = p.stats + (static_cast<long long>(bh) * p.frames + f) * n + q0 + row;
      st[0] = m_i;
      st[plane] = l_i;
      st[2 * plane] = delta;
    }

    // ---- pass 2: dq += sum over the frame's key tiles of ds_lo k ----------
    for (int k0 = key0; k0 < key_end; k0 += kTile) {
      const int cols = live_cols(k0, key_end);
      __syncthreads();
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
          const float prob = expf(logit(srow[j], p.scale, bias, key) - m_i) / l_i;
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
__global__ void __launch_bounds__(kThreads) frame_bwd_dkdv_kernel(Args<T> p, int tiles_per_frame) {
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
  const long long plane = static_cast<long long>(p.batch) * p.num_heads * p.frames * n;
  const float* stats = p.stats + (static_cast<long long>(bh) * p.frames + f) * n;
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
    const float m_i = valid ? stats[q0 + row] : 0.f;
    const float l_i = valid ? stats[plane + q0 + row] : 1.f;
    const float delta = valid ? stats[2 * plane + q0 + row] : 0.f;
    for (int j = 0; j < 32; ++j) {
      const int key = k0 + half * 32 + j;
      float prob = 0.f, ds = 0.f;
      if (valid && key < key_end) {
        prob = expf(logit(srow[j], p.scale, bias, key) - m_i) / l_i;
        ds = prob * (dprow[j] - delta);
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

template <typename T, int D>
cudaError_t launch(const Args<T>& args, cudaStream_t stream) {
  using L = Layout<T, D>;
  auto dq_kernel = frame_bwd_dq_kernel<T, D>;
  auto dkdv_kernel = frame_bwd_dkdv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L::bytes));
  if (err != cudaSuccess) return err;
  const int bh = args.batch * args.num_heads;
  const int tiles_per_frame = (args.s_len + kTile - 1) / kTile;
  dq_kernel<<<dim3((args.n + kTile - 1) / kTile, bh), kThreads, L::bytes, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // reads the row statistics the first kernel wrote: same stream, in order
  dkdv_kernel<<<dim3(args.frames * tiles_per_frame, bh), kThreads, L::bytes, stream>>>(
      args, tiles_per_frame);
  return cudaGetLastError();
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
                  const void* go, void* dq, void* dk, void* dv, void* dbias, void* stats,
                  int batch, int num_heads, int n, int frames, float scale,
                  const long long* strides) {
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.key_bias = static_cast<const float*>(key_bias);
  a.go = static_cast<const T*>(go);
  a.dq = static_cast<T*>(dq);
  a.dk = static_cast<T*>(dk);
  a.dv = static_cast<T*>(dv);
  a.dbias = static_cast<float*>(dbias);
  a.stats = static_cast<float*>(stats);
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
//   dtype: 0 = bf16, 1 = fp32 (q, k, v, go, dq, dk and dv share it)
//   key_bias: fp32 [batch, n] contiguous, or null for the unbiased form
//   go: the cotangent of the token-major output [batch, n, frames, heads, d]
//   dbias: fp32 [batch, num_heads, n] contiguous, or null when not wanted
//   stats: fp32 [3, batch, num_heads, frames, n] scratch
//   frames: divides n
//   strides: 22 element strides: (batch, head, row) of q, k, v, then
//            (batch, head, row, frame) of go, then (batch, head, row) of
//            dq, dk, dv
// Returns the cudaError_t of the launches (0 on success).
extern "C" int vtm_frame_attention_bwd(int dtype, int head_dim, const void* q, const void* k,
                                       const void* v, const void* key_bias, const void* go,
                                       void* dq, void* dk, void* dv, void* dbias, void* stats,
                                       int batch, int num_heads, int n, int frames, float scale,
                                       const long long* strides, void* stream) {
  if (frames < 1 || n < 1 || n % frames != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_head_dim<__nv_bfloat16>(
          head_dim,
          make_args<__nv_bfloat16>(q, k, v, key_bias, go, dq, dk, dv, dbias, stats, batch,
                                   num_heads, n, frames, scale, strides),
          s);
    case 1:
      return dispatch_head_dim<float>(
          head_dim,
          make_args<float>(q, k, v, key_bias, go, dq, dk, dv, dbias, stats, batch, num_heads, n,
                           frames, scale, strides),
          s);
    default:
      return cudaErrorInvalidValue;
  }
}
