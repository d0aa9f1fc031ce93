// Block-diagonal (per-frame) attention backward for Hopper (sm_90a): the
// gradients of
//   out[b, f*s + i, h, :] = softmax_j(q_i k_j^T * scale + m_i * key_bias[b, f*s + j]) v_j
// (i, j in [0, s): the queries of frame f attend only to the keys of frame
// f; the row mask m_i is 1, or with exclude_first_row m_0 = 0) with respect
// to q, k, v and key_bias, given do = d(loss)/d(out), token-major
// [B, F*s, H*d] and read through its strides.
//
// Replaces the Pallas TPU kernel of vtm/ops/flash_attention.py::
// _blockdiag_backward (kernel _make_blockdiag_bwd_kernel, the custom_vjp of
// tome_blockdiag_attention). The math and its rounding points are that
// kernel's, per (b, h, frame):
//   s  = (q k^T) * scale + m * bias      fp32, from the unscaled q
//   p  = softmax(s)                      fp32, normalised
//   dp = do v^T                          fp32
//   delta = rowsum(p * dp),  ds = p * (dp - delta)
//   dq = scale * (ds_lo k)               ds_lo, p_lo: ds, p rounded to the
//   dk = scale * (ds_lo^T q)             input dtype before the products;
//   dv = p_lo^T do                       fp32 sums, cast once at the end
//   dbias[b, h, key] = sum over the queries the bias reached (m_i = 1) of
//                      the unrounded ds
// The sum of dbias over heads is left to the caller.
//
// What bounds it on the H100: at B8 H12 d64 F8 s197 the five products are
// 10*B*H*F*s^2*d = 19 GFLOP against about 136 MB of q/k/v/do/dq/dk/dv,
// about 140 FLOP per byte: below the card's ~295 FLOP/byte bf16 ridge, so
// device memory bounds it as long as no [s, s] tile leaves the chip.
//
// Design (first version: simple, right and the same from run to run):
//   The TPU program holds a whole frame's [s_pad, s_pad] fp32 tiles of s and
//   dp in VMEM, so dq, dk and dv of a (head, frame) are local writes of one
//   program. Two such tiles at s = 197 are over a block's shared memory
//   here, so each sum gets one owner among [64 x 64] tiles instead, with no
//   atomics and for any frame length:
//   * blockdiag_bwd_dq_kernel, one block per (b*h, frame, 64-row q tile of
//     the frame), walks the frame's key tiles twice. Pass 1 finds each
//     row's max m, denominator l and delta with an online softmax and
//     writes them to [3, B, H, F*s] fp32 scratch. Pass 2 recomputes s and
//     dp, forms ds, and sums dq over the frame's keys in registers.
//   * blockdiag_bwd_dkdv_kernel, one block per (b*h, frame, 64-key tile of
//     the frame), keeps its K/V tile in shared memory, walks the frame's q
//     tiles in order, recomputes s and dp from the saved row statistics,
//     and sums dk, dv (registers) and the dbias column sums over the
//     frame's queries, row 0 left out of dbias under the row mask.
//   No tile runs over into the next frame: rows and keys at or past the
//   frame's end are staged as zeros, masked by index (logit -1e30, p = ds =
//   0) and never stored; the 16-wide groups past the end are skipped in
//   every product, and what they leave stale in shared memory is never read
//   as a key or a query.
//   That is nine [64 x 64 x d] products per tile pair where five are
//   needed, the price of owning every sum.
//   * bf16 runs the products on the tensor cores (nvcuda::wmma 16x16x16,
//     fp32 accumulation); fp32 runs them as FMAs on the CUDA cores so that
//     fp32 gradients stay within fp32 rounding of the plain version.
// A whole frame per block at short s (one pass, five products), wgmma and
// TMA are left for later versions.

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

// Element strides (batch, head, row) of q, k, v, do and of the outputs dq,
// dk, dv; the last dim is contiguous everywhere.
struct Strides {
  long long q[3], k[3], v[3], go[3], dq[3], dk[3], dv[3];
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
  float* stats;  // [3, B, H, N]: row max, row denominator, delta
  int batch, num_heads, n, frames, s_len, tiles_per_frame, exclude_first_row;
  float scale;
  Strides st;
};

// rows (or keys) of the tile at x0 that lie inside a frame of `end` rows,
// rounded up to the 16-wide groups the tensor-core path works in
__device__ __forceinline__ int live(int x0, int end) {
  const int left = end - x0;
  return left >= kTile ? kTile : (left + 15) / 16 * 16;
}

// ---- dq, and the row statistics every tile of ds needs -------------------
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
  const int f = blockIdx.x / p.tiles_per_frame;
  const int q0 = (blockIdx.x % p.tiles_per_frame) * kTile;  // within the frame
  const long long frame0 = static_cast<long long>(f) * s_len;
  // everything below indexes rows and keys within the frame: [0, s_len)
  const T* qb = p.q + b * p.st.q[0] + h * p.st.q[1] + frame0 * p.st.q[2];
  const T* kb = p.k + b * p.st.k[0] + h * p.st.k[1] + frame0 * p.st.k[2];
  const T* vb = p.v + b * p.st.v[0] + h * p.st.v[1] + frame0 * p.st.v[2];
  const T* gob = p.go + b * p.st.go[0] + h * p.st.go[1] + frame0 * p.st.go[2];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow = warp * 16;          // first row of this warp's strip
  const int row = wrow + (lane >> 1);  // the row this lane owns
  const int half = lane & 1;           // which half of the row's 64 keys
  // the row mask: with exclude_first_row, row 0 of the frame sees no bias
  const float* bias = nullptr;
  if (p.key_bias != nullptr && !(p.exclude_first_row && q0 + row == 0))
    bias = p.key_bias + static_cast<long long>(b) * p.n + frame0;

  load_tile<T, D, false>(qs, L::ld_x, qb, p.st.q[2], q0, s_len, 0.f);
  load_tile<T, D, false>(dos, L::ld_x, gob, p.st.go[2], q0, s_len, 0.f);

  float* srow = ss + row * L::ld_s + half * 32;
  const float* dprow = dps + row * L::ld_s + half * 32;

  // ---- pass 1: m, l and delta = sum_j p_j dp_j of this lane's row --------
  float m_i = kMask, l_i = 0.f, a_i = 0.f;
  for (int k0 = 0; k0 < s_len; k0 += kTile) {
    const int cols = live(k0, s_len);
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D, false>(ks, L::ld_x, kb, p.st.k[2], k0, s_len, 0.f);
    load_tile<T, D, false>(vs, L::ld_x, vb, p.st.v[2], k0, s_len, 0.f);
    __syncthreads();
    product_abt<T, D>(qs, ks, ss, wrow, row, half, cols);
    product_abt<T, D>(dos, vs, dps, wrow, row, half, cols);
    __syncwarp();
    float mx = kMask;
    for (int j = 0; j < 32; ++j) {
      const int key = k0 + half * 32 + j;
      const float s = key < s_len ? logit(srow[j], p.scale, bias, key) : kMask;
      srow[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float corr = expf(m_i - m_new);
    float sum = 0.f, acc = 0.f;
    for (int j = 0; j < 32; ++j) {
      if (k0 + half * 32 + j < s_len) {  // past the end dp was never computed
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
  if (half == 0 && q0 + row < s_len) {
    const long long plane = static_cast<long long>(p.batch) * p.num_heads * p.n;
    float* st = p.stats + static_cast<long long>(bh) * p.n + frame0 + q0 + row;
    st[0] = m_i;
    st[plane] = l_i;
    st[2 * plane] = delta;
  }

  // ---- pass 2: dq = scale * sum over the frame's key tiles of ds_lo k ----
  Accum<T, D> dq;
  dq.zero();
  T* dsrow = dss + row * L::ld_p + half * 32;
  for (int k0 = 0; k0 < s_len; k0 += kTile) {
    const int cols = live(k0, s_len);
    __syncthreads();
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
        const float prob = expf(logit(srow[j], p.scale, bias, key) - m_i) / l_i;
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
  const int f = blockIdx.x / p.tiles_per_frame;
  const int k0 = (blockIdx.x % p.tiles_per_frame) * kTile;  // within the frame
  const int cols = live(k0, s_len);
  const long long frame0 = static_cast<long long>(f) * s_len;
  const T* qb = p.q + b * p.st.q[0] + h * p.st.q[1] + frame0 * p.st.q[2];
  const T* kb = p.k + b * p.st.k[0] + h * p.st.k[1] + frame0 * p.st.k[2];
  const T* vb = p.v + b * p.st.v[0] + h * p.st.v[1] + frame0 * p.st.v[2];
  const T* gob = p.go + b * p.st.go[0] + h * p.st.go[1] + frame0 * p.st.go[2];
  const float* frame_bias =
      p.key_bias ? p.key_bias + static_cast<long long>(b) * p.n + frame0 : nullptr;
  const bool masked_rows = frame_bias != nullptr && p.exclude_first_row;
  const long long plane = static_cast<long long>(p.batch) * p.num_heads * p.n;
  const float* stats = p.stats + static_cast<long long>(bh) * p.n + frame0;
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
    const float m_i = valid ? stats[q0 + row] : 0.f;
    const float l_i = valid ? stats[plane + q0 + row] : 1.f;
    const float delta = valid ? stats[2 * plane + q0 + row] : 0.f;
    for (int j = 0; j < 32; ++j) {
      const int key = k0 + half * 32 + j;
      float prob = 0.f, ds = 0.f;
      if (valid && key < s_len) {
        prob = expf(logit(srow[j], p.scale, bias, key) - m_i) / l_i;
        ds = prob * (dprow[j] - delta);
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

template <typename T, int D>
cudaError_t launch(const Args<T>& args, cudaStream_t stream) {
  using L = Layout<T, D>;
  auto dq_kernel = blockdiag_bwd_dq_kernel<T, D>;
  auto dkdv_kernel = blockdiag_bwd_dkdv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L::bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(args.frames * args.tiles_per_frame, args.batch * args.num_heads);
  dq_kernel<<<grid, kThreads, L::bytes, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // reads the row statistics the first kernel wrote: same stream, in order
  dkdv_kernel<<<grid, kThreads, L::bytes, stream>>>(args);
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
                  int batch, int num_heads, int n, int frames, int exclude_first_row,
                  float scale, const long long* strides) {
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
  a.tiles_per_frame = (a.s_len + kTile - 1) / kTile;
  a.exclude_first_row = exclude_first_row;
  a.scale = scale;
  std::memcpy(&a.st, strides, sizeof(a.st));
  return a;
}

}  // namespace

// C entry point, bound with ctypes by vtm_torch/ops/flash_attention.py.
//   dtype: 0 = bf16, 1 = fp32 (q, k, v, go, dq, dk and dv share it)
//   key_bias: fp32 [batch, n] contiguous, or null for the unbiased form
//   go: the cotangent of the token-major output, read as [batch, heads, n, d]
//       through its strides
//   dbias: fp32 [batch, num_heads, n] contiguous, or null when not wanted
//   stats: fp32 [3, batch, num_heads, n] scratch
//   frames: divides n; exclude_first_row: 1 keeps the bias off row 0 of
//           every frame, and that row out of dbias
//   strides: 21 element strides, (batch, head, row) of q, k, v, go, dq, dk, dv
// Returns the cudaError_t of the launches (0 on success).
extern "C" int vtm_blockdiag_attention_bwd(int dtype, int head_dim, const void* q, const void* k,
                                           const void* v, const void* key_bias, const void* go,
                                           void* dq, void* dk, void* dv, void* dbias, void* stats,
                                           int batch, int num_heads, int n, int frames,
                                           int exclude_first_row, float scale,
                                           const long long* strides, void* stream) {
  if (frames < 1 || n < 1 || n % frames != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_head_dim<__nv_bfloat16>(
          head_dim,
          make_args<__nv_bfloat16>(q, k, v, key_bias, go, dq, dk, dv, dbias, stats, batch,
                                   num_heads, n, frames, exclude_first_row, scale, strides),
          s);
    case 1:
      return dispatch_head_dim<float>(
          head_dim,
          make_args<float>(q, k, v, key_bias, go, dq, dk, dv, dbias, stats, batch, num_heads, n,
                           frames, exclude_first_row, scale, strides),
          s);
    default:
      return cudaErrorInvalidValue;
  }
}
