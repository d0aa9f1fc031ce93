// Dense attention backward for Hopper (sm_90a): the gradients of
//   out = softmax(q k^T * scale + key_bias[b, key]) v      over [B, H, N, d]
// with respect to q, k, v and key_bias, given do = d(loss)/d(out) and the
// forward's residuals: out itself and lse = m + log l, the log-sum-exp of
// each row's logits, which K1 (flash_attention_fwd.cu) writes when a
// gradient is wanted.
//
// Replaces the Pallas TPU kernel of vtm/ops/flash_attention.py::_backward_impl
// (kernel _bwd_kernel, the custom_vjp of tome_flash_attention). Its math and
// rounding points, with the row statistics taken from the residuals:
//   s  = (q k^T) * scale + bias          fp32, from the unscaled q
//   p  = exp(s - lse)                    fp32, normalised by the saved lse
//   dp = do v^T                          fp32
//   delta = rowsum(do * out),  ds = p * (dp - delta)
//   dq = scale * (ds_lo k)               ds_lo, p_lo: ds, p rounded to the
//   dk = scale * (ds_lo^T q)             input dtype before the products;
//   dv = p_lo^T do                       fp32 sums, cast once at the end
//   dbias[b, h, key] = sum over queries of the unrounded ds
// delta = rowsum(do * out) equals the TPU kernel's rowsum(p * dp) (since
// out = p v); out is read in the input dtype, so in bf16 delta carries
// out's rounding, about 2^-9 of each term, far below ds's own rounding to
// bf16. The sum of dbias over heads is left to the caller.
//
// What bounds it on the H100: at B8 H12 N1568 d64 the five products the
// math needs are 10*B*H*N^2*d = 151 GFLOP against about 135 MB of
// q/k/v/do/dq/dk/dv, far above the card's ~295 FLOP/byte bf16 ridge: the
// tensor cores bound it, not device memory, as long as no [N, N] tile
// leaves the chip.
//
// Design. Blocks run in any order and each sum has one owner: there are no
// atomics, and two runs give the same bits.
//   * attention_bwd_dq_kernel, one block per (b*h, 64-row q tile): in its
//     prologue delta = rowsum(do * out) in fp32, written to a [B, H, N]
//     scratch; then one pass over the key tiles computing s, dp, p, ds and
//     dq += ds_lo k (three products a tile pair).
//   * attention_bwd_dkdv_kernel, one block per (b*h, 64-key tile), launched
//     after it on the same stream (it reads delta): over the q tiles it
//     computes s, dp, p, ds, then dv += p_lo^T do, dk += ds_lo^T q and the
//     dbias column sums (four products).
//   Seven [64 x 64 x d] products a tile pair where the first version did
//   nine (it recomputed s and dp for a statistics pass); the fused
//   one-kernel form would need five, with dq summed by atomics in an order
//   that changes from run to run.
//
// Two bodies:
//   * bf16 at d = 64, the head dimension of every ViT-B path: the Hopper
//     backward tile loop of wgmma_attention_bwd.cuh (shared with K4 and
//     K5b), one warpgroup (128 threads) a block, every product a wgmma
//     m64n64k16 with fp32 accumulators in registers. The dk/dv kernel
//     computes s^T = k q^T and dp^T = v do^T, so that p^T and ds^T sit in
//     the accumulators of their key rows: rounded to bf16 in registers,
//     they are the A operand of dv += p^T do and dk += ds^T q, and the
//     dbias sums are row sums in registers. The dq kernel's ds feeds
//     dq += ds k the same way. S, dP, P and dS never reach shared memory.
//     The streamed tiles (k and v in the dq kernel, q and do in the dk/dv
//     kernel) pass through a two-stage ring filled by cp.async, so the next
//     tile's copy overlaps the current tile's products; tiles are 128-byte
//     swizzled as wgmma's descriptors read them (wgmma_tiles.cuh). p = exp2
//     of fp32 logits in the log2 domain. Results leave through a swizzled
//     bf16 stage with 16-byte stores. The biased and unbiased cases are two
//     instances chosen at compile time.
//   * every other case (fp32, and bf16 at d = 16, 32, 128): the first
//     version's body (wmma 16x16x16 for bf16, fp32 FMAs on the CUDA cores
//     so that fp32 gradients stay within fp32 rounding of the plain
//     version), with the same residual formulation: no statistics pass.
// wgmma at d = 128, TMA, warp specialisation and a persistent grid are
// left for later versions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
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
using vtm::to_float;
using vtm::write_rows;
// shared-memory layout, tile products and register accumulators: attention_tiles.cuh
template <typename T, int D>
using Layout = vtm::BwdLayout<T, D>;

constexpr int kTile = vtm::kTileRows;  // rows of a q tile and keys of a k tile
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
  int batch, num_heads, n;
  float scale;
  Strides st;
};

template <typename T>
struct Slice {
  const T *q, *k, *v, *go, *out;
  const float* bias;
};

template <typename T>
__device__ __forceinline__ Slice<T> slice(const Args<T>& p, int b, int h) {
  Slice<T> s;
  s.q = p.q + b * p.st.q[0] + h * p.st.q[1];
  s.k = p.k + b * p.st.k[0] + h * p.st.k[1];
  s.v = p.v + b * p.st.v[0] + h * p.st.v[1];
  s.go = p.go + b * p.st.go[0] + h * p.st.go[1];
  s.out = p.out + b * p.st.o[0] + h * p.st.o[1];
  s.bias = p.key_bias ? p.key_bias + static_cast<long long>(b) * p.n : nullptr;
  return s;
}

// ======================= first-version body (fp32, bf16 d != 64) ==========

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attention_bwd_dq_kernel(Args<T> p) {
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
  const Slice<T> sl = slice(p, b, h);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow = warp * 16;          // first row of this warp's strip
  const int row = wrow + (lane >> 1);  // the row this lane owns
  const int half = lane & 1;           // which half of the row's 64 keys

  load_tile<T, D, false>(qs, L::ld_x, sl.q, p.st.q[2], q0, n, 0.f);
  load_tile<T, D, false>(dos, L::ld_x, sl.go, p.st.go[2], q0, n, 0.f);

  const bool valid = q0 + row < n;
  const float delta = row_delta<T, D>(sl.go, p.st.go[2], sl.out, p.st.o[2], q0 + row, n, half);
  const float lse = valid ? p.lse[static_cast<long long>(bh) * n + q0 + row] : 0.f;
  if (half == 0 && valid) p.delta[static_cast<long long>(bh) * n + q0 + row] = delta;

  const float* srow = ss + row * L::ld_s + half * 32;
  const float* dprow = dps + row * L::ld_s + half * 32;

  // ---- one pass: dq = scale * sum over key tiles of ds_lo k ----------------
  Accum<T, D> dq;
  dq.zero();
  T* dsrow = dss + row * L::ld_p + half * 32;
  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D, false>(ks, L::ld_x, sl.k, p.st.k[2], k0, n, 0.f);
    load_tile<T, D, false>(vs, L::ld_x, sl.v, p.st.v[2], k0, n, 0.f);
    __syncthreads();
    product_abt<T, D>(qs, ks, ss, wrow, row, half);
    product_abt<T, D>(dos, vs, dps, wrow, row, half);
    __syncwarp();
    for (int j = 0; j < 32; ++j) {
      const int key = k0 + half * 32 + j;
      float ds = 0.f;
      if (key < n) {
        const float prob = expf(logit(srow[j], p.scale, sl.bias, key) - lse);
        ds = prob * (dprow[j] - delta);
      }
      dsrow[j] = from_float<T>(ds);
    }
    __syncwarp();
    dq.template add<false>(dss, L::ld_p, ks, L::ld_x, wrow, row, half);
  }
  __syncthreads();  // every warp is done with s and dp: they become the stage
  dq.store(ss, L::ld_o, wrow, row, half, p.scale);
  __syncthreads();
  write_rows<T, D>(p.dq + b * p.st.dq[0] + h * p.st.dq[1], p.st.dq[2], ss, L::ld_o, q0, n);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attention_bwd_dkdv_kernel(Args<T> p) {
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
  const int k0 = blockIdx.x * kTile;
  const Slice<T> sl = slice(p, b, h);
  const float* lse = p.lse + static_cast<long long>(bh) * n;
  const float* delta = p.delta + static_cast<long long>(bh) * n;
  const bool want_dbias = p.dbias != nullptr;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow = warp * 16;  // s, dp: this warp's query rows; dk, dv: its key rows
  const int row = wrow + (lane >> 1);
  const int half = lane & 1;

  load_tile<T, D, false>(ks, L::ld_x, sl.k, p.st.k[2], k0, n, 0.f);
  load_tile<T, D, false>(vs, L::ld_x, sl.v, p.st.v[2], k0, n, 0.f);

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
    load_tile<T, D, false>(qs, L::ld_x, sl.q, p.st.q[2], q0, n, 0.f);
    load_tile<T, D, false>(dos, L::ld_x, sl.go, p.st.go[2], q0, n, 0.f);
    __syncthreads();
    product_abt<T, D>(qs, ks, ss, wrow, row, half);
    product_abt<T, D>(dos, vs, dps, wrow, row, half);
    __syncwarp();
    const bool valid = q0 + row < n;
    const float lse_i = valid ? lse[q0 + row] : 0.f;
    const float delta_i = valid ? delta[q0 + row] : 0.f;
    for (int j = 0; j < 32; ++j) {
      const int key = k0 + half * 32 + j;
      float prob = 0.f, ds = 0.f;
      if (valid && key < n) {
        prob = expf(logit(srow[j], p.scale, sl.bias, key) - lse_i);
        ds = prob * (dprow[j] - delta_i);
      }
      prow[j] = from_float<T>(prob);
      dsrow[j] = from_float<T>(ds);
      dprow[j] = ds;  // unrounded, for the dbias column sums
    }
    __syncthreads();  // dk, dv and dbias read every query row of the tile
    dv.template add<true>(ps, L::ld_p, dos, L::ld_x, wrow, row, half);
    dk.template add<true>(dss, L::ld_p, qs, L::ld_x, wrow, row, half);
    if (want_dbias && threadIdx.x < kTile) {
      for (int r = 0; r < kTile; ++r) db += dps[r * L::ld_s + threadIdx.x];
    }
  }
  if (want_dbias && threadIdx.x < kTile && k0 + threadIdx.x < n)
    p.dbias[static_cast<long long>(bh) * n + k0 + threadIdx.x] = db;

  __syncthreads();  // every warp is done with s and dp: they become the stage
  dk.store(ss, L::ld_o, wrow, row, half, p.scale);
  __syncthreads();
  write_rows<T, D>(p.dk + b * p.st.dk[0] + h * p.st.dk[1], p.st.dk[2], ss, L::ld_o, k0, n);
  __syncthreads();
  dv.store(ss, L::ld_o, wrow, row, half, 1.f);
  __syncthreads();
  write_rows<T, D>(p.dv + b * p.st.dv[0] + h * p.st.dv[1], p.st.dv[2], ss, L::ld_o, k0, n);
}

// ======================= Hopper body (bf16, d = 64) =======================

namespace wg = vtm::wg;
using bf16 = __nv_bfloat16;

// One (b, h) slice of the dense problem as a one-frame backward walk.
__device__ __forceinline__ wg::BwdWalk dense_walk(const Args<bf16>& p) {
  wg::BwdWalk w = wg::slice_walk(p, blockIdx.y, 0, 1, p.n, p.n);
  w.row0 = w.key0 = blockIdx.x * wg::kRows;
  return w;
}

template <bool kBias>
__global__ void __launch_bounds__(wg::kThreads) attention_bwd_dq_wgmma(Args<bf16> p) {
  extern __shared__ unsigned char smem[];
  wg::attend_bwd_dq<kBias>(dense_walk(p), wg::AllPairs(), smem);
}

template <bool kBias>
__global__ void __launch_bounds__(wg::kThreads) attention_bwd_dkdv_wgmma(Args<bf16> p) {
  extern __shared__ unsigned char smem[];
  wg::attend_bwd_dkdv<kBias>(dense_walk(p), wg::AllPairs(), smem);
}

// ======================= launch ===========================================

template <typename T, int D>
cudaError_t launch(const Args<T>& args, cudaStream_t stream) {
  const dim3 grid((args.n + kTile - 1) / kTile, args.batch * args.num_heads);
  if constexpr (std::is_same<T, bf16>::value && D == 64) {
    constexpr int bytes = wg::BwdSmem::kLaunchBytes;
    if (args.key_bias)
      return vtm::launch_bwd_pair<attention_bwd_dq_wgmma<true>, attention_bwd_dkdv_wgmma<true>>(
          args, grid, grid, wg::kThreads, bytes, bytes, stream);
    return vtm::launch_bwd_pair<attention_bwd_dq_wgmma<false>, attention_bwd_dkdv_wgmma<false>>(
        args, grid, grid, wg::kThreads, bytes, bytes, stream);
  } else {
    constexpr int bytes = static_cast<int>(Layout<T, D>::bytes);
    return vtm::launch_bwd_pair<attention_bwd_dq_kernel<T, D>, attention_bwd_dkdv_kernel<T, D>>(
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
                  void* dbias, void* delta, int batch, int num_heads, int n, float scale,
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
  a.scale = scale;
  std::memcpy(&a.st, strides, sizeof(a.st));
  return a;
}

}  // namespace

// C entry point, bound with ctypes by vtm_torch/ops/flash_attention.py.
//   dtype: 0 = bf16, 1 = fp32 (q, k, v, go, out, dq, dk and dv share it)
//   key_bias: fp32 [batch, n] contiguous, or null for the unbiased form
//   out, lse: the forward's output and its fp32 [batch, num_heads, n]
//             contiguous row log-sum-exp
//   dbias: fp32 [batch, num_heads, n] contiguous, or null when not wanted
//   delta: fp32 [batch, num_heads, n] contiguous scratch
//   strides: 24 element strides, (batch, head, row) of q, k, v, go, out,
//            dq, dk, dv
// Returns the cudaError_t of the launches (0 on success).
extern "C" int vtm_attention_bwd(int dtype, int head_dim, const void* q, const void* k,
                                 const void* v, const void* key_bias, const void* go,
                                 const void* out, const void* lse, void* dq, void* dk, void* dv,
                                 void* dbias, void* delta, int batch, int num_heads, int n,
                                 float scale, const long long* strides, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_head_dim<__nv_bfloat16>(
          head_dim,
          make_args<__nv_bfloat16>(q, k, v, key_bias, go, out, lse, dq, dk, dv, dbias, delta,
                                   batch, num_heads, n, scale, strides),
          s);
    case 1:
      return dispatch_head_dim<float>(
          head_dim,
          make_args<float>(q, k, v, key_bias, go, out, lse, dq, dk, dv, dbias, delta, batch,
                           num_heads, n, scale, strides),
          s);
    default:
      return cudaErrorInvalidValue;
  }
}
