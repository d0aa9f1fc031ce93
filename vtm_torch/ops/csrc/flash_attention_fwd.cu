// Dense attention forward for Hopper (sm_90a):
//   out = softmax(q k^T * scale + key_bias[b, key]) v      over [B, H, N, d]
//
// Replaces the Pallas TPU kernel of vtm/ops/flash_attention.py::_forward
// (kernel _make_n8_kernel, reached through tome_flash_attention); the same
// math as its lane-padded twins _kernel / _kernel_chunked.
//
// What bounds it on the H100: at B8 H12 N1568 d64 one call is
// 4*B*H*N^2*d = 60.4 GFLOP against about 77 MB of q/k/v/out, so about
// 785 FLOP per byte -- above the card's ~295 FLOP/byte bf16 ridge. The
// kernel is bound by the tensor cores, not by device memory.
//
// Why the plain PyTorch version (ops/flash_attention.py::_reference) loses:
// it writes and reads back a [B, H, N, N] fp32 logits tensor, about
// 944 MB per call at that shape, plus the softmax and bf16 probability
// tensors. This kernel keeps logits and probabilities on chip.
//
// Two bodies:
//   * bf16 at d = 64, the head dimension of every ViT-B path: the Hopper
//     tile loop of wgmma_attention.cuh (shared with K3 and K5a) with one
//     frame of N keys: one warpgroup (128 threads) a block of 64 query rows,
//     64-key tiles of k and v through a two-stage cp.async ring, products
//     on wgmma with S and the accumulator in registers, p as the register A
//     operand of p v, the keys past N masked on the last tile only, the
//     biased and unbiased cases two instances chosen at compile time, and
//     the output through a swizzled bf16 stage with 16-byte stores. Several
//     blocks an SM (49 KB of shared memory, 128 registers a thread) overlap
//     one block's exp pass with another's products. A block of two
//     warpgroups sharing the ring (128 rows, half the L2 traffic a row) ran
//     in lockstep, its barrier each tile keeping both exp passes together,
//     and was no faster (PERF.md §6): it is not kept.
//   * every other case (fp32, and bf16 at d = 16, 32, 128): the first
//     version's body. One block of 4 warps per (b*h, 64-row q tile), each
//     warp 16 rows; 64-key tiles of k and v staged in shared memory with
//     16-byte loads, rows past N zero-filled; bf16 on nvcuda::wmma
//     16x16x16 with S, P and the accumulator in shared memory, fp32 on the
//     CUDA cores (TF32 would keep only ~3 digits); online softmax in fp32
//     from m = -1e30, keys past N at -1e30; p cast to the input dtype before
//     p v, the accumulator divided by l at the end.
// Both round q * scale to the input dtype before q k^T, as the plain
// version does. When a gradient is wanted the caller passes `lse`, fp32
// [B, H, N]: each row's natural-log log-sum-exp, the residual K2
// (flash_attention_bwd.cu) normalises its recomputed p with; serving
// passes null and nothing more is written.
// TMA, warp specialisation and a persistent grid are left for later
// versions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

#include "attention_tiles.cuh"
#include "wgmma_attention.cuh"

namespace {

using namespace nvcuda;
using vtm::from_float;
using vtm::load_tile;

constexpr int kBlockQ = vtm::kTileRows;  // query rows per thread block
constexpr int kBlockK = vtm::kTileRows;  // keys per tile
constexpr int kWarps = 4;                // each warp owns 16 query rows
constexpr int kThreads = kWarps * 32;
static_assert(kThreads == vtm::kTileThreads, "load_tile strides by the block's thread count");
constexpr float kMask = -1e30f;
static_assert(kBlockQ == kWarps * 16, "each warp owns a 16-row strip");

// Element strides (batch, head, row) of q, k, v and out; the last dim is
// contiguous. Row strides let the split_heads view of the fused qkv
// projection be read without a copy.
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

// Shared-memory layout. Row pads of 16 bytes break bank conflicts and keep
// every 16-row fragment origin 32-byte aligned, as wmma requires.
template <typename T, int D>
struct Layout {
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int ld_qkv = D + kPad;     // Q, K, V tiles (T)
  static constexpr int ld_s = kBlockK + 4;    // logits (fp32)
  static constexpr int ld_p = kBlockK + kPad; // probabilities (T)
  static constexpr int ld_o = D + 4;          // accumulator (fp32)
  static constexpr size_t q_bytes = size_t(kBlockQ) * ld_qkv * sizeof(T);
  static constexpr size_t kv_bytes = size_t(kBlockK) * ld_qkv * sizeof(T);
  static constexpr size_t s_bytes = size_t(kBlockQ) * ld_s * sizeof(float);
  static constexpr size_t p_bytes = size_t(kBlockQ) * ld_p * sizeof(T);
  static constexpr size_t o_bytes = size_t(kBlockQ) * ld_o * sizeof(float);
  static constexpr size_t k_off = q_bytes;
  static constexpr size_t v_off = k_off + kv_bytes;
  static constexpr size_t s_off = v_off + kv_bytes;
  static constexpr size_t p_off = s_off + s_bytes;
  static constexpr size_t o_off = p_off + p_bytes;
  static constexpr size_t bytes = o_off + o_bytes;
  static_assert(q_bytes % 128 == 0 && kv_bytes % 128 == 0 && s_bytes % 128 == 0 &&
                    p_bytes % 128 == 0,
                "shared regions must stay 128-byte aligned");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const float* __restrict__ key_bias,
                         T* __restrict__ out, float* __restrict__ lse, int num_heads, int n,
                         float scale, Strides st) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = reinterpret_cast<T*>(smem + L::k_off);
  T* vs = reinterpret_cast<T*>(smem + L::v_off);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);
  T* ps = reinterpret_cast<T*>(smem + L::p_off);
  float* os = reinterpret_cast<float*>(smem + L::o_off);

  const int bh = blockIdx.y;
  const int b = bh / num_heads;
  const int h = bh % num_heads;
  const int q0 = blockIdx.x * kBlockQ;
  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* kb = k + b * st.k[0] + h * st.k[1];
  const T* vb = v + b * st.v[0] + h * st.v[1];
  T* ob = out + b * st.o[0] + h * st.o[1];
  const float* bias = key_bias ? key_bias + static_cast<long long>(b) * n : nullptr;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow = warp * 16;             // first row of this warp's strip
  const int row = wrow + (lane >> 1);     // the row this lane's softmax owns
  const int half = lane & 1;              // which half of the row it owns

  load_tile<T, D, true>(qs, L::ld_qkv, qb, st.q[2], q0, n, scale);
  for (int i = threadIdx.x; i < kBlockQ * L::ld_o; i += kThreads) os[i] = 0.f;
  __syncthreads();

  float m_i = kMask;  // running max of this lane's row
  float l_i = 0.f;    // running denominator of this lane's row

  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    load_tile<T, D, false>(ks, L::ld_qkv, kb, st.k[2], k0, n, 0.f);
    load_tile<T, D, false>(vs, L::ld_qkv, vb, st.v[2], k0, n, 0.f);
    __syncthreads();

    // ---- s = (q * scale) k^T for this warp's 16 rows --------------------
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bt;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
#pragma unroll
      for (int nt = 0; nt < kBlockK / 16; ++nt) {
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::load_matrix_sync(a, qs + wrow * L::ld_qkv + kk * 16, L::ld_qkv);
          // k^T as a column-major [d, key] operand: element (d, j) at ks[j * ld + d]
          wmma::load_matrix_sync(bt, ks + nt * 16 * L::ld_qkv + kk * 16, L::ld_qkv);
          wmma::mma_sync(acc, a, bt, acc);
        }
        wmma::store_matrix_sync(ss + wrow * L::ld_s + nt * 16, acc, L::ld_s, wmma::mem_row_major);
      }
    } else {
      const T* qr = qs + row * L::ld_qkv;
      for (int j = half * 32; j < half * 32 + 32; ++j) {
        const T* kr = ks + j * L::ld_qkv;
        float acc = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
        ss[row * L::ld_s + j] = acc;
      }
    }
    __syncwarp();

    // ---- online softmax over this lane's half row -----------------------
    float* srow = ss + row * L::ld_s + half * 32;
    float mx = kMask;
    for (int j = 0; j < 32; ++j) {
      const int key = k0 + half * 32 + j;
      float s = kMask;
      if (key < n) s = bias ? srow[j] + bias[key] : srow[j];
      srow[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float corr = expf(m_i - m_new);
    float sum = 0.f;
    T* prow = ps + row * L::ld_p + half * 32;
    for (int j = 0; j < 32; ++j) {
      const float p = expf(srow[j] - m_new);
      prow[j] = from_float<T>(p);
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_i = l_i * corr + sum;
    m_i = m_new;
    float* orow = os + row * L::ld_o + half * (D / 2);
    for (int d = 0; d < D / 2; ++d) orow[d] *= corr;
    __syncwarp();

    // ---- acc += p v ------------------------------------------------------
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt) {
        wmma::load_matrix_sync(acc, os + wrow * L::ld_o + dt * 16, L::ld_o, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < kBlockK / 16; ++kk) {
          wmma::load_matrix_sync(a, ps + wrow * L::ld_p + kk * 16, L::ld_p);
          wmma::load_matrix_sync(bv, vs + kk * 16 * L::ld_qkv + dt * 16, L::ld_qkv);
          wmma::mma_sync(acc, a, bv, acc);
        }
        wmma::store_matrix_sync(os + wrow * L::ld_o + dt * 16, acc, L::ld_o, wmma::mem_row_major);
      }
    } else {
      const T* pr = ps + row * L::ld_p;
      for (int d = half * (D / 2); d < half * (D / 2) + D / 2; ++d) {
        float acc = os[row * L::ld_o + d];
#pragma unroll 16
        for (int j = 0; j < kBlockK; ++j) acc = fmaf(pr[j], vs[j * L::ld_qkv + d], acc);
        os[row * L::ld_o + d] = acc;
      }
    }
    __syncthreads();  // k/v/p tiles are overwritten by the next iteration
  }

  // ---- out = acc / l, in T --------------------------------------------
  if (q0 + row < n) {
    T* orow_g = ob + (q0 + row) * st.o[2];
    const float* orow = os + row * L::ld_o;
    for (int d = half * (D / 2); d < half * (D / 2) + D / 2; ++d)
      orow_g[d] = from_float<T>(orow[d] / l_i);
    if (lse && half == 0) lse[static_cast<long long>(bh) * n + q0 + row] = m_i + logf(l_i);
  }
}

// ======================= Hopper body (bf16, d = 64) =======================

namespace wg = vtm::wg;
using bf16 = __nv_bfloat16;
using WgSmem = wg::WalkSmem;

template <bool kBias>
__global__ void __launch_bounds__(wg::kThreads)
    attention_fwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ key_bias,
                        bf16* __restrict__ out, float* __restrict__ lse, int num_heads, int n,
                        float scale, Strides st) {
  extern __shared__ unsigned char smem[];
  const int bh = blockIdx.y;
  const int b = bh / num_heads;
  const int h = bh % num_heads;
  wg::Walk w;
  w.q = q + b * st.q[0] + h * st.q[1];
  w.k = k + b * st.k[0] + h * st.k[1];
  w.v = v + b * st.v[0] + h * st.v[1];
  w.q_stride = st.q[2];
  w.k_stride = st.k[2];
  w.v_stride = st.v[2];
  w.bias = kBias ? key_bias + static_cast<long long>(b) * n : nullptr;
  w.out = out + b * st.o[0] + h * st.o[1];
  w.out_stride = st.o[2];
  w.out_frame_stride = 0;
  w.lse = lse ? lse + static_cast<long long>(bh) * n : nullptr;
  w.lse_frame_stride = 0;
  w.row0 = blockIdx.x * wg::kRows;
  w.rows = n;
  w.frames = 1;
  w.frame_len = n;
  w.scale = scale;
  wg::attend<kBias>(w, wg::AllPairs(), smem);
}

template <bool kBias>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* key_bias,
                         void* out, void* lse, int batch, int num_heads, int n, float scale,
                         const Strides& st, cudaStream_t stream) {
  auto kernel = attention_fwd_wgmma<kBias>;
  static bool done[vtm::kMaxDevices] = {};
  cudaError_t err = vtm::allow_smem_once(kernel, WgSmem::kLaunchBytes, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + wg::kRows - 1) / wg::kRows, batch * num_heads);
  kernel<<<grid, wg::kThreads, WgSmem::kLaunchBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(key_bias), static_cast<bf16*>(out), static_cast<float*>(lse),
      num_heads, n, scale, st);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* key_bias, void* out,
                   void* lse, int batch, int num_heads, int n, float scale, const Strides& st,
                   cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value && D == 64) {
    return key_bias ? launch_wgmma<true>(q, k, v, key_bias, out, lse, batch, num_heads, n, scale, st, stream)
                    : launch_wgmma<false>(q, k, v, key_bias, out, lse, batch, num_heads, n, scale, st, stream);
  } else {
    using L = Layout<T, D>;
    auto kernel = attention_fwd_kernel<T, D>;
    static bool done[vtm::kMaxDevices] = {};
    cudaError_t err = vtm::allow_smem_once(kernel, static_cast<int>(L::bytes), done);
    if (err != cudaSuccess) return err;
    const dim3 grid((n + kBlockQ - 1) / kBlockQ, batch * num_heads);
    kernel<<<grid, kThreads, L::bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(key_bias), static_cast<T*>(out), static_cast<float*>(lse),
        num_heads, n, scale, st);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t dispatch_head_dim(int head_dim, const void* q, const void* k, const void* v,
                              const void* key_bias, void* out, void* lse, int batch,
                              int num_heads, int n, float scale, const Strides& st,
                              cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(q, k, v, key_bias, out, lse, batch, num_heads, n, scale, st, stream);
    case 32: return launch<T, 32>(q, k, v, key_bias, out, lse, batch, num_heads, n, scale, st, stream);
    case 64: return launch<T, 64>(q, k, v, key_bias, out, lse, batch, num_heads, n, scale, st, stream);
    case 128: return launch<T, 128>(q, k, v, key_bias, out, lse, batch, num_heads, n, scale, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, bound with ctypes by vtm_torch/ops/flash_attention.py.
//   dtype: 0 = bf16, 1 = fp32 (q, k, v and out share it)
//   key_bias: fp32 [batch, n] contiguous, or null for the unbiased form
//   lse: fp32 [batch, num_heads, n] contiguous, each row's log-sum-exp, or
//        null when no gradient is wanted
//   strides: 12 element strides, (batch, head, row) of q, k, v, out
// Returns the cudaError_t of the launch (0 on success).
extern "C" int vtm_attention_fwd(int dtype, int head_dim, const void* q, const void* k,
                                 const void* v, const void* key_bias, void* out, void* lse,
                                 int batch, int num_heads, int n, float scale,
                                 const long long* strides, void* stream) {
  Strides st;
  std::memcpy(&st, strides, sizeof(st));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_head_dim<__nv_bfloat16>(head_dim, q, k, v, key_bias, out, lse, batch,
                                              num_heads, n, scale, st, s);
    case 1:
      return dispatch_head_dim<float>(head_dim, q, k, v, key_bias, out, lse, batch, num_heads, n,
                                      scale, st, s);
    default:
      return cudaErrorInvalidValue;
  }
}
