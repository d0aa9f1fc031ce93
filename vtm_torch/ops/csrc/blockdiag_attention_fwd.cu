// Block-diagonal (per-frame) attention forward for Hopper (sm_90a): for
// q, k, v [B, H, F*s, d], frame-major, the queries of frame f attend only
// to the keys of frame f,
//   out[b, f*s + i, h, :] = softmax_j(q_i k_j^T * scale + m_i * key_bias[b, f*s + j]) v_j
// with i, j in [0, s) and the row mask m_i = 1, or with exclude_first_row
// m_0 = 0 (row 0 of every frame, TimeSformer's broadcast CLS query, sees no
// bias). The output is token-major with merged heads, [B, F*s, H*d].
//
// Replaces the Pallas TPU kernel of vtm/ops/flash_attention.py::
// _blockdiag_forward (kernel _make_blockdiag_kernel, reached through
// tome_blockdiag_attention): TimeSformer's divided spatial attention.
//
// What bounds it on the H100: at B8 H12 d64 F8 s197 one call is
// 4*B*H*F*s^2*d = 7.6 GFLOP against about 77 MB of q/k/v/out, about 98 FLOP
// per byte -- below the card's ~295 FLOP/byte bf16 ridge. The kernel is
// bound by device memory, and the merged layers (s = 179 ... 10) more so.
//
// Why the plain PyTorch version (ops/flash_attention.py::
// _blockdiag_reference) loses: it writes and reads back a [B, H, F, s, s]
// fp32 logits tensor (119 MB at that shape) plus the softmax and the
// probabilities in the input dtype. This kernel keeps a [64 x 64] tile of
// them in shared memory.
//
// Design (first version: simple and right, not fast):
//   * one thread block of 4 warps per (b*h, frame, 64-row q tile of the
//     frame); each warp owns 16 query rows. A loop walks the frame's keys
//     in 64-key tiles staged in shared memory with 16-byte loads. A tile
//     never runs over into the next frame: rows at or past the frame's end
//     are zero-filled, their logits are -1e30, and query rows past the end
//     are never stored. Nothing is padded in device memory: s = 197, 179,
//     ..., 10 go in as they are, and a frame's first row is 16-byte aligned
//     because every row of the fused qkv buffer is.
//   * the 16-wide key groups past the frame's end are skipped in both
//     products; the logits they would have written are never read (the
//     softmax masks by key index) and their probabilities are written as 0.
//   * bf16: q k^T and p v run on the tensor cores (nvcuda::wmma bf16
//     16x16x16, fp32 accumulation). fp32: the same loop with fp32 FMAs on
//     the CUDA cores, so fp32 results stay within fp32 rounding of the
//     plain version.
//   * rounding points: q * scale is rounded to the input dtype before
//     q k^T (as the plain version does); the softmax is online, in fp32,
//     from m = -1e30; p = exp(s - m) is cast to the input dtype before p v
//     and the fp32 accumulator is divided by the denominator afterwards,
//     as the TPU kernel does. The plain version normalises p in fp32
//     before the cast: in bf16 the two differ by bf16 rounding of p, which
//     the checks hold to the plain bf16 version's own error.
// wgmma, TMA, several frames or heads per block at small s, and warp
// specialisation are left for later versions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

#include "attention_tiles.cuh"

namespace {

using namespace nvcuda;
using vtm::from_float;
using vtm::load_tile;

constexpr int kBlockQ = vtm::kTileRows;  // query rows per thread block
constexpr int kBlockK = vtm::kTileRows;  // keys per tile
constexpr int kWarps = 4;                // each warp owns 16 query rows
constexpr int kThreads = kWarps * 32;
static_assert(kThreads == vtm::kTileThreads, "load_tile strides by the block's thread count");
constexpr float kMask = vtm::kMask;
static_assert(kBlockQ == kWarps * 16, "each warp owns a 16-row strip");

// Element strides (batch, head, row) of q, k, v and out; the last dim is
// contiguous. Row strides let the views of the fused qkv projection be
// read, and the token-major output be written, without a copy.
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
    blockdiag_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                   const T* __restrict__ v, const float* __restrict__ key_bias,
                                   T* __restrict__ out, int num_heads, int frames, int s_len,
                                   int tiles_per_frame, int exclude_first_row, float scale,
                                   Strides st) {
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
  const int f = blockIdx.x / tiles_per_frame;
  const int q0 = (blockIdx.x % tiles_per_frame) * kBlockQ;  // within the frame
  const long long frame0 = static_cast<long long>(f) * s_len;  // the frame's first row
  // everything below indexes rows and keys within the frame: [0, s_len)
  const T* qb = q + b * st.q[0] + h * st.q[1] + frame0 * st.q[2];
  const T* kb = k + b * st.k[0] + h * st.k[1] + frame0 * st.k[2];
  const T* vb = v + b * st.v[0] + h * st.v[1] + frame0 * st.v[2];
  T* ob = out + b * st.o[0] + h * st.o[1] + frame0 * st.o[2];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow = warp * 16;             // first row of this warp's strip
  const int row = wrow + (lane >> 1);     // the row this lane's softmax owns
  const int half = lane & 1;              // which half of the row it owns
  // the row mask: with exclude_first_row, row 0 of the frame sees no bias
  const float* bias = nullptr;
  if (key_bias != nullptr && !(exclude_first_row && q0 + row == 0))
    bias = key_bias + static_cast<long long>(b) * frames * s_len + frame0;

  load_tile<T, D, true>(qs, L::ld_qkv, qb, st.q[2], q0, s_len, scale);
  for (int i = threadIdx.x; i < kBlockQ * L::ld_o; i += kThreads) os[i] = 0.f;
  __syncthreads();

  float m_i = kMask;  // running max of this lane's row
  float l_i = 0.f;    // running denominator of this lane's row

  for (int k0 = 0; k0 < s_len; k0 += kBlockK) {
    // 16-wide key groups of this tile that hold a key of the frame
    const int left = s_len - k0;
    const int cols = left >= kBlockK ? kBlockK : (left + 15) / 16 * 16;
    load_tile<T, D, false>(ks, L::ld_qkv, kb, st.k[2], k0, s_len, 0.f);
    load_tile<T, D, false>(vs, L::ld_qkv, vb, st.v[2], k0, s_len, 0.f);
    __syncthreads();

    // ---- s = (q * scale) k^T for this warp's 16 rows --------------------
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bt;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
#pragma unroll
      for (int nt = 0; nt < kBlockK / 16; ++nt) {
        if (nt * 16 >= cols) break;
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
      for (int j = half * 32; j < half * 32 + 32 && j < cols; ++j) {
        const T* kr = ks + j * L::ld_qkv;
        float acc = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
        ss[row * L::ld_s + j] = acc;
      }
    }
    __syncwarp();

    // ---- online softmax over this lane's half row -----------------------
    // A logit past the frame's end was never computed: it is read as -1e30.
    float* srow = ss + row * L::ld_s + half * 32;
    float mx = kMask;
    for (int j = 0; j < 32; ++j) {
      const int key = k0 + half * 32 + j;
      float s = kMask;
      if (key < s_len) s = bias ? srow[j] + bias[key] : srow[j];
      srow[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float corr = expf(m_i - m_new);
    float sum = 0.f;
    T* prow = ps + row * L::ld_p + half * 32;
    for (int j = 0; j < 32; ++j) {
      const float p = k0 + half * 32 + j < s_len ? expf(srow[j] - m_new) : 0.f;
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
          if (kk * 16 >= cols) break;
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
        for (int j = 0; j < cols; ++j) acc = fmaf(pr[j], vs[j * L::ld_qkv + d], acc);
        os[row * L::ld_o + d] = acc;
      }
    }
    __syncthreads();  // k/v/p tiles are overwritten by the next iteration
  }

  // ---- out = acc / l, in T; rows past the frame's end are not stored ----
  if (q0 + row < s_len) {
    T* orow_g = ob + (q0 + row) * st.o[2];
    const float* orow = os + row * L::ld_o;
    for (int d = half * (D / 2); d < half * (D / 2) + D / 2; ++d)
      orow_g[d] = from_float<T>(orow[d] / l_i);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* key_bias, void* out,
                   int batch, int num_heads, int frames, int s_len, int exclude_first_row,
                   float scale, const Strides& st, cudaStream_t stream) {
  using L = Layout<T, D>;
  auto kernel = blockdiag_attention_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::bytes));
  if (err != cudaSuccess) return err;
  const int tiles_per_frame = (s_len + kBlockQ - 1) / kBlockQ;
  const dim3 grid(frames * tiles_per_frame, batch * num_heads);
  kernel<<<grid, kThreads, L::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(key_bias), static_cast<T*>(out), num_heads, frames, s_len,
      tiles_per_frame, exclude_first_row, scale, st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(int head_dim, const void* q, const void* k, const void* v,
                              const void* key_bias, void* out, int batch, int num_heads,
                              int frames, int s_len, int exclude_first_row, float scale,
                              const Strides& st, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(q, k, v, key_bias, out, batch, num_heads, frames, s_len,
                           exclude_first_row, scale, st, stream);
    case 32:
      return launch<T, 32>(q, k, v, key_bias, out, batch, num_heads, frames, s_len,
                           exclude_first_row, scale, st, stream);
    case 64:
      return launch<T, 64>(q, k, v, key_bias, out, batch, num_heads, frames, s_len,
                           exclude_first_row, scale, st, stream);
    case 128:
      return launch<T, 128>(q, k, v, key_bias, out, batch, num_heads, frames, s_len,
                            exclude_first_row, scale, st, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, bound with ctypes by vtm_torch/ops/flash_attention.py.
//   dtype: 0 = bf16, 1 = fp32 (q, k, v and out share it)
//   key_bias: fp32 [batch, n] contiguous, or null for the unbiased form
//   n = frames * s tokens, frame-major; exclude_first_row: 1 keeps the bias
//   off row 0 of every frame
//   strides: 12 element strides, (batch, head, row) of q, k, v, out
// Returns the cudaError_t of the launch (0 on success).
extern "C" int vtm_blockdiag_attention_fwd(int dtype, int head_dim, const void* q, const void* k,
                                           const void* v, const void* key_bias, void* out,
                                           int batch, int num_heads, int n, int frames,
                                           int exclude_first_row, float scale,
                                           const long long* strides, void* stream) {
  if (frames < 1 || n < 1 || n % frames != 0) return cudaErrorInvalidValue;
  Strides st;
  std::memcpy(&st, strides, sizeof(st));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_head_dim<__nv_bfloat16>(head_dim, q, k, v, key_bias, out, batch, num_heads,
                                              frames, n / frames, exclude_first_row, scale, st, s);
    case 1:
      return dispatch_head_dim<float>(head_dim, q, k, v, key_bias, out, batch, num_heads, frames,
                                      n / frames, exclude_first_row, scale, st, s);
    default:
      return cudaErrorInvalidValue;
  }
}
