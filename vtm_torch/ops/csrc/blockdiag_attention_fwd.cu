// Block-diagonal (per-frame) attention forward for Hopper (sm_90a): for
// q, k, v [B, H, F*s, d], frame-major, the queries of frame f attend only
// to the keys of frame f,
//   out[b, f*s + i, h, :] = softmax_j(q_i k_j^T * scale + m_i * key_bias[b, f*s + j]) v_j
// with i, j in [0, s) and the row mask m_i = 1, or with exclude_first_row
// m_0 = 0 (row 0 of every frame, TimeSformer's broadcast CLS query, sees no
// bias). The output is token-major with merged heads, [B, F*s, H*d]. When
// a gradient is wanted it also writes the log-sum-exp of each row's logits
// (every row belongs to one frame), fp32 [B, H, F*s]: K5b's residual
// (blockdiag_attention_bwd.cu), with out itself.
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
// Two bodies. Both go through a launch plan the wrapper computes
// (ops/flash_attention.py::blockdiag_plan) and passes as ints: frames per
// block, 64-row query tiles per frame, blocks per (b, h).
//   * bf16 at d = 64, the head dimension of every ViT-B path: the Hopper
//     tile loop of wgmma_attention.cuh (shared with K1 and K3), one
//     warpgroup a block. Frames of more than 32 tokens: frame-aligned
//     64-row query tiles, each walking its frame's ceil(s/64) key tiles,
//     the keys past the frame's end masked on the last one. Frames of at
//     most 32 tokens: g = 64 / s whole frames packed into one 64-row
//     tile, rows [f0 s, (f0 + g) s) of [B, H, F*s, d] (a clip's frames
//     are contiguous), and one 64-key tile holding the same g frames'
//     keys; each row's keys are its frame's window [f s, (f + 1) s),
//     found once a thread (one division a row: a division a pair cost
//     about 5 us a call at s = 10, PERF.md) and compared on the S
//     accumulator in registers, and a clip's last block holds F mod g
//     frames. At s = 10 a block works on 60 of its 64 rows where one
//     frame a block would use 10. Under exclude_first_row the bias skips
//     row 0 of every frame: in a packed tile, each row r with (r - f0 s)
//     % s == 0. S, P and the accumulator stay in registers (wgmma), k/v
//     stream through a cp.async ring, and the biased and unbiased cases
//     are two instances chosen at compile time.
//   * every other case (fp32, and bf16 at d = 16, 32, 128): the first
//     version's body, one frame a block. One thread block of 4 warps per
//     (b*h, frame, 64-row q tile of the frame); each warp owns 16 query
//     rows. A loop walks the frame's keys in 64-key tiles staged in shared
//     memory with 16-byte loads. A tile never runs over into the next
//     frame: rows at or past the frame's end are zero-filled, their logits
//     are -1e30, and query rows past the end are never stored; the 16-wide
//     key groups past the frame's end are skipped in both products. bf16
//     runs the products on nvcuda::wmma 16x16x16 with S, P and the
//     accumulator in shared memory; fp32 runs them as FMAs on the CUDA
//     cores, so fp32 results stay within fp32 rounding of the plain version.
// Nothing is padded in device memory: s = 197, 179, ..., 10 go in as they
// are, and a frame's first row is 16-byte aligned because every row of the
// fused qkv buffer is. Rounding points: q * scale is rounded to the input
// dtype before q k^T (as the plain version does); the softmax is online,
// in fp32; p is cast to the input dtype before p v and the fp32 accumulator
// is divided by the denominator afterwards, as the TPU kernel does. The
// plain version normalises p in fp32 before the cast: in bf16 the two
// differ by bf16 rounding of p, which the checks hold to the plain bf16
// version's own error.
// TMA, several heads per block and warp specialisation are left for later
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
                                   T* __restrict__ out, float* __restrict__ lse, int num_heads,
                                   int frames, int s_len, int tiles_per_frame,
                                   int exclude_first_row, float scale, Strides st) {
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
  if (lse != nullptr && half == 0 && q0 + row < s_len)
    lse[static_cast<long long>(bh) * frames * s_len + frame0 + q0 + row] = m_i + logf(l_i);
  if (q0 + row < s_len) {
    T* orow_g = ob + (q0 + row) * st.o[2];
    const float* orow = os + row * L::ld_o;
    for (int d = half * (D / 2); d < half * (D / 2) + D / 2; ++d)
      orow_g[d] = from_float<T>(orow[d] / l_i);
  }
}

// ======================= Hopper body (bf16, d = 64) =======================

namespace wg = vtm::wg;
using bf16 = __nv_bfloat16;
using WgSmem = wg::WalkSmem;
using Plan = wg::BlockdiagPlan;

template <bool kBias, bool kPacked>
__global__ void __launch_bounds__(wg::kThreads)
    blockdiag_attention_fwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                  const bf16* __restrict__ v, const float* __restrict__ key_bias,
                                  bf16* __restrict__ out, float* __restrict__ lse, int num_heads,
                                  int frames, int s_len, Plan plan, int exclude_first_row,
                                  float scale, Strides st) {
  extern __shared__ unsigned char smem[];
  const int bh = blockIdx.y;
  const int b = bh / num_heads;
  const int h = bh % num_heads;
  int f0, q0, len;  // the block's first frame, first row within it, keys walked
  if constexpr (kPacked) {
    f0 = blockIdx.x * plan.frames_per_block;
    q0 = 0;
    len = min(plan.frames_per_block, frames - f0) * s_len;
  } else {
    f0 = blockIdx.x / plan.tiles_per_frame;
    q0 = (blockIdx.x % plan.tiles_per_frame) * wg::kRows;
    len = s_len;
  }
  const long long row0 = static_cast<long long>(f0) * s_len;  // the first frame's first row
  wg::Walk w;
  w.q = q + b * st.q[0] + h * st.q[1] + row0 * st.q[2];
  w.k = k + b * st.k[0] + h * st.k[1] + row0 * st.k[2];
  w.v = v + b * st.v[0] + h * st.v[1] + row0 * st.v[2];
  w.q_stride = st.q[2];
  w.k_stride = st.k[2];
  w.v_stride = st.v[2];
  w.bias = kBias ? key_bias + static_cast<long long>(b) * frames * s_len + row0 : nullptr;
  w.out = out + b * st.o[0] + h * st.o[1] + row0 * st.o[2];
  w.out_stride = st.o[2];
  w.out_frame_stride = 0;
  w.lse = lse ? lse + static_cast<long long>(bh) * frames * s_len + row0 : nullptr;
  w.lse_frame_stride = 0;
  w.row0 = q0;
  w.rows = len;
  w.frames = 1;
  w.frame_len = len;
  w.scale = scale;
  if constexpr (kPacked) {
    wg::attend<kBias>(w, wg::PackedFrames{s_len, exclude_first_row != 0}, smem);
  } else {
    wg::attend<kBias>(w, wg::FrameRows{exclude_first_row != 0}, smem);
  }
}

template <bool kBias, bool kPacked>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* key_bias,
                         void* out, void* lse, int batch, int num_heads, int frames, int s_len,
                         const Plan& plan, int exclude_first_row, float scale, const Strides& st,
                         cudaStream_t stream) {
  auto kernel = blockdiag_attention_fwd_wgmma<kBias, kPacked>;
  static bool done[vtm::kMaxDevices] = {};
  cudaError_t err = vtm::allow_smem_once(kernel, WgSmem::kLaunchBytes, done);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(plan.blocks, batch * num_heads), wg::kThreads, WgSmem::kLaunchBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(key_bias), static_cast<bf16*>(out), static_cast<float*>(lse), num_heads,
      frames, s_len, plan, exclude_first_row, scale, st);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* key_bias, void* out,
                   void* lse, int batch, int num_heads, int frames, int s_len, const Plan& plan,
                   int exclude_first_row, float scale, const Strides& st, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value && D == 64) {
    const bool packed = plan.frames_per_block > 1;
    if (key_bias)
      return packed ? launch_wgmma<true, true>(q, k, v, key_bias, out, lse, batch, num_heads, frames, s_len,
                                               plan, exclude_first_row, scale, st, stream)
                    : launch_wgmma<true, false>(q, k, v, key_bias, out, lse, batch, num_heads, frames, s_len,
                                                plan, exclude_first_row, scale, st, stream);
    return packed ? launch_wgmma<false, true>(q, k, v, key_bias, out, lse, batch, num_heads, frames, s_len,
                                              plan, exclude_first_row, scale, st, stream)
                  : launch_wgmma<false, false>(q, k, v, key_bias, out, lse, batch, num_heads, frames, s_len,
                                               plan, exclude_first_row, scale, st, stream);
  } else {
    if (plan.frames_per_block != 1) return cudaErrorInvalidValue;  // the first body packs nothing
    using L = Layout<T, D>;
    auto kernel = blockdiag_attention_fwd_kernel<T, D>;
    static bool done[vtm::kMaxDevices] = {};
    cudaError_t err = vtm::allow_smem_once(kernel, static_cast<int>(L::bytes), done);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(plan.blocks, batch * num_heads), kThreads, L::bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(key_bias), static_cast<T*>(out), static_cast<float*>(lse), num_heads,
        frames, s_len, plan.tiles_per_frame, exclude_first_row, scale, st);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t dispatch_head_dim(int head_dim, const void* q, const void* k, const void* v,
                              const void* key_bias, void* out, void* lse, int batch, int num_heads,
                              int frames, int s_len, const Plan& plan, int exclude_first_row,
                              float scale, const Strides& st, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(q, k, v, key_bias, out, lse, batch, num_heads, frames, s_len, plan,
                           exclude_first_row, scale, st, stream);
    case 32:
      return launch<T, 32>(q, k, v, key_bias, out, lse, batch, num_heads, frames, s_len, plan,
                           exclude_first_row, scale, st, stream);
    case 64:
      return launch<T, 64>(q, k, v, key_bias, out, lse, batch, num_heads, frames, s_len, plan,
                           exclude_first_row, scale, st, stream);
    case 128:
      return launch<T, 128>(q, k, v, key_bias, out, lse, batch, num_heads, frames, s_len, plan,
                            exclude_first_row, scale, st, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, bound with ctypes by vtm_torch/ops/flash_attention.py.
//   dtype: 0 = bf16, 1 = fp32 (q, k, v and out share it)
//   key_bias: fp32 [batch, n] contiguous, or null for the unbiased form
//   lse: fp32 [batch, num_heads, n] contiguous, each row's log-sum-exp, or
//        null when not wanted
//   n = frames * s tokens, frame-major; exclude_first_row: 1 keeps the bias
//   off row 0 of every frame
//   frames_per_block, tiles_per_frame, blocks: the launch plan
//   (ops/flash_attention.py::blockdiag_plan); frames_per_block > 1 only for
//   the bf16 d = 64 body
//   strides: 12 element strides, (batch, head, row) of q, k, v, out
// Returns the cudaError_t of the launch (0 on success).
extern "C" int vtm_blockdiag_attention_fwd(int dtype, int head_dim, const void* q, const void* k,
                                           const void* v, const void* key_bias, void* out,
                                           void* lse, int batch, int num_heads, int n, int frames,
                                           int exclude_first_row, int frames_per_block,
                                           int tiles_per_frame, int blocks, float scale,
                                           const long long* strides, void* stream) {
  if (frames < 1 || n < 1 || n % frames != 0) return cudaErrorInvalidValue;
  const Plan plan{frames_per_block, tiles_per_frame, blocks};
  if (!plan.covers(frames, n / frames)) return cudaErrorInvalidValue;
  Strides st;
  std::memcpy(&st, strides, sizeof(st));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_head_dim<__nv_bfloat16>(head_dim, q, k, v, key_bias, out, lse, batch,
                                              num_heads, frames, n / frames, plan,
                                              exclude_first_row, scale, st, s);
    case 1:
      return dispatch_head_dim<float>(head_dim, q, k, v, key_bias, out, lse, batch, num_heads,
                                      frames, n / frames, plan, exclude_first_row, scale, st, s);
    default:
      return cudaErrorInvalidValue;
  }
}
