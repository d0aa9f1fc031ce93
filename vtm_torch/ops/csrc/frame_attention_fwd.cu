// Per-frame (trajectory) attention forward for Hopper (sm_90a):
//   out[b, i, f, h, :] = sum_{j in frame f} softmax_j(q_i . k_j * scale + key_bias[b, j]) v_j
// over q, k, v [B, H, N, d], where frame f is the contiguous key segment
// [f*s, (f+1)*s), s = N / F, and every frame has a softmax of its own.
// The output is token-major [B, N, F, H, d], so the model's [B, N, F, D]
// view of it is free. This is the spatial step of Motionformer's
// trajectory attention. When a gradient is wanted it also writes the
// log-sum-exp of each row's logits in each frame, fp32 [B, H, F, N]: K4's
// residual (frame_attention_bwd.cu), with out itself.
//
// Replaces the Pallas TPU kernel of vtm/ops/flash_attention.py::
// _frame_forward_tm_s8 (kernel _make_frame_tm_s8_kernel, reached through
// tome_frame_attention), and with it the layout variants _frame_forward_tm
// (lane-major, head pairs) and _frame_forward (odd head counts), which
// compute the same math.
//
// What bounds it on the H100: at B8 H12 N1568 F8 d64 one call is
// 4*B*H*N^2*d = 60.4 GFLOP, the same as dense attention at that N, and it
// writes 154 MB of output (F times the size of q) against 58 MB of q/k/v
// read: about 285 FLOP per byte, at the card's ~295 FLOP/byte bf16 ridge,
// and the least time is set by the bytes (0.063 ms) by a hair. The plain
// PyTorch version (ops/flash_attention.py::_frame_reference) also writes
// and reads back a [B, H, N, N] fp32 logits tensor, 944 MB at that shape,
// plus the probabilities.
//
// Grid: one block per (b*h, 64-row q tile). The q tile (q * scale rounded
// to the input dtype) is staged once and reused for all F frames, as the
// TPU kernel gives one program every frame's keys; rows past N are
// zero-filled and not stored. Two bodies:
//   * bf16 at d = 64, the head dimension of every ViT-B path: the Hopper
//     tile loop of wgmma_attention.cuh (shared with K1 and K5a), one
//     warpgroup (128 threads) a block walking the F frames in turn with an
//     online softmax per frame. Each frame's 64-key tiles of k and v stream
//     through a two-stage cp.async ring (the next tile, of this frame or the
//     next, is in flight while the current one is used); S = q k^T and
//     out_f += p v run on wgmma with fp32 accumulators in registers; the key
//     bias is added, and keys past the frame's end get -1e30 on its ragged
//     last tile, where the running max is taken; p = exp2 in the log2
//     domain is rounded to bf16 in registers. The running max and
//     denominator restart at each frame boundary; at the frame's end the
//     accumulator is divided by the denominator and leaves through a
//     swizzled bf16 stage with 16-byte stores at row stride F*H*d, while
//     the next frame's first tile is already loading. Shared memory does
//     not depend on the frame length. The biased and unbiased cases are two
//     instances chosen at compile time.
//   * every other case (fp32, and bf16 at d = 16, 32, 128): the first
//     version's body. S for the whole frame goes into a shared fp32 buffer
//     of [64 x ceil64(s)] (up to 132 KB at s = 512); an exact softmax
//     over the frame's s keys, one warp per row; p normalised in fp32 and
//     rounded to the input dtype before the product with v, as the TPU s8
//     kernel does. bf16 runs the products on wmma 16x16x16; fp32 runs them
//     as FMAs on the CUDA cores (TF32 would keep only ~3 digits).
// TMA, warp specialisation and a persistent grid are left for later
// versions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "attention_tiles.cuh"
#include "wgmma_attention.cuh"

namespace {

using namespace nvcuda;
using vtm::from_float;
using vtm::load_tile;
using vtm::to_float;

constexpr int kTile = vtm::kTileRows;  // query rows per block, keys per tile
constexpr int kWarps = 4;              // each warp owns 16 query rows
constexpr int kThreads = kWarps * 32;
constexpr int kMaxFrameLen = 512;      // S holds at most 8 key tiles
static_assert(kThreads == vtm::kTileThreads, "load_tile strides by the block's thread count");
static_assert(kTile == kWarps * 16, "each warp owns a 16-row strip");

// Element strides of q, k, v (batch, head, row) and out (batch, head, row,
// frame); the last dim is contiguous.
struct Strides {
  long long q[3], k[3], v[3], o[4];
};

// Shared-memory layout: q tile, one k-or-v tile, S (fp32), and for bf16 a
// [64 x 64] tile of p in T for the wmma product. Row pads of 16 bytes keep
// every 16-row fragment origin 32-byte aligned, as wmma requires. S is as
// wide as the frame rounded up to 64, and at least D so that it can stage
// a [64 x D] fp32 result.
template <typename T, int D>
struct FrameLayout {
  static constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int ld_qkv = D + kPad;
  static constexpr int ld_p = kTile + kPad;
  static constexpr size_t qkv_bytes = size_t(kTile) * ld_qkv * sizeof(T);
  static constexpr size_t p_bytes = kTensorCores ? size_t(kTile) * ld_p * sizeof(T) : 0;
  static_assert(qkv_bytes % 128 == 0 && p_bytes % 128 == 0, "regions stay 128-byte aligned");

  int ld_s;
  size_t s_off, p_off, bytes;

  __host__ __device__ explicit FrameLayout(int s_len) {
    int cols = (s_len + kTile - 1) / kTile * kTile;
    if (cols < D) cols = D;
    ld_s = cols + 4;
    s_off = 2 * qkv_bytes;
    p_off = s_off + size_t(kTile) * ld_s * sizeof(float);  // a multiple of 256
    bytes = p_off + p_bytes;
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    frame_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const float* __restrict__ key_bias,
                               T* __restrict__ out, float* __restrict__ lse, int num_heads, int n,
                               int frames, int s_len, float scale, Strides st) {
  using L = FrameLayout<T, D>;
  const L lay(s_len);
  const int ld_s = lay.ld_s;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* kvs = reinterpret_cast<T*>(smem + L::qkv_bytes);
  float* ss = reinterpret_cast<float*>(smem + lay.s_off);
  T* ps = reinterpret_cast<T*>(smem + lay.p_off);

  const int bh = blockIdx.y;
  const int b = bh / num_heads;
  const int h = bh % num_heads;
  const int q0 = blockIdx.x * kTile;
  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* kb = k + b * st.k[0] + h * st.k[1];
  const T* vb = v + b * st.v[0] + h * st.v[1];
  T* ob = out + b * st.o[0] + h * st.o[1];
  const float* bias = key_bias ? key_bias + static_cast<long long>(b) * n : nullptr;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow = warp * 16;          // first row of this warp's strip
  const int row = wrow + (lane >> 1);  // fp32 path: the row this lane owns
  const int half = lane & 1;           // fp32 path: which half of it
  const int n_tiles = (s_len + kTile - 1) / kTile;

  load_tile<T, D, true>(qs, L::ld_qkv, qb, st.q[2], q0, n, scale);

  for (int f = 0; f < frames; ++f) {
    const int key0 = f * s_len;
    const int key_end = key0 + s_len;

    // ---- S = (q * scale) k_f^T, one key tile at a time -------------------
    for (int t = 0; t < n_tiles; ++t) {
      const int c0 = t * kTile;
      __syncthreads();  // the q tile is staged; no warp still reads kvs
      load_tile<T, D, false>(kvs, L::ld_qkv, kb, st.k[2], key0 + c0, key_end, 0.f);
      __syncthreads();
      if constexpr (L::kTensorCores) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bt;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
#pragma unroll
        for (int nt = 0; nt < kTile / 16; ++nt) {
          if (c0 + nt * 16 >= s_len) break;
          wmma::fill_fragment(acc, 0.f);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            wmma::load_matrix_sync(a, qs + wrow * L::ld_qkv + kk * 16, L::ld_qkv);
            // k^T as a column-major [d, key] operand: element (d, j) at kvs[j * ld + d]
            wmma::load_matrix_sync(bt, kvs + nt * 16 * L::ld_qkv + kk * 16, L::ld_qkv);
            wmma::mma_sync(acc, a, bt, acc);
          }
          wmma::store_matrix_sync(ss + wrow * ld_s + c0 + nt * 16, acc, ld_s, wmma::mem_row_major);
        }
      } else {
        const T* qr = qs + row * L::ld_qkv;
        for (int j = half * 32; j < half * 32 + 32; ++j) {
          if (c0 + j >= s_len) break;
          const T* kr = kvs + j * L::ld_qkv;
          float acc = 0.f;
#pragma unroll 16
          for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
          ss[row * ld_s + c0 + j] = acc;
        }
      }
    }
    __syncwarp();

    // ---- exact softmax over the frame's keys, one warp per row -----------
    for (int r = wrow; r < wrow + 16; ++r) {
      float* srow = ss + r * ld_s;
      float mx = -INFINITY;
      for (int j = lane; j < s_len; j += 32) {
        const float x = bias ? srow[j] + bias[key0 + j] : srow[j];
        srow[j] = x;
        mx = fmaxf(mx, x);
      }
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < s_len; j += 32) {
        const float e = expf(srow[j] - mx);
        srow[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lse != nullptr && lane == 0 && q0 + r < n)
        lse[(static_cast<long long>(bh) * frames + f) * n + q0 + r] = mx + logf(sum);
      // p = e / sum in fp32, rounded to the input dtype (held as fp32)
      for (int j = lane; j < s_len; j += 32) srow[j] = to_float(from_float<T>(srow[j] / sum));
    }
    __syncwarp();

    // ---- out_f = p v_f ------------------------------------------------------
    if constexpr (L::kTensorCores) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[D / 16];
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt) wmma::fill_fragment(acc[dt], 0.f);
      for (int t = 0; t < n_tiles; ++t) {
        const int c0 = t * kTile;
        __syncthreads();  // no warp still reads kvs
        load_tile<T, D, false>(kvs, L::ld_qkv, vb, st.v[2], key0 + c0, key_end, 0.f);
        // this warp's 16 rows of p for the tile, 0 past the frame's end
        for (int i = lane; i < 16 * kTile; i += 32) {
          const int r = wrow + i / kTile;
          const int c = i % kTile;
          ps[r * L::ld_p + c] = from_float<T>(c0 + c < s_len ? ss[r * ld_s + c0 + c] : 0.f);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          if (c0 + kk * 16 >= s_len) break;
          wmma::load_matrix_sync(a, ps + wrow * L::ld_p + kk * 16, L::ld_p);
#pragma unroll
          for (int dt = 0; dt < D / 16; ++dt) {
            wmma::load_matrix_sync(bv, kvs + kk * 16 * L::ld_qkv + dt * 16, L::ld_qkv);
            wmma::mma_sync(acc[dt], a, bv, acc[dt]);
          }
        }
      }
      // stage through this warp's own rows of S (it has read them all),
      // then store the rows inside N with one cast
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt)
        wmma::store_matrix_sync(ss + wrow * ld_s + dt * 16, acc[dt], ld_s, wmma::mem_row_major);
      __syncwarp();
      for (int i = lane; i < 16 * D; i += 32) {
        const int r = i / D;
        const int c = i % D;
        const int qrow = q0 + wrow + r;
        if (qrow < n) ob[qrow * st.o[2] + f * st.o[3] + c] = from_float<T>(ss[(wrow + r) * ld_s + c]);
      }
    } else {
      float acc[D / 2];
#pragma unroll
      for (int dd = 0; dd < D / 2; ++dd) acc[dd] = 0.f;
      const float* prow = ss + row * ld_s;
      for (int t = 0; t < n_tiles; ++t) {
        const int c0 = t * kTile;
        __syncthreads();  // no warp still reads kvs
        load_tile<T, D, false>(kvs, L::ld_qkv, vb, st.v[2], key0 + c0, key_end, 0.f);
        __syncthreads();
        for (int j = 0; j < kTile; ++j) {
          if (c0 + j >= s_len) break;
          const float p = prow[c0 + j];
          const T* vr = kvs + j * L::ld_qkv + half * (D / 2);
#pragma unroll
          for (int dd = 0; dd < D / 2; ++dd) acc[dd] = fmaf(p, to_float(vr[dd]), acc[dd]);
        }
      }
      const int qrow = q0 + row;
      if (qrow < n) {
        T* orow = ob + qrow * st.o[2] + f * st.o[3] + half * (D / 2);
#pragma unroll
        for (int dd = 0; dd < D / 2; ++dd) orow[dd] = from_float<T>(acc[dd]);
      }
    }
  }
}

// ======================= Hopper body (bf16, d = 64) =======================

namespace wg = vtm::wg;
using bf16 = __nv_bfloat16;
using WgSmem = wg::WalkSmem;

template <bool kBias>
__global__ void __launch_bounds__(wg::kThreads)
    frame_attention_fwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const float* __restrict__ key_bias,
                              bf16* __restrict__ out, float* __restrict__ lse, int num_heads, int n,
                              int frames, int s_len, float scale, Strides st) {
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
  w.out_frame_stride = st.o[3];
  w.lse = lse ? lse + static_cast<long long>(bh) * frames * n : nullptr;
  w.lse_frame_stride = n;
  w.row0 = blockIdx.x * wg::kRows;
  w.rows = n;
  w.frames = frames;
  w.frame_len = s_len;
  w.scale = scale;
  wg::attend<kBias>(w, wg::AllPairs(), smem);
}

template <bool kBias>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* key_bias,
                         void* out, void* lse, int batch, int num_heads, int n, int frames,
                         float scale, const Strides& st, cudaStream_t stream) {
  auto kernel = frame_attention_fwd_wgmma<kBias>;
  static bool done[vtm::kMaxDevices] = {};
  cudaError_t err = vtm::allow_smem_once(kernel, WgSmem::kLaunchBytes, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + wg::kRows - 1) / wg::kRows, batch * num_heads);
  kernel<<<grid, wg::kThreads, WgSmem::kLaunchBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(key_bias), static_cast<bf16*>(out), static_cast<float*>(lse),
      num_heads, n, frames, n / frames, scale, st);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* key_bias, void* out,
                   void* lse, int batch, int num_heads, int n, int frames, float scale,
                   const Strides& st, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value && D == 64) {
    return key_bias ? launch_wgmma<true>(q, k, v, key_bias, out, lse, batch, num_heads, n, frames, scale, st, stream)
                    : launch_wgmma<false>(q, k, v, key_bias, out, lse, batch, num_heads, n, frames, scale, st, stream);
  } else {
    const int s_len = n / frames;
    const dim3 grid((n + kTile - 1) / kTile, batch * num_heads);
    const FrameLayout<T, D> lay(s_len);
    auto kernel = frame_attention_fwd_kernel<T, D>;
    // raised once, to what the longest frame needs
    static bool done[vtm::kMaxDevices] = {};
    cudaError_t err = vtm::allow_smem_once(
        kernel, static_cast<int>(FrameLayout<T, D>(kMaxFrameLen).bytes), done);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, lay.bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(key_bias), static_cast<T*>(out), static_cast<float*>(lse), num_heads,
        n, frames, s_len, scale, st);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t dispatch_head_dim(int head_dim, const void* q, const void* k, const void* v,
                              const void* key_bias, void* out, void* lse, int batch, int num_heads,
                              int n, int frames, float scale, const Strides& st, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(q, k, v, key_bias, out, lse, batch, num_heads, n, frames, scale, st, stream);
    case 32: return launch<T, 32>(q, k, v, key_bias, out, lse, batch, num_heads, n, frames, scale, st, stream);
    case 64: return launch<T, 64>(q, k, v, key_bias, out, lse, batch, num_heads, n, frames, scale, st, stream);
    case 128: return launch<T, 128>(q, k, v, key_bias, out, lse, batch, num_heads, n, frames, scale, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, bound with ctypes by vtm_torch/ops/flash_attention.py.
//   dtype: 0 = bf16, 1 = fp32 (q, k, v and out share it)
//   key_bias: fp32 [batch, n] contiguous, or null for the unbiased form
//   lse: fp32 [batch, num_heads, frames, n] contiguous, each row's
//        log-sum-exp in each frame, or null when not wanted
//   frames: divides n, with n / frames <= 512
//   strides: 13 element strides: (batch, head, row) of q, k, v, then
//            (batch, head, row, frame) of out
// Returns the cudaError_t of the launch (0 on success).
extern "C" int vtm_frame_attention_fwd(int dtype, int head_dim, const void* q, const void* k,
                                       const void* v, const void* key_bias, void* out, void* lse,
                                       int batch, int num_heads, int n, int frames, float scale,
                                       const long long* strides, void* stream) {
  if (frames < 1 || n < 1 || n % frames != 0 || n / frames > kMaxFrameLen) {
    return cudaErrorInvalidValue;
  }
  Strides st;
  std::memcpy(&st, strides, sizeof(st));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_head_dim<__nv_bfloat16>(head_dim, q, k, v, key_bias, out, lse, batch,
                                              num_heads, n, frames, scale, st, s);
    case 1:
      return dispatch_head_dim<float>(head_dim, q, k, v, key_bias, out, lse, batch, num_heads, n,
                                      frames, scale, st, s);
    default:
      return cudaErrorInvalidValue;
  }
}
