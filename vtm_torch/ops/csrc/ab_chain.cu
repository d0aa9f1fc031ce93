// The attention chain taken apart, for Hopper (sm_90a), at head dim 64:
//   s = (q * scale) k^T [+ bias[key]]  ->  p  ->  acc = sum p v
//   out = acc / max(|l|, 1e-6)
// in one of three modes:
//   full    p = exp(s - m), the online softmax of K1 (l >= 1, so out = acc / l)
//   linear  the same recurrence with identity in place of exp: p = s - m,
//           corr = m_old - m_new (every pass of the softmax but the exp)
//   nosmax  p = s cast to the input dtype; m and l are not kept (l = 0)
//
// Replaces the Pallas TPU kernels of
//   tools/ab_bisect.py:37   call_kernel (body vtm/ops/flash_attention.py:79
//                           _kernel_chunked): full with a per-batch or
//                           shared key bias                            (T1)
//   tools/ab_b32.py:51      grid_swapped: full, unbiased, the block order
//                           swapped so that b*h varies fastest         (T5)
//   tools/ab_decomp.py:144  chain: the three modes, no scale, no bias  (T8)
//   tools/ab_decomp.py:248  chain_bias: full plus a shared bias, read in
//                           two ways                                   (T9)
//   tools/ab_decomp.py:324  chain_bias_cost: T9 with a cost estimate  (T10)
//   tools/ab_block_attn.py:110  n8_attention: full, unbiased, q scaled in
//                           the kernel, keys past N masked by index   (T12)
//
// What bounds it on the H100: as K1, the tensor cores (4 B H N^2 d
// operations against 4 tensors of B H N d: about 800 FLOP per byte at
// N 1600). Two bodies:
//   * Hopper body (bf16: every variant): the forward tile loop of
//     wgmma_attention.cuh on a walk built from the four strided views: one
//     warpgroup per (b*h, 64-row q tile), k and v through a two-stage
//     cp.async ring, wgmma products with the logits and probabilities in
//     registers. T5, T12 and T8 full run K1's own unbiased instance,
//     vtm::wg::attend<false, AllPairs, Softmax>, and T1 its biased one,
//     attend<true, AllPairs, Softmax> (flash_attention_fwd.cu::
//     attention_fwd_wgmma, no lse), so on the same operands they give K1's
//     output bits: what they measure is the block order, the views and the
//     host's glue, not a body. T9 1d runs T1's instance on a shared bias
//     row (stride 0), T9 2d the same loop under the policy StagedBias,
//     which brings each key tile's bias into shared memory with its keys,
//     and T10 T1's instance in a second kernel that carries the hints
//     below: all three give K1's biased bits. T8 linear and nosmax run the
//     same loop under the policies LinearChain and NoSoftmax, which take
//     the exp (and the max) out of it: what is left is the rest of K1's
//     time.
//   * first body (fp32, every variant): the body K1 keeps for fp32 and
//     other head dims (flash_attention_fwd.cu::attention_fwd_kernel): one
//     block of 4 warps per (b*h, 64-row q tile), 64-key tiles of k and v
//     staged in shared memory, products on FMA units, logits,
//     probabilities and the accumulator in shared memory.
//
// Why each variant exists here, where the TPU's reason does not carry:
//   * The TPU chunk is 800 keys; here the chunk is the 64-key tile, the
//     only blk the wrapper admits. `linear` does not telescope, so its
//     numbers depend on that chunk.
//   * T9's two ways of reading the bias are a layout question of the
//     broadcast on the TPU. Their Hopper counterparts: each lane reads
//     bias[key] from device memory after q k^T's wait (`1d`: K1's read), or
//     the tile's 64 values come into shared memory a tile ahead, in the
//     commit group of its k and v (`2d`; the first body stages them
//     before the tile's products).
//   * T10's cost estimate is a hint to XLA's scheduler and changes no
//     number. CUDA has no such thing. The nearest hints the compiler and
//     the CUDA runtime do take: an occupancy target in __launch_bounds__
//     (Hopper body 4 blocks an SM, what its 50,176 B allow; first body 3),
//     and a preference for the largest shared-memory carve-out. T10 is a
//     second instantiation of T9 `1d` with both.
//   * T5: blockIdx.x varies fastest. Normally x is the q tile, so blocks
//     in flight together share one head's k and v; swapped, x is b*h and
//     neighbouring blocks share nothing (y, the q tile, is capped at
//     65,535). At B8 H12 N 1568 every head's k and v (38.5 MB) fit the
//     50 MB L2; at B32 (154 MB) they do not.
//   * T12 takes the strided split-heads views of a fused qkv projection
//     and writes token-major, so the glue around it is views.
//   * T1 takes q pre-scaled and a per-batch or shared bias row: the walk's
//     bias is key_bias + b * bias_batch_stride (stride n or 0).
//   shared memory: Hopper body 50,176 B (4 blocks an SM; StagedBias 50,688
//   B, still 4), first body 104,704 B.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

#include "attention_tiles.cuh"
#include "wgmma_attention.cuh"

namespace {

using vtm::from_float;
using vtm::kMask;
using vtm::load_tile;

constexpr int kD = 64;                  // head dim
constexpr int kBlockQ = vtm::kTileRows; // query rows per thread block
constexpr int kBlockK = vtm::kTileRows; // keys per tile: the chunk of the recurrence
constexpr int kThreads = vtm::kTileThreads;

enum Mode { kFull = 0, kNoSoftmax = 1, kLinear = 2 };
enum Variant { kAttentionBias = 6 };  // T1: full with a per-batch or shared bias
enum BiasRead { kNoBias = 0, kBiasPerElement = 1, kBiasStaged = 2 };

// Element strides (batch, head, row) of q, k, v and out; the last dim is
// contiguous.
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

// Shared-memory layout: K1's, plus one key tile's bias values.
template <typename T>
struct Layout {
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int ld_qkv = kD + kPad;     // q, k, v tiles (T)
  static constexpr int ld_s = kBlockK + 4;     // logits (fp32)
  static constexpr int ld_p = kBlockK + kPad;  // probabilities (T)
  static constexpr int ld_o = kD + 4;          // accumulator (fp32)
  static constexpr size_t tile_bytes = size_t(kBlockQ) * ld_qkv * sizeof(T);
  static constexpr size_t s_bytes = size_t(kBlockQ) * ld_s * sizeof(float);
  static constexpr size_t p_bytes = size_t(kBlockQ) * ld_p * sizeof(T);
  static constexpr size_t o_bytes = size_t(kBlockQ) * ld_o * sizeof(float);
  static constexpr size_t k_off = tile_bytes;
  static constexpr size_t v_off = k_off + tile_bytes;
  static constexpr size_t s_off = v_off + tile_bytes;
  static constexpr size_t p_off = s_off + s_bytes;
  static constexpr size_t o_off = p_off + p_bytes;
  static constexpr size_t bias_off = o_off + o_bytes;
  static constexpr size_t bytes = bias_off + kBlockK * sizeof(float);
  static_assert(tile_bytes % 128 == 0 && s_bytes % 128 == 0 && p_bytes % 128 == 0 &&
                    o_bytes % 128 == 0,
                "shared regions must stay 128-byte aligned");
};

// ========================== first body ===================================

template <typename T, int kMode, int kBias, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    ab_chain_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ key_bias, T* __restrict__ out, int num_heads, int n,
                    float scale, long long bias_batch_stride, int swap_grid, Strides st) {
  static_assert(std::is_same<T, float>::value, "bf16 runs the Hopper body");
  using L = Layout<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = reinterpret_cast<T*>(smem + L::k_off);
  T* vs = reinterpret_cast<T*>(smem + L::v_off);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);
  T* ps = reinterpret_cast<T*>(smem + L::p_off);
  float* os = reinterpret_cast<float*>(smem + L::o_off);
  float* bs = reinterpret_cast<float*>(smem + L::bias_off);

  const int bh = swap_grid ? blockIdx.x : blockIdx.y;
  const int q0 = (swap_grid ? blockIdx.y : blockIdx.x) * kBlockQ;
  const int b = bh / num_heads;
  const int h = bh % num_heads;
  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* kb = k + b * st.k[0] + h * st.k[1];
  const T* vb = v + b * st.v[0] + h * st.v[1];
  T* ob = out + b * st.o[0] + h * st.o[1];
  const float* bias = kBias != kNoBias ? key_bias + b * bias_batch_stride : nullptr;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow = warp * 16;          // first row of this warp's strip
  const int row = wrow + (lane >> 1);  // the row this lane's softmax owns
  const int half = lane & 1;           // which half of the row it owns

  load_tile<T, kD, true>(qs, L::ld_qkv, qb, st.q[2], q0, n, scale);
  for (int i = threadIdx.x; i < kBlockQ * L::ld_o; i += kThreads) os[i] = 0.f;
  __syncthreads();

  float m_i = kMask;  // running max of this lane's row
  float l_i = 0.f;    // running denominator of this lane's row

  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    load_tile<T, kD, false>(ks, L::ld_qkv, kb, st.k[2], k0, n, 0.f);
    load_tile<T, kD, false>(vs, L::ld_qkv, vb, st.v[2], k0, n, 0.f);
    if constexpr (kBias == kBiasStaged) {
      if (threadIdx.x < kBlockK) bs[threadIdx.x] = k0 + threadIdx.x < n ? bias[k0 + threadIdx.x] : 0.f;
    }
    __syncthreads();

    // ---- s = (q * scale) k^T for this lane's half row ---------------------
    {
      const T* qr = qs + row * L::ld_qkv;
      for (int j = half * 32; j < half * 32 + 32; ++j) {
        const T* kr = ks + j * L::ld_qkv;
        float acc = 0.f;
#pragma unroll 16
        for (int d = 0; d < kD; ++d) acc = fmaf(qr[d], kr[d], acc);
        ss[row * L::ld_s + j] = acc;
      }
    }
    __syncwarp();

    // ---- p from s, over this lane's half row ----------------------------
    float* srow = ss + row * L::ld_s + half * 32;
    T* prow = ps + row * L::ld_p + half * 32;
    const int key0 = k0 + half * 32;
    if constexpr (kMode == kNoSoftmax) {
      // zero-filled keys past n give s = 0 already
      for (int j = 0; j < 32; ++j) prow[j] = from_float<T>(srow[j]);
    } else {
      float mx = kMask;
      for (int j = 0; j < 32; ++j) {
        if (key0 + j < n) {
          float s = srow[j];
          if constexpr (kBias == kBiasPerElement) s += bias[key0 + j];
          if constexpr (kBias == kBiasStaged) s += bs[half * 32 + j];
          srow[j] = s;
          mx = fmaxf(mx, s);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_i, mx);
      const float corr = kMode == kLinear ? m_i - m_new : expf(m_i - m_new);
      float sum = 0.f;
      for (int j = 0; j < 32; ++j) {
        float p = 0.f;  // a key past n weighs nothing in either mode
        if (key0 + j < n) p = kMode == kLinear ? srow[j] - m_new : expf(srow[j] - m_new);
        prow[j] = from_float<T>(p);
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l_i = l_i * corr + sum;
      m_i = m_new;
      float* orow = os + row * L::ld_o + half * (kD / 2);
      for (int d = 0; d < kD / 2; ++d) orow[d] *= corr;
    }
    __syncwarp();

    // ---- acc += p v ------------------------------------------------------
    {
      const T* pr = ps + row * L::ld_p;
      for (int d = half * (kD / 2); d < half * (kD / 2) + kD / 2; ++d) {
        float acc = os[row * L::ld_o + d];
#pragma unroll 16
        for (int j = 0; j < kBlockK; ++j) acc = fmaf(pr[j], vs[j * L::ld_qkv + d], acc);
        os[row * L::ld_o + d] = acc;
      }
    }
    __syncthreads();  // k/v/p tiles are overwritten by the next iteration
  }

  // ---- out = acc / max(|l|, 1e-6), in T: the one division by l ----------
  if (q0 + row < n) {
    const float denom = fmaxf(fabsf(l_i), 1e-6f);
    T* orow_g = ob + (q0 + row) * st.o[2];
    const float* orow = os + row * L::ld_o;
    for (int d = half * (kD / 2); d < half * (kD / 2) + kD / 2; ++d)
      orow_g[d] = from_float<T>(orow[d] / denom);
  }
}

// ======================= Hopper body (bf16, d = 64) =======================

namespace wg = vtm::wg;
using bf16 = __nv_bfloat16;

constexpr int kHintedBlocks = 4;  // T10's occupancy target: what 50,176 B a block allow an SM

// One warpgroup over 64 query rows of one (b, h): K1's forward instance
// (policy Softmax; kBias: T1, T9 1d, else T5, T12, T8 full), T9 2d's
// (StagedBias), or T8's linear and nosmax (LinearChain, NoSoftmax).
// swap_grid: blockIdx.x is b*h and y the q tile (T5); otherwise x is the q
// tile (K1).
template <bool kBias, class Policy>
__device__ __forceinline__ void attend_views(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                             const bf16* __restrict__ v, const float* __restrict__ key_bias,
                                             bf16* __restrict__ out, int num_heads, int n, float scale,
                                             long long bias_batch_stride, int swap_grid, const Strides& st) {
  extern __shared__ unsigned char smem[];
  const int bh = swap_grid ? blockIdx.x : blockIdx.y;
  const int tile = swap_grid ? blockIdx.y : blockIdx.x;
  const int b = bh / num_heads;
  const int h = bh % num_heads;
  wg::Walk w;
  w.q = q + b * st.q[0] + h * st.q[1];
  w.k = k + b * st.k[0] + h * st.k[1];
  w.v = v + b * st.v[0] + h * st.v[1];
  w.q_stride = st.q[2];
  w.k_stride = st.k[2];
  w.v_stride = st.v[2];
  w.q_frame_stride = w.k_frame_stride = w.v_frame_stride = 0;
  w.bias = kBias ? key_bias + b * bias_batch_stride : nullptr;
  w.bias_hi = w.bias_lo = nullptr;
  w.out = out + b * st.o[0] + h * st.o[1];
  w.out_stride = st.o[2];
  w.out_frame_stride = 0;
  w.lse = nullptr;
  w.lse_frame_stride = 0;
  w.row0 = tile * wg::kRows;
  w.rows = n;
  w.frames = 1;
  w.frame_len = n;
  w.scale = scale;
  wg::attend<kBias, wg::AllPairs, Policy>(w, wg::AllPairs(), smem);
}

// The launch bounds are K1's, so that ptxas sees K1's kernel body (128
// registers, 4 blocks an SM).
template <bool kBias, class Policy>
__global__ void __launch_bounds__(wg::kThreads)
    ab_attention_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ key_bias,
                       bf16* __restrict__ out, int num_heads, int n, float scale,
                       long long bias_batch_stride, int swap_grid, Strides st) {
  attend_views<kBias, Policy>(q, k, v, key_bias, out, num_heads, n, scale, bias_batch_stride, swap_grid, st);
}

// T10: the same body with an occupancy target (its launch also prefers the
// largest shared-memory carve-out).
template <bool kBias, class Policy>
__global__ void __launch_bounds__(wg::kThreads, kHintedBlocks)
    ab_attention_hinted_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const float* __restrict__ key_bias,
                              bf16* __restrict__ out, int num_heads, int n, float scale,
                              long long bias_batch_stride, int swap_grid, Strides st) {
  attend_views<kBias, Policy>(q, k, v, key_bias, out, num_heads, n, scale, bias_batch_stride, swap_grid, st);
}

struct Args {
  const void *q, *k, *v, *bias;
  void* out;
  int batch, num_heads, n;
  float scale;
  long long bias_batch_stride;
  int swap_grid;
  Strides st;
  cudaStream_t stream;
  // non-null: launch nothing, write the kernel's blocks an SM and its
  // dynamic shared bytes here instead
  int* occupancy;
};

// Blocks of `kernel` that fit one SM at `bytes` of dynamic shared memory,
// and those bytes, into out[0], out[1] (its limit already raised).
template <typename K>
cudaError_t occupancy(K kernel, int threads, int bytes, int* out) {
  out[1] = bytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads, bytes);
}

template <typename T, int kMode, int kBias, int kMinBlocks>
cudaError_t launch(const Args& a) {
  using L = Layout<T>;
  auto kernel = ab_chain_kernel<T, kMode, kBias, kMinBlocks>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::bytes));
  if (err != cudaSuccess) return err;
  if (kMinBlocks > 1) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  if (a.occupancy) return occupancy(kernel, kThreads, static_cast<int>(L::bytes), a.occupancy);
  const int tiles = (a.n + kBlockQ - 1) / kBlockQ;
  const int bh = a.batch * a.num_heads;
  const dim3 grid = a.swap_grid ? dim3(bh, tiles) : dim3(tiles, bh);
  kernel<<<grid, kThreads, L::bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.bias), static_cast<T*>(a.out), a.num_heads, a.n, a.scale,
      a.bias_batch_stride, a.swap_grid, a.st);
  return cudaGetLastError();
}

// The largest shared-memory carve-out preferred for `kernel`, once a device.
template <typename K>
cudaError_t carve_out_once(K kernel, bool (&done)[vtm::kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < vtm::kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < vtm::kMaxDevices) done[dev] = true;
  return err;
}

using HopperKernel = void (*)(const bf16*, const bf16*, const bf16*, const float*, bf16*, int, int, float,
                              long long, int, Strides);

// The Hopper kernel under Policy (kHinted: T10's), its shared-memory limit
// raised (and with kHinted the carve-out preferred) once a device. Only the
// kernel named is instantiated.
template <bool kBias, class Policy, bool kHinted>
cudaError_t hopper_kernel(HopperKernel* kernel) {
  if constexpr (kHinted) {
    *kernel = ab_attention_hinted_wgmma<kBias, Policy>;
  } else {
    *kernel = ab_attention_wgmma<kBias, Policy>;
  }
  static bool done[vtm::kMaxDevices] = {};
  cudaError_t err = vtm::allow_smem_once(*kernel, wg::ModeSmem<Policy>::kLaunchBytes, done);
  if (err != cudaSuccess) return err;
  if constexpr (kHinted) {
    static bool carved[vtm::kMaxDevices] = {};
    err = carve_out_once(*kernel, carved);
  }
  return err;
}

// The grid of both bodies: (q tiles, b*h), or (b*h, q tiles) swapped; the
// Python side's plan (ops/ab_attention.py::chain_plan).
template <bool kBias, class Policy, bool kHinted>
cudaError_t launch_wgmma(const Args& a) {
  constexpr int kBytes = wg::ModeSmem<Policy>::kLaunchBytes;
  if constexpr (Policy::kStageBias) {
    // every tile's bias values start on a 16-byte boundary
    if (reinterpret_cast<uintptr_t>(a.bias) % 16 || a.bias_batch_stride % 4) return cudaErrorInvalidValue;
  }
  HopperKernel kernel = nullptr;
  cudaError_t err = hopper_kernel<kBias, Policy, kHinted>(&kernel);
  if (err != cudaSuccess) return err;
  if (a.occupancy) return occupancy(kernel, wg::kThreads, kBytes, a.occupancy);
  const int tiles = (a.n + wg::kRows - 1) / wg::kRows;
  const int bh = a.batch * a.num_heads;
  const dim3 grid = a.swap_grid ? dim3(bh, tiles) : dim3(tiles, bh);
  kernel<<<grid, wg::kThreads, kBytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const float*>(a.bias), static_cast<bf16*>(a.out), a.num_heads, a.n, a.scale,
      a.bias_batch_stride, a.swap_grid, a.st);
  return cudaGetLastError();
}

// bf16 on the Hopper body under Policy, fp32 on the first body's kMode;
// kHinted (T10): each body's hinted kernel.
template <typename T, int kMode, int kBias, class Policy, bool kHinted = false>
cudaError_t launch_either(const Args& a) {
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_wgmma<kBias != kNoBias, Policy, kHinted>(a);
  } else {
    return launch<T, kMode, kBias, kHinted ? 3 : 1>(a);
  }
}

// bf16: every variant on the Hopper body; fp32: every variant on the first.
template <typename T>
cudaError_t dispatch_variant(int variant, const Args& a) {
  const bool biased = (variant >= 3 && variant <= 5) || variant == kAttentionBias;
  if (!a.occupancy && biased != (a.bias != nullptr)) return cudaErrorInvalidValue;
  switch (variant) {
    case kFull: return launch_either<T, kFull, kNoBias, wg::Softmax>(a);
    case kNoSoftmax: return launch_either<T, kNoSoftmax, kNoBias, wg::NoSoftmax>(a);
    case kLinear: return launch_either<T, kLinear, kNoBias, wg::LinearChain>(a);
    case 3: return launch_either<T, kFull, kBiasPerElement, wg::Softmax>(a);
    case 4: return launch_either<T, kFull, kBiasStaged, wg::StagedBias>(a);
    case 5: return launch_either<T, kFull, kBiasPerElement, wg::Softmax, true>(a);
    case kAttentionBias: return launch_either<T, kFull, kBiasPerElement, wg::Softmax>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, bound with ctypes by vtm_torch/ops/ab_attention.py.
//   dtype: 0 = bf16, 1 = fp32 (q, k, v and out share it); head dim 64
//   variant: 0 full, 1 nosmax, 2 linear (all unbiased; T8, and full T5,
//     T12); 3 full with the bias read per element, 4 with the bias staged
//     per key tile (16-byte aligned rows in bf16), 5 as 3 with the
//     occupancy and carve-out hints (T9, T10); 6 full with a bias (T1; in
//     bf16 the same instance as 3). In bf16 every variant runs the Hopper
//     body, in fp32 the first body
//   key_bias: fp32, row b at key_bias + b * bias_batch_stride (0: one
//     row shared by every batch); null for variants 0-2
//   swap_grid: 0 = (q tile, b*h) with the q tile fastest, 1 = swapped (both bodies)
//   strides: 12 element strides, (batch, head, row) of q, k, v, out
// Returns the cudaError_t of the launch (0 on success).
extern "C" int vtm_ab_chain(int dtype, int variant, const void* q, const void* k, const void* v,
                            const void* key_bias, void* out, int batch, int num_heads, int n,
                            float scale, long long bias_batch_stride, int swap_grid,
                            const long long* strides, void* stream) {
  Args a{q, k, v, key_bias, out, batch, num_heads, n, scale, bias_batch_stride, swap_grid, {},
         static_cast<cudaStream_t>(stream), nullptr};
  std::memcpy(&a.st, strides, sizeof(a.st));
  switch (dtype) {
    case 0: return dispatch_variant<__nv_bfloat16>(variant, a);
    case 1: return dispatch_variant<float>(variant, a);
    default: return cudaErrorInvalidValue;
  }
}

// The kernel that vtm_ab_chain launches for (dtype, variant): its blocks an
// SM by cudaOccupancyMaxActiveBlocksPerMultiprocessor at its launch's
// dynamic shared bytes, into out[0], and those bytes into out[1]. Launches
// nothing. Returns the cudaError_t (0 on success).
extern "C" int vtm_ab_chain_occupancy(int dtype, int variant, int* out) {
  Args a{};
  a.occupancy = out;
  switch (dtype) {
    case 0: return dispatch_variant<__nv_bfloat16>(variant, a);
    case 1: return dispatch_variant<float>(variant, a);
    default: return cudaErrorInvalidValue;
  }
}
