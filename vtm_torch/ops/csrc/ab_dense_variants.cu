// Four variants of the dense attention forward (K1) that move softmax work
// elsewhere, for Hopper (sm_90a), at head dim 64:
//   out = softmax((q * scale) k^T + key_bias[b, key]) v      over [B, H, N, 64]
//
// Replaces the Pallas TPU kernels of
//   tools/ab_dense_v2.py:156  v2_attention (body _make_v2_kernel, :59)  (T11)
//     v2_sum    a ones column appended to v: the softmax denominator comes
//               out of p v (65 wide) instead of a row sum; since p goes
//               through the product in the input dtype, the denominator is
//               that of the *cast* p, which K1's is not
//     v2_fold   v2_sum, and the bias with the pad mask carried through
//               q k^T as two extra contraction features: q gets [1, 1], k
//               gets [hi, lo], the split of the fp32 bias into two numbers
//               of the input dtype (66 deep); no bias add, no mask
//     v2_nomax  v2_fold without the running max: p = exp(s). Overflows on
//               large logits by design; for measurement only
//   tools/ab_mxu_pack.py:203  packed_attention (body _make_packed_kernel,
//               :132): two heads in one block, q as the interleaved
//               block-diagonal operand [q1_i | 0], [0 | q2_i] against
//               [k1 | k2] (128 deep) and p against [v1 | v2] (128 wide);
//               token-major out  (T4)
//
// What bounds them on the H100: as K1, the tensor cores (at B8 H12 N1568,
// 60.4 GFLOP against about 77 MB). What they measure is whether work moved
// into a product, or two heads in one block, beat K1's own body, which is
// the same loop as theirs:
//   * bf16 (every shape the A/B entry point times): K1's Hopper tile loop,
//     vtm::wg::attend of wgmma_attention.cuh, under a softmax policy.
//     v2_sum takes the denominator from an m64n8k16 product of the bf16 p
//     with 8 columns of ones per k-step of p v (4 accumulator registers,
//     rescaled by the running max's correction as o is) instead of K1's
//     fp32 row sum and shuffles. v2_fold adds one k16 step to q k^T:
//     [1, 1, 0...] from registers against a tile of each key's
//     [hi, lo, 0...], staged with the key tile, with keys past N at
//     hi = bf16(-1e30) and lo = its residual: no bias loads, no mask.
//     v2_nomax drops the max, its shuffles and the correction. The TPU's
//     65 and 66 were free on a 128-wide matrix unit; here they cost a
//     sixteenth of the p v steps, a quarter of the q k^T steps.
//     packed: on wgmma a k-step is 16 deep and one instruction's 64 rows
//     share one B operand, so the zero quarters of the block-diagonal q are
//     whole k-steps that add exact zeros, and two heads cannot share one
//     product. The packing left is a block per head pair: the two heads are
//     two frames of one walk (their own q, k, v and output columns, one
//     bias), the ring's prefetch of the second head's first k, v tile
//     overlapping the first head's last tile, half the blocks of K1, each
//     pair's outputs two neighbouring 128-byte halves of a 256-byte
//     token-major row. The question `ab_dense --exp mxu_pack` now asks: does
//     a head pair per block beat K1's one head per block?
//   * fp32: the first body, on FMA units (TF32 would keep about three
//     digits): one block of 4 warps, 64 rows of logits (packed: 32 queries
//     of each of two heads, interleaved), 64-key tiles staged in shared
//     memory, the operands packed as the TPU kernels pack them.
//   shared memory: bf16 v2_* 51,200 B (the fold tile shares the output
//   stage), packed 50,176 B; fp32 v2_sum 112,640 B, v2_fold and v2_nomax
//   120,832 B, packed 169,984 B of 232,448.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

#include "attention_tiles.cuh"
#include "wgmma_attention.cuh"

namespace {

using vtm::kMask;
using vtm::load_tile;

constexpr int kD = 64;                  // head dim
constexpr int kRows = vtm::kTileRows;   // rows of logits per block
constexpr int kBlockK = vtm::kTileRows; // keys per tile
constexpr int kThreads = vtm::kTileThreads;

enum Variant { kSum = 0, kFold = 1, kNoMax = 2, kPacked = 3 };

struct Strides {
  long long q[3], k[3], v[3], o[3];
};

// ========================= first body (fp32) ==============================

// kDepth: the contraction of q k^T as staged; kWidth: the width of the v
// tile and of the accumulator.
template <int V>
struct Layout {
  static constexpr int kDepth = V == kPacked ? 2 * kD : (V == kSum ? kD : kD + 16);
  static constexpr int kWidth = V == kPacked ? 2 * kD : kD + 16;
  static constexpr int kPad = 4;               // 16 bytes
  static constexpr int ld_qk = kDepth + kPad;  // q and k tiles
  static constexpr int ld_v = kWidth + kPad;   // v tile
  static constexpr int ld_s = kBlockK + 4;     // logits
  static constexpr int ld_p = kBlockK + kPad;  // probabilities
  static constexpr int ld_o = kWidth + 4;      // accumulator
  static constexpr size_t qk_bytes = size_t(kRows) * ld_qk * sizeof(float);
  static constexpr size_t v_bytes = size_t(kBlockK) * ld_v * sizeof(float);
  static constexpr size_t s_bytes = size_t(kRows) * ld_s * sizeof(float);
  static constexpr size_t p_bytes = size_t(kRows) * ld_p * sizeof(float);
  static constexpr size_t o_bytes = size_t(kRows) * ld_o * sizeof(float);
  static constexpr size_t k_off = qk_bytes;
  static constexpr size_t v_off = k_off + qk_bytes;
  static constexpr size_t s_off = v_off + v_bytes;
  static constexpr size_t p_off = s_off + s_bytes;
  static constexpr size_t o_off = p_off + p_bytes;
  static constexpr size_t bytes = o_off + o_bytes;
  static_assert(qk_bytes % 128 == 0 && v_bytes % 128 == 0 && s_bytes % 128 == 0 &&
                    p_bytes % 128 == 0,
                "shared regions must stay 128-byte aligned");
};

// Columns [64, 80) of a staged tile row: c0, c1, then zeros.
__device__ __forceinline__ void fill_extra(float* row, float c0, float c1) {
  row[kD] = c0;
  row[kD + 1] = c1;
#pragma unroll
  for (int c = kD + 2; c < kD + 16; ++c) row[c] = 0.f;
}

// The interleaved block-diagonal q of a head pair: packed row 2 r + head =
// query row q0 + r of that head, scaled, in columns [64 head, 64 head + 64),
// zeros in the other half; rows past `n` all zero.
__device__ __forceinline__ void load_packed_q(float* dst, int ld, const float* q1, const float* q2,
                                              long long row_stride, int q0, int n, float scale) {
  constexpr int kVecsPerRow = kD / 4;
  for (int i = threadIdx.x; i < kRows * kVecsPerRow; i += kThreads) {
    const int pr = i / kVecsPerRow;  // packed row
    const int c = (i % kVecsPerRow) * 4;
    const int head = pr & 1;
    const int r = q0 + (pr >> 1);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n) {
      val = *reinterpret_cast<const float4*>((head ? q2 : q1) + r * row_stride + c);
      val = make_float4(val.x * scale, val.y * scale, val.z * scale, val.w * scale);
    }
    *reinterpret_cast<float4*>(dst + pr * ld + head * kD + c) = val;
    *reinterpret_cast<float4*>(dst + pr * ld + (1 - head) * kD + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    ab_dense_variant_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ key_bias,
                            const float* __restrict__ bias_hi, const float* __restrict__ bias_lo,
                            float* __restrict__ out, int num_heads, int n, float scale, Strides st) {
  using L = Layout<V>;
  constexpr int kDepth = L::kDepth;
  constexpr int kWidth = L::kWidth;
  constexpr bool kFolded = V == kFold || V == kNoMax;  // bias and mask inside q k^T
  constexpr bool kOnes = V != kPacked;                 // denominator from a ones column of v
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = reinterpret_cast<float*>(smem + L::k_off);
  float* vs = reinterpret_cast<float*>(smem + L::v_off);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);
  float* ps = reinterpret_cast<float*>(smem + L::p_off);
  float* os = reinterpret_cast<float*>(smem + L::o_off);

  // packed: blockIdx.y counts head pairs, and the block holds heads h and h + 1
  const int groups = V == kPacked ? num_heads / 2 : num_heads;
  const int b = blockIdx.y / groups;
  const int h = V == kPacked ? 2 * (blockIdx.y % groups) : blockIdx.y % groups;
  const int q0 = blockIdx.x * (V == kPacked ? kRows / 2 : kRows);
  const float* qb = q + b * st.q[0] + h * st.q[1];
  const float* kb = k + b * st.k[0] + h * st.k[1];
  const float* vb = v + b * st.v[0] + h * st.v[1];
  const float* bias = key_bias ? key_bias + static_cast<long long>(b) * n : nullptr;
  const float* hi = bias_hi ? bias_hi + static_cast<long long>(b) * n : nullptr;
  const float* lo = bias_lo ? bias_lo + static_cast<long long>(b) * n : nullptr;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = warp * 16 + (lane >> 1);  // the row this lane's softmax owns
  const int half = lane & 1;                // which half of the row it owns

  if constexpr (V == kPacked) {
    load_packed_q(qs, L::ld_qk, qb, qb + st.q[1], st.q[2], q0, n, scale);
  } else {
    load_tile<float, kD, true>(qs, L::ld_qk, qb, st.q[2], q0, n, scale);
    if constexpr (kFolded) {
      if (threadIdx.x < kRows) fill_extra(qs + threadIdx.x * L::ld_qk, 1.f, 1.f);
    }
  }
  for (int i = threadIdx.x; i < kRows * L::ld_o; i += kThreads) os[i] = 0.f;
  __syncthreads();

  float m_i = kMask;  // running max of this lane's row
  float l_i = 0.f;    // running denominator of this lane's row (packed only)

  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    load_tile<float, kD, false>(ks, L::ld_qk, kb, st.k[2], k0, n, 0.f);
    load_tile<float, kD, false>(vs, L::ld_v, vb, st.v[2], k0, n, 0.f);
    if constexpr (V == kPacked) {
      load_tile<float, kD, false>(ks + kD, L::ld_qk, kb + st.k[1], st.k[2], k0, n, 0.f);
      load_tile<float, kD, false>(vs + kD, L::ld_v, vb + st.v[1], st.v[2], k0, n, 0.f);
    } else if (threadIdx.x < kBlockK) {
      const int key = k0 + threadIdx.x;
      fill_extra(vs + threadIdx.x * L::ld_v, 1.f, 0.f);
      if constexpr (kFolded) {
        float f_hi = 0.f, f_lo = 0.f;  // fp32 splits a bias as (bias, 0), the pad mask too
        if (key >= n) {
          f_hi = kMask;
        } else if (hi) {
          f_hi = hi[key];
          f_lo = lo[key];
        }
        fill_extra(ks + threadIdx.x * L::ld_qk, f_hi, f_lo);
      }
    }
    __syncthreads();

    // ---- s = q k^T over the staged depth, this lane's half row -----------
    const float* qr = qs + row * L::ld_qk;
    for (int j = half * 32; j < half * 32 + 32; ++j) {
      const float* kr = ks + j * L::ld_qk;
      float acc = 0.f;
#pragma unroll 16
      for (int d = 0; d < kDepth; ++d) acc = fmaf(qr[d], kr[d], acc);
      ss[row * L::ld_s + j] = acc;
    }
    __syncwarp();

    // ---- p from s, over this lane's half row ----------------------------
    float* srow = ss + row * L::ld_s + half * 32;
    float* prow = ps + row * L::ld_p + half * 32;
    if constexpr (V == kNoMax) {
      for (int j = 0; j < 32; ++j) prow[j] = expf(srow[j]);
    } else {
      float mx = kMask;
      for (int j = 0; j < 32; ++j) {
        float s = srow[j];
        if constexpr (!kFolded) {
          const int key = k0 + half * 32 + j;
          s = key < n ? (bias ? s + bias[key] : s) : kMask;
          srow[j] = s;
        }
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_i, mx);
      const float corr = expf(m_i - m_new);
      float sum = 0.f;
      for (int j = 0; j < 32; ++j) {
        const float p = expf(srow[j] - m_new);
        prow[j] = p;
        sum += p;
      }
      if constexpr (!kOnes) {
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        l_i = l_i * corr + sum;
      }
      m_i = m_new;
      float* orow = os + row * L::ld_o + half * (kWidth / 2);
      for (int d = 0; d < kWidth / 2; ++d) orow[d] *= corr;
    }
    __syncwarp();

    // ---- acc += p v over the staged width, this lane's half row ----------
    const float* pr = ps + row * L::ld_p;
    for (int d = half * (kWidth / 2); d < half * (kWidth / 2) + kWidth / 2; ++d) {
      float acc = os[row * L::ld_o + d];
#pragma unroll 16
      for (int j = 0; j < kBlockK; ++j) acc = fmaf(pr[j], vs[j * L::ld_v + d], acc);
      os[row * L::ld_o + d] = acc;
    }
    __syncthreads();  // k/v/p tiles are overwritten by the next iteration
  }

  // ---- out = acc / denominator ------------------------------------------
  const float* orow = os + row * L::ld_o;
  if constexpr (V == kPacked) {
    // packed row `row` is query q0 + row / 2 of head h + (row & 1); its
    // output sits in that head's half of the 128 columns
    const int head = row & 1;
    const int r = q0 + (row >> 1);
    if (r < n) {
      float* dst = out + b * st.o[0] + (h + head) * st.o[1] + r * st.o[2];
      for (int d = half * (kD / 2); d < half * (kD / 2) + kD / 2; ++d) dst[d] = orow[head * kD + d] / l_i;
    }
  } else if (q0 + row < n) {
    const float denom = orow[kD];  // from the ones column
    float* dst = out + b * st.o[0] + h * st.o[1] + (q0 + row) * st.o[2];
    for (int d = half * (kD / 2); d < half * (kD / 2) + kD / 2; ++d) dst[d] = orow[d] / denom;
  }
}

// ======================= Hopper body (bf16, d = 64) =======================

namespace wg = vtm::wg;
using bf16 = __nv_bfloat16;

template <int V>
using ModeOf = std::conditional_t<
    V == kPacked, wg::HeadPairs,
    std::conditional_t<V == kSum, wg::OnesColumn, std::conditional_t<V == kFold, wg::FoldedBias, wg::FoldedNoMax>>>;

// A block of one warpgroup: 64 query rows of one head (packed: of a head
// pair, walked as two frames), on the shared forward tile loop. At least 4
// blocks an SM, as K1 runs: v2_sum's biased instance would take 144
// registers (3 blocks) and fits 128 without spills.
template <int V, bool kBias>
__global__ void __launch_bounds__(wg::kThreads, 4)
    ab_dense_variant_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const float* __restrict__ key_bias,
                           const bf16* __restrict__ bias_hi, const bf16* __restrict__ bias_lo,
                           bf16* __restrict__ out, int num_heads, int n, float scale, Strides st) {
  extern __shared__ unsigned char smem[];
  constexpr int kHeadsPerBlock = V == kPacked ? 2 : 1;
  const int groups = num_heads / kHeadsPerBlock;
  const int b = blockIdx.y / groups;
  const int h = (blockIdx.y % groups) * kHeadsPerBlock;
  wg::Walk w;
  w.q = q + b * st.q[0] + h * st.q[1];
  w.k = k + b * st.k[0] + h * st.k[1];
  w.v = v + b * st.v[0] + h * st.v[1];
  w.q_stride = st.q[2];
  w.k_stride = st.k[2];
  w.v_stride = st.v[2];
  w.q_frame_stride = st.q[1];
  w.k_frame_stride = st.k[1];
  w.v_frame_stride = st.v[1];
  w.bias = kBias ? key_bias + static_cast<long long>(b) * n : nullptr;
  w.bias_hi = bias_hi ? bias_hi + static_cast<long long>(b) * n : nullptr;
  w.bias_lo = bias_lo ? bias_lo + static_cast<long long>(b) * n : nullptr;
  w.out = out + b * st.o[0] + h * st.o[1];
  w.out_stride = st.o[2];
  w.out_frame_stride = st.o[1];
  w.lse = nullptr;
  w.lse_frame_stride = 0;
  w.row0 = blockIdx.x * wg::kRows;
  w.rows = n;
  w.frames = kHeadsPerBlock;
  w.frame_len = n;
  w.scale = scale;
  wg::attend<kBias, wg::AllPairs, ModeOf<V>>(w, wg::AllPairs(), smem);
}

struct Args {
  const void *q, *k, *v, *bias, *hi, *lo;
  void* out;
  int batch, num_heads, n;
  float scale;
  Strides st;
  cudaStream_t stream;
};

// The grid of both bodies: query tiles by (batch, head) or (batch, head
// pair); the Python side's plan (ops/ab_attention.py::packed_plan).
dim3 grid_of(int variant, const Args& a, int queries_per_block) {
  const int groups = variant == kPacked ? a.batch * a.num_heads / 2 : a.batch * a.num_heads;
  return dim3((a.n + queries_per_block - 1) / queries_per_block, groups);
}

template <int V, bool kBias>
cudaError_t launch_wgmma(const Args& a) {
  auto kernel = ab_dense_variant_wgmma<V, kBias>;
  constexpr int kBytes = wg::ModeSmem<ModeOf<V>>::kLaunchBytes;
  static bool done[vtm::kMaxDevices] = {};
  cudaError_t err = vtm::allow_smem_once(kernel, kBytes, done);
  if (err != cudaSuccess) return err;
  kernel<<<grid_of(V, a, wg::kRows), wg::kThreads, kBytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const float*>(a.bias), static_cast<const bf16*>(a.hi), static_cast<const bf16*>(a.lo),
      static_cast<bf16*>(a.out), a.num_heads, a.n, a.scale, a.st);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_fp32(const Args& a) {
  auto kernel = ab_dense_variant_kernel<V>;
  static bool done[vtm::kMaxDevices] = {};
  cudaError_t err = vtm::allow_smem_once(kernel, static_cast<int>(Layout<V>::bytes), done);
  if (err != cudaSuccess) return err;
  kernel<<<grid_of(V, a, V == kPacked ? kRows / 2 : kRows), kThreads, Layout<V>::bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<const float*>(a.bias), static_cast<const float*>(a.hi), static_cast<const float*>(a.lo),
      static_cast<float*>(a.out), a.num_heads, a.n, a.scale, a.st);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch(int dtype, const Args& a) {
  if (dtype == 1) return launch_fp32<V>(a);
  if constexpr (V == kFold || V == kNoMax) {
    return launch_wgmma<V, false>(a);  // the bias comes through the product
  } else {
    return a.bias ? launch_wgmma<V, true>(a) : launch_wgmma<V, false>(a);
  }
}

}  // namespace

// C entry point, bound with ctypes by vtm_torch/ops/ab_attention.py.
//   dtype: 0 = bf16, 1 = fp32 (q, k, v, bias_hi, bias_lo and out share it)
//   variant: 0 v2_sum, 1 v2_fold, 2 v2_nomax, 3 packed (num_heads even)
//   key_bias: fp32 [batch, n] or null (v2_sum, packed)
//   bias_hi, bias_lo: [batch, n] in the input dtype, both or neither
//     (v2_fold, v2_nomax)
//   strides: 12 element strides, (batch, head, row) of q, k, v, out
// Returns the cudaError_t of the launch (0 on success).
extern "C" int vtm_ab_dense_variant(int dtype, int variant, const void* q, const void* k,
                                    const void* v, const void* key_bias, const void* bias_hi,
                                    const void* bias_lo, void* out, int batch, int num_heads,
                                    int n, float scale, const long long* strides, void* stream) {
  Args a{q, k, v, key_bias, bias_hi, bias_lo, out, batch, num_heads, n, scale, {},
         static_cast<cudaStream_t>(stream)};
  std::memcpy(&a.st, strides, sizeof(a.st));
  const bool folded = variant == kFold || variant == kNoMax;
  // the fp32 bias belongs to v2_sum and packed, the hi/lo pair to the folded two
  if ((a.hi == nullptr) != (a.lo == nullptr) || (folded ? a.bias != nullptr : a.hi != nullptr))
    return cudaErrorInvalidValue;
  if (variant == kPacked && a.num_heads % 2) return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (variant) {
    case kSum: return launch<kSum>(dtype, a);
    case kFold: return launch<kFold>(dtype, a);
    case kNoMax: return launch<kNoMax>(dtype, a);
    case kPacked: return launch<kPacked>(dtype, a);
    default: return cudaErrorInvalidValue;
  }
}
