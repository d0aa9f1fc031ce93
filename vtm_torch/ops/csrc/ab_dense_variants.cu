// Four variants of the dense attention forward (K1) that move softmax work
// into the two products, for Hopper (sm_90a), at head dim 64:
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
//               the operands are packed inside the kernel; token-major out  (T4)
//
// What bounds them on the H100: as K1, the tensor cores. What they
// measure is whether work moved into a product is cheaper than the pass it
// replaces. On the TPU a d = 64 product half fills a 128 x 128 matrix
// unit, so 65 wide, 66 deep and two packed heads were free. Here a wmma
// step is 16: 65 and 66 become 80, a quarter more products, and packing
// doubles the issued products, half of them on zeros. That is the finding
// these kernels are here to put a number on; they are ported as they are.
//
// Design: K1's body (csrc/flash_attention_fwd.cu) with the tile widths as
// template constants: one block of 4 warps, 64 rows of logits per block
// (64 queries; packed: 32 queries of each of two heads, interleaved), a
// loop over 64-key tiles staged in shared memory, bf16 on nvcuda::wmma with
// fp32 accumulation, fp32 on FMA units. v2_fold's mask goes through the
// product as it does on the TPU: a key past N gets hi = -1e30 rounded to
// the input dtype and lo = the residual, summed in fp32.
//   shared memory, bf16 / fp32: v2_sum 77,824 / 112,640 B, v2_fold and
//   v2_nomax 81,920 / 120,832 B, packed 112,640 / 169,984 B of 232,448.

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
using vtm::kMask;
using vtm::load_tile;
using vtm::to_float;

constexpr int kD = 64;                  // head dim
constexpr int kRows = vtm::kTileRows;   // rows of logits per block
constexpr int kBlockK = vtm::kTileRows; // keys per tile
constexpr int kThreads = vtm::kTileThreads;

enum Variant { kSum = 0, kFold = 1, kNoMax = 2, kPacked = 3 };

struct Strides {
  long long q[3], k[3], v[3], o[3];
};

// kDepth: the contraction of q k^T as staged; kWidth: the width of the v
// tile and of the accumulator.
template <typename T, int V>
struct Layout {
  static constexpr int kDepth = V == kPacked ? 2 * kD : (V == kSum ? kD : kD + 16);
  static constexpr int kWidth = V == kPacked ? 2 * kD : kD + 16;
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int ld_qk = kDepth + kPad;  // q and k tiles (T)
  static constexpr int ld_v = kWidth + kPad;   // v tile (T)
  static constexpr int ld_s = kBlockK + 4;     // logits (fp32)
  static constexpr int ld_p = kBlockK + kPad;  // probabilities (T)
  static constexpr int ld_o = kWidth + 4;      // accumulator (fp32)
  static constexpr size_t qk_bytes = size_t(kRows) * ld_qk * sizeof(T);
  static constexpr size_t v_bytes = size_t(kBlockK) * ld_v * sizeof(T);
  static constexpr size_t s_bytes = size_t(kRows) * ld_s * sizeof(float);
  static constexpr size_t p_bytes = size_t(kRows) * ld_p * sizeof(T);
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
template <typename T>
__device__ __forceinline__ void fill_extra(T* row, T c0, T c1) {
  row[kD] = c0;
  row[kD + 1] = c1;
#pragma unroll
  for (int c = kD + 2; c < kD + 16; ++c) row[c] = from_float<T>(0.f);
}

// The interleaved block-diagonal q of a head pair: packed row 2 r + head =
// query row q0 + r of that head, scaled and rounded to T, in columns
// [64 head, 64 head + 64), zeros in the other half; rows past `n` all zero.
template <typename T>
__device__ __forceinline__ void load_packed_q(T* dst, int ld, const T* q1, const T* q2,
                                              long long row_stride, int q0, int n, float scale) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecsPerRow = kD / kVec;
  for (int i = threadIdx.x; i < kRows * kVecsPerRow; i += kThreads) {
    const int pr = i / kVecsPerRow;  // packed row
    const int c = (i % kVecsPerRow) * kVec;
    const int head = pr & 1;
    const int r = q0 + (pr >> 1);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n) {
      val = *reinterpret_cast<const uint4*>((head ? q2 : q1) + r * row_stride + c);
      T* e = reinterpret_cast<T*>(&val);
#pragma unroll
      for (int j = 0; j < kVec; ++j) e[j] = from_float<T>(to_float(e[j]) * scale);
    }
    *reinterpret_cast<uint4*>(dst + pr * ld + head * kD + c) = val;
    *reinterpret_cast<uint4*>(dst + pr * ld + (1 - head) * kD + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    ab_dense_variant_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const float* __restrict__ key_bias,
                            const T* __restrict__ bias_hi, const T* __restrict__ bias_lo,
                            T* __restrict__ out, int num_heads, int n, float scale, Strides st) {
  using L = Layout<T, V>;
  constexpr int kDepth = L::kDepth;
  constexpr int kWidth = L::kWidth;
  constexpr bool kFolded = V == kFold || V == kNoMax;  // bias and mask inside q k^T
  constexpr bool kOnes = V != kPacked;                 // denominator from a ones column of v
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = reinterpret_cast<T*>(smem + L::k_off);
  T* vs = reinterpret_cast<T*>(smem + L::v_off);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);
  T* ps = reinterpret_cast<T*>(smem + L::p_off);
  float* os = reinterpret_cast<float*>(smem + L::o_off);

  // packed: blockIdx.y counts head pairs, and the block holds heads h and h + 1
  const int groups = V == kPacked ? num_heads / 2 : num_heads;
  const int b = blockIdx.y / groups;
  const int h = V == kPacked ? 2 * (blockIdx.y % groups) : blockIdx.y % groups;
  const int q0 = blockIdx.x * (V == kPacked ? kRows / 2 : kRows);
  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* kb = k + b * st.k[0] + h * st.k[1];
  const T* vb = v + b * st.v[0] + h * st.v[1];
  const float* bias = key_bias ? key_bias + static_cast<long long>(b) * n : nullptr;
  const T* hi = bias_hi ? bias_hi + static_cast<long long>(b) * n : nullptr;
  const T* lo = bias_lo ? bias_lo + static_cast<long long>(b) * n : nullptr;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow = warp * 16;          // first row of this warp's strip
  const int row = wrow + (lane >> 1);  // the row this lane's softmax owns
  const int half = lane & 1;           // which half of the row it owns
  const T zero = from_float<T>(0.f);
  const T one = from_float<T>(1.f);

  if constexpr (V == kPacked) {
    load_packed_q<T>(qs, L::ld_qk, qb, qb + st.q[1], st.q[2], q0, n, scale);
  } else {
    load_tile<T, kD, true>(qs, L::ld_qk, qb, st.q[2], q0, n, scale);
    if constexpr (kFolded) {
      if (threadIdx.x < kRows) fill_extra<T>(qs + threadIdx.x * L::ld_qk, one, one);
    }
  }
  for (int i = threadIdx.x; i < kRows * L::ld_o; i += kThreads) os[i] = 0.f;
  __syncthreads();

  float m_i = kMask;  // running max of this lane's row
  float l_i = 0.f;    // running denominator of this lane's row (packed only)

  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    load_tile<T, kD, false>(ks, L::ld_qk, kb, st.k[2], k0, n, 0.f);
    load_tile<T, kD, false>(vs, L::ld_v, vb, st.v[2], k0, n, 0.f);
    if constexpr (V == kPacked) {
      load_tile<T, kD, false>(ks + kD, L::ld_qk, kb + st.k[1], st.k[2], k0, n, 0.f);
      load_tile<T, kD, false>(vs + kD, L::ld_v, vb + st.v[1], st.v[2], k0, n, 0.f);
    } else if (threadIdx.x < kBlockK) {
      const int key = k0 + threadIdx.x;
      fill_extra<T>(vs + threadIdx.x * L::ld_v, one, zero);
      if constexpr (kFolded) {
        T f_hi = zero, f_lo = zero;
        if (key >= n) {  // the pad mask, split as the bias is
          f_hi = from_float<T>(kMask);
          f_lo = from_float<T>(kMask - to_float(f_hi));
        } else if (hi) {
          f_hi = hi[key];
          f_lo = lo[key];
        }
        fill_extra<T>(ks + threadIdx.x * L::ld_qk, f_hi, f_lo);
      }
    }
    __syncthreads();

    // ---- s = q k^T over the staged depth, for this warp's 16 rows --------
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bt;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
#pragma unroll
      for (int nt = 0; nt < kBlockK / 16; ++nt) {
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < kDepth / 16; ++kk) {
          wmma::load_matrix_sync(a, qs + wrow * L::ld_qk + kk * 16, L::ld_qk);
          // k^T as a column-major [depth, key] operand: element (d, j) at ks[j * ld + d]
          wmma::load_matrix_sync(bt, ks + nt * 16 * L::ld_qk + kk * 16, L::ld_qk);
          wmma::mma_sync(acc, a, bt, acc);
        }
        wmma::store_matrix_sync(ss + wrow * L::ld_s + nt * 16, acc, L::ld_s, wmma::mem_row_major);
      }
    } else {
      const T* qr = qs + row * L::ld_qk;
      for (int j = half * 32; j < half * 32 + 32; ++j) {
        const T* kr = ks + j * L::ld_qk;
        float acc = 0.f;
#pragma unroll 16
        for (int d = 0; d < kDepth; ++d) acc = fmaf(qr[d], kr[d], acc);
        ss[row * L::ld_s + j] = acc;
      }
    }
    __syncwarp();

    // ---- p from s, over this lane's half row ----------------------------
    float* srow = ss + row * L::ld_s + half * 32;
    T* prow = ps + row * L::ld_p + half * 32;
    if constexpr (V == kNoMax) {
      for (int j = 0; j < 32; ++j) prow[j] = from_float<T>(expf(srow[j]));
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
        prow[j] = from_float<T>(p);
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

    // ---- acc += p v over the staged width --------------------------------
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
#pragma unroll
      for (int dt = 0; dt < kWidth / 16; ++dt) {
        wmma::load_matrix_sync(acc, os + wrow * L::ld_o + dt * 16, L::ld_o, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < kBlockK / 16; ++kk) {
          wmma::load_matrix_sync(a, ps + wrow * L::ld_p + kk * 16, L::ld_p);
          wmma::load_matrix_sync(bv, vs + kk * 16 * L::ld_v + dt * 16, L::ld_v);
          wmma::mma_sync(acc, a, bv, acc);
        }
        wmma::store_matrix_sync(os + wrow * L::ld_o + dt * 16, acc, L::ld_o, wmma::mem_row_major);
      }
    } else {
      const T* pr = ps + row * L::ld_p;
      for (int d = half * (kWidth / 2); d < half * (kWidth / 2) + kWidth / 2; ++d) {
        float acc = os[row * L::ld_o + d];
#pragma unroll 16
        for (int j = 0; j < kBlockK; ++j) acc = fmaf(pr[j], vs[j * L::ld_v + d], acc);
        os[row * L::ld_o + d] = acc;
      }
    }
    __syncthreads();  // k/v/p tiles are overwritten by the next iteration
  }

  // ---- out = acc / denominator, in T ------------------------------------
  const float* orow = os + row * L::ld_o;
  if constexpr (V == kPacked) {
    // packed row `row` is query q0 + row / 2 of head h + (row & 1); its
    // output sits in that head's half of the 128 columns
    const int head = row & 1;
    const int r = q0 + (row >> 1);
    if (r < n) {
      T* dst = out + b * st.o[0] + (h + head) * st.o[1] + r * st.o[2];
      for (int d = half * (kD / 2); d < half * (kD / 2) + kD / 2; ++d)
        dst[d] = from_float<T>(orow[head * kD + d] / l_i);
    }
  } else if (q0 + row < n) {
    const float denom = orow[kD];  // sum of the cast p, from the ones column
    T* dst = out + b * st.o[0] + h * st.o[1] + (q0 + row) * st.o[2];
    for (int d = half * (kD / 2); d < half * (kD / 2) + kD / 2; ++d)
      dst[d] = from_float<T>(orow[d] / denom);
  }
}

struct Args {
  const void *q, *k, *v, *bias, *hi, *lo;
  void* out;
  int batch, num_heads, n;
  float scale;
  Strides st;
  cudaStream_t stream;
};

template <typename T, int V>
cudaError_t launch(const Args& a) {
  using L = Layout<T, V>;
  auto kernel = ab_dense_variant_kernel<T, V>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::bytes));
  if (err != cudaSuccess) return err;
  constexpr int kQueries = V == kPacked ? kRows / 2 : kRows;  // query rows per block
  const int groups = V == kPacked ? a.batch * a.num_heads / 2 : a.batch * a.num_heads;
  const dim3 grid((a.n + kQueries - 1) / kQueries, groups);
  kernel<<<grid, kThreads, L::bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.bias), static_cast<const T*>(a.hi), static_cast<const T*>(a.lo),
      static_cast<T*>(a.out), a.num_heads, a.n, a.scale, a.st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_variant(int variant, const Args& a) {
  const bool folded = variant == kFold || variant == kNoMax;
  // the fp32 bias belongs to v2_sum and packed, the hi/lo pair to the folded two
  if ((a.hi == nullptr) != (a.lo == nullptr) || (folded ? a.bias != nullptr : a.hi != nullptr))
    return cudaErrorInvalidValue;
  if (variant == kPacked && a.num_heads % 2) return cudaErrorInvalidValue;
  switch (variant) {
    case kSum: return launch<T, kSum>(a);
    case kFold: return launch<T, kFold>(a);
    case kNoMax: return launch<T, kNoMax>(a);
    case kPacked: return launch<T, kPacked>(a);
    default: return cudaErrorInvalidValue;
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
  switch (dtype) {
    case 0: return dispatch_variant<__nv_bfloat16>(variant, a);
    case 1: return dispatch_variant<float>(variant, a);
    default: return cudaErrorInvalidValue;
  }
}
