// The q k^T product alone, for Hopper (sm_90a): what the first of K1's two
// products costs when nothing follows it. For each group g (a head, or a
// packed pair of heads) and query row i, with the keys taken in chunks of
// 64 (the key tile):
//   columns  out[g, i, c] = sum over chunks t of (q k^T)[i, 64 t + c],  c < 64,
//            in the input dtype from an fp32 sum
//   row sum  out[g, i, 0] = sum over all keys of (q k^T)[i, key],  fp32
//
// Replaces the Pallas TPU kernels of
//   tools/ab_mxu_pack.py:84   qk64: columns, depth 64                  (T2)
//   tools/ab_mxu_pack.py:116  qk_packed: columns over prebuilt packed
//                             operands, depth 128                      (T3)
//   tools/ab_decomp.py:69     qk_d64: row sum, depth 64                (T6)
//   tools/ab_decomp.py:97     qk_packed: row sum, depth 128            (T7)
// The packed operands hold two heads: q rows [q1_i | 0] and [0 | q2_i]
// interleaved, k rows [k1_j | k2_j], so one 128-deep product gives head
// 1's logits in the even rows and head 2's in the odd rows.
//
// What bounds it on the H100: the product it issues, 2 G nq nk depth
// operations against G (nq + nk) depth elements read and almost nothing
// written: at G 96, n 1600, depth 64 about 1600 FLOP per byte, so the tensor
// cores. The functions themselves need far less (a row sum of q k^T is
// q . (sum of the keys), the columns form q . (sum over chunks of k)): as
// functions they are bound by their bytes, and a probe is slow against
// that bound by design: it is there to time the product, and its
// yardstick is the product's bound (the packed forms: 62.9 GFLOP at
// qp [48, 3200, 128], 0.0636 ms at 989 TFLOP/s, half of it on zeros).
//
// Every column of every tile's product is consumed: with the chunk equal
// to the 64-key tile, the "columns" form keeps all 64, and the row sum is
// the sum of those 64 at the end, so the two forms differ by their
// epilogue and by the output they store (64 values a row against one).
// That closes the hole of the TPU probes, where a compiler could narrow a
// product whose columns were dropped. Keys past the end are zero-filled,
// so they add exactly 0.
//
// Two bodies:
//   * bf16 (T2, T3, T6, T7), ab_qk_probe_wgmma<kDepth, kRowSum>, on
//     wgmma_tiles.cuh. One warpgroup a block over kRowTiles 64-row tiles
//     of q: one m64n64 fp32 accumulator a row tile (32 registers a
//     thread) that stays in registers across every key tile, never read
//     out or rescaled until the epilogue. q is loaded once, as kRowTiles x
//     kDepth / 64 128-byte-swizzled [64 x 64] tiles; k streams through a
//     kStages-stage cp.async ring of 64-key tiles (8 KB a stage at depth
//     64, the two depth halves, 16 KB, at 128). A tile's products
//     (m64n64k16 from shared memory, kDepth / 16 k-steps for each row
//     tile) go out as one group; the block waits for the previous tile's
//     group only, so one tile's copy lands while the tensor cores run the
//     tile before it. The rows of a block share each staged k tile. Row
//     tiles past the end are zero-filled and multiplied all the same (the
//     products stay unconditional); their rows are not stored. The tiling
//     is a constant of the depth (WgTiling):
//       depth 128 (T3, T7): 4 row tiles, 3 stages, 115,712 B: 2 blocks an
//         SM (128 rows with four stages ran as fast as 256 with three, so
//         L2 does not hold it back; PERF.md);
//       depth 64 (T2, T6): 2 row tiles, 4 stages, 50,176 B: 4 blocks an
//         SM, 96 registers; the fastest of the tilings timed (PERF.md):
//         128 rows leave 4% of the products on the zero rows of a ragged
//         last block where 256 leave 12% at n 1600, and the fourth stage
//         keeps two key tiles landing.
//     The compiler is asked to keep registers for the blocks an SM that
//     the shared memory allows. Epilogues: the columns through store_tile
//     (scale 1, rows past the end not written) in the ring's first stage,
//     which holds one [64 x 64] bf16 tile at either depth; the row sum as
//     each thread's 16 columns of a row, summed in order, then the quad's
//     four partial sums with __shfl_xor_sync 1 and 2, written by the
//     quad's first lane.
//   * fp32, the first body: one block of 4 warps per (g, 64-row q tile);
//     a loop over 64-key tiles of k staged in shared memory with 16-byte
//     loads, products on FMA units with the sum in registers.
//
// Why the packed form exists here: on the TPU a d = 64 contraction half
// fills the 128-deep matrix unit, and packing two heads was a way to fill
// it. A wgmma k-step is 16 deep, so on Hopper nothing is half
// filled: the packed form issues twice the products, half of them on
// zeros, and for a general qp the kernel cannot know which. It is ported
// and measured all the same; expect about twice the time of the plain form
// for the same useful work on the same body (T3 against T2, T7 against
// T6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "attention_tiles.cuh"
#include "wgmma_tiles.cuh"

namespace {

using vtm::load_tile;

constexpr int kBlockQ = vtm::kTileRows;
constexpr int kBlockK = vtm::kTileRows;
constexpr int kThreads = vtm::kTileThreads;
constexpr int kCols = 64;  // columns kept of every chunk's product

template <typename T, int kDepth>
struct Layout {
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr int ld_x = kDepth + kPad;  // q and k tiles (T)
  static constexpr int ld_o = kCols + 4;      // the staged sum (fp32)
  static constexpr size_t tile_bytes = size_t(kBlockQ) * ld_x * sizeof(T);
  static constexpr size_t k_off = tile_bytes;
  static constexpr size_t o_off = 2 * tile_bytes;
  static constexpr size_t bytes = o_off + size_t(kBlockQ) * ld_o * sizeof(float);
  static_assert(tile_bytes % 128 == 0, "shared regions must stay 128-byte aligned");
};

template <typename T, int kDepth, bool kRowSum>
__global__ void __launch_bounds__(kThreads)
    ab_qk_probe_kernel(const T* __restrict__ q, const T* __restrict__ k, void* __restrict__ out,
                       int nq, int nk) {
  static_assert(std::is_same<T, float>::value, "bf16 runs the Hopper body");
  using L = Layout<T, kDepth>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = reinterpret_cast<T*>(smem + L::k_off);
  float* os = reinterpret_cast<float*>(smem + L::o_off);

  const long long g = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const T* qb = q + g * nq * kDepth;
  const T* kb = k + g * nk * kDepth;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = warp * 16 + (lane >> 1);
  const int half = lane & 1;

  load_tile<T, kDepth, false>(qs, L::ld_x, qb, kDepth, q0, nq, 0.f);

  float acc[kCols / 2];
#pragma unroll
  for (int j = 0; j < kCols / 2; ++j) acc[j] = 0.f;
  for (int k0 = 0; k0 < nk; k0 += kBlockK) {
    __syncthreads();  // the previous tile has been read (and q is staged)
    load_tile<T, kDepth, false>(ks, L::ld_x, kb, kDepth, k0, nk, 0.f);
    __syncthreads();
    const T* qr = qs + row * L::ld_x;
#pragma unroll
    for (int j = 0; j < kCols / 2; ++j) {
      const T* kr = ks + (half * (kCols / 2) + j) * L::ld_x;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < kDepth; ++d) dot = fmaf(qr[d], kr[d], dot);
      acc[j] += dot;
    }
  }
#pragma unroll
  for (int j = 0; j < kCols / 2; ++j) os[row * L::ld_o + half * (kCols / 2) + j] = acc[j];
  if constexpr (kRowSum) {
    __syncwarp();  // a warp reads back only its own 16 rows
    const float* orow = os + row * L::ld_o + half * (kCols / 2);
    float sum = 0.f;
    for (int j = 0; j < kCols / 2; ++j) sum += orow[j];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0 && q0 + row < nq) static_cast<float*>(out)[g * nq + q0 + row] = sum;
  } else {
    __syncthreads();  // neighbouring threads write neighbouring columns of any row
    vtm::write_rows<T, kCols>(static_cast<T*>(out) + g * nq * kCols, kCols, os, L::ld_o, q0, nq);
  }
}

template <typename T, int kDepth, bool kRowSum>
cudaError_t launch(const void* q, const void* k, void* out, int groups, int nq, int nk,
                   cudaStream_t stream) {
  using L = Layout<T, kDepth>;
  auto kernel = ab_qk_probe_kernel<T, kDepth, kRowSum>;
  static bool done[vtm::kMaxDevices] = {};
  cudaError_t err = vtm::allow_smem_once(kernel, static_cast<int>(L::bytes), done);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + kBlockQ - 1) / kBlockQ, groups);
  kernel<<<grid, kThreads, L::bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                               out, nq, nk);
  return cudaGetLastError();
}

// ==================== Hopper body (bf16) =================================

namespace wg = vtm::wg;
using bf16 = __nv_bfloat16;

// 64-row tiles of q a block (they share each staged k tile), and key tiles
// in the ring (one computing, one in the tensor cores, the rest landing).
template <int kDepth>
struct WgTiling {
  static constexpr int kRowTiles = 4;
  static constexpr int kStages = 3;
};
template <>
struct WgTiling<64> {
  static constexpr int kRowTiles = 2;
  static constexpr int kStages = 4;
};

template <int kDepth>
struct WgSmem {
  static constexpr int kRowTiles = WgTiling<kDepth>::kRowTiles;
  static constexpr int kStages = WgTiling<kDepth>::kStages;
  static constexpr int kHalves = kDepth / wg::kRows;                  // swizzled 64-column tiles a row
  static constexpr int kStage = kHalves * wg::kTileBytes;             // one 64-key tile of k
  static constexpr int kRing = kRowTiles * kHalves * wg::kTileBytes;  // after q's tiles
  static constexpr int kLaunchBytes = kRing + kStages * kStage + 1024;  // + room to align the base
  // blocks an SM by shared memory (228 KB an SM, 1 KB of it reserved a
  // block): the occupancy the compiler keeps registers for
  static constexpr int kMinBlocks = 228 * 1024 / (kLaunchBytes + 1024);
  static_assert(kDepth % wg::kRows == 0, "depth must be a multiple of 64");
  static_assert(kStages >= 3, "the ring needs a stage computing, one in the tensor cores, one landing");
  static_assert(kStage >= wg::kTileBytes, "store_tile stages the output in the ring's first stage");
  static_assert(kMinBlocks >= 1, "a block must fit an SM");
};

// One warpgroup: q rows [rows x, rows x + rows) of group y (rows = 64
// kRowTiles) against every key of the group (header note). q [groups, nq,
// kDepth], k [groups, nk, kDepth], contiguous.
template <int kDepth, bool kRowSum>
__global__ void __launch_bounds__(wg::kThreads, WgSmem<kDepth>::kMinBlocks)
    ab_qk_probe_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k, void* __restrict__ out,
                      int nq, int nk) {
  using L = WgSmem<kDepth>;
  constexpr int kRowTiles = L::kRowTiles;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = wg::aligned_smem(smem_raw);
  const uint32_t base = wg::smem_addr(smem);
  const long long g = blockIdx.y;
  const int row0 = blockIdx.x * kRowTiles * wg::kRows;
  const bf16* qb = q + g * nq * kDepth;
  const bf16* kb = k + g * nk * kDepth;
  const int tiles = (nk + wg::kRows - 1) / wg::kRows;

  auto q_tile = [&](int m, int h) { return base + (m * L::kHalves + h) * wg::kTileBytes; };
  auto k_tile = [&](int t, int h) { return base + L::kRing + (t % kStages) * L::kStage + h * wg::kTileBytes; };
  // key tile t into its stage (nothing past the last tile), one commit group each
  auto load_k = [&](int t) {
    if (t < tiles) {
#pragma unroll
      for (int h = 0; h < L::kHalves; ++h)
        wg::load_tile_async(k_tile(t, h), kb + h * wg::kRows, kDepth, t * wg::kRows, nk);
    }
    wg::cp_async_commit();
  };

#pragma unroll
  for (int m = 0; m < kRowTiles; ++m) {
#pragma unroll
    for (int h = 0; h < L::kHalves; ++h)
      wg::load_tile_async(q_tile(m, h), qb + h * wg::kRows, kDepth, row0 + m * wg::kRows, nq);
  }
#pragma unroll
  for (int t = 0; t < kStages - 2; ++t) load_k(t);  // q lands with the first group

  float acc[kRowTiles][32];
#pragma unroll
  for (int m = 0; m < kRowTiles; ++m) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;
  }

  for (int t = 0; t < tiles; ++t) {
    wg::cp_async_wait<kStages - 3>();
    wg::fence_async_shared();
    __syncthreads();  // tile t staged by every thread; tile t - 2's products done in every warp
    load_k(t + kStages - 2);  // into tile t - 2's stage
#pragma unroll
    for (int m = 0; m < kRowTiles; ++m) wg::fence_regs(acc[m]);
    wg::wg_fence();
#pragma unroll
    for (int h = 0; h < L::kHalves; ++h) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t b = wg::desc_sw128(k_tile(t, h) + 32 * kk);
#pragma unroll
        for (int m = 0; m < kRowTiles; ++m) wg::mma_ss(acc[m], wg::desc_sw128(q_tile(m, h) + 32 * kk), b, 1);
      }
    }
    wg::wg_commit();
    wg::wg_wait<1>();  // the previous tile's products
#pragma unroll
    for (int m = 0; m < kRowTiles; ++m) wg::fence_regs(acc[m]);
  }
  wg::wg_wait<0>();
#pragma unroll
  for (int m = 0; m < kRowTiles; ++m) wg::fence_regs(acc[m]);

  if constexpr (kRowSum) {
    float* o = static_cast<float*>(out) + g * nq;
#pragma unroll
    for (int m = 0; m < kRowTiles; ++m) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {  // this thread's two rows: 16 columns each
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sum += acc[m][4 * j + 2 * hh];
          sum += acc[m][4 * j + 2 * hh + 1];
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const int r = row0 + m * wg::kRows + wg::acc_row(2 * hh);
        if (threadIdx.x % 4 == 0 && r < nq) o[r] = sum;
      }
    }
  } else {
    wg::cp_async_wait<0>();  // the ring's first stage becomes the output stage
    bf16* o = static_cast<bf16*>(out) + g * nq * kCols;
#pragma unroll
    for (int m = 0; m < kRowTiles; ++m)
      wg::store_tile(acc[m], 1.f, smem + L::kRing, o, kCols, row0 + m * wg::kRows, nq);
  }
}

// occupancy non-null: launch nothing, write the kernel's blocks an SM by
// the runtime's calculator and its dynamic shared bytes there instead.
template <int kDepth, bool kRowSum>
cudaError_t launch_wgmma(const void* q, const void* k, void* out, int groups, int nq, int nk,
                         cudaStream_t stream, int* occupancy) {
  constexpr int kBytes = WgSmem<kDepth>::kLaunchBytes;
  constexpr int kRowsPerBlock = WgSmem<kDepth>::kRowTiles * wg::kRows;
  auto kernel = ab_qk_probe_wgmma<kDepth, kRowSum>;
  static bool done[vtm::kMaxDevices] = {};
  cudaError_t err = vtm::allow_smem_once(kernel, kBytes, done);
  if (err != cudaSuccess) return err;
  if (occupancy) {
    occupancy[1] = kBytes;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kernel, wg::kThreads, kBytes);
  }
  const dim3 grid((nq + kRowsPerBlock - 1) / kRowsPerBlock, groups);
  kernel<<<grid, wg::kThreads, kBytes, stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                                 out, nq, nk);
  return cudaGetLastError();
}

template <int kDepth>
cudaError_t launch_bf16(int rowsum, const void* q, const void* k, void* out, int groups, int nq, int nk,
                        cudaStream_t stream, int* occupancy) {
  return rowsum ? launch_wgmma<kDepth, true>(q, k, out, groups, nq, nk, stream, occupancy)
                : launch_wgmma<kDepth, false>(q, k, out, groups, nq, nk, stream, occupancy);
}

cudaError_t dispatch(int dtype, int depth, int rowsum, const void* q, const void* k, void* out, int groups,
                     int nq, int nk, cudaStream_t stream, int* occupancy) {
  if (dtype == 0) {
    if (depth == 64) return launch_bf16<64>(rowsum, q, k, out, groups, nq, nk, stream, occupancy);
    if (depth == 128) return launch_bf16<128>(rowsum, q, k, out, groups, nq, nk, stream, occupancy);
  } else if (dtype == 1 && !occupancy) {
    if (depth == 64) {
      return rowsum ? launch<float, 64, true>(q, k, out, groups, nq, nk, stream)
                    : launch<float, 64, false>(q, k, out, groups, nq, nk, stream);
    }
    if (depth == 128) {
      return rowsum ? launch<float, 128, true>(q, k, out, groups, nq, nk, stream)
                    : launch<float, 128, false>(q, k, out, groups, nq, nk, stream);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry points, bound with ctypes by vtm_torch/ops/ab_attention.py.
//   dtype: 0 = bf16 (the Hopper body), 1 = fp32 (the first body); q and k
//     share it
//   depth: 64 (one head per group) or 128 (a packed pair)
//   rowsum: 0 = out [groups, nq, 64] in the input dtype; 1 = out
//     [groups, nq, 1] fp32
//   q [groups, nq, depth], k [groups, nk, depth]: contiguous
// Return the cudaError_t of the call (0 on success).
extern "C" int vtm_ab_qk_probe(int dtype, int depth, int rowsum, const void* q, const void* k,
                               void* out, int groups, int nq, int nk, void* stream) {
  return dispatch(dtype, depth, rowsum, q, k, out, groups, nq, nk, static_cast<cudaStream_t>(stream), nullptr);
}

// The bf16 kernel of (depth, rowsum): its blocks an SM by the runtime's
// occupancy calculator into out[0], its dynamic shared bytes into out[1].
// Launches nothing.
extern "C" int vtm_ab_qk_probe_occupancy(int depth, int rowsum, int* out) {
  return dispatch(0, depth, rowsum, nullptr, nullptr, nullptr, 0, 0, 0, nullptr, out);
}
