// Per-bin nearest-target search by an augmented product on the tensor cores
// (kernel K2, "mxu" scoring).
//
// Replaces: wildcat_slam_tpu/ops/knn_pallas.py, _knn_bins with _knn_mxu_kernel
// (the Pallas TPU kernel behind knn_topk_fused(mode="mxu")). Queries come
// embedded as a = [-2q, 1, 0...] and targets as b = [t; |t|^2; 0...], so one
// product per tile gives the score s = a.b = |t|^2 - 2 q.t, the squared
// distance minus |q|^2 (the wrapper, ops/knn.py, adds |q|^2 back). For each
// query row and bin (targets b, b + nb, b + 2 nb, ...) it keeps the smallest
// score and the target that attains it, walking the targets in increasing
// order with a strict '<', so the earlier target wins a tie as in the TPU
// kernel. Far-padded targets (1e6 per dimension, |t|^2 = 6e12) score ~6e12:
// finite, and never below a real target.
//
// Precision: the TPU kernel ran the product at Precision.HIGHEST, the f32
// semantics the matcher needs (|t|^2 reaches several hundred on these
// descriptors while neighbour distances are 0.01-1, so a ~10-bit TF32 product
// would reorder neighbours). One TF32 pass keeps ~11 significant bits, so
// every operand is split x = hi + lo, both exact in TF32, and the product is
// taken as lo*hi + hi*lo + hi*hi (the 3xTF32 scheme; the dropped lo*lo term
// is ~2^-22 of the product), small terms first, accumulated in f32. The
// rounding to TF32 is done here in integer arithmetic (round half away from
// zero on the 13 dropped bits), so the split is exact and repeatable.
//
// What bounds it on an H100: at Q = 8192, T = 16384 the 3-pass product at
// depth 8 is Q*T*8*2*3 = 6.4 GFLOP, ~13 us at the 495 TFLOP/s TF32 peak; the
// fold is one compare and two selects per score on the CUDA cores, ~12 us;
// the outputs are 32 MB, ~10 us at 3.35 TB/s. On the TPU the contraction was
// padded to 128 lanes; here it is padded only to the mma depth of 8 (the
// matcher's D = 6 dims, the 1 / |t|^2 column and one zero).
//
// Design: mma.sync.m16n8k8 (TF32 in, f32 out). A warp owns 16 queries x 64
// bins; its query fragments (hi and lo) stay in registers for the whole walk.
// A block of 4 warps (64 queries x 64 bins) stages the 64 targets of each bin
// group in shared memory, already split, and every warp reads its B
// fragments from there. In the mma output layout each thread holds the same
// 4 (query, bin) scores of each 16x8 tile at every group, so it owns those
// (query, bin) pairs outright: it folds each new score into its own running
// minimum in registers, in target order. No cross-thread reduction, no
// atomics: every output has exactly one writer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                    // warps per block, stacked along queries
constexpr int kNTiles = 8;                   // 8-bin n-tiles per warp
constexpr int kBinsPerBlock = 8 * kNTiles;   // 64
constexpr int kQPerBlock = 16 * kWarps;      // 64
constexpr int kStride = kBinsPerBlock + 8;   // shared row stride: conflict-free B reads
constexpr int kDepth = 8;                    // contraction depth: one m16n8k8 step

__device__ __forceinline__ float tf32_round(float x) {
  // nearest TF32 value (10 explicit mantissa bits), ties away from zero;
  // finite inputs only (the descriptors and their squares are far from overflow)
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float h = tf32_round(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32_round(x - h));  // x - h is exact in f32
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(32 * kWarps)
knn_mxu_kernel(const float* __restrict__ dq, const float* __restrict__ dtt,
               float* __restrict__ vals, int* __restrict__ idx, int nq, int nt, int nb) {
  __shared__ uint32_t s_hi[kDepth][kStride];
  __shared__ uint32_t s_lo[kDepth][kStride];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;  // mma groupID, threadID_in_group
  const int bin0 = blockIdx.x * kBinsPerBlock;
  const int q0 = blockIdx.y * kQPerBlock + warp * 16;

  // A fragment (row-major 16 x 8): rows gid and gid + 8, columns tig and tig + 4
  uint32_t a_hi[4], a_lo[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int q = q0 + gid + 8 * (r & 1);
    const int k = tig + 4 * (r >> 1);
    const float v = q < nq ? __ldg(&dq[(size_t)q * kDepth + k]) : 0.f;
    split(v, a_hi[r], a_lo[r]);
  }

  float best[kNTiles][4];
  int bidx[kNTiles][4];
  const int ngroups = nt / nb;
  for (int g = 0; g < ngroups; ++g) {
    // stage this group's targets for the block's 64 bins, split hi/lo
    __syncthreads();
    for (int e = threadIdx.x; e < kDepth * kBinsPerBlock; e += 32 * kWarps) {
      const int k = e / kBinsPerBlock, c = e % kBinsPerBlock;
      const int bin = bin0 + c;
      const float v = bin < nb ? __ldg(&dtt[(size_t)k * nt + (size_t)g * nb + bin]) : 0.f;
      split(v, s_hi[k][c], s_lo[k][c]);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      if (bin0 + 8 * j >= nb) break;  // nb % 8 == 0: n-tiles are whole
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const int col = 8 * j + gid;  // B fragment: k rows tig, tig + 4; column gid
      mma_tf32(acc, a_lo, s_hi[tig][col], s_hi[tig + 4][col]);
      mma_tf32(acc, a_hi, s_lo[tig][col], s_lo[tig + 4][col]);
      mma_tf32(acc, a_hi, s_hi[tig][col], s_hi[tig + 4][col]);
      // C layout: acc[r] is (query gid + 8 (r >> 1), bin 2 tig + (r & 1)) of the tile
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = g * nb + bin0 + 8 * j + 2 * tig + (r & 1);
        if (g == 0 || acc[r] < best[j][r]) {  // strict: ties keep the earlier target
          best[j][r] = acc[r];
          bidx[j][r] = t;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
    if (bin0 + 8 * j >= nb) break;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int q = q0 + gid + 8 * (r >> 1);
      const int bin = bin0 + 8 * j + 2 * tig + (r & 1);
      if (q < nq) {
        vals[(size_t)q * nb + bin] = best[j][r];
        idx[(size_t)q * nb + bin] = bidx[j][r];
      }
    }
  }
}

}  // namespace

// dq_aug: (nq, 8) row-major, [-2 q, 1, 0...]; dtt_aug: (8, nt) row-major,
// [t; |t|^2; 0...]; vals: (nq, nb) f32 scores |t|^2 - 2 q.t; idx: (nq, nb)
// int32. nt must be a multiple of nb, nb a multiple of 8. Returns a
// cudaError_t code (0 on success).
extern "C" int wc_knn_mxu(const float* dq_aug, const float* dtt_aug, float* vals, int* idx,
                          int nq, int nt, int nb, void* stream) {
  if (nq < 1 || nb < 8 || nb % 8 != 0 || nt < nb || nt % nb != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((nb + kBinsPerBlock - 1) / kBinsPerBlock, (nq + kQPerBlock - 1) / kQPerBlock);
  knn_mxu_kernel<<<grid, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      dq_aug, dtt_aug, vals, idx, nq, nt, nb);
  return (int)cudaGetLastError();
}
