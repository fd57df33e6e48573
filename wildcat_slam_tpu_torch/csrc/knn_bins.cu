// Per-bin nearest-target search for the surfel matcher (kernel K2).
//
// Replaces: wildcat_slam_tpu/ops/knn_pallas.py, _knn_bins with _knn_vpu_kernel
// and _fold_chunk (the Pallas TPU kernel behind knn_topk_fused). For each
// query row q and each bin b (targets t = b, b + nb, b + 2 nb, ...), it finds
// the smallest squared descriptor distance and the target that attains it.
// Targets are walked in increasing order with a strict '<', so on a tie the
// earlier target wins, as in the TPU kernel. The caller pads T to a multiple
// of nb with far rows (1e6), which never win a bin against a real target, and
// finishes with an exact top-k over the (Q, nb) result.
//
// What bounds it on an H100: instruction issue. Each (q, t) pair costs D
// subtracts, D multiplies and D-1 adds, rounded one by one (no FMA, so the
// distance is bit-equal to the plain PyTorch version's), then a compare and
// two selects: 3D + 2 = 20 instructions at D = 6, one issue slot each, so
// ~2.7 G instructions at Q = 8192, T = 16384. The target table (T * D * 4
// bytes, 384 KB) stays in L2 and the (Q, nb) outputs are 32 MB. At D = 6 the
// inner loop below compiles for sm_90a to 21.7 SASS instructions a
// pair: those 20, plus the loads, address arithmetic and loop control of two
// target groups spread over their 32 pairs.
//
// Design: one thread per (bin, Q queries), Q = 16 at D <= 6, their
// descriptors in registers, so each target loaded serves 16 distances; a
// block is one row of bins. Targets are read transposed (D, T), so the
// threads of a warp take neighbouring targets and each load is coalesced.
// The first target group is peeled (it sets the minima without a compare),
// and the loop, unrolled by two over two target buffers, loads the next
// group's targets while the current one is scored, so it never waits on L2.
// Outputs are written once, coalesced along the bin axis. No shared memory,
// no atomics: every output has exactly one writer. The launch (grid, bins a
// block, queries a thread) is ops/knn.py's bins_grid, passed in and checked
// here; the kernel is compiled for the (D, Q) pairs listed in wc_knn_bins.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 128;  // the most bins a block (launch bounds)

template <int D>
__device__ __forceinline__ float sqdist(const float (&q)[D], const float (&t)[D]) {
  float diff = __fsub_rn(q[0], t[0]);
  float s = __fmul_rn(diff, diff);
#pragma unroll
  for (int d = 1; d < D; ++d) {
    diff = __fsub_rn(q[d], t[d]);
    s = __fadd_rn(s, __fmul_rn(diff, diff));
  }
  return s;
}

// Fold the distances to one target group into the running minima.
template <int D, int Q>
__device__ __forceinline__ void fold(const float (&qv)[Q][D], const float (&tv)[D], int t,
                                     float (&best)[Q], int (&bidx)[Q]) {
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const float s = sqdist<D>(qv[i], tv);
    if (s < best[i]) {  // strict: ties keep the earlier target
      best[i] = s;
      bidx[i] = t;
    }
  }
}

template <int D>
__device__ __forceinline__ void load_targets(float (&tv)[D], const float* col, int nt) {
#pragma unroll
  for (int d = 0; d < D; ++d) tv[d] = __ldg(col + (size_t)d * nt);
}

template <int D, int Q>
__global__ void __launch_bounds__(kMaxThreads, 3)
knn_bins_kernel(const float* __restrict__ dq, const float* __restrict__ dtt,
                float* __restrict__ vals, int* __restrict__ idx, int nq, int nt, int nb) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int q0 = blockIdx.y * Q;
  if (b >= nb) return;

  float qv[Q][D];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const int q = q0 + i < nq ? q0 + i : nq - 1;
#pragma unroll
    for (int d = 0; d < D; ++d) qv[i][d] = __ldg(&dq[(size_t)q * D + d]);
  }

  // two target buffers: one group is scored while the next one loads
  const float* tcol = dtt + b;  // column b of the (D, nt) target table
  const int ngroups = nt / nb;
  float ta[D], tb[D];
  load_targets<D>(ta, tcol, nt);
  load_targets<D>(tb, tcol + (size_t)min(1, ngroups - 1) * nb, nt);

  // group 0 sets the minima
  float best[Q];
  int bidx[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    best[i] = sqdist<D>(qv[i], ta);
    bidx[i] = b;
  }
  int g = 1;
  for (; g + 1 < ngroups; g += 2) {
    load_targets<D>(ta, tcol + (size_t)(g + 1) * nb, nt);
    fold<D, Q>(qv, tb, g * nb + b, best, bidx);
    load_targets<D>(tb, tcol + (size_t)min(g + 2, ngroups - 1) * nb, nt);
    fold<D, Q>(qv, ta, (g + 1) * nb + b, best, bidx);
  }
  if (g < ngroups) fold<D, Q>(qv, tb, g * nb + b, best, bidx);
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const int q = q0 + i;
    if (q < nq) {
      vals[(size_t)q * nb + b] = best[i];
      idx[(size_t)q * nb + b] = bidx[i];
    }
  }
}

template <int D, int Q>
cudaError_t launch(const float* dq, const float* dtt, float* vals, int* idx, int nq, int nt,
                   int nb, dim3 grid, int threads, cudaStream_t stream) {
  knn_bins_kernel<D, Q><<<grid, threads, 0, stream>>>(dq, dtt, vals, idx, nq, nt, nb);
  return cudaGetLastError();
}

}  // namespace

// dq: (nq, nd) row-major; dtt: (nd, nt) row-major (targets transposed);
// vals: (nq, nb) f32; idx: (nq, nb) int32. nt must be a multiple of nb. The
// launch (grid_x bin blocks of `threads` bins, grid_y query blocks of `qpt`
// queries) is ops/knn.py's bins_grid; it must cover every (query, bin) and
// name a compiled (nd, qpt) pair. Returns a cudaError_t code (0 on success).
extern "C" int wc_knn_bins(const float* dq, const float* dtt, float* vals, int* idx,
                           int nq, int nt, int nd, int nb, int grid_x, int grid_y, int threads,
                           int qpt, void* stream) {
  if (nq < 1 || nb < 1 || nt < nb || nt % nb != 0 || threads < 1 || threads > kMaxThreads ||
      grid_x < 1 || grid_y < 1 || grid_y > 65535 || (long long)grid_x * threads < nb ||
      (long long)grid_y * qpt < nq)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_x, grid_y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nd == 3 && qpt == 16)
    return (int)launch<3, 16>(dq, dtt, vals, idx, nq, nt, nb, grid, threads, s);
  if (nd == 6 && qpt == 16)
    return (int)launch<6, 16>(dq, dtt, vals, idx, nq, nt, nb, grid, threads, s);
  if (nd == 8 && qpt == 8)
    return (int)launch<8, 8>(dq, dtt, vals, idx, nq, nt, nb, grid, threads, s);
  return (int)cudaErrorInvalidValue;
}
