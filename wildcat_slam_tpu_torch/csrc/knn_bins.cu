// Per-bin nearest-target search for the surfel matcher (kernel K2).
//
// Replaces: wildcat_slam_tpu/ops/knn_pallas.py, _knn_bins with _knn_vpu_kernel
// (the Pallas TPU kernel behind knn_topk_fused). For each query row q and each
// bin b (targets t = b, b + nb, b + 2 nb, ...), it finds the smallest squared
// descriptor distance and the target that attains it. Targets are walked in
// increasing order with a strict '<', so on a tie the earlier target wins, as
// in the TPU kernel. The caller pads T to a multiple of nb with far rows
// (1e6), which never win a bin against a real target, and finishes with an
// exact top-k over the (Q, nb) result.
//
// What bounds it on an H100: arithmetic. Each (q, t) pair costs D subtracts,
// D multiplies and D-1 adds (no FMA: the distance is rounded exactly like the
// plain PyTorch version, so the two agree bit for bit). At Q = 8192 and
// T = 16384 that is ~2.4 G float ops; the target table (T * D * 4 bytes,
// 384 KB) stays in L2, and the (Q, nb) outputs are 32 MB.
//
// Design: one thread per (bin, group of kQPT queries). The kQPT query rows
// live in registers, so every target row read from memory serves kQPT
// distances. Targets are read transposed (D, T): the 128 threads of a warp
// row take neighbouring bins, i.e. neighbouring targets, so each load is
// coalesced. Outputs are written once, coalesced along the bin axis. No
// shared memory, no atomics: every output has exactly one writer.

#include <cuda_runtime.h>

namespace {

constexpr int kBinsPerBlock = 128;
constexpr int kRowsPerBlock = 2;
constexpr int kQPT = 8;

template <int D>
__global__ void __launch_bounds__(kBinsPerBlock * kRowsPerBlock)
knn_bins_kernel(const float* __restrict__ dq, const float* __restrict__ dtt,
                float* __restrict__ vals, int* __restrict__ idx,
                int nq, int nt, int nb) {
  const int b = blockIdx.x * kBinsPerBlock + threadIdx.x;
  const int q0 = (blockIdx.y * kRowsPerBlock + threadIdx.y) * kQPT;
  if (b >= nb) return;

  float qv[kQPT][D];
#pragma unroll
  for (int i = 0; i < kQPT; ++i) {
    const int q = q0 + i < nq ? q0 + i : nq - 1;
#pragma unroll
    for (int d = 0; d < D; ++d) qv[i][d] = __ldg(&dq[(size_t)q * D + d]);
  }

  float best[kQPT];
  int bidx[kQPT];
  const int ngroups = nt / nb;
  for (int g = 0; g < ngroups; ++g) {
    const int t = g * nb + b;
    float tv[D];
#pragma unroll
    for (int d = 0; d < D; ++d) tv[d] = __ldg(&dtt[(size_t)d * nt + t]);
#pragma unroll
    for (int i = 0; i < kQPT; ++i) {
      float diff = __fsub_rn(qv[i][0], tv[0]);
      float s = __fmul_rn(diff, diff);
#pragma unroll
      for (int d = 1; d < D; ++d) {
        diff = __fsub_rn(qv[i][d], tv[d]);
        s = __fadd_rn(s, __fmul_rn(diff, diff));
      }
      if (g == 0 || s < best[i]) {  // strict: ties keep the earlier target
        best[i] = s;
        bidx[i] = t;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kQPT; ++i) {
    const int q = q0 + i;
    if (q < nq) {
      vals[(size_t)q * nb + b] = best[i];
      idx[(size_t)q * nb + b] = bidx[i];
    }
  }
}

template <int D>
cudaError_t launch(const float* dq, const float* dtt, float* vals, int* idx,
                   int nq, int nt, int nb, cudaStream_t stream) {
  const dim3 block(kBinsPerBlock, kRowsPerBlock);
  const dim3 grid((nb + kBinsPerBlock - 1) / kBinsPerBlock,
                  (nq + kRowsPerBlock * kQPT - 1) / (kRowsPerBlock * kQPT));
  knn_bins_kernel<D><<<grid, block, 0, stream>>>(dq, dtt, vals, idx, nq, nt, nb);
  return cudaGetLastError();
}

}  // namespace

// dq: (nq, nd) row-major; dtt: (nd, nt) row-major (targets transposed);
// vals: (nq, nb) f32; idx: (nq, nb) int32. nt must be a multiple of nb.
// Returns a cudaError_t code (0 on success).
extern "C" int wc_knn_bins(const float* dq, const float* dtt, float* vals, int* idx,
                           int nq, int nt, int nd, int nb, void* stream) {
  if (nq < 1 || nb < 1 || nt < nb || nt % nb != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nd) {
    case 3: return (int)launch<3>(dq, dtt, vals, idx, nq, nt, nb, s);
    case 6: return (int)launch<6>(dq, dtt, vals, idx, nq, nt, nb, s);
    case 8: return (int)launch<8>(dq, dtt, vals, idx, nq, nt, nb, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
