// Block-Jacobi preconditioned conjugate gradients in one launch (kernel K1).
//
// Replaces: wildcat_slam_tpu/ops/pcg_pallas.py, pcg_solve_fused (_pcg_kernel),
// the Pallas TPU kernel that keeps H, the preconditioner and the CG vectors in
// VMEM for the whole solve. It computes x ~ (H + diag(dlam))^-1 b with the
// damping folded into the matvec and the S damped 12x12 block inverses as the
// preconditioner, for at most `iters` iterations, stopping early when
// |r|^2 <= tol^2 |b|^2 -- the same recurrence and exit test as the TPU kernel
// and as the plain PyTorch version (ops/pcg.py, pcg_solve_plain).
//
// What bounds it on an H100: the matvec reads all of H every iteration
// (N = 12 S; 5.3 MB at S = 96, 37.7 MB at S = 256). That fits the 50 MB L2
// but not one SM's 227 KB of shared memory, so H cannot stay on chip per SM
// the way it stayed in VMEM on the TPU. At these sizes the iteration is
// bounded by latency -- L2 reads and the grid-wide barriers between the
// phases -- more than by bandwidth or FLOPs.
//
// Design: one cooperative launch with a grid no larger than the co-resident
// limit. Each block owns 12-row block-rows (b, b + gridDim.x, ...), so any S
// runs on any grid. Per iteration three phases separated by grid.sync():
//   A. p is staged in shared memory; each of the 12 warps computes one row of
//      H p + dlam * p (f32 FMAs over the L2-resident row, then a fixed-order
//      warp reduction) and the block's partial p.Hp;
//   B. every block sums all partials in the same fixed order, so alpha is the
//      same bit pattern everywhere; x and r are updated for the block's rows,
//      z = Minv r is applied with the block's own 12x12 inverse, and partial
//      r.z and r.r are written;
//   C. the partials are summed the same way; beta, the new p, and the exit
//      test, which every block evaluates identically and so leaves together.
// No float atomics: two runs on the same inputs give the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kB = 12;              // preconditioner block size
constexpr int kThreads = 32 * kB;   // one warp per row of a block-row
constexpr int kMaxN = 12000;        // staged p + statics within 48 KB of shared memory

struct PcgArgs {
  const float* h;     // (n, n) row-major
  const float* dlam;  // (n,)
  const float* minv;  // (s, 12, 12)
  const float* b;     // (n,)
  float* x;           // (n,) output
  float* r;           // (n,) scratch
  float* p;           // (n,) scratch
  float* w;           // (n,) scratch: H p, then z
  float* part;        // (3, gridDim.x) per-block partial sums
  int n;
  int s;
  int iters;
  float tol2;
};

__device__ __forceinline__ float block_sum_fixed(const float* part, int count) {
  float acc = 0.f;
  for (int i = 0; i < count; ++i) acc += part[i];
  return acc;
}

// z = Minv_sb r for the 12 rows in sr; thread t < 12 computes row t.
__device__ __forceinline__ float apply_block_inverse(const float* minv, int sb,
                                                     const float* sr, int t) {
  const float* m = minv + (size_t)sb * kB * kB + t * kB;
  float z = 0.f;
#pragma unroll
  for (int j = 0; j < kB; ++j) z = fmaf(m[j], sr[j], z);
  return z;
}

__global__ void __launch_bounds__(kThreads) pcg_kernel(PcgArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float sp[];  // staged p, n floats
  __shared__ float sr[kB], sz[kB], swarp[kB], bcast[3];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int nblk = gridDim.x;
  float* part_a = a.part;
  float* part_b = a.part + nblk;
  float* part_c = a.part + 2 * nblk;
  const float tiny = 1e-30f;

  // init: x = 0, r = b, z = Minv b, p = z; partial r.z and b.b
  float acc_rz = 0.f, acc_bb = 0.f;
  for (int sb = blockIdx.x; sb < a.s; sb += nblk) {
    const int r0 = sb * kB;
    if (tid < kB) {
      const float bv = a.b[r0 + tid];
      sr[tid] = bv;
      a.x[r0 + tid] = 0.f;
      a.r[r0 + tid] = bv;
    }
    __syncthreads();
    if (tid < kB) {
      const float z = apply_block_inverse(a.minv, sb, sr, tid);
      sz[tid] = z;
      a.p[r0 + tid] = z;
    }
    __syncthreads();
    if (tid == 0) {
      for (int i = 0; i < kB; ++i) {
        acc_rz += sr[i] * sz[i];
        acc_bb += sr[i] * sr[i];
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    part_b[blockIdx.x] = acc_rz;
    part_c[blockIdx.x] = acc_bb;
  }
  grid.sync();
  if (tid == 0) {
    bcast[0] = block_sum_fixed(part_b, nblk);
    bcast[1] = block_sum_fixed(part_c, nblk);
  }
  __syncthreads();
  float rz = bcast[0];
  const float b2 = bcast[1];
  float rr = b2;
  __syncthreads();

  for (int k = 0; k < a.iters && rr > a.tol2 * b2; ++k) {
    // ---- A: w = H p + dlam * p on own rows; partial p.w
    for (int i = tid; i < a.n; i += kThreads) sp[i] = a.p[i];
    __syncthreads();
    float acc_pw = 0.f;
    for (int sb = blockIdx.x; sb < a.s; sb += nblk) {
      const int row = sb * kB + warp;
      const float* hr = a.h + (size_t)row * a.n;
      float acc = 0.f;
      for (int j = lane; j < a.n; j += 32) acc = fmaf(hr[j], sp[j], acc);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
      if (lane == 0) {
        const float v = acc + a.dlam[row] * sp[row];
        a.w[row] = v;
        swarp[warp] = sp[row] * v;
      }
      __syncthreads();
      if (tid == 0) {
        for (int i = 0; i < kB; ++i) acc_pw += swarp[i];
      }
      __syncthreads();
    }
    if (tid == 0) part_a[blockIdx.x] = acc_pw;
    grid.sync();

    // ---- B: alpha; x, r update; z = Minv r; partial r.z, r.r
    if (tid == 0) bcast[0] = block_sum_fixed(part_a, nblk);
    __syncthreads();
    const float alpha = rz / fmaxf(bcast[0], tiny);
    float acc_rz_new = 0.f, acc_rr = 0.f;
    for (int sb = blockIdx.x; sb < a.s; sb += nblk) {
      const int r0 = sb * kB;
      if (tid < kB) {
        const int i = r0 + tid;
        a.x[i] = a.x[i] + alpha * a.p[i];
        const float rv = a.r[i] - alpha * a.w[i];
        a.r[i] = rv;
        sr[tid] = rv;
      }
      __syncthreads();
      if (tid < kB) {
        const float z = apply_block_inverse(a.minv, sb, sr, tid);
        sz[tid] = z;
        a.w[r0 + tid] = z;
      }
      __syncthreads();
      if (tid == 0) {
        for (int i = 0; i < kB; ++i) {
          acc_rz_new += sr[i] * sz[i];
          acc_rr += sr[i] * sr[i];
        }
      }
      __syncthreads();
    }
    if (tid == 0) {
      part_b[blockIdx.x] = acc_rz_new;
      part_c[blockIdx.x] = acc_rr;
    }
    grid.sync();

    // ---- C: beta, p = z + beta p, exit test (identical on every block)
    if (tid == 0) {
      bcast[1] = block_sum_fixed(part_b, nblk);
      bcast[2] = block_sum_fixed(part_c, nblk);
    }
    __syncthreads();
    const float rz_new = bcast[1];
    rr = bcast[2];
    const float beta = rz_new / fmaxf(rz, tiny);
    rz = rz_new;
    for (int sb = blockIdx.x; sb < a.s; sb += nblk) {
      if (tid < kB) {
        const int i = sb * kB + tid;
        a.p[i] = a.w[i] + beta * a.p[i];
      }
    }
    grid.sync();
  }
}

}  // namespace

extern "C" const char* wc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// h (n, n), dlam (n,), minv (n/12, 12, 12), b (n,), x (n,) -- f32, device,
// contiguous. scratch: 3 n + 3 (n / 12) floats. tol2 = tol * tol.
// Returns a cudaError_t code (0 on success).
extern "C" int wc_pcg_solve(const float* h, const float* dlam, const float* minv,
                            const float* b, float* x, float* scratch, int n, int iters,
                            float tol2, void* stream) {
  if (n < kB || n % kB != 0 || n > kMaxN || iters < 0) return (int)cudaErrorInvalidValue;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = (size_t)n * sizeof(float);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pcg_kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  const int s = n / kB;
  const int grid = s < per_sm * sms ? s : per_sm * sms;
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  PcgArgs a{h, dlam, minv, b, x, scratch, scratch + n, scratch + 2 * n, scratch + 3 * n,
            n, s, iters, tol2};
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)pcg_kernel, dim3(grid), dim3(kThreads), args,
                                  smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
