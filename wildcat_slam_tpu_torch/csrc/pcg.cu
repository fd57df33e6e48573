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
// What bounds it on an H100: not bytes or FLOPs but latency. H (N = 12 S;
// 5.3 MB at S = 96, 21.2 MB at S = 192, 37.7 MB at S = 256) is read once per
// iteration, ~1.6 us of HBM time at S = 96 for the whole solve, while an
// iteration waits on two grid-wide barriers, two L2 round trips for the
// cross-block sums, and the matvec's reads of H.
//
// Design: one cooperative launch (the grid no larger than the co-resident
// limit) laid out by ops/pcg.py, launch_plan. Block i owns the contiguous
// block-rows [i k, (i + 1) k) and keeps the first `resident` of them in
// shared memory for the whole solve, copied once at the start by TMA bulk
// copies completing on an mbarrier; the rest (only where H outgrows the
// grid's shared memory: S = 256) are read from L2 every iteration. Every
// block keeps the whole p vector in shared memory. The own rows' x, r, Hp,
// dlam and block-inverse rows live in registers, one thread per row (16 lanes
// per block-row, so z = Minv r is a 16-wide shuffle). An iteration is
//   A. w = H p + dlam p on the own rows: each thread takes float4 columns of
//      p and of the 12 rows of a block-row (12 independent FMA chains), the
//      block reduces the 12 sums (halving shuffles, then across warps); the
//      block's partial p.w is written; grid barrier;
//   B. alpha from the sum of the partials; x and r updated; z = Minv r; z and
//      the partial r.z and r.r are written; grid barrier;
//   C. rz and rr from the sums of the partials, beta, and p = z + beta p
//      formed by every block from all of z (read from L2), the same
//      expression on the same bits everywhere, so no block needs a global p
//      and there is no third barrier; the exit test.
// The barriers are a counter in global memory (a release add, an acquire
// poll by one thread a block), lighter than cooperative_groups' grid sync,
// which fences fully on both sides. Each sum over the per-block partials is
// taken by one warp, lane l adding partials l, l + 32, ... in order and then
// a butterfly, so every lane of every block holds the same bits: all blocks
// compute the same alpha, beta and exit test and leave the loop together. No
// float atomics: two runs on the same inputs give the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kB = 12;                                   // preconditioner block size
constexpr int kThreads = 384;                            // 12 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowLanes = 16;                            // lanes per owned block-row
constexpr int kMaxRowsPerBlock = kThreads / kRowLanes;   // block-rows a block can own
constexpr int kStaticSmem = 1024;                        // ops/pcg.py STATIC_SMEM
constexpr int kZRegs = 2;                                // z chunks fetched before the sums
constexpr float kTiny = 1e-30f;

struct PcgArgs {
  const float* h;     // (n, n) row-major
  const float* dlam;  // (n,)
  const float* minv;  // (s, 12, 12)
  const float* b;     // (n,)
  float* x;           // (n,) output
  float* z;           // (n,) scratch: the preconditioned residual
  float* part;        // (3 gridDim.x + 1) scratch: per-block partial sums, the barrier count
  int n;
  int s;
  int iters;
  int rows_per_block;  // block-rows per block (the last block may own fewer)
  int resident;        // of them, held in shared memory
  float tol2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Butterfly sum over the warp: every lane ends with the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of part[0..count) by one warp, in a fixed order; every lane gets it.
__device__ __forceinline__ float sum_partials(const float* part, int count, int lane) {
  float acc = 0.f;
  for (int i = lane; i < count; i += 32) acc += __ldcg(part + i);
  return warp_sum(acc);
}

// One halving step of warp_sum12: lanes with bit 2 HALF set keep the upper
// half of v, the others the lower half, each adding its partner's copy.
template <int HALF>
__device__ __forceinline__ void halve(float (&v)[16], int lane) {
  const bool hi = (lane & (2 * HALF)) != 0;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float keep = hi ? v[j + HALF] : v[j];
    const float send = hi ? v[j] : v[j + HALF];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * HALF);
  }
}

__device__ __forceinline__ float warp_sum12(float (&v)[16], int lane) {
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// Fixed-order sums of one or two per-thread values over the row threads of a
// block (warps [0, row_warps)); the result is valid in thread 0.
__device__ __forceinline__ float2 rows_sum(float2 v, int row_warps, int warp, int lane,
                                           float2* swarp) {
  if (warp < row_warps) {
    v.x = warp_sum(v.x);
    v.y = warp_sum(v.y);
  }
  if (row_warps == 1) return v;
  if (warp < row_warps && lane == 0) swarp[warp] = v;
  __syncthreads();
  float2 acc = make_float2(0.f, 0.f);
  if (threadIdx.x == 0) {
    for (int w = 0; w < row_warps; ++w) {
      acc.x += swarp[w].x;
      acc.y += swarp[w].y;
    }
  }
  return acc;
}


// Grid-wide barrier on a counter: every block adds one (a release, so the
// block's writes before it are visible to whoever sees the count), then
// waits until the count reaches `target` (an acquire). The caller raises the
// target by the number of blocks at each barrier; the counter is reset at
// the start of the launch.
__device__ __forceinline__ void grid_barrier(unsigned* ctr, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(ctr) : "memory");
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(ctr) : "memory");
    } while (v < target);
  }
  __syncthreads();
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__global__ void __launch_bounds__(kThreads, 1) pcg_kernel(PcgArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(128) float smem[];
  __shared__ float red[kWarps][kB];
  __shared__ float2 swarp[kWarps];
  __shared__ float bc[3];
  __shared__ __align__(8) uint64_t bar;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = a.n, nq = n / 4, nblk = gridDim.x;
  const int blk0 = blockIdx.x * a.rows_per_block;        // first owned block-row
  const int kb = min(a.rows_per_block, a.s - blk0);      // owned block-rows
  const int row_warps = (kb * kRowLanes + 31) / 32;
  float* sh = smem;                                      // resident block-rows of H
  float* sp = smem + (size_t)a.resident * kB * n;        // p, all n entries
  float4* sp4 = reinterpret_cast<float4*>(sp);
  float* part_a = a.part;
  float* part_b = a.part + nblk;
  float* part_c = a.part + 2 * nblk;
  unsigned* ctr = reinterpret_cast<unsigned*>(a.part + 3 * nblk);
  unsigned target = 0;

  // start copying the resident block-rows of H into shared memory
  const int nres = min(a.resident, kb);
  const uint32_t bar_addr = smem_addr(&bar);
  if (nres > 0 && tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_addr));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    const uint32_t row_bytes = (uint32_t)n * 4u;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar_addr),
                 "r"(row_bytes * kB * nres)
                 : "memory");
    const float* src = a.h + (size_t)blk0 * kB * n;
    for (int i = 0; i < nres * kB; ++i) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
              smem_addr(sh + (size_t)i * n)),
          "l"(src + (size_t)i * n), "r"(row_bytes), "r"(bar_addr)
          : "memory");
    }
  }

  // the own rows: thread 16 bb + i holds row 12 (blk0 + bb) + i
  const int bb_own = tid / kRowLanes, i_own = tid % kRowLanes;
  const bool is_row = bb_own < kb && i_own < kB;
  const int row = (blk0 + bb_own) * kB + i_own;
  float minv_row[kB];
  float x = 0.f, r = 0.f, w = 0.f, dl = 0.f;
#pragma unroll
  for (int j = 0; j < kB; ++j) minv_row[j] = 0.f;
  if (is_row) {
    r = a.b[row];
    dl = a.dlam[row];
    const float* m = a.minv + (size_t)(blk0 + bb_own) * kB * kB + i_own * kB;
#pragma unroll
    for (int j = 0; j < kB; ++j) minv_row[j] = m[j];
  }

  // the barrier count starts at 0: reset, then the launch's one cooperative grid sync
  if (blockIdx.x == 0 && tid == 0) *ctr = 0u;
  grid.sync();
  float rz = 0.f, b2 = 0.f, alpha = 0.f;
  bool h_ready = nres == 0;
  for (int k = 0;; ++k) {
    // ---- B: x += alpha p, r -= alpha w (not before the first matvec);
    // z = Minv r; publish z and the partial r.z, r.r
    float2 pr = make_float2(0.f, 0.f);
    if (warp < row_warps) {
      if (k > 0 && is_row) {
        x = x + alpha * sp[row];
        r = r - alpha * w;
      }
      const int base = (lane & 16);
      float z = 0.f;
#pragma unroll
      for (int j = 0; j < kB; ++j) z = fmaf(minv_row[j], __shfl_sync(0xffffffffu, r, base + j), z);
      if (is_row) {
        a.z[row] = z;
        pr = make_float2(r * z, r * r);
      }
    }
    pr = rows_sum(pr, row_warps, warp, lane, swarp);
    if (tid == 0) {
      part_b[blockIdx.x] = pr.x;
      part_c[blockIdx.x] = pr.y;
    }
    grid_barrier(ctr, target += nblk);

    // ---- C: rz, rr; p = z + beta p from all of z; the exit test
    const float4* z4 = reinterpret_cast<const float4*>(a.z);
    float4 zr[kZRegs];
#pragma unroll
    for (int u = 0; u < kZRegs; ++u) {
      const int c = tid + u * kThreads;
      if (c < nq) zr[u] = __ldcg(z4 + c);
    }
    if (warp < 2) {
      const float v = sum_partials(warp == 0 ? part_b : part_c, nblk, lane);
      if (lane == 0) bc[warp] = v;
    }
    __syncthreads();
    const float rz_new = bc[0], rr = bc[1];
    if (k == 0) {
      b2 = rr;
#pragma unroll
      for (int u = 0; u < kZRegs; ++u) {
        const int c = tid + u * kThreads;
        if (c < nq) sp4[c] = zr[u];
      }
      for (int c = tid + kZRegs * kThreads; c < nq; c += kThreads) sp4[c] = __ldcg(z4 + c);
    } else {
      const float beta = rz_new / fmaxf(rz, kTiny);
#pragma unroll
      for (int u = 0; u < kZRegs; ++u) {
        const int c = tid + u * kThreads;
        if (c < nq) {
          float4 p = sp4[c];
          p.x = zr[u].x + beta * p.x;
          p.y = zr[u].y + beta * p.y;
          p.z = zr[u].z + beta * p.z;
          p.w = zr[u].w + beta * p.w;
          sp4[c] = p;
        }
      }
      for (int c = tid + kZRegs * kThreads; c < nq; c += kThreads) {
        const float4 zc = __ldcg(z4 + c);
        float4 p = sp4[c];
        p.x = zc.x + beta * p.x;
        p.y = zc.y + beta * p.y;
        p.z = zc.z + beta * p.z;
        p.w = zc.w + beta * p.w;
        sp4[c] = p;
      }
    }
    rz = rz_new;
    __syncthreads();
    if (!(k < a.iters && rr > a.tol2 * b2)) break;
    if (!h_ready) {  // the matvec needs H from here on
      mbar_wait(bar_addr, 0);
      h_ready = true;
    }

    // ---- A: w = H p + dlam p on the own rows; publish the partial p.w
    for (int bb = 0; bb < kb; ++bb) {
      float acc[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = 0.f;
      if (bb < nres) {
        const float4* hb = reinterpret_cast<const float4*>(sh + (size_t)bb * kB * n);
        for (int c = tid; c < nq; c += kThreads) {
          const float4 pv = sp4[c];
#pragma unroll
          for (int i = 0; i < kB; ++i) {
            const float4 hv = hb[i * nq + c];
            acc[i] = fmaf(hv.x, pv.x, acc[i]);
            acc[i] = fmaf(hv.y, pv.y, acc[i]);
            acc[i] = fmaf(hv.z, pv.z, acc[i]);
            acc[i] = fmaf(hv.w, pv.w, acc[i]);
          }
        }
      } else {
        const float4* hb = reinterpret_cast<const float4*>(a.h + (size_t)(blk0 + bb) * kB * n);
        for (int c = tid; c < nq; c += kThreads) {
          const float4 pv = sp4[c];
#pragma unroll
          for (int i = 0; i < kB; ++i) {
            const float4 hv = __ldg(hb + i * nq + c);
            acc[i] = fmaf(hv.x, pv.x, acc[i]);
            acc[i] = fmaf(hv.y, pv.y, acc[i]);
            acc[i] = fmaf(hv.z, pv.z, acc[i]);
            acc[i] = fmaf(hv.w, pv.w, acc[i]);
          }
        }
      }
      const float v = warp_sum12(acc, lane);
      if (lane < 2 * kB && (lane & 1) == 0) red[warp][lane >> 1] = v;
      __syncthreads();
      if (bb_own == bb && i_own < kB) {
        float hp = 0.f;
#pragma unroll
        for (int ww = 0; ww < kWarps; ++ww) hp += red[ww][i_own];
        w = hp + dl * sp[row];
      }
      if (bb + 1 < kb) __syncthreads();  // red is refilled by the next block-row
    }
    float2 pw = make_float2(is_row ? sp[row] * w : 0.f, 0.f);
    pw = rows_sum(pw, row_warps, warp, lane, swarp);
    if (tid == 0) part_a[blockIdx.x] = pw.x;
    grid_barrier(ctr, target += nblk);

    // alpha from the sum of the partials (the row threads need it)
    if (row_warps == 1) {
      if (warp == 0) alpha = rz / fmaxf(sum_partials(part_a, nblk, lane), kTiny);
    } else {
      if (warp == 0) {
        const float v = sum_partials(part_a, nblk, lane);
        if (lane == 0) bc[2] = v;
      }
      __syncthreads();
      alpha = rz / fmaxf(bc[2], kTiny);
    }
  }
  if (!h_ready) mbar_wait(bar_addr, 0);  // no block exits with its copies in flight
  if (is_row) a.x[row] = x;
}

}  // namespace

extern "C" const char* wc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}


// h (n, n), dlam (n,), minv (n/12, 12, 12), b (n,), x (n,) -- f32, device,
// contiguous. scratch: n + 3 * grid + 1 floats. tol2 = tol * tol. The launch plan
// (grid, rows_per_block, resident, smem_bytes) is ops/pcg.py's launch_plan;
// it is checked here against the card. Returns a cudaError_t code (0 on
// success).
extern "C" int wc_pcg_solve(const float* h, const float* dlam, const float* minv,
                            const float* b, float* x, float* scratch, int n, int iters,
                            float tol2, int grid, int rows_per_block, int resident,
                            int smem_bytes, void* stream) {
  const int s = n / kB;
  if (n < kB || n % kB != 0 || iters < 0 || grid < 1 || rows_per_block < 1 ||
      rows_per_block > kMaxRowsPerBlock || (long long)grid * rows_per_block < s ||
      (long long)(grid - 1) * rows_per_block >= s || resident < 0 || resident > rows_per_block ||
      (long long)smem_bytes < 4LL * n * (1 + (long long)kB * resident))
    return (int)cudaErrorInvalidValue;
  // the card's limits and the kernel's occupancy, queried once per device and
  // shared-memory size (these queries cost more host time than the launch);
  // the cache is keyed by the device, so windows on several cards stepped in
  // turn do not query again. The caller makes the tensors' card current
  constexpr int kCachedDevices = 64;
  static thread_local int cached_smem[kCachedDevices] = {};
  static thread_local int cached_blocks[kCachedDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const bool cached = dev < kCachedDevices && cached_smem[dev] == smem_bytes;
  int blocks = cached ? cached_blocks[dev] : 0;
  if (!cached) {
    int coop = 0, sms = 0, optin = 0, per_sm = 0;
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (!coop) return (int)cudaErrorNotSupported;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, pcg_kernel);
    if (e != cudaSuccess) return (int)e;
    if (attr.sharedSizeBytes > (size_t)kStaticSmem || smem_bytes + kStaticSmem > optin)
      return (int)cudaErrorInvalidConfiguration;
    e = cudaFuncSetAttribute(pcg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pcg_kernel, kThreads, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    blocks = per_sm * sms;
    if (dev < kCachedDevices) {
      cached_smem[dev] = smem_bytes;
      cached_blocks[dev] = blocks;
    }
  }
  if (grid > blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
  PcgArgs a{h, dlam, minv, b, x, scratch, scratch + n, n, s, iters, rows_per_block, resident,
            tol2};
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)pcg_kernel, dim3(grid), dim3(kThreads), args,
                                  (size_t)smem_bytes, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
