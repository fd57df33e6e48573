// Dense symmetric positive definite solve in one launch (kernel K4).
//
// Replaces: the dense solves of the JAX package's sweep, XLA operations with
// no Pallas kernel behind them -- jax.scipy.linalg.cho_factor / cho_solve of
// the damped LM system (wildcat_slam_tpu/odometry/solver.py, lm_step,
// linear_solver="cholesky") and jnp.linalg.solve of the spline fit's normal
// equations (wildcat_slam_tpu/odometry/corrections.py,
// fit_correction_spline), whose matrix N^T N is SPD. The port's plain
// version is ops/spd.py's spd_solve_plain (torch.linalg.cholesky_ex, then
// torch.cholesky_solve). Given a (n, n), of which the lower triangle is
// read, and b (n, m), it computes x = a^-1 b through the Cholesky factor
// L L^T = a; when a pivot is not positive or not finite every entry of x is
// NaN, as JAX's factorisation gives.
//
// Why a kernel: the sweep runs as one composed CUDA graph (csrc/
// sweep_graph.cu), whose child graphs cannot hold memory-allocation nodes,
// and cuBLAS's triangular solves allocate inside a capture on some calls.
// This kernel allocates nothing (the wrapper hands it a workspace from
// torch's allocator) and is one graph node.
//
// What bounds it on an H100: latency. At the LM system's N = 1152 the
// factorisation is N^3 / 6 ~ 2.5e8 FMA (7.6 us at the f32 peak) and a is
// 5.3 MB (1.6 us of HBM), but the factorisation is a chain of N pivots, and
// each 32-wide panel waits on a grid barrier.
//
// Design: one launch, cooperative when the grid has more than one block
// (ops/spd.py, plan; N <= 128 runs in one block, where every barrier is
// __syncthreads()). The factor is built in place in a workspace of 32 x 32
// tiles (row stride np = 32 ceil(n / 32), the padding an identity), with b^T
// appended as one more tile row: the factorisation of [a b; b^T .] carries
// the forward substitution, its last tile row ends as y^T = (L^-1 b)^T.
// Right-looking, one grid barrier a panel: phase k gives each warp a tile.
// The warp of tile (i, k), i > k, applies panel k - 1's update to the
// diagonal tile (k, k) and factors it in registers (a lane a row, each
// column of L broadcast through shared memory: every such warp computes the
// same bits), applies the update to its own tile and solves it against L_kk
// (the trsm), which gives L[i, k];
// the warp of (k, k) does the first two steps and stores L_kk apart, since
// the others still read a[k, k] in this phase; the warp of a trailing tile
// (i, j), k < j <= i, applies panel k - 1's update. After the last panel one
// block solves L^T x = y by panels from the last, x in shared memory, each
// panel's sums over the tiles below split over its warps and added in a
// fixed order, then the 32-row triangle by shuffles. Tiles come into a
// warp's shared memory by cp.async (a column item's own tiles while it
// updates D) and a lane reads its own row there by 16-byte vectors; items go
// round-robin over the blocks first, so each column item has an SM of its
// own. Fixed orders throughout and no float atomics: two runs give the same
// bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRhs = kTile;
// Shared-memory tiles are 32 rows of kStride values, each row 16-byte
// aligned: a lane reading or writing its own row by 16-byte vectors meets no
// bank conflict (36 floats or 34 doubles a row), and a warp reading one row
// together is served by broadcast.
template <typename T>
constexpr int kStride = sizeof(T) == 4 ? 36 : 34;
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);
template <typename T>
using Vec16 = typename std::conditional<sizeof(T) == 4, float4, double2>::type;
// a warp's shared memory: the staged L[., k-1] tile, L_kk^T, a row buffer,
// 32 reciprocals
template <typename T>
constexpr int kWarpSmem = 3 * kTile * kStride<T> + kTile;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct SpdArgs {
  const T* a;      // (n, n) row-major, lower triangle read
  const T* b;      // (n, m) row-major
  T* x;            // (n, m) output
  T* w;            // workspace: (np + 32) rows of np, the diagonal factors, their reciprocals
  unsigned* sync;  // [0] the barrier count, [1] the bad-pivot flag
  int n;
  int m;
  int tiles;       // P = np / 32
};

// Grid-wide barrier on a counter (K1's, csrc/pcg.cu): every block adds one
// (a release), then waits for the count to reach the raised target (an
// acquire). One block: __syncthreads().
__device__ __forceinline__ void grid_barrier(unsigned* ctr, unsigned& target) {
  __syncthreads();
  if (gridDim.x == 1) return;
  target += gridDim.x;
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(ctr) : "memory");
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(ctr) : "memory");
    } while (v < target);
  }
  __syncthreads();
}

// Start copying the tile at src (row stride ld) into the shared tile dst by
// 16-byte cp.async copies, consecutive lanes on consecutive chunks of a row;
// through L2 only (.cg), since the workspace is written by other blocks in
// this launch. copy_commit closes a group of copies, copy_wait<N> waits until
// at most N groups are in flight and makes the copies visible to the warp.
template <typename T>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, int ld, int lane) {
  constexpr int per_row = kTile / kVec<T>;      // 16-byte chunks a row: 8 or 16
  constexpr int chunks = kTile * per_row / 32;  // a lane's
#pragma unroll
  for (int u = 0; u < chunks; ++u) {
    const int id = lane + 32 * u, r = id / per_row, c = (id % per_row) * kVec<T>;
    const unsigned to = (unsigned)__cvta_generic_to_shared(dst + r * kStride<T> + c);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(to),
                 "l"(src + (size_t)r * ld + c)
                 : "memory");
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
  __syncwarp();
}

// Row r of a shared tile (row points at it) into registers, or back.
template <typename T>
__device__ __forceinline__ void read_row(T (&v)[kTile], const T* row) {
  const Vec16<T>* p = reinterpret_cast<const Vec16<T>*>(row);
#pragma unroll
  for (int u = 0; u < kTile / kVec<T>; ++u) {
    const Vec16<T> q = p[u];
    if constexpr (kVec<T> == 4) {
      v[4 * u] = q.x;
      v[4 * u + 1] = q.y;
      v[4 * u + 2] = q.z;
      v[4 * u + 3] = q.w;
    } else {
      v[2 * u] = q.x;
      v[2 * u + 1] = q.y;
    }
  }
}

template <typename T>
__device__ __forceinline__ void write_row(const T (&v)[kTile], T* row) {
  Vec16<T>* p = reinterpret_cast<Vec16<T>*>(row);
#pragma unroll
  for (int u = 0; u < kTile / kVec<T>; ++u) {
    if constexpr (kVec<T> == 4) {
      p[u] = make_float4(v[4 * u], v[4 * u + 1], v[4 * u + 2], v[4 * u + 3]);
    } else {
      p[u] = make_double2(v[2 * u], v[2 * u + 1]);
    }
  }
}

// Row r (the lane) from registers into the tile at dst, through the row buffer.
template <typename T>
__device__ __forceinline__ void store_row(const T (&v)[kTile], T* buf, T* dst, int ld, int lane) {
  __syncwarp();
  write_row(v, buf + lane * kStride<T>);
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kTile; ++r) dst[(size_t)r * ld + lane] = buf[r * kStride<T> + lane];
}

// acc (row r of a tile) -= li (row r of L[i, k-1]) * L[j, k-1]^T, lj the
// staged L[j, k-1]; each sum in order of the panel's columns.
template <typename T>
__device__ __forceinline__ void tile_update(T (&acc)[kTile], const T (&li)[kTile], const T* lj) {
#pragma unroll
  for (int c = 0; c < kTile; ++c) {
    T row[kTile];
    read_row(row, lj + c * kStride<T>);
#pragma unroll
    for (int p = 0; p < kTile; ++p) acc[c] = fma(-li[p], row[p], acc[c]);
  }
}

// Cholesky of a 32 x 32 tile held a row a lane (d[j] = D[lane][j]): on
// return d[j] = L[lane][j], zero above the diagonal, and inv = 1 / L[lane][lane].
// Each step's column of L goes through col (32 values of shared memory), so
// every lane reads it by broadcast vector loads, not one shuffle a value.
// Returns whether a pivot was not positive or not finite (the same on
// every lane).
template <typename T>
__device__ __forceinline__ bool chol_tile(T (&d)[kTile], T& inv, T* col, int lane) {
  bool bad = false;
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    const T piv = __shfl_sync(kFull, d[j], j);
    bad |= !(piv > T(0) && piv < T(INFINITY));
    const T rs = rsqrt(piv);  // 1 / L[j][j] in one instruction chain, not a sqrt then a divide
    const T s = piv * rs;
    if (lane == j) inv = rs;
    const T l = lane > j ? d[j] * rs : (lane == j ? s : T(0));
    d[j] = l;
    col[lane] = l;
    __syncwarp();
    T lc[kTile];
    read_row(lc, col);
#pragma unroll
    for (int q = j + 1; q < kTile; ++q) d[q] = fma(-l, lc[q], d[q]);
    __syncwarp();  // col is written again at the next step
  }
  return bad;
}

// Row r of L[i, k] from row r of the updated a[i, k]: L_kk x = a by forward
// substitution, column by column (lkt holds L_kk^T, rinv its reciprocal
// diagonal).
template <typename T>
__device__ __forceinline__ void trsm_row(T (&acc)[kTile], const T* lkt, const T* rinv) {
#pragma unroll
  for (int c = 0; c < kTile; ++c) {
    const T xc = acc[c] * rinv[c];
    acc[c] = xc;
    T lr[kTile];  // column c of L_kk, by broadcast vector loads
    read_row(lr, lkt + c * kStride<T>);
#pragma unroll
    for (int q = c + 1; q < kTile; ++q) acc[q] = fma(-lr[q], xc, acc[q]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) spd_kernel(SpdArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = a.n, m = a.m, P = a.tiles, np = P * kTile;
  const int gwarp = blockIdx.x * kWarps + warp, nwarps = gridDim.x * kWarps;
  T* w = a.w;
  T* diag = a.w + (size_t)(np + kTile) * np;  // L_kk, row-major, tile k at k * 1024
  T* recip = diag + (size_t)P * kTile * kTile;  // 1 / diag(L_kk), tile k at k * 32
  unsigned* ctr = a.sync;
  unsigned* flag = a.sync + 1;
  unsigned target = 0;

  if (blockIdx.x == 0 && tid == 0) {
    *ctr = 0u;
    *flag = 0u;
  }
  if (gridDim.x > 1) {
    cg::this_grid().sync();  // the count starts at 0 (the launch's one cooperative sync)
  } else {
    __syncthreads();
  }

  // ---- the lower tiles of a (the padding an identity) and b^T into the workspace
  {
    const int lower = P * (P + 1) / 2;
    for (int t = gwarp; t < lower + P; t += nwarps) {
      int i, j;
      if (t >= lower) {
        i = P;
        j = t - lower;
      } else {
        i = 0;
        int u = t;
        while (u > i) {
          u -= i + 1;
          ++i;
        }
        j = u;
      }
      const int col = j * kTile + lane;
      T* dst = w + (size_t)i * kTile * np + col;
      for (int r = 0; r < kTile; ++r) {
        const int row = i * kTile + r;
        T v = T(0);
        if (i < P) {
          if (row < n && col < n) {
            if (col <= row) v = __ldg(a.a + (size_t)row * n + col);
          } else if (row == col) {
            v = T(1);
          }
        } else if (r < m && col < n) {
          v = __ldg(a.b + (size_t)col * m + r);
        }
        dst[(size_t)r * np] = v;
      }
    }
  }
  grid_barrier(ctr, target);

  // ---- the factorisation, one phase a panel
  constexpr int S = kStride<T>;
  T* lj = smem + warp * kWarpSmem<T>;  // the staged L[., k-1] tile (a[0, 0] at k = 0)
  T* lkt = lj + kTile * S;              // L_kk^T (before that, a second staging tile)
  T* buf = lkt + kTile * S;             // the row buffer
  T* rinv = buf + kTile * S;            // 1 / diag(L_kk)
  auto tile = [&](int i, int j) { return w + (size_t)i * kTile * np + j * kTile; };
  for (int k = 0; k < P; ++k) {
    const int col_items = P - k + 1;
    int items = col_items;
    if (k > 0) {
      for (int j = k + 1; j < P; ++j) items += P - j + 1;
    }
    // item t to warp t / grid of block t % grid: the column items, the
    // longest, each on an SM of its own
    for (int t = warp * gridDim.x + blockIdx.x; t < items; t += nwarps) {
      T acc[kTile], li[kTile];
      if (t < col_items) {
        // column item: tile (i, k); i == k the diagonal, i == P the right-hand sides.
        // D = a[k, k] - L[k, k-1] L[k, k-1]^T, the own tile's copy in flight
        // meanwhile; then L_kk, then the own tile's update and solve
        const int i = k + t;
        T d[kTile];
        __syncwarp();
        if (k > 0) {
          copy_tile(lj, tile(k, k - 1), np, lane);
          copy_tile(buf, tile(k, k), np, lane);
          copy_commit();
          if (i != k) {
            copy_tile(lkt, tile(i, k - 1), np, lane);
            copy_commit();
            copy_wait<1>();
          } else {
            copy_wait<0>();
          }
          read_row(li, lj + lane * S);
          read_row(d, buf + lane * S);
          if (i != k) {
            __syncwarp();  // buf is read
            copy_tile(buf, tile(i, k), np, lane);
            copy_commit();
          }
          tile_update(d, li, lj);
          if (i != k) {
            copy_wait<0>();
            read_row(li, lkt + lane * S);  // L[i, k-1]
          }
        } else {
          copy_tile(lj, tile(k, k), np, lane);
          if (i != k) copy_tile(buf, tile(i, k), np, lane);
          copy_commit();
          copy_wait<0>();
          read_row(d, lj + lane * S);
        }
        T inv = T(0);
        const bool bad = chol_tile(d, inv, rinv, lane);  // rinv as the column buffer
        if (i == k) {
          store_row(d, buf, diag + (size_t)k * kTile * kTile, kTile, lane);
          recip[k * kTile + lane] = inv;
          if (bad && lane == 0) atomicExch(flag, 1u);
          continue;
        }
        __syncwarp();  // lkt is read
#pragma unroll
        for (int c = 0; c < kTile; ++c) lkt[c * S + lane] = d[c];
        rinv[lane] = inv;
        __syncwarp();
        read_row(acc, buf + lane * S);
        if (k > 0) tile_update(acc, li, lj);
        trsm_row(acc, lkt, rinv);
        store_row(acc, buf, tile(i, k), np, lane);
      } else {
        // trailing item: tile (i, j), k < j <= i, takes panel k - 1's update
        int u = t - col_items, j = k + 1;
        while (u >= P - j + 1) {
          u -= P - j + 1;
          ++j;
        }
        const int i = j + u;
        __syncwarp();
        copy_tile(lj, tile(j, k - 1), np, lane);
        copy_tile(buf, tile(i, k - 1), np, lane);
        copy_tile(lkt, tile(i, j), np, lane);
        copy_commit();
        copy_wait<0>();
        read_row(li, buf + lane * S);
        read_row(acc, lkt + lane * S);
        tile_update(acc, li, lj);
        store_row(acc, buf, tile(i, j), np, lane);
      }
    }
    grid_barrier(ctr, target);
  }
  if (blockIdx.x != 0) return;

  // ---- L^T x = y by one block, panels from the last; x in shared memory
  T* xs = smem;                    // (np, m)
  T* part = smem + (size_t)np * m;  // (warps, 32, m): each lane's sums, tile by tile
  for (int k = P - 1; k >= 0; --k) {
    for (int t = 0; t < m; ++t) part[(warp * kTile + lane) * m + t] = T(0);
    for (int i = k + 1 + warp; i < P; i += kWarps) {
      const T* col = w + (size_t)i * kTile * np + k * kTile + lane;
      T l[kTile];  // L[32 i + r][32 k + lane]
#pragma unroll
      for (int r = 0; r < kTile; ++r) l[r] = __ldcg(col + (size_t)r * np);
      for (int t = 0; t < m; ++t) {
        const T* xr = xs + (size_t)i * kTile * m + t;
        T s = T(0);
#pragma unroll
        for (int r = 0; r < kTile; ++r) s = fma(l[r], xr[r * m], s);
        part[(warp * kTile + lane) * m + t] += s;
      }
    }
    __syncthreads();
    for (int t = warp; t < m; t += kWarps) {
      T v = __ldcg(w + (size_t)(np + t) * np + k * kTile + lane);  // y_k
      for (int ww = 0; ww < kWarps; ++ww) v -= part[(ww * kTile + lane) * m + t];
      const T* lk = diag + (size_t)k * kTile * kTile;
      T lc[kTile];  // lc[c] = L_kk[c][lane]
#pragma unroll
      for (int c = 0; c < kTile; ++c) lc[c] = __ldcg(lk + c * kTile + lane);
      const T own = __ldcg(recip + k * kTile + lane);  // 1 / L_kk[lane][lane]
#pragma unroll
      for (int c = kTile - 1; c >= 0; --c) {
        if (lane == c) v *= own;  // x[c], final
        const T z = __shfl_sync(kFull, v, c);
        if (lane < c) v = fma(-lc[c], z, v);
      }
      xs[(size_t)(k * kTile + lane) * m + t] = v;
    }
    __syncthreads();
  }
  const bool bad = __ldcg(flag) != 0u;
  const T nan = T(NAN);
  for (int e = tid; e < n * m; e += kThreads) a.x[e] = bad ? nan : xs[e];
}

struct Cached {
  int smem = 0;
  int blocks = 0;
};

template <typename T>
int launch(const void* a, const void* b, void* x, void* work, unsigned* sync, int n, int m,
           int grid, int tiles, int smem_bytes, cudaStream_t stream) {
  // the card's limits and the kernel's occupancy, once per device and
  // shared-memory size (the queries cost more host time than the launch);
  // the caller makes the tensors' card current
  constexpr int kCachedDevices = 64;
  static thread_local Cached cached[kCachedDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const bool hit = dev < kCachedDevices && cached[dev].smem == smem_bytes;
  int blocks = hit ? cached[dev].blocks : 0;
  if (!hit) {
    int coop = 0, sms = 0, optin = 0, per_sm = 0;
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (smem_bytes > optin) return (int)cudaErrorInvalidConfiguration;
    e = cudaFuncSetAttribute(spd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, spd_kernel<T>, kThreads,
                                                      smem_bytes);
    if (e != cudaSuccess) return (int)e;
    blocks = coop ? per_sm * sms : 1;
    if (dev < kCachedDevices) {
      cached[dev].smem = smem_bytes;
      cached[dev].blocks = blocks;
    }
  }
  if (grid > blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
  SpdArgs<T> args{static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(x),
                  static_cast<T*>(work), sync, n, m, tiles};
  if (grid == 1) {
    spd_kernel<T><<<1, kThreads, (size_t)smem_bytes, stream>>>(args);
  } else {
    void* params[] = {&args};
    e = cudaLaunchCooperativeKernel((const void*)spd_kernel<T>, dim3(grid), dim3(kThreads),
                                    params, (size_t)smem_bytes, stream);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// a (n, n), b (n, m), x (n, m) -- float32 (itemsize 4) or float64 (8),
// device, contiguous. work: (32 P + 32) 32 P + 1056 P values of the same
// type, sync: 2 int32, with P = tiles = ceil(n / 32). The launch (grid,
// tiles, smem_bytes) is ops/spd.py's plan, checked here. Returns a
// cudaError_t code (0 on success).
extern "C" int wc_spd_solve(const void* a, const void* b, void* x, void* work, int* sync, int n,
                            int m, int itemsize, int grid, int tiles, int smem_bytes,
                            void* stream) {
  if (n < 1 || m < 1 || m > kMaxRhs || (itemsize != 4 && itemsize != 8) ||
      tiles != (n + kTile - 1) / kTile || grid < 1 || (long long)n * m > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const long long need_factor =
      (long long)kWarps * (itemsize == 4 ? kWarpSmem<float> : kWarpSmem<double>) * itemsize;
  const long long need_solve = ((long long)tiles * kTile + kWarps * kTile) * m * itemsize;
  if (smem_bytes < need_factor || smem_bytes < need_solve) return (int)cudaErrorInvalidValue;
  auto* s = reinterpret_cast<unsigned*>(sync);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return itemsize == 4 ? launch<float>(a, b, x, work, s, n, m, grid, tiles, smem_bytes, st)
                       : launch<double>(a, b, x, work, s, n, m, grid, tiles, smem_bytes, st);
}
