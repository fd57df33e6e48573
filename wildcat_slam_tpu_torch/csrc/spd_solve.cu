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
// read, and b (n, m), m <= 32, it computes x = a^-1 b through the Cholesky
// factor L L^T = a; when a pivot is not positive or not finite every entry
// of x is NaN, as JAX's factorisation gives.
//
// Why a kernel: the sweep runs as one composed CUDA graph (csrc/
// sweep_graph.cu), whose child graphs cannot hold memory-allocation nodes,
// and cuBLAS's triangular solves allocate inside a capture on some calls.
// This kernel allocates nothing (the wrapper hands it a workspace and its
// flags from torch's allocator) and is one graph node.
//
// What bounds it on an H100: latency, not bytes or operations. At the LM
// system's N = 1152 the work is N^3 / 6 ~ 2.5e8 FMA (7.6 us at the card's
// peak) on 5.3 MB (1.6 us of HBM), but it is a chain of N / 32 = 36 panels:
// each panel's diagonal tile is factored, the tiles below it are solved
// against it, and the next diagonal tile takes their update before it can
// be factored; the back substitution is the same chain in reverse. On an
// NVIDIA H100 80GB HBM3 at 700 W (python -m wildcat_slam_tpu_torch.probe_spd
// --trace; graph replays) a panel takes 6.3 us in float32 and 8.1 us in
// float64 on that chain: a flag hop and a tile copy ~0.8 us, the triangular
// solve 0.6 / 1.1 us, the look-ahead update with its flag ~1.7 us, the
// diagonal tile's 32 pivots 2.6 / 3.9 us; the back substitution adds 2.1 /
// 2.6 us a panel. N = 1152, m = 1 takes 0.31 ms in float32 and 0.39 ms in
// float64, and N = 96, m = 6 (one block) 25 us.
//
// Design. Both paths work on 32 x 32 tiles of [a b; b^T .] (the padding an
// identity): factoring the bordered matrix carries the forward substitution,
// its last tile row ends as y^T = (L^-1 b)^T. A warp owns a tile and applies
// panel k's update A_ij -= L_ik L_jk^T in place, in the order k = 0, 1, ...;
// in float32 by FMA (a lane a row, rows of L_jk read by broadcast), in
// float64 on the tensor cores (DMMA, mma.sync m16n8k4, the tile as 8
// fragments). Shared tiles have rows of 36 values: a lane's 16-byte row reads
// (float32) and DMMA's fragment reads (float64) meet no bank conflict.
// - One block (spd_one_block, N up to the plan's limit: every tile fits the
//   block's shared memory; the spline fit's N = 96): [a b; b^T .] is loaded
//   once into shared memory and factored in place, two __syncthreads() a
//   panel: the column's triangular solves, then the panel's updates, where
//   warp 0 updates and factors the next diagonal tile (the look-ahead) while
//   the other warps apply the rest. Both substitutions run from shared
//   memory and x is written once.
// - Many blocks (spd_tiles, cooperative, so that every block is resident and
//   no wait can deadlock): a tile dataflow, no grid barrier. Each tile has
//   one owner warp; a published tile (in the workspace, L2) sets its flag by
//   st.release.gpu, its consumers spin on it by ld.acquire.gpu and copy it by
//   cp.async. The owner of diagonal tile d also owns (d, d - 1): as soon as
//   L[d-1, d-1] is out it solves (d, d - 1), publishes it, applies its
//   update to (d, d) and factors it -- one flag hop a panel on the critical
//   path, the factorisation of the diagonal off every other tile's. The back
//   substitution is the reverse sweep on the same owners: the owner of
//   (i, k) publishes L_ik^T x_i as soon as x_i is out, the owner of (k, k)
//   subtracts them from y_k in the fixed order i = P-1, ..., k+3, then
//   L_{k+2,k}^T x_{k+2} and L_{k+1,k}^T x_{k+1} itself, solves with L_kk^T and
//   publishes x_k. Each warp
//   walks its tiles in one order for the factorisation (by column, the
//   diagonal first) and the reverse for the back substitution; every wait is
//   on a tile earlier in that order, so no wait can deadlock.
// A bad pivot makes its tile's factor NaN, which spreads to every later
// tile and so to every entry of x. Fixed orders throughout and no float
// atomics: two runs and a graph replay give the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 32;
constexpr int kStride = 36;                  // values a shared tile row
constexpr int kTileSmem = kTile * kStride;   // values a shared tile
constexpr int kTileWork = kTile * kTile;     // values a workspace tile
constexpr int kOneBlockWarps = 8;
constexpr int kMaxWarps = 8;                 // a block of the many-block path
constexpr int kWarpSmem = 4 * kTileSmem + 5 * kTile;  // its warp: 4 tiles, 5 x 32 values
constexpr int kMaxRhs = kTile;
constexpr int kMaxN = 65536;
constexpr unsigned kFull = 0xffffffffu;
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);
template <typename T>
using Vec16 = typename std::conditional<sizeof(T) == 4, float4, double2>::type;

// Tile (i, j) of the lower triangle, and with i = P the tile j of b^T's row.
__host__ __device__ __forceinline__ size_t lin(int i, int j) {
  return (size_t)i * (i + 1) / 2 + j;
}

// The one-block path's shared memory: every tile, the current diagonal
// tile's transpose, the diagonal tiles' reciprocal diagonals, chol_tile's
// columns.
long long one_block_smem(int tiles, int itemsize) {
  return ((long long)(lin(tiles, tiles) + 1) * kTileSmem + (long long)(tiles + 4) * kTile) *
         itemsize;
}

template <typename T>
struct SpdArgs {
  const T* a;        // (n, n) row-major, lower triangle read
  const T* b;        // (n, m) row-major
  T* x;              // (n, m) output
  T* w;              // workspace of the many-block path (ops/spd.py, plan)
  unsigned* flags;   // its flags
  int n;
  int m;
  int tiles;         // P = ceil(n / 32)
};

template <typename T>
__device__ __forceinline__ void read_vec(T (&v)[kVec<T>], const T* p) {
  const Vec16<T> q = *reinterpret_cast<const Vec16<T>*>(p);
  if constexpr (kVec<T> == 4) {
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = q.x;
    v[1] = q.y;
  }
}

template <typename T>
__device__ __forceinline__ void read_row(T (&v)[kTile], const T* row) {
#pragma unroll
  for (int u = 0; u < kTile / kVec<T>; ++u) {
    T q[kVec<T>];
    read_vec(q, row + u * kVec<T>);
#pragma unroll
    for (int e = 0; e < kVec<T>; ++e) v[u * kVec<T> + e] = q[e];
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

// Tile (i, j) of a into the shared tile s: the lower triangle (zero above the
// diagonal), an identity past n; a lane a column.
template <typename T>
__device__ __forceinline__ void load_input(T* s, const T* a, int n, int i, int j, int lane) {
  const int col = j * kTile + lane;
#pragma unroll 8
  for (int r = 0; r < kTile; ++r) {
    const int row = i * kTile + r;
    T v = T(0);
    if (row < n && col < n) {
      if (col <= row) v = __ldg(a + (size_t)row * n + col);
    } else if (row == col) {
      v = T(1);
    }
    s[r * kStride + lane] = v;
  }
}

// Tile j of b^T (rows t < m) into the shared tile s, zero elsewhere.
template <typename T>
__device__ __forceinline__ void load_rhs(T* s, const T* b, int n, int m, int j, int lane) {
  const int col = j * kTile + lane;
#pragma unroll 8
  for (int t = 0; t < kTile; ++t) {
    s[t * kStride + lane] = t < m && col < n ? __ldg(b + (size_t)col * m + t) : T(0);
  }
}

// Start copying `rows` rows of a workspace tile (row stride 32) into the
// shared tile dst by 16-byte cp.async copies, consecutive lanes on
// consecutive chunks; through L2 only (.cg), since other blocks write the
// workspace in this launch. copy_commit closes a group, copy_wait<N> waits
// until at most N groups are in flight and makes the copies visible to the
// warp.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int rows, int lane) {
  constexpr int per_row = kTile / kVec<T>;
  for (int id = lane; id < rows * per_row; id += 32) {
    const int r = id / per_row, c = (id % per_row) * kVec<T>;
    const unsigned to = (unsigned)__cvta_generic_to_shared(dst + r * kStride + c);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(to), "l"(src + r * kTile + c)
                 : "memory");
  }
}

template <typename T>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, int lane) {
  copy_rows(dst, src, kTile, lane);
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
  __syncwarp();
}

// `rows` rows of the shared tile src into the workspace tile dst.
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, const T* src, int rows, int lane) {
  constexpr int per_row = kTile / kVec<T>;
  for (int id = lane; id < rows * per_row; id += 32) {
    const int r = id / per_row, c = (id % per_row) * kVec<T>;
    *reinterpret_cast<Vec16<T>*>(dst + r * kTile + c) =
        *reinterpret_cast<const Vec16<T>*>(src + r * kStride + c);
  }
}

// The flags of the many-block path: set once a tile's stores are done (a
// release at the card's scope), waited for by one lane (an acquire); the
// warp's other lanes read after the __syncwarp() that follows.
__device__ __forceinline__ void set_flag(unsigned* f, int lane) {
  __syncwarp();
  if (lane == 0) asm volatile("st.release.gpu.global.u32 [%0], 1;" ::"l"(f) : "memory");
}

__device__ __forceinline__ void spin(const unsigned* f) {
  unsigned v;
  do {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(f) : "memory");
  } while (v == 0u);
}

// Lane 0 waits for f0 and lane 1 for f1 (when given), side by side.
__device__ __forceinline__ void wait_flags(const unsigned* f0, const unsigned* f1, int lane) {
  if (lane == 0) spin(f0);
  if (lane == 1 && f1 != nullptr) spin(f1);
  __syncwarp();
}

// One 16 x 8 x 4 product on the tensor cores in float64 (sm_90): d += a b,
// a lane holding a[g][t], a[g + 8][t], b[t][g] and d[g][2t], d[g][2t + 1],
// d[g + 8][2t], d[g + 8][2t + 1] (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void dmma(double (&d)[4], double a0, double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// Panel k's update of a tile: acc -= li lj^T (all three shared tiles; li may
// be lj). Float32: a lane holds 8 x 4 values of acc (32 independent sums),
// reading 4 columns of 8 rows of li and of 4 rows of lj a step; each value's
// sum runs over the panel's columns in order.
// Float64: DMMA, a lane holding four values of each of the 8 16 x 8 blocks.
template <typename T>
__device__ __forceinline__ void tile_update(T* acc, const T* li, const T* lj, int lane) {
  if constexpr (sizeof(T) == 4) {
    // the lane's rows 2 (lane / 8) + s + 8 i and columns lane % 8 + 8 j: a
    // warp's scalar reads of acc and its vector reads of lj's rows meet no
    // bank conflict, lanes 8 apart read li's rows by broadcast
    const int rb = 2 * (lane / 8), cb = lane % 8;
    T v[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) v[r][c] = acc[(rb + r % 2 + 8 * (r / 2)) * kStride + cb + 8 * c];
    }
#pragma unroll 1
    for (int p = 0; p < kTile; p += 4) {  // rolled: a small body, the code stays in cache
      T fa[8][4], fb[4][4];
#pragma unroll
      for (int r = 0; r < 8; ++r) read_vec(fa[r], li + (rb + r % 2 + 8 * (r / 2)) * kStride + p);
#pragma unroll
      for (int c = 0; c < 4; ++c) read_vec(fb[c], lj + (cb + 8 * c) * kStride + p);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) v[r][c] = fma(-fa[r][e], fb[c][e], v[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[(rb + r % 2 + 8 * (r / 2)) * kStride + cb + 8 * c] = v[r][c];
    }
  } else {
    // 2 x 4 blocks of 16 x 8, the panel's columns in 8 steps of 4
    const int g = lane / 4, t4 = lane % 4;
    double d[2][4][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const double2 q = *reinterpret_cast<const double2*>(
              acc + (16 * r + 8 * h + g) * kStride + 8 * c + 2 * t4);
          d[r][c][2 * h] = q.x;
          d[r][c][2 * h + 1] = q.y;
        }
      }
    }
#pragma unroll 1
    for (int p = 0; p < kTile; p += 4) {
      double fa[2][2], fb[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        fa[r][0] = -li[(16 * r + g) * kStride + p + t4];
        fa[r][1] = -li[(16 * r + 8 + g) * kStride + p + t4];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) fb[c] = lj[(8 * c + g) * kStride + p + t4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) dmma(d[r][c], fa[r][0], fa[r][1], fb[c]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          *reinterpret_cast<double2*>(acc + (16 * r + 8 * h + g) * kStride + 8 * c + 2 * t4) =
              make_double2(d[r][c][2 * h], d[r][c][2 * h + 1]);
        }
      }
    }
  }
}

// Cholesky of the shared tile s in place (its lower triangle; zero above the
// diagonal on return), its transpose L^T into the shared tile sT and the
// reciprocals of its diagonal into rinv. A lane holds its row. Two columns a
// step: every lane takes the 2 x 2 diagonal block by shuffles and factors
// it, its own two values of L follow, and they reach the other lanes by
// shuffles (float32) or through col (float64: 4 x 32 values of shared
// memory, two steps' columns in turn, so one __syncwarp() a step, read by
// broadcast vectors). The same operations in the same order as one column at
// a time. A pivot not positive or not finite makes its column, and so every
// later value, NaN.
template <typename T>
__device__ __forceinline__ void chol_tile(T* s, T* sT, T* rinv, T* col, int lane) {
  T d[kTile];
  read_row(d, s + lane * kStride);
  T diag = s[lane * kStride + lane];
  T inv = T(0);
#pragma unroll
  for (int j = 0; j < kTile; j += 2) {
    const T a = __shfl_sync(kFull, diag, j);
    const T b = __shfl_sync(kFull, d[j], j + 1);
    const T rs0 = a > T(0) && a < T(INFINITY) ? rsqrt(a) : T(NAN);
    const T l10 = b * rs0;
    const T c = fma(-l10, l10, __shfl_sync(kFull, diag, j + 1));
    const T rs1 = c > T(0) && c < T(INFINITY) ? rsqrt(c) : T(NAN);
    const T l0 = lane > j ? d[j] * rs0 : (lane == j ? a * rs0 : T(0));
    T l1 = T(0);
    if (lane > j + 1) {
      l1 = fma(-l0, l10, d[j + 1]) * rs1;
    } else if (lane == j + 1) {
      l1 = c * rs1;
    }
    if (lane == j) inv = rs0;
    if (lane == j + 1) inv = rs1;
    if (lane > j + 1) diag = fma(-l1, l1, fma(-l0, l0, diag));
    d[j] = l0;
    d[j + 1] = l1;
    if constexpr (sizeof(T) == 4) {
      // float32: the column by shuffles (through shared memory ptxas hoists
      // the reads past 255 registers and spills)
#pragma unroll
      for (int q = j + 2; q < kTile; ++q) {
        d[q] = fma(-l1, __shfl_sync(kFull, l1, q), fma(-l0, __shfl_sync(kFull, l0, q), d[q]));
      }
      continue;
    }
    T* cj = col + (j / 2) % 2 * 2 * kTile;
    cj[lane] = l0;
    cj[kTile + lane] = l1;
    __syncwarp();
#pragma unroll
    for (int u = (j + 2) / kVec<T>; u < kTile / kVec<T>; ++u) {
      T q0[kVec<T>], q1[kVec<T>];
      read_vec(q0, cj + u * kVec<T>);
      read_vec(q1, cj + kTile + u * kVec<T>);
#pragma unroll
      for (int e = 0; e < kVec<T>; ++e) {
        const int q = u * kVec<T> + e;
        if (q > j + 1) d[q] = fma(-l1, q1[e], fma(-l0, q0[e], d[q]));
      }
    }
  }
  write_row(d, s + lane * kStride);
#pragma unroll
  for (int c = 0; c < kTile; ++c) sT[c * kStride + lane] = d[c];
  rinv[lane] = inv;
}

// The shared tile s := s L_kk^-T (its rows solved against the factored
// diagonal tile, given as its transpose lkkT, rinv its reciprocal diagonal):
// a lane solves its row, y_c = s_c / L[c][c], then s_q -= L[q][c] y_c for
// q > c, reading row c of L^T by broadcast; each s_q takes its terms in
// order of c.
template <typename T>
__device__ __forceinline__ void trsm_tile(T* s, const T* lkkT, const T* rinv, int lane) {
  T y[kTile];
  read_row(y, s + lane * kStride);
#pragma unroll
  for (int c = 0; c < kTile; ++c) {
    const T yc = y[c] * rinv[c];
    y[c] = yc;
#pragma unroll
    for (int u = (c + 1) / kVec<T>; u < kTile / kVec<T>; ++u) {
      T q[kVec<T>];
      read_vec(q, lkkT + c * kStride + u * kVec<T>);
#pragma unroll
      for (int e = 0; e < kVec<T>; ++e) {
        if (u * kVec<T> + e > c) y[u * kVec<T> + e] = fma(-q[e], yc, y[u * kVec<T> + e]);
      }
    }
  }
  write_row(y, s + lane * kStride);
}

// L_kk^T x = r for the m rows of the shared tile r (row t = right-hand side
// t), in place: lane t solves its row from the last value back, x_c = r_c /
// L[c][c], then r_q -= L[c][q] x_c for q < c, reading row c of L by
// broadcast.
template <typename T>
__device__ __forceinline__ void trsv_rows(T* r, const T* lkk, const T* rinv, int m, int lane) {
  if (lane < m) {
    T v[kTile];
    read_row(v, r + lane * kStride);
#pragma unroll
    for (int c = kTile - 1; c >= 0; --c) {
      const T xc = v[c] * rinv[c];
      v[c] = xc;
#pragma unroll
      for (int u = 0; u * kVec<T> < c; ++u) {
        T q[kVec<T>];
        read_vec(q, lkk + c * kStride + u * kVec<T>);
#pragma unroll
        for (int e = 0; e < kVec<T>; ++e) {
          if (u * kVec<T> + e < c) v[u * kVec<T> + e] = fma(-q[e], xc, v[u * kVec<T> + e]);
        }
      }
    }
    write_row(v, r + lane * kStride);
  }
  __syncwarp();
}

// Column `lane` of the shared tile s, and its product with row t of x:
// sum_r L[r][lane] x[t][r], in order of r (one value of L^T x).
template <typename T>
__device__ __forceinline__ void read_col(T (&lc)[kTile], const T* s, int lane) {
#pragma unroll
  for (int r = 0; r < kTile; ++r) lc[r] = s[r * kStride + lane];
}

template <typename T>
__device__ __forceinline__ T dot_row(const T (&lc)[kTile], const T* xrow) {
  T s = T(0);
#pragma unroll
  for (int u = 0; u < kTile / kVec<T>; ++u) {
    T q[kVec<T>];
    read_vec(q, xrow + u * kVec<T>);
#pragma unroll
    for (int e = 0; e < kVec<T>; ++e) s = fma(lc[u * kVec<T> + e], q[e], s);
  }
  return s;
}

// ---- one block: the whole system in shared memory

template <typename T>
__device__ __forceinline__ void one_block_backsub(T* tiles, const T* rinv, int P, int m,
                                                  int warp, int lane) {
  // L^T x = y from the last panel: warp 0 solves y_k's rows in place (x_k),
  // then the warps take y_j -= L_kj^T x_k for j < k, each y_j in the order
  // k = P-1, P-2, ...
  T* yrow = tiles + lin(P, 0) * kTileSmem;
  for (int k = P - 1; k >= 0; --k) {
    if (warp == 0) trsv_rows(yrow + k * kTileSmem, tiles + lin(k, k) * kTileSmem,
                             rinv + k * kTile, m, lane);
    __syncthreads();
    for (int j = warp; j < k; j += kOneBlockWarps) {
      T lc[kTile];
      read_col(lc, tiles + lin(k, j) * kTileSmem, lane);
      for (int t = 0; t < m; ++t) {
        yrow[j * kTileSmem + t * kStride + lane] -=
            dot_row(lc, yrow + k * kTileSmem + t * kStride);
      }
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kOneBlockWarps * 32, 1) spd_one_block(SpdArgs<T> A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int P = A.tiles, n = A.n, m = A.m;
  const int ntiles = (int)lin(P, P);
  T* tiles = reinterpret_cast<T*>(smem_raw);
  T* diag_t = tiles + (size_t)ntiles * kTileSmem;  // the current L_kk^T
  T* rinv = diag_t + kTileSmem;                    // P x 32
  T* col = rinv + P * kTile;                       // chol_tile's columns
  auto tile = [&](int i, int j) { return tiles + lin(i, j) * kTileSmem; };

  for (int u = warp; u < ntiles; u += kOneBlockWarps) {
    int i = 0, j = u;
    while (i < P && j > i) {
      j -= i + 1;
      ++i;
    }
    if (i == P) {
      load_rhs(tiles + (size_t)u * kTileSmem, A.b, n, m, j, lane);
    } else {
      load_input(tiles + (size_t)u * kTileSmem, A.a, n, i, j, lane);
    }
  }
  __syncthreads();
  for (int k = -1; k < P; ++k) {
    // column k below the diagonal, the right-hand sides' tile included
    if (k >= 0) {
      for (int i = k + 1 + warp; i <= P; i += kOneBlockWarps) {
        trsm_tile(tile(i, k), diag_t, rinv + k * kTile, lane);
      }
      __syncthreads();
    }
    // panel k's updates: warp 0 takes the next diagonal tile and factors it,
    // the other warps the tiles (i, j), k < j <= i <= P, in turn
    if (warp == 0) {
      if (k + 1 < P) {
        if (k >= 0) tile_update(tile(k + 1, k + 1), tile(k + 1, k), tile(k + 1, k), lane);
        __syncwarp();
        chol_tile(tile(k + 1, k + 1), diag_t, rinv + (k + 1) * kTile, col, lane);
      }
    } else if (k >= 0) {
      int idx = 0;
      for (int j = k + 1; j < P; ++j) {
        for (int i = j; i <= P; ++i, ++idx) {
          if (idx > 0 && (idx - 1) % (kOneBlockWarps - 1) == warp - 1) {
            tile_update(tile(i, j), tile(i, k), tile(j, k), lane);
          }
        }
      }
    }
    __syncthreads();
  }
  one_block_backsub(tiles, rinv, P, m, warp, lane);
  const T* yrow = tile(P, 0);
  for (int e = threadIdx.x; e < n * m; e += blockDim.x) {
    const int row = e / m, t = e % m;
    A.x[e] = yrow[(row / kTile) * kTileSmem + t * kStride + row % kTile];
  }
}

// ---- many blocks: a tile dataflow

template <typename T>
struct Dataflow {
  const T* a;
  const T* b;
  T* x;
  T* L;            // published tiles, lin(i, j) * 1024 (row stride 32); L_dd as L_dd^T
  T* D;            // L_dd, P x 1024
  T* rinv;         // the diagonal tiles' reciprocal diagonals, P x 32
  T* X;            // x_k^T, P x (m, 32)
  T* C;            // L_ik^T x_i, lin(i, k) x (m, 32)
  unsigned* fL;    // a flag a published tile of L (and of y^T)
  unsigned* fX;    // a flag an x_k
  unsigned* fC;    // a flag an L_ik^T x_i
  int n, m, P;
  // the warp's shared memory: its tiles, two staged tiles, 32 reciprocals,
  // chol_tile's columns
  T *own0, *own1, *st0, *st1, *rv, *col;
  __device__ T* tile(int i, int j) const { return L + lin(i, j) * kTileWork; }
};

// Work item t of the factorisation, column by column: the diagonal tile j
// (with (j, j - 1)), the tiles (i, j) for i = j + 2, ..., P - 1, then b^T's
// tile j (i = P).
__device__ __forceinline__ void item_tile(int t, int P, int& i, int& j) {
  j = 0;
  for (;;) {
    const int count = j <= P - 2 ? P - j : 2;
    if (t < count) {
      i = t == 0 ? j : (t == count - 1 ? P : j + 1 + t);
      return;
    }
    t -= count;
    ++j;
  }
}

// Item (i, j) of the factorisation. Below the diagonal (i >= j + 2, or i =
// P for b^T's tile j): the tile takes panel k's update for k < j, is solved
// against L_jj and published. On the diagonal (i = j = d): the owner carries
// (d, d - 1) so, and (d, d) beside it, which takes each panel's update too,
// then (the look-ahead) the update by the just-solved L_{d,d-1}, then is
// factored and published: L_dd^T as the tile (the triangular solves read its
// rows), L_dd apart (the back substitution's).
template <typename T>
__device__ __forceinline__ void factor_item(const Dataflow<T>& f, int i, int j, int lane) {
  const bool diag = i == j;
  const int ai = i, aj = diag ? j - 1 : j;  // the tile solved, when aj >= 0
  if (aj >= 0) {
    if (ai == f.P) {
      load_rhs(f.own0, f.b, f.n, f.m, aj, lane);
    } else {
      load_input(f.own0, f.a, f.n, ai, aj, lane);
    }
  }
  if (diag) load_input(f.own1, f.a, f.n, i, i, lane);
  __syncwarp();
  for (int k = 0; k < aj; ++k) {
    wait_flags(f.fL + lin(ai, k), f.fL + lin(aj, k), lane);
    copy_tile(f.st0, f.tile(ai, k), lane);
    copy_tile(f.st1, f.tile(aj, k), lane);
    copy_commit();
    copy_wait<0>();
#pragma unroll 1
    for (int u = 0; u <= (int)diag; ++u) {
      tile_update(u ? f.own1 : f.own0, f.st0, u ? f.st0 : f.st1, lane);
    }
    __syncwarp();  // the staged tiles are read
  }
  if (aj >= 0) {
    wait_flags(f.fL + lin(aj, aj), nullptr, lane);
    copy_tile(f.st1, f.tile(aj, aj), lane);
    copy_commit();
    f.rv[lane] = __ldcg(f.rinv + aj * kTile + lane);
    copy_wait<0>();
    trsm_tile(f.own0, f.st1, f.rv, lane);
    __syncwarp();
    store_rows(f.tile(ai, aj), f.own0, kTile, lane);
    if (diag) tile_update(f.own1, f.own0, f.own0, lane);  // its stores drain meanwhile
    set_flag(f.fL + lin(ai, aj), lane);
  }
  if (diag) {
    chol_tile(f.own1, f.own0, f.rv, f.col, lane);  // L_dd into own1, L_dd^T into own0
    __syncwarp();
    f.rinv[i * kTile + lane] = f.rv[lane];
    store_rows(f.tile(i, i), f.own0, kTile, lane);
    set_flag(f.fL + lin(i, i), lane);
    store_rows(f.D + (size_t)i * kTileWork, f.own1, kTile, lane);
    __syncwarp();  // own1 is read before the warp's next item loads it
  }
}

// The back substitution's part of item (i, k): below the diagonal (i >= k +
// 3), L_ik^T x_i once x_i is out; on the diagonal (i = k), x_k: y_k less
// L_ik^T x_i for i = P-1, ..., k+3 as they come, then less L_{k+2,k}^T x_{k+2}
// and L_{k+1,k}^T x_{k+1} (taken here, so that the others' sums have two
// panels of slack), then solved with L_kk^T.
template <typename T>
__device__ void back_substitute(const Dataflow<T>& f, int i, int k, int lane) {
  const int m = f.m, P = f.P;
  T lc[kTile];
  if (i != k) {
    if (i == k + 2) return;
    wait_flags(f.fX + i, nullptr, lane);
    copy_rows(f.st0, f.X + (size_t)i * kTile * m, m, lane);
    copy_tile(f.st1, f.tile(i, k), lane);
    copy_commit();
    copy_wait<0>();
    read_col(lc, f.st1, lane);
    T* out = f.C + lin(i, k) * kTile * m;
    for (int t = 0; t < m; ++t) out[t * kTile + lane] = dot_row(lc, f.st0 + t * kStride);
    set_flag(f.fC + lin(i, k), lane);
    return;
  }
  wait_flags(f.fL + lin(P, k), nullptr, lane);
  copy_rows(f.own0, f.tile(P, k), m, lane);
  copy_tile(f.own1, f.D + (size_t)k * kTileWork, lane);
  copy_commit();
  f.rv[lane] = __ldcg(f.rinv + k * kTile + lane);
  copy_wait<0>();
  for (int i2 = P - 1; i2 > k + 2; --i2) {
    wait_flags(f.fC + lin(i2, k), nullptr, lane);
    const T* part = f.C + lin(i2, k) * kTile * m;
    for (int t = 0; t < m; ++t) f.own0[t * kStride + lane] -= __ldcg(part + t * kTile + lane);
  }
  for (int i2 = k + 2 < P ? k + 2 : P - 1; i2 > k; --i2) {
    wait_flags(f.fL + lin(i2, k), nullptr, lane);
    copy_tile(f.st1, f.tile(i2, k), lane);  // in flight while x_i2 is awaited
    copy_commit();
    wait_flags(f.fX + i2, nullptr, lane);
    copy_rows(f.st0, f.X + (size_t)i2 * kTile * m, m, lane);
    copy_commit();
    copy_wait<0>();
    read_col(lc, f.st1, lane);
    for (int t = 0; t < m; ++t) f.own0[t * kStride + lane] -= dot_row(lc, f.st0 + t * kStride);
    __syncwarp();  // the staged tiles are read
  }
  trsv_rows(f.own0, f.own1, f.rv, m, lane);
  store_rows(f.X + (size_t)k * kTile * m, f.own0, m, lane);
  set_flag(f.fX + k, lane);
  const int row = k * kTile + lane;  // x itself after the flag: no one waits for it
  if (row < f.n) {
    for (int t = 0; t < m; ++t) f.x[(size_t)row * m + t] = f.own0[t * kStride + lane];
  }
  __syncwarp();  // own0 is read before the warp's next item loads it
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32, 1) spd_tiles(SpdArgs<T> A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, warps = blockDim.x / 32;
  const int P = A.tiles, m = A.m;
  const size_t lower = lin(P, 0);  // tiles of the lower triangle; b^T's row follows
  Dataflow<T> f;
  f.a = A.a;
  f.b = A.b;
  f.x = A.x;
  f.L = A.w;
  f.D = f.L + (lower + P) * kTileWork;
  f.rinv = f.D + (size_t)P * kTileWork;
  f.X = f.rinv + (size_t)P * kTile;
  f.C = f.X + (size_t)P * kTile * m;
  f.fL = A.flags;
  f.fX = f.fL + lower + P;
  f.fC = f.fX + P;
  f.n = A.n;
  f.m = m;
  f.P = P;
  f.own0 = reinterpret_cast<T*>(smem_raw) + (size_t)warp * kWarpSmem;
  f.own1 = f.own0 + kTileSmem;
  f.st0 = f.own1 + kTileSmem;
  f.st1 = f.st0 + kTileSmem;
  f.rv = f.st1 + kTileSmem;
  f.col = f.rv + kTile;

  // every flag to 0 (the launch's one grid-wide sync)
  const size_t nflags = 2 * lower + 2 * (size_t)P;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < nflags;
       e += (size_t)gridDim.x * blockDim.x) {
    f.fL[e] = 0u;
  }
  cg::this_grid().sync();

  // item t to warp t mod G, the first items each on a block of its own
  const int items = (int)lower + 1, G = gridDim.x * warps, g = warp * gridDim.x + blockIdx.x;
  if (g >= items) return;
  for (int t = g; t < items; t += G) {
    int i, j;
    item_tile(t, P, i, j);
    factor_item(f, i, j, lane);
  }
  for (int t = g + (items - 1 - g) / G * G; t >= 0; t -= G) {
    int i, j;
    item_tile(t, P, i, j);
    if (i < P) back_substitute(f, i, j, lane);
  }
}

struct Cached {
  int smem = -1;
  int threads = 0;
  int blocks = 0;
};

template <typename T>
int launch(const SpdArgs<T>& args, bool one_block, int grid, int warps, int smem_bytes,
           cudaStream_t stream) {
  // the card's limits and the kernel's occupancy, once per device, path and
  // launch shape (the queries cost more host time than the launch); the
  // caller makes the tensors' card current
  constexpr int kCachedDevices = 64;
  static thread_local Cached cached[kCachedDevices][2];
  const void* fn = one_block ? (const void*)spd_one_block<T> : (const void*)spd_tiles<T>;
  const int threads = 32 * warps;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  Cached* c = dev < kCachedDevices ? &cached[dev][one_block ? 1 : 0] : nullptr;
  const bool hit = c != nullptr && c->smem == smem_bytes && c->threads == threads;
  int blocks = hit ? c->blocks : 0;
  if (!hit) {
    int coop = 0, sms = 0, optin = 0, per_sm = 0;
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (smem_bytes > optin) return (int)cudaErrorInvalidConfiguration;
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    blocks = one_block ? per_sm : (coop ? per_sm * sms : 0);
    if (c != nullptr) {
      c->smem = smem_bytes;
      c->threads = threads;
      c->blocks = blocks;
    }
  }
  if (grid > blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {const_cast<SpdArgs<T>*>(&args)};
  e = one_block ? cudaLaunchKernel(fn, dim3(1), dim3(threads), params, (size_t)smem_bytes, stream)
                : cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(threads), params,
                                              (size_t)smem_bytes, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// a (n, n), b (n, m), x (n, m) -- float32 (itemsize 4) or float64 (8),
// device, contiguous. The launch (one_block, grid, warps, tiles, smem_bytes)
// is ops/spd.py's plan, checked here: one block of 8 warps holding every tile
// of [a b; b^T .] in shared memory, or the tile dataflow on `grid` blocks of
// `warps` warps (cooperative). work and sync: the dataflow's workspace and
// flags (plan.workspace values of the type, plan.flags int32), unused by one
// block. Returns a cudaError_t code (0 on success).
extern "C" int wc_spd_solve(const void* a, const void* b, void* x, void* work, int* sync, int n,
                            int m, int itemsize, int one_block, int grid, int warps, int tiles,
                            int smem_bytes, void* stream) {
  if (n < 1 || n > kMaxN || m < 1 || m > kMaxRhs || (itemsize != 4 && itemsize != 8) ||
      tiles != (n + kTile - 1) / kTile || (long long)n * m > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const long long need = one_block ? one_block_smem(tiles, itemsize)
                                   : (long long)warps * kWarpSmem * itemsize;
  const bool shape_ok = one_block ? grid == 1 && warps == kOneBlockWarps
                                  : grid >= 1 && warps >= 1 && warps <= kMaxWarps;
  if (!shape_ok || smem_bytes < need) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* flags = reinterpret_cast<unsigned*>(sync);
  if (itemsize == 4) {
    const SpdArgs<float> args{static_cast<const float*>(a), static_cast<const float*>(b),
                              static_cast<float*>(x), static_cast<float*>(work), flags, n, m, tiles};
    return launch<float>(args, one_block != 0, grid, warps, smem_bytes, st);
  }
  const SpdArgs<double> args{static_cast<const double*>(a), static_cast<const double*>(b),
                             static_cast<double*>(x), static_cast<double*>(work), flags, n, m, tiles};
  return launch<double>(args, one_block != 0, grid, warps, smem_bytes, st);
}
