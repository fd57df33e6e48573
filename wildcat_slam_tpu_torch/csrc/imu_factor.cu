// The IMU factors' residuals, Jacobians and banded normal equations (kernel
// K5), in one launch.
//
// Replaces: no Pallas kernel. It is the counterpart of
// wildcat_slam_tpu/odometry/factors.py:468 (imu_residuals) followed by
// wildcat_slam_tpu/odometry/solver.py:78 (_imu_banded_normal_eqs), which XLA
// fuses into a few fusions inside the jitted sweep; the port ran them as one
// PyTorch kernel per operation (~0.65 ms a call, odometry/factors.py
// imu_residuals_plain and odometry/solver.py imu_banded_normal_eqs_plain, the
// plain version). Each factor i (Mi of them) ties three IMU times, each
// interpolated between two sample states, to a 12-vector residual r_i and
// six 12 x 12 Jacobian blocks (the three distinct ones jt1, jt2, jt3 times
// the lerp weights); all six fall in the 3-block band that starts at
// base_i = min(idx_i), so the factor's band B_i (12 x 36) gives
// hb_i = B_i^T B_i (36 x 36) and gb_i = B_i^T r_i, which sum per base into
// hseg[s] and gseg[s] and read off as five block bands of H (delta -2..2)
// and g.
//
// Residual mode: one thread a factor writes r (Mi, 12), where(valid, r, 0).
// Normal mode: one cooperative launch in three phases, two grid barriers.
// Phase 0, a block a segment of kSeg factors: a thread a factor evaluates
// its residual and the 3 x 3 pieces of its Jacobians, then the block forms
// the segment's bands B (12 x 36) in shared memory (a thread an entry of
// the three 12 x 12 jt blocks, by selects: no branch a block, which the
// lanes of a warp would take apart). A factor whose band is
// all zero and whose residual is finite (an invalid factor: its Jacobian is
// multiplied by 0, and the kernel checks that no term of it is infinite or
// NaN) adds exact zeros to every chain and is left out; the others' bands and
// residuals go to a workspace, and the segment lists them by base, stably
// (its piece), with each base's exclusive offset in it. Phase 1, a block a
// base s: the base's factors, in increasing index, are the runs of base s in
// the segments' pieces, segment after segment (an exclusive scan of the
// segments' counts); their bands are staged kBatch at a time (16-byte
// asynchronous copies, all in flight at once) and each of hseg[s]'s 666
// distinct entries (a <= b of the symmetric 36 x 36) and gseg[s]'s 36 is a
// chain over them, a thread a 3 x 3 tile of them (each B[k][a] loaded once
// for three chains): hb's entry is sum_k fma(B[k][a], B[k][b]) over the 12
// rows k, then added to the chain.
// Each chain is computed once, into a workspace. Phase 2, over the grid:
//   band -2 = hseg[r-2](2,0),  band -1 = hseg[r-1](1,0) + hseg[r-2](2,1),
//   band  0 = (hseg[r](0,0) + hseg[r-1](1,1)) + hseg[r-2](2,2),
//   band +1 = hseg[r](0,1) + hseg[r-1](1,2),  band +2 = hseg[r](0,2),
//   g[r] = (gseg[r](0) + gseg[r-1](1)) + gseg[r-2](2),
// the order in which the plain version adds them: bands 0, +1 and +2 are
// formed, each value written at (r, i, j) and, transposed, where band -d at
// r + d (or band 0's (j, i)) reads the same entries of the symmetric hseg;
// so H stays exactly symmetric (K1 reads H's rows as its columns). No
// atomics: every place comes from counts and exclusive scans. Every chain
// is the one of the kernel's first design (a block a block row over the
// factors of bases r-2..r), in the same order, so the bits are too.
//
// What bounds it on an H100: operations, ~0.3 us at Mi = 1536, S = 96 (the
// distinct entries of B^T B and B^T r over the valid factors, ~12 M FMA) on
// ~0.2 MB of factors. What it takes is latency: a factor's evaluation is a
// long dependent chain (sin, cos, atan, sqrt), and a base's chains run over
// its factors one after another. So each factor is evaluated once, every
// factor's chain starts at once over the grid, each base's sums are formed
// once by one block (the bases' blocks run side by side) over its valid
// factors only (on the main path ~256 invalid factors share base 0), and
// the bands are read off in one pass.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lie.cuh"

namespace {

namespace cg = cooperative_groups;

using wc::rfma;

constexpr int kThreads = 256;       // a normal-mode block (ops/imu_factor.py THREADS)
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 16;            // factors a segment (ops/imu_factor.py SEGMENT)
constexpr int kBatch = 16;          // bands staged together (ops/imu_factor.py BATCH)
constexpr int kTile = kThreads;     // segments gathered together
constexpr int kResThreads = 128;    // a residual-mode block
constexpr int kPieces = 48;         // a factor's pieces: r 12, four 3 x 3 blocks, lerp weights
constexpr int kMeta = 8;            // base, rel (6), valid
constexpr int kBand = 12 * 36;
constexpr int kRec = kBand + 12;      // a factor's record: its band, then r
constexpr int kSlot = kPieces + 8;    // a factor's pieces and weights in phase 0
constexpr int kTri = 36 * 37 / 2;     // the distinct entries of a base's symmetric hseg
constexpr int kSum = kTri + 36;       // a base's chains: hseg's, then gseg's
constexpr int kTiles = 12 * 13 / 2;  // 3 x 3 tiles of hseg's upper triangle, a thread each
constexpr int kInputs = 14;
static_assert(kSeg <= 32, "a segment's factors are the bits of a mask");

template <typename T>
struct Args {
  const unsigned char* valid;          // (Mi,)
  const T *q1, *q2;                    // (Mi, 4)
  const T *a1, *g1, *g2, *p1, *p2, *p3;  // (Mi, 3)
  const long long *il, *ir;            // (Mi, 3)
  const T* f;                          // (Mi, 3)
  const T* cor;                        // (S, 12)
  const T* grav;                       // (3,)
  int mi, s_cap;
  // the weights and the products the plain version forms in double on the
  // host, each cast once: w_g, w_a, w_bg, w_ba, dt, dt dt, w_g / dt,
  // w_a / dt / dt, 2 w_a / dt / dt
  T w_g, w_a, w_bg, w_ba, dt, dt2, wg_dt, wa_dt2, wa2_dt2;
};

// piece offsets in a factor's pieces
constexpr int kR = 0, kDth1 = 12, kDth2 = 21, kDacc = 30, kRq1c = 39;
// the lerp weights (1 - f0, f0, 1 - f1, f1, 1 - f2, f2) and valid follow in
// the block's meta (as values, kW)
constexpr int kW = 0;

// Factor m's residual into p[kR..] (where(valid, r, 0)) and, with kJac, the
// 3 x 3 pieces of its Jacobians (dth/dr1, dth/dr2, dacc/dr1, R(q1c)), the
// six lerp weights and valid into w (7 values), and base and rel into meta.
template <typename T, bool kJac>
__device__ void imu_eval(const Args<T>& a, int m, T* p, T* w, int* meta) {
  T c[3][12];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    wc::lerp_rows(a.cor, a.il[3 * m + k], a.ir[3 * m + k], a.f[3 * m + k], 12, c[k]);
  const T *r1c = c[0], *r2c = c[1];
  const T *t1c = c[0] + 3, *t2c = c[1] + 3, *t3c = c[2] + 3;
  const T *bg1 = c[0] + 6, *bg2 = c[1] + 6, *ba1 = c[0] + 9, *ba2 = c[1] + 9;
  const T *q1 = a.q1 + 4 * m, *q2 = a.q2 + 4 * m;
  const T *a1 = a.a1 + 3 * m, *g1 = a.g1 + 3 * m, *g2 = a.g2 + 3 * m;
  const T *p1 = a.p1 + 3 * m, *p2 = a.p2 + 3 * m, *p3 = a.p3 + 3 * m;
  T e1[4], e2[4], q1c[4], q2c[4], q1cc[4], dq[4], theta[3], acc_body[3], acc_world[3];
  wc::exp_quat(r1c, e1);
  wc::exp_quat(r2c, e2);
  wc::quat_mul(e1, q1, q1c);
  wc::quat_mul(e2, q2, q2c);
  wc::quat_conj(q1c, q1cc);
  wc::quat_mul(q1cc, q2c, dq);
  wc::log_quat(dq, theta);
#pragma unroll
  for (int i = 0; i < 3; ++i) acc_body[i] = a1[i] - ba1[i];
  wc::quat_rotate(q1c, acc_body, acc_world);
  const bool valid = a.valid[m] != 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    // each operation rounded as the plain version rounds it: the position
    // sum is divided by dt^2, which amplifies any other rounding ~4e4 times
    const T sum = (t3c[i] + p3[i]) + (t1c[i] + p1[i]);
    const T acc_est = (sum - (T(2) * (t2c[i] + p2[i]))) / a.dt2;
    const T r0 = a.w_g * (((g1[i] + g2[i]) / T(2) - (theta[i] / a.dt)) - bg1[i]);
    const T r1 = a.w_a * ((acc_world[i] - acc_est) + a.grav[i]);
    const T r2 = a.w_bg * (bg1[i] - bg2[i]);
    const T r3 = a.w_ba * (ba1[i] - ba2[i]);
    p[kR + i] = valid ? r0 : T(0);
    p[kR + 3 + i] = valid ? r1 : T(0);
    p[kR + 6 + i] = valid ? r2 : T(0);
    p[kR + 9 + i] = valid ? r3 : T(0);
  }
  if (!kJac) return;
  T q1m[9], q2m[9], jr1[9], jr2[9], jinv[9], tmp[9], re1[9], h[9], v[3];
  wc::quat_to_matrix(q1, q1m);
  wc::quat_to_matrix(q2, q2m);
  wc::jr(r1c, jr1);
  wc::jr(r2c, jr2);
  // dth/dr1 = -(Jl^-1(theta) R(q1)^T) Jr(r1)
  wc::jl_inv(theta, jinv);
  wc::mat3_mul_t(jinv, q1m, tmp);
  wc::mat3_mul(tmp, jr1, p + kDth1);
#pragma unroll
  for (int i = 0; i < 9; ++i) p[kDth1 + i] = -p[kDth1 + i];
  // dth/dr2 = (Jr^-1(theta) R(q2)^T) Jr(r2)
  wc::jr_inv(theta, jinv);
  wc::mat3_mul_t(jinv, q2m, tmp);
  wc::mat3_mul(tmp, jr2, p + kDth2);
  // dacc/dr1 = -(R(e1) hat(q1 (a1 - ba1))) Jr(r1)
  wc::quat_to_matrix(e1, re1);
  wc::quat_rotate(q1, acc_body, v);
  wc::hat(v, h);
  wc::mat3_mul(re1, h, tmp);
  wc::mat3_mul(tmp, jr1, p + kDacc);
#pragma unroll
  for (int i = 0; i < 9; ++i) p[kDacc + i] = -p[kDacc + i];
  wc::quat_to_matrix(q1c, p + kRq1c);
  long long idx[6], base = a.il[3 * m];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    idx[2 * k] = a.il[3 * m + k];
    idx[2 * k + 1] = a.ir[3 * m + k];
    const T f = a.f[3 * m + k];
    w[kW + 2 * k] = T(1) - f;
    w[kW + 2 * k + 1] = f;
  }
  w[kW + 6] = valid ? T(1) : T(0);
#pragma unroll
  for (int k = 1; k < 6; ++k) base = idx[k] < base ? idx[k] : base;
  meta[0] = (int)base;
#pragma unroll
  for (int k = 0; k < 6; ++k) meta[1 + k] = (int)(idx[k] - base);
}

// Entry (row, col) of jt_q (q = 0, 1, 2: the IMU times), from the pieces p:
// block (row / 3, col / 3) is a constant times a 3 x 3 piece, a constant
// times the identity, or zero. Formed by selects, not a branch a block: the
// lanes of a warp form entries of different blocks.
template <typename T>
__device__ __forceinline__ T jt_entry(const Args<T>& a, const T* p, int q, int row, int col) {
  const int br = row / 3, bc = col / 3, i = row % 3, j = col % 3;
  const T eye = i == j ? T(1) : T(0);
  const int blk = 4 * br + bc;
  T c;
  int off;  // the piece's offset, -1 for the identity, -2 for a zero block
  if (q == 0) {
    c = blk == 0 ? -a.wg_dt : blk == 2 ? -a.w_g : blk == 4 ? a.w_a : blk == 5 ? -a.wa_dt2
        : blk == 7 ? -a.w_a : blk == 10 ? a.w_bg : a.w_ba;
    off = blk == 0 ? kDth1 : blk == 4 ? kDacc : blk == 7 ? kRq1c
        : blk == 2 || blk == 5 || blk == 10 || blk == 15 ? -1 : -2;
  } else if (q == 1) {  // no (gyr, bg) block: the residual uses bg(tau1) only
    c = blk == 0 ? -a.wg_dt : blk == 5 ? a.wa2_dt2 : blk == 10 ? -a.w_bg : -a.w_ba;
    off = blk == 0 ? kDth2 : blk == 5 || blk == 10 || blk == 15 ? -1 : -2;
  } else {
    c = -a.wa_dt2;
    off = blk == 5 ? -1 : -2;
  }
  const T piece = p[(off >= 0 ? off : 0) + 3 * i + j];
  return off == -2 ? T(0) : c * (off >= 0 ? piece : eye);
}

// Entries (row, 12 d + col), d = 0, 1, 2, of a factor's band: column block
// d holds the sum, in k order, of the Jacobian blocks k with rel_k = d, each
// jt_(k/2) times its lerp weight times valid
template <typename T>
__device__ __forceinline__ void band_entries(const Args<T>& a, const T* p, const T* w,
                                             const int* mt, int row, int col, T* out) {
  const T jt[3] = {jt_entry(a, p, 0, row, col), jt_entry(a, p, 1, row, col),
                   jt_entry(a, p, 2, row, col)};
  T s[3] = {T(0), T(0), T(0)};
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const T x = (jt[k >> 1] * w[kW + k]) * w[kW + 6];
    const int d = mt[1 + k];
#pragma unroll
    for (int dd = 0; dd < 3; ++dd)
      if (d == dd) s[dd] = s[dd] + x;
  }
#pragma unroll
  for (int dd = 0; dd < 3; ++dd) out[36 * row + 12 * dd + col] = s[dd];
}

template <typename T>
__global__ void __launch_bounds__(kResThreads)
    imu_factor_residuals(Args<T> a, T* __restrict__ r_out) {
  const int m = blockIdx.x * kResThreads + threadIdx.x;
  if (m >= a.mi) return;
  T p[12];
  imu_eval<T, false>(a, m, p, nullptr, nullptr);
#pragma unroll
  for (int c = 0; c < 12; ++c) r_out[12 * m + c] = p[c];
}

// The workspaces: values (the kept factors' records, then the bases' chains)
// and int32 (each segment's offsets by base, then its piece), in this order
// (ops/imu_factor.py plan)
struct Sizes {
  int nseg;
  long long values, ints;
};

Sizes sizes(int mi, int s_cap) {
  Sizes z;
  z.nseg = (mi + kSeg - 1) / kSeg;
  z.values = (long long)mi * kRec + (long long)s_cap * kSum;
  z.ints = (long long)z.nseg * (s_cap + 1 + kSeg);
  return z;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    imu_factor_normal(Args<T> a, T* __restrict__ bands, T* __restrict__ g_out,
                      T* __restrict__ work, T* __restrict__ hseg, int* __restrict__ ebase,
                      int* __restrict__ piece, int nseg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, s_cap = a.s_cap;

  // phase 0: a block a segment: a thread a factor evaluates it, the block
  // forms its band; the kept factors' records, listed by base
  {
    T* rec = reinterpret_cast<T*>(smem_raw);  // kSeg x kRec: the segment's bands and residuals
    T* pc = rec + kSeg * kRec;                // kSeg x kSlot: pieces and weights
    int* meta = reinterpret_cast<int*>(pc + kSeg * kSlot);  // kSeg x kMeta
    int* masks = meta + kSeg * kMeta;         // kWarps: the kept factors, a bit each
    for (int g = blockIdx.x; g < nseg; g += gridDim.x) {
      const int m0 = g * kSeg, live = min(kSeg, a.mi - m0);
      if (tid < live) imu_eval<T, true>(a, m0 + tid, pc + tid * kSlot, pc + tid * kSlot + kPieces,
                                        meta + tid * kMeta);
      __syncthreads();
      // the bands, a thread an entry of a 12 x 12 block (its three column
      // blocks); a factor is kept unless its band is all zero and its
      // residual finite
      unsigned keep = 0;
      for (int e = tid; e < live * 144; e += kThreads) {
        const int f = e / 144, row = (e % 144) / 12, col = e % 12;
        const T* p = pc + f * kSlot;
        T* out = rec + f * kRec;
        band_entries(a, p, p + kPieces, meta + f * kMeta, row, col, out);
#pragma unroll
        for (int dd = 0; dd < 3; ++dd)
          keep |= (out[36 * row + 12 * dd + col] != T(0) ? 1u : 0u) << f;
      }
      for (int e = tid; e < live * 12; e += kThreads) {
        const T v = pc[(e / 12) * kSlot + kR + e % 12];
        rec[(e / 12) * kRec + kBand + e % 12] = v;
        keep |= (isfinite(v) ? 0u : 1u) << (e / 12);
      }
#pragma unroll
      for (int d = 16; d >= 1; d >>= 1) keep |= __shfl_xor_sync(0xffffffffu, keep, d);
      if (lane == 0) masks[warp] = (int)keep;
      __syncthreads();
      keep = 0;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) keep |= (unsigned)masks[v];
      for (int e = tid; e < live * kRec; e += kThreads)
        if ((keep >> (e / kRec)) & 1u) work[(size_t)m0 * kRec + e] = rec[e];
      // the kept factors with a base in [0, S), by base, stably
      const int base = tid < live ? meta[tid * kMeta] : -1;
      const bool listed = tid < live && ((keep >> tid) & 1u) && base >= 0 && base < s_cap;
      if (listed) {
        int rank = 0;
        for (int f = 0; f < live; ++f) {
          const int b = meta[f * kMeta];
          rank += ((keep >> f) & 1u) && b >= 0 && (b < base || (b == base && f < tid)) ? 1 : 0;
        }
        piece[(size_t)g * kSeg + rank] = m0 + tid;
      }
      for (int s = tid; s <= s_cap; s += kThreads) {
        int before = 0;
        for (int f = 0; f < live; ++f) {
          const int b = meta[f * kMeta];
          before += ((keep >> f) & 1u) && b >= 0 && b < s ? 1 : 0;
        }
        ebase[(size_t)g * (s_cap + 1) + s] = before;
      }
      __syncthreads();  // the slots are rewritten by the block's next segment
    }
  }
  cg::this_grid().sync();

  // phase 1: a block a base: its factors gathered from the pieces in order,
  // their bands staged kBatch at a time, each chain of hseg and gseg once
  {
    T* band = reinterpret_cast<T*>(smem_raw);        // kBatch x kRec
    int* list = reinterpret_cast<int*>(band + kBatch * kRec);  // kTile x kSeg
    int* cnt = list + kTile * kSeg;                  // kTile
    int* scratch = cnt + kTile;                      // kWarps
    // thread t < kTiles: the 3 x 3 tile (ta, tb), ta <= tb, of hseg (rows
    // 3 ta.., columns 3 tb..); kTiles + r, r < 12: gseg's rows 3 r..3 r + 2
    int ta = -1, tb = -1;
    if (tid < kTiles) {
      int e = tid, r = 0;
      while (e >= 12 - r) e -= 12 - r++;
      ta = r, tb = r + e;
    } else if (tid < kTiles + 12) {
      ta = tid - kTiles;
    }
    for (int s = blockIdx.x; s < s_cap; s += gridDim.x) {
      T acc[9];
#pragma unroll
      for (int u = 0; u < 9; ++u) acc[u] = T(0);
      for (int t0 = 0; t0 < nseg; t0 += kTile) {
        const int g = t0 + tid;
        int off = 0, c = 0;
        if (g < nseg) {
          const int* e = ebase + (size_t)g * (s_cap + 1) + s;
          off = e[0];
          c = e[1] - off;
        }
        cnt[tid] = c;
        __syncthreads();
        const int total = wc::block_exclusive_scan<kWarps>(cnt, kTile, scratch);
        for (int k = 0; k < c; ++k) list[cnt[tid] + k] = piece[(size_t)g * kSeg + off + k];
        __syncthreads();
        for (int b0 = 0; b0 < total; b0 += kBatch) {
          const int nbat = min(kBatch, total - b0);
          constexpr int kUnits = kRec * sizeof(T) / 16;  // a record's 16-byte pieces
          static_assert(kRec * sizeof(T) % 16 == 0, "records are copied 16 bytes at a time");
          for (int v = tid; v < nbat * kUnits; v += kThreads) {
            const int j = v / kUnits, piece = 16 * (v % kUnits);
            wc::copy_async16(reinterpret_cast<char*>(band + j * kRec) + piece,
                             reinterpret_cast<const char*>(work + (size_t)list[b0 + j] * kRec) +
                                 piece);
          }
          wc::copy_async_wait();
          __syncthreads();
          // each chain over this batch's factors, in order: the factor's hb
          // entry sum_k fma(B[k][a], B[k][b]) (or gb's, sum_k fma(B[k][a], r[k]))
          if (ta >= 0)
            for (int j = 0; j < nbat; ++j) {
              const T* bj = band + j * kRec;
              T hb[9];
#pragma unroll
              for (int u = 0; u < 9; ++u) hb[u] = T(0);
              if (tb >= 0) {
#pragma unroll
                for (int k = 0; k < 12; ++k) {
                  const T* row = bj + 36 * k;
                  const T x[3] = {row[3 * ta], row[3 * ta + 1], row[3 * ta + 2]};
                  const T y[3] = {row[3 * tb], row[3 * tb + 1], row[3 * tb + 2]};
#pragma unroll
                  for (int u = 0; u < 9; ++u) hb[u] = rfma(x[u / 3], y[u % 3], hb[u]);
                }
              } else {
#pragma unroll
                for (int k = 0; k < 12; ++k) {
                  const T* row = bj + 36 * k;
#pragma unroll
                  for (int u = 0; u < 3; ++u) hb[u] = rfma(row[3 * ta + u], bj[kBand + k], hb[u]);
                }
              }
#pragma unroll
              for (int u = 0; u < 9; ++u) acc[u] = acc[u] + hb[u];
            }
          __syncthreads();  // the batch is restaged
        }
      }
      // hseg's entries (a, b), a <= b, of the tile; gseg's rows
      T* hs = hseg + (size_t)s * kSum;
      if (tb >= 0) {
#pragma unroll
        for (int u = 0; u < 9; ++u) {
          const int r = 3 * ta + u / 3, c = 3 * tb + u % 3;
          if (r <= c) hs[r * 36 - r * (r - 1) / 2 + (c - r)] = acc[u];
        }
      } else if (ta >= 0) {
#pragma unroll
        for (int u = 0; u < 3; ++u) hs[kTri + 3 * ta + u] = acc[u];
      }
    }
  }
  cg::this_grid().sync();

  // phase 2: the bands and g read off hseg and gseg (a missing base's are 0)
  {
    auto hs = [&](int s, int r, int c) -> T {
      if (s < 0) return T(0);
      const int lo = min(r, c), hi = max(r, c);
      return hseg[(size_t)s * kSum + lo * 36 - lo * (lo - 1) / 2 + (hi - lo)];
    };
    const long long items = (long long)s_cap * (3 * 144 + 12 + 2 * 144);
    for (long long it = (long long)blockIdx.x * kThreads + tid; it < items;
         it += (long long)gridDim.x * kThreads) {
      const int r = (int)(it / (3 * 144 + 12 + 2 * 144)), k = (int)(it % (3 * 144 + 12 + 2 * 144));
      if (k < 3 * 144) {
        // band +delta at r, entry (i, j)
        const int delta = k / 144, i = (k % 144) / 12, j = k % 12;
        if (delta == 0 && i > j) continue;
        T v;
        if (delta == 0)
          v = (hs(r, i, j) + hs(r - 1, 12 + i, 12 + j)) + hs(r - 2, 24 + i, 24 + j);
        else if (delta == 1)
          v = hs(r, i, 12 + j) + hs(r - 1, 12 + i, 24 + j);
        else
          v = hs(r, i, 24 + j);
        bands[((size_t)(2 + delta) * s_cap + r) * 144 + 12 * i + j] = v;
        if (delta == 0)
          bands[((size_t)2 * s_cap + r) * 144 + 12 * j + i] = v;
        else if (r + delta < s_cap)
          bands[((size_t)(2 - delta) * s_cap + r + delta) * 144 + 12 * j + i] = v;
      } else if (k < 3 * 144 + 12) {
        const int i = k - 3 * 144;
        auto gs = [&](int s, int c) -> T {
          return s < 0 ? T(0) : hseg[(size_t)s * kSum + kTri + c];
        };
        g_out[12 * r + i] = (gs(r, i) + gs(r - 1, 12 + i)) + gs(r - 2, 24 + i);
      } else {
        // band -delta at r < delta: no base below 0 (band -1 at r: hseg[r-1](1,0) +
        // hseg[r-2](2,1); band -2: hseg[r-2](2,0))
        const int e = k - (3 * 144 + 12), delta = 1 + e / 144;
        if (r < delta)
          bands[((size_t)(2 - delta) * s_cap + r) * 144 + e % 144] =
              delta == 1 ? T(0) + T(0) : T(0);
      }
    }
  }
}

// The normal-mode block's dynamic shared memory: the larger phase's
size_t normal_smem(int itemsize) {
  const size_t p0 = (size_t)itemsize * (kSeg * kRec + kSeg * kSlot) +
                    sizeof(int) * (kSeg * kMeta + kWarps);
  const size_t p1 =
      (size_t)itemsize * kBatch * kRec + sizeof(int) * (kTile * kSeg + kTile + kWarps);
  return p0 > p1 ? p0 : p1;
}

int resident_cache[2][16];  // resident blocks of the normal-mode kernel, per type and card

template <typename T>
int launch(void* const* in, void* r_out, void* bands, void* g_out, void* work, void* iwork,
           int mi, int s_cap, int normal, const double* k, cudaStream_t st) {
  Args<T> a;
  a.valid = static_cast<const unsigned char*>(in[0]);
  a.q1 = static_cast<const T*>(in[1]);
  a.q2 = static_cast<const T*>(in[2]);
  a.a1 = static_cast<const T*>(in[3]);
  a.g1 = static_cast<const T*>(in[4]);
  a.g2 = static_cast<const T*>(in[5]);
  a.p1 = static_cast<const T*>(in[6]);
  a.p2 = static_cast<const T*>(in[7]);
  a.p3 = static_cast<const T*>(in[8]);
  a.il = static_cast<const long long*>(in[9]);
  a.ir = static_cast<const long long*>(in[10]);
  a.f = static_cast<const T*>(in[11]);
  a.cor = static_cast<const T*>(in[12]);
  a.grav = static_cast<const T*>(in[13]);
  a.mi = mi, a.s_cap = s_cap;
  a.w_g = T(k[0]), a.w_a = T(k[1]), a.w_bg = T(k[2]), a.w_ba = T(k[3]);
  a.dt = T(k[4]), a.dt2 = T(k[5]), a.wg_dt = T(k[6]), a.wa_dt2 = T(k[7]), a.wa2_dt2 = T(k[8]);
  if (!normal) {
    if (mi > 0)
      imu_factor_residuals<T><<<(mi + kResThreads - 1) / kResThreads, kResThreads, 0, st>>>(
          a, static_cast<T*>(r_out));
    return (int)cudaGetLastError();
  }
  const Sizes z = sizes(mi, s_cap);
  const size_t smem = normal_smem(sizeof(T));
  int resident = 0;
  cudaError_t err = wc::resident_blocks(imu_factor_normal<T>, kThreads, smem, &resident,
                                        resident_cache[sizeof(T) == 8]);
  if (err != cudaSuccess) return (int)err;
  // phase 0 takes one block a segment, phase 1 one block a base
  const int grid = min(resident, max(z.nseg, s_cap));
  int* ints = static_cast<int*>(iwork);
  err = wc::launch_cooperative(imu_factor_normal<T>, dim3(grid), dim3(kThreads), smem, st, a,
                               static_cast<T*>(bands), static_cast<T*>(g_out),
                               static_cast<T*>(work), static_cast<T*>(work) + (size_t)mi * kRec,
                               ints, ints + (size_t)z.nseg * (s_cap + 1), z.nseg);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// in: the kInputs input pointers (valid, q1, q2, a1, g1, g2, p1, p2, p3, il,
// ir, f, cor, grav); consts: the nine values of Args' comment. Residual mode
// (normal = 0) writes r_out (Mi, 12); normal mode writes bands (5, S, 12, 12)
// and g_out (S 12), with work (values: the kept factors' bands and
// residuals, then the bases' chains) and iwork (int32: the segments'
// offsets by base and their pieces) as its workspace, of `values` and `ints`
// entries. threads, segment, batch, smem_bytes, values and ints are the
// wrapper's plan (ops/imu_factor.py), checked against the kernel's build.
extern "C" int wc_imu_factor(void* const* in, int n_in, void* r_out, void* bands, void* g_out,
                             void* work, void* iwork, int mi, int s_cap, int itemsize,
                             int normal, const double* consts, int threads, int segment,
                             int batch, int smem_bytes, long long values, long long ints,
                             void* stream) {
  if (n_in != kInputs || mi < 0 || s_cap < 1 || (itemsize != 4 && itemsize != 8) ||
      (mi > 0 && mi > (1 << 26)))
    return (int)cudaErrorInvalidValue;
  if (normal) {
    const Sizes z = sizes(mi, s_cap);
    if (threads != kThreads || segment != kSeg || batch != kBatch ||
        (size_t)smem_bytes != normal_smem(itemsize) || values != z.values || ints != z.ints)
      return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return itemsize == 4
             ? launch<float>(in, r_out, bands, g_out, work, iwork, mi, s_cap, normal, consts, st)
             : launch<double>(in, r_out, bands, g_out, work, iwork, mi, s_cap, normal, consts,
                              st);
}
