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
// Normal mode: one cooperative launch in two phases. Phase 1, a warp a
// factor: lane 0 evaluates its residual and the 3 x 3 pieces of its
// Jacobians, then the lanes form its band B (12 x 36) and write it, r and its
// base to a workspace. A grid barrier. Phase 2, a block a block row r of H:
// the block lists, in factor order, the factors whose base is r - 2, r - 1
// or r (warp ballots, no atomics), stages their bands kBatch at a time in
// shared memory and accumulates the three 12 x 36 slabs of hseg[r - di]
// that its bands read, rows di*12..di*12+11, and the matching 12 entries of
// gseg[r - di], each entry a chain over its factors in increasing index:
// hb's entry is sum_k fma(B[k][a], B[k][b]) over the 12 rows k, then added
// to the chain. Block r then writes
//   band -2 = hseg[r-2](2,0),  band -1 = hseg[r-1](1,0) + hseg[r-2](2,1),
//   band  0 = (hseg[r](0,0) + hseg[r-1](1,1)) + hseg[r-2](2,2),
//   band +1 = hseg[r](0,1) + hseg[r-1](1,2),  band +2 = hseg[r](0,2),
//   g[r] = (gseg[r](0) + gseg[r-1](1)) + gseg[r-2](2),
// the order in which the plain version adds them. Blocks r and r + 1 both
// accumulate hseg[r] (its rows 0-11 and 12-23) over the same factors in the
// same order, and fma(x, y, c) = fma(y, x, c), so band -delta at r + delta
// is the transpose of band +delta at r bit for bit, and H stays exactly
// symmetric (K1 reads H's rows as its columns).
//
// What bounds it on an H100: operations. At Mi = 1536, S = 96 a call does
// Mi (36 x 36 + 36) x 12 = 24 M FMA (~0.7 us at the f32 FMA peak) on
// ~0.2 MB of factors. Each factor is evaluated once, by a warp of the whole
// grid; its band is read by the three blocks whose bands it reaches, and a
// block's chains run in registers over bands staged in shared memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lie.cuh"

namespace {

namespace cg = cooperative_groups;

using wc::rfma;

constexpr int kThreads = 256;       // a normal-mode block (ops/imu_factor.py THREADS)
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 32;          // bands staged together (ops/imu_factor.py BATCH)
constexpr int kWindow = 2048;       // factors scanned before their members are processed
constexpr int kResThreads = 128;    // a residual-mode block
constexpr int kPieces = 48;         // a factor's pieces: r 12, four 3 x 3 blocks, lerp weights
constexpr int kMeta = 8;            // base, rel (6), valid
constexpr int kBand = 12 * 36;
constexpr int kAcc = 3 * kBand + 36;  // three hseg slabs, three gseg pieces
constexpr int kRec = kBand + 12;      // a factor's record in the workspace: its band, then r
constexpr int kSlot = kPieces + 8;    // a warp's factor in phase 1: its pieces and weights
constexpr int kScan = 8;              // consecutive factors a thread of a row's scan
constexpr int kLoads = 8;             // a thread's loads in flight when it stages records
constexpr int kInputs = 14;

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

// Entry (row, col) of jt_q (q = 0, 1, 2: the IMU times), from the pieces p.
template <typename T>
__device__ __forceinline__ T jt_entry(const Args<T>& a, const T* p, int q, int row, int col) {
  const int br = row / 3, bc = col / 3, i = row % 3, j = col % 3;
  const T eye = i == j ? T(1) : T(0);
  const int blk = 4 * br + bc;
  if (q == 0) {
    switch (blk) {
      case 0: return -a.wg_dt * p[kDth1 + 3 * i + j];
      case 2: return -a.w_g * eye;
      case 4: return a.w_a * p[kDacc + 3 * i + j];
      case 5: return -a.wa_dt2 * eye;
      case 7: return -a.w_a * p[kRq1c + 3 * i + j];
      case 10: return a.w_bg * eye;
      case 15: return a.w_ba * eye;
      default: return T(0);
    }
  }
  if (q == 1) {  // no (gyr, bg) block: the residual uses bg(tau1) only
    switch (blk) {
      case 0: return -a.wg_dt * p[kDth2 + 3 * i + j];
      case 5: return a.wa2_dt2 * eye;
      case 10: return -a.w_bg * eye;
      case 15: return -a.w_ba * eye;
      default: return T(0);
    }
  }
  return blk == 5 ? (-a.wa_dt2 * eye) : T(0);
}

// Entry e (row e / 36, column e % 36) of a factor's band: column block d
// holds the sum, in k order, of the Jacobian blocks k with rel_k = d, each
// jt_(k/2) times its lerp weight times valid
template <typename T>
__device__ __forceinline__ T band_entry(const Args<T>& a, const T* p, const T* w, const int* mt,
                                        int e) {
  const int row = e / 36, col36 = e % 36, d = col36 / 12, col = col36 % 12;
  T s = T(0);
  for (int k = 0; k < 6; ++k)
    if (mt[1 + k] == d) s = s + ((jt_entry(a, p, k >> 1, row, col) * w[kW + k]) * w[kW + 6]);
  return s;
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    imu_factor_normal(Args<T> a, T* __restrict__ bands, T* __restrict__ g_out,
                      T* __restrict__ work, int* __restrict__ base_of) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* band = reinterpret_cast<T*>(smem_raw);  // kBatch x kBand: phase 2's staged bands
  T* res = band + kBatch * kBand;             // kBatch x 12: their residuals
  T* wp = res + kBatch * 12;                  // kWarps x kSlot: phase 1's factors
  T* slab = wp + kWarps * kSlot;              // kAcc: the finished chains
  int* meta = reinterpret_cast<int*>(slab + kAcc);  // kWarps x kMeta
  int* based = meta + kWarps * kMeta;         // kBatch: the staged factors' bases
  int* list = based + kBatch;                 // kWindow
  int* counts = list + kWindow;               // kWarps
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // phase 1: a warp a factor, over the whole grid
  for (int m = blockIdx.x * kWarps + warp; m < a.mi; m += gridDim.x * kWarps) {
    T* p = wp + warp * kSlot;
    int* mt = meta + warp * kMeta;
    if (lane == 0) imu_eval<T, true>(a, m, p, p + kPieces, mt);
    __syncwarp();
    T* rec = work + (size_t)m * kRec;
    for (int e = lane; e < kBand; e += 32) rec[e] = band_entry(a, p, p + kPieces, mt, e);
    if (lane < 12) rec[kBand + lane] = p[kR + lane];
    if (lane == 0) base_of[m] = mt[0];
    __syncwarp();
  }
  cg::this_grid().sync();

  // phase 2: a block a block row r
  for (int r = blockIdx.x; r < a.s_cap; r += gridDim.x) {
    // thread tid: entries tid and tid + kThreads (below kBand) of each slab,
    // row tid of each gseg piece (tid < 12); every thread works on every factor
    const int e0 = tid, e1 = tid + kThreads;
    const int i0 = e0 / 36, c0 = e0 % 36, i1 = e1 / 36, c1 = e1 % 36;
    const bool has1 = e1 < kBand, has_g = tid < 12;
    T s0a = T(0), s0b = T(0), s1a = T(0), s1b = T(0), s2a = T(0), s2b = T(0);
    T g0 = T(0), g1 = T(0), g2 = T(0);
    for (int w0 = 0; w0 < a.mi; w0 += kWindow) {
      const int w1 = min(a.mi, w0 + kWindow);
      int listed = 0;
      for (int cs = w0; cs < w1; cs += kThreads * kScan) {
        const int m0 = cs + tid * kScan;
        bool member[kScan];
#pragma unroll
        for (int k = 0; k < kScan; ++k) {
          const int base = m0 + k < w1 ? base_of[m0 + k] : -1;
          member[k] = base >= 0 && base >= r - 2 && base <= r;
        }
        listed += wc::compact_many<kWarps, kScan>(
            member, m0, listed, [&](int pos, int k) { list[pos] = m0 + k; }, counts);
      }
      for (int b0 = 0; b0 < listed; b0 += kBatch) {
        const int nb = min(kBatch, listed - b0);
        // stage the batch's records, kLoads loads in flight a thread
        for (int e0 = tid; e0 < nb * kRec; e0 += kLoads * kThreads) {
          T v[kLoads];
#pragma unroll
          for (int u = 0; u < kLoads; ++u) {
            const int e = e0 + u * kThreads;
            v[u] = e < nb * kRec ? work[(size_t)list[b0 + e / kRec] * kRec + e % kRec] : T(0);
          }
#pragma unroll
          for (int u = 0; u < kLoads; ++u) {
            const int e = e0 + u * kThreads, j = e / kRec, c = e % kRec;
            if (e >= nb * kRec) break;
            if (c < kBand)
              band[j * kBand + c] = v[u];
            else
              res[j * 12 + c - kBand] = v[u];
          }
        }
        if (tid < nb) based[tid] = base_of[list[b0 + tid]];
        __syncthreads();
        // each chain over this batch's factors of its base, in order: the
        // factor's hb entries (i, c) of slab di, sum_k fma(B[k][12 di + i], B[k][c])
        for (int j = 0; j < nb; ++j) {
          const int di = r - based[j];
          const T* bj = band + j * kBand;
          const T* rj = res + j * 12;
          T va = T(0), vb = T(0), vg = T(0);
#pragma unroll
          for (int k = 0; k < 12; ++k) {
            va = rfma(bj[36 * k + 12 * di + i0], bj[36 * k + c0], va);
            if (has1) vb = rfma(bj[36 * k + 12 * di + i1], bj[36 * k + c1], vb);
            if (has_g) vg = rfma(bj[36 * k + 12 * di + tid], rj[k], vg);
          }
          if (di == 0) {
            s0a += va, s0b += vb, g0 += vg;
          } else if (di == 1) {
            s1a += va, s1b += vb, g1 += vg;
          } else {
            s2a += va, s2b += vb, g2 += vg;
          }
        }
        __syncthreads();
      }
    }
    slab[e0] = s0a, slab[kBand + e0] = s1a, slab[2 * kBand + e0] = s2a;
    if (has1) slab[e1] = s0b, slab[kBand + e1] = s1b, slab[2 * kBand + e1] = s2b;
    if (has_g) {
      slab[3 * kBand + tid] = g0, slab[3 * kBand + 12 + tid] = g1;
      slab[3 * kBand + 24 + tid] = g2;
    }
    __syncthreads();
    // slab di (rows i, columns c) = hseg[r - di][12 di + i][c]
    const int s_cap = a.s_cap;
    for (int e = tid; e < 5 * 144; e += kThreads) {
      const int d = e / 144, i = (e % 144) / 12, j = e % 12;
      const T* s0 = slab + 36 * i;
      const T* s1 = slab + kBand + 36 * i;
      const T* s2 = slab + 2 * kBand + 36 * i;
      T v;
      switch (d) {
        case 0: v = s2[j]; break;                                      // delta -2: (2, 0) at r - 2
        case 1: v = s1[j] + s2[12 + j]; break;                    // delta -1
        case 2: v = (s0[j] + s1[12 + j]) + s2[24 + j]; break;  // delta 0
        case 3: v = s0[12 + j] + s1[24 + j]; break;               // delta +1
        default: v = s0[24 + j]; break;                                // delta +2: (0, 2) at r
      }
      bands[((size_t)d * s_cap + r) * 144 + 12 * i + j] = v;
    }
    if (tid < 12) {
      const T* gs = slab + 3 * kBand;
      g_out[12 * r + tid] = (gs[tid] + gs[12 + tid]) + gs[24 + tid];
    }
    __syncthreads();  // slab is rewritten by the next row
  }
}

size_t normal_smem(int itemsize) {
  return (size_t)itemsize * (kBatch * kBand + kBatch * 12 + kWarps * kSlot + kAcc) +
         sizeof(int) * (kWarps * kMeta + kBatch + kWindow + kWarps);
}

int resident_cache[2][16];  // resident blocks of the normal-mode kernel, per type and card

template <typename T>
int launch(void* const* in, void* r_out, void* bands, void* g_out, void* work, void* base_of,
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
  const size_t smem = normal_smem(sizeof(T));
  int resident = 0;
  cudaError_t err = wc::resident_blocks(imu_factor_normal<T>, kThreads, smem, &resident,
                                        resident_cache[sizeof(T) == 8]);
  if (err != cudaSuccess) return (int)err;
  // phase 2 takes one block a block row; phase 1 one warp a factor
  const int grid = min(resident, max(s_cap, (mi + kWarps - 1) / kWarps));
  err = wc::launch_cooperative(imu_factor_normal<T>, dim3(grid), dim3(kThreads), smem, st, a,
                               static_cast<T*>(bands), static_cast<T*>(g_out),
                               static_cast<T*>(work), static_cast<int*>(base_of));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// in: the kInputs input pointers (valid, q1, q2, a1, g1, g2, p1, p2, p3, il,
// ir, f, cor, grav); consts: the nine values of Args' comment. Residual mode
// (normal = 0) writes r_out (Mi, 12); normal mode writes bands (5, S, 12, 12)
// and g_out (S 12), with work (Mi x (12 x 36 + 12) values) and base_of (Mi
// int32) as its workspace. threads, batch and smem_bytes are the wrapper's
// plan (ops/imu_factor.py), checked against the kernel's build.
extern "C" int wc_imu_factor(void* const* in, int n_in, void* r_out, void* bands, void* g_out,
                             void* work, void* base_of, int mi, int s_cap, int itemsize,
                             int normal, const double* consts, int threads, int batch,
                             int smem_bytes, void* stream) {
  if (n_in != kInputs || mi < 0 || s_cap < 1 || (itemsize != 4 && itemsize != 8) ||
      (mi > 0 && mi > (1 << 26)))
    return (int)cudaErrorInvalidValue;
  if (normal && (threads != kThreads || batch != kBatch ||
                 (size_t)smem_bytes != normal_smem(itemsize)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return itemsize == 4
             ? launch<float>(in, r_out, bands, g_out, work, base_of, mi, s_cap, normal, consts, st)
             : launch<double>(in, r_out, bands, g_out, work, base_of, mi, s_cap, normal, consts,
                              st);
}
