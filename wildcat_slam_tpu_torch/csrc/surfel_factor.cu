// The surfel factors' residuals, IRLS weights, Jacobians and normal
// equations with the sparse cross Gram, and the assembly of H (kernel K6),
// in one launch.
//
// Replaces: no Pallas kernel. It is the counterpart of
// wildcat_slam_tpu/odometry/factors.py:344 (surfel_residuals) followed by
// wildcat_slam_tpu/odometry/solver.py:122 (_surfel_normal_eqs) and the
// assembly of H in solve_window (_place_block_bands, D + D^T, the gauge
// mask), which XLA fuses inside the jitted sweep; the port ran them as one
// PyTorch kernel per operation, the cross matrix D = B1^T B2 as a dense
// (8192 x 1152)^T (8192 x 1152) product of two matrices with 24 nonzeros a
// row (odometry/factors.py surfel_residuals_plain and odometry/solver.py
// surfel_normal_eqs_plain, the plain version). Factor m (M of them, the
// first nb binary) has the residual r = w n . (T1 - T2), the Cauchy IRLS
// weight sw = 1 / sqrt(1 + r^2 / a^2) and two side Jacobians j1v, j2v (12
// each, the lerp weights cancelled as the plain version does), side k
// interpolated between sample states ikl and ikr with weight 1 - fk and fk.
//
// Residual mode: one thread a factor writes r (M,), where(valid, r, 0).
// Normal mode: one cooperative launch in three phases, two grid barriers.
// Phase 1: every factor evaluated once, a thread a factor, over the whole
// grid: r, sw, j1v, j2v and rs_w = r sw into a workspace; and for each block
// row s (a block a row) the list, in factor order, of the factors with a
// side there, i1l or i2l in {s - 1, s} (warp ballots, no atomics). Phase 2,
// a warp an item, two kinds:
//   a pair of block rows s <= t (S (S + 1) / 2 of them): over the shorter
//   of the two rows' lists (each holds every factor that reaches both) the
//   chains, in increasing factor index,
//     A[i][j] = D[(s,i),(t,j)] = sum fma(w1(m,s) j1v_i, w2(m,t) j2v_j) over
//               the binary factors with side 1 at s and side 2 at t,
//     B[i][j] = D[(t,j),(s,i)], the same over side 1 at t and side 2 at s,
//   and d = A + B written at (s,i),(t,j) and at (t,j),(s,i) of H (masked
//   and final where |t - s| > 2);
//   a chunk of CHUNK entries of a row's list: the partial sums, in order, of
//   g[s] (sum fma(w_k(m,s), jkv_i rs_w) a side) and of the diagonal
//   payloads c (jkv_i jkv_j), c in ((1-f)^2, (1-f) f, f^2), of row s, side 1
//   over the binary factors with i1l = s and side 2 over all with i2l = s
//   (t11, t22), into a workspace. (The rows of the newest sample states hold
//   most of the factors: a row's work is spread over its chunks.)
// Phase 3, a warp a block row s: the chunks' partial sums added in order,
// then the blocks (s, s), (s, s + 1), (s, s + 2) of H,
//   H[(s,i),(t,j)] = ((band + d) fm_a) fm_b + [a = b] (1 - fm_a),
// band the IMU bands (kernel K5's output) plus the surfel ones (delta 0:
// (t11 + t22)[s] c0 + (t11 + t22)[s-1] c2; +1: (t11 + t22)[s] c1), in the
// order the plain version adds them, written at (a, b) and (b, a) (in the
// diagonal block from i <= j), and g[s]. Each value of H is computed once
// and written to both of its places, so H is bit-exactly symmetric (K1
// reads H's rows as its columns).
//
// What bounds it on an H100: bytes. At M = 16384, S = 96 in float32 the
// call reads ~1.8 MB of factors and writes H, 5.3 MB (~2 us at 3.35 TB/s),
// for ~16 M FMA. A binary factor reaches the ~2 x 8192 / states rows of
// its brackets, so a pair's D needs a few factors of a row's list, not the
// 8192 rows of the dense product.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lie.cuh"

namespace {

namespace cg = cooperative_groups;

using wc::rfma;

constexpr int kThreads = 256;       // a normal-mode block (ops/surfel_factor.py THREADS)
constexpr int kWarps = kThreads / 32;
constexpr int kResThreads = 128;    // a residual-mode block
constexpr int kRec = 28;            // a factor's record in the workspace: j1v 12, j2v 12, rs_w
constexpr int kLane = 5;            // entries of a 12 x 12 block a lane: 144 over 32 lanes
constexpr int kChunk = 64;          // list entries a chunk item (ops/surfel_factor.py CHUNK)
constexpr int kScan = 8;            // consecutive factors a thread of a row's scan
constexpr int kStage = 32;          // a chunk's factors staged together in shared memory
constexpr int kPart = 6 * 144 + 24; // a chunk's partial sums: t11 c0..c2, t22 c0..c2, g
constexpr int kInputs = 15;

template <typename T>
struct Args {
  const unsigned char* valid;  // (M,)
  const T* w;                  // (M,)
  const T* n;                  // (M, 3)
  const unsigned char* opt1;   // (M,)
  const T *v1, *p1;            // (M, 3)
  const long long *i1l, *i1r;  // (M,)
  const T* f1;                 // (M,)
  const T *v2, *p2;
  const long long *i2l, *i2r;
  const T* f2;
  const T* cor;                // (S, 12)
  int m, nb, s_cap;
  T a2;                        // cauchy_scale^2
};

// w_k(m, t): the lerp weight of sample state t on a side with brackets
// (il, ir) and factor f, in the plain version's form (i == t) (1 - f) +
// (ir == t) f
template <typename T>
__device__ __forceinline__ T weight(long long il, long long ir, T f, long long t) {
  return ((il == t ? T(1) : T(0)) * (T(1) - f)) + ((ir == t ? T(1) : T(0)) * f);
}

// One side's Jacobian block [-sign (u Jr(rc)), sign wn, 0] with
// u = (wn R(rc)) x v, the first 6 entries into out
template <typename T>
__device__ __forceinline__ void side_block(const T* wn, const T* v, const T* rc, T sign, T* out) {
  T rm[9], tmp[3], u[3], jrm[9], vj[3];
  wc::exp_matrix(rc, rm);
  wc::vec_mat3(wn, rm, tmp);
  wc::cross(tmp, v, u);
  wc::jr(rc, jrm);
  wc::vec_mat3(u, jrm, vj);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out[i] = -sign * vj[i];
    out[3 + i] = sign * wn[i];
  }
}

// Factor m's residual (where(valid, r, 0)) and, with kJac, j1v and j2v with
// the IRLS weight and rs_w = r sw into mem (kMem values).
template <typename T, bool kJac>
__device__ T surfel_eval(const Args<T>& a, int m, T* mem) {
  const T f1 = a.f1[m], f2 = a.f2[m];
  T c1[6], c2[6];
  wc::lerp_rows(a.cor, a.i1l[m], a.i1r[m], f1, 6, c1);
  wc::lerp_rows(a.cor, a.i2l[m], a.i2r[m], f2, 6, c2);
  const T *v1 = a.v1 + 3 * m, *p1 = a.p1 + 3 * m, *v2 = a.v2 + 3 * m, *p2 = a.p2 + 3 * m;
  const T* n = a.n + 3 * m;
  const bool opt1 = a.opt1[m] != 0, valid = a.valid[m] != 0;
  T q[4], e1[3], e2[3];
  wc::exp_quat(c1, q);
  wc::quat_rotate(q, v1, e1);
  wc::exp_quat(c2, q);
  wc::quat_rotate(q, v2, e2);
  T d[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    // each operation rounded as the plain version rounds it (metre-scale
    // positions whose difference is the residual)
    const T t1 = opt1 ? (e1[i] + c1[3 + i]) + p1[i] : v1[i];
    d[i] = t1 - ((e2[i] + c2[3 + i]) + p2[i]);
  }
  const T w = a.w[m];
  const T dot = ((n[0] * d[0]) + (n[1] * d[1])) + (n[2] * d[2]);
  const T r = valid ? (w * dot) : T(0);
  if (!kJac) return r;
  const T wn[3] = {w * n[0], w * n[1], w * n[2]};
  T j1[6], j2[6];
  side_block(wn, v1, c1, T(1), j1);
  side_block(wn, v2, c2, T(-1), j2);
  const T opt1f = opt1 ? T(1) : T(0), vm = valid ? T(1) : T(0);
  const T sw = T(1) / wc::wsqrt(T(1) + r * r / a.a2);
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    const T b1 = (k < 6 ? j1[k] : T(0)) * opt1f;
    const T b2 = k < 6 ? j2[k] : T(0);
    mem[k] = (((b1 * (T(1) - f1)) * vm) + ((b1 * f1) * vm)) * sw;
    mem[12 + k] = (((b2 * (T(1) - f2)) * vm) + ((b2 * f2) * vm)) * sw;
  }
  mem[24] = r * sw;
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kResThreads)
    surfel_factor_residuals(Args<T> a, T* __restrict__ r_out) {
  const int m = blockIdx.x * kResThreads + threadIdx.x;
  if (m < a.m) r_out[m] = surfel_eval<T, false>(a, m, nullptr);
}

// A list entry: the factor's index and its four bracket indices, two 16-bit
// values an int (each clamped to [-2, S], which keeps every comparison with
// a row in [-1, S - 1])
__device__ __forceinline__ int pack2(long long lo, long long hi, int s_cap) {
  const int l = (int)(lo < -2 ? -2 : lo > s_cap ? s_cap : lo);
  const int h = (int)(hi < -2 ? -2 : hi > s_cap ? s_cap : hi);
  return (int)((unsigned)(l & 0xFFFF) | ((unsigned)(h & 0xFFFF) << 16));
}
__device__ __forceinline__ int lo16(int v) { return (int)(short)(v & 0xFFFF); }
__device__ __forceinline__ int hi16(int v) { return (int)(short)((unsigned)v >> 16); }

// The pair of block rows (s, t), s <= t, of item q (row-major over the
// upper triangle)
__device__ __forceinline__ void pair_of(int q, int s_cap, int* s, int* t) {
  int r = 0;
  while (q >= s_cap - r) q -= s_cap - r++;
  *s = r, *t = r + q;
}

// The chunk items before row s's: sum over rows r < s of ceil(len_r / kChunk)
__device__ __forceinline__ int chunks_before(const int* lens, int s) {
  int c = 0;
  for (int r = 0; r < s; ++r) c += (lens[r] + kChunk - 1) / kChunk;
  return c;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    surfel_factor_normal(Args<T> a, const T* __restrict__ imu_bands, const T* __restrict__ gi,
                         const T* __restrict__ fm, T* __restrict__ h, T* __restrict__ g_out,
                         T* __restrict__ work, int4* __restrict__ lists, int* __restrict__ lens,
                         T* __restrict__ part) {
  __shared__ int counts[kWarps];
  // a chunk item's staged factors, a warp's slot each: records, then scalars
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* staged = reinterpret_cast<T*>(smem_raw) + (threadIdx.x >> 5) * kStage * (kRec + 2);
  const int tid = threadIdx.x, lane = tid & 31, s_cap = a.s_cap, mm = a.m, n = 12 * s_cap;
  const int warp0 = blockIdx.x * kWarps + (tid >> 5), warps = gridDim.x * kWarps;
  cg::grid_group grid = cg::this_grid();

  // phase 1: every factor evaluated once; each block row's list
  for (int m = blockIdx.x * kThreads + tid; m < mm; m += gridDim.x * kThreads)
    surfel_eval<T, true>(a, m, work + (size_t)m * kRec);
  for (int s = blockIdx.x; s < s_cap; s += gridDim.x) {
    int listed = 0;
    int4* entries = lists + (size_t)s * mm;
    for (int c0 = 0; c0 < mm; c0 += kThreads * kScan) {
      const int m0 = c0 + tid * kScan;
      bool member[kScan];
      int p1[kScan], p2[kScan];  // the packed brackets, loaded with the test
#pragma unroll
      for (int k = 0; k < kScan; ++k) {
        const int m = m0 + k;
        member[k] = false;
        if (m < mm) {
          const long long l1 = a.i1l[m], l2 = a.i2l[m];
          member[k] = l1 == s || l1 == s - 1 || l2 == s || l2 == s - 1;
          p1[k] = pack2(l1, a.i1r[m], s_cap);
          p2[k] = pack2(l2, a.i2r[m], s_cap);
        }
      }
      listed += wc::compact_many<kWarps, kScan>(
          member, m0, listed,
          [&](int pos, int k) { entries[pos] = make_int4(m0 + k, p1[k], p2[k], 0); }, counts);
    }
    if (tid == 0) lens[s] = listed;
  }
  grid.sync();

  // phase 2: the pairs' cross terms, then the rows' chunks
  const int pairs = s_cap * (s_cap + 1) / 2;
  const int chunks = chunks_before(lens, s_cap);
  for (int q = warp0; q < pairs + chunks; q += warps) {
    if (q < pairs) {
      int s, t;
      pair_of(q, s_cap, &s, &t);
      const int ws = lens[s] <= lens[t] ? s : t;  // walk the shorter list
      const int4* list = lists + (size_t)ws * mm;
      const int len = lens[ws];
      T A[kLane], B[kLane];
#pragma unroll
      for (int u = 0; u < kLane; ++u) A[u] = B[u] = T(0);
      for (int b0 = 0; b0 < len; b0 += 32) {
        const int idx = b0 + lane;
        int4 en = make_int4(0, 0, 0, 0);
        bool take = false;
        if (idx < len) {
          en = list[idx];
          const int i1l = lo16(en.y), i1r = hi16(en.y), i2l = lo16(en.z), i2r = hi16(en.z);
          take = en.x < a.nb && (((i1l == s || i1r == s) && (i2l == t || i2r == t)) ||
                                 ((i1l == t || i1r == t) && (i2l == s || i2r == s)));
        }
        unsigned todo = __ballot_sync(0xffffffffu, take);
        while (todo) {
          const int src = __ffs(todo) - 1;
          todo &= todo - 1;
          const int f = __shfl_sync(0xffffffffu, en.x, src);
          const int p1 = __shfl_sync(0xffffffffu, en.y, src), p2 = __shfl_sync(0xffffffffu, en.z, src);
          const int i1l = lo16(p1), i1r = hi16(p1), i2l = lo16(p2), i2r = hi16(p2);
          const T f1 = a.f1[f], f2 = a.f2[f];
          const T* j1v = work + (size_t)f * kRec;
          const T* j2v = j1v + 12;
          const bool dst = (i1l == s || i1r == s) && (i2l == t || i2r == t);
          const bool dts = (i1l == t || i1r == t) && (i2l == s || i2r == s);
          const T w1s = weight<T>(i1l, i1r, f1, s), w2t = weight<T>(i2l, i2r, f2, t);
          const T w1t = weight<T>(i1l, i1r, f1, t), w2s = weight<T>(i2l, i2r, f2, s);
#pragma unroll
          for (int u = 0; u < kLane; ++u) {
            const int e = lane + 32 * u;
            if (e >= 144) continue;
            const int i = e / 12, j = e % 12;
            // D[(s,i),(t,j)] = b1(m,(s,i)) b2(m,(t,j)); D[(t,j),(s,i)] = b1(m,(t,j)) b2(m,(s,i))
            if (dst) A[u] = rfma(w1s * j1v[i], w2t * j2v[j], A[u]);
            if (dts) B[u] = rfma(w1t * j1v[j], w2s * j2v[i], B[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kLane; ++u) {
        const int e = lane + 32 * u;
        if (e >= 144) continue;
        const int i = e / 12, j = e % 12;
        if (t == s && i > j) continue;
        const int ra = 12 * s + i, cb = 12 * t + j;
        T v = A[u] + B[u];
        if (t - s > 2) v = ((T(0) + v) * fm[ra]) * fm[cb];  // final: no band here
        h[(size_t)ra * n + cb] = v;
        h[(size_t)cb * n + ra] = v;
      }
    } else {
      // chunk c of row s's list
      int c = q - pairs, s = 0;
      while (c >= (lens[s] + kChunk - 1) / kChunk) c -= (lens[s++] + kChunk - 1) / kChunk;
      const int4* list = lists + (size_t)s * mm;
      const int b = c * kChunk, e1 = min(lens[s], b + kChunk);
      T acc[6][kLane];
#pragma unroll
      for (int k = 0; k < 6; ++k)
#pragma unroll
        for (int u = 0; u < kLane; ++u) acc[k][u] = T(0);
      T gacc = T(0);  // lanes 0-11 side 1, 12-23 side 2
      for (int g0 = b; g0 < e1; g0 += kStage) {
        // stage up to kStage factors: a lane's entry, then the records, coalesced
        const int ng = min(kStage, e1 - g0);
        int4 en = make_int4(0, 0, 0, 0);
        if (lane < ng) {
          en = list[g0 + lane];
          staged[kStage * kRec + 2 * lane] = a.f1[en.x];
          staged[kStage * kRec + 2 * lane + 1] = a.f2[en.x];
        }
        for (int v0 = 0; v0 < ng * kRec; v0 += 32) {  // the same trips in every lane
          const int v = v0 + lane;
          const int f = __shfl_sync(0xffffffffu, en.x, min(v, ng * kRec - 1) / kRec);
          if (v < ng * kRec) staged[v] = work[(size_t)f * kRec + v % kRec];
        }
        __syncwarp();
        for (int j = 0; j < ng; ++j) {
        const int f = __shfl_sync(0xffffffffu, en.x, j);
        const int q1 = __shfl_sync(0xffffffffu, en.y, j), q2 = __shfl_sync(0xffffffffu, en.z, j);
        const int i1l = lo16(q1), i1r = hi16(q1), i2l = lo16(q2), i2r = hi16(q2);
        const T f1 = staged[kStage * kRec + 2 * j], f2 = staged[kStage * kRec + 2 * j + 1];
        const T* j1v = staged + j * kRec;
        const T* j2v = j1v + 12;
        const bool p1 = f < a.nb && i1l == s, p2 = i2l == s;
        if (p1 || p2) {
          // the diagonal payloads' coefficients, as the plain version forms them
          const T g1 = T(1) - f1, g2 = T(1) - f2;
          const T c1[3] = {g1 * g1, g1 * f1, f1 * f1};
          const T c2[3] = {g2 * g2, g2 * f2, f2 * f2};
#pragma unroll
          for (int u = 0; u < kLane; ++u) {
            const int e = lane + 32 * u;
            if (e >= 144) continue;
            const int i = e / 12, j = e % 12;
            if (p1) {
              const T x = j1v[i] * j1v[j];
#pragma unroll
              for (int k = 0; k < 3; ++k) acc[k][u] = acc[k][u] + (c1[k] * x);
            }
            if (p2) {
              const T y = j2v[i] * j2v[j];
#pragma unroll
              for (int k = 0; k < 3; ++k) acc[3 + k][u] = acc[3 + k][u] + (c2[k] * y);
            }
          }
        }
        if (lane < 24) {
          const bool two = lane >= 12;
          const bool side = two ? (i2l == s || i2l == s - 1) : (i1l == s || i1l == s - 1);
          if (side) {
            const T wk = two ? weight<T>(i2l, i2r, f2, s) : weight<T>(i1l, i1r, f1, s);
            gacc = rfma(wk, (two ? j2v : j1v)[lane % 12] * j1v[24], gacc);
          }
        }
        }
        __syncwarp();  // the slot is restaged by the next group
      }
      T* out = part + (size_t)(q - pairs) * kPart;
#pragma unroll
      for (int k = 0; k < 6; ++k)
#pragma unroll
        for (int u = 0; u < kLane; ++u) {
          const int e = lane + 32 * u;
          if (e < 144) out[144 * k + e] = acc[k][u];
        }
      if (lane < 24) out[6 * 144 + lane] = gacc;
    }
  }
  grid.sync();

  // phase 3: a warp a block row: its chunks' sums in order, then the bands
  for (int s = warp0; s < s_cap; s += warps) {
    const int c0 = chunks_before(lens, s), cs = (lens[s] + kChunk - 1) / kChunk;
    const int cp = s > 0 ? c0 - (lens[s - 1] + kChunk - 1) / kChunk : c0;  // row s - 1's first
    T tot[6][kLane], prev[2][kLane];  // t11, t22 at c0..c2 of row s; at c2 of row s - 1
#pragma unroll
    for (int u = 0; u < kLane; ++u) {
#pragma unroll
      for (int k = 0; k < 6; ++k) tot[k][u] = T(0);
      prev[0][u] = prev[1][u] = T(0);
    }
    // chunk by chunk, each chunk's loads issued together
    for (int c = 0; c < cs; ++c) {
      const T* pc = part + (size_t)(c0 + c) * kPart;
#pragma unroll
      for (int u = 0; u < kLane; ++u) {
        const int e = lane + 32 * u;
        if (e >= 144) continue;
#pragma unroll
        for (int k = 0; k < 6; ++k) tot[k][u] = tot[k][u] + pc[144 * k + e];
      }
    }
    for (int c = cp; c < c0; ++c) {
      const T* pc = part + (size_t)c * kPart;
#pragma unroll
      for (int u = 0; u < kLane; ++u) {
        const int e = lane + 32 * u;
        if (e >= 144) continue;
        prev[0][u] = prev[0][u] + pc[144 * 2 + e];
        prev[1][u] = prev[1][u] + pc[144 * 5 + e];
      }
    }
    for (int delta = 0; delta <= 2 && s + delta < s_cap; ++delta) {
      const int t = s + delta;
#pragma unroll
      for (int u = 0; u < kLane; ++u) {
        const int e = lane + 32 * u;
        if (e >= 144) continue;
        const int i = e / 12, j = e % 12;
        if (delta == 0 && i > j) continue;
        const int ra = 12 * s + i, cb = 12 * t + j;
        T band = imu_bands[((size_t)(delta + 2) * s_cap + s) * 144 + e];
        if (delta == 0)
          band = band + ((tot[0][u] + tot[3][u]) + (prev[0][u] + prev[1][u]));
        else if (delta == 1)
          band = band + (tot[1][u] + tot[4][u]);
        T v = band + h[(size_t)ra * n + cb];  // d, from phase 2
        v = (v * fm[ra]) * fm[cb];
        v = v + (ra == cb ? T(1) - fm[ra] : T(0));
        h[(size_t)ra * n + cb] = v;
        h[(size_t)cb * n + ra] = v;
      }
    }
    // g[s] = ((g1 + g2) + gi) fm
    T gs = T(0);
    if (lane < 24)
      for (int c = 0; c < cs; ++c) gs = gs + part[(size_t)(c0 + c) * kPart + 6 * 144 + lane];
    const T other = __shfl_down_sync(0xffffffffu, gs, 12);
    if (lane < 12) {
      const int ra = 12 * s + lane;
      g_out[ra] = ((gs + other) + gi[ra]) * fm[ra];
    }
  }
}

int resident_cache[2][16];  // resident blocks of the normal-mode kernel, per type and card

template <typename T>
int launch(void* const* in, void* r_out, const void* imu_bands, const void* gi, const void* fm,
           void* h, void* g_out, void* work, void* lists, void* lens, void* part, int m, int nb,
           int s_cap, int normal, double a2, cudaStream_t st) {
  Args<T> a;
  a.valid = static_cast<const unsigned char*>(in[0]);
  a.w = static_cast<const T*>(in[1]);
  a.n = static_cast<const T*>(in[2]);
  a.opt1 = static_cast<const unsigned char*>(in[3]);
  a.v1 = static_cast<const T*>(in[4]);
  a.p1 = static_cast<const T*>(in[5]);
  a.i1l = static_cast<const long long*>(in[6]);
  a.i1r = static_cast<const long long*>(in[7]);
  a.f1 = static_cast<const T*>(in[8]);
  a.v2 = static_cast<const T*>(in[9]);
  a.p2 = static_cast<const T*>(in[10]);
  a.i2l = static_cast<const long long*>(in[11]);
  a.i2r = static_cast<const long long*>(in[12]);
  a.f2 = static_cast<const T*>(in[13]);
  a.cor = static_cast<const T*>(in[14]);
  a.m = m, a.nb = nb, a.s_cap = s_cap;
  a.a2 = T(a2);
  if (!normal) {
    if (m > 0)
      surfel_factor_residuals<T><<<(m + kResThreads - 1) / kResThreads, kResThreads, 0, st>>>(
          a, static_cast<T*>(r_out));
    return (int)cudaGetLastError();
  }
  const size_t smem = sizeof(T) * kWarps * kStage * (kRec + 2);
  int resident = 0;
  cudaError_t err = wc::resident_blocks(surfel_factor_normal<T>, kThreads, smem, &resident,
                                        resident_cache[sizeof(T) == 8]);
  if (err != cudaSuccess) return (int)err;
  const int items = s_cap * (s_cap + 1) / 2 + s_cap + 4 * m / kChunk;  // pairs and chunks, at most
  const int need = max(max(s_cap, (m + kThreads - 1) / kThreads), (items + kWarps - 1) / kWarps);
  err = wc::launch_cooperative(surfel_factor_normal<T>, dim3(min(resident, need)),
                               dim3(kThreads), smem, st, a, static_cast<const T*>(imu_bands),
                               static_cast<const T*>(gi), static_cast<const T*>(fm),
                               static_cast<T*>(h), static_cast<T*>(g_out), static_cast<T*>(work),
                               static_cast<int4*>(lists), static_cast<int*>(lens),
                               static_cast<T*>(part));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// in: the kInputs input pointers (valid, w, n, opt1, v1, p1, i1l, i1r, f1,
// v2, p2, i2l, i2r, f2, cor). Residual mode (normal = 0) writes r_out (M,);
// normal mode reads imu_bands (5, S, 12, 12), gi (S 12) and fm (S 12) and
// writes h (S 12, S 12) and g_out (S 12), with work (M x 28 values), lists
// (S x M int4: a factor and its packed brackets), lens (S int32) and part
// ((S + 4 M / 64) x (6 x 144 + 24) values: a chunk's partial sums) as its
// workspace. threads and chunk are the
// wrapper's plan (ops/surfel_factor.py), checked against the kernel's build.
extern "C" int wc_surfel_factor(void* const* in, int n_in, void* r_out, const void* imu_bands,
                                const void* gi, const void* fm, void* h, void* g_out, void* work,
                                void* lists, void* lens, void* part, int m, int nb, int s_cap,
                                int itemsize, int normal, double a2, int threads, int chunk,
                                void* stream) {
  if (n_in != kInputs || m < 0 || nb < 0 || nb > m || s_cap < 1 || s_cap > 4096 ||
      (itemsize != 4 && itemsize != 8) || m > (1 << 26))
    return (int)cudaErrorInvalidValue;
  if (normal && (threads != kThreads || chunk != kChunk)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return itemsize == 4
             ? launch<float>(in, r_out, imu_bands, gi, fm, h, g_out, work, lists, lens, part, m,
                             nb, s_cap, normal, a2, st)
             : launch<double>(in, r_out, imu_bands, gi, fm, h, g_out, work, lists, lens, part, m,
                              nb, s_cap, normal, a2, st);
}
