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
// Normal mode: one cooperative launch in four phases, three grid barriers.
// Phase 0, a block a segment of kSeg factors: the window's cor staged in
// shared memory; each factor evaluated by two threads, one a side (they
// swap their points for r), its record (j1v, j2v, rs_w, f1, f2) and its
// packed brackets written once; then each factor's keys, sorted in the
// block with the factor's place in the low bits (so stably): the block rows
// it reaches (i1l or i2l in {s - 1, s}, each row once) and, if binary, the
// pairs of block rows s <= t that its brackets reach (side 1 at one, side 2
// at the other, each pair once). The segment writes its row entries and
// its pair entries (its pieces, by key then factor) and each key's
// exclusive offset in them. Phase 1: the counts summed over the segments
// (warps take segments, lanes keys) and scanned: each segment's row
// entries go after the earlier segments' and the earlier rows', so a
// row's list holds its factors in increasing index; the pairs' totals. The
// pairs are not gathered: a pair's list is its run in each segment's
// piece, segment after segment. Phase 2, a warp an item, each staging its
// factors' records (16-byte asynchronous copies, all in flight at once, 64
// factors at a time in float32, 32 in float64) and forming each staged
// factor's flags and coefficients once, on a lane of its own, two kinds:
//   a chunk of kChunk entries of a row's list: the partial sums, in order,
//   of g[s] (sum fma(w_k(m,s), jkv_i rs_w) a side) and of the diagonal
//   payloads c (jkv_i jkv_j), c in ((1-f)^2, (1-f) f, f^2), of row s, side 1
//   over the binary factors with i1l = s and side 2 over all with i2l = s
//   (t11, t22), into a workspace (a payload is symmetric, so its upper
//   triangle's chains are formed and each written to both places);
//   a pair of block rows s <= t that holds factors: its factors gathered
//   from the pieces, then the chains, in increasing factor index (a factor
//   that feeds one of them has its sides scaled by their weights in place),
//     A[i][j] = D[(s,i),(t,j)] = sum fma(w1(m,s) j1v_i, w2(m,t) j2v_j) over
//               the binary factors with side 1 at s and side 2 at t,
//     B[i][j] = D[(t,j),(s,i)], the same over side 1 at t and side 2 at s,
//   and d = A + B written at (s,i),(t,j) and at (t,j),(s,i) of H (masked
//   and final where |t - s| > 2).
// The pairs without factors are written by a flat pass over H, 16 bytes a
// store (d = 0 near the band, the masked zero beyond). Phase 3, a block a block row s and 32
// of its 144 entries (a thread a value: the chunks' partial sums added in
// order, kIn loads in flight), then the blocks (s, s), (s, s + 1),
// (s, s + 2) of H,
//   H[(s,i),(t,j)] = ((band + d) fm_a) fm_b + [a = b] (1 - fm_a),
// band the IMU bands (kernel K5's output) plus the surfel ones (delta 0:
// (t11 + t22)[s] c0 + (t11 + t22)[s-1] c2; +1: (t11 + t22)[s] c1), in the
// order the plain version adds them, written at (a, b) and (b, a) (in the
// diagonal block from i <= j), and g[s]. Each value of H is computed once
// and written to both of its places, so H is bit-exactly symmetric (K1
// reads H's rows as its columns). No atomics: every place comes from counts
// and exclusive scans. Every chain and sum is the one of the kernel's first
// design (a block a row's scan of all M factors for its list, and a warp a
// pair walking the shorter list), in the same order, so the bits are too.
//
// What bounds it on an H100: bytes, ~2 us at M = 16384, S = 96 in float32
// (~1.8 MB of factors read, H's 5.3 MB written) for ~16 M FMA; what it
// takes is latency: chains of dependent loads and of FMAs, and grid
// barriers. So every factor is read once (its two sides on two threads,
// cor from shared memory), each list is built by one counting pass over the
// grid (no block scans all M factors), a pair's work covers only its
// factors (a binary factor reaches ~2 x 8192 / states rows, so most pairs
// hold none and cost one load), and a row's payloads are spread over its
// chunks and then over a block.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "lie.cuh"

namespace {

namespace cg = cooperative_groups;

using wc::rfma;

constexpr int kThreads = 256;       // a normal-mode block (ops/surfel_factor.py THREADS)
constexpr int kWarps = kThreads / 32;
constexpr int kResThreads = 128;    // a residual-mode block
constexpr int kRec = 28;            // a factor's record: j1v 12, j2v 12, rs_w, f1, f2, one unused
constexpr int kLane = 5;            // entries of a 12 x 12 block a lane: 144 over 32 lanes
constexpr int kChunk = 64;          // list entries a chunk item (ops/surfel_factor.py CHUNK)
template <typename T>
constexpr int kStage = sizeof(T) == 4 ? 64 : 32;  // a warp's factors staged together
constexpr int kCoef = 8;            // a staged factor's coefficients (its payloads' or weights)
constexpr int kTri = 3;             // a 12 x 12 block's upper triangle a lane: 78 over 32
constexpr int kPart = 6 * 144 + 24; // a chunk's partial sums: t11 c0..c2, t22 c0..c2, g
constexpr int kSeg = 128;           // factors a segment (ops/surfel_factor.py SEGMENT)
constexpr int kKeys = 8 * kSeg;     // a segment's keys: <= 4 block rows and <= 4 pairs a factor
constexpr int kPiece = 4 * kSeg;    // a segment's row entries (or pair entries), at most
constexpr int kCorRows = 512;       // rows of cor staged in shared memory (their first 6 values)
constexpr int kWin = 2048;          // a segment's pair offsets formed together in shared memory
constexpr unsigned kNoKey = 0xffffffffu;
constexpr int kInputs = 15;
static_assert(2 * kSeg == kThreads, "a segment's factors take two threads each");

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

// The int32 workspace, its parts in this order (ops/surfel_factor.py plan)
struct Ints {
  int2* packed;  // (M,): the factor's packed brackets, side 1 then side 2
  int* erow;     // (nseg, S + 1): a segment's row entries before row s
  int* rcnt;     // (nseg, S): a segment's row entries of row s
  int* rpiece;   // (nseg, kPiece): a segment's row entries, by row then factor
  int* lists;    // (4 M,): the block rows' lists, row after row
  int* epair;    // (npseg, P + 1): a segment's pair entries before pair q
  int* ppiece;   // (npseg, kPiece): a segment's pair entries, by pair then factor
  int* ptot;     // (P,): the factors of pair q
  int* rstart;   // (S + 1,): row s's list starts at lists[rstart[s]]
  int* cstart;   // (S + 1,): row s's first chunk item; cstart[S] the chunks
};

struct Sizes {
  int nseg, npseg, pairs;
  long long values, ints;  // the two workspaces, in values and in int32
};

Sizes sizes(int m, int nb, int s_cap) {
  Sizes z;
  z.nseg = (m + kSeg - 1) / kSeg;
  z.npseg = (nb + kSeg - 1) / kSeg;
  z.pairs = s_cap * (s_cap + 1) / 2;
  z.values = (long long)m * kRec + ((long long)s_cap + 4LL * m / kChunk) * kPart;
  z.ints = 2LL * m + (long long)z.nseg * (2 * s_cap + 1 + kPiece) + 4LL * m +
           (long long)z.npseg * (z.pairs + 1 + kPiece) + z.pairs + 2LL * (s_cap + 1);
  return z;
}

Ints carve(int* base, int m, const Sizes& z, int s_cap) {
  Ints w;
  w.packed = reinterpret_cast<int2*>(base);
  w.erow = base + 2LL * m;
  w.rcnt = w.erow + (long long)z.nseg * (s_cap + 1);
  w.rpiece = w.rcnt + (long long)z.nseg * s_cap;
  w.lists = w.rpiece + (long long)z.nseg * kPiece;
  w.epair = w.lists + 4LL * m;
  w.ppiece = w.epair + (long long)z.npseg * (z.pairs + 1);
  w.ptot = w.ppiece + (long long)z.npseg * kPiece;
  w.rstart = w.ptot + z.pairs;
  w.cstart = w.rstart + s_cap + 1;
  return w;
}

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

// Row i of cor (its first 6 values): from the staged rows where it is one
template <typename T>
__device__ __forceinline__ const T* cor_row(const Args<T>& a, const T* scor, int ncor,
                                            long long i) {
  return i >= 0 && i < ncor ? scor + 6 * i : a.cor + 12 * i;
}

// Side k (0: side 1, 1: side 2) of factor m: c, its correction interpolated
// as wc::lerp_rows forms it (6 values), and pt, the side's point (side 1:
// opt1 ? (R(c) v1 + c_t) + p1 : v1; side 2: (R(c) v2 + c_t) + p2)
template <typename T>
__device__ __forceinline__ void side_point(const Args<T>& a, int m, int side, const T* scor,
                                           int ncor, T* c, T* pt) {
  const long long il = side ? a.i2l[m] : a.i1l[m], ir = side ? a.i2r[m] : a.i1r[m];
  const T f = side ? a.f2[m] : a.f1[m];
  const T *ra = cor_row(a, scor, ncor, il), *rb = cor_row(a, scor, ncor, ir);
  const T g = T(1) - f;
#pragma unroll
  for (int i = 0; i < 6; ++i) c[i] = ra[i] * g + rb[i] * f;
  const T* v = (side ? a.v2 : a.v1) + 3 * m;
  const T* p = (side ? a.p2 : a.p1) + 3 * m;
  T q[4], e[3];
  wc::exp_quat(c, q);
  wc::quat_rotate(q, v, e);
  const bool fixed = side == 0 && a.opt1[m] == 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    // each operation rounded as the plain version rounds it (metre-scale
    // positions whose difference is the residual)
    pt[i] = fixed ? v[i] : (e[i] + c[3 + i]) + p[i];
  }
}

// where(valid, w n . d, 0) with d = T1 - T2
template <typename T>
__device__ __forceinline__ T residual_of(const Args<T>& a, int m, const T* d) {
  const T* n = a.n + 3 * m;
  const T dot = ((n[0] * d[0]) + (n[1] * d[1])) + (n[2] * d[2]);
  return a.valid[m] != 0 ? (a.w[m] * dot) : T(0);
}

// Factor m's side `side` on one thread of a pair of neighbouring lanes (2i:
// side 1, 2i + 1: side 2, both of factor m; every lane must call it): the
// two swap their points for r, then each writes its side's Jacobian entries
// with the IRLS weight into the factor's record (side 1 also rs_w = r sw
// and f1, side 2 f2), unless rec is null.
template <typename T>
__device__ void surfel_eval_side(const Args<T>& a, int m, int side, const T* scor, int ncor,
                                 T* rec) {
  T c[6], pt[3], d[3];
  side_point(a, m, side, scor, ncor, c, pt);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T other = __shfl_xor_sync(0xffffffffu, pt[i], 1);
    d[i] = side == 0 ? pt[i] - other : other - pt[i];
  }
  if (rec == nullptr) return;
  const T r = residual_of(a, m, d);
  const T* n = a.n + 3 * m;
  const T w = a.w[m];
  const T wn[3] = {w * n[0], w * n[1], w * n[2]};
  const T* v = (side ? a.v2 : a.v1) + 3 * m;
  T jb[6];
  side_block(wn, v, c, side ? T(-1) : T(1), jb);
  const T f = side ? a.f2[m] : a.f1[m];
  const T opt1f = a.opt1[m] != 0 ? T(1) : T(0), vm = a.valid[m] != 0 ? T(1) : T(0);
  const T sw = T(1) / wc::wsqrt(T(1) + r * r / a.a2);
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    const T jk = k < 6 ? jb[k] : T(0);
    const T b = side == 0 ? jk * opt1f : jk;
    rec[12 * side + k] = (((b * (T(1) - f)) * vm) + ((b * f) * vm)) * sw;
  }
  if (side == 0) {
    rec[24] = r * sw;
    rec[25] = f;
  } else {
    rec[26] = f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kResThreads)
    surfel_factor_residuals(Args<T> a, T* __restrict__ r_out) {
  const int m = blockIdx.x * kResThreads + threadIdx.x;
  if (m >= a.m) return;
  T c[6], t1[3], t2[3], d[3];
  side_point(a, m, 0, a.cor, 0, c, t1);
  side_point(a, m, 1, a.cor, 0, c, t2);
#pragma unroll
  for (int i = 0; i < 3; ++i) d[i] = t1[i] - t2[i];
  r_out[m] = residual_of(a, m, d);
}

// A factor's two bracket indices, two 16-bit values an int (each clamped to
// [-2, S], which keeps every comparison with a row in [-1, S - 1])
__device__ __forceinline__ int pack2(long long lo, long long hi, int s_cap) {
  const int l = (int)(lo < -2 ? -2 : lo > s_cap ? s_cap : lo);
  const int h = (int)(hi < -2 ? -2 : hi > s_cap ? s_cap : hi);
  return (int)((unsigned)(l & 0xFFFF) | ((unsigned)(h & 0xFFFF) << 16));
}
__device__ __forceinline__ int lo16(int v) { return (int)(short)(v & 0xFFFF); }
__device__ __forceinline__ int hi16(int v) { return (int)(short)((unsigned)v >> 16); }

// v[0..12) to dst (16-byte aligned), 16 bytes a store
__device__ __forceinline__ void store12(float* dst, const float* v) {
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(v[0], v[1], v[2], v[3]);
  d[1] = make_float4(v[4], v[5], v[6], v[7]);
  d[2] = make_float4(v[8], v[9], v[10], v[11]);
}
__device__ __forceinline__ void store12(double* dst, const double* v) {
  double2* d = reinterpret_cast<double2*>(dst);
#pragma unroll
  for (int k = 0; k < 6; ++k) d[k] = make_double2(v[2 * k], v[2 * k + 1]);
}

// The pair of block rows (s, t), s <= t, has the index q (row-major over the
// upper triangle); pair_of is its inverse
__device__ __forceinline__ int pair_index(int s, int t, int s_cap) {
  return s * s_cap - s * (s - 1) / 2 + (t - s);
}
__device__ __forceinline__ void pair_of(int q, int s_cap, int* s, int* t) {
  int r = 0;
  while (q >= s_cap - r) q -= s_cap - r++;
  *s = r, *t = r + q;
}

// The last i in [0, n) with v[i] <= x (v non-decreasing, v[0] <= x)
__device__ __forceinline__ int last_at_most(const int* v, int n, int x) {
  int lo = 0, hi = n;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (v[mid] <= x) lo = mid; else hi = mid;
  }
  return lo;
}

// Keys k0 + k, k in [0, nk), of the segments' exclusive offsets e (a
// segment's nkeys + 1 offsets `stride` ints apart; with `counts`, its
// nkeys counts): tot[k] the entries of
// the key over all nseg segments, pre[k] over the segments before `cut`
// (either may be null). Warps take segments, lanes keys, kColumns keys of
// kRows segments a lane at once; partial holds 2 kWarps x 32 kColumns ints.
// Every thread of the block must call it.
constexpr int kColumns = 4, kRows = 8;
__device__ void column_sums(const int* e, int stride, bool counts, int nseg, int k0, int nk,
                            int cut, int* tot, int* pre, int* partial) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int kb = 0; kb < nk; kb += 32 * kColumns) {
    int t[kColumns], p[kColumns];
#pragma unroll
    for (int u = 0; u < kColumns; ++u) t[u] = p[u] = 0;
    for (int g0 = warp; g0 < nseg; g0 += kWarps * kRows) {
      int c[kRows][kColumns];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int g = g0 + r * kWarps;
        const int* eg = e + (size_t)g * stride + k0 + kb + lane;
#pragma unroll
        for (int u = 0; u < kColumns; ++u)
          c[r][u] = g < nseg && kb + lane + 32 * u < nk
                        ? (counts ? eg[32 * u] : eg[32 * u + 1] - eg[32 * u]) : 0;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int u = 0; u < kColumns; ++u) {
          t[u] += c[r][u];
          p[u] += g0 + r * kWarps < cut ? c[r][u] : 0;
        }
    }
#pragma unroll
    for (int u = 0; u < kColumns; ++u) {
      partial[(warp * kColumns + u) * 32 + lane] = t[u];
      partial[((kWarps + warp) * kColumns + u) * 32 + lane] = p[u];
    }
    __syncthreads();
    for (int v = threadIdx.x; v < 32 * kColumns; v += blockDim.x) {
      const int k = kb + v;  // column v: lane v % 32 of slot v / 32
      if (k >= nk) continue;
      const int u = v / 32, l = v % 32;
      int ts = 0, ps = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        ts += partial[(w * kColumns + u) * 32 + l];
        ps += partial[((kWarps + w) * kColumns + u) * 32 + l];
      }
      if (tot) tot[k] = ts;
      if (pre) pre[k] = ps;
    }
    __syncthreads();
  }
}

// The ng factors fidx[0..ng) (shared memory) staged: their records into
// staged (kRec values each), 16 bytes a copy, every copy of the warp in
// flight at once
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ work, const int* fidx, int ng,
                                      T* staged) {
  constexpr int kUnits = kRec * sizeof(T) / 16;  // a record's 16-byte pieces
  static_assert(kRec * sizeof(T) % 16 == 0, "records are copied 16 bytes at a time");
  for (int v = threadIdx.x & 31; v < ng * kUnits; v += 32)
    wc::copy_async16(reinterpret_cast<char*>(staged + (v / kUnits) * kRec) + 16 * (v % kUnits),
                     reinterpret_cast<const char*>(work + (size_t)fidx[v / kUnits] * kRec) +
                         16 * (v % kUnits));
  wc::copy_async_wait();
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    surfel_factor_normal(Args<T> a, const T* __restrict__ imu_bands, const T* __restrict__ gi,
                         const T* __restrict__ fm, T* __restrict__ h, T* __restrict__ g_out,
                         T* __restrict__ work, T* __restrict__ part, Ints w, int nseg, int npseg,
                         int pairs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, s_cap = a.s_cap, mm = a.m, n = 12 * s_cap;
  const int warp0 = blockIdx.x * kWarps + (tid >> 5), warps = gridDim.x * kWarps;
  cg::grid_group grid = cg::this_grid();

  // phase 0: a block a segment: its factors evaluated (two threads a
  // factor), keyed and sorted; the segment's pieces and offsets
  {
    const int ncor = min(s_cap, kCorRows);
    T* scor = reinterpret_cast<T*>(smem_raw);
    unsigned* keys = reinterpret_cast<unsigned*>(scor + 6 * ncor);
    int* win = reinterpret_cast<int*>(keys + kKeys);  // kWin pair offsets
    for (int i = tid; i < 6 * ncor; i += kThreads) scor[i] = a.cor[12 * (i / 6) + i % 6];
    __syncthreads();
    for (int g = blockIdx.x; g < nseg; g += gridDim.x) {
      const int f = tid >> 1, side = tid & 1, m = g * kSeg + f;
      const bool live = m < mm;
      const int me = live ? m : mm - 1;
      surfel_eval_side(a, me, side, scor, ncor, live ? work + (size_t)m * kRec : nullptr);
      unsigned k4[4] = {kNoKey, kNoKey, kNoKey, kNoKey};
      int nk = 0;
      if (live) {
        const long long l1 = a.i1l[m], l2 = a.i2l[m];
        const int p1 = pack2(l1, a.i1r[m], s_cap), p2 = pack2(l2, a.i2r[m], s_cap);
        if (side == 0) {  // the block rows s with i1l or i2l in {s - 1, s}
          w.packed[m] = make_int2(p1, p2);
          const long long c[4] = {l1, l1 + 1, l2, l2 + 1};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            bool fresh = c[u] >= 0 && c[u] < s_cap;
            for (int v = 0; v < u; ++v) fresh = fresh && c[v] != c[u];
            if (fresh) k4[nk++] = ((unsigned)c[u] << 7) | (unsigned)f;
          }
        } else if (m < a.nb) {  // the pairs s <= t: side 1 bracketed at one, side 2 at the other
          const int x[2] = {lo16(p1), hi16(p1)}, y[2] = {lo16(p2), hi16(p2)};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int xu = x[u >> 1], yu = y[u & 1];
            if (xu < 0 || xu >= s_cap || yu < 0 || yu >= s_cap) continue;
            const unsigned key =
                ((unsigned)(s_cap + pair_index(min(xu, yu), max(xu, yu), s_cap)) << 7) |
                (unsigned)f;
            bool fresh = true;
            for (int v = 0; v < nk; ++v) fresh = fresh && k4[v] != key;
            if (fresh) k4[nk++] = key;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) keys[4 * tid + u] = k4[u];
      __syncthreads();
      wc::block_sort<kKeys / (2 * kThreads)>(keys);
      const int nrow = wc::lower_bound(keys, kKeys, (unsigned)s_cap << 7);
      int* er = w.erow + (size_t)g * (s_cap + 1);
      for (int s = tid; s <= s_cap; s += kThreads) {
        const int lo = wc::lower_bound(keys, nrow, (unsigned)s << 7);
        er[s] = lo;
        if (s < s_cap)
          w.rcnt[(size_t)g * s_cap + s] = wc::lower_bound(keys, nrow, (unsigned)(s + 1) << 7) - lo;
      }
      for (int i = tid; i < nrow; i += kThreads)
        w.rpiece[(size_t)g * kPiece + i] = g * kSeg + (int)(keys[i] & 127u);
      if (g < npseg) {
        // the offsets kWin pairs at a time: each thread a run of them (a
        // search for its first, then a walk) into shared memory, then stored
        // coalesced
        const int npair = wc::lower_bound(keys, kKeys, kNoKey) - nrow;
        const unsigned* pk = keys + nrow;
        int* ep = w.epair + (size_t)g * (pairs + 1);
        for (int qw = 0; qw <= pairs; qw += kWin) {
          const int nq = min(kWin, pairs + 1 - qw), per = (nq + kThreads - 1) / kThreads;
          const int q0 = qw + tid * per, q1 = min(qw + nq, q0 + per);
          int pos = q0 < q1 ? wc::lower_bound(pk, npair, (unsigned)(s_cap + q0) << 7) : npair;
          for (int q = q0; q < q1; ++q) {
            while (pos < npair && pk[pos] < ((unsigned)(s_cap + q) << 7)) ++pos;
            win[q - qw] = pos;
          }
          __syncthreads();
          for (int i = tid; i < nq; i += kThreads) ep[qw + i] = win[i];
          __syncthreads();
        }
        for (int i = tid; i < npair; i += kThreads)
          w.ppiece[(size_t)g * kPiece + i] = g * kSeg + (int)(keys[nrow + i] & 127u);
      }
      __syncthreads();  // keys are rewritten by the block's next segment
    }
  }
  grid.sync();

  // phase 1: each segment's row entries placed after the earlier segments'
  // and the earlier rows'; the rows' starts and chunks (block 0); the
  // pairs' totals, a slice of the pairs a block
  {
    int* stot = reinterpret_cast<int*>(smem_raw);  // S + 1: row totals, then row starts
    int* spre = stot + s_cap + 1;                   // S: the earlier segments' entries
    int* sch = spre + s_cap;                        // S + 1: chunks a row, then first chunks
    int* er = sch + s_cap + 1;                      // S + 1: the segment's offsets
    int* partial = er + s_cap + 1;                  // 2 kWarps x 32 kColumns
    int* scratch = partial + 2 * kWarps * 32 * kColumns;  // kWarps
    for (int g = blockIdx.x; g < nseg || g == 0; g += gridDim.x) {
      column_sums(w.rcnt, s_cap, true, nseg, 0, s_cap, g, stot, spre, partial);
      for (int s = tid; s < s_cap; s += kThreads) sch[s] = (stot[s] + kChunk - 1) / kChunk;
      __syncthreads();
      const int rows = wc::block_exclusive_scan<kWarps>(stot, s_cap, scratch);
      const int chunks = wc::block_exclusive_scan<kWarps>(sch, s_cap, scratch);
      if (g == 0)
        for (int s = tid; s <= s_cap; s += kThreads) {
          w.rstart[s] = s < s_cap ? stot[s] : rows;
          w.cstart[s] = s < s_cap ? sch[s] : chunks;
        }
      if (g < nseg) {
        const int* erg = w.erow + (size_t)g * (s_cap + 1);
        for (int s = tid; s <= s_cap; s += kThreads) er[s] = erg[s];
        __syncthreads();
        for (int i = tid; i < er[s_cap]; i += kThreads) {
          const int s = last_at_most(er, s_cap, i);
          w.lists[stot[s] + spre[s] + (i - er[s])] = w.rpiece[(size_t)g * kPiece + i];
        }
      }
      __syncthreads();  // the arrays are rewritten by the block's next segment
    }
    const int blocks = gridDim.x, per = (pairs + blocks - 1) / blocks;
    const int q0 = min(pairs, (int)blockIdx.x * per);
    column_sums(w.epair, pairs + 1, false, npseg, q0, min(pairs, q0 + per) - q0, 0,
                w.ptot + q0, nullptr, partial);
  }
  grid.sync();

  // phase 2: the pairs without factors (flat); then a warp an item: the
  // rows' chunks, then the pairs that hold factors
  {
    // a thread a row's 12 entries in a block column bt, stored 16 bytes at a time
    for (int u = blockIdx.x * kThreads + tid; u < n * s_cap; u += gridDim.x * kThreads) {
      const int r = u / s_cap, bt = u % s_cap, bs = r / 12;
      const int s = min(bs, bt), t = max(bs, bt);
      if (w.ptot[pair_index(s, t, s_cap)] != 0) continue;
      T v[12];
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const int c = 12 * bt + j;
        v[j] = T(0) + T(0);  // d = A + B over no factors
        if (t - s > 2) {
          const int ra = bs <= bt ? r : c, cb = bs <= bt ? c : r;
          v[j] = ((T(0) + v[j]) * fm[ra]) * fm[cb];
        }
      }
      store12(h + (size_t)r * n + 12 * bt, v);
    }
    // a warp's slot: kS records, each factor's coefficients, flags, index
    // and packed brackets
    constexpr int kS = kStage<T>, kPer = kS / 32;  // factors a slot, a lane
    T* staged = reinterpret_cast<T*>(smem_raw) + (tid >> 5) * kS * (kRec + kCoef);
    T* coef = staged + kS * kRec;
    int* flags = reinterpret_cast<int*>(reinterpret_cast<T*>(smem_raw) +
                                        kWarps * kS * (kRec + kCoef)) + (tid >> 5) * 2 * kS;
    int* fidx = flags + kS;
    // a lane's entries of a 12 x 12 block: (e / 12, e % 12), e = lane + 32 u;
    // and of its upper triangle (the symmetric payloads), row-major
    int bi[kLane], bj[kLane], ti[kTri], tj[kTri];
#pragma unroll
    for (int u = 0; u < kLane; ++u) bi[u] = (lane + 32 * u) / 12, bj[u] = (lane + 32 * u) % 12;
#pragma unroll
    for (int u = 0; u < kTri; ++u) {
      int e = lane + 32 * u, r = 0;
      while (r < 12 && e >= 12 - r) e -= 12 - r++;
      ti[u] = r, tj[u] = r + e;
    }
    const int nch = w.cstart[s_cap];
    for (int it = warp0; it < nch + pairs; it += warps) {
      if (it < nch) {
        // chunk `it` of row s's list
        const int s = last_at_most(w.cstart, s_cap, it);
        const int* list = w.lists + w.rstart[s];
        const int b = (it - w.cstart[s]) * kChunk;
        const int e1 = min(w.rstart[s + 1] - w.rstart[s], b + kChunk);
        T acc[6][kTri];  // entry (ti, tj) of t11 c0..c2, t22 c0..c2: (tj, ti) is the same
#pragma unroll
        for (int k = 0; k < 6; ++k)
#pragma unroll
          for (int u = 0; u < kTri; ++u) acc[k][u] = T(0);
        T gacc = T(0);  // lanes 0-11 side 1, 12-23 side 2
        for (int g0 = b; g0 < e1; g0 += kS) {
          const int ng = min(kS, e1 - g0);
          int2 br[kPer];
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int jj = lane + 32 * u;
            if (jj < ng) {
              const int f = list[g0 + jj];
              fidx[jj] = f;
              br[u] = w.packed[f];
            }
          }
          __syncwarp();
          stage(work, fidx, ng, staged);
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int jj = lane + 32 * u;
            if (jj >= ng) continue;
            // the lane's factor: which sums it feeds, and their coefficients
            const T* r = staged + jj * kRec;
            const T f1 = r[25], f2 = r[26];
            const int i1l = lo16(br[u].x), i1r = hi16(br[u].x);
            const int i2l = lo16(br[u].y), i2r = hi16(br[u].y);
            // the diagonal payloads' coefficients, as the plain version forms them
            const T g1 = T(1) - f1, g2 = T(1) - f2;
            T* c = coef + jj * kCoef;
            c[0] = g1 * g1, c[1] = g1 * f1, c[2] = f1 * f1;
            c[3] = g2 * g2, c[4] = g2 * f2, c[5] = f2 * f2;
            c[6] = weight<T>(i1l, i1r, f1, s), c[7] = weight<T>(i2l, i2r, f2, s);
            flags[jj] = (fidx[jj] < a.nb && i1l == s ? 1 : 0) | (i2l == s ? 2 : 0) |
                        (i1l == s || i1l == s - 1 ? 4 : 0) | (i2l == s || i2l == s - 1 ? 8 : 0);
          }
          __syncwarp();
          for (int j = 0; j < ng; ++j) {
            const int fj = flags[j];
            const T* r = staged + j * kRec;
            const T* c = coef + j * kCoef;
            if (fj & 3) {
#pragma unroll
              for (int u = 0; u < kTri; ++u) {
                if (lane + 32 * u >= 78) continue;
                if (fj & 1) {
                  const T x = r[ti[u]] * r[tj[u]];
#pragma unroll
                  for (int k = 0; k < 3; ++k) acc[k][u] = acc[k][u] + (c[k] * x);
                }
                if (fj & 2) {
                  const T y = r[12 + ti[u]] * r[12 + tj[u]];
#pragma unroll
                  for (int k = 0; k < 3; ++k) acc[3 + k][u] = acc[3 + k][u] + (c[3 + k] * y);
                }
              }
            }
            if (lane < 24) {
              const bool two = lane >= 12;
              if (fj & (two ? 8 : 4))
                gacc = rfma(c[two ? 7 : 6], r[(two ? 12 : 0) + lane % 12] * r[24], gacc);
            }
          }
          __syncwarp();  // the slot is restaged by the next group
        }
        T* out = part + (size_t)it * kPart;
#pragma unroll
        for (int k = 0; k < 6; ++k)
#pragma unroll
          for (int u = 0; u < kTri; ++u) {
            if (lane + 32 * u >= 78) continue;
            out[144 * k + 12 * ti[u] + tj[u]] = acc[k][u];
            out[144 * k + 12 * tj[u] + ti[u]] = acc[k][u];
          }
        if (lane < 24) out[6 * 144 + lane] = gacc;
      } else {
        const int q = it - nch;
        if (w.ptot[q] == 0) continue;  // the flat pass wrote it
        int s, t;
        pair_of(q, s_cap, &s, &t);
        T A[kLane], B[kLane];
#pragma unroll
        for (int u = 0; u < kLane; ++u) A[u] = B[u] = T(0);
        // the pair's list: its run in each segment's piece, 32 segments at
        // a time, gathered and staged kS factors at a time
        for (int g0 = 0; g0 < npseg; g0 += 32) {
          int off = 0, cnt = 0;
          if (g0 + lane < npseg) {
            const int* e = w.epair + (size_t)(g0 + lane) * (pairs + 1) + q;
            off = e[0];
            cnt = e[1] - off;
          }
          int inc = cnt;  // inclusive scan over the lanes' segments
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, inc, d);
            if (lane >= d) inc += y;
          }
          const int total = __shfl_sync(0xffffffffu, inc, 31);
          for (int w0 = 0; w0 < total; w0 += kS) {
            const int ng = min(kS, total - w0);
            int2 br[kPer];
#pragma unroll
            for (int u = 0; u < kPer; ++u) {
              const int want = w0 + lane + 32 * u;
              int src = 0;  // the lane whose segment holds entry `want`: the first with inc > want
#pragma unroll
              for (int step = 16; step >= 1; step >>= 1)
                if (__shfl_sync(0xffffffffu, inc, src + step - 1) <= want) src += step;
              const int soff = __shfl_sync(0xffffffffu, off, src);
              const int sfirst = __shfl_sync(0xffffffffu, inc - cnt, src);
              if (want - w0 < ng) {
                const int f = w.ppiece[(size_t)(g0 + src) * kPiece + soff + (want - sfirst)];
                fidx[want - w0] = f;
                br[u] = w.packed[f];
              }
            }
            __syncwarp();
            stage(work, fidx, ng, staged);
#pragma unroll
            for (int u = 0; u < kPer; ++u) {
              const int jj = lane + 32 * u;
              if (jj >= ng) continue;
              // the lane's factor: D[(s,i),(t,j)] = b1(m,(s,i)) b2(m,(t,j)) where
              // side 1 is at s and side 2 at t (dst), D[(t,j),(s,i)] = b1(m,(t,j))
              // b2(m,(s,i)) where side 1 is at t and side 2 at s (dts); with one
              // of them its sides scaled in place by their weights
              T* r = staged + jj * kRec;
              const T f1 = r[25], f2 = r[26];
              const int i1l = lo16(br[u].x), i1r = hi16(br[u].x);
              const int i2l = lo16(br[u].y), i2r = hi16(br[u].y);
              const bool dst = (i1l == s || i1r == s) && (i2l == t || i2r == t);
              const bool dts = (i1l == t || i1r == t) && (i2l == s || i2r == s);
              const T w1s = weight<T>(i1l, i1r, f1, s), w2t = weight<T>(i2l, i2r, f2, t);
              const T w1t = weight<T>(i1l, i1r, f1, t), w2s = weight<T>(i2l, i2r, f2, s);
              if (dst != dts) {
                const T wa = dst ? w1s : w1t, wb = dst ? w2t : w2s;
                for (int k = 0; k < 12; ++k) r[k] = wa * r[k], r[12 + k] = wb * r[12 + k];
              } else {
                T* c = coef + jj * kCoef;
                c[0] = w1s, c[1] = w2t, c[2] = w1t, c[3] = w2s;
              }
              flags[jj] = (dst ? 1 : 0) | (dts ? 2 : 0);
            }
            __syncwarp();
            for (int j = 0; j < ng; ++j) {
              const int fj = flags[j];
              const T* r = staged + j * kRec;
              if (fj == 1) {  // (w1s j1v_i) (w2t j2v_j)
#pragma unroll
                for (int u = 0; u < kLane; ++u)
                  if (lane + 32 * u < 144) A[u] = rfma(r[bi[u]], r[12 + bj[u]], A[u]);
              } else if (fj == 2) {  // (w1t j1v_j) (w2s j2v_i)
#pragma unroll
                for (int u = 0; u < kLane; ++u)
                  if (lane + 32 * u < 144) B[u] = rfma(r[bj[u]], r[12 + bi[u]], B[u]);
              } else if (fj == 3) {
                const T* c = coef + j * kCoef;
#pragma unroll
                for (int u = 0; u < kLane; ++u) {
                  if (lane + 32 * u >= 144) continue;
                  A[u] = rfma(c[0] * r[bi[u]], c[1] * r[12 + bj[u]], A[u]);
                  B[u] = rfma(c[2] * r[bj[u]], c[3] * r[12 + bi[u]], B[u]);
                }
              }
            }
            __syncwarp();  // the slot is restaged by the next group
          }
        }
#pragma unroll
        for (int u = 0; u < kLane; ++u) {
          const int e = lane + 32 * u;
          if (e >= 144) continue;
          const int i = bi[u], j = bj[u];
          if (t == s && i > j) continue;
          const int ra = 12 * s + i, cb = 12 * t + j;
          T v = A[u] + B[u];
          if (t - s > 2) v = ((T(0) + v) * fm[ra]) * fm[cb];  // final: no band here
          h[(size_t)ra * n + cb] = v;
          h[(size_t)cb * n + ra] = v;
        }
      }
    }
  }
  grid.sync();

  // phase 3: a block an item, a block row s and kEb of its 144 entries e: a
  // thread a chain, the chunks' partial sums of one value added in order
  // (row s's t11 c0, t11 c1, t22 c0, t22 c1 and row s - 1's t11 c2, t22 c2
  // of entry e; in the row's first item also the 24 of g), then the band
  // blocks' entries e and g[s]
  {
    constexpr int kEb = 32, kItems = (144 + kEb - 1) / kEb, kIn = 16;
    T* sv = reinterpret_cast<T*>(smem_raw);     // 6 kEb chains, then g's 24
    for (int item = blockIdx.x; item < s_cap * kItems; item += gridDim.x) {
      const int s = item / kItems, e0 = (item % kItems) * kEb;
      const int c0 = w.cstart[s], c1 = w.cstart[s + 1], cp = s > 0 ? w.cstart[s - 1] : c0;
      int col = -1, from = 0, to = 0;
      if (tid < 6 * kEb && e0 + tid % kEb < 144) {
        const int slot = tid / kEb;  // sv's slots hold the payloads 0, 1, 3, 4, 2, 5
        const int k = slot < 2 ? slot : slot < 4 ? slot + 1 : slot == 4 ? 2 : 5;
        col = 144 * k + e0 + tid % kEb;
        from = k == 2 || k == 5 ? cp : c0;
        to = k == 2 || k == 5 ? c0 : c1;
      } else if (tid >= 6 * kEb && tid < 6 * kEb + 24 && e0 == 0) {
        col = 6 * 144 + tid - 6 * kEb;
        from = c0, to = c1;
      }
      T sum = T(0);
      for (int cb = from; cb < to; cb += kIn) {
        T y[kIn];
#pragma unroll
        for (int i = 0; i < kIn; ++i)
          y[i] = cb + i < to ? part[(size_t)(cb + i) * kPart + col] : T(0);
#pragma unroll
        for (int i = 0; i < kIn; ++i)
          if (cb + i < to) sum = sum + y[i];
      }
      if (col >= 0) sv[tid] = sum;
      __syncthreads();
      if (tid < 3 * kEb && e0 + tid % kEb < 144) {
        const int delta = tid / kEb, le = tid % kEb, e = e0 + le, i = e / 12, j = e % 12;
        const int t = s + delta;
        if (t < s_cap && !(delta == 0 && i > j)) {
          const int ra = 12 * s + i, cb = 12 * t + j;
          T band = imu_bands[((size_t)(delta + 2) * s_cap + s) * 144 + e];
          if (delta == 0)  // (t11 + t22)[s] c0 + (t11 + t22)[s - 1] c2
            band = band + ((sv[le] + sv[2 * kEb + le]) + (sv[4 * kEb + le] + sv[5 * kEb + le]));
          else if (delta == 1)  // (t11 + t22)[s] c1
            band = band + (sv[kEb + le] + sv[3 * kEb + le]);
          T x = band + h[(size_t)ra * n + cb];  // d, from phase 2
          x = (x * fm[ra]) * fm[cb];
          x = x + (ra == cb ? T(1) - fm[ra] : T(0));
          h[(size_t)ra * n + cb] = x;
          h[(size_t)cb * n + ra] = x;
        }
      }
      // g[s] = ((g1 + g2) + gi) fm
      if (e0 == 0 && tid < 12) {
        const int ra = 12 * s + tid;
        g_out[ra] = ((sv[6 * kEb + tid] + sv[6 * kEb + 12 + tid]) + gi[ra]) * fm[ra];
      }
      __syncthreads();  // sv is rewritten by the block's next item
    }
  }
}

// The normal-mode block's dynamic shared memory: the largest phase's
size_t normal_smem(int s_cap, int itemsize) {
  const size_t p0 =
      (size_t)itemsize * 6 * min(s_cap, kCorRows) + sizeof(unsigned) * kKeys + sizeof(int) * kWin;
  const size_t p1 = sizeof(int) * (4 * (size_t)s_cap + 3 + 2 * kWarps * 32 * kColumns + kWarps);
  const int ks = itemsize == 4 ? kStage<float> : kStage<double>;
  const size_t p2 = (size_t)itemsize * kWarps * ks * (kRec + kCoef) + sizeof(int) * kWarps * 2 * ks;
  const size_t p3 = (size_t)itemsize * (6 * 32 + 24);
  return std::max(std::max(p0, p1), std::max(p2, p3));
}

// resident blocks of the normal-mode kernel, per type and card, and the shared
// memory they were counted for (it grows with S)
int resident_cache[2][16];
size_t resident_smem[2][16];

template <typename T>
int launch(void* const* in, void* r_out, const void* imu_bands, const void* gi, const void* fm,
           void* h, void* g_out, void* work, void* iwork, int m, int nb, int s_cap, int normal,
           double a2, cudaStream_t st) {
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
  const Sizes z = sizes(m, nb, s_cap);
  const size_t smem = normal_smem(s_cap, sizeof(T));
  int resident = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 16 && resident_smem[sizeof(T) == 8][dev] != smem)
    resident_cache[sizeof(T) == 8][dev] = 0, resident_smem[sizeof(T) == 8][dev] = smem;
  err = wc::resident_blocks(surfel_factor_normal<T>, kThreads, smem, &resident,
                            resident_cache[sizeof(T) == 8]);
  if (err != cudaSuccess) return (int)err;
  // phase 0 takes a block a segment, phase 3 a block a fifth of a row,
  // phase 2 a warp an item (at most S + 4 M / kChunk chunks and the pairs)
  const long long items = (long long)s_cap + 4LL * m / kChunk + z.pairs;
  const long long need =
      std::max(std::max((long long)z.nseg, 5LL * s_cap), (items + kWarps - 1) / kWarps);
  const int grid = (int)std::min((long long)resident, need);
  err = wc::launch_cooperative(surfel_factor_normal<T>, dim3(grid), dim3(kThreads), smem, st, a,
                               static_cast<const T*>(imu_bands), static_cast<const T*>(gi),
                               static_cast<const T*>(fm), static_cast<T*>(h),
                               static_cast<T*>(g_out), static_cast<T*>(work),
                               static_cast<T*>(work) + (size_t)m * kRec,
                               carve(static_cast<int*>(iwork), m, z, s_cap), z.nseg, z.npseg,
                               z.pairs);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// in: the kInputs input pointers (valid, w, n, opt1, v1, p1, i1l, i1r, f1,
// v2, p2, i2l, i2r, f2, cor). Residual mode (normal = 0) writes r_out (M,);
// normal mode reads imu_bands (5, S, 12, 12), gi (S 12) and fm (S 12) and
// writes h (S 12, S 12) and g_out (S 12), with work (values: the factors'
// records, then the chunks' partial sums) and iwork (int32: the packed
// brackets, the segments' pieces and offsets, the rows' lists, the pairs'
// totals, the rows' starts and first chunks) as its workspace, of `values`
// and `ints` entries. threads, chunk, segment, values and ints are the
// wrapper's plan (ops/surfel_factor.py), checked against the kernel's build.
extern "C" int wc_surfel_factor(void* const* in, int n_in, void* r_out, const void* imu_bands,
                                const void* gi, const void* fm, void* h, void* g_out, void* work,
                                void* iwork, int m, int nb, int s_cap, int itemsize, int normal,
                                double a2, int threads, int chunk, int segment, long long values,
                                long long ints, void* stream) {
  if (n_in != kInputs || m < 0 || nb < 0 || nb > m || s_cap < 1 || s_cap > 4096 ||
      (itemsize != 4 && itemsize != 8) || m > (1 << 26))
    return (int)cudaErrorInvalidValue;
  if (normal) {
    const Sizes z = sizes(m, nb, s_cap);
    if (threads != kThreads || chunk != kChunk || segment != kSeg || values != z.values ||
        ints != z.ints)
      return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return itemsize == 4
             ? launch<float>(in, r_out, imu_bands, gi, fm, h, g_out, work, iwork, m, nb, s_cap,
                             normal, a2, st)
             : launch<double>(in, r_out, imu_bands, gi, fm, h, g_out, work, iwork, m, nb, s_cap,
                              normal, a2, st);
}
