// Kernel K7: surfel extraction, the counterpart of XLA's fusions of
// wildcat_slam_tpu/odometry/surfel.py:104-336 (extract_surfels: no Pallas
// kernel stands behind it). The plain version is
// ops/surfel_extract.py:extract_plain, which issues some 1,500-2,000 small
// kernels a sweep; here it is two launches around the library's level sorts.
//
//   surfel_keys      every level's voxel key of every point (voxel.split_keys,
//                    the invalid points pinned to 2^31 - 1, packed as
//                    hi 2^31 + lo); the wrapper then sorts each level stably
//                    (torch.sort, the one library call on K7's path).
//   surfel_extract   one cooperative launch (every block resident; grid
//                    barriers between its phases):
//     1  the segment starts (a key unlike its predecessor's) counted per
//        tile of kTile sorted points; the slot tables set to "absent" (P);
//        a warp a block of the blocked prefix (below): its points' 11
//        channels [w, q, sym6(q), t] (q about the point's cell centre), their
//        exclusive in-block prefix and the block's total;
//     2  the segment ids by a scan over the tiles, and each segment's first
//        position written at its id (direct compaction: the ids of the starts
//        ascend, so start[id] = i is _compact_positions' array without its
//        sort); slot v_cap is the sentinel, a segment's end is the next
//        segment's start; the parent levels' ids in input order; a block a
//        (level, channel) for the double-float scan of the block totals;
//     3  a thread a slot: the moments of its range, the count, mean,
//        covariance, its eigenvalues (eigh3.cuh), the strict plane test and
//        n > min_pts;
//     4  a thread a slot: the hierarchy. A child slot finds its parent slot
//        through its first point's input index; level 1 follows a big root,
//        deeper levels a big non-planar parent;
//     5  per point: its slot's candidacy, the time gaps, the cluster starts,
//        counted per tile;
//     6  the cluster ids by a scan and each cluster's first position at its id
//        (cut at nc; slot nc is the sentinel);
//     7  a thread a cluster: the moments of [start, max(min(next start,
//        segment end), start)), the eigenvalues and eigenvectors, the
//        non-strict plane test, n >= min_pts, the normal towards the origin;
//     8  the valid candidates (level-major, L nc of them) counted per tile,
//        then listed with their times, each tile's sorted by (t, index) in
//        shared memory (a bitonic sort: a run of the list); the invalid ones
//        written straight to their places after the valid ones (index
//        order), and n_dropped;
//     9  a warp a valid candidate, a lane a run: its place in the time order
//        is its place in its run plus, in each other run, the entries before
//        it (a binary search; an earlier run holds only smaller indices, so
//        its ties come first). O(n_valid (L nc / kTile) log kTile), where a
//        comparison of every pair would be O(n_valid^2); the first
//        min(cap, L nc) places are written.
//
// A range's moments are the plain version's (ops/dfsum.py df_prefix and
// df_range_sum, as the JAX package's ops/dfsum.py), in its order of
// operations: the sorted points cut into blocks of blk = min(128, the
// largest power of two dividing P); each block's exclusive prefix summed
// point by point (what the triangular matmul of ones sums on the card) and
// its total by four interleaved accumulators added in turn (torch.sum over
// the block on the card); the totals' double-float Hillis-Steele scan
// (dfsum.df_cumsum); a range [s, e) read as (hi[e/blk] - hi[s/blk]) +
// (lo[e/blk] - lo[s/blk]) + (inb(e) - inb(s)). Held to the plain version on
// the card, the moments come out bit-equal; a sum more accurate than it
// carried the float64 sweep off the JAX package's float64 record within 34
// sweeps (chip_smoke (l)'s gate), where the plain version stays 56.
// No float atomics, no order that depends on scheduling: the scans are
// integer or follow that fixed order. The result is the same on every run
// and in a graph.
// What bounds it is latency: ~10 dependent phases over ~200 K points, the
// gathers of the points through the sort's permutation and the eigh3 chains
// of the slots and clusters, not its ~6 MB of traffic.
//
// Built with -fmad=false (ops/_build.py, SOURCE_FLAGS): each product and sum
// rounds as the plain version's PyTorch operations do. A division by a
// host scalar is a product with its reciprocal, as PyTorch's CUDA kernels
// take it: floor(p / size) is floor(p * (1 / size)), 1 / size rounded in
// the working type.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "eigh3.cuh"
#include "lie.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256, kWarps = kThreads / 32, kPer = 4, kTile = kThreads * kPer;
constexpr int kMaxLevels = 8, kChan = 11, kCand = 14, kBlockMax = 128;
constexpr long long kBig = 2147483647LL;  // 2^31 - 1: the key of an invalid point
constexpr int kBias = 1 << 19;            // voxel.split_keys' bias (20 bits an axis)
// shared memory: a warp's block of channel values (kBlockMax x kChan; in
// phase 8 a tile's valid candidates, their times and indices, in its place),
// then a tile scan's counts and warp totals and a block sum's totals
constexpr int kSmemInts = kThreads + kWarps + kWarps + 1;
static_assert(sizeof(float) * kWarps * kBlockMax * kChan >= (sizeof(float) + sizeof(int)) * kTile,
              "a tile's candidates fit where the channel blocks were");
template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * kWarps * kBlockMax * kChan + sizeof(int) * kSmemInts;
}

// The workspace layout (int32 and values), as ops/surfel_extract.py:plan
// sizes it.
struct Layout {
  long long seg, sid_in, newc, start, flags, cand, cl_start, tiles_s, tiles_c, vtiles, cval,
      vlist, voff, totals, ints;
  long long inb, bph, bpl, sch, scl, cands, vt, values;
  int blk, nb, tiles_p, tiles_v, ncap;
};

Layout layout(int p, int v_cap, int nc, int cap, int levels) {
  Layout z;
  const long long lp = (long long)levels * p, lnc = (long long)levels * nc;
  z.blk = 1;
  while (z.blk < kBlockMax && p % (2 * z.blk) == 0) z.blk *= 2;
  z.nb = p / z.blk;
  z.tiles_p = (p + kTile - 1) / kTile;
  z.tiles_v = (int)((lnc + kTile - 1) / kTile);
  z.ncap = (int)(cap < lnc ? cap : lnc);
  long long o = 0;
  z.seg = o, o += lp;
  z.sid_in = o, o += (long long)(levels - 1) * p;
  z.newc = o, o += lp;
  z.start = o, o += (long long)levels * (v_cap + 1);
  z.flags = o, o += (long long)levels * v_cap;
  z.cand = o, o += (long long)levels * v_cap;
  z.cl_start = o, o += (long long)levels * (nc + 1);
  z.tiles_s = o, o += (long long)levels * z.tiles_p;
  z.tiles_c = o, o += (long long)levels * z.tiles_p;
  z.vtiles = o, o += z.tiles_v;
  z.cval = o, o += lnc;
  z.vlist = o, o += lnc;
  z.voff = o, o += z.tiles_v + 1;
  z.totals = o, o += 2 * levels;
  z.ints = o;
  // values: the in-block prefixes (L, P, kChan); the block prefixes, high
  // and low words (L, kChan, nb + 1) with the scan's second buffer (L,
  // kChan, nb); the candidates (L nc, kCand), the valid ones' times
  const long long lcb = (long long)levels * kChan * z.nb;
  z.inb = 0;
  z.bph = z.inb + lp * kChan;
  z.bpl = z.bph + lcb + (long long)levels * kChan;
  z.sch = z.bpl + lcb + (long long)levels * kChan;
  z.scl = z.sch + lcb;
  z.cands = z.scl + lcb;
  z.vt = z.cands + lnc * kCand;
  z.values = z.vt + lnc;
  return z;
}

template <typename T>
struct Params {
  const T* pts;
  const T* t;
  const long long* keys[kMaxLevels];  // each level's keys, sorted
  const long long* perm[kMaxLevels];  // the sort's permutation
  int* iw;
  T* cw;
  T *o_t, *o_center, *o_cov, *o_norm, *o_res, *o_std;
  unsigned char* o_valid;
  long long* o_dropped;
  Layout z;
  int p, v_cap, nc, cap, levels;
  T size[kMaxLevels], inv[kMaxLevels];
  T min_pts, thr, likeness, gap;
};

// a point's cell at one level
template <typename T>
__device__ __forceinline__ void cell_of(const T* q, T inv, int* cell) {
#pragma unroll
  for (int d = 0; d < 3; ++d) cell[d] = (int)floor(q[d] * inv);
}

// ---- moments: the plain version's blocked prefix of the 11 channels

// valid_s of sorted position k at level l: its hi key is not the pin (an
// invalid point's is)
template <typename T>
__device__ __forceinline__ bool valid_sorted(const Params<T>& a, int l, int k) {
  return (a.keys[l][k] >> 31) != kBig;
}

// sorted point k's channels at level l: [w, q, sym6(q), t] if it is valid,
// else zeros
template <typename T>
__device__ __forceinline__ void point_channels(const Params<T>& a, int l, int k, T* x) {
  if (!valid_sorted(a, l, k)) {
#pragma unroll
    for (int c = 0; c < kChan; ++c) x[c] = T(0);
    return;
  }
  const long long i = a.perm[l][k];
  const T* q = a.pts + 3 * i;
  int cell[3];
  cell_of(q, a.inv[l], cell);
  T d[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) d[c] = q[c] - ((T)cell[c] + T(0.5)) * a.size[l];
  x[0] = T(1), x[1] = d[0], x[2] = d[1], x[3] = d[2];
  x[4] = d[0] * d[0], x[5] = d[1] * d[1], x[6] = d[2] * d[2];
  x[7] = d[0] * d[1], x[8] = d[0] * d[2], x[9] = d[1] * d[2];
  x[10] = a.t[i];
}

// dfsum._combine: two double-float partial sums
template <typename T>
__device__ __forceinline__ void df_combine(T ph, T pl, T qh, T ql, T& hi, T& lo) {
  const T s = ph + qh;
  const T bb = s - ph;
  T e = (ph - (s - bb)) + (qh - bb);
  e = e + pl + ql;
  hi = s + e;
  lo = e - (hi - s);
}

// dfsum.df_range_sum of channel c over sorted positions [s, e) of level l
template <typename T>
__device__ __forceinline__ T range_sum(const Params<T>& a, int l, int c, int s, int e) {
  const Layout& z = a.z;
  const long long row = ((long long)l * kChan + c) * (z.nb + 1);
  const T* bh = a.cw + z.bph + row;
  const T* bl = a.cw + z.bpl + row;
  const T* inb = a.cw + z.inb + (long long)l * a.p * kChan + c;
  const int sb = s / z.blk, eb = e / z.blk;
  const T ve = inb[(long long)(e < a.p - 1 ? e : a.p - 1) * kChan];
  const T vs = inb[(long long)(s < a.p - 1 ? s : a.p - 1) * kChan];
  return (bh[eb] - bh[sb]) + (bl[eb] - bl[sb]) +
         ((e < a.p ? ve : ve * T(0)) - (s < a.p ? vs : vs * T(0)));
}

// count, mean and covariance (row-major 3 x 3) of the range [s, e) of level l
template <typename T>
__device__ __forceinline__ T range_moments(const Params<T>& a, int l, int s, int e, T* mean,
                                           T* cov, T& t_sum) {
  T m[kChan];
#pragma unroll
  for (int c = 0; c < kChan; ++c) m[c] = range_sum(a, l, c, s, e);
  const T n = m[0];
  const T n_safe = n < T(1) ? T(1) : n;
#pragma unroll
  for (int c = 0; c < 3; ++c) mean[c] = m[1 + c] / n_safe;
  const T xx = m[4] / n_safe - mean[0] * mean[0];
  const T yy = m[5] / n_safe - mean[1] * mean[1];
  const T zz = m[6] / n_safe - mean[2] * mean[2];
  const T xy = m[7] / n_safe - mean[0] * mean[1];
  const T xz = m[8] / n_safe - mean[0] * mean[2];
  const T yz = m[9] / n_safe - mean[1] * mean[2];
  cov[0] = xx, cov[1] = xy, cov[2] = xz;
  cov[3] = xy, cov[4] = yy, cov[5] = yz;
  cov[6] = xz, cov[7] = yz, cov[8] = zz;
  t_sum = m[10];
  return n;
}

// _plane_test on ascending eigenvalues
template <typename T>
__device__ __forceinline__ bool plane_test(const T* v, T thr, T likeness_min, bool strict) {
  const T s = v[0] + v[1] + v[2];
  const T likeness = T(2) * (v[1] - v[0]) / wc::clamp_min(s, wc::Finfo<T>::tiny);
  return strict ? (v[0] < thr && likeness > likeness_min)
                : (v[0] <= thr && likeness >= likeness_min);
}

// ---- block helpers (every thread of the block calls them)

__device__ __forceinline__ int block_sum(int x, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_down_sync(0xffffffffu, x, d);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += red[w];
    red[kWarps] = s;
  }
  __syncthreads();
  const int s = red[kWarps];
  __syncthreads();
  return s;
}

// the sum of cnt[0..n) by the block
__device__ __forceinline__ int block_sum_of(const int* cnt, int n, int* red) {
  int x = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) x += cnt[i];
  return block_sum(x, red);
}

// This thread's kPer consecutive flags of a tile: rank[u] becomes the number
// of flagged entries of the tile before entry u. Returns the tile's count.
__device__ __forceinline__ int tile_ranks(const bool* f, int* rank, int* sm) {
  int c = 0;
#pragma unroll
  for (int u = 0; u < kPer; ++u) rank[u] = c, c += f[u] ? 1 : 0;
  sm[threadIdx.x] = c;
  __syncthreads();
  const int total = wc::block_exclusive_scan<kWarps>(sm, kThreads, sm + kThreads);
  const int base = sm[threadIdx.x];
#pragma unroll
  for (int u = 0; u < kPer; ++u) rank[u] += base;
  __syncthreads();
  return total;
}

template <typename T>
__device__ __forceinline__ bool is_start(const Params<T>& a, int l, int k) {
  return k == 0 || a.keys[l][k] != a.keys[l][k - 1];
}

// candidate m's record to output place r
template <typename T>
__device__ __forceinline__ void write_out(const Params<T>& a, int r, long long m) {
  const T* rec = a.cw + a.z.cands + m * kCand;
  const int l = (int)(m / a.nc);
  a.o_t[r] = rec[0];
#pragma unroll
  for (int d = 0; d < 3; ++d) a.o_center[3 * r + d] = rec[1 + d], a.o_norm[3 * r + d] = rec[10 + d];
  // cov6 [xx yy zz xy xz yz] unpacked
  T* cv = a.o_cov + 9 * (long long)r;
  cv[0] = rec[4], cv[1] = rec[7], cv[2] = rec[8];
  cv[3] = rec[7], cv[4] = rec[5], cv[5] = rec[9];
  cv[6] = rec[8], cv[7] = rec[9], cv[8] = rec[6];
  a.o_std[r] = rec[13];
  a.o_res[r] = a.size[l];
  a.o_valid[r] = (unsigned char)(a.iw[a.z.cval + m] != 0);
}

// torch's order of floats (NaN last)
template <typename T>
__device__ __forceinline__ bool fless(T x, T y) {
  return x < y || (y != y && x == x);
}

// candidate (tx, mx) before (ty, my) in the time order: by t, then index;
// the padding of a sort (index kPad) last
constexpr int kPad = 0x7fffffff;
template <typename T>
__device__ __forceinline__ bool precedes(T tx, int mx, T ty, int my) {
  if (mx == kPad || my == kPad) return my == kPad && mx != kPad;
  return fless(tx, ty) || (!fless(ty, tx) && mx < my);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) surfel_keys(const T* pts, const unsigned char* valid,
                                                        long long* keys, int p, int levels,
                                                        Params<T> a) {
  const long long n = (long long)levels * p;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const int l = (int)(i / p), k = (int)(i % p);
    int cell[3];
    cell_of(pts + 3LL * k, a.inv[l], cell);
    // voxel.split_keys
    const unsigned c0 = (unsigned)cell[0] + kBias, c1 = (unsigned)cell[1] + kBias,
                   c2 = (unsigned)cell[2] + kBias;
    const long long hi = (int)((c0 << 10) | (unsigned)((int)c1 >> 10)),
                    lo = (int)(((c1 & 1023u) << 20) | c2);
    keys[i] = (valid[k] ? hi : kBig) * (1LL << 31) + (valid[k] ? lo : kBig);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) surfel_extract(Params<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem) + (threadIdx.x >> 5) * kBlockMax * kChan;
  int* sm = reinterpret_cast<int*>(smem + sizeof(T) * kWarps * kBlockMax * kChan);
  int* red = sm + kThreads + kWarps;
  cg::grid_group grid = cg::this_grid();
  const Layout& z = a.z;
  int* iw = a.iw;
  const int p = a.p, v_cap = a.v_cap, nc = a.nc, L = a.levels;
  const int tid = threadIdx.x, lane = tid & 31;
  const long long gtid = blockIdx.x * (long long)kThreads + tid,
                  gthreads = (long long)gridDim.x * kThreads;
  const int gwarp = (int)(gtid >> 5), nwarps = (int)(gthreads >> 5);
  const int tiles = L * z.tiles_p;

  // 1: the slot tables to "absent"; the segment starts counted per tile
  for (long long i = gtid; i < (long long)L * (v_cap + 1); i += gthreads) iw[z.start + i] = p;
  for (long long i = gtid; i < (long long)L * (nc + 1); i += gthreads) iw[z.cl_start + i] = p;
  for (int item = blockIdx.x; item < tiles; item += gridDim.x) {
    const int l = item / z.tiles_p, k0 = (item % z.tiles_p) * kTile + tid * kPer;
    int c = 0;
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      if (k0 + u < p) c += is_start(a, l, k0 + u) ? 1 : 0;
    c = block_sum(c, red);
    if (tid == 0) iw[z.tiles_s + item] = c;
  }
  // ... and a warp a block of blk points: the channels, their exclusive
  // in-block prefix (a lane a channel, point by point) and the block's total
  // (four interleaved accumulators, added in turn)
  for (int item = gwarp; item < L * z.nb; item += nwarps) {
    const int l = item / z.nb, b = item % z.nb, k0 = b * z.blk;
    for (int j = lane; j < z.blk; j += 32) point_channels(a, l, k0 + j, xs + j * kChan);
    __syncwarp();
    if (lane < kChan) {
      T* inb = a.cw + z.inb + ((long long)l * p + k0) * kChan + lane;
      T run = T(0), acc[4] = {T(0), T(0), T(0), T(0)};
      for (int j = 0; j < z.blk; ++j) {
        const T x = xs[j * kChan + lane];
        inb[(long long)j * kChan] = run;
        run = run + x;
        acc[j & 3] = acc[j & 3] + x;
      }
      const long long row = ((long long)l * kChan + lane) * (z.nb + 1) + b + 1;
      a.cw[z.bph + row] = acc[0] + acc[1] + acc[2] + acc[3];
      a.cw[z.bpl + row] = T(0);
    }
    __syncwarp();
  }
  grid.sync();

  // 2: segment ids, each segment's first position at its id (ids <= v_cap),
  // the parent levels' ids in input order; the valid segments' count
  for (int item = blockIdx.x; item < tiles; item += gridDim.x) {
    const int l = item / z.tiles_p, tile = item % z.tiles_p, k0 = tile * kTile + tid * kPer;
    const int off = block_sum_of(iw + z.tiles_s + l * z.tiles_p, tile, red);
    bool f[kPer];
    int rank[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) f[u] = k0 + u < p && is_start(a, l, k0 + u);
    tile_ranks(f, rank, sm);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int k = k0 + u;
      if (k >= p) break;
      const int sid = off + rank[u] + (f[u] ? 1 : 0) - 1;
      iw[z.seg + (long long)l * p + k] = sid;
      if (f[u] && sid <= v_cap) iw[z.start + (long long)l * (v_cap + 1) + sid] = k;
      if (l < L - 1) iw[z.sid_in + (long long)l * p + a.perm[l][k]] = sid;
      if (k == p - 1)  // the invalid points, if any, are the last segment
        iw[z.totals + l] = sid + 1 - (valid_sorted(a, l, k) ? 0 : 1);
    }
  }
  // ... and a block a (level, channel): dfsum.df_cumsum of the block totals,
  // Hillis-Steele, between the block prefix (from its entry 1) and a second
  // buffer; entry 0 is 0
  for (int item = blockIdx.x; item < L * kChan; item += gridDim.x) {
    T* h0 = a.cw + z.bph + (long long)item * (z.nb + 1) + 1;
    T* l0 = a.cw + z.bpl + (long long)item * (z.nb + 1) + 1;
    T *sh = h0, *sl = l0, *dh = a.cw + z.sch + (long long)item * z.nb,
      *dl = a.cw + z.scl + (long long)item * z.nb;
    for (int off = 1; off < z.nb; off <<= 1) {
      for (int i = tid; i < z.nb; i += kThreads) {
        if (i < off)
          dh[i] = sh[i], dl[i] = sl[i];
        else
          df_combine(sh[i - off], sl[i - off], sh[i], sl[i], dh[i], dl[i]);
      }
      __syncthreads();
      T* x = sh;
      sh = dh, dh = x, x = sl, sl = dl, dl = x;
    }
    if (sh != h0)
      for (int i = tid; i < z.nb; i += kThreads) h0[i] = sh[i], l0[i] = sl[i];
    if (tid == 0) h0[-1] = T(0), l0[-1] = T(0);
    __syncthreads();
  }
  grid.sync();

  // 3: a thread a slot: big (n > min_pts) and the strict plane test
  for (long long item = gtid; item < (long long)L * v_cap; item += gthreads) {
    const int l = (int)(item / v_cap), j = (int)(item % v_cap);
    const int* st = iw + z.start + (long long)l * (v_cap + 1);
    const int s = st[j];
    int fl = 0;
    if (s < p) {
      T mean[3], cov[9], t_sum;
      const T n = range_moments(a, l, s, st[j + 1], mean, cov, t_sum);
      if (n > a.min_pts) {
        T vals[3], vecs[9];
        wc::eigh3(cov, vals, vecs);
        fl = 1 | (plane_test(vals, a.thr, a.likeness, true) ? 2 : 0);
      }
    }
    iw[z.flags + item] = fl;
  }
  grid.sync();

  // 4: a thread a slot: fitted through the chain of parents, then candidacy
  for (long long item = gtid; item < (long long)L * v_cap; item += gthreads) {
    const int l = (int)(item / v_cap);
    const int fl = iw[z.flags + item];
    bool ok = fl & 1;
    int cl = l, cj = (int)(item % v_cap);
    while (ok && cl > 0) {
      const int s = iw[z.start + (long long)cl * (v_cap + 1) + cj];
      const long long i0 = a.perm[cl][s < p - 1 ? s : p - 1];
      const int ps = iw[z.sid_in + (long long)(cl - 1) * p + i0];
      if (ps >= v_cap) {
        ok = false;
        break;
      }
      const int pf = iw[z.flags + (long long)(cl - 1) * v_cap + ps];
      ok = (pf & 1) && (cl - 1 == 0 || !(pf & 2));
      cl -= 1, cj = ps;
    }
    iw[z.cand + item] = ok && (fl & 2);
  }
  grid.sync();

  // 5: the cluster starts per point, counted per tile
  for (int item = blockIdx.x; item < tiles; item += gridDim.x) {
    const int l = item / z.tiles_p, k0 = (item % z.tiles_p) * kTile + tid * kPer;
    int c = 0;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int k = k0 + u;
      if (k >= p) break;
      const int sid = iw[z.seg + (long long)l * p + k];
      bool nf = false;
      if (sid < v_cap && iw[z.cand + (long long)l * v_cap + sid] && valid_sorted(a, l, k)) {
        const long long* perm = a.perm[l];
        nf = k == 0 || is_start(a, l, k) || (a.t[perm[k]] - a.t[perm[k - 1]]) > a.gap;
      }
      iw[z.newc + (long long)l * p + k] = nf;
      c += nf ? 1 : 0;
    }
    c = block_sum(c, red);
    if (tid == 0) iw[z.tiles_c + item] = c;
  }
  grid.sync();

  // 6: cluster ids, each cluster's first position at its id (ids <= nc)
  for (int item = blockIdx.x; item < tiles; item += gridDim.x) {
    const int l = item / z.tiles_p, tile = item % z.tiles_p, k0 = tile * kTile + tid * kPer;
    const int off = block_sum_of(iw + z.tiles_c + l * z.tiles_p, tile, red);
    bool f[kPer];
    int rank[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) f[u] = k0 + u < p && iw[z.newc + (long long)l * p + k0 + u];
    const int total = tile_ranks(f, rank, sm);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int cid = off + rank[u];
      if (f[u] && cid <= nc) iw[z.cl_start + (long long)l * (nc + 1) + cid] = k0 + u;
    }
    if (tile == z.tiles_p - 1 && tid == 0) iw[z.totals + L + l] = off + total;
  }
  grid.sync();

  // 7: a thread a cluster: its surfel candidate
  for (long long item = gtid; item < (long long)L * nc; item += gthreads) {
    const int l = (int)(item / nc), c = (int)(item % nc);
    const int* cst = iw + z.cl_start + (long long)l * (nc + 1);
    const int s = cst[c];
    T* rec = a.cw + z.cands + item * kCand;
    if (s >= p) {
      for (int i = 0; i < kCand; ++i) rec[i] = T(0);
      iw[z.cval + item] = 0;
      continue;
    }
    const int sid = iw[z.seg + (long long)l * p + s];
    const int se = iw[z.start + (long long)l * (v_cap + 1) + sid + 1];
    const int nx = cst[c + 1];
    const int lim = nx < se ? nx : se;
    T mean[3], cov[9], vals[3], vecs[9], t_sum;
    const T n = range_moments(a, l, s, lim > s ? lim : s, mean, cov, t_sum);
    const T* q = a.pts + 3 * a.perm[l][s];
    int cell[3];
    cell_of(q, a.inv[l], cell);
    T center[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) center[d] = ((T)cell[d] + T(0.5)) * a.size[l] + mean[d];
    wc::eigh3(cov, vals, vecs);
    const bool keep = n >= a.min_pts && plane_test(vals, a.thr, a.likeness, false);
    T nrm[3] = {vecs[0], vecs[3], vecs[6]};
    if (nrm[0] * center[0] + nrm[1] * center[1] + nrm[2] * center[2] < T(0))
      nrm[0] = -nrm[0], nrm[1] = -nrm[1], nrm[2] = -nrm[2];
    const T n_safe = n < T(1) ? T(1) : n;
    rec[0] = t_sum / n_safe;
    rec[1] = center[0], rec[2] = center[1], rec[3] = center[2];
    rec[4] = cov[0], rec[5] = cov[4], rec[6] = cov[8];
    rec[7] = cov[1], rec[8] = cov[2], rec[9] = cov[5];
    rec[10] = nrm[0], rec[11] = nrm[1], rec[12] = nrm[2];
    rec[13] = wc::wsqrt(wc::clamp_min(vals[0], T(0)));
    iw[z.cval + item] = keep;
  }
  grid.sync();

  // 8a: the valid candidates counted per tile
  const int ncand = L * nc;
  for (int item = blockIdx.x; item < z.tiles_v; item += gridDim.x) {
    const int m0 = item * kTile + tid * kPer;
    int c = 0;
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      if (m0 + u < ncand) c += iw[z.cval + m0 + u] ? 1 : 0;
    c = block_sum(c, red);
    if (tid == 0) iw[z.vtiles + item] = c;
  }
  grid.sync();

  // 8b: the valid ones listed, each tile's sorted by (t, index) in shared
  // memory into a run of the list at its offset (voff); the invalid ones
  // straight to their places after them; n_dropped
  const int n_valid = block_sum_of(iw + z.vtiles, z.tiles_v, red);
  T* rt = reinterpret_cast<T*>(smem);             // the tile's valid candidates' times
  int* rm = reinterpret_cast<int*>(rt + kTile);   // ... and indices (kPad past the count)
  for (int item = blockIdx.x; item < z.tiles_v; item += gridDim.x) {
    const int m0 = item * kTile + tid * kPer;
    const int off = block_sum_of(iw + z.vtiles, item, red);
    bool f[kPer];
    int rank[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) f[u] = m0 + u < ncand && iw[z.cval + m0 + u];
    const int cnt = tile_ranks(f, rank, sm);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int m = m0 + u;
      if (m >= ncand) break;
      const int before = off + rank[u];  // valid candidates before m
      if (f[u]) {
        rt[rank[u]] = a.cw[z.cands + (long long)m * kCand];
        rm[rank[u]] = m;
      } else if (n_valid + (m - before) < z.ncap) {
        write_out(a, n_valid + (m - before), m);
      }
    }
    int n2 = 1;
    while (n2 < cnt) n2 <<= 1;
    for (int i = cnt + tid; i < n2; i += kThreads) rm[i] = kPad;
    __syncthreads();
    for (int k = 2; k <= n2; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < n2; i += kThreads) {
          const int x = i ^ j;
          if (x > i && ((i & k) == 0 ? precedes(rt[x], rm[x], rt[i], rm[i])
                                     : precedes(rt[i], rm[i], rt[x], rm[x]))) {
            const T tt = rt[i];
            const int mm = rm[i];
            rt[i] = rt[x], rm[i] = rm[x], rt[x] = tt, rm[x] = mm;
          }
        }
        __syncthreads();
      }
    for (int i = tid; i < cnt; i += kThreads) {
      iw[z.vlist + off + i] = rm[i];
      a.cw[z.vt + off + i] = rt[i];
    }
    if (tid == 0) iw[z.voff + item] = off;
    __syncthreads();
  }
  if (gtid == 0) {
    iw[z.voff + z.tiles_v] = n_valid;
    long long dropped = n_valid > a.cap ? n_valid - a.cap : 0;
    for (int l = 0; l < L; ++l) {
      const int segs = iw[z.totals + l], clusters = iw[z.totals + L + l];
      dropped += (segs > v_cap ? segs - v_cap : 0) + (clusters > nc ? clusters - nc : 0);
    }
    *a.o_dropped = dropped;
  }
  grid.sync();

  // 9: a warp a valid candidate (list place item, in run ri), a lane a run r:
  // the entries of r that come before it, by a binary search of r's times.
  // r < ri holds smaller indices (its equal times come first), r > ri larger;
  // in its own run, its place there.
  const T* vt = a.cw + z.vt;
  const int* voff = iw + z.voff;
  for (int item = gwarp; item < n_valid; item += nwarps) {
    const T ti = vt[item];
    int c = 0;
    for (int r = lane; r < z.tiles_v; r += 32) {
      const int o = voff[r], e = voff[r + 1];
      if (item >= o && item < e) {
        c += item - o;
        continue;
      }
      const bool earlier = item >= e;
      int lo = o, hi = e;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (earlier ? !fless(ti, vt[mid]) : fless(vt[mid], ti))
          lo = mid + 1;
        else
          hi = mid;
      }
      c += lo - o;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) c += __shfl_down_sync(0xffffffffu, c, d);
    if (lane == 0 && c < z.ncap) write_out(a, c, iw[z.vlist + item]);
  }
}

int g_resident[2][16];

template <typename T>
int launch(int mode, void* const* ptr, int n_ptr, int p, int v_cap, int nc, int cap, int levels,
           const double* reals, cudaStream_t st) {
  Params<T> a = {};
  a.p = p, a.v_cap = v_cap, a.nc = nc, a.cap = cap, a.levels = levels;
  for (int l = 0; l < levels; ++l) {
    a.size[l] = (T)reals[l];
    a.inv[l] = T(1) / a.size[l];
  }
  a.thr = (T)reals[levels], a.likeness = (T)reals[levels + 1], a.gap = (T)reals[levels + 2];
  a.min_pts = (T)reals[levels + 3];
  if (mode == 0) {  // pts, valid, keys (L, P)
    if (n_ptr != 3) return (int)cudaErrorInvalidValue;
    const long long n = (long long)levels * p;
    const int blocks = (int)((n + kThreads - 1) / kThreads < 4096 ? (n + kThreads - 1) / kThreads
                                                                     : 4096);
    surfel_keys<T><<<blocks, kThreads, 0, st>>>((const T*)ptr[0], (const unsigned char*)ptr[1],
                                                (long long*)ptr[2], p, levels, a);
    return (int)cudaGetLastError();
  }
  // pts, t, the sorted keys (which carry the validity) and the permutation
  // of each level, the two workspaces, then t, center, cov, norm,
  // resolution, std, valid, n_dropped
  if (n_ptr != 2 + 2 * levels + 2 + 8) return (int)cudaErrorInvalidValue;
  int i = 0;
  a.pts = (const T*)ptr[i++];
  a.t = (const T*)ptr[i++];
  for (int l = 0; l < levels; ++l) a.keys[l] = (const long long*)ptr[i++];
  for (int l = 0; l < levels; ++l) a.perm[l] = (const long long*)ptr[i++];
  a.iw = (int*)ptr[i++];
  a.cw = (T*)ptr[i++];
  a.o_t = (T*)ptr[i++], a.o_center = (T*)ptr[i++], a.o_cov = (T*)ptr[i++];
  a.o_norm = (T*)ptr[i++], a.o_res = (T*)ptr[i++], a.o_std = (T*)ptr[i++];
  a.o_valid = (unsigned char*)ptr[i++];
  a.o_dropped = (long long*)ptr[i++];
  a.z = layout(p, v_cap, nc, cap, levels);
  const size_t smem = smem_bytes<T>();
  int blocks = 0;
  cudaError_t e = wc::resident_blocks(surfel_extract<T>, kThreads, smem, &blocks,
                                      g_resident[sizeof(T) == 8]);
  if (e != cudaSuccess) return (int)e;
  e = wc::launch_cooperative(surfel_extract<T>, dim3(blocks), dim3(kThreads), smem, st, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// mode 0: the keys; mode 1: the cooperative pass. reals: the levels' voxel
// sizes, then the plane threshold, the plane likeness, the cluster time gap
// and min_points_per_plane. ints and values are the workspaces' lengths
// (ops/surfel_extract.py:plan), checked against the layout; tile is kTile.
extern "C" int wc_surfel_extract(int mode, void* const* ptr, int n_ptr, int p, int v_cap, int nc,
                                 int cap, int levels, const double* reals, int itemsize,
                                 int threads, int tile, long long ints, long long values,
                                 void* stream) {
  if ((mode != 0 && mode != 1) || p < 1 || v_cap < 1 || nc < 1 || cap < 1 || levels < 1 ||
      levels > kMaxLevels || (itemsize != 4 && itemsize != 8) || threads != kThreads ||
      tile != kTile || (long long)levels * nc * kCand >= (1LL << 31) ||
      (long long)levels * p >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const Layout z = layout(p, v_cap, nc, cap, levels);
  if (ints != z.ints || values != z.values) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return itemsize == 4 ? launch<float>(mode, ptr, n_ptr, p, v_cap, nc, cap, levels, reals, st)
                       : launch<double>(mode, ptr, n_ptr, p, v_cap, nc, cap, levels, reals, st);
}
