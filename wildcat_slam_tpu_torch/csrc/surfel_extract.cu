// Kernel K7: surfel extraction, the counterpart of XLA's fusions of
// wildcat_slam_tpu/odometry/surfel.py:104-336 (extract_surfels: no Pallas
// kernel stands behind it). The plain version is
// ops/surfel_extract.py:extract_plain, which issues some 1,500-2,000 small
// kernels a sweep; here it is one cooperative launch (every block resident;
// grid barriers between its phases), with its own sort of the voxel levels:
//
//   K  the slot tables set to "absent" (P); a block a chunk of the points
//      (kTile or more: at most kMaxChunks chunks): its valid points counted
//      and, at every level, the minimum and maximum of each of the key's
//      three 20-bit cell fields (voxel.split_keys' layout: x, y, z biased
//      by 2^19) over them;
//   B  every block: each level's key layout from the chunks' ranges (a
//      field less its minimum, the three side by side in as many bits as
//      their spans need; an invalid point the top value, above every valid
//      key) and the number of LSD passes of kDigitBits its width needs;
//      then a block a (level, chunk): the keys in input order, and the first
//      digit counted;
//   S  the passes (as many as the widest level needs; a level that needs
//      fewer sits out the rest), each: a block a (level, chunk) places its
//      points by digit (their digit's offset: the digit's count over all
//      the chunks, exclusive over the digits, plus its count in the earlier
//      chunks; then its rank in the chunk: within a warp by __match_any_sync
//      and __popc in lane order, the warps' counts added in warp order), a
//      grid barrier, then the next digit counted a chunk and a barrier. Stable
//      by construction: no atomics, no order that depends on scheduling.
//      Subtracting a field's minimum and narrowing it keeps the order of the
//      packed key hi 2^31 + lo, so for cells within voxel.split_keys' range
//      (|cell| < 2^19 on each axis) the permutation is torch.sort(stable)'s.
//      A level's last pass writes its sorted keys and permutation;
//   1  the segment starts (a key unlike its predecessor's) counted per tile
//      of kTile sorted points; a warp a block of the blocked prefix (below):
//      its points' 11 channels [w, q, sym6(q), t] (q about the point's cell
//      centre), their exclusive in-block prefix and the block's total;
//   2  the segment ids by a scan over the tiles, and each segment's first
//      position written at its id (direct compaction: the ids of the starts
//      ascend, so start[id] = i is _compact_positions' array without its
//      sort); slot v_cap is the sentinel, a segment's end is the next
//      segment's start; the parent levels' ids in input order; a block a
//      (level, channel) for the double-float scan of the block totals;
//   3  a thread a slot: the moments of its range, the count, mean,
//      covariance, its eigenvalues (eigh3.cuh), the strict plane test and
//      n > min_pts;
//   4  a thread a slot: the hierarchy. A child slot finds its parent slot
//      through its first point's input index; level 1 follows a big root,
//      deeper levels a big non-planar parent;
//   5  per point: its slot's candidacy, the time gaps, the cluster starts,
//      counted per tile;
//   6  the cluster ids by a scan and each cluster's first position at its id
//      (cut at nc; slot nc is the sentinel);
//   7  a thread a cluster: the moments of [start, max(min(next start,
//      segment end), start)), the eigenvalues and eigenvectors, the
//      non-strict plane test, n >= min_pts, the normal towards the origin;
//   8  the valid candidates (level-major, L nc of them) counted per tile,
//      then listed with their times, each tile's sorted by (t, index) in
//      shared memory (a bitonic sort: a run of the list); the invalid ones
//      written straight to their places after the valid ones (index
//      order), and n_dropped;
//   9  a warp a valid candidate, a lane a run: its place in the time order
//      is its place in its run plus, in each other run, the entries before
//      it (a binary search; an earlier run holds only smaller indices, so
//      its ties come first). O(n_valid (L nc / kTile) log kTile), where a
//      comparison of every pair would be O(n_valid^2); the first
//      min(cap, L nc) places are written.
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
// No atomics, no order that depends on scheduling: the scans are integer
// or follow that fixed order. The result is the same on every run and in a
// graph.
// What bounds it is latency: ~20 dependent phases over ~200 K points (the
// sort's passes among them), the gathers of the points through the sort's
// permutation and the eigh3 chains of the slots and clusters, not its few
// MB of traffic.
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

using u64 = unsigned long long;

constexpr int kThreads = 256, kWarps = kThreads / 32, kPer = 4, kTile = kThreads * kPer;
constexpr int kMaxLevels = 8, kChan = 11, kCand = 14, kBlockMax = 128;
constexpr int kBias = 1 << 19;                // voxel.split_keys' bias (20 bits an axis)
constexpr unsigned kField = (1u << 20) - 1;   // ... and its fields' mask
constexpr int kDigitBits = 8, kDigits = 1 << kDigitBits, kMaxChunks = 256;
static_assert(kDigits == kThreads, "the sort's scans take a thread a digit");
// shared memory: a warp's block of channel values (kBlockMax x kChan; in the
// sort the warps' digit counts and the digits' offsets, in phase 8 a tile's
// valid candidates, their times and indices, in its place), the levels' key
// layouts, then a tile scan's counts and warp totals and a block sum's totals
constexpr int kSmemInts = kThreads + kWarps + kWarps + 1;
constexpr int kSortInts = 2 * kWarps * kDigits + 2 * kDigits + kWarps;
static_assert(sizeof(float) * kWarps * kBlockMax * kChan >= (sizeof(float) + sizeof(int)) * kTile,
              "a tile's candidates fit where the channel blocks were");
static_assert(sizeof(float) * kWarps * kBlockMax * kChan >= sizeof(int) * kSortInts,
              "the sort's counts fit where the channel blocks were");
static_assert(kSmemInts >= 1 + 6 * kMaxLevels, "the levels' ranges fit the scan's counts");
static_assert(sizeof(float) * kWarps * kBlockMax * kChan >=
                  sizeof(int) * kWarps * (1 + 6 * kMaxLevels),
              "the warps' ranges fit where the channel blocks were");

// a level's key: the fields less their minima, field 0 shifted by sh0 and
// field 1 by sh1; an invalid point's key is top, above every valid one; the
// key's width takes `passes` LSD passes of kDigitBits (at least one)
struct LevelKey {
  u64 top;
  unsigned lo[3];
  int sh0, sh1, passes;
};

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * kWarps * kBlockMax * kChan + sizeof(LevelKey) * kMaxLevels +
         sizeof(int) * kSmemInts;
}

// The workspace layout (int32 and values), as ops/surfel_extract.py:plan
// sizes it.
struct Layout {
  long long key0, key1, keys, idx0, idx1, perm, hist, part, seg, sid_in, newc, start, flags,
      cand, cl_start, tiles_s, tiles_c, vtiles, cval, vlist, voff, totals, ints;
  long long inb, bph, bpl, sch, scl, cands, vt, values;
  int blk, nb, tiles_p, tiles_v, ncap, chunk, chunks;
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
  z.chunk = (p + kMaxChunks * kTile - 1) / (kMaxChunks * kTile) * kTile;
  z.chunks = (p + z.chunk - 1) / z.chunk;
  long long o = 0;
  // the sort: the digits' counts, a row of kDigits a (level, chunk), first
  // (16-byte aligned); 64-bit keys (two ints each) in input order and
  // ping-pong, and the sorted ones; the points' indices of the ping-pong and
  // the permutation; the chunks' valid counts and ranges (1 + 6 L each)
  z.hist = o, o += (long long)levels * z.chunks * kDigits;
  z.key0 = o, o += 2 * lp;
  z.key1 = o, o += 2 * lp;
  z.keys = o, o += 2 * lp;
  z.idx0 = o, o += lp;
  z.idx1 = o, o += lp;
  z.perm = o, o += lp;
  z.part = o, o += (long long)z.chunks * (1 + 6 * levels);
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
  const unsigned char* valid;
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

// a point's three key fields at one level: its cell biased by 2^19, 20 bits
// an axis (voxel.split_keys packs them as hi = f0 2^10 + f1 / 2^10, lo =
// (f1 mod 2^10) 2^20 + f2, so hi 2^31 + lo orders as (f0, f1, f2))
template <typename T>
__device__ __forceinline__ void key_fields(const T* q, T inv, unsigned* f) {
  int cell[3];
  cell_of(q, inv, cell);
#pragma unroll
  for (int d = 0; d < 3; ++d) f[d] = ((unsigned)cell[d] + kBias) & kField;
}

// point k's key at one level
template <typename T>
__device__ __forceinline__ u64 point_key(const Params<T>& a, const LevelKey& lk, int l, int k) {
  if (!a.valid[k]) return lk.top;
  unsigned f[3];
  key_fields(a.pts + 3LL * k, a.inv[l], f);
  return ((u64)(f[0] - lk.lo[0]) << lk.sh0) | ((u64)(f[1] - lk.lo[1]) << lk.sh1) |
         (u64)(f[2] - lk.lo[2]);
}

// level l's sorted keys and permutation (the sort's last pass wrote them)
template <typename T>
__device__ __forceinline__ const u64* sorted_keys(const Params<T>& a, int l) {
  return reinterpret_cast<const u64*>(a.iw + a.z.keys) + (long long)l * a.p;
}
template <typename T>
__device__ __forceinline__ const int* sorted_perm(const Params<T>& a, int l) {
  return a.iw + a.z.perm + (long long)l * a.p;
}

// ---- moments: the plain version's blocked prefix of the 11 channels

// valid_s of sorted position k at level l: its key is not the top (an
// invalid point's is)
template <typename T>
__device__ __forceinline__ bool valid_sorted(const Params<T>& a, const LevelKey* lk, int l,
                                             int k) {
  return sorted_keys(a, l)[k] != lk[l].top;
}

// sorted point k's channels at level l: [w, q, sym6(q), t] if it is valid,
// else zeros
template <typename T>
__device__ __forceinline__ void point_channels(const Params<T>& a, const LevelKey* lk, int l,
                                               int k, T* x) {
  if (!valid_sorted(a, lk, l, k)) {
#pragma unroll
    for (int c = 0; c < kChan; ++c) x[c] = T(0);
    return;
  }
  const long long i = sorted_perm(a, l)[k];
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
  const u64* keys = sorted_keys(a, l);
  return k == 0 || keys[k] != keys[k - 1];
}

// ---- the sort

// The sort's shared memory: the warps' counts of a round's digits (zero
// between rounds), their offsets, each digit's running offset and the
// digits' totals with their scan's warp totals.
struct SortSmem {
  int *wcnt, *pre, *run, *tot, *scan;
  __device__ explicit SortSmem(int* s)
      : wcnt(s), pre(s + kWarps * kDigits), run(s + 2 * kWarps * kDigits),
        tot(s + 2 * kWarps * kDigits + kDigits), scan(s + 2 * kWarps * kDigits + 2 * kDigits) {}
};

// One round of kThreads elements in thread order, this thread's with digit d
// (kDigits: none): its place among the elements of digit d, after run[d]
// (the earlier rounds' and the offset); run[d] moves past the round's. The
// warp's peers by __match_any_sync, their count before this lane by __popc;
// a thread a digit then adds the warps' counts in warp order. Two
// __syncthreads; wcnt is zero on entry and on return.
__device__ __forceinline__ int round_place(int d, const SortSmem& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned peers = __match_any_sync(0xffffffffu, d);
  const int before = __popc(peers & ((1u << lane) - 1u));
  if (d < kDigits && before == 0) s.wcnt[warp * kDigits + d] = __popc(peers);
  __syncthreads();
  int acc = s.run[threadIdx.x];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int i = w * kDigits + threadIdx.x;
    const int c = s.wcnt[i];
    s.wcnt[i] = 0;
    s.pre[i] = acc;
    acc += c;
  }
  s.run[threadIdx.x] = acc;
  __syncthreads();
  return d < kDigits ? s.pre[warp * kDigits + d] + before : 0;
}

// Each level's key layout from the chunks' valid counts and field ranges
// (every block computes the same, into lk); returns the most passes a level
// needs.
template <typename T>
__device__ __forceinline__ int level_keys(const Params<T>& a, LevelKey* lk, int* sm) {
  const Layout& z = a.z;
  const int L = a.levels, per = 1 + 6 * L, lane = threadIdx.x & 31;
  // a warp a value: the valid points' count (a sum), a field's minimum or
  // maximum over the chunks
  for (int j = threadIdx.x >> 5; j < per; j += kWarps) {
    const bool mx = j > 0 && (j - 1) % 2 == 1;
    unsigned v = j == 0 || mx ? 0u : 0xffffffffu;
#pragma unroll 4
    for (int c = lane; c < z.chunks; c += 32) {
      const unsigned x = (unsigned)a.iw[z.part + (long long)c * per + j];
      v = j == 0 ? v + x : (mx ? max(v, x) : min(v, x));
    }
    v = j == 0 ? __reduce_add_sync(0xffffffffu, v)
               : (mx ? __reduce_max_sync(0xffffffffu, v) : __reduce_min_sync(0xffffffffu, v));
    if (lane == 0) sm[j] = (int)v;
  }
  __syncthreads();
  if (threadIdx.x < L) {
    const int l = threadIdx.x, nv = sm[0];
    unsigned span[3];
    int w[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const unsigned lo = (unsigned)sm[1 + 6 * l + 2 * d], hi = (unsigned)sm[2 + 6 * l + 2 * d];
      lk[l].lo[d] = nv > 0 ? lo : 0u;
      span[d] = nv > 0 ? hi - lo : 0u;
      w[d] = 32 - __clz(span[d]);
    }
    lk[l].sh1 = w[2], lk[l].sh0 = w[1] + w[2];
    const u64 widest = ((u64)span[0] << lk[l].sh0) | ((u64)span[1] << lk[l].sh1) | span[2];
    lk[l].top = widest + 1;
    const int bits = 64 - __clzll(nv < a.p ? widest + 1 : widest);
    lk[l].passes = bits > kDigitBits ? (bits + kDigitBits - 1) / kDigitBits : 1;
  }
  __syncthreads();
  int passes = 0;
  for (int l = 0; l < L; ++l) passes = max(passes, lk[l].passes);
  return passes;
}

// Pass k's digits of level l's chunk c counted into hist (pass 0: the keys
// computed from the points and written in input order)
template <typename T>
__device__ __forceinline__ void count_chunk(const Params<T>& a, const LevelKey& lk, int l, int c,
                                            int k, const SortSmem& s) {
  const Layout& z = a.z;
  const int p = a.p, k0 = c * z.chunk, k1 = min(p, k0 + z.chunk), shift = k * kDigitBits;
  u64* key0 = reinterpret_cast<u64*>(a.iw + z.key0) + (long long)l * p;
  const u64* src = reinterpret_cast<const u64*>(a.iw + (k % 2 == 0 ? z.key0 : z.key1)) +
                   (long long)l * p;
  s.run[threadIdx.x] = 0;
  for (int t0 = k0; t0 < k1; t0 += kTile) {
    int dig[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = t0 + u * kThreads + threadIdx.x;
      dig[u] = kDigits;
      if (e < k1) {
        u64 key;
        if (k == 0)
          key = point_key(a, lk, l, e), key0[e] = key;
        else
          key = src[e];
        dig[u] = (int)((key >> shift) & (kDigits - 1));
      }
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) round_place(dig[u], s);
  }
  a.iw[z.hist + ((long long)l * z.chunks + c) * kDigits + threadIdx.x] = s.run[threadIdx.x];
}

// Pass k of level l's chunk c: its points placed by digit k (into the sorted
// keys and permutation on the level's last pass)
template <typename T>
__device__ __forceinline__ void place_chunk(const Params<T>& a, const LevelKey& lk, int l, int c,
                                            int k, const SortSmem& s) {
  const Layout& z = a.z;
  const int p = a.p, k0 = c * z.chunk, k1 = min(p, k0 + z.chunk), shift = k * kDigitBits;
  const bool last = k == lk.passes - 1;
  const long long lo = (long long)l * p;
  const u64* src = reinterpret_cast<const u64*>(a.iw + (k % 2 == 0 ? z.key0 : z.key1)) + lo;
  const int* isrc = a.iw + (k % 2 == 0 ? z.idx0 : z.idx1) + lo;
  u64* dst = reinterpret_cast<u64*>(a.iw + (last ? z.keys : k % 2 == 0 ? z.key1 : z.key0)) + lo;
  int* idst = a.iw + (last ? z.perm : k % 2 == 0 ? z.idx1 : z.idx0) + lo;
  // the digit's offset: its count over the level's chunks, exclusive over
  // the digits, plus its count in the chunks before c. A warp sums every
  // kWarps-th chunk's counts, a lane 8 digits (two 16-byte loads a chunk),
  // then a thread a digit adds the warps' sums (in the rounds' arrays: the
  // block's last item may still be reading them)
  __syncthreads();
  {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int4* h = reinterpret_cast<const int4*>(a.iw + z.hist) +
                    (long long)l * z.chunks * (kDigits / 4) + 2 * lane;
    int all[8] = {}, before[8] = {};
#pragma unroll 4
    for (int j = warp; j < z.chunks; j += kWarps) {
      const int4 x = h[(long long)j * (kDigits / 4)], y = h[(long long)j * (kDigits / 4) + 1];
      const int v[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) all[i] += v[i], before[i] += j < c ? v[i] : 0;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      s.pre[warp * kDigits + 8 * lane + i] = all[i],
          s.wcnt[warp * kDigits + 8 * lane + i] = before[i];
  }
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int i = w * kDigits + threadIdx.x;
    all += s.pre[i], before += s.wcnt[i];
    s.wcnt[i] = 0;
  }
  s.tot[threadIdx.x] = all;
  wc::block_exclusive_scan<kWarps>(s.tot, kDigits, s.scan);
  s.run[threadIdx.x] = s.tot[threadIdx.x] + before;
  for (int t0 = k0; t0 < k1; t0 += kTile) {
    u64 key[kPer];
    int idx[kPer], dig[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = t0 + u * kThreads + threadIdx.x;
      dig[u] = kDigits;
      if (e < k1) {
        key[u] = src[e];
        idx[u] = k == 0 ? e : isrc[e];
        dig[u] = (int)((key[u] >> shift) & (kDigits - 1));
      }
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int r = round_place(dig[u], s);
      if (dig[u] < kDigits) dst[r] = key[u], idst[r] = idx[u];
    }
  }
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
__global__ void __launch_bounds__(kThreads) surfel_extract(Params<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem) + (threadIdx.x >> 5) * kBlockMax * kChan;
  LevelKey* lk = reinterpret_cast<LevelKey*>(smem + sizeof(T) * kWarps * kBlockMax * kChan);
  int* sm = reinterpret_cast<int*>(lk + kMaxLevels);
  int* red = sm + kThreads + kWarps;
  const SortSmem ss(reinterpret_cast<int*>(smem));
  cg::grid_group grid = cg::this_grid();
  const Layout& z = a.z;
  int* iw = a.iw;
  const int p = a.p, v_cap = a.v_cap, nc = a.nc, L = a.levels;
  const int tid = threadIdx.x, lane = tid & 31;
  const long long gtid = blockIdx.x * (long long)kThreads + tid,
                  gthreads = (long long)gridDim.x * kThreads;
  const int gwarp = (int)(gtid >> 5), nwarps = (int)(gthreads >> 5);
  const int tiles = L * z.tiles_p;

  // K: the slot tables to "absent"; a block a chunk: its valid points
  // counted, each level's key fields' minima and maxima over them
  for (long long i = gtid; i < (long long)L * (v_cap + 1); i += gthreads) iw[z.start + i] = p;
  for (long long i = gtid; i < (long long)L * (nc + 1); i += gthreads) iw[z.cl_start + i] = p;
  int* wred = reinterpret_cast<int*>(smem);  // the warps' counts and bounds (kWarps x per)
  for (int c = blockIdx.x; c < z.chunks; c += gridDim.x) {
    const int k0 = c * z.chunk, k1 = min(p, k0 + z.chunk), per = 1 + 6 * L;
    unsigned nv = 0, lo[kMaxLevels][3], hi[kMaxLevels][3];
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l)
#pragma unroll
      for (int d = 0; d < 3; ++d) lo[l][d] = 0xffffffffu, hi[l][d] = 0u;
#pragma unroll 4
    for (int k = k0 + tid; k < k1; k += kThreads)
      if (a.valid[k]) {
        const T* q = a.pts + 3LL * k;
        const T x[3] = {q[0], q[1], q[2]};
        nv += 1;
#pragma unroll
        for (int l = 0; l < kMaxLevels; ++l)
          if (l < L) {
            unsigned f[3];
            key_fields(x, a.inv[l], f);
#pragma unroll
            for (int d = 0; d < 3; ++d)
              lo[l][d] = min(lo[l][d], f[d]), hi[l][d] = max(hi[l][d], f[d]);
          }
      }
    // the warp's count, minima and maxima (part's order), then the block's
    // over the warps in warp order
    const int w0 = (tid >> 5) * per;
    nv = __reduce_add_sync(0xffffffffu, nv);
    if (lane == 0) wred[w0] = (int)nv;
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l)
      if (l < L)
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const unsigned m = __reduce_min_sync(0xffffffffu, lo[l][d]),
                         M = __reduce_max_sync(0xffffffffu, hi[l][d]);
          if (lane == 0)
            wred[w0 + 1 + 6 * l + 2 * d] = (int)m, wred[w0 + 2 + 6 * l + 2 * d] = (int)M;
        }
    __syncthreads();
    for (int j = tid; j < per; j += kThreads) {
      unsigned v = (unsigned)wred[j];
      for (int w = 1; w < kWarps; ++w) {
        const unsigned y = (unsigned)wred[w * per + j];
        v = j == 0 ? v + y : ((j - 1) % 2 == 0 ? min(v, y) : max(v, y));
      }
      iw[z.part + (long long)c * per + j] = (int)v;
    }
    __syncthreads();
  }
  grid.sync();

  // B: the levels' key layouts; a block a (level, chunk): its keys in input
  // order, their first digit counted
  const int passes = level_keys(a, lk, sm);
  for (int i = tid; i < kWarps * kDigits; i += kThreads) ss.wcnt[i] = 0;
  __syncthreads();
  for (int item = blockIdx.x; item < L * z.chunks; item += gridDim.x)
    count_chunk(a, lk[item / z.chunks], item / z.chunks, item % z.chunks, 0, ss);
  grid.sync();

  for (int k = 0; k < passes; ++k) {
    if (k > 0) {
      // sort, pass k: the digits counted a chunk
      for (int item = blockIdx.x; item < L * z.chunks; item += gridDim.x)
        if (k < lk[item / z.chunks].passes)
          count_chunk(a, lk[item / z.chunks], item / z.chunks, item % z.chunks, k, ss);
      grid.sync();
    }
    // sort, pass k: the points placed by their digit
    for (int item = blockIdx.x; item < L * z.chunks; item += gridDim.x)
      if (k < lk[item / z.chunks].passes)
        place_chunk(a, lk[item / z.chunks], item / z.chunks, item % z.chunks, k, ss);
    grid.sync();
  }

  // 1: the segment starts counted per tile
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
#pragma unroll 4
    for (int j = lane; j < z.blk; j += 32) point_channels(a, lk, l, k0 + j, xs + j * kChan);
    __syncwarp();
    if (lane < kChan) {
      T* inb = a.cw + z.inb + ((long long)l * p + k0) * kChan + lane;
      T run = T(0), acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll 8
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
      if (l < L - 1) iw[z.sid_in + (long long)l * p + sorted_perm(a, l)[k]] = sid;
      if (k == p - 1)  // the invalid points, if any, are the last segment
        iw[z.totals + l] = sid + 1 - (valid_sorted(a, lk, l, k) ? 0 : 1);
    }
  }
  // ... and a block a (level, channel), from the last block down (the first
  // ones hold the tiles above): dfsum.df_cumsum of the block totals,
  // Hillis-Steele, between the block prefix (from its entry 1) and a second
  // buffer, in shared memory where the four arrays fit; entry 0 is 0
  for (int item = gridDim.x - 1 - blockIdx.x; item >= 0 && item < L * kChan; item += gridDim.x) {
    T* h0 = a.cw + z.bph + (long long)item * (z.nb + 1) + 1;
    T* l0 = a.cw + z.bpl + (long long)item * (z.nb + 1) + 1;
    const bool fits = 4 * z.nb <= kWarps * kBlockMax * kChan;
    T* buf = reinterpret_cast<T*>(smem);
    T *sh = fits ? buf : h0, *sl = fits ? buf + z.nb : l0,
      *dh = fits ? buf + 2 * z.nb : a.cw + z.sch + (long long)item * z.nb,
      *dl = fits ? buf + 3 * z.nb : a.cw + z.scl + (long long)item * z.nb;
    if (fits) {
      for (int i = tid; i < z.nb; i += kThreads) sh[i] = h0[i], sl[i] = l0[i];
      __syncthreads();
    }
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
      const int i0 = sorted_perm(a, cl)[s < p - 1 ? s : p - 1];
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
      if (sid < v_cap && iw[z.cand + (long long)l * v_cap + sid] && valid_sorted(a, lk, l, k)) {
        const int* perm = sorted_perm(a, l);
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
    const T* q = a.pts + 3LL * sorted_perm(a, l)[s];
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
int launch(void* const* ptr, int n_ptr, int p, int v_cap, int nc, int cap, int levels,
           const double* reals, cudaStream_t st) {
  // pts, t, valid, the two workspaces, then t, center, cov, norm,
  // resolution, std, valid, n_dropped
  if (n_ptr != 13) return (int)cudaErrorInvalidValue;
  Params<T> a = {};
  a.p = p, a.v_cap = v_cap, a.nc = nc, a.cap = cap, a.levels = levels;
  for (int l = 0; l < levels; ++l) {
    a.size[l] = (T)reals[l];
    a.inv[l] = T(1) / a.size[l];
  }
  a.thr = (T)reals[levels], a.likeness = (T)reals[levels + 1], a.gap = (T)reals[levels + 2];
  a.min_pts = (T)reals[levels + 3];
  int i = 0;
  a.pts = (const T*)ptr[i++];
  a.t = (const T*)ptr[i++];
  a.valid = (const unsigned char*)ptr[i++];
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

// One launch of K7. reals: the levels' voxel sizes, then the plane
// threshold, the plane likeness, the cluster time gap and
// min_points_per_plane. ints and values are the workspaces' lengths
// (ops/surfel_extract.py:plan), checked against the layout; tile is kTile.
extern "C" int wc_surfel_extract(void* const* ptr, int n_ptr, int p, int v_cap, int nc, int cap,
                                 int levels, const double* reals, int itemsize, int threads,
                                 int tile, long long ints, long long values, void* stream) {
  if (p < 1 || v_cap < 1 || nc < 1 || cap < 1 || levels < 1 || levels > kMaxLevels ||
      (itemsize != 4 && itemsize != 8) || threads != kThreads || tile != kTile ||
      (long long)levels * nc * kCand >= (1LL << 31) || (long long)levels * p >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const Layout z = layout(p, v_cap, nc, cap, levels);
  if (ints != z.ints || values != z.values) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return itemsize == 4 ? launch<float>(ptr, n_ptr, p, v_cap, nc, cap, levels, reals, st)
                       : launch<double>(ptr, n_ptr, p, v_cap, nc, cap, levels, reals, st);
}
