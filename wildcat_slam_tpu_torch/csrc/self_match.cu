// The self-match fixed point of the surfel matcher (kernel K3), in one launch.
//
// Replaces: the lax.while_loop of wildcat_slam_tpu/odometry/match.py
// (match_surfels with self_match=True: fp_body, fp_cond), which the JAX
// package runs on the device; no Pallas kernel stands behind it. The port's
// plain version is ops/self_match.py's self_match_plain, one host sync a
// round. Given each query's k candidates cand (Q, k) and their acceptance
// mask ok (Q, k), every round recomputes, for all queries at once, the first
// accepted candidate that is not blocked, where rank r of query q is blocked
// when its candidate c = cand[q, r] satisfies 0 <= c < q and partner[c] == q
// (the pull form that match.py states as the definition). It stops when no
// partner changes, or after max_rounds rounds, as fp_cond does, and leaves
// partner (Q,) with -1 for none and the rounds it ran.
//
// What bounds it on an H100: latency, not bytes or operations. The inputs are
// Q k (8 + 1) bytes (0.74 MB at Q = 8192, k = 10) and a round does ~Q compares,
// but each round depends on the one before, so the rounds run in one block,
// where the barrier between them is __syncthreads().
//
// Design: one block of 1024 threads; thread i owns queries i, i + 1024, ...
// Before round 1 the block reads cand and ok once, in memory order (a warp
// reads consecutive addresses; none depends on partner), and each thread
// keeps of its queries' rows only what a round can use: the accepted
// candidates c with 0 <= c < q, in rank order, up to the first accepted
// candidate that no partner can block, which ends the list (its full value
// goes to the output; a query whose list it ends takes it). The lists are
// 16-bit, slot j of query q at lists[j ls + q] (ls = Q padded, list_stride),
// in shared memory when 2 (k + 1) ls bytes fit beside the partners (Q = 8192,
// k = 10: 208 KB in all), else in a global scratch (ops/self_match.py, plan). partner lives in shared memory as
// 16-bit values, double-buffered: a round reads the old array and writes the
// new one, so it has one barrier (__syncthreads_or of whether any partner
// changed), no atomics and no bitmap. A query's round walks its list: the
// first entry c whose partner[c] is not q, or the last entry, is its new
// partner -- one LDS of the list and one of partner for most queries. The
// values are integers, so the result equals the plain version's bit for
// bit, rounds included.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr unsigned short kNone = 0xFFFFu;  // no partner, or one outside [0, Q)
constexpr unsigned short kSkip = 0xFFFEu;  // a rank that is not accepted (a slot, before B)
constexpr int kMaxQueries = 0xFFFE;        // a query index stays below kSkip

// The row stride of the lists, in 16-bit slots: Q rounded up to 64, plus 2,
// so that slot r of consecutive queries and rank r + 1 of the same query
// fall in other shared-memory banks (ops/self_match.py, list_stride).
__host__ __device__ constexpr int list_stride(int nq) { return (nq + 63) / 64 * 64 + 2; }

template <bool kSharedLists>
__global__ void __launch_bounds__(kThreads, 1)
    self_match_kernel(const long long* __restrict__ cand, const unsigned char* __restrict__ ok,
                      long long* __restrict__ partner_out, int* __restrict__ rounds_out,
                      unsigned short* __restrict__ lists_global, int nq, int k, int max_rounds) {
  extern __shared__ __align__(16) unsigned short smem[];
  unsigned short* cur = smem;        // partner, read this round
  unsigned short* nxt = smem + nq;   // partner, written this round
  unsigned short* lists = kSharedLists ? smem + 2 * nq : lists_global;
  const int tid = threadIdx.x;
  const int ls = list_stride(nq);

  // each query's list, once. A: every (query, rank) in memory order, so a
  // warp reads consecutive addresses, classed into its slot: not accepted,
  // blockable (0 <= c < q: c itself) or ending (c in [q, Q): c; else kNone)
  const int total = nq * k, step_q = kThreads / k, step_r = kThreads % k;
  for (int e = tid, q = tid / k, r = tid % k; e < total; e += kThreads) {
    const long long c = cand[e];
    unsigned short v = kSkip;
    if (ok[e]) v = c >= 0 && c < nq ? (unsigned short)c : kNone;
    lists[(size_t)r * ls + q] = v;
    q += step_q;  // (q, r) of e + kThreads
    r += step_r;
    if (r >= k) {
      r -= k;
      ++q;
    }
  }
  __syncthreads();
  // B: each owned query's slots compacted in place, up to the ending entry,
  // whose full value goes to the output (-1 when there is none)
  for (int q = tid; q < nq; q += kThreads) {
    int len = 0, end = -1;
    for (int r = 0; r < k; ++r) {
      const unsigned short v = lists[(size_t)r * ls + q];
      if (v == kSkip) continue;
      if (v < q) {
        lists[(size_t)len++ * ls + q] = v;
      } else {
        end = r;
        break;
      }
    }
    const unsigned short last = end < 0 ? kNone : lists[(size_t)end * ls + q];
    lists[(size_t)len * ls + q] = last;
    partner_out[q] = end < 0 ? -1 : last != kNone ? (long long)last : cand[(size_t)q * k + end];
    cur[q] = kNone;
  }
  __syncthreads();

  int rounds = 0;
  bool changed = true;
  while (changed && rounds < max_rounds) {
    int any = 0;
    for (int q = tid; q < nq; q += kThreads) {
      // entries below q are blocked when their partner is q; the last is >= q
      const unsigned short* slot = lists + q;
      unsigned short c = *slot;
      while (c < q && cur[c] == q) {
        slot += ls;
        c = *slot;
      }
      nxt[q] = c;
      any |= c != cur[q];
    }
    ++rounds;
    changed = __syncthreads_or(any) != 0;
    unsigned short* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int q = tid; q < nq; q += kThreads) {
    if (rounds == 0) {
      partner_out[q] = -1;
    } else if (cur[q] != kNone) {
      partner_out[q] = cur[q];
    }  // else the list's ending entry, already there
  }
  if (tid == 0) *rounds_out = rounds;
}

template <bool kSharedLists>
int launch(const long long* cand, const unsigned char* ok, long long* partner, int* rounds,
           unsigned short* lists, int nq, int k, int max_rounds, int smem_bytes,
           cudaStream_t stream) {
  // the opt-in above 48 KB, set once per device and size (it costs more host
  // time than the launch); the caller makes the tensors' card current
  constexpr int kCachedDevices = 64;
  static thread_local int cached_smem[kCachedDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (!(dev < kCachedDevices && cached_smem[dev] >= smem_bytes)) {
    int optin = 0;
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (smem_bytes > optin) return (int)cudaErrorInvalidConfiguration;
    e = cudaFuncSetAttribute(self_match_kernel<kSharedLists>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
    if (dev < kCachedDevices) cached_smem[dev] = smem_bytes;
  }
  self_match_kernel<kSharedLists><<<1, kThreads, (size_t)smem_bytes, stream>>>(
      cand, ok, partner, rounds, lists, nq, k, max_rounds);
  return (int)cudaGetLastError();
}

}  // namespace

// cand (nq, k) int64, ok (nq, k) bool (one byte each), partner (nq,) int64,
// rounds (1,) int32 -- device, contiguous. threads, smem_bytes and
// shared_lists are ops/self_match.py's plan: kThreads, and 4 nq bytes for
// the two partner buffers plus, when shared_lists, 2 (k + 1) list_stride(nq)
// for the lists; otherwise lists is a global scratch of (k + 1)
// list_stride(nq) 16-bit values.
// Returns a cudaError_t code (0 on success).
extern "C" int wc_self_match(const long long* cand, const unsigned char* ok, long long* partner,
                             int* rounds, void* lists, int nq, int k, int max_rounds, int threads,
                             int smem_bytes, int shared_lists, void* stream) {
  if (nq < 1 || nq > kMaxQueries || k < 1 || (long long)nq * (k + 1) > (1LL << 30) ||
      max_rounds < 0 || threads != kThreads)
    return (int)cudaErrorInvalidValue;
  const long long need = 4LL * nq + (shared_lists ? 2LL * list_stride(nq) * (k + 1) : 0);
  if ((long long)smem_bytes != need || (!shared_lists && lists == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<unsigned short*>(lists);
  return shared_lists
             ? launch<true>(cand, ok, partner, rounds, nullptr, nq, k, max_rounds, smem_bytes, st)
             : launch<false>(cand, ok, partner, rounds, l, nq, k, max_rounds, smem_bytes, st);
}
