// The self-match fixed point of the surfel matcher (kernel K3), in one launch.
//
// Replaces: the lax.while_loop of wildcat_slam_tpu/odometry/match.py
// (match_surfels with self_match=True: fp_body, fp_cond), which the JAX
// package runs on the device; no Pallas kernel stands behind it. The port's
// plain version is ops/self_match.py's self_match_plain, one host sync a
// round. Given each query's k candidates cand (Q, k) and their acceptance
// mask ok (Q, k), every round recomputes, for all queries at once, the first
// accepted candidate that is not blocked, where rank r of query p is blocked
// when its candidate c = cand[p, r] has p as its current partner and p > c.
// It stops when no partner changes, or after max_rounds rounds, as fp_cond
// does, and leaves partner (Q,) with -1 for none and the rounds it ran.
//
// What bounds it on an H100: latency, not bytes or operations. The inputs are
// Q k (8 + 1) bytes (0.74 MB at Q = 8192, k = 10) and a round does ~2 Q k
// compares; but each round depends on the one before, and the whole recurrence
// needs a barrier between its two phases, so it runs in one block, where
// that barrier is __syncthreads().
//
// Design: one block of 1024 threads. partner (4 Q bytes) and two bitmaps of
// Q k bits, ok and dup (the blocked ranks), live in shared memory, 53 KB at
// Q = 8192, k = 10; cand (8 Q k bytes) is read from global memory and L2.
// Thread i owns queries i, i + 1024, ..., and only it reads or writes their
// partners. Each round: clear dup; each owned query c with partner p > c sets
// the bits of the ranks of p whose candidate is c (atomicOr: OR commutes,
// so the bitmap does not depend on the order of the threads); barrier; each
// owned query takes its first rank in ok & ~dup; the block ORs whether any
// partner changed (__syncthreads_or, which is also the round's last barrier).
// The values are integers, so the result equals the plain version's bit for
// bit. The launch (threads, shared memory) is ops/self_match.py's plan,
// passed in and checked here.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads, 1)
    self_match_kernel(const long long* __restrict__ cand, const unsigned char* __restrict__ ok,
                      long long* __restrict__ partner_out, int* __restrict__ rounds_out, int nq,
                      int k, int words, int max_rounds) {
  extern __shared__ unsigned int smem[];
  int* partner = reinterpret_cast<int*>(smem);
  unsigned int* okb = smem + nq;
  unsigned int* dup = okb + words;
  const int tid = threadIdx.x;
  const int total = nq * k;

  for (int w = tid; w < words; w += kThreads) {
    unsigned int bits = 0u;
    const int base = w * 32;
#pragma unroll 4
    for (int b = 0; b < 32; ++b) {
      const int e = base + b;
      if (e < total && ok[e]) bits |= 1u << b;
    }
    okb[w] = bits;
  }
  for (int i = tid; i < nq; i += kThreads) partner[i] = -1;
  __syncthreads();

  int rounds = 0;
  bool changed = true;
  while (changed && rounds < max_rounds) {
    for (int w = tid; w < words; w += kThreads) dup[w] = 0u;
    __syncthreads();
    // c matched to p > c blocks the ranks r of p with cand[p, r] == c
    for (int c = tid; c < nq; c += kThreads) {
      const int p = partner[c];
      if (p > c && p < nq) {
        const long long* row = cand + (size_t)p * k;
        for (int r = 0; r < k; ++r) {
          if (row[r] == c) {
            const int e = p * k + r;
            atomicOr(&dup[e >> 5], 1u << (e & 31));
          }
        }
      }
    }
    __syncthreads();
    int any = 0;
    for (int i = tid; i < nq; i += kThreads) {
      int next = -1;
      for (int r = 0; r < k; ++r) {
        const int e = i * k + r;
        if (((okb[e >> 5] & ~dup[e >> 5]) >> (e & 31)) & 1u) {
          next = (int)cand[(size_t)i * k + r];
          break;
        }
      }
      if (next != partner[i]) {
        partner[i] = next;
        any = 1;
      }
    }
    ++rounds;
    changed = __syncthreads_or(any) != 0;
  }
  for (int i = tid; i < nq; i += kThreads) partner_out[i] = partner[i];
  if (tid == 0) *rounds_out = rounds;
}

}  // namespace

// cand (nq, k) int64, ok (nq, k) bool (one byte each), partner (nq,) int64,
// rounds (1,) int32 -- device, contiguous. threads and smem_bytes are
// ops/self_match.py's plan: kThreads, and 4 (nq + 2 words) bytes with words =
// ceil(nq k / 32). Returns a cudaError_t code (0 on success).
extern "C" int wc_self_match(const long long* cand, const unsigned char* ok, long long* partner,
                             int* rounds, int nq, int k, int max_rounds, int threads,
                             int smem_bytes, void* stream) {
  if (nq < 1 || k < 1 || (long long)nq * k > (1LL << 30) || max_rounds < 0 ||
      threads != kThreads)
    return (int)cudaErrorInvalidValue;
  const int words = (int)(((long long)nq * k + 31) / 32);
  if ((long long)smem_bytes != 4LL * (nq + 2LL * words)) return (int)cudaErrorInvalidValue;
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
    e = cudaFuncSetAttribute(self_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return (int)e;
    if (dev < kCachedDevices) cached_smem[dev] = smem_bytes;
  }
  self_match_kernel<<<1, kThreads, (size_t)smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      cand, ok, partner, rounds, nq, k, words, max_rounds);
  return (int)cudaGetLastError();
}
