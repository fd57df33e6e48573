// The factor kernels' shared device code (K5 csrc/imu_factor.cu, K6
// csrc/surfel_factor.cu). SO(3) and quaternion helpers, the device
// counterparts of ops/lie.py, with its formulas and its Taylor branches (eps
// 1e-4 in float32 and 1e-8 in float64, the series switch at 0.2 and 0.01),
// on 3-vectors, wxyz quaternions and row-major 3 x 3 matrices held in plain
// arrays; each writes its result into an output array that may not alias an
// input. Then the block-wide scan and sort of the kernels' counting passes,
// and the cooperative launch. The sources that include it build with
// -fmad=false (ops/_build.py, SOURCE_FLAGS): every product and sum rounds on
// its own, as the plain versions' PyTorch operations do, and a sum's FMA is
// written out (rfma).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace wc {

template <typename T>
struct Lie;
template <>
struct Lie<float> {
  static constexpr float eps = 1e-4f, taylor = 0.2f;
};
template <>
struct Lie<double> {
  static constexpr double eps = 1e-8, taylor = 0.01;
};

__device__ __forceinline__ float wsin(float x) { return sinf(x); }
__device__ __forceinline__ double wsin(double x) { return sin(x); }
__device__ __forceinline__ float wcos(float x) { return cosf(x); }
__device__ __forceinline__ double wcos(double x) { return cos(x); }
__device__ __forceinline__ float wsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double wsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float watan(float x) { return atanf(x); }
__device__ __forceinline__ double watan(double x) { return atan(x); }

// an explicit FMA (a sum's step where two code paths must give the same bits)
__device__ __forceinline__ float rfma(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double rfma(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename T>
__device__ __forceinline__ void cross(const T* a, const T* b, T* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

template <typename T>
__device__ __forceinline__ void hat(const T* v, T* m) {
  m[0] = T(0), m[1] = -v[2], m[2] = v[1];
  m[3] = v[2], m[4] = T(0), m[5] = -v[0];
  m[6] = -v[1], m[7] = v[0], m[8] = T(0);
}

// out = a b (3 x 3)
template <typename T>
__device__ __forceinline__ void mat3_mul(const T* a, const T* b, T* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j];
}

// out = a b^T (3 x 3)
template <typename T>
__device__ __forceinline__ void mat3_mul_t(const T* a, const T* b, T* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] =
          a[3 * i] * b[3 * j] + a[3 * i + 1] * b[3 * j + 1] + a[3 * i + 2] * b[3 * j + 2];
}

// the row vector v times m: out_j = sum_i v_i m_ij
template <typename T>
__device__ __forceinline__ void vec_mat3(const T* v, const T* m, T* out) {
#pragma unroll
  for (int j = 0; j < 3; ++j) out[j] = v[0] * m[j] + v[1] * m[3 + j] + v[2] * m[6 + j];
}

// rotation vector -> unit quaternion (Sophus SO3::exp)
template <typename T>
__device__ __forceinline__ void exp_quat(const T* v, T* q) {
  const T t2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  const T t = wsqrt(t2);
  const bool small = t < Lie<T>::eps;
  const T ts = small ? T(1) : t;
  const T k = small ? T(0.5) - t2 / T(48) : wsin(ts / T(2)) / ts;
  const T w = small ? T(1) - t2 / T(8) : wcos(ts / T(2));
  q[0] = w, q[1] = k * v[0], q[2] = k * v[1], q[3] = k * v[2];
  const T nrm = wsqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = q[i] / nrm;
}

// unit quaternion -> rotation vector (Sophus SO3::log)
template <typename T>
__device__ __forceinline__ void log_quat(const T* q, T* out) {
  const T w = q[0];
  const T n2 = q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
  const T n = wsqrt(n2);
  const bool small_n = n < Lie<T>::eps;
  const bool small_w = fabs(w) < Lie<T>::eps;
  const T ns = small_n ? T(1) : n;
  const T ws = small_w ? T(1) : w;
  const T k_small_n = T(2) / ws - T(2.0 / 3.0) * n2 / (ws * ws * ws);
  const T k_small_w = (w >= T(0) ? T(M_PI) : T(-M_PI)) / ns;
  const T k_general = T(2) * watan(ns / ws) / ns;
  const T k = small_n ? k_small_n : (small_w ? k_small_w : k_general);
  out[0] = k * q[1], out[1] = k * q[2], out[2] = k * q[3];
}

// the Hamilton product a b
template <typename T>
__device__ __forceinline__ void quat_mul(const T* a, const T* b, T* out) {
  out[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  out[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  out[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  out[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

template <typename T>
__device__ __forceinline__ void quat_conj(const T* q, T* out) {
  out[0] = q[0], out[1] = -q[1], out[2] = -q[2], out[3] = -q[3];
}

// v rotated by the unit quaternion q (the two-cross form)
template <typename T>
__device__ __forceinline__ void quat_rotate(const T* q, const T* v, T* out) {
  const T* qv = q + 1;
  T c[3], t[3], c2[3];
  cross(qv, v, c);
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = T(2) * c[i];
  cross(qv, t, c2);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = v[i] + q[0] * t[i] + c2[i];
}

template <typename T>
__device__ __forceinline__ void quat_to_matrix(const T* q, T* m) {
  const T w = q[0], x = q[1], y = q[2], z = q[3];
  const T xx = x * x, yy = y * y, zz = z * z, xy = x * y, xz = x * z, yz = y * z;
  const T wx = w * x, wy = w * y, wz = w * z;
  m[0] = T(1) - T(2) * (yy + zz), m[1] = T(2) * (xy - wz), m[2] = T(2) * (xz + wy);
  m[3] = T(2) * (xy + wz), m[4] = T(1) - T(2) * (xx + zz), m[5] = T(2) * (yz - wx);
  m[6] = T(2) * (xz - wy), m[7] = T(2) * (yz + wx), m[8] = T(1) - T(2) * (xx + yy);
}

template <typename T>
__device__ __forceinline__ void exp_matrix(const T* v, T* m) {
  T q[4];
  exp_quat(v, q);
  quat_to_matrix(q, m);
}

// the left Jacobian of SO(3) at v
template <typename T>
__device__ __forceinline__ void jl(const T* v, T* m) {
  const T t2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  const T t = wsqrt(t2);
  const bool tiny = t < Lie<T>::eps;
  const T ts = tiny ? T(1) : t;
  const T sinc = tiny ? T(1) - t2 / T(6) : wsin(ts) / ts;
  const T half_sinc = tiny ? T(1) - t2 / T(24) : wsin(ts / T(2)) / (ts / T(2));
  const T cosc = T(0.5) * half_sinc * half_sinc;
  const bool small = t < Lie<T>::taylor;
  const T one_m_sinc =
      small ? T(1.0 / 6.0) - t2 / T(120) + t2 * t2 / T(5040) : (T(1) - sinc) / (ts * ts);
  T h[9];
  hat(v, h);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      m[3 * i + j] = (i == j ? sinc : T(0)) + one_m_sinc * (v[i] * v[j]) + cosc * h[3 * i + j];
}

// the right Jacobian: jl(-v)
template <typename T>
__device__ __forceinline__ void jr(const T* v, T* m) {
  const T nv[3] = {-v[0], -v[1], -v[2]};
  jl(nv, m);
}

// the inverse left Jacobian at v
template <typename T>
__device__ __forceinline__ void jl_inv(const T* v, T* m) {
  const T t2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  const T t = wsqrt(t2);
  const bool small = t < Lie<T>::taylor;
  const T ts = small ? T(1) : t;
  const T half = ts / T(2);
  const T coef = small ? T(1.0 / 12.0) + t2 / T(720) + t2 * t2 / T(30240)
                       : (T(1) - half * wcos(half) / wsin(half)) / (ts * ts);
  T h[9];
  hat(v, h);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T eye = i == j ? T(1) : T(0);
      m[3 * i + j] = eye - T(0.5) * h[3 * i + j] + coef * (v[i] * v[j] - t2 * eye);
    }
}

// the inverse right Jacobian: jl_inv(-v)
template <typename T>
__device__ __forceinline__ void jr_inv(const T* v, T* m) {
  const T nv[3] = {-v[0], -v[1], -v[2]};
  jl_inv(nv, m);
}

// cor[il] (1 - f) + cor[ir] f over the first n entries of two rows of 12
template <typename T>
__device__ __forceinline__ void lerp_rows(const T* cor, long long il, long long ir, T f, int n,
                                          T* out) {
  const T* a = cor + 12 * il;
  const T* b = cor + 12 * ir;
  const T g = T(1) - f;
  for (int c = 0; c < n; ++c) out[c] = a[c] * g + b[c] * f;
}

// An exclusive scan of v[0..n) in place by the whole block (kWarps warps):
// thread t sums a run of consecutive entries, a warp scan and the warps'
// totals (scratch, kWarps ints) place the runs. Returns the total; every
// thread of the block must call it. Integers, so the result does not depend
// on any order.
template <int kWarps>
__device__ __forceinline__ int block_exclusive_scan(int* v, int n, int* scratch) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nt = kWarps * 32;
  const int per = (n + nt - 1) / nt, lo = min(n, tid * per), hi = min(n, lo + per);
  int c = 0;
  for (int i = lo; i < hi; ++i) c += v[i];
  int x = c;  // inclusive scan over the warp's lanes
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  int base = x - c, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    base += w < warp ? scratch[w] : 0;
    total += scratch[w];
  }
  for (int i = lo; i < hi; ++i) {
    const int y = v[i];
    v[i] = base;
    base += y;
  }
  __syncthreads();  // scratch is rewritten by the next scan
  return total;
}

// Sorts keys[0..n) ascending in shared memory, n = 2 kPer blockDim.x, by
// the whole block: a bitonic network, each thread kPer compare-exchanges a
// stage (their loads issued together) and a __syncthreads a stage. Keys
// that carry their entry's position in their low bits make the sort
// stable.
template <int kPer>
__device__ __forceinline__ void block_sort(unsigned* keys) {
  const int n = 2 * kPer * blockDim.x;
  for (int k = 2; k <= n; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      int i[kPer];
      unsigned a[kPer], b[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int q = threadIdx.x + u * blockDim.x;  // the q-th pair: i with bit j clear, i | j
        i[u] = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        a[u] = keys[i[u]];
        b[u] = keys[i[u] | j];
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u)
        if ((a[u] > b[u]) == ((i[u] & k) == 0)) keys[i[u]] = b[u], keys[i[u] | j] = a[u];
      __syncthreads();
    }
}

// The first index of the sorted keys[0..n) whose key is >= x
__device__ __forceinline__ int lower_bound(const unsigned* keys, int n, unsigned x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// An asynchronous 16-byte copy from device memory to shared memory (both
// 16-byte aligned), and the wait for all of a thread's copies: loads that
// stage data keep no registers, so a thread can have many in flight.
__device__ __forceinline__ void copy_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// A cooperative launch of `fn` (every block resident, so that a grid
// barrier cannot deadlock) on `grid` blocks.
template <typename... P>
cudaError_t launch_cooperative(void (*fn)(P...), dim3 grid, dim3 block, size_t smem,
                               cudaStream_t st, P... args) {
  void* params[] = {(void*)&args...};
  return cudaLaunchCooperativeKernel((const void*)fn, grid, block, params, smem, st);
}

// The blocks of `fn` that the current card keeps resident at once (with
// `threads` threads and `smem` bytes of dynamic shared memory each), after
// raising its dynamic shared memory limit to `smem`; cached per card.
template <typename F>
cudaError_t resident_blocks(F fn, int threads, size_t smem, int* out, int* cache) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 16 && cache[dev] > 0) {
    *out = cache[dev];
    return cudaSuccess;
  }
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (e != cudaSuccess) return e;
  *out = sms * per_sm;
  if (dev < 16) cache[dev] = *out;
  return *out > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

}  // namespace wc
