// The closed-form eigendecomposition of a symmetric 3 x 3 matrix on the
// device: the counterpart of ops/eigh3.py (its CPU twin), with its formulas
// in the same order of operations. _eigvals3_sym's trigonometric
// eigenvalues, then the most isolated eigenvector from the largest cross
// product of the rows of (A - lambda I), then the remaining pair from the
// 2 x 2 projection onto its complement. Eigenvalues ascending, eigenvectors
// as columns of a row-major 3 x 3 array.
//
// A division by a constant is written as PyTorch's CUDA kernels take a
// division by a host scalar: a product with the reciprocal, rounded in the
// working type; a cross product as torch.linalg.cross computes it on the
// card, a1 b2 - a2 b1 as fma(a1, b2, -(a2 b1)) (seen on the card in float32:
// every one of 600,000 components equal). torch.maximum, torch.clamp and torch.clip carry a NaN
// through (tmax, clamp_min, clip1). The sources that include this build
// with -fmad=false (ops/_build.py, SOURCE_FLAGS), so every product and sum
// rounds on its own, as the plain version's PyTorch operations do; acos,
// cos, sin and atan2 come from the CUDA math library and may differ from
// PyTorch's in the last bits.

#pragma once

#include <math.h>

#include "lie.cuh"

namespace wc {

template <typename T>
struct Finfo;
template <>
struct Finfo<float> {
  static constexpr float eps = 1.1920928955078125e-07f, tiny = 1.1754943508222875e-38f;
};
template <>
struct Finfo<double> {
  static constexpr double eps = 2.220446049250313e-16, tiny = 2.2250738585072014e-308;
};

__device__ __forceinline__ float wacos(float x) { return acosf(x); }
__device__ __forceinline__ double wacos(double x) { return acos(x); }
__device__ __forceinline__ float watan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double watan2(double y, double x) { return atan2(y, x); }

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return (a != a || a > b) ? a : b; }
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) { return x < lo ? lo : x; }
template <typename T>
__device__ __forceinline__ T clip1(T x) { return x < T(-1) ? T(-1) : (x > T(1) ? T(1) : x); }

// _eigvals3_sym: the eigenvalues (w0, w1, w2) of the symmetric a (row-major)
template <typename T>
__device__ __forceinline__ void eigvals3_sym(const T* a, T& w0, T& w1, T& w2) {
  const T a00 = a[0], a11 = a[4], a22 = a[8], a01 = a[1], a02 = a[2], a12 = a[5];
  const T third = T(1) / T(3), sixth = T(1) / T(6);
  const T p1 = a01 * a01 + a02 * a02 + a12 * a12;
  const T q = (a00 + a11 + a22) * third;
  const T b00 = a00 - q, b11 = a11 - q, b22 = a22 - q;
  const T p2 = b00 * b00 + b11 * b11 + b22 * b22 + T(2) * p1;
  const T p = wsqrt(clamp_min(p2 * sixth, T(0)));
  const T p_safe = tmax(p, T(100 * Finfo<T>::eps) * (fabs(q) + T(1)));
  const T det_b = (b00 * (b11 * b22 - a12 * a12) - a01 * (a01 * b22 - a12 * a02) +
                   a02 * (a01 * a12 - b11 * a02)) /
                  (p_safe * p_safe * p_safe);
  const T r = clip1(det_b * T(0.5));
  const T phi = wacos(r) * third;
  w2 = q + T(2) * p * wcos(phi);
  w0 = q + T(2) * p * wcos(phi + T(2.0943951023931953));  // 2 pi / 3
  w1 = T(3) * q - w2 - w0;
}

// torch.linalg.cross on the card
template <typename T>
__device__ __forceinline__ void cross_fma(const T* a, const T* b, T* out) {
  out[0] = rfma(a[1], b[2], -(a[2] * b[1]));
  out[1] = rfma(a[2], b[0], -(a[0] * b[2]));
  out[2] = rfma(a[0], b[1], -(a[1] * b[0]));
}

template <typename T>
__device__ __forceinline__ T dot3(const T* x, const T* y) {
  return x[0] * y[0] + x[1] * y[1] + x[2] * y[2];
}

// eigh3: vals ascending; vecs[3 i + k] is component i of the unit
// eigenvector of vals[k]
template <typename T>
__device__ void eigh3(const T* a, T* vals, T* vecs) {
  T w0, w1, w2;
  eigvals3_sym(a, w0, w1, w2);
  const bool iso_is_min = (w1 - w0) >= (w2 - w1);
  const T lam = iso_is_min ? w0 : w2;
  T m[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) m[3 * i + j] = a[3 * i + j] - lam * (i == j ? T(1) : T(0));
  // _largest_cross_of_rows
  T c0[3], c1[3], c2[3];
  cross_fma(m + 3, m + 6, c0);
  cross_fma(m + 6, m, c1);
  cross_fma(m, m + 3, c2);
  const T n0 = dot3(c0, c0), n1 = dot3(c1, c1), n2 = dot3(c2, c2);
  const T nb01 = tmax(n0, n1), nbest = tmax(nb01, n2);
  const bool first01 = n0 >= n1, from01 = nb01 >= n2;
  const T scale = tmax(fabs(w0), fabs(w2));
  const T e = Finfo<T>::eps * (scale + T(1));
  const T eps2 = e * e * T(100);
  T v[3];
  const bool degen = nbest <= eps2;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T best = from01 ? (first01 ? c0[i] : c1[i]) : c2[i];
    v[i] = degen ? (i == 0 ? T(1) : T(0)) : best;
  }
  const T nv = wsqrt(dot3(v, v));
  v[0] = v[0] / nv, v[1] = v[1] / nv, v[2] = v[2] / nv;
  // _orthonormal_complement
  T ax[3] = {T(1), T(0), T(0)};
  if (fabs(v[0]) > T(0.9)) ax[0] = T(0), ax[1] = T(1);
  T u[3], w[3];
  cross_fma(v, ax, u);
  const T nu = wsqrt(dot3(u, u));
  u[0] = u[0] / nu, u[1] = u[1] / nu, u[2] = u[2] / nu;
  cross_fma(v, u, w);
  T au[3], aw[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    au[i] = dot3(a + 3 * i, u);
    aw[i] = dot3(a + 3 * i, w);
  }
  const T puu = dot3(u, au), pww = dot3(w, aw), puw = dot3(u, aw);
  const T th = T(0.5) * watan2(T(2) * puw, puu - pww);
  const T c = wcos(th), s = wsin(th);
  const T mu_a = c * c * puu + T(2) * c * s * puw + s * s * pww;
  const T mu_b = s * s * puu - T(2) * c * s * puw + c * c * pww;
  T va[3], vb[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    va[i] = c * u[i] + s * w[i];
    vb[i] = -s * u[i] + c * w[i];
  }
  const bool swap = mu_a > mu_b;
  const T mu_lo = swap ? mu_b : mu_a, mu_hi = swap ? mu_a : mu_b;
  vals[0] = iso_is_min ? lam : mu_lo;
  vals[1] = iso_is_min ? mu_lo : mu_hi;
  vals[2] = iso_is_min ? mu_hi : lam;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T v_lo = swap ? vb[i] : va[i], v_hi = swap ? va[i] : vb[i];
    vecs[3 * i] = iso_is_min ? v[i] : v_lo;
    vecs[3 * i + 1] = iso_is_min ? v_lo : v_hi;
    vecs[3 * i + 2] = iso_is_min ? v_hi : v[i];
  }
}

}  // namespace wc
