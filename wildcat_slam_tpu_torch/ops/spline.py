"""Cubic spline kernels: uniform B-spline blend, Hermite interpolation and the
least-squares B-spline control-point fit/eval.

Counterpart of ``wildcat_slam_tpu/ops/spline.py``. The basis matrix ``_M`` is
copied here as a host constant so this package never imports the JAX module.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Uniform cubic B-spline basis matrix (the reference's spline_interpolation.h:83).
_M = np.asarray(
    [
        [-1.0, 3.0, -3.0, 1.0],
        [3.0, -6.0, 3.0, 0.0],
        [-3.0, 0.0, 3.0, 0.0],
        [1.0, 4.0, 1.0, 0.0],
    ]
)


@functools.lru_cache(maxsize=None)
def _basis(dtype, device) -> torch.Tensor:
    return torch.as_tensor(_M, dtype=dtype, device=device)


def basis(dtype, device=None) -> torch.Tensor:
    """``_M`` as a tensor of the given dtype/device, copied to a device once
    per (dtype, device): a captured sweep may not copy from the host."""
    return _basis(dtype, torch.device(device) if device is not None else torch.device("cpu"))


def _like(x, ref: torch.Tensor) -> torch.Tensor:
    """``x`` as a tensor of ``ref``'s dtype and device; a Python number is
    filled on the device rather than copied from the host."""
    if isinstance(x, (int, float)):
        return torch.full((), x, dtype=ref.dtype, device=ref.device)
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def cubic_bspline_approx(p_1, p0, p1, p2, s):
    """Uniform cubic B-spline blend of 4 control points at parameter s in [0, 1]."""
    s = _like(s, p0)
    s2 = s * s
    s3 = s2 * s
    w_1 = (1.0 - s) ** 3
    w0 = 3.0 * s3 - 6.0 * s2 + 4.0
    w1 = -3.0 * s3 + 3.0 * s2 + 3.0 * s + 1.0
    w2 = s3
    return (p_1 * w_1[..., None] + p0 * w0[..., None] + p1 * w1[..., None]
            + p2 * w2[..., None]) / 6.0


def cubic_hermite(s_1, p_1, s0, p0, s1, p1, s2, p2, s):
    """Catmull-Rom-style cubic Hermite interpolation with 3-point slopes."""
    m0 = 0.5 * ((p0 - p_1) / (s0 - s_1) + (p1 - p0) / (s1 - s0))
    m1 = 0.5 * ((p1 - p0) / (s1 - s0) + (p2 - p1) / (s2 - s1))
    t = _like((s - s0) / (s1 - s0), p0)
    t2 = t * t
    t3 = t2 * t
    h00 = 2 * t3 - 3 * t2 + 1
    h10 = t3 - 2 * t2 + t
    h01 = -2 * t3 + 3 * t2
    h11 = t3 - t2
    dt = s1 - s0
    return (h00[..., None] * p0 + (h10 * dt)[..., None] * m0 + h01[..., None] * p1
            + (h11 * dt)[..., None] * m1)


def bspline_basis_matrix(n: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """The (n, n) collocation matrix N with N @ Q evaluating the spline at the n
    sample knots."""
    temp = np.array([0.0, 0.0, 0.0, 1.0]) @ _M / 6.0
    N = np.zeros((n, n))
    for i in range(n):
        idx = np.clip(np.arange(i - 1, i + 3), 0, n - 1)
        for j in range(4):
            N[i, idx[j]] += temp[j]
    return torch.as_tensor(N, dtype=dtype, device=device)


def fit_control_points(points: torch.Tensor) -> torch.Tensor:
    """Least-squares control points Q = (N^T N)^-1 N^T p for uniform knots."""
    N = bspline_basis_matrix(points.shape[0], dtype=points.dtype, device=points.device)
    return torch.linalg.solve_ex(N.T @ N, N.T @ points, check_errors=False)[0]


def eval_bspline(control_points: torch.Tensor, t_front, t_back, query_t):
    """Evaluate the fitted uniform B-spline at query times. Returns
    ``(values, in_range)``."""
    q = control_points
    n = q.shape[0]
    dtype = q.dtype
    query_t = _like(query_t, q)
    in_range = (query_t >= t_front) & (query_t <= t_back)
    index_f = (query_t - t_front) / (t_back - t_front) * (n - 1) + 1.0
    index_int = torch.floor(index_f).to(torch.int64)
    t = index_f - index_int.to(dtype)
    offsets = torch.arange(-2, 2, device=q.device)
    idx = torch.clip(index_int[..., None] + offsets, 0, n - 1)
    q4 = q[idx]
    tv = torch.stack([t * t * t, t * t, t, torch.ones_like(t)], dim=-1)
    w = torch.einsum("...i,ij->...j", tv, basis(dtype, q.device)) / 6.0
    return torch.einsum("...j,...jd->...d", w, q4), in_range


def fit_and_eval(sample_t, sample_p, query_t):
    """Fit a uniform cubic B-spline through (sample_t, sample_p), evaluate at query_t."""
    q = fit_control_points(sample_p)
    return eval_bspline(q, sample_t[0], sample_t[-1], query_t)
