"""Batched SO(3) Lie-group primitives in PyTorch.

Counterpart of ``wildcat_slam_tpu/ops/lie.py``: Hat, Exp, Log, Jl, Jr, Jl_inv,
Jr_inv and the wxyz quaternion utilities. Every function is batched over
arbitrary leading axes and works in float32 or float64. Small angles take the
same Taylor branches as the JAX package, selected with ``torch.where`` over
"safe" denominators, so no branch divides by ~0.
"""

from __future__ import annotations

import math

import torch


def _eps(dtype) -> float:
    return 1e-4 if dtype == torch.float32 else 1e-8


def _taylor_switch(dtype) -> float:
    return 0.2 if dtype == torch.float32 else 0.01


def _norm(q: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of ``v``: (..., 3) -> (..., 3, 3)."""
    zeros = torch.zeros_like(v[..., 0])
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    rows = [
        torch.stack([zeros, -vz, vy], dim=-1),
        torch.stack([vz, zeros, -vx], dim=-1),
        torch.stack([-vy, vx, zeros], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def mat3_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 product as elementwise multiply-reduce (exact f32, no TF32)."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def vec_mat3(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Batched row-vector times 3x3: (..., 3) x (..., 3, 3) -> (..., 3)."""
    return torch.sum(v[..., :, None] * m, dim=-2)


def _safe(x: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.where(x < eps, torch.ones_like(x), x)


def exp_quat(v: torch.Tensor) -> torch.Tensor:
    """Rotation vector -> unit quaternion (wxyz), Sophus ``SO3::exp``."""
    t2 = torch.sum(v * v, dim=-1)
    t = torch.sqrt(t2)
    eps = _eps(v.dtype)
    small = t < eps
    t_safe = _safe(t, eps)
    k = torch.where(small, 0.5 - t2 / 48.0, torch.sin(t_safe / 2.0) / t_safe)
    w = torch.where(small, 1.0 - t2 / 8.0, torch.cos(t_safe / 2.0))
    q = torch.cat([w[..., None], k[..., None] * v], dim=-1)
    return q / _norm(q)


def log_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (wxyz) -> rotation vector, Sophus ``SO3::log``."""
    w = q[..., 0]
    vec = q[..., 1:]
    n2 = torch.sum(vec * vec, dim=-1)
    n = torch.sqrt(n2)
    eps = _eps(q.dtype)
    small_n = n < eps
    small_w = torch.abs(w) < eps
    n_safe = _safe(n, eps)
    w_safe = torch.where(small_w, torch.ones_like(w), w)
    k_small_n = 2.0 / w_safe - (2.0 / 3.0) * n2 / (w_safe**3)
    pi = torch.full_like(w, math.pi)
    k_small_w = torch.where(w >= 0, pi, -pi) / n_safe
    k_general = 2.0 * torch.arctan(n_safe / w_safe) / n_safe
    k = torch.where(small_n, k_small_n, torch.where(small_w, k_small_w, k_general))
    return k[..., None] * vec


def _eye_like(v: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=v.dtype, device=v.device).expand(v.shape[:-1] + (3, 3))


def jl(v: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO(3)."""
    t2 = torch.sum(v * v, dim=-1)
    t = torch.sqrt(t2)
    eps = _eps(v.dtype)
    tiny = t < eps
    t_safe = _safe(t, eps)
    t2_safe = t_safe * t_safe
    sinc = torch.where(tiny, 1.0 - t2 / 6.0, torch.sin(t_safe) / t_safe)
    half_sinc = torch.where(tiny, 1.0 - t2 / 24.0,
                            torch.sin(t_safe / 2.0) / (t_safe / 2.0))
    cosc = 0.5 * half_sinc * half_sinc
    small = t < _taylor_switch(v.dtype)
    one_m_sinc = torch.where(small, 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0,
                             (1.0 - sinc) / t2_safe)
    vvt = v[..., :, None] * v[..., None, :]
    return (sinc[..., None, None] * _eye_like(v) + one_m_sinc[..., None, None] * vvt
            + cosc[..., None, None] * hat(v))


def jr(v: torch.Tensor) -> torch.Tensor:
    return jl(-v)


def jl_inv(v: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian."""
    t2 = torch.sum(v * v, dim=-1)
    t = torch.sqrt(t2)
    small = t < _taylor_switch(v.dtype)
    t_safe = torch.where(small, torch.ones_like(t), t)
    half = t_safe / 2.0
    coef = torch.where(small, 1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0,
                       (1.0 - half * torch.cos(half) / torch.sin(half)) / (t_safe * t_safe))
    eye = _eye_like(v)
    hh = v[..., :, None] * v[..., None, :] - t2[..., None, None] * eye
    return eye - 0.5 * hat(v) + coef[..., None, None] * hh


def jr_inv(v: torch.Tensor) -> torch.Tensor:
    return jl_inv(-v)


def quat_identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, both (..., 4) wxyz."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    # the same bits as q * [1, -1, -1, -1], with no constant to copy to the device
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis (broadcasting, like ``jnp.cross``)."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by unit quaternion(s) q via the two-cross form."""
    qv = q[..., 1:]
    w = q[..., 0:1]
    t = 2.0 * cross(qv, v)
    return v + w * t + cross(qv, t)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rows = [
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation matching Eigen's ``Quaternion::slerp``."""
    d = torch.sum(q0 * q1, dim=-1)
    abs_d = torch.abs(d)
    close = abs_d >= 1.0 - _eps(q0.dtype)
    abs_d_c = torch.clip(abs_d, 0.0, 1.0)
    theta = torch.arccos(torch.where(close, torch.zeros_like(abs_d_c), abs_d_c))
    sin_theta = torch.sin(theta)
    sin_safe = torch.where(close, torch.ones_like(sin_theta), sin_theta)
    scale0 = torch.where(close, 1.0 - t, torch.sin((1.0 - t) * theta) / sin_safe)
    scale1 = torch.where(close, t, torch.sin(t * theta) / sin_safe)
    scale1 = torch.where(d < 0, -scale1, scale1)
    out = scale0[..., None] * q0 + scale1[..., None] * q1
    return out / _norm(out)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / _norm(q)


def quat_angular_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = quat_mul(quat_conj(a), b)
    return torch.sqrt(torch.sum(log_quat(d) ** 2, dim=-1))


def exp_matrix(v: torch.Tensor) -> torch.Tensor:
    return quat_to_matrix(exp_quat(v))
