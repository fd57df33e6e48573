"""Batched closed-form eigendecomposition of symmetric 3x3 matrices.

Counterpart of ``wildcat_slam_tpu/ops/eigh3.py``: trigonometric eigenvalues,
the most isolated eigenvector from the largest cross product of rows of
(A - lambda I), the remaining pair from the 2x2 projection onto its
complement. Elementwise only. Eigenvalues ascending, eigenvectors as columns.
"""

from __future__ import annotations

import math

import torch

from wildcat_slam_tpu_torch.ops.lie import cross


def _eigvals3_sym(a: torch.Tensor):
    a00, a11, a22 = a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]
    a01, a02, a12 = a[..., 0, 1], a[..., 0, 2], a[..., 1, 2]
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    eps = torch.finfo(a.dtype).eps
    p_safe = torch.maximum(p, 100.0 * eps * (torch.abs(q) + 1.0))
    det_b = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    ) / (p_safe * p_safe * p_safe)
    r = torch.clip(det_b / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    w2 = q + 2.0 * p * torch.cos(phi)
    w0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    w1 = 3.0 * q - w2 - w0
    return w0, w1, w2


def _largest_cross_of_rows(m: torch.Tensor):
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    c0 = cross(r1, r2)
    c1 = cross(r2, r0)
    c2 = cross(r0, r1)
    n0 = torch.sum(c0 * c0, dim=-1)
    n1 = torch.sum(c1 * c1, dim=-1)
    n2 = torch.sum(c2 * c2, dim=-1)
    best01 = torch.where((n0 >= n1)[..., None], c0, c1)
    nbest01 = torch.maximum(n0, n1)
    best = torch.where((nbest01 >= n2)[..., None], best01, c2)
    return best, torch.maximum(nbest01, n2)


def _unit(axis: int, like: torch.Tensor) -> torch.Tensor:
    e = torch.zeros_like(like)
    e[..., axis].fill_(1.0)
    return e


def _orthonormal_complement(v: torch.Tensor):
    e = torch.where((torch.abs(v[..., 0]) > 0.9)[..., None], _unit(1, v), _unit(0, v))
    u = cross(v, e)
    u = u / torch.sqrt(torch.sum(u * u, dim=-1, keepdim=True))
    return u, cross(v, u)


def eigh3(a: torch.Tensor):
    """Eigendecomposition of symmetric (..., 3, 3): ``(eigvals (..., 3)
    ascending, eigvecs (..., 3, 3))`` with ``eigvecs[..., :, k]`` the unit
    eigenvector of ``eigvals[..., k]``."""
    dtype = a.dtype
    w0, w1, w2 = _eigvals3_sym(a)
    eye = torch.eye(3, dtype=dtype, device=a.device)
    iso_is_min = (w1 - w0) >= (w2 - w1)
    lam_iso = torch.where(iso_is_min, w0, w2)
    v_iso, n2 = _largest_cross_of_rows(a - lam_iso[..., None, None] * eye)
    scale = torch.maximum(torch.abs(w0), torch.abs(w2))
    eps2 = (torch.finfo(dtype).eps * (scale + 1.0)) ** 2 * 1e2
    degen = n2 <= eps2
    v_iso = torch.where(degen[..., None], _unit(0, v_iso), v_iso)
    v_iso = v_iso / torch.sqrt(torch.sum(v_iso * v_iso, dim=-1, keepdim=True))

    u, w = _orthonormal_complement(v_iso)
    au = torch.sum(a * u[..., None, :], dim=-1)
    aw = torch.sum(a * w[..., None, :], dim=-1)
    puu = torch.sum(u * au, dim=-1)
    pww = torch.sum(w * aw, dim=-1)
    puw = torch.sum(u * aw, dim=-1)
    th = 0.5 * torch.atan2(2.0 * puw, puu - pww)
    c, s = torch.cos(th), torch.sin(th)
    mu_a = c * c * puu + 2.0 * c * s * puw + s * s * pww
    mu_b = s * s * puu - 2.0 * c * s * puw + c * c * pww
    va = c[..., None] * u + s[..., None] * w
    vb = -s[..., None] * u + c[..., None] * w
    swap = mu_a > mu_b
    mu_lo = torch.where(swap, mu_b, mu_a)
    mu_hi = torch.where(swap, mu_a, mu_b)
    v_lo = torch.where(swap[..., None], vb, va)
    v_hi = torch.where(swap[..., None], va, vb)

    im = iso_is_min[..., None]
    vals = torch.stack([torch.where(iso_is_min, lam_iso, mu_lo),
                        torch.where(iso_is_min, mu_lo, mu_hi),
                        torch.where(iso_is_min, mu_hi, lam_iso)], dim=-1)
    vecs = torch.stack([torch.where(im, v_iso, v_lo),
                        torch.where(im, v_lo, v_hi),
                        torch.where(im, v_hi, v_iso)], dim=-1)
    return vals, vecs


def min_eigpair3(a: torch.Tensor):
    """(lambda_min, v_min) of symmetric (..., 3, 3)."""
    vals, vecs = eigh3(a)
    return vals[..., 0], vecs[..., :, 0]
