"""Post-solve state updates: B-spline-smoothed corrections onto IMU states and
surfel pose attachment/refresh.

Counterpart of ``wildcat_slam_tpu/odometry/corrections.py``. The optimizer
interpolates corrections linearly; the state update smooths them with a
least-squares cubic B-spline fitted over the full sample capacity (identity
rows past ``count``).
"""

from __future__ import annotations

import torch

from wildcat_slam_tpu_torch.odometry import imu as imu_mod
from wildcat_slam_tpu_torch.odometry.states import ImuStates, SampleStates, Surfels
from wildcat_slam_tpu_torch.ops import lie, spd
from wildcat_slam_tpu_torch.ops.spline import basis


def fit_correction_spline(sample: SampleStates) -> torch.Tensor:
    """LS-fit B-spline control points (S, 6) through the (rot_cor, pos_cor)
    samples; the banded collocation matrix is [1, 4, 1]/6 with the boundary
    lumping of the reference's index clamping. Solves (N^T N) Q = N^T p, as
    the JAX version does (there by ``jnp.linalg.solve``): N^T N is SPD, so by
    ``ops/spd.spd_solve``, kernel K4 in one launch on the card (a library
    solve's triangular solves may allocate inside a graph capture, which the
    sweep graph cannot hold), its plain version on the CPU."""
    s = sample.capacity
    n = sample.count
    dtype = sample.cor.dtype
    dev = sample.cor.device
    rows = torch.arange(s, device=dev)
    live = rows < n
    nmat = torch.zeros((s, s), dtype=dtype, device=dev)
    # one add per band offset, in the JAX version's order: a clamped index
    # lands on a neighbour's column at the ends and adds to it there
    for off, w in ((-1, 1.0 / 6.0), (0, 4.0 / 6.0), (1, 1.0 / 6.0)):
        cols = torch.minimum(torch.clamp(rows + off, min=0), n - 1)
        hit = (cols[:, None] == rows[None, :]) & live[:, None]
        nmat = nmat + hit.to(dtype) * w
    nmat = torch.where(live[:, None], nmat, torch.eye(s, dtype=dtype, device=dev))
    p = torch.where(live[:, None], torch.cat([sample.cor[:, 0:3], sample.cor[:, 3:6]], 1), 0.0)
    return spd.spd_solve(nmat.T @ nmat, nmat.T @ p)


def eval_correction_spline(sample: SampleStates, q: torch.Tensor, query_t: torch.Tensor):
    """Evaluate the fitted correction spline at query times. Returns
    ((Q, 3) rot_cor, (Q, 3) pos_cor, (Q,) in_range)."""
    n = sample.count
    dtype = q.dtype
    tdt = sample.t.dtype
    t0 = sample.t[0]
    t_back = imu_mod.row_at(sample.t, n - 1)
    qt = query_t.to(tdt)
    in_range = (qt >= t0) & (qt <= t_back)
    span = torch.clamp(t_back - t0, min=torch.finfo(tdt).tiny)
    index_f = ((qt - t0) / span * (n - 1).to(tdt) + 1.0).to(dtype)
    index_int = torch.floor(index_f).to(torch.int64)
    tf = index_f - index_int.to(dtype)
    offsets = torch.arange(-2, 2, device=q.device)
    idx = torch.minimum(torch.clamp(index_int[..., None] + offsets, min=0), n - 1)
    q4 = q[idx]
    tv = torch.stack([tf * tf * tf, tf * tf, tf, torch.ones_like(tf)], dim=-1)
    w = torch.einsum("...i,ij->...j", tv, basis(dtype, q.device)) / 6.0
    vals = torch.einsum("...j,...jd->...d", w, q4)
    return vals[..., 0:3], vals[..., 3:6], in_range


def update_imu_poses(sample: SampleStates, imu: ImuStates, dt: float) -> ImuStates:
    """Apply the smoothed corrections to every IMU state inside the sample
    window, then re-extrapolate the single trailing state."""
    q = fit_correction_spline(sample)
    rot_cor, pos_cor, ok = eval_correction_spline(sample, q, imu.t)
    ok = (ok & imu.mask)[:, None]
    rot = lie.quat_normalize(torch.where(ok, lie.quat_mul(lie.exp_quat(rot_cor), imu.rot), imu.rot))
    pos = torch.where(ok, pos_cor + imu.pos, imu.pos)

    c = imu.count
    back_cor = imu_mod.row_at(sample.cor, sample.count - 1)
    bg, ba = back_cor[6:9], back_cor[9:12]
    g = imu_mod.row_at
    p1, r1, a1 = g(pos, c - 3), g(rot, c - 3), g(imu.acc, c - 3)
    p2, r2 = g(pos, c - 2), g(rot, c - 2)
    g2, g3 = g(imu.gyr, c - 2), g(imu.gyr, c - 1)
    dt2 = torch.full((), dt * dt, dtype=pos.dtype, device=pos.device)
    r3 = lie.quat_mul(r2, lie.exp_quat(((g2 + g3) / 2.0 - bg) * dt))
    p3 = (lie.quat_rotate(r1, a1 - ba) + sample.grav) * dt2 + 2.0 * p2 - p1
    return imu.replace(rot=imu_mod.put_rows(rot, r3[None], c - 1),
                       pos=imu_mod.put_rows(pos, p3[None], c - 1))


def attach_surfel_poses(t, center_w, cov_w, norm_w, resolution, std, valid,
                        imu: ImuStates) -> Surfels:
    """Attach the interpolated pose at each surfel's timestamp and convert the
    world-frame geometry into the body frame."""
    pos, rot = imu_mod.interp_pose(imu, t)
    rinv = lie.quat_conj(rot)
    rmat_inv = lie.quat_to_matrix(rinv)
    return Surfels(
        t=t, center=lie.quat_rotate(rinv, center_w - pos),
        cov=torch.matmul(torch.matmul(rmat_inv, cov_w), rmat_inv.transpose(-1, -2)),
        norm=lie.quat_rotate(rinv, norm_w), rot=rot, pos=pos,
        resolution=resolution, std=std, valid=valid)


def update_surfel_poses(surfels: Surfels, imu: ImuStates) -> Surfels:
    """Refresh only the attached pose; body-frame geometry is immutable."""
    pos, rot = imu_mod.interp_pose(imu, surfels.t)
    keep = surfels.valid[:, None]
    return surfels.replace(rot=torch.where(keep, rot, surfels.rot),
                           pos=torch.where(keep, pos, surfels.pos))
