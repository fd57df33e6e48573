"""Synthetic lidar-inertial sequences with exact ground truth.

Counterpart of ``wildcat_slam_tpu/io/synthetic.py`` (numpy only; a test holds
the two generators to the same arrays). The reference has no simulator — its only end-to-end check is eyeballing rviz on
Hilti bags (SURVEY.md §4). This generator provides deterministic sequences whose
IMU stream is *discretely consistent* with the pipeline's propagation model, so
integration error is exactly zero and every downstream deviation is attributable
to the component under test:

- gyro samples solve the midpoint recurrence
  ``Log(R_k^T R_{k+1}) = (w_k + w_{k+1})/2 * dt``  (lidar_odometry.cc:121)
- accelerometer samples invert the second-difference position rule
  ``a_k = R_k^T ((p_{k+2} - 2 p_{k+1} + p_k)/dt^2 - g_w)``  (:122)

Lidar scans are raycasts from the moving sensor into an axis-aligned room
(floor/ceiling/4 walls), returned in the *lidar* frame with the Hilti extrinsic
inverted, so the pipeline's own extrinsic handling is exercised.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation


def _traj_pose(t, speed=1.0, rot_scale=1.0, origin=(0.0, 0.0, 0.0), travel=0.0, climb=0.0):
    """Smooth trajectory: position + rotation (scipy) at times t (vectorized).

    Starts AT REST with identity attitude (smoothstep envelope with zero initial
    velocity): the odometry — like the reference — encodes zero initial velocity
    by construction (the first two IMU states share pos=0, lidar_odometry.cc:379)
    and anchors its world frame at the initial body pose, so a moving start would
    be unobservable initialization error, not algorithm error.

    ``rot_scale`` multiplies both the angular amplitudes and frequencies, so the
    peak body rate grows ~quadratically (rot_scale=3 peaks near 110 deg/s —
    aggressive handheld motion). ``origin`` translates the whole trajectory.
    ``travel``/``climb`` add a sustained drift velocity (m/s along x / z, under
    the same smoothstep), so long runs cover real distance — this is what
    pushes the pipeline's own world coordinates far from its voxel-grid origin.
    """
    t = np.asarray(t)
    ramp = np.clip(t / 2.0, 0.0, 1.0)
    s = ramp * ramp * (3.0 - 2.0 * ramp)  # smoothstep: s(0)=s'(0)=0
    pos = np.stack(
        [
            (2.0 * np.sin(0.4 * speed * t) + travel * t) * s,
            1.5 * np.sin(0.3 * speed * t) * s,
            (0.3 * np.sin(0.23 * speed * t) + climb * t) * s,
        ],
        axis=-1,
    ) + np.asarray(origin, float)
    rs = rot_scale
    yaw = (0.5 * rs * np.sin(0.21 * rs * speed * t) + 0.1 * speed * t) * s
    pitch = 0.12 * rs * np.sin(0.33 * rs * speed * t) * s
    roll = 0.1 * rs * np.sin(0.27 * rs * speed * t) * s
    rot = Rotation.from_euler("zyx", np.stack([yaw, pitch, roll], axis=-1))
    return pos, rot


class SyntheticSequence:
    """Deterministic synthetic lidar-inertial sequence.

    Attributes after construction:
      imu: list of (t, acc (3,), gyr (3,)) at `imu_rate`
      scans: list of (times (N,), points_lidar (N, 3)) per 0.1 s scan packet
      gt_pos(t), gt_rot(t): ground truth sampling (world frame, body->world)
    """

    def __init__(
        self,
        duration: float = 10.0,
        imu_rate: float = 200.0,
        points_per_scan: int = 2000,
        scan_period: float = 0.1,
        room_half: float = 8.0,
        noise_range: float = 0.003,
        outlier_fraction: float = 0.0,
        gravity: float = 9.81,
        speed: float = 1.0,
        seed: int = 0,
        ext_rot: np.ndarray | None = None,
        ext_pos: np.ndarray | None = None,
        geometry: str = "room",
        origin: tuple = (0.0, 0.0, 0.0),
        rot_scale: float = 1.0,
        travel: float = 0.0,
        pillar_spacing: float = 0.0,
        door_spacing: float = 0.0,
        ramp_slope: float = 0.15,
    ):
        """``geometry`` selects the raycast world (all centered on ``origin``):
        - "room": axis-aligned box (floor/ceiling/4 walls) — planar, the nominal
          regime of the reference's Hilti indoor sequences.
        - "cylinder": vertical cylindrical shell of radius ``room_half`` plus
          floor/ceiling — curved walls, so surfel planes are only locally valid
          (exercises plane-likeness gating and small-patch matching).
        - "ramp": endless corridor along x (walls y=±``room_half``/2, ceiling)
          whose floor is a 15% grade inclined plane — non-axis-aligned planes.
          NOTE the bare corridor has a continuous translational symmetry along
          the slope direction (1, 0, 0.15): every plane normal is orthogonal to
          it, so motion along the corridor is fundamentally unobservable from
          lidar (the classic corridor degeneracy) and position drifts along
          that direction by design. Set ``pillar_spacing`` > 0 to line the
          walls with box pillars, or ``door_spacing`` > 0 to add doorway
          bulkheads (full cross-walls with a 4 m x 2.75 m door hole) — large
          ±x-normal planes that make travel along the corridor observable. With ``travel`` > 0
          the trajectory climbs the ramp (climb = 0.15*travel keeps the sensor
          ~1 m above the floor), covering real distance — exercises the voxel
          key packing far from the origin (voxel.py packs cell coords into
          20-bit fields: ±104 km at 0.2 m cells) and the f32 window-time
          rebase over many cycles.
        ``origin`` translates trajectory + world (ground truth is offset; the
        pipeline's own frame is anchored at the initial pose regardless).
        ``rot_scale`` drives aggressive angular rates (see ``_traj_pose``).
        """
        rng = np.random.default_rng(seed)
        self.speed = speed
        self.rot_scale = rot_scale
        self.origin = np.asarray(origin, float)
        self.travel = travel
        self.climb = ramp_slope * travel if geometry == "ramp" else 0.0
        self.g_w = np.array([0.0, 0.0, -gravity])
        dt = 1.0 / imu_rate
        n = int(duration * imu_rate) + 3

        t_imu = np.arange(n) * dt
        pos, rot = _traj_pose(t_imu, speed, rot_scale, origin, travel, self.climb)
        rmat = rot.as_matrix()

        # gyro: solve the midpoint recurrence forward (w0 from analytic rate)
        rel = (rot[:-1].inv() * rot[1:]).as_rotvec()  # Log(R_k^T R_{k+1})
        w = np.zeros((n, 3))
        w[0] = rel[0] / dt  # good first approximation
        for k in range(n - 1):
            w[k + 1] = 2.0 * rel[k] / dt - w[k]

        # accel: invert the second-difference rule
        acc = np.zeros((n, 3))
        pdd = (pos[2:] - 2 * pos[1:-1] + pos[:-2]) / (dt * dt)
        acc[: n - 2] = np.einsum("nij,nj->ni", rmat[: n - 2].transpose(0, 2, 1), pdd - self.g_w)
        acc[n - 2 :] = acc[n - 3]

        self.imu = [(t_imu[k], acc[k], w[k]) for k in range(n)]
        self._rot = rot
        self._pos = pos
        self._t_imu = t_imu

        # extrinsic (defaults to the Hilti rig of the config)
        if ext_rot is None:
            ext_rot = np.array(
                [[-5.32125e-08, -1.0, 0.0], [-1.0, -5.32125e-08, -0.0], [0.0, 0.0, -1.0]]
            )
        if ext_pos is None:
            ext_pos = np.array([-0.001, -0.00855, 0.055])
        inv_rot = ext_rot.T
        inv_pos = -inv_rot @ ext_pos

        # lidar scans: raycast into the scene surfaces (planes + optional
        # cylindrical shell), all expressed relative to `origin`
        self.scans = []
        half = room_half
        if geometry == "room":
            normals = np.array(
                [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]], float
            )
            offsets = np.array([half, half, half, half, 1.0, 3.0])  # floor z=-1, ceil z=3
            cyl_radius = None
        elif geometry == "cylinder":
            normals = np.array([[0, 0, 1], [0, 0, -1]], float)
            offsets = np.array([1.0, 3.0])
            cyl_radius = half
        elif geometry == "ramp":
            # endless corridor along x; floor plane z = 0.15 x - 1 (15% grade),
            # ceiling parallel to it 4 m above: n.p + off = 0 form below
            w = half / 2.0
            normals = np.array(
                [[0, 1, 0], [0, -1, 0], [-ramp_slope, 0, 1], [ramp_slope, 0, -1]], float
            )
            offsets = np.array([w, w, 1.0, 3.0])
            cyl_radius = None
            if pillar_spacing > 0.0:
                # box pillars alternating along both walls, spanning the local
                # floor..ceiling cross-section — break the corridor's
                # translational symmetry so travel becomes observable
                total = abs(travel) * duration + 4 * half
                k = np.arange(-int(2 * half / pillar_spacing) - 1,
                              int((total + 2 * half) / pillar_spacing) + 2)
                xc = k * pillar_spacing
                yc = np.where(k % 2 == 0, w - 0.4, -(w - 0.4))
                zlo = ramp_slope * xc - 1.2
                zhi = ramp_slope * xc + 3.2
                a = 0.3  # half-extents
                boxes = np.stack(
                    [xc - a, xc + a, yc - a, yc + a, zlo, zhi], axis=1
                )  # (P, 6): xlo xhi ylo yhi zlo zhi
            else:
                boxes = None
        else:
            raise ValueError(f"unknown geometry {geometry!r}")
        if geometry != "ramp":
            boxes = None
        n_scans = int(duration / scan_period)
        for s in range(n_scans):
            ts = s * scan_period + np.sort(rng.uniform(0, scan_period, points_per_scan))
            p_s, r_s = _traj_pose(ts, speed, rot_scale, origin, travel, self.climb)
            # random directions, mildly downward-biased like a real spinning lidar
            az = rng.uniform(-np.pi, np.pi, points_per_scan)
            el = rng.uniform(-0.45, 0.45, points_per_scan)
            d_body = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], axis=1)
            d_w = np.einsum("nij,nj->ni", r_s.as_matrix(), d_body)

            # first positive intersection among the planes: n.x = -offset
            # plane: n . x + off = 0 -> t = -(n.p + off) / (n.d), in local coords
            p_l = p_s - self.origin
            num = -(p_l @ normals.T + offsets)  # (N, P)
            den = d_w @ normals.T
            tt = np.where(den != 0, num / den, np.inf)
            tt = np.where(tt > 1e-6, tt, np.inf)
            t_hit = tt.min(axis=1)
            if boxes is not None:
                # ray-AABB slab test against the near pillars (entry hit only)
                near = boxes[np.abs(boxes[:, 0] - p_l[:, 0].mean()) < 130.0 + 4 * half]
                if len(near):
                    lo = near[:, 0::2]  # (P, 3)
                    hi = near[:, 1::2]
                    with np.errstate(divide="ignore", invalid="ignore"):
                        t1 = (lo[None] - p_l[:, None, :]) / d_w[:, None, :]
                        t2 = (hi[None] - p_l[:, None, :]) / d_w[:, None, :]
                    tmin = np.nanmax(np.minimum(t1, t2), axis=2)  # (N, P)
                    tmax = np.nanmin(np.maximum(t1, t2), axis=2)
                    hit = (tmax >= tmin) & (tmin > 1e-6)
                    tb = np.where(hit, tmin, np.inf).min(axis=1)
                    t_hit = np.minimum(t_hit, tb)
            if geometry == "ramp" and door_spacing > 0.0:
                # doorway bulkheads: opaque planes x = k*D except a door hole
                # (|y| <= 2, 0.05 <= z - floor(kD) <= 2.8). A ray can pass
                # through several door holes; check the first few bulkheads in
                # ray order and take the first opaque hit.
                D = door_spacing
                dx = d_w[:, 0]
                px = p_l[:, 0]
                k0 = np.where(dx >= 0, np.ceil(px / D + 1e-9), np.floor(px / D - 1e-9))
                step = np.where(dx >= 0, 1.0, -1.0)
                t_door = np.full(len(px), np.inf)
                hit_found = np.zeros(len(px), bool)
                for j in range(6):
                    k = k0 + j * step
                    with np.errstate(divide="ignore", invalid="ignore"):
                        tk = (k * D - px) / dx
                    yk = p_l[:, 1] + tk * d_w[:, 1]
                    zk = p_l[:, 2] + tk * d_w[:, 2]
                    zrel = zk - (ramp_slope * k * D - 1.0)
                    through = (np.abs(yk) <= 2.0) & (zrel >= 0.05) & (zrel <= 2.8)
                    solid = np.isfinite(tk) & (tk > 1e-6) & ~through & ~hit_found
                    t_door = np.where(solid, tk, t_door)
                    hit_found = hit_found | solid
                t_hit = np.minimum(t_hit, t_door)
            if cyl_radius is not None:
                # |p_xy + t d_xy|^2 = R^2: smallest positive root per ray
                a = np.sum(d_w[:, :2] ** 2, axis=1)
                bq = np.sum(p_l[:, :2] * d_w[:, :2], axis=1)
                cq = np.sum(p_l[:, :2] ** 2, axis=1) - cyl_radius**2
                disc = bq * bq - a * cq
                sq = np.sqrt(np.maximum(disc, 0.0))
                roots = np.stack([(-bq - sq), (-bq + sq)], axis=1) / np.maximum(a, 1e-12)[:, None]
                roots = np.where((disc[:, None] >= 0) & (roots > 1e-6), roots, np.inf)
                t_hit = np.minimum(t_hit, roots.min(axis=1))
            ok = np.isfinite(t_hit)
            t_hit = np.where(ok, t_hit, 1.0)
            hits_w = p_s + d_w * t_hit[:, None]
            hits_w += rng.normal(scale=noise_range, size=hits_w.shape) * d_w  # range noise
            if outlier_fraction > 0.0:
                # floating clutter / dynamic-object returns at random ranges —
                # exercises the Cauchy robustification of the surfel factors
                n_out = int(outlier_fraction * points_per_scan)
                which = rng.choice(points_per_scan, n_out, replace=False)
                hits_w[which] = p_s[which] + d_w[which] * rng.uniform(0.5, 6.0, (n_out, 1))

            # world -> imu body -> lidar frame
            hits_b = np.einsum("nij,nj->ni", r_s.as_matrix().transpose(0, 2, 1), hits_w - p_s)
            hits_l = hits_b @ inv_rot.T + inv_pos
            self.scans.append((ts[ok], hits_l[ok]))

    def gt_pose(self, t):
        """Ground-truth (pos, rot wxyz quaternion) at times t."""
        pos, rot = _traj_pose(
            np.asarray(t), self.speed, self.rot_scale, self.origin, self.travel, self.climb
        )
        q = rot.as_quat()  # xyzw
        return pos, np.concatenate([q[..., 3:4], q[..., :3]], axis=-1)


def ate_rmse(traj, gt_pos_fn, align: bool = True):
    """Absolute trajectory error of [(t, pos, quat)] vs ground truth positions.
    With ``align=True`` a rigid (SE3, Umeyama without scale) alignment is applied
    first — the standard ATE protocol."""
    t = np.array([e[0] for e in traj])
    p = np.stack([e[1] for e in traj])
    g = gt_pos_fn(t)
    if align and len(traj) >= 3:
        mu_p, mu_g = p.mean(0), g.mean(0)
        pc, gc = p - mu_p, g - mu_g
        u, _, vt = np.linalg.svd(pc.T @ gc)
        d = np.sign(np.linalg.det(vt.T @ u.T))
        r = vt.T @ np.diag([1, 1, d]) @ u.T
        p = (r @ pc.T).T + mu_g
    return float(np.sqrt(np.mean(np.sum((p - g) ** 2, axis=1))))
