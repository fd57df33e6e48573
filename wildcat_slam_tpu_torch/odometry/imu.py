"""IMU handling: uniform-rate resampling (host) and on-device propagation.

Counterpart of ``wildcat_slam_tpu/odometry/imu.py``. ``ImuResampler`` is the
host-side numpy class, copied because its JAX module imports jax. The device
half: :func:`propagate` (the velocity-free second-difference recurrence,
unrolled into a quaternion prefix product and two running sums),
:func:`interp_pose` and :func:`undistort_points`.
"""

from __future__ import annotations

import numpy as np
import torch

from wildcat_slam_tpu_torch.odometry.states import ImuStates
from wildcat_slam_tpu_torch.ops import lie


class ImuResampler:
    """Linear-interpolating resampler onto the uniform grid ``t0 + k / rate``:
    the first raw sample anchors the grid; each later grid target is lerped
    from its bracketing raw pair."""

    def __init__(self, rate: float):
        self.rate = float(rate)
        self._grid_k = 0
        self._t0 = None
        self._prev = None

    def add(self, t: float, acc, gyr):
        """Feed one raw sample; returns a list of (t, acc, gyr) grid outputs.
        Raises on out-of-order raw samples."""
        if self._prev is not None and t < self._prev[0]:
            raise ValueError(
                f"IMU sample at {t:.6f} arrived before the previous raw sample "
                f"{self._prev[0]:.6f}; IMU messages must be time-ordered")
        acc = np.asarray(acc, np.float64)
        gyr = np.asarray(gyr, np.float64)
        out = []
        if self._t0 is None:
            self._t0 = float(t)
            self._prev = (float(t), acc, gyr)
            self._grid_k = 1
            return [(float(t), acc, gyr)]
        tp, accp, gyrp = self._prev
        while True:
            target = self._t0 + self._grid_k / self.rate
            if target > t:
                break
            if target >= tp:
                f = 0.0 if t == tp else (target - tp) / (t - tp)
                out.append((target, (1 - f) * accp + f * acc, (1 - f) * gyrp + f * gyr))
            self._grid_k += 1
        self._prev = (float(t), acc, gyr)
        return out

    def get_state(self) -> np.ndarray:
        """Serializable state (checkpoint support): 11 doubles, the layout of
        the JAX package's numpy and native (native/feeder.cc) resamplers, so a
        checkpoint written with either restores here."""
        out = np.zeros(11, np.float64)
        if self._t0 is not None:
            out[0] = 1.0
            out[1] = self._grid_k
            out[2] = self._t0
            out[3], out[4:7], out[7:10] = self._prev[0], self._prev[1], self._prev[2]
        return out

    def set_state(self, st: np.ndarray) -> None:
        st = np.asarray(st, np.float64)
        if st[0] != 0.0:
            self._grid_k = int(st[1])
            self._t0 = float(st[2])
            self._prev = (float(st[3]), st[4:7].copy(), st[7:10].copy())
        else:
            self._grid_k, self._t0, self._prev = 0, None, None


def put_rows(buf: torch.Tensor, vals: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Write ``vals`` into rows [start, start + len) of a copy of ``buf``. The
    start is clamped so the block fits, as ``lax.dynamic_update_slice`` does."""
    k = vals.shape[0]
    s = torch.clamp(start, 0, buf.shape[0] - k)
    rows = s + torch.arange(k, device=buf.device)
    out = buf.clone()
    out[rows] = vals.to(buf.dtype)
    return out


def row_at(buf: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``buf[i]`` with the index clamped into range (``lax.dynamic_slice``).
    ``i`` is a 0-dim device tensor: an index_select, since indexing with it
    would read it on the host."""
    return torch.index_select(buf, 0, torch.clamp(i, 0, buf.shape[0] - 1).reshape(1))[0]


def quat_prefix_product(dq: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix product dq_0 * dq_1 * ... * dq_n along axis 0, as a
    log-step (Hillis-Steele) scan: ceil(log2 K) batched products instead of K
    sequential ones. The association order differs from
    ``lax.associative_scan``'s, so results agree to rounding."""
    out = dq
    off = 1
    while off < out.shape[0]:
        out = torch.cat([out[:off], lie.quat_mul(out[:-off], out[off:])])
        off *= 2
    return out


def propagate(imu: ImuStates, new_t, new_acc, new_gyr, new_count, bg, ba, grav,
              dt: float) -> ImuStates:
    """Append K new IMU states predicted by the second-difference recurrence.
    Requires imu.count >= 2."""
    k = new_t.shape[0]
    c = imu.count
    p1, r1, a1 = row_at(imu.pos, c - 2), row_at(imu.rot, c - 2), row_at(imu.acc, c - 2)
    p2, r2, g2 = row_at(imu.pos, c - 1), row_at(imu.rot, c - 1), row_at(imu.gyr, c - 1)
    a2 = row_at(imu.acc, c - 1)
    dtype = imu.pos.dtype
    dt2 = torch.full((), dt * dt, dtype=dtype, device=imu.pos.device)

    gyr_prev = torch.cat([g2[None], new_gyr[:-1]], 0)
    dq = lie.exp_quat(((gyr_prev + new_gyr) / 2.0 - bg) * dt)
    rot_new = lie.quat_normalize(lie.quat_mul(r2[None], quat_prefix_product(dq)))

    rot_acc = torch.cat([r1[None], r2[None], rot_new[: k - 2]], 0)
    acc_acc = torch.cat([a1[None], a2[None], new_acc[: k - 2]], 0)
    accw = lie.quat_rotate(rot_acc, acc_acc - ba) + grav
    v = (p2 - p1)[None] + dt2 * torch.cumsum(accw, 0)
    pos_new = p2[None] + torch.cumsum(v, 0)
    return imu.replace(
        t=put_rows(imu.t, new_t, c), pos=put_rows(imu.pos, pos_new, c),
        rot=put_rows(imu.rot, rot_new, c), acc=put_rows(imu.acc, new_acc, c),
        gyr=put_rows(imu.gyr, new_gyr, c), count=c + new_count)


def init_from_first_two(imu: ImuStates, t, acc, gyr, dt: float) -> ImuStates:
    """Window bootstrap: state 0 at identity/origin, state 1 rotated by the
    averaged gyro over one tick."""
    rot1 = lie.exp_quat(((gyr[0] + gyr[1]) / 2.0) * dt)
    rot = torch.stack([lie.quat_identity((), rot1.dtype, rot1.device), rot1])

    def set2(buf, v):
        out = buf.clone()
        out[:2] = v
        return out

    return imu.replace(t=set2(imu.t, t.to(imu.t.dtype)), rot=set2(imu.rot, rot.to(imu.rot.dtype)),
                       pos=set2(imu.pos, 0.0), acc=set2(imu.acc, acc.to(imu.acc.dtype)),
                       gyr=set2(imu.gyr, gyr.to(imu.gyr.dtype)),
                       count=torch.full_like(imu.count, 2))


def bracket_indices(imu: ImuStates, query_t: torch.Tensor) -> torch.Tensor:
    """Index of the first valid IMU state with ``t >= query`` (lower_bound),
    clamped to [1, count-1]. O(1) arithmetic on the uniform grid plus two
    monotone corrections against the stored times."""
    big = torch.finfo(imu.t.dtype).max
    t_pad = torch.where(imu.mask, imu.t, big)
    q = query_t.to(imu.t.dtype)
    n = imu.t.shape[0]
    rate = 1.0 / (imu.t[1] - imu.t[0])
    idx = torch.clip(torch.floor((q - imu.t[0]) * rate).to(torch.int64), 0, n - 1)
    for _ in range(2):
        idx = torch.where(t_pad[idx] < q, torch.clamp(idx + 1, max=n - 1), idx)
    return torch.minimum(torch.clamp(idx, min=1), imu.count - 1)


def interp_pose(imu: ImuStates, query_t: torch.Tensor):
    """Pose at query times by lerp(pos)/slerp(rot) between bracketing IMU
    states. Returns (pos (Q,3), rot (Q,4))."""
    idx = bracket_indices(imu, query_t)
    t0 = imu.t[idx - 1]
    t1 = imu.t[idx]
    tiny = torch.finfo(imu.t.dtype).tiny
    f = (query_t.to(imu.t.dtype) - t0) / torch.clamp(t1 - t0, min=tiny)
    f = torch.clip(f, 0.0, 1.0).to(imu.pos.dtype)
    pos = imu.pos[idx - 1] * (1.0 - f)[..., None] + imu.pos[idx] * f[..., None]
    return pos, lie.quat_slerp(imu.rot[idx - 1], imu.rot[idx], f)


def _interp_pose_sorted(imu: ImuStates, query_t: torch.Tensor):
    """interp_pose for a time-sorted query vector (a sweep's point stamps).

    Run boundaries come from the dual search of the JAX version: the first
    point of tick k's bracket run is ``searchsorted(query_t, t[k-1],
    right)``, with runs 0 and 1 both starting at point 0 and runs past
    count-1 never starting. The JAX version then scatter-adds per-tick
    differences at those starts (a float scatter with duplicate indices and
    ``mode="drop"``) and takes a running sum over the points, which
    telescopes to ``vals[k]`` for the last tick k whose run starts at or
    before the point. Here that tick index is found directly with a second
    searchsorted over the (non-decreasing) run starts and ``vals`` is
    gathered at it: the same bracketing, no duplicate-index scatter (so no
    atomics and no run-to-run variation on CUDA), and no rounding from the
    telescoped sum.
    """
    query_t = torch.cummax(query_t, 0).values
    k_cap = imu.t.shape[0]
    p_cap = query_t.shape[0]
    dev = imu.t.device

    def prev(a):
        return torch.cat([a[:1], a[:-1]], 0)

    big = torch.finfo(imu.t.dtype).max
    j = torch.arange(k_cap, device=dev)
    tj = torch.where((j >= 1) & (j <= imu.count - 2), imu.t, big)
    bound = torch.cat([torch.full((2,), -big, dtype=imu.t.dtype, device=dev), tj[1:k_cap - 1]])
    qt = query_t.to(imu.t.dtype).contiguous()
    starts = torch.searchsorted(qt, bound.contiguous(), right=True)        # (K,) sorted
    tick = torch.searchsorted(starts, torch.arange(p_cap, device=dev), right=True) - 1

    dtype = imu.pos.dtype
    t1 = imu.t.to(dtype)[tick]
    t0 = prev(imu.t).to(dtype)[tick]
    pos1, pos0 = imu.pos[tick], prev(imu.pos)[tick]
    rot1, rot0 = imu.rot[tick], prev(imu.rot)[tick]
    f = (query_t.to(dtype) - t0) / torch.clamp(t1 - t0, min=torch.finfo(dtype).tiny)
    f = torch.clip(f, 0.0, 1.0)
    pos = pos0 * (1.0 - f)[..., None] + pos1 * f[..., None]
    return pos, lie.quat_slerp(rot0, rot1, f)


def undistort_points(imu: ImuStates, pt_t, pt_xyz, sorted_t: bool = False):
    """Transform each point into the world frame with the interpolated pose at
    its timestamp. ``sorted_t=True`` takes the sorted-stamp path."""
    if sorted_t:
        pos, rot = _interp_pose_sorted(imu, pt_t)
    else:
        pos, rot = interp_pose(imu, pt_t)
    return lie.quat_rotate(rot, pt_xyz) + pos
