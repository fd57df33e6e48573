"""The odometry pipeline: host feeder + one per-sweep window step on the device.

Counterpart of ``wildcat_slam_tpu/odometry/pipeline.py`` (single-window
offline path). The host buffers sensor data, decides sweep boundaries and
feeds padded arrays with host-computed counts (absolute times stay float64 on
the host; the device sees window-relative times); :func:`process_sweep` runs
IMU propagation, sample-state creation, undistortion, surfel extraction,
window merging, matching, the LM solve and the post-solve updates.

The JAX version donates the state to its jitted step. Here every step builds
new tensors for the fields it changes and returns a new ``WindowState``; the
old one is dropped by the caller, so nothing is updated in place.

Not ported yet: ``chunk_sweeps > 1`` (``process_sweeps_chained``, rejected
with ``NotImplementedError``), the native feeder, cloud collection.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import List, Optional

import numpy as np
import torch

from wildcat_slam_tpu_torch import _numerics
from wildcat_slam_tpu_torch.config import WildcatConfig
from wildcat_slam_tpu_torch.odometry import corrections as cor_mod
from wildcat_slam_tpu_torch.odometry import factors as fmod
from wildcat_slam_tpu_torch.odometry import imu as imu_mod
from wildcat_slam_tpu_torch.odometry import window as win_mod
from wildcat_slam_tpu_torch.odometry._ptbuf import ChunkedPointBuffer
from wildcat_slam_tpu_torch.odometry.match import match_surfels
from wildcat_slam_tpu_torch.odometry.solver import residual_snapshot, solve_window
from wildcat_slam_tpu_torch.odometry.states import (ImuStates, SampleStates, Surfels,
                                                    TensorStruct, concat)
from wildcat_slam_tpu_torch.odometry.surfel import extract_surfels


class OutOfOrderError(ValueError):
    """A sensor message broke the time order that add_imu/add_scan require.
    The message is refused before any state changes, so a caller may drop it
    and go on (the CLI's drop-and-count policy)."""


@dataclasses.dataclass
class WindowState(TensorStruct):
    sample: SampleStates
    imu: ImuStates
    sld: Surfels
    fix: Surfels
    # cached pack_geo_rows(fix): (max_surfels_fixed, 12); fixed-window poses
    # are frozen after insertion, so only the inserted rows are refreshed
    fix_geo: torch.Tensor

    @classmethod
    def empty(cls, cfg: WildcatConfig, dtype, device) -> "WindowState":
        return cls(sample=SampleStates.empty(cfg.max_sample_states, dtype, device),
                   imu=ImuStates.empty(cfg.max_imu_states, dtype, device),
                   sld=Surfels.empty(cfg.max_surfels_sliding, dtype, device),
                   fix=Surfels.empty(cfg.max_surfels_fixed, dtype, device),
                   fix_geo=torch.zeros((cfg.max_surfels_fixed, 12), dtype=dtype, device=device))


def init_window(state: WindowState, imu_t, imu_acc, imu_gyr, cfg: WildcatConfig) -> WindowState:
    """Window bootstrap from the first two IMU samples: two IMU states, one
    sample state at the first IMU time, gravity from the first accelerometer
    direction."""
    imu = imu_mod.init_from_first_two(state.imu, imu_t, imu_acc, imu_gyr, cfg.imu_dt)
    a0 = imu_acc[0]
    grav = -cfg.gravity_norm * a0 / torch.sqrt(torch.sum(a0 * a0))
    s = state.sample
    t, rot, pos = s.t.clone(), s.rot.clone(), s.pos.clone()
    t[0] = imu_t[0].to(t.dtype)
    rot[0] = imu.rot[0]
    pos[0] = imu.pos[0]
    sample = s.replace(t=t, rot=rot, pos=pos, count=torch.ones_like(s.count),
                       grav=grav.to(s.grav.dtype))
    return state.replace(sample=sample, imu=imu)


def process_sweep(state: WindowState, imu_t, imu_acc, imu_gyr, imu_n, sample_t, sample_n,
                  pts, pts_t, pts_n, n_sample_drop, n_imu_drop, fix_first_pos,
                  cfg: WildcatConfig):
    """One full sweep step on the device. Returns (state, outputs): outputs
    holds "packed", the (22,) float32 per-sweep outputs (layout as in the JAX
    package), and with ``cfg.debug_residuals`` the post- and pre-solve
    residual snapshots "residuals" and "residuals_pre" of the last outer
    iteration (``solver.residual_snapshot``)."""
    sample, imu = state.sample, state.imu
    dtype = sample.pos.dtype
    dev = sample.pos.device

    back_cor = imu_mod.row_at(sample.cor, sample.count - 1)
    imu = imu_mod.propagate(imu, imu_t, imu_acc, imu_gyr, imu_n, back_cor[6:9],
                            back_cor[9:12], sample.grav, cfg.imu_dt)
    sample = win_mod.add_sample_states(sample, imu, sample_t, sample_n)
    pred_pos = imu_mod.row_at(sample.pos, sample.count - 1)

    pts_valid = torch.arange(pts.shape[0], device=dev) < pts_n
    pts_world = imu_mod.undistort_points(imu, pts_t, pts, sorted_t=cfg.sorted_undistort)
    sweep_surf = extract_surfels(pts_world, pts_t, pts_valid, cfg)
    new_surfels = cor_mod.attach_surfel_poses(
        sweep_surf["t"], sweep_surf["center"], sweep_surf["cov"], sweep_surf["norm"],
        sweep_surf["resolution"], sweep_surf["std"], sweep_surf["valid"], imu)
    sld, sld_evicted = win_mod.insert_surfels(state.sld, new_surfels)
    fix, fix_geo = state.fix, state.fix_geo

    weights = (cfg.weight_gyr, cfg.weight_acc, cfg.weight_bg, cfg.weight_ba)
    match_kw = dict(center_dist=cfg.match_center_dist, angular_dist=cfg.match_angular_dist,
                    surfel_dist=cfg.match_surfel_dist, time_diff=cfg.match_time_diff,
                    k=cfg.match_knn, max_pairs=cfg.max_correspondences,
                    approx=cfg.match_knn_approx)
    for _ in range(cfg.outer_iter_num_max):
        c_sld, n_sld = sld.center_world(), sld.norm_world()
        c_fix, n_fix = fix_geo[:, 6:9], fix_geo[:, 9:12]
        iq_s, it_s, pv_s, drop_s = match_surfels(
            c_sld, n_sld, sld.t, sld.valid, c_sld, n_sld, sld.t, sld.valid,
            self_match=True, **match_kw)
        iq_f, it_f, pv_f, drop_f = match_surfels(
            c_sld, n_sld, sld.t, sld.valid, c_fix, n_fix, fix.t, fix.valid,
            self_match=False, **match_kw)
        sld_pack = fmod.pack_factor_rows(sld)
        fix_pack = fmod.pack_factor_rows_from_geo(fix, fix_geo)
        sfac = concat(
            fmod.build_surfel_factors(sld, sld, iq_s, it_s, pv_s, sample, cfg.surfel_sigma_floor,
                                      target_optimized=True, sq_pack=sld_pack, st_pack=sld_pack),
            fmod.build_surfel_factors(sld, fix, iq_f, it_f, pv_f, sample, cfg.surfel_sigma_floor,
                                      target_optimized=False, sq_pack=sld_pack, st_pack=fix_pack))
        ifac = fmod.build_imu_factors(imu, sample, max_factors=cfg.max_imu_states)
        if cfg.degeneracy_remap:
            w_t, w_r, deg_t, deg_r = fmod.degeneracy_projectors(
                sfac, pred_pos, cfg.degeneracy_remap_ratio)
            remap_proj = (w_t, w_r)
        else:
            deg_t, deg_r = fmod.direction_coverage(sfac, pred_pos)
            remap_proj = None
        if cfg.debug_residuals:
            res_pre = residual_snapshot(sample, sfac, ifac, weights, cfg.imu_dt, sample.grav)
        sample, sstats = solve_window(
            sample, sfac, ifac, weights, cfg.imu_dt, sample.grav, fix_first_pos,
            cauchy_scale=cfg.cauchy_loss_scale, max_iterations=cfg.inner_iter_num_max,
            init_lambda=cfg.gn_initial_lambda, function_tolerance=cfg.gn_function_tolerance,
            linear_solver=cfg.linear_solver, pcg_iters=cfg.pcg_iters, pcg_tol=cfg.pcg_tol,
            n_binary=cfg.max_correspondences, remap_proj=remap_proj)
        if cfg.debug_residuals:
            res_post = residual_snapshot(sample, sfac, ifac, weights, cfg.imu_dt, sample.grav)
        stats = [sstats.iterations, sstats.initial_cost, sstats.final_cost,
                 new_surfels.count, torch.sum(pv_s.to(torch.int64)),
                 torch.sum(pv_f.to(torch.int64))]
        tail = [sweep_surf["n_dropped"], drop_s + drop_f, deg_t, deg_r, sstats.lambda_final]
        imu = cor_mod.update_imu_poses(sample, imu, cfg.imu_dt)
        sld = cor_mod.update_surfel_poses(sld, imu)
        sample = sample.apply_corrections()

    shl = win_mod.shift_left
    sample2 = sample.replace(t=shl(sample.t, n_sample_drop), rot=shl(sample.rot, n_sample_drop),
                             pos=shl(sample.pos, n_sample_drop), cor=shl(sample.cor, n_sample_drop),
                             count=sample.count - n_sample_drop)
    imu2 = imu.replace(t=shl(imu.t, n_imu_drop), rot=shl(imu.rot, n_imu_drop),
                       pos=shl(imu.pos, n_imu_drop), acc=shl(imu.acc, n_imu_drop),
                       gyr=shl(imu.gyr, n_imu_drop), count=imu.count - n_imu_drop)
    sld, moved = win_mod.extract_moved(sld, imu2.t[0], cfg.max_surfels_per_sweep * 2)
    incoming = concat(sld_evicted, moved)
    fix, _, fix_geo = win_mod.insert_surfels(fix, incoming, win_aux=fix_geo,
                                             new_aux=fmod.pack_geo_rows(incoming))
    fix_newest = torch.max(torch.where(fix.valid, fix.t, torch.finfo(dtype).min))
    fix = fix.replace(valid=fix.valid & (fix.t >= fix_newest - cfg.fixed_window_duration))
    sample2, imu2, sld, fix, shift = win_mod.rebase_times(sample2, imu2, sld, fix)

    pose_idx = sample2.count - 1
    f32 = lambda v: torch.as_tensor(v, device=dev).to(torch.float32).reshape(-1)
    packed = torch.cat([f32(sample2.pos[pose_idx]), f32(sample2.rot[pose_idx]), f32(shift)]
                       + [f32(v) for v in stats] + [f32(pred_pos)] + [f32(v) for v in tail])
    outputs = dict(packed=packed)
    if cfg.debug_residuals:
        outputs.update(residuals=res_post, residuals_pre=res_pre)
    return state.replace(sample=sample2, imu=imu2, sld=sld, fix=fix, fix_geo=fix_geo), outputs


class LidarOdometry:
    """Host-facing odometry frontend.

    Usage:
        lo = LidarOdometry(WildcatConfig(), device="cuda")
        lo.add_imu(t, acc, gyr)          # raw IMU, any rate
        lo.add_scan(times, points_lidar) # one lidar scan (lidar frame)
        lo.trajectory                    # [(t, pos(3), quat wxyz(4)), ...]
    """

    def __init__(self, cfg: WildcatConfig = WildcatConfig(), *, device, chunk_sweeps: int = 1):
        if chunk_sweeps != 1:
            raise NotImplementedError(
                "chunk_sweeps > 1 is not ported to wildcat_slam_tpu_torch yet (ROADMAP.md); "
                "use the JAX package wildcat_slam_tpu for it")
        _numerics.apply()
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but torch.cuda.is_available() is False")
        if self.device.type == "cuda" and cfg.dtype != "float32" and cfg.linear_solver == "pcg":
            raise ValueError(
                f"dtype={cfg.dtype!r} with linear_solver='pcg' cannot run on the card: kernel K1 "
                "(csrc/pcg.cu) takes float32; use dtype='float32', or linear_solver='pcg_xla' "
                "or 'cholesky' for float64 there")
        self.dtype = torch.float32 if cfg.dtype == "float32" else torch.float64
        self._np_dtype = np.float32 if cfg.dtype == "float32" else np.float64
        self.state = WindowState.empty(cfg, self.dtype, self.device)
        self.resampler = imu_mod.ImuResampler(cfg.imu_rate)
        self.points = ChunkedPointBuffer(cfg)
        self.imu_queue: List[tuple] = []
        self._last_raw_imu_t: Optional[float] = None
        self._warned_overflow = False
        self.synced = False
        self.initialized = False
        self.epoch: Optional[float] = None
        self.sample_times: List[float] = []
        self.imu_front_time: Optional[float] = None
        self.fix_first = True
        self.sweep_id = 0
        self._trajectory: List[tuple] = []
        self._stats: List[dict] = []
        # host seconds per sweep: prep (feed build), step (process_sweep incl.
        # its syncs), fetch (the packed outputs' copy to the host)
        self.timing = {"prep": 0.0, "step": 0.0, "fetch": 0.0, "sweeps": 0}
        self.sweep_seconds: List[float] = []
        # with cfg.debug_residuals: per sweep the valid surfel residuals (M,)
        # and IMU residuals (Mi, 12) after ("surfel", "imu") and before
        # ("surfel_pre", "imu_pre") the solve, as numpy arrays
        self.residuals: List[dict] = []

    @property
    def trajectory(self) -> List[tuple]:
        return self._trajectory

    @trajectory.setter
    def trajectory(self, value) -> None:  # checkpoint restore
        self._trajectory = list(value)

    @property
    def stats(self) -> List[dict]:
        return self._stats

    def add_imu(self, t: float, acc, gyr):
        """One raw IMU message (time-ordered)."""
        if self._last_raw_imu_t is not None and t < self._last_raw_imu_t:
            raise OutOfOrderError(
                f"IMU sample at {t:.6f} arrived before the previous raw sample "
                f"{self._last_raw_imu_t:.6f}; IMU messages must be time-ordered")
        self._last_raw_imu_t = float(t)
        for tt, aa, gg in self.resampler.add(t, acc, gyr):
            self.imu_queue.append((tt, aa, gg))

    def add_scan(self, times: np.ndarray, points_lidar: np.ndarray):
        """One lidar scan: per-point absolute times (sorted) + (N, 3) points in
        the lidar frame. Runs every sweep that becomes complete."""
        times = np.ascontiguousarray(times, np.float64)
        if len(times):
            if np.any(np.diff(times) < 0):
                raise OutOfOrderError("point times within a scan must be non-decreasing")
            if len(self.points) and times[0] < self.points.back_time:
                raise OutOfOrderError(
                    f"scan starts at {times[0]:.6f} before the buffered tail "
                    f"{self.points.back_time:.6f}; scans must arrive in time order")
        self.points.add_points(times, np.ascontiguousarray(points_lidar, np.float32))
        while self._try_process():
            pass

    def _sync(self) -> bool:
        if self.synced:
            return True
        if not self.imu_queue or len(self.points) == 0:
            return False
        if self.imu_queue[-1][0] < self.points.front_time:
            return False
        while self.imu_queue and self.imu_queue[0][0] < self.points.front_time:
            self.imu_queue.pop(0)
        self.points.drop_before(self.imu_queue[0][0])
        if len(self.points) == 0:
            return False
        self.synced = True
        return True

    def _ready(self) -> bool:
        cfg = self.cfg
        if not self._sync() or len(self.points) == 0 or not self.imu_queue:
            return False
        sweep_end = self.points.front_time + cfg.sweep_duration
        if self.points.back_time < sweep_end:
            return False
        if self.imu_queue[-1][0] < sweep_end + 1.0 / cfg.imu_rate:
            return False
        if not self.initialized and len(self.imu_queue) < 2:
            return False
        return True

    def _init_args(self):
        (t0, a0, g0), (t1, a1, g1) = self.imu_queue[0], self.imu_queue[1]
        np_dtype = self._np_dtype
        self.epoch = t0
        args = (np.asarray([0.0, t1 - t0], np_dtype), np.stack([a0, a1]).astype(np_dtype),
                np.stack([g0, g1]).astype(np_dtype))
        self.imu_queue = self.imu_queue[2:]
        self.sample_times = [t0]
        self.imu_front_time = t0
        self.initialized = True
        return args

    def _to_device(self, args) -> tuple:
        """Feed arrays (numpy) as tensors on this frontend's device."""
        return tuple(torch.as_tensor(np.asarray(a)).to(self.device) for a in args)

    def _try_process(self) -> bool:
        if not self._ready():
            return False
        tm0 = time.perf_counter()
        if not self.initialized:
            self.state = init_window(self.state, *self._to_device(self._init_args()), self.cfg)
        prep = self._prepare_feed()
        args = self._to_device(prep["args"])
        tm1 = time.perf_counter()
        self.state, out = process_sweep(self.state, *args, self.cfg)
        tm2 = time.perf_counter()
        self._commit(out["packed"].cpu(), prep["back"], prep["host_stats"])  # one D2H copy per sweep
        if "residuals" in out:
            self.residuals.append(_residual_entry(out["residuals"], out["residuals_pre"]))
        tm3 = time.perf_counter()
        self.timing["prep"] += tm1 - tm0
        self.timing["step"] += tm2 - tm1
        self.timing["fetch"] += tm3 - tm2
        self.timing["sweeps"] += 1
        self.sweep_seconds.append(tm3 - tm0)
        return True

    def _prepare_feed(self) -> dict:
        """Build one sweep's padded feed arrays and commit the sweep's host
        bookkeeping; the logic of the JAX package's ``_prepare_feed``."""
        cfg = self.cfg
        sweep_end = self.points.front_time + cfg.sweep_duration
        last_sample_t = self.sample_times[-1]
        n_add = int((sweep_end - last_sample_t) / cfg.sample_dt)
        new_sample_abs = [last_sample_t + cfg.sample_dt * (k + 1) for k in range(n_add)]
        t0_grid = self.resampler._t0
        rate = cfg.imu_rate
        new_sample_abs = [t0_grid + round((t - t0_grid) * rate) / rate for t in new_sample_abs]
        sample_back_abs = new_sample_abs[-1] if new_sample_abs else last_sample_t

        feed_until = sample_back_abs + 1.5 / rate
        k_feed = 0
        while k_feed < len(self.imu_queue) and self.imu_queue[k_feed][0] < feed_until:
            k_feed += 1
        feed = self.imu_queue[:k_feed]
        self.imu_queue = self.imu_queue[k_feed:]

        np_dtype = self._np_dtype
        kmax = int(cfg.sweep_duration * cfg.imu_rate) + 32
        if k_feed > kmax:
            raise RuntimeError(f"IMU feed {k_feed} exceeds capacity {kmax}")
        imu_t = np.zeros((kmax,), np_dtype)
        imu_acc = np.zeros((kmax, 3), np_dtype)
        imu_gyr = np.zeros((kmax, 3), np_dtype)
        for i, (tt, aa, gg) in enumerate(feed):
            imu_t[i], imu_acc[i], imu_gyr[i] = tt - self.epoch, aa, gg
        amax = int(cfg.sweep_duration / cfg.sample_dt) + 8
        sam_t = np.zeros((amax,), np_dtype)
        for i, tt in enumerate(new_sample_abs):
            sam_t[i] = tt - self.epoch

        cap_p = cfg.max_points_per_sweep
        p_t = np.zeros((cap_p,), np.float32)
        p_xyz = np.zeros((cap_p, 3), np.float32)
        n_avail = self.points.count_until(sample_back_abs)
        n_pts_dropped = 0
        if n_avail > cap_p:
            tmp_t = np.zeros((n_avail,), np.float32)
            tmp_xyz = np.zeros((n_avail, 3), np.float32)
            self.points.pop_sweep(sample_back_abs, self.epoch, tmp_t, tmp_xyz)
            keep = (_voxel_decimate_indices(tmp_xyz, cap_p, cfg.decimate_voxel_size)
                    if cfg.overflow_decimate else np.arange(cap_p))
            n_pts_cap = len(keep)
            p_t[:n_pts_cap] = tmp_t[keep]
            p_xyz[:n_pts_cap] = tmp_xyz[keep]
            n_pts_dropped = n_avail - n_pts_cap
            if not self._warned_overflow:
                warnings.warn(
                    f"sweep {self.sweep_id}: {n_avail} points exceed max_points_per_sweep="
                    f"{cap_p}; " + ("voxel-decimated to fit" if cfg.overflow_decimate
                                    else "tail truncated")
                    + f" ({n_pts_dropped} dropped); per-sweep counts are in "
                    "stats['n_points_dropped'].")
                self._warned_overflow = True
        else:
            n_pts_cap = self.points.pop_sweep(sample_back_abs, self.epoch, p_t, p_xyz)

        all_samples = self.sample_times + new_sample_abs
        if len(all_samples) > cfg.max_sample_states:
            raise RuntimeError(
                f"sample window {len(all_samples)} exceeds max_sample_states="
                f"{cfg.max_sample_states}; raise the capacity")
        n_imu_after = int(round((sample_back_abs - self.imu_front_time) * rate)) + 2
        if n_imu_after > cfg.max_imu_states:
            raise RuntimeError(
                f"imu window {n_imu_after} exceeds max_imu_states={cfg.max_imu_states}; "
                "raise the capacity")
        back = all_samples[-1]
        thr = cfg.sliding_window_duration + 0.5 * cfg.sample_dt
        n_drop = sum(1 for t in all_samples if back - t > thr)
        new_front = all_samples[n_drop]
        n_imu_drop = max(0, int(round((new_front - self.imu_front_time) * rate)))
        fix_first = self.fix_first
        self.sample_times = all_samples[n_drop:]
        self.imu_front_time = new_front
        if n_drop > 0:
            self.fix_first = False
        self.epoch = new_front
        return dict(
            args=(imu_t, imu_acc, imu_gyr, np.int64(k_feed), sam_t, np.int64(n_add),
                  p_xyz.astype(np_dtype, copy=False), p_t.astype(np_dtype, copy=False),
                  np.int64(n_pts_cap), np.int64(n_drop), np.int64(n_imu_drop),
                  np.bool_(fix_first)),
            back=back,
            host_stats=dict(n_points_in=n_avail, n_points_fed=n_pts_cap,
                            n_points_dropped=n_pts_dropped))

    def _commit(self, packed: torch.Tensor, back: float, host_stats: dict) -> None:
        v = packed.numpy().astype(np.float64)
        self._trajectory.append((back, v[0:3], v[3:7]))
        warn = self.cfg.degeneracy_warn_ratio
        self._stats.append(dict(
            shift=v[7], iterations=int(v[8]), initial_cost=v[9], final_cost=v[10],
            n_new_surfels=int(v[11]), n_pairs_sld=int(v[12]), n_pairs_fix=int(v[13]),
            pose_pos_pred=v[14:17], n_surfels_dropped=int(v[17]), n_pairs_dropped=int(v[18]),
            deg_trans_ratio=v[19], deg_rot_ratio=v[20], lm_lambda_final=v[21],
            degenerate=bool(warn > 0 and min(v[19], v[20]) < warn), **host_stats))
        self.sweep_id += 1


def _residual_entry(post, pre) -> dict:
    """Host copies of the valid residuals of one sweep's snapshots."""
    def valid(r, v):
        return r.detach().cpu().numpy()[v.cpu().numpy()]

    (rs, rsv, ri, riv), (ps, psv, pi, piv) = post, pre
    return dict(surfel=valid(rs, rsv), imu=valid(ri, riv),
                surfel_pre=valid(ps, psv), imu_pre=valid(pi, piv))


def _voxel_decimate_indices(xyz: np.ndarray, cap: int, size0: float) -> np.ndarray:
    """Keep the first point per voxel, coarsening the grid x1.5 until the kept
    count fits; returns sorted indices (time order kept)."""
    size = float(size0)
    first = np.arange(min(len(xyz), cap))
    for _ in range(32):
        cell = np.clip(np.floor(xyz / size), -(2**20), 2**20 - 1).astype(np.int64) + 2**20
        key = (cell[:, 0] << 42) | (cell[:, 1] << 21) | cell[:, 2]
        _, first = np.unique(key, return_index=True)
        if len(first) <= cap:
            return np.sort(first)
        size *= 1.5
    return np.sort(first)[:cap]
