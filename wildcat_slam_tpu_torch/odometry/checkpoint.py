"""Checkpoint / resume of the odometry state, file-compatible with the JAX package.

Counterpart of ``wildcat_slam_tpu/odometry/checkpoint.py`` (single window).
The window state and the host bookkeeping serialize to one ``.npz`` in the
JAX package's layout: the state as ``leaf_0 .. leaf_{n-1}`` in the flatten
order of its ``WindowState`` (sample, imu, sld, fix, each field in
declaration order, then fix_geo; counts as int32), a ``__meta__`` JSON with
the host fields and the config, and the trajectory, the resampled IMU queue,
the buffered points and the resampler state. So ``wildcat_slam_tpu``'s
``checkpoint.load`` resumes a file written here, and :func:`load` resumes one
written by the JAX package.

A JAX checkpoint written with ``use_native=True`` (the C++ host feeder) loads
into the port's numpy feeder: the two feeders are output-identical
(``tests/test_native.py``) and share the resampler state layout. The batched
mode's files (``save_batch``/``load_batch``) wait for ``--batch``.
"""

from __future__ import annotations

import json

import numpy as np

from wildcat_slam_tpu_torch.config import WildcatConfig
from wildcat_slam_tpu_torch.odometry import factors as fmod
from wildcat_slam_tpu_torch.odometry.convert import (window_state_from_numpy,
                                                     window_state_to_numpy)
from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry, WindowState

_HOST_FIELDS = ("synced", "initialized", "epoch", "sample_times", "imu_front_time",
                "fix_first", "sweep_id", "_last_raw_imu_t")


def _leaf_keys(state: WindowState) -> list:
    """Field paths in the JAX package's flatten order of its WindowState."""
    return [f"{part}.{f}" for part in ("sample", "imu", "sld", "fix")
            for f in getattr(state, part).fields()] + ["fix_geo"]


def save(path: str, lo: LidarOdometry) -> None:
    """Write ``lo``'s full state to ``path`` (.npz) in the JAX package's format."""
    tree = window_state_to_numpy(lo.state)
    leaves = [tree[k].astype(np.int32) if k.endswith(".count") else tree[k]
              for k in _leaf_keys(lo.state)]
    pts_t, pts_xyz = lo.points.dump()
    traj, imu_q = lo.trajectory, lo.imu_queue
    np.savez_compressed(
        path,
        __meta__=json.dumps(dict(n_leaves=len(leaves),
                                 host={f: getattr(lo, f) for f in _HOST_FIELDS},
                                 config=lo.cfg.to_json(), trajectory_len=len(traj),
                                 use_native=False)),
        **{f"leaf_{i}": x for i, x in enumerate(leaves)},
        traj_t=np.asarray([e[0] for e in traj]),
        traj_pos=np.stack([e[1] for e in traj]) if traj else np.zeros((0, 3)),
        traj_rot=np.stack([e[2] for e in traj]) if traj else np.zeros((0, 4)),
        imu_queue_t=np.asarray([e[0] for e in imu_q]),
        imu_queue_acc=np.stack([e[1] for e in imu_q]) if imu_q else np.zeros((0, 3)),
        imu_queue_gyr=np.stack([e[2] for e in imu_q]) if imu_q else np.zeros((0, 3)),
        pts_t=pts_t,
        pts_xyz=pts_xyz,
        resampler=lo.resampler.get_state(),
    )


def load(path: str, *, device) -> LidarOdometry:
    """Restore a :class:`LidarOdometry` on ``device`` from a checkpoint written
    by :func:`save` or by the JAX package (its config wins)."""
    d = np.load(path, allow_pickle=False)
    meta = json.loads(str(d["__meta__"]))
    lo = LidarOdometry(WildcatConfig.from_json(meta["config"]), device=device)
    keys = _leaf_keys(lo.state)
    n = meta["n_leaves"]
    # a file from before the window state gained its trailing fix_geo cache
    # holds one leaf fewer; the cache is derived and is recomputed below
    if n not in (len(keys), len(keys) - 1):
        raise ValueError(
            f"checkpoint format mismatch: {path} holds {n} state leaves but the "
            f"current WindowState has {len(keys)}; the file was written by an "
            "incompatible version")
    tree = {k: d[f"leaf_{i}"] for i, k in enumerate(keys[:n])}
    if n < len(keys):
        tree["fix_geo"] = np.zeros(tuple(lo.state.fix_geo.shape))
    lo.state = window_state_from_numpy(tree, lo.device, lo.dtype)
    if n < len(keys):
        lo.state = lo.state.replace(fix_geo=fmod.pack_geo_rows(lo.state.fix))
    for f in _HOST_FIELDS:
        setattr(lo, f, meta["host"].get(f, getattr(lo, f)))
    lo.trajectory = [(float(t), p, q)
                     for t, p, q in zip(d["traj_t"], d["traj_pos"], d["traj_rot"])]
    lo.imu_queue = [(float(t), a, g) for t, a, g in
                    zip(d["imu_queue_t"], d["imu_queue_acc"], d["imu_queue_gyr"])]
    lo.points.restore(d["pts_t"], d["pts_xyz"])
    lo.resampler.set_state(d["resampler"])
    return lo

