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

The file records which host feeder wrote it (``use_native``: the C++ feeder
of ``io/native.py`` or the numpy one); :func:`load` resumes on the same
feeder unless told otherwise. Both feeders dump their buffered points and
their resampler state in one layout, so either resumes a file of the other,
from either package.

A batch of windows (``parallel/batch.py``) saves as one single-window file
per window (:func:`save_batch`), so either package resumes any window on its
own, and :func:`load_batch` resumes a batch from such files.
"""

from __future__ import annotations

import json
import os

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
    lo.flush_chunks()  # chained mode: the device state must catch up with the host
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
                                 use_native=bool(lo.use_native))),
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


def load(path: str, *, device="cuda", use_native: bool = None, collect_clouds: bool = False,
         chunk_sweeps: int = 1) -> LidarOdometry:
    """Restore a :class:`LidarOdometry` on ``device`` (the card unless the
    caller asks for the CPU) from a checkpoint written by :func:`save` or by
    the JAX package (its config wins). The host feeder is the one that wrote
    the file unless ``use_native`` says otherwise. ``collect_clouds`` and
    ``chunk_sweeps`` set up the frontend as its constructor does."""
    d = np.load(path, allow_pickle=False)
    meta = json.loads(str(d["__meta__"]))
    if use_native is None:
        use_native = bool(meta.get("use_native", False))
    lo = LidarOdometry(WildcatConfig.from_json(meta["config"]), device=device,
                       collect_clouds=collect_clouds, use_native=use_native,
                       chunk_sweeps=chunk_sweeps)
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



def batch_paths(path: str, n: int) -> list:
    """Per-window file names of a batch checkpoint: ``out.npz`` ->
    ``out.w0.npz .. out.w{n-1}.npz``. Each is a complete single-window
    checkpoint."""
    base, ext = os.path.splitext(path)
    return [f"{base}.w{i}{ext or '.npz'}" for i in range(n)]


def save_batch(path: str, bo) -> list:
    """Checkpoint a :class:`~wildcat_slam_tpu_torch.parallel.batch.BatchedOdometry`
    as one single-window file per window (:func:`batch_paths`); the host
    bookkeeping lives in the embedded frontends already. Returns the paths."""
    paths = batch_paths(path, len(bo.windows))
    for p, w in zip(paths, bo.windows):
        save(p, w)  # each window's frontend holds its state
    return paths


def load_batch(paths, *, device="cuda", use_native: bool = None, n_devices: int = None):
    """Restore a ``BatchedOdometry`` from per-window checkpoints (written by
    :func:`save_batch`, or any set of compatible single-window files of
    either package), each window on its device of the mesh, each on the host
    feeder that wrote it unless ``use_native`` says otherwise. All files must
    share one config and one init status: the batched step is lockstep, so a
    mixed set cannot come from one batch run."""
    from wildcat_slam_tpu_torch.parallel import mesh as mesh_mod
    from wildcat_slam_tpu_torch.parallel.batch import BatchedOdometry

    if n_devices is None:
        n_devices = mesh_mod.default_n_devices(len(paths), device)
    devs = mesh_mod.window_devices(len(paths), mesh_mod.make_mesh(n_devices, device))
    los = [load(p, device=dev, use_native=use_native) for p, dev in zip(paths, devs)]
    if len({lo.cfg.to_json() for lo in los}) != 1:
        raise ValueError("batch resume: checkpoint configs differ across windows")
    inits = {bool(lo.initialized) for lo in los}
    if len(inits) != 1:
        raise ValueError(
            "batch resume: mixed window init status across checkpoints -- these files were "
            "not written by one lockstep batch run")
    bo = BatchedOdometry(los[0].cfg, batch=len(los), n_devices=n_devices, device=device)
    for lo in los:
        lo.dispatch = False  # BatchedOdometry steps; the frontends only buffer
    bo.windows = los  # each holds its restored state
    bo._initialized = inits.pop()
    return bo
