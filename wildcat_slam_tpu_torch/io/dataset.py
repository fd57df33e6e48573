"""Offline dataset replay (counterpart of ``wildcat_slam_tpu/io/dataset.py``)
— the counterpart of the reference's rosbag mode
(wildcat_slam_node.cc:80-99: iterate messages, dispatch IMU and PointCloud2 to
the odometry callbacks).

Since ROS is not a dependency here, sequences live in a directory:

    <dir>/imu.npz           t (N,) f64, acc (N, 3), gyr (N, 3)
    <dir>/scans/00000.wcs   binary scan files (one per lidar packet)
    ...

The ``.wcs`` scan format (versioned, little-endian) is shared with the native
C++ feeder (native/feeder.cc):

    magic   u32 = 0x57435331  ("WCS1")
    count   u32
    t0      f64                      base timestamp
    then count records of: dt f32 (time - t0), x f32, y f32, z f32

A converter from in-memory (times, points) and a writer for a
:class:`wildcat_slam_tpu_torch.io.synthetic.SyntheticSequence` are provided.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, Tuple

import numpy as np

WCS_MAGIC = 0x57435331


def save_scan(path: str, times: np.ndarray, points: np.ndarray) -> None:
    times = np.asarray(times, np.float64)
    points = np.asarray(points, np.float32)
    t0 = float(times[0]) if len(times) else 0.0
    with open(path, "wb") as f:
        f.write(struct.pack("<IId", WCS_MAGIC, len(times), t0))
        rec = np.empty((len(times), 4), np.float32)
        rec[:, 0] = (times - t0).astype(np.float32)
        rec[:, 1:] = points
        f.write(rec.tobytes())


def load_scan(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        magic, count = struct.unpack("<II", f.read(8))
        (t0,) = struct.unpack("<d", f.read(8))
        if magic != WCS_MAGIC:
            raise ValueError(f"{path}: bad magic {magic:#x}")
        rec = np.frombuffer(f.read(count * 16), np.float32).reshape(count, 4)
    return t0 + rec[:, 0].astype(np.float64), rec[:, 1:].astype(np.float64)


def save_sequence(dirname: str, imu, scans) -> None:
    """imu: iterable of (t, acc, gyr); scans: iterable of (times, points)."""
    os.makedirs(os.path.join(dirname, "scans"), exist_ok=True)
    t = np.asarray([e[0] for e in imu])
    acc = np.stack([e[1] for e in imu])
    gyr = np.stack([e[2] for e in imu])
    np.savez(os.path.join(dirname, "imu.npz"), t=t, acc=acc, gyr=gyr)
    for i, (times, pts) in enumerate(scans):
        save_scan(os.path.join(dirname, "scans", f"{i:05d}.wcs"), times, pts)


class Dataset:
    """Replays a sequence directory in timestamp order, yielding
    ("imu", t, acc, gyr) and ("scan", times, points) events — the same
    interleaving the reference gets from rosbag::View."""

    def __init__(self, dirname: str):
        self.dirname = dirname
        d = np.load(os.path.join(dirname, "imu.npz"))
        self.imu_t, self.imu_acc, self.imu_gyr = d["t"], d["acc"], d["gyr"]
        scan_dir = os.path.join(dirname, "scans")
        self.scan_files = sorted(
            os.path.join(scan_dir, f) for f in os.listdir(scan_dir) if f.endswith(".wcs")
        )

    def __iter__(self) -> Iterator[tuple]:
        i_imu = 0
        for path in self.scan_files:
            times, pts = load_scan(path)
            scan_end = times[-1] if len(times) else -np.inf
            while i_imu < len(self.imu_t) and self.imu_t[i_imu] <= scan_end + 0.01:
                yield ("imu", self.imu_t[i_imu], self.imu_acc[i_imu], self.imu_gyr[i_imu])
                i_imu += 1
            yield ("scan", times, pts)
        while i_imu < len(self.imu_t):
            yield ("imu", self.imu_t[i_imu], self.imu_acc[i_imu], self.imu_gyr[i_imu])
            i_imu += 1


def from_synthetic(seq, dirname: str) -> None:
    """Materialize a SyntheticSequence as an on-disk dataset."""
    save_sequence(dirname, seq.imu, seq.scans)
