"""Chunked host point buffer.

Counterpart of ``wildcat_slam_tpu/odometry/_ptbuf.py`` without its checkpoint
``dump``/``restore`` (checkpoints are not ported).

Scans arrive ~10x per sweep; a flat-array buffer re-concatenates the whole
backlog on every scan (O(buffered) per scan). This buffer keeps scans as a list of
filtered chunks and only concatenates the consumed prefix once per sweep in
``pop_sweep``. Point times are globally non-decreasing across chunks (enforced
by LidarOdometry.add_scan), so per-chunk searchsorted is exact.
"""

from __future__ import annotations

import numpy as np


class ChunkedPointBuffer:
    """Filtered, IMU-frame point buffer (the reference's points_buff_,
    lidar_odometry.cc:489-496)."""

    def __init__(self, cfg):
        self._min2 = cfg.min_range**2
        self._max2 = cfg.max_range**2
        self._bb_min = np.asarray(cfg.blind_box_min)
        self._bb_max = np.asarray(cfg.blind_box_max)
        self._rot = np.asarray(cfg.ext_lidar2imu_rot, np.float64).reshape(3, 3)
        self._pos = np.asarray(cfg.ext_lidar2imu_pos, np.float64)
        self._t_chunks: list[np.ndarray] = []
        self._p_chunks: list[np.ndarray] = []
        self._n = 0

    def add_points(self, times: np.ndarray, pts_lidar: np.ndarray) -> int:
        p = pts_lidar @ self._rot.T + self._pos
        r2 = np.sum(p * p, axis=1)
        in_box = np.all((p >= self._bb_min) & (p <= self._bb_max), axis=1)
        keep = (r2 >= self._min2) & (r2 <= self._max2) & ~in_box
        kept = int(keep.sum())
        if kept:
            self._t_chunks.append(times[keep])
            self._p_chunks.append(p[keep])
            self._n += kept
        return kept

    def __len__(self) -> int:
        return self._n

    @property
    def front_time(self) -> float:
        return float(self._t_chunks[0][0]) if self._n else float("nan")

    @property
    def back_time(self) -> float:
        return float(self._t_chunks[-1][-1]) if self._n else float("nan")

    def _split_at(self, t_cut: float):
        """(full chunks before t_cut, split index in the straddling chunk)."""
        k = 0
        while k < len(self._t_chunks) and self._t_chunks[k][-1] < t_cut:
            k += 1
        part = 0
        if k < len(self._t_chunks):
            part = int(np.searchsorted(self._t_chunks[k], t_cut, side="left"))
        return k, part

    def drop_before(self, t_cut: float) -> int:
        k, part = self._split_at(t_cut)
        dropped = sum(len(t) for t in self._t_chunks[:k]) + part
        if part and k < len(self._t_chunks):
            self._t_chunks[k] = self._t_chunks[k][part:]
            self._p_chunks[k] = self._p_chunks[k][part:]
        del self._t_chunks[:k], self._p_chunks[:k]
        self._n -= dropped
        return dropped

    def count_until(self, t_end: float) -> int:
        k, part = self._split_at(t_end)
        return sum(len(t) for t in self._t_chunks[:k]) + part

    def pop_sweep(self, t_end: float, epoch: float, out_t: np.ndarray, out_xyz: np.ndarray) -> int:
        k, part = self._split_at(t_end)
        m = 0
        cap = len(out_t)
        for j in range(k + (1 if part else 0)):
            tc = self._t_chunks[j]
            pc = self._p_chunks[j]
            if j == k:
                tc, pc = tc[:part], pc[:part]
            take = max(0, min(len(tc), cap - m))
            if take:
                out_t[m : m + take] = (tc[:take] - epoch).astype(np.float32)
                out_xyz[m : m + take] = pc[:take].astype(np.float32)
            m += len(tc)  # count all consumed, even past cap (caller handles)
        if part and k < len(self._t_chunks):
            self._t_chunks[k] = self._t_chunks[k][part:]
            self._p_chunks[k] = self._p_chunks[k][part:]
        del self._t_chunks[:k], self._p_chunks[:k]
        self._n -= m
        return min(m, cap)
