"""Typed, serializable configuration for the whole pipeline.

Counterpart of ``wildcat_slam_tpu/config.py``, with the same fields and
defaults (a test holds the two equal), so that the port stands on its own.
The comments there give the source of each constant in the reference
implementation and the measurements behind the defaults.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class WildcatConfig:
    # ----- IMU noise model -----
    gyroscope_noise_density: float = 0.00015198973532354657
    accelerometer_noise_density: float = 0.006308226052016165
    gyroscope_random_walk: float = 0.00011673723527962174
    accelerometer_random_walk: float = 2.664506559330434e-06
    imu_factor_weight: float = 0.01

    # ----- Preprocess -----
    max_range: float = 120.0
    min_range: float = 0.3
    # Axis-aligned blind box around the sensor, in the IMU frame.
    blind_box_min: Tuple[float, float, float] = (-0.8, -0.5, -0.4)
    blind_box_max: Tuple[float, float, float] = (0.3, 0.5, 0.4)
    # lidar -> imu extrinsic for the Hilti rig: rotation matrix rows + translation.
    ext_lidar2imu_rot: Tuple[float, ...] = (
        -5.32125e-08, -1.0, 0.0,
        -1.0, -5.32125e-08, -0.0,
        0.0, 0.0, -1.0,
    )
    ext_lidar2imu_pos: Tuple[float, float, float] = (-0.001, -0.00855, 0.055)

    # ----- Windows -----
    imu_rate: float = 200.0
    sample_dt: float = 0.08
    fixed_window_duration: float = 20.0
    sliding_window_duration: float = 6.0
    sweep_duration: float = 0.5

    # ----- Optimization -----
    gravity_norm: float = 9.81
    outer_iter_num_max: int = 1
    inner_iter_num_max: int = 100
    cauchy_loss_scale: float = 0.4
    surfel_sigma_floor: float = 0.05 / 6.0

    # ----- Surfel extraction -----
    voxel_size: float = 0.8
    max_voxel_depth: int = 2
    min_points_per_plane: int = 20
    planer_threshold: float = 0.01
    min_plane_likeness: float = 0.1
    cluster_time_gap: float = 0.05

    # ----- Correspondence search -----
    match_center_dist: float = 1.0
    match_angular_dist: float = 5.0 * math.pi / 180.0
    match_surfel_dist: float = 0.1
    match_knn: int = 10
    # per-bin partial-reduce search (kernel K2 on CUDA, recall ~0.98 at k=10);
    # False selects an exact top-k over a full-f32 Gram
    match_knn_approx: bool = True
    match_time_diff: float = 0.06

    # ----- Static capacities (the window shrink runs after the new sweep is
    # appended, so they absorb one extra sweep) -----
    max_points_per_sweep: int = 65536
    # Overfull sweeps: keep the first point per voxel on a coarsening grid
    # until the sweep fits (False truncates the tail); the dropped count is
    # reported per sweep in LidarOdometry.stats (n_points_dropped).
    overflow_decimate: bool = True
    decimate_voxel_size: float = 0.02  # starting grid; coarsened x1.5 until fit
    max_sample_states: int = 96
    max_imu_states: int = 1536
    max_surfels_per_sweep: int = 1024
    max_surfels_sliding: int = 8192
    max_surfels_fixed: int = 16384
    max_correspondences: int = 8192
    max_voxels_per_sweep: int = 8192
    max_leaves_per_sweep: int = 16384

    # ----- Solver -----
    gn_initial_lambda: float = 1e-4
    # sorted-stamp undistortion fast path; False selects the per-point gather
    sorted_undistort: bool = True
    gn_function_tolerance: float = 1e-3
    # "pcg": block-Jacobi PCG, kernel K1 for float32 on CUDA; "pcg_xla": the
    # plain PyTorch PCG; "cholesky": dense Cholesky
    linear_solver: str = "pcg"
    pcg_iters: int = 24
    pcg_tol: float = 1e-2
    debug_residuals: bool = False  # not ported (LidarOdometry raises)
    # min direction-coverage ratio below which a sweep is flagged degenerate
    # in stats; 0 disables the flag
    degeneracy_warn_ratio: float = 0.02
    degeneracy_remap: bool = False  # not ported (LidarOdometry raises)
    degeneracy_remap_ratio: float = 0.02
    dtype: str = "float32"

    def __post_init__(self):
        """Fail at construction rather than deep inside a sweep."""
        if self.outer_iter_num_max < 1:
            raise ValueError(
                f"outer_iter_num_max must be >= 1, got {self.outer_iter_num_max}")
        if self.inner_iter_num_max < 1:
            raise ValueError(
                f"inner_iter_num_max must be >= 1, got {self.inner_iter_num_max}")
        for name in ("max_points_per_sweep", "max_sample_states", "max_imu_states",
                     "max_surfels_per_sweep", "max_surfels_sliding",
                     "max_surfels_fixed", "max_correspondences",
                     "max_voxels_per_sweep", "max_leaves_per_sweep", "pcg_iters"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{name} must be a positive int, got {v!r}")
        for name in ("imu_rate", "sample_dt", "sweep_duration",
                     "sliding_window_duration", "fixed_window_duration",
                     "voxel_size", "decimate_voxel_size"):
            v = getattr(self, name)
            if not v > 0:
                raise ValueError(f"{name} must be > 0, got {v!r}")
        if self.linear_solver not in ("pcg", "pcg_xla", "cholesky"):
            raise ValueError(
                f"linear_solver must be one of 'pcg', 'pcg_xla', 'cholesky'; "
                f"got {self.linear_solver!r}")
        if not 0.0 <= self.degeneracy_warn_ratio < 1.0:
            raise ValueError(
                f"degeneracy_warn_ratio must be in [0, 1), got {self.degeneracy_warn_ratio!r}")
        if not 0.0 < self.degeneracy_remap_ratio < 1.0:
            raise ValueError(
                f"degeneracy_remap_ratio must be in (0, 1), got {self.degeneracy_remap_ratio!r}")
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"dtype must be 'float32' or 'float64', got {self.dtype!r}")

    # ----- Derived cost weights -----
    @property
    def weight_gyr(self) -> float:
        return 1.0 / (self.gyroscope_noise_density * math.sqrt(self.imu_rate)) * self.imu_factor_weight

    @property
    def weight_acc(self) -> float:
        return 1.0 / (self.accelerometer_noise_density * math.sqrt(self.imu_rate)) * self.imu_factor_weight

    @property
    def weight_bg(self) -> float:
        return 1.0 / (self.gyroscope_random_walk / math.sqrt(self.imu_rate)) * self.imu_factor_weight

    @property
    def weight_ba(self) -> float:
        return 1.0 / (self.accelerometer_random_walk / math.sqrt(self.imu_rate)) * self.imu_factor_weight

    @property
    def imu_dt(self) -> float:
        return 1.0 / self.imu_rate

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "WildcatConfig":
        d = json.loads(s)
        d = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
        return cls(**d)

    def replace(self, **kw) -> "WildcatConfig":
        return dataclasses.replace(self, **kw)
