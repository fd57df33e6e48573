"""Surfel extraction: hierarchical voxel plane fitting + temporal clustering.

Counterpart of ``wildcat_slam_tpu/odometry/surfel.py`` (see its module doc for
the gating semantics, which are kept exactly). On CUDA tensors it is kernel
K7 (``ops/surfel_extract.extract``), on CPU tensors its plain version
(``ops/surfel_extract.extract_plain``).
"""

from __future__ import annotations

import torch

from wildcat_slam_tpu_torch.config import WildcatConfig
from wildcat_slam_tpu_torch.ops import surfel_extract


def extract_surfels(pts: torch.Tensor, t: torch.Tensor, valid: torch.Tensor,
                    cfg: WildcatConfig) -> dict:
    """Extract surfels from one undistorted sweep (world frame, time-sorted).

    Returns a dict of world-frame surfel arrays of length
    ``cfg.max_surfels_per_sweep`` (t, center, cov, norm, resolution, std,
    valid) sorted by time, plus ``n_dropped``: candidates lost to the static
    capacities."""
    if pts.device.type == "cpu":
        return surfel_extract.extract_plain(pts, t, valid, cfg)
    return surfel_extract.extract(pts, t, valid, cfg)
