"""Trajectory export in TUM format (timestamp tx ty tz qx qy qz qw).

Counterpart of ``wildcat_slam_tpu/io/trajectory.py``.

The reference only publishes TF transforms to ROS (lidar_odometry.cc:596-602);
for offline evaluation (ATE vs a baseline) a file format is needed — TUM is the
standard consumed by evo/rpg trajectory evaluation tools.
"""

from __future__ import annotations


def save_tum(path: str, trajectory) -> None:
    """trajectory: iterable of (t, pos (3,), quat wxyz (4,))."""
    with open(path, "w") as f:
        for t, pos, q in trajectory:
            f.write(
                f"{t:.9f} {pos[0]:.9f} {pos[1]:.9f} {pos[2]:.9f} "
                f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}\n"
            )

