"""Text-bucket histogram for residual diagnostics (numpy only; a copy of
``wildcat_slam_tpu/utils/histogram.py``, held equal by a test).

Equivalent of the reference's Cartographer-derived ``Histogram``
(common/histogram.{h,cc}): collects scalars, prints a bucketized distribution
with counts, percents and bars — used for the per-sweep residual reports
(lidar_odometry.cc:56-100). Vectorized over numpy arrays instead of per-value
``Add`` calls.
"""

from __future__ import annotations

import numpy as np


class Histogram:
    def __init__(self):
        self._values: list[np.ndarray] = []

    def add(self, values) -> "Histogram":
        v = np.atleast_1d(np.asarray(values, np.float64))
        self._values.append(v[np.isfinite(v)])
        return self

    @property
    def values(self) -> np.ndarray:
        return np.concatenate(self._values) if self._values else np.zeros((0,))

    def to_string(self, buckets: int = 10) -> str:
        v = self.values
        if v.size == 0:
            return "Count: 0"
        lo, hi = float(v.min()), float(v.max())
        out = [f"Count: {v.size}  Min: {lo:.6g}  Max: {hi:.6g}  Mean: {v.mean():.6g}"]
        if lo == hi:
            return "\n".join(out)
        edges = np.linspace(lo, hi, buckets + 1)
        counts, _ = np.histogram(v, bins=edges)
        cum = 0
        for i in range(buckets):
            frac = counts[i] / v.size
            cum += counts[i]
            bar = "#" * int(round(frac * 20))
            out.append(
                f"[{edges[i]:>10.4g}, {edges[i+1]:>10.4g}) "
                f"{counts[i]:>8d} ({100*frac:5.1f}%)  Total: {100*cum/v.size:5.1f}%  {bar}"
            )
        return "\n".join(out)

    def __str__(self) -> str:
        return self.to_string()


def residual_report(name: str, residuals: np.ndarray, buckets: int = 10) -> str:
    """One-call residual distribution report (PrintSurfelResiduals analog,
    lidar_odometry.cc:56-71)."""
    return f"{name} residuals:\n{Histogram().add(residuals).to_string(buckets)}"
