"""SE(3) rigid transforms as (quaternion, translation) pairs.

Counterpart of ``wildcat_slam_tpu/ops/se3.py``, the equivalent of the
reference's ``Rigid3<T>`` (identity/rotation/translation constructors,
composition, inverse, point transforms). Batched: a transform is a
``(q (..., 4) wxyz, t (..., 3))`` pair of tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from wildcat_slam_tpu_torch.ops import lie


class Rigid3(NamedTuple):
    q: torch.Tensor  # (..., 4) wxyz
    t: torch.Tensor  # (..., 3)

    @classmethod
    def identity(cls, shape=(), dtype=torch.float32, device=None) -> "Rigid3":
        return cls(lie.quat_identity(shape, dtype, device),
                   torch.zeros(tuple(shape) + (3,), dtype=dtype, device=device))

    @classmethod
    def rotation(cls, q: torch.Tensor) -> "Rigid3":
        return cls(q, torch.zeros(q.shape[:-1] + (3,), dtype=q.dtype, device=q.device))

    @classmethod
    def translation(cls, t: torch.Tensor) -> "Rigid3":
        return cls(lie.quat_identity(t.shape[:-1], t.dtype, t.device), t)

    @classmethod
    def from_matrix(cls, rot: torch.Tensor, t: torch.Tensor) -> "Rigid3":
        """From a (..., 3, 3) rotation matrix and a translation, by the
        w-dominant form (valid away from 180-degree rotations, e.g. for the
        config's extrinsic)."""
        w = 0.5 * torch.sqrt(torch.clamp(1.0 + rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2],
                                         min=1e-12))
        x = (rot[..., 2, 1] - rot[..., 1, 2]) / (4 * w)
        y = (rot[..., 0, 2] - rot[..., 2, 0]) / (4 * w)
        z = (rot[..., 1, 0] - rot[..., 0, 1]) / (4 * w)
        return cls(lie.quat_normalize(torch.stack([w, x, y, z], -1)), t)

    def compose(self, other: "Rigid3") -> "Rigid3":
        """self * other."""
        return Rigid3(lie.quat_normalize(lie.quat_mul(self.q, other.q)),
                      lie.quat_rotate(self.q, other.t) + self.t)

    def __mul__(self, other: "Rigid3") -> "Rigid3":
        return self.compose(other)

    def inverse(self) -> "Rigid3":
        qi = lie.quat_conj(self.q)
        return Rigid3(qi, -lie.quat_rotate(qi, self.t))

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        """Transform (..., 3) points."""
        return lie.quat_rotate(self.q, points) + self.t

    def matrix(self) -> torch.Tensor:
        return lie.quat_to_matrix(self.q)
