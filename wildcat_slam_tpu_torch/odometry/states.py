"""Fixed-capacity, mask-validated state containers of tensors.

Counterpart of ``wildcat_slam_tpu/odometry/states.py``: ``SampleStates``,
``ImuStates`` and ``Surfels`` as structure-of-arrays dataclasses with a static
capacity and validity masks. ``count`` is a 0-d int64 tensor on the state's
device, so masks and slices never need a host sync. ``replace()`` returns a
shallow copy with some fields swapped, like ``flax.struct.dataclass``.

Quaternions are (N, 4) wxyz body->world; device times are window-relative.
"""

from __future__ import annotations

import dataclasses

import torch

from wildcat_slam_tpu_torch.ops import lie


class TensorStruct:
    """Mixin for dataclasses of tensors: ``replace``, ``fields`` and ``map``
    (the ``tree_map`` of the JAX package)."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def fields(self):
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def map(self, fn):
        return type(self)(**{k: fn(v) for k, v in self.fields().items()})


def concat(a: TensorStruct, b: TensorStruct) -> TensorStruct:
    """Field-wise concatenation of two structs of one type along axis 0."""
    fb = b.fields()
    return type(a)(**{k: torch.cat([v, fb[k]], 0) for k, v in a.fields().items()})


def _count(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64, device=device)


@dataclasses.dataclass
class SampleStates(TensorStruct):
    """The 12-dof optimization nodes sampled every ``sample_dt``. ``cor`` packs
    [rot_cor(3), pos_cor(3), bg(3), ba(3)]."""

    t: torch.Tensor       # (S,)
    rot: torch.Tensor     # (S, 4)
    pos: torch.Tensor     # (S, 3)
    cor: torch.Tensor     # (S, 12)
    count: torch.Tensor   # () int64
    grav: torch.Tensor    # (3,)

    @property
    def capacity(self) -> int:
        return self.t.shape[0]

    @property
    def mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.t.device) < self.count

    @property
    def rot_cor(self):
        return self.cor[:, 0:3]

    @property
    def pos_cor(self):
        return self.cor[:, 3:6]

    @classmethod
    def empty(cls, capacity: int, dtype=torch.float32, device=None) -> "SampleStates":
        return cls(
            t=torch.zeros((capacity,), dtype=dtype, device=device),
            rot=lie.quat_identity((capacity,), dtype, device),
            pos=torch.zeros((capacity, 3), dtype=dtype, device=device),
            cor=torch.zeros((capacity, 12), dtype=dtype, device=device),
            count=_count(device),
            grav=torch.zeros((3,), dtype=dtype, device=device),
        )

    def apply_corrections(self) -> "SampleStates":
        """Fold the pose corrections into the nominal pose and zero them
        (bg/ba persist)."""
        new_rot = lie.quat_mul(lie.exp_quat(self.rot_cor), self.rot)
        new_pos = self.pos_cor + self.pos
        m = self.mask[:, None]
        cor = self.cor.clone()
        cor[:, 0:6].zero_()
        return self.replace(rot=lie.quat_normalize(torch.where(m, new_rot, self.rot)),
                            pos=torch.where(m, new_pos, self.pos), cor=cor)


@dataclasses.dataclass
class ImuStates(TensorStruct):
    """Per-IMU-tick states: timestamp, pose, and the resampled measurements."""

    t: torch.Tensor      # (I,)
    rot: torch.Tensor    # (I, 4)
    pos: torch.Tensor    # (I, 3)
    acc: torch.Tensor    # (I, 3)
    gyr: torch.Tensor    # (I, 3)
    count: torch.Tensor  # () int64

    @property
    def capacity(self) -> int:
        return self.t.shape[0]

    @property
    def mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.t.device) < self.count

    @classmethod
    def empty(cls, capacity: int, dtype=torch.float32, device=None) -> "ImuStates":
        z3 = lambda: torch.zeros((capacity, 3), dtype=dtype, device=device)
        return cls(t=torch.zeros((capacity,), dtype=dtype, device=device),
                   rot=lie.quat_identity((capacity,), dtype, device),
                   pos=z3(), acc=z3(), gyr=z3(), count=_count(device))


@dataclasses.dataclass
class Surfels(TensorStruct):
    """Planar patches with body-frame geometry plus an attached pose. Slots
    need not be contiguous (``valid`` masks them)."""

    t: torch.Tensor            # (N,) mean point timestamp
    center: torch.Tensor       # (N, 3) body frame
    cov: torch.Tensor          # (N, 3, 3) body frame
    norm: torch.Tensor         # (N, 3) body frame
    rot: torch.Tensor          # (N, 4) body->world
    pos: torch.Tensor          # (N, 3) body->world
    resolution: torch.Tensor   # (N,)
    std: torch.Tensor          # (N,)
    valid: torch.Tensor        # (N,) bool

    @property
    def capacity(self) -> int:
        return self.t.shape[0]

    @property
    def count(self) -> torch.Tensor:
        return torch.sum(self.valid.to(torch.int64))

    @classmethod
    def empty(cls, capacity: int, dtype=torch.float32, device=None) -> "Surfels":
        kw = dict(dtype=dtype, device=device)
        return cls(
            t=torch.zeros((capacity,), **kw),
            center=torch.zeros((capacity, 3), **kw),
            cov=torch.zeros((capacity, 3, 3), **kw),
            norm=torch.zeros((capacity, 3), **kw),
            rot=lie.quat_identity((capacity,), dtype, device),
            pos=torch.zeros((capacity, 3), **kw),
            resolution=torch.zeros((capacity,), **kw),
            std=torch.zeros((capacity,), **kw),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        )

    def center_world(self) -> torch.Tensor:
        return lie.quat_rotate(self.rot, self.center) + self.pos

    def norm_world(self) -> torch.Tensor:
        return lie.quat_rotate(self.rot, self.norm)

    def cov_world(self) -> torch.Tensor:
        # full f32 batched products (TF32 is off, _numerics.py)
        r = lie.quat_to_matrix(self.rot)
        return torch.matmul(torch.matmul(r, self.cov), r.transpose(-1, -2))
