"""Window state <-> flat dict of numpy arrays.

The dict is keyed by the field paths of the JAX package's ``WindowState``
(``sample.t``, ``sample.cor``, ..., ``sld.valid``, ``fix_geo``), so the same
window state can be handed to ``process_sweep`` of either package.
"""

from __future__ import annotations

import numpy as np
import torch

from wildcat_slam_tpu_torch.odometry.pipeline import WindowState
from wildcat_slam_tpu_torch.odometry.states import ImuStates, SampleStates, Surfels

_PARTS = (("sample", SampleStates), ("imu", ImuStates), ("sld", Surfels), ("fix", Surfels))


def _tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64), device=device)
    return torch.as_tensor(a, device=device).to(dtype)


def window_state_from_numpy(tree: dict, device, dtype=torch.float32) -> WindowState:
    """Build a ``WindowState`` from a dict of numpy arrays keyed by field path.
    Float fields are cast to ``dtype``, counts to int64, masks stay bool."""
    parts = {}
    for name, cls in _PARTS:
        fields = {f: _tensor(tree[f"{name}.{f}"], device, dtype)
                  for f in cls.__dataclass_fields__}
        parts[name] = cls(**fields)
    return WindowState(fix_geo=_tensor(tree["fix_geo"], device, dtype), **parts)


def window_state_to_numpy(state: WindowState) -> dict:
    """The inverse of :func:`window_state_from_numpy`."""
    out = {}
    for name, _ in _PARTS:
        for f, v in getattr(state, name).fields().items():
            out[f"{name}.{f}"] = v.detach().cpu().numpy()
    out["fix_geo"] = state.fix_geo.detach().cpu().numpy()
    return out
