"""Windows onto CUDA devices: batch-of-windows data parallelism.

Counterpart of ``wildcat_slam_tpu/parallel/mesh.py``. B independent odometry
windows (parallel bag segments, a fleet, a mapping farm) advance in lockstep.
The JAX version shards the window axis over a 1-D device mesh with
``shard_map`` and runs the unbatched per-sweep program on each device's local
windows in a static loop, not ``vmap``, so that the LM and matcher control
flow stays adaptive per window. The port keeps those semantics without the
sharding machinery: the mesh is a list of devices, window ``i`` lives on
``mesh[i // (B / n)]`` with its own ``WindowState``, and each window's
bootstrap (:func:`make_batched_init`) and sweeps run under
``torch.cuda.device`` of its card, so that every launch goes to that card
and its stream. The sweeps run through each window's frontend, on the card
its own sweep graph (``parallel/batch.py``, ``odometry/graph.py``). One
host thread steps the devices one after another.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from wildcat_slam_tpu_torch.config import WildcatConfig
from wildcat_slam_tpu_torch.odometry import graph as graph_mod
from wildcat_slam_tpu_torch.odometry import pipeline as pipe


def default_n_devices(batch: int, device="cuda") -> int:
    """The largest device count that divides ``batch`` and is visible (one
    for the CPU)."""
    avail = torch.cuda.device_count() if torch.device(device).type == "cuda" else 1
    return max(d for d in range(1, min(batch, max(avail, 1)) + 1) if batch % d == 0)


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> List[torch.device]:
    """The first ``n_devices`` CUDA cards (all by default); ``device="cpu"``
    gives ``n_devices`` CPU entries (one by default)."""
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")] * (n_devices or 1)
    if kind != "cuda":
        raise ValueError(f"make_mesh: device must be 'cuda' or 'cpu', got {device!r}")
    avail = torch.cuda.device_count()
    if avail == 0:
        raise RuntimeError("device='cuda' requested but no CUDA card is visible")
    n = avail if n_devices is None else int(n_devices)
    if not 1 <= n <= avail:
        raise ValueError(f"n_devices={n}, but {avail} CUDA cards are visible")
    return [torch.device("cuda", i) for i in range(n)]


def window_devices(batch: int, mesh: List[torch.device]) -> List[torch.device]:
    """The device of each window: window ``i`` on ``mesh[i // (batch / n)]``."""
    if batch % len(mesh):
        raise ValueError(f"batch={batch} must be a multiple of the mesh size {len(mesh)}")
    per = batch // len(mesh)
    return [mesh[i // per] for i in range(batch)]


def _put(arrays, dev: torch.device) -> list:
    """Numpy arrays as tensors on ``dev``, one transfer each."""
    return [torch.as_tensor(a).to(dev) for a in arrays]


def _per_device(states: list, feeds, mesh: List[torch.device], inner) -> tuple:
    """Run ``inner(state, *feed)`` for every window under its device's guard.
    ``feeds`` are stacked (B, ...) numpy arrays; each device's slice of each
    moves to it in one transfer. Returns the results in window order."""
    per = len(states) // len(mesh)
    out = []
    for d, dev in enumerate(mesh):
        with graph_mod.device_guard(dev):
            local = _put([f[d * per:(d + 1) * per] for f in feeds], dev)
            for j in range(per):
                out.append(inner(states[d * per + j], *(a[j] for a in local)))
    return out


def make_batched_init(cfg: WildcatConfig, mesh: List[torch.device]):
    """``init(states, imu_t, imu_acc, imu_gyr) -> states``: the window
    bootstrap of every window on its device (leading window axis)."""
    def init(states, imu_t, imu_acc, imu_gyr):
        return _per_device(states, (imu_t, imu_acc, imu_gyr), mesh,
                           lambda st, *a: pipe.init_window(st, *a, cfg))

    return init
