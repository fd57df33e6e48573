"""Multi-window batches: B odometry windows in lockstep.

Counterpart of ``wildcat_slam_tpu/parallel/batch.py``. ``BatchedOdometry``
owns B single-window frontends (``LidarOdometry`` with ``dispatch = False``:
sweep boundaries, feed construction and trajectory bookkeeping, shared
through ``_prepare_feed``/``_commit``), each on its device as placed by
``parallel/mesh.py``, and steps each window through its frontend's
``_sweep``: on a card, each window's own sweep graph, captured on that
window's card (``odometry/graph.py``).

Lockstep model (offline batch processing, e.g. parallel bag segments):

- feed each window's sensor stream with :meth:`add_imu`/:meth:`add_scan`
  (interleaved or one after another: nothing steps until a step is possible);
- :meth:`pump` steps every window while every one has a complete sweep
  buffered;
- :meth:`finish` drains the tails: windows that ran out of data get
  zero-count no-op feeds, so the rest keep stepping until none has a full
  sweep left.

Per-window trajectories and stats come from the embedded frontends
(:attr:`trajectories`, :attr:`stats`); each window's packed outputs are
copied to the host as they are made and read when asked for. The CLI exposes this as ``--batch
SRC1,SRC2,...``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from wildcat_slam_tpu_torch.config import WildcatConfig
from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry
from wildcat_slam_tpu_torch.parallel import mesh as mesh_mod


class BatchedOdometry:
    """B lockstep odometry windows over the devices of a mesh (the CUDA cards
    unless ``device="cpu"``). The batch must be a multiple of the mesh size;
    by default the mesh is the largest device count that divides it.
    ``use_native`` picks each window's host feeder, as in ``LidarOdometry``."""

    def __init__(self, cfg: WildcatConfig = WildcatConfig(), batch: int = 2,
                 n_devices: Optional[int] = None, device="cuda", use_native: bool = False):
        self.cfg = cfg
        if n_devices is None:
            n_devices = mesh_mod.default_n_devices(batch, device)
        self.mesh = mesh_mod.make_mesh(n_devices, device)
        if batch % len(self.mesh) != 0:
            raise ValueError(
                f"batch={batch} must be a multiple of the mesh size {len(self.mesh)} "
                "(pass n_devices to shrink the mesh)")
        self.windows: List[LidarOdometry] = []
        for dev in mesh_mod.window_devices(batch, self.mesh):
            w = LidarOdometry(cfg, device=dev, use_native=use_native)
            w.dispatch = False  # host buffering only; BatchedOdometry steps
            self.windows.append(w)
        self._init = mesh_mod.make_batched_init(cfg, self.mesh)
        self._initialized = False

    @property
    def state(self) -> list:
        """The windows' states, one a window on its device."""
        return [w.state for w in self.windows]

    @state.setter
    def state(self, states: list) -> None:
        for w, st in zip(self.windows, states, strict=True):
            w.state = st  # a new state drops the window's graph (LidarOdometry.state)

    def add_imu(self, i: int, t: float, acc, gyr) -> None:
        self.windows[i].add_imu(t, acc, gyr)

    def add_scan(self, i: int, times: np.ndarray, points_lidar: np.ndarray) -> None:
        self.windows[i].add_scan(times, points_lidar)

    def _init_all(self) -> bool:
        """Bootstrap every window at once; needs every window's first sweep
        buffered (offline segments have it)."""
        if not all(w._ready() for w in self.windows):
            return False
        args = [w._init_args() for w in self.windows]  # commits host state
        stacked = [np.stack([a[j] for a in args]) for j in range(3)]
        self.state = self._init(self.state, *stacked)
        self._initialized = True
        return True

    def _round(self, ready: List[bool]) -> None:
        """One lockstep step: real feeds for ready windows, no-op feeds for the
        rest (their outputs are discarded)."""
        preps = [w._prepare_feed() if r else None for w, r in zip(self.windows, ready)]
        feeds = [p["args"] if p is not None else w.noop_feed()
                 for p, w in zip(preps, self.windows)]
        for w, p, feed in zip(self.windows, preps, feeds):
            out = w._sweep(feed)  # under the window's card (on a card, its graph)
            if p is not None:
                w._commit(out, p["back"], p["host_stats"])

    def pump(self) -> int:
        """Step while every window has a complete sweep buffered. Returns the
        number of steps taken."""
        if not self._initialized and not self._init_all():
            return 0
        n = 0
        while all(w._ready() for w in self.windows):
            self._round([True] * len(self.windows))
            n += 1
        return n

    def finish(self) -> int:
        """Drain the tails after all data is fed: step while any window has a
        sweep left, feeding no-ops to the exhausted ones. Returns the number
        of steps taken."""
        n = self.pump()
        if not self._initialized:
            raise RuntimeError("batched init never became possible: some window received "
                               "less than one full sweep of data")
        while True:
            ready = [w._ready() for w in self.windows]
            if not any(ready):
                return n
            self._round(ready)
            n += 1

    @property
    def trajectories(self) -> List[list]:
        return [w.trajectory for w in self.windows]

    @property
    def stats(self) -> List[list]:
        return [w.stats for w in self.windows]
