"""How the correction spline's fit moves the trajectory on the card:
``bench.py``'s workload (the shipped config, a 50 s room at 12800 points a
scan, ~100 sweeps) with the fit computed three ways, and in float64.

    python -m wildcat_slam_tpu_torch.probe_spline_fit [--checkpoints DIR]

- ``kernel``: the port as it is, (N^T N) Q = N^T p solved by kernel K4
  (``ops/spd.spd_solve``), on the sweep graph;
- ``operator``: Q = A_n p, with A_n = (N^T N)^-1 N^T made once per live
  count in float64 on the host and cast to the run's dtype, on the sweep
  graph;
- ``library``: the normal equations solved by ``torch.linalg.solve_ex`` (LU
  in cuSOLVER), run eagerly (its triangular solves may allocate inside a
  capture);
- ``float64``: ``kernel`` with ``dtype="float64", linear_solver="pcg_xla"``.

For each it prints the ATE (unaligned, against the sequence's ground
truth), the LM iterations a sweep (min, median, max), the sweeps that ran
to the ``inner_iter_num_max`` cap (with each one's wall ms, costs before and
after its solve and final LM damping), the wall ms a sweep, and the
iterations of the sweeps around the first capped one in every variant.
With ``--checkpoints DIR`` it then runs ``kernel`` once more and writes, for
each sweep k that ``kernel`` ran to the cap, the checkpoint taken after k
sweeps (``DIR/after{k}.npz``) and the number of the sequence's events fed
by then (``DIR/marks.json``), from which
``tests/torch_jax_reference.py --lm-cap --resume-from DIR`` runs sweep k in
both packages on a CPU. Needs a CUDA card; it exits non-zero without one.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import numpy as np
import torch

from wildcat_slam_tpu_torch import cli
from wildcat_slam_tpu_torch.config import WildcatConfig
from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence, ate_rmse
from wildcat_slam_tpu_torch.odometry import checkpoint
from wildcat_slam_tpu_torch.odometry import corrections as cor_mod
from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry
from wildcat_slam_tpu_torch.ops import spd


@functools.lru_cache(maxsize=None)
def _operators(s: int, dtype, device) -> torch.Tensor:
    """(S, S, S): for n = 1..S live states, (N^T N)^-1 N^T in float64."""
    ops = np.zeros((s, s, s))
    rows = np.arange(s)
    for n in range(1, s + 1):
        nmat = np.zeros((s, s))
        for off, w in ((-1, 1.0 / 6.0), (0, 4.0 / 6.0), (1, 1.0 / 6.0)):
            np.add.at(nmat, (rows[:n], np.clip(rows[:n] + off, 0, n - 1)), w)
        nmat[n:, n:] = np.eye(s - n)
        ops[n - 1] = np.linalg.solve(nmat.T @ nmat, nmat.T)
    return torch.as_tensor(ops, dtype=dtype, device=device)


def _targets(sample) -> torch.Tensor:
    live = torch.arange(sample.capacity, device=sample.cor.device) < sample.count
    return torch.where(live[:, None], sample.cor[:, 0:6], 0.0)


def fit_operator(sample) -> torch.Tensor:
    s = sample.capacity
    ops = _operators(s, sample.cor.dtype, sample.cor.device)
    op = torch.index_select(ops, 0, torch.clamp(sample.count - 1, 0, s - 1).reshape(1))[0]
    return op @ _targets(sample)


def fit_library(sample) -> torch.Tensor:
    solve = spd.spd_solve  # the default config's LM runs pcg: only the fit calls it
    spd.spd_solve = lambda a, b: torch.linalg.solve_ex(a, b, check_errors=False)[0]
    try:
        return KERNEL(sample)
    finally:
        spd.spd_solve = solve


KERNEL = cor_mod.fit_correction_spline
VARIANTS = {"kernel": (KERNEL, True, {}), "operator": (fit_operator, True, {}),
            "library": (fit_library, False, {}),
            "float64": (KERNEL, True, dict(dtype="float64", linear_solver="pcg_xla"))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoints", default=None,
                    help="write the checkpoint before each of kernel's capped sweeps here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_spline_fit: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    seq = SyntheticSequence(duration=50.0, points_per_scan=12800, room_half=5.0, seed=0)
    events = list(cli.synthetic_events(seq))
    iters = {}
    for name, (fit, graph, cfg_kw) in VARIANTS.items():
        cfg = WildcatConfig(**cfg_kw)
        cor_mod.fit_correction_spline = fit
        try:
            t0 = time.perf_counter()
            lo = LidarOdometry(cfg, device=dev)
            lo._use_graph = graph
            cli.feed_events(lo, events)
            its = np.asarray([s["iterations"] for s in lo.stats])
        finally:
            cor_mod.fit_correction_spline = KERNEL
        iters[name] = its
        ate = ate_rmse(lo.trajectory, lambda t: seq.gt_pose(t)[0], align=False)
        capped = np.flatnonzero(its >= cfg.inner_iter_num_max).tolist()
        ms = np.asarray(lo.sweep_seconds[1:]) * 1e3
        print(f"{name}: {lo.sweep_id} sweeps in {time.perf_counter() - t0:.1f} s "
              f"({'graph' if graph else 'eager'}); ATE {ate * 1e3:.3f} mm; LM iterations a "
              f"sweep min {its.min()} median {np.median(its):.0f} max {its.max()}; sweeps at "
              f"the cap of {cfg.inner_iter_num_max}: {capped}; wall ms a sweep after the first: "
              f"median {np.median(ms):.2f}, max {ms.max():.2f}", flush=True)
        for i in capped:
            st = lo.stats[i]
            print(f"{name}: sweep {i} at the cap: {lo.sweep_seconds[i] * 1e3:.2f} ms; cost "
                  f"{float(st['initial_cost'])!r} -> {float(st['final_cost'])!r}; final LM "
                  f"lambda {float(st['lm_lambda_final'])!r}", flush=True)
    cap = WildcatConfig().inner_iter_num_max
    firsts = [int(np.argmax(v >= cap)) for v in iters.values() if (v >= cap).any()]
    for c in sorted(set(firsts)):
        a, b = max(0, c - 3), c + 4
        print(f"LM iterations of sweeps {a}-{b - 1}: " + "; ".join(
            f"{name} {v[a:b].tolist()}" for name, v in iters.items()), flush=True)
    if args.checkpoints:
        os.makedirs(args.checkpoints, exist_ok=True)
        lo = LidarOdometry(WildcatConfig(), device=dev)
        given, marks = 0, {}
        for k in np.flatnonzero(iters["kernel"] >= cap).tolist():
            given += cli.feed_events(lo, events[given:], until_sweep=k)
            checkpoint.save(os.path.join(args.checkpoints, f"after{k}.npz"), lo)
            marks[k] = given
            print(f"kernel: checkpoint after {k} sweeps ({given} events)", flush=True)
        with open(os.path.join(args.checkpoints, "marks.json"), "w") as f:
            json.dump(marks, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
