"""Where a sweep's time goes on one CUDA card.

    python -m wildcat_slam_tpu_torch.profile_sweeps [--profiled 6] [--table FILE]

Runs the shipped ``WildcatConfig()`` on the synthetic sequence of
``chip_smoke.py`` (8 s, 12 800 points per scan: 64k points per sweep) three
times, each with a fresh ``LidarOdometry``:

1. plain -- per-sweep wall ms after the first sweep (median, p90);
2. stages -- every stage that ``process_sweep`` calls is timed between two
   ``torch.cuda.synchronize()`` calls; ms per sweep by stage, averaged over
   the sweeps after the first (the syncs add a little to each stage); this
   run is eager (process_sweep called each sweep), since a graph replays all
   the stages in one launch;
3. profiler -- ``torch.profiler`` (CPU + CUDA) over the last ``--profiled``
   sweeps: the host's launch calls (kernels and CUDA graphs), host
   synchronisations and device kernel time per sweep, and the largest device
   items.

Runs 1 and 3 take the frontend's own path: on the card, the sweep graph.

The device idle share is 1 - (device kernel ms per sweep, run 3) / (median
wall ms per sweep, run 1): device time from the profiler against wall time
taken without it. The device time is the sum over the profiler's device
rows, the table's "Self CUDA time total"; kernels run one at a time on one
stream, so it is the time the device was busy.
"""

from __future__ import annotations

import argparse
import functools
import sys

import numpy as np
import torch
from torch.autograd import DeviceType

from wildcat_slam_tpu_torch.cli import feed_events, synthetic_events
from wildcat_slam_tpu_torch.config import WildcatConfig
from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence
from wildcat_slam_tpu_torch.odometry import corrections as cor_mod
from wildcat_slam_tpu_torch.odometry import factors as fmod
from wildcat_slam_tpu_torch.odometry import imu as imu_mod
from wildcat_slam_tpu_torch.odometry import pipeline
from wildcat_slam_tpu_torch.odometry import window as win_mod
from wildcat_slam_tpu_torch.utils.profiling import StageTimer

# (namespace, attribute) of every stage process_sweep calls
STAGES = [(imu_mod, "propagate"), (win_mod, "add_sample_states"), (imu_mod, "undistort_points"),
          (pipeline, "extract_surfels"), (cor_mod, "attach_surfel_poses"),
          (win_mod, "insert_surfels"), (pipeline, "match_surfels"),
          (fmod, "pack_factor_rows"), (fmod, "pack_factor_rows_from_geo"),
          (fmod, "build_surfel_factors"), (fmod, "build_imu_factors"),
          (fmod, "direction_coverage"), (pipeline, "solve_window"),
          (cor_mod, "update_imu_poses"), (cor_mod, "update_surfel_poses"),
          (win_mod, "extract_moved"), (fmod, "pack_geo_rows"), (win_mod, "rebase_times")]

# the host's launch calls: kernels one by one, and CUDA graphs (a sweep
# graph's replay launches all its kernels in one call)
LAUNCH_KEYS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cudaLaunchCooperativeKernel", "cudaGraphLaunch")
SYNC_KEYS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def graph_ms(fn, reps: int = 20, runs: int = 5) -> float:
    """Milliseconds per call of ``fn`` on the device without the host's
    launch overhead: ``reps`` calls captured in one CUDA graph, replayed
    between CUDA events, divided by ``reps``; the median of ``runs``
    (``chip_smoke.py``'s ``graph_ms`` and the probes)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the warm-up capture needs, off the capturing stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    times.sort()
    return times[len(times) // 2]


def _run(seq, device, on_sweep=None, graph: bool = True) -> pipeline.LidarOdometry:
    """Feed the whole sequence; ``on_sweep(lo)`` runs before each scan.
    ``graph=False`` runs every sweep eagerly (the stage timings need the
    stages called one by one; a graph replays them all at once)."""
    lo = pipeline.LidarOdometry(WildcatConfig(), device=device)
    lo._use_graph = graph
    for ev in synthetic_events(seq):
        if ev[0] == "scan" and on_sweep is not None:
            on_sweep(lo)
        feed_events(lo, [ev])
    torch.cuda.synchronize()
    return lo


def stage_times(seq, device) -> tuple[dict, int]:
    """Sync-bounded ms per stage, summed over the sweeps after the first."""
    timer = StageTimer()
    on_card = torch.empty(0, device=device)  # the stage waits for this card
    depth = [0]
    counting = [False]

    def timed(name, fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if depth[0] or not counting[0]:  # only the outermost stage is timed
                return fn(*a, **kw)
            depth[0] += 1
            torch.cuda.synchronize()
            try:
                with timer.stage(name, block_on=on_card):
                    return fn(*a, **kw)
            finally:
                depth[0] -= 1
        return wrapper

    saved = [(ns, attr, getattr(ns, attr)) for ns, attr in STAGES]
    for ns, attr, fn in saved:
        setattr(ns, attr, timed(attr, fn))
    try:
        def start_counting(lo):
            counting[0] = lo.sweep_id >= 1
        lo = _run(seq, device, start_counting, graph=False)
    finally:
        for ns, attr, fn in saved:
            setattr(ns, attr, fn)
    return {name: s * 1e3 for name, s in timer.totals.items()}, lo.sweep_id - 1


def profile(seq, device, n_total: int, n_profiled: int):
    """torch.profiler over the last ``n_profiled`` of the ``n_total`` sweeps."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    prof = torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    start = max(1, n_total - n_profiled)
    started = [False]

    def gate(lo):
        if lo.sweep_id == start and not started[0]:
            started[0] = True
            prof.start()

    lo = _run(seq, device, gate)
    prof.stop()
    return prof, lo.sweep_id - start


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profiled", type=int, default=6, help="sweeps under the profiler")
    ap.add_argument("--table", default=None, help="write the profiler's full table here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_sweeps: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    seq = SyntheticSequence(duration=8.0, points_per_scan=12800, room_half=5.0, seed=0)
    print(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__}")

    lo = _run(seq, dev)
    steady = np.asarray(lo.sweep_seconds[1:]) * 1e3
    med = float(np.median(steady))
    iters = [s["iterations"] for s in lo.stats]
    print(f"plain: {lo.sweep_id} sweeps; per-sweep ms after the first: median {med:.2f}, "
          f"p90 {float(np.percentile(steady, 90)):.2f}; LM iterations {iters}")

    totals, n = stage_times(seq, dev)
    print(f"stages: sync-bounded ms per sweep over {n} sweeps "
          f"(sum {sum(totals.values()) / n:.2f}):")
    for name, ms in sorted(totals.items(), key=lambda kv: -kv[1]):
        print(f"  {name:28s} {ms / n:9.3f}")

    prof, n_prof = profile(seq, dev, lo.sweep_id, args.profiled)
    rows = prof.key_averages()

    def count(keys):
        return sum(r.count for r in rows if r.key in keys)

    # the device's own rows (kernels, memcpys), as the table's "Self CUDA time
    # total" counts them; the aten rows above them repeat the same time
    dev_us = sum(r.self_device_time_total for r in rows if r.device_type == DeviceType.CUDA
                 and not getattr(r, "is_user_annotation", False))
    dev_ms = dev_us / 1e3 / n_prof
    print(f"profiler: {n_prof} sweeps; per sweep: {count(LAUNCH_KEYS) / n_prof:.1f} launch "
          f"calls (kernels and graphs), {count(SYNC_KEYS) / n_prof:.1f} host syncs, "
          f"{count(('cudaMemcpyAsync',)) / n_prof:.1f} cudaMemcpyAsync, device kernel time "
          f"{dev_ms:.3f} ms -> idle share {1.0 - dev_ms / med:.3f} of the {med:.2f} ms "
          "median sweep")
    table = rows.table(sort_by="self_cuda_time_total", row_limit=12, max_name_column_width=60)
    print(table)
    if args.table:
        with open(args.table, "w") as f:
            f.write(rows.table(sort_by="self_cuda_time_total", row_limit=200,
                               max_name_column_width=100))
    return 0


if __name__ == "__main__":
    sys.exit(main())
