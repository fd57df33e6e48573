"""Command-line odometry entry point of the PyTorch port.

Counterpart of ``wildcat_slam_tpu/cli.py``:

    python -m wildcat_slam_tpu_torch.cli --synthetic 8 --traj-out traj.tum --device cuda
    python -m wildcat_slam_tpu_torch.cli --dataset DIR | --bag FILE.bag [--exact-knn]
        [--degeneracy-remap] [--residual-hist] [--checkpoint-out CKPT.npz]
        [--resume CKPT.npz] [--max-sweeps N] [--chunk-sweeps K] [--surfels-out S.ply]
        [--cloud-out C.ply] [--profile DIR] [--native] [--snapshot-every N]
        [--viewer-port PORT] [--viewer-surfels-every N] [--strict] [--verbose]
    python -m wildcat_slam_tpu_torch.cli --batch synthetic:8,synthetic:8:room:1,FILE.bag
        [--traj-out T.tum] [--surfels-out S.ply] [--checkpoint-out CKPT.npz]
    python -m wildcat_slam_tpu_torch.io.stream --duration 8 | \\
        python -m wildcat_slam_tpu_torch.cli --stream - --verbose

The kernels run on the card unless ``--device cpu`` is given. A checkpoint
written by either package resumes in the other, on the host feeder that
wrote it unless ``--native`` asks for the C++ one (``io/native.py``).
``--viewer-port`` serves a live in-browser view of the run (``viz/live.py``);
``--snapshot-every N`` writes numbered surfel PLYs next to ``--surfels-out``
and rewrites ``--traj-out`` every N sweeps.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from types import SimpleNamespace

import numpy as np


def synthetic_events(seq):
    """(kind, ...) events of a synthetic sequence in arrival order: each scan
    comes after the IMU samples up to 10 ms past its last point."""
    i_imu = 0
    for times, pts in seq.scans:
        while i_imu < len(seq.imu) and seq.imu[i_imu][0] <= times[-1] + 0.01:
            yield ("imu", *seq.imu[i_imu])
            i_imu += 1
        yield ("scan", times, pts)


def feed_events(lo, events, until_sweep=None) -> int:
    """Give (kind, ...) events to an odometry frontend in order; with
    ``until_sweep``, stop once ``lo.sweep_id`` reaches it. Returns the number
    of events given."""
    n = 0
    for ev in events:
        if ev[0] == "imu":
            lo.add_imu(*ev[1:])
        else:
            lo.add_scan(*ev[1:])
        n += 1
        if until_sweep is not None and lo.sweep_id >= until_sweep:
            break
    return n


def _stats_text(st: dict) -> str:
    """One sweep's stats as the --verbose line shows them."""
    return (f"surfels={st['n_new_surfels']} pairs={st['n_pairs_sld']}/{st['n_pairs_fix']} "
            f"iters={st['iterations']} cost {st['initial_cost']:.3f}->{st['final_cost']:.3f} "
            f"deg={st['deg_trans_ratio']:.3f}/{st['deg_rot_ratio']:.3f}"
            + (" DEGENERATE" if st["degenerate"] else ""))


def publish(viewer, lo, surfels_every: int) -> None:
    """Show ``lo``'s newest pose on a ``viz.live.LiveViewer``, and every
    ``surfels_every`` sweeps its sliding-window surfels (copied to the host)."""
    from wildcat_slam_tpu_torch.viz.surfel_export import surfel_ellipsoids

    back_t, pos, _ = lo.trajectory[-1]
    surf = None
    if lo.sweep_id % max(surfels_every, 1) == 0:
        surf = surfel_ellipsoids(_host_surfels(lo.state.sld))
    viewer.update(lo.sweep_id, float(back_t), pos, surf)


def _host_surfels(sld):
    """A window's surfels on the host, with the arrays and methods that
    ``viz/surfel_export`` reads."""
    c, cov, n = (v.cpu().numpy() for v in (sld.center_world(), sld.cov_world(), sld.norm_world()))
    return SimpleNamespace(valid=sld.valid.cpu().numpy(), t=sld.t.cpu().numpy(),
                           center_world=lambda: c, cov_world=lambda: cov, norm_world=lambda: n)


def _batch_events(spec: str, imu_topic, lidar_topic):
    """One segment source of --batch: a dataset dir, a .bag, or
    'synthetic:SECONDS[:GEOMETRY[:SEED]]'."""
    if spec.split(":")[0] == "synthetic":
        from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence

        parts = spec.split(":")
        return synthetic_events(SyntheticSequence(
            duration=float(parts[1]) if len(parts) > 1 else 8.0, points_per_scan=6000,
            room_half=5.0, geometry=parts[2] if len(parts) > 2 else "room",
            seed=int(parts[3]) if len(parts) > 3 else 0))
    if spec.endswith(".bag"):
        from wildcat_slam_tpu_torch.io.rosbag import read_bag

        return read_bag(spec, imu_topic, lidar_topic)
    from wildcat_slam_tpu_torch.io.dataset import Dataset

    return Dataset(spec)


def _run_batch(args, cfg) -> int:
    """--batch: B segments in lockstep, one window each (parallel/batch.py)."""
    from wildcat_slam_tpu_torch.odometry import checkpoint
    from wildcat_slam_tpu_torch.odometry.pipeline import OutOfOrderError
    from wildcat_slam_tpu_torch.parallel.batch import BatchedOdometry

    specs = [s.strip() for s in args.batch.split(",") if s.strip()]
    for s in specs:
        if s.split(":")[0] != "synthetic" and not os.path.exists(s):
            print(f"--batch: no such source: {s}", file=sys.stderr)
            return 2
    if args.resume:
        # the base path given to --checkpoint-out (expands to its .w{i} files)
        # or an explicit comma-separated list
        paths = ([p.strip() for p in args.resume.split(",") if p.strip()] if "," in args.resume
                 else checkpoint.batch_paths(args.resume, len(specs)))
        missing = [p for p in paths if not os.path.exists(p)]
        if missing:
            print(f"--resume: missing batch checkpoint files: {missing}", file=sys.stderr)
            return 2
        if len(paths) != len(specs):
            print(f"--resume: {len(paths)} checkpoint files for {len(specs)} --batch sources",
                  file=sys.stderr)
            return 2
        bo = checkpoint.load_batch(paths, device=args.device,
                                   use_native=True if args.native else None)
        cfg = bo.cfg  # the checkpoints' config wins, as in a single-window resume
    else:
        bo = BatchedOdometry(cfg, batch=len(specs), device=args.device, use_native=args.native)
    print(f"batch: {len(specs)} windows over {len(bo.mesh)} device(s) "
          f"({', '.join(str(d) for d in dict.fromkeys(bo.mesh))})", file=sys.stderr)

    # one persistent iterator per source: a Dataset restarts when iterated anew
    its = [iter(_batch_events(s, args.imu_topic, args.lidar_topic)) for s in specs]
    live = [True] * len(its)
    sweeps0 = [w.sweep_id for w in bo.windows]  # nonzero when resuming
    seen = [len(w.stats) for w in bo.windows]  # per-window stats already shown
    ooo_dropped = {"imu": 0, "scan": 0}

    def feed(i, ev):
        # a resumed run re-reads its sources from the start: the events before
        # the checkpoint are out of order and dropped and counted, as in the
        # single-window CLI; any other error propagates
        try:
            if ev[0] == "imu":
                bo.add_imu(i, ev[1], ev[2], ev[3])
            else:
                bo.add_scan(i, ev[1], ev[2])
        except OutOfOrderError:
            if args.strict:
                raise
            ooo_dropped[ev[0]] += 1

    def report_new():
        if not args.verbose:
            return
        for i, w in enumerate(bo.windows):
            for st in w.stats[seen[i]:]:
                print(f"w{i} sweep {sweeps0[i] + seen[i] + 1}: {_stats_text(st)}",
                      file=sys.stderr)
                seen[i] += 1

    def hit_max():
        return args.max_sweeps and min(
            w.sweep_id - s0 for w, s0 in zip(bo.windows, sweeps0)) >= args.max_sweeps

    t0 = time.perf_counter()
    while any(live):
        for i, it in enumerate(its):
            if not live[i]:
                continue
            for ev in it:  # feed through the next scan of segment i
                feed(i, ev)
                if ev[0] == "scan":
                    break
            else:
                live[i] = False
        bo.pump()
        report_new()
        if hit_max():
            break
    if not hit_max():
        bo.finish()
        report_new()
    trajs = bo.trajectories  # copies the pending outputs inside the timed run
    elapsed = time.perf_counter() - t0

    total = sum(w.sweep_id - s0 for w, s0 in zip(bo.windows, sweeps0))
    for i, w in enumerate(bo.windows):
        n_deg = sum(1 for s in w.stats if s["degenerate"])
        print(f"window {i}: {w.sweep_id} sweeps"
              + (f" ({w.sweep_id - sweeps0[i]} this run)" if sweeps0[i] else "")
              + (f", {n_deg} DEGENERATE" if n_deg else ""), file=sys.stderr)
    if any(ooo_dropped.values()):
        print(f"WARNING: dropped {ooo_dropped['imu']} out-of-order IMU and "
              f"{ooo_dropped['scan']} out-of-order scan messages (duplicate or backward "
              "timestamps; --strict aborts instead)", file=sys.stderr)
    print(f"batch total: {total} sweeps in {elapsed:.2f}s on {args.device} "
          f"({cfg.sweep_duration * total / max(elapsed, 1e-9):.2f}x real-time incl. kernel "
          "build, all windows)", file=sys.stderr)

    if args.checkpoint_out:
        paths = checkpoint.save_batch(args.checkpoint_out, bo)
        print(f"state checkpoints -> {', '.join(paths)}", file=sys.stderr)
    if args.traj_out:
        from wildcat_slam_tpu_torch.io.trajectory import save_tum

        base, ext = os.path.splitext(args.traj_out)
        for i, traj in enumerate(trajs):
            if traj:
                save_tum(f"{base}_w{i}{ext or '.tum'}", traj)
        print(f"trajectories -> {base}_w*{ext or '.tum'}", file=sys.stderr)
    if args.surfels_out:
        from wildcat_slam_tpu_torch.viz.surfel_export import save_surfels_ply

        base, ext = os.path.splitext(args.surfels_out)
        for i, st in enumerate(bo.state):
            cnt = save_surfels_ply(f"{base}_w{i}{ext or '.ply'}", _host_surfels(st.sld))
            print(f"{cnt} surfels -> {base}_w{i}{ext or '.ply'}", file=sys.stderr)
    return 0


def _warmup(cfg, device, use_native: bool) -> float:
    """Build the kernels (and the native feeder) and the CUDA context before a
    live stream is read: one sweep of a throwaway pipeline with the same
    config. Returns seconds."""
    from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence
    from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry

    t0 = time.perf_counter()
    wseq = SyntheticSequence(duration=1.2, points_per_scan=2000, room_half=5.0)
    feed_events(LidarOdometry(cfg, device=device, use_native=use_native),
                synthetic_events(wseq), until_sweep=1)
    return time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Wildcat lidar-inertial odometry (PyTorch + CUDA)")
    ap.add_argument("--dataset", help="sequence directory (imu.npz + scans/*.wcs)")
    ap.add_argument("--bag", help="ROS1 .bag file (sensor_msgs/Imu + PointCloud2)")
    ap.add_argument("--imu-topic", default=None, help="bag IMU topic (default: any Imu)")
    ap.add_argument("--lidar-topic", default=None, help="bag lidar topic (default: any PointCloud2)")
    ap.add_argument("--synthetic", type=float, default=None, metavar="SECONDS",
                    help="run on a generated synthetic sequence instead of a dataset")
    ap.add_argument("--synthetic-geometry", default="room", choices=["room", "cylinder", "ramp"])
    ap.add_argument("--synthetic-door-spacing", type=float, default=0.0, metavar="M",
                    help="doorway spacing for --synthetic-geometry ramp (0 = bare corridor)")
    ap.add_argument("--batch", default=None, metavar="SRC1,SRC2,...",
                    help="process B independent segments in lockstep, one window each "
                         "(parallel/batch.py). Each SRC is a dataset dir, a .bag file, or "
                         "'synthetic:SECONDS[:GEOMETRY[:SEED]]'. --traj-out FILE.tum writes "
                         "FILE_w0.tum, FILE_w1.tum, ...; --surfels-out likewise")
    ap.add_argument("--stream", default=None, metavar="SRC",
                    help="run live from a framed sensor stream (io/stream.py): '-' = stdin, "
                         "'tcp:HOST:PORT', or a FIFO/file path; reports scan->pose latency")
    ap.add_argument("--stream-imu-queue", type=int, default=100000, metavar="N",
                    help="bounded IMU queue for --stream (drop-oldest, counted; 0 = unbounded; "
                         "producer backpressure only when both bounds are 0)")
    ap.add_argument("--stream-scan-queue", type=int, default=512, metavar="N",
                    help="bounded scan queue for --stream (drop-oldest, counted; 0 = unbounded)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the pre-stream warmup (the first live sweep then builds the "
                         "kernels and the CUDA context)")
    ap.add_argument("--snapshot-every", type=int, default=None, metavar="N",
                    help="every N sweeps: numbered surfel PLYs next to --surfels-out "
                         "(S_000010.ply, ...) and a rewritten --traj-out")
    ap.add_argument("--viewer-port", type=int, default=None, metavar="PORT",
                    help="serve a live in-browser 3D view of the run on this port (trajectory "
                         "and surfel ellipsoids, viz/live.py; 0 picks a free port)")
    ap.add_argument("--viewer-surfels-every", type=int, default=5, metavar="N",
                    help="refresh the viewer's surfels every N sweeps (the pose every sweep)")
    ap.add_argument("--imu-rate", type=float, default=200.0)
    ap.add_argument("--traj-out", default=None, help="write trajectory (TUM format)")
    ap.add_argument("--surfels-out", default=None,
                    help="write the final sliding-window surfels (PLY ellipsoids)")
    ap.add_argument("--cloud-out", default=None,
                    help="write the accumulated undistorted cloud (PLY)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="trace the run with torch.profiler into DIR/trace.json (Chrome trace)")
    ap.add_argument("--native", action="store_true",
                    help="use the C++ host feeder (csrc/feeder.cc, built with g++ at first use)")
    ap.add_argument("--chunk-sweeps", type=int, default=1, metavar="K",
                    help="offline replay: stage K sweeps of feeds and run them in one chained "
                         "call with one copy of their outputs. Incompatible with --stream (adds "
                         "K sweeps of latency) and the per-sweep readers --cloud-out, "
                         "--residual-hist, --viewer-port, --snapshot-every and --verbose")
    ap.add_argument("--max-sweeps", type=int, default=None)
    ap.add_argument("--residual-hist", action="store_true",
                    help="print pre/post-solve residual histograms per sweep")
    ap.add_argument("--exact-knn", action="store_true",
                    help="exact top-k correspondence search instead of the per-bin search")
    ap.add_argument("--degeneracy-remap", action="store_true",
                    help="project each solver step's common-mode component off the "
                         "unobserved directions (exact no-op on healthy scenes)")
    ap.add_argument("--checkpoint-out", default=None, metavar="NPZ",
                    help="save the full odometry state at exit (resume with --resume)")
    ap.add_argument("--resume", default=None, metavar="NPZ",
                    help="resume from a checkpoint of either package (its config wins)")
    ap.add_argument("--strict", action="store_true",
                    help="abort on out-of-order sensor messages instead of dropping and "
                         "counting them")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    from wildcat_slam_tpu_torch.config import WildcatConfig
    from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry, OutOfOrderError
    from wildcat_slam_tpu_torch.utils.profiling import StageTimer, trace

    if args.batch:
        if args.stream or args.cloud_out:
            ap.error("--batch is incompatible with --stream/--cloud-out (per-window clouds and "
                     "live streams stop at the batch boundary; checkpoint/resume and --verbose "
                     "work)")
        return _run_batch(args, WildcatConfig(imu_rate=args.imu_rate,
                                              match_knn_approx=not args.exact_knn,
                                              degeneracy_remap=args.degeneracy_remap))
    if args.chunk_sweeps > 1:
        bad = [f for f, on in (("--stream", args.stream is not None),
                               ("--cloud-out", bool(args.cloud_out)),
                               ("--residual-hist", args.residual_hist),
                               ("--viewer-port", args.viewer_port is not None),
                               ("--snapshot-every", bool(args.snapshot_every)),
                               ("--verbose", args.verbose)) if on]
        if bad:
            ap.error(f"--chunk-sweeps > 1 is incompatible with {', '.join(bad)} (per-sweep "
                     "outputs/latency)")
    frontend = dict(collect_clouds=args.cloud_out is not None,
                    chunk_sweeps=max(args.chunk_sweeps, 1))

    if args.resume:
        from wildcat_slam_tpu_torch.odometry import checkpoint

        if not os.path.exists(args.resume):
            ap.error(f"--resume: no such file: {args.resume}")
        if args.exact_knn or args.degeneracy_remap or args.residual_hist:
            print("warning: --exact-knn/--degeneracy-remap/--residual-hist are ignored with "
                  "--resume (the checkpoint's config wins)", file=sys.stderr)
        # the host feeder follows the checkpoint unless --native is passed
        lo = checkpoint.load(args.resume, device=args.device,
                             use_native=True if args.native else None, **frontend)
        cfg = lo.cfg
    else:
        cfg = WildcatConfig(imu_rate=args.imu_rate, debug_residuals=args.residual_hist,
                            match_knn_approx=not args.exact_knn,
                            degeneracy_remap=args.degeneracy_remap)
        lo = LidarOdometry(cfg, device=args.device, use_native=args.native, **frontend)
    timer = StageTimer()

    stream_reader = None  # BoundedQueueReader when --stream runs bounded

    def events():
        nonlocal stream_reader
        if args.stream is not None:
            from wildcat_slam_tpu_torch.io.stream import (BoundedQueueReader, open_source,
                                                          read_stream)

            src = open_source(args.stream)
            if args.stream_imu_queue > 0 or args.stream_scan_queue > 0:
                stream_reader = BoundedQueueReader(src, imu_queue=args.stream_imu_queue,
                                                   scan_queue=args.stream_scan_queue)
                yield from stream_reader
            else:  # both 0: plain blocking reads, producer backpressure
                yield from read_stream(src)
        elif args.synthetic is not None:
            from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence

            yield from synthetic_events(SyntheticSequence(
                duration=args.synthetic, points_per_scan=6000, room_half=5.0,
                geometry=args.synthetic_geometry, door_spacing=args.synthetic_door_spacing))
        elif args.bag:
            from wildcat_slam_tpu_torch.io.rosbag import read_bag

            if not os.path.exists(args.bag):
                ap.error(f"--bag: no such file: {args.bag}")
            yield from read_bag(args.bag, args.imu_topic, args.lidar_topic)
        else:
            if not args.dataset:
                ap.error("need --dataset, --bag, --synthetic, or --stream")
            if not os.path.isdir(args.dataset):
                ap.error(f"--dataset: no such directory: {args.dataset}")
            from wildcat_slam_tpu_torch.io.dataset import Dataset

            yield from Dataset(args.dataset)

    if args.stream is not None and not args.no_warmup:
        print(f"warmup: kernels and device ready in "
              f"{_warmup(cfg, args.device, lo.use_native):.1f} s", file=sys.stderr)

    viewer = None
    if args.viewer_port is not None:
        from wildcat_slam_tpu_torch.viz.live import LiveViewer

        viewer = LiveViewer(args.viewer_port)
        print(f"live viewer: http://localhost:{viewer.port}/", file=sys.stderr)

    def snapshot() -> None:
        if args.surfels_out:
            from wildcat_slam_tpu_torch.viz.surfel_export import save_surfels_ply

            base, ext = os.path.splitext(args.surfels_out)
            save_surfels_ply(f"{base}_{lo.sweep_id:06d}{ext or '.ply'}",
                             _host_surfels(lo.state.sld))
        if args.traj_out:
            from wildcat_slam_tpu_torch.io.trajectory import save_tum

            save_tum(args.traj_out, lo.trajectory)

    # Field-quirk policy (as in the JAX package's CLI): the library refuses an
    # out-of-order message before it changes any state; the CLI drops and
    # counts it, --strict raises. Any other error propagates
    ooo_dropped = {"imu": 0, "scan": 0}

    def feed(ev):
        try:
            if ev[0] == "imu":
                lo.add_imu(ev[1], ev[2], ev[3])
            else:
                lo.add_scan(ev[1], ev[2])
        except OutOfOrderError:
            if args.strict:
                raise
            ooo_dropped[ev[0]] += 1

    def report(sweep_t: float) -> None:
        if args.residual_hist and lo.residuals:
            from wildcat_slam_tpu_torch.utils.histogram import residual_report

            r = lo.residuals[-1]
            for name, v in (("surfel pre ", r["surfel_pre"]), ("surfel post", r["surfel"]),
                            ("imu-gyro pre ", np.linalg.norm(r["imu_pre"][:, 0:3], axis=1)),
                            ("imu-gyro post", np.linalg.norm(r["imu"][:, 0:3], axis=1))):
                print(residual_report(name, v), file=sys.stderr)
        if args.verbose:
            print(f"sweep {lo.sweep_id}: {_stats_text(lo.stats[-1])} {sweep_t * 1e3:.1f} ms",
                  file=sys.stderr)

    sweeps0 = lo.sweep_id  # nonzero when resuming; counters below are per run
    n_stats0 = len(lo.stats)
    latencies = []  # --stream: scan receipt -> pose available, per sweep

    def run() -> float:
        t0 = time.perf_counter()
        for ev in events():
            before = lo.sweep_id
            t_recv = time.perf_counter()
            with timer.stage(ev[0]):
                feed(ev)
            if lo.sweep_id > before:
                # the per-sweep path ends each sweep with its one D2H copy, so
                # the pose is on the host (--stream runs no chunks)
                latencies.append(time.perf_counter() - t_recv)
                if args.snapshot_every and lo.sweep_id % args.snapshot_every == 0:
                    snapshot()
                if viewer is not None:
                    publish(viewer, lo, args.viewer_surfels_every)
                report(lo.sweep_seconds[-1])
            if args.max_sweeps and lo.sweep_id - sweeps0 >= args.max_sweeps:
                break
        lo.trajectory  # chained mode: runs the partial tail chunk inside the timed run
        return time.perf_counter() - t0

    try:
        if args.profile:
            with trace(args.profile):
                elapsed = run()
            print(f"profile -> {os.path.join(args.profile, 'trace.json')}", file=sys.stderr)
        else:
            elapsed = run()
    finally:
        if viewer is not None:
            viewer.close()

    n = lo.sweep_id - sweeps0
    if any(ooo_dropped.values()):
        print(f"WARNING: dropped {ooo_dropped['imu']} out-of-order IMU and "
              f"{ooo_dropped['scan']} out-of-order scan messages (duplicate or backward "
              "timestamps; --strict aborts instead)", file=sys.stderr)
    if stream_reader is not None and any(stream_reader.dropped.values()):
        d = stream_reader.dropped
        print(f"WARNING: stream overload -- dropped {d['imu']} IMU and {d['scan']} scan "
              f"messages (oldest first; queue bounds {args.stream_imu_queue}/"
              f"{args.stream_scan_queue})", file=sys.stderr)
    n_deg = sum(1 for s in lo.stats[n_stats0:] if s["degenerate"])
    if n_deg:
        print(f"WARNING: {n_deg}/{n} sweeps flagged DEGENERATE (direction-coverage ratio < "
              f"{cfg.degeneracy_warn_ratio}); per-sweep ratios in stats deg_trans_ratio/"
              "deg_rot_ratio", file=sys.stderr)
    print(f"{n} sweeps in {elapsed:.2f}s on {args.device} "
          f"({cfg.sweep_duration * n / max(elapsed, 1e-9):.2f}x real-time incl. kernel build)",
          file=sys.stderr)
    if n > 1:
        steady = np.asarray(lo.sweep_seconds[-n + 1:]) * 1e3
        print(f"per-sweep ms after the first: median {np.median(steady):.1f}, "
              f"p90 {np.percentile(steady, 90):.1f}", file=sys.stderr)
    if args.stream is not None and len(latencies) > 1:
        lat = np.asarray(latencies[1:]) * 1e3
        print(f"live latency (scan->pose) after the first sweep: median {np.median(lat):.1f} ms, "
              f"p95 {np.percentile(lat, 95):.1f} ms, max {lat.max():.1f} ms over "
              f"{len(lat)} sweeps (first: {latencies[0] * 1e3:.1f} ms)", file=sys.stderr)

    if args.checkpoint_out:
        from wildcat_slam_tpu_torch.odometry import checkpoint

        checkpoint.save(args.checkpoint_out, lo)
        print(f"state checkpoint -> {args.checkpoint_out}", file=sys.stderr)
    if args.verbose:
        print(timer.report(), file=sys.stderr)
    if args.traj_out and lo.trajectory:
        from wildcat_slam_tpu_torch.io.trajectory import save_tum

        save_tum(args.traj_out, lo.trajectory)
        print(f"trajectory ({len(lo.trajectory)} poses) -> {args.traj_out}", file=sys.stderr)
    if args.surfels_out:
        from wildcat_slam_tpu_torch.viz.surfel_export import save_surfels_ply

        cnt = save_surfels_ply(args.surfels_out, _host_surfels(lo.state.sld))
        print(f"{cnt} surfels -> {args.surfels_out}", file=sys.stderr)
    if args.cloud_out and lo.clouds:
        from wildcat_slam_tpu_torch.viz.surfel_export import save_cloud_ply

        cloud = np.concatenate(lo.clouds)
        save_cloud_ply(args.cloud_out, cloud)
        print(f"cloud ({len(cloud)} points) -> {args.cloud_out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
