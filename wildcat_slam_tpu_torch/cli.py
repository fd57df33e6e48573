"""Command-line odometry entry point of the PyTorch port (single window).

Counterpart of ``wildcat_slam_tpu/cli.py``:

    python -m wildcat_slam_tpu_torch.cli --synthetic 8 --traj-out traj.tum --device cuda
    python -m wildcat_slam_tpu_torch.cli --dataset DIR | --bag FILE.bag [--exact-knn]
        [--degeneracy-remap] [--residual-hist] [--checkpoint-out CKPT.npz]
        [--resume CKPT.npz] [--max-sweeps N] [--strict] [--verbose]
    python -m wildcat_slam_tpu_torch.io.stream --duration 8 | \\
        python -m wildcat_slam_tpu_torch.cli --stream - --verbose

The kernels run on the card unless ``--device cpu`` is given. A checkpoint
written by either package resumes in the other. ``--batch``,
``--chunk-sweeps``, ``--native``, ``--viewer-port``, ``--snapshot-every``,
``--surfels-out``, ``--cloud-out`` and ``--profile`` are not ported yet and
raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

# flags of the JAX package's CLI that the port does not carry yet
_UNPORTED = ("batch", "chunk_sweeps", "native", "viewer_port", "snapshot_every",
             "surfels_out", "cloud_out", "profile")


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


def _warmup(cfg, device) -> float:
    """Build the kernels and the CUDA context before a live stream is read:
    one sweep of a throwaway pipeline with the same config. Returns seconds."""
    from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence
    from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry

    t0 = time.perf_counter()
    wseq = SyntheticSequence(duration=1.2, points_per_scan=2000, room_half=5.0)
    feed_events(LidarOdometry(cfg, device=device), synthetic_events(wseq), until_sweep=1)
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
    ap.add_argument("--imu-rate", type=float, default=200.0)
    ap.add_argument("--traj-out", default=None, help="write trajectory (TUM format)")
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
    for flag in _UNPORTED:
        name = "--" + flag.replace("_", "-")
        if flag == "native":
            ap.add_argument(name, action="store_true", help="not ported yet (NotImplementedError)")
        else:
            ap.add_argument(name, default=None, help="not ported yet (NotImplementedError)")
    args = ap.parse_args(argv)
    for flag in _UNPORTED:
        value = getattr(args, flag)
        if value not in (None, False) and not (flag == "chunk_sweeps" and value == "1"):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported to wildcat_slam_tpu_torch yet "
                "(ROADMAP.md); use python -m wildcat_slam_tpu.cli")

    from wildcat_slam_tpu_torch.config import WildcatConfig
    from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry, OutOfOrderError

    if args.resume:
        from wildcat_slam_tpu_torch.odometry import checkpoint

        if not os.path.exists(args.resume):
            ap.error(f"--resume: no such file: {args.resume}")
        if args.exact_knn or args.degeneracy_remap or args.residual_hist:
            print("warning: --exact-knn/--degeneracy-remap/--residual-hist are ignored with "
                  "--resume (the checkpoint's config wins)", file=sys.stderr)
        lo = checkpoint.load(args.resume, device=args.device)
        cfg = lo.cfg
    else:
        cfg = WildcatConfig(imu_rate=args.imu_rate, debug_residuals=args.residual_hist,
                            match_knn_approx=not args.exact_knn,
                            degeneracy_remap=args.degeneracy_remap)
        lo = LidarOdometry(cfg, device=args.device)

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
        print(f"warmup: kernels and device ready in {_warmup(cfg, args.device):.1f} s",
              file=sys.stderr)

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
            st = lo.stats[-1]
            deg = " DEGENERATE" if st["degenerate"] else ""
            print(f"sweep {lo.sweep_id}: surfels={st['n_new_surfels']} "
                  f"pairs={st['n_pairs_sld']}/{st['n_pairs_fix']} iters={st['iterations']} "
                  f"cost {st['initial_cost']:.3f}->{st['final_cost']:.3f} "
                  f"deg={st['deg_trans_ratio']:.3f}/{st['deg_rot_ratio']:.3f}{deg} "
                  f"{sweep_t * 1e3:.1f} ms", file=sys.stderr)

    sweeps0 = lo.sweep_id  # nonzero when resuming; counters below are per run
    n_stats0 = len(lo.stats)
    latencies = []  # --stream: scan receipt -> pose available, per sweep
    t0 = time.perf_counter()
    for ev in events():
        before = lo.sweep_id
        t_recv = time.perf_counter()
        feed(ev)
        if lo.sweep_id > before:
            # the pose is on the host: each sweep ends with its one D2H copy
            latencies.append(time.perf_counter() - t_recv)
            report(lo.sweep_seconds[-1])
        if args.max_sweeps and lo.sweep_id - sweeps0 >= args.max_sweeps:
            break
    elapsed = time.perf_counter() - t0

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
    if args.traj_out and lo.trajectory:
        from wildcat_slam_tpu_torch.io.trajectory import save_tum

        save_tum(args.traj_out, lo.trajectory)
        print(f"trajectory ({len(lo.trajectory)} poses) -> {args.traj_out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
