"""Command-line odometry entry point of the PyTorch port (offline subset).

Counterpart of ``wildcat_slam_tpu/cli.py``:

    python -m wildcat_slam_tpu_torch.cli --synthetic 8 --traj-out traj.tum --device cuda
    python -m wildcat_slam_tpu_torch.cli --dataset DIR [--exact-knn] [--max-sweeps N]

``--batch``, ``--stream``, ``--checkpoint-out`` and ``--resume`` are not
ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Wildcat lidar-inertial odometry (PyTorch + CUDA)")
    ap.add_argument("--dataset", help="sequence directory (imu.npz + scans/*.wcs)")
    ap.add_argument("--synthetic", type=float, default=None, metavar="SECONDS",
                    help="run on a generated synthetic sequence instead of a dataset")
    ap.add_argument("--synthetic-geometry", default="room", choices=["room", "cylinder", "ramp"])
    ap.add_argument("--traj-out", default=None, help="write trajectory (TUM format)")
    ap.add_argument("--exact-knn", action="store_true",
                    help="exact top-k correspondence search instead of the per-bin search")
    ap.add_argument("--max-sweeps", type=int, default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--verbose", action="store_true")
    for flag in ("--batch", "--stream", "--checkpoint-out", "--resume"):
        ap.add_argument(flag, default=None, help="not ported yet (NotImplementedError)")
    args = ap.parse_args(argv)
    for flag in ("batch", "stream", "checkpoint_out", "resume"):
        if getattr(args, flag) is not None:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported to wildcat_slam_tpu_torch yet "
                "(ROADMAP.md); use python -m wildcat_slam_tpu.cli")

    from wildcat_slam_tpu_torch.config import WildcatConfig
    from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry

    cfg = WildcatConfig(match_knn_approx=not args.exact_knn)
    lo = LidarOdometry(cfg, device=args.device)

    def events():
        if args.synthetic is not None:
            from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence

            seq = SyntheticSequence(duration=args.synthetic, points_per_scan=6000,
                                    room_half=5.0, geometry=args.synthetic_geometry)
            i_imu = 0
            for times, pts in seq.scans:
                while i_imu < len(seq.imu) and seq.imu[i_imu][0] <= times[-1] + 0.01:
                    yield ("imu", *seq.imu[i_imu])
                    i_imu += 1
                yield ("scan", times, pts)
        else:
            if not args.dataset:
                ap.error("need --dataset or --synthetic")
            if not os.path.isdir(args.dataset):
                ap.error(f"--dataset: no such directory: {args.dataset}")
            from wildcat_slam_tpu_torch.io.dataset import Dataset

            yield from Dataset(args.dataset)

    t0 = time.perf_counter()
    for ev in events():
        before = lo.sweep_id
        if ev[0] == "imu":
            lo.add_imu(ev[1], ev[2], ev[3])
        else:
            lo.add_scan(ev[1], ev[2])
        if args.verbose and lo.sweep_id > before:
            st = lo.stats[-1]
            print(f"sweep {lo.sweep_id}: surfels={st['n_new_surfels']} "
                  f"pairs={st['n_pairs_sld']}/{st['n_pairs_fix']} iters={st['iterations']} "
                  f"cost {st['initial_cost']:.3f}->{st['final_cost']:.3f} "
                  f"{lo.sweep_seconds[-1] * 1e3:.1f} ms", file=sys.stderr)
        if args.max_sweeps and lo.sweep_id >= args.max_sweeps:
            break
    elapsed = time.perf_counter() - t0
    n = lo.sweep_id
    print(f"{n} sweeps in {elapsed:.2f}s on {args.device} "
          f"({cfg.sweep_duration * n / max(elapsed, 1e-9):.2f}x real-time incl. kernel build)",
          file=sys.stderr)
    if n > 1:
        steady = np.asarray(lo.sweep_seconds[1:]) * 1e3
        print(f"per-sweep ms after the first: median {np.median(steady):.1f}, "
              f"p90 {np.percentile(steady, 90):.1f}", file=sys.stderr)
    if args.traj_out and lo.trajectory:
        from wildcat_slam_tpu_torch.io.trajectory import save_tum

        save_tum(args.traj_out, lo.trajectory)
        print(f"trajectory ({len(lo.trajectory)} poses) -> {args.traj_out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
