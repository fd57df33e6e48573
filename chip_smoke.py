"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each or more (any failure raises and the script exits
non-zero):
  1. device  -- a CUDA card must be present (no CPU fallback); versions, and
                the card's name and power limit from nvidia-smi;
  2. build   -- compile the CUDA kernels from csrc/ with nvcc;
  3. kernels -- each kernel against its plain PyTorch version on the card at
                the main path's shapes on seeded random inputs (K1 PCG at S=96,
                plus S=192/256; K2 KNN bins at Q=8192 vs T=8192 and T=16384);
  4. main    -- LidarOdometry(WildcatConfig(), device="cuda") on an 8 s
                synthetic sequence at 64k points per sweep: ATE < 0.02 m, and
                both kernels launched by that run. The run records the inputs
                of the first K1 call and of each K2 call of its last sweep;
  5. replay  -- each kernel against its plain version on those recorded
                main-path inputs, with CUDA-event timings of both.
The script imports nothing of JAX or of the JAX package. Its last three lines
are the card's name and power limit, a JSON object with one entry per kernel,
and {"ok": true, "device": {...}}.

Tolerances. K2 rounds exactly like its plain version (no FMA, the same
dimension order), so values and indices must be bit-equal. K1 sums its
matvec in another order than the plain version's cuBLAS gemv and CG
amplifies that: the solutions must agree within K1_RTOL of their largest
entry, the relative residuals |(H+D)x-b|/|b| within K1_RES_RTOL of each
other and below 1 (the residual of x = 0), two kernel runs must give the same bits (no float atomics), and the
kernel must sit at most a tenth as far from the plain solution as a plain
solve that drops the damping or runs one iteration fewer.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

K1_RTOL = 1e-5
K1_RES_RTOL = 2e-5


def _nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "nvidia-smi failed"


def _time_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median milliseconds of ``fn`` by CUDA events (each rep synchronised)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _random_system(s_cap: int, seed: int):
    """SPD normal matrix and rhs, as tests/test_pcg_pallas.py builds them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = s_cap * 12
    a = rng.normal(size=(n, n + 24))
    return (a @ a.T / n).astype(np.float32), rng.normal(size=(n,)).astype(np.float32)


def _cloud(rng, n: int, spread: float = 5.0):
    """Surfel descriptor cloud, as tests/test_knn_pallas.py builds it."""
    import numpy as np

    c = rng.uniform(-spread, spread, (n, 3))
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return np.concatenate([c, nrm / 0.0873], axis=1).astype(np.float32)


def check_k1(label: str, h, dlam, minv, b, iters: int, tol: float) -> float:
    """K1 against its plain version on one system; returns max |x - x_plain|."""
    import torch

    from wildcat_slam_tpu_torch.ops import pcg

    x = pcg.pcg_solve(h, dlam, minv, b, iters, tol)
    x2 = pcg.pcg_solve(h, dlam, minv, b, iters, tol)
    xp = pcg.pcg_solve_plain(h, dlam, minv, b, iters, tol)
    # what a wrong kernel would give: no damping in the matvec, or one
    # iteration fewer (0 when the plain solve exits before its last iteration)
    x_nodamp = pcg.pcg_solve_plain(h, torch.zeros_like(dlam), minv, b, iters, tol)
    x_short = pcg.pcg_solve_plain(h, dlam, minv, b, iters - 1, tol)
    torch.cuda.synchronize()

    def res(v):
        return float(torch.linalg.norm(h @ v + dlam * v - b) / torch.linalg.norm(b))

    err = float(torch.max(torch.abs(x - xp)))
    scale = float(torch.max(torch.abs(xp)))
    gaps = [float(torch.max(torch.abs(v - xp))) for v in (x_nodamp, x_short)]
    r, rp = res(x), res(xp)
    line = (f"K1 pcg {label}: max|x-x_plain|={err:.3e} = {err / scale:.3e} of max|x_plain|="
            f"{scale:.3e} (bound {K1_RTOL:g}); residual |(H+D)x-b|/|b| kernel {r:.7g} plain "
            f"{rp:.7g}, {abs(r - rp) / rp:.3e} apart (bound {K1_RES_RTOL:g}); plain without damping "
            f"{gaps[0]:.3e} away, one iteration fewer {gaps[1]:.3e} away; "
            f"bitwise-repeatable={bool(torch.equal(x, x2))}")
    print(line, flush=True)
    ok = (err <= K1_RTOL * scale and abs(r - rp) <= K1_RES_RTOL * rp and r < 1.0
          and torch.equal(x, x2) and all(err <= 0.1 * g for g in gaps if g > 0))
    if not ok:
        raise AssertionError("K1 disagrees with its plain version: " + line)
    return err


def check_k2(label: str, dq, dt, n_bins: int, recall: bool) -> float:
    """K2 against its plain version: values and indices bit-equal; with
    ``recall``, recall@10 of the bins against an exact search >= 0.95."""
    import torch

    from wildcat_slam_tpu_torch.ops import knn

    vals, idx = knn.knn_bins(dq, dt, n_bins)
    vp, ip = knn.knn_bins_plain(dq, dt, n_bins)
    torch.cuda.synchronize()
    err = float(torch.max(torch.abs(vals - vp)))
    ulps = int(torch.max(torch.abs(vals.view(torch.int32) - vp.view(torch.int32))))
    mismatch = int(torch.sum(idx != ip))
    line = (f"K2 knn_bins {label}: max|vals-plain|={err:.3e} ({ulps} ulp, bound 0) "
            f"idx mismatches={mismatch} (bound 0)")
    rec = 1.0
    if recall:
        got_k, _ = knn.knn_topk(dq, dt, 10)
        hits = 0
        for q0 in range(0, dq.shape[0], 1024):
            d2 = knn._sqdist(dq[q0:q0 + 1024], dt)
            ref = torch.sort(d2, dim=1, stable=True).indices[:, :10]
            got = got_k[q0:q0 + 1024]
            hits += int(torch.sum((got[:, :, None] == ref[:, None, :]).any(dim=2)))
        rec = hits / (dq.shape[0] * 10)
        line += f" recall@10={rec:.4f} (>=0.95)"
    print(line, flush=True)
    if not (ulps == 0 and mismatch == 0 and rec >= 0.95):
        raise AssertionError("K2 disagrees with its plain version: " + line)
    return err


def phase_kernels(dev) -> None:
    import numpy as np
    import torch

    from wildcat_slam_tpu_torch.ops import pcg

    # K1 at the main path's S=96 (iters 24, tol 1e-2), then S=192/256
    for s_cap in (96, 192, 256):
        h_np, b_np = _random_system(s_cap, seed=s_cap)
        h = torch.as_tensor(h_np, device=dev)
        b = torch.as_tensor(b_np, device=dev)
        dlam = 1e-3 * torch.clip(torch.diagonal(h), 1e-6, 1e32)
        minv = pcg.block_diag_inverse(h, dlam, s_cap)
        check_k1(f"random S={s_cap}", h, dlam, minv, b, 24, 1e-2)
    # K2 at Q=8192 against T=8192 (self) and T=16384 (cross)
    rng = np.random.default_rng(0)
    for t_n in (8192, 16384):
        dt = torch.as_tensor(_cloud(rng, t_n), device=dev)
        dq = dt[:8192].contiguous() if t_n == 8192 else torch.as_tensor(_cloud(rng, 8192), device=dev)
        check_k2(f"random Q=8192 T={t_n}", dq, dt, 512, recall=True)


def phase_main(dev) -> tuple[dict, dict]:
    """The shipped config on the 8 s synthetic sequence. Returns the launch
    counts of this run and the kernel inputs recorded in its last sweep."""
    import numpy as np
    import torch

    from wildcat_slam_tpu_torch.config import WildcatConfig
    from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence, ate_rmse
    from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry
    from wildcat_slam_tpu_torch.ops import knn, pcg

    t0 = time.perf_counter()
    seq = SyntheticSequence(duration=8.0, points_per_scan=12800, room_half=5.0, seed=0)
    print(f"main: synthetic sequence generated in {time.perf_counter() - t0:.1f} s", flush=True)
    lo = LidarOdometry(WildcatConfig(), device=dev)

    # record kernel inputs as the main path calls the wrappers; the recorders
    # launch nothing themselves, the wrappers count their own launches
    recorded = {}
    real_pcg, real_bins = pcg.pcg_solve, knn.knn_bins

    def pcg_recorder(h, dlam, minv, b, iters, tol):
        if recorded.get("pcg_sweep") != lo.sweep_id:  # the sweep's first LM iteration
            recorded["pcg_sweep"] = lo.sweep_id
            recorded["pcg"] = (h.clone(), dlam.clone(), minv.clone(), b.clone(), iters, tol)
        return real_pcg(h, dlam, minv, b, iters, tol)

    def bins_recorder(dq, dt, n_bins):
        recorded[("knn", dt.shape[0])] = (dq.clone(), dt.clone(), n_bins)
        return real_bins(dq, dt, n_bins)

    pcg.pcg_solve, knn.knn_bins = pcg_recorder, bins_recorder
    try:
        pcg.LAUNCHES = 0
        knn.LAUNCHES = 0
        t0 = time.perf_counter()
        imu_it = iter(seq.imu)
        pending = next(imu_it, None)
        for ts, pts in seq.scans:
            while pending is not None and pending[0] <= ts[-1] + 0.01:
                lo.add_imu(*pending)
                pending = next(imu_it, None)
            lo.add_scan(ts, pts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"pcg": pcg.LAUNCHES, "knn": knn.LAUNCHES}
    finally:
        pcg.pcg_solve, knn.knn_bins = real_pcg, real_bins
    traj = lo.trajectory
    ate = ate_rmse(traj, lambda t: seq.gt_pose(t)[0], align=False)
    steady = np.asarray(lo.sweep_seconds[1:]) * 1e3
    poses = np.stack([p for _, p, _ in traj])
    print(f"main: {lo.sweep_id} sweeps in {wall:.2f} s; per-sweep ms after the first: "
          f"median {np.median(steady):.2f}, p90 {np.percentile(steady, 90):.2f}; "
          f"ATE {ate * 1e3:.3f} mm unaligned (< 20 mm); launches {launches}", flush=True)
    if not (lo.sweep_id >= 10 and np.all(np.isfinite(poses)) and ate < 0.02):
        raise AssertionError(f"main path failed: sweeps={lo.sweep_id} ATE={ate}")
    if not (launches["pcg"] > 0 and launches["knn"] > 0):
        raise AssertionError(f"main path did not launch both kernels: {launches}")
    return launches, recorded


def phase_replay(recorded: dict) -> dict:
    """Each kernel against its plain version on the recorded main-path inputs,
    and the times of both."""
    from wildcat_slam_tpu_torch.ops import knn, pcg

    out = {}
    h, dlam, minv, b, iters, tol = recorded["pcg"]
    err = check_k1(f"main-path S={h.shape[0] // 12} (sweep {recorded['pcg_sweep']}, "
                   "first LM iteration)", h, dlam, minv, b, iters, tol)
    out["pcg"] = dict(max_abs_err=err,
                      ms=_time_ms(lambda: pcg.pcg_solve(h, dlam, minv, b, iters, tol)),
                      plain_ms=_time_ms(lambda: pcg.pcg_solve_plain(h, dlam, minv, b, iters, tol)))
    print(f"K1 pcg main-path time: kernel {out['pcg']['ms']:.4f} ms, plain "
          f"{out['pcg']['plain_ms']:.4f} ms (median of 20, CUDA events)", flush=True)
    t_sizes = sorted(k[1] for k in recorded if isinstance(k, tuple))
    for t_n in t_sizes:
        dq, dt, n_bins = recorded[("knn", t_n)]
        err = check_k2(f"main-path Q={dq.shape[0]} T={t_n}", dq, dt, n_bins, recall=False)
        if t_n == t_sizes[-1]:
            out["knn"] = dict(max_abs_err=err, ms=_time_ms(lambda: knn.knn_bins(dq, dt, n_bins)),
                              plain_ms=_time_ms(lambda: knn.knn_bins_plain(dq, dt, n_bins)))
            print(f"K2 knn_bins main-path T={t_n} time: kernel {out['knn']['ms']:.4f} ms, "
                  f"plain {out['knn']['plain_ms']:.4f} ms (median of 20, CUDA events)",
                  flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False -- this needs a CUDA card",
              file=sys.stderr)
        return 1
    from wildcat_slam_tpu_torch import _numerics
    from wildcat_slam_tpu_torch.ops import _build

    _numerics.apply()
    dev = torch.device("cuda", 0)
    smi = _nvidia_smi()
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    so = _build.build()
    print(f"build: {so.name} ready in {time.perf_counter() - t0:.1f} s", flush=True)
    phase_kernels(dev)
    launches, recorded = phase_main(dev)
    kern = phase_replay(recorded)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "wildcat_slam_tpu"))
    if bad:
        raise AssertionError(f"the port imported JAX or the JAX package: {bad}")
    rows = [
        dict(name="pcg_solve", route="cuda", source="wildcat_slam_tpu_torch/csrc/pcg.cu",
             replaces="wildcat_slam_tpu/ops/pcg_pallas.py:118", launches=launches["pcg"],
             **kern["pcg"]),
        dict(name="knn_bins", route="cuda", source="wildcat_slam_tpu_torch/csrc/knn_bins.cu",
             replaces="wildcat_slam_tpu/ops/knn_pallas.py:126", launches=launches["knn"],
             **kern["knn"]),
    ]
    for r in rows:
        if not all(math.isfinite(r[k]) for k in ("max_abs_err", "ms", "plain_ms")):
            raise AssertionError(f"non-finite measurement: {r}")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
