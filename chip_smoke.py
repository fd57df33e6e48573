"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each or more (any failure raises and the script exits
non-zero):
  1. device  -- a CUDA card must be present (no CPU fallback); versions, and
                the card's name and power limit from nvidia-smi;
  2. build   -- compile the CUDA kernels from csrc/ with nvcc;
  3. kernels -- each kernel against its plain PyTorch version on the card at
                the main path's shapes on seeded random inputs (K1 PCG at S=96,
                plus S=192/256; K2 KNN bins, vpu and mxu scoring, at Q=8192 vs
                T=8192 and T=16384);
  4. main    -- LidarOdometry(WildcatConfig(), device="cuda") on an 8 s
                synthetic sequence at 64k points per sweep: ATE < 0.02 m, and
                both kernels launched by that run. The run records the inputs
                of the first K1 call and of each K2 call of its last sweep;
  5. replay  -- the mxu path, knn_topk(mode="mxu") on the recorded K2 inputs,
                then each kernel against its plain version on the recorded
                main-path inputs, with CUDA-event timings of both and of one
                PyTorch call as yardstick (library_ms), and each kernel's bound;
  6. paths   -- at the shipped config, each path with the launch counts set to
                0 before it and read after it: (a) the room with
                degeneracy_remap=True, equal to the main path's trajectory bit
                for bit; (b) the cylinder (seed 2) with the remap off and on,
                both ATEs and the sweeps where it fired; (c) 8 sweeps, a
                checkpoint, a fresh LidarOdometry loaded from it running the
                rest, equal to the main path's trajectory bit for bit; (d) the
                CLI on a framed stream file, its scan->pose latency.
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
solve that drops the damping or runs one iteration fewer. K2 mxu takes its
product as three TF32 passes (csrc/knn_mxu.cu) where the plain version takes
one f32 product: per (query, bin) the minima must agree within MXU_FACTOR *
2^-23 * (|q| + |t|)^2 at the two winning targets (~10x the worst gap seen),
the indices may differ only where the two winners' exact squared distances
lie within that bound (near ties, counted), recall@10 against an exact search
>= 0.95, and the mxu and vpu top-10 sets must share >= 99.5% of their
candidates; a single-pass TF32 product must fail the value bound.

Bounds (bound_ms): the larger of the bytes each kernel must move (inputs read
once, outputs written once) over 3.35 TB/s and its operations over the peak
rate of their kind (67 TFLOP/s f32 with an FMA as two operations, so 33.5 T
op/s for plain f32 operations; 495 TFLOP/s TF32 on the tensor cores), counted
from this run's inputs (K1: the iterations its data needs).
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

K1_RTOL = 1e-5
K1_RES_RTOL = 2e-5
MXU_FACTOR = 16.0

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12        # FMA counted as two operations
F32_OPS = F32_FLOPS / 2  # one plain f32 (or compare/select) operation per lane per clock
TF32_FLOPS = 495e12


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


def _counted(label: str, fn):
    """Run one path with every launch count set to 0 before it; returns fn's
    result and the counts read after it. Both main-path kernels must launch."""
    import torch

    from wildcat_slam_tpu_torch.ops import knn, pcg

    pcg.LAUNCHES = knn.LAUNCHES = knn.MXU_LAUNCHES = 0
    out = fn()
    torch.cuda.synchronize()
    launches = {"pcg": pcg.LAUNCHES, "knn": knn.LAUNCHES}
    if not all(launches.values()):
        raise AssertionError(f"{label}: a kernel of the path did not launch: {launches}")
    return out, launches


def _same_trajectory(a, b) -> bool:
    import numpy as np

    return len(a) == len(b) and all(
        t1 == t2 and np.array_equal(p1, p2) and np.array_equal(q1, q2)
        for (t1, p1, q1), (t2, p2, q2) in zip(a, b))


def _bound(bytes_moved: float, **op_seconds) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes over the memory rate and
    each kind of operation over its peak rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = max(op_seconds.values())
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _pcg_iterations(h, dlam, minv, b, iters: int, tol: float) -> int:
    """Iterations the PCG recurrence runs on this system before its exit test
    stops it: the smallest iteration cap whose plain solve equals the full one
    bit for bit."""
    import torch

    from wildcat_slam_tpu_torch.ops import pcg

    full = pcg.pcg_solve_plain(h, dlam, minv, b, iters, tol)
    lo, hi = 0, iters
    while lo < hi:
        mid = (lo + hi) // 2
        if torch.equal(pcg.pcg_solve_plain(h, dlam, minv, b, mid, tol), full):
            hi = mid
        else:
            lo = mid + 1
    return lo


def _tf32(x):
    """x rounded to TF32 as csrc/knn_mxu.cu rounds it (ties away from zero):
    the operands of a single-pass TF32 product."""
    import torch

    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mxu_gap(dq, dt, vals, idx, vals_ref, idx_ref) -> tuple:
    """(worst |vals - vals_ref| in units of 2^-23 (|q| + |t|)^2 at the two
    winners, index mismatches, mismatches whose winners' exact squared
    distances differ by more than MXU_FACTOR units)."""
    import torch

    qn = torch.linalg.norm(dq.double(), dim=1, keepdim=True)
    tn = torch.linalg.norm(dt.double(), dim=1)
    unit = torch.maximum((qn + tn[idx.long()]) ** 2, (qn + tn[idx_ref.long()]) ** 2) * 2.0**-23
    ratio = float(torch.max((vals.double() - vals_ref.double()).abs() / unit))
    diff = idx != idx_ref
    rows = torch.nonzero(diff)[:, 0]
    s1 = torch.sum((dq[rows].double() - dt[idx[diff].long()].double()) ** 2, 1)
    s2 = torch.sum((dq[rows].double() - dt[idx_ref[diff].long()].double()) ** 2, 1)
    far = int(torch.sum((s1 - s2).abs() > MXU_FACTOR * unit[diff]))
    return ratio, int(diff.sum()), far


def _recall10(dq, dt, got) -> float:
    """Share of the exact 10 nearest targets (per-dimension f32 distances,
    stable ties) that ``got`` (Q, 10) holds."""
    import torch

    from wildcat_slam_tpu_torch.ops import knn

    hits = 0
    for q0 in range(0, dq.shape[0], 1024):
        ref = torch.sort(knn._sqdist(dq[q0:q0 + 1024], dt), dim=1, stable=True).indices[:, :10]
        hits += int(torch.sum((got[q0:q0 + 1024, :, None] == ref[:, None, :]).any(dim=2)))
    return hits / (dq.shape[0] * 10)


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
        rec = _recall10(dq, dt, knn.knn_topk(dq, dt, 10)[0])
        line += f" recall@10={rec:.4f} (>=0.95)"
    print(line, flush=True)
    if not (ulps == 0 and mismatch == 0 and rec >= 0.95):
        raise AssertionError("K2 disagrees with its plain version: " + line)
    return err


def check_mxu(label: str, dq, dt, n_bins: int, recall: bool) -> float:
    """K2 mxu against its plain version (see the module doc for the bounds);
    also shows that a single-pass TF32 product would fail the value bound.
    Returns max |vals - vals_plain|."""
    import torch

    from wildcat_slam_tpu_torch.ops import knn

    dq_aug, dtt_aug = knn.mxu_embedding(dq, dt)
    vals, idx = knn.knn_bins_mxu(dq_aug, dtt_aug, n_bins)
    vp, ip = knn.knn_bins_mxu_plain(dq_aug, dtt_aug, n_bins)
    v1, i1 = knn.knn_bins_mxu_plain(_tf32(dq_aug), _tf32(dtt_aug), n_bins)
    torch.cuda.synchronize()
    ratio, mismatch, far = _mxu_gap(dq, dt, vals, idx, vp, ip)
    ratio1, mismatch1, _ = _mxu_gap(dq, dt, v1, i1, vp, ip)
    err = float(torch.max(torch.abs(vals - vp)))
    km, _ = knn.knn_topk(dq, dt, 10, mode="mxu")
    kv, _ = knn.knn_topk(dq, dt, 10)
    real = torch.all(dq.abs() < knn.FAR / 2, dim=1)  # the matcher parks invalid queries at -FAR
    agree = float(torch.mean((km[real][:, :, None] == kv[real][:, None, :]).any(2).double()))
    line = (f"K2 knn_bins_mxu {label}: max|vals-plain|={err:.3e}, worst gap {ratio:.3f} x "
            f"2^-23 (|q|+|t|)^2 (bound {MXU_FACTOR:g}); idx mismatches={mismatch}, "
            f"{far} of them not near ties (bound 0); mxu/vpu top-10 agreement {agree:.5f} "
            f"over {int(real.sum())} real queries (>=0.995); single-pass TF32 would sit "
            f"{ratio1:.1f} units away with {mismatch1} idx mismatches "
            f"({'caught' if ratio1 > MXU_FACTOR else 'NOT caught'})")
    rec = 1.0
    if recall:
        rec = _recall10(dq, dt, km)
        line += f"; recall@10={rec:.4f} (>=0.95)"
    print(line, flush=True)
    if not (ratio <= MXU_FACTOR and far == 0 and agree >= 0.995 and rec >= 0.95
            and ratio1 > MXU_FACTOR):
        raise AssertionError("K2 mxu disagrees with its plain version: " + line)
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
        check_mxu(f"random Q=8192 T={t_n}", dq, dt, 512, recall=True)


def phase_main(dev) -> tuple:
    """The shipped config on the 8 s synthetic sequence. Returns the launch
    counts of this run, the kernel inputs recorded in its last sweep, its
    trajectory and the sequence's events."""
    import numpy as np

    from wildcat_slam_tpu_torch.cli import feed_events, synthetic_events
    from wildcat_slam_tpu_torch.config import WildcatConfig
    from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence, ate_rmse
    from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry
    from wildcat_slam_tpu_torch.ops import knn, pcg

    t0 = time.perf_counter()
    seq = SyntheticSequence(duration=8.0, points_per_scan=12800, room_half=5.0, seed=0)
    events = list(synthetic_events(seq))
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
        t0 = time.perf_counter()
        _, launches = _counted("main", lambda: feed_events(lo, events))
        wall = time.perf_counter() - t0
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
    return launches, recorded, traj, events


def phase_replay(recorded: dict) -> dict:
    """The mxu path on the recorded K2 inputs, then each kernel against its
    plain version on the recorded main-path inputs; the times of both, of the
    yardstick, and each kernel's bound."""
    import torch

    from wildcat_slam_tpu_torch.ops import knn, pcg

    t_sizes = sorted(k[1] for k in recorded if isinstance(k, tuple))
    # the mxu path: knn_topk(mode="mxu"), the entry point that reaches it, on
    # the inputs the main path gave K2 (launches counted from 0 here)
    knn.MXU_LAUNCHES = 0
    for t_n in t_sizes:
        dq, dt, _ = recorded[("knn", t_n)]
        knn.knn_topk(dq, dt, 10, mode="mxu")
    torch.cuda.synchronize()
    mxu_launches = knn.MXU_LAUNCHES
    print(f"mxu path: knn_topk(mode='mxu') on the main path's K2 inputs (T={t_sizes}): "
          f"{mxu_launches} launches", flush=True)
    if mxu_launches != len(t_sizes):
        raise AssertionError(f"the mxu path did not launch its kernel: {mxu_launches}")

    out = {}
    h, dlam, minv, b, iters, tol = recorded["pcg"]
    err = check_k1(f"main-path S={h.shape[0] // 12} (sweep {recorded['pcg_sweep']}, "
                   "first LM iteration)", h, dlam, minv, b, iters, tol)
    n = h.shape[0]
    its = _pcg_iterations(h, dlam, minv, b, iters, tol)
    bound_ms, bound_by = _bound(4.0 * (n * n + 3 * n + 144 * (n // 12)),
                                fp32=(its * (2.0 * n * n + 38 * n) + 28 * n) / F32_FLOPS)

    def cholesky():  # the exact solve of the damped system: the LM step's library yardstick
        chol = torch.linalg.cholesky(h + torch.diag(dlam))
        return torch.cholesky_solve(b[:, None], chol)

    out["pcg"] = dict(max_abs_err=err,
                      ms=_time_ms(lambda: pcg.pcg_solve(h, dlam, minv, b, iters, tol)),
                      plain_ms=_time_ms(lambda: pcg.pcg_solve_plain(h, dlam, minv, b, iters, tol)),
                      bound_ms=bound_ms, bound_by=bound_by, library_ms=_time_ms(cholesky))
    print(f"K1 pcg main-path time: kernel {out['pcg']['ms']:.4f} ms, plain "
          f"{out['pcg']['plain_ms']:.4f} ms, cholesky + cholesky_solve {out['pcg']['library_ms']:.4f}"
          f" ms (median of 20, CUDA events); {its} of {iters} iterations run, bound "
          f"{bound_ms * 1e3:.2f} us ({bound_by})", flush=True)
    for t_n in t_sizes:
        dq, dt, n_bins = recorded[("knn", t_n)]
        err = check_k2(f"main-path Q={dq.shape[0]} T={t_n}", dq, dt, n_bins, recall=False)
        err_mxu = check_mxu(f"main-path Q={dq.shape[0]} T={t_n}", dq, dt, n_bins, recall=False)
        if t_n != t_sizes[-1]:
            continue
        q, d = dq.shape
        bound_ms, bound_by = _bound(4.0 * (q * d + t_n * d) + 8.0 * q * n_bins,
                                    fp32=q * t_n * (3 * d + 2) / F32_OPS)
        out["knn"] = dict(max_abs_err=err, ms=_time_ms(lambda: knn.knn_bins(dq, dt, n_bins)),
                          plain_ms=_time_ms(lambda: knn.knn_bins_plain(dq, dt, n_bins)),
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=_time_ms(lambda: torch.topk(torch.cdist(dq, dt), 10, dim=1,
                                                                 largest=False)))
        dq_aug, dtt_aug = knn.mxu_embedding(dq, dt)
        kd = dq_aug.shape[1]
        bound_ms, bound_by = _bound(4.0 * (q * kd + kd * t_n) + 8.0 * q * n_bins,
                                    tf32=q * t_n * kd * 2 * 3 / TF32_FLOPS,
                                    fold=3.0 * q * t_n / F32_OPS)
        out["knn_mxu"] = dict(
            max_abs_err=err_mxu, launches=mxu_launches,
            ms=_time_ms(lambda: knn.knn_bins_mxu(dq_aug, dtt_aug, n_bins)),
            plain_ms=_time_ms(lambda: knn.knn_bins_mxu_plain(dq_aug, dtt_aug, n_bins)),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=_time_ms(lambda: torch.topk(dq_aug @ dtt_aug, 10, dim=1, largest=False)))
        for key, what in (("knn", "cdist + topk"), ("knn_mxu", "matmul + topk")):
            r = out[key]
            print(f"K2 {key} main-path T={t_n} time: kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, exact {what} {r['library_ms']:.4f} ms (median of 20, "
                  f"CUDA events); bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})",
                  flush=True)
    return out


def phase_paths(dev, main_traj, main_events) -> dict:
    """The single-window paths beyond the main one, each with its launch
    counts from 0 (see the module doc). Returns the counts per path."""
    import contextlib
    import io
    import os
    import re
    import tempfile

    import numpy as np

    from wildcat_slam_tpu_torch import cli
    from wildcat_slam_tpu_torch.config import WildcatConfig
    from wildcat_slam_tpu_torch.io.stream import stream_synthetic
    from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence, ate_rmse
    from wildcat_slam_tpu_torch.odometry import checkpoint
    from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry

    counts = {}

    def run(cfg, events):
        lo = LidarOdometry(cfg, device=dev)
        cli.feed_events(lo, events)
        return lo

    # (a) remap on the healthy room: inert, bit for bit
    t0 = time.perf_counter()
    lo, counts["remap_room"] = _counted("remap room", lambda: run(
        WildcatConfig(degeneracy_remap=True), main_events))
    same = _same_trajectory(lo.trajectory, main_traj)
    med = np.median(np.asarray(lo.sweep_seconds[1:]) * 1e3)
    print(f"paths (a) room, degeneracy_remap=True: {lo.sweep_id} sweeps, per-sweep median "
          f"{med:.2f} ms after the first, trajectory equal to remap off bit for bit: {same}; "
          f"launches {counts['remap_room']} ({time.perf_counter() - t0:.1f} s)", flush=True)
    if not same:
        raise AssertionError("remap on the healthy room changed the trajectory")

    # (b) the cylinder (seed 2), remap off and on
    seq = SyntheticSequence(duration=8.0, points_per_scan=12800, room_half=5.0, seed=2,
                            geometry="cylinder")
    cyl = list(cli.synthetic_events(seq))
    ates = {}
    for remap in (False, True):
        cfg = WildcatConfig(degeneracy_remap=remap)
        lo, counts[f"cylinder_remap_{'on' if remap else 'off'}"] = _counted(
            "cylinder", lambda: run(cfg, cyl))
        ates[remap] = ate_rmse(lo.trajectory, lambda t: seq.gt_pose(t)[0], align=False)
        fired = [i for i, st in enumerate(lo.stats)
                 if min(st["deg_trans_ratio"], st["deg_rot_ratio"]) < cfg.degeneracy_remap_ratio]
        print(f"paths (b) cylinder seed 2, remap {'on ' if remap else 'off'}: {lo.sweep_id} sweeps, "
              f"ATE {ates[remap] * 1e3:.3f} mm unaligned, per-sweep median "
              f"{np.median(np.asarray(lo.sweep_seconds[1:]) * 1e3):.2f} ms; sweeps under the remap "
              f"ratio {cfg.degeneracy_remap_ratio}: {fired}", flush=True)
        if not (lo.sweep_id >= 10 and np.isfinite(ates[remap])):
            raise AssertionError(f"cylinder run failed: sweeps={lo.sweep_id} ATE={ates[remap]}")
    print(f"paths (b) the JAX package's contract 'ATE remap on < off' "
          f"(tests/test_regimes.py) {'holds' if ates[True] < ates[False] else 'does not hold'} "
          f"here: {ates[True] * 1e3:.3f} vs {ates[False] * 1e3:.3f} mm", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        # (c) checkpoint after 8 sweeps, resumed in a fresh frontend on the card
        def round_trip():
            lo = LidarOdometry(WildcatConfig(), device=dev)
            n = cli.feed_events(lo, main_events, until_sweep=8)
            path = os.path.join(tmp, "ckpt.npz")
            checkpoint.save(path, lo)
            lo2 = checkpoint.load(path, device=dev)
            cli.feed_events(lo2, main_events[n:])
            return lo2

        lo, counts["checkpoint"] = _counted("checkpoint", round_trip)
        same = _same_trajectory(lo.trajectory, main_traj)
        print(f"paths (c) checkpoint after 8 sweeps, loaded on {dev} and run on: "
              f"{lo.sweep_id} sweeps, trajectory equal to the uninterrupted run bit for bit: "
              f"{same}; launches {counts['checkpoint']}", flush=True)
        if not same:
            raise AssertionError("the resumed run left the uninterrupted trajectory")

        # (d) the CLI, live from a framed stream file
        path = os.path.join(tmp, "room.wcst")
        with open(path, "wb") as f:
            stream_synthetic(f, duration=8.0, points_per_scan=12800, seed=0, realtime=False)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc, counts["cli_stream"] = _counted("cli --stream", lambda: cli.main(
                ["--stream", path, "--device", "cuda"]))
        text = err.getvalue()
        for ln in text.strip().splitlines():
            if "ptxas" not in ln:
                print(f"paths (d) cli --stream: {ln}", flush=True)
        lat = re.search(r"median ([0-9.]+) ms, p95 ([0-9.]+) ms", text)
        sweeps = re.search(r"(\d+) sweeps in", text)
        # the stream is in time order: nothing may be dropped as out of order
        if (rc != 0 or not lat or not sweeps or int(sweeps.group(1)) < 10
                or "out-of-order" in text):
            raise AssertionError("cli --stream failed:\n" + text)
        print(f"paths (d) cli --stream: scan->pose latency after the first sweep median "
              f"{lat.group(1)} ms, p95 {lat.group(2)} ms; launches {counts['cli_stream']}",
              flush=True)
    return counts


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
    launches, recorded, main_traj, main_events = phase_main(dev)
    kern = phase_replay(recorded)
    phase_paths(dev, main_traj, main_events)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "wildcat_slam_tpu"))
    if bad:
        raise AssertionError(f"the port imported JAX or the JAX package: {bad}")
    mxu = kern.pop("knn_mxu")
    rows = [
        dict(name="pcg_solve", route="cuda", source="wildcat_slam_tpu_torch/csrc/pcg.cu",
             replaces="wildcat_slam_tpu/ops/pcg_pallas.py:118", launches=launches["pcg"],
             **kern["pcg"]),
        dict(name="knn_bins", route="cuda", source="wildcat_slam_tpu_torch/csrc/knn_bins.cu",
             replaces="wildcat_slam_tpu/ops/knn_pallas.py:126", launches=launches["knn"],
             **kern["knn"]),
        dict(name="knn_bins_mxu", route="cuda", source="wildcat_slam_tpu_torch/csrc/knn_mxu.cu",
             replaces="wildcat_slam_tpu/ops/knn_pallas.py:104", **mxu),
    ]
    for r in rows:
        nums = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")
        if not (r["launches"] > 0 and all(math.isfinite(r[k]) for k in nums)):
            raise AssertionError(f"missing or non-finite measurement: {r}")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
