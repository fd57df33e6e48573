"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each or more (any failure raises and the script exits
non-zero):
  1. device  -- a CUDA card must be present (no CPU fallback); versions, and
                the card's name and power limit from nvidia-smi;
  2. build   -- compile the CUDA kernels from csrc/ with nvcc, count K2
                vpu's SASS instructions per (query, target) pair in its
                inner loop (cuobjdump -sass of the built library), count the
                tensor-core instructions of K2 mxu's main kernel (HGMMA, the
                wgmma of Hopper, must be there and HMMA, mma.sync, must not),
                and print K2 mxu's registers a thread, prologue and main;
  3. kernels -- each kernel against its plain PyTorch version on the card at
                the main path's shapes on seeded random inputs (K1 PCG at S=96,
                plus S=192/256; K2 KNN bins, vpu and mxu scoring, at Q=8192 vs
                T=8192 and T=16384), and at the edges of their launch
                geometry: K1 with iters=0, a system that exits early, S=8
                (held to the plain solve in float64, see below);
                K2 vpu with Q not a multiple of its queries per thread, T =
                n_bins (one target group), D=3 and D=8; K2 mxu with a ragged
                last query tile (Q=8201, Q=1001), T = n_bins (one group) and
                n_bins 128, 256 and 384 (the bin counts knn_topk gives small T);
                K3 (self_match) at Q=8192, k=10 on random candidates and on
                adversarial chains (31 and 2001 rounds, and 2001 capped at 5),
                at a ragged Q, one query and Q=35000 (its lists in a global
                scratch), bit-equal to its plain version; K4 (spd_solve) in
                float32 and float64 at N=96, m=6 and N=1152, m=1 (the main
                path's shapes), N=1, 12, 130, 576, 3072, at the largest N
                its one-block path takes (256 f32, 160 f64) and one above
                (the tile dataflow), and N=700 (a ragged last tile on the
                dataflow), held to its backward-error and forward-gap
                bounds, NaN on indefinite systems, and a graph replay equal
                to its eager call; K5 (imu_factor) and K6 (surfel_factor)
                in float32 and float64 on random factors at the main path's
                sizes (S=96, M=16384 of which 8192 binary, Mi=1536), with
                40 live states, every factor invalid, a ragged M and Mi, and
                S=8 (FACTOR_RTOL; H and the IMU bands bit-symmetric); K7
                (surfel_extract) in float32 and float64 on the 4096-point
                room sweep at the small and the tight capacities, with no
                valid point, with every point in one voxel, at P=5001, on
                k7_dense and on k7_wide (the sort's most passes)
                (K7_F64_TOL, K7_F32_TOL; t, centers and covariances
                bit-equal; two runs and a graph replay bit-equal);
  4. main    -- LidarOdometry(WildcatConfig(), device="cuda") on an 8 s
                synthetic sequence at 64k points per sweep: its first sweep
                eager, the rest on its sweep graph (odometry/graph.py); ATE <
                0.02 m, K1, K2 vpu, K3-K7 launched by that run (replays
                count the launches they hold), what the graph cost to capture;
                then (k) the eager reference, process_sweep called directly
                on each feed _prepare_feed builds: the graph run must equal it
                bit for bit (trajectory, the 22 packed outputs); it records
                the inputs of the first K1 call and of each K2, K3 and K4 call
                of its last sweep, of its first K5 and K6 normal
                equations and of its last K7 extraction;
  5. replay  -- the mxu path, knn_topk(mode="mxu") on the recorded K2 inputs,
                then each kernel against its plain version on the recorded
                main-path inputs, with CUDA-event timings of both and of one
                PyTorch call as yardstick (library_ms; none computes K3's
                fixed point, so K3's is null), and each kernel's bound; K4
                on the spline fit's system and on the first damped LM system
                (from K1's inputs) in float32 and float64, the library's
                cholesky_ex + cholesky_solve also timed back to back
                (library_device_ms, beside K4's device_ms); K5 and K6 in
                both modes (the normal mode by graph replays too; K6's
                yardstick the cross Gram b1^T b2 with the one-hot einsums it
                replaces, K5's null); K7 in float32 and float64 (one
                launch: its times, its phases' split and its sort phases'
                time by probe_extract's stamped copy, beside the yardstick
                torch.sort(stable) of the same three levels' packed keys,
                the calls its sort replaces; its library_ms null);
                then K1's S-scaling table: K1 on the random S=96/192/256
                systems, its time, iterations run, bound and share of it;
                then each wrapper's cost (wrapper_costs): device time, time
                of single calls, and the host's time per call; then K2 vpu
                and K2 mxu side by side (device time, bound) at Q=8192,
                T=16384 and at Q=16384, T=65536, with K2 mxu held to its plain
                version at the larger shape;
  6. paths   -- at the shipped config, each path with the launch counts set to
                0 before it and read after it: (a) the room with
                degeneracy_remap=True, equal to the main path's trajectory bit
                for bit; (b) the cylinder (seed 2) with the remap off and on,
                both ATEs and the sweeps where it fired; (c) 8 sweeps, a
                checkpoint, a fresh LidarOdometry loaded from it running the
                rest, equal to the main path's trajectory and to the eager
                run (trajectory and packed outputs) bit for bit; (d) the
                CLI on a framed stream file, its scan->pose latency;
                (e) batched windows: BatchedOdometry(batch=2) on the room
                seeds 0 (8 s) and 1 (6 s, so window 1 drains on no-op feeds),
                one sweep graph a window, each window equal to its eager
                single-window run bit for bit (and within BATCH_TOL of the
                main path's), then ms per lockstep round and the sweeps a
                second over all windows at B=1, 2 and 4 (four seeds, 4 rounds);
                (f) chained sweeps: LidarOdometry(chunk_sweeps=4) on the main
                path's sequence (4 feeds in one transfer, the sweep graph
                replayed from each slot), equal to the eager run bit for bit
                and within BATCH_TOL of the main path's trajectory, its median
                ms per sweep, and the host syncs and launches per sweep of
                both paths over sweeps 5-8 by torch.profiler;
                (g) outputs: cli --synthetic 4 with --surfels-out, --cloud-out,
                --profile and --traj-out (the PLYs parse, the cloud holds every
                point the sweeps were fed, the trace names the pcg and
                knn_bins kernels), then cli --batch of two 4 s rooms with
                --max-sweeps 4 --checkpoint-out, its --resume to the end, and
                an uninterrupted run: the resumed TUM files equal the
                uninterrupted ones;
                (h) the C++ host feeder: LidarOdometry(use_native=True) on the
                main path's sequence, within NATIVE_TOL of its poses, ATE
                < 20 mm, prep ms a sweep of both feeders; then a checkpoint of
                the native run after 8 sweeps, resumed on the native feeder,
                equal to the uninterrupted native run bit for bit;
                (i) the viewer and snapshots: cli --synthetic 4 --native
                --snapshot-every 2 --surfels-out --traj-out --viewer-port 0
                (a numbered PLY every 2 sweeps, each parses; a TUM line a
                sweep), then a LiveViewer fed by cli.publish from (h)'s run:
                /state holds its last pose and its surfels;
  7. regimes -- (j) tests/test_regimes.py's sequences at its _small_cfg, each
                held to that test's bound, unchanged: fast rotation (ATE <
                0.05 m, on the numpy and the native feeder), world offset
                (aligned ATE < 0.02 m), ramp travel (end error < 0.1 m after
                > 3 m), the ramp corridor with doors (ATE < 0.08 m, every
                final cost finite) and the bare ramp (error perpendicular to
                the slope < 0.03 m);
  8. graph   -- (k) bench.py's workload: the shipped config on a 50 s room
                at 12800 points a scan (~100 sweeps, the fixed window full
                from sweep 41), through LidarOdometry's sweep graph and
                through the eager reference: bit-equal (trajectory and the 22
                packed outputs), ATE < 0.02 m beside the JAX package's
                recorded figure; per sweep, for both, torch.profiler over
                sweeps GRAPH_PROFILED (launch calls, kernels and graphs; host
                syncs; memcpys; device kernel ms), the wall median and p90 of
                the other steady sweeps, the idle share; and the graph's
                capture and instantiate seconds, node count and pool size;
                then float64 with linear_solver="pcg_xla" (the plain PCG,
                its early exit on the device) and linear_solver="cholesky"
                (K4) in float32 and in float64, each on the room's first 8
                sweeps, graph against eager, bit-equal, K4's launches
                counted;
  9. records -- (l) the port on the card against the JAX package's recorded
                CPU runs in tests/torch_reference/ (written by
                tests/torch_jax_reference.py; read here, never imported):
                (k)'s graph run (shipped config, K2 bins) against room50_f32
                and room50_f64, ATE within room50_f32's + 0.5 mm; the room in
                float64 (pcg_xla, exact KNN) on the graph against room50_f64:
                its position and quaternion gaps within 1e-5 over the sweeps
                before room50_f64_ulp (the JAX package's float64 run with one
                input moved by one ulp) first passes 1e-5 m, its first sweep
                over 1e-5 m and its first sweep whose counts differ no
                earlier than room50_f64_ulp's, and over the whole run its RMS
                and largest position gaps and largest quaternion gap within
                2 x room50_f64_ulp's + 1e-5; in float32 with the exact KNN
                (K1) on the graph, its RMS and largest position gap to
                room50_f64 within 2 x room50_f32's own + 5e-5 m and its ATE
                within room50_f32's + 0.3 mm, and the float64 gate must
                refuse this float32 run (each run prints the first sweep
                whose position gap passes 1e-5 m);
                then benchmarks/longrun.py's 300 s travel and fastrot regimes
                at the shipped config on the graph against travel300_f32 and
                fastrot300_f32: ATE and final
                error within 1.25 x the record's + 1 mm; over the prefix
                before the record's error first passes 0.1 m (travel
                diverges in both packages, fastrot never passes it) the ATE
                and largest error within 1.25 x the record's + 1 mm (the gap
                to the record there is printed: float32 runs of travel part
                from the second sweep); the rebase shift
                within 1e-6 s of the record's every sweep and as many sweeps
                with a shift, fix_geo equal to pack_geo_rows(fix) bit for bit
                every 100 sweeps and at the end, one capture of the sweep
                graph, the card's allocated and reserved bytes at the end
                equal to theirs at sweep 100, the host's RSS grown by at most
                64 MiB from sweep 100. Every run's sweep times must be the
                record's; each prints its gaps, both ATEs, the LM iterations
                and capped sweeps of both packages, the median ratio of pair
                counts and the sweeps whose integer counts differ.
 10. bench   -- (m) the port's benchmark, benchmarks_torch/bench.py, once per
                cell of BENCHMARK.json (room50_shipped, room50x4_batch) with
                one repeat, each in a process of its own on this card: its
                JSON line parses, the cell is correct, and every metric
                BENCHMARK.json names for the cell is present and not null.
host_costs, not run by main, times the host feeder (numpy against native)
and the live viewer on the main sequence (see its docstring).
The script imports nothing of JAX or of the JAX package. Its last three lines
are the card's name and power limit, a JSON object with one entry per kernel,
and {"ok": true, "device": {...}}.

Tolerances. K2 rounds exactly like its plain version (no FMA, the same
dimension order), so values and indices must be bit-equal. K3 computes
integers: its partners and rounds must equal its plain version's. K4 factors
in another order than cuSOLVER: its backward error |a x - b| / (|a| |x| +
|b|) must be at most 10 N eps of its dtype (a Cholesky solve's is a small
multiple of eps), and its forward gap max|x - x_plain| / max|x_plain| at
most 100 kappa_2(a) eps (sound solves read a few kappa eps; one tile's
update left out reads ~100 times the bound at N=1152 while its backward
error stays inside 10 N eps), its solution finite, two runs bit-equal. K5
and K6 sum in other orders than their plain versions' einsums and
products: each output within 1e-10 (float64) or 1e-4 (float32) of the plain
version's largest entry on the same inputs (FACTOR_RTOL; in float32 the
plain version in float64 is printed beside it, not gated), H and the IMU
bands bit-symmetric, two runs bit-equal. K7 (surfel extraction) sums
the moments as its plain version does: its surfels' validity, time order
and n_dropped must equal the plain version's and its floats at the valid
surfels lie within 1e-10 (float64) or tests/test_torch_surfel.py's
tolerances (float32) of the plain version's (K7_F64_TOL, K7_F32_TOL). The
sweep graph runs the eager path's kernels in the eager path's order, so every
graph run must equal its eager run bit for bit. K1 sums its
matvec in another order than the plain version's cuBLAS gemv and CG
amplifies that: the solutions must agree within K1_RTOL of their largest
entry, the relative residuals |(H+D)x-b|/|b| within K1_RES_RTOL of each
other and below 1 (the residual of x = 0), two kernel runs must give the
same bits (no float atomics), and the kernel must sit at most a tenth as far
from the plain solution as a plain solve that drops the damping or runs one
iteration fewer. On an ill-conditioned system (S=8) 24 iterations amplify the
plain f32 solve's own rounding: there the plain solve in float64 on the same
inputs is the reference for all of these checks, and the kernel must also
sit no farther from it than the plain f32 solve does (its residual within
K1_RES_RTOL of the reference's, or no farther than the plain f32 solve's
residual). K2 mxu takes its
product as three TF32 passes (csrc/knn_mxu.cu) where the plain version takes
one f32 product: per (query, bin) the minima must agree within MXU_FACTOR *
2^-23 * (|q| + |t|)^2 at the two winning targets (~10x the worst gap seen),
the indices may differ only where the two winners' exact squared distances
lie within that bound (near ties, counted), recall@10 against an exact search
>= 0.95, and the mxu and vpu top-10 sets must share >= 99.5% of their
candidates; a single-pass TF32 product must fail the value bound.

Timings: ms, plain_ms and library_ms are the median of 20 single calls,
each between CUDA events and synchronised, so they include the host's launch
overhead; device_ms is CUDA events around 20 back-to-back calls divided by
20, the median of 5 such runs, where that overhead hides behind the device's
work unless it is the larger; graph_ms (K3, K4, whose wrappers cost the host
more than their launches cost the device at the main path's shapes) is 20
calls captured in one CUDA graph and replayed, divided by 20; K4's
library_device_ms is its yardstick's device_ms (cholesky_ex without its
error check, then cholesky_solve: no host sync between calls).

Bounds (bound_ms): the larger of the bytes each kernel must move (inputs read
once, outputs written once) over 3.35 TB/s and its operations over the peak
rate of their kind (67 TFLOP/s f32 with an FMA as two operations, so 33.5 T
op/s for plain f32 operations; 495 TFLOP/s TF32 on the tensor cores), counted
from this run's inputs (K1: the iterations its data needs; K4: N^3 / 6 + N^2 m
FMA at the card's peak for its dtype, 67 TFLOP/s f32, and 67 TFLOP/s f64 on
the tensor cores (DMMA), twice the rate of the DFMA that it issues).
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

K1_RTOL = 1e-5
BATCH_TOL = 1e-6  # m and quaternion units: batched or chained against single-window runs
# m and quaternion units: the C++ feeder's float32 points against numpy's
# (tests/test_native.py bounds the positions by it)
NATIVE_TOL = 2e-4
# tests/test_regimes.py's _small_cfg, the config of its regimes
REGIME_CFG = dict(max_points_per_sweep=16384, max_surfels_per_sweep=512, max_surfels_sliding=2048,
                  max_surfels_fixed=2048, max_correspondences=2048, max_leaves_per_sweep=4096,
                  max_imu_states=640, max_sample_states=48, inner_iter_num_max=25)
K1_RES_RTOL = 2e-5
MXU_FACTOR = 16.0
# (Q, T, n_bins) of K2 mxu's edge cases; tests/test_torch_kernels.py has the same
MXU_EDGES = ((8201, 16384, 512), (1001, 512, 512), (3001, 4096, 128), (3001, 4096, 256),
             (3001, 3840, 384))

# (k): the sweeps of the 50 s room under torch.profiler, [first, end)
GRAPH_PROFILED = (60, 68)

# (l): the JAX package's recorded runs (tests/torch_jax_reference.py writes
# them on a CPU; this script only reads them), and the port's copy of what
# they ran: bench.py's 50 s room and benchmarks/longrun.py's 300 s regimes
REFERENCE_DIR = ("tests", "torch_reference")
ROOM50 = dict(duration=50.0, points_per_scan=12800, room_half=5.0, seed=0)
LONGRUN = dict(duration=300.0, points_per_scan=2000, seed=0)
SOAKS = {"travel300_f32": dict(geometry="ramp", room_half=8.0, travel=1.5, door_spacing=10.0,
                               **LONGRUN),
         "fastrot300_f32": dict(room_half=5.0, rot_scale=3.0, **LONGRUN)}
# packed columns that hold counts (LM iterations, new surfels, pairs sliding
# and fixed, surfels and pairs dropped)
COUNT_COLUMNS = (8, 11, 12, 13, 17, 18)
# float64 against room50_f64: gaps <= F64_GAP (m, and quaternion units) over
# the sweeps before room50_f64_ulp (its input moved by one ulp) first passes
# F64_GAP; that sweep and its first sweep whose counts differ reached no
# earlier; over the whole run gaps <= GAP_FACTOR x room50_f64_ulp's + F64_GAP.
# float32: gap(port, room50_f64) <= GAP_FACTOR x room50_f32's + F32_GAP_SLACK
GAP_FACTOR, F64_GAP, F32_GAP_SLACK = 2.0, 1e-5, 5e-5
F32_ATE_SLACK = 3e-4    # m: exact-KNN float32 port against the JAX float32 record
BINS_ATE_SLACK = 5e-4   # m: the shipped config (K2 bins) against the JAX float32 record
SOAK_FACTOR, SOAK_SLACK = 1.25, 1e-3  # ATE and final error <= 1.25 x the record's + 1 mm
SOAK_PREFIX_ERROR = 0.1  # m: a soak's prefix ends where the record's error first passes it
SHIFT_TOL = 1e-6        # s: the rebase shift against the record's, every sweep
RSS_GROWTH = 64 * 2**20  # bytes: the host's RSS from sweep 100 to the end of a soak
LIFETIME_EVERY = 100    # sweeps between the soak's fix_geo checks

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12        # FMA counted as two operations
F32_OPS = F32_FLOPS / 2  # one plain f32 (or compare/select) operation per lane per clock
F64_FLOPS = 67e12        # FMA counted as two operations, on the tensor cores (DMMA)
TF32_FLOPS = 495e12


def _nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "nvidia-smi failed"


def _time_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median milliseconds of single calls of ``fn`` by CUDA events, each
    synchronised (host launch overhead included)."""
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


def _device_ms(fn, warmup: int = 3, reps: int = 20, runs: int = 5) -> float:
    """Milliseconds per call of ``fn`` on the device: CUDA events around
    ``reps`` back-to-back calls, divided by ``reps``; the median of ``runs``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    times.sort()
    return times[len(times) // 2]


def _host_us(fn, reps: int = 50, runs: int = 5) -> float:
    """Microseconds of host time per call of ``fn`` (the enqueue, not the
    device's work): ``reps`` calls with no sync between them, the median of
    ``runs``."""
    import torch

    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    times.sort()
    return times[len(times) // 2]


_SASS_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_SASS_BRANCH = re.compile(r"\bBRA\s+(?:`\(\.L_x_\d+\)\s*)?0x([0-9a-f]+)")
SASS_GROUPS_PER_TRIP = 2  # csrc/knn_bins.cu: the loop is unrolled over two target buffers


def sass_functions(sass: str) -> dict:
    """{mangled name: [(address, instruction), ...]} of a ``cuobjdump -sass`` listing."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _SASS_INSTR.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return out


def sass_loop(instrs: list) -> list:
    """The instructions from the target of the one backward branch to the branch."""
    back = []
    for addr, text in instrs:
        m = _SASS_BRANCH.search(text)
        if m and int(m.group(1), 16) < addr:
            back.append((int(m.group(1), 16), addr))
    if len(back) != 1:
        raise ValueError(f"expected one backward branch, found {len(back)}")
    lo, hi = back[0]
    return [text for addr, text in instrs if lo <= addr <= hi]


def sass_opcode(text: str) -> str:
    """``@!P0 FADD.FTZ R1, ...`` -> ``FADD``."""
    return re.sub(r"^@!?U?P\w+\s+", "", text).split()[0].split(".")[0]


def cuobjdump_sass(so) -> str:
    """The ``cuobjdump -sass`` listing of the built library ``so``."""
    from pathlib import Path

    from wildcat_slam_tpu_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    return subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                          check=True, timeout=120).stdout


def sass_per_pair(sass: str) -> list:
    """K2 vpu's inner loop in a ``cuobjdump -sass`` listing, per instance
    knn_bins_kernel<D, Q>: one trip scores SASS_GROUPS_PER_TRIP target groups
    for Q queries. Lines of instructions a pair against the bound's 3 D + 2."""
    import collections

    lines = []
    for name, instrs in sass_functions(sass).items():
        m = re.search(r"knn_bins_kernelILi(\d+)ELi(\d+)E", name)
        if not m:
            continue
        d, q = int(m.group(1)), int(m.group(2))
        body = sass_loop(instrs)
        pairs = SASS_GROUPS_PER_TRIP * q
        ops = collections.Counter(sass_opcode(t) for t in body)
        lines.append(f"K2 vpu SASS, knn_bins_kernel<{d}, {q}>: {len(body)} instructions a trip "
                     f"of {pairs} pairs, {len(body) / pairs:.2f} a pair (bound {3 * d + 2}); "
                     + ", ".join(f"{k} {v}" for k, v in ops.most_common()))
    if len(lines) != 3:
        raise AssertionError(f"expected three knn_bins_kernel instances, found {len(lines)}")
    return sorted(lines)


def mxu_tensor_ops(sass: str) -> str:
    """The tensor-core instructions of K2 mxu's main kernel (knn_mxu_kernel,
    not its prologue) in a ``cuobjdump -sass`` listing: a line with the counts
    of HGMMA (Hopper's wgmma), HMMA (mma.sync) and the warpgroup fences and
    waits around them. Raises unless HGMMA > 0 and HMMA == 0."""
    import collections

    funcs = [instrs for name, instrs in sass_functions(sass).items()
             if re.search(r"14knn_mxu_kernel", name)]
    if len(funcs) != 1:
        raise AssertionError(f"expected one knn_mxu_kernel in the listing, found {len(funcs)}")
    ops = collections.Counter(sass_opcode(t) for _, t in funcs[0])
    wg = collections.Counter(".".join(re.sub(r"^@!?U?P\w+\s+", "", t).split()[0].split(".")[:2])
                             for _, t in funcs[0] if "WARPGROUP" in t)
    line = (f"K2 mxu SASS, knn_mxu_kernel: HGMMA {ops['HGMMA']}, HMMA {ops['HMMA']} (needs "
            f"HGMMA > 0 and HMMA == 0); " + ", ".join(f"{k} {v}" for k, v in sorted(wg.items())))
    if not (ops["HGMMA"] > 0 and ops["HMMA"] == 0):
        raise AssertionError("K2 mxu does not run on wgmma: " + line)
    return line


def mxu_registers() -> str:
    """K2 mxu's registers and local (spill) bytes a thread, prologue and main
    kernel, as the loaded library reports them."""
    import ctypes

    from wildcat_slam_tpu_torch.ops import _build

    res = (ctypes.c_int * 4)()
    _build.check(_build.library().wc_knn_mxu_resources(res), "wc_knn_mxu_resources")
    return (f"K2 mxu registers a thread: prologue knn_mxu_split_kernel {res[0]} ({res[1]} B "
            f"local), main knn_mxu_kernel {res[2]} ({res[3]} B local)")


def _random_system(s_cap: int, seed: int):
    """SPD normal matrix and rhs, as tests/test_pcg_pallas.py builds them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = s_cap * 12
    a = rng.normal(size=(n, n + 24))
    return (a @ a.T / n).astype(np.float32), rng.normal(size=(n,)).astype(np.float32)


def random_system(dev, s_cap: int, shift: float = 0.0):
    """K1's inputs on the card for the random system of ``s_cap`` blocks,
    with ``shift`` added to H's diagonal (at S=96, 0.5 makes it converge in 8
    iterations at tol 1e-2): H, the damping (1e-3 of the diagonal), the block
    inverses and b."""
    import numpy as np
    import torch

    from wildcat_slam_tpu_torch.ops import pcg

    h_np, b_np = _random_system(s_cap, seed=s_cap)
    h = torch.as_tensor(h_np + np.float32(shift) * np.eye(12 * s_cap, dtype=np.float32),
                        device=dev)
    b = torch.as_tensor(b_np, device=dev)
    dlam = 1e-3 * torch.clip(torch.diagonal(h), 1e-6, 1e32)
    return h, dlam, pcg.block_diag_inverse(h, dlam, s_cap), b


def _cloud(rng, n: int, spread: float = 5.0):
    """Surfel descriptor cloud, as tests/test_knn_pallas.py builds it."""
    import numpy as np

    c = rng.uniform(-spread, spread, (n, 3))
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return np.concatenate([c, nrm / 0.0873], axis=1).astype(np.float32)


def _counted(label: str, fn):
    """Run one path with every launch count set to 0 before it; returns fn's
    result and the counts read after it. The kernels of the main path (K1,
    K2 vpu, K3-K7) must launch. A sweep graph's replays count the launches it
    holds, once a replay, and its capture counts none (``graph.launches``)."""
    import torch

    from wildcat_slam_tpu_torch.odometry import graph

    graph.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = graph.launches()
    launches = {k: counts[k] for k in ("pcg", "knn", "self_match", "spd", "imu_factor",
                                       "surfel_factor", "surfel_extract")}
    if not all(launches.values()):
        raise AssertionError(f"{label}: a kernel of the path did not launch: {launches}")
    return out, launches


# the 22 packed outputs of a sweep as LidarOdometry.stats holds them (beside
# the pose, 7 more, in its trajectory)
PACKED_STATS = ("shift", "iterations", "initial_cost", "final_cost", "n_new_surfels",
                "n_pairs_sld", "n_pairs_fix", "pose_pos_pred", "n_surfels_dropped",
                "n_pairs_dropped", "deg_trans_ratio", "deg_rot_ratio", "lm_lambda_final")


def _same_outputs(a, b) -> bool:
    """Two frontends' runs equal bit for bit: the trajectories, and every
    packed output of the sweeps both ran (a resumed run holds the stats of
    its own sweeps only: the last ones)."""
    import numpy as np

    n = min(len(a.stats), len(b.stats))
    return _same_trajectory(a.trajectory, b.trajectory) and n > 0 and all(
        np.array_equal(x[k], y[k], equal_nan=True)
        for x, y in zip(a.stats[len(a.stats) - n:], b.stats[len(b.stats) - n:])
        for k in PACKED_STATS)


def _eager_frontend(dev, cfg=None):
    """A frontend for the eager reference: it only buffers (dispatch =
    False); :func:`_eager_feed` steps it."""
    from wildcat_slam_tpu_torch.config import WildcatConfig
    from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry

    lo = LidarOdometry(cfg or WildcatConfig(), device=dev)
    lo.dispatch = False
    return lo


def _eager_feed(lo, events, until_sweep=None) -> int:
    """The eager reference on the card: give ``events`` to ``lo`` (from
    :func:`_eager_frontend`) and run every sweep it has ready by calling
    ``process_sweep`` directly on the feed ``_prepare_feed`` builds, with
    LidarOdometry's own bookkeeping (no graph). Stops once ``lo.sweep_id``
    reaches ``until_sweep``; returns the number of events given."""
    from wildcat_slam_tpu_torch.odometry import graph
    from wildcat_slam_tpu_torch.odometry.pipeline import init_window, process_sweep

    n = 0
    for ev in events:
        (lo.add_imu if ev[0] == "imu" else lo.add_scan)(*ev[1:])
        n += 1
        while lo._ready():
            t0 = time.perf_counter()
            if not lo.initialized:
                lo.state = init_window(lo.state, *lo._to_device(lo._init_args()), lo.cfg)
            prep = lo._prepare_feed()
            lo.state, out = process_sweep(lo.state, *lo._to_device(prep["args"]), lo.cfg)
            lo._commit(dict(out, packed=graph.HostCopy(out["packed"])), prep["back"],
                       prep["host_stats"])
            lo._flush()
            lo.sweep_seconds.append(time.perf_counter() - t0)
        if until_sweep is not None and lo.sweep_id >= until_sweep:
            break
    return n


def _graph_text(lo) -> str:
    """What a frontend's sweep graph cost to make."""
    g = lo._graph
    nodes = g.node_count()
    return (f"capture {g.capture_seconds:.3f} s, instantiate {g.instantiate_seconds:.3f} s, "
            f"{len(g.graphs)} graphs, {nodes if nodes is not None else 'not measured'} nodes, "
            f"pool {g.pool_bytes / 2**20:.1f} MiB")


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


def check_k1(label: str, h, dlam, minv, b, iters: int, tol: float,
             reference: str = "f32") -> float:
    """K1 against its plain version on one system; returns max |x - x_ref|.
    ``reference="f64"``: the plain solve in float64 on the same inputs is the
    reference, and the kernel must sit no farther from it than the plain f32
    solve does (see the module doc)."""
    import torch

    from wildcat_slam_tpu_torch.ops import pcg

    x = pcg.pcg_solve(h, dlam, minv, b, iters, tol)
    x2 = pcg.pcg_solve(h, dlam, minv, b, iters, tol)
    xp = pcg.pcg_solve_plain(h, dlam, minv, b, iters, tol)
    hr, dr, mr, br = (t.double() for t in (h, dlam, minv, b)) if reference == "f64" \
        else (h, dlam, minv, b)
    xr = pcg.pcg_solve_plain(hr, dr, mr, br, iters, tol) if reference == "f64" else xp
    # what a wrong kernel would give: no damping in the matvec, or one
    # iteration fewer (0 when the plain solve exits before its last iteration)
    x_nodamp = pcg.pcg_solve_plain(hr, torch.zeros_like(dr), mr, br, iters, tol)
    x_short = pcg.pcg_solve_plain(hr, dr, mr, br, iters - 1, tol)
    torch.cuda.synchronize()

    def res(v):
        v = v.to(hr.dtype)
        return float(torch.linalg.norm(hr @ v + dr * v - br) / torch.linalg.norm(br))

    err = float(torch.max(torch.abs(x.to(xr.dtype) - xr)))
    if iters == 0:  # no iteration: x stays 0, exactly
        line = (f"K1 pcg {label}: x == 0 {bool(torch.equal(x, torch.zeros_like(x)))}, plain "
                f"x == 0 {bool(torch.equal(xp, torch.zeros_like(xp)))}, "
                f"bitwise-repeatable={bool(torch.equal(x, x2))}")
        print(line, flush=True)
        if not (torch.equal(x, torch.zeros_like(x)) and torch.equal(xp, x) and torch.equal(x, x2)):
            raise AssertionError("K1 disagrees with its plain version: " + line)
        return err
    scale = float(torch.max(torch.abs(xr)))
    gaps = [float(torch.max(torch.abs(v - xr))) for v in (x_nodamp, x_short)]
    r, rr = res(x), res(xr)
    ref = "plain" if reference == "f32" else "plain f64"
    line = (f"K1 pcg {label}: max|x-x_{reference}|={err:.3e} = {err / scale:.3e} of "
            f"max|x_{reference}|={scale:.3e} (bound {K1_RTOL:g}); residual |(H+D)x-b|/|b| "
            f"kernel {r:.7g} {ref} {rr:.7g}, {abs(r - rr) / rr:.3e} apart (bound "
            f"{K1_RES_RTOL:g}); {ref} without damping {gaps[0]:.3e} away, one iteration fewer "
            f"{gaps[1]:.3e} away; bitwise-repeatable={bool(torch.equal(x, x2))}")
    res_bound = K1_RES_RTOL * rr
    if reference == "f64":
        err32 = float(torch.max(torch.abs(xp.double() - xr)))
        r32 = res(xp)
        res_bound = max(res_bound, abs(r32 - rr))
        line += (f"; the plain f32 solve {err32 / scale:.3e} of max|x_f64| away, its residual "
                 f"{abs(r32 - rr) / rr:.3e} apart (the kernel must be no farther in either)")
    ok = (err <= K1_RTOL * scale and abs(r - rr) <= res_bound and r < 1.0
          and torch.equal(x, x2) and all(err <= 0.1 * g for g in gaps if g > 0))
    if reference == "f64":
        ok = ok and err <= err32
    print(line, flush=True)
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


def k3_chains(q: int, k: int, seed: int, lengths, dev):
    """Adversarial inputs of K3: random candidates (30% accepted), with
    chains written in: in a chain a, a+1, ..., query a's only candidate is
    a + 1 and each later query's are its two neighbours, so that each
    query's partner depends on the one before and the fixed point needs as
    many rounds as the longest chain is long."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    cand = rng.integers(0, q, size=(q, k))
    ok = rng.random((q, k)) < 0.3
    start = 0
    for n in lengths:
        for j in range(min(n, q - 1 - start)):
            a = start + j
            row = [a + 1] if j == 0 else [a - 1, a + 1]
            cand[a, :len(row)] = row
            ok[a, :len(row)] = True
            ok[a, len(row):] = False
        start += n + 1
    return torch.as_tensor(cand, device=dev), torch.as_tensor(ok, device=dev)


def check_k3(label: str, cand, ok, max_rounds: int) -> int:
    """K3 against its plain version: partners and rounds bit-equal. Returns
    the rounds run."""
    import torch

    from wildcat_slam_tpu_torch.ops import self_match as sm

    partner, rounds = sm.self_match(cand, ok, max_rounds)
    torch.cuda.synchronize()
    ref, ref_rounds = sm.self_match_plain(cand, ok, max_rounds)
    same = torch.equal(partner, ref) and int(rounds) == int(ref_rounds)
    print(f"K3 self_match {label}: Q={cand.shape[0]} k={cand.shape[1]}, {int(rounds)} rounds "
          f"(plain {int(ref_rounds)}, cap {max_rounds}), {int((partner >= 0).sum())} matched; "
          f"bit-equal to the plain version: {same}", flush=True)
    if not same:
        raise AssertionError(f"K3 {label}: the kernel left its plain version")
    return int(rounds)


def _k3_bound(q: int, k: int, rounds: int) -> tuple:
    """K3's bound: cand (int64) and ok read once, partner (int64) written
    once; per round ~2 Q k integer compares (the blocked ranks and the first
    free rank), counted at the plain 32-bit operation rate."""
    return _bound(8.0 * q * k + q * k + 8.0 * q, int32=2.0 * rounds * q * k / F32_OPS)


def spd_system(dev, n: int, m: int, dtype, seed: int = 0):
    """K4's inputs: a = G G^T / N + I (eigenvalues in [1, ~5]) and b, made
    from ``seed`` with numpy, in ``dtype`` on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + n + m)
    g = rng.normal(size=(n, n))
    a = g @ g.T / n + np.eye(n)
    return (torch.as_tensor(a, dtype=dtype, device=dev),
            torch.as_tensor(rng.normal(size=(n, m)), dtype=dtype, device=dev))


def check_k4(label: str, a, b) -> float:
    """K4 against its plain version (``spd.accuracy``): a finite x whose
    backward error |a x - b| / (|a| |x| + |b|) is at most 10 N eps and whose
    forward gap max|x - x_plain| / max|x_plain| is at most 100 kappa_2(a) eps
    (a the symmetric matrix that a's lower triangle stands for), two runs
    bit-equal. Returns max |x - x_plain|."""
    import torch

    from wildcat_slam_tpu_torch.ops import spd

    x = spd.spd_solve(a, b)
    x2 = spd.spd_solve(a, b)
    ref = spd.spd_solve_plain(a, b)
    torch.cuda.synchronize()
    acc = spd.accuracy(a, b, x, ref)
    plain = spd.accuracy(a, b, ref, ref)
    same = torch.equal(x, x2)
    line = (f"K4 spd_solve {label}: N={a.shape[0]} m={b.shape[1]} {str(a.dtype)[6:]}; backward "
            f"error {acc['backward']:.3e} (plain {plain['backward']:.3e}; bound 10 N eps = "
            f"{acc['backward_bound']:.3e}); max|x-x_plain| / max|x_plain| {acc['forward']:.3e} "
            f"(bound 100 kappa eps = {acc['forward_bound']:.3e}, kappa {acc['kappa']:.3e}); "
            f"bitwise-repeatable={same}")
    print(line, flush=True)
    if not (acc["ok"] and same):
        raise AssertionError("K4 left its bound: " + line)
    return float(torch.max(torch.abs(x - ref)))


def check_k4_edges(dev, dtype) -> None:
    """K4 on an indefinite system gives NaN everywhere, as its plain version
    (the 3 x 3 whose second pivot is negative, and the N=1152 system with one
    diagonal entry made negative); inside a CUDA graph capture it gives its
    eager bits."""
    import torch

    from wildcat_slam_tpu_torch.ops import spd

    small = torch.tensor([[3.5, 2.0, 0.0], [2.0, 0.5, 0.0], [0.0, 0.0, 2.5]], dtype=dtype,
                         device=dev)
    a, b = spd_system(dev, 1152, 1, dtype)
    spoiled = a.clone()
    spoiled[700, 700] = -5.0
    nans = []
    for aa, bb in ((small, torch.ones((3, 1), dtype=dtype, device=dev)), (spoiled, b)):
        nans.append(bool(torch.all(torch.isnan(spd.spd_solve(aa, bb))))
                    and bool(torch.all(torch.isnan(spd.spd_solve_plain(aa, bb)))))
    eager = spd.spd_solve(a, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        spd.spd_solve(a, b)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        captured = spd.spd_solve(a, b)
    g.replay()
    torch.cuda.synchronize()
    same = torch.equal(captured, eager)
    print(f"K4 spd_solve {str(dtype)[6:]}: NaN everywhere on the indefinite 3 x 3 and N=1152 "
          f"systems (kernel and plain): {nans}; a graph replay equals the eager call bit for "
          f"bit: {same}", flush=True)
    if not (all(nans) and same):
        raise AssertionError(f"K4 edges failed: NaN {nans}, graph equal {same}")


def _k4_bound(n: int, m: int, itemsize: int) -> tuple:
    """K4's bound: a's lower triangle and b read once, x written once; the
    factorisation's N^3 / 6 FMA and the two triangular solves' N^2 m FMA at
    the card's peak for the dtype: the f32 FMA rate, and in f64 the tensor
    cores' (DMMA, twice the DFMA rate that the kernel issues at)."""
    flops = n ** 3 / 3.0 + 2.0 * n * n * m
    ops = {"fma": flops / F32_FLOPS} if itemsize == 4 else {"dmma": flops / F64_FLOPS}
    return _bound(itemsize * (n * (n + 1) / 2 + 2 * n * m), **ops)


def k4_times(a, b, err: float) -> dict:
    """K4's row: its times (single calls, back to back, graph replays), the
    plain version's, the library's (cholesky + cholesky_solve: single calls,
    and back to back without cholesky's host-syncing error check) and its
    bound."""
    import torch

    from wildcat_slam_tpu_torch.ops import spd
    from wildcat_slam_tpu_torch.profile_sweeps import graph_ms

    def library():
        return torch.cholesky_solve(b, torch.linalg.cholesky(a))

    def library_unchecked():
        return torch.cholesky_solve(b, torch.linalg.cholesky_ex(a, check_errors=False)[0])

    bound_ms, bound_by = _k4_bound(a.shape[0], b.shape[1], a.element_size())
    return dict(max_abs_err=err, ms=_time_ms(lambda: spd.spd_solve(a, b)),
                device_ms=_device_ms(lambda: spd.spd_solve(a, b)),
                graph_ms=graph_ms(lambda: spd.spd_solve(a, b)),
                plain_ms=_time_ms(lambda: spd.spd_solve_plain(a, b)),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=_time_ms(library),
                library_device_ms=_device_ms(library_unchecked))


# K5 and K6 against their plain versions on the same inputs, per output, as
# a share of the plain output's largest entry: max |kernel - plain| at most
# 1e-10 in float64 and 1e-4 in float32 (the sums run in another order than
# the plain version's einsums and products, and the kernels' sin, cos and
# atan are CUDA's). In float32 the plain version in float64 on the same
# inputs is printed beside it, as a diagnostic only: the IMU residual divides
# a sum of metre-scale positions by dt^2, so both float32 versions sit ~1e-2
# of the residuals' scale from it on the main path's inputs
FACTOR_RTOL = {"float32": 1e-4, "float64": 1e-10}


def factor_problem(dev, dtype, s_cap: int = 96, count: int | None = None, m: int = 16384,
                   nb: int = 8192, mi: int = 1536, seed: int = 0, valid_share: float = 0.9):
    """Random surfel factors (the first nb binary) and IMU factors on S
    sample states (``count`` live), bracketed as the pipeline brackets them
    (``factors.sample_bracket``: ir = il + 1; a unary factor's side 1 at
    (0, 0) with f = 0; an IMU factor's six indices within three blocks of
    their minimum), made from ``seed`` with numpy in ``dtype`` on the card.
    Returns (sfac, ifac, cor, grav, fm, nb) with fm the gauge mask (the live
    states, the first state's position frozen)."""
    import numpy as np
    import torch

    from wildcat_slam_tpu_torch.odometry.factors import ImuFactors, SurfelFactors

    rng = np.random.default_rng(seed)
    count = count or s_cap

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), device=dev).to(dt)

    def unit(n, d):
        x = rng.normal(size=(n, d))
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    unary = np.arange(m) >= nb
    i1l = np.where(unary, 0, rng.integers(0, count - 1, m))
    i2l = rng.integers(0, count - 1, m)
    sfac = SurfelFactors(
        valid=t(rng.uniform(size=m) < valid_share, torch.bool), w=t(rng.uniform(5.0, 60.0, m)),
        n=t(unit(m, 3)), opt1=t(~unary, torch.bool), v1=t(rng.normal(size=(m, 3)) * 4.0),
        p1=t(rng.normal(size=(m, 3))), i1l=t(i1l, torch.int64),
        i1r=t(np.where(unary, 0, i1l + 1), torch.int64),
        f1=t(np.where(unary, 0.0, rng.uniform(size=m))), v2=t(rng.normal(size=(m, 3)) * 4.0),
        p2=t(rng.normal(size=(m, 3))), i2l=t(i2l, torch.int64), i2r=t(i2l + 1, torch.int64),
        f2=t(rng.uniform(size=m)))
    base = rng.integers(0, max(count - 2, 1), mi)
    il = base[:, None] + (rng.uniform(size=(mi, 3)) < np.array([0.0, 0.3, 0.6]))
    il = np.minimum(il, count - 2)
    acc = np.array([0.0, 0.0, 9.81]) + rng.normal(scale=0.3, size=(mi, 3))
    ifac = ImuFactors(
        valid=t(rng.uniform(size=mi) < valid_share, torch.bool), q1=t(unit(mi, 4)),
        q2=t(unit(mi, 4)), a1=t(acc), g1=t(rng.normal(scale=0.5, size=(mi, 3))),
        g2=t(rng.normal(scale=0.5, size=(mi, 3))), p1=t(rng.normal(size=(mi, 3))),
        p2=t(rng.normal(size=(mi, 3))), p3=t(rng.normal(size=(mi, 3))),
        il=t(il, torch.int64), ir=t(il + 1, torch.int64), f=t(rng.uniform(size=(mi, 3))))
    cor = t(rng.normal(scale=1e-3, size=(s_cap, 12)))
    grav = t(np.array([0.0, 0.0, -9.81]))
    par = np.arange(12 * s_cap)
    fm = t(((par // 12) < count) & ~((par >= 3) & (par < 6)))
    return sfac, ifac, cor, grav, fm, nb


def _gap(got, ref) -> float:
    """max |got - ref| / max |ref| (NaN where they differ in finiteness)."""
    import torch

    if not torch.equal(torch.isfinite(got), torch.isfinite(ref)):
        return float("nan")
    fin = torch.isfinite(ref)
    scale = float(torch.max(torch.abs(ref[fin]))) if bool(fin.any()) else 0.0
    diff = float(torch.max(torch.abs(got[fin] - ref[fin]))) if bool(fin.any()) else 0.0
    return diff / scale if scale > 0 else diff


def _double(x):
    """A factor struct, tensor or scalar in float64 (the reference's inputs)."""
    import torch

    if hasattr(x, "map"):
        return x.map(_double)
    return x.double() if isinstance(x, torch.Tensor) and x.is_floating_point() else x


def _held(outputs: dict, dtype) -> tuple:
    """Each output (kernel, plain, float64 reference or None) against the
    gate of FACTOR_RTOL, the kernel to the plain version; the float64
    reference's gaps are printed, not gated. Returns (text, ok, the largest
    absolute difference to the plain version over the finite entries)."""
    import torch

    rtol, parts, ok = FACTOR_RTOL[str(dtype)[6:]], [], True
    for name, (got, plain, ref) in outputs.items():
        gap = _gap(got, plain)
        ok &= gap <= rtol
        parts.append(f"{name} {gap:.3e}" + ("" if ref is None else
                     f" (to float64 {_gap(got.double(), ref):.3e}, plain's "
                     f"{_gap(plain.double(), ref):.3e})"))
    diffs = [torch.abs(got.double() - plain.double()) for got, plain, _ in outputs.values()]
    return "max gap / scale " + ", ".join(parts) + f" (bound {rtol:.0e})", ok, max(
        float(d[torch.isfinite(d)].max()) if bool(torch.isfinite(d).any()) else 0.0
        for d in diffs)


def check_k5(label: str, ifac, cor, weights, dt: float, grav) -> float:
    """K5 (imu_factor) against its plain version (FACTOR_RTOL): the
    residuals, the five block bands and g; band -d at r + d the transpose
    of band +d at r bit for bit, two runs bit-equal. Returns the largest
    absolute difference to the plain version."""
    import torch

    from wildcat_slam_tpu_torch.odometry import factors as fmod
    from wildcat_slam_tpu_torch.odometry import solver
    from wildcat_slam_tpu_torch.ops import imu_factor

    s_cap = cor.shape[0]
    r = imu_factor.residuals(ifac, cor, weights, dt, grav)
    bands, g = imu_factor.normal_eqs(ifac, cor, weights, dt, grav)
    bands2, g2 = imu_factor.normal_eqs(ifac, cor, weights, dt, grav)
    torch.cuda.synchronize()
    r_p = fmod.imu_residuals_plain(ifac, cor, weights, dt, grav, with_jac=False)[0]
    bands_p, g_p = solver.imu_banded_normal_eqs_plain(ifac, cor, weights, dt, grav, s_cap)
    refs = (None, None, None)
    if cor.dtype == torch.float32:
        args = tuple(map(_double, (ifac, cor, weights, dt, grav)))
        refs = (fmod.imu_residuals_plain(*args, with_jac=False)[0],
                *solver.imu_banded_normal_eqs_plain(*args, s_cap))
    text, ok, worst = _held(dict(r=(r, r_p, refs[0]), bands=(bands, bands_p, refs[1]),
                                 g=(g, g_p, refs[2])), cor.dtype)
    same = torch.equal(bands, bands2) and torch.equal(g, g2)
    sym = all(torch.equal(bands[2 + d, :s_cap - d], bands[2 - d, d:].transpose(1, 2))
              for d in (1, 2)) and torch.equal(bands[2], bands[2].transpose(1, 2))
    line = (f"K5 imu_factor {label}: Mi={ifac.valid.shape[0]} S={s_cap} {str(cor.dtype)[6:]}, "
            f"{int(ifac.valid.sum())} valid; {text}; bands symmetric bit for bit {sym}; "
            f"bitwise-repeatable={same}")
    print(line, flush=True)
    if not (ok and sym and same):
        raise AssertionError("K5 left its plain version: " + line)
    return worst


def check_k6(label: str, sfac, cor, a2: float, imu_bands, gi, fm, nb: int) -> float:
    """K6 (surfel_factor) against its plain version (FACTOR_RTOL): the
    residuals, H and g, and H without the IMU factors' part (the surfel
    factors' alone, at their own scale); H bit-exactly symmetric, two runs
    bit-equal. Returns the largest absolute difference to the plain
    version."""
    import torch

    from wildcat_slam_tpu_torch.odometry import factors as fmod
    from wildcat_slam_tpu_torch.odometry import solver
    from wildcat_slam_tpu_torch.ops import surfel_factor

    s_cap = cor.shape[0]
    zb, zg = torch.zeros_like(imu_bands), torch.zeros_like(gi)
    r = surfel_factor.residuals(sfac, cor)
    h, g = surfel_factor.normal_eqs(sfac, cor, a2, imu_bands, gi, fm, nb)
    h2, g2 = surfel_factor.normal_eqs(sfac, cor, a2, imu_bands, gi, fm, nb)
    hs, gs = surfel_factor.normal_eqs(sfac, cor, a2, zb, zg, fm, nb)
    torch.cuda.synchronize()
    r_p = fmod.surfel_residuals_plain(sfac, cor, with_jac=False)[0]
    h_p, g_p = solver.surfel_normal_eqs_plain(sfac, cor, a2, imu_bands, gi, fm, s_cap, nb)
    hs_p, gs_p = solver.surfel_normal_eqs_plain(sfac, cor, a2, zb, zg, fm, s_cap, nb)
    refs = (None,) * 5
    if cor.dtype == torch.float32:
        sf, c, f = _double(sfac), cor.double(), fm.double()
        refs = (fmod.surfel_residuals_plain(sf, c, with_jac=False)[0],
                *solver.surfel_normal_eqs_plain(sf, c, a2, imu_bands.double(), gi.double(), f,
                                                s_cap, nb),
                *solver.surfel_normal_eqs_plain(sf, c, a2, zb.double(), zg.double(), f, s_cap,
                                                nb))
    text, ok, worst = _held(dict(r=(r, r_p, refs[0]), H=(h, h_p, refs[1]), g=(g, g_p, refs[2]),
                                 H_surfel=(hs, hs_p, refs[3]), g_surfel=(gs, gs_p, refs[4])),
                            cor.dtype)
    same = torch.equal(h, h2) and torch.equal(g, g2)
    sym = torch.equal(h, h.T) and torch.equal(hs, hs.T)
    line = (f"K6 surfel_factor {label}: M={sfac.valid.shape[0]} nb={nb} S={s_cap} "
            f"{str(cor.dtype)[6:]}, {int(sfac.valid.sum())} valid; {text}; H symmetric bit for "
            f"bit {sym}; bitwise-repeatable={same}")
    print(line, flush=True)
    if not (ok and sym and same):
        raise AssertionError("K6 left its plain version: " + line)
    return worst


def check_factor_kernels(label: str, dev, dtype, **kw) -> None:
    """K5, then K6 on K5's plain bands, on a :func:`factor_problem`."""
    from wildcat_slam_tpu_torch.odometry import solver

    sfac, ifac, cor, grav, fm, nb = factor_problem(dev, dtype, **kw)
    check_k5(label, ifac, cor, FACTOR_WEIGHTS, FACTOR_DT, grav)
    bands, gi = solver.imu_banded_normal_eqs_plain(ifac, cor, FACTOR_WEIGHTS, FACTOR_DT, grav,
                                                   cor.shape[0])
    check_k6(label, sfac, cor, FACTOR_A2, bands, gi, fm, nb)


# the shipped config's IMU weights, IMU period and Cauchy scale squared
FACTOR_WEIGHTS = (3.0, 2.0, 40.0, 500.0)
FACTOR_DT = 0.005
FACTOR_A2 = 0.4 ** 2


def _k5_bound(ifac, s_cap: int, itemsize: int) -> tuple:
    """K5's bound (normal mode): the factors (29 values, valid, 6 int64
    indices each) and cor read once, the bands and g written once; for each
    valid factor (an invalid one's band is zero) the distinct entries of its
    B^T B (36 x 37 / 2, B^T B being symmetric) and B^T r (36) over its 12
    rows, as FMA at the f32 (or f64 tensor-core) peak. The band's structural
    zeros are counted as work, so the least work is lower still."""
    mi, valid = ifac.valid.shape[0], int(ifac.valid.sum())
    moved = mi * (29 * itemsize + 1 + 48) + 12 * s_cap * itemsize + (5 * 144 + 12) * s_cap \
        * itemsize
    flops = 2.0 * valid * (36 * 37 // 2 + 36) * 12
    return _bound(moved, fma=flops / (F32_FLOPS if itemsize == 4 else F64_FLOPS))


def _k6_bound(sfac, nb: int, s_cap: int, itemsize: int) -> tuple:
    """K6's bound (normal mode): the factors (18 values: w, n, v1, p1, f1,
    v2, p2, f2; valid, opt1 and 4 int64 indices each), cor, the IMU bands,
    gi and fm read once, H and g written once; for each valid factor the D
    products of its binary side pairs (2 x 2 blocks of 144), the diagonal
    payloads (3 coefficients x the 78 distinct entries of a side's
    symmetric 12 x 12 outer product: side 1 only if binary) and g (12 a
    side), as FMA at the f32 (or f64 tensor-core) peak."""
    m = sfac.valid.shape[0]
    n = 12 * s_cap
    valid = int(sfac.valid.sum())
    binary = int(sfac.valid[:nb].sum())
    moved = m * (18 * itemsize + 2 + 32) + (12 + 5 * 144 + 24) * s_cap * itemsize \
        + (n * n + n) * itemsize
    flops = 2.0 * (binary * (4 * 144 + 3 * 78 + 12) + valid * (3 * 78 + 12))
    return _bound(moved, fma=flops / (F32_FLOPS if itemsize == 4 else F64_FLOPS))


def k6_library(sfac, cor, a2: float, s_cap: int, nb: int):
    """K6's yardstick: the PyTorch calls it replaces on the same inputs, the
    cross Gram b1^T b2 and the one-hot contractions (g and the diagonal
    payloads), their operands made beforehand. Returns the function."""
    import torch

    from wildcat_slam_tpu_torch.odometry import factors as fmod

    w1, w2 = fmod.interp_weights(sfac, s_cap, cor.dtype)
    rs, jac, _ = fmod.surfel_residuals_plain(sfac, cor, w_interp=(w1, w2))
    sw = 1.0 / torch.sqrt(1.0 + rs * rs / a2)
    j1v = (jac[:, 0] + jac[:, 1]) * sw[:, None]
    j2v = (jac[:, 2] + jac[:, 3]) * sw[:, None]
    x1, x2 = j1v * (rs * sw)[:, None], j2v * (rs * sw)[:, None]
    ar = torch.arange(s_cap, device=cor.device)
    oh1 = (sfac.i1l[:nb, None] == ar).to(cor.dtype)
    oh2 = (sfac.i2l[:, None] == ar).to(cor.dtype)
    pay1 = torch.randn((nb, 3 * 144), dtype=cor.dtype, device=cor.device)
    pay2 = torch.randn((sfac.valid.shape[0], 3 * 144), dtype=cor.dtype, device=cor.device)
    b1 = (w1[:nb, :, None] * j1v[:nb, None, :]).reshape(nb, 12 * s_cap)
    b2 = (w2[:nb, :, None] * j2v[:nb, None, :]).reshape(nb, 12 * s_cap)

    def library():
        return (b1.T @ b2, torch.einsum("ms,mi->si", w1, x1) + torch.einsum("ms,mi->si", w2, x2),
                torch.einsum("ms,mx->sx", oh1, pay1) + torch.einsum("ms,mx->sx", oh2, pay2))

    return library


def factor_times(rec5: tuple, rec6: tuple) -> tuple:
    """K5's and K6's rows on the main path's recorded inputs: the kernels'
    times (single calls, back to back, graph replays) in normal mode and in
    residual mode, the plain versions', the bounds, and K6's yardstick."""
    from wildcat_slam_tpu_torch.odometry import factors as fmod
    from wildcat_slam_tpu_torch.odometry import solver
    from wildcat_slam_tpu_torch.ops import imu_factor, surfel_factor
    from wildcat_slam_tpu_torch.profile_sweeps import graph_ms

    ifac, cor, weights, dt, grav, s_cap = rec5
    sfac, cor6, a2, bands, gi, fm, _, nb = rec6
    err5 = check_k5("main-path", ifac, cor, weights, dt, grav)
    err6 = check_k6("main-path", sfac, cor6, a2, bands, gi, fm, nb)
    itemsize = cor.element_size()
    k5 = lambda: imu_factor.normal_eqs(ifac, cor, weights, dt, grav)
    k6 = lambda: surfel_factor.normal_eqs(sfac, cor6, a2, bands, gi, fm, nb)
    r5 = lambda: imu_factor.residuals(ifac, cor, weights, dt, grav)
    r6 = lambda: surfel_factor.residuals(sfac, cor6)
    out = {}
    bound_ms, bound_by = _k5_bound(ifac, s_cap, itemsize)
    out["imu_factor"] = dict(
        max_abs_err=err5, ms=_time_ms(k5), device_ms=_device_ms(k5), graph_ms=graph_ms(k5),
        residual_device_ms=_device_ms(r5),
        plain_ms=_time_ms(lambda: solver.imu_banded_normal_eqs_plain(ifac, cor, weights, dt,
                                                                     grav, s_cap)),
        residual_plain_ms=_time_ms(lambda: fmod.imu_residuals_plain(ifac, cor, weights, dt, grav,
                                                                    with_jac=False)),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    bound_ms, bound_by = _k6_bound(sfac, nb, s_cap, itemsize)
    library = k6_library(sfac, cor6, a2, s_cap, nb)
    out["surfel_factor"] = dict(
        max_abs_err=err6, ms=_time_ms(k6), device_ms=_device_ms(k6), graph_ms=graph_ms(k6),
        residual_device_ms=_device_ms(r6),
        plain_ms=_time_ms(lambda: solver.surfel_normal_eqs_plain(sfac, cor6, a2, bands, gi, fm,
                                                                 s_cap, nb)),
        residual_plain_ms=_time_ms(lambda: fmod.surfel_residuals_plain(sfac, cor6,
                                                                       with_jac=False)),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=_time_ms(library),
        library_device_ms=_device_ms(library))
    # the workspaces a normal-mode call takes from torch's allocator
    p5 = imu_factor.plan(ifac.valid.shape[0], s_cap, itemsize)
    p6 = surfel_factor.plan(sfac.valid.shape[0], nb, s_cap, itemsize)
    work = {"imu_factor": f"workspace {imu_factor.workspace_bytes(p5, itemsize)} bytes a call",
            "surfel_factor": f"workspace {surfel_factor.workspace_bytes(p6, itemsize)} bytes a "
                             f"call ({4 * p6.ints} of them the lists)"}
    for key, name in (("imu_factor", "K5 imu_factor"), ("surfel_factor", "K6 surfel_factor")):
        r = out[key]
        lib = ("no PyTorch call computes it" if r["library_ms"] is None else
               f"library (b1^T b2 and the one-hot einsums) {r['library_ms']:.4f} ms, back to "
               f"back {r['library_device_ms']:.4f} ms")
        print(f"{name} main-path time: kernel {r['ms']:.4f} ms by single synchronised calls, "
              f"{r['device_ms']:.4f} ms back to back, {r['graph_ms']:.4f} ms by graph replays "
              f"({work[key]}); residual mode {r['residual_device_ms']:.4f} ms back to back; plain "
              f"{r['plain_ms']:.4f} ms (residuals alone {r['residual_plain_ms']:.4f} ms); {lib}; "
              f"bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), "
              f"{r['bound_ms'] / r['graph_ms']:.2%} of the graph-replay time", flush=True)
    return out


# K7 (surfel_extract) against its plain version on the same inputs: the
# surfels' validity, time order and n_dropped equal, two runs and a graph
# replay bit-equal, every float at the valid surfels within K7_F64_TOL in
# float64 and within tests/test_torch_surfel.py's tolerances in float32
# (K7_F32_TOL). K7 sums the moments as the plain version does (its blocked
# prefix, in its order), so they agree to the bit; eigh3 takes acos, cos,
# sin and atan2 from the CUDA math library, and the normals and the stds
# may differ in the last bits.
K7_F64_TOL = 1e-10
K7_F32_TOL = {"t": 1e-5, "center": 1e-5, "norm": 1e-5, "cov": 1e-7, "std": 5e-6,
              "resolution": 1e-5}
K7_FLOATS = ("t", "center", "norm", "cov", "std", "resolution")
K7_BIT_EQUAL = ("t", "center", "cov")  # the moments' outputs: the plain version's order
# tests/test_torch_surfel.py's configs: "tight" fires the segment, cluster
# and surfel drops at once
K7_CFGS = {"small": dict(max_points_per_sweep=4096, max_surfels_per_sweep=256,
                         max_voxels_per_sweep=1024, max_leaves_per_sweep=2048),
           "tight": dict(max_points_per_sweep=4096, max_surfels_per_sweep=16,
                         max_voxels_per_sweep=48, max_leaves_per_sweep=64)}


def k7_sweep(n: int = 4096, n_valid: int = 3800, seed: int = 3):
    """tests/test_torch_surfel.py's room sweep (its 0.5 s of 800-point scans;
    longer for more points): float64 numpy points (n, 3), times from 0 and
    the first n_valid valid."""
    import numpy as np

    from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence

    seq = SyntheticSequence(duration=0.5 * -(-n_valid // 3800), points_per_scan=800,
                            room_half=4.0, seed=seed)
    t = np.concatenate([s[0] for s in seq.scans])
    p = np.concatenate([s[1] for s in seq.scans])
    m = min(len(t), n_valid)
    pts, ts = np.zeros((n, 3)), np.zeros(n)
    pts[:m], ts[:m] = p[:m], t[:m] - t[0]
    return pts, ts, np.arange(n) < m


def k7_dense(p: int = 65536, seed: int = 11):
    """K7's densest input at the shipped sizes: a 32 m x 32 m floor of
    triangles of 3 points (within 1 cm), placed at random, 2e-5 s apart in
    time (the cluster time gap 1e-5 s; 2e-6 s between a triangle's points),
    min_points_per_plane 3: every triangle is a surfel candidate at levels 0
    and 1, some 27,500 valid ones of the 3 nc = 49,152 cluster slots (the
    time order's worst case is n_valid = 3 nc)."""
    import numpy as np

    from wildcat_slam_tpu_torch.config import WildcatConfig

    rng = np.random.default_rng(seed)
    n = p // 3
    xy = np.repeat(rng.uniform(-16.0, 16.0, (n, 2)), 3, 0) + rng.uniform(-0.01, 0.01, (3 * n, 2))
    pts, ts = np.zeros((p, 3)), np.zeros(p)
    pts[:3 * n] = np.stack([xy[:, 0], xy[:, 1], -1.5 + 0.02 * xy[:, 0]
                            + rng.normal(0, 1e-3, 3 * n)], 1)
    ts[:3 * n] = np.repeat(np.arange(n) * 2e-5, 3) + np.tile(np.arange(3) * 2e-6, n)
    return pts, ts, np.arange(p) < 3 * n, WildcatConfig(min_points_per_plane=3,
                                                        cluster_time_gap=1e-5)


def k7_wide(p: int = 65536, seed: int = 13):
    """K7's widest keys at the shipped sizes: :func:`k7_dense` with four of
    its triangles moved to each of the eight corners of voxel.split_keys'
    range at the finest level (cells +-(2^19 - 1) on each axis, ~105 km out),
    so that level's keys span 60 bits and its sort takes the most passes
    (eight of 8 bits)."""
    import itertools

    import numpy as np

    pts, ts, valid, cfg = k7_dense(p, seed)
    size = cfg.voxel_size / 2.0**cfg.max_voxel_depth
    corners = np.array(list(itertools.product((-1.0, 1.0), repeat=3)))
    centre = (corners * (2**19 - 1) + 0.5) * size  # the outermost cells' centres
    tri = pts[:96].reshape(32, 3, 3)
    moved = np.repeat(centre, 4, 0)[:, None, :] + tri - tri.mean(1, keepdims=True)
    pts[:96] = moved.reshape(96, 3)
    return pts, ts, valid, cfg


def k7_inputs() -> dict:
    """K7's inputs beside the main path's, as float64 numpy arrays and a
    config: the room sweep at the small and the tight capacities, every
    point invalid, every point in one level-0 voxel (four passes 0.1 s
    apart over a tilted patch), P=5001 (not a multiple of the tiles),
    :func:`k7_dense` and :func:`k7_wide`."""
    import numpy as np

    from wildcat_slam_tpu_torch.config import WildcatConfig

    pts, ts, valid = k7_sweep()
    rng = np.random.default_rng(7)
    xy = rng.uniform(0.05, 0.75, (4096, 2))
    one = np.stack([xy[:, 0], xy[:, 1], 0.4 + 0.05 * xy[:, 0] + rng.normal(0, 0.002, 4096)], 1)
    one_t = np.repeat(np.arange(4) * 0.1, 1024) + np.tile(np.linspace(0, 0.02, 1024), 4)
    big = dict(K7_CFGS["small"], max_points_per_sweep=5001)
    return {"room": (pts, ts, valid, WildcatConfig(**K7_CFGS["small"])),
            "room, tight": (pts, ts, valid, WildcatConfig(**K7_CFGS["tight"])),
            "every point invalid": (pts, ts, np.zeros(4096, bool),
                                    WildcatConfig(**K7_CFGS["small"])),
            "one voxel": (one, one_t, np.ones(4096, bool), WildcatConfig(**K7_CFGS["small"])),
            "P=5001": (*k7_sweep(5001, 4990), WildcatConfig(**big)),
            "dense": k7_dense(), "wide": k7_wide()}


def _k7_same(a: dict, b: dict) -> bool:
    import torch

    return all(torch.equal(torch.nan_to_num(a[k]), torch.nan_to_num(b[k])) for k in a)


def check_k7(label: str, pts, t, valid, cfg) -> float:
    """K7 against its plain version on these inputs (K7_F64_TOL,
    K7_F32_TOL): the surfels' validity, time order and n_dropped equal, every
    float at the valid surfels within tolerance and K7_BIT_EQUAL's bit-equal;
    two runs and a graph replay bit-equal. Returns the largest float gap."""
    import torch

    from wildcat_slam_tpu_torch.ops import surfel_extract as se

    got = se.extract(pts, t, valid, cfg)
    again = se.extract(pts, t, valid, cfg)
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        se.extract(pts, t, valid, cfg)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(g):
        captured = se.extract(pts, t, valid, cfg)
    g.replay()
    ref = se.extract_plain(pts, t, valid, cfg)
    torch.cuda.synchronize()
    rv = ref["valid"]
    n = int(rv.sum())
    same = torch.equal(got["valid"], rv) and int(got["n_dropped"]) == int(ref["n_dropped"])
    f64 = pts.dtype == torch.float64
    held, equal = {}, []
    for k in K7_FLOATS:
        x, y = got[k][rv], ref[k][rv]
        held[k] = (float((x.double() - y.double()).abs().max()) if n else 0.0,
                   K7_F64_TOL if f64 else K7_F32_TOL[k])
        if torch.equal(x, y):
            equal.append(k)
    repeat = _k7_same(got, again) and _k7_same(got, captured)
    line = (f"K7 surfel_extract {label} {str(pts.dtype)[6:]}: P={pts.shape[0]} valid "
            f"{int(valid.sum())} points, {n} surfels, n_dropped {int(ref['n_dropped'])}; "
            f"validity and n_dropped equal: {same}; runs and graph replay bit-equal: {repeat}; "
            + ", ".join(f"{k} {v:.2e} (limit {lim:.0e})" for k, (v, lim) in held.items())
            + f"; bit-equal at the valid surfels: {', '.join(equal) or 'none'}")
    print(line, flush=True)
    if not (same and repeat and all(v <= lim for v, lim in held.values())
            and all(k in equal for k in K7_BIT_EQUAL)):
        raise AssertionError("K7 left its plain version: " + line)
    return max(v for v, _ in held.values())


def phase_k7(dev) -> None:
    """K7 on :func:`k7_inputs` in float32 and float64."""
    import torch

    for label, (pts, ts, valid, cfg) in k7_inputs().items():
        for dtype in (torch.float32, torch.float64):
            check_k7(label, torch.as_tensor(pts, dtype=dtype, device=dev),
                     torch.as_tensor(ts, dtype=dtype, device=dev),
                     torch.as_tensor(valid, device=dev), cfg)


def _k7_bound(p: int, n_levels: int, ncap: int, itemsize: int) -> tuple:
    """K7's bound: the points (xyz, t, valid) read once (every level's keys
    come from one read, and the levels' gathers of ~1 MB stay in the 50 MB
    L2) and the surfels (t, center, cov 3 x 3, norm, resolution, std, valid)
    and n_dropped written once, at 3.35 TB/s; its arithmetic (~40 operations
    a point a level: the key and the 11 moments) at the plain f32 (or f64)
    rate."""
    moved = p * (4 * itemsize + 1) + ncap * (18 * itemsize + 1) + 8
    ops = 40.0 * n_levels * p
    return _bound(moved, ops=ops / (F32_OPS if itemsize == 4 else F64_FLOPS / 2))


def k7_times(rec: tuple) -> dict:
    """K7's row on the main path's recorded last-sweep inputs (float32 as
    recorded, then float64): the kernel's times (single calls, back to back,
    graph replays), its phases' split and its sort phases' time (a copy with
    globaltimer stamps at its barriers, ``probe_extract``), the yardstick of
    the sort phases (``torch.sort(stable=True)`` of the same three levels'
    packed int64 keys, the calls K7's sort replaces), the plain version's
    time, the bound; and K7's graph-replay time on :func:`k7_dense`, the most
    valid candidates for the time order to rank, and on :func:`k7_wide`, the
    most passes for the sort."""
    import dataclasses

    import torch

    from wildcat_slam_tpu_torch import probe_extract as pe
    from wildcat_slam_tpu_torch.ops import _build
    from wildcat_slam_tpu_torch.ops import surfel_extract as se
    from wildcat_slam_tpu_torch.profile_sweeps import graph_ms

    pts, t, valid, cfg = rec
    lib, names, ptx = pe.build_traced(_build.SRC_DIR, _build.BUILD_DIR / "probe",
                                      _build.flags("surfel_extract.cu"))
    print(f"K7 surfel_extract ptxas: {' | '.join(ptx)}", flush=True)
    out = {}
    for dtype in (torch.float32, torch.float64):
        x, y = pts.to(dtype), t.to(dtype)
        err = check_k7("main-path", x, y, valid, cfg)
        k7 = lambda: se.extract(x, y, valid, cfg)
        keys = pe.packed_level_keys(x, valid, cfg)
        sorts = lambda: [torch.sort(k, stable=True) for k in keys]
        split = pe.stamped_split(lib, names, k7)
        p = se.plan(x.shape[0], cfg.max_voxels_per_sweep, cfg.max_leaves_per_sweep,
                    cfg.max_surfels_per_sweep, cfg.max_voxel_depth + 1, x.element_size())
        bound_ms, bound_by = _k7_bound(x.shape[0], cfg.max_voxel_depth + 1, p.ncap,
                                       x.element_size())
        r = dict(max_abs_err=err, ms=_time_ms(k7), device_ms=_device_ms(k7), graph_ms=graph_ms(k7),
                 sort_phases_ms=pe.sort_us(split) / 1e3, sort_library_graph_ms=graph_ms(sorts),
                 phases_us=[[name.split(":")[0], round(a + b, 2)] for name, a, b in split],
                 plain_ms=_time_ms(lambda: se.extract_plain(x, y, valid, cfg)),
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        for label, (dp, dt, dv, dcfg) in (("dense", k7_dense()), ("wide", k7_wide())):
            dp, dt = (torch.as_tensor(v, dtype=dtype, device=x.device) for v in (dp, dt))
            dv = torch.as_tensor(dv, device=x.device)
            slots = (dcfg.max_voxel_depth + 1) * dcfg.max_leaves_per_sweep
            every = se.extract_plain(dp, dt, dv,
                                     dataclasses.replace(dcfg, max_surfels_per_sweep=slots))
            fn = lambda: se.extract(dp, dt, dv, dcfg)
            sort_ms = pe.sort_us(pe.stamped_split(lib, names, fn)) / 1e3
            r.update({f"{label}_n_valid": int(every["valid"].sum()),
                      f"{label}_graph_ms": graph_ms(fn), f"{label}_sort_phases_ms": sort_ms})
        print(f"K7 surfel_extract main-path time {str(dtype)[6:]}: one launch, "
              f"{r['ms']:.4f} ms by single synchronised calls, {r['device_ms']:.4f} ms back to "
              f"back, {r['graph_ms']:.4f} ms by graph replays; its sort phases (keys, ranges, "
              f"passes) {r['sort_phases_ms']:.4f} ms, against the yardstick torch.sort(stable) of "
              f"the three levels' packed int64 keys {r['sort_library_graph_ms']:.4f} ms by graph "
              f"replays; phases (us, each with its barrier): "
              + "; ".join(f"[{k}] {v:.1f}" for k, v in r["phases_us"])
              + f"; plain {r['plain_ms']:.4f} ms; no PyTorch call computes it; workspace "
              f"{se.workspace_bytes(p, x.element_size())} bytes a call; bound "
              f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), "
              f"{r['bound_ms'] / r['graph_ms']:.2%} of the graph-replay time; on the dense "
              f"input ({r['dense_n_valid']} valid candidates of "
              f"{(cfg.max_voxel_depth + 1) * cfg.max_leaves_per_sweep}) "
              f"{r['dense_graph_ms']:.4f} ms by graph replays (sort phases "
              f"{r['dense_sort_phases_ms']:.4f}); on the wide input {r['wide_graph_ms']:.4f} ms "
              f"(sort phases {r['wide_sort_phases_ms']:.4f})", flush=True)
        out[str(dtype)[6:]] = r
    return out["float32"]


def phase_kernels(dev) -> None:
    import numpy as np
    import torch

    from wildcat_slam_tpu_torch.ops import knn, spd

    # K1 at the main path's S=96 (iters 24, tol 1e-2), then S=192/256, then
    # the edges: no iteration, a system that exits early, a small grid (S=8)
    for s_cap in (96, 192, 256):
        h, dlam, minv, b = random_system(dev, s_cap)
        check_k1(f"random S={s_cap}", h, dlam, minv, b, 24, 1e-2)
    h, dlam, minv, b = random_system(dev, 96)
    check_k1("random S=96 iters=0", h, dlam, minv, b, 0, 1e-2)
    h, dlam, minv, b = random_system(dev, 96, shift=0.5)
    its = _pcg_iterations(h, dlam, minv, b, 24, 1e-2)
    if not 0 < its < 24:
        raise AssertionError(f"K1 early-exit case ran {its} of 24 iterations")
    check_k1(f"random S=96 H + 0.5 I (exits after {its} of 24 iterations)", h, dlam, minv, b, 24,
             1e-2)
    # S=8: ill-conditioned enough that 24 iterations amplify the plain f32
    # solve's own rounding, so the reference is the plain solve in float64
    h, dlam, minv, b = random_system(dev, 8)
    check_k1("random S=8", h, dlam, minv, b, 24, 1e-2, reference="f64")
    # K2 at Q=8192 against T=8192 (self) and T=16384 (cross)
    rng = np.random.default_rng(0)
    for t_n in (8192, 16384):
        dt = torch.as_tensor(_cloud(rng, t_n), device=dev)
        dq = dt[:8192].contiguous() if t_n == 8192 else torch.as_tensor(_cloud(rng, 8192), device=dev)
        check_k2(f"random Q=8192 T={t_n}", dq, dt, 512, recall=True)
        check_mxu(f"random Q=8192 T={t_n}", dq, dt, 512, recall=True)
    # K2 vpu at the edges of its geometry: a ragged last query block, a single
    # target group, and the other descriptor widths it is built for
    qpt = knn.QUERIES_PER_THREAD[6]
    for q_n, t_n, d in ((8192 + qpt // 2 + 1, 16384, 6), (1001, 512, 6), (3001, 4096, 3),
                        (3001, 4096, 8)):
        dt = torch.as_tensor(rng.normal(size=(t_n, d)).astype(np.float32), device=dev)
        dq = torch.as_tensor(rng.normal(size=(q_n, d)).astype(np.float32), device=dev)
        dt[t_n // 3:t_n // 3 + 7] = knn.FAR  # far rows never win a bin
        check_k2(f"edge Q={q_n} T={t_n} D={d} (Q % {knn.QUERIES_PER_THREAD[d]} = "
                 f"{q_n % knn.QUERIES_PER_THREAD[d]}, {t_n // 512} target groups)", dq, dt, 512,
                 recall=False)
    # K2 mxu at the edges of its geometry: a ragged last query tile, a single
    # target group, and the bin counts knn_topk gives a small T
    for q_n, t_n, n_bins in MXU_EDGES:
        dt = torch.as_tensor(rng.normal(size=(t_n, 6)).astype(np.float32), device=dev)
        dq = torch.as_tensor(rng.normal(size=(q_n, 6)).astype(np.float32), device=dev)
        dt[t_n // 3:t_n // 3 + 7] = knn.FAR  # far rows never win a bin
        check_mxu(f"edge Q={q_n} T={t_n} n_bins={n_bins} (Q % {knn.MXU_QUERY_TILE} = "
                  f"{q_n % knn.MXU_QUERY_TILE}, {t_n // n_bins} target groups)", dq, dt, n_bins,
                  recall=False)
    # K3 at the main path's Q=8192, k=10: random candidates, then adversarial
    # chains (30 rounds; 2000 rounds; the same capped at 5 rounds), and a
    # ragged Q with another k
    gen = torch.Generator(device=dev).manual_seed(3)
    check_k3("random", torch.randint(0, 8192, (8192, 10), device=dev, generator=gen),
             torch.rand((8192, 10), device=dev, generator=gen) < 0.5, 8192)
    check_k3("chains of 30", *k3_chains(8192, 10, 1, [30] * 40, dev), 8192)
    check_k3("chain of 2000", *k3_chains(8192, 10, 2, [2000, 500, 7], dev), 8192)
    check_k3("chain of 2000, capped", *k3_chains(8192, 10, 2, [2000], dev), 5)
    check_k3("ragged", torch.randint(0, 1001, (1001, 7), device=dev, generator=gen),
             torch.rand((1001, 7), device=dev, generator=gen) < 0.6, 1001)
    # K3 at the edges of its plan: one query; Q=35000, whose lists outgrow
    # shared memory (a global scratch)
    check_k3("one query", torch.zeros((1, 10), dtype=torch.int64, device=dev),
             torch.ones((1, 10), dtype=torch.bool, device=dev), 1)
    check_k3("Q=35000, lists in global memory", *k3_chains(35000, 10, 4, [50] * 10, dev), 35000)
    # K4 at the main path's shapes (the spline fit's N=96, m=6; the damped LM
    # system's N=1152, m=1) and at the edges of its plan (one tile; the
    # largest N of its one-block path and one above it, on the tile dataflow;
    # a ragged last tile on the dataflow; N=3072 on the whole card), in both
    # dtypes; an indefinite system; a graph capture
    for dtype in (torch.float32, torch.float64):
        limit = spd.one_block_limit(torch.finfo(dtype).bits // 8)
        for n, m in ((96, 6), (1152, 1), (1, 1), (12, 6), (130, 6), (576, 1), (limit, 6),
                     (limit + 1, 6), (700, 6), (3072, 1), (3072, 6)):
            path = "one block" if spd.plan(n, m, torch.finfo(dtype).bits // 8).one_block \
                else "dataflow"
            check_k4(f"random ({path})", *spd_system(dev, n, m, dtype))
        check_k4_edges(dev, dtype)
    # K5 and K6 at the main path's sizes (S=96, M=16384 of which 8192 binary,
    # Mi=1536) with every state live and with 40, then at the edges: every
    # factor invalid, a ragged M and Mi, S=8; in both dtypes
    for dtype in (torch.float32, torch.float64):
        check_factor_kernels("random", dev, dtype)
        check_factor_kernels("random, 40 live states", dev, dtype, count=40, seed=1)
        check_factor_kernels("every factor invalid", dev, dtype, valid_share=0.0, seed=2)
        check_factor_kernels("ragged", dev, dtype, m=5001, nb=2001, mi=1001, seed=3)
        check_factor_kernels("S=8", dev, dtype, s_cap=8, m=3000, nb=1000, mi=300, seed=4)
    # K7 on the room sweep, the tight capacities, no valid point, one voxel
    # and a ragged P, in both dtypes
    phase_k7(dev)


def phase_main(dev) -> tuple:
    """The shipped config on the 8 s synthetic sequence, through LidarOdometry
    (its first sweep eager, then its sweep graph captured and replayed).
    Returns the launch counts of this run, its trajectory, the sequence's
    events, its per-sweep median ms, the frontend and the sequence."""
    import numpy as np

    from wildcat_slam_tpu_torch.cli import feed_events, synthetic_events
    from wildcat_slam_tpu_torch.config import WildcatConfig
    from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence, ate_rmse
    from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry

    t0 = time.perf_counter()
    seq = SyntheticSequence(duration=8.0, points_per_scan=12800, room_half=5.0, seed=0)
    events = list(synthetic_events(seq))
    print(f"main: synthetic sequence generated in {time.perf_counter() - t0:.1f} s", flush=True)
    lo = LidarOdometry(WildcatConfig(), device=dev)
    t0 = time.perf_counter()
    _, launches = _counted("main", lambda: feed_events(lo, events))
    wall = time.perf_counter() - t0
    traj = lo.trajectory
    ate = ate_rmse(traj, lambda t: seq.gt_pose(t)[0], align=False)
    steady = np.asarray(lo.sweep_seconds[1:]) * 1e3
    poses = np.stack([p for _, p, _ in traj])
    print(f"main: {lo.sweep_id} sweeps in {wall:.2f} s; per-sweep ms after the first: "
          f"median {np.median(steady):.2f}, p90 {np.percentile(steady, 90):.2f}; "
          f"ATE {ate * 1e3:.3f} mm unaligned (< 20 mm); launches {launches} (K7 "
          f"{launches['surfel_extract'] / lo.sweep_id:.2f} a sweep); sweep graph: "
          f"{_graph_text(lo)}", flush=True)
    if not (lo.sweep_id >= 10 and np.all(np.isfinite(poses)) and ate < 0.02):
        raise AssertionError(f"main path failed: sweeps={lo.sweep_id} ATE={ate}")
    if launches["surfel_extract"] != lo.sweep_id:  # K7: one launch a call, one call a sweep
        raise AssertionError(f"main path: {launches['surfel_extract']} K7 launches in "
                             f"{lo.sweep_id} sweeps")
    return launches, traj, events, float(np.median(steady)), lo, seq


def phase_eager(dev, main_lo, events) -> tuple:
    """(k), the main sequence: the eager reference (process_sweep called on
    each feed, no graph) must equal the graph run bit for bit, in the
    trajectory and every packed output (iteration counts included). It
    records the inputs of the first K1 call and of each K2, K3 and K4 call
    of its last sweep, and of K5's and K6's first normal equations and K7's
    extraction there. Returns them and the eager frontend."""
    import numpy as np

    from wildcat_slam_tpu_torch.odometry import pipeline, solver
    from wildcat_slam_tpu_torch.ops import knn, pcg, spd
    from wildcat_slam_tpu_torch.ops import self_match as sm

    lo = _eager_frontend(dev)
    # record kernel inputs as the eager run calls the wrappers; the recorders
    # launch nothing themselves
    recorded = {}
    real_pcg, real_bins, real_sm = pcg.pcg_solve, knn.knn_bins, sm.self_match

    def pcg_recorder(h, dlam, minv, b, iters, tol):
        if recorded.get("pcg_sweep") != lo.sweep_id:  # the sweep's first LM iteration
            recorded["pcg_sweep"] = lo.sweep_id
            recorded["pcg"] = (h.clone(), dlam.clone(), minv.clone(), b.clone(), iters, tol)
        return real_pcg(h, dlam, minv, b, iters, tol)

    def bins_recorder(dq, dt, n_bins):
        recorded[("knn", dt.shape[0])] = (dq.clone(), dt.clone(), n_bins)
        return real_bins(dq, dt, n_bins)

    def sm_recorder(cand, ok, max_rounds):
        recorded["self_match"] = (cand.clone(), ok.clone(), max_rounds)
        return real_sm(cand, ok, max_rounds)

    real_spd = spd.spd_solve

    def spd_recorder(a, b):  # the spline fit's system (the main path runs pcg)
        recorded["spd"] = (a.clone(), b.clone())
        return real_spd(a, b)

    real_k5, real_k6 = solver._imu_banded_normal_eqs, solver._surfel_normal_eqs
    clone = lambda x: x.map(lambda t: t.clone()) if hasattr(x, "map") else (
        x.clone() if hasattr(x, "clone") else x)

    def k5_recorder(ifac, cor, weights, dt, grav, s_cap):  # the sweep's first normal equations
        if recorded.get("k5_sweep") != lo.sweep_id:
            recorded["k5_sweep"] = lo.sweep_id
            recorded["imu_factor"] = tuple(map(clone, (ifac, cor, weights, dt, grav, s_cap)))
        return real_k5(ifac, cor, weights, dt, grav, s_cap)

    def k6_recorder(sfac, cor, a2, imu_bands, gi, fm, s_cap, nb, w_interp=None):
        if recorded.get("k6_sweep") != lo.sweep_id:
            recorded["k6_sweep"] = lo.sweep_id
            recorded["surfel_factor"] = tuple(map(clone, (sfac, cor, a2, imu_bands, gi, fm, s_cap,
                                                          nb)))
        return real_k6(sfac, cor, a2, imu_bands, gi, fm, s_cap, nb, w_interp)

    real_k7 = pipeline.extract_surfels

    def k7_recorder(pts, t, valid, cfg):  # the sweep's extraction (the last one stays)
        recorded["surfel_extract"] = (pts.clone(), t.clone(), valid.clone(), cfg)
        return real_k7(pts, t, valid, cfg)

    pcg.pcg_solve, knn.knn_bins, sm.self_match = pcg_recorder, bins_recorder, sm_recorder
    spd.spd_solve = spd_recorder
    solver._imu_banded_normal_eqs, solver._surfel_normal_eqs = k5_recorder, k6_recorder
    pipeline.extract_surfels = k7_recorder
    try:
        _eager_feed(lo, events)
    finally:
        pcg.pcg_solve, knn.knn_bins, sm.self_match = real_pcg, real_bins, real_sm
        spd.spd_solve = real_spd
        solver._imu_banded_normal_eqs, solver._surfel_normal_eqs = real_k5, real_k6
        pipeline.extract_surfels = real_k7
    same = _same_outputs(main_lo, lo)
    med = np.median(np.asarray(lo.sweep_seconds[1:]) * 1e3)
    print(f"(k) main sequence: eager process_sweep {lo.sweep_id} sweeps, per-sweep median "
          f"{med:.2f} ms after the first; the graph run equals it bit for bit (trajectory and "
          f"the 22 packed outputs, LM iterations {[s['iterations'] for s in lo.stats]}): {same}",
          flush=True)
    if not (same and lo.sweep_id == main_lo.sweep_id):
        raise AssertionError("the graph run of the main sequence left its eager run")
    return recorded, lo


def _pcg_bound(n: int, its: int) -> tuple:
    """K1's bound: H, dlam, b, x and the block inverses moved once; the f32
    operations of ``its`` iterations (matvec 2 N^2 + 38 N each) and the setup."""
    return _bound(4.0 * (n * n + 3 * n + 144 * (n // 12)),
                  fp32=(its * (2.0 * n * n + 38 * n) + 28 * n) / F32_FLOPS)


def phase_replay(recorded: dict) -> dict:
    """The mxu path on the recorded K2 inputs, then each kernel against its
    plain version on the recorded main-path inputs; the times of both, of the
    yardstick, and each kernel's bound; then K1's S-scaling table."""
    import torch

    from wildcat_slam_tpu_torch.ops import knn, pcg
    from wildcat_slam_tpu_torch.ops import self_match as sm
    from wildcat_slam_tpu_torch.profile_sweeps import graph_ms

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
    bound_ms, bound_by = _pcg_bound(n, its)

    def cholesky():  # the exact solve of the damped system: the LM step's library yardstick
        chol = torch.linalg.cholesky(h + torch.diag(dlam))
        return torch.cholesky_solve(b[:, None], chol)

    out["pcg"] = dict(max_abs_err=err,
                      ms=_time_ms(lambda: pcg.pcg_solve(h, dlam, minv, b, iters, tol)),
                      device_ms=_device_ms(lambda: pcg.pcg_solve(h, dlam, minv, b, iters, tol)),
                      plain_ms=_time_ms(lambda: pcg.pcg_solve_plain(h, dlam, minv, b, iters, tol)),
                      bound_ms=bound_ms, bound_by=bound_by, library_ms=_time_ms(cholesky))
    _print_times("K1 pcg main-path", out["pcg"], "cholesky + cholesky_solve",
                 f"; {its} of {iters} iterations run")
    for t_n in t_sizes:
        dq, dt, n_bins = recorded[("knn", t_n)]
        err = check_k2(f"main-path Q={dq.shape[0]} T={t_n}", dq, dt, n_bins, recall=False)
        err_mxu = check_mxu(f"main-path Q={dq.shape[0]} T={t_n}", dq, dt, n_bins, recall=False)
        if t_n != t_sizes[-1]:
            continue
        q, d = dq.shape
        (bound_ms, bound_by), mxu_bound = _knn_bounds(q, t_n, n_bins, d)
        out["knn"] = dict(max_abs_err=err, ms=_time_ms(lambda: knn.knn_bins(dq, dt, n_bins)),
                          device_ms=_device_ms(lambda: knn.knn_bins(dq, dt, n_bins)),
                          plain_ms=_time_ms(lambda: knn.knn_bins_plain(dq, dt, n_bins)),
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=_time_ms(lambda: torch.topk(torch.cdist(dq, dt), 10, dim=1,
                                                                 largest=False)))
        _print_times(f"K2 knn main-path T={t_n}", out["knn"], "exact cdist + topk")
        dq_aug, dtt_aug = knn.mxu_embedding(dq, dt)
        bound_ms, bound_by = mxu_bound
        out["knn_mxu"] = dict(
            max_abs_err=err_mxu, launches=mxu_launches,
            ms=_time_ms(lambda: knn.knn_bins_mxu(dq_aug, dtt_aug, n_bins)),
            device_ms=_device_ms(lambda: knn.knn_bins_mxu(dq_aug, dtt_aug, n_bins)),
            plain_ms=_time_ms(lambda: knn.knn_bins_mxu_plain(dq_aug, dtt_aug, n_bins)),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=_time_ms(lambda: torch.topk(dq_aug @ dtt_aug, 10, dim=1, largest=False)))
        _print_times(f"K2 knn_mxu main-path T={t_n}", out["knn_mxu"], "exact matmul + topk")

    # K3 on the main path's last self-match
    cand, ok, max_rounds = recorded["self_match"]
    rounds = check_k3("main-path", cand, ok, max_rounds)
    bound_ms, bound_by = _k3_bound(*cand.shape, rounds)
    out["self_match"] = dict(
        max_abs_err=0.0, ms=_time_ms(lambda: sm.self_match(cand, ok, max_rounds)),
        device_ms=_device_ms(lambda: sm.self_match(cand, ok, max_rounds)),
        graph_ms=graph_ms(lambda: sm.self_match(cand, ok, max_rounds)),
        plain_ms=_time_ms(lambda: sm.self_match_plain(cand, ok, max_rounds)),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    r = out["self_match"]
    print(f"K3 self_match main-path time: kernel {r['ms']:.4f} ms by single synchronised calls, "
          f"{r['device_ms']:.4f} ms back to back, {r['graph_ms']:.4f} ms by graph replays; plain "
          f"{r['plain_ms']:.4f} ms; no PyTorch call computes the fixed point; bound "
          f"{bound_ms * 1e3:.3f} us ({bound_by}, {rounds} rounds), "
          f"{bound_ms / r['graph_ms']:.2%} of the graph-replay time", flush=True)
    # K3's cost split, by graph replays at Q=8192, k=10: a launch of a few
    # rounds (random candidates) against one of 2001 (the adversarial chain)
    # gives a round's cost and the rest's (the one-time load, the output)
    split = []
    for cand_s, ok_s in (k3_chains(8192, 10, 1, [], cand.device),
                         k3_chains(8192, 10, 2, [2000, 500, 7], cand.device)):
        split.append((int(sm.self_match(cand_s, ok_s, 8192)[1]),
                      graph_ms(lambda c=cand_s, o=ok_s: sm.self_match(c, o, 8192))))
    (r_few, ms_few), (r_many, ms_many) = split
    per_round = (ms_many - ms_few) / (r_many - r_few)
    print(f"K3 cost split (graph replays): {r_few} rounds {ms_few:.4f} ms, {r_many} rounds "
          f"{ms_many:.4f} ms: {per_round * 1e3:.3f} us a round, "
          f"{(ms_few - r_few * per_round) * 1e3:.2f} us the rest (the one-time load of cand "
          f"and ok, the output)", flush=True)
    # the same main-path launch with its lists in the global scratch that a
    # Q whose lists outgrow shared memory takes (the plan given no room beyond
    # the partners): what keeping them in shared memory buys at this shape
    plan = sm.plan
    sm.plan = lambda q, k: plan(q, k, smem_per_block=4 * q)
    try:
        partner_g, rounds_g = sm.self_match(cand, ok, max_rounds)
        ref, ref_rounds = sm.self_match_plain(cand, ok, max_rounds)
        same_g = torch.equal(partner_g, ref) and int(rounds_g) == int(ref_rounds)
        global_ms = graph_ms(lambda: sm.self_match(cand, ok, max_rounds))
    finally:
        sm.plan = plan
    print(f"K3 lists in shared memory against a global scratch, main path Q={cand.shape[0]} "
          f"k={cand.shape[1]} (graph replays): {r['graph_ms']:.4f} ms against {global_ms:.4f} "
          f"ms; global-scratch partners and rounds equal the plain version's: {same_g}",
          flush=True)
    if not same_g:
        raise AssertionError("K3 with its lists in a global scratch left its plain version")

    # K4 on the main path's last spline fit (its shape on the main path), then
    # on the main path's first damped LM system (h + diag(dlam) of K1's
    # recorded inputs, as linear_solver="cholesky" would solve it), f32 and f64
    a_fit, b_fit = recorded["spd"]
    out["spd"] = k4_times(a_fit, b_fit, check_k4("main-path spline fit", a_fit, b_fit))
    _print_times(f"K4 spd_solve main-path spline fit N={a_fit.shape[0]} m={b_fit.shape[1]}",
                 out["spd"], "cholesky + cholesky_solve", f"; graph replays "
                 f"{out['spd']['graph_ms']:.4f} ms; library back to back "
                 f"{out['spd']['library_device_ms']:.4f} ms")
    # K5 and K6 on the main path's last sweep's first normal equations
    out.update(factor_times(recorded["imu_factor"], recorded["surfel_factor"]))
    # K7 on the main path's last sweep's extraction
    out["surfel_extract"] = k7_times(recorded["surfel_extract"])
    h_lm, dlam_lm, _, b_lm, _, _ = recorded["pcg"]
    for dtype in (torch.float32, torch.float64):
        a_lm, rhs = (h_lm + torch.diag(dlam_lm)).to(dtype), b_lm[:, None].to(dtype)
        r = k4_times(a_lm, rhs, check_k4("main-path LM system", a_lm, rhs))
        _print_times(f"K4 spd_solve main-path LM system N={a_lm.shape[0]} m=1 "
                     f"{str(dtype)[6:]}", r, "cholesky + cholesky_solve",
                     f"; graph replays {r['graph_ms']:.4f} ms; library back to back "
                     f"{r['library_device_ms']:.4f} ms")

    # K1's S-scaling table on the random systems of phase 3 (iters 24, tol 1e-2)
    sms = torch.cuda.get_device_properties(h.device).multi_processor_count
    for s_cap in (96, 192, 256):
        h, dlam, minv, b = random_system(h.device, s_cap)
        its = _pcg_iterations(h, dlam, minv, b, 24, 1e-2)
        ms = _device_ms(lambda: pcg.pcg_solve(h, dlam, minv, b, 24, 1e-2))
        bound_ms, bound_by = _pcg_bound(12 * s_cap, its)
        print(f"K1 S-scaling S={s_cap}: device {ms:.4f} ms, {its} of 24 iterations run, "
              f"{ms / max(its, 1) * 1e3:.2f} us per iteration; bound {bound_ms * 1e3:.2f} us "
              f"({bound_by}), {bound_ms / ms:.2%} of it; plan {pcg.launch_plan(s_cap, sms)}",
              flush=True)
    return out


def _print_times(label: str, r: dict, library: str, extra: str = "") -> None:
    print(f"{label} time: kernel {r['ms']:.4f} ms by single synchronised calls, "
          f"{r['device_ms']:.4f} ms back to back; plain {r['plain_ms']:.4f} ms, {library} "
          f"{r['library_ms']:.4f} ms{extra}; bound {r['bound_ms'] * 1e3:.2f} us "
          f"({r['bound_by']}), {r['bound_ms'] / r['device_ms']:.2%} of the device time",
          flush=True)


def wrapper_costs(dev) -> dict:
    """What K1, K2 vpu and K2 mxu cost through their wrappers: K1 on the
    random S=96 system capped at 16 iterations (as many as the main path's
    first solve runs), K2 vpu and mxu at Q=8192 against T=16384, D=6 (the main
    path's larger search). For each: device ms (back to back), ms of single
    synchronised calls, and the host's microseconds per call. It calls only the
    wrappers' signatures, so it times another checkout's package the same way:

        python3 -c "import runpy, sys, torch; sys.path.insert(0, 'OTHER');
          runpy.run_path('chip_smoke.py')['wrapper_costs'](torch.device('cuda', 0))"
    """
    import numpy as np
    import torch

    from wildcat_slam_tpu_torch.ops import knn, pcg

    h, dlam, minv, b = random_system(dev, 96)
    its = _pcg_iterations(h, dlam, minv, b, 16, 1e-2)
    rng = np.random.default_rng(1)
    dt = torch.as_tensor(_cloud(rng, 16384), device=dev)
    dq = torch.as_tensor(_cloud(rng, 8192), device=dev)
    dq_aug, dtt_aug = knn.mxu_embedding(dq, dt)
    out = {}
    for key, fn in (("pcg", lambda: pcg.pcg_solve(h, dlam, minv, b, 16, 1e-2)),
                    ("knn", lambda: knn.knn_bins(dq, dt, 512)),
                    ("knn_mxu", lambda: knn.knn_bins_mxu(dq_aug, dtt_aug, 512))):
        out[key] = dict(device_ms=_device_ms(fn), ms=_time_ms(fn), host_us=_host_us(fn))

    def costs(key):
        return (f"device {out[key]['device_ms']:.4f} ms, single calls {out[key]['ms']:.4f} ms, "
                f"host {out[key]['host_us']:.1f} us a call")

    print(f"wrapper costs ({pcg.__file__.rsplit('/ops/', 1)[0]}): K1 S=96, {its} iterations: "
          f"{costs('pcg')}; K2 vpu Q=8192 T=16384 D=6: {costs('knn')}; K2 mxu Q=8192 T=16384 "
          f"D=6: {costs('knn_mxu')}", flush=True)
    return out


def _knn_bounds(q: int, t: int, n_bins: int, d: int = 6) -> tuple:
    """(K2 vpu's, K2 mxu's) bound at Q queries of width D against T targets:
    bytes of the inputs and the (Q, n_bins) outputs; vpu's 3 D + 2 f32
    operations a pair; mxu's 3-pass TF32 product at depth 8 and its fold."""
    return (_bound(4.0 * (q * d + t * d) + 8.0 * q * n_bins, fp32=q * t * (3 * d + 2) / F32_OPS),
            _bound(4.0 * (q * 8 + 8 * t) + 8.0 * q * n_bins, tf32=q * t * 8 * 2 * 3 / TF32_FLOPS,
                   fold=3.0 * q * t / F32_OPS))


def phase_crossover(dev) -> None:
    """K2 vpu and K2 mxu side by side at the main path's Q=8192, T=16384 and
    at Q=16384, T=65536 (the larger shape of knn_pallas.py's A/B), on seeded
    descriptor clouds: device time (back to back) and share of each bound; K2
    mxu held to its plain version at the larger shape (no recall pass)."""
    import numpy as np
    import torch

    from wildcat_slam_tpu_torch.ops import knn

    for q_n, t_n in ((8192, 16384), (16384, 65536)):
        rng = np.random.default_rng(t_n)
        dt = torch.as_tensor(_cloud(rng, t_n), device=dev)
        dq = torch.as_tensor(_cloud(rng, q_n), device=dev)
        if t_n == 65536:
            check_mxu(f"crossover Q={q_n} T={t_n}", dq, dt, 512, recall=False)
        dq_aug, dtt_aug = knn.mxu_embedding(dq, dt)
        vpu = _device_ms(lambda: knn.knn_bins(dq, dt, 512))
        mxu = _device_ms(lambda: knn.knn_bins_mxu(dq_aug, dtt_aug, 512))
        (bv, _), (bm, _) = _knn_bounds(q_n, t_n, 512)
        print(f"K2 crossover Q={q_n} T={t_n} n_bins=512: vpu device {vpu:.4f} ms "
              f"({bv / vpu:.2%} of its bound {bv * 1e3:.2f} us), mxu device {mxu:.4f} ms "
              f"({bm / mxu:.2%} of its bound {bm * 1e3:.2f} us); mxu / vpu {mxu / vpu:.3f}",
              flush=True)


def phase_paths(dev, main_traj, main_events, eager_lo) -> dict:
    """The single-window paths beyond the main one, each with its launch
    counts from 0 (see the module doc); the checkpoint's resumed run held to
    the eager reference (``phase_eager``) bit for bit. Returns the counts per
    path."""
    import contextlib
    import io
    import os
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
        same = _same_trajectory(lo.trajectory, main_traj) and _same_outputs(lo, eager_lo)
        print(f"paths (c) checkpoint after 8 sweeps, loaded on {dev} and run on: "
              f"{lo.sweep_id} sweeps, trajectory and packed outputs equal to the uninterrupted "
              f"run's and to the eager run's bit for bit: {same}; launches "
              f"{counts['checkpoint']}", flush=True)
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


def _traj_gap(a, b) -> float:
    """Largest |position| or |quaternion| difference of two trajectories with
    the same times (inf when they differ in length or times)."""
    import numpy as np

    if len(a) != len(b) or any(t1 != t2 for (t1, _, _), (t2, _, _) in zip(a, b)):
        return math.inf
    return max((float(max(np.abs(p1 - p2).max(), np.abs(q1 - q2).max()))
                for (_, p1, q1), (_, p2, q2) in zip(a, b)), default=0.0)


def _run_batch(dev, event_lists: list) -> tuple:
    """BatchedOdometry over ``event_lists`` (one window each), fed as the CLI
    feeds --batch: one scan of each window in turn, then pump; then finish.
    Returns the BatchedOdometry and the seconds of each lockstep round (each ended by
    a device synchronisation)."""
    import torch

    from wildcat_slam_tpu_torch.config import WildcatConfig
    from wildcat_slam_tpu_torch.parallel.batch import BatchedOdometry

    bo = BatchedOdometry(WildcatConfig(), batch=len(event_lists), device=dev)
    rounds = []
    step = bo._round

    def timed_round(ready):
        t0 = time.perf_counter()
        step(ready)
        torch.cuda.synchronize(dev)
        rounds.append(time.perf_counter() - t0)

    bo._round = timed_round
    its = [iter(ev) for ev in event_lists]
    live = [True] * len(its)
    while any(live):
        for i, it in enumerate(its):
            for ev in it if live[i] else ():
                (bo.add_imu if ev[0] == "imu" else bo.add_scan)(i, *ev[1:])
                if ev[0] == "scan":
                    break
            else:
                live[i] = False
        bo.pump()
    bo.finish()
    return bo, rounds


def phase_batch(dev, main_traj, main_events, eager_lo) -> None:
    """(e): two windows, each on its own sweep graph, against their eager
    single-window runs (bit for bit), then the lockstep round time and
    throughput at B=1, 2 and 4."""
    import numpy as np

    from wildcat_slam_tpu_torch import cli
    from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence

    def events(seed, duration):
        return list(cli.synthetic_events(SyntheticSequence(
            duration=duration, points_per_scan=12800, room_half=5.0, seed=seed)))

    ev1 = events(1, 6.0)
    single1 = _eager_frontend(dev)
    _eager_feed(single1, ev1)
    (bo, rounds), counts = _counted("batch B=2", lambda: _run_batch(dev, [main_events, ev1]))
    gaps = [_traj_gap(bo.trajectories[0], main_traj), _traj_gap(bo.trajectories[1],
                                                                single1.trajectory)]
    same = [_same_outputs(w, ref) for w, ref in zip(bo.windows, (eager_lo, single1))]
    sweeps = [w.sweep_id for w in bo.windows]
    print(f"paths (e) batch B=2, room seeds 0 (8 s) and 1 (6 s): {len(rounds)} lockstep rounds, "
          f"sweeps per window {sweeps}; largest gap to the single-window runs: window 0 "
          f"{gaps[0]:.3e} (the main path's run), window 1 {gaps[1]:.3e} (its eager run; bound "
          f"{BATCH_TOL:g}); each window equal to its eager run bit for bit (trajectory and "
          f"packed outputs): {same}; launches {counts}", flush=True)
    if not (max(gaps) <= BATCH_TOL and all(same)
            and sweeps == [len(main_traj), len(single1.trajectory)] and sweeps[0] > sweeps[1] >= 10):
        raise AssertionError(f"batched windows left their single-window runs: gaps {gaps}, "
                             f"sweeps {sweeps}")
    short = [events(seed, 2.1) for seed in range(4)]
    rows = {2: rounds[:4]}
    for b in (1, 4):
        (bo, rows[b]), counts = _counted(f"batch B={b}", lambda: _run_batch(dev, short[:b]))
        if [w.sweep_id for w in bo.windows] != [4] * b:
            raise AssertionError(f"B={b}: sweeps {[w.sweep_id for w in bo.windows]}")
    for b in (1, 2, 4):
        ms = np.asarray(rows[b]) * 1e3
        print(f"paths (e) batch B={b}, first 4 lockstep rounds: ms per round median "
              f"{np.median(ms[1:]):.2f} (after the first), {b * len(ms) / (ms.sum() / 1e3):.2f} "
              f"sweeps/s over all windows; rounds {np.round(ms, 2).tolist()}", flush=True)
    print(f"paths (e) batch B=2, all {len(rounds)} rounds: ms per round median "
          f"{np.median(np.asarray(rounds[1:]) * 1e3):.2f}, "
          f"{sum(sweeps) / sum(rounds):.2f} sweeps/s over both windows", flush=True)


def _profiled_syncs(dev, events, chunk: int) -> tuple:
    """Host syncs and kernel launches per sweep over sweeps 5 to 8 (chained
    with ``chunk`` = 4: its second chunk) under torch.profiler, counted by
    the names profile_sweeps counts; the first four sweeps run unprofiled.
    Only CUDA activity is traced (the runtime calls counted here are CUDA
    events), and the raw events are counted by name: the counts that
    key_averages() gives, without the parse into operator trees that takes
    it seconds."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    from wildcat_slam_tpu_torch import cli
    from wildcat_slam_tpu_torch.config import WildcatConfig
    from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry
    from wildcat_slam_tpu_torch.profile_sweeps import LAUNCH_KEYS, SYNC_KEYS

    lo = LidarOdometry(WildcatConfig(), device=dev, chunk_sweeps=chunk)
    n = cli.feed_events(lo, events, until_sweep=4)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cli.feed_events(lo, events[n:], until_sweep=8)
        lo.trajectory
        torch.cuda.synchronize(dev)
    names = collections.Counter(e.name() for e in prof.profiler.kineto_results.events())
    syncs = sum(names[k] for k in SYNC_KEYS) / 4
    launches = sum(names[k] for k in LAUNCH_KEYS) / 4
    if lo.sweep_id != 8 or not (syncs > 0 and launches > 0):
        raise AssertionError(f"the profiler saw {syncs} syncs and {launches} launches a sweep "
                             f"over sweeps 5 to {lo.sweep_id}")
    return syncs, launches


def phase_chained(dev, main_traj, main_events, main_ms: float, eager_lo) -> None:
    """(f): chunk_sweeps=4 on the main path's sequence (the sweep graph
    replayed from 4 staged feed slots), equal to the eager run bit for bit,
    then the host syncs and launches per sweep of both paths."""
    import numpy as np

    from wildcat_slam_tpu_torch import cli
    from wildcat_slam_tpu_torch.config import WildcatConfig
    from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry

    def run():
        lo = LidarOdometry(WildcatConfig(), device=dev, chunk_sweeps=4)
        t0 = time.perf_counter()
        cli.feed_events(lo, main_events)
        traj = lo.trajectory  # runs a padded tail chunk, if any, and copies the rows
        return lo, traj, time.perf_counter() - t0

    (lo, traj, wall), counts = _counted("chained", run)
    gap = _traj_gap(traj, main_traj)
    same = _same_outputs(lo, eager_lo)
    med = float(np.median(np.asarray(lo.sweep_seconds[1:]) * 1e3))
    print(f"paths (f) chained, chunk_sweeps=4: {lo.sweep_id} sweeps in {wall:.2f} s, "
          f"{-(-lo.sweep_id // 4)} chunks; largest gap to the main path's trajectory {gap:.3e} "
          f"(bound {BATCH_TOL:g}); trajectory and packed outputs equal to the eager run's bit "
          f"for bit: {same}; per-sweep ms after the first: median {med:.2f} (the main path's "
          f"per-sweep dispatch: {main_ms:.2f}); launches {counts}", flush=True)
    if not (gap <= BATCH_TOL and same):
        raise AssertionError(f"the chained run left the main path's trajectory: gap {gap}")
    for label, chunk in (("per-sweep", 1), ("chained k=4", 4)):
        syncs, launches = _profiled_syncs(dev, main_events, chunk)
        print(f"paths (f) {label}: torch.profiler over sweeps 5-8: {syncs:.2f} host syncs and "
              f"{launches:.2f} launch calls (kernels and graphs) per sweep", flush=True)


def _profiled(fn) -> dict:
    """torch.profiler (CUDA activity only) around ``fn()``: the host's launch
    calls (kernels and graphs), syncs and memcpys, and the device's kernel
    ms (every device activity but the memcpys and memsets)."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from wildcat_slam_tpu_torch.profile_sweeps import LAUNCH_KEYS, SYNC_KEYS

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names, kernel_ns = collections.Counter(), 0
    for e in prof.profiler.kineto_results.events():
        names[e.name()] += 1
        if e.device_type() == DeviceType.CUDA and not e.name().startswith(("Memcpy", "Memset")):
            kernel_ns += e.duration_ns()
    return dict(launches=sum(names[k] for k in LAUNCH_KEYS), syncs=sum(names[k] for k in SYNC_KEYS),
                memcpys=names["cudaMemcpyAsync"] + names["cudaMemcpy"], kernel_ms=kernel_ns / 1e6)


def phase_graph(dev) -> tuple:
    """(k): bench.py's workload (the shipped config, a 50 s room at 12800
    points a scan, ~100 sweeps: the first runs with a full fixed window),
    through LidarOdometry (its sweep graph) and through the eager reference:
    bit-equal, ATE < 20 mm. Per sweep, for both, over sweeps PROFILED of the
    steady state (after fixed_window_duration + sweep_duration, as bench.py
    times): launch calls, syncs and memcpys, device kernel ms (torch.profiler);
    wall median and p90 over the other steady sweeps; idle share. Returns
    the graph run's frontend, the events and the sequence."""
    import numpy as np
    import torch

    from wildcat_slam_tpu_torch import cli
    from wildcat_slam_tpu_torch.config import WildcatConfig
    from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence, ate_rmse
    from wildcat_slam_tpu_torch.odometry import graph
    from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry

    cfg = WildcatConfig()
    t0 = time.perf_counter()
    seq = SyntheticSequence(**ROOM50)
    events = list(cli.synthetic_events(seq))
    print(f"(k) 50 s room: sequence generated in {time.perf_counter() - t0:.1f} s", flush=True)
    first_steady = int((cfg.fixed_window_duration + cfg.sweep_duration) / cfg.sweep_duration)
    p0, p1 = GRAPH_PROFILED
    runs = {}
    for label in ("graph", "eager"):
        t0 = time.perf_counter()
        if label == "graph":
            lo = LidarOdometry(cfg, device=dev)
            feed = lambda evs, until=None, lo=lo: cli.feed_events(lo, evs, until_sweep=until)
        else:
            lo = _eager_frontend(dev, cfg)
            feed = lambda evs, until=None, lo=lo: _eager_feed(lo, evs, until_sweep=until)
        n = feed(events, p0)
        given = []
        prof = _profiled(lambda: given.append(feed(events[n:], p1)))
        feed(events[n + given[0]:])
        lo.trajectory  # the last copies
        wall = np.asarray([s for i, s in enumerate(lo.sweep_seconds)
                           if i >= first_steady and not p0 <= i < p1]) * 1e3
        prof = {k: v / (p1 - p0) for k, v in prof.items()}
        med = float(np.median(wall))
        runs[label] = lo
        extra = f"; sweep graph: {_graph_text(lo)}" if label == "graph" else ""
        print(f"(k) 50 s room, {label}: {lo.sweep_id} sweeps in {time.perf_counter() - t0:.1f} s; "
              f"per sweep over sweeps {p0}-{p1 - 1} under torch.profiler: "
              f"{prof['launches']:.1f} launch calls (kernels and graphs), {prof['syncs']:.1f} "
              f"host syncs, {prof['memcpys']:.1f} memcpys, device kernel time "
              f"{prof['kernel_ms']:.3f} ms; wall over the other {len(wall)} sweeps from sweep "
              f"{first_steady}: median {med:.2f} ms, p90 {np.percentile(wall, 90):.2f} ms; idle "
              f"share {1.0 - prof['kernel_ms'] / med:.3f}{extra}", flush=True)
    same = _same_outputs(runs["graph"], runs["eager"])
    ate = ate_rmse(runs["graph"].trajectory, lambda t: seq.gt_pose(t)[0], align=False)
    iters = [s["iterations"] for s in runs["graph"].stats]
    print(f"(k) 50 s room: graph run equal to the eager run bit for bit (trajectory and the 22 "
          f"packed outputs): {same}; ATE {ate * 1e3:.3f} mm unaligned (< 20 mm; the JAX "
          f"package's recorded figure on this workload: 2.84 mm, BENCH_r05.json, TPU v5 lite); "
          f"LM iterations a sweep min {min(iters):.0f} median {np.median(iters):.0f} max "
          f"{max(iters):.0f}, sweeps at the cap of {cfg.inner_iter_num_max}: "
          f"{[i for i, n in enumerate(iters) if n >= cfg.inner_iter_num_max]}", flush=True)
    if not (same and ate < 0.02 and runs["graph"].sweep_id >= 90):
        raise AssertionError(f"(k) 50 s room failed: bit-equal {same}, ATE {ate}")
    # float64 on the card takes the plain PCG (linear_solver="pcg_xla"), whose
    # early exit the graph holds on the device, and linear_solver="cholesky"
    # takes K4 in float32 and float64 on the graph too: the room's first 8
    # sweeps of each, graph against eager, K4's launches counted on the graph
    for label, kw in (("float64, linear_solver='pcg_xla'",
                       dict(dtype="float64", linear_solver="pcg_xla")),
                      ("float32, linear_solver='cholesky'", dict(linear_solver="cholesky")),
                      ("float64, linear_solver='cholesky'",
                       dict(dtype="float64", linear_solver="cholesky"))):
        cfg_x = WildcatConfig(**kw)
        lo = LidarOdometry(cfg_x, device=dev)
        graph.reset_counts()
        cli.feed_events(lo, events, until_sweep=8)
        torch.cuda.synchronize()
        counts = graph.launches()
        ref = _eager_frontend(dev, cfg_x)
        _eager_feed(ref, events, until_sweep=8)
        same = _same_outputs(lo, ref)
        its = sum(st["iterations"] for st in lo.stats)
        print(f"(k) {label}: {lo.sweep_id} sweeps, graph run equal to the eager run bit for "
              f"bit: {same}; {its:.0f} LM iterations, launches {counts}; sweep graph: "
              f"{_graph_text(lo)}", flush=True)
        k4_ok = counts["spd"] >= max(1, its if kw["linear_solver"] == "cholesky" else 0)
        if not (same and lo.sweep_id == 8 and k4_ok):
            raise AssertionError(f"(k) the {label} graph run left its eager run or missed K4")
    return runs["graph"], events, seq


def load_record(name: str) -> dict:
    """One recorded JAX run: {"t" (n,), "packed" (n, 22), "meta"}."""
    import os

    import numpy as np

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), *REFERENCE_DIR, f"{name}.npz")
    with np.load(path, allow_pickle=False) as d:
        return dict(t=d["t"], packed=d["packed"], meta=json.loads(str(d["meta"])))


def packed_rows(trajectory, stats) -> tuple:
    """(t (n,), packed (n, 22)): a frontend's run as the records hold it (the
    pose, then PACKED_STATS), from either package's trajectory and stats."""
    import numpy as np

    t = np.asarray([e[0] for e in trajectory], np.float64)
    rows = [np.concatenate([np.asarray(p, np.float64), np.asarray(q, np.float64)]
                           + [np.atleast_1d(np.asarray(st[k], np.float64)) for k in PACKED_STATS])
            for (_, p, q), st in zip(trajectory, stats)]
    return t, np.stack(rows) if rows else np.zeros((0, 22))


def errors(t, pos, seq) -> dict:
    """ATE (RMS, unaligned), largest and final position error (m), and the
    error a sweep."""
    import numpy as np

    err = np.linalg.norm(pos - seq.gt_pose(np.asarray(t))[0], axis=1)
    return dict(ate=float(np.sqrt(np.mean(err ** 2))), max=float(err.max()), final=float(err[-1]),
                each=err)


def _gaps(a, b) -> dict:
    """Position gaps (RMS and largest, m), the largest quaternion gap (up to
    sign), the first sweep whose position gap passes F64_GAP and the sweeps
    whose counts differ of two packed runs with the same sweeps; with the
    gaps a sweep (dp, dq)."""
    import numpy as np

    dp = np.linalg.norm(a[:, 0:3] - b[:, 0:3], axis=1)
    dq = np.minimum(np.abs(a[:, 3:7] - b[:, 3:7]).max(1), np.abs(a[:, 3:7] + b[:, 3:7]).max(1))
    over = np.flatnonzero(dp > F64_GAP)
    cols = list(COUNT_COLUMNS)
    differ = [int(i) for i in np.flatnonzero(np.any(a[:, cols] != b[:, cols], axis=1))]
    return dict(rms=float(np.sqrt(np.mean(dp ** 2))), max=float(dp.max()), quat=float(dq.max()),
                first_over=int(over[0]) if len(over) else None, differ=differ, dp=dp, dq=dq)


def _f64_gate(g: dict, u: dict) -> list:
    """The float64 gate: the failures of a run's gaps ``g`` to room50_f64,
    held to room50_f64_ulp's ``u`` (see F64_GAP). Over the sweeps before
    ``u`` first passes F64_GAP both gaps stay within it; the run's first
    sweep over it and its first sweep whose counts differ come no earlier
    than ``u``'s; over the whole run each gap is within GAP_FACTOR x ``u``'s
    + F64_GAP."""
    import numpy as np

    n = len(u["dp"])

    def first(x):
        return n if x is None else x

    def first_differ(x):
        return x["differ"][0] if x["differ"] else n

    fails = []
    k = first(u["first_over"])
    pre = dict(position=float(g["dp"][:k].max(initial=0.0)), quat=float(g["dq"][:k].max(initial=0.0)))
    for name, v in pre.items():
        if not v <= F64_GAP:
            fails.append(f"largest {name} gap over sweeps 0-{k - 1} {v:.3e} > {F64_GAP:g}")
    if first(g["first_over"]) < k:
        fails.append(f"first sweep over {F64_GAP:g} m {g['first_over']} before "
                     f"room50_f64_ulp's {u['first_over']}")
    if first_differ(g) < first_differ(u):
        fails.append(f"first sweep whose counts differ {first_differ(g)} before "
                     f"room50_f64_ulp's {first_differ(u)}")
    for key in ("rms", "max", "quat"):
        if not g[key] <= GAP_FACTOR * u[key] + F64_GAP:
            fails.append(f"{key} gap {g[key]:.3e} over {GAP_FACTOR:g} x room50_f64_ulp's "
                         f"{u[key]:.3e} + {F64_GAP:g}")
    return fails


def _iterations_text(packed, cap: int) -> str:
    import numpy as np

    its = packed[:, 8]
    return (f"min {its.min():.0f} median {np.median(its):.0f} max {its.max():.0f}, capped "
            f"{[int(i) for i in np.flatnonzero(its >= cap)]}")


def _hold(label: str, lo, seq, records: dict) -> dict:
    """The port's run ``lo`` against each of ``records`` (name -> record):
    the sweep times must be the record's; prints the gaps, both ATEs, the LM
    iterations of both, the median ratio of pair counts and the sweeps
    whose counts differ. Returns the port's errors and, per record, its
    gaps and errors."""
    import numpy as np

    t, packed = packed_rows(lo.trajectory, lo.stats)
    cap = lo.cfg.inner_iter_num_max
    mine = errors(t, packed[:, 0:3], seq)
    out = dict(mine, packed=packed, records={})
    print(f"(l) {label}: {len(t)} sweeps, ATE {mine['ate'] * 1e3:.4f} mm unaligned, largest "
          f"error {mine['max'] * 1e3:.4f} mm, final {mine['final'] * 1e3:.4f} mm; LM iterations "
          f"{_iterations_text(packed, cap)}", flush=True)
    for name, rec in records.items():
        if not np.array_equal(t, rec["t"]):
            raise AssertionError(f"(l) {label}: the sweep times are not {name}'s "
                                 f"({len(t)} sweeps against {len(rec['t'])})")
        theirs = errors(rec["t"], rec["packed"][:, 0:3], seq)
        gap = _gaps(packed, rec["packed"])
        pairs = packed[:, 12] + packed[:, 13]
        pairs_ref = rec["packed"][:, 12] + rec["packed"][:, 13]
        ratio = float(np.median(pairs / np.maximum(pairs_ref, 1.0)))
        differ = gap["differ"]
        out["records"][name] = dict(gap, **{f"ref_{k}": v for k, v in theirs.items()})
        print(f"(l) {label} against {name}: position gap RMS {gap['rms']:.3e} m, largest "
              f"{gap['max']:.3e} m, first over {F64_GAP:g} m at sweep {gap['first_over']}; "
              f"quaternion gap largest {gap['quat']:.3e}; ATE port "
              f"{mine['ate'] * 1e3:.4f} mm, JAX {theirs['ate'] * 1e3:.4f} mm (final error "
              f"{theirs['final'] * 1e3:.4f} mm, largest {theirs['max'] * 1e3:.4f} mm); JAX LM "
              f"iterations {_iterations_text(rec['packed'], cap)}; median pair-count ratio "
              f"port/JAX {ratio:.6f}; sweeps whose counts differ ({len(differ)}): "
              f"{differ[:20]}{' ...' if len(differ) > 20 else ''}", flush=True)
    return out


def _footprint(dev) -> dict:
    """The card's allocated and reserved bytes and the host's resident bytes."""
    import os

    import torch

    torch.cuda.synchronize(dev)
    with open("/proc/self/statm") as f:
        rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    return dict(allocated=torch.cuda.memory_allocated(dev),
                reserved=torch.cuda.memory_reserved(dev), rss=rss)


def _fix_geo_exact(lo) -> bool:
    """The fixed window's cached geometry (refreshed only for inserted rows)
    equals ``pack_geo_rows`` of the window, bit for bit."""
    import torch

    from wildcat_slam_tpu_torch.odometry import factors

    torch.cuda.synchronize(lo.device)
    st = lo.state
    fresh = factors.pack_geo_rows(st.fix)
    bits = torch.int64 if fresh.dtype == torch.float64 else torch.int32
    same = torch.equal(st.fix_geo.view(bits), fresh.view(bits))
    if not same:
        rows = (st.fix_geo.view(bits) != fresh.view(bits)).any(1)
        valid = st.fix.valid
        print(f"(l) fix_geo differs from pack_geo_rows(fix) in {int(rows.sum())} rows "
              f"({int((rows & valid).sum())} valid), largest gap on valid rows "
              f"{float((st.fix_geo - fresh)[valid].abs().max()):.3e}", flush=True)
    return same


def _soak(dev, name: str, rec: dict) -> None:
    """A 300 s soak on the sweep graph with its lifetime checks, against the
    JAX record ``name``."""
    import numpy as np

    from wildcat_slam_tpu_torch import cli
    from wildcat_slam_tpu_torch.config import WildcatConfig
    from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence
    from wildcat_slam_tpu_torch.odometry import graph as graph_mod
    from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry

    seq_kw = SOAKS[name]
    if rec["meta"]["sequence"] != seq_kw or rec["meta"]["config_kw"] != {}:
        raise AssertionError(f"(l) {name}: the record ran {rec['meta']['sequence']} "
                             f"{rec['meta']['config_kw']}, not {seq_kw} at the shipped config")
    t0 = time.perf_counter()
    seq = SyntheticSequence(**seq_kw)
    events = list(cli.synthetic_events(seq))
    t_gen = time.perf_counter() - t0
    lo = LidarOdometry(WildcatConfig(), device=dev)
    real = graph_mod.SweepGraph
    captures = []

    class CountedGraph(real):
        def __init__(self, *args, **kw):
            captures.append(lo.sweep_id)
            super().__init__(*args, **kw)

    checks, mark = [], None
    graph_mod.SweepGraph = CountedGraph
    t0 = time.perf_counter()
    try:
        for ev in events:
            n = lo.sweep_id
            cli.feed_events(lo, [ev])
            if lo.sweep_id != n and lo.sweep_id % LIFETIME_EVERY == 0:
                checks.append((lo.sweep_id, _fix_geo_exact(lo)))
                if lo.sweep_id == LIFETIME_EVERY:
                    lo.trajectory  # the host copies so far
                    mark = _footprint(dev)
        lo.trajectory
        checks.append((lo.sweep_id, _fix_geo_exact(lo)))
        end = _footprint(dev)
    finally:
        graph_mod.SweepGraph = real
    wall = time.perf_counter() - t0
    res = _hold(f"{name} soak (graph)", lo, seq, {name: rec})
    gap = res["records"][name]
    shift, shift_ref = res["packed"][:, 7], rec["packed"][:, 7]
    shift_gap = float(np.abs(shift - shift_ref).max())
    rebases, rebases_ref = int(np.count_nonzero(shift)), int(np.count_nonzero(shift_ref))
    ms = np.asarray(lo.sweep_seconds[1:]) * 1e3
    fix_ok = all(ok for _, ok in checks)
    growth = end["rss"] - mark["rss"]
    # the prefix before the record's error first passes SOAK_PREFIX_ERROR,
    # where a diverging record still bounds the port's errors
    over = np.flatnonzero(gap["ref_each"] > SOAK_PREFIX_ERROR)
    n = int(over[0]) if len(over) else len(rec["t"])
    mine, theirs = res["each"][:n], gap["ref_each"][:n]
    pre = dict(ate=float(np.sqrt(np.mean(mine ** 2))), max=float(mine.max()),
               ref_ate=float(np.sqrt(np.mean(theirs ** 2))), ref_max=float(theirs.max()),
               gap=float(np.sqrt(np.mean(gap["dp"][:n] ** 2))), gap_max=float(gap["dp"][:n].max()))
    flat = end["allocated"] == mark["allocated"] and end["reserved"] == mark["reserved"]
    print(f"(l) {name} soak: sequence generated in {t_gen:.1f} s, {lo.sweep_id} sweeps in "
          f"{wall:.1f} s; per sweep on the graph after the first: median {np.median(ms):.2f} ms, "
          f"p90 {np.percentile(ms, 90):.2f} ms; ATE {res['ate'] * 1e3:.4f} mm (JAX "
          f"{gap['ref_ate'] * 1e3:.4f}), largest error {res['max'] * 1e3:.4f} mm (JAX "
          f"{gap['ref_max'] * 1e3:.4f}), final error {res['final'] * 1e3:.4f} mm (JAX "
          f"{gap['ref_final'] * 1e3:.4f}); shift gap to the record {shift_gap:.3e} s; sweeps "
          f"with a rebase shift {rebases} (JAX {rebases_ref}); fix_geo == pack_geo_rows(fix) bit "
          f"for bit at sweeps {[k for k, _ in checks]}: {[ok for _, ok in checks]}; captures "
          f"{len(captures)} (before sweeps {captures}); card memory at sweep {LIFETIME_EVERY} "
          f"allocated {mark['allocated']} B reserved {mark['reserved']} B, at the end "
          f"{end['allocated']} B / {end['reserved']} B; host RSS {mark['rss'] / 2**20:.1f} -> "
          f"{end['rss'] / 2**20:.1f} MiB (+{growth / 2**20:.1f})", flush=True)
    print(f"(l) {name} soak, prefix before the record's error first passes "
          f"{SOAK_PREFIX_ERROR:g} m: sweeps 0-{n - 1} (t <= {rec['t'][n - 1]:.3f} s); ATE "
          f"{pre['ate'] * 1e3:.4f} mm (JAX {pre['ref_ate'] * 1e3:.4f}), largest error "
          f"{pre['max'] * 1e3:.4f} mm (JAX {pre['ref_max'] * 1e3:.4f}); position gap to the "
          f"record RMS {pre['gap'] * 1e3:.4f} mm, largest {pre['gap_max'] * 1e3:.4f} mm",
          flush=True)
    bounds = dict(
        ate=res["ate"] <= SOAK_FACTOR * gap["ref_ate"] + SOAK_SLACK,
        final=res["final"] <= SOAK_FACTOR * gap["ref_final"] + SOAK_SLACK,
        prefix_ate=pre["ate"] <= SOAK_FACTOR * pre["ref_ate"] + SOAK_SLACK,
        prefix_max=pre["max"] <= SOAK_FACTOR * pre["ref_max"] + SOAK_SLACK,
        shift=shift_gap <= SHIFT_TOL, rebases=rebases == rebases_ref, fix_geo=fix_ok,
        one_capture=len(captures) == 1, memory_flat=flat, rss=growth <= RSS_GROWTH)
    if not all(bounds.values()):
        raise AssertionError(f"(l) {name} soak failed: {bounds}")


def phase_records(dev, room_lo, room_events, room_seq) -> None:
    """(l): the port on the card against the JAX package's recorded runs
    (tests/torch_reference/): (k)'s graph run of the 50 s room at the shipped
    config, the room in float64 (pcg_xla, exact KNN) and in float32 with the
    exact KNN, both on the graph, then the two 300 s soaks with their
    lifetime checks. Every bound is checked; a failed one raises."""
    from wildcat_slam_tpu_torch import cli
    from wildcat_slam_tpu_torch.config import WildcatConfig
    from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry

    f64 = dict(dtype="float64", linear_solver="pcg_xla", match_knn_approx=False)
    recs = {n: load_record(n) for n in ("room50_f64", "room50_f64_ulp", "room50_f32")}
    for n, kw in (("room50_f64", f64), ("room50_f64_ulp", f64),
                  ("room50_f32", dict(match_knn_approx=False))):
        if recs[n]["meta"]["sequence"] != ROOM50 or recs[n]["meta"]["config_kw"] != kw:
            raise AssertionError(f"(l) {n} is not the run this phase expects: {recs[n]['meta']}")
    failed = []
    own = {}
    for n in ("room50_f64_ulp", "room50_f32"):
        own[n] = g = _gaps(recs[n]["packed"], recs["room50_f64"]["packed"])
        print(f"(l) the records: {n} against room50_f64: position gap RMS {g['rms']:.3e} m, "
              f"largest {g['max']:.3e} m, first over {F64_GAP:g} m at sweep {g['first_over']}; "
              f"quaternion {g['quat']:.3e}; first sweep whose counts differ "
              f"{g['differ'][0] if g['differ'] else None}", flush=True)
    ref, ulp = own["room50_f32"], own["room50_f64_ulp"]
    print(f"(l) the float64 gate on room50_f32 (the JAX package's float32 run): "
          f"{_f64_gate(ref, ulp) or 'passes'}", flush=True)
    # the shipped config (K2 bins): (k)'s graph run
    res = _hold("shipped config, K2 bins (k)'s graph run", room_lo, room_seq,
                {n: recs[n] for n in ("room50_f32", "room50_f64")})
    if not res["ate"] <= res["records"]["room50_f32"]["ref_ate"] + BINS_ATE_SLACK:
        failed.append("shipped config: ATE over room50_f32's + 0.5 mm")
    for label, kw, names in (
            ("float64, pcg_xla, exact KNN (graph)", f64, ("room50_f64",)),
            ("float32, exact KNN, K1 (graph)", dict(match_knn_approx=False),
             ("room50_f32", "room50_f64"))):
        lo = LidarOdometry(WildcatConfig(**kw), device=dev)
        t0 = time.perf_counter()
        cli.feed_events(lo, room_events)
        lo.trajectory
        print(f"(l) {label}: {lo.sweep_id} sweeps in {time.perf_counter() - t0:.1f} s", flush=True)
        res = _hold(label, lo, room_seq, {n: recs[n] for n in names})
        g = res["records"]
        gate = _f64_gate(g["room50_f64"], ulp)
        print(f"(l) {label}: the float64 gate against room50_f64 (room50_f64_ulp first over "
              f"{F64_GAP:g} m at sweep {ulp['first_over']}, its counts first differ at "
              f"{ulp['differ'][:1]}; this run's largest gaps before it: position "
              f"{g['room50_f64']['dp'][:ulp['first_over']].max(initial=0.0):.3e} m, quaternion "
              f"{g['room50_f64']['dq'][:ulp['first_over']].max(initial=0.0):.3e}; counts first "
              f"differ at {g['room50_f64']['differ'][:1]}): {gate or 'passes'}", flush=True)
        if "room50_f32" in names:
            if not g["room50_f64"]["rms"] <= GAP_FACTOR * ref["rms"] + F32_GAP_SLACK:
                failed.append(f"{label}: RMS gap to room50_f64 over 2 x JAX float32's + 5e-5 m")
            if not g["room50_f64"]["max"] <= GAP_FACTOR * ref["max"] + F32_GAP_SLACK:
                failed.append(f"{label}: largest gap to room50_f64 over 2 x JAX float32's + 5e-5 m")
            if not res["ate"] <= g["room50_f32"]["ref_ate"] + F32_ATE_SLACK:
                failed.append(f"{label}: ATE over room50_f32's + 0.3 mm")
            if not gate:
                failed.append(f"{label}: the float64 gate passes a float32 run")
        else:
            failed += [f"{label}: {f}" for f in gate]
    for name in SOAKS:
        try:
            _soak(dev, name, load_record(name))
        except AssertionError as e:
            failed.append(str(e))
    if failed:
        raise AssertionError(f"(l) failed: {failed}")


def phase_outputs(dev) -> None:
    """(g): the CLI's map outputs and trace, and a batch checkpoint resumed."""
    import contextlib
    import io
    import os
    import tempfile

    import numpy as np

    from wildcat_slam_tpu_torch import cli
    from wildcat_slam_tpu_torch.config import WildcatConfig
    from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence
    from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry

    def run_cli(label, argv):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc, counts = _counted(label, lambda: cli.main(argv))
        text = err.getvalue()
        if rc != 0:
            raise AssertionError(f"{label} failed:\n{text}")
        return text, counts

    # the points the CLI's sweeps are fed, by the host feeder alone
    host = LidarOdometry(WildcatConfig(), device=dev)
    host.dispatch = False
    fed = 0
    for ev in cli.synthetic_events(SyntheticSequence(duration=4.0, points_per_scan=6000,
                                                     room_half=5.0)):
        (host.add_imu if ev[0] == "imu" else host.add_scan)(*ev[1:])
        while host._ready():
            if not host.initialized:
                host._init_args()
            fed += host._prepare_feed()["host_stats"]["n_points_fed"]

    with tempfile.TemporaryDirectory() as tmp:
        out = {k: os.path.join(tmp, k) for k in ("s.ply", "c.ply", "prof", "t.tum", "ck.npz",
                                                 "full.tum", "resumed.tum")}
        text, counts = run_cli("cli outputs", [
            "--synthetic", "4", "--device", "cuda", "--surfels-out", out["s.ply"],
            "--cloud-out", out["c.ply"], "--profile", out["prof"], "--traj-out", out["t.tum"]])
        surf = _read_ply(out["s.ply"])
        cloud = _read_ply(out["c.ply"])
        with open(os.path.join(out["prof"], "trace.json")) as f:
            trace = f.read()
        names = {k: k in trace for k in ("pcg_kernel", "knn_bins_kernel")}
        traj = np.loadtxt(out["t.tum"])
        print(f"paths (g) cli --synthetic 4: {len(traj)} poses; surfels PLY {surf['vertex']} "
              f"vertices, {surf['face']} faces; cloud PLY {cloud['vertex']} points (the sweeps "
              f"were fed {fed}); trace {len(trace) / 1e6:.1f} MB names {names}; launches {counts}",
              flush=True)
        if not (len(traj) >= 7 and surf["vertex"] > 0 and surf["face"] > 0
                and cloud["vertex"] == fed > 0 and all(names.values())):
            raise AssertionError("cli outputs failed:\n" + text)

        batch = ["--batch", "synthetic:4:room:0,synthetic:4:room:1", "--device", "cuda"]
        run_cli("cli --batch --checkpoint-out",
                batch + ["--max-sweeps", "4", "--checkpoint-out", out["ck.npz"]])
        text, counts = run_cli("cli --batch --resume",
                               batch + ["--resume", out["ck.npz"], "--traj-out", out["resumed.tum"]])
        run_cli("cli --batch", batch + ["--traj-out", out["full.tum"]])
        same = []
        for i in range(2):
            with open(out["resumed.tum"].replace(".tum", f"_w{i}.tum")) as f:
                a = f.read()
            with open(out["full.tum"].replace(".tum", f"_w{i}.tum")) as f:
                same.append(a == f.read() and len(a.splitlines()) >= 7)
        print(f"paths (g) cli --batch of two 4 s rooms: 4 sweeps, --checkpoint-out, --resume to "
              f"the end: TUM files equal to the uninterrupted run's: {same}; the resumed run's "
              f"launches {counts}", flush=True)
        if not all(same):
            raise AssertionError("the resumed batch left the uninterrupted one:\n" + text)


def _read_ply(path: str) -> dict:
    """Element counts of an ASCII PLY, with each data line checked for its
    numbers (vertex rows: x y z [r g b]; face rows: 3 i j k)."""
    with open(path) as f:
        lines = f.read().splitlines()
    if lines[:2] != ["ply", "format ascii 1.0"] or "end_header" not in lines:
        raise AssertionError(f"{path}: not an ASCII PLY")
    head = lines.index("end_header")
    counts = {ln.split()[1]: int(ln.split()[2]) for ln in lines[:head]
              if ln.startswith("element ")}
    rows = lines[head + 1:]
    n_v, n_f = counts.get("vertex", 0), counts.get("face", 0)
    if len(rows) != n_v + n_f or any(len(r.split()) not in (3, 6) for r in rows[:n_v]) \
            or any(r.split()[0] != "3" for r in rows[n_v:]):
        raise AssertionError(f"{path}: the data does not match its header {counts}")
    for r in rows[:n_v]:
        [float(x) for x in r.split()]
    return counts


def _prep_ms(lo) -> float:
    """``LidarOdometry.timing["prep"]`` a sweep, in ms."""
    return lo.timing["prep"] / max(lo.timing["sweeps"], 1) * 1e3


def phase_native(dev, main_traj, main_events, main_lo, main_seq):
    """(h): the main sequence on the C++ host feeder (within NATIVE_TOL of the
    main path's poses, ATE < 20 mm), then the native run checkpointed
    after 8 sweeps and resumed on that feeder (bit-equal to the
    uninterrupted native run). Returns the native frontend (its state on the
    card)."""
    import os
    import tempfile

    import numpy as np

    from wildcat_slam_tpu_torch import cli
    from wildcat_slam_tpu_torch.config import WildcatConfig
    from wildcat_slam_tpu_torch.io import native
    from wildcat_slam_tpu_torch.io.synthetic import ate_rmse
    from wildcat_slam_tpu_torch.odometry import checkpoint
    from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry

    t0 = time.perf_counter()
    so = native.build()
    print(f"paths (h) native feeder: {so.name} built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def run():
        lo = LidarOdometry(WildcatConfig(), device=dev, use_native=True)
        cli.feed_events(lo, main_events)
        return lo

    lo, counts = _counted("native", run)
    gap = _traj_gap(lo.trajectory, main_traj)
    ate = ate_rmse(lo.trajectory, lambda t: main_seq.gt_pose(t)[0], align=False)
    med = [float(np.median(np.asarray(x.sweep_seconds[1:]) * 1e3)) for x in (main_lo, lo)]
    print(f"paths (h) native feeder: {lo.sweep_id} sweeps, largest gap to the main path's "
          f"positions and quaternions {gap:.3e} (bound {NATIVE_TOL:g}), ATE {ate * 1e3:.3f} mm unaligned (< 20 mm); "
          f"prep ms a sweep (timing['prep']): numpy {_prep_ms(main_lo):.3f}, native "
          f"{_prep_ms(lo):.3f}; per-sweep median after the first: numpy {med[0]:.2f}, native "
          f"{med[1]:.2f} ms; launches {counts}", flush=True)
    if not (lo.use_native and lo.sweep_id == len(main_traj) and gap <= NATIVE_TOL and ate < 0.02):
        raise AssertionError(f"the native feeder's run failed: gap {gap}, ATE {ate}")

    with tempfile.TemporaryDirectory() as tmp:
        def round_trip():
            lo1 = LidarOdometry(WildcatConfig(), device=dev, use_native=True)
            n = cli.feed_events(lo1, main_events, until_sweep=8)
            path = os.path.join(tmp, "native.npz")
            checkpoint.save(path, lo1)
            lo2 = checkpoint.load(path, device=dev)  # the feeder the file names
            cli.feed_events(lo2, main_events[n:])
            return lo2

        resumed, counts = _counted("native checkpoint", round_trip)
    same = _same_trajectory(resumed.trajectory, lo.trajectory)
    print(f"paths (h) native checkpoint after 8 sweeps, resumed on the native feeder: "
          f"{resumed.use_native}; {resumed.sweep_id} sweeps, trajectory equal to the "
          f"uninterrupted native run bit for bit: {same}; launches {counts}", flush=True)
    if not (resumed.use_native and same):
        raise AssertionError("the resumed native run left the uninterrupted one")
    return lo


def phase_viewer(dev, lo) -> None:
    """(i): cli --synthetic 4 --native with --snapshot-every 2, --surfels-out,
    --traj-out and --viewer-port 0 (numbered PLYs that parse, a TUM line a
    sweep), then a LiveViewer fed by cli.publish from ``lo``, a run on the
    card: /state holds its last pose and its surfels."""
    import contextlib
    import io
    import json
    import os
    import tempfile
    import urllib.request

    import numpy as np

    from wildcat_slam_tpu_torch import cli
    from wildcat_slam_tpu_torch.viz.live import LiveViewer

    with tempfile.TemporaryDirectory() as tmp:
        s_ply, t_txt = os.path.join(tmp, "S.ply"), os.path.join(tmp, "T.txt")
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc, counts = _counted("cli snapshots", lambda: cli.main([
                "--synthetic", "4", "--native", "--snapshot-every", "2", "--surfels-out", s_ply,
                "--traj-out", t_txt, "--viewer-port", "0", "--device", "cuda"]))
        text = err.getvalue()
        m = re.search(r"(\d+) sweeps in", text)
        n = int(m.group(1)) if m else 0
        snaps = sorted(f for f in os.listdir(tmp) if re.fullmatch(r"S_\d{6}\.ply", f))
        plys = {f: _read_ply(os.path.join(tmp, f)) for f in snaps + ["S.ply"]}
        traj = np.loadtxt(t_txt)
        print(f"paths (i) cli --synthetic 4 --native --snapshot-every 2 --viewer-port 0: {n} "
              f"sweeps, snapshots {snaps} with {[plys[f]['vertex'] for f in snaps]} vertices, "
              f"final PLY {plys['S.ply']['vertex']} vertices, TUM {traj.shape[0]} lines; "
              f"launches {counts}", flush=True)
        if not (rc == 0 and n >= 7 and snaps == [f"S_{k:06d}.ply" for k in range(2, n + 1, 2)]
                and all(p["vertex"] > 0 for p in plys.values()) and traj.shape == (n, 8)
                and "live viewer: http://localhost:" in text):
            raise AssertionError("cli snapshots and viewer failed:\n" + text)

    viewer = LiveViewer(port=0)
    try:
        cli.publish(viewer, lo, surfels_every=1)
        with urllib.request.urlopen(f"http://127.0.0.1:{viewer.port}/state", timeout=10) as r:
            st = json.loads(r.read())
    finally:
        viewer.close()
    t, pos, _ = lo.trajectory[-1]
    ok = (st["sweep"] == lo.sweep_id and st["t"] == t
          and np.allclose(st["pose"], pos, rtol=0, atol=1e-4) and len(st["surfels"]["c"]) > 0)
    print(f"paths (i) LiveViewer fed from the native run on the card: /state sweep {st['sweep']}, "
          f"pose {st['pose']} (last pose {np.round(pos, 4).tolist()}), "
          f"{len(st['surfels']['c'])} surfels", flush=True)
    if not ok:
        raise AssertionError(f"the viewer's state is not the run's: {st['sweep']}, {st['pose']}")


def phase_regimes(dev) -> None:
    """(j): tests/test_regimes.py's sequences at its _small_cfg, each held to
    that test's bound (a value over it fails the script): fast rotation
    (numpy and native feeder), world offset, ramp travel, the ramp corridor
    with doors and the bare ramp."""
    import numpy as np

    from wildcat_slam_tpu_torch import cli
    from wildcat_slam_tpu_torch.config import WildcatConfig
    from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence, ate_rmse
    from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry

    failed = []

    def run(label, seq_kw, bound, measure, use_native=False, **cfg_kw):
        seq = SyntheticSequence(points_per_scan=3000, seed=0, **seq_kw)
        events = list(cli.synthetic_events(seq))
        lo = LidarOdometry(WildcatConfig(**{**REGIME_CFG, **cfg_kw}), device=dev,
                           use_native=use_native)
        _, counts = _counted(label, lambda: cli.feed_events(lo, events))
        value, ok, extra = measure(lo, seq)
        ok = ok and value < bound and lo.sweep_id >= 3
        print(f"regimes (j) {label}: {value:.6f} (bound {bound:g}){extra}; {lo.sweep_id} sweeps, "
              f"launches {counts}{'' if ok else ' -- FAILED'}", flush=True)
        if not ok:
            failed.append(label)

    def ate(align):
        def measure(lo, seq):
            return ate_rmse(lo.trajectory, lambda t: seq.gt_pose(t)[0], align=align), True, ""
        return measure

    def end_error(lo, seq):
        t_end, p_end, _ = lo.trajectory[-1]
        gt_end = seq.gt_pose(t_end)[0]
        return (float(np.linalg.norm(p_end - gt_end)), gt_end[0] > 3.0,
                f", ground truth travelled to x = {gt_end[0]:.3f} m (> 3)")

    def finite_ate(lo, seq):
        err, _, _ = ate(False)(lo, seq)
        finite = all(np.isfinite(s["final_cost"]) for s in lo.stats)
        return err, finite, f", every final_cost finite: {finite}"

    def perpendicular(lo, seq):
        d = np.array([1.0, 0.0, 0.15])
        d /= np.linalg.norm(d)
        errs = [np.asarray(p) - seq.gt_pose(t)[0] for t, p, _ in lo.trajectory]
        return max(float(np.linalg.norm(e - (e @ d) * d)) for e in errs), True, ""

    fast = dict(duration=2.5, room_half=4.0, rot_scale=3.0)
    run("fast rotation, ATE unaligned (m)", fast, 0.05, ate(False))
    run("fast rotation on the native feeder, ATE unaligned (m)", fast, 0.05, ate(False),
        use_native=True)
    run("world offset (400, -380, 60), ATE aligned (m)",
        dict(duration=2.0, room_half=4.0, origin=(400.0, -380.0, 60.0)), 0.02, ate(True))
    run("ramp travel at 1.5 m/s, end error (m)",
        dict(duration=4.0, room_half=8.0, geometry="ramp", travel=1.5, door_spacing=10.0), 0.1,
        end_error, max_imu_states=1024, max_sample_states=64)
    run("ramp corridor with doors, ATE unaligned (m)",
        dict(duration=2.5, room_half=8.0, geometry="ramp", door_spacing=10.0), 0.08, finite_ate)
    run("bare ramp, largest error perpendicular to the slope (m)",
        dict(duration=2.5, room_half=8.0, geometry="ramp"), 0.03, perpendicular)
    if failed:
        raise AssertionError(f"regimes over their tests/test_regimes.py bounds: {failed}")


def host_costs(dev) -> None:
    """What the host feeder and the live viewer cost on the main sequence
    (shipped config, 8 s room, 12800 points a scan), one run after another
    in one process after a warm-up run. The numpy and the C++ feeder
    alternate (numpy, native, native, numpy): each run's
    ``LidarOdometry.timing["prep"]`` a sweep, the time in its point filter
    (``add_points``) a sweep and its per-sweep median after the first sweep.
    Then the wall time from one sweep's end to the next (the feeding between
    included) without and with a LiveViewer fed by ``cli.publish`` each
    sweep (surfels every 5), alternating off, on, on, off; the median of
    each run, and the time of the ``publish`` calls themselves, with and
    without surfels. Not part of ``main``:

        python3 -c "import runpy, torch;
          runpy.run_path('chip_smoke.py')['host_costs'](torch.device('cuda', 0))"
    """
    import numpy as np
    import torch

    from wildcat_slam_tpu_torch import cli
    from wildcat_slam_tpu_torch.config import WildcatConfig
    from wildcat_slam_tpu_torch.io import native
    from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence
    from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry
    from wildcat_slam_tpu_torch.viz.live import LiveViewer

    print(f"host costs on {_nvidia_smi()}", flush=True)
    native.build()
    events = list(cli.synthetic_events(SyntheticSequence(duration=8.0, points_per_scan=12800,
                                                         room_half=5.0, seed=0)))
    cli.feed_events(LidarOdometry(WildcatConfig(), device=dev), events, until_sweep=2)
    torch.cuda.synchronize(dev)

    for use_native in (False, True, True, False):
        lo = LidarOdometry(WildcatConfig(), device=dev, use_native=use_native)
        add_points, filter_s = lo.points.add_points, [0.0]

        def timed(times, pts, add_points=add_points, filter_s=filter_s):
            t0 = time.perf_counter()
            kept = add_points(times, pts)
            filter_s[0] += time.perf_counter() - t0
            return kept

        lo.points.add_points = timed
        cli.feed_events(lo, events)
        print(f"host costs, {'native' if use_native else 'numpy '} feeder: {lo.sweep_id} sweeps, "
              f"prep {_prep_ms(lo):.4f} ms a sweep, point filter "
              f"{filter_s[0] / lo.sweep_id * 1e3:.4f} ms a sweep, per-sweep median after the "
              f"first {np.median(np.asarray(lo.sweep_seconds[1:]) * 1e3):.2f} ms", flush=True)

    for on in (False, True, True, False):
        viewer = LiveViewer(port=0) if on else None
        lo = LidarOdometry(WildcatConfig(), device=dev)
        ends, publish_ms = [], {False: [], True: []}  # keyed by: surfels sent
        try:
            for ev in events:
                before = lo.sweep_id
                (lo.add_imu if ev[0] == "imu" else lo.add_scan)(*ev[1:])
                if lo.sweep_id > before:
                    if viewer is not None:
                        t0 = time.perf_counter()
                        cli.publish(viewer, lo, surfels_every=5)
                        publish_ms[lo.sweep_id % 5 == 0].append((time.perf_counter() - t0) * 1e3)
                    ends.append(time.perf_counter())
        finally:
            if viewer is not None:
                viewer.close()
        ms = np.diff(ends) * 1e3
        calls = (f"; publish: pose only median {np.median(publish_ms[False]):.3f} ms over "
                 f"{len(publish_ms[False])} calls, with surfels "
                 f"{np.round(publish_ms[True], 3).tolist()} ms" if on else "")
        print(f"host costs, viewer {'on ' if on else 'off'}: {lo.sweep_id} sweeps, sweep end to "
              f"sweep end median {np.median(ms):.2f} ms, p90 {np.percentile(ms, 90):.2f} ms; on "
              f"the sweeps whose surfels went to the viewer: {np.round(ms[3::5], 2).tolist()}"
              f"{calls}", flush=True)


def phase_bench() -> None:
    """(m): the port's benchmark, benchmarks_torch/bench.py, once per cell of
    BENCHMARK.json with one repeat, each in a process of its own on card 0
    (as every phase): its last line parses, the cell is correct,
    and every metric the cell names is in it and not null."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        cells = json.load(f)["workloads"]
    for cell in cells:
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, os.path.join("benchmarks_torch", "bench.py"),
                              "--workload", cell["name"], "--repeats", "1"], cwd=root,
                             capture_output=True, text=True, timeout=600)
        lines = res.stdout.strip().splitlines()
        line = json.loads(lines[-1]) if res.returncode == 0 and lines else {}
        names = [m["name"] for key in ("metrics", "reported", "layer_metrics") for m in cell[key]]
        missing = [n for n in names if line.get(n) is None]
        shown = {m["name"]: line.get(m["name"]) for m in cell["metrics"]}
        print(f"(m) bench {cell['name']}, one repeat: exit {res.returncode} in "
              f"{time.perf_counter() - t0:.1f} s; correct {line.get('correct')}, checks "
              f"{line.get('checks')}; {shown}; missing or null: {missing}", flush=True)
        if not (line.get("correct") is True and not missing):
            raise AssertionError(f"(m) bench {cell['name']} failed: {res.stderr[-4000:]}")


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
    sass = cuobjdump_sass(so)
    for line in sass_per_pair(sass) + [mxu_tensor_ops(sass), mxu_registers()]:
        print(f"build: {line}", flush=True)
    phase_kernels(dev)
    launches, main_traj, main_events, main_ms, main_lo, main_seq = phase_main(dev)
    recorded, eager_lo = phase_eager(dev, main_lo, main_events)
    kern = phase_replay(recorded)
    wrapper_costs(dev)
    phase_crossover(dev)
    t_paths = time.perf_counter()
    phase_paths(dev, main_traj, main_events, eager_lo)
    t_batch = time.perf_counter()
    phase_batch(dev, main_traj, main_events, eager_lo)
    t_chained = time.perf_counter()
    phase_chained(dev, main_traj, main_events, main_ms, eager_lo)
    t_outputs = time.perf_counter()
    phase_outputs(dev)
    t_native = time.perf_counter()
    native_lo = phase_native(dev, main_traj, main_events, main_lo, main_seq)
    t_viewer = time.perf_counter()
    phase_viewer(dev, native_lo)
    t_regimes = time.perf_counter()
    phase_regimes(dev)
    t_graph = time.perf_counter()
    room = phase_graph(dev)
    t_records = time.perf_counter()
    phase_records(dev, *room)
    t_bench = time.perf_counter()
    phase_bench()
    t_end = time.perf_counter()
    print(f"seconds: build, kernels, main, its eager run and replay {t_paths - t0:.1f}, paths "
          f"(a)-(d) {t_batch - t_paths:.1f}, (e) {t_chained - t_batch:.1f}, (f) "
          f"{t_outputs - t_chained:.1f}, (g) {t_native - t_outputs:.1f}, (h) "
          f"{t_viewer - t_native:.1f}, (i) {t_regimes - t_viewer:.1f}, (j) "
          f"{t_graph - t_regimes:.1f}, (k) {t_records - t_graph:.1f}, (l) "
          f"{t_bench - t_records:.1f}, (m) {t_end - t_bench:.1f}", flush=True)
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
        # no pallas_call: the counterpart of the lax.while_loop at match.py:233
        dict(name="self_match", route="cuda", source="wildcat_slam_tpu_torch/csrc/self_match.cu",
             replaces="wildcat_slam_tpu/odometry/match.py:233", launches=launches["self_match"],
             **kern["self_match"]),
        # no pallas_call: the counterpart of the spline fit's jnp.linalg.solve
        # (the main path's call; also cho_factor/cho_solve at solver.py:421)
        dict(name="spd_solve", route="cuda", source="wildcat_slam_tpu_torch/csrc/spd_solve.cu",
             replaces="wildcat_slam_tpu/odometry/corrections.py:57", launches=launches["spd"],
             **kern["spd"]),
        # no pallas_call: XLA's fusions of imu_residuals, then _imu_banded_normal_eqs
        dict(name="imu_factor", route="cuda",
             source="wildcat_slam_tpu_torch/csrc/imu_factor.cu",
             replaces="wildcat_slam_tpu/odometry/factors.py:468",
             also_replaces="wildcat_slam_tpu/odometry/solver.py:78",
             launches=launches["imu_factor"], **kern["imu_factor"]),
        # no pallas_call: XLA's fusions of surfel_residuals, then _surfel_normal_eqs
        dict(name="surfel_factor", route="cuda",
             source="wildcat_slam_tpu_torch/csrc/surfel_factor.cu",
             replaces="wildcat_slam_tpu/odometry/factors.py:344",
             also_replaces="wildcat_slam_tpu/odometry/solver.py:122",
             launches=launches["surfel_factor"], **kern["surfel_factor"]),
        # no pallas_call: XLA's fusions of extract_surfels (surfel.py:105-336);
        # sort_phases_ms is its sort's share of its time, sort_library_graph_ms
        # the torch.sort calls that share replaces
        dict(name="surfel_extract", route="cuda",
             source="wildcat_slam_tpu_torch/csrc/surfel_extract.cu",
             replaces="wildcat_slam_tpu/odometry/surfel.py:105",
             launches=launches["surfel_extract"], **kern["surfel_extract"]),
    ]
    for r in rows:
        nums = ("launches", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms")
        lib_ok = r["library_ms"] is None if r["name"] in ("self_match", "imu_factor",
                                                          "surfel_extract") else \
            math.isfinite(r["library_ms"])
        if not (r["launches"] > 0 and lib_ok and all(math.isfinite(r[k]) for k in nums)):
            raise AssertionError(f"missing or non-finite measurement: {r}")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
