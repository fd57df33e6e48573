"""Where the time of K5 (``csrc/imu_factor.cu``) and K6
(``csrc/surfel_factor.cu``) goes on the card, phase by phase, and how they
compare with another checkout's.

    python -m wildcat_slam_tpu_torch.probe_factors [--parent DIR]

Each kernel is copied with a globaltimer stamp by each block's thread 0 at
its start and at each phase boundary, put in by text edits of its source,
and built with ``csrc/lie.cuh`` beside it into its own library under
``_build/probe/`` (K5: the factors evaluated, their bands formed, phase 0
done (the kept factors listed by base: the counting pass), the first
barrier passed, the bases' chains done, the second barrier passed, the
bands read off; K6: the factors evaluated (thread 0's), the segment's keys
written, sorted, phase 0 done (the pieces and offsets: the counting pass),
the first barrier passed, the rows' counts summed over the segments, the
rows' lists placed, the pairs' totals (the scan and placement), the second barrier
passed, the flat pass over the empty pairs done, the block's first warp
past its chunk items, all items done (chunks and pairs), the third barrier
passed, the rows' bands done). One normal-mode launch on
``chip_smoke.factor_problem`` at the main path's sizes (S=96, M=16384 of
which 8192 binary, Mi=1536) with 75 live states, the factors' sides spread
over all of them (``spread``) or every factor's side 2 in the newest six
states (``newest``: a sweep's new surfels are the queries of its matches;
K5 has no such layout), in float32 and float64; for each stamp the probe
prints when the first and the last block reached it, in us from the
earliest start, and ptxas's lines for the normal-mode kernels.

With ``--parent DIR`` (another checkout of the repository, e.g. ``git
archive`` of the parent commit unpacked under ``_build/parent``) it then
runs both checkouts' wrappers in turns (parent, this, this, parent; a
process each, each building its own kernels) on the same inputs: the four
problems above and the main path's inputs (the first normal equations of
the last sweep of chip_smoke's 8 s sequence, run eagerly), in float32 and,
cast, in float64. It prints each run's graph-replay and back-to-back times
of both normal modes and whether every output of both modes (K5's bands, g
and residuals; K6's H, g and residuals) is ``torch.equal`` between the two
checkouts and between the runs of each. Needs a CUDA card; it exits
non-zero without one, or when an output differs.
"""

from __future__ import annotations

import argparse
import ctypes
import runpy
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from wildcat_slam_tpu_torch.ops import _build, imu_factor, surfel_factor

_ROOT = Path(__file__).resolve().parents[1]
_NSTAMP = 16
_STAMPS = """
__device__ unsigned long long probe_stamps[4096 * 16];
__device__ __forceinline__ void probe_stamp(int k) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    probe_stamps[blockIdx.x * 16 + k] = t;
  }
}
"""
_READ = """
extern "C" int wc_probe_stamps(unsigned long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, probe_stamps, n * sizeof(unsigned long long));
}
"""


def _after(mark: str, stamp: int) -> tuple:
    return mark, f"{mark}  probe_stamp({stamp});\n"


# kernel: [(mark, replacement)] that put the stamps in
TRACE = {
    "imu_factor.cu": [
        ("namespace cg = cooperative_groups;\n", "namespace cg = cooperative_groups;\n" + _STAMPS),
        _after("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, "
               "s_cap = a.s_cap;\n", 0),
        _after("                                        meta + tid * kMeta);\n"
               "      __syncthreads();\n", 1),
        _after("      if (lane == 0) masks[warp] = (int)keep;\n      __syncthreads();\n", 2),
        ("  cg::this_grid().sync();\n\n  // phase 1:",
         "  probe_stamp(3);\n  cg::this_grid().sync();\n  probe_stamp(4);\n\n  // phase 1:"),
        ("  cg::this_grid().sync();\n\n  // phase 2:",
         "  probe_stamp(5);\n  cg::this_grid().sync();\n  probe_stamp(6);\n\n  // phase 2:"),
        ("      }\n    }\n  }\n}\n\n// The normal-mode block's dynamic shared memory",
         "      }\n    }\n  }\n  probe_stamp(7);\n}\n\n// The normal-mode block's dynamic shared "
         "memory"),
    ],
    "surfel_factor.cu": [
        ("namespace cg = cooperative_groups;\n", "namespace cg = cooperative_groups;\n" + _STAMPS),
        _after("  cg::grid_group grid = cg::this_grid();\n", 0),
        _after("      surfel_eval_side(a, me, side, scor, ncor, live ? work + (size_t)m * kRec : "
               "nullptr);\n", 1),
        ("      __syncthreads();\n      wc::block_sort<",
         "      __syncthreads();\n      probe_stamp(2);\n      wc::block_sort<"),
        _after("      wc::block_sort<kKeys / (2 * kThreads)>(keys);\n", 3),
        ("  grid.sync();\n\n  // phase 1:",
         "  probe_stamp(4);\n  grid.sync();\n  probe_stamp(5);\n\n  // phase 1:"),
        _after("      column_sums(w.rcnt, s_cap, true, nseg, 0, s_cap, g, stot, spre, "
               "partial);\n", 6),
        _after("      __syncthreads();  // the arrays are rewritten by the block's next segment\n"
               "    }\n", 7),
        ("  grid.sync();\n\n  // phase 2:",
         "  probe_stamp(8);\n  grid.sync();\n  probe_stamp(9);\n\n  // phase 2:"),
        ("    // a warp's slot: kS records, each factor's coefficients, flags, index\n",
         "    probe_stamp(10);\n"
         "    // a warp's slot: kS records, each factor's coefficients, flags, index\n"),
        ("        const int q = it - nch;\n",  # the warp's first pair item: its chunks done
         "        const int q = it - nch;\n        if (it < nch + warps) probe_stamp(11);\n"),
        ("  grid.sync();\n\n  // phase 3:",
         "  probe_stamp(12);\n  grid.sync();\n  probe_stamp(13);\n\n  // phase 3:"),
        ("      __syncthreads();  // sv is rewritten by the block's next item\n    }\n  }\n}\n",
         "      __syncthreads();  // sv is rewritten by the block's next item\n    }\n  }\n"
         "  probe_stamp(14);\n}\n"),
    ],
}
STAMPS = {"imu_factor.cu": ("start", "evaluated", "bands", "counted", "barrier 1", "chains",
                            "barrier 2", "read off"),
          "surfel_factor.cu": ("start", "evaluated", "keyed", "sorted", "counted", "barrier 1",
                               "rows summed", "rows placed", "placed", "barrier 2", "zero fill",
                               "chunks", "items", "barrier 3", "phase 3")}


def traced(name: str) -> str:
    """The kernel's source with the stamps put in."""
    src = (_build.SRC_DIR / name).read_text()
    for mark, replacement in TRACE[name]:
        if src.count(mark) != 1:
            raise RuntimeError(f"csrc/{name} no longer has the mark {mark!r} of a stamp")
        src = src.replace(mark, replacement)
    return src + _READ


def stamps(lib, name: str, fn) -> str:
    """One launch of ``fn`` on the trace variant ``lib``: when the first and
    the last block reached each stamp, us from the earliest start."""
    fn()  # the first launch's stamps are overwritten, or older than the second's start
    torch.cuda.synchronize()
    host = (ctypes.c_ulonglong * (4096 * _NSTAMP))()
    lib.wc_probe_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn()
    torch.cuda.synchronize()
    _build.check(lib.wc_probe_stamps(host, 4096 * _NSTAMP), "wc_probe_stamps")
    t = np.frombuffer(host, dtype=np.uint64).reshape(4096, _NSTAMP).astype(np.int64)
    names = STAMPS[name]
    t = t[t[:, 0] > 0][:, :len(names)]
    t = t[t[:, 0] >= t[:, 0].max() - 200_000]  # this launch's blocks: started within 0.2 ms
    t0 = t[:, 0].min()
    parts = []
    for i, k in enumerate(names):
        col = t[:, i][t[:, i] >= t0]  # blocks that reached the stamp in this launch
        parts.append(f"{k} {(col.min() - t0) / 1e3:.1f}-{(col.max() - t0) / 1e3:.1f}"
                     if len(col) else f"{k} -")
    return ", ".join(parts) + f" us ({len(t)} blocks)"


def build(name: str) -> tuple:
    """(the loaded traced copy of ``name``, ptxas's lines of its normal-mode
    kernels)."""
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in _build.HEADERS:
        (out_dir / header).write_text((_build.SRC_DIR / header).read_text())
    cu = out_dir / f"{Path(name).stem}_trace.cu"
    cu.write_text(traced(name))
    res = subprocess.run([_build._nvcc(), *_build.flags(name), "-shared", "-o",
                          str(cu.with_suffix(".so")), str(cu)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on the traced copy of {name}:\n{res.stderr}")
    lines = res.stderr.splitlines()
    ptx = [f"{'f32' if 'IfE' in lines[i] else 'f64'}: {lines[i + 1].strip()}; "
           f"{lines[i + 2].strip()}" for i in range(len(lines) - 2)
           if "Function properties" in lines[i] and "_normal" in lines[i]]
    return _build.declare(ctypes.CDLL(str(cu.with_suffix(".so")))), ptx


def problems(dev) -> tuple:
    """{(layout, dtype): (sfac, ifac, cor, grav, fm, nb)} at the main path's
    sizes, and chip_smoke's namespace."""
    cs = runpy.run_path(str(_ROOT / "chip_smoke.py"))
    out = {}
    for dtype in (torch.float32, torch.float64):
        for layout in ("spread", "newest"):
            p = cs["factor_problem"](dev, dtype, count=75, seed=7)
            if layout == "newest":
                sfac = p[0]
                rng = np.random.default_rng(8)
                i2l = torch.as_tensor(rng.integers(68, 74, sfac.i2l.shape[0]), device=dev)
                p = (sfac.replace(i2l=i2l, i2r=i2l + 1),) + p[1:]
            out[(layout, str(dtype)[6:])] = p
    return out, cs


def trace(dev, probs, cs) -> None:
    w, dt, a2 = cs["FACTOR_WEIGHTS"], cs["FACTOR_DT"], cs["FACTOR_A2"]
    real = _build.library
    for name in ("imu_factor.cu", "surfel_factor.cu"):
        lib, ptx = build(name)
        _build.library = lambda: lib
        try:
            times = []
            for (layout, dtype), (sfac, ifac, cor, grav, fm, nb) in probs.items():
                if name == "imu_factor.cu":
                    if layout != "spread":
                        continue
                    fn = lambda i=ifac, c=cor, g=grav: imu_factor.normal_eqs(i, c, w, dt, g)
                else:
                    s_cap = cor.shape[0]  # the IMU part's values do not move the time
                    bands = torch.zeros((5, s_cap, 12, 12), dtype=cor.dtype, device=dev)
                    gi = torch.zeros(12 * s_cap, dtype=cor.dtype, device=dev)
                    fn = lambda s=sfac, c=cor, b=bands, g=gi, f=fm, n=nb: \
                        surfel_factor.normal_eqs(s, c, a2, b, g, f, n)
                times.append(f"{layout} {dtype}: {stamps(lib, name, fn)}")
        finally:
            _build.library = real
        print(f"{name} trace: {'; '.join(times)}; ptxas {' | '.join(ptx)}", flush=True)


def main_path_inputs(dev, cs) -> tuple:
    """The first normal equations' inputs of the last sweep of chip_smoke's
    8 s sequence at the shipped config, run eagerly: (K5's, K6's)."""
    from wildcat_slam_tpu_torch.cli import synthetic_events
    from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence
    from wildcat_slam_tpu_torch.odometry import solver

    seq = SyntheticSequence(duration=8.0, points_per_scan=12800, room_half=5.0, seed=0)
    lo = cs["_eager_frontend"](dev)
    rec = {}
    real_k5, real_k6 = solver._imu_banded_normal_eqs, solver._surfel_normal_eqs
    copy = lambda x: x.map(lambda t: t.clone()) if hasattr(x, "map") else (
        x.clone() if isinstance(x, torch.Tensor) else x)

    def k5(*args):
        if rec.get("k5") != lo.sweep_id:
            rec["k5"], rec["imu"] = lo.sweep_id, tuple(map(copy, args))
        return real_k5(*args)

    def k6(*args):
        if rec.get("k6") != lo.sweep_id:
            rec["k6"], rec["surfel"] = lo.sweep_id, tuple(map(copy, args[:8]))
        return real_k6(*args)

    solver._imu_banded_normal_eqs, solver._surfel_normal_eqs = k5, k6
    try:
        cs["_eager_feed"](lo, list(synthetic_events(seq)))
    finally:
        solver._imu_banded_normal_eqs, solver._surfel_normal_eqs = real_k5, real_k6
    return rec["imu"], rec["surfel"]


def _fields(fac) -> dict:
    return {k: v.cpu() for k, v in fac.fields().items()}


def _cases(dev, probs, cs) -> dict:
    """The comparison's inputs, on the host: name -> dict of K5's and K6's
    arguments (factor structs as dicts of tensors)."""
    w, dt, a2 = cs["FACTOR_WEIGHTS"], cs["FACTOR_DT"], cs["FACTOR_A2"]
    from wildcat_slam_tpu_torch.odometry import solver

    cases = {}
    for (layout, dtype), (sfac, ifac, cor, grav, fm, nb) in probs.items():
        bands, gi = solver.imu_banded_normal_eqs_plain(ifac, cor, w, dt, grav, cor.shape[0])
        cases[f"{layout} {dtype}"] = dict(
            ifac=_fields(ifac), cor=cor.cpu(), weights=w, dt=dt, grav=grav.cpu(),
            sfac=_fields(sfac), cor6=cor.cpu(), a2=a2, bands=bands.cpu(), gi=gi.cpu(),
            fm=fm.cpu(), nb=nb)
    (ifac, cor, weights, dt, grav, _), (sfac, cor6, a2, bands, gi, fm, _, nb) = \
        main_path_inputs(dev, cs)
    for dtype in (torch.float32, torch.float64):
        cast = lambda t: t.to(dtype) if t.is_floating_point() else t
        cases[f"main-path {str(dtype)[6:]}"] = dict(
            ifac={k: cast(v) for k, v in _fields(ifac).items()}, cor=cast(cor.cpu()),
            weights=weights, dt=dt, grav=cast(grav.cpu()),
            sfac={k: cast(v) for k, v in _fields(sfac).items()}, cor6=cast(cor6.cpu()), a2=a2,
            bands=cast(bands.cpu()), gi=cast(gi.cpu()), fm=cast(fm.cpu()), nb=nb)
    return cases


TIMED = ("spread float32", "newest float32", "main-path float32")


def worker(inputs: str, out: str) -> None:
    """Run by :func:`compare` in a process whose ``sys.path`` starts with
    the checkout under test: that checkout's wrappers on every case (both
    modes, twice), and the graph-replay and back-to-back times of the normal
    modes on the TIMED cases."""
    from wildcat_slam_tpu_torch.odometry.factors import ImuFactors, SurfelFactors
    from wildcat_slam_tpu_torch.profile_sweeps import graph_ms

    dev = torch.device("cuda", 0)
    cases = torch.load(inputs, weights_only=False)
    got, times = {}, {}
    for name, c in cases.items():
        d = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v) for k, v in c.items()}
        ifac = ImuFactors(**{k: v.to(dev) for k, v in c["ifac"].items()})
        sfac = SurfelFactors(**{k: v.to(dev) for k, v in c["sfac"].items()})
        k5 = lambda: imu_factor.normal_eqs(ifac, d["cor"], d["weights"], d["dt"], d["grav"])
        k6 = lambda: surfel_factor.normal_eqs(sfac, d["cor6"], d["a2"], d["bands"], d["gi"],
                                              d["fm"], d["nb"])
        for rep in range(2):
            for key, val in (("k5 bands", k5()[0]), ("k5 g", k5()[1]),
                             ("k5 r", imu_factor.residuals(ifac, d["cor"], d["weights"], d["dt"],
                                                           d["grav"])),
                             ("k6 H", k6()[0]), ("k6 g", k6()[1]),
                             ("k6 r", surfel_factor.residuals(sfac, d["cor6"]))):
                got[(name, key, rep)] = val.cpu()
        if name in TIMED:
            times[name] = {k: (graph_ms(fn), _device_ms(fn)) for k, fn in (("K5", k5), ("K6", k6))}
    torch.cuda.synchronize()
    torch.save({"got": got, "times": times}, out)


def _device_ms(fn, reps: int = 20, runs: int = 5) -> float:
    """CUDA events around ``reps`` back-to-back calls, per call, median of
    ``runs``."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return float(np.median(out))


def compare(dev, probs, cs, parent: Path) -> bool:
    """Both checkouts' wrappers in turns (parent, this, this, parent) on the
    same inputs; prints their times and whether every output is equal."""
    work = _build.BUILD_DIR / "probe"
    work.mkdir(parents=True, exist_ok=True)
    inputs = work / "factor_cases.pt"
    torch.save(_cases(dev, probs, cs), inputs)
    torch.cuda.empty_cache()
    runs = []
    for k, root in enumerate((parent, _ROOT, _ROOT, parent)):
        out = work / f"factor_run{k}.pt"
        code = ("import runpy, sys; sys.path.insert(0, sys.argv[1]); "
                "runpy.run_path(sys.argv[2], run_name='probe_worker')['worker'](sys.argv[3], "
                "sys.argv[4])")
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", code, str(root), __file__, str(inputs),
                              str(out)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"the run of {root} failed:\n{res.stderr[-4000:]}")
        runs.append(torch.load(out, weights_only=False))
        label = "parent" if root == parent else "this"
        print(f"run {k} ({label}, {time.perf_counter() - t0:.0f} s): " + "; ".join(
            f"{name}: " + ", ".join(f"{kern} graph {g:.4f} ms, back to back {b:.4f} ms"
                                    for kern, (g, b) in t.items())
            for name, t in runs[-1]["times"].items()), flush=True)
    ok = True
    for name in sorted({key[0] for key in runs[0]["got"]}):
        same = {}
        for key in ("k5 bands", "k5 g", "k5 r", "k6 H", "k6 g", "k6 r"):
            vals = [r["got"][(name, key, rep)] for r in runs for rep in (0, 1)]
            same[key] = all(torch.equal(vals[0], v) for v in vals[1:])
        ok &= all(same.values())
        print(f"bit-equal, {name} (both checkouts, each run twice): "
              + ", ".join(f"{k} {v}" for k, v in same.items()), flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout to compare with (its repository root)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_factors: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    probs, cs = problems(dev)
    trace(dev, probs, cs)
    if args.parent is not None and not compare(dev, probs, cs, args.parent.resolve()):
        print("probe_factors: the two checkouts' outputs differ", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
