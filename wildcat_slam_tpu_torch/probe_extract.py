"""Where the time of K7 (``csrc/surfel_extract.cu``) goes on the card, phase
by phase, and how it compares with another checkout's.

    python -m wildcat_slam_tpu_torch.probe_extract [--parent DIR]

K7's cooperative kernel is copied with a globaltimer stamp by each block's
thread 0 at its start, on each arrival at and each departure from a grid
barrier, and at its end, put in by text edits of its source (every
``grid.sync();``), and built with its headers into its own library under
``_build/probe/``. The copy runs through the checkout's own wrapper
(``ops/surfel_extract.extract``) on the main path's inputs (the last
sweep's extraction of chip_smoke's 8 s sequence at the shipped config, run
eagerly) and on ``chip_smoke.k7_dense``, in float32 and float64. Each phase
is named by the last phase comment before the barrier it ends at; its time is
from the last block's departure from that barrier to the last block's
arrival at the next, and the barrier's from that arrival to the last
departure (medians over 21 launches, in us). A phase that a loop runs more
than once (the sort's passes) is listed once a run.

Beside the split it prints, a process a checkout, the checkout's K7 a call
by graph replay (``profile_sweeps.graph_ms``), the same three levels'
packed int64 keys sorted by ``torch.sort(stable=True)`` (the calls the
sort phases replace, which K7 made before it had its own sort: the
yardstick), K7's keys launch alone where the checkout has one (an older
checkout's ``level_keys``), and ptxas's lines for its kernels. With ``--parent DIR`` (another checkout of the
repository, e.g. ``git archive`` of the parent commit unpacked under
``_build/parent``) it runs parent, this, this, parent, and reports whether
every output of each case is ``torch.equal`` across all four runs. Needs a
CUDA card; it exits non-zero without one, or when an output differs.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import runpy
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

_ROOT = Path(__file__).resolve().parents[1]
_BLOCKS, _N = 2048, 160  # stamps: blocks traced, stamps a block
_STAMPS = f"""
__device__ unsigned long long probe_t[{_BLOCKS} * {_N}];
__device__ int probe_c[{_BLOCKS} * {_N}];
// thread 0 of each block: the time and 2 line + (1 on leaving a barrier)
struct ProbeClock {{
  int n;
  __device__ ProbeClock() : n(0) {{}}
  __device__ void operator()(int line, int leave) {{
    if (threadIdx.x == 0 && blockIdx.x < {_BLOCKS} && n < {_N}) {{
      unsigned long long t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      probe_t[blockIdx.x * {_N} + n] = t;
      probe_c[blockIdx.x * {_N} + n] = 2 * line + leave;
      ++n;
    }}
  }}
  __device__ ~ProbeClock() {{ (*this)(0, 1); }}
}};
"""
_READ = f"""
extern "C" int wc_probe_read(unsigned long long* t, int* c) {{
  cudaError_t e = cudaMemcpyFromSymbol(t, probe_t, sizeof(probe_t));
  return (int)(e != cudaSuccess ? e : cudaMemcpyFromSymbol(c, probe_c, sizeof(probe_c)));
}}
extern "C" int wc_probe_clear() {{
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, probe_c);
  return (int)(e != cudaSuccess ? e : cudaMemset(p, 0, sizeof(probe_c)));
}}
"""
_START = "  cg::grid_group grid = cg::this_grid();\n"
_SYNC = "grid.sync();"


def traced(src: str) -> str:
    """K7's source with the stamps put in."""
    for mark in ("namespace cg = cooperative_groups;\n", _START):
        if src.count(mark) != 1:
            raise RuntimeError(f"csrc/surfel_extract.cu no longer has the mark {mark!r}")
    if _SYNC not in src:
        raise RuntimeError("csrc/surfel_extract.cu has no grid barrier")
    src = src.replace("namespace cg = cooperative_groups;\n",
                      "namespace cg = cooperative_groups;\n" + _STAMPS)
    src = src.replace(_START, _START + "  ProbeClock probe_clock;\n  probe_clock(__LINE__, 1);\n")
    src = src.replace(_SYNC, "probe_clock(__LINE__, 0); grid.sync(); probe_clock(__LINE__, 1);")
    return src + _READ


_MARK = re.compile(r"\s*// (([0-9]+[a-z]?|[A-Z]|sort, pass k):.*)")


def labels(src: str) -> dict:
    """line of a barrier in the traced source -> the name of the phase that
    ends there: the last phase comment (``// 2: ...``, ``// sort, pass k:
    ...``) before it; line 0 (the kernel's end): the last one after the last
    barrier."""
    lines = src.splitlines()
    out, name = {}, None
    for i, ln in enumerate(lines):
        m = _MARK.match(ln)
        if m:
            name = m.group(1)[:60]
        if "grid.sync();" in ln:
            out[i + 1] = name
    out[0] = name
    return out


def build_traced(src_dir: Path, out_dir: Path, flags) -> tuple:
    """(the loaded traced copy of ``src_dir``'s K7, its phase names, ptxas's
    lines of its kernels)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in ("lie.cuh", "eigh3.cuh"):
        (out_dir / header).write_text((src_dir / header).read_text())
    text = traced((src_dir / "surfel_extract.cu").read_text())
    cu = out_dir / "surfel_extract_trace.cu"
    cu.write_text(text)
    from wildcat_slam_tpu_torch.ops import _build

    res = subprocess.run([_build._nvcc(), *flags, "-shared", "-o", str(cu.with_suffix(".so")),
                          str(cu)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on the traced copy of K7:\n{res.stderr}")
    lines = res.stderr.splitlines()
    ptx = [f"{lines[i].split('for')[-1].strip()}: {lines[i + 1].strip()}; {lines[i + 2].strip()}"
           for i in range(len(lines) - 2) if "Function properties" in lines[i]]
    lib = _build.declare(ctypes.CDLL(str(cu.with_suffix(".so"))))
    lib.wc_probe_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib, labels(text), ptx


def _launch_stamps(lib, fn) -> tuple:
    """One launch of ``fn`` on the traced library: (codes, times) of the
    blocks that ran, (blocks, stamps)."""
    from wildcat_slam_tpu_torch.ops import _build

    _build.check(lib.wc_probe_clear(), "wc_probe_clear")
    torch.cuda.synchronize()
    fn()
    torch.cuda.synchronize()
    t = np.zeros(_BLOCKS * _N, np.uint64)
    c = np.zeros(_BLOCKS * _N, np.int32)
    _build.check(lib.wc_probe_read(t.ctypes.data, c.ctypes.data), "wc_probe_read")
    t, c = t.reshape(_BLOCKS, _N).astype(np.int64), c.reshape(_BLOCKS, _N)
    ran = c[:, 0] != 0
    return c[ran], t[ran]


def phase_split(lib, names: dict, fn, runs: int = 21) -> list:
    """[(phase name, phase us, barrier us)] of ``fn``'s K7 launch on the
    traced library, medians over ``runs`` launches; the last entry's
    barrier is 0 (the kernel's end)."""
    fn()
    per = []
    for _ in range(runs):
        c, t = _launch_stamps(lib, fn)
        n = int((c != 0).sum(1).min())
        if not (c[:, :n] == c[0, :n]).all():
            raise RuntimeError("K7's blocks passed different barriers")
        last = t[:, :n].max(0)  # the last block's stamp of each event
        # events: start (leave), then (arrive, leave) a barrier, then end
        per.append([(last[k + 1] - last[k], (last[k + 2] - last[k + 1]) if k + 2 < n else 0)
                    for k in range(0, n - 1, 2)])
        codes = c[0, :n]
    med = np.median(np.asarray(per, np.float64), 0) / 1e3
    return [(names.get(int(codes[k + 1]) // 2, f"line {int(codes[k + 1]) // 2}"), float(a),
             float(b)) for k, (a, b) in zip(range(0, len(codes) - 1, 2), med)]


def stamped_split(lib, names: dict, fn) -> list:
    """:func:`phase_split` of ``fn`` (a call of ``surfel_extract.extract``)
    with the kernel library swapped for the traced copy ``lib``."""
    from wildcat_slam_tpu_torch.ops import _build

    real = _build.library
    _build.library = lambda: lib
    try:
        return phase_split(lib, names, fn)
    finally:
        _build.library = real


_SORT = re.compile(r"(K|B|sort, pass k):")


def sort_us(split: list) -> float:
    """The sort phases' share of a split, us (each with its barrier): the
    keys' ranges, the keys and the passes."""
    return sum(a + b for name, a, b in split if name and _SORT.match(name))


def packed_level_keys(pts: torch.Tensor, valid: torch.Tensor, cfg) -> torch.Tensor:
    """(L, P) int64: each level's packed voxel key (hi 2^31 + lo, as
    ``extract_plain`` sorts it; the invalid points' pinned) by PyTorch
    operations: the input of the yardstick sorts."""
    from wildcat_slam_tpu_torch.ops import voxel

    big = 2**31 - 1
    keys = []
    for level in range(cfg.max_voxel_depth + 1):
        hi, lo = voxel.split_keys(torch.floor(pts / (cfg.voxel_size / 2.0**level)).to(torch.int32))
        keys.append(torch.where(valid, hi, big).to(torch.int64) * (1 << 31)
                    + torch.where(valid, lo, big).to(torch.int64))
    return torch.stack(keys)


def main_path_inputs(dev, cs) -> tuple:
    """The last sweep's extraction inputs of chip_smoke's 8 s sequence at the
    shipped config, run eagerly: (pts, t, valid, cfg)."""
    from wildcat_slam_tpu_torch.cli import synthetic_events
    from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence
    from wildcat_slam_tpu_torch.odometry import pipeline

    seq = SyntheticSequence(duration=8.0, points_per_scan=12800, room_half=5.0, seed=0)
    lo = cs["_eager_frontend"](dev)
    rec = {}
    real = pipeline.extract_surfels

    def record(pts, t, valid, cfg):
        rec["k7"] = (pts.clone(), t.clone(), valid.clone(), cfg)
        return real(pts, t, valid, cfg)

    pipeline.extract_surfels = record
    try:
        cs["_eager_feed"](lo, list(synthetic_events(seq)))
    finally:
        pipeline.extract_surfels = real
    return rec["k7"]


def cases(dev, cs) -> dict:
    """name -> (pts, t, valid, cfg) on the host: the main path's inputs and
    k7_dense, in float32 and float64."""
    pts, t, valid, cfg = main_path_inputs(dev, cs)
    dp, dt, dv, dcfg = cs["k7_dense"]()
    out = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        out[f"main-path {name}"] = (pts.cpu().to(dtype), t.cpu().to(dtype), valid.cpu(), cfg)
        out[f"dense {name}"] = (torch.as_tensor(dp, dtype=dtype), torch.as_tensor(dt, dtype=dtype),
                                torch.as_tensor(dv), dcfg)
    return out


def worker(inputs: str, out: str) -> None:
    """Run by :func:`main` in a process whose ``sys.path`` starts with the
    checkout under test: its traced K7 on every case (the split), then its
    K7, its keys launch where it has one and the yardstick sorts, by graph
    replay, and K7's outputs."""
    from wildcat_slam_tpu_torch.ops import _build
    from wildcat_slam_tpu_torch.ops import surfel_extract as se
    from wildcat_slam_tpu_torch.profile_sweeps import graph_ms

    dev = torch.device("cuda", 0)
    data = torch.load(inputs, weights_only=False)
    lib, names, ptx = build_traced(_build.SRC_DIR, _build.BUILD_DIR / "probe",
                                   _build.flags("surfel_extract.cu"))
    res = {"ptxas": ptx, "split": {}, "times": {}, "got": {}}
    for name, (pts, t, valid, cfg) in data.items():
        x, y, v = pts.to(dev), t.to(dev), valid.to(dev)
        fn = lambda: se.extract(x, y, v, cfg)
        res["split"][name] = stamped_split(lib, names, fn)
        res["got"][name] = {k: w.cpu() for k, w in fn().items()}
        keys = packed_level_keys(x, v, cfg)
        times = {"K7": graph_ms(fn),
                 "torch.sort": graph_ms(lambda: [torch.sort(k, stable=True) for k in keys])}
        if hasattr(se, "level_keys"):
            times["keys launch"] = graph_ms(lambda: se.level_keys(x, v, cfg))
        res["times"][name] = times
    torch.cuda.synchronize()
    torch.save(res, out)


def _report(k: int, label: str, seconds: float, r: dict) -> None:
    print(f"run {k} ({label}, {seconds:.0f} s); ptxas: {' | '.join(r['ptxas'])}", flush=True)
    for name, split in r["split"].items():
        times = ", ".join(f"{a} {b:.4f} ms" for a, b in r["times"][name].items())
        total = sum(a + b for _, a, b in split)
        print(f"  {name}: {times}; stamps {total:.1f} us, the sort phases {sort_us(split):.1f}: "
              + "; ".join(f"[{p}] {a:.1f} + {b:.1f}" for p, a, b in split), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout to compare with (its repository root)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_extract: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print("card:", torch.cuda.get_device_name(0), flush=True)
    cs = runpy.run_path(str(_ROOT / "chip_smoke.py"))
    work = _ROOT / "wildcat_slam_tpu_torch" / "_build" / "probe"
    work.mkdir(parents=True, exist_ok=True)
    inputs = work / "k7_cases.pt"
    torch.save(cases(dev, cs), inputs)
    torch.cuda.empty_cache()
    roots = [_ROOT] if args.parent is None else [args.parent.resolve(), _ROOT, _ROOT,
                                                 args.parent.resolve()]
    runs = []
    for k, root in enumerate(roots):
        out = work / f"k7_run{k}.pt"
        code = ("import runpy, sys; sys.path.insert(0, sys.argv[1]); "
                "runpy.run_path(sys.argv[2], run_name='probe_worker')['worker'](sys.argv[3], "
                "sys.argv[4])")
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", code, str(root), __file__, str(inputs),
                              str(out)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"the run of {root} failed:\n{res.stderr[-4000:]}")
        runs.append(torch.load(out, weights_only=False))
        label = "this" if root == _ROOT else "parent"
        _report(k, label, time.perf_counter() - t0, runs[-1])
    ok = True
    for name in runs[0]["got"]:
        got = [r["got"][name] for r in runs]
        same = {key: all(torch.equal(torch.nan_to_num(got[0][key]), torch.nan_to_num(g[key]))
                         for g in got[1:]) for key in got[0]}
        ok &= all(same.values())
        print(f"bit-equal, {name} ({len(runs)} runs): "
              + ", ".join(f"{k} {v}" for k, v in same.items()), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
