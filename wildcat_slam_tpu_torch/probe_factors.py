"""Where the time of K5 (``csrc/imu_factor.cu``) and K6
(``csrc/surfel_factor.cu``) goes on the card, phase by phase.

    python -m wildcat_slam_tpu_torch.probe_factors

Each kernel is copied with a globaltimer stamp by each block's thread 0 at
its start and at each phase boundary (K5: phase 1 done, the barrier passed,
phase 2 done; K6: the factors evaluated, the lists built, the first barrier
passed, phase 2 done, the second barrier passed, phase 3 done), put in by
text edits of its source, and built with ``csrc/lie.cuh`` beside it into
its own library under ``_build/probe/``. One normal-mode launch on
``chip_smoke.factor_problem`` at the main path's sizes (S=96, M=16384 of
which 8192 binary, Mi=1536) with 75 live states, the factors' sides spread
over all of them (``spread``) or every factor's side 2 in the newest six
states (``newest``: a sweep's new surfels are the queries of its matches),
in float32 and float64; for each stamp the probe prints when the first and
the last block reached it, in us from the earliest start, and ptxas's lines
for the normal-mode kernels. Needs a CUDA card; it exits non-zero without
one.
"""

from __future__ import annotations

import ctypes
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from wildcat_slam_tpu_torch.ops import _build, imu_factor, surfel_factor

_K5_PHASE2 = "  cg::this_grid().sync();\n\n  // phase 2: a block a block row r\n"
_K6_PHASE2 = "  grid.sync();\n\n  // phase 2: the pairs' cross terms, then the rows' chunks\n"

_STAMPS = """
__device__ unsigned long long probe_stamps[4096 * 8];
__device__ __forceinline__ void probe_stamp(int k) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    probe_stamps[blockIdx.x * 8 + k] = t;
  }
}
"""
_READ = """
extern "C" int wc_probe_stamps(unsigned long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, probe_stamps, n * sizeof(unsigned long long));
}
"""
# kernel: [(mark, replacement)] that put the stamps in
TRACE = {
    "imu_factor.cu": [
        ("namespace cg = cooperative_groups;\n", "namespace cg = cooperative_groups;\n" + _STAMPS),
        ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
         "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n  probe_stamp(0);\n"),
        (_K5_PHASE2, "  probe_stamp(1);\n" + _K5_PHASE2 + "  probe_stamp(2);\n"),
        ("    __syncthreads();  // slab is rewritten by the next row\n  }\n}\n",
         "    __syncthreads();  // slab is rewritten by the next row\n  }\n  probe_stamp(3);\n}\n"),
    ],
    "surfel_factor.cu": [
        ("namespace cg = cooperative_groups;\n", "namespace cg = cooperative_groups;\n" + _STAMPS),
        ("  cg::grid_group grid = cg::this_grid();\n",
         "  cg::grid_group grid = cg::this_grid();\n  probe_stamp(0);\n"),
        ("  for (int s = blockIdx.x; s < s_cap; s += gridDim.x) {\n    int listed = 0;",
         "  probe_stamp(1);\n  for (int s = blockIdx.x; s < s_cap; s += gridDim.x) {\n"
         "    int listed = 0;"),
        (_K6_PHASE2, "  probe_stamp(2);\n" + _K6_PHASE2 + "  probe_stamp(3);\n"),
        ("  grid.sync();\n\n  // phase 3", "  probe_stamp(4);\n  grid.sync();\n  probe_stamp(5);\n\n"
         "  // phase 3"),
        ("      g_out[ra] = ((gs + other) + gi[ra]) * fm[ra];\n    }\n  }\n}\n",
         "      g_out[ra] = ((gs + other) + gi[ra]) * fm[ra];\n    }\n  }\n"
         "  probe_stamp(6);\n}\n"),
    ],
}
STAMPS = {"imu_factor.cu": ("start", "phase 1", "barrier", "phase 2"),
          "surfel_factor.cu": ("start", "evaluated", "lists", "barrier 1", "phase 2", "barrier 2",
                               "phase 3")}


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
    fn()
    torch.cuda.synchronize()
    host = (ctypes.c_ulonglong * (4096 * 8))()
    fn()
    torch.cuda.synchronize()
    lib.wc_probe_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    _build.check(lib.wc_probe_stamps(host, 4096 * 8), "wc_probe_stamps")
    t = np.frombuffer(host, dtype=np.uint64).reshape(4096, 8).astype(np.int64)
    names = STAMPS[name]
    t = t[t[:, 0] > 0][:, :len(names)]
    t = t[t[:, 0] >= t[:, 0].max() - 200_000]  # this launch's blocks: started within 0.2 ms
    t0 = t[:, 0].min()
    return ", ".join(f"{k} {(t[:, i].min() - t0) / 1e3:.1f}-{(t[:, i].max() - t0) / 1e3:.1f}"
                     for i, k in enumerate(names)) + f" us ({len(t)} blocks)"


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
    cs = runpy.run_path(str(Path(_build.__file__).resolve().parents[2] / "chip_smoke.py"))
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


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("probe_factors: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    probs, cs = problems(dev)
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
                    fn = lambda: imu_factor.normal_eqs(ifac, cor, w, dt, grav)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
