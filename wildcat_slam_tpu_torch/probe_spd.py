"""What bounds K4 (``csrc/spd_solve.cu``) on the card: the kernel against
variants of its own source with one part of its work cut out.

    python -m wildcat_slam_tpu_torch.probe_spd

Each variant is built from the source by a text edit, into its own library
under ``_build/probe/``, and timed on the same inputs (a = G G^T / N + I and
b from a seed) at the main path's shapes: the spline fit's N=96, m=6 and the
damped LM system's N=1152, m=1, in float32 and float64:

- ``kernel``: the source as it is;
- ``no_backsub``: no back substitution (one block's L^T x = y);
- ``no_chol``: the diagonal tiles' factorisation returns at once;
- ``no_update``: a tile update does one FMA a value instead of 32;
- ``no_barrier``: the grid barriers return at once;
- ``no_trsm``: the column tiles' triangular solves do nothing;
- ``one_tile``: panel 0's update of the last diagonal tile left out (the
  smallest fault: one 32 x 32 tile update of one phase).

The variants compute wrong results: the difference of their times to
``kernel``'s is what the part costs beyond what overlaps it. Each time is
20 calls captured in one CUDA graph and replayed, divided by 20, the median
of 5 replays (``profile_sweeps.graph_ms``). Each variant's result is held to
the plain version by the card's gate (``spd.accuracy``: backward error at
most 10 N eps, forward gap at most 100 kappa eps): the kernel must pass it
and every cut variant should fail it (``gate`` in the line; the probe exits
non-zero when the kernel fails). It also prints ptxas's lines for each
variant's kernel (registers, stack and spills, float32 and float64). Needs
a CUDA card; it exits non-zero without one.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from wildcat_slam_tpu_torch.ops import _build, spd
from wildcat_slam_tpu_torch.profile_sweeps import graph_ms

CUTS = {
    "no_backsub": ("  if (blockIdx.x != 0) return;", "  return;"),
    "no_chol": ("  bool bad = false;\n#pragma unroll\n  for (int j = 0; j < kTile; ++j) {",
                "  bool bad = false;\n  return bad;\n#pragma unroll\n  for (int j = 0; j < kTile; ++j) {"),
    "no_update": ("#pragma unroll\n    for (int p = 0; p < kTile; ++p) acc[c] = fma(-li[p], row[p], acc[c]);",
                  "    acc[c] = fma(-li[c], row[c], acc[c]);"),
    "no_barrier": ("  if (gridDim.x == 1) return;\n  target += gridDim.x;",
                   "  return;\n  target += gridDim.x;"),
    "no_trsm": ("    const T xc = acc[c] * rinv[c];", "    const T xc = acc[c];\n    continue;"),
    "one_tile": ("        read_row(acc, lkt + lane * S);\n        tile_update(acc, li, lj);",
                 "        read_row(acc, lkt + lane * S);\n"
                 "        if (!(k == 1 && i == P - 1 && j == P - 1)) tile_update(acc, li, lj);"),
}
SHAPES = ((96, 6, torch.float32), (1152, 1, torch.float32), (96, 6, torch.float64),
          (1152, 1, torch.float64))


def variants(src: str) -> dict:
    missing = [name for name, (mark, _) in CUTS.items() if src.count(mark) != 1]
    if missing:
        raise RuntimeError(f"csrc/spd_solve.cu no longer has the marks of {missing} that this "
                           "probe cuts")
    return {"kernel": src, **{name: src.replace(mark, cut) for name, (mark, cut) in CUTS.items()}}


def build(srcs: dict) -> dict:
    """{name: (loaded library, ptxas's lines for the kernel)}, one nvcc each,
    all started together."""
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in srcs.items():
        cu = out_dir / f"spd_{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(cu.with_suffix(".so")),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        err = proc.communicate()[1]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{err}")
        lines = err.splitlines()
        ptxas = [f"{'f32' if 'IfE' in lines[i] else 'f64'}: {lines[i + 1].strip()}; "
                 f"{lines[i + 2].strip()}" for i in range(len(lines) - 2)
                 if "Function properties" in lines[i] and "spd_kernel" in lines[i]]
        lib = _build.declare(ctypes.CDLL(str(out_dir / f"spd_{name}.so")))
        libs[name] = (lib, ptxas)
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_spd: needs a CUDA card", file=sys.stderr)
        return 1
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"probe_spd: {res.stdout.strip()}", flush=True)
    libs = build(variants((_build.SRC_DIR / "spd_solve.cu").read_text()))
    for name, (_, ptxas) in libs.items():
        print(f"probe_spd {name} ptxas: {' | '.join(ptxas)}", flush=True)
    dev = torch.device("cuda", 0)
    for n, m, dtype in SHAPES:
        rng = np.random.default_rng(n + m)
        g = rng.normal(size=(n, n))
        a = torch.as_tensor(g @ g.T / n + np.eye(n), dtype=dtype, device=dev)
        b = torch.as_tensor(rng.normal(size=(n, m)), dtype=dtype, device=dev)
        p = spd.plan(n, m, a.element_size())
        x = torch.empty_like(b)
        work = torch.empty(p.workspace, dtype=dtype, device=dev)
        sync = torch.empty(2, dtype=torch.int32, device=dev)
        ref = spd.spd_solve_plain(a, b)
        row, kernel_ok = [], True
        for name, (lib, _) in libs.items():
            def call(lib=lib):
                _build.check(lib.wc_spd_solve(a.data_ptr(), b.data_ptr(), x.data_ptr(),
                                              work.data_ptr(), sync.data_ptr(), n, m,
                                              a.element_size(), p.grid, p.tiles, p.smem_bytes,
                                              torch.cuda.current_stream().cuda_stream),
                             "wc_spd_solve")
            x.fill_(float("nan"))
            call()
            acc = spd.accuracy(a, b, x, ref)
            kernel_ok &= name != "kernel" or acc["ok"]
            row.append(f"{name} {graph_ms(call) * 1e3:.1f} us (gate "
                       f"{'pass' if acc['ok'] else 'fail'}: backward {acc['backward']:.1e}, "
                       f"forward {acc['forward']:.1e})")
        print(f"probe_spd N={n} m={m} {str(dtype)[6:]} (grid {p.grid}; bounds: backward "
              f"{acc['backward_bound']:.1e}, forward {acc['forward_bound']:.1e}): "
              + ", ".join(row), flush=True)
        if not kernel_ok:
            print("probe_spd: the kernel failed its gate", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
