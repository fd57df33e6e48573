"""What bounds K4 (``csrc/spd_solve.cu``) on the card: the kernel against
variants of its own source with one part of its work cut out.

    python -m wildcat_slam_tpu_torch.probe_spd [--parent DIR] [--trace]

Each variant is built from the source by text edits, into its own library
under ``_build/probe/``, and timed on the same inputs (a = G G^T / N + I and
b from a seed) at the main path's shapes: the spline fit's N=96, m=6 (the
one-block path) and the damped LM system's N=1152, m=1 (the tile
dataflow), in float32 and float64:

- ``kernel``: the source as it is;
- ``no_backsub``: no back substitution (either path's L^T x = y);
- ``no_chol``: the diagonal tiles' factorisation returns at once;
- ``no_update``: the tile updates return at once;
- ``no_flags``: the dataflow's flag waits return at once (its reads race;
  the one-block path has no flags, so there it is the kernel);
- ``no_trsm``: the column tiles' triangular solves return at once;
- ``one_tile``: panel 0's update of the last diagonal tile left out (the
  smallest fault: one 32 x 32 tile update of one panel).

With ``--parent DIR`` (a checkout of another commit, e.g. unpacked by ``git
archive`` under ``_build/``) that checkout's ``csrc/spd_solve.cu`` is built
and timed too (``parent``), launched by its own ``ops/spd.py`` plan: an A/B
inside one call. With ``--trace`` a variant with globaltimer stamps at each
stage of the dataflow's diagonal items and back substitution (``TRACE``,
text edits too) runs once at N=1152 in each dtype, and the probe prints
where a panel's time goes on the critical path (the mean over panels 2 to
35 of each stage) and when the factorisation and x_0 were done.

The variants compute wrong results: the difference of their times to
``kernel``'s is what the part costs beyond what overlaps it. Each time is
20 calls captured in one CUDA graph and replayed, divided by 20, the median
of 5 replays (``profile_sweeps.graph_ms``). Each variant's result is held to
the plain version by the card's gate (``spd.accuracy``: backward error at
most 10 N eps, forward gap at most 100 kappa eps): the kernel (and the
parent) must pass it and every cut variant should fail it (``gate`` in the
line; the probe exits non-zero when the kernel fails). It also prints
ptxas's lines for each variant's kernels (registers, stack and spills, float32
and float64, one block and the dataflow). Needs a CUDA card; it exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from wildcat_slam_tpu_torch.ops import _build, spd
from wildcat_slam_tpu_torch.profile_sweeps import graph_ms

_RETURN = "\n  return;"
# name: the text edits that cut the part out, (mark, replacement) each
CUTS = {
    "no_backsub": tuple((mark, mark + _RETURN) for mark in (
        "                                                  int warp, int lane) {",
        "__device__ void back_substitute(const Dataflow<T>& f, int i, int k, int lane) {")),
    "no_chol": (("__device__ __forceinline__ void chol_tile(T* s, T* sT, T* rinv, T* col, "
                 "int lane) {",
                 "__device__ __forceinline__ void chol_tile(T* s, T* sT, T* rinv, T* col, "
                 "int lane) {" + _RETURN),),
    "no_update": (("__device__ __forceinline__ void tile_update(T* acc, const T* li, const T* lj, "
                   "int lane) {",
                   "__device__ __forceinline__ void tile_update(T* acc, const T* li, const T* lj, "
                   "int lane) {" + _RETURN),),
    "no_flags": (("__device__ __forceinline__ void spin(const unsigned* f) {",
                  "__device__ __forceinline__ void spin(const unsigned* f) {" + _RETURN),),
    "no_trsm": (("__device__ __forceinline__ void trsm_tile(T* s, const T* lkkT, const T* rinv, "
                 "int lane) {",
                 "__device__ __forceinline__ void trsm_tile(T* s, const T* lkkT, const T* rinv, "
                 "int lane) {" + _RETURN),),
    "one_tile": (
        ("      tile_update(u ? f.own1 : f.own0, f.st0, u ? f.st0 : f.st1, lane);",
         "      if (!(u == 1 && i == f.P - 1 && k == 0))\n"
         "        tile_update(u ? f.own1 : f.own0, f.st0, u ? f.st0 : f.st1, lane);"),
        ("            tile_update(tile(i, j), tile(i, k), tile(j, k), lane);",
         "            if (!(k == 0 && i == P - 1 && j == P - 1))\n"
         "              tile_update(tile(i, j), tile(i, k), tile(j, k), lane);")),
}
SHAPES = ((96, 6, torch.float32), (1152, 1, torch.float32), (96, 6, torch.float64),
          (1152, 1, torch.float64))


def _stamp(slot: str) -> str:
    return ("if (lane == 0) { unsigned long long t_; asm volatile(\"mov.u64 %0, %%globaltimer;\" "
            f": \"=l\"(t_)); g_trace[{slot}] = t_; }}")


# (mark, replacement) edits that stamp the globaltimer: diagonal item d at
# slot 16 d + stage (STAGES), the back substitution of panel k at 4096 + 16 k
# + stage (BACK_STAGES), the launch's grid-wide sync at 8192 and 8193
STAGES = ("start", "updates", "hop", "copy", "trsm", "look-ahead update and flag", "", "chol",
          "publish")
BACK_STAGES = ("start", "y_k", "partial sums", "two nearest", "trsv", "flag")
TRACE = (
    ("namespace {\n\nconstexpr int kTile = 32;",
     "__device__ unsigned long long g_trace[1 << 14];\nnamespace {\n\nconstexpr int kTile = 32;"),
    ("  __syncwarp();\n  for (int k = 0; k < aj; ++k) {",
     "  __syncwarp();\n  if (diag) " + _stamp("16 * i + 0") + "\n  for (int k = 0; k < aj; ++k) {"),
    ("  if (aj >= 0) {\n    wait_flags(f.fL + lin(aj, aj), nullptr, lane);",
     "  if (diag) " + _stamp("16 * i + 1") + "\n  if (aj >= 0) {\n    wait_flags(f.fL + lin(aj, aj), "
     "nullptr, lane);\n    if (diag) " + _stamp("16 * i + 2")),
    ("    copy_wait<0>();\n    trsm_tile(f.own0, f.st1, f.rv, lane);\n    __syncwarp();",
     "    copy_wait<0>();\n    if (diag) " + _stamp("16 * i + 3") + "\n    trsm_tile(f.own0, f.st1, "
     "f.rv, lane);\n    __syncwarp();\n    if (diag) " + _stamp("16 * i + 4")),
    ("    set_flag(f.fL + lin(ai, aj), lane);\n  }",
     "    set_flag(f.fL + lin(ai, aj), lane);\n    if (diag) " + _stamp("16 * i + 5") + "\n  }"),
    ("    chol_tile(f.own1, f.own0, f.rv, f.col, lane);  // L_dd into own1, L_dd^T into own0",
     "    " + _stamp("16 * i + 6") + "\n    chol_tile(f.own1, f.own0, f.rv, f.col, lane);\n    "
     + _stamp("16 * i + 7")),
    ("    set_flag(f.fL + lin(i, i), lane);", "    set_flag(f.fL + lin(i, i), lane);\n    "
     + _stamp("16 * i + 8")),
    ("  wait_flags(f.fL + lin(P, k), nullptr, lane);\n  copy_rows(f.own0, f.tile(P, k), m, lane);",
     "  " + _stamp("4096 + 16 * k + 0") + "\n  wait_flags(f.fL + lin(P, k), nullptr, lane);\n  "
     + _stamp("4096 + 16 * k + 1") + "\n  copy_rows(f.own0, f.tile(P, k), m, lane);"),
    ("  for (int i2 = k + 2 < P ? k + 2 : P - 1; i2 > k; --i2) {",
     "  " + _stamp("4096 + 16 * k + 2") + "\n  for (int i2 = k + 2 < P ? k + 2 : P - 1; i2 > k; --i2) {"),
    ("  trsv_rows(f.own0, f.own1, f.rv, m, lane);\n  store_rows(f.X",
     "  " + _stamp("4096 + 16 * k + 3") + "\n  trsv_rows(f.own0, f.own1, f.rv, m, lane);\n  "
     + _stamp("4096 + 16 * k + 4") + "\n  store_rows(f.X"),
    ("  set_flag(f.fX + k, lane);\n  const int row",
     "  set_flag(f.fX + k, lane);\n  " + _stamp("4096 + 16 * k + 5") + "\n  const int row"),
    ("  cg::this_grid().sync();\n", "  if (blockIdx.x == 0) " + _stamp("8192") + "\n  cg::this_grid()"
     ".sync();\n  if (blockIdx.x == 0) " + _stamp("8193") + "\n"),
)


def traced(src: str) -> str:
    """The source with TRACE's stamps and an entry that copies them out."""
    missing = [mark for mark, _ in TRACE if src.count(mark) != 1]
    if missing:
        raise RuntimeError(f"csrc/spd_solve.cu no longer has the trace's marks {missing}")
    for mark, replacement in TRACE:
        src = src.replace(mark, replacement)
    return src + ('\nextern "C" int wc_trace_read(void* host) {\n'
                  '  return (int)cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace));\n}\n')


def trace(lib, dev) -> None:
    """Run the traced variant at N=1152 in each dtype and print the mean time
    of each stage of a panel on the critical path (panels 2 to 35) and of a
    back-substitution panel, from the globaltimer's stamps."""
    lib.wc_trace_read.argtypes = [ctypes.c_void_p]
    for dtype in (torch.float32, torch.float64):
        n, m = 1152, 1
        rng = np.random.default_rng(n + m)
        g = rng.normal(size=(n, n))
        a = torch.as_tensor(g @ g.T / n + np.eye(n), dtype=dtype, device=dev)
        b = torch.as_tensor(rng.normal(size=(n, m)), dtype=dtype, device=dev)
        x = torch.empty_like(b)
        p = spd.plan(n, m, a.element_size())
        work = torch.empty(p.workspace, dtype=dtype, device=dev)
        flags = torch.empty(p.flags, dtype=torch.int32, device=dev)
        lib.wc_spd_solve.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        for _ in range(3):
            _build.check(lib.wc_spd_solve(a.data_ptr(), b.data_ptr(), x.data_ptr(), work.data_ptr(),
                                          flags.data_ptr(), n, m, a.element_size(),
                                          *spd.launch_args(p),
                                          torch.cuda.current_stream().cuda_stream), "wc_spd_solve")
            torch.cuda.synchronize()
        t = np.zeros(1 << 14, dtype=np.uint64)
        _build.check(lib.wc_trace_read(t.ctypes.data), "wc_trace_read")
        t = (t.astype(np.int64) - int(t[8192])) / 1e3  # us from the launch's sync
        P = p.tiles
        diag = np.stack([t[16 * d:16 * d + 9] for d in range(2, P)])
        step = np.diff(diag[:, 8]).mean()
        stages = {"hop": diag[:, 2] - np.concatenate([[t[16 * 1 + 8]], diag[:-1, 8]]),
                  "copy": diag[:, 3] - diag[:, 2], "trsm": diag[:, 4] - diag[:, 3],
                  "look-ahead update and flag": diag[:, 5] - diag[:, 4],
                  "chol": diag[:, 7] - diag[:, 6], "publish": diag[:, 8] - diag[:, 7]}
        back = np.stack([t[4096 + 16 * k:4096 + 16 * k + 6] for k in range(P)])
        bstep = -np.diff(back[::-1, 5][::-1]).mean()
        print(f"probe_spd trace N={n} {str(dtype)[6:]}: a panel {step:.2f} us on the critical path: "
              + ", ".join(f"{k} {v.mean():.2f}" for k, v in stages.items())
              + f"; factorisation done at {t[16 * (P - 1) + 8]:.1f} us; back substitution "
              f"{bstep:.2f} us a panel (trsv {(back[:, 4] - back[:, 3]).mean():.2f}); x_0 at "
              f"{back[0, 5]:.1f} us", flush=True)


def variants(src: str) -> dict:
    missing = [name for name, edits in CUTS.items() if any(src.count(mark) != 1
                                                            for mark, _ in edits)]
    if missing:
        raise RuntimeError(f"csrc/spd_solve.cu no longer has the marks of {missing} that this "
                           "probe cuts")
    out = {"kernel": src}
    for name, edits in CUTS.items():
        cut = src
        for mark, replacement in edits:
            cut = cut.replace(mark, replacement)
        out[name] = cut
    return out


def _ptxas(lines: list) -> list:
    """ptxas's properties of each K4 kernel in nvcc's output: which, then its
    stack and spills and its registers."""
    out = []
    for i in range(len(lines) - 2):
        if "Function properties" in lines[i] and ("spd_" in lines[i]):
            kind = next((k for k in ("spd_one_block", "spd_tiles", "spd_kernel") if k in lines[i]),
                        "spd")
            out.append(f"{kind} {'f32' if 'IfE' in lines[i] else 'f64'}: {lines[i + 1].strip()}; "
                       f"{lines[i + 2].strip()}")
    return out


def build(srcs: dict) -> dict:
    """{name: (loaded library, ptxas's lines for its kernels)}, one nvcc each,
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
        libs[name] = (ctypes.CDLL(str(out_dir / f"spd_{name}.so")), _ptxas(err.splitlines()))
    return libs


def _parent_plan(root: Path):
    """The ``plan`` function of another checkout's ``ops/spd.py``."""
    spec = importlib.util.spec_from_file_location(
        "parent_spd", root / "wildcat_slam_tpu_torch" / "ops" / "spd.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.plan


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout whose K4 is timed beside this one's")
    ap.add_argument("--trace", action="store_true",
                    help="time each stage of the dataflow's critical path at N=1152")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_spd: needs a CUDA card", file=sys.stderr)
        return 1
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"probe_spd: {res.stdout.strip()}", flush=True)
    srcs = variants((_build.SRC_DIR / "spd_solve.cu").read_text())
    plans = {name: spd.plan for name in srcs}
    if args.parent is not None:
        srcs["parent"] = (args.parent / "wildcat_slam_tpu_torch" / "csrc" / "spd_solve.cu").read_text()
        plans["parent"] = _parent_plan(args.parent)
    libs = build(srcs)
    for name, (_, ptxas) in libs.items():
        print(f"probe_spd {name} ptxas: {' | '.join(ptxas)}", flush=True)
    dev = torch.device("cuda", 0)
    for n, m, dtype in SHAPES:
        rng = np.random.default_rng(n + m)
        g = rng.normal(size=(n, n))
        a = torch.as_tensor(g @ g.T / n + np.eye(n), dtype=dtype, device=dev)
        b = torch.as_tensor(rng.normal(size=(n, m)), dtype=dtype, device=dev)
        x = torch.empty_like(b)
        ref = spd.spd_solve_plain(a, b)
        row, kernel_ok = [], True
        for name, (lib, _) in libs.items():
            p = plans[name](n, m, a.element_size())
            launch = spd.launch_args(p)
            work = torch.empty(p.workspace, dtype=dtype, device=dev)
            flags = torch.empty(getattr(p, "flags", 2), dtype=torch.int32, device=dev)
            fn = lib.wc_spd_solve
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * (3 + len(launch)) + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def call(fn=fn, launch=launch, work=work, flags=flags):
                _build.check(fn(a.data_ptr(), b.data_ptr(), x.data_ptr(), work.data_ptr(),
                                flags.data_ptr(), n, m, a.element_size(), *launch,
                                torch.cuda.current_stream().cuda_stream), "wc_spd_solve")
            x.fill_(float("nan"))
            call()
            acc = spd.accuracy(a, b, x, ref)
            kernel_ok &= name not in ("kernel", "parent") or acc["ok"]
            row.append(f"{name} {graph_ms(call) * 1e3:.1f} us (gate "
                       f"{'pass' if acc['ok'] else 'fail'}: backward {acc['backward']:.1e}, "
                       f"forward {acc['forward']:.1e})")
        p = spd.plan(n, m, a.element_size())
        print(f"probe_spd N={n} m={m} {str(dtype)[6:]} ({'one block' if p.one_block else 'dataflow'}"
              f", grid {p.grid} x {p.warps} warps; bounds: backward {acc['backward_bound']:.1e}, "
              f"forward {acc['forward_bound']:.1e}): " + ", ".join(row), flush=True)
        if not kernel_ok:
            print("probe_spd: the kernel failed its gate", file=sys.stderr)
            return 1
    if args.trace:
        trace(build({"traced": traced(srcs["kernel"])})["traced"][0], dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
