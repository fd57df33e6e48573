"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a``, one ``nvcc`` process
per source, all started together, then linked into one shared library with a
plain C interface, loaded with ``ctypes``. The build runs at first use,
into ``wildcat_slam_tpu_torch/_build/``, and the library's file name carries a
hash of the sources, so an edited source is rebuilt and an unchanged one is
loaded as it is. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("pcg.cu", "knn_bins.cu", "knn_mxu.cu", "self_match.cu", "spd_solve.cu",
           "imu_factor.cu", "surfel_factor.cu", "surfel_extract.cu", "sweep_graph.cu")
HEADERS = ("lie.cuh", "eigh3.cuh")  # included by the sources: part of the library's hash
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the factor kernels and the surfel extraction round each operation on its
# own, as their plain versions' PyTorch operations do (no contraction into
# FMA; the factor kernels' sums' FMAs are explicit): the float64 sweep then
# stays on the JAX package's float64 record as long as the plain version does
# (chip_smoke (l)). Never --use_fast_math: K7's floor(p / size) must round
# as the plain version's
SOURCE_FLAGS = {"imu_factor.cu": ("-fmad=false",), "surfel_factor.cu": ("-fmad=false",),
                "surfel_extract.cu": ("-fmad=false",)}


def flags(source: str) -> tuple:
    """nvcc's flags for one source."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(source, ())

_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = shutil.which("nvcc") or (os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None)
    if not cand or not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return cand


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    return BUILD_DIR / f"libwildcat_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these exact sources exists."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    objs = [so.with_suffix(f".{os.getpid()}.{Path(src).stem}.o") for src in SOURCES]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    cmds = [[nvcc, *flags(src), "-c", "-o", str(obj), str(SRC_DIR / src)]
            for src, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    stderr = ""
    try:
        for cmd, proc in zip(cmds, procs):
            err = proc.communicate()[1]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
            stderr += err
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stderr}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, so)
    seconds = time.perf_counter() - t0
    ptxas = [ln for ln in stderr.splitlines() if "ptxas" in ln or "spill" in ln]
    print(f"built {so.name} in {seconds:.1f} s", file=sys.stderr)
    for ln in ptxas:
        print(ln, file=sys.stderr)
    return so


_VP, _I32, _PP = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)
_I64 = ctypes.c_longlong
_F64, _PF64 = ctypes.c_double, ctypes.POINTER(ctypes.c_double)
# the C entry points: (argument types, return type)
SIGNATURES = {
    "wc_pcg_solve": ([_VP] * 6 + [_I32, _I32, ctypes.c_float, _I32, _I32, _I32, _I32, _VP],
                     _I32),
    "wc_knn_bins": ([_VP] * 4 + [_I32] * 8 + [_VP], _I32),
    "wc_knn_mxu": ([_VP] * 5 + [_I32] * 8 + [_VP], _I32),
    "wc_self_match": ([_VP] * 5 + [_I32] * 6 + [_VP], _I32),
    "wc_spd_solve": ([_VP] * 5 + [_I32] * 8 + [_VP], _I32),
    "wc_imu_factor": ([_PP, _I32] + [_VP] * 5 + [_I32] * 4 + [_PF64] + [_I32] * 4
                      + [_I64] * 2 + [_VP], _I32),
    "wc_surfel_factor": ([_PP, _I32] + [_VP] * 8 + [_I32] * 5 + [_F64] + [_I32] * 3
                         + [_I64] * 2 + [_VP], _I32),
    "wc_surfel_extract": ([_PP] + [_I32] * 6 + [_PF64] + [_I32] * 3 + [_I64] * 2 + [_VP], _I32),
    "wc_graph_create": ([_PP], _I32),
    "wc_graph_add_child": ([_VP, _PP, _VP], _I32),
    "wc_graph_add_lm_loop": ([_VP, _PP, _VP, _VP, _VP, _VP, _I32], _I32),
    "wc_graph_instantiate": ([_VP, _PP], _I32),
    "wc_graph_launch": ([_VP, _VP], _I32),
    "wc_graph_destroy": ([_VP, _VP], _I32),
    "wc_graph_nodes": ([_VP, ctypes.POINTER(ctypes.c_ulonglong)], _I32),
    "wc_knn_mxu_resources": ([ctypes.POINTER(_I32)], _I32),
    "wc_error_string": ([_I32], ctypes.c_char_p),
}


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and return types of the entry points that ``lib``
    holds (all of them in the kernel library; a library built from one
    source, as the probes build, holds its own)."""
    for name, (argtypes, restype) in SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        _lib = declare(ctypes.CDLL(str(build())))
    return _lib


def graph_nodes(raw_graph: int) -> int:
    """The node count of a cudaGraph_t (``CUDAGraph.raw_cuda_graph()``)."""
    n = ctypes.c_ulonglong(0)
    check(library().wc_graph_nodes(raw_graph, ctypes.byref(n)), "wc_graph_nodes")
    return n.value


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        name = library().wc_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({name})")
