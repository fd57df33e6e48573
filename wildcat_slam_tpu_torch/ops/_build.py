"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ``ctypes``. The build runs at first use,
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
SOURCES = ("pcg.cu", "knn_bins.cu", "knn_mxu.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libwildcat_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these exact sources exists."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(SRC_DIR / s) for s in SOURCES)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, so)
    seconds = time.perf_counter() - t0
    ptxas = [ln for ln in res.stderr.splitlines() if "ptxas info" in ln]
    print(f"built {so.name} in {seconds:.1f} s", file=sys.stderr)
    for ln in ptxas:
        print(ln, file=sys.stderr)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.wc_pcg_solve.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, f32, vp]
        lib.wc_pcg_solve.restype = i32
        lib.wc_knn_bins.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, vp]
        lib.wc_knn_bins.restype = i32
        lib.wc_knn_mxu.argtypes = [vp, vp, vp, vp, i32, i32, i32, vp]
        lib.wc_knn_mxu.restype = i32
        lib.wc_error_string.argtypes = [i32]
        lib.wc_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        name = library().wc_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({name})")
