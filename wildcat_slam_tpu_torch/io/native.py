"""ctypes bindings of the C++ host feeder (``csrc/feeder.cc``).

Counterpart of ``wildcat_slam_tpu/io/native.py``: the same
``NativeFeeder``/``NativeResampler`` API over the same C signatures.
``csrc/feeder.cc`` is a byte-for-byte copy of the JAX package's
``native/feeder.cc`` (held equal by a test), so the port builds from its own
copy and needs nothing outside its package.

The library is built at first use with ``g++`` and the flags of
``native/Makefile``, into ``wildcat_slam_tpu_torch/_build/`` under a name
that carries a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. The build writes a
per-process temporary file and renames it into place, so processes that
build at once never load a half-written library. Nothing is built at import.

There is no fallback: ``LidarOdometry(use_native=True)`` raises when the
library cannot be built or loaded. :func:`available` only tells the tests
whether to run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "feeder.cc"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")

_lib = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libwcfeeder_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/feeder.cc`` unless a library for this exact source exists."""
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native feeder (csrc/feeder.cc) is "
                           "built with it at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, so)
    return so


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    d = ctypes.c_double
    dp = ctypes.POINTER(ctypes.c_double)
    fp = ctypes.POINTER(ctypes.c_float)
    vp = ctypes.c_void_p
    lg = ctypes.c_long

    lib.wc_feeder_create.restype = vp
    lib.wc_feeder_create.argtypes = [dp, dp, d, d, dp, dp]
    lib.wc_feeder_destroy.restype = None
    lib.wc_feeder_destroy.argtypes = [vp]
    lib.wc_feeder_add_points.restype = lg
    lib.wc_feeder_add_points.argtypes = [vp, lg, dp, fp]
    lib.wc_feeder_load_scan.restype = lg
    lib.wc_feeder_load_scan.argtypes = [vp, ctypes.c_char_p]
    lib.wc_feeder_size.restype = lg
    lib.wc_feeder_size.argtypes = [vp]
    lib.wc_feeder_front_time.restype = d
    lib.wc_feeder_front_time.argtypes = [vp]
    lib.wc_feeder_back_time.restype = d
    lib.wc_feeder_back_time.argtypes = [vp]
    lib.wc_feeder_drop_before.restype = lg
    lib.wc_feeder_drop_before.argtypes = [vp, d]
    lib.wc_feeder_count_until.restype = lg
    lib.wc_feeder_count_until.argtypes = [vp, d]
    lib.wc_feeder_pop_sweep.restype = lg
    lib.wc_feeder_pop_sweep.argtypes = [vp, d, d, lg, fp, fp]
    lib.wc_feeder_peek.restype = lg
    lib.wc_feeder_peek.argtypes = [vp, lg, dp, fp]
    lib.wc_feeder_push_filtered.restype = None
    lib.wc_feeder_push_filtered.argtypes = [vp, lg, dp, fp]

    lib.wc_resampler_create.restype = vp
    lib.wc_resampler_create.argtypes = [d]
    lib.wc_resampler_destroy.restype = None
    lib.wc_resampler_destroy.argtypes = [vp]
    lib.wc_resampler_add.restype = lg
    lib.wc_resampler_add.argtypes = [vp, d, dp, dp, lg, dp, dp, dp]
    lib.wc_resampler_t0.restype = d
    lib.wc_resampler_t0.argtypes = [vp]
    lib.wc_resampler_get_state.restype = None
    lib.wc_resampler_get_state.argtypes = [vp, dp]
    lib.wc_resampler_set_state.restype = None
    lib.wc_resampler_set_state.argtypes = [vp, dp]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library builds and loads here (the tests' skip condition)."""
    try:
        _load()
        return True
    except (OSError, RuntimeError):
        return False


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _points(n: int, xyz) -> np.ndarray:
    """``xyz`` as a C-contiguous (n, 3) float32 array, or ValueError."""
    p = np.ascontiguousarray(xyz, np.float32)
    if p.shape != (n, 3):
        raise ValueError(f"expected ({n}, 3) points, got shape {p.shape}")
    return p


class NativeFeeder:
    """Point buffer with the extrinsic and the filters applied in C++."""

    def __init__(self, ext_rot, ext_pos, min_range, max_range, bb_min, bb_max):
        lib = _load()
        self._lib = lib
        rot = np.ascontiguousarray(ext_rot, np.float64).reshape(9)
        pos = np.ascontiguousarray(ext_pos, np.float64).reshape(3)
        bmin = np.ascontiguousarray(bb_min, np.float64).reshape(3)
        bmax = np.ascontiguousarray(bb_max, np.float64).reshape(3)
        self._h = lib.wc_feeder_create(_dptr(rot), _dptr(pos), float(min_range),
                                       float(max_range), _dptr(bmin), _dptr(bmax))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.wc_feeder_destroy(self._h)
            self._h = None

    def add_points(self, times: np.ndarray, pts_lidar: np.ndarray) -> int:
        t = np.ascontiguousarray(times, np.float64).reshape(-1)
        p = _points(len(t), pts_lidar)
        return self._lib.wc_feeder_add_points(self._h, len(t), _dptr(t), _fptr(p))

    def load_scan(self, path: str) -> int:
        n = self._lib.wc_feeder_load_scan(self._h, os.fsencode(path))
        if n < 0:
            raise IOError(f"native scan load failed ({n}) for {path}")
        return n

    def __len__(self) -> int:
        return self._lib.wc_feeder_size(self._h)

    @property
    def front_time(self) -> float:
        return self._lib.wc_feeder_front_time(self._h)

    @property
    def back_time(self) -> float:
        return self._lib.wc_feeder_back_time(self._h)

    def drop_before(self, t_cut: float) -> int:
        return self._lib.wc_feeder_drop_before(self._h, float(t_cut))

    def count_until(self, t_end: float) -> int:
        """Number of buffered points with time < t_end (non-destructive)."""
        return self._lib.wc_feeder_count_until(self._h, float(t_end))

    def pop_sweep(self, t_end: float, epoch: float, out_times: np.ndarray,
                  out_xyz: np.ndarray) -> int:
        """Pop points with t < t_end into the padded f32 arrays (times relative
        to epoch). Returns the count written (capped at the array size)."""
        n = len(out_times)
        for a, shape in ((out_times, (n,)), (out_xyz, (n, 3))):
            if a.dtype != np.float32 or a.shape != shape or not a.flags.c_contiguous:
                raise ValueError(f"pop_sweep needs C-contiguous float32 arrays of shapes (n,) "
                                 f"and (n, 3); got {out_times.dtype}{out_times.shape} and "
                                 f"{out_xyz.dtype}{out_xyz.shape}")
        return self._lib.wc_feeder_pop_sweep(self._h, float(t_end), float(epoch), n,
                                             _fptr(out_times), _fptr(out_xyz))

    def dump(self):
        """Non-destructive copy of the buffered points (checkpoint support)."""
        n = len(self)
        t = np.zeros(n, np.float64)
        xyz = np.zeros((n, 3), np.float32)
        self._lib.wc_feeder_peek(self._h, n, _dptr(t), _fptr(xyz))
        return t, xyz.astype(np.float64)

    def restore(self, t: np.ndarray, xyz: np.ndarray) -> None:
        t = np.ascontiguousarray(t, np.float64).reshape(-1)
        x = _points(len(t), xyz)
        self._lib.wc_feeder_push_filtered(self._h, len(t), _dptr(t), _fptr(x))


class NativeResampler:
    """Uniform-grid IMU resampler in C++ (the grid of ``imu.ImuResampler``)."""

    def __init__(self, rate: float, max_out: int = 64):
        lib = _load()
        self._lib = lib
        self._h = lib.wc_resampler_create(float(rate))
        self._out_t = np.zeros(max_out, np.float64)
        self._out_acc = np.zeros((max_out, 3), np.float64)
        self._out_gyr = np.zeros((max_out, 3), np.float64)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.wc_resampler_destroy(self._h)
            self._h = None

    @property
    def _t0(self) -> float:  # the attribute name of the numpy resampler
        return self._lib.wc_resampler_t0(self._h)

    def get_state(self) -> np.ndarray:
        out = np.zeros(11, np.float64)
        self._lib.wc_resampler_get_state(self._h, _dptr(out))
        return out

    def set_state(self, st: np.ndarray) -> None:
        st = np.ascontiguousarray(st, np.float64).reshape(-1)
        if st.shape != (11,):
            raise ValueError(f"resampler state needs 11 values, got {st.shape}")
        self._lib.wc_resampler_set_state(self._h, _dptr(st))

    def add(self, t: float, acc, gyr):
        a = np.ascontiguousarray(acc, np.float64).reshape(3)
        g = np.ascontiguousarray(gyr, np.float64).reshape(3)
        n = self._lib.wc_resampler_add(
            self._h, float(t), _dptr(a), _dptr(g), len(self._out_t),
            _dptr(self._out_t), _dptr(self._out_acc), _dptr(self._out_gyr))
        return [(float(self._out_t[i]), self._out_acc[i].copy(), self._out_gyr[i].copy())
                for i in range(n)]
