"""The IMU factors' residuals and banded normal equations: kernel K5.

Counterpart of the JAX package's ``factors.imu_residuals`` followed by
``solver._imu_banded_normal_eqs``, which XLA fuses inside the jitted sweep
(no Pallas kernel stands behind them). :func:`residuals` gives the masked
residuals r (Mi, 12) and :func:`normal_eqs` the five block bands of H
(delta -2..2, each (S, 12, 12)) and g (S 12), one launch each of
``csrc/imu_factor.cu`` on CUDA tensors; both raise for anything else. The
plain version is ``odometry/factors.imu_residuals_plain`` (with its
Jacobians) followed by ``odometry/solver.imu_banded_normal_eqs_plain``; the
port's entry points ``factors.imu_residuals`` and
``solver._imu_banded_normal_eqs`` run it on CPU tensors and these on CUDA
tensors. The kernel needs brackets whose six indices span at most three
blocks from their minimum (the plain version drops a block beyond them, so
does the kernel).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from wildcat_slam_tpu_torch.ops import _build

LAUNCHES = 0  # kernel launches by residuals and normal_eqs (not by the plain version)

# csrc/imu_factor.cu, normal mode: one cooperative launch of blocks of
# THREADS threads. Phase 1, a warp a factor, writes each factor's band
# (12 x 36) and residual (12) to a workspace (RECORD values a factor) and its
# base (int32); phase 2, a block a block row of H, stages BATCH bands at a
# time. A block's shared memory holds the staged bands and residuals, a warp
# slot of pieces (48) and weights (8) each, the finished chains (three
# 12 x 36 slabs and 36 entries of g) and, as int32, a warp's meta (8) each,
# the staged bases, the list of a window of WINDOW factors and a count a warp
THREADS = 256
BATCH = 32
WINDOW = 2048
RECORD = 12 * 36 + 12
MAX_FACTORS = 1 << 26
MAX_WORKSPACE_BYTES = 1 << 31  # a normal-mode call's workspace (the bands and bases)
H100_SMEM_PER_BLOCK = 232_448  # opt-in shared memory of one block (227 KB)
FIELDS = ("valid", "q1", "q2", "a1", "g1", "g2", "p1", "p2", "p3", "il", "ir", "f")


class Plan(NamedTuple):
    threads: int     # a normal-mode block (the kernel is built for THREADS)
    batch: int       # factors evaluated together (built for BATCH)
    smem_bytes: int  # dynamic shared memory of a normal-mode block


def smem_bytes(itemsize: int) -> int:
    """The normal-mode block's shared memory (csrc/imu_factor.cu, normal_smem)."""
    warps = THREADS // 32
    values = BATCH * 12 * 36 + BATCH * 12 + warps * (48 + 8) + 3 * 12 * 36 + 36
    return itemsize * values + 4 * (warps * 8 + BATCH + WINDOW + warps)


def plan(mi: int, s_cap: int, itemsize: int,
         smem_per_block: int = H100_SMEM_PER_BLOCK) -> Plan:
    """The normal-mode launch for Mi factors on S sample states (one block a
    block row). Raises ValueError for what the kernel does not take, and
    where the workspace would pass MAX_WORKSPACE_BYTES."""
    if not 0 <= mi <= MAX_FACTORS or s_cap < 1 or itemsize not in (4, 8):
        raise ValueError(f"imu_factor: needs 0 <= Mi <= {MAX_FACTORS}, S >= 1 and float32 or "
                         f"float64, got Mi={mi}, S={s_cap}, {itemsize}-byte values")
    work = max(mi, 1) * (RECORD * itemsize + 4)
    if work > MAX_WORKSPACE_BYTES:
        raise ValueError(f"imu_factor: Mi={mi} factors need {work} bytes of workspace, more "
                         f"than {MAX_WORKSPACE_BYTES}")
    smem = smem_bytes(itemsize)
    if smem > smem_per_block:
        raise ValueError(f"imu_factor: a block needs {smem} bytes of shared memory, more than "
                         f"the {smem_per_block} it can have")
    return Plan(THREADS, BATCH, smem)


def supports(mi: int, s_cap: int, dtype: torch.dtype) -> bool:
    """True when the kernel takes Mi factors on S states in ``dtype``."""
    try:
        plan(mi, s_cap, torch.finfo(dtype).bits // 8 if dtype.is_floating_point else 0)
    except ValueError:
        return False
    return True


def consts(weights, dt: float) -> tuple:
    """The kernel's scalars as the plain version forms them in double before
    one cast each: w_g, w_a, w_bg, w_ba, dt, dt dt, w_g / dt, w_a / dt / dt,
    2 w_a / dt / dt."""
    w_g, w_a, w_bg, w_ba = (float(w) for w in weights)
    return (w_g, w_a, w_bg, w_ba, dt, dt * dt, w_g / dt, w_a / dt / dt, 2.0 * w_a / dt / dt)


def _inputs(fac, cor: torch.Tensor, grav: torch.Tensor) -> list:
    """The kernel's inputs in its order, contiguous, after the checks that
    need no host read."""
    dtype, dev = cor.dtype, cor.device
    mi = fac.valid.shape[0]
    if dev.type != "cuda" or dtype not in (torch.float32, torch.float64) or cor.dim() != 2 \
            or cor.shape[1] != 12:
        raise ValueError(f"imu_factor: needs cor (S, 12) float32 or float64 on a CUDA card, got "
                         f"{tuple(cor.shape)} {dtype} on {dev}")
    out = []
    for name in FIELDS:
        t = getattr(fac, name)
        want = torch.bool if name == "valid" else torch.int64 if name in ("il", "ir") else dtype
        if t.device != dev or t.dtype != want or t.shape[0] != mi:
            raise ValueError(f"imu_factor: field {name} is {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}; needs {want} on {dev} with Mi={mi} rows")
        out.append(t.contiguous())
    if grav.shape != (3,) or grav.dtype != dtype or grav.device != dev:
        raise ValueError(f"imu_factor: needs grav (3,) {dtype} on {dev}")
    return out + [cor.contiguous(), grav.contiguous()]


def _launch(fac, cor, weights, dt: float, grav, r_out, bands, g_out, normal: bool) -> None:
    global LAUNCHES
    ins = _inputs(fac, cor, grav)
    mi, s_cap, itemsize = fac.valid.shape[0], cor.shape[0], cor.element_size()
    p = plan(mi, s_cap, itemsize)
    ptrs = (ctypes.c_void_p * len(ins))(*(t.data_ptr() for t in ins))
    k = (ctypes.c_double * 9)(*consts(weights, dt))
    work = base_of = None
    if normal:  # the workspace of phase 1, from torch's allocator
        work = torch.empty((max(mi, 1) * RECORD,), dtype=cor.dtype, device=cor.device)
        base_of = torch.empty((max(mi, 1),), dtype=torch.int32, device=cor.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _build.library()
    with torch.cuda.device(cor.device):  # the C entry launches on the current card
        err = lib.wc_imu_factor(ptrs, len(ins), ptr(r_out), ptr(bands), ptr(g_out), ptr(work),
                                ptr(base_of), mi, s_cap, itemsize, int(normal), k, p.threads,
                                p.batch, p.smem_bytes,
                                torch.cuda.current_stream(cor.device).cuda_stream)
    _build.check(err, "wc_imu_factor")
    LAUNCHES += 1


def residuals(fac, cor: torch.Tensor, weights, dt: float, grav: torch.Tensor) -> torch.Tensor:
    """The residuals r (Mi, 12), where(valid, r, 0), by the kernel."""
    r = torch.empty((fac.valid.shape[0], 12), dtype=cor.dtype, device=cor.device)
    _launch(fac, cor, weights, dt, grav, r, None, None, normal=False)
    return r


def normal_eqs(fac, cor: torch.Tensor, weights, dt: float, grav: torch.Tensor):
    """The IMU factors' part of (H, g) by the kernel: the block bands
    (5, S, 12, 12), band d holding the 12 x 12 blocks at (r, r + d - 2), and
    g (S 12)."""
    s_cap = cor.shape[0]
    bands = torch.empty((5, s_cap, 12, 12), dtype=cor.dtype, device=cor.device)
    g = torch.empty((s_cap * 12,), dtype=cor.dtype, device=cor.device)
    _launch(fac, cor, weights, dt, grav, None, bands, g, normal=True)
    return bands, g
