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
does the kernel). What bounds it is latency (each factor's evaluation is a
long dependent chain, and each base's sums run over its factors in order),
not its ~0.3 us of operations: it evaluates each factor once on a thread of
its own, lists the factors by base with one stable counting pass over the
grid, forms each base's sums once, in a block of their own, over its valid
factors only, and reads the bands off them in one pass.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from wildcat_slam_tpu_torch.ops import _build

LAUNCHES = 0  # kernel launches by residuals and normal_eqs (not by the plain version)

# csrc/imu_factor.cu, normal mode: one cooperative launch of blocks of
# THREADS threads, two grid barriers. A block takes a segment of SEGMENT
# factors: a thread a factor evaluates it, the block forms the bands
# (12 x 36) in shared memory, writes the kept factors' bands and residuals
# to a workspace (RECORD values a factor) and lists them by base (a piece of
# SEGMENT int32 and S + 1 offsets a segment). Then a block a base gathers
# its factors from the pieces (TILE segments at a time) and stages BATCH
# bands at a time; each base's CHAINS sums (hseg's distinct entries, gseg's)
# go to the workspace. A block's shared memory holds, in phase 0, the
# segment's records, pieces and weights (48 + 8 a factor) and, as int32,
# their meta (8 a factor) and a mask a warp; in phase 1 the staged records
# and, as int32, the gathered list, a count a segment of the tile and a
# scratch value a warp.
THREADS = 256
SEGMENT = 16
BATCH = 16
TILE = THREADS
RECORD = 12 * 36 + 12
CHAINS = 36 * 37 // 2 + 36
MAX_FACTORS = 1 << 26
MAX_WORKSPACE_BYTES = 1 << 31  # a normal-mode call's workspaces together
H100_SMEM_PER_BLOCK = 232_448  # opt-in shared memory of one block (227 KB)
FIELDS = ("valid", "q1", "q2", "a1", "g1", "g2", "p1", "p2", "p3", "il", "ir", "f")


class Plan(NamedTuple):
    threads: int     # a normal-mode block (the kernel is built for THREADS)
    segment: int     # factors a segment of the counting pass (built for SEGMENT)
    batch: int       # bands staged together (built for BATCH)
    smem_bytes: int  # dynamic shared memory of a normal-mode block
    values: int      # the records (RECORD a factor), then the bases' sums (CHAINS a base)
    ints: int        # int32: each segment's offsets by base and its piece


def smem_bytes(itemsize: int) -> int:
    """The normal-mode block's shared memory (csrc/imu_factor.cu, normal_smem)."""
    warps = THREADS // 32
    phase0 = itemsize * SEGMENT * (RECORD + 48 + 8) + 4 * (SEGMENT * 8 + warps)
    phase1 = itemsize * BATCH * RECORD + 4 * (TILE * SEGMENT + TILE + warps)
    return max(phase0, phase1)


def plan(mi: int, s_cap: int, itemsize: int,
         smem_per_block: int = H100_SMEM_PER_BLOCK) -> Plan:
    """The normal-mode launch for Mi factors on S sample states. Raises
    ValueError for what the kernel does not take, and where the workspaces
    would pass MAX_WORKSPACE_BYTES."""
    if not 0 <= mi <= MAX_FACTORS or s_cap < 1 or itemsize not in (4, 8):
        raise ValueError(f"imu_factor: needs 0 <= Mi <= {MAX_FACTORS}, S >= 1 and float32 or "
                         f"float64, got Mi={mi}, S={s_cap}, {itemsize}-byte values")
    nseg = -(-mi // SEGMENT)
    p = Plan(THREADS, SEGMENT, BATCH, smem_bytes(itemsize), mi * RECORD + s_cap * CHAINS,
             nseg * (s_cap + 1 + SEGMENT))
    if workspace_bytes(p, itemsize) > MAX_WORKSPACE_BYTES:
        raise ValueError(f"imu_factor: Mi={mi} factors on S={s_cap} states need "
                         f"{workspace_bytes(p, itemsize)} bytes of workspace, more than "
                         f"{MAX_WORKSPACE_BYTES}")
    if p.smem_bytes > smem_per_block:
        raise ValueError(f"imu_factor: a block needs {p.smem_bytes} bytes of shared memory, "
                         f"more than the {smem_per_block} it can have")
    return p


def workspace_bytes(p: Plan, itemsize: int) -> int:
    """The bytes a normal-mode call takes from torch's allocator besides the
    bands and g: the values' and the int32 workspace."""
    return p.values * itemsize + 4 * p.ints


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
    work = iwork = None
    if normal:  # the workspaces, from torch's allocator
        work = torch.empty((max(p.values, 1),), dtype=cor.dtype, device=cor.device)
        iwork = torch.empty((max(p.ints, 1),), dtype=torch.int32, device=cor.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _build.library()
    with torch.cuda.device(cor.device):  # the C entry launches on the current card
        err = lib.wc_imu_factor(ptrs, len(ins), ptr(r_out), ptr(bands), ptr(g_out), ptr(work),
                                ptr(iwork), mi, s_cap, itemsize, int(normal), k, p.threads,
                                p.segment, p.batch, p.smem_bytes, p.values, p.ints,
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
