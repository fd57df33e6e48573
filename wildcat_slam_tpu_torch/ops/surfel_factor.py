"""The surfel factors' residuals and normal equations, and H: kernel K6.

Counterpart of the JAX package's ``factors.surfel_residuals`` followed by
``solver._surfel_normal_eqs`` and the assembly of H in ``solve_window``
(the block bands placed, D + D^T, the gauge mask), which XLA fuses inside
the jitted sweep (no Pallas kernel stands behind them). :func:`residuals`
gives the masked residuals r (M,) and :func:`normal_eqs` H (S 12, S 12) and
g (S 12) from the factors, the IMU factors' bands and g (kernel K5's
output) and the gauge mask, one launch each of ``csrc/surfel_factor.cu`` on
CUDA tensors; both raise for anything else. The cross matrix D over the
binary rows is formed sparsely: the block (s, t) of H sums only the factors
with a side bracketed at s and the other at t. What bounds the kernel is
latency (dependent loads and FMA chains, grid barriers), not its ~2 us of
bytes: it reads each factor once (two threads a factor), builds the block
rows' lists and the pairs' lists by one stable counting pass over the grid
(a block sorts a segment's keys; scans over the segments place them), gives
a warp only to the pairs that hold factors, and spreads a row's sums over
chunks and then a block. The plain version is
``odometry/factors.surfel_residuals_plain`` (with its Jacobians) followed by
``odometry/solver.surfel_normal_eqs_plain``; the port's entry points
``factors.surfel_residuals`` and ``solver._surfel_normal_eqs`` run it on CPU
tensors and these on CUDA tensors.

The kernel needs brackets with ``ir`` in ``{il, il + 1}``, as
``factors.sample_bracket`` gives them: a block row lists the factors whose
``il`` is the row or the one before. Where the plain version's dense one-hot
products carry a non-finite Jacobian of one factor into every entry of H,
the kernel carries it into the entries that factor touches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from wildcat_slam_tpu_torch.ops import _build

LAUNCHES = 0  # kernel launches by residuals and normal_eqs (not by the plain version)

# csrc/surfel_factor.cu, normal mode: one cooperative launch of blocks of
# THREADS threads, three grid barriers. A block takes a segment of SEGMENT
# factors: it writes each factor's record (RECORD values: j1v, j2v, rs_w,
# f1, f2) and packed brackets, sorts the segment's keys (the block rows and
# the pairs of block rows each factor reaches, at most four of each) and
# writes its pieces (its row entries and its pair entries, by key then
# factor) with each key's offset in them, and its rows' counts; the rows'
# lists (at most 4 M entries: a factor sits in at most four) are placed
# after a scan over the segments. Then a warp a chunk of CHUNK entries of a
# row's list (its partial sums, PARTIAL values, to a workspace; at most
# S + 4 M / CHUNK chunks) or a pair of block rows that holds factors, whose
# list is its run in each segment's pair piece; then a block a fifth of a
# block row.
THREADS = 256
RECORD = 28
CHUNK = 64
PARTIAL = 6 * 144 + 24
SEGMENT = 128
MAX_FACTORS = 1 << 26
MAX_STATES = 4096
MAX_WORKSPACE_BYTES = 1 << 31  # a normal-mode call's workspaces together
FIELDS = ("valid", "w", "n", "opt1", "v1", "p1", "i1l", "i1r", "f1", "v2", "p2", "i2l", "i2r",
          "f2")


class Plan(NamedTuple):
    threads: int    # a normal-mode block (the kernel is built for THREADS)
    chunk: int      # list entries a chunk (built for CHUNK)
    segment: int    # factors a segment of the counting pass (built for SEGMENT)
    values: int     # the records (RECORD a factor), then the chunks' partial sums
    ints: int       # int32: packed brackets, the segments' pieces and offsets, the lists


def plan(m: int, nb: int, s_cap: int, itemsize: int) -> Plan:
    """The normal-mode launch for M factors (nb binary) on S sample states.
    Raises ValueError for what the kernel does not take, and where the
    workspaces would pass MAX_WORKSPACE_BYTES (the pair offsets grow as
    nb S^2)."""
    if not 0 <= nb <= m <= MAX_FACTORS or not 1 <= s_cap <= MAX_STATES or itemsize not in (4, 8):
        raise ValueError(f"surfel_factor: needs 0 <= nb <= M <= {MAX_FACTORS}, 1 <= S <= "
                         f"{MAX_STATES} and float32 or float64, got M={m}, nb={nb}, S={s_cap}, "
                         f"{itemsize}-byte values")
    nseg, npseg = -(-m // SEGMENT), -(-nb // SEGMENT)
    pairs = s_cap * (s_cap + 1) // 2
    piece = 4 * SEGMENT
    values = m * RECORD + (s_cap + 4 * m // CHUNK) * PARTIAL
    ints = (2 * m + nseg * (2 * s_cap + 1 + piece) + 4 * m + npseg * (pairs + 1 + piece) + pairs
            + 2 * (s_cap + 1))
    p = Plan(THREADS, CHUNK, SEGMENT, values, ints)
    if workspace_bytes(p, itemsize) > MAX_WORKSPACE_BYTES:
        raise ValueError(f"surfel_factor: M={m} factors ({nb} binary) on S={s_cap} states need "
                         f"{workspace_bytes(p, itemsize)} bytes of workspace, more than "
                         f"{MAX_WORKSPACE_BYTES}")
    return p


def workspace_bytes(p: Plan, itemsize: int) -> int:
    """The bytes a normal-mode call takes from torch's allocator besides H
    and g: the values' and the int32 workspace."""
    return p.values * itemsize + 4 * p.ints


def supports(m: int, nb: int, s_cap: int, dtype: torch.dtype) -> bool:
    """True when the kernel takes M factors (nb binary) on S states in ``dtype``."""
    try:
        plan(m, nb, s_cap, torch.finfo(dtype).bits // 8 if dtype.is_floating_point else 0)
    except ValueError:
        return False
    return True


def _inputs(fac, cor: torch.Tensor) -> list:
    """The kernel's inputs in its order, contiguous, after the checks that
    need no host read."""
    dtype, dev = cor.dtype, cor.device
    m = fac.valid.shape[0]
    if dev.type != "cuda" or dtype not in (torch.float32, torch.float64) or cor.dim() != 2 \
            or cor.shape[1] != 12:
        raise ValueError(f"surfel_factor: needs cor (S, 12) float32 or float64 on a CUDA card, "
                         f"got {tuple(cor.shape)} {dtype} on {dev}")
    out = []
    for name in FIELDS:
        t = getattr(fac, name)
        want = torch.bool if name in ("valid", "opt1") else \
            torch.int64 if name[0] == "i" else dtype
        if t.device != dev or t.dtype != want or t.shape[0] != m:
            raise ValueError(f"surfel_factor: field {name} is {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}; needs {want} on {dev} with M={m} rows")
        out.append(t.contiguous())
    return out + [cor.contiguous()]


def _launch(fac, cor, nb: int, a2: float, r_out, imu_bands, gi, fm, h, g_out,
            normal: bool) -> None:
    global LAUNCHES
    ins = _inputs(fac, cor)
    m, s_cap, itemsize = fac.valid.shape[0], cor.shape[0], cor.element_size()
    p = plan(m, nb, s_cap, itemsize)
    ptrs = (ctypes.c_void_p * len(ins))(*(t.data_ptr() for t in ins))
    work = iwork = None
    if normal:  # the workspaces, from torch's allocator
        work = torch.empty((max(p.values, 1),), dtype=cor.dtype, device=cor.device)
        iwork = torch.empty((max(p.ints, 1),), dtype=torch.int32, device=cor.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _build.library()
    with torch.cuda.device(cor.device):  # the C entry launches on the current card
        err = lib.wc_surfel_factor(ptrs, len(ins), ptr(r_out), ptr(imu_bands), ptr(gi), ptr(fm),
                                   ptr(h), ptr(g_out), ptr(work), ptr(iwork), m, nb, s_cap,
                                   itemsize, int(normal), float(a2), p.threads, p.chunk,
                                   p.segment, p.values, p.ints,
                                   torch.cuda.current_stream(cor.device).cuda_stream)
    _build.check(err, "wc_surfel_factor")
    LAUNCHES += 1


def residuals(fac, cor: torch.Tensor) -> torch.Tensor:
    """The residuals r (M,), where(valid, r, 0), by the kernel."""
    r = torch.empty((fac.valid.shape[0],), dtype=cor.dtype, device=cor.device)
    _launch(fac, cor, 0, 1.0, r, None, None, None, None, None, normal=False)
    return r


def normal_eqs(fac, cor: torch.Tensor, a2: float, imu_bands: torch.Tensor, gi: torch.Tensor,
               fm: torch.Tensor, nb: int):
    """(H, g) by the kernel: the surfel factors (the first nb binary) with
    their Cauchy IRLS weights (a2 = cauchy_scale^2), the IMU factors' bands
    (5, S, 12, 12) and gi (S 12), and the gauge mask fm (S 12) applied as
    H fm fm^T + diag(1 - fm), g = (g_surfel + gi) fm."""
    s_cap = cor.shape[0]
    n = 12 * s_cap
    dtype, dev = cor.dtype, cor.device
    for name, t, shape in (("imu_bands", imu_bands, (5, s_cap, 12, 12)), ("gi", gi, (n,)),
                           ("fm", fm, (n,))):
        if t.shape != shape or t.dtype != dtype or t.device != dev:
            raise ValueError(f"surfel_factor: needs {name} {shape} {dtype} on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    h = torch.empty((n, n), dtype=dtype, device=dev)
    g = torch.empty((n,), dtype=dtype, device=dev)
    _launch(fac, cor, nb, a2, None, imu_bands.contiguous(), gi.contiguous(), fm.contiguous(), h,
            g, normal=True)
    return h, g
