"""Dense symmetric positive definite solve: kernel K4 and its plain version.

Counterpart of ``jax.scipy.linalg.cho_factor``/``cho_solve`` in the JAX
package's LM step (``linear_solver="cholesky"``) and of ``jnp.linalg.solve``
in its spline fit (whose matrix N^T N is SPD): XLA operations there, no
Pallas kernel. :func:`spd_solve` solves a x = b through the Cholesky factor
L L^T = a (the lower triangle of ``a`` is read) and returns NaN everywhere
when a pivot is not positive or not finite, as JAX's factorisation does. On
a CUDA tensor it launches the hand-written kernel ``csrc/spd_solve.cu``
(one launch: factorisation, forward and back substitution, laid out by
:func:`plan`), which allocates nothing, so a sweep graph holds it as one
node; on a CPU tensor it runs :func:`spd_solve_plain`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from wildcat_slam_tpu_torch.ops import _build

LAUNCHES = 0  # kernel launches by spd_solve (not by spd_solve_plain)

# csrc/spd_solve.cu: 32 x 32 tiles of [a b; b^T .], shared tiles with rows of
# 36 values. One block of 8 warps when every tile fits its shared memory;
# else the tile dataflow, where each warp keeps four tiles (its own two, two
# staged) and 5 x 32 values in shared memory
TILE = 32
STRIDE = 36
ONE_BLOCK_WARPS = 8
MAX_WARPS = 8        # a block of the dataflow (the kernel's launch bounds)
MAX_RHS = TILE       # the right-hand sides ride in one extra tile row
MAX_N = 65536        # the kernel's item and flag indices
H100_SMS = 132
H100_SMEM_PER_BLOCK = 232_448  # opt-in shared memory of one block (227 KB)


class Plan(NamedTuple):
    one_block: bool  # every tile in one block's shared memory, else the tile dataflow
    grid: int        # blocks (cooperative when more than one)
    warps: int       # warps a block
    tiles: int       # P = ceil(N / 32) tile rows of the factor
    smem_bytes: int  # dynamic shared memory per block
    workspace: int   # elements of the workspace tensor (the dataflow's)
    flags: int       # int32 flags (the dataflow's)


def one_block_smem(tiles: int, itemsize: int) -> int:
    """Shared memory of the one-block path: the P (P + 1) / 2 lower tiles,
    b^T's P tiles and the current diagonal tile's transpose, P x 32
    reciprocals and 4 x 32 values of the diagonal factorisation."""
    return ((tiles * (tiles + 1) // 2 + tiles + 1) * TILE * STRIDE + (tiles + 4) * TILE) * itemsize


def warp_smem(itemsize: int) -> int:
    """Shared memory of one warp of the dataflow: 4 tiles and 5 x 32 values."""
    return (4 * TILE * STRIDE + 5 * TILE) * itemsize


def items(tiles: int) -> int:
    """Work items of the dataflow, each a warp's: a diagonal tile d (with
    (d, d - 1)), each tile (i, j) with i >= j + 2, and b^T's tiles."""
    return tiles * (tiles + 1) // 2 + 1


def plan(n: int, m: int, itemsize: int, sms: int = H100_SMS,
         smem_per_block: int = H100_SMEM_PER_BLOCK) -> Plan:
    """The kernel's launch for an (n, n) system with m right-hand sides of
    ``itemsize``-byte floats. One block while every tile fits its shared
    memory (N <= 256 in float32, N <= 160 in float64 on an H100); else the
    tile dataflow, an item a warp over as many blocks as the card has SMs
    (items beyond go round again), no more warps a block than fit its shared
    memory. Raises ValueError for what it cannot take: more than 32
    right-hand sides, or N above 65536."""
    if not 1 <= n <= MAX_N or not 1 <= m <= MAX_RHS or itemsize not in (4, 8):
        raise ValueError(f"spd_solve: needs 1 <= N <= {MAX_N}, 1 <= m <= {MAX_RHS} right-hand "
                         f"sides and float32 or float64, got N={n}, m={m}, {itemsize}-byte values")
    tiles = -(-n // TILE)
    smem = one_block_smem(tiles, itemsize)
    if smem <= smem_per_block:
        return Plan(True, 1, ONE_BLOCK_WARPS, tiles, smem, 1, 1)
    count = items(tiles)
    grid = min(sms, count)
    warps = min(MAX_WARPS, smem_per_block // warp_smem(itemsize), -(-count // grid))
    lower = tiles * (tiles + 1) // 2
    # the published tiles of L and y^T, the diagonal factors again (as rows),
    # their reciprocal diagonals, x^T, and one L_ik^T x_i a lower tile
    workspace = (lower + 2 * tiles) * TILE * TILE + tiles * TILE + (tiles + lower) * TILE * m
    return Plan(False, grid, warps, tiles, warps * warp_smem(itemsize), workspace,
                2 * (lower + tiles))


def one_block_limit(itemsize: int, smem_per_block: int = H100_SMEM_PER_BLOCK) -> int:
    """The largest N that the one-block path takes."""
    tiles = 1
    while one_block_smem(tiles + 1, itemsize) <= smem_per_block:
        tiles += 1
    return tiles * TILE


def launch_args(p: Plan) -> tuple:
    """The plan's arguments of the C entry, in its order (all fields but the
    two buffer sizes)."""
    return tuple(int(v) for k, v in p._asdict().items() if k not in ("workspace", "flags"))


@functools.lru_cache(maxsize=None)
def _card_plan(device_index: int, n: int, m: int, itemsize: int) -> Plan:
    """:func:`plan` for the card ``device_index``, once per shape: the
    wrapper runs every LM iteration, where host time is the sweep's."""
    props = torch.cuda.get_device_properties(device_index)
    return plan(n, m, itemsize, props.multi_processor_count,
                getattr(props, "shared_memory_per_block_optin", H100_SMEM_PER_BLOCK))


def supports(n: int, m: int, dtype: torch.dtype) -> bool:
    """True when the kernel takes an (n, n) system with m right-hand sides."""
    try:
        plan(n, m, torch.finfo(dtype).bits // 8)
    except ValueError:
        return False
    return True


def spd_solve_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: the library's Cholesky factor and
    triangular solves, NaN everywhere when the factorisation failed (no host
    read: the test is a select)."""
    chol, info = torch.linalg.cholesky_ex(a, check_errors=False)
    x = torch.cholesky_solve(b, chol)
    return torch.where(info == 0, x, torch.full_like(x, float("nan")))


FORWARD_FACTOR = 100  # the forward gap's bound, in units of kappa_2(a) eps


def accuracy(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor, ref: torch.Tensor) -> dict:
    """How a solve ``x`` of a x = b is held to the plain version's ``ref``
    (a the symmetric matrix that a's lower triangle stands for): the
    backward error |a x - b| / (|a| |x| + |b|) in Frobenius norms, bound
    10 N eps, and the forward gap max|x - ref| / max|ref|, bound
    FORWARD_FACTOR kappa_2(a) eps (kappa_2 in float64 from the eigenvalues;
    a sound solve reads a few kappa eps, one 32 x 32 tile's update left out
    reads ~100 times the bound at N = 1152). ``ok`` when x is finite and
    both are within their bounds."""
    n = a.shape[0]
    eps = torch.finfo(a.dtype).eps
    sym = torch.tril(a) + torch.tril(a, -1).T
    backward = float(torch.linalg.norm(sym @ x - b)
                     / (torch.linalg.norm(sym) * torch.linalg.norm(x) + torch.linalg.norm(b)))
    eig = torch.linalg.eigvalsh(sym.double()).abs()
    kappa = float(eig.max() / eig.min())
    forward = float(torch.max(torch.abs(x - ref)) / torch.max(torch.abs(ref)))
    out = dict(backward=backward, backward_bound=10 * n * eps, forward=forward,
               forward_bound=FORWARD_FACTOR * kappa * eps, kappa=kappa)
    out["ok"] = (bool(torch.all(torch.isfinite(x))) and backward <= out["backward_bound"]
                 and forward <= out["forward_bound"])
    return out


def spd_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = a^-1 b for a symmetric positive definite (N, N) ``a`` (its lower
    triangle read) and (N, m) ``b``, float32 or float64 on one device: the
    kernel for CUDA tensors, the plain version for CPU tensors. NaN
    everywhere when a pivot is not positive or not finite."""
    global LAUNCHES
    n = a.shape[0]
    if a.shape != (n, n) or b.dim() != 2 or b.shape[0] != n or a.dtype != b.dtype \
            or a.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"spd_solve: needs a (N, N) and b (N, m) of one float dtype, got "
                         f"a{tuple(a.shape)} {a.dtype}, b{tuple(b.shape)} {b.dtype}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return spd_solve_plain(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"spd_solve: unsupported devices {a.device}, {b.device}")
    index = a.device.index if a.device.index is not None else torch.cuda.current_device()
    p = _card_plan(index, n, b.shape[1], a.element_size())
    a, b = a.contiguous(), b.contiguous()
    x = torch.empty_like(b)
    work = torch.empty(p.workspace, dtype=a.dtype, device=a.device)
    flags = torch.empty(p.flags, dtype=torch.int32, device=a.device)  # zeroed by the kernel
    lib = _build.library()
    with torch.cuda.device(a.device):  # the C entry launches on the current card
        err = lib.wc_spd_solve(a.data_ptr(), b.data_ptr(), x.data_ptr(), work.data_ptr(),
                               flags.data_ptr(), n, b.shape[1], a.element_size(), *launch_args(p),
                               torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "wc_spd_solve")
    LAUNCHES += 1
    return x
