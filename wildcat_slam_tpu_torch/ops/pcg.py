"""Block-Jacobi PCG solve of the LM step: kernel K1 and its plain version.

Counterpart of ``wildcat_slam_tpu/ops/pcg_pallas.py``. :func:`pcg_solve`
solves x ~ (H + diag(dlam))^-1 b with the S damped 12x12 block inverses as
preconditioner. On a CUDA tensor it launches the hand-written kernel
``csrc/pcg.cu`` (one cooperative launch for the whole solve, laid out by
:func:`launch_plan`); on a CPU tensor it runs :func:`pcg_solve_plain`, the
same recurrence in plain PyTorch. The preconditioner helpers
(``batched_small_inverse``, ``extract_diag_blocks``, ``block_diag_inverse``)
are plain tensor code, as they were XLA code in the JAX package.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from wildcat_slam_tpu_torch.ops import _build

LAUNCHES = 0  # kernel launches by pcg_solve (not by pcg_solve_plain)

# csrc/pcg.cu: 384 threads a block, one thread per owned row in 16-lane groups
# (kMaxRowsPerBlock = 24 block-rows a block), kStaticSmem bytes of static
# shared memory beside the plan's dynamic shared memory.
MAX_ROWS_PER_BLOCK = 24
STATIC_SMEM = 1024
H100_SMS = 132
H100_SMEM_PER_BLOCK = 232_448  # opt-in shared memory of one block (227 KB)
# N <= 12000 keeps p (48 KB) in shared memory and at most 24 block-rows per
# block on any card with 42 or more SMs
MAX_N = 12000


class LaunchPlan(NamedTuple):
    grid: int            # blocks, all co-resident (one per SM)
    rows_per_block: int  # block-rows each block owns (the last block may own fewer)
    resident: int        # of them, held in shared memory for the whole solve
    smem_bytes: int      # dynamic shared memory per block: resident rows of H, then p


def launch_plan(s_cap: int, sms: int = H100_SMS,
                smem_per_block: int = H100_SMEM_PER_BLOCK) -> LaunchPlan:
    """The kernel's launch for a system of ``s_cap`` 12x12 blocks on a card
    with ``sms`` SMs: the block-rows split into contiguous runs of
    ceil(S / sms), one block per run, each block holding as many of its
    block-rows of H in shared memory as fit beside p and streaming the rest
    from L2. Raises ValueError for what the kernel cannot take."""
    n = 12 * s_cap
    if not 1 <= s_cap or n > MAX_N:
        raise ValueError(f"pcg_solve: S={s_cap} blocks (N={n}) exceeds the kernel's N <= {MAX_N}: "
                         f"p (4N bytes) is held in shared memory and each block owns at most "
                         f"{MAX_ROWS_PER_BLOCK} block-rows")
    k = -(-s_cap // sms)
    room = smem_per_block - STATIC_SMEM - 4 * n
    if k > MAX_ROWS_PER_BLOCK or room < 0:
        raise ValueError(f"pcg_solve: S={s_cap} blocks do not fit a card with {sms} SMs and "
                         f"{smem_per_block} bytes of shared memory per block")
    resident = min(k, room // (4 * 12 * n))
    return LaunchPlan(-(-s_cap // k), k, resident, 4 * n * (1 + 12 * resident))


@functools.lru_cache(maxsize=None)
def _card_plan(device_index: int, s_cap: int) -> LaunchPlan:
    """:func:`launch_plan` for the card ``device_index``, once per (card, S):
    the wrapper runs every LM iteration, where host time is the sweep's."""
    props = torch.cuda.get_device_properties(device_index)
    return launch_plan(s_cap, props.multi_processor_count,
                       getattr(props, "shared_memory_per_block_optin", H100_SMEM_PER_BLOCK))


def supports(s_cap: int) -> bool:
    """True when the kernel takes a system of ``s_cap`` 12x12 blocks."""
    try:
        launch_plan(s_cap)
    except ValueError:
        return False
    return True


def pcg_solve_plain(h, dlam, minv, b, iters: int, tol: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same recurrence, same early exit
    (|r|^2 <= tol^2 |b|^2, tested before each iteration). On CPU tensors the
    exit is a host read, which costs no sync there. On a card it is taken on
    the device, so that a sweep graph can hold it (``linear_solver="pcg_xla"``):
    every iteration runs, and once the test fails none changes anything, so
    the result is the early-exited one."""
    n = h.shape[0]
    s_cap = n // 12
    tiny = 1e-30
    on_host = h.device.type == "cpu"

    def prec(r):
        return torch.sum(minv * r.reshape(s_cap, 1, 12), dim=2).reshape(n)

    b2 = torch.sum(b * b)
    x = torch.zeros_like(b)
    r = b
    p = prec(r)
    rz = torch.sum(r * p)
    for _ in range(iters):
        go = torch.sum(r * r) > tol * tol * b2
        if on_host and not bool(go):
            break
        hp = h @ p + dlam * p
        alpha = rz / torch.clamp(torch.sum(p * hp), min=tiny)
        r_new = r - alpha * hp
        z = prec(r_new)
        rz_new = torch.sum(r_new * z)
        beta = rz_new / torch.clamp(rz, min=tiny)
        if on_host:
            x, r, p, rz = x + alpha * p, r_new, z + beta * p, rz_new
        else:
            x = torch.where(go, x + alpha * p, x)
            p = torch.where(go, z + beta * p, p)
            r = torch.where(go, r_new, r)
            rz = torch.where(go, rz_new, rz)
    return x


def pcg_solve(h, dlam, minv, b, iters: int, tol: float) -> torch.Tensor:
    """x ~ (H + diag(dlam))^-1 b: the kernel for CUDA tensors, the plain
    version for CPU tensors. h (N, N) with N = 12 S, dlam (N,), minv
    (S, 12, 12), b (N,). H must be symmetric (the kernel reads rows)."""
    global LAUNCHES
    n = h.shape[0]
    if h.shape != (n, n) or n % 12 or dlam.shape != (n,) or b.shape != (n,) \
            or minv.shape != (n // 12, 12, 12):
        raise ValueError(f"pcg_solve: bad shapes h{tuple(h.shape)} dlam{tuple(dlam.shape)} "
                         f"minv{tuple(minv.shape)} b{tuple(b.shape)}")
    if h.device.type == "cpu":
        return pcg_solve_plain(h, dlam, minv, b, iters, tol)
    if h.device.type != "cuda":
        raise ValueError(f"pcg_solve: unsupported device {h.device}")
    index = h.device.index if h.device.index is not None else torch.cuda.current_device()
    plan = _card_plan(index, n // 12)
    ts = (h, dlam, minv, b)
    if any(t.dtype != torch.float32 or t.device != h.device for t in ts):
        raise ValueError("pcg_solve: the kernel takes float32 tensors on one device "
                         "(linear_solver='pcg_xla' runs the plain PCG in any dtype)")
    h, dlam, minv, b = (t.contiguous() for t in ts)
    if h.data_ptr() % 16:  # the kernel reads H as float4s and copies its rows by TMA
        h = h.clone()
    x = torch.empty_like(b)
    scratch = torch.empty(n + 3 * plan.grid + 1, dtype=torch.float32, device=h.device)
    lib = _build.library()
    with torch.cuda.device(h.device):  # the C entry launches on the current card
        err = lib.wc_pcg_solve(h.data_ptr(), dlam.data_ptr(), minv.data_ptr(), b.data_ptr(),
                               x.data_ptr(), scratch.data_ptr(), n, int(iters),
                               float(tol * tol), *plan,
                               torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(err, "wc_pcg_solve")
    LAUNCHES += 1
    return x


def batched_small_inverse(a: torch.Tensor) -> torch.Tensor:
    """Batched (B, n, n) inverse by unrolled Gauss-Jordan without pivoting
    (valid for the SPD damped diagonal blocks)."""
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape)
    aug = torch.cat([a, eye], dim=-1)
    for k in range(n):
        piv = aug[:, k, :] / aug[:, k, k:k + 1]
        aug = aug - aug[:, :, k:k + 1] * piv[:, None, :]
        aug[:, k, :] = piv
    return aug[:, :, n:]


def extract_diag_blocks(h: torch.Tensor, s_cap: int) -> torch.Tensor:
    """(S, 12, 12) diagonal blocks of (S*12, S*12) H."""
    return h.reshape(s_cap, 12, s_cap, 12).diagonal(dim1=0, dim2=2).permute(2, 0, 1)


def block_diag_inverse(h, dlam, s_cap: int, diag_blocks=None) -> torch.Tensor:
    """(S, 12, 12) inverses of the damped 12x12 diagonal blocks of H."""
    if diag_blocks is None:
        diag_blocks = extract_diag_blocks(h, s_cap)
    return batched_small_inverse(diag_blocks + torch.diag_embed(dlam.reshape(s_cap, 12)))
