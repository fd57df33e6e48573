"""Block-Jacobi PCG solve of the LM step: kernel K1 and its plain version.

Counterpart of ``wildcat_slam_tpu/ops/pcg_pallas.py``. :func:`pcg_solve`
solves x ~ (H + diag(dlam))^-1 b with the S damped 12x12 block inverses as
preconditioner. On a CUDA tensor it launches the hand-written kernel
``csrc/pcg.cu`` (one cooperative launch for the whole solve); on a CPU tensor
it runs :func:`pcg_solve_plain`, the same recurrence in plain PyTorch. The
preconditioner helpers (``batched_small_inverse``, ``extract_diag_blocks``,
``block_diag_inverse``) are plain tensor code, as they were XLA code in the
JAX package.
"""

from __future__ import annotations

import torch

from wildcat_slam_tpu_torch.ops import _build

LAUNCHES = 0  # kernel launches by pcg_solve (not by pcg_solve_plain)

MAX_N = 12000  # csrc/pcg.cu kMaxN: the staged p vector must fit 48 KB of shared memory


def supports(s_cap: int) -> bool:
    """True when the kernel takes a system of ``s_cap`` 12x12 blocks."""
    return 1 <= s_cap and 12 * s_cap <= MAX_N


def pcg_solve_plain(h, dlam, minv, b, iters: int, tol: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same recurrence, same early exit
    (|r|^2 <= tol^2 |b|^2, tested before each iteration), one host sync per
    iteration for the exit test."""
    n = h.shape[0]
    s_cap = n // 12
    tiny = 1e-30

    def prec(r):
        return torch.sum(minv * r.reshape(s_cap, 1, 12), dim=2).reshape(n)

    b2 = torch.sum(b * b)
    x = torch.zeros_like(b)
    r = b
    p = prec(r)
    rz = torch.sum(r * p)
    for _ in range(iters):
        if not bool(torch.sum(r * r) > tol * tol * b2):
            break
        hp = h @ p + dlam * p
        alpha = rz / torch.clamp(torch.sum(p * hp), min=tiny)
        x = x + alpha * p
        r = r - alpha * hp
        z = prec(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.clamp(rz, min=tiny)
        p = z + beta * p
        rz = rz_new
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
    if not supports(n // 12):
        raise ValueError(f"pcg_solve: S={n // 12} blocks (N={n}) exceeds the kernel's "
                         f"N <= {MAX_N}: the staged p vector must fit 48 KB of shared memory")
    ts = (h, dlam, minv, b)
    if any(t.dtype != torch.float32 or t.device != h.device for t in ts):
        raise ValueError("pcg_solve: the kernel takes float32 tensors on one device "
                         "(linear_solver='pcg_xla' runs the plain PCG in any dtype)")
    h, dlam, minv, b = (t.contiguous() for t in ts)
    x = torch.empty_like(b)
    scratch = torch.empty(3 * n + 3 * (n // 12), dtype=torch.float32, device=h.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = lib.wc_pcg_solve(h.data_ptr(), dlam.data_ptr(), minv.data_ptr(), b.data_ptr(),
                           x.data_ptr(), scratch.data_ptr(), n, int(iters),
                           float(tol * tol), stream)
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
