"""Sliding-window solver: Levenberg-Marquardt with Cauchy IRLS.

Counterpart of ``wildcat_slam_tpu/odometry/solver.py``: the banded IMU normal
equations, the structured surfel normal equations, exact symmetry of H,
gauge masking, and Nielsen's gain-ratio LM schedule. On a CUDA tensor the
normal equations are two launches: kernel K5 (``ops/imu_factor.py``: the
IMU factors' residuals, Jacobians and five block bands) and kernel K6
(``ops/surfel_factor.py``: the surfel factors', the cross matrix D formed
sparsely, and H assembled and masked); their plain versions
(:func:`imu_banded_normal_eqs_plain`, :func:`surfel_normal_eqs_plain`: the
diagonal families by one-hot contractions, the cross family by one
(S*12 x nb) x (nb x S*12) product in full f32) run on the CPU. The
``lax.while_loop`` keeps its state on the device (cor, cost, lambda, nu,
the iteration count, H and g, updated in place) and leaves the loop to
``lm_loop``: run eagerly (:func:`lm_loop_eager`, the host reads the step's
(re-linearise, done) flags), or, on the card, captured as an LM-step graph and a
re-linearisation graph (the JAX ``lax.cond``) that ``odometry/graph.py``
runs in a device-side WHILE node, the flags read by a kernel.

Linear solver: ``"pcg"`` calls ``ops/pcg.pcg_solve``, which launches kernel
K1 on CUDA float32 tensors, runs its plain version on CPU tensors and raises
otherwise; ``"pcg_xla"`` calls the plain version ``pcg_solve_plain`` directly
(the role of the JAX package's portable ``_pcg_solve``); ``"cholesky"`` calls
``ops/spd.spd_solve`` on the damped system, which launches kernel K4 on CUDA
tensors (float32 and float64; one node of the sweep graph) and runs its plain
version (``torch.linalg.cholesky_ex``, NaN when the factorisation fails, as
JAX's ``cho_factor``) on CPU tensors. Both PCGs fold the damping into the
matvec.

With ``remap_proj`` (degeneracy solution remapping) the common-mode mean of
the per-state rotation and position steps is projected off the weak axes
before the candidate's cost is evaluated; with both projectors zero the
step is unchanged bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from wildcat_slam_tpu_torch.odometry import factors as fmod
from wildcat_slam_tpu_torch.odometry.states import SampleStates
from wildcat_slam_tpu_torch.ops import imu_factor, surfel_factor
from wildcat_slam_tpu_torch.ops import pcg as pcg_mod
from wildcat_slam_tpu_torch.ops import spd as spd_mod


def _shift_down(a, d: int):
    """a[r - d] along axis 0 with zeros for r < d."""
    if d == 0:
        return a
    return torch.cat([torch.zeros_like(a[:d]), a[:-d]], 0)


def _add_band(bands, delta, blk):
    bands[delta] = blk if delta not in bands else bands[delta] + blk


def _place_block_bands(bands, s_cap: int, dtype, device):
    """Dense (S*12, S*12) H from per-delta block bands: B_delta[r] is the
    12x12 block at block-row r, block-col r + delta."""
    n = s_cap * 12
    h4 = torch.zeros((s_cap, 12, s_cap, 12), dtype=dtype, device=device)
    ar = torch.arange(s_cap, device=device)
    for delta, blk in sorted(bands.items()):
        rows = ar[max(0, -delta):s_cap - max(0, delta)]
        h4[rows, :, rows + delta, :] += blk[rows]
    return h4.reshape(n, n)


def _imu_banded_normal_eqs(ifac, cor, weights, dt: float, grav, s_cap: int):
    """The IMU factors' part of (H, g): the five block bands (5, S, 12, 12),
    band d holding the blocks at (r, r + d - 2), and g. Kernel K5 on a CUDA
    tensor, :func:`imu_banded_normal_eqs_plain` on a CPU one."""
    if cor.device.type != "cpu":
        return imu_factor.normal_eqs(ifac, cor, weights, dt, grav)
    return imu_banded_normal_eqs_plain(ifac, cor, weights, dt, grav, s_cap)


def imu_banded_normal_eqs_plain(ifac, cor, weights, dt: float, grav, s_cap: int):
    """K5's plain version: the residuals and Jacobians, then every factor's
    contiguous 3-block band from ``base = min(idx)``, its outer products
    reduced per base into (S, 36, 36) and read off as five block bands."""
    ri, jac, idx = fmod.imu_residuals_plain(ifac, cor, weights, dt, grav)
    dtype = jac.dtype
    base = torch.min(idx, dim=1).values
    rel = idx - base[:, None]
    band = torch.cat([
        sum(torch.where((rel[:, k] == d)[:, None, None], jac[:, k], 0.0) for k in range(6))
        for d in range(3)], 2)                                          # (Mi, 12, 36)
    hb = torch.einsum("mri,mrj->mij", band, band)
    gb = torch.einsum("mri,mr->mi", band, ri)
    oh = (base[:, None] == torch.arange(s_cap, device=jac.device)[None, :]).to(dtype)
    hseg = torch.einsum("ms,mij->sij", oh, hb).reshape(s_cap, 3, 12, 3, 12)
    gseg = torch.einsum("ms,mi->si", oh, gb).reshape(s_cap, 3, 12)
    bands = {}
    for di in range(3):
        for dj in range(3):
            _add_band(bands, dj - di, _shift_down(hseg[:, di, :, dj, :], di))
    g = sum(_shift_down(gseg[:, di], di) for di in range(3)).reshape(s_cap * 12)
    return torch.stack([bands[d] for d in range(-2, 3)]), g


def _surfel_normal_eqs(sfac, cor, a2: float, imu_bands, gi, fm, s_cap: int, nb: int,
                       w_interp=None):
    """(H, g) of the window: the surfel factors' part (the first nb binary)
    with the IMU factors' bands and gi added and the gauge mask fm applied.
    Kernel K6 on a CUDA tensor, :func:`surfel_normal_eqs_plain` on a CPU one
    (``w_interp``: the plain version's (M, S) bracket-lerp matrices)."""
    if cor.device.type != "cpu":
        return surfel_factor.normal_eqs(sfac, cor, a2, imu_bands, gi, fm, nb)
    return surfel_normal_eqs_plain(sfac, cor, a2, imu_bands, gi, fm, s_cap, nb, w_interp)


def surfel_normal_eqs_plain(sfac, cor, a2: float, imu_bands, gi, fm, s_cap: int, nb: int,
                            w_interp=None):
    """K6's plain version: the residuals, IRLS weights and Jacobians, the
    diagonal families by one-hot contractions, the dense cross matrix D over
    the binary rows (H gets D + D^T), the bands placed, the mask applied."""
    dtype = cor.dtype
    S = s_cap
    if w_interp is None:
        w_interp = fmod.interp_weights(sfac, s_cap, dtype)
    rs, jac_s, _ = fmod.surfel_residuals_plain(sfac, cor, w_interp=w_interp)
    sw = 1.0 / torch.sqrt(1.0 + rs * rs / a2)
    j1v = (jac_s[:, 0] + jac_s[:, 1]) * sw[:, None]
    j2v = (jac_s[:, 2] + jac_s[:, 3]) * sw[:, None]
    rs_w = rs * sw
    w1, w2 = w_interp
    gs = (torch.einsum("ms,mi->si", w1, j1v * rs_w[:, None])
          + torch.einsum("ms,mi->si", w2, j2v * rs_w[:, None])).reshape(S * 12)
    ar = torch.arange(S, device=cor.device)

    def diag_payload(jv, f):
        a = (jv[:, :, None] * jv[:, None, :]).reshape(jv.shape[0], 144)
        c = torch.stack([(1.0 - f) * (1.0 - f), (1.0 - f) * f, f * f], 1)
        return (c[:, :, None] * a[:, None, :]).reshape(jv.shape[0], 3 * 144)

    oh1 = (sfac.i1l[:nb, None] == ar).to(dtype)
    oh2 = (sfac.i2l[:, None] == ar).to(dtype)
    t11 = torch.einsum("ms,mx->sx", oh1, diag_payload(j1v[:nb], sfac.f1[:nb])).reshape(S, 3, 12, 12)
    t22 = torch.einsum("ms,mx->sx", oh2, diag_payload(j2v, sfac.f2)).reshape(S, 3, 12, 12)
    tdiag = t11 + t22
    bands = {d: imu_bands[d + 2] for d in range(-2, 3)}
    _add_band(bands, 0, tdiag[:, 0] + _shift_down(tdiag[:, 2], 1))
    _add_band(bands, 1, tdiag[:, 1])
    _add_band(bands, -1, _shift_down(tdiag[:, 1], 1))
    # the big Gram: full f32 (TF32 off, _numerics.py), outside any kernel
    b1 = (w1[:nb, :, None] * j1v[:nb, None, :]).reshape(nb, S * 12)
    b2 = (w2[:nb, :, None] * j2v[:nb, None, :]).reshape(nb, S * 12)
    d = b1.T @ b2
    # (d + d.T) is exactly symmetric and the banded part is too, so H is
    # bit-exactly symmetric (the K1 kernel reads its rows as columns)
    h = _place_block_bands(bands, s_cap, dtype, cor.device) + (d + d.T)
    h = h * fm[:, None] * fm[None, :] + torch.diag(1.0 - fm)
    return h, (gs + gi) * fm


def lm_loop_eager(lm_step, relinearize, max_iterations: int) -> None:
    """The LM loop run eagerly: at most ``max_iterations`` calls of
    ``lm_step``, which returns the device flags (re-linearise, done); the host
    reads them, one sync each an iteration, and stops on done."""
    for _ in range(max_iterations):
        flags = lm_step()
        if bool(flags[1]):
            break
        if bool(flags[0]):
            relinearize()


class SolveStats(NamedTuple):
    iterations: torch.Tensor
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    lambda_final: torch.Tensor


def solve_window(sample: SampleStates, sfac, ifac, weights, dt: float, grav,
                 fix_first_pos, cauchy_scale: float = 0.4, max_iterations: int = 100,
                 init_lambda: float = 1e-4, function_tolerance: float = 1e-6,
                 linear_solver: str = "pcg", pcg_iters: int = 96, pcg_tol: float = 1e-6,
                 n_binary: int | None = None, remap_proj=None, lm_loop=None):
    """Optimize the correction state of the sliding window. ``remap_proj`` is
    None or the (W_t, W_r) projectors of ``factors.degeneracy_projectors``.
    ``lm_loop(lm_step, relinearize, max_iterations)`` runs the LM iterations
    (default :func:`lm_loop_eager`; ``odometry/graph.py`` passes the one that
    captures them). Returns (sample with updated cor, SolveStats)."""
    s_cap = sample.capacity
    n_par = s_cap * 12
    dtype = sample.cor.dtype
    dev = sample.cor.device
    a2 = cauchy_scale**2

    par = torch.arange(n_par, device=dev)
    par_state, par_slot = par // 12, par % 12
    frozen_pos0 = (par_state == 0) & (par_slot >= 3) & (par_slot < 6) & fix_first_pos
    fm = ((par_state < sample.count) & ~frozen_pos0).to(dtype)
    nb = sfac.valid.shape[0] if n_binary is None else n_binary
    # the (M, S) bracket-lerp matrices of the plain versions; the kernels
    # read the brackets themselves
    w_interp = fmod.interp_weights(sfac, s_cap, dtype) if dev.type == "cpu" else None
    tiny = torch.finfo(dtype).tiny

    def remap_step(delta):
        if remap_proj is None:
            return delta
        w_t, w_r = remap_proj
        smask = (torch.arange(s_cap, device=dev) < sample.count).to(dtype)
        s_count = torch.clamp(torch.sum(smask), min=1.0)
        d2 = delta.reshape(s_cap, 12)
        sub_rot = w_r @ (torch.einsum("s,si->i", smask, d2[:, 0:3]) / s_count)
        sub_pos = w_t @ (torch.einsum("s,si->i", smask, d2[:, 3:6]) / s_count)
        d2 = torch.cat([d2[:, 0:3] + (-smask[:, None] * sub_rot[None, :]),
                        d2[:, 3:6] + (-smask[:, None] * sub_pos[None, :]), d2[:, 6:]], 1)
        return d2.reshape(-1)

    def eval_cost(cor_flat):
        cor = cor_flat.reshape(s_cap, 12)
        rs, _, _ = fmod.surfel_residuals(sfac, cor, with_jac=False, w_interp=w_interp)
        ri, _, _ = fmod.imu_residuals(ifac, cor, weights, dt, grav, with_jac=False)
        return 0.5 * (torch.sum(a2 * torch.log1p(rs * rs / a2)) + torch.sum(ri * ri))

    def build_normal_eqs(cor_flat):
        cor = cor_flat.reshape(s_cap, 12)
        bands, gi = _imu_banded_normal_eqs(ifac, cor, weights, dt, grav, s_cap)
        return _surfel_normal_eqs(sfac, cor, a2, bands, gi, fm, s_cap, nb, w_interp)

    def linear_solve(h, g, lam, d):
        dlam = lam * d
        if linear_solver == "cholesky":
            # NaN when a pivot fails, as jax.scipy's cho_factor: the step is rejected
            return -spd_mod.spd_solve(h + torch.diag(dlam), g[:, None])[:, 0]
        minv = pcg_mod.block_diag_inverse(h, dlam, s_cap)
        solve = pcg_mod.pcg_solve if linear_solver == "pcg" else pcg_mod.pcg_solve_plain
        return solve(h, dlam, minv, -g, pcg_iters, pcg_tol)

    # the loop state lives in buffers that each iteration updates in place, so
    # that the iteration can be captured once and replayed (odometry/graph.py)
    cor = sample.cor.reshape(-1).clone()
    cost0 = eval_cost(cor)
    cost = cost0.clone()
    h, g = build_normal_eqs(cor)
    lam = torch.full((), init_lambda, dtype=dtype, device=dev)
    nu = torch.full((), 2.0, dtype=dtype, device=dev)
    k = torch.zeros((), dtype=torch.int64, device=dev)

    def lm_step():
        """One LM iteration (the JAX ``lm_step``), in place. Returns the
        device flags (re-linearise, done): re-linearisation follows an
        accepted step that is not final."""
        d = torch.clip(torch.diagonal(h), 1e-6, 1e32)
        delta = remap_step(linear_solve(h, g, lam, d))
        new_flat = cor + delta
        new_cost = eval_cost(new_flat)
        pred = 0.5 * (torch.sum(delta * (lam * d * delta)) - torch.sum(delta * g))
        rho = (cost - new_cost) / torch.clamp(pred, min=tiny)
        accept = (new_cost < cost) & torch.isfinite(new_cost) & (pred > 0)
        rel_decrease = (cost - new_cost) / torch.clamp(cost, min=tiny)
        new_done = accept & (rel_decrease < function_tolerance)
        shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam_out = torch.clip(torch.where(accept, lam * shrink, lam * nu), 1e-12, 1e10)
        nu_out = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
        cor.copy_(torch.where(accept, new_flat, cor))
        cost.copy_(torch.where(accept, new_cost, cost))
        lam.copy_(lam_out)
        nu.copy_(nu_out)
        k.add_(1)
        return torch.stack([accept & ~new_done, new_done])

    def relinearize():
        h_new, g_new = build_normal_eqs(cor)
        h.copy_(h_new)
        g.copy_(g_new)

    (lm_loop or lm_loop_eager)(lm_step, relinearize, max_iterations)
    out = sample.replace(cor=cor.reshape(s_cap, 12))
    return out, SolveStats(iterations=k, initial_cost=cost0, final_cost=cost, lambda_final=lam)


def residual_snapshot(sample: SampleStates, sfac, ifac, weights, dt: float, grav):
    """Raw residuals for diagnostics (the reference's pre/post-solve residual
    histograms): (surfel residuals (M,), their valid mask, IMU residuals
    (Mi, 12), their valid mask)."""
    rs, _, _ = fmod.surfel_residuals(sfac, sample.cor, with_jac=False)
    ri, _, _ = fmod.imu_residuals(ifac, sample.cor, weights, dt, grav, with_jac=False)
    return rs, sfac.valid, ri, ifac.valid
