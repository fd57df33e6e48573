"""Batched factor construction and evaluation with analytic Jacobians.

Counterpart of ``wildcat_slam_tpu/odometry/factors.py``: the surfel match
factors (unary + binary unified by scatter pairs) and the IMU triplet
factors, with the same two corrected Jacobians as the JAX package (its module
doc, items (a) and (b): no gyro/bias block for the second IMU time, and the
first-time rotation block as the exact derivative of ``Exp(r)^-1``), and the
degeneracy health signal with its weak-subspace projectors. On a CUDA tensor
the residuals alone (``with_jac=False``: the cost, the residual snapshot)
come from kernels K6 (``ops/surfel_factor.py``) and K5
(``ops/imu_factor.py``); the Jacobian forms here are the kernels' plain
versions, which ``solver.build_normal_eqs`` reduces on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

from wildcat_slam_tpu_torch.odometry import imu as imu_mod
from wildcat_slam_tpu_torch.odometry.states import SampleStates, Surfels, TensorStruct
from wildcat_slam_tpu_torch.ops import imu_factor, lie, surfel_factor
from wildcat_slam_tpu_torch.ops.eigh3 import eigh3


def sample_bracket(sample: SampleStates, t_query: torch.Tensor):
    """Bracketing sample-state indices and lerp factor for query times
    (upper_bound semantics, clipped into the valid range). Returns (il, ir, f)."""
    tdt = sample.t.dtype
    tpad = torch.where(sample.mask, sample.t, torch.finfo(tdt).max)
    q = t_query.to(tdt)
    n = sample.t.shape[0]
    ir = torch.floor((q - sample.t[0]) / (sample.t[1] - sample.t[0])).to(torch.int64)
    ir = torch.clip(ir, 0, n - 1)
    for _ in range(2):  # first k with tpad[k] > q
        ir = torch.where(tpad[ir] <= q, torch.clamp(ir + 1, max=n - 1), ir)
    ir = torch.minimum(torch.clamp(ir, min=1), sample.count - 1)
    il = ir - 1
    tl, tr = tpad[il], tpad[ir]
    f = (q - tl) / torch.clamp(tr - tl, min=torch.finfo(tdt).tiny)
    return il, ir, torch.clip(f, 0.0, 1.0).to(sample.cor.dtype)


def _interp_cor(cor, il, ir, f):
    return cor[il] * (1.0 - f)[..., None] + cor[ir] * f[..., None]


@dataclasses.dataclass
class SurfelFactors(TensorStruct):
    """Per-factor constants fixed at build time. Side 1 is the earlier surfel
    (constant world center when ``opt1`` is False), side 2 the later one."""

    valid: torch.Tensor
    w: torch.Tensor
    n: torch.Tensor
    opt1: torch.Tensor
    v1: torch.Tensor
    p1: torch.Tensor
    i1l: torch.Tensor
    i1r: torch.Tensor
    f1: torch.Tensor
    v2: torch.Tensor
    p2: torch.Tensor
    i2l: torch.Tensor
    i2r: torch.Tensor
    f2: torch.Tensor


def _cov6(cw):
    return torch.stack([cw[:, 0, 0], cw[:, 1, 1], cw[:, 2, 2],
                        cw[:, 0, 1], cw[:, 0, 2], cw[:, 1, 2]], 1)


def pack_factor_rows(s: Surfels) -> torch.Tensor:
    """(K, 18) rows [t, valid, rot quat (4), center body (3), pos (3),
    cov_world sym6 (6)]."""
    return torch.cat([s.t[:, None], s.valid.to(s.t.dtype)[:, None], s.rot, s.center, s.pos,
                      _cov6(s.cov_world())], 1)


def pack_geo_rows(s: Surfels) -> torch.Tensor:
    """(K, 12) pose-frozen geometry [cov_world sym6, center_world, norm_world]."""
    return torch.cat([_cov6(s.cov_world()), s.center_world(), s.norm_world()], 1)


def pack_factor_rows_from_geo(s: Surfels, geo: torch.Tensor) -> torch.Tensor:
    """:func:`pack_factor_rows` with the cached cov_world of a geo table."""
    return torch.cat([s.t[:, None], s.valid.to(s.t.dtype)[:, None], s.rot, s.center, s.pos,
                      geo[:, 0:6]], 1)


def _sym6_to_full(m6):
    xx, yy, zz, xy, xz, yz = (m6[..., i] for i in range(6))
    return torch.stack([torch.stack([xx, xy, xz], -1), torch.stack([xy, yy, yz], -1),
                        torch.stack([xz, yz, zz], -1)], -2)


def build_surfel_factors(sq: Surfels, st_: Surfels, iq, it, pair_valid,
                         sample: SampleStates, sigma_floor: float, target_optimized: bool,
                         sq_pack=None, st_pack=None) -> SurfelFactors:
    """Factor constants from matched pairs (iq into sq, it into st_):
    binary when ``target_optimized`` (both in the sliding window, ordered by
    time), else unary with the fixed-window target as the constant side 1."""
    if sq_pack is None:
        sq_pack = pack_factor_rows(sq)
    if st_pack is None:
        st_pack = sq_pack if st_ is sq else pack_factor_rows(st_)
    gq, gt = sq_pack[iq], st_pack[it]
    tq, tt = gq[:, 0], gt[:, 0]
    valid = pair_valid & (gq[:, 1] > 0.5) & (gt[:, 1] > 0.5)
    vals, vecs = eigh3(_sym6_to_full(gq[:, 12:18]) + _sym6_to_full(gt[:, 12:18]))
    n = vecs[..., :, 0]
    w = 1.0 / torch.sqrt(sigma_floor**2 + torch.clamp(vals[..., 0], min=0.0))

    def side(g):
        il, ir, f = sample_bracket(sample, g[:, 0])
        return lie.quat_rotate(g[:, 2:6], g[:, 6:9]), g[:, 9:12], il, ir, f

    vq_, pq_, iql, iqr, fq = side(gq)
    vt_, pt_, itl, itr, ft = side(gt)
    if target_optimized:
        swap = tq > tt
        sel = lambda a, b: torch.where(swap, b, a)
        selv = lambda a, b: torch.where(swap[:, None], b, a)
        return SurfelFactors(
            valid=valid & (tq != tt), w=w, n=n, opt1=torch.ones_like(valid),
            v1=selv(vq_, vt_), p1=selv(pq_, pt_), i1l=sel(iql, itl), i1r=sel(iqr, itr),
            f1=sel(fq, ft),
            v2=selv(vt_, vq_), p2=selv(pt_, pq_), i2l=sel(itl, iql), i2r=sel(itr, iqr),
            f2=sel(ft, fq))
    c1w = vt_ + pt_
    zi = torch.zeros_like(iql)
    return SurfelFactors(
        valid=valid, w=w, n=n, opt1=torch.zeros_like(valid),
        v1=c1w, p1=torch.zeros_like(c1w), i1l=zi, i1r=zi, f1=torch.zeros_like(fq),
        v2=vq_, p2=pq_, i2l=iql, i2r=iqr, f2=fq)


def _coverage_mats(fac: SurfelFactors, ref_pos: torch.Tensor):
    """The weighted second-moment matrices (D_t, D_r) of the constraint
    directions: D_t = sum w^2 n n^T, D_r = sum w^2 c c^T with
    c = (x - ref_pos) x n (see the JAX package's ``direction_coverage``)."""
    dtype = fac.n.dtype
    w2 = torch.where(fac.valid, fac.w * fac.w, 0.0).to(dtype)
    dt_mat = torch.einsum("m,mi,mj->ij", w2, fac.n, fac.n)
    c = lie.cross((fac.v2 + fac.p2) - ref_pos[None, :].to(dtype), fac.n)
    dr_mat = torch.einsum("m,mi,mj->ij", w2, c, c)
    return dt_mat, dr_mat


def direction_coverage(fac: SurfelFactors, ref_pos: torch.Tensor):
    """Degeneracy health signal: scale-free eigenvalue ratios lambda_min /
    lambda_max of the weighted translation and rotation constraint moments
    (see the JAX package's docstring). Returns (trans_ratio, rot_ratio)."""
    tiny = torch.finfo(fac.n.dtype).tiny

    def ratio(d):
        vals, _ = eigh3(d)
        return torch.clamp(vals[0], min=0.0) / torch.clamp(vals[2], min=tiny)

    return tuple(ratio(d) for d in _coverage_mats(fac, ref_pos))


def degeneracy_projectors(fac: SurfelFactors, ref_pos: torch.Tensor, remap_ratio: float):
    """Weak-subspace projectors for degeneracy solution remapping (Zhang &
    Singh ICRA'16 section V, adapted to the joint solve; see the JAX
    package's docstring). Returns ``(W_t, W_r, trans_ratio, rot_ratio)``:
    3x3 projectors ``W = sum_{k weak} v_k v_k^T`` over the eigenvectors whose
    eigenvalue is below ``remap_ratio * lambda_max``, and the ratios of
    :func:`direction_coverage`. On a healthy scene both W are exact zeros, so
    the remapped step equals the unremapped one bit for bit."""
    tiny = torch.finfo(fac.n.dtype).tiny

    def proj(d):
        vals, vecs = eigh3(d)
        ratio = torch.clamp(vals[0], min=0.0) / torch.clamp(vals[2], min=tiny)
        weak = (vals < remap_ratio * vals[2]).to(d.dtype)
        return torch.einsum("k,ik,jk->ij", weak, vecs, vecs), ratio

    (w_t, r_t), (w_r, r_r) = (proj(d) for d in _coverage_mats(fac, ref_pos))
    return w_t, w_r, r_t, r_r


def interp_weights(fac: SurfelFactors, s_cap: int, dtype):
    """(W1, W2): (M, S) bracket-lerp weight matrices, constant through a solve."""
    ar = torch.arange(s_cap, device=fac.i1l.device)
    w1 = ((fac.i1l[:, None] == ar) * (1.0 - fac.f1)[:, None]
          + (fac.i1r[:, None] == ar) * fac.f1[:, None])
    w2 = ((fac.i2l[:, None] == ar) * (1.0 - fac.f2)[:, None]
          + (fac.i2r[:, None] == ar) * fac.f2[:, None])
    return w1.to(dtype), w2.to(dtype)


def surfel_residuals(fac: SurfelFactors, cor: torch.Tensor, with_jac: bool = True,
                     w_interp=None):
    """Residuals r = w n . (T1 - T2) and (optionally) Jacobian blocks onto the
    sample blocks (i1l, i1r, i2l, i2r). Returns (r (M,), jac (M, 4, 12), idx (M, 4)).
    The residuals alone of a CUDA tensor come from kernel K6, the rest from
    :func:`surfel_residuals_plain`."""
    if not with_jac and cor.device.type != "cpu":
        return surfel_factor.residuals(fac, cor), None, None
    return surfel_residuals_plain(fac, cor, with_jac, w_interp)


def surfel_residuals_plain(fac: SurfelFactors, cor: torch.Tensor, with_jac: bool = True,
                           w_interp=None):
    """:func:`surfel_residuals` in tensor operations (K6's plain version)."""
    if w_interp is not None:
        w1, w2 = w_interp
        c1, c2 = w1 @ cor, w2 @ cor
    else:
        c1 = _interp_cor(cor, fac.i1l, fac.i1r, fac.f1)
        c2 = _interp_cor(cor, fac.i2l, fac.i2r, fac.f2)
    r1c, t1c = c1[:, 0:3], c1[:, 3:6]
    r2c, t2c = c2[:, 0:3], c2[:, 3:6]
    e1 = lie.quat_rotate(lie.exp_quat(r1c), fac.v1) + t1c + fac.p1
    t1 = torch.where(fac.opt1[:, None], e1, fac.v1)
    t2 = lie.quat_rotate(lie.exp_quat(r2c), fac.v2) + t2c + fac.p2
    r = torch.where(fac.valid, fac.w * torch.sum(fac.n * (t1 - t2), dim=-1), 0.0)
    if not with_jac:
        return r, None, None

    wn = fac.w[:, None] * fac.n

    def block(v, rc, sign):
        u = lie.cross(lie.vec_mat3(wn, lie.exp_matrix(rc)), v)
        jrot = -sign * lie.vec_mat3(u, lie.jr(rc))
        return torch.cat([jrot, sign * wn, torch.zeros(v.shape[:1] + (6,), dtype=v.dtype,
                                                       device=v.device)], 1)

    j1 = block(fac.v1, r1c, 1.0) * fac.opt1[:, None]
    j2 = block(fac.v2, r2c, -1.0)
    vm = fac.valid[:, None]
    jac = torch.stack([j1 * (1.0 - fac.f1)[:, None] * vm, j1 * fac.f1[:, None] * vm,
                       j2 * (1.0 - fac.f2)[:, None] * vm, j2 * fac.f2[:, None] * vm], 1)
    idx = torch.stack([fac.i1l, fac.i1r, fac.i2l, fac.i2r], 1)
    return r, jac, idx


@dataclasses.dataclass
class ImuFactors(TensorStruct):
    """Constants for one IMU-triplet factor (i1, i2, i3); ``il``/``ir``/``f``
    are (Mi, 3) brackets and lerp factors of the three IMU times."""

    valid: torch.Tensor
    q1: torch.Tensor
    q2: torch.Tensor
    a1: torch.Tensor
    g1: torch.Tensor
    g2: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    p3: torch.Tensor
    il: torch.Tensor
    ir: torch.Tensor
    f: torch.Tensor


def build_imu_factors(imu, sample: SampleStates, max_factors: int) -> ImuFactors:
    """One factor per consecutive IMU triplet fully inside the sample window,
    compacted valid-first (stable, so time order is kept)."""
    cap = imu.capacity
    i0 = torch.arange(cap, device=imu.t.device)
    nx1 = torch.clamp(i0 + 1, max=cap - 1)
    nx2 = torch.clamp(i0 + 2, max=cap - 1)
    valid = ((i0 + 2 < imu.count) & (imu.t >= sample.t[0])
             & (imu.t[nx2] <= imu_mod.row_at(sample.t, sample.count - 1)))
    il, ir, f = sample_bracket(sample, torch.stack([imu.t, imu.t[nx1], imu.t[nx2]], 1))
    order = torch.argsort((~valid).to(torch.int8), stable=True)[:max_factors]
    fac = ImuFactors(valid=valid, q1=imu.rot, q2=imu.rot[nx1], a1=imu.acc, g1=imu.gyr,
                     g2=imu.gyr[nx1], p1=imu.pos, p2=imu.pos[nx1], p3=imu.pos[nx2],
                     il=il, ir=ir, f=f)
    return fac.map(lambda x: x[order])


def imu_residuals(fac: ImuFactors, cor: torch.Tensor, weights, dt: float, grav: torch.Tensor,
                  with_jac: bool = True):
    """12-dim IMU residual per factor and (optionally) Jacobian blocks. Returns
    (r (Mi, 12), jac (Mi, 6, 12, 12), idx (Mi, 6)); the 6 blocks are the
    (left, right) brackets of the three IMU times. The residuals alone of a
    CUDA tensor come from kernel K5, the rest from :func:`imu_residuals_plain`."""
    if not with_jac and cor.device.type != "cpu":
        return imu_factor.residuals(fac, cor, weights, dt, grav), None, None
    return imu_residuals_plain(fac, cor, weights, dt, grav, with_jac)


def imu_residuals_plain(fac: ImuFactors, cor: torch.Tensor, weights, dt: float,
                        grav: torch.Tensor, with_jac: bool = True):
    """:func:`imu_residuals` in tensor operations (K5's plain version)."""
    w_g, w_a, w_bg, w_ba = weights
    dtype = cor.dtype
    mi = fac.q1.shape[0]
    c = torch.stack([_interp_cor(cor, fac.il[:, k], fac.ir[:, k], fac.f[:, k])
                     for k in range(3)], 1)
    r1c, r2c = c[:, 0, 0:3], c[:, 1, 0:3]
    t1c, t2c, t3c = c[:, 0, 3:6], c[:, 1, 3:6], c[:, 2, 3:6]
    bg1, bg2 = c[:, 0, 6:9], c[:, 1, 6:9]
    ba1, ba2 = c[:, 0, 9:12], c[:, 1, 9:12]
    e1 = lie.exp_quat(r1c)
    e2 = lie.exp_quat(r2c)
    q1c = lie.quat_mul(e1, fac.q1)
    q2c = lie.quat_mul(e2, fac.q2)
    theta = lie.log_quat(lie.quat_mul(lie.quat_conj(q1c), q2c))
    acc_world = lie.quat_rotate(q1c, fac.a1 - ba1)
    acc_est = ((t3c + fac.p3) + (t1c + fac.p1) - 2.0 * (t2c + fac.p2)) / (dt * dt)
    r = torch.cat([w_g * ((fac.g1 + fac.g2) / 2.0 - theta / dt - bg1),
                   w_a * (acc_world - acc_est + grav),
                   w_bg * (bg1 - bg2), w_ba * (ba1 - ba2)], 1)
    r = torch.where(fac.valid[:, None], r, 0.0)
    if not with_jac:
        return r, None, None

    dev = cor.device
    eye3 = torch.eye(3, dtype=dtype, device=dev).expand(mi, 3, 3)
    z3 = torch.zeros((mi, 3, 3), dtype=dtype, device=dev)
    q1m = lie.quat_to_matrix(fac.q1)
    q2m = lie.quat_to_matrix(fac.q2)
    jr1 = lie.jr(r1c)
    jr2 = lie.jr(r2c)
    dth_dr1 = -lie.mat3_mul(lie.mat3_mul(lie.jl_inv(theta), q1m.transpose(-1, -2)), jr1)
    dth_dr2 = lie.mat3_mul(lie.mat3_mul(lie.jr_inv(theta), q2m.transpose(-1, -2)), jr2)
    dacc_dr1 = -lie.mat3_mul(lie.mat3_mul(
        lie.quat_to_matrix(e1), lie.hat(lie.quat_rotate(fac.q1, fac.a1 - ba1))), jr1)

    def blockmat(rows):
        return torch.cat([torch.cat(r, 2) for r in rows], 1)

    jt1 = blockmat([
        [-(w_g / dt) * dth_dr1, z3, -w_g * eye3, z3],
        [w_a * dacc_dr1, -(w_a / dt / dt) * eye3, z3, -w_a * lie.quat_to_matrix(q1c)],
        [z3, z3, w_bg * eye3, z3],
        [z3, z3, z3, w_ba * eye3],
    ])
    jt2 = blockmat([  # no (gyr, bg) block: the residual uses bg(tau1) only
        [-(w_g / dt) * dth_dr2, z3, z3, z3],
        [z3, (2.0 * w_a / dt / dt) * eye3, z3, z3],
        [z3, z3, -w_bg * eye3, z3],
        [z3, z3, z3, -w_ba * eye3],
    ])
    jt3 = blockmat([
        [z3, z3, z3, z3],
        [z3, -(w_a / dt / dt) * eye3, z3, z3],
        [z3, z3, z3, z3],
        [z3, z3, z3, z3],
    ])
    vm = fac.valid[:, None, None]
    f = fac.f
    jac = torch.stack([
        jt1 * (1.0 - f[:, 0])[:, None, None] * vm, jt1 * f[:, 0][:, None, None] * vm,
        jt2 * (1.0 - f[:, 1])[:, None, None] * vm, jt2 * f[:, 1][:, None, None] * vm,
        jt3 * (1.0 - f[:, 2])[:, None, None] * vm, jt3 * f[:, 2][:, None, None] * vm,
    ], 1)
    idx = torch.stack([fac.il[:, 0], fac.ir[:, 0], fac.il[:, 1], fac.ir[:, 1],
                       fac.il[:, 2], fac.ir[:, 2]], 1)
    return r, jac, idx
