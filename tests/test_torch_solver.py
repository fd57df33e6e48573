"""The port's PCG (K1's plain version) and LM solver against the JAX package.

- ``pcg_solve_plain`` (the port's one plain PCG) against
  ``pcg_solve_fused(interpret=True)`` and against the JAX package's portable
  ``_pcg_solve``, on the cases of ``tests/test_pcg_pallas.py`` (float32;
  within 2e-4 as there: CG amplifies the f32 rounding of a different matvec
  summation order).
- The preconditioner helpers within 1e-10 in float64.
- One ``solve_window`` in float64 against JAX's, for each linear solver:
  corrections within 1e-8, the same LM iteration count; and with every
  Cholesky factorisation failing, both reject each step and grow lambda.
- Degeneracy remapping in float64: ``degeneracy_projectors`` within 1e-10,
  ``solve_window(remap_proj=...)`` within 1e-8 (summation order only), and
  zero projectors leave the solve bit for bit unchanged.
- ``residual_snapshot`` in float64 within 1e-10.
- The normal equations (kernels K5's and K6's plain versions, the CPU's
  ``_imu_banded_normal_eqs`` and ``_surfel_normal_eqs``) against the JAX
  package's ``_imu_banded_normal_eqs``, ``_surfel_normal_eqs`` and
  ``solve_window``'s assembly of H and g: the IMU bands and g, the surfel
  factors' H and g alone, and the whole H and g, within 1e-12 of the largest
  entry in float64 and 1e-5 in float32 (the JAX inputs cast to float32,
  since ``conftest.py`` turns x64 on; the two packages' einsums and
  products sum in other orders), H bit-exactly symmetric.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from wildcat_slam_tpu.odometry import factors as jf
from wildcat_slam_tpu.odometry import solver as jsolver
from wildcat_slam_tpu.odometry import states as jst
from wildcat_slam_tpu.odometry.solver import _pcg_solve as j_pcg_xla
from wildcat_slam_tpu.odometry.solver import residual_snapshot as j_snapshot
from wildcat_slam_tpu.odometry.solver import solve_window as j_solve
from wildcat_slam_tpu.ops import pcg_pallas
from wildcat_slam_tpu_torch.odometry import factors as tf
from wildcat_slam_tpu_torch.odometry import solver as tsolver
from wildcat_slam_tpu_torch.odometry import states as tst
from wildcat_slam_tpu_torch.odometry.solver import residual_snapshot as t_snapshot
from wildcat_slam_tpu_torch.odometry.solver import solve_window as t_solve
from wildcat_slam_tpu_torch.ops import pcg

torch.set_num_threads(1)


def _random_system(s_cap, seed=0):
    rng = np.random.default_rng(seed)
    n = s_cap * 12
    a = rng.normal(size=(n, n + 24))
    return (a @ a.T / n).astype(np.float32), rng.normal(size=(n,)).astype(np.float32)


# the cases of tests/test_pcg_pallas.py::TestFusedPcg: (S, seed, lam, iters, tol, zero rhs)
CASES = {"matches_xla_pcg": (8, 0, 1e-3, 24, 1e-6, False),
         "solves_the_system": (4, 3, 1e-2, 200, 1e-7, False),
         "early_exit_on_converged": (4, 5, 1e-3, 24, 1e-6, True)}


@pytest.mark.parametrize("case", list(CASES))
def test_pcg_plain_matches_fused_and_xla(case):
    s_cap, seed, lam, iters, tol, zero = CASES[case]
    h, g = _random_system(s_cap, seed)
    if zero:
        g = np.zeros_like(g)
    dlam = (lam * np.clip(np.diag(h), 1e-6, 1e32)).astype(np.float32)
    minv_j = pcg_pallas.block_diag_inverse(jnp.asarray(h), jnp.asarray(dlam), s_cap)
    fused = np.asarray(pcg_pallas.pcg_solve_fused(jnp.asarray(h), jnp.asarray(dlam), minv_j,
                                                  jnp.asarray(g), iters=iters, tol=tol,
                                                  interpret=True))
    xla = np.asarray(j_pcg_xla(jnp.asarray(h + np.diag(dlam)), jnp.asarray(g), s_cap, iters, tol))
    th, tdl, tg = map(torch.as_tensor, (h, dlam, g))
    minv = pcg.block_diag_inverse(th, tdl, s_cap)
    np.testing.assert_allclose(minv.numpy(), np.asarray(minv_j), rtol=1e-4, atol=1e-4)
    plain = pcg.pcg_solve_plain(th, tdl, minv, tg, iters, tol)
    assert torch.equal(pcg.pcg_solve(th, tdl, minv, tg, iters, tol), plain)  # CPU -> plain
    for ref in (fused, xla):
        np.testing.assert_allclose(plain.numpy(), ref, rtol=2e-4, atol=2e-4)
    if zero:
        assert np.all(plain.numpy() == 0.0)
    if case == "solves_the_system":
        lhs = (h + np.diag(dlam)) @ plain.numpy()
        np.testing.assert_allclose(lhs, g, rtol=1e-3, atol=1e-3)


def test_preconditioner_helpers():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(60, 60))
    h = a @ a.T + 60 * np.eye(60)
    dlam = rng.uniform(0.1, 1.0, 60)
    np.testing.assert_allclose(pcg.extract_diag_blocks(torch.as_tensor(h), 5).numpy(),
                               np.asarray(pcg_pallas.extract_diag_blocks(jnp.asarray(h), 5)),
                               rtol=0, atol=0)
    np.testing.assert_allclose(
        pcg.block_diag_inverse(torch.as_tensor(h), torch.as_tensor(dlam), 5).numpy(),
        np.asarray(pcg_pallas.block_diag_inverse(jnp.asarray(h), jnp.asarray(dlam), 5)),
        rtol=0, atol=1e-10)
    for s in (96, 192, 256):
        assert pcg.supports(s)
    assert not pcg.supports(1001)


def _problem():
    """A small window: smooth IMU states, sample states on their grid, and
    surfel factors (binary + unary) from perturbed surfels. Returns the numpy
    pieces both packages are built from."""
    rng = np.random.default_rng(4)
    s_cap, count, stride = 12, 9, 16
    n_imu = 160
    dt = 0.005
    it = np.where(np.arange(n_imu) < (count - 1) * stride + 2, np.arange(n_imu) * dt, 0.0)
    ang = np.cumsum(rng.normal(scale=0.002, size=(n_imu, 3)), 0)
    half = np.linalg.norm(ang, axis=1, keepdims=True) / 2 + 1e-12
    rot = np.concatenate([np.cos(half), np.sin(half) * ang / (2 * half)], 1)
    pos = np.cumsum(np.cumsum(rng.normal(scale=1e-4, size=(n_imu, 3)), 0), 0)
    imu = dict(t=it, rot=rot, pos=pos, acc=np.array([0, 0, 9.81]) + rng.normal(scale=0.05, size=(n_imu, 3)),
               gyr=rng.normal(scale=0.4, size=(n_imu, 3)), count=np.int64((count - 1) * stride + 2))
    st = np.where(np.arange(s_cap) < count, np.arange(s_cap) * stride * dt, 0.0)
    sidx = np.minimum(np.arange(s_cap) * stride, n_imu - 1)
    sample = dict(t=st, rot=rot[sidx], pos=pos[sidx], cor=np.zeros((s_cap, 12)),
                  count=np.int64(count), grav=np.array([0.0, 0.0, -9.81]))

    def surfels(n, tspan):
        axis = rng.integers(0, 3, n)
        c = rng.uniform(-3, 3, (n, 3))
        c[np.arange(n), axis] = 2.0
        q = np.zeros((n, 4))
        q[:, 0] = 1.0
        cov = np.tile(np.diag([0.01, 0.01, 1e-5]), (n, 1, 1))
        return dict(t=rng.uniform(*tspan, n), center=c + rng.normal(scale=0.01, size=(n, 3)),
                    cov=cov, norm=np.eye(3)[axis], rot=q, pos=np.zeros((n, 3)),
                    resolution=np.full(n, 0.4), std=np.full(n, 0.003), valid=np.ones(n, bool))

    sld = surfels(80, (0.0, (count - 1) * stride * dt))
    fix = surfels(60, (-1.0, 0.0))
    pairs = dict(iq=rng.integers(0, 80, 48), it=rng.integers(0, 80, 48),
                 iu=rng.integers(0, 60, 48), pv=np.ones(48, bool))
    return imu, sample, sld, fix, pairs


def _build(pkg_st, pkg_f, conv, imu, sample, sld, fix, pairs):
    mk = lambda cls, d: cls(**{k: conv(v) for k, v in d.items()})
    s = mk(pkg_st.SampleStates, sample)
    w, f = mk(pkg_st.Surfels, sld), mk(pkg_st.Surfels, fix)
    b = pkg_f.build_surfel_factors(w, w, conv(pairs["iq"]), conv(pairs["it"]), conv(pairs["pv"]),
                                   s, 0.05 / 6.0, target_optimized=True)
    u = pkg_f.build_surfel_factors(w, f, conv(pairs["iq"]), conv(pairs["iu"]), conv(pairs["pv"]),
                                   s, 0.05 / 6.0, target_optimized=False)
    ifac = pkg_f.build_imu_factors(mk(pkg_st.ImuStates, imu), s, 128)
    return s, b, u, ifac


WEIGHTS = (3.0, 2.0, 40.0, 500.0)
SOLVE_KW = dict(cauchy_scale=0.4, max_iterations=25, init_lambda=1e-4, function_tolerance=1e-3,
                linear_solver="pcg_xla", pcg_iters=24, pcg_tol=1e-2, n_binary=48)


@pytest.fixture(scope="module")
def problem():
    import jax

    pieces = _problem()
    js, jb, ju, jif = _build(jst, jf, jnp.asarray, *pieces)
    ts, tb, tu, tif = _build(tst, tf, torch.as_tensor, *pieces)
    jsf = jax.tree_util.tree_map(lambda a, b: jnp.concatenate([a, b], 0), jb, ju)
    return (js, jsf, jif), (ts, tst.concat(tb, tu), tif)


@pytest.mark.parametrize("linear_solver", ["pcg", "pcg_xla", "cholesky"])
def test_solve_window_matches_jax(problem, linear_solver):
    (js, jsf, jif), (ts, tsf, tif) = problem
    kw = dict(SOLVE_KW, linear_solver=linear_solver)
    jo, jstat = j_solve(js, jsf, jif, WEIGHTS, 0.005, js.grav, jnp.asarray(True), **kw)
    to, tstat = t_solve(ts, tsf, tif, WEIGHTS, 0.005, ts.grav, torch.tensor(True), **kw)
    assert int(tstat.iterations) == int(jstat.iterations) >= 2
    np.testing.assert_allclose(to.cor.numpy(), np.asarray(jo.cor), rtol=0, atol=1e-8)
    for name in ("initial_cost", "final_cost", "lambda_final"):
        np.testing.assert_allclose(float(getattr(tstat, name)), float(getattr(jstat, name)),
                                   rtol=1e-9)
    assert float(tstat.final_cost) < float(tstat.initial_cost)

def test_failed_cholesky_step_is_rejected_as_in_jax(problem, monkeypatch):
    """A damped system whose factorisation fails gives a NaN step (JAX's
    cho_factor, the port's spd_solve): the LM step rejects it through
    isfinite(new_cost), keeps the state and grows lambda by nu. Both solves
    are handed the system with its last pivot made negative (a padded
    state's, whose gradient is zero), so every factorisation fails there; the
    library's partial factor alone would still give the true step for the
    other states, and the step would be taken."""
    import jax.scipy.linalg as jsl

    from wildcat_slam_tpu_torch.ops import spd

    def spoiled(a):
        a = a.clone()
        a[-1, -1] = -1.0
        return a

    (js, jsf, jif), (ts, tsf, tif) = problem
    j_factor, t_solve_spd = jsl.cho_factor, spd.spd_solve
    monkeypatch.setattr(jsl, "cho_factor",
                        lambda a, *args, **kw: j_factor(a.at[-1, -1].set(-1.0), *args, **kw))
    monkeypatch.setattr(spd, "spd_solve", lambda a, b: t_solve_spd(spoiled(a), b))
    kw = dict(SOLVE_KW, linear_solver="cholesky", max_iterations=3)
    # the jitted JAX function's own body, traced anew, so the patch is seen
    jo, jstat = j_solve.__wrapped__(js, jsf, jif, WEIGHTS, 0.005, js.grav, jnp.asarray(True), **kw)
    to, tstat = t_solve(ts, tsf, tif, WEIGHTS, 0.005, ts.grav, torch.tensor(True), **kw)
    lam = SOLVE_KW["init_lambda"] * 2.0 * 4.0 * 8.0  # nu = 2, 4, 8 after each rejection
    for stat, cor in ((jstat, np.asarray(jo.cor)), (tstat, to.cor.numpy())):
        assert int(stat.iterations) == 3
        assert float(stat.final_cost) == float(stat.initial_cost)
        np.testing.assert_allclose(float(stat.lambda_final), lam, rtol=1e-12)
        np.testing.assert_array_equal(cor, np.zeros_like(cor))


def test_degeneracy_remap_matches_jax(problem):
    (js, jsf, jif), (ts, tsf, tif) = problem
    ref_pos = np.array([0.1, -0.2, 0.05])
    # a ratio this high marks the two weaker axes of each moment as weak,
    # so both projectors are non-zero and the remap acts on the step
    jw = jf.degeneracy_projectors(jsf, jnp.asarray(ref_pos), 0.9)
    tw = tf.degeneracy_projectors(tsf, torch.as_tensor(ref_pos), 0.9)
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-10)
    assert all(float(torch.sum(torch.abs(w))) > 0.5 for w in tw[:2])
    for a, b in zip(tf.direction_coverage(tsf, torch.as_tensor(ref_pos)), tw[2:]):
        assert float(a) == float(b)
    jo, jstat = j_solve(js, jsf, jif, WEIGHTS, 0.005, js.grav, jnp.asarray(True),
                        remap_proj=jw[:2], **SOLVE_KW)
    to, tstat = t_solve(ts, tsf, tif, WEIGHTS, 0.005, ts.grav, torch.tensor(True),
                        remap_proj=tw[:2], **SOLVE_KW)
    assert int(tstat.iterations) == int(jstat.iterations)
    np.testing.assert_allclose(to.cor.numpy(), np.asarray(jo.cor), rtol=0, atol=1e-8)
    free, _ = t_solve(ts, tsf, tif, WEIGHTS, 0.005, ts.grav, torch.tensor(True), **SOLVE_KW)
    assert float(torch.max(torch.abs(free.cor - to.cor))) > 1e-6  # the remap acted
    zero = torch.zeros((3, 3), dtype=torch.float64)
    inert, _ = t_solve(ts, tsf, tif, WEIGHTS, 0.005, ts.grav, torch.tensor(True),
                       remap_proj=(zero, zero), **SOLVE_KW)
    assert torch.equal(inert.cor, free.cor)


def test_residual_snapshot_matches_jax(problem):
    (js, jsf, jif), (ts, tsf, tif) = problem
    rng = np.random.default_rng(9)
    cor = rng.normal(scale=1e-3, size=tuple(ts.cor.shape))
    jr = j_snapshot(js.replace(cor=jnp.asarray(cor)), jsf, jif, WEIGHTS, 0.005, js.grav)
    tr = t_snapshot(ts.replace(cor=torch.as_tensor(cor)), tsf, tif, WEIGHTS, 0.005, ts.grav)
    for a, b in zip(tr, jr):
        if a.dtype == torch.bool:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-10)


NE_TOL = {"float64": 1e-12, "float32": 1e-5}  # of the largest entry


@functools.partial(jax.jit, static_argnums=(5, 6, 7))
def _jax_normal_eqs(sfac, ifac, cor, grav, fm, s_cap, nb, dtype):
    """The JAX package's normal equations as its ``solve_window`` assembles
    them: (IMU bands (5, S, 12, 12), gi, (H, g), (H, g) of the surfel factors
    alone), in one compiled program."""
    a2 = SOLVE_KW["cauchy_scale"] ** 2
    w1, w2 = jf.interp_weights(sfac, s_cap, dtype)
    rs, jac_s, _ = jf.surfel_residuals(sfac, cor, w_interp=(w1, w2))
    ri, jac_i, idx_i = jf.imu_residuals(ifac, cor, WEIGHTS, 0.005, grav)
    sw = 1.0 / jnp.sqrt(1.0 + rs * rs / a2)
    j1v = (jac_s[:, 0] + jac_s[:, 1]) * sw[:, None]
    j2v = (jac_s[:, 2] + jac_s[:, 3]) * sw[:, None]
    bands_i, gi = jsolver._imu_banded_normal_eqs(jac_i, idx_i, ri, s_cap)
    stacked = jnp.stack([bands_i[d] for d in range(-2, 3)])
    out = []
    for bands, g_i in ((dict(bands_i), gi),
                       ({d: jnp.zeros_like(b) for d, b in bands_i.items()}, jnp.zeros_like(gi))):
        bands_s, d, gs = jsolver._surfel_normal_eqs(j1v, j2v, rs * sw, sfac, w1, w2, s_cap, nb)
        for delta, blk in bands_s.items():
            jsolver._add_band(bands, delta, blk)
        h = jsolver._place_block_bands(bands, s_cap, dtype) + (d + d.T)
        out.append((h * fm[:, None] * fm[None, :] + jnp.diag(1.0 - fm), (gs + g_i) * fm))
    return stacked, gi, out[0], out[1]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("part", ["imu", "surfel", "both"])
def test_normal_equations_match_jax(problem, dtype, part):
    """The port's plain normal equations (what the card's K5 and K6 compute)
    against the JAX package's, at a perturbed correction with the gauge
    mask of the window (live states, the first position frozen)."""
    (js, jsf, jif), (ts, tsf, tif) = problem
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j_cast = lambda x: x.astype(jdt) if jnp.issubdtype(x.dtype, jnp.floating) else x
    t_cast = lambda x: x.to(tdt) if x.is_floating_point() else x
    jsf, jif = (jax.tree_util.tree_map(j_cast, f) for f in (jsf, jif))
    tsf, tif = tsf.map(t_cast), tif.map(t_cast)
    s_cap, nb = ts.cor.shape[0], SOLVE_KW["n_binary"]
    cor = np.random.default_rng(7).normal(scale=1e-3, size=(s_cap, 12))
    par = np.arange(12 * s_cap)
    fm = (((par // 12) < int(ts.count)) & ~((par >= 3) & (par < 6))).astype(dtype)
    j_bands, j_gi, both, surfel = _jax_normal_eqs(jsf, jif, jnp.asarray(cor, jdt),
                                                  jnp.asarray(np.asarray(js.grav), jdt),
                                                  jnp.asarray(fm), s_cap, nb, jdt)
    j_h, j_g = (np.asarray(x) for x in (surfel if part == "surfel" else both))
    tcor, tgrav, tfm = torch.as_tensor(cor, dtype=tdt), ts.grav.to(tdt), torch.as_tensor(fm)
    bands, gi = tsolver._imu_banded_normal_eqs(tif, tcor, WEIGHTS, 0.005, tgrav, s_cap)
    assert bands.shape == (5, s_cap, 12, 12) and bands.dtype == tdt
    if part == "surfel":
        bands, gi = torch.zeros_like(bands), torch.zeros_like(gi)
    h, g = tsolver._surfel_normal_eqs(tsf, tcor, SOLVE_KW["cauchy_scale"] ** 2, bands, gi, tfm,
                                      s_cap, nb)
    close = lambda got, want: np.testing.assert_allclose(
        got.numpy(), want, rtol=0, atol=NE_TOL[dtype] * np.abs(want).max())
    if part == "imu":
        close(bands, np.asarray(j_bands))
        close(gi, np.asarray(j_gi))
    else:
        close(h, j_h)
        close(g, j_g)
    assert torch.equal(h, h.T)
    assert float(torch.max(torch.abs(h - torch.diag(torch.diagonal(h))))) > 0.0
