"""The port's factors against the JAX package's, and its analytic Jacobians
against ``torch.autograd``.

Float64 throughout: residuals, Jacobians and factor constants within 1e-10
of JAX; analytic Jacobians within 1e-8 of autograd's (the analytic forms use
Taylor branches near zero angle that autograd differentiates differently).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from wildcat_slam_tpu.odometry import factors as jf
from wildcat_slam_tpu.odometry import states as jst
from wildcat_slam_tpu_torch.odometry import factors as tf
from wildcat_slam_tpu_torch.odometry import states as tst

torch.set_num_threads(1)

S_CAP, S_COUNT, SDT = 12, 9, 0.08
WEIGHTS = (3.0, 2.0, 40.0, 500.0)
IMU_DT = 0.005


def _close(got, ref, atol=1e-10):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               rtol=0, atol=atol)


def _sample(rng):
    t = np.where(np.arange(S_CAP) < S_COUNT, np.arange(S_CAP) * SDT, 0.0)
    rot = rng.normal(size=(S_CAP, 4))
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    d = dict(t=t, rot=rot, pos=rng.normal(size=(S_CAP, 3)),
             cor=rng.normal(scale=0.05, size=(S_CAP, 12)), count=np.int64(S_COUNT),
             grav=np.array([0.0, 0.0, -9.81]))
    return (jst.SampleStates(**{k: jnp.asarray(v) for k, v in d.items()}),
            tst.SampleStates(**{k: torch.as_tensor(v) for k, v in d.items()}), d)


def _surfels(rng, n):
    rot = rng.normal(size=(n, 4))
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    a = rng.normal(size=(n, 3, 3)) * 0.05
    d = dict(t=rng.uniform(0, (S_COUNT - 1) * SDT, n), center=rng.normal(size=(n, 3)),
             cov=a @ np.swapaxes(a, 1, 2), norm=rng.normal(size=(n, 3)), rot=rot,
             pos=rng.normal(size=(n, 3)), resolution=np.full(n, 0.4),
             std=rng.uniform(0, 0.01, n), valid=rng.uniform(size=n) > 0.1)
    return (jst.Surfels(**{k: jnp.asarray(v) for k, v in d.items()}),
            tst.Surfels(**{k: torch.as_tensor(v) for k, v in d.items()}))


@pytest.fixture(scope="module")
def built():
    """Surfel factors (binary + unary) and IMU factors built by both packages
    from the same states."""
    rng = np.random.default_rng(0)
    js, ts, sd = _sample(rng)
    jsw, tsw = _surfels(rng, 64)
    jfx, tfx = _surfels(rng, 48)
    m = 40
    iq, it = rng.integers(0, 64, m), rng.integers(0, 64, m)
    iu = rng.integers(0, 48, m)
    pv = rng.uniform(size=m) > 0.2
    out = {}
    for name, st_j, st_t, tgt, opt in (("binary", jsw, tsw, it, True),
                                       ("unary", jfx, tfx, iu, False)):
        out[name] = (
            jf.build_surfel_factors(jsw, st_j, jnp.asarray(iq), jnp.asarray(tgt), jnp.asarray(pv),
                                    js, 0.05 / 6.0, target_optimized=opt),
            tf.build_surfel_factors(tsw, st_t, torch.as_tensor(iq), torch.as_tensor(tgt),
                                    torch.as_tensor(pv), ts, 0.05 / 6.0, target_optimized=opt))
    n_imu = 160
    it_ = np.where(np.arange(n_imu) < 140, np.arange(n_imu) * IMU_DT, 0.0)
    rot = rng.normal(size=(n_imu, 4))
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    imu_d = dict(t=it_, rot=rot, pos=rng.normal(size=(n_imu, 3)),
                 acc=rng.normal(size=(n_imu, 3)), gyr=rng.normal(size=(n_imu, 3)),
                 count=np.int64(140))
    ji = jst.ImuStates(**{k: jnp.asarray(v) for k, v in imu_d.items()})
    ti = tst.ImuStates(**{k: torch.as_tensor(v) for k, v in imu_d.items()})
    out["imu"] = (jf.build_imu_factors(ji, js, 128), tf.build_imu_factors(ti, ts, 128))
    out["sample"] = (js, ts, sd)
    return out


def _cmp_struct(tobj, jobj):
    for k, v in tobj.fields().items():
        ref = np.asarray(getattr(jobj, k))
        if v.dtype in (torch.bool, torch.int64, torch.int32):
            np.testing.assert_array_equal(v.numpy(), ref, err_msg=k)
        else:
            _close(v.numpy(), ref)


@pytest.mark.parametrize("kind", ["binary", "unary", "imu"])
def test_build_factors(built, kind):
    jfac, tfac = built[kind]
    _cmp_struct(tfac, jfac)


def test_sample_bracket(built):
    js, ts, _ = built["sample"]
    q = np.concatenate([np.linspace(-0.1, 0.8, 57), np.arange(S_COUNT) * SDT])
    for a, b in zip(tf.sample_bracket(ts, torch.as_tensor(q)), jf.sample_bracket(js, jnp.asarray(q))):
        _close(a.numpy(), b)


@pytest.mark.parametrize("with_interp", [False, True])
@pytest.mark.parametrize("kind", ["binary", "unary"])
def test_surfel_residuals(built, kind, with_interp):
    jfac, tfac = built[kind]
    cor = np.random.default_rng(1).normal(scale=0.05, size=(S_CAP, 12))
    wj = jf.interp_weights(jfac, S_CAP, jnp.float64) if with_interp else None
    wt = tf.interp_weights(tfac, S_CAP, torch.float64) if with_interp else None
    if with_interp:
        _close(wt[0].numpy(), wj[0])
        _close(wt[1].numpy(), wj[1])
    got = tf.surfel_residuals(tfac, torch.as_tensor(cor), w_interp=wt)
    ref = jf.surfel_residuals(jfac, jnp.asarray(cor), w_interp=wj)
    for a, b in zip(got, ref):
        _close(a.numpy(), b)
    _close(tf.direction_coverage(tfac, torch.zeros(3, dtype=torch.float64))[0].numpy(),
           jf.direction_coverage(jfac, jnp.zeros(3))[0])
    _close(tf.direction_coverage(tfac, torch.ones(3, dtype=torch.float64))[1].numpy(),
           jf.direction_coverage(jfac, jnp.ones(3))[1])


def test_imu_residuals(built):
    jfac, tfac = built["imu"]
    cor = np.random.default_rng(2).normal(scale=0.05, size=(S_CAP, 12))
    grav = np.array([0.1, -0.2, -9.8])
    got = tf.imu_residuals(tfac, torch.as_tensor(cor), WEIGHTS, IMU_DT, torch.as_tensor(grav))
    ref = jf.imu_residuals(jfac, jnp.asarray(cor), WEIGHTS, IMU_DT, jnp.asarray(grav))
    for a, b in zip(got, ref):
        _close(a.numpy(), b, atol=1e-8)  # residual scale ~1e4 (w_ba / dt^2 terms)


def _dense_jac(jac, idx, rows):
    """Scatter per-block Jacobians (M, B, R, 12) into dense (M*R, S*12)."""
    m, nb = idx.shape
    jac = jac.reshape(m, nb, rows, 12)
    out = np.zeros((m, rows, S_CAP, 12))
    for b in range(nb):
        for i in range(m):
            out[i, :, idx[i, b]] += jac[i, b]
    return out.reshape(m * rows, S_CAP * 12)


@pytest.mark.parametrize("kind", ["binary", "unary", "imu"])
def test_jacobians_match_autograd(built, kind):
    _, tfac = built[kind]
    cor = torch.as_tensor(np.random.default_rng(3).normal(scale=0.05, size=(S_CAP, 12)))
    grav = torch.tensor([0.0, 0.0, -9.81], dtype=torch.float64)
    if kind == "imu":
        fn = lambda c: tf.imu_residuals(tfac, c, WEIGHTS, IMU_DT, grav, with_jac=False)[0]
        _, jac, idx = tf.imu_residuals(tfac, cor, WEIGHTS, IMU_DT, grav)
        rows = 12
    else:
        fn = lambda c: tf.surfel_residuals(tfac, c, with_jac=False)[0]
        _, jac, idx = tf.surfel_residuals(tfac, cor)
        rows = 1
    auto = torch.autograd.functional.jacobian(fn, cor).reshape(-1, S_CAP * 12).numpy()
    dense = _dense_jac(jac.numpy(), idx.numpy(), rows)
    scale = max(1.0, np.abs(auto).max())
    np.testing.assert_allclose(dense, auto, rtol=0, atol=1e-8 * scale)
