"""The port's IMU and window modules against the JAX package's.

Tolerances: float64 within 1e-10; float32 within 64 ulp of the value's
magnitude, except the quaternion prefix product of ``propagate``, whose
log-step association order differs from ``lax.associative_scan``'s
(float32: 1e-5 absolute on unit quaternions and on positions of a few
metres over 16 ticks). Pure gathers and scatters (window ops) are exact.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from wildcat_slam_tpu.odometry import imu as jimu
from wildcat_slam_tpu.odometry import states as jst
from wildcat_slam_tpu.odometry import window as jwin
from wildcat_slam_tpu_torch.odometry import imu as timu
from wildcat_slam_tpu_torch.odometry import states as tst
from wildcat_slam_tpu_torch.odometry import window as twin

torch.set_num_threads(1)

DTYPES = {"float64": np.float64, "float32": np.float32}
DT = 0.005


def _close(got, ref, dt, atol32=None):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    if dt == "float64":
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
    elif atol32 is not None:
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol32)
    else:
        tol = 64 * np.finfo(np.float32).eps * np.maximum(1.0, np.abs(ref))
        assert np.all(np.abs(got - ref) <= tol), np.max(np.abs(got - ref) / tol)


def _imu_np(rng, cap=64, count=40, npd=np.float64):
    t = np.where(np.arange(cap) < count, np.arange(cap) * DT, 0.0)
    w = rng.normal(scale=0.01, size=(cap, 3))
    half = np.linalg.norm(w, axis=1, keepdims=True) / 2
    dq = np.concatenate([np.cos(half), np.sin(half) * w / (2 * half)], 1)
    rot = np.zeros((cap, 4))
    rot[0] = [1.0, 0, 0, 0]
    for i in range(1, cap):  # cumulative product of small rotations
        a, b = rot[i - 1], dq[i]
        rot[i] = [a[0] * b[0] - a[1:] @ b[1:], *(a[0] * b[1:] + b[0] * a[1:] + np.cross(a[1:], b[1:]))]
    pos = np.cumsum(rng.normal(scale=0.01, size=(cap, 3)), 0)
    acc = np.array([0.0, 0.0, 9.81]) + rng.normal(scale=0.1, size=(cap, 3))
    gyr = rng.normal(scale=0.05, size=(cap, 3))
    return dict(t=t.astype(npd), rot=rot.astype(npd), pos=pos.astype(npd), acc=acc.astype(npd),
                gyr=gyr.astype(npd), count=np.int64(count))


def _both(cls_j, cls_t, d):
    return (cls_j(**{k: jnp.asarray(v) for k, v in d.items()}),
            cls_t(**{k: torch.as_tensor(v) for k, v in d.items()}))


def _cmp_fields(tobj, jobj, dt, exact=False, **kw):
    for name, v in tobj.fields().items():
        ref = np.asarray(getattr(jobj, name))
        if exact or v.dtype in (torch.bool, torch.int64, torch.int32):
            np.testing.assert_array_equal(v.numpy(), ref, err_msg=name)
        else:
            _close(v.numpy(), ref, dt, **kw)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_propagate(dt):
    npd = DTYPES[dt]
    rng = np.random.default_rng(0)
    d = _imu_np(rng, npd=npd)
    ji, ti = _both(jst.ImuStates, tst.ImuStates, d)
    k = 16
    new_t = ((40 + np.arange(k)) * DT).astype(npd)
    new_acc = (np.array([0, 0, 9.81]) + rng.normal(scale=0.1, size=(k, 3))).astype(npd)
    new_gyr = rng.normal(scale=0.5, size=(k, 3)).astype(npd)
    bg, ba, grav = (rng.normal(scale=s, size=3).astype(npd) for s in (1e-3, 1e-2, 1.0))
    args = (new_t, new_acc, new_gyr)
    jo = jimu.propagate(ji, *map(jnp.asarray, args), jnp.asarray(12, jnp.int32),
                        *map(jnp.asarray, (bg, ba, grav)), DT)
    to = timu.propagate(ti, *map(torch.as_tensor, args), torch.tensor(12),
                        *map(torch.as_tensor, (bg, ba, grav)), DT)
    _cmp_fields(to, jo, dt, atol32=1e-5)


@pytest.mark.parametrize("sorted_t", [True, False])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_undistort(dt, sorted_t):
    npd = DTYPES[dt]
    rng = np.random.default_rng(1)
    ji, ti = _both(jst.ImuStates, tst.ImuStates, _imu_np(rng, npd=npd))
    n = 300
    # sorted sweep stamps incl. exact grid ticks, out-of-range ends, and the
    # zero padding tail a sweep buffer carries
    pt = np.sort(np.concatenate([rng.uniform(-0.01, 40 * DT, n - 40), np.arange(30) * DT]))
    pt = np.concatenate([pt, np.zeros(10)]).astype(npd)
    xyz = rng.normal(scale=5.0, size=(n, 3)).astype(npd)
    got = timu.undistort_points(ti, torch.as_tensor(pt), torch.as_tensor(xyz), sorted_t=sorted_t)
    ref = jimu.undistort_points(ji, jnp.asarray(pt), jnp.asarray(xyz), sorted_t=sorted_t)
    # the JAX sorted path's telescoped running sum rounds; the port gathers
    # the bracket values directly (imu.py _interp_pose_sorted)
    _close(got.numpy(), ref, dt, atol32=2e-5 if sorted_t else None)


def test_init_from_first_two():
    rng = np.random.default_rng(2)
    d = _imu_np(rng)
    ji, ti = _both(jst.ImuStates, tst.ImuStates, d)
    t, acc, gyr = np.array([0.0, DT]), rng.normal(size=(2, 3)), rng.normal(size=(2, 3))
    jo = jimu.init_from_first_two(ji, jnp.asarray(t), jnp.asarray(acc), jnp.asarray(gyr), DT)
    to = timu.init_from_first_two(ti, torch.as_tensor(t), torch.as_tensor(acc),
                                  torch.as_tensor(gyr), DT)
    _cmp_fields(to, jo, "float64")


def test_imu_resampler_identical():
    rng = np.random.default_rng(3)
    t = np.cumsum(rng.uniform(0.001, 0.009, 400)) + 100.0
    t[50] = t[49]  # duplicate stamp
    acc, gyr = rng.normal(size=(400, 3)), rng.normal(size=(400, 3))
    rj, rt = jimu.ImuResampler(200.0), timu.ImuResampler(200.0)
    for i in range(400):
        a = rj.add(t[i], acc[i], gyr[i])
        b = rt.add(t[i], acc[i], gyr[i])
        assert len(a) == len(b)
        for (ta, aa, ga), (tb, ab, gb) in zip(a, b):
            assert ta == tb
            np.testing.assert_array_equal(aa, ab)
            np.testing.assert_array_equal(ga, gb)
    with pytest.raises(ValueError):
        rt.add(t[0], acc[0], gyr[0])


def _sample_np(rng, cap=24, count=5, npd=np.float64):
    stride = 16 * DT
    t = np.where(np.arange(cap) < count, np.arange(cap) * stride, 0.0)
    rot = rng.normal(size=(cap, 4))
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    return dict(t=t.astype(npd), rot=rot.astype(npd), pos=rng.normal(size=(cap, 3)).astype(npd),
                cor=rng.normal(size=(cap, 12)).astype(npd), count=np.int64(count),
                grav=np.array([0, 0, -9.81], npd))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_add_sample_states(dt):
    npd = DTYPES[dt]
    rng = np.random.default_rng(4)
    ji, ti = _both(jst.ImuStates, tst.ImuStates, _imu_np(rng, cap=160, count=120, npd=npd))
    js, ts = _both(jst.SampleStates, tst.SampleStates, _sample_np(rng, npd=npd))
    new_t = (np.arange(5, 11) * 16 * DT).astype(npd)
    jo = jwin.add_sample_states(js, ji, jnp.asarray(new_t), jnp.asarray(4, jnp.int32))
    to = twin.add_sample_states(ts, ti, torch.as_tensor(new_t), torch.tensor(4))
    _cmp_fields(to, jo, dt)


def _surfels_np(rng, cap, n_valid, npd, t0=0.0):
    valid = np.zeros(cap, bool)
    valid[rng.choice(cap, n_valid, replace=False)] = True
    rot = rng.normal(size=(cap, 4))
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    t = np.round(rng.uniform(t0, t0 + 2.0, cap), 3)  # rounded: exercises equal keys
    return dict(t=t.astype(npd), center=rng.normal(size=(cap, 3)).astype(npd),
                cov=rng.normal(size=(cap, 3, 3)).astype(npd),
                norm=rng.normal(size=(cap, 3)).astype(npd), rot=rot.astype(npd),
                pos=rng.normal(size=(cap, 3)).astype(npd),
                resolution=rng.uniform(0.2, 0.8, cap).astype(npd),
                std=rng.uniform(0, 0.01, cap).astype(npd), valid=valid)


@pytest.mark.parametrize("n_win_valid", [10, 30])  # free slots / evictions
@pytest.mark.parametrize("dt", list(DTYPES))
def test_insert_surfels(dt, n_win_valid):
    npd = DTYPES[dt]
    rng = np.random.default_rng(5)
    jw, tw = _both(jst.Surfels, tst.Surfels, _surfels_np(rng, 32, n_win_valid, npd))
    jn, tn = _both(jst.Surfels, tst.Surfels, _surfels_np(rng, 12, 8, npd, t0=1.0))
    aux_w = rng.normal(size=(32, 12)).astype(npd)
    aux_n = rng.normal(size=(12, 12)).astype(npd)
    jo, je, ja = jwin.insert_surfels(jw, jn, win_aux=jnp.asarray(aux_w), new_aux=jnp.asarray(aux_n))
    to, te, ta = twin.insert_surfels(tw, tn, win_aux=torch.as_tensor(aux_w),
                                     new_aux=torch.as_tensor(aux_n))
    _cmp_fields(to, jo, dt, exact=True)
    _cmp_fields(te, je, dt, exact=True)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_extract_moved_and_rebase(dt):
    npd = DTYPES[dt]
    rng = np.random.default_rng(6)
    d = _surfels_np(rng, 40, 30, npd)
    jw, tw = _both(jst.Surfels, tst.Surfels, d)
    for cut, cap in ((0.8, 8), (1.5, 32)):  # capacity-limited and not
        js, jm = jwin.extract_moved(jw, jnp.asarray(npd(cut)), cap)
        ts_, tm = twin.extract_moved(tw, torch.tensor(cut, dtype=tw.t.dtype), cap)
        _cmp_fields(ts_, js, dt, exact=True)
        _cmp_fields(tm, jm, dt, exact=True)
    jsam, tsam = _both(jst.SampleStates, tst.SampleStates, _sample_np(rng, npd=npd))
    jimu_, timu_ = _both(jst.ImuStates, tst.ImuStates, _imu_np(rng, npd=npd))
    jf, tf = _both(jst.Surfels, tst.Surfels, _surfels_np(rng, 16, 9, npd))
    jout = jwin.rebase_times(jsam, jimu_, jw, jf)
    tout = twin.rebase_times(tsam, timu_, tw, tf)
    for a, b in zip(tout[:4], jout[:4]):
        _cmp_fields(a, b, dt)
    _close(tout[4].numpy(), jout[4], dt)
    buf = rng.normal(size=(24, 3)).astype(npd)
    for k in (0, 3, 30):
        np.testing.assert_array_equal(twin.shift_left(torch.as_tensor(buf), torch.tensor(k)).numpy(),
                                      np.asarray(jwin._shift_left(jnp.asarray(buf), k)))
