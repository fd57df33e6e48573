"""The port's C++ host feeder (``wildcat_slam_tpu_torch/io/native.py`` over
its copy ``csrc/feeder.cc``) against the JAX package's (``io/native.py`` over
``native/feeder.cc``) and against the numpy feeder.

Twins of the six cases of ``tests/test_native.py`` (filter, scan file,
``drop_before``, resampler, end to end, NaN/Inf points), each also held
against the JAX package's ``NativeFeeder``/``NativeResampler`` with the same
inputs: bit-equal, since both libraries compile the same source. Then: the
source copy is byte-equal to the original; with no compiler ``use_native``
raises instead of falling back to numpy; a checkpoint written on the native
feeder resumes on it in both packages; a batch's windows take the feeder
asked for. The end-to-end runs use the port only (the JAX pipeline is held
to the port's numpy feeder by ``tests/test_torch_pipeline.py``).
"""

import os

import numpy as np
import pytest
import torch

from wildcat_slam_tpu.io import native as jnative
from wildcat_slam_tpu.odometry import checkpoint as jckpt
from wildcat_slam_tpu_torch.cli import feed_events, synthetic_events
from wildcat_slam_tpu_torch.config import WildcatConfig
from wildcat_slam_tpu_torch.io import native
from wildcat_slam_tpu_torch.io.dataset import save_scan
from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence
from wildcat_slam_tpu_torch.odometry import checkpoint
from wildcat_slam_tpu_torch.odometry._ptbuf import ChunkedPointBuffer
from wildcat_slam_tpu_torch.odometry.imu import ImuResampler
from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry
from wildcat_slam_tpu_torch.parallel.batch import BatchedOdometry

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the small config of tests/test_native.py's end-to-end case
SMALL = WildcatConfig(max_points_per_sweep=16384, max_surfels_per_sweep=512,
                      max_surfels_sliding=2048, max_surfels_fixed=2048,
                      max_correspondences=2048, max_leaves_per_sweep=4096,
                      max_imu_states=640, max_sample_states=48, inner_iter_num_max=15)


@pytest.fixture(scope="module")
def libs():
    """Both packages' libraries: the port's built from its csrc/ with g++."""
    if not native.available():
        pytest.skip("the port's native feeder does not build here (no g++)")
    if not jnative.available():
        pytest.skip("the JAX package's native library is unavailable")


def _feeders(cfg):
    args = (np.asarray(cfg.ext_lidar2imu_rot).reshape(3, 3), cfg.ext_lidar2imu_pos,
            cfg.min_range, cfg.max_range, cfg.blind_box_min, cfg.blind_box_max)
    return native.NativeFeeder(*args), jnative.NativeFeeder(*args)


def _python_filter(cfg, times, pts):
    p = pts @ np.asarray(cfg.ext_lidar2imu_rot).reshape(3, 3).T + np.asarray(cfg.ext_lidar2imu_pos)
    rng = np.linalg.norm(p, axis=1)
    in_box = np.all((p >= np.asarray(cfg.blind_box_min)) & (p <= np.asarray(cfg.blind_box_max)),
                    axis=1)
    keep = (rng >= cfg.min_range) & (rng <= cfg.max_range) & ~in_box
    return times[keep], p[keep]


def _pop(f, n_out, t_end, epoch):
    out_t = np.zeros(n_out, np.float32)
    out_p = np.zeros((n_out, 3), np.float32)
    n = f.pop_sweep(t_end, epoch, out_t, out_p)
    return n, out_t[:n], out_p[:n]


def test_filter_matches_python_and_jax(libs):
    cfg = WildcatConfig()
    rng = np.random.default_rng(0)
    pts = rng.uniform(-10, 10, (5000, 3))
    pts[:100] *= 0.02   # some inside the min range / blind box
    pts[100:120] *= 30  # some beyond the max range
    times = np.sort(rng.uniform(0, 1, 5000))
    f, jf = _feeders(cfg)
    kept = f.add_points(times, pts.astype(np.float32))
    ref_t, ref_p = _python_filter(cfg, times, pts.astype(np.float32).astype(np.float64))
    assert kept == len(ref_t) == len(f) == jf.add_points(times, pts.astype(np.float32))
    n, out_t, out_p = _pop(f, 8192, 2.0, 0.0)
    assert n == len(ref_t) and len(f) == 0
    np.testing.assert_allclose(out_t, ref_t, atol=1e-6)
    np.testing.assert_allclose(out_p, ref_p, atol=1e-5)
    jn, jt, jp = _pop(jf, 8192, 2.0, 0.0)
    assert jn == n and np.array_equal(out_t, jt) and np.array_equal(out_p, jp)


def test_scan_file_roundtrip(libs, tmp_path):
    cfg = WildcatConfig()
    rng = np.random.default_rng(1)
    pts = rng.uniform(-10, 10, (1000, 3)).astype(np.float32)
    times = 1000.0 + np.sort(rng.uniform(0, 0.1, 1000))
    path = str(tmp_path / "s.wcs")
    save_scan(path, times, pts)
    f, jf = _feeders(cfg)
    kept = f.load_scan(path)
    ref_t, _ = _python_filter(cfg, times, pts.astype(np.float64))
    assert kept == len(ref_t) == jf.load_scan(path)
    n, out_t, out_p = _pop(f, 4096, 2000.0, 1000.0)
    assert n == kept
    np.testing.assert_allclose(out_t, ref_t - 1000.0, atol=1e-4)
    jn, jt, jp = _pop(jf, 4096, 2000.0, 1000.0)
    assert jn == n and np.array_equal(out_t, jt) and np.array_equal(out_p, jp)
    with pytest.raises(IOError):
        f.load_scan(str(tmp_path / "missing.wcs"))


def test_drop_before(libs):
    f, jf = _feeders(WildcatConfig())
    times = np.linspace(0, 1, 100)
    pts = np.full((100, 3), 5.0, np.float32)
    for g in (f, jf):
        g.add_points(times, pts)
    assert f.drop_before(0.5) == jf.drop_before(0.5) == 50
    assert abs(f.front_time - times[50]) < 1e-12
    assert f.front_time == jf.front_time and f.back_time == jf.back_time
    assert f.count_until(0.75) == jf.count_until(0.75)
    with pytest.raises(ValueError):  # the point array must hold one row per time
        f.add_points(times, pts[:99])


def test_resampler_matches_numpy_and_jax(libs):
    rate = 200.0
    py, nat, jnat = ImuResampler(rate), native.NativeResampler(rate), jnative.NativeResampler(rate)
    rng = np.random.default_rng(2)
    t = 0.0
    for _ in range(500):
        t += rng.uniform(0.002, 0.008)
        acc, gyr = rng.normal(size=3), rng.normal(size=3)
        out_py, out_nat, out_j = py.add(t, acc, gyr), nat.add(t, acc, gyr), jnat.add(t, acc, gyr)
        assert len(out_py) == len(out_nat) == len(out_j)
        for (tp, ap, gp), (tn, an, gn), (tj, aj, gj) in zip(out_py, out_nat, out_j):
            assert tp == tn == tj  # the same grid expression: bit-equal
            np.testing.assert_allclose(ap, an, atol=0)
            np.testing.assert_allclose(gp, gn, atol=0)
            assert np.array_equal(an, aj) and np.array_equal(gn, gj)
    assert py._t0 == nat._t0 == jnat._t0
    assert np.array_equal(nat.get_state(), py.get_state())
    assert np.array_equal(nat.get_state(), jnat.get_state())


@pytest.fixture(scope="module")
def runs(libs):
    """The port on the numpy and on the native feeder over the sequence of
    tests/test_native.py's end-to-end case, and the native run's events."""
    seq = SyntheticSequence(duration=1.6, points_per_scan=3000, room_half=4.0, seed=0)
    events = list(synthetic_events(seq))
    out = {}
    for use_native in (False, True):
        lo = LidarOdometry(SMALL, device="cpu", use_native=use_native)
        feed_events(lo, events)
        out[use_native] = lo
    return out, events


def test_native_feeder_end_to_end_equivalence(runs):
    (los, _) = runs
    a, b = los[False], los[True]
    assert not a.use_native and b.use_native
    assert isinstance(b.points, native.NativeFeeder)
    assert isinstance(b.resampler, native.NativeResampler)
    assert a.sweep_id == b.sweep_id >= 3
    for (t1, p1, _), (t2, p2, _) in zip(a.trajectory, b.trajectory):
        assert t1 == t2
        # the native feeder holds its points in float32, the numpy one in
        # float64 until the feed: equal up to that rounding
        np.testing.assert_allclose(p1, p2, atol=2e-4)


def test_nan_and_inf_points_dropped_on_every_feeder(libs):
    cfg = WildcatConfig()
    rng = np.random.default_rng(0)
    n = 500
    pts = rng.uniform(-5, 5, (n, 3))
    pts[::50] = np.nan
    pts[1::50] = np.inf
    pts[2::50] = -np.inf
    times = np.sort(rng.uniform(0, 0.1, n))
    py = ChunkedPointBuffer(cfg)
    n_py = py.add_points(times, pts.copy())
    tp, xp = py.dump()
    assert np.all(np.isfinite(xp))
    f, jf = _feeders(cfg)
    assert f.add_points(times, pts.copy()) == jf.add_points(times, pts.copy()) == n_py
    tn, xn = f.dump()
    np.testing.assert_allclose(tn, tp, atol=0)
    np.testing.assert_allclose(xn, xp, rtol=0, atol=1e-6)
    tj, xj = jf.dump()
    assert np.array_equal(tn, tj) and np.array_equal(xn, xj)


def test_feeder_source_is_a_copy_of_the_reference():
    with open(os.path.join(REPO, "native", "feeder.cc"), "rb") as f:
        original = f.read()
    assert native.SOURCE.read_bytes() == original


def test_use_native_raises_without_a_compiler(monkeypatch, tmp_path):
    """No fallback: with g++ missing and nothing built, use_native=True
    raises rather than running on the numpy feeder."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        LidarOdometry(SMALL, device="cpu", use_native=True)
    assert not native.available()
    assert not (tmp_path / "build").exists()
    assert not LidarOdometry(SMALL, device="cpu").use_native  # the numpy feeder needs none


def test_native_checkpoint_resumes_on_the_native_feeder_in_both_packages(runs, tmp_path):
    """The port's native run saved after its first sweep; the JAX package
    loads it on its native feeder and saves it again; the port resumes that
    JAX file on the native feeder and runs on to the uninterrupted native
    run's trajectory, bit for bit."""
    (los, events) = runs
    lo = LidarOdometry(SMALL, device="cpu", use_native=True)
    n = feed_events(lo, events, until_sweep=1)
    port_file, jax_file = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    checkpoint.save(port_file, lo)

    jlo = jckpt.load(port_file)
    assert jlo.use_native and isinstance(jlo.points, jnative.NativeFeeder)
    (ta, xa), (tb, xb) = lo.points.dump(), jlo.points.dump()
    assert len(ta) > 0 and np.array_equal(ta, tb) and np.array_equal(xa, xb)
    assert np.array_equal(jlo.resampler.get_state(), lo.resampler.get_state())
    jckpt.save(jax_file, jlo)

    resumed = checkpoint.load(jax_file, device="cpu")
    assert resumed.use_native and isinstance(resumed.points, native.NativeFeeder)
    assert not checkpoint.load(jax_file, device="cpu", use_native=False).use_native
    feed_events(resumed, events[n:])
    full = los[True].trajectory
    assert len(resumed.trajectory) == len(full) >= 3
    for (t1, p1, q1), (t2, p2, q2) in zip(resumed.trajectory, full):
        assert t1 == t2 and np.array_equal(p1, p2) and np.array_equal(q1, q2)


def test_batch_windows_take_the_feeder_asked_for(libs, tmp_path):
    bo = BatchedOdometry(SMALL, batch=2, device="cpu", use_native=True)
    assert all(isinstance(w.points, native.NativeFeeder) for w in bo.windows)
    paths = checkpoint.save_batch(str(tmp_path / "b.npz"), bo)
    assert all(w.use_native for w in checkpoint.load_batch(paths, device="cpu").windows)
    assert not any(w.use_native for w in
                   checkpoint.load_batch(paths, device="cpu", use_native=False).windows)
