"""The port's numpy-only modules against the JAX package's originals.

``wildcat_slam_tpu_torch.config``, ``.io``, ``.utils.histogram``,
``.odometry._ptbuf`` and the host ``ImuResampler`` are copies so that the
port imports nothing of the JAX package; these tests hold each copy to its
original: equal config fields and checks, bit-equal synthetic sequences and
ATE, the same point-buffer output and checkpoint dumps, the same resampler
state, datasets and trajectory files that the JAX package reads back, framed
streams and ROS bags that each package reads from the other, and the same
residual histograms.
"""

import dataclasses
import io

import numpy as np
import pytest

from wildcat_slam_tpu import config as jcfg
from wildcat_slam_tpu.io import dataset as jds
from wildcat_slam_tpu.io import rosbag as jbag
from wildcat_slam_tpu.io import stream as jstream
from wildcat_slam_tpu.io import synthetic as jsyn
from wildcat_slam_tpu.io import trajectory as jtraj
from wildcat_slam_tpu.odometry import _ptbuf as jbuf
from wildcat_slam_tpu.odometry.imu import ImuResampler as JaxResampler
from wildcat_slam_tpu.utils import histogram as jhist
from wildcat_slam_tpu_torch import config as tcfg
from wildcat_slam_tpu_torch.io import dataset as tds
from wildcat_slam_tpu_torch.io import rosbag as tbag
from wildcat_slam_tpu_torch.io import stream as tstream
from wildcat_slam_tpu_torch.io import synthetic as tsyn
from wildcat_slam_tpu_torch.io import trajectory as ttraj
from wildcat_slam_tpu_torch.odometry import _ptbuf as tbuf
from wildcat_slam_tpu_torch.odometry.imu import ImuResampler
from wildcat_slam_tpu_torch.utils import histogram as thist


def test_config_fields_and_defaults_match_jax():
    j, t = jcfg.WildcatConfig(), tcfg.WildcatConfig()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for name in ("weight_gyr", "weight_acc", "weight_bg", "weight_ba", "imu_dt"):
        assert getattr(t, name) == getattr(j, name)
    assert tcfg.WildcatConfig.from_json(j.to_json()) == t
    assert t.replace(pcg_iters=7).pcg_iters == 7


@pytest.mark.parametrize("bad", [dict(outer_iter_num_max=0), dict(max_sample_states=0),
                                 dict(sample_dt=0.0), dict(linear_solver="lu"),
                                 dict(degeneracy_warn_ratio=1.0), dict(dtype="float16")])
def test_config_rejects_what_jax_rejects(bad):
    for cls in (jcfg.WildcatConfig, tcfg.WildcatConfig):
        with pytest.raises(ValueError):
            cls(**bad)


@pytest.mark.parametrize("kw", [dict(geometry="room"), dict(geometry="cylinder"),
                                dict(geometry="ramp", travel=0.5, pillar_spacing=3.0,
                                     door_spacing=6.0, outlier_fraction=0.05)])
def test_synthetic_sequence_matches_jax(kw):
    args = dict(duration=0.35, points_per_scan=300, room_half=4.0, seed=2, **kw)
    j, t = jsyn.SyntheticSequence(**args), tsyn.SyntheticSequence(**args)
    assert len(t.imu) == len(j.imu) and len(t.scans) == len(j.scans) == 3
    for a, b in zip(t.imu, j.imu):
        assert a[0] == b[0] and np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
    for (ta, pa), (tb, pb) in zip(t.scans, j.scans):
        assert np.array_equal(ta, tb) and np.array_equal(pa, pb)
    times = np.linspace(0.0, 0.3, 7)
    for a, b in zip(t.gt_pose(times), j.gt_pose(times)):
        assert np.array_equal(a, b)
    traj = [(s, p + 0.01 * np.sin(s), q) for s, p, q in zip(times, *j.gt_pose(times))]
    for align in (False, True):
        assert tsyn.ate_rmse(traj, lambda s: t.gt_pose(s)[0], align=align) == \
            jsyn.ate_rmse(traj, lambda s: j.gt_pose(s)[0], align=align)


def test_point_buffer_matches_jax():
    seq = jsyn.SyntheticSequence(duration=0.4, points_per_scan=500, room_half=4.0, seed=1)
    cfg = jcfg.WildcatConfig()
    bufs = [jbuf.ChunkedPointBuffer(cfg), tbuf.ChunkedPointBuffer(tcfg.WildcatConfig())]
    for ts, pts in seq.scans:
        assert len({b.add_points(ts, pts.astype(np.float32)) for b in bufs}) == 1
    assert len({b.drop_before(0.05) for b in bufs}) == 1
    assert len({b.count_until(0.3) for b in bufs}) == 1
    outs = []
    for b in bufs:
        out_t, out_xyz = np.zeros(700, np.float32), np.zeros((700, 3), np.float32)
        n = b.pop_sweep(0.3, 0.05, out_t, out_xyz)
        outs.append((n, out_t, out_xyz, len(b), b.front_time, b.back_time))
    (n1, t1, x1, *r1), (n2, t2, x2, *r2) = outs
    assert n1 == n2 == 700 and r1 == r2
    assert np.array_equal(t1, t2) and np.array_equal(x1, x2)


def test_dataset_and_trajectory_files_cross_read(tmp_path):
    seq = tsyn.SyntheticSequence(duration=0.3, points_per_scan=200, seed=4)
    tds.from_synthetic(seq, str(tmp_path / "seq"))
    ev_t = list(tds.Dataset(str(tmp_path / "seq")))
    ev_j = list(jds.Dataset(str(tmp_path / "seq")))
    assert len(ev_t) == len(ev_j) > len(seq.scans)
    for a, b in zip(ev_t, ev_j):
        assert a[0] == b[0] and all(np.array_equal(x, y) for x, y in zip(a[1:], b[1:]))
    traj = [(0.5 * k, np.array([k, 2.0 * k, -k]), np.array([1.0, 0.0, 0.0, 0.0])) for k in range(3)]
    ttraj.save_tum(str(tmp_path / "t.tum"), traj)
    jtraj.save_tum(str(tmp_path / "j.tum"), traj)
    assert (tmp_path / "t.tum").read_text() == (tmp_path / "j.tum").read_text()
    for a, b in zip(jtraj.load_tum(str(tmp_path / "t.tum")), traj):
        assert a[0] == b[0] and np.allclose(a[1], b[1]) and np.allclose(a[2], b[2])


def _same_events(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x[0] == y[0] and all(np.array_equal(u, v) for u, v in zip(x[1:], y[1:]))


def test_point_buffer_dump_restore_matches_jax():
    seq = jsyn.SyntheticSequence(duration=0.3, points_per_scan=400, room_half=4.0, seed=5)
    bufs = [jbuf.ChunkedPointBuffer(jcfg.WildcatConfig()),
            tbuf.ChunkedPointBuffer(tcfg.WildcatConfig())]
    for ts, pts in seq.scans:
        for b in bufs:
            b.add_points(ts, pts.astype(np.float32))
    (jt, jx), (tt, tx) = (b.dump() for b in bufs)
    assert np.array_equal(jt, tt) and np.array_equal(jx, tx) and len(tt) == len(bufs[1])
    fresh = tbuf.ChunkedPointBuffer(tcfg.WildcatConfig())
    fresh.restore(jt, jx)
    assert len(fresh) == len(bufs[0]) and fresh.front_time == bufs[0].front_time
    assert fresh.count_until(0.2) == bufs[0].count_until(0.2)


def test_resampler_state_matches_jax():
    rng = np.random.default_rng(3)
    raw = [(0.0013 + 0.0031 * i, rng.normal(size=3), rng.normal(size=3)) for i in range(40)]
    j, t = JaxResampler(200.0), ImuResampler(200.0)
    assert np.array_equal(j.get_state(), t.get_state())
    for r in raw[:25]:
        j.add(*r)
        t.add(*r)
    assert np.array_equal(j.get_state(), t.get_state())
    t2 = ImuResampler(200.0)
    t2.set_state(j.get_state())  # a JAX resampler's state resumes in the port
    for r in raw[25:]:
        a, b = j.add(*r), t2.add(*r)
        assert len(a) == len(b)
        assert all(x[0] == y[0] and np.array_equal(x[1], y[1]) for x, y in zip(a, b))


def test_stream_copy_matches_jax():
    blobs = []
    for mod in (jstream, tstream):
        buf = io.BytesIO()
        mod.stream_synthetic(buf, duration=0.3, points_per_scan=200, seed=3, realtime=False)
        blobs.append(buf.getvalue())
    assert blobs[0] == blobs[1]
    evs_t = list(tstream.read_stream(io.BytesIO(blobs[0])))
    _same_events(evs_t, list(jstream.read_stream(io.BytesIO(blobs[0]))))
    for bad in (blobs[0][:-20], b"XXXX" + blobs[0][4:]):  # truncated payload, bad magic
        errs = []
        for mod in (jstream, tstream):
            with pytest.raises((EOFError, ValueError)) as e:
                list(mod.read_stream(io.BytesIO(bad)))
            errs.append(type(e.value))
        assert errs[0] == errs[1]
    readers = [mod.BoundedQueueReader(io.BytesIO(blobs[0]), imu_queue=7, scan_queue=1)
               for mod in (jstream, tstream)]
    for r in readers:
        r.join(30)
    got = [list(r) for r in readers]
    _same_events(got[1], got[0])
    assert readers[0].dropped == readers[1].dropped and readers[1].dropped["imu"] > 0


def test_rosbag_copy_matches_jax(tmp_path):
    rng = np.random.default_rng(8)
    evs = [("imu", 1000.0 + i * 0.005, rng.normal(size=3), rng.normal(size=3)) for i in range(30)]
    for k in range(3):
        times = 1000.0 + k * 0.06 + rng.uniform(0, 0.05, 50)  # unsorted: the reader sorts
        evs.append(("scan", times, rng.normal(size=(50, 3)) * 5))
    paths = [str(tmp_path / "j.bag"), str(tmp_path / "t.bag")]
    jbag.write_bag(paths[0], evs)
    tbag.write_bag(paths[1], evs)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    _same_events(list(tbag.read_bag(paths[0])), list(jbag.read_bag(paths[0])))
    _same_events(list(tbag.read_bag(paths[0], lidar_topic="/none")),
                 list(jbag.read_bag(paths[0], lidar_topic="/none")))
    counts = tbag.convert_bag(paths[0], str(tmp_path / "seq"))
    assert counts == {"imu": 30, "scans": 3}
    assert len(list(jds.Dataset(str(tmp_path / "seq")))) == 33


def test_histogram_copy_matches_jax():
    rng = np.random.default_rng(2)
    v = np.concatenate([rng.normal(size=500), [np.nan, np.inf]])
    assert thist.residual_report("surfel", v) == jhist.residual_report("surfel", v)
    for vals in (np.zeros(0), np.ones(4)):
        assert str(thist.Histogram().add(vals)) == str(jhist.Histogram().add(vals))
