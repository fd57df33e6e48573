"""The port's pipeline against the JAX package's, end to end on CPU.

(a) One ``process_sweep`` in each package from the same window state and the
    same ``_prepare_feed`` arguments (float64, exact KNN): every state field
    within 1e-8, the packed integer counts equal.
(b) The port alone, float32 with the default per-bin KNN (K2's plain
    version): ATE < 0.02 m unaligned against exact ground truth.
(c) The port's trajectory against the JAX trajectory on the same run
    (float64, exact KNN) within 1e-6 m / 1e-6 on the quaternion.
(d) ``degeneracy_remap=True`` on the healthy room: the same trajectory as
    remap off, bit for bit (the projectors are exact zeros there).

(a) and (c) use a 0.5 s sliding window so that surfels migrate to the fixed
window inside the 1.6 s sequence and the fixed-window match runs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from wildcat_slam_tpu.config import WildcatConfig as JaxConfig
from wildcat_slam_tpu.odometry.pipeline import LidarOdometry as JaxOdometry
from wildcat_slam_tpu_torch.cli import feed_events, synthetic_events
from wildcat_slam_tpu_torch.config import WildcatConfig
from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence, ate_rmse
from wildcat_slam_tpu_torch.odometry.convert import (window_state_from_numpy,
                                                     window_state_to_numpy)
from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry, process_sweep

torch.set_num_threads(1)


def _small_cfg(cls=WildcatConfig, **kw):
    base = dict(max_points_per_sweep=16384, max_surfels_per_sweep=512, max_surfels_sliding=2048,
                max_surfels_fixed=2048, max_correspondences=2048, max_leaves_per_sweep=4096,
                max_imu_states=640, max_sample_states=48, inner_iter_num_max=25)
    base.update(kw)
    return cls(**base)


PARITY_KW = dict(dtype="float64", match_knn_approx=False, sliding_window_duration=0.5)
PARITY_CFG = _small_cfg(**PARITY_KW)


def _seq():
    return SyntheticSequence(duration=1.6, points_per_scan=4000, room_half=4.0, seed=0)


def _feed(lo, seq):
    feed_events(lo, synthetic_events(seq))
    return lo


def _flatten(jax_state) -> dict:
    """JAX WindowState -> dict of numpy arrays keyed by field path."""
    out = {}
    for part in ("sample", "imu", "sld", "fix"):
        obj = getattr(jax_state, part)
        for f in dataclasses.fields(obj):
            out[f"{part}.{f.name}"] = np.asarray(getattr(obj, f.name))
    out["fix_geo"] = np.asarray(jax_state.fix_geo)
    return out


@pytest.fixture(scope="module")
def jax_run():
    """The JAX pipeline on the parity config, recording each sweep's window
    state and feed arguments before its dispatch."""
    lo = JaxOdometry(_small_cfg(JaxConfig, **PARITY_KW))
    record = []
    prepare = lo._prepare_feed

    def recording_prepare():
        state = _flatten(lo.state)  # before process_sweep donates it
        prep = prepare()
        record.append((state, prep["args"]))
        return prep

    lo._prepare_feed = recording_prepare
    _feed(lo, _seq())
    traj = lo.trajectory
    return dict(record=record, final=_flatten(lo.state), traj=traj, stats=lo.stats)


def test_one_sweep_state_matches_jax(jax_run):
    record = jax_run["record"]
    assert len(record) == 3
    k = 2  # the third sweep: the fixed window is populated by then
    state_np, args = record[k]
    ref = jax_run["final"]
    state = window_state_from_numpy(state_np, "cpu", torch.float64)
    targs = [torch.as_tensor(np.asarray(a).astype(np.int64) if np.asarray(a).dtype == np.int32
                             else np.asarray(a)) for a in args]
    new_state, out = process_sweep(state, *targs, PARITY_CFG)
    packed = out["packed"]
    got = window_state_to_numpy(new_state)
    assert set(got) == set(ref)
    for key in sorted(ref):
        g, r = got[key], ref[key]
        if r.dtype == bool or np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(g, r, err_msg=key)
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-8, err_msg=key)
    st = jax_run["stats"][k]
    p = packed.numpy()
    for idx, name in ((8, "iterations"), (11, "n_new_surfels"), (12, "n_pairs_sld"),
                      (13, "n_pairs_fix"), (17, "n_surfels_dropped"), (18, "n_pairs_dropped")):
        assert int(p[idx]) == int(st[name]), name
    assert int(p[13]) > 0  # the fixed-window match contributed pairs


def test_trajectory_matches_jax(jax_run):
    lo = _feed(LidarOdometry(PARITY_CFG, device="cpu"), _seq())
    ref = jax_run["traj"]
    assert len(lo.trajectory) == len(ref) == 3
    for (t1, p1, q1), (t2, p2, q2) in zip(lo.trajectory, ref):
        assert t1 == t2
        np.testing.assert_allclose(p1, p2, rtol=0, atol=1e-6)
        np.testing.assert_allclose(q1, q2, rtol=0, atol=1e-6)


def test_short_sequence_ate_f32_bins():
    seq = _seq()
    lo = _feed(LidarOdometry(_small_cfg(), device="cpu"), seq)
    assert lo.sweep_id >= 3
    err = ate_rmse(lo.trajectory, lambda t: seq.gt_pose(t)[0], align=False)
    assert err < 0.02, f"ATE {err}"
    assert all(np.isfinite(s["final_cost"]) for s in lo.stats)
    assert all(s["n_new_surfels"] > 50 for s in lo.stats)


def test_remap_inert_on_the_room():
    seq = _seq()
    off = _feed(LidarOdometry(_small_cfg(), device="cpu"), seq)
    on = _feed(LidarOdometry(_small_cfg(degeneracy_remap=True), device="cpu"), seq)
    assert len(on.trajectory) == len(off.trajectory) >= 3
    for (t1, p1, q1), (t2, p2, q2) in zip(off.trajectory, on.trajectory):
        assert t1 == t2 and np.array_equal(p1, p2) and np.array_equal(q1, q2)
