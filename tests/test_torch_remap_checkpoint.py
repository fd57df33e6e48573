"""Degeneracy remapping, residual snapshots and checkpoints of the port
against the JAX package, on one float64 run of the cylinder (seed 2), the
scene whose rotation about the symmetry axis is unobserved, so the remap
fires (rotation coverage ratio below ``degeneracy_remap_ratio`` in the first
two sweeps).

(a) One ``process_sweep`` with ``degeneracy_remap=True`` and
    ``debug_residuals=True`` in each package from the same window state and
    feed: every state field within 1e-8 (summation order only, as in
    ``tests/test_torch_pipeline.py``), the residual snapshots within 1e-8.
(b) JAX runs a sweep and saves a checkpoint; the port loads it and runs on:
    its trajectory matches the JAX run that went on without stopping, within
    1e-6 m / 1e-6 on the quaternion (as ``test_trajectory_matches_jax``).
(c) The port saves; the JAX package loads and runs on: within the same bound
    of the port's uninterrupted run.

One JAX config for the whole file, so the per-sweep program compiles once.
"""

import dataclasses

import numpy as np
import pytest
import torch

from wildcat_slam_tpu.config import WildcatConfig as JaxConfig
from wildcat_slam_tpu.io.synthetic import SyntheticSequence
from wildcat_slam_tpu.odometry import checkpoint as jckpt
from wildcat_slam_tpu.odometry.pipeline import LidarOdometry as JaxOdometry
from wildcat_slam_tpu_torch.cli import feed_events, synthetic_events
from wildcat_slam_tpu_torch.config import WildcatConfig
from wildcat_slam_tpu_torch.odometry import checkpoint as tckpt
from wildcat_slam_tpu_torch.odometry.convert import (window_state_from_numpy,
                                                     window_state_to_numpy)
from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry, process_sweep

torch.set_num_threads(1)

CFG_KW = dict(max_points_per_sweep=16384, max_surfels_per_sweep=512, max_surfels_sliding=2048,
              max_surfels_fixed=2048, max_correspondences=2048, max_leaves_per_sweep=4096,
              max_imu_states=640, max_sample_states=48, inner_iter_num_max=25,
              dtype="float64", match_knn_approx=False, sliding_window_duration=0.5,
              degeneracy_remap=True, debug_residuals=True)
CFG = WildcatConfig(**CFG_KW)
SPLIT_SWEEP = 1  # checkpoints are taken once this many sweeps have run


EVENTS = list(synthetic_events(SyntheticSequence(
    duration=1.6, points_per_scan=3000, room_half=5.0, seed=2, geometry="cylinder")))


def _flatten(jax_state) -> dict:
    out = {}
    for part in ("sample", "imu", "sld", "fix"):
        obj = getattr(jax_state, part)
        for f in dataclasses.fields(obj):
            out[f"{part}.{f.name}"] = np.asarray(getattr(obj, f.name))
    out["fix_geo"] = np.asarray(jax_state.fix_geo)
    return out


def _assert_same_trajectory(a, b):
    assert len(a) == len(b) == 3
    for (t1, p1, q1), (t2, p2, q2) in zip(a, b):
        assert t1 == t2
        np.testing.assert_allclose(p1, p2, rtol=0, atol=1e-6)
        np.testing.assert_allclose(q1, q2, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX pipeline over the cylinder, recording each sweep's window state
    and feed before its dispatch, and saving a checkpoint after SPLIT_SWEEP
    sweeps."""
    lo = JaxOdometry(JaxConfig(**CFG_KW))
    record = []
    prepare = lo._prepare_feed

    def recording_prepare():
        state = _flatten(lo.state)
        prep = prepare()
        record.append((state, prep["args"]))
        return prep

    lo._prepare_feed = recording_prepare
    path = str(tmp_path_factory.mktemp("ckpt") / "jax.npz")
    split = feed_events(lo, EVENTS, until_sweep=SPLIT_SWEEP)
    jckpt.save(path, lo)
    feed_events(lo, EVENTS[split:])
    return dict(record=record, traj=lo.trajectory, stats=lo.stats, residuals=lo.residuals,
                path=path, split=split)


def test_remap_sweep_matches_jax(jax_run):
    k = 1  # the second sweep: the remap fires there
    assert jax_run["stats"][k]["deg_rot_ratio"] < CFG.degeneracy_remap_ratio
    state_np, args = jax_run["record"][k]
    nxt = jax_run["record"][k + 1][0]
    state = window_state_from_numpy(state_np, "cpu", torch.float64)
    targs = [torch.as_tensor(np.asarray(a).astype(np.int64) if np.asarray(a).dtype == np.int32
                             else np.asarray(a)) for a in args]
    new_state, out = process_sweep(state, *targs, CFG)
    got = window_state_to_numpy(new_state)
    for key in sorted(nxt):
        g, r = got[key], nxt[key]
        if r.dtype == bool or np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(g, r, err_msg=key)
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-8, err_msg=key)
    ref = jax_run["residuals"][k]
    for name, snap in (("", out["residuals"]), ("_pre", out["residuals_pre"])):
        rs, rsv, ri, riv = (v.numpy() for v in snap)
        np.testing.assert_allclose(rs[rsv], ref["surfel" + name], rtol=0, atol=1e-8)
        np.testing.assert_allclose(ri[riv], ref["imu" + name], rtol=0, atol=1e-8)
    assert len(ref["surfel"]) > 100


def test_port_resumes_a_jax_checkpoint(jax_run):
    lo = tckpt.load(jax_run["path"], device="cpu")
    assert lo.cfg == CFG and lo.sweep_id == SPLIT_SWEEP
    feed_events(lo, EVENTS[jax_run["split"]:])
    _assert_same_trajectory(lo.trajectory, jax_run["traj"])
    assert len(lo.residuals) == 3 - SPLIT_SWEEP


def test_jax_resumes_a_port_checkpoint(jax_run, tmp_path):
    split = jax_run["split"]
    lo = LidarOdometry(CFG, device="cpu")
    feed_events(lo, EVENTS[:split])
    assert lo.sweep_id == SPLIT_SWEEP
    path = str(tmp_path / "port.npz")
    tckpt.save(path, lo)
    jlo = jckpt.load(path)
    assert jlo.sweep_id == SPLIT_SWEEP
    feed_events(jlo, EVENTS[split:])
    feed_events(lo, EVENTS[split:])
    _assert_same_trajectory(jlo.trajectory, lo.trajectory)
    # and the port's uninterrupted run tracks the JAX one
    _assert_same_trajectory(lo.trajectory, jax_run["traj"])
