"""Chained sweeps and the map outputs of the port against the JAX package, on the CPU.

One float64 JAX reference run (exact KNN, the sizes of
``__graft_entry__._tiny_cfg``, a 0.5 s sliding window) over 2.1 s of the
room (4 sweeps), collecting its clouds, then two JAX no-op steps: the state
that ``chunk_sweeps=3`` must reach, since its second chunk holds one real
sweep padded with two no-op feeds.

(a) The port's per-sweep run: trajectory within 1e-6 m / 1e-6 on the
    quaternion of the JAX run, and each sweep's cloud within 1e-6 m of the
    JAX cloud, point for point.
(b) ``chunk_sweeps=3``: the trajectory and stats equal the per-sweep path's
    bit for bit, one device tensor holds a chunk's packed rows, and the
    final state is within 1e-8 of JAX's after the two no-op steps.
(c) The CLI on a ``--resume``d checkpoint: ``--chunk-sweeps 2`` writes the
    library's uninterrupted trajectory; ``--cloud-out`` holds as many points
    as the sweeps fed; ``--surfels-out`` is byte-equal to the JAX package's
    ``save_surfels_ply`` of the same surfels; ``--profile`` writes a trace.

The JAX side compiles ``process_sweep`` once (``emit_cloud=True``, passed by
keyword as its frontend passes it).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from wildcat_slam_tpu.config import WildcatConfig as JaxConfig
from wildcat_slam_tpu.odometry import pipeline as jpipe
from wildcat_slam_tpu.viz import surfel_export as jexport
from wildcat_slam_tpu_torch import cli
from wildcat_slam_tpu_torch.config import WildcatConfig
from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence
from wildcat_slam_tpu_torch.io.trajectory import save_tum
from wildcat_slam_tpu_torch.odometry import checkpoint as tckpt
from wildcat_slam_tpu_torch.odometry import pipeline as tpipe
from wildcat_slam_tpu_torch.odometry.convert import window_state_to_numpy

torch.set_num_threads(1)

CFG_KW = dict(max_points_per_sweep=2048, max_surfels_per_sweep=128, max_surfels_sliding=256,
              max_surfels_fixed=256, max_correspondences=256, max_leaves_per_sweep=512,
              max_imu_states=256, max_sample_states=16, inner_iter_num_max=3,
              dtype="float64", match_knn_approx=False, sliding_window_duration=0.5)
CFG = WildcatConfig(**CFG_KW)
EVENTS = list(cli.synthetic_events(SyntheticSequence(duration=2.1, points_per_scan=400,
                                                     room_half=2.0, seed=0)))
N_NOOP = 2  # 4 sweeps in chunks of 3: the second chunk is one sweep and two no-op feeds


def _flatten(jax_state) -> dict:
    out = {}
    for part in ("sample", "imu", "sld", "fix"):
        obj = getattr(jax_state, part)
        for f in dataclasses.fields(obj):
            out[f"{part}.{f.name}"] = np.asarray(getattr(obj, f.name))
    out["fix_geo"] = np.asarray(jax_state.fix_geo)
    return out


@pytest.fixture(scope="module")
def jax_run():
    lo = jpipe.LidarOdometry(JaxConfig(**CFG_KW), collect_clouds=True)
    cli.feed_events(lo, EVENTS)
    traj, stats = lo.trajectory, lo.stats
    state = lo.state
    for _ in range(N_NOOP):
        state, _ = jpipe.process_sweep(state, *lo.noop_feed(), lo.cfg, emit_cloud=True)
    assert len(traj) == 4 and stats[-1]["n_pairs_fix"] > 0
    return dict(traj=traj, clouds=lo.clouds, after_noop=_flatten(state))


@pytest.fixture(scope="module")
def per_sweep():
    lo = tpipe.LidarOdometry(CFG, device="cpu", collect_clouds=True)
    cli.feed_events(lo, EVENTS)
    return lo


def test_per_sweep_run_and_clouds_match_jax(jax_run, per_sweep):
    assert len(per_sweep.trajectory) == len(jax_run["traj"]) == 4
    for (t1, p1, q1), (t2, p2, q2) in zip(per_sweep.trajectory, jax_run["traj"]):
        assert t1 == t2
        np.testing.assert_allclose(p1, p2, rtol=0, atol=1e-6)
        np.testing.assert_allclose(q1, q2, rtol=0, atol=1e-6)
    assert len(per_sweep.clouds) == 4
    for got, ref, st in zip(per_sweep.clouds, jax_run["clouds"], per_sweep.stats):
        assert got.shape == ref.shape == (st["n_points_fed"], 3)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_chained_matches_per_sweep_and_jax(jax_run, per_sweep):
    lo = tpipe.LidarOdometry(CFG, device="cpu", chunk_sweeps=3)
    n = cli.feed_events(lo, EVENTS, until_sweep=3)
    assert lo.sweep_id == 3 and len(lo._feed_queue) == 0
    # one host copy holds the chunk's rows until the host reads them
    assert len({id(p[1]) for p in lo._pending}) == 1 and lo._pending[0][1].host.shape == (3, 22)
    cli.feed_events(lo, EVENTS[n:])
    assert lo.sweep_id == 3 and len(lo._feed_queue) == 1  # the fourth sweep is staged
    traj = lo.trajectory  # runs the padded tail chunk
    assert lo.sweep_id == 4 and len(traj) == 4 and len(lo.sweep_seconds) == 4
    assert lo.timing["sweeps"] == 4
    for (t1, p1, q1), (t2, p2, q2) in zip(traj, per_sweep.trajectory):
        assert t1 == t2 and np.array_equal(p1, p2) and np.array_equal(q1, q2)
    for a, b in zip(lo.stats, per_sweep.stats):
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[k], b[k]) for k in a)
    got, ref = window_state_to_numpy(lo.state), jax_run["after_noop"]
    for key in sorted(ref):
        if ref[key].dtype == bool or np.issubdtype(ref[key].dtype, np.integer):
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
        else:
            np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=1e-8, err_msg=key)


@pytest.fixture(scope="module")
def cli_sources(tmp_path_factory):
    """A library checkpoint after one sweep of the CLI's --synthetic 2.1
    source, the library's uninterrupted trajectory as TUM, and the resumed
    library run with its clouds."""
    d = tmp_path_factory.mktemp("cli")
    events = list(cli.synthetic_events(SyntheticSequence(duration=2.1, points_per_scan=6000,
                                                         room_half=5.0)))
    lo = tpipe.LidarOdometry(CFG, device="cpu")
    n = cli.feed_events(lo, events, until_sweep=1)
    tckpt.save(str(d / "ck.npz"), lo)
    cli.feed_events(lo, events[n:])
    save_tum(str(d / "ref.tum"), lo.trajectory)
    resumed = tckpt.load(str(d / "ck.npz"), device="cpu", collect_clouds=True)
    cli.feed_events(resumed, events[n:])
    assert resumed.sweep_id == 4
    return d, (d / "ref.tum").read_text(), resumed


def test_cli_chunk_sweeps_on_a_resumed_checkpoint(cli_sources, capsys):
    d, ref, _ = cli_sources
    assert cli.main(["--resume", str(d / "ck.npz"), "--synthetic", "2.1", "--device", "cpu",
                     "--chunk-sweeps", "2", "--traj-out", str(d / "chained.tum"),
                     "--checkpoint-out", str(d / "chained.npz")]) == 0
    assert "3 sweeps in" in capsys.readouterr().err
    assert (d / "chained.tum").read_text() == ref
    assert tckpt.load(str(d / "chained.npz"), device="cpu").sweep_id == 4


def test_cli_map_outputs_and_profile(cli_sources, capsys):
    d, ref, resumed = cli_sources
    assert cli.main(["--resume", str(d / "ck.npz"), "--synthetic", "2.1", "--device", "cpu",
                     "--cloud-out", str(d / "cloud.ply"), "--surfels-out", str(d / "s.ply"),
                     "--profile", str(d / "prof"), "--traj-out", str(d / "out.tum")]) == 0
    err = capsys.readouterr().err
    assert (d / "out.tum").read_text() == ref
    # the cloud: every valid point of the three sweeps of this run
    n_points = sum(s["n_points_fed"] for s in resumed.stats[-3:])
    assert n_points == sum(len(c) for c in resumed.clouds) > 0
    assert f"cloud ({n_points} points)" in err
    text = (d / "cloud.ply").read_text().splitlines()
    head = text.index("end_header")
    assert text[:3] == ["ply", "format ascii 1.0", f"element vertex {n_points}"]
    cloud = np.loadtxt(text[head + 1:])
    np.testing.assert_allclose(cloud, np.concatenate(resumed.clouds), rtol=0, atol=6e-5)
    jexport.save_surfels_ply(str(d / "jax_s.ply"), cli._host_surfels(resumed.state.sld))
    assert (d / "s.ply").read_bytes() == (d / "jax_s.ply").read_bytes()
    with open(d / "prof" / "trace.json") as f:
        assert len(json.load(f)["traceEvents"]) > 0


def test_stage_timer_counts_and_reports():
    from wildcat_slam_tpu_torch.utils.profiling import StageTimer

    timer = StageTimer()
    for name in ("scan", "imu", "scan"):
        with timer.stage(name, block_on=torch.zeros(1)):  # a CPU tensor waits for nothing
            pass
    assert dict(timer.counts) == {"scan": 2, "imu": 1}
    report = timer.report().splitlines()
    assert len(report) == 2 and all("total" in ln and "mean" in ln for ln in report)
