"""Batched windows of the port against the JAX package, on the CPU.

One float64 JAX reference run per sequence (exact KNN, the sizes of
``__graft_entry__._tiny_cfg``, a 0.5 s sliding window so that the fixed
window fills and matches): room seed 0 over 2.1 s (4 sweeps) and seed 1
over 1.6 s (3 sweeps), so that in a batch of the two, window 1 runs out of
data first and drains on a no-op feed.

(a) The port's ``process_sweep`` on ``noop_feed()`` after the real sweeps
    matches JAX ``process_sweep`` on the same feed: every state leaf within
    1e-8 (summation order only, as ``tests/test_torch_pipeline.py``).
(b) ``BatchedOdometry(batch=2, device="cpu")``: each window's trajectory
    equals the port's single-window run of its sequence bit for bit and the
    JAX run within 1e-6 m / 1e-6 on the quaternion; the exhausted window's
    final state is within 1e-8 of the JAX state after the same no-op step.
(c) ``load_batch`` resumes the JAX package's single-window checkpoints, and
    the JAX ``checkpoint.load`` resumes each file of ``save_batch``: both
    runs on within 1e-6 of the uninterrupted JAX runs.
(d) The CLI's ``--batch`` on ``--resume``d checkpoints: per-window TUM files
    equal to the library's uninterrupted runs, per-window surfel PLYs equal
    byte for byte to the JAX package's ``save_surfels_ply`` of the same
    surfels, and ``--checkpoint-out`` files that resume.
(e) The batched step runs each window under its card's device context.

The JAX side compiles ``process_sweep`` once for the whole file: its calls
pass ``emit_cloud`` by keyword as its frontend does.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from wildcat_slam_tpu.config import WildcatConfig as JaxConfig
from wildcat_slam_tpu.odometry import checkpoint as jckpt
from wildcat_slam_tpu.odometry import pipeline as jpipe
from wildcat_slam_tpu.viz import surfel_export as jexport
from wildcat_slam_tpu_torch import cli
from wildcat_slam_tpu_torch.config import WildcatConfig
from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence
from wildcat_slam_tpu_torch.odometry import checkpoint as tckpt
from wildcat_slam_tpu_torch.odometry import graph as graph_mod
from wildcat_slam_tpu_torch.odometry import pipeline as tpipe
from wildcat_slam_tpu_torch.odometry.convert import (window_state_from_numpy,
                                                     window_state_to_numpy)
from wildcat_slam_tpu_torch.parallel import mesh as mesh_mod
from wildcat_slam_tpu_torch.parallel.batch import BatchedOdometry

torch.set_num_threads(1)

CFG_KW = dict(max_points_per_sweep=2048, max_surfels_per_sweep=128, max_surfels_sliding=256,
              max_surfels_fixed=256, max_correspondences=256, max_leaves_per_sweep=512,
              max_imu_states=256, max_sample_states=16, inner_iter_num_max=3,
              dtype="float64", match_knn_approx=False, sliding_window_duration=0.5)
CFG = WildcatConfig(**CFG_KW)
DURATIONS = (2.1, 1.6)
SPLIT_SWEEP = 2  # checkpoints are taken once this many sweeps have run
EVENTS = [list(cli.synthetic_events(SyntheticSequence(
    duration=d, points_per_scan=400, room_half=2.0, seed=seed)))
    for seed, d in enumerate(DURATIONS)]


def _flatten(jax_state) -> dict:
    out = {}
    for part in ("sample", "imu", "sld", "fix"):
        obj = getattr(jax_state, part)
        for f in dataclasses.fields(obj):
            out[f"{part}.{f.name}"] = np.asarray(getattr(obj, f.name))
    out["fix_geo"] = np.asarray(jax_state.fix_geo)
    return out


def _assert_states_close(got: dict, ref: dict):
    assert set(got) == set(ref)
    for key in sorted(ref):
        g, r = got[key], ref[key]
        if r.dtype == bool or np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(g, r, err_msg=key)
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-8, err_msg=key)


def _assert_traj_close(a, b):
    assert len(a) == len(b)
    for (t1, p1, q1), (t2, p2, q2) in zip(a, b):
        assert t1 == t2
        np.testing.assert_allclose(p1, p2, rtol=0, atol=1e-6)
        np.testing.assert_allclose(q1, q2, rtol=0, atol=1e-6)


def _torch_feed(feed):
    return [torch.as_tensor(np.asarray(a).astype(np.int64) if np.asarray(a).dtype == np.int32
                            else np.asarray(a)) for a in feed]


def _feed_batch(bo, events, starts=(0, 0)):
    for i, evs in enumerate(events):
        for ev in evs[starts[i]:]:
            (bo.add_imu if ev[0] == "imu" else bo.add_scan)(i, *ev[1:])
        bo.pump()


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Per sequence: the JAX run's trajectory, a checkpoint after SPLIT_SWEEP
    sweeps, the state before and after one no-op step at the end."""
    d = tmp_path_factory.mktemp("jax")
    runs = []
    for i, events in enumerate(EVENTS):
        lo = jpipe.LidarOdometry(JaxConfig(**CFG_KW))
        split = cli.feed_events(lo, events, until_sweep=SPLIT_SWEEP)
        jckpt.save(str(d / f"w{i}.npz"), lo)
        cli.feed_events(lo, events[split:])
        traj, stats = lo.trajectory, lo.stats
        before = _flatten(lo.state)
        feed = lo.noop_feed()
        state, _ = jpipe.process_sweep(lo.state, *feed, lo.cfg, emit_cloud=False)
        runs.append(dict(traj=traj, stats=stats, split=split, ckpt=str(d / f"w{i}.npz"),
                         before=before, feed=feed, after_noop=_flatten(state)))
    assert [len(r["traj"]) for r in runs] == [4, 3]
    assert runs[1]["stats"][-1]["n_pairs_fix"] > 0  # the fixed window took part
    return runs


@pytest.fixture(scope="module")
def singles():
    """The port's single-window run of each sequence."""
    out = []
    for events in EVENTS:
        lo = tpipe.LidarOdometry(CFG, device="cpu")
        cli.feed_events(lo, events)
        out.append(lo)
    return out


def test_noop_step_matches_jax(jax_runs):
    run = jax_runs[1]
    state = window_state_from_numpy(run["before"], "cpu", torch.float64)
    new_state, out = tpipe.process_sweep(state, *_torch_feed(run["feed"]), CFG)
    _assert_states_close(window_state_to_numpy(new_state), run["after_noop"])
    assert torch.isfinite(out["packed"]).all()


def test_noop_feed_matches_jax():
    jlo, lo = jpipe.LidarOdometry(JaxConfig(**CFG_KW)), tpipe.LidarOdometry(CFG, device="cpu")
    lo.fix_first = jlo.fix_first = False
    for a, b in zip(lo.noop_feed(), jlo.noop_feed()):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and np.array_equal(a, b) and a.dtype.kind == b.dtype.kind


def test_batch_matches_single_windows_and_jax(jax_runs, singles):
    bo = BatchedOdometry(CFG, batch=2, device="cpu")
    assert bo.mesh == [torch.device("cpu")]
    _feed_batch(bo, EVENTS)
    assert bo.finish() == 1  # window 1 drains on one no-op round
    for lo, got, run in zip(singles, bo.trajectories, jax_runs):
        assert len(got) == len(lo.trajectory) == len(run["traj"])
        diff = max(max(np.abs(p1 - p2).max(), np.abs(q1 - q2).max())
                   for (_, p1, q1), (_, p2, q2) in zip(got, lo.trajectory))
        assert diff == 0 and [t for t, _, _ in got] == [t for t, _, _ in lo.trajectory]
        _assert_traj_close(got, run["traj"])
    assert [w.sweep_id for w in bo.windows] == [4, 3]  # no sweep made up for the no-op
    assert [s["n_pairs_fix"] for s in bo.stats[1]] == [s["n_pairs_fix"] for s in singles[1].stats]
    _assert_states_close(window_state_to_numpy(bo.state[1]), jax_runs[1]["after_noop"])


def test_load_batch_resumes_jax_checkpoints(jax_runs):
    bo = tckpt.load_batch([r["ckpt"] for r in jax_runs], device="cpu")
    assert [w.sweep_id for w in bo.windows] == [SPLIT_SWEEP] * 2 and bo._initialized
    assert all(not w.dispatch for w in bo.windows)
    _feed_batch(bo, EVENTS, starts=[r["split"] for r in jax_runs])
    bo.finish()
    for got, run in zip(bo.trajectories, jax_runs):
        _assert_traj_close(got, run["traj"])


def test_jax_resumes_save_batch_files(jax_runs, tmp_path):
    bo = BatchedOdometry(CFG, batch=2, device="cpu")
    splits = [r["split"] for r in jax_runs]
    _feed_batch(bo, [ev[:n] for ev, n in zip(EVENTS, splits)])
    assert [w.sweep_id for w in bo.windows] == [SPLIT_SWEEP] * 2
    paths = tckpt.save_batch(str(tmp_path / "b.npz"), bo)
    assert paths == [str(tmp_path / "b.w0.npz"), str(tmp_path / "b.w1.npz")]
    for path, events, n, run in zip(paths, EVENTS, splits, jax_runs):
        jlo = jckpt.load(path)
        assert jlo.sweep_id == SPLIT_SWEEP
        cli.feed_events(jlo, events[n:])
        _assert_traj_close(jlo.trajectory, run["traj"])


def test_load_batch_refuses_mixed_files(jax_runs, tmp_path):
    fresh = str(tmp_path / "fresh.npz")
    tckpt.save(fresh, tpipe.LidarOdometry(CFG, device="cpu"))  # never initialized
    with pytest.raises(ValueError, match="mixed window init status"):
        tckpt.load_batch([jax_runs[0]["ckpt"], fresh], device="cpu")
    other = str(tmp_path / "other.npz")
    tckpt.save(other, tckpt.load(jax_runs[1]["ckpt"], device="cpu"))
    lo = tckpt.load(other, device="cpu")
    lo.cfg = CFG.replace(inner_iter_num_max=4)
    tckpt.save(other, lo)
    with pytest.raises(ValueError, match="configs differ"):
        tckpt.load_batch([jax_runs[0]["ckpt"], other], device="cpu")


def test_batch_size_must_divide_the_mesh():
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        BatchedOdometry(CFG, batch=3, n_devices=2, device="cpu")


@pytest.fixture(scope="module")
def cli_sources(tmp_path_factory):
    """The CLI's --batch synthetic sources, a library checkpoint of each
    after one sweep, and the library's uninterrupted trajectories as TUM."""
    from wildcat_slam_tpu_torch.io.trajectory import save_tum

    d = tmp_path_factory.mktemp("cli")
    specs = ["synthetic:1.6:room:0", "synthetic:1.6:room:1"]
    refs = []
    for i, spec in enumerate(specs):
        events = list(cli._batch_events(spec, None, None))
        lo = tpipe.LidarOdometry(CFG, device="cpu")
        n = cli.feed_events(lo, events, until_sweep=1)
        tckpt.save(str(d / f"ck.w{i}.npz"), lo)
        cli.feed_events(lo, events[n:])
        save_tum(str(d / f"ref{i}.tum"), lo.trajectory)
        refs.append((d / f"ref{i}.tum").read_text())
    return d, ",".join(specs), refs


def test_cli_batch_on_resumed_checkpoints(cli_sources, capsys):
    d, specs, refs = cli_sources
    assert cli.main(["--batch", specs, "--resume", str(d / "ck.npz"), "--device", "cpu",
                     "--traj-out", str(d / "b.tum"), "--surfels-out", str(d / "s.ply"),
                     "--checkpoint-out", str(d / "out.npz"), "--verbose"]) == 0
    err = capsys.readouterr().err
    assert "batch: 2 windows over 1 device(s) (cpu)" in err and "dropped" in err
    assert "w1 sweep 2:" in err and "batch total: 4 sweeps" in err
    for i in range(2):
        assert (d / f"b_w{i}.tum").read_text() == refs[i]
        lo = tckpt.load(str(d / f"out.w{i}.npz"), device="cpu")
        assert lo.sweep_id == 3
        jexport.save_surfels_ply(str(d / f"jax_s{i}.ply"), cli._host_surfels(lo.state.sld))
        assert (d / f"s_w{i}.ply").read_bytes() == (d / f"jax_s{i}.ply").read_bytes()
        assert (d / f"s_w{i}.ply").read_text().startswith("ply\nformat ascii 1.0\n")
    # nothing left to run: the resumed files end where they are
    assert cli.main(["--batch", specs, "--resume", str(d / "out.npz"), "--device", "cpu"]) == 0
    assert "batch total: 0 sweeps" in capsys.readouterr().err
    assert cli.main(["--batch", specs, "--resume", str(d / "nope.npz"), "--device", "cpu"]) == 2


class _NoFeed:
    """A feed buffer that moves nothing (no card here)."""
    slots = 1

    def put(self, feeds):
        pass


def test_batched_step_enters_each_windows_device(monkeypatch):
    """Each window's init runs under torch.cuda.device of its card, with its
    slice of the feed moved there, and each window frontend's sweep enters
    its own card (a stub init and sweep and a recording device context stand
    in for the cards)."""
    current, seen, puts = [None], [], []

    @contextlib.contextmanager
    def recording_device(dev):
        prev, current[0] = current[0], dev
        try:
            yield
        finally:
            current[0] = prev

    def put(arrays, dev):
        puts.append((dev, current[0], len(arrays[0])))
        return [torch.as_tensor(a) for a in arrays]

    monkeypatch.setattr(torch.cuda, "device", recording_device)
    monkeypatch.setattr(mesh_mod, "_put", put)
    monkeypatch.setattr(mesh_mod.pipe, "init_window", lambda st, *a, cfg=None: (st, current[0]))
    mesh = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert mesh_mod.window_devices(4, mesh) == [mesh[0], mesh[0], mesh[1], mesh[1]]
    states = ["s0", "s1", "s2", "s3"]
    inits = mesh_mod.make_batched_init(CFG, mesh)(states, *(np.zeros((4, 2)),) * 3)
    assert [dev for _, dev in inits] == [mesh[0], mesh[0], mesh[1], mesh[1]]
    assert puts == [(mesh[0], mesh[0], 2), (mesh[1], mesh[1], 2)]
    # a window's sweep on the card: its frontend's step under its own card
    seen_steps = []
    for dev in mesh:
        lo = tpipe.LidarOdometry(CFG, device="cpu")
        lo.device, lo._use_graph = dev, True
        monkeypatch.setattr(lo, "_step", lambda lo=lo: seen_steps.append(current[0]) or
                            dict(packed=torch.zeros(22)))
        monkeypatch.setattr(graph_mod, "FeedBuffer", lambda *a, **kw: _NoFeed())
        lo._sweep(lo.noop_feed())
    assert seen_steps == mesh and current[0] is None
