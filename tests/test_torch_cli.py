"""The port's CLI on the CPU: a live ``--stream`` run from a framed file and a
``--resume`` chain over a ROS bag, each against the JAX package's CLI.

The CLI builds the shipped config unless it resumes a checkpoint, whose
config wins; so both runs resume a small-config (float64, exact KNN)
checkpoint written by the library after one sweep, re-read their source
from the start and drop the events before the checkpoint (counted). The
trajectory each writes must equal, to the TUM file's 9 decimals, the
library's uninterrupted run over the same events: the resumed state is the
saved state bit for bit and the CPU path is deterministic. The JAX
package's CLI, given the same arguments and the same checkpoint, must write
the same trajectory within 1e-6 (as ``test_trajectory_matches_jax``): the
two CLIs drop the same replayed events, count ``--max-sweeps`` from the
resume point and read the same bag topics. A checkpoint from before the
window state's fix_geo cache loads with the cache rebuilt. ``--snapshot-every``
writes the same files as the JAX CLI's; ``--native`` resumes on the C++ host
feeder, and a resumed run keeps the feeder its checkpoint names. The two
CLIs take the same options.
"""

import argparse
import json

import numpy as np
import pytest
import torch

from wildcat_slam_tpu import cli as jax_cli
from wildcat_slam_tpu_torch import cli
from wildcat_slam_tpu_torch.config import WildcatConfig
from wildcat_slam_tpu_torch.io import rosbag, stream
from wildcat_slam_tpu_torch.io.trajectory import save_tum
from wildcat_slam_tpu_torch.odometry import checkpoint
from wildcat_slam_tpu_torch.odometry import factors as fmod
from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry, OutOfOrderError
from wildcat_slam_tpu_torch.ops import pcg

torch.set_num_threads(1)

CFG = WildcatConfig(max_points_per_sweep=16384, max_surfels_per_sweep=512,
                    max_surfels_sliding=2048, max_surfels_fixed=2048, max_correspondences=2048,
                    max_leaves_per_sweep=4096, max_imu_states=640, max_sample_states=48,
                    inner_iter_num_max=25, dtype="float64", match_knn_approx=False)
TOPICS = ["--imu-topic", "/alphasense/imu", "--lidar-topic", "/hesai/pandar"]


def _library_run(events, ckpt_path):
    """The uninterrupted run's trajectory; a checkpoint after its first sweep."""
    lo = LidarOdometry(CFG, device="cpu")
    n = cli.feed_events(lo, events, until_sweep=1)
    checkpoint.save(str(ckpt_path), lo)
    cli.feed_events(lo, events[n:])
    assert lo.sweep_id == 3
    return lo.trajectory


def _bag_chain(main, d, prefix):
    """--resume over the bag for one sweep with --checkpoint-out, then
    --resume of that file to the end with --traj-out."""
    assert main(["--resume", str(d / "bag.npz"), "--bag", str(d / "seq.bag"), *TOPICS,
                 "--device", "cpu", "--max-sweeps", "1",
                 "--checkpoint-out", str(d / f"{prefix}bag2.npz")]) == 0
    assert main(["--resume", str(d / f"{prefix}bag2.npz"), "--bag", str(d / "seq.bag"),
                 "--device", "cpu", "--traj-out", str(d / f"{prefix}bag.tum")]) == 0


def _assert_close_tum(a, b):
    a, b = np.loadtxt(a), np.loadtxt(b)
    assert a.shape == b.shape == (3, 8)
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    np.testing.assert_allclose(a[:, 1:], b[:, 1:], rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    with open(d / "seq.wcst", "wb") as f:
        stream.stream_synthetic(f, duration=1.6, points_per_scan=3000, seed=0, realtime=False)
    with open(d / "seq.wcst", "rb") as f:
        events = list(stream.read_stream(f))
    rosbag.write_bag(str(d / "seq.bag"), events)
    out = {}
    for name, evs in (("stream", events), ("bag", list(rosbag.read_bag(str(d / "seq.bag"))))):
        traj = _library_run(evs, d / f"{name}.npz")
        save_tum(str(d / f"{name}_ref.tum"), traj)
        out[name] = (d / f"{name}_ref.tum").read_text()
    # the JAX package's CLI on the same files and checkpoints
    assert jax_cli.main(["--resume", str(d / "stream.npz"), "--stream", str(d / "seq.wcst"),
                         "--no-warmup", "--device", "cpu",
                         "--traj-out", str(d / "jax_stream.tum")]) == 0
    _bag_chain(jax_cli.main, d, "jax_")
    return d, out


def test_cli_stream_from_a_file(sources, capsys):
    d, ref = sources
    assert cli.main(["--resume", str(d / "stream.npz"), "--stream", str(d / "seq.wcst"),
                     "--device", "cpu", "--traj-out", str(d / "stream.tum")]) == 0
    err = capsys.readouterr().err
    assert "warmup: kernels and device ready" in err
    assert "live latency (scan->pose) after the first sweep: median" in err
    assert "dropped" in err  # the events before the checkpoint
    assert (d / "stream.tum").read_text() == ref["stream"]
    _assert_close_tum(d / "stream.tum", d / "jax_stream.tum")


def test_cli_resume_chain_over_a_bag(sources, capsys):
    d, ref = sources
    capsys.readouterr()
    _bag_chain(cli.main, d, "")
    err = capsys.readouterr().err
    assert "1 sweeps in" in err and "state checkpoint ->" in err
    assert (d / "bag.tum").read_text() == ref["bag"]
    _assert_close_tum(d / "bag.tum", d / "jax_bag.tum")
    with pytest.raises(OutOfOrderError):  # --strict raises on the replayed events instead
        cli.main(["--resume", str(d / "bag.npz"), "--bag", str(d / "seq.bag"),
                  "--device", "cpu", "--strict"])
    assert np.isfinite(np.loadtxt(d / "bag.tum")).all()


def test_cli_lets_other_errors_through(sources, monkeypatch):
    """Only out-of-order messages are dropped and counted: an error from
    inside a sweep (here K1's wrapper refusing its input, as it does for a
    tensor it cannot take on the card) ends the run."""
    d, _ = sources

    def refuse(*args):
        raise ValueError("pcg_solve: refused")

    monkeypatch.setattr(pcg, "pcg_solve", refuse)
    with pytest.raises(ValueError, match="refused"):
        cli.main(["--resume", str(d / "stream.npz"), "--stream", str(d / "seq.wcst"),
                  "--no-warmup", "--device", "cpu"])


def test_checkpoint_without_fix_geo_is_migrated(sources, tmp_path):
    """A file from before the window state's fix_geo cache (one leaf fewer)
    loads with the cache recomputed, as the JAX package's load does; any
    other leaf count is refused."""
    d, _ = sources
    data = dict(np.load(d / "stream.npz", allow_pickle=False))
    meta = json.loads(str(data["__meta__"]))
    n = meta["n_leaves"]
    del data[f"leaf_{n - 1}"]
    meta["n_leaves"] = n - 1
    data["__meta__"] = json.dumps(meta)
    np.savez_compressed(tmp_path / "old.npz", **data)
    lo = checkpoint.load(str(tmp_path / "old.npz"), device="cpu")
    ref = checkpoint.load(str(d / "stream.npz"), device="cpu")
    assert torch.equal(lo.state.fix_geo, fmod.pack_geo_rows(lo.state.fix))
    torch.testing.assert_close(lo.state.fix_geo, ref.state.fix_geo, rtol=0, atol=1e-6)
    meta["n_leaves"] = n - 2
    del data[f"leaf_{n - 2}"]
    data["__meta__"] = json.dumps(meta)
    np.savez_compressed(tmp_path / "bad.npz", **data)
    with pytest.raises(ValueError, match="checkpoint format mismatch"):
        checkpoint.load(str(tmp_path / "bad.npz"), device="cpu")


def _ply(path):
    """(header lines, vertex rows, face rows) of an ASCII PLY as arrays."""
    lines = path.read_text().splitlines()
    head = lines.index("end_header")
    n_v = int(next(ln for ln in lines if ln.startswith("element vertex")).split()[2])
    rows = lines[head + 1:]
    return (lines[:head], np.array([r.split() for r in rows[:n_v]], float).reshape(-1, 6),
            np.array([r.split() for r in rows[n_v:]], int).reshape(-1, 4))


def test_cli_snapshots_match_jax(sources, tmp_path, capsys):
    """--snapshot-every 2 over the resumed bag run (sweeps 2 and 3): the same
    numbered surfel PLYs, final PLY and TUM as the JAX CLI's, the TUMs within
    1e-6; the port's run also serves the live viewer, which changes nothing."""
    d, ref = sources
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--viewer-port", "0"])):
        out = tmp_path / name
        out.mkdir()
        assert main(["--resume", str(d / "bag.npz"), "--bag", str(d / "seq.bag"), *TOPICS,
                     "--device", "cpu", "--snapshot-every", "2", "--surfels-out",
                     str(out / "S.ply"), "--traj-out", str(out / "T.tum"), *extra]) == 0
    assert "live viewer: http://localhost:" in capsys.readouterr().err
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == ["S.ply", "S_000002.ply", "T.tum"]
    assert (tmp_path / "port" / "T.tum").read_text() == ref["bag"]
    _assert_close_tum(tmp_path / "port" / "T.tum", tmp_path / "jax" / "T.tum")
    for name in ("S.ply", "S_000002.ply"):
        (hj, vj, fj), (hp, vp, fp) = _ply(tmp_path / "jax" / name), _ply(tmp_path / "port" / name)
        assert hj == hp and len(vp) > 0 and np.array_equal(fj, fp)
        np.testing.assert_allclose(vp[:, :3], vj[:, :3], rtol=0, atol=2e-4)  # 4 decimals
        np.testing.assert_allclose(vp[:, 3:], vj[:, 3:], rtol=0, atol=1)  # uint8 colours


def test_cli_native_resume_keeps_the_feeder(sources, tmp_path):
    """--native resumes a numpy-feeder checkpoint on the C++ feeder; the file
    it writes names that feeder, and resuming that file without --native
    stays on it. The trajectory stays within 2e-4 m of the numpy run's (the
    native feeder holds its points in float32)."""
    from wildcat_slam_tpu_torch.io import native

    if not native.available():
        pytest.skip("the port's native feeder does not build here (no g++)")
    d, ref = sources

    def run(resume, ckpt, *extra):
        assert cli.main(["--resume", str(resume), "--bag", str(d / "seq.bag"), "--device", "cpu",
                         "--max-sweeps", "1", "--checkpoint-out", str(ckpt),
                         "--traj-out", str(tmp_path / "n.tum"), *extra]) == 0
        return json.loads(str(np.load(ckpt)["__meta__"]))["use_native"]

    assert run(d / "bag.npz", tmp_path / "n1.npz", "--native") is True
    assert run(tmp_path / "n1.npz", tmp_path / "n2.npz") is True
    a = np.loadtxt(tmp_path / "n.tum")
    b = np.array([[float(x) for x in ln.split()] for ln in ref["bag"].splitlines()])
    assert a.shape == b.shape == (3, 8)
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    np.testing.assert_allclose(a[:, 1:4], b[:, 1:4], rtol=0, atol=2e-4)


class _Parsed(Exception):
    pass


def _options(main, monkeypatch):
    """{dest: (option strings, action, default, type, choices, nargs)} of a CLI."""
    def grab(self, args=None, namespace=None):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed) as exc:
        main([])
    return {a.dest: (tuple(a.option_strings), type(a).__name__, a.default, a.type, a.choices,
                     a.nargs) for a in exc.value.args[0]._actions}


def test_cli_takes_the_jax_clis_options(monkeypatch):
    """Every option of the JAX CLI, with its action, default, type and
    choices; only --device differs (cuda/cpu against default/cpu)."""
    jax_opts, port_opts = _options(jax_cli.main, monkeypatch), _options(cli.main, monkeypatch)
    assert sorted(port_opts) == sorted(jax_opts)
    assert port_opts.pop("device")[:2] == jax_opts.pop("device")[:2]
    assert port_opts == jax_opts
