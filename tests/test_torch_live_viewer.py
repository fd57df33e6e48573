"""The port's live viewer (``wildcat_slam_tpu_torch/viz/live.py``): the twin
of ``tests/test_live_viewer.py`` (server round trip and state encoding),
then the viewer fed by ``cli.publish`` from a CPU run of the port: the pose
and the surfel ellipsoids of the window's surfels copied to the host."""

import json
import urllib.request

import numpy as np
import torch

from wildcat_slam_tpu_torch import cli
from wildcat_slam_tpu_torch.config import WildcatConfig
from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence
from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry
from wildcat_slam_tpu_torch.viz.live import LiveViewer
from wildcat_slam_tpu_torch.viz.surfel_export import surfel_ellipsoids

torch.set_num_threads(1)


def _get(v, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{v.port}{path}", timeout=5).read()


def test_viewer_serves_page_and_state():
    v = LiveViewer(port=0)  # free port
    try:
        page = _get(v, "/")
        assert b"wildcat-slam-tpu live" in page
        assert b"cdn" not in page.lower()  # self-contained: works with no network

        v.update(3, 1.5, np.array([1.0, 2.0, 3.0]))
        st = json.loads(_get(v, "/state"))
        assert st["sweep"] == 3 and st["pose"] == [1.0, 2.0, 3.0]
        assert st["traj"] == [[1.0, 2.0, 3.0]]

        surf = dict(center=np.array([[0.0, 0.0, 1.0]]), radii=np.array([[0.01, 0.2, 0.3]]),
                    axes=np.eye(3)[None], rgb=np.array([[0.5, 0.5, 1.0]]),
                    timestamp=np.array([1.0]))
        v.update(4, 2.0, np.array([1.0, 2.5, 3.0]), surf)
        st = json.loads(_get(v, "/state"))
        s = st["surfels"]
        assert len(s["c"]) == 1
        # a1 = largest 3-sigma axis (z * 0.3), a2 = middle (y * 0.2)
        np.testing.assert_allclose(s["a1"][0], [0.0, 0.0, 0.3], atol=1e-6)
        np.testing.assert_allclose(s["a2"][0], [0.0, 0.2, 0.0], atol=1e-6)
        assert len(st["traj"]) == 2
    finally:
        v.close()


def test_viewer_fed_from_a_run():
    cfg = WildcatConfig(max_points_per_sweep=16384, max_surfels_per_sweep=512,
                        max_surfels_sliding=2048, max_surfels_fixed=2048,
                        max_correspondences=2048, max_leaves_per_sweep=4096,
                        max_imu_states=640, max_sample_states=48, inner_iter_num_max=15)
    lo = LidarOdometry(cfg, device="cpu")
    seq = SyntheticSequence(duration=0.9, points_per_scan=2000, room_half=4.0, seed=0)
    cli.feed_events(lo, cli.synthetic_events(seq), until_sweep=1)
    v = LiveViewer(port=0)
    try:
        cli.publish(v, lo, surfels_every=1)
        st = json.loads(_get(v, "/state"))
    finally:
        v.close()
    t, pos, _ = lo.trajectory[-1]
    assert st["sweep"] == lo.sweep_id == 1 and st["t"] == t
    np.testing.assert_allclose(st["pose"], pos, atol=1e-4)  # the viewer rounds to 0.1 mm
    ell = surfel_ellipsoids(cli._host_surfels(lo.state.sld))
    assert len(st["surfels"]["c"]) == min(len(ell["center"]), 2000) > 0
