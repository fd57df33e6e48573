"""The port's surfel extraction against the JAX package's ``extract_surfels``.

Surfel sets (validity, order) and dropped counts must be equal; geometry
within 1e-10 in float64, and in float32 within 1e-5 (centers, times,
normals), 1e-7 (covariances) and 5e-6 (std = sqrt(lambda_min), which
amplifies the covariance rounding), where the two sides round the in-block
prefix sums in another order.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from wildcat_slam_tpu.config import WildcatConfig as JaxConfig
from wildcat_slam_tpu.odometry.surfel import extract_surfels as j_extract
from wildcat_slam_tpu_torch.config import WildcatConfig
from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence
from wildcat_slam_tpu_torch.odometry.surfel import extract_surfels as t_extract

torch.set_num_threads(1)

CFGS = {
    "small": dict(max_points_per_sweep=4096, max_surfels_per_sweep=256,
                  max_voxels_per_sweep=1024, max_leaves_per_sweep=2048),
    # capacities below the data: segment, cluster and surfel drops all fire
    "tight": dict(max_points_per_sweep=4096, max_surfels_per_sweep=16,
                  max_voxels_per_sweep=48, max_leaves_per_sweep=64),
}


@pytest.fixture(scope="module")
def sweep():
    seq = SyntheticSequence(duration=0.5, points_per_scan=800, room_half=4.0, seed=3)
    t = np.concatenate([s[0] for s in seq.scans])
    p = np.concatenate([s[1] for s in seq.scans])
    n = min(len(t), 3800)
    pts = np.zeros((4096, 3))
    ts = np.zeros(4096)
    pts[:n], ts[:n] = p[:n], t[:n] - t[0]
    return pts, ts, np.arange(4096) < n


@pytest.mark.parametrize("dt", ["float64", "float32"])
@pytest.mark.parametrize("cfg_name", list(CFGS))
def test_extract_surfels_matches_jax(sweep, cfg_name, dt):
    cfg = WildcatConfig(**CFGS[cfg_name])
    npd = np.float64 if dt == "float64" else np.float32
    pts, ts, valid = (sweep[0].astype(npd), sweep[1].astype(npd), sweep[2])
    ref = j_extract(jnp.asarray(pts), jnp.asarray(ts), jnp.asarray(valid),
                    JaxConfig(**CFGS[cfg_name]))
    got = t_extract(torch.as_tensor(pts), torch.as_tensor(ts), torch.as_tensor(valid), cfg)
    rv = np.asarray(ref["valid"])
    assert rv.sum() >= (10 if cfg_name == "small" else 1)
    np.testing.assert_array_equal(got["valid"].numpy(), rv)
    assert int(got["n_dropped"]) == int(ref["n_dropped"])
    if cfg_name == "tight":
        assert int(ref["n_dropped"]) > 0
    for key in ("t", "center", "norm", "cov", "std", "resolution"):
        g = got[key].numpy()[rv].astype(np.float64)
        r = np.asarray(ref[key])[rv].astype(np.float64)
        if dt == "float64":
            atol = 1e-10
        else:
            atol = {"cov": 1e-7, "std": 5e-6}.get(key, 1e-5)
        np.testing.assert_allclose(g, r, rtol=0, atol=atol, err_msg=key)
