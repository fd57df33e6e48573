"""Contract of the port: neither JAX nor the JAX package inside it or in
chip_smoke.py, pinned float32 numerics, and no CPU fallback in chip_smoke.py."""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "wildcat_slam_tpu_torch", "wildcat_slam_tpu_torch.cli", "wildcat_slam_tpu_torch._numerics",
    "wildcat_slam_tpu_torch.config", "wildcat_slam_tpu_torch.profile_sweeps",
    "wildcat_slam_tpu_torch.io.synthetic", "wildcat_slam_tpu_torch.io.dataset",
    "wildcat_slam_tpu_torch.io.trajectory", "wildcat_slam_tpu_torch.odometry._ptbuf",
    "wildcat_slam_tpu_torch.ops.lie", "wildcat_slam_tpu_torch.ops.spline",
    "wildcat_slam_tpu_torch.ops.dfsum", "wildcat_slam_tpu_torch.ops.eigh3",
    "wildcat_slam_tpu_torch.ops.voxel", "wildcat_slam_tpu_torch.ops.knn",
    "wildcat_slam_tpu_torch.ops.pcg", "wildcat_slam_tpu_torch.ops._build",
    "wildcat_slam_tpu_torch.odometry.states", "wildcat_slam_tpu_torch.odometry.imu",
    "wildcat_slam_tpu_torch.odometry.window", "wildcat_slam_tpu_torch.odometry.surfel",
    "wildcat_slam_tpu_torch.odometry.corrections", "wildcat_slam_tpu_torch.odometry.match",
    "wildcat_slam_tpu_torch.odometry.factors", "wildcat_slam_tpu_torch.odometry.solver",
    "wildcat_slam_tpu_torch.odometry.pipeline", "wildcat_slam_tpu_torch.odometry.convert",
    "wildcat_slam_tpu_torch.odometry.checkpoint", "wildcat_slam_tpu_torch.ops.se3",
    "wildcat_slam_tpu_torch.io.stream", "wildcat_slam_tpu_torch.io.rosbag",
    "wildcat_slam_tpu_torch.utils.histogram",
]


def _python(code, cwd=REPO, env_extra=None):
    env = dict(os.environ, PYTHONPATH=REPO, **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _chip_smoke_imports():
    """chip_smoke.py's import statements, at module level or in a function."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    return [ast.unparse(node) for node in ast.walk(tree)
            if isinstance(node, (ast.Import, ast.ImportFrom))
            and getattr(node, "module", None) != "__future__"]


def test_port_imports_no_jax():
    smoke = _chip_smoke_imports()
    assert any("wildcat_slam_tpu_torch.odometry.pipeline" in ln for ln in smoke)
    code = "\n".join(["import importlib, sys",
                      f"for m in {PORT_MODULES!r}: importlib.import_module(m)", *smoke,
                      "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
                      "('jax', 'jaxlib', 'flax', 'wildcat_slam_tpu'))",
                      "print('BAD', bad)", "assert not bad, bad", ""])
    res = _python(code)
    assert res.returncode == 0, res.stdout + res.stderr


def test_numerics_pinned_by_the_frontend():
    from wildcat_slam_tpu_torch import _numerics
    from wildcat_slam_tpu_torch.config import WildcatConfig
    from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        assert not _numerics.pinned()
        LidarOdometry(WildcatConfig(max_points_per_sweep=64, max_surfels_sliding=64,
                                    max_surfels_fixed=64), device="cpu")
        assert _numerics.pinned()
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        _numerics.apply()


def _last_line(text):
    lines = [ln for ln in text.strip().splitlines() if ln.strip()]
    return lines[-1] if lines else ""


def test_chip_smoke_fails_without_a_card():
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert '"ok": true' not in _last_line(res.stdout)


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode != 0
    assert '"ok": true' not in _last_line(res.stdout)


@pytest.mark.parametrize("flag", ["--batch", "--chunk-sweeps", "--native", "--viewer-port",
                                  "--snapshot-every", "--surfels-out", "--cloud-out", "--profile"])
def test_cli_rejects_unported_modes(flag):
    from wildcat_slam_tpu_torch import cli

    value = [] if flag == "--native" else ["2"]
    with pytest.raises(NotImplementedError, match=flag):
        cli.main(["--synthetic", "1", "--device", "cpu", flag, *value])


def test_cuda_tensor_without_card_is_refused():
    """A wrapper never falls back to its plain version for a non-CPU tensor."""
    from wildcat_slam_tpu_torch.ops import knn, pcg

    meta = torch.zeros((24, 24), device="meta")
    with pytest.raises(ValueError, match="device"):
        pcg.pcg_solve(meta, meta[0], torch.zeros((2, 12, 12), device="meta"), meta[0], 4, 1e-2)
    with pytest.raises(ValueError, match="device"):
        knn.knn_bins(torch.zeros((4, 6), device="meta"), torch.zeros((512, 6), device="meta"), 512)
    with pytest.raises(ValueError, match="device"):
        knn.knn_bins_mxu(torch.zeros((4, 8), device="meta"), torch.zeros((8, 512), device="meta"),
                         512)
