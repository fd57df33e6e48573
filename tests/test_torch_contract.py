"""Contract of the port: neither JAX nor the JAX package inside it, in its
benchmark (benchmarks_torch/) or in chip_smoke.py, pinned float32 numerics,
and no CPU fallback in chip_smoke.py."""

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
    "wildcat_slam_tpu_torch.probe_knn_mxu", "wildcat_slam_tpu_torch.probe_spline_fit",
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
    "wildcat_slam_tpu_torch.utils.histogram", "wildcat_slam_tpu_torch.utils.profiling",
    "wildcat_slam_tpu_torch.parallel.mesh", "wildcat_slam_tpu_torch.parallel.batch",
    "wildcat_slam_tpu_torch.viz.surfel_export", "wildcat_slam_tpu_torch.viz.live",
    "wildcat_slam_tpu_torch.io.native", "wildcat_slam_tpu_torch.odometry.graph",
    "wildcat_slam_tpu_torch.ops.self_match", "wildcat_slam_tpu_torch.ops.spd",
    "wildcat_slam_tpu_torch.probe_spd", "wildcat_slam_tpu_torch.probe_factors",
    "wildcat_slam_tpu_torch.probe_extract",
    "wildcat_slam_tpu_torch.ops.imu_factor",
    "wildcat_slam_tpu_torch.ops.surfel_factor", "wildcat_slam_tpu_torch.ops.surfel_extract",
    "benchmarks_torch.bench",
]
# JAX modules the port does not carry (ROADMAP.md, "Not to port"), and the
# port's names of the kernels' modules
NOT_PORTED = {"utils/vma.py"}
KERNEL_MODULES = {"ops/pcg_pallas.py": "ops/pcg.py", "ops/knn_pallas.py": "ops/knn.py"}


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


def test_module_list_matches_jax():
    def modules(pkg):
        root = os.path.join(REPO, pkg)
        return {os.path.relpath(os.path.join(d, f), root) for d, _, files in os.walk(root)
                for f in files if f.endswith(".py") and "_build" not in d}

    jax_modules = {KERNEL_MODULES.get(m, m) for m in modules("wildcat_slam_tpu") - NOT_PORTED}
    assert jax_modules <= modules("wildcat_slam_tpu_torch"), \
        sorted(jax_modules - modules("wildcat_slam_tpu_torch"))


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


@pytest.mark.parametrize("argv", [
    ["--batch", "synthetic:1,synthetic:1", "--stream", "-"],
    ["--batch", "synthetic:1,synthetic:1", "--cloud-out", "c.ply"],
    ["--synthetic", "1", "--chunk-sweeps", "2", "--stream", "-"],
    ["--synthetic", "1", "--chunk-sweeps", "2", "--cloud-out", "c.ply"],
    ["--synthetic", "1", "--chunk-sweeps", "2", "--residual-hist"],
    ["--synthetic", "1", "--chunk-sweeps", "3", "--verbose", "--cloud-out", "c.ply"],
    ["--synthetic", "1", "--chunk-sweeps", "2", "--viewer-port", "0"],
    ["--synthetic", "1", "--chunk-sweeps", "2", "--snapshot-every", "2", "--verbose"],
])
def test_cli_refuses_incompatible_modes(argv, capsys):
    """The JAX CLI's usage errors, word for word, before any work starts."""
    from wildcat_slam_tpu import cli as jax_cli
    from wildcat_slam_tpu_torch import cli

    errors = []
    for main in (jax_cli.main, cli.main):
        with pytest.raises(SystemExit) as exc:
            main([*argv, "--device", "cpu"])
        assert exc.value.code == 2
        errors.append([ln for ln in capsys.readouterr().err.splitlines() if "error:" in ln])
    assert len(errors[1]) == 1 and "incompatible with" in errors[1][0]
    assert errors[1][0].split("error:")[1] == errors[0][0].split("error:")[1]


@pytest.mark.parametrize("kw", [dict(chunk_sweeps=0), dict(chunk_sweeps=-2),
                                dict(chunk_sweeps=2, collect_clouds=True),
                                dict(chunk_sweeps=4, debug_residuals=True)])
def test_frontend_refuses_what_jax_refuses(kw):
    from wildcat_slam_tpu.config import WildcatConfig as JaxConfig
    from wildcat_slam_tpu.odometry.pipeline import LidarOdometry as JaxOdometry
    from wildcat_slam_tpu_torch.config import WildcatConfig
    from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry

    kw = dict(kw)
    cfg_kw = dict(max_points_per_sweep=64, max_surfels_sliding=64, max_surfels_fixed=64,
                  debug_residuals=kw.pop("debug_residuals", False))
    with pytest.raises(ValueError, match="chunk_sweeps") as jax_err:
        JaxOdometry(JaxConfig(**cfg_kw), **kw)
    with pytest.raises(ValueError, match="chunk_sweeps") as err:
        LidarOdometry(WildcatConfig(**cfg_kw), device="cpu", **kw)
    assert str(err.value) == str(jax_err.value)


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
