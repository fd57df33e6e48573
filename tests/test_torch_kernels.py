"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card (marker ``gpu``) and skips without one.
The file imports neither JAX nor the JAX package, so it runs on a machine
without them:

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerances: K2 (knn_bins) rounds exactly like its plain version (no FMA,
same dimension order), so values and indices must be equal. K2 mxu
(knn_bins_mxu) takes its product as three TF32 passes on the tensor cores
where the plain version takes one f32 product: per (query, bin) the minima
must agree within MXU_FACTOR * 2^-23 * (|q| + |t|)^2 at the winning targets,
and the indices may differ only where the two winners' scores lie within
that bound of each other. K1 (pcg_solve)
sums the matvec in another order than cuBLAS, and CG amplifies that over 24
iterations: within 1e-5 of the solution's scale; two kernel runs must give
the same bits (no float atomics).
"""

import numpy as np
import pytest
import torch

from wildcat_slam_tpu_torch.config import WildcatConfig
from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence, ate_rmse
from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry
from wildcat_slam_tpu_torch.ops import knn, pcg

pytestmark = pytest.mark.gpu

MXU_FACTOR = 16.0  # chip_smoke.py MXU_FACTOR


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _cloud(rng, n, spread=5.0):
    c = rng.uniform(-spread, spread, (n, 3))
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return np.concatenate([c, nrm / 0.0873], axis=1).astype(np.float32)


def _random_system(s_cap, seed):
    rng = np.random.default_rng(seed)
    n = s_cap * 12
    a = rng.normal(size=(n, n + 24))
    return (a @ a.T / n).astype(np.float32), rng.normal(size=(n,)).astype(np.float32)


@pytest.mark.parametrize("q_n,t_n", [(300, 512), (300, 2048), (1000, 4096)])
def test_knn_bins_kernel_equals_plain(cuda_device, q_n, t_n):
    rng = np.random.default_rng(t_n)
    dt = torch.as_tensor(_cloud(rng, t_n), device=cuda_device)
    dt[t_n // 2:t_n // 2 + 100] = knn.FAR  # masked rows never win against real ones
    dq = torch.as_tensor(_cloud(rng, q_n), device=cuda_device)
    before = knn.LAUNCHES
    vk, ik = knn.knn_bins(dq, dt, 512)
    vp, ip = knn.knn_bins_plain(dq, dt, 512)
    assert knn.LAUNCHES == before + 1
    assert torch.equal(vk, vp) and torch.equal(ik, ip)


def mxu_check(dq, dt, n_bins):
    """knn_bins_mxu against knn_bins_mxu_plain on the embedding of (dq, dt).
    Returns (worst value gap in units of 2^-23 (|q| + |t|)^2, index
    mismatches, of them outside the near-tie bound)."""
    dq_aug, dtt_aug = knn.mxu_embedding(dq, dt)
    vk, ik = knn.knn_bins_mxu(dq_aug, dtt_aug, n_bins)
    vp, ip = knn.knn_bins_mxu_plain(dq_aug, dtt_aug, n_bins)
    qn = torch.linalg.norm(dq.double(), dim=1, keepdim=True)
    tn = torch.linalg.norm(dt.double(), dim=1)
    scale = torch.maximum((qn + tn[ik.long()]) ** 2, (qn + tn[ip.long()]) ** 2) * 2.0**-23
    ratio = float(torch.max((vk.double() - vp.double()).abs() / scale))
    diff = ik != ip
    # exact scores of both winners where the indices differ
    rows = torch.nonzero(diff)[:, 0]
    sk = torch.sum((dq[rows].double() - dt[ik[diff].long()].double()) ** 2, 1)
    sp = torch.sum((dq[rows].double() - dt[ip[diff].long()].double()) ** 2, 1)
    far = int(torch.sum((sk - sp).abs() > MXU_FACTOR * scale[diff]))
    return ratio, int(diff.sum()), far


@pytest.mark.parametrize("q_n,t_n", [(300, 512), (1000, 4096), (777, 3000)])
def test_knn_mxu_kernel_matches_plain(cuda_device, q_n, t_n):
    rng = np.random.default_rng(t_n)
    dt = torch.as_tensor(_cloud(rng, t_n), device=cuda_device)
    dt[t_n // 3:t_n // 3 + 200] = knn.FAR  # masked rows never win against real ones
    dq = torch.as_tensor(_cloud(rng, q_n), device=cuda_device)
    pad = (-t_n) % 512  # T not a multiple of the bins: far-padded as knn_topk does
    dt = torch.cat([dt, torch.full((pad, 6), knn.FAR, device=cuda_device)])
    before = knn.MXU_LAUNCHES
    ratio, mismatch, far = mxu_check(dq, dt, 512)
    assert knn.MXU_LAUNCHES == before + 1
    print(f"mxu q={q_n} t={t_n}: worst gap {ratio:.3f} x 2^-23 (|q|+|t|)^2, "
          f"{mismatch} index mismatches, {far} outside the near-tie bound")
    assert ratio <= MXU_FACTOR and far == 0
    kk, _ = knn.knn_topk(dq, dt[:t_n], 10, mode="mxu")
    kv, _ = knn.knn_topk(dq, dt[:t_n], 10)
    assert not bool(torch.any((kk >= t_n // 3) & (kk < t_n // 3 + 200)))  # masked never chosen
    agree = float(torch.mean((kk[:, :, None] == kv[:, None, :]).any(2).double()))
    assert agree >= 0.995, agree


@pytest.mark.parametrize("s_cap", [8, 96, 256])
def test_pcg_kernel_matches_plain(cuda_device, s_cap):
    h, g = _random_system(s_cap, seed=s_cap)
    th, tg = torch.as_tensor(h, device=cuda_device), torch.as_tensor(g, device=cuda_device)
    dlam = 1e-3 * torch.clip(torch.diagonal(th), 1e-6, 1e32)
    minv = pcg.block_diag_inverse(th, dlam, s_cap)
    before = pcg.LAUNCHES
    x1 = pcg.pcg_solve(th, dlam, minv, tg, 24, 1e-2)
    x2 = pcg.pcg_solve(th, dlam, minv, tg, 24, 1e-2)
    assert pcg.LAUNCHES == before + 2
    assert torch.equal(x1, x2)
    xp = pcg.pcg_solve_plain(th, dlam, minv, tg, 24, 1e-2)
    assert float(torch.max(torch.abs(x1 - xp))) <= 1e-5 * float(torch.max(torch.abs(xp)))
    zero = pcg.pcg_solve(th, dlam, minv, torch.zeros_like(tg), 24, 1e-2)
    assert torch.equal(zero, torch.zeros_like(tg))  # early exit before any iteration


def test_float64_pcg_refused_on_the_card(cuda_device):
    """K1 takes float32: a float64 config with linear_solver='pcg' (a JAX
    package checkpoint may carry one) is refused when the frontend is built."""
    with pytest.raises(ValueError, match="K1"):
        LidarOdometry(WildcatConfig(dtype="float64"), device=cuda_device)
    LidarOdometry(WildcatConfig(dtype="float64", linear_solver="pcg_xla"), device=cuda_device)


def test_pcg_kernel_refuses_what_it_cannot_hold(cuda_device):
    big = torch.zeros((12012, 12012), device=cuda_device)
    with pytest.raises(ValueError, match="exceeds"):
        pcg.pcg_solve(big, big[0], torch.zeros((1001, 12, 12), device=cuda_device), big[0], 4, 1e-2)
    h = torch.zeros((24, 24), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        pcg.pcg_solve(h, h[0], torch.zeros((2, 12, 12), dtype=torch.float64, device=cuda_device),
                      h[0], 4, 1e-2)


def test_small_pipeline_on_card_launches_both_kernels(cuda_device):
    cfg = WildcatConfig(max_points_per_sweep=16384, max_surfels_per_sweep=512,
                        max_surfels_sliding=2048, max_surfels_fixed=2048,
                        max_correspondences=2048, max_leaves_per_sweep=4096,
                        max_imu_states=640, max_sample_states=48, inner_iter_num_max=25)
    seq = SyntheticSequence(duration=1.6, points_per_scan=4000, room_half=4.0, seed=0)
    lo = LidarOdometry(cfg, device=cuda_device)
    pcg.LAUNCHES = knn.LAUNCHES = 0
    imu_iter = iter(seq.imu)
    pending = next(imu_iter, None)
    for ts, pl in seq.scans:
        while pending is not None and pending[0] <= ts[-1] + 0.01:
            lo.add_imu(*pending)
            pending = next(imu_iter, None)
        lo.add_scan(ts, pl)
    assert lo.sweep_id >= 3
    assert pcg.LAUNCHES > 0 and knn.LAUNCHES > 0
    assert ate_rmse(lo.trajectory, lambda t: seq.gt_pose(t)[0], align=False) < 0.02
