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
the same bits (no float atomics). K3 (self_match) computes integers: its
partners and rounds equal its plain version's bit for bit. K4 (spd_solve)
factors in another order than cuSOLVER: its backward error |a x - b| /
(|a| |x| + |b|) is at most 10 N eps of the dtype and its forward gap to the
plain solve at most 100 kappa_2(a) eps (``spd.accuracy``), two runs and a
graph replay give the same bits. K5 (imu_factor) and K6 (surfel_factor) sum
in another order than their plain versions' einsums and products: every
output within ``chip_smoke.FACTOR_RTOL`` (1e-4 in float32, 1e-10 in float64)
of the plain version's largest entry, H and the IMU bands symmetric bit for
bit, two runs and a graph replay give the same bits. K7 (surfel_extract)
sums the moments in its plain version's order (the blocked prefix of
``ops/dfsum.py``), and is held to the plain version in the same dtype
(``chip_smoke.check_k7``): the surfels' validity and n_dropped equal, their
order and floats within 1e-10 in float64 and within
tests/test_torch_surfel.py's tolerances in float32, their t, centers and
covariances bit-equal; two runs and a graph replay give the same bits.
"""

import importlib.util
import pathlib


import numpy as np
import pytest
import torch

from wildcat_slam_tpu_torch.config import WildcatConfig
from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence, ate_rmse
from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry
from wildcat_slam_tpu_torch.ops import imu_factor, knn, pcg, spd, surfel_extract, surfel_factor
from wildcat_slam_tpu_torch.ops import self_match as sm

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


@pytest.mark.parametrize("q_n,t_n", [(300, 512), (300, 2048), (1000, 4096), (8201, 16384)])
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


@pytest.mark.parametrize("q_n,t_n,d,n_bins", [(1001, 512, 6, 512), (17, 128, 6, 128),
                                               (3001, 4096, 3, 512), (3001, 4096, 8, 512),
                                               (777, 1536, 6, 384), (1, 1024, 6, 512)])
def test_knn_bins_kernel_edges(cuda_device, q_n, t_n, d, n_bins):
    """The edges of the kernel's geometry: a ragged last query block (Q not a
    multiple of its queries per thread), one target group (T = n_bins), bins
    not a multiple of its block, and D = 3 and 8."""
    rng = np.random.default_rng(q_n + t_n + d)
    dt = torch.as_tensor(rng.normal(size=(t_n, d)).astype(np.float32), device=cuda_device)
    dq = torch.as_tensor(rng.normal(size=(q_n, d)).astype(np.float32), device=cuda_device)
    before = knn.LAUNCHES
    vk, ik = knn.knn_bins(dq, dt, n_bins)
    vp, ip = knn.knn_bins_plain(dq, dt, n_bins)
    assert knn.LAUNCHES == before + 1
    assert torch.equal(vk, vp) and torch.equal(ik, ip)


def test_knn_bins_kernel_refuses_a_launch_it_was_not_built_for(cuda_device):
    """The C entry checks the launch it is given: a (D, queries a thread) pair
    it was not compiled for, or a grid that leaves queries or bins uncovered."""
    from wildcat_slam_tpu_torch.ops import _build

    dq = torch.zeros((100, 6), device=cuda_device)
    dtt = torch.zeros((6, 512), device=cuda_device)
    vals = torch.empty((100, 512), device=cuda_device)
    idx = torch.empty((100, 512), dtype=torch.int32, device=cuda_device)
    lib = _build.library()
    stream = torch.cuda.current_stream(cuda_device).cuda_stream

    def launch(*grid):
        return lib.wc_knn_bins(dq.data_ptr(), dtt.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                               100, 512, 6, 512, *grid, stream)

    assert launch(*knn.bins_grid(100, 512, 6)) == 0
    assert launch(4, 13, 128, 8) != 0   # D=6 is built for 16 queries a thread
    assert launch(4, 6, 128, 16) != 0   # 96 of 100 queries covered
    assert launch(3, 7, 128, 16) != 0   # 384 of 512 bins covered
    assert launch(2, 7, 256, 16) != 0   # more threads than the launch bounds
    torch.cuda.synchronize()


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


# chip_smoke.py MXU_EDGES
@pytest.mark.parametrize("q_n,t_n,n_bins", [(8201, 16384, 512), (1001, 512, 512),
                                            (3001, 4096, 128), (3001, 4096, 256),
                                            (3001, 3840, 384)])
def test_knn_mxu_kernel_edges(cuda_device, q_n, t_n, n_bins):
    """The edges of the mxu kernel's geometry: a ragged last query tile (Q
    not a multiple of 128), one target group (T = n_bins), and the bin counts
    knn_topk gives a small T (128, 256 and 384: two, four and six 64-bin
    tiles)."""
    rng = np.random.default_rng(q_n + t_n + n_bins)
    dt = torch.as_tensor(rng.normal(size=(t_n, 6)).astype(np.float32), device=cuda_device)
    dq = torch.as_tensor(rng.normal(size=(q_n, 6)).astype(np.float32), device=cuda_device)
    dt[t_n // 3:t_n // 3 + 7] = knn.FAR  # far rows never win a bin
    before = knn.MXU_LAUNCHES
    ratio, mismatch, far = mxu_check(dq, dt, n_bins)
    assert knn.MXU_LAUNCHES == before + 1
    assert ratio <= MXU_FACTOR and far == 0, (ratio, mismatch, far)


def test_knn_mxu_kernel_refuses_a_launch_it_was_not_built_for(cuda_device):
    """The C entry checks the launch it is given against the kernel's
    constants: bin tile, stages, shared memory and the padded bin count."""
    from wildcat_slam_tpu_torch.ops import _build

    q, t, nb = 300, 1000, 200  # 5 groups of 200 bins; 256 padded bins
    plan = knn.mxu_plan(q, nb)
    dq = torch.zeros((q, 8), device=cuda_device)
    dtt = torch.zeros((8, t), device=cuda_device)
    staged = torch.empty((t // nb) * plan.padded_bins * 16, device=cuda_device)
    vals = torch.empty((q, nb), device=cuda_device)
    idx = torch.empty((q, nb), dtype=torch.int32, device=cuda_device)
    lib = _build.library()
    stream = torch.cuda.current_stream(cuda_device).cuda_stream

    def launch(*p):
        return lib.wc_knn_mxu(dq.data_ptr(), dtt.data_ptr(), staged.data_ptr(), vals.data_ptr(),
                              idx.data_ptr(), q, t, nb, *p, stream)

    assert launch(*plan) == 0
    assert launch(plan.grid, 128, *plan[2:]) != 0  # built for 64-bin tiles
    assert launch(plan.grid, 64, 2 * plan.stages, *plan[3:]) != 0  # built for plan.stages
    assert launch(*plan[:3], plan.smem_bytes // 2, plan.padded_bins) != 0
    assert launch(*plan[:4], 192) != 0  # 192 padded bins leave bins 192-199 out
    assert launch(0, *plan[1:]) != 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("s_cap,reference", [(8, "f64"), (96, "f32"), (192, "f32"),
                                             (256, "f32")])
def test_pcg_kernel_matches_plain(cuda_device, s_cap, reference):
    """Within 1e-5 of the plain solution's scale. At S=8 the system is
    ill-conditioned enough that 24 iterations amplify the plain f32 solve's
    own rounding: there the reference is the plain solve in float64 on the
    same inputs, and the kernel must sit no farther from it than the plain
    f32 solve does."""
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
    if reference == "f64":
        xr = pcg.pcg_solve_plain(th.double(), dlam.double(), minv.double(), tg.double(), 24, 1e-2)
        assert float(torch.max(torch.abs(x1.double() - xr))) <= float(
            torch.max(torch.abs(xp.double() - xr)))
    else:
        xr = xp
    assert float(torch.max(torch.abs(x1.to(xr.dtype) - xr))) <= 1e-5 * float(
        torch.max(torch.abs(xr)))
    zero = pcg.pcg_solve(th, dlam, minv, torch.zeros_like(tg), 24, 1e-2)
    assert torch.equal(zero, torch.zeros_like(tg))  # early exit before any iteration


@pytest.mark.parametrize("s_cap,shift,iters", [(96, 0.0, 0), (96, 0.5, 24), (1, 0.0, 24),
                                               (1000, 0.0, 3)])
def test_pcg_kernel_edges(cuda_device, s_cap, shift, iters):
    """No iteration (x stays 0), a system that exits early (H + 0.5 I: 8 of
    24 iterations), one block-row, and S = 1000, where no block-row fits a
    block's shared memory and every block streams its rows from L2."""
    h, g = _random_system(s_cap, seed=s_cap)
    th = torch.as_tensor(h + np.float32(shift) * np.eye(12 * s_cap, dtype=np.float32),
                         device=cuda_device)
    tg = torch.as_tensor(g, device=cuda_device)
    dlam = 1e-3 * torch.clip(torch.diagonal(th), 1e-6, 1e32)
    minv = pcg.block_diag_inverse(th, dlam, s_cap)
    x1 = pcg.pcg_solve(th, dlam, minv, tg, iters, 1e-2)
    x2 = pcg.pcg_solve(th, dlam, minv, tg, iters, 1e-2)
    xp = pcg.pcg_solve_plain(th, dlam, minv, tg, iters, 1e-2)
    assert torch.equal(x1, x2)
    if iters == 0:
        assert torch.equal(x1, torch.zeros_like(tg)) and torch.equal(xp, x1)
    else:
        assert float(torch.max(torch.abs(x1 - xp))) <= 1e-5 * float(torch.max(torch.abs(xp)))


def test_float64_pcg_refused_on_the_card(cuda_device):
    """K1 takes float32: a float64 config with linear_solver='pcg' (a JAX
    package checkpoint may carry one) is refused when the frontend is built."""
    with pytest.raises(ValueError, match="K1"):
        LidarOdometry(WildcatConfig(dtype="float64"), device=cuda_device)
    LidarOdometry(WildcatConfig(dtype="float64", linear_solver="pcg_xla"), device=cuda_device)


def test_cholesky_refused_on_the_card(cuda_device):
    """linear_solver='cholesky' runs on kernel K4, which allocates nothing, so
    the sweep graph holds it in float32 and float64: the card takes both
    (float64 with linear_solver='pcg' stays refused, K1 being float32)."""
    for dtype in ("float32", "float64"):
        LidarOdometry(WildcatConfig(linear_solver="cholesky", dtype=dtype), device=cuda_device)
        LidarOdometry(WildcatConfig(linear_solver="cholesky", dtype=dtype), device="cpu")
    with pytest.raises(ValueError, match="K1"):
        LidarOdometry(WildcatConfig(dtype="float64"), device=cuda_device)


@pytest.mark.parametrize("linear_solver,dtype", [("pcg", "float32"), ("cholesky", "float32"),
                                                 ("cholesky", "float64")],
                         ids=["pcg", "cholesky", "cholesky-float64"])
def test_small_graph_run_equals_eager(cuda_device, linear_solver, dtype):
    """A small config's run on the sweep graph equals its eager run on the
    card (the same frontend with the graph off) bit for bit."""
    from wildcat_slam_tpu_torch.cli import feed_events, synthetic_events

    cfg = WildcatConfig(max_points_per_sweep=16384, max_surfels_per_sweep=512,
                        max_surfels_sliding=2048, max_surfels_fixed=2048,
                        max_correspondences=2048, max_leaves_per_sweep=4096,
                        max_imu_states=640, max_sample_states=48, inner_iter_num_max=25,
                        linear_solver=linear_solver, dtype=dtype)
    events = list(synthetic_events(SyntheticSequence(duration=2.1, points_per_scan=4000,
                                                     room_half=4.0, seed=0)))
    runs = []
    for graph in (True, False):
        lo = LidarOdometry(cfg, device=cuda_device)
        lo._use_graph = graph
        feed_events(lo, events)
        runs.append(lo)
    assert runs[0]._graph is not None and runs[1]._graph is None
    got, ref = runs[0].trajectory, runs[1].trajectory
    assert len(got) == len(ref) >= 3
    assert all(t1 == t2 and np.array_equal(p1, p2) and np.array_equal(q1, q2)
               for (t1, p1, q1), (t2, p2, q2) in zip(got, ref))


def test_pcg_kernel_refuses_what_it_cannot_hold(cuda_device):
    big = torch.zeros((1, 1), device=cuda_device).expand(12012, 12012)  # refused before any read
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
    pcg.LAUNCHES = knn.LAUNCHES = imu_factor.LAUNCHES = surfel_factor.LAUNCHES = 0
    imu_iter = iter(seq.imu)
    pending = next(imu_iter, None)
    for ts, pl in seq.scans:
        while pending is not None and pending[0] <= ts[-1] + 0.01:
            lo.add_imu(*pending)
            pending = next(imu_iter, None)
        lo.add_scan(ts, pl)
    assert lo.sweep_id >= 3
    assert pcg.LAUNCHES > 0 and knn.LAUNCHES > 0
    assert imu_factor.LAUNCHES > 0 and surfel_factor.LAUNCHES > 0
    assert ate_rmse(lo.trajectory, lambda t: seq.gt_pose(t)[0], align=False) < 0.02


def test_wrappers_enter_the_tensors_card(cuda_device, monkeypatch):
    """Each wrapper makes its tensors' card current around the C entry, which
    launches on the current card (a window on another card than the current
    one would otherwise launch on the wrong one)."""
    entered = []
    real = torch.cuda.device

    class Recording(real):
        def __enter__(self):
            entered.append(self.idx)
            return super().__enter__()

    monkeypatch.setattr(torch.cuda, "device", Recording)
    h_np, b_np = _random_system(8, 8)
    h, b = torch.as_tensor(h_np, device=cuda_device), torch.as_tensor(b_np, device=cuda_device)
    dlam = 1e-3 * torch.diagonal(h)
    pcg.pcg_solve(h, dlam, pcg.block_diag_inverse(h, dlam, 8), b, 4, 1e-2)
    rng = np.random.default_rng(0)
    dq = torch.as_tensor(_cloud(rng, 300), device=cuda_device)
    dt = torch.as_tensor(_cloud(rng, 1024), device=cuda_device)
    knn.knn_bins(dq, dt, 512)
    knn.knn_bins_mxu(*knn.mxu_embedding(dq, dt), 512)
    cs = _chip_smoke()
    sfac, ifac, cor, grav, _, _ = cs.factor_problem(cuda_device, torch.float32, m=300, nb=100,
                                                    mi=50, s_cap=8)
    imu_factor.residuals(ifac, cor, cs.FACTOR_WEIGHTS, cs.FACTOR_DT, grav)
    surfel_factor.residuals(sfac, cor)
    assert entered == [cuda_device.index] * 5  # before synchronize, which enters one too
    torch.cuda.synchronize()


def test_small_batch_and_chain_on_card(cuda_device):
    """Batched windows and chained sweeps on the card: each window and the
    chained run give the single-window trajectory bit for bit."""
    from wildcat_slam_tpu_torch.cli import feed_events, synthetic_events
    from wildcat_slam_tpu_torch.parallel.batch import BatchedOdometry

    cfg = WildcatConfig(max_points_per_sweep=16384, max_surfels_per_sweep=512,
                        max_surfels_sliding=2048, max_surfels_fixed=2048,
                        max_correspondences=2048, max_leaves_per_sweep=4096,
                        max_imu_states=640, max_sample_states=48, inner_iter_num_max=25)
    events = [list(synthetic_events(SyntheticSequence(duration=d, points_per_scan=4000,
                                                      room_half=4.0, seed=s)))
              for s, d in ((0, 2.1), (1, 1.6))]
    singles = []
    for ev in events:
        lo = LidarOdometry(cfg, device=cuda_device)
        feed_events(lo, ev)
        singles.append(lo.trajectory)
    bo = BatchedOdometry(cfg, batch=2, device=cuda_device)
    assert bo.mesh == [torch.device("cuda", 0)]
    for i, ev in enumerate(events):
        for e in ev:
            (bo.add_imu if e[0] == "imu" else bo.add_scan)(i, *e[1:])
    bo.finish()
    chained = LidarOdometry(cfg, device=cuda_device, chunk_sweeps=3)
    feed_events(chained, events[0])
    for got, ref in zip(bo.trajectories + [chained.trajectory], singles + singles[:1]):
        assert len(got) == len(ref) >= 3
        assert all(t1 == t2 and np.array_equal(p1, p2) and np.array_equal(q1, q2)
                   for (t1, p1, q1), (t2, p2, q2) in zip(got, ref))


def _k3_inputs(case, dev):
    """K3's inputs: random candidates, or candidates with chains written in
    (a chain's queries each depend on the one before, so the fixed point
    takes as many rounds as the longest chain is long; chip_smoke.k3_chains)."""
    rng = np.random.default_rng(11)
    q, k, p_ok, lengths = {"random": (8192, 10, 0.5, ()), "chains": (8192, 10, 0.3, [30] * 40),
                           "long chain": (8192, 10, 0.3, [2000, 500]),
                           "ragged": (1001, 7, 0.6, [100])}[case]
    cand = rng.integers(0, q, size=(q, k))
    ok = rng.random((q, k)) < p_ok
    start = 0
    for n in lengths:
        for j in range(n):
            a = start + j
            row = [a + 1] if j == 0 else [a - 1, a + 1]
            cand[a, :len(row)] = row
            ok[a, :len(row)] = True
            ok[a, len(row):] = False
        start += n + 1
    return torch.as_tensor(cand, device=dev), torch.as_tensor(ok, device=dev)


@pytest.mark.parametrize("case,cap", [("random", None), ("chains", None), ("long chain", None),
                                      ("long chain", 5), ("ragged", None)])
def test_self_match_kernel_equals_plain(cuda_device, case, cap):
    cand, ok = _k3_inputs(case, cuda_device)
    cap = cap or cand.shape[0]
    partner, rounds = sm.self_match(cand, ok, cap)
    ref, ref_rounds = sm.self_match_plain(cand, ok, cap)
    assert torch.equal(partner, ref) and int(rounds) == int(ref_rounds)
    if case == "long chain":  # the chain sets the rounds, unless the cap stops them first
        assert int(rounds) == (5 if cap == 5 else 2001)


@pytest.mark.parametrize("q,k", [(1, 1), (1, 10), (1000, 1), (1000, 10), (8192, 1), (8192, 10),
                                 (35000, 1), (35000, 10)])
def test_self_match_kernel_at_plan_edges(cuda_device, q, k):
    """K3 at its plan's edges (Q=35000, k=10: the lists in a global scratch)
    on random candidates and on chip_smoke's adversarial chains."""
    rng = np.random.default_rng(q + k)
    cases = [(torch.as_tensor(rng.integers(0, q, size=(q, k)), device=cuda_device),
              torch.as_tensor(rng.random((q, k)) < 0.5, device=cuda_device))]
    if k > 1 and q > 1:
        cases.append(_chip_smoke().k3_chains(q, k, 5, [min(q // 3, 300)] * 2, cuda_device))
    for cand, ok in cases:
        partner, rounds = sm.self_match(cand, ok, q)
        ref, ref_rounds = sm.self_match_plain(cand, ok, q)
        assert torch.equal(partner, ref) and int(rounds) == int(ref_rounds)


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _spd_system(n, m, dtype, dev, seed=0):
    rng = np.random.default_rng(seed + n + m)
    g = rng.normal(size=(n, n))
    return (torch.as_tensor(g @ g.T / n + np.eye(n), dtype=dtype, device=dev),
            torch.as_tensor(rng.normal(size=(n, m)), dtype=dtype, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("n", [1, 12, 96, 576, 1152, 3072])
@pytest.mark.parametrize("m", [1, 6])
def test_spd_kernel_matches_plain(cuda_device, dtype, n, m):
    a, b = _spd_system(n, m, dtype, cuda_device)
    a = a + torch.triu(torch.full_like(a, float("nan")), 1)  # the kernel reads the lower triangle
    before = spd.LAUNCHES
    x = spd.spd_solve(a, b)
    x2 = spd.spd_solve(a, b)
    assert spd.LAUNCHES == before + 2
    acc = spd.accuracy(a, b, x, spd.spd_solve_plain(a, b))
    print(f"K4 N={n} m={m} {dtype}: {acc}")
    assert torch.equal(x, x2)
    assert acc["ok"], acc


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("case", ["one_block_limit", "one_above", "ragged_dataflow"])
def test_spd_kernel_at_its_plan_edges(cuda_device, dtype, case):
    """K4 at the largest N its one-block path takes (256 in float32, 160 in
    float64), at one more (the tile dataflow on a few blocks), and with a
    ragged last tile on the dataflow (N=700 = 21 * 32 + 28), 6 right-hand
    sides."""
    itemsize = torch.finfo(dtype).bits // 8
    limit = spd.one_block_limit(itemsize)
    n = {"one_block_limit": limit, "one_above": limit + 1, "ragged_dataflow": 700}[case]
    assert spd.plan(n, 6, itemsize).one_block == (case == "one_block_limit")
    a, b = _spd_system(n, 6, dtype, cuda_device)
    a = a + torch.triu(torch.full_like(a, float("nan")), 1)
    x = spd.spd_solve(a, b)
    acc = spd.accuracy(a, b, x, spd.spd_solve_plain(a, b))
    print(f"K4 N={n} m=6 {dtype}: {acc}")
    assert torch.equal(x, spd.spd_solve(a, b))
    assert acc["ok"], acc


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_spd_kernel_nan_on_an_indefinite_system(cuda_device, dtype):
    small = torch.tensor([[3.5, 2.0, 0.0], [2.0, 0.5, 0.0], [0.0, 0.0, 2.5]], dtype=dtype,
                         device=cuda_device)
    a, b = _spd_system(1152, 1, dtype, cuda_device)
    a[700, 700] = -5.0
    for aa, bb in ((small, torch.ones((3, 1), dtype=dtype, device=cuda_device)), (a, b)):
        assert bool(torch.all(torch.isnan(spd.spd_solve(aa, bb))))
        assert bool(torch.all(torch.isnan(spd.spd_solve_plain(aa, bb))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("n,m", [(96, 6), (1152, 1)])
def test_spd_kernel_in_a_graph_equals_eager(cuda_device, dtype, n, m):
    a, b = _spd_system(n, m, dtype, cuda_device)
    eager = spd.spd_solve(a, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        spd.spd_solve(a, b)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        captured = spd.spd_solve(a, b)
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)


def test_spd_kernel_refuses_what_its_plan_cannot_take(cuda_device):
    a = torch.eye(96, device=cuda_device)
    with pytest.raises(ValueError, match="right-hand sides"):
        spd.spd_solve(a, torch.ones((96, 33), device=cuda_device))
    with pytest.raises(ValueError):
        spd.spd_solve(a.half(), torch.ones((96, 1), device=cuda_device).half())


FACTOR_CASES = {"main": {}, "live40": dict(count=40, seed=1),
                "invalid": dict(valid_share=0.0, seed=2),
                "ragged": dict(m=5001, nb=2001, mi=1001, seed=3),
                "s8": dict(s_cap=8, m=3000, nb=1000, mi=300, seed=4)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("case", list(FACTOR_CASES))
def test_factor_kernels_match_plain(cuda_device, dtype, case):
    """K5 and K6 at the main path's sizes (S=96, M=16384 of which 8192
    binary, Mi=1536), with 40 live states, with every factor invalid, at a
    ragged M and Mi, and at S=8 (chip_smoke.check_factor_kernels)."""
    before = imu_factor.LAUNCHES, surfel_factor.LAUNCHES
    _chip_smoke().check_factor_kernels(case, cuda_device, dtype, **FACTOR_CASES[case])
    assert imu_factor.LAUNCHES > before[0] and surfel_factor.LAUNCHES > before[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_factor_kernels_in_a_graph_equal_eager(cuda_device, dtype):
    cs = _chip_smoke()
    sfac, ifac, cor, grav, fm, nb = cs.factor_problem(cuda_device, dtype, seed=5)
    w, dt, a2 = cs.FACTOR_WEIGHTS, cs.FACTOR_DT, cs.FACTOR_A2

    def run():
        bands, gi = imu_factor.normal_eqs(ifac, cor, w, dt, grav)
        h, g = surfel_factor.normal_eqs(sfac, cor, a2, bands, gi, fm, nb)
        return (bands, gi, h, g, imu_factor.residuals(ifac, cor, w, dt, grav),
                surfel_factor.residuals(sfac, cor))

    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        captured = run()
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(captured, eager))


def test_factor_kernels_refuse_what_they_cannot_take(cuda_device):
    cs = _chip_smoke()
    sfac, ifac, cor, grav, fm, nb = cs.factor_problem(cuda_device, torch.float32, m=300, nb=100,
                                                      mi=50, s_cap=8)
    with pytest.raises(ValueError):
        imu_factor.residuals(ifac, cor.half(), cs.FACTOR_WEIGHTS, cs.FACTOR_DT, grav.half())
    with pytest.raises(ValueError):
        surfel_factor.residuals(sfac, cor.double())  # the factors are float32
    with pytest.raises(ValueError):
        surfel_factor.normal_eqs(sfac, cor, cs.FACTOR_A2, torch.zeros((5, 8, 12, 12),
                                 device=cuda_device), fm, fm, 301)  # nb > M


K7_CASES = ("room", "room, tight", "every point invalid", "one voxel", "P=5001", "dense", "wide")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("case", K7_CASES)
def test_surfel_extract_kernel_matches_plain(cuda_device, dtype, case):
    """K7 on chip_smoke.k7_inputs: the 4096-point room sweep at the small
    and the tight configs (segment, cluster and surfel drops), no valid
    point, every point in one voxel, P=5001, the dense floor of triangles at
    the shipped sizes, and that floor with triangles at the far corners of
    the key range (the sort's most passes) (chip_smoke.check_k7: t, centers
    and covariances bit-equal to the plain version's; two runs and a graph
    replay bit-equal too)."""
    cs = _chip_smoke()
    pts, ts, valid, cfg = cs.k7_inputs()[case]
    before = surfel_extract.LAUNCHES
    cs.check_k7(case, torch.as_tensor(pts, dtype=dtype, device=cuda_device),
                torch.as_tensor(ts, dtype=dtype, device=cuda_device),
                torch.as_tensor(valid, device=cuda_device), cfg)
    assert surfel_extract.LAUNCHES > before


def test_surfel_extract_kernel_refuses_what_it_cannot_take(cuda_device):
    cfg = WildcatConfig(max_points_per_sweep=64)
    pts = torch.zeros((64, 3), device=cuda_device)
    t, valid = torch.zeros(64, device=cuda_device), torch.ones(64, dtype=torch.bool,
                                                               device=cuda_device)
    with pytest.raises(ValueError):
        surfel_extract.extract(pts, t.double(), valid, cfg)  # t in another dtype
    with pytest.raises(ValueError):
        surfel_extract.extract(pts, t, valid.to(torch.uint8), cfg)
    with pytest.raises(ValueError):
        surfel_extract.extract(pts.half(), t.half(), valid, cfg)
    with pytest.raises(ValueError):
        surfel_extract.extract(pts, t, valid, WildcatConfig(max_points_per_sweep=64,
                                                            max_voxel_depth=8))
