"""Kernels K5 (``ops/imu_factor.py``) and K6 (``ops/surfel_factor.py``) on
the CPU: their launch plans, their wrappers' refusal of CPU tensors, the CPU
dispatch to the plain versions, and numpy models of how the kernels list
and reduce the factors, held to the plain versions.

The models follow ``csrc/imu_factor.cu`` and ``csrc/surfel_factor.cu``: a
block row's scan gives each thread a few consecutive factors and places its
members after those of the threads before it, by a warp scan of the
threads' counts and the warps' totals (``wc::compact_many`` in
``csrc/lie.cuh``), window after window, and each output entry is a chain
over its factors in that order. Every factor must
sit in exactly the block rows its brackets reach, in increasing index; K6's
pair of block rows (s, t), s <= t, must find every factor of its cross
terms in the lists of both rows (it walks the shorter); and the models'
sums must equal the plain versions' within
1e-12 of the largest entry in float64 (the order of the sums differs). The
factors are ``chip_smoke.factor_problem``'s, made on the CPU from a seed.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from wildcat_slam_tpu_torch.odometry import factors as fmod
from wildcat_slam_tpu_torch.odometry import solver
from wildcat_slam_tpu_torch.ops import imu_factor, surfel_factor

TOL = 1e-12  # of the largest entry, float64


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def _scan(member, threads, window, per=8):
    """wc::compact_many over windows of ``window`` factors, chunks of
    ``threads`` x ``per`` factors, ``per`` consecutive ones a thread: a
    thread's members go after the warp's earlier lanes' (the warp's
    inclusive scan less its own count) and the earlier warps' totals.
    Returns the factor indices in their list order, the windows one after
    another (a window's list is processed before the next is scanned)."""
    m, out = len(member), []
    for w0 in range(0, m, window):
        w1, slots, listed = min(m, w0 + window), {}, 0
        for c0 in range(w0, w1, threads * per):
            idx = np.arange(c0, c0 + threads * per).reshape(threads, per)
            held = member[np.minimum(idx, m - 1)] & (idx < w1)
            counts = held.sum(1)
            scan = np.cumsum(counts.reshape(-1, 32), 1).reshape(-1)  # inclusive, per warp
            totals = counts.reshape(-1, 32).sum(1)
            for t in range(threads):
                pos = listed + scan[t] - counts[t] + totals[:t // 32].sum()
                for k in np.flatnonzero(held[t]):
                    assert pos not in slots
                    slots[pos] = idx[t, k]
                    pos += 1
            listed += totals.sum()
        assert sorted(slots) == list(range(listed))
        out += [slots[k] for k in range(listed)]
    return np.asarray(out, dtype=np.int64)


@pytest.fixture(scope="module")
def problem():
    """A window of S=12 states (10 live), 9000 surfel factors (3000 binary)
    and 700 IMU factors, float64 on the CPU."""
    sfac, ifac, cor, grav, fm, nb = CS.factor_problem("cpu", torch.float64, s_cap=12, count=10,
                                                      m=9000, nb=3000, mi=700, seed=11)
    return sfac, ifac, cor, grav, fm, nb


def test_plans():
    for itemsize in (4, 8):
        p = imu_factor.plan(1536, 96, itemsize)
        assert p.smem_bytes == imu_factor.smem_bytes(itemsize) <= imu_factor.H100_SMEM_PER_BLOCK
    # S=96 at the main path's sizes: a record of 28 values a factor, a list
    # of up to M entries of 4 int32 a block row, and the partial sums of at
    # most S + 4 M / 64 chunks (a factor sits in at most 4 lists)
    p = surfel_factor.plan(16384, 8192, 96, 4)
    assert p == surfel_factor.Plan(256, 64, 16384 * 28, 4 * 96 * 16384,
                                   (96 + 1024) * (6 * 144 + 24))
    assert surfel_factor.plan(0, 0, 8, 8).workspace == 28
    for bad in ((10, 11, 96, 4), (10, 5, 96, 2), (10, 5, 0, 4), (10, 5, 5000, 4)):
        with pytest.raises(ValueError):  # nb > M, 2-byte values, S = 0, S > MAX_STATES
            surfel_factor.plan(*bad)
    assert surfel_factor.supports(16384, 8192, 96, torch.float64)
    assert not surfel_factor.supports(10, 11, 96, torch.float32)
    assert not surfel_factor.supports(10, 5, 96, torch.float16)
    # the workspaces stay under MAX_WORKSPACE_BYTES: K6's lists grow as S M,
    # K5's bands as Mi
    assert surfel_factor.workspace_bytes(p, 96, 4) == (p.workspace + p.partials) * 4 + 4 * (
        4 * 96 * 16384 + 96) == 30979456
    assert not surfel_factor.supports(1 << 22, 0, 4096, torch.float32)
    with pytest.raises(ValueError):
        surfel_factor.plan(1 << 22, 0, 4096, 4)
    assert not imu_factor.supports(1 << 26, 96, torch.float64)
    with pytest.raises(ValueError):
        imu_factor.plan(1 << 26, 96, 8)
    assert imu_factor.supports(1536, 96, torch.float64)
    assert not imu_factor.supports(1536, 96, torch.float16)
    assert not imu_factor.supports(1536, 96, torch.int64)


def test_cpu_takes_the_plain_version_and_the_kernels_refuse_it(problem):
    sfac, ifac, cor, grav, fm, nb = problem
    w, dt = CS.FACTOR_WEIGHTS, CS.FACTOR_DT
    before = imu_factor.LAUNCHES, surfel_factor.LAUNCHES
    assert torch.equal(fmod.surfel_residuals(sfac, cor, with_jac=False)[0],
                       fmod.surfel_residuals_plain(sfac, cor, with_jac=False)[0])
    assert torch.equal(fmod.imu_residuals(ifac, cor, w, dt, grav, with_jac=False)[0],
                       fmod.imu_residuals_plain(ifac, cor, w, dt, grav, with_jac=False)[0])
    bands, gi = solver._imu_banded_normal_eqs(ifac, cor, w, dt, grav, 12)
    h, g = solver._surfel_normal_eqs(sfac, cor, CS.FACTOR_A2, bands, gi, fm, 12, nb)
    assert torch.equal(h, h.T)
    assert (imu_factor.LAUNCHES, surfel_factor.LAUNCHES) == before
    with pytest.raises(ValueError, match="CUDA"):
        imu_factor.residuals(ifac, cor, w, dt, grav)
    with pytest.raises(ValueError, match="CUDA"):
        imu_factor.normal_eqs(ifac, cor, w, dt, grav)
    with pytest.raises(ValueError, match="CUDA"):
        surfel_factor.residuals(sfac, cor)
    with pytest.raises(ValueError, match="CUDA"):
        surfel_factor.normal_eqs(sfac, cor, CS.FACTOR_A2, bands, gi, fm, nb)


def _weight(il, ir, f, t):
    return (il == t) * (1.0 - f) + (ir == t) * f


def test_k6_row_lists_and_pair_sums(problem):
    """K6's model: block row s lists the factors with i1l or i2l in
    {s - 1, s}; the pair (s, t), s <= t, finds D[(s,i),(t,j)] (side 1 at s,
    side 2 at t) and D[(t,j),(s,i)] (side 1 at t, side 2 at s) in either
    row's list; the diagonal payloads and g of row s sum over its list (in
    chunks, added in order). The sums give the plain version's H and g
    (without the IMU factors)."""
    sfac, _, cor, _, fm, nb = problem
    s_cap, a2 = cor.shape[0], CS.FACTOR_A2
    f = {k: v.numpy() for k, v in sfac.fields().items()}
    rs, jac, _ = fmod.surfel_residuals_plain(sfac, cor)
    sw = 1.0 / torch.sqrt(1.0 + rs * rs / a2)
    j1v = ((jac[:, 0] + jac[:, 1]) * sw[:, None]).numpy()
    j2v = ((jac[:, 2] + jac[:, 3]) * sw[:, None]).numpy()
    rsw = (rs * sw).numpy()
    m_all, n = np.arange(len(rsw)), 12 * s_cap
    reach = lambda s: ((f["i1l"] == s) | (f["i1r"] == s) | (f["i2l"] == s) | (f["i2r"] == s)
                       | ((m_all >= nb) & (f["i1l"] == s - 1)))  # a unary side 1 at (0, 0)
    lists = []
    for s in range(s_cap):
        rows = (s - 1, s)
        lst = _scan(np.isin(f["i1l"], rows) | np.isin(f["i2l"], rows), surfel_factor.THREADS,
                    1 << 30)
        assert lst.tolist() == np.flatnonzero(reach(s)).tolist()  # in index order, exactly
        lists.append(lst)
    h, g = np.zeros((n, n)), np.zeros(n)
    for s in range(s_cap):
        for t in range(s, s_cap):
            a = np.zeros((12, 12))  # D[(s,i),(t,j)]
            b = np.zeros((12, 12))  # D[(t,j),(s,i)], indexed [i][j]
            x0, y0, x2, y2, g1, g2 = (np.zeros((12, 12)),) * 4 + (np.zeros(12),) * 2
            for m in lists[s]:
                bin_, i1l, i1r, i2l, i2r = m < nb, f["i1l"][m], f["i1r"][m], f["i2l"][m], f["i2r"][m]
                side1, side2 = i1l in (s - 1, s), i2l in (s - 1, s)
                if bin_ and side1 and t in (i2l, i2r):
                    a = a + np.outer(_weight(i1l, i1r, f["f1"][m], s) * j1v[m],
                                     _weight(i2l, i2r, f["f2"][m], t) * j2v[m])
                if bin_ and side2 and t in (i1l, i1r):
                    b = b + np.outer(_weight(i2l, i2r, f["f2"][m], s) * j2v[m],
                                     _weight(i1l, i1r, f["f1"][m], t) * j1v[m])
                f1, f2 = f["f1"][m], f["f2"][m]
                c1, c2 = ((1 - f1) ** 2, (1 - f2) ** 2) if t == s else ((1 - f1) * f1, (1 - f2) * f2)
                if t in (s, s + 1) and bin_ and i1l == s:
                    x0 = x0 + c1 * np.outer(j1v[m], j1v[m])
                if t in (s, s + 1) and i2l == s:
                    y0 = y0 + c2 * np.outer(j2v[m], j2v[m])
                if t == s and bin_ and i1l == s - 1:
                    x2 = x2 + f1 * f1 * np.outer(j1v[m], j1v[m])
                if t == s and i2l == s - 1:
                    y2 = y2 + f2 * f2 * np.outer(j2v[m], j2v[m])
                if t == s and side1:
                    g1 = g1 + _weight(i1l, i1r, f1, s) * (j1v[m] * rsw[m])
                if t == s and side2:
                    g2 = g2 + _weight(i2l, i2r, f2, s) * (j2v[m] * rsw[m])
            # every factor with a D term at (s, t) or (t, s) is in both rows' lists
            for side_s, side_t in (((f["i1l"], f["i1r"]), (f["i2l"], f["i2r"])),
                                   ((f["i2l"], f["i2r"]), (f["i1l"], f["i1r"]))):
                both = ((m_all < nb) & ((side_s[0] == s) | (side_s[1] == s))
                        & ((side_t[0] == t) | (side_t[1] == t)))
                assert set(np.flatnonzero(both)) <= set(lists[s].tolist()) & set(
                    lists[t].tolist())
            blk = a + b
            if t == s:
                blk = blk + (x0 + y0) + (x2 + y2)
                g[12 * s:12 * s + 12] = g1 + g2
            elif t == s + 1:
                blk = blk + (x0 + y0)
            h[12 * s:12 * s + 12, 12 * t:12 * t + 12] = blk
            h[12 * t:12 * t + 12, 12 * s:12 * s + 12] = blk.T
    fmn = fm.numpy()
    h = h * fmn[:, None] * fmn[None, :] + np.diag(1.0 - fmn)
    zero = torch.zeros((5, s_cap, 12, 12), dtype=cor.dtype)
    h_p, g_p = solver.surfel_normal_eqs_plain(sfac, cor, a2, zero, torch.zeros(n, dtype=cor.dtype),
                                              fm, s_cap, nb)
    np.testing.assert_allclose(h, h_p.numpy(), rtol=0, atol=TOL * np.abs(h_p.numpy()).max())
    np.testing.assert_allclose(g * fmn, g_p.numpy(), rtol=0, atol=TOL * np.abs(g_p.numpy()).max())
    assert np.count_nonzero(np.abs(h - np.diag(np.diag(h))) > 0) > 12 * n  # D is not empty


def test_k5_block_members_and_bands(problem):
    """K5's model: block row r lists the factors whose base (the least of
    their six bracket indices) is r - 2, r - 1 or r; its slabs of
    hseg[r - di] (rows 12 di..12 di + 11 of the per-base sums of B^T B)
    give the plain version's five bands and g, and band -d at r + d is the
    transpose of band +d at r (bit for bit on the card, where both blocks
    sum the same products in the same order; here within TOL)."""
    _, ifac, cor, grav, _, _ = problem
    s_cap = cor.shape[0]
    w, dt = CS.FACTOR_WEIGHTS, CS.FACTOR_DT
    ri, jac, idx = fmod.imu_residuals_plain(ifac, cor, w, dt, grav)
    ri, jac, idx = ri.numpy(), jac.numpy(), idx.numpy()
    base = idx.min(1)
    band = np.zeros((len(base), 12, 36))
    for k in range(6):
        for m in range(len(base)):
            d = idx[m, k] - base[m]
            if d <= 2:
                band[m, :, 12 * d:12 * d + 12] += jac[m, k]
    out, gout = np.zeros((5, s_cap, 12, 12)), np.zeros((s_cap, 12))
    for r in range(s_cap):
        member = (base >= 0) & (base >= r - 2) & (base <= r)
        lst = _scan(member, imu_factor.THREADS, imu_factor.WINDOW)
        assert lst.tolist() == np.flatnonzero(member).tolist()
        slab, gs = np.zeros((3, 12, 36)), np.zeros((3, 12))
        for m in lst:
            di = r - base[m]
            slab[di] += band[m][:, 12 * di:12 * di + 12].T @ band[m]
            gs[di] += band[m][:, 12 * di:12 * di + 12].T @ ri[m]
        s0, s1, s2 = slab
        out[:, r] = (s2[:, 0:12], s1[:, 0:12] + s2[:, 12:24],
                     s0[:, 0:12] + s1[:, 12:24] + s2[:, 24:36], s0[:, 12:24] + s1[:, 24:36],
                     s0[:, 24:36])
        gout[r] = gs[0] + gs[1] + gs[2]
    # each factor in exactly the blocks base, base + 1, base + 2 (those < S)
    counts = sum(((base >= 0) & (base >= r - 2) & (base <= r)).astype(int) for r in range(s_cap))
    assert np.array_equal(counts, np.minimum(3, s_cap - base))
    bands_p, g_p = solver.imu_banded_normal_eqs_plain(ifac, cor, w, dt, grav, s_cap)
    np.testing.assert_allclose(out, bands_p.numpy(), rtol=0,
                               atol=TOL * np.abs(bands_p.numpy()).max())
    np.testing.assert_allclose(gout.reshape(-1), g_p.numpy(), rtol=0,
                               atol=TOL * np.abs(g_p.numpy()).max())
    for d in (1, 2):
        np.testing.assert_allclose(out[2 + d, :s_cap - d], out[2 - d, d:].transpose(0, 2, 1),
                                   rtol=0, atol=TOL * np.abs(out).max())
