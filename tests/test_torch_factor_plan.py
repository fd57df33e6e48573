"""Kernels K5 (``ops/imu_factor.py``) and K6 (``ops/surfel_factor.py``) on
the CPU: their launch plans, their wrappers' refusal of CPU tensors, the CPU
dispatch to the plain versions, and numpy models of how the kernels list
and reduce the factors, held to the plain versions.

The models follow ``csrc/imu_factor.cu`` and ``csrc/surfel_factor.cu``: one
stable counting pass over the grid. A block takes a segment of SEGMENT
factors, sorts their keys with each factor's place (K6: the block rows and
the pairs of block rows a factor reaches; K5: a kept factor's base) and
writes them by key (its piece) with each key's exclusive offset; sums of the
segments' counts and exclusive scans place K6's rows' lists, and a pair's
(or a base's) list is its run in each segment's piece, segment after
segment. Each list must hold what the kernels' first design listed: a row,
the factors with i1l or i2l in {s - 1, s} in increasing index, each once; a
pair (s, t), the factors that a walk of the shorter of the two rows' lists
takes; a base, its factors in order, less those whose band is all zero with
a finite residual (an invalid factor's exact zeros). Each output entry is a
chain over its list, and the models' sums must equal the plain versions'
within 1e-12 of the largest entry in float64 (the order of the sums
differs). The factors are ``chip_smoke.factor_problem``'s, made on the CPU
from a seed.
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


@pytest.fixture(scope="module")
def problem():
    """A window of S=12 states (10 live), 9000 surfel factors (3000 binary)
    and 700 IMU factors, float64 on the CPU."""
    sfac, ifac, cor, grav, fm, nb = CS.factor_problem("cpu", torch.float64, s_cap=12, count=10,
                                                      m=9000, nb=3000, mi=700, seed=11)
    return sfac, ifac, cor, grav, fm, nb


def test_plans():
    # K5 at the main path's sizes: a record of 12 x 36 + 12 values a factor
    # and 702 sums a base; a segment's S + 1 offsets and its piece of 16
    for itemsize in (4, 8):
        p = imu_factor.plan(1536, 96, itemsize)
        assert p == imu_factor.Plan(256, 16, 16, imu_factor.smem_bytes(itemsize),
                                    1536 * 444 + 96 * 702, 96 * (97 + 16))
        assert p.smem_bytes <= imu_factor.H100_SMEM_PER_BLOCK
    assert imu_factor.smem_bytes(4) == 4 * 16 * 444 + 4 * (256 * 16 + 256 + 8) == 45856
    assert imu_factor.workspace_bytes(imu_factor.plan(1536, 96, 4), 4) == 3040896
    # K6 at S=96: a record of 28 values a factor and the partial sums of at
    # most S + 4 M / 64 chunks; as int32 the packed brackets, each segment's
    # row offsets and counts, pair offsets and pieces (4 entries a factor at
    # most), the rows' lists (a factor sits in at most 4), the pairs' totals
    # and the rows' starts: 2.10 MB of lists where the first design took
    # S M int4 (25.2 MB)
    p = surfel_factor.plan(16384, 8192, 96, 4)
    assert p == surfel_factor.Plan(256, 64, 128, 16384 * 28 + (96 + 1024) * (6 * 144 + 24),
                                   2 * 16384 + 128 * (97 + 96 + 512) + 4 * 16384
                                   + 64 * (4657 + 512) + 4656 + 2 * 97)
    assert 4 * p.ints == 2096840 < 4 * 2**20
    assert surfel_factor.workspace_bytes(p, 4) == 4 * (p.values + p.ints) == 7910088
    assert surfel_factor.plan(0, 0, 8, 8).values == 8 * (6 * 144 + 24)
    for bad in ((10, 11, 96, 4), (10, 5, 96, 2), (10, 5, 0, 4), (10, 5, 5000, 4)):
        with pytest.raises(ValueError):  # nb > M, 2-byte values, S = 0, S > MAX_STATES
            surfel_factor.plan(*bad)
    assert surfel_factor.supports(16384, 8192, 96, torch.float64)
    assert not surfel_factor.supports(10, 11, 96, torch.float32)
    assert not surfel_factor.supports(10, 5, 96, torch.float16)
    # the workspaces stay under MAX_WORKSPACE_BYTES: K6's records and
    # partial sums grow as M, its pair offsets as nb S^2; K5's bands as Mi
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


def _pair_index(s, t, s_cap):
    return s * s_cap - s * (s - 1) // 2 + (t - s)


def _segments(keyed, m, seg):
    """The counting pass's phase 0: ``keyed(i)`` gives factor i's keys; each
    segment of ``seg`` factors sorts its (key, factor) pairs (the factor's
    place in the low bits: stable). Returns each segment's sorted keys and
    factors."""
    out = []
    for g0 in range(0, m, seg):
        pairs = sorted((k, i) for i in range(g0, min(m, g0 + seg)) for k in keyed(i))
        out.append((np.asarray([k for k, _ in pairs], dtype=np.int64),
                    np.asarray([i for _, i in pairs], dtype=np.int64)))
    return out


def _runs(pieces, offsets, key):
    """A key's list: its run in each segment's piece, segment after segment."""
    return np.concatenate([piece[e[key]:e[key + 1]] for piece, e in zip(pieces, offsets)]
                          + [np.zeros(0, dtype=np.int64)])


def _k6_model(sfac, nb, s_cap):
    """K6's lists by the counting pass: the rows' lists placed by scans over
    the segments' counts, each pair's list read off the segments' pieces."""
    f = {k: v.numpy() for k, v in sfac.fields().items()}
    m, pairs, seg = len(f["i1l"]), s_cap * (s_cap + 1) // 2, surfel_factor.SEGMENT
    pk = {k: np.clip(f[k], -2, s_cap) for k in ("i1l", "i1r", "i2l", "i2r")}  # 16-bit brackets

    def keyed(i):
        rows = []
        for c in (f["i1l"][i], f["i1l"][i] + 1, f["i2l"][i], f["i2l"][i] + 1):
            if 0 <= c < s_cap and c not in rows:
                rows.append(int(c))
        prs = []
        for x in (pk["i1l"][i], pk["i1r"][i]):
            for y in (pk["i2l"][i], pk["i2r"][i]):
                q = s_cap + _pair_index(min(x, y), max(x, y), s_cap)
                if i < nb and 0 <= x < s_cap and 0 <= y < s_cap and q not in prs:
                    prs.append(int(q))
        return rows + prs

    segs = _segments(keyed, m, seg)
    nrow = [int(np.searchsorted(k, s_cap)) for k, _ in segs]
    erow = [np.searchsorted(k[:n], np.arange(s_cap + 1)) for (k, _), n in zip(segs, nrow)]
    cnt = np.stack([np.diff(e) for e in erow]) if segs else np.zeros((0, s_cap), dtype=np.int64)
    start = np.concatenate([[0], np.cumsum(cnt.sum(0))])
    lists = np.full(int(start[-1]), -1, dtype=np.int64)
    for g, ((_, fac), e) in enumerate(zip(segs, erow)):
        pre = cnt[:g].sum(0)
        for i in range(nrow[g]):
            s = int(np.searchsorted(e, i, side="right")) - 1  # the entry's row
            pos = start[s] + pre[s] + i - e[s]
            assert lists[pos] == -1  # each place taken once
            lists[pos] = fac[i]
    assert (lists >= 0).all()
    rows = [lists[start[s]:start[s + 1]] for s in range(s_cap)]
    psegs = segs[:-(-nb // seg)]
    epair = [np.searchsorted(k[n:], s_cap + np.arange(pairs + 1)) for (k, _), n in
             zip(psegs, nrow)]
    ppiece = [fac[n:] for (_, fac), n in zip(psegs, nrow)]
    pair_lists = {}
    for s in range(s_cap):
        for t in range(s, s_cap):
            pair_lists[(s, t)] = _runs(ppiece, epair, _pair_index(s, t, s_cap))
    return rows, pair_lists, pk


def _k6_sums(sfac, cor, fm, nb, rows, pair_lists):
    """H and g (no IMU part) from the model's lists, as the kernel forms
    them: a row's payloads and g over its list, each pair's cross terms over
    its list."""
    s_cap, a2 = cor.shape[0], CS.FACTOR_A2
    f = {k: v.numpy() for k, v in sfac.fields().items()}
    rs, jac, _ = fmod.surfel_residuals_plain(sfac, cor)
    sw = 1.0 / torch.sqrt(1.0 + rs * rs / a2)
    j1v = ((jac[:, 0] + jac[:, 1]) * sw[:, None]).numpy()
    j2v = ((jac[:, 2] + jac[:, 3]) * sw[:, None]).numpy()
    rsw = (rs * sw).numpy()
    n = 12 * s_cap
    h, g = np.zeros((n, n)), np.zeros(n)
    t11, t22 = np.zeros((s_cap, 3, 12, 12)), np.zeros((s_cap, 3, 12, 12))
    for s, lst in enumerate(rows):
        for m in lst:
            f1, f2 = f["f1"][m], f["f2"][m]
            if m < nb and f["i1l"][m] == s:
                t11[s] += np.multiply.outer(np.array([(1 - f1) ** 2, (1 - f1) * f1, f1 * f1]),
                                            np.outer(j1v[m], j1v[m]))
            if f["i2l"][m] == s:
                t22[s] += np.multiply.outer(np.array([(1 - f2) ** 2, (1 - f2) * f2, f2 * f2]),
                                            np.outer(j2v[m], j2v[m]))
            if f["i1l"][m] in (s - 1, s):
                g[12 * s:12 * s + 12] += _weight(f["i1l"][m], f["i1r"][m], f1, s) * j1v[m] * rsw[m]
            if f["i2l"][m] in (s - 1, s):
                g[12 * s:12 * s + 12] += _weight(f["i2l"][m], f["i2r"][m], f2, s) * j2v[m] * rsw[m]
    for (s, t), lst in pair_lists.items():
        blk = np.zeros((12, 12))
        for m in lst:
            i1l, i1r, i2l, i2r, f1, f2 = (f[k][m] for k in ("i1l", "i1r", "i2l", "i2r", "f1", "f2"))
            if s in (i1l, i1r) and t in (i2l, i2r):  # D[(s,i),(t,j)]
                blk += np.outer(_weight(i1l, i1r, f1, s) * j1v[m],
                                _weight(i2l, i2r, f2, t) * j2v[m])
            if t in (i1l, i1r) and s in (i2l, i2r):  # D[(t,j),(s,i)], indexed [i][j]
                blk += np.outer(_weight(i2l, i2r, f2, s) * j2v[m],
                                _weight(i1l, i1r, f1, t) * j1v[m])
        if t == s:
            blk = blk + (t11[s, 0] + t22[s, 0]) + (
                (t11[s - 1, 2] + t22[s - 1, 2]) if s > 0 else 0.0)
        elif t == s + 1:
            blk = blk + (t11[s, 1] + t22[s, 1])
        h[12 * s:12 * s + 12, 12 * t:12 * t + 12] = blk
        h[12 * t:12 * t + 12, 12 * s:12 * s + 12] = blk.T
    fmn = fm.numpy()
    return h * fmn[:, None] * fmn[None, :] + np.diag(1.0 - fmn), g * fmn


def _k5_model(ifac, cor, grav, s_cap):
    """K5's base lists by the counting pass (the kept factors of segments
    of SEGMENT, by base), the bases' sums over them and the bands read off.
    Returns (lists, kept, base, bands, g)."""
    w, dt = CS.FACTOR_WEIGHTS, CS.FACTOR_DT
    ri, jac, idx = fmod.imu_residuals_plain(ifac, cor, w, dt, grav)
    ri, jac, idx = ri.numpy(), jac.numpy(), idx.numpy()
    mi, seg = len(ri), imu_factor.SEGMENT
    base = idx.min(1)
    band = np.zeros((mi, 12, 36))
    for k in range(6):
        for d in range(3):
            sel = idx[:, k] - base == d
            band[sel, :, 12 * d:12 * d + 12] += jac[sel, k]
    kept = (band != 0).any((1, 2)) | ~np.isfinite(ri).all(1)
    segs = _segments(lambda i: [int(base[i])] if kept[i] and 0 <= base[i] < s_cap else [], mi,
                     seg)
    ebase = [np.searchsorted(k, np.arange(s_cap + 1)) for k, _ in segs]
    lists = [_runs([fac for _, fac in segs], ebase, s) for s in range(s_cap)]
    hseg, gseg = np.zeros((s_cap + 2, 36, 36)), np.zeros((s_cap + 2, 36))  # bases -2, -1 at the end
    for s, lst in enumerate(lists):
        for m in lst:
            hseg[s] += band[m].T @ band[m]
            gseg[s] += band[m].T @ ri[m]
    out, gout = np.zeros((5, s_cap, 12, 12)), np.zeros((s_cap, 12))
    blk = lambda s, a, b: hseg[s, 12 * a:12 * a + 12, 12 * b:12 * b + 12]
    for r in range(s_cap):
        out[:, r] = (blk(r - 2, 2, 0), blk(r - 1, 1, 0) + blk(r - 2, 2, 1),
                     blk(r, 0, 0) + blk(r - 1, 1, 1) + blk(r - 2, 2, 2),
                     blk(r, 0, 1) + blk(r - 1, 1, 2), blk(r, 0, 2))
        gout[r] = gseg[r, 0:12] + gseg[r - 1, 12:24] + gseg[r - 2, 24:36]
    return lists, kept, base, band, out, gout.reshape(-1)


@pytest.fixture(scope="module")
def models(problem):
    sfac, ifac, cor, grav, fm, nb = problem
    rows, pair_lists, pk = _k6_model(sfac, nb, cor.shape[0])
    return rows, pair_lists, pk, _k5_model(ifac, cor, grav, cor.shape[0])


def test_k6_row_lists_and_pair_sums(problem, models):
    """K6's model: the rows' lists and the pairs' lists of the counting pass
    give the plain version's H and g (without the IMU factors), and the
    cross terms D are not empty."""
    sfac, _, cor, _, fm, nb = problem
    rows, pair_lists, _, _ = models
    s_cap, n = cor.shape[0], 12 * cor.shape[0]
    h, g = _k6_sums(sfac, cor, fm, nb, rows, pair_lists)
    zero = torch.zeros((5, s_cap, 12, 12), dtype=cor.dtype)
    h_p, g_p = solver.surfel_normal_eqs_plain(sfac, cor, CS.FACTOR_A2, zero,
                                              torch.zeros(n, dtype=cor.dtype), fm, s_cap, nb)
    np.testing.assert_allclose(h, h_p.numpy(), rtol=0, atol=TOL * np.abs(h_p.numpy()).max())
    np.testing.assert_allclose(g, g_p.numpy(), rtol=0, atol=TOL * np.abs(g_p.numpy()).max())
    assert np.count_nonzero(np.abs(h - np.diag(np.diag(h))) > 0) > 12 * n  # D is not empty
    assert sum(len(v) > 0 for v in pair_lists.values()) > s_cap  # off-diagonal pairs hold some


def test_k5_block_members_and_bands(problem, models):
    """K5's model: the bases' lists of the counting pass give the plain
    version's five bands and g, and band -d at r + d is the transpose of
    band +d at r (bit for bit on the card, where both read the same entries
    of the symmetric per-base sums; here within TOL)."""
    _, ifac, cor, grav, _, _ = problem
    s_cap = cor.shape[0]
    _, kept, _, _, out, gout = models[3]
    bands_p, g_p = solver.imu_banded_normal_eqs_plain(ifac, cor, CS.FACTOR_WEIGHTS,
                                                      CS.FACTOR_DT, grav, s_cap)
    np.testing.assert_allclose(out, bands_p.numpy(), rtol=0,
                               atol=TOL * np.abs(bands_p.numpy()).max())
    np.testing.assert_allclose(gout, g_p.numpy(), rtol=0, atol=TOL * np.abs(g_p.numpy()).max())
    for d in (1, 2):
        np.testing.assert_allclose(out[2 + d, :s_cap - d], out[2 - d, d:].transpose(0, 2, 1),
                                   rtol=0, atol=TOL * np.abs(out).max())
    assert 0 < kept.sum() < len(kept)  # the invalid factors are left out, the valid ones kept


@pytest.mark.parametrize("part", ["rows", "pairs", "bases", "sums"])
def test_counting_pass_lists(problem, models, part):
    """The counting pass lists what the kernels' first design listed: each
    block row the factors with i1l or i2l in {s - 1, s}, in increasing
    index, each once; each pair (s, t) the factors that a walk of the
    shorter of the two rows' lists takes (binary, side 1 bracketed at one
    row and side 2 at the other); each base its factors in order, less the
    ones whose band is all zero with a finite residual (which add exact
    zeros); and the models' sums give the plain versions' H and g."""
    sfac, ifac, cor, grav, fm, nb = problem
    rows, pair_lists, pk, (blists, kept, base, band, out, gout) = models
    s_cap = cor.shape[0]
    f = {k: v.numpy() for k, v in sfac.fields().items()}
    if part == "rows":
        for s, lst in enumerate(rows):
            rule = np.isin(f["i1l"], (s - 1, s)) | np.isin(f["i2l"], (s - 1, s))
            assert lst.tolist() == np.flatnonzero(rule).tolist()  # in order, each once
        assert max(len(r) for r in rows) > 3 * len(f["i1l"]) / s_cap  # unary ones crowd rows 0, 1
    elif part == "pairs":
        for (s, t), lst in pair_lists.items():
            walk = rows[s] if len(rows[s]) <= len(rows[t]) else rows[t]
            at = lambda side, r: (pk[side + "l"][walk] == r) | (pk[side + "r"][walk] == r)
            take = (walk < nb) & ((at("i1", s) & at("i2", t)) | (at("i1", t) & at("i2", s)))
            assert lst.tolist() == walk[take].tolist()
    elif part == "bases":
        for s, lst in enumerate(blists):
            assert lst.tolist() == np.flatnonzero(kept & (base == s)).tolist()
        assert not band[~kept].any()  # the left-out factors' bands are exact zeros
    else:
        h, g = _k6_sums(sfac, cor, fm, nb, rows, pair_lists)
        bands_p, gi_p = solver.imu_banded_normal_eqs_plain(ifac, cor, CS.FACTOR_WEIGHTS,
                                                           CS.FACTOR_DT, grav, s_cap)
        # the IMU part placed as the kernel places it, then the surfel part
        h_p, g_p = solver.surfel_normal_eqs_plain(sfac, cor, CS.FACTOR_A2, torch.as_tensor(out),
                                                  torch.as_tensor(gout), fm, s_cap, nb)
        h_i, g_i = solver.surfel_normal_eqs_plain(sfac, cor, CS.FACTOR_A2, bands_p, gi_p, fm,
                                                  s_cap, nb)
        for got, ref in ((h_p, h_i), (g_p, g_i)):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                       atol=TOL * np.abs(ref.numpy()).max())
        zb = torch.zeros((5, s_cap, 12, 12), dtype=cor.dtype)
        h_s, g_s = solver.surfel_normal_eqs_plain(sfac, cor, CS.FACTOR_A2, zb,
                                                  torch.zeros(12 * s_cap, dtype=cor.dtype), fm,
                                                  s_cap, nb)
        np.testing.assert_allclose(h, h_s.numpy(), rtol=0, atol=TOL * np.abs(h_s.numpy()).max())
        np.testing.assert_allclose(g, g_s.numpy(), rtol=0, atol=TOL * np.abs(g_s.numpy()).max())


@pytest.mark.parametrize("name", ["imu_factor.cu", "surfel_factor.cu"])
def test_probe_finds_the_phase_marks(name):
    """``probe_factors`` stamps each phase boundary by text edits of the
    kernel's source: every mark is found once, and each stamp is put in."""
    from wildcat_slam_tpu_torch import probe_factors

    src = probe_factors.traced(name)
    for k in range(len(probe_factors.STAMPS[name])):
        assert f"probe_stamp({k});" in src
