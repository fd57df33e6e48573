"""The port's ops (wildcat_slam_tpu_torch/ops) against the JAX package's.

Same inputs, made with numpy from a seed, go through both. Tolerances:
float64 within 1e-10 absolute (the two sides differ only in summation order
and libm implementations); float32 within 64 ulp of the value's magnitude
(transcendentals and reduction order differ between XLA and ATen).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from wildcat_slam_tpu.ops import dfsum as jdf
from wildcat_slam_tpu.ops import eigh3 as jeig
from wildcat_slam_tpu.ops import lie as jlie
from wildcat_slam_tpu.ops import se3 as jse3
from wildcat_slam_tpu.ops import spline as jsp
from wildcat_slam_tpu.ops import voxel as jvox
from wildcat_slam_tpu_torch.ops import dfsum as tdf
from wildcat_slam_tpu_torch.ops import eigh3 as teig
from wildcat_slam_tpu_torch.ops import lie as tlie
from wildcat_slam_tpu_torch.ops import se3 as tse3
from wildcat_slam_tpu_torch.ops import spline as tsp
from wildcat_slam_tpu_torch.ops import voxel as tvox

torch.set_num_threads(1)

DTYPES = {"float64": (np.float64, torch.float64), "float32": (np.float32, torch.float32)}


def _close(got, ref, dtype_name):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    if dtype_name == "float64":
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
    else:
        tol = 64 * np.finfo(np.float32).eps * np.maximum(1.0, np.abs(ref))
        assert np.all(np.abs(got - ref) <= tol), np.max(np.abs(got - ref) / tol)


def _rotvecs(rng, n):
    """Rotation vectors spanning the Taylor branches: tiny, small, large."""
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    ang = np.concatenate([rng.uniform(0, 1e-9, n // 4), rng.uniform(1e-6, 0.05, n // 4),
                          rng.uniform(0.05, 0.5, n // 4), rng.uniform(0.5, 3.0, n - 3 * (n // 4))])
    return v * ang[:, None]


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


LIE_UNARY = ["hat", "exp_quat", "jl", "jr", "jl_inv", "jr_inv", "exp_matrix"]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", LIE_UNARY)
def test_lie_rotvec_functions(name, dt):
    npd, _ = DTYPES[dt]
    v = _rotvecs(np.random.default_rng(0), 64).astype(npd)
    _close(getattr(tlie, name)(torch.as_tensor(v)), getattr(jlie, name)(jnp.asarray(v)), dt)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", ["log_quat", "quat_normalize", "quat_to_matrix", "quat_conj"])
def test_lie_quat_functions(name, dt):
    npd, _ = DTYPES[dt]
    rng = np.random.default_rng(1)
    q = np.concatenate([_quats(rng, 60), [[1.0, 1e-10, 0, 0], [1e-9, 1.0, 0, 0],
                                          [-0.5, 0.5, 0.5, 0.5], [1.0, 0, 0, 0]]]).astype(npd)
    _close(getattr(tlie, name)(torch.as_tensor(q)), getattr(jlie, name)(jnp.asarray(q)), dt)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_lie_binary_functions(dt):
    npd, _ = DTYPES[dt]
    rng = np.random.default_rng(2)
    a, b = _quats(rng, 64).astype(npd), _quats(rng, 64).astype(npd)
    b[:8] = a[:8]  # near-parallel slerp branch
    v = rng.normal(size=(64, 3)).astype(npd)
    f = rng.uniform(0, 1, 64).astype(npd)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    _close(tlie.quat_mul(ta, tb), jlie.quat_mul(ja, jb), dt)
    _close(tlie.quat_rotate(ta, torch.as_tensor(v)), jlie.quat_rotate(ja, jnp.asarray(v)), dt)
    _close(tlie.quat_slerp(ta, tb, torch.as_tensor(f)), jlie.quat_slerp(ja, jb, jnp.asarray(f)), dt)
    _close(tlie.quat_angular_distance(ta, tb), jlie.quat_angular_distance(ja, jb), dt)
    m1 = tlie.exp_matrix(torch.as_tensor(v))
    m2 = tlie.quat_to_matrix(tb)
    _close(tlie.mat3_mul(m1, m2), jlie.mat3_mul(jnp.asarray(m1.numpy()), jnp.asarray(m2.numpy())), dt)
    _close(tlie.vec_mat3(torch.as_tensor(v), m2),
           jlie.vec_mat3(jnp.asarray(v), jnp.asarray(m2.numpy())), dt)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_spline(dt):
    npd, _ = DTYPES[dt]
    rng = np.random.default_rng(3)
    p = [rng.normal(size=(16, 3)).astype(npd) for _ in range(4)]
    s = rng.uniform(0, 1, 16).astype(npd)
    _close(tsp.cubic_bspline_approx(*map(torch.as_tensor, p), torch.as_tensor(s)),
           jsp.cubic_bspline_approx(*map(jnp.asarray, p), jnp.asarray(s)), dt)
    knots = [npd(0.0), npd(0.1), npd(0.25), npd(0.3)]
    q = np.asarray(0.17, npd)
    args_t = [x for pair in zip(knots, map(torch.as_tensor, p)) for x in pair]
    args_j = [x for pair in zip(knots, map(jnp.asarray, p)) for x in pair]
    _close(tsp.cubic_hermite(*args_t, q), jsp.cubic_hermite(*args_j, q), dt)
    samples = rng.normal(size=(12, 3)).astype(npd)
    qt = np.linspace(-0.1, 1.2, 40).astype(npd)
    st = np.linspace(0.0, 1.1, 12).astype(npd)
    vt, rt = tsp.fit_and_eval(torch.as_tensor(st), torch.as_tensor(samples), torch.as_tensor(qt))
    vj, rj = jsp.fit_and_eval(jnp.asarray(st), jnp.asarray(samples), jnp.asarray(qt))
    _close(vt, vj, dt)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_dfsum(dt):
    npd, _ = DTYPES[dt]
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(1024, 11)) * np.array([1, 10, 1e2, 1e3] * 2 + [1, 1, 1])).astype(npd)
    hi_t, lo_t = tdf.df_cumsum(torch.as_tensor(x), dim=0)
    hi_j, lo_j = jdf.df_cumsum(jnp.asarray(x), axis=0)
    # association order differs (log-step vs XLA's scan tree): compare the
    # double-float value hi + lo against the exact prefix in float64
    exact = np.cumsum(x.astype(np.float64), axis=0)
    err_t = np.abs(hi_t.numpy().astype(np.float64) + lo_t.numpy() - exact)
    err_j = np.abs(np.asarray(hi_j, np.float64) + np.asarray(lo_j) - exact)
    bound = 4 * np.finfo(npd).eps ** 2 * np.cumsum(np.abs(x.astype(np.float64)), axis=0) + 1e-300
    assert np.all(err_t <= np.maximum(bound, 4 * err_j)), np.max(err_t / bound)
    starts = rng.integers(0, 1024, 64)
    ends = np.minimum(starts + rng.integers(0, 300, 64), 1024)
    pt = tdf.df_prefix(torch.as_tensor(x))
    pj = jdf.df_prefix(jnp.asarray(x))
    got = tdf.df_range_sum(pt, torch.as_tensor(starts), torch.as_tensor(ends)).numpy()
    ref = np.asarray(jdf.df_range_sum(pj, jnp.asarray(starts), jnp.asarray(ends)))
    if dt == "float64":
        _close(got, ref, dt)
    else:
        # the in-block sums round in another order: both sides must sit within
        # the scheme's documented bound, ~eps * |block total| per channel
        exact = np.stack([x[s:e].astype(np.float64).sum(0) for s, e in zip(starts, ends)])
        block_abs = np.abs(x.astype(np.float64)).reshape(-1, 128, 11).sum(1).max(0)
        bound = 16 * np.finfo(np.float32).eps * block_abs
        assert np.all(np.abs(got - exact) <= bound)
        assert np.all(np.abs(ref - exact) <= bound)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_eigh3(dt):
    npd, _ = DTYPES[dt]
    rng = np.random.default_rng(5)
    a = rng.normal(size=(200, 3, 3))
    a = a @ np.swapaxes(a, 1, 2)
    a[:20] = np.diag([1.0, 1.0, 1e-4])  # repeated pair
    a[20:30] = np.eye(3) * 2.0          # fully degenerate
    a[30:40] = np.diag([1e-6, 0.5, 0.5]) + 1e-9
    a = a.astype(npd)
    vt, wt = teig.eigh3(torch.as_tensor(a))
    vj, wj = jeig.eigh3(jnp.asarray(a))
    _close(vt, vj, dt)
    _close(wt, wj, dt)
    lt, nt = teig.min_eigpair3(torch.as_tensor(a))
    lj, nj = jeig.min_eigpair3(jnp.asarray(a))
    _close(lt, lj, dt)
    _close(nt, nj, dt)


def test_voxel_keys_and_segments():
    rng = np.random.default_rng(6)
    cells = rng.integers(-(2**19), 2**19, size=(500, 3)).astype(np.int32)
    cells[:50] = cells[0]
    ht, lt = tvox.split_keys(torch.as_tensor(cells))
    hj, lj = jvox.split_keys(jnp.asarray(cells))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    keys = np.sort(rng.integers(0, 40, 300)).astype(np.int32)
    st, it = tvox.segment_ids_from_sorted_keys(torch.as_tensor(keys))
    sj, ij = jvox.segment_ids_from_sorted_keys(jnp.asarray(keys))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    n_seg = int(st.max()) + 1
    for cap in (n_seg, n_seg + 7):  # exact fit and absent trailing segments
        np.testing.assert_array_equal(
            tvox.segment_start_positions(st, it, cap).numpy(),
            np.asarray(jvox.segment_start_positions(sj, ij, cap)))


def test_voxel_keys_far_from_origin_unique():
    """Twin of tests/test_regimes.py::TestVoxelKeysFarFromOrigin: cells at
    +-520 m (0.2 m cells), +-100 km and the packing limit, with their
    neighbours along each axis, map to distinct (hi, lo) keys, equal to the
    JAX package's."""
    rng = np.random.default_rng(0)
    bases = np.array([[0, 0, 0], [2600, -2600, 2600], [500_000, -500_000, 1],
                      [(1 << 19) - 3, -(1 << 19) + 2, (1 << 19) - 3]], np.int32)
    offs = rng.integers(-1, 2, size=(64, 3)).astype(np.int32)
    cells = np.clip((bases[:, None, :] + offs[None, :, :]).reshape(-1, 3),
                    -(1 << 19), (1 << 19) - 1)
    hi, lo = tvox.split_keys(torch.as_tensor(cells))
    assert len(set(zip(hi.tolist(), lo.tolist()))) == len({tuple(c) for c in cells.tolist()})
    hj, lj = jvox.split_keys(jnp.asarray(cells))
    assert np.array_equal(hi.numpy(), np.asarray(hj)) and np.array_equal(lo.numpy(), np.asarray(lj))


def test_voxel_keys_keep_lexicographic_order():
    """Sorting by (hi, lo) equals sorting by (x, y, z) over the whole packing
    range: extraction needs equal cells contiguous after the two-key sort."""
    rng = np.random.default_rng(1)
    cells = rng.integers(-(1 << 19), 1 << 19, size=(512, 3)).astype(np.int32)
    hi, lo = tvox.split_keys(torch.as_tensor(cells))
    key64 = (hi.numpy().astype(np.int64) << 30) | lo.numpy().astype(np.int64)
    c = cells.astype(np.int64) + (1 << 19)
    np.testing.assert_array_equal(
        np.argsort(key64, kind="stable"),
        np.argsort((c[:, 0] << 40) | (c[:, 1] << 20) | c[:, 2], kind="stable"))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_rigid3(dt):
    npd, td = DTYPES[dt]
    rng = np.random.default_rng(11)
    qa, qb = _quats(rng, 8).astype(npd), _quats(rng, 8).astype(npd)
    ta, tb = rng.normal(size=(8, 3)).astype(npd), rng.normal(size=(8, 3)).astype(npd)
    pts = rng.normal(size=(8, 3)).astype(npd)
    ja, jb = jse3.Rigid3(jnp.asarray(qa), jnp.asarray(ta)), jse3.Rigid3(jnp.asarray(qb), jnp.asarray(tb))
    ta_, tb_ = (tse3.Rigid3(torch.as_tensor(q), torch.as_tensor(t)) for q, t in ((qa, ta), (qb, tb)))
    for got, ref in ((ta_ * tb_, ja * jb), (ta_.inverse(), ja.inverse())):
        _close(got.q.numpy(), ref.q, dt)
        _close(got.t.numpy(), ref.t, dt)
    _close(ta_.apply(torch.as_tensor(pts)).numpy(), ja.apply(jnp.asarray(pts)), dt)
    _close(ta_.matrix().numpy(), ja.matrix(), dt)
    m = ta_.matrix()
    _close(tse3.Rigid3.from_matrix(m, torch.as_tensor(ta)).q.numpy(),
           jse3.Rigid3.from_matrix(jnp.asarray(m.numpy()), jnp.asarray(ta)).q, dt)
    ident = tse3.Rigid3.identity((2,), td)
    assert torch.equal(ident.apply(torch.ones(2, 3, dtype=td)), torch.ones(2, 3, dtype=td))
    _close(tse3.Rigid3.rotation(torch.as_tensor(qa)).t.numpy(), np.zeros((8, 3)), dt)
    _close(tse3.Rigid3.translation(torch.as_tensor(ta)).q.numpy(),
           jse3.Rigid3.translation(jnp.asarray(ta)).q, dt)
