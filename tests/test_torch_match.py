"""The port's KNN bins (K2's plain version) and matcher against the JAX package.

- ``knn_bins_plain`` equals the Pallas kernel ``_knn_bins(mode="vpu")`` run in
  interpret mode, per bin: indices equal, values within 4 ulp. Both sum the
  squared differences one dimension at a time in f32, but XLA's CPU backend
  contracts each ``s + d * d`` into one FMA, which saves a rounding per
  dimension (<= 1/2 ulp each over 6 dimensions); the port rounds like the
  CUDA kernel (separate multiply and add), and the two agree bit for bit on
  the card (chip_smoke.py).
- ``knn_topk`` equals ``knn_topk_fused`` (the same bins + exact top-k).
- mxu scoring: ``knn_bins_mxu_plain`` against ``_knn_bins(mode="mxu")`` in
  interpret mode on the same augmented embedding, and ``knn_topk(mode="mxu")``
  against ``knn_topk_fused(mode="mxu")``. Both sides take f32 dot products of
  the embedding in different summation orders, so per (query, bin) the
  values agree within MXU_FACTOR * 2^-23 * (|q| + |t|)^2 at the winning
  targets (the bound chip_smoke.py holds the tensor-core kernel to), and an
  index may differ only where the two winners' exact squared distances lie
  within that bound. mxu and vpu top-10 sets agree on >= 99.5% of the
  candidates, as ``tests/test_knn_pallas.py`` asks of the JAX kernel.
- The exact path (``approx=False``) gives the same pair sets as
  ``match_surfels(approx=False)``, after validity masking.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from wildcat_slam_tpu.odometry.match import match_surfels as j_match
from wildcat_slam_tpu.ops.knn_pallas import _knn_bins, knn_topk_fused
from wildcat_slam_tpu_torch.odometry.match import match_surfels as t_match
from wildcat_slam_tpu_torch.ops import knn

torch.set_num_threads(1)

MXU_FACTOR = 16.0  # chip_smoke.py MXU_FACTOR


def _cloud(rng, n, spread=5.0):
    c = rng.uniform(-spread, spread, (n, 3))
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return np.concatenate([c, nrm / 0.0873], axis=1).astype(np.float32)


def _ulps(a, b):
    return np.max(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)))


def test_knn_bins_plain_matches_pallas_vpu():
    rng = np.random.default_rng(0)
    dt = _cloud(rng, 2048)
    dt[1500:] = knn.FAR  # masked targets, as the matcher produces
    dq = np.concatenate([dt[:128], _cloud(rng, 128)])
    vj, ij = _knn_bins(jnp.asarray(dq), jnp.asarray(dt.T), mode="vpu", n_dims=6, n_bins=512,
                       block_q=128, chunk_t=1024, interpret=True)
    vt, it = knn.knn_bins_plain(torch.as_tensor(dq), torch.as_tensor(dt), 512)
    assert _ulps(vt.numpy(), np.asarray(vj)) <= 4
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    # the wrapper takes the plain version for CPU tensors
    vw, iw = knn.knn_bins(torch.as_tensor(dq), torch.as_tensor(dt), 512)
    assert torch.equal(vw, vt) and torch.equal(iw, it)


@pytest.mark.parametrize("t_n", [300, 1000, 2048])  # one bin each, padded, exact fit
def test_knn_topk_matches_fused(t_n):
    rng = np.random.default_rng(t_n)
    dt = _cloud(rng, t_n)
    dq = _cloud(rng, 64)
    kj, dj = knn_topk_fused(jnp.asarray(dq), jnp.asarray(dt), 10, interpret=True)
    kt, d2 = knn.knn_topk(torch.as_tensor(dq), torch.as_tensor(dt), 10)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    assert _ulps(d2.numpy(), np.asarray(dj)) <= 4


def _mxu_gaps(dq, dt, vals, idx, vals_ref, idx_ref):
    """(worst value gap in units of 2^-23 (|q| + |t|)^2, index mismatches
    whose two winners are not within the bound of each other)."""
    dq, dt = dq.astype(np.float64), dt.astype(np.float64)
    qn = np.linalg.norm(dq, axis=1)[:, None]
    tn = np.linalg.norm(dt, axis=1)
    scale = np.maximum((qn + tn[idx]) ** 2, (qn + tn[idx_ref]) ** 2) * 2.0**-23
    ratio = np.max(np.abs(vals.astype(np.float64) - vals_ref) / scale)
    rows, cols = np.nonzero(idx != idx_ref)
    s1 = np.sum((dq[rows] - dt[idx[rows, cols]]) ** 2, 1)
    s2 = np.sum((dq[rows] - dt[idx_ref[rows, cols]]) ** 2, 1)
    return ratio, int(np.sum(np.abs(s1 - s2) > MXU_FACTOR * scale[rows, cols]))


def test_knn_bins_mxu_plain_matches_pallas_mxu():
    rng = np.random.default_rng(1)
    dt = _cloud(rng, 2048)
    dt[1500:] = knn.FAR
    dq = np.concatenate([dt[:128], _cloud(rng, 128)])
    dq_aug, dtt_aug = knn.mxu_embedding(torch.as_tensor(dq), torch.as_tensor(dt))
    vj, ij = _knn_bins(jnp.asarray(dq_aug.numpy()), jnp.asarray(dtt_aug.numpy()), mode="mxu",
                       n_dims=6, n_bins=512, block_q=128, chunk_t=1024, interpret=True)
    vt, it = knn.knn_bins_mxu_plain(dq_aug, dtt_aug, 512)
    ratio, far = _mxu_gaps(dq, dt, vt.numpy(), it.numpy(), np.asarray(vj), np.asarray(ij))
    assert ratio <= MXU_FACTOR and far == 0, (ratio, far)
    assert np.mean(it.numpy() == np.asarray(ij)) > 0.999
    # the wrapper takes the plain version for CPU tensors
    vw, iw = knn.knn_bins_mxu(dq_aug, dtt_aug, 512)
    assert torch.equal(vw, vt) and torch.equal(iw, it)


@pytest.mark.parametrize("t_n", [300, 1000, 2048])  # one bin each, padded, exact fit
def test_knn_topk_mxu_matches_fused(t_n):
    rng = np.random.default_rng(t_n + 1)
    dt = _cloud(rng, t_n)
    dq = _cloud(rng, 64)
    kj, dj = knn_topk_fused(jnp.asarray(dq), jnp.asarray(dt), 10, mode="mxu", interpret=True)
    kt, d2 = knn.knn_topk(torch.as_tensor(dq), torch.as_tensor(dt), 10, mode="mxu")
    ratio, far = _mxu_gaps(dq, dt, d2.numpy(), kt.numpy(), np.asarray(dj), np.asarray(kj))
    assert ratio <= MXU_FACTOR and far == 0, (ratio, far)


def test_mxu_vpu_modes_agree():
    rng = np.random.default_rng(5)
    dq = _cloud(rng, 128)
    dt = _cloud(rng, 700)
    a, da = knn.knn_topk(torch.as_tensor(dq), torch.as_tensor(dt), 10, n_bins=256, mode="mxu")
    b, db = knn.knn_topk(torch.as_tensor(dq), torch.as_tensor(dt), 10, n_bins=256)
    agree = np.mean([len(set(x) & set(y)) / 10.0 for x, y in zip(a.numpy(), b.numpy())])
    assert agree >= 0.995, agree
    np.testing.assert_allclose(da.numpy(), db.numpy(), rtol=1e-3, atol=1e-2)
    with pytest.raises(ValueError, match="mode"):
        knn.knn_topk(torch.as_tensor(dq), torch.as_tensor(dt), 10, mode="gram")
    with pytest.raises(ValueError, match="D <= 7"):  # the kernel's one depth-8 step
        knn.mxu_embedding(torch.zeros((4, 8)), torch.zeros((4, 8)))


def _surfels(rng, n, base=None):
    """Surfel centers on three planes with their normals; with ``base``,
    perturbed copies of those surfels (so most queries find partners)."""
    if base is None:
        axis = rng.integers(0, 3, n)
        c = rng.uniform(-3, 3, (n, 3))
        c[np.arange(n), axis] = rng.choice([-2.0, 2.0], n)
        nrm = np.eye(3)[axis]
    else:
        c = base[0] + rng.normal(scale=0.03, size=base[0].shape)
        nrm = base[1] + rng.normal(scale=0.01, size=base[1].shape)
    nrm = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    t = rng.uniform(0, 2.0, n)
    valid = rng.uniform(size=n) > 0.1
    return c, nrm, t, valid


@pytest.mark.parametrize("self_match", [True, False])
@pytest.mark.parametrize("dt", ["float64", "float32"])
def test_exact_pairs_match_jax(self_match, dt):
    npd = np.float64 if dt == "float64" else np.float32
    rng = np.random.default_rng(7)
    tgt = _surfels(rng, 384)
    qry = tgt if self_match else _surfels(rng, 384, base=tgt)
    kw = dict(k=10, max_pairs=200, self_match=self_match, approx=False)
    args = [a.astype(npd) if a.dtype != bool else a for a in (*qry, *tgt)]
    iq, it, v, nd = j_match(*map(jnp.asarray, args), **kw)
    tq, tt, tv, tnd = t_match(*map(torch.as_tensor, args), **kw)
    v = np.asarray(v)
    assert v.sum() > 50 and int(nd) > 0  # pairs found, and overflow counted
    np.testing.assert_array_equal(tv.numpy(), v)
    np.testing.assert_array_equal(tq.numpy()[v], np.asarray(iq)[v])
    np.testing.assert_array_equal(tt.numpy()[v], np.asarray(it)[v])
    assert int(tnd) == int(nd)
