"""The port's KNN bins (K2's plain version) and matcher against the JAX package.

- ``knn_bins_plain`` equals the Pallas kernel ``_knn_bins(mode="vpu")`` run in
  interpret mode, per bin: indices equal, values within 4 ulp. Both sum the
  squared differences one dimension at a time in f32, but XLA's CPU backend
  contracts each ``s + d * d`` into one FMA, which saves a rounding per
  dimension (<= 1/2 ulp each over 6 dimensions); the port rounds like the
  CUDA kernel (separate multiply and add), and the two agree bit for bit on
  the card (chip_smoke.py).
- ``knn_topk`` equals ``knn_topk_fused`` (the same bins + exact top-k).
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


def test_mxu_mode_rejected():
    with pytest.raises(NotImplementedError, match="mxu"):
        knn.knn_topk(torch.zeros(4, 6), torch.zeros(8, 6), 2, mode="mxu")


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
