"""The port's dense SPD solve (kernel K4's plain version, ``ops/spd.py``)
against the JAX package's LM step solve, ``jax.scipy.linalg.cho_factor``
then ``cho_solve``, on the CPU.

Inputs are made from a seed with numpy. The systems are a = G G^T / N + I
(eigenvalues in [1, ~5], so two factorisations that round differently stay
within a few ulps of the solution's scale): float64 within 1e-12 and
float32 within 1e-5 of the largest entry of the solution. An indefinite
system gives NaN everywhere in both. The plan that lays out the kernel's
launch, and the gate that holds the kernel to its plain version on a card
(``spd.accuracy``), are checked here too; the kernel itself runs only on a
card (``tests/test_torch_kernels.py``).
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp
import jax.scipy.linalg as jsl

from wildcat_slam_tpu_torch.ops import spd

TOL = {"float64": 1e-12, "float32": 1e-5}
INDEFINITE = np.array([[3.5, 2.0, 0.0], [2.0, 0.5, 0.0], [0.0, 0.0, 2.5]])


def _system(n, m, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(n, n))
    return g @ g.T / n + np.eye(n), rng.normal(size=(n, m))


def _jax_solve(a, b):
    return np.asarray(jsl.cho_solve(jsl.cho_factor(jnp.asarray(a)), jnp.asarray(b)))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n,m", [(12, 1), (12, 6), (96, 1), (96, 6), (576, 1), (576, 6)])
def test_spd_solve_matches_jax_cho_solve(n, m, dtype):
    a, b = _system(n, m, seed=n + m)
    a, b = a.astype(dtype), b.astype(dtype)
    want = _jax_solve(a, b)
    a_t = torch.as_tensor(a)
    a_t = a_t + torch.triu(torch.full_like(a_t, float("nan")), 1)  # only the lower triangle is read
    got = spd.spd_solve(a_t, torch.as_tensor(b))
    assert got.dtype == getattr(torch, dtype) and got.shape == (n, m)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL[dtype] * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_spd_solve_gives_nan_on_an_indefinite_system(dtype):
    """The factorisation fails at the second pivot (0.5 - 2^2 / 3.5 < 0):
    JAX's cho_factor and the port both give NaN everywhere, where the
    library's partial factor alone would give a finite x."""
    a, b = INDEFINITE.astype(dtype), np.array([[1.0], [2.0], [3.0]], dtype)
    assert np.all(np.isnan(_jax_solve(a, b)))
    got = spd.spd_solve(torch.as_tensor(a), torch.as_tensor(b))
    assert got.shape == (3, 1) and bool(torch.all(torch.isnan(got)))
    chol, info = torch.linalg.cholesky_ex(torch.as_tensor(a))
    assert int(info) == 2 and bool(torch.all(torch.isfinite(torch.cholesky_solve(
        torch.as_tensor(b), chol))))


def test_spd_plan_states_its_limits():
    """The launch at the main path's shapes, and what it refuses."""
    fit = spd.plan(96, 6, 4)  # the spline fit: one block
    assert fit.grid == 1 and fit.tiles == 3
    lm = spd.plan(1152, 1, 8)  # the damped LM system at S = 96
    assert lm.tiles == 36 and 1 < lm.grid <= spd.H100_SMS
    assert lm.grid == -(-spd.work_items(36, 1) // spd.WARPS)
    assert lm.smem_bytes == spd.WARPS * (3 * 32 * 34 + 32) * 8  # 210944 bytes
    assert lm.workspace == (1152 + 32) * 1152 + 36 * (32 * 32 + 32)
    assert spd.work_items(36, 0) == 37 and spd.work_items(36, 35) == 2
    for args in ((96, 33, 4), (0, 1, 4), (12, 1, 2)):
        with pytest.raises(ValueError):
            spd.plan(*args)
    assert spd.supports(12 * 96, 1, torch.float64) and spd.supports(96, 6, torch.float32)
    assert not spd.supports(30000, 1, torch.float64) and spd.supports(30000, 1, torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        spd.plan(30000, 1, 8)
    with pytest.raises(ValueError):
        spd.spd_solve(torch.zeros((4, 4)), torch.zeros((4, 1), dtype=torch.float64))


def test_spd_probe_cuts_what_it_names():
    """python -m wildcat_slam_tpu_torch.probe_spd times K4 against text edits
    of its source: each edit must find its one mark in the current
    csrc/spd_solve.cu and change only that."""
    from wildcat_slam_tpu_torch import probe_spd as probe

    src = (Path(spd.__file__).resolve().parent.parent / "csrc" / "spd_solve.cu").read_text()
    out = probe.variants(src)
    assert out["kernel"] == src and set(out) == {"kernel", *probe.CUTS}
    for name, (mark, cut) in probe.CUTS.items():
        assert out[name] != src and out[name].count(cut) == src.count(cut) + 1
    with pytest.raises(RuntimeError, match="no longer has"):
        probe.variants(src.replace(probe.CUTS["no_chol"][0], ""))


def _blocked_cholesky(a, skip=None, tile=32):
    """Right-looking blocked Cholesky in numpy, K4's order of panels; ``skip``
    = (k, i, j) leaves out panel k's update of tile (i, j)."""
    w = np.tril(a).copy()
    tiles = a.shape[0] // tile
    for k in range(tiles):
        kk = slice(k * tile, (k + 1) * tile)
        w[kk, kk] = np.linalg.cholesky(w[kk, kk])
        for i in range(k + 1, tiles):
            ii = slice(i * tile, (i + 1) * tile)
            w[ii, kk] = np.linalg.solve(w[kk, kk], w[ii, kk].T).T
        for j in range(k + 1, tiles):
            for i in range(j, tiles):
                if skip != (k, i, j):
                    ii, jj = slice(i * tile, (i + 1) * tile), slice(j * tile, (j + 1) * tile)
                    w[ii, jj] -= w[ii, kk] @ w[jj, kk].T
    return np.tril(w)


def test_spd_accuracy_gate_catches_one_tile_left_out():
    """The card's gate on K4 (``spd.accuracy``, held in chip_smoke.py and the
    gpu tests): at the LM system's N = 1152 in float32, a solve through a
    factor with panel 0's update of the last diagonal tile left out stays
    inside the backward-error bound 10 N eps but leaves the forward-gap bound
    100 kappa eps; a sound solve (float64, rounded) passes both."""
    a64, b64 = _system(1152, 1, 1153)
    a, b = torch.as_tensor(a64, dtype=torch.float32), torch.as_tensor(b64, dtype=torch.float32)
    ref = spd.spd_solve_plain(a, b)
    sound = spd.accuracy(a, b, torch.as_tensor(np.linalg.solve(a64, b64),
                                               dtype=torch.float32), ref)
    assert sound["ok"] and sound["kappa"] < 6 and sound["forward"] < 0.1 * sound["forward_bound"]
    lower = _blocked_cholesky(a64, skip=(0, 35, 35))
    x = np.linalg.solve(lower.T, np.linalg.solve(lower, b64))
    cut = spd.accuracy(a, b, torch.as_tensor(x, dtype=torch.float32), ref)
    assert cut["backward"] <= cut["backward_bound"] and cut["forward"] > 10 * cut["forward_bound"]
    assert not cut["ok"]
