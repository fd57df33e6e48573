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
    """The launch at the main path's shapes, at the one-block limit, and what
    the plan refuses."""
    fit = spd.plan(96, 6, 4)  # the spline fit: one block, the system in its shared memory
    assert fit.one_block and (fit.grid, fit.warps, fit.tiles) == (1, spd.ONE_BLOCK_WARPS, 3)
    assert fit.smem_bytes == ((6 + 3 + 1) * 32 * 36 + (3 + 4) * 32) * 4  # 46976 bytes
    assert spd.one_block_limit(4) == 256 and spd.one_block_limit(8) == 160
    for itemsize, limit in ((4, 256), (8, 160)):
        assert spd.plan(limit, 1, itemsize).one_block and not spd.plan(limit + 1, 1, itemsize).one_block
        assert spd.plan(limit, 32, itemsize).smem_bytes <= spd.H100_SMEM_PER_BLOCK
    lm = spd.plan(1152, 1, 8)  # the damped LM system at S = 96: the tile dataflow
    assert not lm.one_block and lm.tiles == 36 and spd.items(36) == 667
    assert (lm.grid, lm.warps) == (spd.H100_SMS, 6)  # an item a warp, 132 x 6 >= 667
    assert lm.smem_bytes == 6 * (4 * 32 * 36 + 5 * 32) * 8  # 228864 bytes
    assert lm.workspace == (666 + 72) * 1024 + 36 * 32 + (36 + 666) * 32
    assert lm.flags == 2 * (666 + 36)
    assert spd.plan(1152, 1, 4).warps == 6 and spd.plan(3072, 1, 4).warps == spd.MAX_WARPS
    assert spd.launch_args(lm) == (0, lm.grid, lm.warps, 36, lm.smem_bytes)
    for args in ((96, 33, 4), (0, 1, 4), (12, 1, 2), (spd.MAX_N + 1, 1, 4)):
        with pytest.raises(ValueError):
            spd.plan(*args)
    assert spd.supports(12 * 96, 1, torch.float64) and spd.supports(96, 6, torch.float32)
    assert spd.supports(30000, 1, torch.float64) and spd.supports(spd.MAX_N, 32, torch.float64)
    assert not spd.supports(spd.MAX_N + 1, 1, torch.float32) and not spd.supports(96, 33, torch.float32)
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
    assert set(probe.CUTS) == {"no_backsub", "no_chol", "no_update", "no_flags", "no_trsm",
                               "one_tile"}
    for name, edits in probe.CUTS.items():
        assert out[name] != src
        for mark, cut in edits:
            assert src.count(mark) == 1 and out[name].count(cut) == src.count(cut) + 1
    with pytest.raises(RuntimeError, match="no longer has"):
        probe.variants(src.replace(probe.CUTS["no_chol"][0][0], ""))
    stamped = probe.traced(src)  # --trace: its stamps find their marks too
    assert stamped.count("g_trace[") == sum(r.count("g_trace[") for _, r in probe.TRACE)


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


def _item_tile(t, tiles):
    """Work item t of K4's tile dataflow (csrc/spd_solve.cu, item_tile), by
    column: the diagonal tile j (with (j, j - 1)), the tiles (i, j) for
    i >= j + 2, then b^T's tile j (i = tiles)."""
    j = 0
    while True:
        count = tiles - j if j <= tiles - 2 else 2
        if t < count:
            return (j, j) if t == 0 else ((tiles, j) if t == count - 1 else (j + 1 + t, j))
        t -= count
        j += 1


class _Dataflow:
    """A model of K4's tile dataflow (csrc/spd_solve.cu, spd_tiles): item t
    to warp t mod G, each warp's steps in the kernel's order (factor_item for
    its items in order, then back_substitute for them in reverse), each step's
    flag waits, and its arithmetic in numpy. ``run`` interleaves the warps in
    turn, each as far as its waits allow; a read of a published tile whose
    flag is not set fails, and so does a run in which some warp never
    finishes (a deadlock)."""

    def __init__(self, a, b, grid, warps):
        self.tiles = -(-a.shape[0] // 32)
        n, pad = a.shape[0], 32 * self.tiles
        self.a = np.eye(pad)
        self.a[:n, :n] = np.tril(a)
        self.bt = np.zeros((32, pad))
        self.bt[:b.shape[1], :n] = b.T
        self.m, self.count = b.shape[1], grid * warps
        self.flags, self.applied, self.log = {}, {}, []

    def _tile(self, i, j):
        if i == self.tiles:
            return self.bt[:, 32 * j:32 * j + 32].copy()
        return self.a[32 * i:32 * i + 32, 32 * j:32 * j + 32].copy()

    def _read(self, key):
        assert key in self.flags, f"{key} read before its flag is set"
        return self.flags[key]

    def _publish(self, warp, key, value):
        self.flags[key] = value
        self.log.append((warp, key))

    def _factor(self, warp, i, j):
        diag = i == j
        aj = j - 1 if diag else j
        A = self._tile(i, aj) if aj >= 0 else None
        B = self._tile(i, i) if diag else None
        for k in range(aj):
            yield [("L", i, k), ("L", aj, k)]
            li, lj = self._read(("L", i, k)), self._read(("L", aj, k))
            A -= li @ lj.T
            self.applied.setdefault((i, aj), []).append(k)
            if diag:
                B -= li @ li.T
                self.applied.setdefault((i, i), []).append(k)
        if aj >= 0:
            yield [("L", aj, aj)]
            A = np.linalg.solve(self._read(("L", aj, aj)), A.T).T
            self._publish(warp, ("L", i, aj), A)
            if diag:  # the look-ahead: the just-solved tile's update, no wait before it
                B -= A @ A.T
                self.applied.setdefault((i, i), []).append(aj)
        if diag:
            self._publish(warp, ("L", i, i), np.linalg.cholesky(B))

    def _back(self, warp, i, k):
        P, m = self.tiles, self.m
        if i != k:
            if i == k + 2 or i == P:
                return
            yield [("X", i)]
            self._publish(warp, ("C", i, k), self._read(("L", i, k)).T @ self._read(("X", i)))
            return
        yield [("L", P, k)]
        r = self._read(("L", P, k))[:m].T.copy()
        for i2 in range(P - 1, k + 2, -1):
            yield [("C", i2, k)]
            r -= self._read(("C", i2, k))
        for i2 in range(min(k + 2, P - 1), k, -1):
            yield [("L", i2, k)]
            yield [("X", i2)]
            r -= self._read(("L", i2, k)).T @ self._read(("X", i2))
        self._publish(warp, ("X", k), np.linalg.solve(self._read(("L", k, k)).T, r))

    def _program(self, warp):
        mine = [_item_tile(t, self.tiles) for t in range(warp, self.tiles * (self.tiles + 1) // 2 + 1,
                                                        self.count)]
        for i, j in mine:
            yield from self._factor(warp, i, j)
        for i, j in reversed(mine):
            yield from self._back(warp, i, j)

    def run(self, order):
        progs = {w: self._program(w) for w in order}
        waits = {w: next(progs[w], None) for w in order}
        while any(waits[w] is not None for w in order):
            progress = False
            for w in order:
                while waits[w] is not None and all(key in self.flags for key in waits[w]):
                    waits[w] = next(progs[w], None)
                    progress = True
            assert progress, "the dataflow deadlocked"
        x = np.concatenate([self.flags[("X", k)] for k in range(self.tiles)])
        return x


@pytest.mark.parametrize("n,m,grid,warps,reverse", [
    (1152, 1, spd.H100_SMS, 6, False),  # the LM system's plan: an item a warp
    (1152, 1, 8, 2, True),              # 16 warps: ~42 items each
    (300, 6, 4, 2, False),              # a ragged last tile, 7 items a warp
])
def test_spd_dataflow_schedule(n, m, grid, warps, reverse):
    """K4's tile dataflow as a numpy model, the warps interleaved in turn:
    every tile takes each panel's update exactly once, in the order k = 0, 1,
    ...; no published tile is read before its flag is set; no warp waits
    between publishing (d, d - 1) and (d, d) (the look-ahead); the factor
    equals the blocked right-looking Cholesky's (within 1e-12 in float64:
    the same operations, numpy's products of strided and of contiguous tiles
    may round apart) and x solves the system."""
    a, b = _system(n, m, seed=n)
    model = _Dataflow(a, b, grid, warps)
    P = model.tiles
    assert spd.plan(n, m, 4).tiles == P
    if grid == spd.H100_SMS:
        assert spd.plan(n, m, 4)[1:3] == (grid, warps)
    order = list(range(grid * warps))
    x = model.run(order[::-1] if reverse else order)
    for i in range(P + 1):
        for j in range(min(i, P - 1) + 1):
            assert model.applied.get((i, j), []) == list(range(j)), (i, j)
    pad = np.eye(32 * P)
    pad[:n, :n] = a
    want = _blocked_cholesky(pad)
    got = np.zeros_like(want)
    for i in range(P):
        for j in range(i + 1):
            got[32 * i:32 * i + 32, 32 * j:32 * j + 32] = model.flags[("L", i, j)]
    np.testing.assert_allclose(np.tril(got), want, rtol=0, atol=1e-12)
    for d in range(1, P):
        warp, at = next((w, t) for t, (w, key) in enumerate(model.log) if key == ("L", d, d - 1))
        assert model.log[at + 1] == (warp, ("L", d, d))
    np.testing.assert_allclose(x[:n], np.linalg.solve(a, b), rtol=0, atol=1e-9)
