"""The sweep as one device program: what the CPU can hold of it.

- No host sync in the sweep body: a ``TorchDispatchMode`` counts
  ``aten._local_scalar_dense`` (what ``.item()``, ``bool()`` and
  ``.tolist()`` dispatch to) and ``aten.lift_fresh`` (``torch.tensor`` of
  host data) over one ``process_sweep`` after a warm-up sweep: every host
  read comes from a loop decision of a plain version (the eager LM loop,
  the plain self-match), nothing is copied from the host,
  no op makes a tensor whose shape depends on values (``nonzero``, a
  boolean mask as an index), and no library solve runs. A stream capture
  refuses the first three, and a library solve's allocation inside a
  capture breaks the composed graph, so a new one in the body fails here.
- K3's plain version (``ops/self_match.self_match_plain``) against the JAX
  ``match_surfels(self_match=True)`` on chain-heavy candidate lists (each
  query's partner depends on the one before, so the fixed point needs as
  many rounds as the chains are long): pairs equal.
- The trajectory after the sync-free rewrite against the JAX package's on
  one shared run (float64, exact KNN): within 1e-6 m / 1e-6, the bound of
  ``tests/test_torch_pipeline.py``; the spline fit's plain-op solve of the
  normal equations against the JAX fit (float64 within 1e-12, float32
  within 1e-5, relative to the largest control point).
- On the card ``LidarOdometry`` captures the sweep and raises when the
  capture fails: with the capture mocked to raise, the error reaches the
  caller and the sweep does not run eagerly.
- The graph module's host parts: the feed buffer's packing, the state
  write-back with aliased fields, the launch counts of replays, K3's plan.
"""

import collections
import dataclasses
import traceback

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from torch.utils._python_dispatch import TorchDispatchMode

import wildcat_slam_tpu.odometry.match as j_match_mod
from wildcat_slam_tpu.config import WildcatConfig as JaxConfig
from wildcat_slam_tpu.odometry.pipeline import LidarOdometry as JaxOdometry
from wildcat_slam_tpu_torch.cli import feed_events, synthetic_events
from wildcat_slam_tpu_torch.config import WildcatConfig
from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence
from wildcat_slam_tpu_torch.odometry import graph as graph_mod
from wildcat_slam_tpu_torch.odometry import match as t_match_mod
from wildcat_slam_tpu_torch.odometry import pipeline
from wildcat_slam_tpu_torch.odometry.pipeline import WindowState
from wildcat_slam_tpu_torch.ops import imu_factor, knn, pcg, spd, surfel_extract, surfel_factor
from wildcat_slam_tpu_torch.ops import self_match as sm

torch.set_num_threads(1)

TINY = dict(max_points_per_sweep=2048, max_surfels_per_sweep=128, max_surfels_sliding=256,
            max_surfels_fixed=256, max_correspondences=256, max_leaves_per_sweep=512,
            max_imu_states=256, max_sample_states=16, inner_iter_num_max=6,
            sliding_window_duration=0.5)
PARITY = dict(TINY, dtype="float64", match_knn_approx=False)
# the functions whose host reads are the plain versions' loop decisions on
# CPU tensors (on a card the plain PCG takes its exit on the device)
PLAIN_DECISIONS = {"lm_loop_eager", "self_match_plain", "pcg_solve_plain"}
# factorisations and triangular solves: on the card their cuBLAS/cuSOLVER
# calls may allocate stream-ordered memory inside a capture, which the
# composed sweep graph's child nodes cannot hold (odometry/graph.py); only a
# plain version that a card never runs may make them (K4 runs there instead)
PLAIN_SOLVES = {"spd_solve_plain"}
LIBRARY_SOLVES = {"linalg_solve", "_linalg_solve_ex", "linalg_solve_ex", "linalg_lu_factor_ex",
                  "linalg_lu_solve", "lu_solve", "triangular_solve", "linalg_solve_triangular",
                  "linalg_cholesky_ex", "cholesky_solve", "linalg_inv_ex", "_linalg_check_errors"}


def _events():
    return list(synthetic_events(SyntheticSequence(duration=1.6, points_per_scan=1500,
                                                   room_half=4.0, seed=0)))


class _HostReads(TorchDispatchMode):
    """Counts host reads and host-data tensors by the port function that
    made them."""

    def __init__(self):
        super().__init__()
        self.reads = collections.Counter()
        self.lifted = collections.Counter()
        self.shaped = collections.Counter()  # outputs whose shape depends on values
        self.solves = collections.Counter()  # library solves (cuBLAS/cuSOLVER on the card)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        kind = None
        if name == "_local_scalar_dense":
            kind = self.reads
        elif name in ("lift_fresh", "lift_fresh_copy"):
            kind = self.lifted
        elif name in ("nonzero", "masked_select", "_unique2", "unique_dim",
                      "unique_consecutive", "repeat_interleave", "masked_scatter"):
            kind = self.shaped
        elif name in ("index", "index_put_", "index_put", "_index_put_impl_") and any(
                isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
                for i in args[1] if i is not None):
            kind = self.shaped  # a boolean mask as an index: a nonzero inside
        elif name in LIBRARY_SOLVES:
            kind = self.solves
        if kind is not None:
            frames = [f for f in traceback.extract_stack() if "wildcat_slam_tpu_torch" in f.filename]
            kind[frames[-1].name if frames else "?"] += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def jax_traj():
    """The JAX package's trajectory on the parity config: the one shared run."""
    lo = JaxOdometry(JaxConfig(**PARITY))
    feed_events(lo, _events())
    return lo.trajectory


def test_sweep_body_reads_nothing_on_the_host():
    cfg = WildcatConfig(**TINY)
    lo = pipeline.LidarOdometry(cfg, device="cpu")
    modes = []
    real = pipeline.process_sweep

    def watched(*a, **kw):
        m = _HostReads()
        with m:
            out = real(*a, **kw)
        modes.append(m)
        return out

    pipeline.process_sweep = watched
    try:
        feed_events(lo, _events(), until_sweep=3)
    finally:
        pipeline.process_sweep = real
    assert lo.sweep_id == 3
    for m in modes[1:]:  # after the warm-up sweep (which fills the device constants)
        assert not m.lifted, dict(m.lifted)
        assert not m.shaped, dict(m.shaped)
        assert set(m.solves) <= PLAIN_SOLVES and m.solves["spd_solve_plain"] > 0, dict(m.solves)
        assert set(m.reads) <= PLAIN_DECISIONS, dict(m.reads)
        # each plain loop decided at least once: the LM loop, the self-match, the PCG
        assert set(m.reads) == PLAIN_DECISIONS, dict(m.reads)


def _chain_inputs(q, k, seed):
    """Surfels that all pass the geometric filters with each other (one
    centre, one normal, times 0.1 s apart), 10% invalid, and candidate lists
    with chains written in (the adversarial inputs of chip_smoke's K3 check)."""
    rng = np.random.default_rng(seed)
    cand = rng.integers(0, q, size=(q, k))
    start = 0
    for n in (40, 25, 25, 12):
        for j in range(n):
            a = start + j
            row = [a + 1] if j == 0 else [a - 1, a + 1]
            cand[a] = row + [cand[a, len(row)]] * (k - len(row))
        start += n + 1
    c = np.zeros((q, 3))
    nrm = np.tile([0.0, 0.0, 1.0], (q, 1))
    t = 0.1 * np.arange(q)
    valid = rng.uniform(size=q) > 0.1
    valid[:start] = True
    return cand, (c, nrm, t, valid)


def test_self_match_plain_matches_jax_on_chains(monkeypatch):
    q, k = 331, 10
    cand, (c, nrm, t, valid) = _chain_inputs(q, k, 5)
    monkeypatch.setattr(j_match_mod, "knn_search", lambda *a, **kw: (
        jnp.asarray(cand, jnp.int32), jnp.zeros((q, k))))
    monkeypatch.setattr(t_match_mod, "knn_search", lambda *a, **kw: (
        torch.as_tensor(cand), torch.zeros((q, k), dtype=torch.float64)))
    args = (c, nrm, t, valid) * 2
    kw = dict(k=k, max_pairs=q, self_match=True)
    iq, it, v, nd = j_match_mod.match_surfels.__wrapped__(*map(jnp.asarray, args), **kw)
    tq, tt, tv, tnd = t_match_mod.match_surfels(*map(torch.as_tensor, args), **kw)
    ok = torch.as_tensor(valid[cand] & valid[:, None] & (cand != np.arange(q)[:, None]))
    _, rounds = sm.self_match_plain(torch.as_tensor(cand), ok, q)
    assert int(rounds) > 30  # the chains make the fixed point take many rounds
    v = np.asarray(v)
    assert v.sum() > q // 2
    np.testing.assert_array_equal(tv.numpy(), v)
    np.testing.assert_array_equal(tq.numpy()[v], np.asarray(iq)[v])
    np.testing.assert_array_equal(tt.numpy()[v], np.asarray(it)[v])
    assert int(tnd) == int(nd)


def test_trajectory_matches_jax(jax_traj):
    lo = pipeline.LidarOdometry(WildcatConfig(**PARITY), device="cpu")
    feed_events(lo, _events())
    traj = lo.trajectory
    assert len(traj) == len(jax_traj) >= 3
    for (t1, p1, q1), (t2, p2, q2) in zip(traj, jax_traj):
        assert t1 == t2
        np.testing.assert_allclose(p1, p2, rtol=0, atol=1e-6)
        np.testing.assert_allclose(q1, q2, rtol=0, atol=1e-6)


def test_refused_capture_raises_and_runs_nothing_eagerly(monkeypatch):
    """The card's path, on the CPU: the first sweep runs eagerly, the second
    captures; the capture is mocked to raise, and the error reaches the
    caller without the sweep being run some other way."""
    lo = pipeline.LidarOdometry(WildcatConfig(**TINY), device="cpu")
    lo._use_graph = True  # the card's dispatch: warm-up, capture, replay
    calls = []
    real = pipeline.process_sweep

    def counted(*a, **kw):
        calls.append(kw.get("lm_loop"))
        return real(*a, **kw)

    class Refused(graph_mod.SweepGraph):
        def __init__(self, *a, **kw):
            raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(pipeline, "process_sweep", counted)
    monkeypatch.setattr(graph_mod, "SweepGraph", Refused)
    with pytest.raises(RuntimeError, match="stream is capturing"):
        feed_events(lo, _events())
    assert lo.sweep_id == 1 and calls == [None]  # only the eager warm-up sweep ran
    assert len(lo.trajectory) == 1


def test_graph_replays_each_sweep_from_static_buffers(monkeypatch):
    """The card's dispatch on the CPU with a stand-in graph that runs the
    captured function on its static buffers at every replay: the frontend
    warms up, captures once, then replays, and gives the eager trajectory."""
    cfg = WildcatConfig(**TINY)
    ref = pipeline.LidarOdometry(cfg, device="cpu")
    feed_events(ref, _events())
    made = []

    class Replayed:
        def __init__(self, sweep, state, feed):
            self.sweep, self.feed = sweep, feed
            self.state = graph_mod._clone_state(state)
            made.append(self)

        def replay(self):
            new, out = self.sweep(self.state, *self.feed, lm_loop=None)
            graph_mod._write_back(self.state, new)
            return out

    monkeypatch.setattr(graph_mod, "SweepGraph", Replayed)
    lo = pipeline.LidarOdometry(cfg, device="cpu")
    lo._use_graph = True
    feed_events(lo, _events())
    assert len(made) == 1 and lo.state is made[0].state
    for (t1, p1, q1), (t2, p2, q2) in zip(lo.trajectory, ref.trajectory, strict=True):
        assert t1 == t2 and np.array_equal(p1, p2) and np.array_equal(q1, q2)
    lo.state = graph_mod._clone_state(lo.state)  # a new state drops the graph
    assert lo._graph is None


@pytest.mark.parametrize("slots", [1, 3])
def test_feed_buffer_packs_every_array(slots):
    cfg = WildcatConfig(**TINY)
    lo = pipeline.LidarOdometry(cfg, device="cpu")
    rng = np.random.default_rng(slots)
    template = lo.noop_feed()
    feeds = [tuple(np.asarray(rng.normal(size=np.shape(a)) * 100).astype(np.asarray(a).dtype)
                   for a in template) for _ in range(slots)]
    buf = graph_mod.FeedBuffer(template, "cpu", slots=slots)
    for _ in range(2):  # both host buffers in turn
        buf.put(feeds)
        for s in range(slots):
            for got, want in zip(buf.views[s], feeds[s], strict=True):
                assert got.shape == np.shape(want)
                np.testing.assert_array_equal(got.numpy(), want)
    buf.to_slot0(slots - 1)
    for got, want in zip(buf.views[0], feeds[-1]):
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        buf.put([template] * (slots + 1))


def test_write_back_handles_aliased_fields():
    """A new state whose fields are the static buffers themselves, or other
    static buffers (here two swapped): every field gets its new value."""
    cfg = WildcatConfig(**TINY)
    static = WindowState.empty(cfg, torch.float64, "cpu")
    rng = np.random.default_rng(0)
    for t in (static.sld.center, static.fix.center, static.sample.pos):
        t.copy_(torch.as_tensor(rng.normal(size=tuple(t.shape))))
    sld_c, fix_c, pos = static.sld.center.clone(), static.fix.center.clone(), static.sample.pos
    new = static.replace(sld=static.sld.replace(center=static.fix.center),
                         fix=static.fix.replace(center=static.sld.center))
    graph_mod._write_back(static, new)
    assert torch.equal(static.sld.center, fix_c) and torch.equal(static.fix.center, sld_c)
    assert static.sample.pos is pos  # a field that is its own static buffer stays


def test_launches_count_replays_not_captures():
    graph_mod.reset_counts()
    # 1, 2, 1, 0, 2 and 1 eager; the rest captured
    pcg.LAUNCHES, knn.LAUNCHES, sm.LAUNCHES, spd.LAUNCHES = 3, 4, 2, 1
    imu_factor.LAUNCHES, surfel_factor.LAUNCHES, surfel_extract.LAUNCHES = 5, 3, 4
    graph_mod.CAPTURED.update(pcg=2, knn=2, self_match=1, spd=1, imu_factor=3, surfel_factor=2,
                              surfel_extract=2)
    # what the replays' adds leave in a device's counter (pcg, knn, knn_mxu,
    # self_match, spd, imu_factor, surfel_factor, surfel_extract)
    graph_mod.replay_counter(torch.device("cpu")).add_(torch.tensor([10, 8, 0, 4, 6, 9, 7, 6]))
    assert graph_mod.launches() == dict(pcg=11, knn=10, knn_mxu=0, self_match=5, spd=6,
                                        imu_factor=11, surfel_factor=8, surfel_extract=8)
    graph_mod.reset_counts()
    assert graph_mod.launches() == dict(pcg=0, knn=0, knn_mxu=0, self_match=0, spd=0,
                                        imu_factor=0, surfel_factor=0, surfel_extract=0)


def test_self_match_plan_states_its_limit():
    p = sm.plan(8192, 10)  # two 16-bit partner buffers, then 11 list rows of 8194 16-bit slots
    assert sm.list_stride(8192) == 8194 and sm.list_stride(1001) == 1026
    assert p.threads == sm.THREADS and p.smem_bytes == 4 * 8192 + 2 * 8194 * 11
    assert p.shared_lists
    assert sm.supports(8192, 10) and sm.supports(35000, 10)
    assert sm.plan(35000, 10) == (sm.THREADS, 4 * 35000, False)  # the lists in a global scratch
    assert sm.supports(58112, 1) and not sm.supports(58113, 1)
    with pytest.raises(ValueError, match="shared memory"):
        sm.plan(58113, 10)
    with pytest.raises(ValueError):
        sm.self_match(torch.zeros((4, 3), dtype=torch.int32), torch.zeros((4, 3), dtype=torch.bool), 4)


def test_cholesky_refused_for_the_card(monkeypatch):
    """linear_solver='cholesky' runs on kernel K4 in float32 and float64, so
    the card takes both; float64 with linear_solver='pcg' (K1 is float32
    only) and a system K4's plan cannot take (N = 12 S above its 65536) are
    refused before anything is placed there (the card stood in for by
    is_available). The CPU runs both."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for dtype in ("float32", "float64"):
        pipeline.check_card_config(WildcatConfig(**TINY, linear_solver="cholesky", dtype=dtype))
    with pytest.raises(ValueError, match="K1"):
        pipeline.LidarOdometry(WildcatConfig(**TINY, dtype="float64"), device="cuda")
    assert spd.supports(12 * 2500, 1, torch.float64)  # N = 30000: the tile dataflow takes it
    big = spd.MAX_N // 12 + 1  # N = 65544
    assert not spd.supports(12 * big, 1, torch.float64) and spd.supports(big, 6, torch.float64)
    with pytest.raises(ValueError, match="K4"):
        pipeline.check_card_config(WildcatConfig(**dict(TINY, max_sample_states=big),
                                                 linear_solver="cholesky", dtype="float64"))
    for dtype in ("float32", "float64"):
        pipeline.LidarOdometry(WildcatConfig(**TINY, linear_solver="cholesky", dtype=dtype),
                               device="cpu")


@pytest.mark.parametrize("dtype,count,tol", [
    ("float64", 1, 1e-12), ("float64", 2, 1e-12), ("float64", 9, 1e-12), ("float64", 16, 1e-12),
    ("float32", 9, 1e-5), ("float32", 16, 1e-5)])
def test_spline_fit_matches_jax(dtype, count, tol):
    """The correction spline's control points: (N^T N) Q = N^T p solved by
    ``ops/spd.spd_solve`` (K4's plain version on the CPU) against the JAX
    fit's library solve, at live counts from one state to the full
    capacity."""
    from wildcat_slam_tpu.odometry import corrections as j_cor
    from wildcat_slam_tpu.odometry.states import SampleStates as JaxSamples
    from wildcat_slam_tpu_torch.odometry import corrections as t_cor
    from wildcat_slam_tpu_torch.odometry.states import SampleStates

    s = 16
    rng = np.random.default_rng(count)
    cor = (rng.normal(size=(s, 12)) * 1e-2).astype(dtype)
    t_sample = SampleStates.empty(s, getattr(torch, dtype), "cpu").replace(
        cor=torch.as_tensor(cor), count=torch.tensor(count))
    j_sample = dataclasses.replace(JaxSamples.empty(s, jnp.dtype(dtype)), cor=jnp.asarray(cor),
                                   count=jnp.asarray(count, jnp.int32))
    want = np.asarray(j_cor.fit_correction_spline(j_sample), np.float64)
    got = t_cor.fit_correction_spline(t_sample).numpy().astype(np.float64)
    assert got.dtype == np.float64 and got.shape == want.shape == (s, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())
    np.testing.assert_array_equal(got[count:], 0.0)  # the identity rows hold zero targets
