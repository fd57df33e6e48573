"""The recorded JAX runs of ``tests/torch_reference/`` and the first sweeps
of the 50 s room at the shipped config, both packages.

(a) Each record's metadata: the sequence and config it names are the ones
    ``torch_jax_reference.RECORDS`` asks for, its config equals
    ``WildcatConfig(**kw)`` of both packages field by field, its arrays have
    one row a sweep. ``chip_smoke.py``'s copy of the regimes (the recorder
    takes it from there) equals ``benchmarks/longrun.py``'s.
(b) The room's prefix is the 50 s sequence's start: the generator draws
    scan by scan, so a shorter ``duration`` gives the same scans and the
    same IMU samples but for its last two (the accelerometer's end padding),
    which lie past the sweeps compared here.
(c) float64, exact KNN, ``pcg_xla`` at the shipped widths: the JAX package
    and the port over the room's first sweeps within 1e-6 m / 1e-6 of each
    other with equal packed counts, and both within 1e-6 of ``room50_f64``'s
    first rows (the record held to the package that wrote it).
(d) float32 at the shipped config (the port's per-bin KNN, the JAX
    package's exact ``approx_max_k`` on the CPU) over the same prefix: LM
    iterations equal sweep by sweep, positions within 1e-4 m. From the JAX
    package's own window state and feed before the prefix's last sweep, the
    port with the exact KNN gives every packed count of the JAX package's
    sweep (LM iterations included). The counts of the free runs are not
    compared: one plane test that float32 rounding tips moves
    ``n_surfels_dropped`` from the second sweep on (the JAX package's own
    float32 runs with x64 on and off differ so: 2501 and 2502 at the second
    sweep, 2210 and 2220 at the third), and K2's per-bin search (~98%
    recall) moves the pair counts.
"""

import concurrent.futures
import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
import torch_jax_reference as ref
from wildcat_slam_tpu.config import WildcatConfig as JaxConfig
from wildcat_slam_tpu.odometry.pipeline import LidarOdometry as JaxOdometry
from wildcat_slam_tpu_torch.cli import feed_events, synthetic_events
from wildcat_slam_tpu_torch.config import WildcatConfig
from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence
from wildcat_slam_tpu_torch.odometry.convert import window_state_from_numpy
from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry, process_sweep

torch.set_num_threads(1)

SWEEPS = 3
PREFIX = dict(chip_smoke.ROOM50, duration=1.8)  # three sweeps of the room
F64_TOL = 1e-6
F32_POS_TOL = 1e-4
COUNTS = list(chip_smoke.COUNT_COLUMNS)
MIN_SWEEPS = {"room50_f64": 100, "room50_f64_ulp": 100, "room50_f32": 100,
              "travel300_f32": 590, "fastrot300_f32": 590}


def _longrun_regimes() -> dict:
    path = os.path.join(ref.ROOT, "benchmarks", "longrun.py")
    spec = importlib.util.spec_from_file_location("longrun", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.REGIMES


def test_regime_copies_equal_longrun():
    regimes = _longrun_regimes()
    for name in ("travel", "fastrot"):
        assert chip_smoke.SOAKS[f"{name}300_f32"] == {**regimes[name], **chip_smoke.LONGRUN}


@pytest.mark.parametrize("name", sorted(ref.RECORDS))
def test_record_metadata(name):
    rec = chip_smoke.load_record(name)
    meta = rec["meta"]
    seq_kw, cfg_kw = ref.RECORDS[name]
    assert meta["name"] == name
    assert meta["sequence"] == seq_kw
    assert meta["config_kw"] == cfg_kw
    assert meta["x64"] == (cfg_kw.get("dtype") == "float64")
    for cls in (JaxConfig, WildcatConfig):
        fields = json.loads(cls(**cfg_kw).to_json())
        assert set(fields) == set(meta["config"]), cls
        for f in dataclasses.fields(cls):
            assert meta["config"][f.name] == fields[f.name], (cls, f.name)
    for key in ("jax", "numpy", "cpu", "command", "seconds", "errors_m", "capped"):
        assert key in meta, key
    n = meta["sweeps"]
    assert n >= MIN_SWEEPS[name]
    assert rec["t"].shape == (n,) and rec["packed"].shape == (n, 22)
    assert np.all(np.diff(rec["t"]) > 0)
    # the pose and the counts (a diverged run's degeneracy ratios may be NaN)
    assert np.all(np.isfinite(rec["packed"][:, list(range(7)) + COUNTS]))
    its = rec["packed"][:, 8]
    assert np.all(its >= 1) and np.all(its <= meta["config"]["inner_iter_num_max"])
    assert meta["capped"] == [int(i) for i in
                              np.flatnonzero(its >= meta["config"]["inner_iter_num_max"])]
    assert np.array_equal(rec["packed"][:, COUNTS], np.round(rec["packed"][:, COUNTS]))


def test_prefix_is_the_long_sequences_start():
    short = SyntheticSequence(**PREFIX)
    longer = SyntheticSequence(**dict(PREFIX, duration=PREFIX["duration"] + 0.5))
    assert len(short.scans) < len(longer.scans)
    for (t1, p1), (t2, p2) in zip(short.scans, longer.scans):
        assert np.array_equal(t1, t2) and np.array_equal(p1, p2)
    n = len(short.imu)
    for k in range(n):
        same = all(np.array_equal(a, b) for a, b in zip(short.imu[k], longer.imu[k]))
        assert same or k >= n - 2, k
    # the two padded samples lie past every sweep compared here
    t_last = chip_smoke.load_record("room50_f64")["t"][SWEEPS - 1]
    assert short.imu[n - 2][0] > t_last + 0.1


def _jax_state(state) -> dict:
    """A JAX window state as numpy arrays keyed by field path."""
    out = {f"{part}.{f.name}": np.asarray(getattr(getattr(state, part), f.name))
           for part in ("sample", "imu", "sld", "fix")
           for f in dataclasses.fields(getattr(state, part))}
    out["fix_geo"] = np.asarray(state.fix_geo)
    return out


def _run_both(cfg_kw: dict, keep_inputs: bool = False) -> dict:
    """The room's prefix through both packages at the shipped widths (the
    JAX package in a thread of its own, beside the port), and with
    ``keep_inputs`` the JAX package's window state and feed before the
    prefix's last sweep."""
    events = list(synthetic_events(SyntheticSequence(**PREFIX)))
    jlo = JaxOdometry(JaxConfig(**cfg_kw))
    inputs = []
    prepare = jlo._prepare_feed

    def recording_prepare():
        if jlo.sweep_id != SWEEPS - 1:
            return prepare()
        state = _jax_state(jlo.state)  # before process_sweep donates it
        prep = prepare()
        inputs.append((state, prep["args"]))
        return prep

    if keep_inputs:
        jlo._prepare_feed = recording_prepare
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(lambda: (feed_events(jlo, events), jlo.trajectory))
        plo = LidarOdometry(WildcatConfig(**cfg_kw), device="cpu")
        feed_events(plo, events)
        jax_run.result()
    out = dict(inputs=inputs[0] if inputs else None)
    for name, lo in (("jax", jlo), ("port", plo)):
        t, packed = chip_smoke.packed_rows(lo.trajectory, lo.stats)
        assert len(t) >= SWEEPS, name
        out[name] = (t[:SWEEPS], packed[:SWEEPS])
    return out


@pytest.fixture(scope="module")
def f64_runs():
    return _run_both(ref.RECORDS["room50_f64"][1])


@pytest.fixture(scope="module")
def f32_runs():
    return _run_both({}, keep_inputs=True)


def test_float64_prefix_port_equals_jax(f64_runs):
    (tj, pj), (tp, pp) = f64_runs["jax"], f64_runs["port"]
    assert np.array_equal(tj, tp)
    gaps = chip_smoke._gaps(pp, pj)
    assert gaps["max"] <= F64_TOL and gaps["quat"] <= F64_TOL, gaps
    assert np.array_equal(pp[:, COUNTS], pj[:, COUNTS])


@pytest.mark.parametrize("name", ["jax", "port"])
def test_float64_prefix_equals_the_record(f64_runs, name):
    rec = chip_smoke.load_record("room50_f64")
    t, packed = f64_runs[name]
    assert np.array_equal(t, rec["t"][:SWEEPS])
    gaps = chip_smoke._gaps(packed, rec["packed"][:SWEEPS])
    assert gaps["max"] <= F64_TOL and gaps["quat"] <= F64_TOL, gaps
    assert np.array_equal(packed[:, COUNTS], rec["packed"][:SWEEPS, COUNTS])


def test_float32_prefix_port_follows_jax(f32_runs):
    (tj, pj), (tp, pp) = f32_runs["jax"], f32_runs["port"]
    assert np.array_equal(tj, tp)
    assert np.array_equal(pp[:, 8], pj[:, 8]), (pp[:, 8], pj[:, 8])
    assert chip_smoke._gaps(pp, pj)["max"] <= F32_POS_TOL


def test_float32_sweep_from_the_jax_state(f32_runs):
    """The prefix's last sweep run by the port, with the exact KNN, from the
    JAX package's window state and feed before it."""
    k = SWEEPS - 1
    state_np, args = f32_runs["inputs"]
    state = window_state_from_numpy({n: np.array(a) for n, a in state_np.items()}, "cpu",
                                    torch.float32)
    targs = [torch.as_tensor(np.asarray(a).astype(np.int64) if np.asarray(a).dtype == np.int32
                             else np.array(a)) for a in args]
    _, out = process_sweep(state, *targs, WildcatConfig(match_knn_approx=False))
    got, want = out["packed"].numpy().astype(np.float64), f32_runs["jax"][1][k]
    assert np.array_equal(got[COUNTS], want[COUNTS]), (got[COUNTS], want[COUNTS])
    assert np.linalg.norm(got[0:3] - want[0:3]) <= F32_POS_TOL


def test_float64_gate_refuses_the_float32_record():
    """chip_smoke's float64 gate (phase (l)) passes room50_f64_ulp, the JAX
    package's own float64 run moved by one ulp, and refuses room50_f32, its
    float32 run: it tells the precisions apart."""
    f64 = chip_smoke.load_record("room50_f64")["packed"]
    ulp = chip_smoke._gaps(chip_smoke.load_record("room50_f64_ulp")["packed"], f64)
    f32 = chip_smoke._gaps(chip_smoke.load_record("room50_f32")["packed"], f64)
    assert ulp["first_over"] is not None and ulp["differ"]
    assert chip_smoke._f64_gate(ulp, ulp) == []
    fails = chip_smoke._f64_gate(f32, ulp)
    assert any("before room50_f64_ulp's" in f for f in fails), fails
