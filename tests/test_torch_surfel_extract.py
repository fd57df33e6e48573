"""Kernel K7 (surfel extraction, ``ops/surfel_extract.py``) on the CPU.

Its plan (the moments' prefix blocks it shares with the plain version),
workspace and refusals; its registration with the build (the source and
its header hashed and built with -fmad=false, no atomics); the dispatch of
``odometry/surfel.extract_surfels``, which runs the plain version on CPU
tensors, bit for bit, and never the kernel; and chip_smoke.py's K7 inputs
and bound. The kernel runs on a card only: the ``gpu`` tests in
``tests/test_torch_kernels.py`` and ``chip_smoke.py`` hold it to its plain
version there, and ``tests/test_torch_surfel.py`` holds the plain version
to the JAX package.
"""

import os
import re
import runpy
import shutil

import numpy as np
import pytest
import torch

from wildcat_slam_tpu_torch.config import WildcatConfig
from wildcat_slam_tpu_torch.odometry.surfel import extract_surfels
from wildcat_slam_tpu_torch.ops import _build
from wildcat_slam_tpu_torch.ops import surfel_extract as se

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "wildcat_slam_tpu_torch", "csrc", "surfel_extract.cu")

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cs():
    """chip_smoke.py's functions (it imports nothing at module level but the
    standard library)."""
    return runpy.run_path(os.path.join(REPO, "chip_smoke.py"))


def test_plan_at_the_shipped_config():
    cfg = WildcatConfig()
    p = se.plan(cfg.max_points_per_sweep, cfg.max_voxels_per_sweep, cfg.max_leaves_per_sweep,
                cfg.max_surfels_per_sweep, cfg.max_voxel_depth + 1, 4)
    assert (p.threads, p.tile, p.block) == (se.THREADS, se.TILE, se.BLOCK) == (256, 1024, 128)
    assert (p.tiles_p, p.tiles_v, p.ncap) == (64, 48, 1024)
    # the sort: a chunk a tile, 64 a level; eight passes of 8 bits for the
    # widest key (three 20-bit fields and the invalid points' top value)
    assert (p.chunk, p.chunks, p.passes) == (1024, 64, 8)
    # per point and level three 64-bit keys (input order, the ping-pong's
    # other side, sorted) and three indices (ping-pong, the permutation); per
    # (level, chunk) 256 digits' counts; per chunk its valid count and the
    # levels' six field bounds
    sort = 3 * 65536 * (3 * 2 + 3) + 3 * 64 * 256 + 64 * (1 + 6 * 3)
    # per point: the segment ids and cluster-start flags of the three levels,
    # the two parent levels' ids in input order; per slot its start (and the
    # sentinel), flags and candidacy; per cluster its start (and the
    # sentinel); the tiles' counts; the candidates' validity, valid list
    # and its runs' offsets (a run a tile, and the end)
    assert p.ints == sort + (3 * 3 * 65536 - 65536 + 3 * 8193 + 2 * 3 * 8192 + 3 * 16385
                             + 2 * 3 * 64 + 48 + 2 * 3 * 16384 + 49 + 2 * 3)
    # per point and level the channels' in-block prefixes; per level and
    # channel the block prefixes' two words (512 blocks and the leading 0)
    # and the scan's second buffer; per candidate its record and time
    assert p.block == 128
    assert p.values == (3 * 65536 * se.CHANNELS + 3 * se.CHANNELS * (2 * 513 + 2 * 512)
                        + 3 * 16384 * (se.CAND + 1))
    assert se.workspace_bytes(p, 4) == 4 * p.ints + 4 * p.values
    assert se.workspace_bytes(p, 8) == 4 * p.ints + 8 * p.values


def test_plan_cuts_the_output_at_the_candidates():
    assert se.plan(4096, 48, 64, 1024, 3, 8).ncap == 3 * 64
    assert se.plan(4096, 48, 64, 16, 3, 8).ncap == 16
    assert se.plan(5001, 1024, 2048, 256, 3, 4).tiles_p == 5


@pytest.mark.parametrize("args", [
    (0, 8192, 16384, 1024, 3, 4), (se.MAX_POINTS + 1, 8192, 16384, 1024, 3, 4),
    (65536, 0, 16384, 1024, 3, 4), (65536, 8192, se.MAX_SLOTS + 1, 1024, 3, 4),
    (65536, 8192, 16384, 0, 3, 4), (65536, 8192, 16384, 1024, 0, 4),
    (65536, 8192, 16384, 1024, se.MAX_LEVELS + 1, 4), (65536, 8192, 16384, 1024, 3, 2)],
    ids=["no points", "too many points", "no voxel slot", "too many cluster slots",
         "no surfel", "no level", "nine levels", "float16"])
def test_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError, match="surfel_extract: needs"):
        se.plan(*args)


def test_plan_refuses_a_workspace_past_its_cap():
    with pytest.raises(ValueError, match="bytes of workspace"):
        se.plan(se.MAX_POINTS, se.MAX_SLOTS, se.MAX_SLOTS, 1024, se.MAX_LEVELS, 8)


def test_supports_raises_with_its_reason():
    cfg = WildcatConfig()
    sizes = (cfg.max_points_per_sweep, cfg.max_voxels_per_sweep, cfg.max_leaves_per_sweep,
             cfg.max_surfels_per_sweep, cfg.max_voxel_depth + 1)
    assert se.supports(*sizes, torch.float32) and se.supports(*sizes, torch.float64)
    with pytest.raises(ValueError, match="float32 or float64"):
        se.supports(*sizes, torch.float16)
    with pytest.raises(ValueError, match="levels"):
        se.supports(*sizes[:4], 9, torch.float32)


def test_kernel_refuses_cpu_tensors():
    before = se.LAUNCHES
    pts, t, valid = torch.zeros((8, 3)), torch.zeros(8), torch.ones(8, dtype=torch.bool)
    cfg = WildcatConfig(max_points_per_sweep=8)
    with pytest.raises(ValueError, match="CUDA card"):
        se.extract(pts, t, valid, cfg)
    assert se.LAUNCHES == before


@pytest.mark.parametrize("dt", ["float64", "float32"])
@pytest.mark.parametrize("case", ["room", "room, tight"])
def test_extract_surfels_on_cpu_is_the_plain_version(cs, monkeypatch, case, dt):
    """On CPU tensors extract_surfels is extract_plain, bit for bit, on
    tests/test_torch_surfel.py's 4096-point sweep at its small and tight
    configs; the kernel's wrapper is never reached."""
    pts, ts, valid, cfg = cs["k7_inputs"]()[case]
    dtype = getattr(torch, dt)
    args = (torch.as_tensor(pts, dtype=dtype), torch.as_tensor(ts, dtype=dtype),
            torch.as_tensor(valid), cfg)

    def refuse(*a, **k):
        raise AssertionError("the kernel's wrapper was called on CPU tensors")

    monkeypatch.setattr(se, "extract", refuse)
    got, ref = extract_surfels(*args), se.extract_plain(*args)
    assert got.keys() == ref.keys()
    assert all(torch.equal(got[k], ref[k]) for k in ref)
    assert int(ref["valid"].sum()) >= 1
    if case == "room, tight":  # segment, cluster and surfel drops all fire
        assert int(ref["n_dropped"]) > int(cfg.max_surfels_per_sweep)


def test_k7_is_registered_with_the_build():
    assert "surfel_extract.cu" in _build.SOURCES and "eigh3.cuh" in _build.HEADERS
    assert "-fmad=false" in _build.flags("surfel_extract.cu")
    assert not any("fast_math" in f or "fast-math" in f
                   for src in _build.SOURCES for f in _build.flags(src))
    # the ctypes signature has as many arguments as the C entry point
    with open(SOURCE) as f:
        text = f.read()
    decl = re.search(r'extern "C" int wc_surfel_extract\((.*?)\)\s*\{', text, re.S).group(1)
    assert len(_build.SIGNATURES["wc_surfel_extract"][0]) == decl.count(",") + 1


def test_k7_source_has_no_atomics_and_few_kernels():
    texts = []
    for name in ("surfel_extract.cu", "eigh3.cuh"):
        with open(os.path.join(os.path.dirname(SOURCE), name)) as f:
            texts.append(re.sub(r"//.*", "", f.read()))
    assert not any("atomic" in t for t in texts)
    assert 1 <= texts[0].count("__global__") <= 4
    assert "__global__" not in texts[1]


def test_library_hash_covers_the_header(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(os.path.dirname(SOURCE), csrc)
    monkeypatch.setattr(_build, "SRC_DIR", csrc)
    before = _build.library_path()
    (csrc / "eigh3.cuh").write_text((csrc / "eigh3.cuh").read_text() + "\n")
    assert _build.library_path() != before


@pytest.mark.parametrize("p,block", [(65536, 128), (4096, 128), (4160, 64), (5001, 1),
                                     (6, 2)])
def test_plan_takes_the_plain_versions_prefix_block(p, block):
    """K7 sums the moments over dfsum.df_prefix's blocks: the largest power
    of two dividing P, at most 128."""
    from wildcat_slam_tpu_torch.ops.dfsum import df_prefix

    assert se.plan(p, 48, 64, 16, 3, 4).block == block == df_prefix(torch.zeros((p, 1))).block


def test_chip_smoke_k7_inputs_are_what_they_say(cs):
    cases = cs["k7_inputs"]()
    assert set(cases) == {"room", "room, tight", "every point invalid", "one voxel", "P=5001",
                          "dense", "wide"}
    pts, ts, valid, cfg = cases["one voxel"]
    cell = np.floor(pts / cfg.voxel_size)
    assert valid.all() and (cell == cell[0]).all()
    assert not cases["every point invalid"][2].any()
    pts, ts, valid, cfg = cases["P=5001"]
    assert pts.shape == (5001, 3) and cfg.max_points_per_sweep == 5001 and 4900 < valid.sum() < 5001
    for name, (pts, ts, valid, cfg) in cases.items():
        assert pts.shape[0] == ts.shape[0] == valid.shape[0] == cfg.max_points_per_sweep, name
    # the wide input's finest cells reach voxel.split_keys' bounds on each axis
    pts, ts, valid, cfg = cases["wide"]
    cell = np.floor(pts[valid] / (cfg.voxel_size / 2**cfg.max_voxel_depth))
    assert (cell.min(0) == -(2**19 - 1)).all() and (cell.max(0) == 2**19 - 1).all()


def test_k7_bound_counts_the_points_of_each_level(cs):
    """The points are read once for all the levels (their keys come from one
    read), the surfels and n_dropped written once."""
    for itemsize in (4, 8):
        ms, by = cs["_k7_bound"](65536, 3, 1024, itemsize)
        moved = 65536 * (4 * itemsize + 1) + 1024 * (18 * itemsize + 1) + 8
        assert by == "bytes" and ms == pytest.approx(moved / cs["HBM_BYTES_PER_S"] * 1e3)


def test_chip_smoke_dense_input_fills_the_time_order(cs):
    """k7_dense at the shipped sizes: more than half of the 3 nc cluster
    slots hold a valid surfel candidate (the plain version, every candidate
    kept)."""
    import dataclasses

    pts, ts, valid, cfg = cs["k7_dense"]()
    assert pts.shape == (cfg.max_points_per_sweep, 3) == (65536, 3)
    slots = (cfg.max_voxel_depth + 1) * cfg.max_leaves_per_sweep
    out = se.extract_plain(torch.as_tensor(pts, dtype=torch.float32),
                           torch.as_tensor(ts, dtype=torch.float32), torch.as_tensor(valid),
                           dataclasses.replace(cfg, max_surfels_per_sweep=slots))
    assert slots // 2 < int(out["valid"].sum()) < slots


def test_probe_stamps_every_barrier_and_names_its_phases():
    """``probe_extract`` stamps K7's start, each grid barrier and its end by
    text edits of the source, and names each phase by the comment before
    the barrier that ends it; its sort share sums K, B and the passes."""
    from wildcat_slam_tpu_torch import probe_extract

    with open(SOURCE) as f:
        src = f.read()
    traced = probe_extract.traced(src)
    n_sync = src.count("grid.sync();")
    stamped = "probe_clock(__LINE__, 0); grid.sync(); probe_clock(__LINE__, 1);"
    assert traced.count(stamped) == n_sync
    names = [name.split(":")[0] for _, name in sorted(probe_extract.labels(traced).items())[1:]]
    assert names == ["K", "B", "sort, pass k", "sort, pass k", "1", "2", "3", "4", "5", "6",
                     "7", "8a", "8b"]
    split = [("K: keys", 1.0, 0.5), ("sort, pass k: placed", 2.0, 0.5), ("7: clusters", 4.0, 1.0)]
    assert probe_extract.sort_us(split) == 4.0
