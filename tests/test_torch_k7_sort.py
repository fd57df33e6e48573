"""K7's own sort of the voxel levels (``csrc/surfel_extract.cu``: phases K
and B and the passes), modelled in numpy step by step as the kernel takes
it, and held to ``np.argsort(kind="stable")`` of the plain version's packed
keys (``hi 2^31 + lo``) on chip_smoke.py's inputs. The kernel runs on a
card only: ``chip_smoke.check_k7`` and the ``gpu`` tests hold its outputs
to the plain version's there.
"""

import os
import runpy

import numpy as np
import pytest
import torch

from wildcat_slam_tpu_torch.config import WildcatConfig
from wildcat_slam_tpu_torch.ops import surfel_extract as se
from wildcat_slam_tpu_torch.probe_extract import packed_level_keys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIGITS = 2**se.DIGIT_BITS
FIELD = 2**se.FIELD_BITS - 1
BIAS = 2**(se.FIELD_BITS - 1)
WARP, ROUND = 32, se.THREADS  # a round: a thread an element, in thread order


@pytest.fixture(scope="module")
def cases():
    """chip_smoke.py's K7 inputs (it imports nothing at module level but the
    standard library)."""
    return runpy.run_path(os.path.join(REPO, "chip_smoke.py"))["k7_inputs"]()


def _cells(pts, cfg):
    return [np.floor(pts / (cfg.voxel_size / 2.0**level)).astype(np.int64)
            for level in range(cfg.max_voxel_depth + 1)]


def _packed(cell, valid):
    """extract_plain's sort key of one level (voxel.split_keys, packed)."""
    c = cell + BIAS
    hi = (c[:, 0] << 10) | (c[:, 1] >> 10)
    lo = ((c[:, 1] & 1023) << 20) | c[:, 2]
    big = 2**31 - 1
    return np.where(valid, hi, big) * 2**31 + np.where(valid, lo, big)


class _Sort:
    """The kernel's sort of one input's levels: phase K's per-chunk valid
    counts and field ranges, phase B's key layouts (field minima, shifts,
    top, passes) and keys, then each pass's per-chunk digit counts and its
    placement (the digit's offset over the chunks, then the rank inside
    the chunk: the earlier rounds' counts, the earlier warps' of the round,
    the earlier lanes' of the warp)."""

    def __init__(self, cells, valid, pl):
        self.pl, p = pl, valid.shape[0]
        self.chunk_of = np.arange(p) // pl.chunk
        # K: a chunk's valid count and each field's bounds over its valid points
        nv = np.bincount(self.chunk_of, valid, pl.chunks).astype(np.int64)
        self.layouts, self.keys = [], []
        for cell in cells:
            f = (cell + BIAS) & FIELD
            lo = np.full((pl.chunks, 3), 2**32 - 1)
            hi = np.zeros((pl.chunks, 3), np.int64)
            np.minimum.at(lo, self.chunk_of[valid], f[valid])
            np.maximum.at(hi, self.chunk_of[valid], f[valid])
            # B: the level's layout from the chunks' bounds
            any_valid = nv.sum() > 0
            fmin = lo.min(0) if any_valid else np.zeros(3, np.int64)
            span = hi.max(0) - fmin if any_valid else np.zeros(3, np.int64)
            w = [int(s).bit_length() for s in span]
            sh0, sh1 = w[1] + w[2], w[2]
            widest = (int(span[0]) << sh0) | (int(span[1]) << sh1) | int(span[2])
            top = widest + 1
            bits = (top if nv.sum() < p else widest).bit_length()
            passes = max(1, -(-bits // se.DIGIT_BITS))
            key = ((f[:, 0] - fmin[0]) << sh0) | ((f[:, 1] - fmin[1]) << sh1) | (f[:, 2] - fmin[2])
            self.keys.append(np.where(valid, key, top).astype(np.uint64))
            self.layouts.append(dict(bits=bits, passes=passes, top=top))

    def hist(self, digit):
        """(chunks, DIGITS): each chunk's count of each digit."""
        return np.bincount(self.chunk_of * DIGITS + digit,
                           minlength=self.pl.chunks * DIGITS).reshape(-1, DIGITS)

    def places(self, digit):
        """Each element's place in the pass's output, as the kernel ranks it."""
        pl, p = self.pl, digit.shape[0]
        h = self.hist(digit)
        offset = (np.cumsum(h.sum(0)) - h.sum(0))[None, :] + np.cumsum(h, 0) - h
        pad = pl.chunks * pl.chunk  # the chunks' rounds padded with "no digit"
        d = np.full(pad, DIGITS)
        d[:p] = digit
        pos = np.arange(pad)
        # the warp's peers before the lane (__match_any_sync, __popc)
        same = (d.reshape(-1, WARP)[:, :, None] == d.reshape(-1, WARP)[:, None, :])
        before_lane = np.tril(same, -1).sum(2).reshape(-1)
        # the round's warps' counts, added in warp order after the earlier rounds'
        cnt = np.zeros((pad // WARP, DIGITS + 1), np.int64)
        np.add.at(cnt, (pos // WARP, d), 1)
        cnt = cnt[:, :DIGITS].reshape(pl.chunks, pl.chunk // ROUND, ROUND // WARP, DIGITS)
        in_round = np.cumsum(cnt, 2) - cnt
        rounds = cnt.sum(2)
        before_round = np.cumsum(rounds, 1) - rounds
        r = (pos % pl.chunk) // ROUND
        w = (pos % ROUND) // WARP
        c = pos // pl.chunk
        dd = np.minimum(d, DIGITS - 1)
        place = offset[c, dd] + before_round[c, r, dd] + in_round[c, r, w, dd] + before_lane
        return place[:p]

    def run(self):
        """Each level's permutation after its passes (the ping-pong's scatters)."""
        perms = []
        for key, lay in zip(self.keys, self.layouts):
            order = np.arange(key.shape[0])
            for k in range(lay["passes"]):
                digit = ((key[order] >> np.uint64(se.DIGIT_BITS * k)) & np.uint64(DIGITS - 1))
                new = np.empty_like(order)
                new[self.places(digit.astype(np.int64))] = order
                order = new
            perms.append(order)
        return perms


def _check(pts, valid, cfg):
    """The model's permutation against the stable argsort of the packed keys
    at every level; returns the layouts."""
    pl = se.plan(pts.shape[0], cfg.max_voxels_per_sweep, cfg.max_leaves_per_sweep,
                 cfg.max_surfels_per_sweep, cfg.max_voxel_depth + 1, 4)
    cells = _cells(pts, cfg)
    model = _Sort(cells, valid, pl)
    packed = packed_level_keys(torch.as_tensor(pts), torch.as_tensor(valid), cfg).numpy()
    for level, (cell, perm) in enumerate(zip(cells, model.run())):
        assert np.array_equal(packed[level], _packed(cell, valid)), level
        assert np.array_equal(perm, np.argsort(packed[level], kind="stable")), level
        assert model.layouts[level]["passes"] <= pl.passes
    return model.layouts


@pytest.mark.parametrize("case", ["room", "dense", "wide"])
def test_model_sorts_as_the_plain_versions_stable_argsort(cases, case):
    """The room sweep (4096 points), k7_dense and k7_wide (65,536 each): the
    room spans a few bits a field; the wide input's finest level all 60."""
    pts, _, valid, cfg = cases[case]
    layouts = _check(pts, valid, cfg)
    if case == "wide":  # 3 x 20 bits at the finest level: the most passes
        assert layouts[-1]["bits"] == 60 and layouts[-1]["passes"] == 8
        assert [lay["passes"] for lay in layouts] == [7, 8, 8]
    else:
        assert all(lay["passes"] <= 3 for lay in layouts)


def test_model_sorts_no_valid_point_and_one_voxel(cases):
    """No valid point: every key is the top, one pass keeps input order; one
    voxel: the valid keys are all 0, the invalid none, one pass."""
    for case in ("every point invalid", "one voxel"):
        pts, _, valid, cfg = cases[case]
        layouts = _check(pts, valid, cfg)
        assert all(lay["passes"] == 1 for lay in layouts), case
        if case == "every point invalid":
            assert all(lay["top"] == 1 for lay in layouts)


def test_plan_sizes_the_sort_for_the_widest_key():
    """The widest key, three 20-bit fields and the top above them, takes
    eight passes; the ping-pong holds 64-bit keys, so the workspace does not
    grow with the passes; at most MAX_CHUNKS chunks a level, each a whole
    number of tiles."""
    assert se.KEY_BITS == 3 * se.FIELD_BITS + 1
    widest = (2**se.FIELD_BITS - 1) * (2**(2 * se.FIELD_BITS) + 2**se.FIELD_BITS + 1) + 1
    assert widest.bit_length() == se.KEY_BITS
    cfg = WildcatConfig()
    sizes = (cfg.max_voxels_per_sweep, cfg.max_leaves_per_sweep, cfg.max_surfels_per_sweep,
             cfg.max_voxel_depth + 1)
    for p in (1, 4096, 5001, 65536, 1 << 20, 1 << 22):
        pl = se.plan(p, *sizes[:3], 1, 4)
        assert pl.passes == 8 and pl.chunk % se.TILE == 0
        assert pl.chunks <= se.MAX_CHUNKS and (pl.chunks - 1) * pl.chunk < p <= pl.chunks * pl.chunk
    small, big = se.plan(65536, *sizes, 4), se.plan(65536, *sizes[:3], 4, 4)
    # a level more adds its keys (3 x 2 ints a point), indices (3) and counts
    lp = 65536
    assert big.ints - small.ints >= 9 * lp + big.chunks * DIGITS
