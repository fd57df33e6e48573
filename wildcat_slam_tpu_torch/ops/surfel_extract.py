"""Surfel extraction: kernel K7 and its plain version.

Counterpart of XLA's fusions of the JAX package's ``odometry/surfel.py``
``extract_surfels`` (no Pallas kernel stands behind them; see its module doc
for the gating semantics, which are kept exactly): three flat voxel levels,
per segment moments, the closed-form eigh3 plane test, the hierarchy, the
temporal clusters of candidate nodes and their time order.
``odometry/surfel.extract_surfels`` runs :func:`extract` on CUDA tensors and
:func:`extract_plain` on CPU tensors.

:func:`extract` is one cooperative launch of ``csrc/surfel_extract.cu``
(see the source's header for its phases): the voxel keys of every level, a
stable LSD radix sort of its own of the three levels (the keys compressed
to the bits their ranges span, as many passes of DIGIT_BITS as the widest
level needs, worked out on the device), then the rest. It makes no library
call and no host read, takes its workspaces from torch's allocator, and
sums in a fixed order, so a CUDA graph of it replays its eager run bit for
bit. What bounds it is latency (~20 dependent phases, the gathers through
the sort's permutation, the eigh3 chains), not its few MB of traffic. It
sums the moments as :func:`extract_plain` does (``dfsum.df_prefix`` and
``df_range_sum``: the blocked prefix, the block totals' double-float scan,
in their order of operations), so on the card they come out bit-equal to
the plain version's; a more accurate sum took the float64 sweep off the
JAX package's float64 record 22 sweeps early. eigh3 takes acos, cos, sin
and atan2 from the CUDA math library: a normal or a std may differ from
the plain version's in the last bits. Its sort orders a level's points as
``torch.sort(stable=True)`` of the plain version's packed keys
(``hi 2^31 + lo``) for cells within voxel.split_keys' range (|cell| < 2^19
on each axis), where the packed comparison is the cells' lexicographic one.

:func:`extract_plain` is the PyTorch version. Its multi-operand
``lax.sort`` calls of the JAX version become a stable argsort of one key
plus gathers (``lax.sort`` is stable by default, so the order of equal keys
is the same). Two int32 keys sort as one int64 key ``hi * 2^31 + lo``,
which orders exactly like the lexicographic pair; per segment moments are
range differences of one compensated running sum.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from wildcat_slam_tpu_torch.config import WildcatConfig
from wildcat_slam_tpu_torch.ops import _build, voxel
from wildcat_slam_tpu_torch.ops.dfsum import df_prefix, df_range_sum
from wildcat_slam_tpu_torch.ops.eigh3 import eigh3

LAUNCHES = 0  # K7 launches by extract (one a call; not by extract_plain)

# csrc/surfel_extract.cu: blocks of THREADS threads; the scans over the
# sorted points and over the candidates go by tiles of TILE entries (four a
# thread); the sort by chunks of the points (TILE or more, at most
# MAX_CHUNKS a level), by digits of DIGIT_BITS bits, its keys the three
# FIELD_BITS-bit cell fields less their minima and an invalid point's top
# value (at most KEY_BITS bits); the moments' blocked prefix
# (ops/dfsum.df_prefix's) by blocks of at most BLOCK points, CHANNELS values
# a point. CAND values a surfel candidate (t, center 3, cov 6, norm 3, std).
THREADS = 256
TILE = 1024
MAX_CHUNKS = 256
DIGIT_BITS = 8
FIELD_BITS = 20
KEY_BITS = 3 * FIELD_BITS + 1
BLOCK = 128
CHANNELS = 11
CAND = 14
MAX_LEVELS = 8
MAX_POINTS = 1 << 26
MAX_SLOTS = 1 << 24  # max_voxels_per_sweep and max_leaves_per_sweep
MAX_WORKSPACE_BYTES = 1 << 31


class Plan(NamedTuple):
    threads: int   # a block (the kernel is built for THREADS)
    tile: int      # entries a tile of the scans (built for TILE)
    block: int     # points a block of the moments' prefix: df_prefix's, min(BLOCK, the largest
                   # power of two dividing P)
    tiles_p: int   # tiles over a level's points
    tiles_v: int   # tiles over the L nc candidates
    ncap: int      # surfels out: min(cap, L nc)
    chunk: int     # points a chunk of the sort: TILE, or more for at most MAX_CHUNKS a level
    chunks: int    # chunks a level
    passes: int    # the sort's passes for the widest key (KEY_BITS): the ping-pong does not
                   # grow with them
    ints: int      # int32 workspace: per (level, chunk) its digits' counts; per point and
                   # level the sort's keys (64 bits: in input order, the ping-pong's other
                   # side, sorted) and indices (ping-pong, the permutation); per chunk its
                   # valid count and fields' ranges; per point the segment and cluster-start
                   # flags and the parents' ids; per slot its start, flags, candidacy; per
                   # cluster its start; the tiles' counts; the candidates' validity, the
                   # valid ones' list and its runs' offsets
    values: int    # the channels' in-block prefixes (CHANNELS a point a level), the block
                   # prefixes' high and low words and the scan's second buffer, the candidates'
                   # records (CAND values each), the valid ones' times


def plan(p: int, v_cap: int, nc: int, cap: int, n_levels: int, itemsize: int) -> Plan:
    """K7's launch for P points, v_cap voxel slots and nc cluster slots a
    level, cap surfels and n_levels levels. Raises ValueError for what the
    kernel does not take."""
    if not (1 <= p <= MAX_POINTS and 1 <= v_cap <= MAX_SLOTS and 1 <= nc <= MAX_SLOTS
            and cap >= 1 and 1 <= n_levels <= MAX_LEVELS and itemsize in (4, 8)):
        raise ValueError(f"surfel_extract: needs 1 <= P <= {MAX_POINTS}, 1 <= max_voxels_per_sweep"
                         f", max_leaves_per_sweep <= {MAX_SLOTS}, max_surfels_per_sweep >= 1, 1 <="
                         f" levels <= {MAX_LEVELS} and float32 or float64, got P={p}, "
                         f"v_cap={v_cap}, nc={nc}, cap={cap}, {n_levels} levels, {itemsize}-byte "
                         "values")
    lp, lnc = n_levels * p, n_levels * nc
    tiles_p, tiles_v = -(-p // TILE), -(-lnc // TILE)
    block = 1
    while block < BLOCK and p % (2 * block) == 0:
        block *= 2
    nb = p // block
    chunk = -(-p // (MAX_CHUNKS * TILE)) * TILE
    chunks = -(-p // chunk)
    sort = n_levels * chunks * 2**DIGIT_BITS + 3 * 2 * lp + 3 * lp + chunks * (1 + 6 * n_levels)
    ints = (sort + 3 * lp - p + n_levels * (v_cap + 1) + 2 * n_levels * v_cap
            + n_levels * (nc + 1) + 2 * n_levels * tiles_p + tiles_v + 2 * lnc + tiles_v + 1
            + 2 * n_levels)
    values = lp * CHANNELS + n_levels * CHANNELS * (4 * nb + 2) + lnc * (CAND + 1)
    pl = Plan(THREADS, TILE, block, tiles_p, tiles_v, min(cap, lnc), chunk, chunks,
              -(-KEY_BITS // DIGIT_BITS), ints, values)
    if workspace_bytes(pl, itemsize) > MAX_WORKSPACE_BYTES:
        raise ValueError(f"surfel_extract: P={p}, v_cap={v_cap}, nc={nc} need "
                         f"{workspace_bytes(pl, itemsize)} bytes of workspace, more than "
                         f"{MAX_WORKSPACE_BYTES}")
    return pl


def workspace_bytes(p: Plan, itemsize: int) -> int:
    """The bytes a call takes from torch's allocator besides its outputs: the
    int32 and the values' workspace."""
    return 4 * p.ints + itemsize * p.values


def _itemsize(dtype: torch.dtype) -> int:
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"surfel_extract: needs float32 or float64 points, got {dtype}")
    return torch.finfo(dtype).bits // 8


def supports(p: int, v_cap: int, nc: int, cap: int, n_levels: int, dtype: torch.dtype) -> bool:
    """True when K7 takes these sizes in ``dtype``; raises ValueError with
    the reason where it does not."""
    plan(p, v_cap, nc, cap, n_levels, _itemsize(dtype))
    return True


def _levels(cfg: WildcatConfig):
    n_levels = cfg.max_voxel_depth + 1
    sizes = [cfg.voxel_size / (2.0**level) for level in range(n_levels)]
    reals = sizes + [cfg.planer_threshold, cfg.min_plane_likeness, cfg.cluster_time_gap,
                     float(cfg.min_points_per_plane)]
    return n_levels, (ctypes.c_double * len(reals))(*reals)


def _check(pts: torch.Tensor, t: torch.Tensor, valid: torch.Tensor, cfg: WildcatConfig) -> Plan:
    """K7's plan for these inputs, after the checks that need no host read."""
    dtype, dev, p = pts.dtype, pts.device, pts.shape[0]
    if dev.type != "cuda" or pts.dim() != 2 or pts.shape[1] != 3:
        raise ValueError(f"surfel_extract: needs pts (P, 3) on a CUDA card, got "
                         f"{tuple(pts.shape)} on {dev}")
    if valid.shape != (p,) or valid.dtype != torch.bool or valid.device != dev or (
            t.shape != (p,) or t.dtype != dtype or t.device != dev):
        raise ValueError(f"surfel_extract: needs t ({p},) {dtype} and valid ({p},) bool on {dev}, "
                         f"got valid {tuple(valid.shape)} {valid.dtype} on {valid.device}, "
                         f"t {tuple(t.shape)} {t.dtype} on {t.device}")
    return plan(p, cfg.max_voxels_per_sweep, cfg.max_leaves_per_sweep, cfg.max_surfels_per_sweep,
                cfg.max_voxel_depth + 1, _itemsize(dtype))


def extract(pts: torch.Tensor, t: torch.Tensor, valid: torch.Tensor, cfg: WildcatConfig) -> dict:
    """:func:`extract_plain`'s outputs by K7, on CUDA tensors: pts (P, 3), t
    (P,) of pts' dtype, valid (P,) bool, all on one card."""
    global LAUNCHES
    pl = _check(pts, t, valid, cfg)
    dtype, dev = pts.dtype, pts.device
    pts, t, valid = pts.contiguous(), t.contiguous(), valid.contiguous()
    iwork = torch.empty((pl.ints,), dtype=torch.int32, device=dev)
    vwork = torch.empty((pl.values,), dtype=dtype, device=dev)
    n = pl.ncap
    out = dict(t=torch.empty((n,), dtype=dtype, device=dev),
               center=torch.empty((n, 3), dtype=dtype, device=dev),
               cov=torch.empty((n, 3, 3), dtype=dtype, device=dev),
               norm=torch.empty((n, 3), dtype=dtype, device=dev),
               resolution=torch.empty((n,), dtype=dtype, device=dev),
               std=torch.empty((n,), dtype=dtype, device=dev),
               valid=torch.empty((n,), dtype=torch.bool, device=dev),
               n_dropped=torch.empty((), dtype=torch.int64, device=dev))
    tensors = [pts, t, valid, iwork, vwork, *out.values()]
    n_levels, reals = _levels(cfg)
    ptrs = (ctypes.c_void_p * len(tensors))(*(x.data_ptr() for x in tensors))
    lib = _build.library()
    with torch.cuda.device(dev):  # the C entry launches on the current card
        err = lib.wc_surfel_extract(ptrs, len(tensors), pts.shape[0], cfg.max_voxels_per_sweep,
                                    cfg.max_leaves_per_sweep, cfg.max_surfels_per_sweep, n_levels,
                                    reals, pts.element_size(), pl.threads, pl.tile, pl.ints,
                                    pl.values, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "wc_surfel_extract")
    LAUNCHES += 1
    return out


_BIG = 2**31 - 1


def _unpack_sym(m6: torch.Tensor) -> torch.Tensor:
    """(..., 6) [xx yy zz xy xz yz] -> full symmetric (..., 3, 3)."""
    xx, yy, zz, xy, xz, yz = (m6[..., i] for i in range(6))
    return torch.stack([torch.stack([xx, xy, xz], -1), torch.stack([xy, yy, yz], -1),
                        torch.stack([xz, yz, zz], -1)], -2)


def _compact_positions(flag, slot_id, cap: int, fill: int, payload: tuple = ()):
    """(cap + 1,) positions: out[j] = index of the flagged element with
    ``slot_id == j``, ``fill`` for absent slots; slot ``cap`` is the
    open-ended sentinel. ``payload`` channels are returned at the same
    positions (garbage at absent slots; callers mask)."""
    p = flag.shape[0]
    dev = flag.device
    key = torch.where(flag, slot_id.to(torch.int64), _BIG)
    order = torch.argsort(key, stable=True)
    head_k = key[order]
    head_p = order
    outs = [o[order] for o in payload]
    if p < cap + 1:
        pad = cap + 1 - p
        head_k = torch.cat([head_k, torch.full((pad,), _BIG, dtype=torch.int64, device=dev)])
        head_p = torch.cat([head_p, torch.zeros((pad,), dtype=torch.int64, device=dev)])
        outs = [torch.cat([o, torch.zeros((pad,), dtype=o.dtype, device=dev)]) for o in outs]
    head_k, head_p = head_k[:cap + 1], head_p[:cap + 1]
    pos = torch.where(head_k <= cap, head_p, fill)
    if not payload:
        return pos
    return pos, tuple(o[:cap + 1] for o in outs)


def _plane_test(vals, thr: float, likeness_min: float, strict: bool):
    """vals: (..., 3) ascending eigenvalues."""
    s = torch.sum(vals, dim=-1)
    likeness = 2.0 * (vals[..., 1] - vals[..., 0]) / torch.clamp(s, min=torch.finfo(vals.dtype).tiny)
    if strict:
        return (vals[..., 0] < thr) & (likeness > likeness_min)
    return (vals[..., 0] <= thr) & (likeness >= likeness_min)


def _sym6(m):
    return torch.stack([m[:, 0] * m[:, 0], m[:, 1] * m[:, 1], m[:, 2] * m[:, 2],
                        m[:, 0] * m[:, 1], m[:, 0] * m[:, 2], m[:, 1] * m[:, 2]], 1)


def extract_plain(pts: torch.Tensor, t: torch.Tensor, valid: torch.Tensor,
                  cfg: WildcatConfig) -> dict:
    """K7's plain version: ``odometry/surfel.extract_surfels`` in PyTorch
    operations (the port's extraction on CPU tensors)."""
    p_cap = pts.shape[0]
    dtype = pts.dtype
    dev = pts.device
    n_levels = cfg.max_voxel_depth + 1
    min_pts = cfg.min_points_per_plane
    v_cap = cfg.max_voxels_per_sweep
    nc = cfg.max_leaves_per_sweep
    arange_p = torch.arange(p_cap, device=dev)
    zero_i = torch.zeros((), dtype=torch.int64, device=dev)

    per_level = []
    n_seg_dropped = zero_i
    for level in range(n_levels):
        size = cfg.voxel_size / (2.0**level)
        cell = torch.floor(pts / size).to(torch.int32)
        hi, lo = voxel.split_keys(cell)
        hi = torch.where(valid, hi, _BIG).to(torch.int64)
        lo = torch.where(valid, lo, _BIG).to(torch.int64)
        perm = torch.argsort(hi * (1 << 31) + lo, stable=True)
        hi_s, lo_s = hi[perm], lo[perm]
        pts_s, t_s = pts[perm], t[perm]
        valid_s = hi_s != _BIG
        cell_s = torch.floor(pts_s / size).to(torch.int32)

        is_start = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                              (hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1])])
        seg_id = torch.cumsum(is_start.to(torch.int64), 0) - 1

        anchor = (cell_s.to(dtype) + 0.5) * size
        q = torch.where(valid_s[:, None], pts_s - anchor, 0.0)
        tw = torch.where(valid_s, t_s, 0.0).to(dtype)
        chan = torch.cat([valid_s.to(dtype)[:, None], q, _sym6(q), tw[:, None]], 1)
        cumz = df_prefix(chan)

        start_arr = _compact_positions(is_start, seg_id, v_cap, p_cap)
        sums = df_range_sum(cumz, start_arr[:-1], start_arr[1:])
        n_seg = sums[:, 0]
        n_safe = torch.clamp(n_seg, min=1.0)
        mean_q = sums[:, 1:4] / n_safe[:, None]
        cov = (_unpack_sym(sums[:, 4:10]) / n_safe[:, None, None]
               - mean_q[:, :, None] * mean_q[:, None, :])
        vals, _ = eigh3(cov)
        n_segs_valid = torch.sum((is_start & valid_s).to(torch.int64))
        n_seg_dropped = n_seg_dropped + torch.clamp(n_segs_valid - v_cap, min=0)
        per_level.append(dict(
            perm=perm, is_start=is_start, seg_id=seg_id, start_arr=start_arr,
            t_s=t_s, valid_s=valid_s, cell_s=cell_s, cumz=cumz, size=size,
            plane=_plane_test(vals, cfg.planer_threshold, cfg.min_plane_likeness, strict=True),
            big=n_seg > min_pts))

    # hierarchy gating per compact slot: a child's parent slot is the parent
    # level's seg_id (in input order) at the child's first point
    seg_id_input = []
    for lv in per_level[:-1]:
        sid = torch.empty_like(lv["seg_id"])
        sid[lv["perm"]] = lv["seg_id"]
        seg_id_input.append(sid)
    fitted = [per_level[0]["big"]]
    for l in range(1, n_levels):
        lv = per_level[l]
        parent_open = fitted[l - 1] if l == 1 else fitted[l - 1] & ~per_level[l - 1]["plane"]
        i0 = lv["perm"][torch.clip(lv["start_arr"][:-1], 0, p_cap - 1)]
        pseg = seg_id_input[l - 1][i0]
        ok = parent_open[torch.clip(pseg, 0, v_cap - 1)] & (pseg < v_cap)
        fitted.append(ok & lv["big"])
    cand = [fitted[l] & per_level[l]["plane"] for l in range(n_levels)]

    out_chunks = []
    n_cluster_dropped = n_seg_dropped
    for level in range(n_levels):
        lv = per_level[level]
        # per-slot candidacy to points: delta at the unique segment starts,
        # then a running sum (starts of absent slots, = p_cap, are dropped)
        ci = cand[level].to(torch.int64)
        dse = ci - torch.cat([zero_i[None], ci[:-1]])
        starts = lv["start_arr"][:-1]
        # the absent slots' starts (= p_cap) land in one extra slot that is
        # cut off: a fixed-shape scatter, no mask-selected index list
        scat = torch.zeros((p_cap + 1,), dtype=torch.int64, device=dev).index_put_(
            (starts.long(),), torch.where(starts < p_cap, dse, 0))[:p_cap]
        cand_s = (torch.cumsum(scat, 0) > 0) & (lv["seg_id"] < v_cap) & lv["valid_s"]

        gap = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                         (lv["t_s"][1:] - lv["t_s"][:-1]) > cfg.cluster_time_gap])
        new_cluster = (lv["is_start"] | gap) & cand_s
        cl_id = torch.cumsum(new_cluster.to(torch.int64), 0) - 1
        n_cluster_dropped = n_cluster_dropped + torch.clamp(
            torch.sum(new_cluster.to(torch.int64)) - nc, min=0)

        # end of the enclosing segment = next segment start after the point
        idx_or_end = torch.where(lv["is_start"], arange_p, p_cap)
        suffix_min = torch.flip(torch.cummin(torch.flip(idx_or_end, [0]), 0).values, [0])
        nxt = torch.cat([suffix_min[1:], torch.full((1,), p_cap, dtype=torch.int64, device=dev)])
        anchor_pts = (lv["cell_s"].to(dtype) + 0.5) * lv["size"]

        cl_start, (seg_end_h, ax, ay, az) = _compact_positions(
            new_cluster, cl_id, nc, p_cap,
            payload=(nxt, anchor_pts[:, 0], anchor_pts[:, 1], anchor_pts[:, 2]))
        cl_end = torch.maximum(torch.minimum(cl_start[1:], seg_end_h[:nc]), cl_start[:nc])
        sums = df_range_sum(lv["cumz"], cl_start[:nc], cl_end)
        n_cl = sums[:, 0]
        n_safe = torch.clamp(n_cl, min=1.0)
        mean_q = sums[:, 1:4] / n_safe[:, None]
        cov6 = sums[:, 4:10] / n_safe[:, None] - _sym6(mean_q)
        center = torch.stack([ax[:nc], ay[:nc], az[:nc]], 1) + mean_q
        vals, vecs = eigh3(_unpack_sym(cov6))
        keep = (n_cl >= min_pts) & _plane_test(vals, cfg.planer_threshold,
                                               cfg.min_plane_likeness, strict=False)
        norm = vecs[:, :, 0]
        flip = torch.sum(norm * center, dim=1) < 0.0
        out_chunks.append(dict(
            t=sums[:, 10] / n_safe, center=center, cov=cov6,
            norm=torch.where(flip[:, None], -norm, norm),
            resolution=torch.full((nc,), lv["size"], dtype=dtype, device=dev),
            std=torch.sqrt(torch.clamp(vals[:, 0], min=0.0)), valid=keep))

    merged = {k: torch.cat([c[k] for c in out_chunks], 0) for k in out_chunks[0]}
    cap = cfg.max_surfels_per_sweep
    bigt = torch.finfo(dtype).max
    order = torch.argsort(torch.where(merged["valid"], merged["t"], bigt), stable=True)[:cap]
    n_valid = torch.sum(merged["valid"].to(torch.int64))
    out = {k: v[order] for k, v in merged.items()}
    out["cov"] = _unpack_sym(out["cov"])
    out["n_dropped"] = n_cluster_dropped + torch.clamp(n_valid - cap, min=0)
    return out
