"""Surfel extraction: hierarchical voxel plane fitting + temporal clustering.

Counterpart of ``wildcat_slam_tpu/odometry/surfel.py`` (see its module doc for
the gating semantics, which are kept exactly): three flat voxel levels, per
segment moments as range differences of one compensated running sum, the
closed-form eigh3 plane test, and temporal clustering of candidate nodes.

The multi-operand ``lax.sort`` calls of the JAX version become a stable
argsort of one key plus gathers (``lax.sort`` is stable by default, so the
order of equal keys is the same). Two int32 keys sort as one int64 key
``hi * 2^31 + lo``, which orders exactly like the lexicographic pair.
"""

from __future__ import annotations

import torch

from wildcat_slam_tpu_torch.config import WildcatConfig
from wildcat_slam_tpu_torch.ops import voxel
from wildcat_slam_tpu_torch.ops.dfsum import df_prefix, df_range_sum
from wildcat_slam_tpu_torch.ops.eigh3 import eigh3

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


def extract_surfels(pts: torch.Tensor, t: torch.Tensor, valid: torch.Tensor,
                    cfg: WildcatConfig) -> dict:
    """Extract surfels from one undistorted sweep (world frame, time-sorted).

    Returns a dict of world-frame surfel arrays of length
    ``cfg.max_surfels_per_sweep`` (t, center, cov, norm, resolution, std,
    valid) sorted by time, plus ``n_dropped``: candidates lost to the static
    capacities."""
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
