"""Voxel key packing and masked segment utilities.

Counterpart of ``wildcat_slam_tpu/ops/voxel.py``: points get packed integer
cell keys, are stably sorted, and reduce per segment.
"""

from __future__ import annotations

import torch

# 20 bits per axis, biased: cell coords in [-2^19, 2^19).
_BITS = 20
_BIAS = 1 << (_BITS - 1)


def split_keys(cell_xyz: torch.Tensor):
    """Pack int32 cell coords (N, 3) into two int32 sort keys (30 bits each)."""
    c = cell_xyz + _BIAS
    hi = (c[..., 0] << 10) | (c[..., 1] >> 10)
    lo = ((c[..., 1] & 1023) << 20) | c[..., 2]
    return hi, lo


def segment_ids_from_sorted_keys(sorted_keys: torch.Tensor):
    """(segment_id (N,), is_start (N,)) for sorted keys; ids are 0-based."""
    is_start = torch.cat([torch.ones((1,), dtype=torch.bool, device=sorted_keys.device),
                          sorted_keys[1:] != sorted_keys[:-1]])
    seg_id = torch.cumsum(is_start.to(torch.int32), 0, dtype=torch.int32) - 1
    return seg_id, is_start


def segment_start_positions(seg_id: torch.Tensor, is_start: torch.Tensor, num_segments: int):
    """Index of each segment's first element; absent segments report N.
    Starts of segments past ``num_segments`` are dropped (the JAX scatter's
    ``mode="drop"``; here the out-of-range rows are masked explicitly)."""
    n = seg_id.shape[0]
    out = torch.full((num_segments,), n, dtype=torch.int32, device=seg_id.device)
    keep = is_start & (seg_id >= 0) & (seg_id < num_segments)
    pos = torch.arange(n, dtype=torch.int32, device=seg_id.device)
    out[seg_id[keep].long()] = pos[keep]
    return out
