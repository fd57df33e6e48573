"""Sliding/fixed window management over fixed-capacity arrays.

Counterpart of ``wildcat_slam_tpu/odometry/window.py``: sample-state append,
slot insertion of surfels with oldest-first eviction, the sliding->fixed
migration, and time rebasing. Every argsort is stable, as ``jnp.argsort`` is.
"""

from __future__ import annotations

import torch

from wildcat_slam_tpu_torch.odometry import imu as imu_mod
from wildcat_slam_tpu_torch.odometry.states import ImuStates, SampleStates, Surfels


def _argsort(x: torch.Tensor) -> torch.Tensor:
    return torch.argsort(x, stable=True)


def shift_left(buf: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Drop the first n entries (clamped gather; the tail repeats, unread)."""
    cap = buf.shape[0]
    return buf[torch.clip(torch.arange(cap, device=buf.device) + n, 0, cap - 1)]


def add_sample_states(sample: SampleStates, imu: ImuStates, new_t: torch.Tensor,
                      n_new: torch.Tensor) -> SampleStates:
    """Append up to A new sample states at the given times: poses by
    lerp/slerp of IMU states, biases copied from the current back state."""
    c = sample.count
    pos, rot = imu_mod.interp_pose(imu, new_t)
    last_cor = imu_mod.row_at(sample.cor, c - 1)
    new_cor = torch.zeros((new_t.shape[0], 12), dtype=sample.cor.dtype, device=new_t.device)
    new_cor[:, 6:12] = last_cor[6:12]
    put = imu_mod.put_rows
    return sample.replace(t=put(sample.t, new_t, c), rot=put(sample.rot, rot, c),
                          pos=put(sample.pos, pos, c), cor=put(sample.cor, new_cor, c),
                          count=c + n_new)


def insert_surfels(win: Surfels, new: Surfels, win_aux: torch.Tensor | None = None,
                   new_aux: torch.Tensor | None = None):
    """Insert ``new``'s valid entries into a window's free slots, evicting the
    oldest valid entries when free slots run short. Returns (window, evicted)
    plus the updated aux table when ``new_aux`` is given; ``evicted`` has
    ``new.capacity`` rows."""
    m = new.capacity
    big = torch.finfo(win.t.dtype).max
    slots = _argsort(torch.where(win.valid, win.t, -big))[:m]
    ckey = torch.where(new.valid, new.t, big)
    order = _argsort(ckey)[:m]
    newc = new.map(lambda x: x[order])
    newc = newc.replace(valid=newc.valid & (ckey[order] < big))
    write = torch.arange(m, device=win.t.device) < torch.sum(newc.valid.to(torch.int64))

    # slot order makes the write indices sorted and unique
    slot_order = _argsort(slots)
    slots_s = slots[slot_order]
    newc = newc.map(lambda x: x[slot_order])
    write_s = write[slot_order]
    evicted = win.map(lambda x: x[slots_s])
    evicted = evicted.replace(valid=evicted.valid & write_s)

    def put(buf, vals):
        sel = write_s.reshape((-1,) + (1,) * (buf.ndim - 1))
        out = buf.clone()
        out[slots_s] = torch.where(sel, vals.to(buf.dtype), buf[slots_s])
        return out

    nf = newc.fields()
    out = Surfels(**{k: put(v, nf[k]) for k, v in win.fields().items()})
    if new_aux is None:
        return out, evicted
    return out, evicted, put(win_aux, new_aux[order][slot_order])


def extract_moved(sld: Surfels, t_cut: torch.Tensor, capacity: int):
    """Pull up to ``capacity`` of the oldest surfels with ``t < t_cut`` out of
    the sliding window. Returns (sld, moved)."""
    big = torch.finfo(sld.t.dtype).max
    move = sld.valid & (sld.t < t_cut)
    idx = _argsort(torch.where(move, sld.t, big))[:capacity]
    taken = (torch.arange(capacity, device=sld.t.device)
             < torch.clamp(torch.sum(move.to(torch.int64)), max=capacity))
    moved = sld.map(lambda x: x[idx])
    moved = moved.replace(valid=moved.valid & taken)
    valid = sld.valid.clone()
    valid[idx] = torch.where(taken, False, sld.valid[idx])
    return sld.replace(valid=valid), moved


def rebase_times(sample: SampleStates, imu: ImuStates, sld: Surfels, fix: Surfels):
    """Shift all window-relative times so the sample front is 0; returns the
    shift (the host adds it to its f64 epoch)."""
    shift = sample.t[0]
    sample = sample.replace(t=torch.where(sample.mask, sample.t - shift, 0.0))
    imu = imu.replace(t=torch.where(imu.mask, imu.t - shift, 0.0))
    sld = sld.replace(t=torch.where(sld.valid, sld.t - shift, 0.0))
    fix = fix.replace(t=torch.where(fix.valid, fix.t - shift, 0.0))
    return sample, imu, sld, fix, shift
