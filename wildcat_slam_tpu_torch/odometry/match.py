"""Surfel correspondence search.

Counterpart of ``wildcat_slam_tpu/odometry/match.py`` (see its module doc for
the acceptance filters and the proof that the fixed-point self-match equals
the reference's sequential accept loop). The k candidates per query come from
:func:`knn_search`: with ``approx=True`` the per-bin search of
``ops/knn.py`` (kernel K2 on CUDA tensors), with ``approx=False`` an exact
top-k over a full-f32 Gram. The JAX gate that sent only Q*T >= 2^30 on a TPU
to the fused kernel was a TPU crossover; here ``approx=True`` is K2 at every
size. The self-match's fixed point (the JAX ``lax.while_loop``) is
``ops/self_match.py``: kernel K3, one launch that iterates on the card, on
CUDA tensors, its plain version on CPU tensors.
"""

from __future__ import annotations

import math

import torch

from wildcat_slam_tpu_torch.ops import knn as knn_mod
from wildcat_slam_tpu_torch.ops import self_match as sm_mod


def knn_search(cq, nq, vq, ct, nt, vt, *, center_dist: float = 1.0,
               angular_dist: float = 5.0 * math.pi / 180.0, k: int = 10,
               approx: bool = True):
    """k nearest targets per query in the 6-D scaled descriptor space.
    Returns (indices (Q, k) int64, squared distances (Q, k))."""
    dtype = cq.dtype
    # re-center about the valid-query centroid: the expand-the-square distance
    # cancels in f32 once |c|^2 dwarfs the separations
    wsum = torch.clamp(torch.sum(vq.to(dtype)), min=1.0)
    c0 = torch.sum(torch.where(vq[:, None], cq, 0.0), dim=0) / wsum
    dq = torch.cat([(cq - c0) / center_dist, nq / angular_dist], 1)
    dt = torch.cat([(ct - c0) / center_dist, nt / angular_dist], 1)
    far = knn_mod.FAR
    dt = torch.where(vt[:, None], dt, far)
    dq = torch.where(vq[:, None], dq, -far)
    if approx:
        return knn_mod.knn_topk(dq, dt, k)
    d2 = (torch.sum(dq * dq, dim=1)[:, None] - 2.0 * (dq @ dt.T)
          + torch.sum(dt * dt, dim=1)[None, :])
    # stable ascending sort: ties take the lower target index, as lax.top_k does
    vals, knn = torch.sort(d2, dim=1, stable=True)
    return knn[:, :k], vals[:, :k]


def match_surfels(cq, nq, tq, vq, ct, nt, tt, vt, *, center_dist: float = 1.0,
                  angular_dist: float = 5.0 * math.pi / 180.0, surfel_dist: float = 0.1,
                  time_diff: float = 0.06, k: int = 10, max_pairs: int = 8192,
                  self_match: bool = False, approx: bool = True):
    """Match query surfels against targets. Returns (iq, it, valid, n_dropped):
    (max_pairs,) index arrays with a validity mask, plus the count of accepted
    pairs that did not fit."""
    q_cap = cq.shape[0]
    dev = cq.device
    knn, _ = knn_search(cq, nq, vq, ct, nt, vt, center_dist=center_dist,
                        angular_dist=angular_dist, k=k, approx=approx)
    dtype = cq.dtype
    tgt = torch.cat([tt[:, None], ct, nt, vt.to(dtype)[:, None]], 1)
    g = tgt[knn]
    cand_n = g[..., 4:7]
    cosang = torch.clip(torch.sum(nq[:, None, :] * cand_n, dim=-1), -1.0, 1.0)
    pp = torch.abs(torch.sum(nq[:, None, :] * (cq[:, None, :] - g[..., 1:4]), dim=-1))
    cos_thr = torch.cos(torch.full((), angular_dist, dtype=dtype, device=dev))
    ok = ((g[..., 7] > 0.5) & vq[:, None] & (torch.abs(g[..., 0] - tq[:, None]) >= time_diff)
          & (cosang >= cos_thr) & (pp <= surfel_dist))

    qidx = torch.arange(q_cap, device=dev)
    if self_match:
        # the fixed point of the sequential recurrence: kernel K3 on the card,
        # its plain version (one host sync a round) on the CPU
        partner, _ = sm_mod.self_match(knn, ok, q_cap)
        matched = partner != -1
    else:
        matched = torch.any(ok, dim=1)
        first = torch.argmax(ok.to(torch.int8), dim=1)
        partner = torch.where(matched, knn[qidx, first], -1)

    emit = matched
    n_dropped = torch.clamp(torch.sum(emit.to(torch.int64)) - max_pairs, min=0)
    order = torch.argsort((~emit).to(torch.int8), stable=True)[:max_pairs]
    it = torch.where(emit[order], partner[order], 0)
    return qidx[order], it, emit[order], n_dropped
