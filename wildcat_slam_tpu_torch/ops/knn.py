"""Per-bin KNN candidate search: kernel K2 in its two scorings, and their
plain versions.

Counterpart of ``wildcat_slam_tpu/ops/knn_pallas.py``. Targets are binned by
``index mod n_bins``; for each query and bin the search keeps the smallest
score and its target index (earlier target on ties). An exact top-k over the
(Q, n_bins) result then gives the k candidates: the same partial reduce that
``lax.approx_max_k`` performs, with ~98% recall at k=10, n_bins=512.

- "vpu" scoring, the matcher's: the exact per-dimension squared distance. On
  a CUDA tensor :func:`knn_bins` launches ``csrc/knn_bins.cu``; on a CPU
  tensor it runs :func:`knn_bins_plain`.
- "mxu" scoring: the augmented product ``[-2q, 1, 0..] . [t; |t|^2; 0..] =
  |t|^2 - 2 q.t`` in f32, with ``|q|^2`` added back by :func:`knn_topk`. On a
  CUDA tensor :func:`knn_bins_mxu` launches ``csrc/knn_mxu.cu`` (tensor cores,
  3xTF32 split); on a CPU tensor it runs :func:`knn_bins_mxu_plain`.
"""

from __future__ import annotations

import torch

from wildcat_slam_tpu_torch.ops import _build

LAUNCHES = 0  # kernel launches by knn_bins (not by knn_bins_plain)
MXU_LAUNCHES = 0  # kernel launches by knn_bins_mxu (not by knn_bins_mxu_plain)

FAR = 1e6  # padding descriptor value: padded targets never win a bin


def _sqdist(dq: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    """(Q, C) squared distances, one subtract/multiply/add per dimension in
    order -- the kernel's exact rounding sequence (no FMA)."""
    d = dq[:, None, 0] - dt[None, :, 0]
    s = d * d
    for dim in range(1, dq.shape[1]):
        d = dq[:, None, dim] - dt[None, :, dim]
        s = s + d * d
    return s


def _fold_groups(score_group, q: int, t: int, n_bins: int, device):
    """Per-bin running minima over the n_bins-wide target groups, in target
    order with a strict '<': ``score_group(g)`` is the (Q, n_bins) score tile
    of targets [g * n_bins, (g + 1) * n_bins)."""
    lanes = torch.arange(n_bins, dtype=torch.int32, device=device)
    vals = idx = None
    for g in range(t // n_bins):
        s = score_group(g)
        gidx = (lanes + g * n_bins).expand(q, n_bins)
        if vals is None:
            vals, idx = s, gidx.clone()
            continue
        better = s < vals  # strict: ties keep the earlier target
        vals = torch.where(better, s, vals)
        idx = torch.where(better, gidx, idx)
    return vals, idx


def knn_bins_plain(dq: torch.Tensor, dt: torch.Tensor, n_bins: int):
    """Plain version of the kernel: per-bin minima (Q, n_bins) f32 and their
    target indices (Q, n_bins) int32. ``dt`` (T, D) with T a multiple of
    n_bins; walks T one n_bins-wide group at a time, so no (Q, T) matrix forms."""
    return _fold_groups(lambda g: _sqdist(dq, dt[g * n_bins:(g + 1) * n_bins]),
                        dq.shape[0], dt.shape[0], n_bins, dq.device)


def knn_bins(dq: torch.Tensor, dt: torch.Tensor, n_bins: int):
    """Per-bin minima and indices: the kernel for CUDA tensors, the plain
    version for CPU tensors. dq (Q, D), dt (T, D) float32, T % n_bins == 0."""
    global LAUNCHES
    q, d = dq.shape
    t = dt.shape[0]
    if dt.shape[1] != d or t % n_bins or t < n_bins:
        raise ValueError(f"knn_bins: bad shapes dq{tuple(dq.shape)} dt{tuple(dt.shape)} "
                         f"n_bins={n_bins}")
    if dq.device.type == "cpu":
        return knn_bins_plain(dq, dt, n_bins)
    if dq.device.type != "cuda" or dt.device != dq.device:
        raise ValueError(f"knn_bins: unsupported devices {dq.device}, {dt.device}")
    if dq.dtype != torch.float32 or dt.dtype != torch.float32:
        raise ValueError("knn_bins: the kernel takes float32 descriptors")
    if d not in (3, 6, 8):
        raise ValueError(f"knn_bins: the kernel is built for D in (3, 6, 8), got {d}")
    dqc = dq.contiguous()
    dtt = dt.t().contiguous()
    vals = torch.empty((q, n_bins), dtype=torch.float32, device=dq.device)
    idx = torch.empty((q, n_bins), dtype=torch.int32, device=dq.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(dq.device).cuda_stream
    err = lib.wc_knn_bins(dqc.data_ptr(), dtt.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                          q, t, d, n_bins, stream)
    _build.check(err, "wc_knn_bins")
    LAUNCHES += 1
    return vals, idx


def knn_bins_mxu_plain(dq_aug: torch.Tensor, dtt_aug: torch.Tensor, n_bins: int):
    """Plain version of the mxu kernel: scores ``dq_aug @ dtt_aug`` (Q, KD) x
    (KD, T) as full-f32 products (TF32 off, ``_numerics.py``), folded per bin
    one n_bins-wide target group at a time (no (Q, T) matrix forms)."""
    return _fold_groups(lambda g: dq_aug @ dtt_aug[:, g * n_bins:(g + 1) * n_bins],
                        dq_aug.shape[0], dtt_aug.shape[1], n_bins, dq_aug.device)


def knn_bins_mxu(dq_aug: torch.Tensor, dtt_aug: torch.Tensor, n_bins: int):
    """Per-bin minima of the augmented scores and their indices: the kernel for
    CUDA tensors, the plain version for CPU tensors. dq_aug (Q, 8), dtt_aug
    (8, T) float32 (:func:`mxu_embedding`), T % n_bins == 0, n_bins % 8 == 0."""
    global MXU_LAUNCHES
    q, kd = dq_aug.shape
    t = dtt_aug.shape[1]
    if dtt_aug.shape[0] != kd or t % n_bins or t < n_bins:
        raise ValueError(f"knn_bins_mxu: bad shapes dq_aug{tuple(dq_aug.shape)} "
                         f"dtt_aug{tuple(dtt_aug.shape)} n_bins={n_bins}")
    if dq_aug.device.type == "cpu":
        return knn_bins_mxu_plain(dq_aug, dtt_aug, n_bins)
    if dq_aug.device.type != "cuda" or dtt_aug.device != dq_aug.device:
        raise ValueError(f"knn_bins_mxu: unsupported devices {dq_aug.device}, {dtt_aug.device}")
    if dq_aug.dtype != torch.float32 or dtt_aug.dtype != torch.float32:
        raise ValueError("knn_bins_mxu: the kernel takes float32 embeddings")
    if kd != 8 or n_bins % 8:
        raise ValueError(f"knn_bins_mxu: the kernel takes depth 8 and n_bins % 8 == 0, "
                         f"got depth {kd}, n_bins={n_bins}")
    dqc, dtc = dq_aug.contiguous(), dtt_aug.contiguous()
    vals = torch.empty((q, n_bins), dtype=torch.float32, device=dq_aug.device)
    idx = torch.empty((q, n_bins), dtype=torch.int32, device=dq_aug.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(dq_aug.device).cuda_stream
    err = lib.wc_knn_mxu(dqc.data_ptr(), dtc.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                         q, t, n_bins, stream)
    _build.check(err, "wc_knn_mxu")
    MXU_LAUNCHES += 1
    return vals, idx


def mxu_embedding(dq: torch.Tensor, dt: torch.Tensor):
    """The augmented embedding of ``knn_topk_fused(mode="mxu")``, padded to the
    mma depth of 8 instead of 128: dq_aug (Q, 8) rows ``[-2q, 1, 0..]`` and
    dtt_aug (8, T) columns ``[t; |t|^2; 0..]``. The kernel runs one m16n8k8
    step, so D + 1 <= 8: the matcher's descriptors have D = 6."""
    (q, d), t = dq.shape, dt.shape[0]
    if d + 1 > 8:
        raise ValueError(f"mxu scoring takes D <= 7 descriptor dims (one depth-8 mma step), "
                         f"got {d}")
    dq_aug = torch.cat([-2.0 * dq, torch.ones((q, 1), dtype=dq.dtype, device=dq.device),
                        torch.zeros((q, 7 - d), dtype=dq.dtype, device=dq.device)], 1)
    t2 = torch.sum(dt * dt, dim=1, keepdim=True)
    dtt_aug = torch.cat([dt, t2, torch.zeros((t, 7 - d), dtype=dt.dtype,
                                             device=dt.device)], 1).t().contiguous()
    return dq_aug, dtt_aug


def knn_topk(dq: torch.Tensor, dt: torch.Tensor, k: int, n_bins: int = 512,
             chunk_t: int = 2048, mode: str = "vpu"):
    """k candidate targets per query by squared L2 distance through the bins
    (the contract of ``knn_topk_fused``): (indices (Q, k) int64, squared
    distances (Q, k) f32). Rows to exclude must be pre-masked far away.
    ``mode`` "vpu" scores exact per-dimension distances (:func:`knn_bins`),
    "mxu" the augmented product (:func:`knn_bins_mxu`) plus ``|q|^2``."""
    if mode not in ("vpu", "mxu"):
        raise ValueError(f"knn_topk: mode must be 'vpu' or 'mxu', got {mode!r}")
    t_orig = dt.shape[0]
    nb = min(n_bins, max(128, -(-t_orig // 128) * 128))
    tc = max(nb, min(chunk_t, -(-t_orig // nb) * nb))
    tc -= tc % nb
    dq = dq.to(torch.float32)
    dt = dt.to(torch.float32)
    pad = (-t_orig) % tc
    if pad:
        dt = torch.cat([dt, torch.full((pad, dt.shape[1]), FAR, dtype=dt.dtype,
                                       device=dt.device)])
    if mode == "mxu":
        vals, idx = knn_bins_mxu(*mxu_embedding(dq, dt), nb)
        # scores are |t|^2 - 2 q.t: restore true squared distances
        vals = vals + torch.sum(dq * dq, dim=1, keepdim=True)
    else:
        vals, idx = knn_bins(dq, dt, nb)
    kk = min(k, nb)
    # stable ascending sort: ties take the lower bin first, as lax.top_k does
    order = torch.sort(vals, dim=1, stable=True).indices[:, :kk]
    knn = torch.gather(idx, 1, order).to(torch.int64)
    d2 = torch.gather(vals, 1, order)
    if kk < k:
        knn = torch.cat([knn] + [knn[:, -1:]] * (k - kk), 1)
        d2 = torch.cat([d2] + [d2[:, -1:]] * (k - kk), 1)
    return knn, d2
