"""Per-bin KNN candidate search: kernel K2 and its plain version.

Counterpart of ``wildcat_slam_tpu/ops/knn_pallas.py`` (vpu mode). Targets are
binned by ``index mod n_bins``; for each query and bin the search keeps the
smallest squared descriptor distance and its target index (earlier target on
ties). An exact top-k over the (Q, n_bins) result then gives the k
candidates: the same partial reduce that ``lax.approx_max_k`` performs, with
~98% recall at k=10, n_bins=512. On a CUDA tensor :func:`knn_bins` launches
``csrc/knn_bins.cu``; on a CPU tensor it runs :func:`knn_bins_plain`.
"""

from __future__ import annotations

import torch

from wildcat_slam_tpu_torch.ops import _build

LAUNCHES = 0  # kernel launches by knn_bins (not by knn_bins_plain)

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


def knn_bins_plain(dq: torch.Tensor, dt: torch.Tensor, n_bins: int):
    """Plain version of the kernel: per-bin minima (Q, n_bins) f32 and their
    target indices (Q, n_bins) int32. ``dt`` (T, D) with T a multiple of
    n_bins; walks T one n_bins-wide group at a time, so no (Q, T) matrix forms."""
    q, t = dq.shape[0], dt.shape[0]
    lanes = torch.arange(n_bins, dtype=torch.int32, device=dq.device)
    vals = idx = None
    for g in range(t // n_bins):
        s = _sqdist(dq, dt[g * n_bins:(g + 1) * n_bins])
        gidx = (lanes + g * n_bins).expand(q, n_bins)
        if vals is None:
            vals, idx = s, gidx.clone()
            continue
        better = s < vals  # strict: ties keep the earlier target
        vals = torch.where(better, s, vals)
        idx = torch.where(better, gidx, idx)
    return vals, idx


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


def knn_topk(dq: torch.Tensor, dt: torch.Tensor, k: int, n_bins: int = 512,
             chunk_t: int = 2048, mode: str = "vpu"):
    """k candidate targets per query by squared L2 distance through the bins
    (the contract of ``knn_topk_fused``): (indices (Q, k) int64, squared
    distances (Q, k) f32). Rows to exclude must be pre-masked far away.
    Only the per-dimension ("vpu") scoring is ported."""
    if mode != "vpu":
        raise NotImplementedError(
            f"knn_topk mode={mode!r}: the augmented-matmul 'mxu' scoring of the JAX "
            "kernel is not ported yet (ROADMAP.md); only 'vpu' is")
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
