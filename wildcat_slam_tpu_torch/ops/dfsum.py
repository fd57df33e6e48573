"""Compensated prefix sums for range-reduction numerics.

Counterpart of ``wildcat_slam_tpu/ops/dfsum.py`` (see its module doc for why
a plain f32 running sum is not enough for the surfel moments). ``df_cumsum``
is the double-float (hi, lo) scan with error-free two-sums; here it is a
log-step (Hillis-Steele) scan, so its association order differs from
``lax.associative_scan``'s and results agree to the double-float error
(~2^-46 relative), not bit for bit. ``df_prefix``/``df_range_sum`` are the
blocked two-level layout the surfel extraction uses.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def _two_sum(a, b):
    """Error-free transformation: a + b = s + err exactly (Knuth two-sum)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _combine(ph, pl, qh, ql):
    s, e = _two_sum(ph, qh)
    e = e + pl + ql
    hi = s + e
    lo = e - (hi - s)
    return hi, lo


def df_cumsum(x: torch.Tensor, dim: int = 0):
    """Cumulative sum of ``x`` along ``dim`` in double-float precision.
    Returns ``(hi, lo)``; ``hi + lo`` is the prefix sum."""
    hi = x.movedim(dim, 0)
    lo = torch.zeros_like(hi)
    n = hi.shape[0]
    off = 1
    while off < n:
        nh, nl = _combine(hi[:-off], lo[:-off], hi[off:], lo[off:])
        hi = torch.cat([hi[:off], nh])
        lo = torch.cat([lo[:off], nl])
        off *= 2
    return hi.movedim(0, dim), lo.movedim(0, dim)


class DfPrefix(NamedTuple):
    """Blocked compensated prefix over axis 0."""

    bp_hi: torch.Tensor   # (B+1, C) double-float block-prefix high words
    bp_lo: torch.Tensor   # (B+1, C) low words
    inb: torch.Tensor     # (N, C) exclusive in-block cumsum
    block: int


def df_prefix(x: torch.Tensor, block: int = 128) -> DfPrefix:
    """Blocked prefix structure for range sums over ``x[s:e]``; ``x`` is (N, C)."""
    n, c = x.shape
    while n % block:
        block //= 2
    block = min(block, 128)
    b = n // block
    xb = x.reshape(b, block, c)
    # exclusive in-block cumsum as a strictly-lower-triangular ones product
    # (full f32: TF32 is off, see _numerics.py)
    sl = torch.tril(torch.ones((block, block), dtype=x.dtype, device=x.device), -1)
    inb = torch.matmul(sl, xb).reshape(n, c)
    totals = torch.sum(xb, dim=1)
    hi, lo = df_cumsum(totals, dim=0)
    zero = torch.zeros((1, c), dtype=x.dtype, device=x.device)
    return DfPrefix(torch.cat([zero, hi]), torch.cat([zero, lo]), inb, block)


def df_range_sum(pfx: DfPrefix, start: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """Sum of rows [start, end) of the prefixed array; indices in [0, N]
    (N is the open-ended sentinel)."""
    n = pfx.inb.shape[0]
    sb = torch.div(start, pfx.block, rounding_mode="floor")
    eb = torch.div(end, pfx.block, rounding_mode="floor")

    def inb_at(i):
        v = pfx.inb[torch.clamp(i, max=n - 1)]
        return v * (i < n).to(v.dtype)[..., None]

    return ((pfx.bp_hi[eb] - pfx.bp_hi[sb]) + (pfx.bp_lo[eb] - pfx.bp_lo[sb])
            + (inb_at(end) - inb_at(start)))
