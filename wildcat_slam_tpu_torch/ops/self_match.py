"""The self-match fixed point of the surfel matcher: kernel K3 and its plain
version.

Counterpart of the ``lax.while_loop`` in ``wildcat_slam_tpu/odometry/match.py``
(``match_surfels(self_match=True)``, ``fp_body``/``fp_cond``), which the JAX
package runs on the device. Each round recomputes every query's first
accepted candidate that is not blocked, where rank r of query p is blocked
when its candidate c = cand[p, r] has p as its current partner and p > c;
the rounds stop when no partner changes, or after ``max_rounds``. On a CUDA
tensor :func:`self_match` launches ``csrc/self_match.cu`` (one block that
iterates to the fixed point, laid out by :func:`plan`); on a CPU tensor it
runs :func:`self_match_plain`, the same rounds with one host sync each.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from wildcat_slam_tpu_torch.ops import _build

LAUNCHES = 0  # kernel launches by self_match (not by self_match_plain)

# csrc/self_match.cu: one block of THREADS threads; partner (4 Q bytes) and
# the ok and dup bitmaps (Q k bits each) in its dynamic shared memory
THREADS = 1024
H100_SMEM_PER_BLOCK = 232_448  # opt-in shared memory of one block (227 KB)


class Plan(NamedTuple):
    threads: int     # the block's threads (the kernel is built for THREADS)
    smem_bytes: int  # partner, then the ok and dup bitmaps


def plan(q: int, k: int, smem_per_block: int = H100_SMEM_PER_BLOCK) -> Plan:
    """The kernel's launch for Q queries of k candidates. Raises ValueError
    when partner and the two bitmaps do not fit one block's shared memory."""
    if q < 1 or k < 1:
        raise ValueError(f"self_match: needs Q >= 1 and k >= 1, got Q={q}, k={k}")
    words = -(-q * k // 32)
    smem = 4 * (q + 2 * words)
    if smem > smem_per_block:
        raise ValueError(
            f"self_match: Q={q}, k={k} needs {smem} bytes of shared memory (4 Q for the "
            f"partners and 2 x 4 ceil(Q k / 32) for the ok and dup bitmaps), more than the "
            f"{smem_per_block} one block can hold: Q (4 + k / 4) <= {smem_per_block}")
    return Plan(THREADS, smem)


def supports(q: int, k: int) -> bool:
    """True when the kernel takes Q queries of k candidates."""
    try:
        plan(q, k)
    except ValueError:
        return False
    return True


def self_match_plain(cand: torch.Tensor, ok: torch.Tensor, max_rounds: int):
    """Plain version of the kernel: the rounds as whole-array tensor ops, one
    host sync a round for the convergence test. Returns (partner (Q,) int64
    with -1 for none, rounds run as a 0-dim int64 tensor)."""
    q_cap = cand.shape[0]
    dev = cand.device
    qidx = torch.arange(q_cap, device=dev)
    partner = torch.full((q_cap,), -1, dtype=torch.int64, device=dev)
    rounds = 0
    for _ in range(max_rounds):
        blocks = partner > qidx
        pc = torch.where(blocks, partner, 0)
        contrib = (cand[pc] == qidx[:, None]) & blocks[:, None]
        # integer scatter-add: distinct sources never collide on one slot
        dup = torch.zeros(ok.shape, dtype=torch.int32, device=dev).index_put_(
            (pc,), contrib.to(torch.int32), accumulate=True) > 0
        okr = ok & ~dup
        first = torch.argmax(okr.to(torch.int8), dim=1)
        new = torch.where(torch.any(okr, dim=1), cand[qidx, first], -1)
        changed = bool(torch.any(new != partner))
        partner = new
        rounds += 1
        if not changed:
            break
    return partner, torch.full((), rounds, dtype=torch.int64, device=dev)


def self_match(cand: torch.Tensor, ok: torch.Tensor, max_rounds: int):
    """The fixed point: the kernel for CUDA tensors, the plain version for CPU
    tensors. cand (Q, k) int64 candidate indices into the queries, ok (Q, k)
    bool. Returns (partner (Q,) int64, -1 for none; rounds run, 0-dim)."""
    global LAUNCHES
    q, k = cand.shape
    if ok.shape != (q, k) or ok.dtype != torch.bool or cand.dtype != torch.int64:
        raise ValueError(f"self_match: needs cand (Q, k) int64 and ok (Q, k) bool, got "
                         f"cand{tuple(cand.shape)} {cand.dtype}, ok{tuple(ok.shape)} {ok.dtype}")
    if cand.device.type == "cpu":
        return self_match_plain(cand, ok, max_rounds)
    if cand.device.type != "cuda" or ok.device != cand.device:
        raise ValueError(f"self_match: unsupported devices {cand.device}, {ok.device}")
    p = plan(q, k)
    dev = cand.device
    cand, ok = cand.contiguous(), ok.contiguous()
    partner = torch.empty((q,), dtype=torch.int64, device=dev)
    rounds = torch.empty((1,), dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):  # the C entry launches on the current card
        err = lib.wc_self_match(cand.data_ptr(), ok.data_ptr(), partner.data_ptr(),
                                rounds.data_ptr(), q, k, int(max_rounds), *p,
                                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "wc_self_match")
    LAUNCHES += 1
    return partner, rounds[0].to(torch.int64)
