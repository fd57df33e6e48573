"""The self-match fixed point of the surfel matcher: kernel K3 and its plain
version.

Counterpart of the ``lax.while_loop`` in ``wildcat_slam_tpu/odometry/match.py``
(``match_surfels(self_match=True)``, ``fp_body``/``fp_cond``), which the JAX
package runs on the device. Each round recomputes every query's first
accepted candidate that is not blocked, where rank r of query q is blocked
when its candidate c = cand[q, r] satisfies 0 <= c < q and has q as its
current partner; the rounds stop when no partner changes, or after
``max_rounds``. On a CUDA tensor :func:`self_match` launches
``csrc/self_match.cu`` (one block that iterates to the fixed point, laid
out by :func:`plan`); on a CPU tensor it runs :func:`self_match_plain`, the
same rounds with one host sync each.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from wildcat_slam_tpu_torch.ops import _build

LAUNCHES = 0  # kernel launches by self_match (not by self_match_plain)

# csrc/self_match.cu: one block of THREADS threads; the partners, two 16-bit
# buffers (4 Q bytes), in its dynamic shared memory, and beside them each
# query's candidate list (k + 1 16-bit slots, each slot a row of
# list_stride(Q) values) when those 2 (k + 1) list_stride(Q) bytes fit, else
# in a global scratch
THREADS = 1024
MAX_QUERIES = 0xFFFE  # 16-bit partners and list slots; 0xFFFF and 0xFFFE are markers
H100_SMEM_PER_BLOCK = 232_448  # opt-in shared memory of one block (227 KB)


def list_stride(q: int) -> int:
    """The lists' row stride in 16-bit slots: Q rounded up to 64, plus 2
    (csrc/self_match.cu, list_stride: fewer shared-memory bank conflicts)."""
    return -(-q // 64) * 64 + 2


class Plan(NamedTuple):
    threads: int        # the block's threads (the kernel is built for THREADS)
    smem_bytes: int     # the two partner buffers, then the lists when they fit
    shared_lists: bool  # the lists in shared memory (else in a global scratch)


def plan(q: int, k: int, smem_per_block: int = H100_SMEM_PER_BLOCK) -> Plan:
    """The kernel's launch for Q queries of k candidates. Raises ValueError
    when the two partner buffers do not fit one block's shared memory."""
    if q < 1 or k < 1:
        raise ValueError(f"self_match: needs Q >= 1 and k >= 1, got Q={q}, k={k}")
    partners = 4 * q
    if q > MAX_QUERIES or partners > smem_per_block:
        raise ValueError(
            f"self_match: Q={q} needs {partners} bytes of shared memory for the partners (two "
            f"16-bit buffers), more than the {smem_per_block} one block can hold, or more than "
            f"{MAX_QUERIES} queries")
    lists = 2 * list_stride(q) * (k + 1)
    shared = partners + lists <= smem_per_block
    return Plan(THREADS, partners + lists if shared else partners, shared)


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
    lists = None if p.shared_lists else torch.empty(list_stride(q) * (k + 1), dtype=torch.int16,
                                                    device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):  # the C entry launches on the current card
        err = lib.wc_self_match(cand.data_ptr(), ok.data_ptr(), partner.data_ptr(),
                                rounds.data_ptr(), None if lists is None else lists.data_ptr(),
                                q, k, int(max_rounds), p.threads, p.smem_bytes,
                                int(p.shared_lists), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "wc_self_match")
    LAUNCHES += 1
    return partner, rounds[0].to(torch.int64)
