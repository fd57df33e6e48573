"""The launch geometry of the two redesigned kernels, in pure Python.

K1 (``csrc/pcg.cu``) is laid out by ``ops/pcg.launch_plan``: which block
owns which 12-row block-rows of H, how many of them it keeps in shared
memory, and how much shared memory it asks for. K2 vpu (``csrc/knn_bins.cu``)
is launched with ``ops/knn.bins_grid``: its grid, bins a block and queries a
thread. Both kernels take their launch from these functions. Neither kernel
runs here; these tests hold the Python side of K1's plan to the constants in
its CUDA source, and both launches to what the kernels must guarantee: every
block-row has one owner, a block's shared memory fits the H100, and every
(query, bin) output has exactly one writer. The last test holds the SASS
reader of ``chip_smoke.py`` (K2's instructions per pair) to a short listing.
No JAX is imported.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

from wildcat_slam_tpu_torch.ops import knn, pcg

CSRC = Path(pcg.__file__).resolve().parent.parent / "csrc"
H100_SMS = 132
SMEM_LIMIT = 232_448  # bytes of shared memory one H100 block can opt in to


def _constant(source: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert m, f"{name} not found in csrc/{source}"
    return int(m.group(1))


def test_pcg_plan_constants_match_the_kernel():
    threads = _constant("pcg.cu", "kThreads")
    row_lanes = _constant("pcg.cu", "kRowLanes")
    assert pcg.MAX_ROWS_PER_BLOCK == threads // row_lanes
    assert pcg.STATIC_SMEM == _constant("pcg.cu", "kStaticSmem")
    assert pcg.H100_SMEM_PER_BLOCK == SMEM_LIMIT


@pytest.mark.parametrize("s_cap", [1, 8, 96, 192, 256, 1000])
def test_pcg_plan_owns_every_block_row_once(s_cap):
    plan = pcg.launch_plan(s_cap, H100_SMS)
    assert 1 <= plan.grid <= H100_SMS  # one co-resident block per SM at most
    owners = np.zeros(s_cap, dtype=int)
    for blk in range(plan.grid):  # block blk owns [blk k, min((blk + 1) k, S)), as in the kernel
        first = blk * plan.rows_per_block
        owned = min(plan.rows_per_block, s_cap - first)
        assert owned >= 1
        owners[first:first + owned] += 1
    assert np.all(owners == 1)
    assert plan.rows_per_block <= pcg.MAX_ROWS_PER_BLOCK


@pytest.mark.parametrize("s_cap", [1, 8, 96, 192, 256, 1000])
def test_pcg_plan_shared_memory_fits(s_cap):
    plan = pcg.launch_plan(s_cap, H100_SMS)
    n = 12 * s_cap
    # p, then the resident block-rows of H, beside the kernel's static shared memory
    assert plan.smem_bytes == 4 * n + plan.resident * 12 * n * 4
    assert plan.smem_bytes + pcg.STATIC_SMEM <= SMEM_LIMIT
    assert 0 <= plan.resident <= plan.rows_per_block


@pytest.mark.parametrize("s_cap,resident", [(1, 1), (8, 1), (96, 1), (192, 2), (256, 1), (1000, 0)])
def test_pcg_plan_residency(s_cap, resident):
    """S <= 192 keeps all of H in the grid's shared memory; S = 256 keeps one
    of each block's two block-rows and streams the other from L2; at S = 1000
    a block-row (576 KB) outgrows a block's shared memory and all stream."""
    plan = pcg.launch_plan(s_cap, H100_SMS)
    assert plan.resident == resident
    if s_cap <= 192:
        assert plan.resident == plan.rows_per_block
    else:
        assert plan.resident < plan.rows_per_block


def test_pcg_plan_refusals():
    with pytest.raises(ValueError, match=r"S=1001 blocks \(N=12012\) exceeds the kernel's N <= 12000"):
        pcg.launch_plan(pcg.MAX_N // 12 + 1, H100_SMS)
    with pytest.raises(ValueError, match="exceeds"):
        pcg.launch_plan(0, H100_SMS)
    # a card with too few SMs for 24 block-rows a block
    with pytest.raises(ValueError, match="do not fit a card with 40 SMs"):
        pcg.launch_plan(1000, 40)
    assert pcg.supports(1000) and not pcg.supports(1001) and not pcg.supports(0)


@pytest.mark.parametrize("q,n_bins,d", [(8192, 512, 6), (8201, 512, 6), (1001, 384, 6),
                                        (17, 128, 3), (999, 512, 8), (1, 128, 6), (300, 200, 6),
                                        (4097, 1024, 8)])
def test_knn_every_output_has_one_writer(q, n_bins, d):
    """The kernel's map from (block, thread, query slot) to its output
    (query, bin), b = blockIdx.x blockDim.x + threadIdx.x and q = blockIdx.y
    Q + slot, replayed over the launch bins_grid gives it: each output is
    written once."""
    gx, gy, threads, qpt = knn.bins_grid(q, n_bins, d)
    assert threads <= 128  # the kernel's launch bounds
    bx, by, tx, slot = np.meshgrid(np.arange(gx), np.arange(gy), np.arange(threads),
                                   np.arange(qpt), indexing="ij")
    b = bx * threads + tx
    qq = by * qpt + slot
    writes = (b < n_bins) & (qq < q)  # threads past the last bin return; ragged queries skip
    counts = np.zeros((q, n_bins), dtype=int)
    np.add.at(counts, (qq[writes], b[writes]), 1)
    assert np.all(counts == 1)


SASS = """
        Function : _ZN12_GLOBAL__N_115knn_bins_kernelILi6ELi16EEEvPKfS2_PfPiiii
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/              @!P0 BRA 0x0060 ;
        /*0020*/                   FADD R4, R2, -R3 ;
        /*0030*/                   FMUL R4, R4, R4 ;
        /*0040*/                   FSETP.GEU.AND P1, PT, R4, R5, PT ;
        /*0050*/              @!P2 BRA 0x0020 ;
        /*0060*/                   EXIT ;
        /*0070*/                   BRA 0x70;
        Function : _ZN12_GLOBAL__N_114knn_mxu_kernelEPKfS1_PfPiiii
        /*0000*/                   EXIT ;
"""


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sass_count_reads_the_loop():
    """The loop is the range closed by the one backward branch; forward
    branches and the trailing self-branch do not count."""
    smoke = _chip_smoke()
    funcs = smoke.sass_functions(SASS)
    k6 = "_ZN12_GLOBAL__N_115knn_bins_kernelILi6ELi16EEEvPKfS2_PfPiiii"
    assert list(funcs) == [k6, "_ZN12_GLOBAL__N_114knn_mxu_kernelEPKfS1_PfPiiii"]
    body = smoke.sass_loop(funcs[k6])
    assert [smoke.sass_opcode(t) for t in body] == ["FADD", "FMUL", "FSETP", "BRA"]
    with pytest.raises(ValueError, match="one backward branch"):
        smoke.sass_loop(funcs["_ZN12_GLOBAL__N_114knn_mxu_kernelEPKfS1_PfPiiii"])
