"""The launch geometry of the three redesigned kernels, in pure Python.

K1 (``csrc/pcg.cu``) is laid out by ``ops/pcg.launch_plan``: which block
owns which 12-row block-rows of H, how many of them it keeps in shared
memory, and how much shared memory it asks for. K2 vpu (``csrc/knn_bins.cu``)
is launched with ``ops/knn.bins_grid``: its grid, bins a block and queries a
thread. K2 mxu (``csrc/knn_mxu.cu``) is launched with ``ops/knn.mxu_plan``:
its persistent grid, bin tile, stages, shared memory and padded bin count.
The kernels take their launch from these functions. No kernel runs here;
these tests hold the Python side of each plan to the constants in its CUDA
source, and the launches to what the kernels must guarantee: every
block-row has one owner, a block's shared memory fits the H100, and every
(query, bin) output has exactly one writer (for K2 mxu, replayed through the
wgmma f32 accumulator layout). The last tests hold the SASS readers of
``chip_smoke.py`` (K2 vpu's instructions per pair, K2 mxu's tensor-core
instructions) to short listings. No JAX is imported.
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


def test_mxu_plan_constants_match_the_kernel():
    assert knn.MXU_BIN_TILE == _constant("knn_mxu.cu", "kBinTile")
    assert knn.MXU_QUERY_TILE == 64 * _constant("knn_mxu.cu", "kConsumerWarpgroups")
    assert knn.MXU_STAGES == _constant("knn_mxu.cu", "kStages")
    assert knn.MXU_GROUPS_PER_STAGE == _constant("knn_mxu.cu", "kGroupsPerStage")
    depth = _constant("knn_mxu.cu", "kDepth")
    # a stage: its groups' hi and lo halves, f32
    assert knn.MXU_STAGE_BYTES == knn.MXU_GROUPS_PER_STAGE * 2 * knn.MXU_BIN_TILE * depth * 4
    assert knn.MXU_OUT_PITCH == knn.MXU_BIN_TILE + 8  # kOutPitch
    assert "kOutPitch = kBinTile + 8;" in (CSRC / "knn_mxu.cu").read_text()
    plan = knn.mxu_plan(8192, 512)
    # the ring, then the tile's staged vals and idx
    assert plan.smem_bytes == (knn.MXU_STAGES * knn.MXU_STAGE_BYTES
                               + 2 * knn.MXU_QUERY_TILE * knn.MXU_OUT_PITCH * 4)
    assert plan.smem_bytes <= SMEM_LIMIT


def _mxu_writes(q, n_bins, sms=H100_SMS):
    """(query, bin) of every output write of the kernel, replayed in its two
    steps. Persistent block b takes tiles b, b + grid, ...; tile = query tile
    * bin tiles + bin tile. (1) In it, warpgroup wg's thread t (warp w = t //
    32, lane l) holds accumulator register v = 4 j + 2 h + e at row 64 wg +
    16 w + l // 4 + 8 h and bin 8 j + 2 (l % 4) + e of the tile (the wgmma
    m64nNk8 f32 layout) and stages it at that (row, bin) in shared memory:
    each staged slot must be written exactly once. (2) Lane r < 16 of warp w
    copies the staged row 64 wg + 16 w + r (lane r + 16 the same row of idx)
    to global memory, the bins below n_bins of the tile, if its query is
    below Q: the (query, bin) pairs of these copies are returned."""
    plan = knn.mxu_plan(q, n_bins, sms)
    n_bt = plan.padded_bins // plan.bin_tile
    n_tiles = -(-q // knn.MXU_QUERY_TILE) * n_bt
    wg, t, v = np.meshgrid(np.arange(knn.MXU_QUERY_TILE // 64), np.arange(128),
                           np.arange(plan.bin_tile // 2), indexing="ij")
    lane = t % 32
    rows = 64 * wg + 16 * (t // 32) + lane // 4 + 8 * ((v >> 1) & 1)
    cols = 8 * (v >> 2) + 2 * (lane % 4) + (v & 1)
    staged = np.zeros((knn.MXU_QUERY_TILE, plan.bin_tile), dtype=int)
    np.add.at(staged, (rows.ravel(), cols.ravel()), 1)
    assert np.all(staged == 1)  # step (1): one register for each staged slot
    walked, qs, bs = [], [], []
    for blk in range(plan.grid):
        for tile in range(blk, n_tiles, plan.grid):
            walked.append(tile)
            qt, bt = divmod(tile, n_bt)
            width = min(plan.bin_tile, n_bins - bt * plan.bin_tile)  # the copy's bins
            for row in range(knn.MXU_QUERY_TILE):  # lane row % 16 of warp row // 16
                qq = qt * knn.MXU_QUERY_TILE + row
                if qq < q:
                    qs.append(np.full(width, qq))
                    bs.append(bt * plan.bin_tile + np.arange(width))
    assert sorted(walked) == list(range(n_tiles))  # every tile taken by one block
    return np.concatenate(qs), np.concatenate(bs)


@pytest.mark.parametrize("n_bins", [128, 256, 384, 512])
@pytest.mark.parametrize("q", [300, 777, 8192, 8201])
def test_mxu_every_output_has_one_writer(q, n_bins):
    qs, bs = _mxu_writes(q, n_bins)
    assert bs.max() < n_bins  # stores stay inside the output
    counts = np.zeros((q, n_bins), dtype=int)
    np.add.at(counts, (qs, bs), 1)
    assert np.all(counts == 1)


@pytest.mark.parametrize("q,n_bins,sms", [(1, 8, 132), (300, 200, 132), (129, 1000, 7),
                                          (8201, 512, 1)])
def test_mxu_ragged_bins_and_small_cards(q, n_bins, sms):
    """n_bins not a multiple of the bin tile pads the last tile, whose extra
    bins are never stored; a card with fewer SMs walks more tiles a block."""
    plan = knn.mxu_plan(q, n_bins, sms)
    assert plan.padded_bins % plan.bin_tile == 0
    assert 0 <= plan.padded_bins - n_bins < plan.bin_tile
    assert 1 <= plan.grid <= sms
    qs, bs = _mxu_writes(q, n_bins, sms)
    counts = np.zeros((q, n_bins), dtype=int)
    np.add.at(counts, (qs, bs), 1)
    assert np.all(counts == 1)


def test_mxu_plan_refusals():
    for q, n_bins in ((0, 512), (8, 12), (8, 0), (8, 4)):
        with pytest.raises(ValueError, match="n_bins % 8 == 0"):
            knn.mxu_plan(q, n_bins)
    assert knn.mxu_plan(8192, 512).grid == H100_SMS  # 512 tiles: one block an SM
    assert knn.mxu_plan(100, 128).grid == 2  # fewer tiles than SMs: one block a tile


def test_mxu_tile_image_is_the_no_swizzle_k_major_layout():
    """The prologue writes (bin c, depth k) of a 64 x 8 TF32 half-tile at
    byte (c // 8) SBO + (k // 4) LBO + (c % 8) 16 + (k % 4) 4, the canonical
    K-major layout without swizzle that the descriptor (LBO, SBO) reads: core
    matrices of 8 bins x 16 bytes, 128 contiguous bytes each. The map must
    fill the half-tile's bytes exactly once."""
    lbo, sbo = _constant("knn_mxu.cu", "kLbo"), _constant("knn_mxu.cu", "kSbo")
    assert lbo % 16 == 0 and sbo % 16 == 0  # the descriptor holds them in 16-byte units
    c, k = np.meshgrid(np.arange(knn.MXU_BIN_TILE), np.arange(8), indexing="ij")
    offs = (c // 8) * sbo + (k // 4) * lbo + (c % 8) * 16 + (k % 4) * 4
    half = knn.MXU_BIN_TILE * 8 * 4
    assert sorted(offs.ravel()) == list(range(0, half, 4))
    core = offs[:8, :4] - offs[0, 0]  # one core matrix: 8 rows of 16 contiguous bytes
    assert sorted(core.ravel()) == list(range(0, 128, 4))


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


MXU_SASS = """
        Function : _ZN12_GLOBAL__N_120knn_mxu_split_kernelEPKfPfiiii
        /*0000*/                   LDG.E R2, desc[UR4][R2.64] ;
        /*0010*/                   EXIT ;
        Function : _ZN12_GLOBAL__N_114knn_mxu_kernelENS_7MxuArgsE
        /*0000*/                   WARPGROUP.ARRIVE ;
        /*0010*/                   HGMMA.64x64x8.F32.TF32 R24, R88, gdesc[UR4], RZ, !UPT ;
        /*0020*/                   HGMMA.64x64x8.F32.TF32 R24, R92, gdesc[UR8], R24 ;
        /*0030*/                   HGMMA.64x64x8.F32.TF32 R24, R88, gdesc[UR4], R24, gsb0 ;
        /*0040*/                   WARPGROUP.DEPBAR.LE gsb0, 0x1 ;
        /*0050*/              @!P0 FSETP.GEU.AND P1, PT, R24, R56, PT ;
        /*0060*/                   EXIT ;
"""


def test_mxu_sass_counts_the_main_kernel():
    """chip_smoke's build check counts the tensor-core instructions of
    knn_mxu_kernel alone (not its prologue) and fails on mma.sync (HMMA) or
    on no wgmma (HGMMA)."""
    smoke = _chip_smoke()
    line = smoke.mxu_tensor_ops(MXU_SASS)
    assert "HGMMA 3, HMMA 0" in line
    assert "WARPGROUP.ARRIVE 1, WARPGROUP.DEPBAR 1" in line
    with pytest.raises(AssertionError, match="does not run on wgmma"):
        smoke.mxu_tensor_ops(MXU_SASS.replace("HGMMA.64x64x8.F32.TF32", "HMMA.1688.F32.TF32"))
    with pytest.raises(AssertionError, match="does not run on wgmma"):
        smoke.mxu_tensor_ops(MXU_SASS + "        /*0070*/  HMMA.1688.F32.TF32 R4, R8, R12, R4 ;\n")
    with pytest.raises(AssertionError, match="one knn_mxu_kernel"):
        smoke.mxu_tensor_ops(MXU_SASS.split("Function : _ZN12_GLOBAL__N_114")[0])


def test_mxu_probe_cuts_what_it_names():
    """python -m wildcat_slam_tpu_torch.probe_knn_mxu times K2 mxu against
    text edits of its source: each edit must find its mark in the current
    csrc/knn_mxu.cu and change only what it names."""
    from wildcat_slam_tpu_torch import probe_knn_mxu as probe

    src = (CSRC / "knn_mxu.cu").read_text()
    out = probe.variants(src)
    assert out["kernel"] == src
    assert src.count("wgmma_tf32<") == 3  # the three products of a group
    assert out["mma1"].count("wgmma_tf32<") == 1
    assert out["fold1"].count("v < kAcc") == src.count("v < kAcc") - 1
    assert out["fold1_mma1"] == out["fold1"].replace(probe.MMA23, "")
    with pytest.raises(RuntimeError, match="no longer has"):
        probe.variants(src.replace(probe.MMA23, ""))
