// Per-bin nearest-target search by an augmented product on the tensor cores
// (kernel K2, "mxu" scoring), written for Hopper's wgmma.
//
// Replaces: wildcat_slam_tpu/ops/knn_pallas.py, _knn_bins with _knn_mxu_kernel
// and _fold_chunk (the Pallas TPU kernel behind knn_topk_fused(mode="mxu")).
// Queries come embedded as a = [-2q, 1, 0...] and targets as b = [t; |t|^2;
// 0...], so one product per tile gives the score s = a.b = |t|^2 - 2 q.t, the
// squared distance minus |q|^2 (the wrapper, ops/knn.py, adds |q|^2 back). For
// each query row and bin (targets b, b + nb, b + 2 nb, ...) it keeps the
// smallest score and the target that attains it, walking the targets in
// increasing order with a strict '<', so the earlier target wins a tie as in
// the TPU kernel. Far-padded targets (1e6 per dimension, |t|^2 = 6e12) score
// ~6e12: finite, and never below a real target. Every output has one writer;
// there are no atomics.
//
// Precision: the TPU kernel ran the product at Precision.HIGHEST, the f32
// semantics the matcher needs (|t|^2 reaches several hundred on these
// descriptors while neighbour distances are 0.01-1, so a ~10-bit TF32 product
// would reorder neighbours). wgmma reads TF32 operands and ignores their low 13
// bits, so every operand is split x = hi + lo, both exact TF32 values (rounded
// here in integer arithmetic, half away from zero, so the split is exact and
// repeatable), and the product is taken as lo*hi + hi*lo + hi*hi (the 3xTF32
// scheme; the dropped lo*lo term is ~2^-22 of the product), small terms first,
// into one f32 accumulator.
//
// What bounds it on an H100: the fold. At Q = 8192, T = 16384 the 3-pass
// product at depth 8 is Q*T*8*2*3 = 6.4 GFLOP, ~13 us at the 495 TFLOP/s TF32
// peak; the outputs are 32 MB, ~10 us at 3.35 TB/s; the fold takes three
// instructions for each of the Q*T = 134 M scores, and its compares and
// minima run on the ALU pipe, which does 64 lanes a clock on an SM (half the
// FP32 rate): two of them a score are ~16 us at 1.98 GHz, more at the lower
// clock the card holds under this load. The product and the fold run on
// different units, so the design overlaps them; the fold sets the pace.
//
// Design:
// - A prologue kernel (knn_mxu_split_kernel) reads the targets (8, T) once,
//   splits each value into TF32 hi and lo, and writes both halves of every
//   (64-bin tile, target group) as the exact image of the shared-memory tile
//   that wgmma's descriptor reads: K-major (a bin's 8 depth values together,
//   as .tf32 requires), no swizzle, in 8-bin x 4-deep core matrices of 128
//   contiguous bytes. The groups of one bin tile follow each other. A tile
//   past the last bin is padded with zero targets, whose scores are never
//   stored. So every target is split once, not once per query block, and a
//   ring stage arrives ready to use.
// - The main kernel (knn_mxu_kernel) runs persistent blocks over the work
//   list of (128-query tile, 64-bin tile) pairs. One producer thread keeps a
//   ring of kStages stages in flight, each four target groups (16 KB) in one
//   1D bulk copy (cp.async.bulk) completing on an mbarrier; two consumer
//   warpgroups of 64 query rows share each stage and free it with one
//   mbarrier arrival a thread. A warpgroup splits its query rows into hi and
//   lo A fragments once per tile (the next tile's rows load meanwhile) and
//   keeps them in registers.
// - Per target group a warpgroup issues three wgmma.m64n64k8 (lo*hi, hi*lo,
//   hi*hi) into one accumulator and commits them; while they run it folds the
//   previous group's accumulator (two accumulators, alternating). The loop
//   takes a stage in four unrolled steps, so every stage wait, release and
//   descriptor offset is fixed at compile time and no branch or accumulator access sits between a
//   wgmma and its wait (ptxas would otherwise make every wgmma wait for the
//   one before). In the wgmma f32 accumulator layout each thread holds the
//   same 32 (query, bin) scores at every group, so it owns those pairs and
//   keeps their minima and the age of each minimum in registers (see fold);
//   the target is group * nb + bin, formed at the end of a tile.
// - A tile's minima and targets are staged in shared memory, and each warp
//   copies its 16 rows of each to global memory by async bulk copies, so the
//   32 MB of outputs drain while the next tile runs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDepth = 8;                                // contraction depth: one k8 step
constexpr int kBinTile = 64;                             // N of wgmma.m64n64k8
constexpr int kConsumerWarpgroups = 2;                   // 64 query rows each
constexpr int kQueryTile = 64 * kConsumerWarpgroups;     // 128 query rows a tile
constexpr int kConsumerWarps = 4 * kConsumerWarpgroups;  // 8
constexpr int kThreads = 32 * kConsumerWarps + 32;       // and one producer warp: 288
constexpr int kHalfFloats = kBinTile * kDepth;           // one TF32 half of a group's tile (2 KB)
constexpr int kGroupBytes = 2 * kHalfFloats * 4;         // hi, then lo: 4096
constexpr int kGroupsPerStage = 4;                       // target groups a ring stage
constexpr int kStageBytes = kGroupsPerStage * kGroupBytes;  // 16384
constexpr int kStages = 4;                               // stages in the ring
constexpr int kRingBytes = kStages * kStageBytes;        // the ring: 65536
constexpr int kOutPitch = kBinTile + 8;  // floats a staged output row, padded to spread banks
constexpr int kOutBytes = kQueryTile * kOutPitch * 4;    // one tile's vals (or idx) staged
constexpr int kSmemBytes = kRingBytes + 2 * kOutBytes;   // 139264
constexpr int kAcc = kBinTile / 2;                       // accumulator floats a thread
// no-swizzle K-major tile: core matrices of 8 bins x 4 depth values (128 B);
// the depth halves 0-3 and 4-7 are kLbo bytes apart, 8-bin groups kSbo
constexpr int kLbo = 128;
constexpr int kSbo = 256;
constexpr int kSplitThreads = 256;
static_assert((kStages & (kStages - 1)) == 0, "a stage's slot and phase are bits of its number");
static_assert(kGroupsPerStage == 4, "the consumers' loop takes a stage in four unrolled steps");

__device__ __forceinline__ float tf32_round(float x) {
  // nearest TF32 value (10 explicit mantissa bits), ties away from zero;
  // finite inputs only (the descriptors and their squares are far from overflow)
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float h = tf32_round(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32_round(x - h));  // x - h is exact in f32
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Spin until the phase of parity `parity` of the mbarrier at `bar` has
// completed. The loop lives inside the asm, so the compiler sees no divergent
// branch around the wgmma that follow (one there serialises them).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// wgmma matrix descriptor of a no-swizzle K-major tile at shared address addr
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)(kLbo >> 4) << 16) |
         ((uint64_t)(kSbo >> 4) << 32);
}

// d (+)= a . b for a 64 x 8 TF32 A fragment in registers and a 64-bin x 8
// TF32 B tile in shared memory; kAccumulate 0 starts from zero
template <int kAccumulate>
__device__ __forceinline__ void wgmma_tf32(float (&d)[kAcc], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(kAccumulate));
}

// keeps the compiler from moving accesses of d across the wgmma waits
__device__ __forceinline__ void fence_regs(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i]) : : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Issue one target group's three products into acc: lo*hi, hi*lo, hi*hi,
// the first from zero. d_hi describes the group's hi half in the ring, and
// its lo half follows.
__device__ __forceinline__ void issue(float (&acc)[kAcc], const uint32_t (&a_hi)[4],
                                      const uint32_t (&a_lo)[4], uint64_t d_hi) {
  const uint64_t d_lo = d_hi + ((kHalfFloats * 4) >> 4);  // the address field counts 16 bytes
  wgmma_fence();
  wgmma_tf32<0>(acc, a_lo, d_hi);
  wgmma_tf32<1>(acc, a_hi, d_lo);
  wgmma_tf32<1>(acc, a_hi, d_hi);
  wgmma_commit();
}

// Ring stage st (a running count) lies in slot st % kStages; its mbarriers
// are 8 bytes apart from full0 and empty0, and its phase is bit 0 of
// st / kStages. Wait until stage st has landed.
__device__ __forceinline__ void wait_full(uint32_t full0, uint32_t st) {
  mbar_wait(full0 + 8 * (st & (kStages - 1)), (st / kStages) & 1);
}

// The descriptor of stage st's first group (hi half), from stage 0's
__device__ __forceinline__ uint64_t stage_desc(uint64_t desc0, uint32_t st) {
  return desc0 + (((st & (kStages - 1)) * kStageBytes) >> 4);
}

// The products that read stage st are done: every consumer thread arrives
// (no branch between a wait and a fold), which frees the slot for the producer.
__device__ __forceinline__ void release(uint32_t empty0, uint32_t st) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(empty0 + 8 * (st & (kStages - 1)))
               : "memory");
}

// Fold one target group's scores into the running minima, in target order.
// age[v] is minus the number of groups folded since best[v] last improved, so
// the winning group is (the last group) + age[v]. A score that does not
// improve best (acc >= best, or unordered) sets keep = 1.0: the minimum stays
// and the age drops by one; one that improves sets keep = 0: the minimum
// becomes the score and the age 0. The strict '<' keeps the earlier target on
// a tie. Three instructions a score: the compare (FSET) and the minimum
// (FMNMX) on the ALU pipe, which runs at half the FP32 rate, and the age on
// the FMA pipe (a compare and two selects would all take the ALU pipe).
// best starts at +inf and age at 0, so the first group sets them (scores are
// finite).
__device__ __forceinline__ void fold(const float (&acc)[kAcc], float (&best)[kAcc],
                                     float (&age)[kAcc]) {
#pragma unroll
  for (int v = 0; v < kAcc; ++v) {
    float keep;
    asm("set.geu.f32.f32 %0, %1, %2;" : "=f"(keep) : "f"(acc[v]), "f"(best[v]));
    best[v] = fminf(acc[v], best[v]);
    age[v] = fmaf(keep, age[v], -keep);
  }
}

// One thread per padded target column (group g, bin c < nb_pad): split the
// column into TF32 hi and lo and write both into the tile image that the main
// kernel's descriptor reads, bin tile by bin tile, so the groups of one bin
// tile follow each other and a ring stage is one contiguous copy. Columns
// past the last bin are zero.
__global__ void __launch_bounds__(kSplitThreads)
knn_mxu_split_kernel(const float* __restrict__ dtt, float* __restrict__ staged, int nt, int nb,
                     int nb_pad, int ngroups) {
  const long long col = (long long)blockIdx.x * kSplitThreads + threadIdx.x;
  if (col >= (long long)ngroups * nb_pad) return;
  const int g = (int)(col / nb_pad), c = (int)(col % nb_pad);
  const int bt = c / kBinTile, cc = c % kBinTile;
  uint32_t hi[kDepth], lo[kDepth];
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    const float v = c < nb ? __ldg(&dtt[(size_t)k * nt + (size_t)g * nb + c]) : 0.f;
    split(v, hi[k], lo[k]);
  }
  // (bin cc, depth k) of a half lies at float (cc / 8) kSbo/4 + (k / 4) kLbo/4 + (cc % 8) 4 + k % 4
  float* tile = staged + ((size_t)bt * ngroups + g) * 2 * kHalfFloats +
                (cc / 8) * (kSbo / 4) + (cc % 8) * 4;
  *reinterpret_cast<uint4*>(tile) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(tile + kLbo / 4) = make_uint4(hi[4], hi[5], hi[6], hi[7]);
  *reinterpret_cast<uint4*>(tile + kHalfFloats) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  *reinterpret_cast<uint4*>(tile + kHalfFloats + kLbo / 4) =
      make_uint4(lo[4], lo[5], lo[6], lo[7]);
}

struct MxuArgs {
  const float* dq;      // (nq, 8) row-major query embedding
  const float* staged;  // (n_bt, ngroups, 2, kHalfFloats): the split targets' tile images
  float* vals;          // (nq, nb)
  int* idx;             // (nq, nb)
  int nq, nb, ngroups, n_bt, n_tiles;
};

__global__ void __launch_bounds__(kThreads, 1) knn_mxu_kernel(MxuArgs a) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  // the warp index through a shuffle, so the compiler knows it is warp-uniform
  // and the role branch below is not divergent within a warp
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&full[s])));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(&empty[s])),
                   "r"(32 * kConsumerWarps));
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer, one thread: stage st holds groups 4 c .. 4 c + 3 of one of
    // this block's tiles (fewer at the end of a tile), in the order the
    // consumers read them; it is filled once its slot's previous contents
    // are freed
    if (lane == 0) {
      uint32_t st = 0;
      for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
        const float* src = a.staged + (size_t)(tile % a.n_bt) * a.ngroups * 2 * kHalfFloats;
        for (int g0 = 0; g0 < a.ngroups; g0 += kGroupsPerStage, ++st) {
          const uint32_t slot = st & (kStages - 1);
          mbar_wait(smem_addr(&empty[slot]), ((st / kStages) & 1) ^ 1);
          const uint32_t bar = smem_addr(&full[slot]);
          const uint32_t bytes = min(kGroupsPerStage, a.ngroups - g0) * kGroupBytes;
          asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                       "r"(bytes)
                       : "memory");
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], "
              "%2, [%3];" ::"r"(smem_addr(ring + slot * kStageBytes)),
              "l"(src + (size_t)g0 * 2 * kHalfFloats), "r"(bytes), "r"(bar)
              : "memory");
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg holds query rows 64 wg .. 64 wg + 63 of the tile;
  // in the wgmma layouts warp wq of it holds rows 16 wq + gid and 16 wq + gid + 8
  const int wg = warp / 4, wq = warp % 4, gid = lane / 4, tig = lane % 4;
  const uint64_t desc0 = tile_desc(smem_addr(ring));
  const uint32_t full0 = smem_addr(full), empty0 = smem_addr(empty);
  constexpr uint64_t kG = kGroupBytes >> 4;  // a group's offset in the descriptor's units
  float acc0[kAcc], acc1[kAcc], best[kAcc], age[kAcc];
#pragma unroll
  for (int v = 0; v < kAcc; ++v) acc0[v] = acc1[v] = 0.f;

  // this warp's 16 rows of a tile's staged outputs (vals, then idx)
  const int row0 = wg * 64 + wq * 16;  // the warp's first row of the tile
  float* out_v = reinterpret_cast<float*>(ring + kRingBytes) + row0 * kOutPitch;
  int* out_i = reinterpret_cast<int*>(ring + kRingBytes + kOutBytes) + row0 * kOutPitch;
  // A fragment (64 x 8): a[r] is row + 8 (r & 1), depth tig + 4 (r >> 1); the
  // next tile's values are loaded while this tile runs
  auto load_a = [&](int tile, float (&av)[4]) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int q = (tile / a.n_bt) * kQueryTile + row0 + gid + 8 * (r & 1);
      const bool real = tile < a.n_tiles && q < a.nq;
      av[r] = real ? __ldg(&a.dq[(size_t)q * kDepth + tig + 4 * (r >> 1)]) : 0.f;
    }
  };
  float a_next[4];
  load_a(blockIdx.x, a_next);
  uint32_t a_hi[4], a_lo[4];
  const int ng = a.ngroups;
  uint32_t st = 0;  // the ring stage holding the current group
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x, ++st) {
    const int qt = tile / a.n_bt, bt = tile % a.n_bt;
#pragma unroll
    for (int r = 0; r < 4; ++r) split(a_next[r], a_hi[r], a_lo[r]);
    load_a(tile + gridDim.x, a_next);
#pragma unroll
    for (int v = 0; v < kAcc; ++v) best[v] = __int_as_float(0x7f800000), age[v] = 0.f;
    // Even groups in acc0, odd in acc1: each fold runs while the next
    // group's products do. A trip of the loop takes the four groups of stage
    // st; its body is the same on every trip (group g in acc0 in flight at
    // its top and bottom). The last one to four groups, all in stage st, are
    // peeled.
    wait_full(full0, st);
    uint64_t d = stage_desc(desc0, st);
    issue(acc0, a_hi, a_lo, d);
    int g = 0;
    for (; g + kGroupsPerStage < ng; g += kGroupsPerStage, ++st) {
      issue(acc1, a_hi, a_lo, d + kG);
      wgmma_wait<1>();
      fence_regs(acc0);
      fold(acc0, best, age);
      issue(acc0, a_hi, a_lo, d + 2 * kG);
      wgmma_wait<1>();
      fence_regs(acc1);
      fold(acc1, best, age);
      issue(acc1, a_hi, a_lo, d + 3 * kG);
      wgmma_wait<1>();
      fence_regs(acc0);
      fold(acc0, best, age);
      wait_full(full0, st + 1);
      d = stage_desc(desc0, st + 1);
      issue(acc0, a_hi, a_lo, d);
      wgmma_wait<1>();  // groups g .. g + 3 are done: stage st is free
      fence_regs(acc1);
      release(empty0, st);
      fold(acc1, best, age);
    }
    const int rest = ng - g;  // 1 to 4 groups, g in flight in acc0
    if (rest == 1) {
      wgmma_wait<0>();
      fence_regs(acc0);
      release(empty0, st);
      fold(acc0, best, age);
    } else {
      issue(acc1, a_hi, a_lo, d + kG);
      wgmma_wait<1>();
      fence_regs(acc0);
      fold(acc0, best, age);
      if (rest == 2) {
        wgmma_wait<0>();
        fence_regs(acc1);
        release(empty0, st);
        fold(acc1, best, age);
      } else {
        issue(acc0, a_hi, a_lo, d + 2 * kG);
        wgmma_wait<1>();
        fence_regs(acc1);
        fold(acc1, best, age);
        if (rest == 3) {
          wgmma_wait<0>();
          fence_regs(acc0);
          release(empty0, st);
          fold(acc0, best, age);
        } else {
          issue(acc1, a_hi, a_lo, d + 3 * kG);
          wgmma_wait<1>();
          fence_regs(acc0);
          fold(acc0, best, age);
          wgmma_wait<0>();
          fence_regs(acc1);
          release(empty0, st);
          fold(acc1, best, age);
        }
      }
    }
    // Stage the tile's outputs in shared memory, then each lane of the first
    // half of the warp copies one of the warp's 16 rows of vals, and each of
    // the second half one of idx, to global memory by an async bulk copy, so
    // the next tile starts while they drain. The staged rows are reused only
    // after this warp's previous copies have read them.
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    __syncwarp();
    // accumulator layout: v = 4 j + 2 h + e is (row 8 h + gid of the warp's
    // 16, bin 8 j + 2 tig + e of the tile)
#pragma unroll
    for (int j = 0; j < kAcc / 4; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v = 4 * j + 2 * h, bin = bt * kBinTile + 8 * j + 2 * tig;
        const int o = (gid + 8 * h) * kOutPitch + 8 * j + 2 * tig;
        *reinterpret_cast<float2*>(out_v + o) = make_float2(best[v], best[v + 1]);
        const int g0 = ng - 1 + (int)age[v], g1 = ng - 1 + (int)age[v + 1];
        *reinterpret_cast<int2*>(out_i + o) = make_int2(g0 * a.nb + bin, g1 * a.nb + bin + 1);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the copies read these writes
    __syncwarp();
    {
      const int r = lane & 15, q = qt * kQueryTile + row0 + r;
      // nb % 8 == 0: rows of 32-byte multiples
      const uint32_t bytes = min(kBinTile, a.nb - bt * kBinTile) * 4;
      const size_t o = (size_t)q * a.nb + bt * kBinTile;
      const void* dst = lane < 16 ? (const void*)(a.vals + o) : (const void*)(a.idx + o);
      const uint32_t src =
          lane < 16 ? smem_addr(out_v + r * kOutPitch) : smem_addr(out_i + r * kOutPitch);
      asm volatile(
          "{\n .reg .pred p;\n setp.lt.s32 p, %3, %4;\n"
          " @p cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n}\n" ::"l"(dst),
          "r"(src), "r"(bytes), "r"(q), "r"(a.nq)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");  // the last copies are done
}

}  // namespace

// dq_aug: (nq, 8) row-major, [-2 q, 1, 0...]; dtt_aug: (8, nt) row-major,
// [t; |t|^2; 0...]; staged: (nt / nb) * nb_pad * 16 floats of scratch for the
// split targets; vals: (nq, nb) f32 scores |t|^2 - 2 q.t; idx: (nq, nb) int32.
// nt must be a multiple of nb, nb a multiple of 8. The launch (grid, bin tile,
// stages, shared memory, padded bins) is ops/knn.py's mxu_plan, checked here
// against what the kernel was compiled for. Returns a cudaError_t code (0 on
// success).
extern "C" int wc_knn_mxu(const float* dq_aug, const float* dtt_aug, float* staged, float* vals,
                          int* idx, int nq, int nt, int nb, int grid, int bin_tile, int stages,
                          int smem_bytes, int nb_pad, void* stream) {
  if (nq < 1 || nb < 8 || nb % 8 != 0 || nt < nb || nt % nb != 0 || bin_tile != kBinTile ||
      stages != kStages || smem_bytes != kSmemBytes || nb_pad < nb || nb_pad % kBinTile != 0 ||
      nb_pad - nb >= kBinTile || grid < 1)
    return (int)cudaErrorInvalidValue;
  const int ngroups = nt / nb, n_bt = nb_pad / kBinTile;
  const long long n_tiles = (long long)((nq + kQueryTile - 1) / kQueryTile) * n_bt;
  if (n_tiles > 0x7fffffff || grid > n_tiles) return (int)cudaErrorInvalidValue;
  // the ring and the staged outputs are above the 48 KB a block gets without
  // asking: ask once per device (a bit each; the caller makes the tensors'
  // card current)
  static thread_local unsigned long long ready_devs = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !(ready_devs >> dev & 1ull)) {
    err = cudaFuncSetAttribute(knn_mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) ready_devs |= 1ull << dev;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cols = (long long)ngroups * nb_pad;
  knn_mxu_split_kernel<<<(unsigned)((cols + kSplitThreads - 1) / kSplitThreads), kSplitThreads,
                         0, s>>>(dtt_aug, staged, nt, nb, nb_pad, ngroups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const MxuArgs args{dq_aug, staged, vals, idx, nq, nb, ngroups, n_bt, (int)n_tiles};
  knn_mxu_kernel<<<grid, kThreads, kSmemBytes, s>>>(args);
  return (int)cudaGetLastError();
}

// Registers and local (spill) bytes a thread of the two kernels: out[0..1] the
// prologue's, out[2..3] the main kernel's. Returns a cudaError_t code.
extern "C" int wc_knn_mxu_resources(int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, knn_mxu_split_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  err = cudaFuncGetAttributes(&fa, knn_mxu_kernel);
  if (err != cudaSuccess) return (int)err;
  out[2] = fa.numRegs;
  out[3] = (int)fa.localSizeBytes;
  return 0;
}
