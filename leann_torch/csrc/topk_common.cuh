// The core shared by the two distance + top-k kernels (flat_topk.cu,
// knn_panel.cu): TMA loads into a ring of shared-memory stages behind
// mbarriers, wgmma products (bf16 in, f32 sums in registers), and a
// threshold-filtered top-k epilogue that works from the accumulator
// registers into sorted per-row lists.
//
// Block: 384 threads, 128 query rows, a range of corpus columns.
//   warpgroup 2 (producer, 40 registers after setmaxnreg): one thread
//     issues every TMA load. A stage holds one 64-feature box of the
//     block's 128 query rows and the same box of a 128-row corpus tile; the
//     ring has S stages, each behind a full and an empty mbarrier waited on
//     with phase parity.
//   warpgroups 0, 1 (consumers, 232 registers after setmaxnreg; ptxas
//     holds their code to the 168 that 384 threads allow, and a spill fails
//     the build's check): warpgroup w owns query rows
//     64 w .. 64 w + 63 (one wgmma M) and issues wgmma m64n128k16 on every
//     stage, keeping one box in flight and releasing the one before. After
//     a tile's last box its accumulators hold the tile's 64 x 128 dot
//     products; the epilogue turns them into scores and offers each row's
//     survivors to that row's list. Both warpgroups read every stage and
//     arrive on its empty barrier, so no waiter is ever more than one phase
//     ahead of a barrier, which the parity waits need.
// Grid: (column splits, row blocks). With more than one split each block
// writes a partial list per row and a merge kernel folds them.
//
// Why 128 rows in two warpgroups and not 64 rows with the warpgroups taking
// alternate tiles (ping-pong): ping-pong keeps two lists per row, each over
// half the columns, which costs about 1.8x the list work of one list. With
// one list per row the products no longer overlap the epilogue of the same
// block; the other blocks on the card do not wait for it.
//
// Operands: bf16 row-major [rows, D], D a multiple of 16. A TMA box is 64
// features (128 B) x 128 rows with 128-byte swizzle; TMA's out-of-bounds
// zero fill covers the ragged row tails and D not a multiple of 64 (D = 400
// is 7 boxes, the last half filled). The wgmma descriptors read the same
// swizzled layout (K-major, 8-row groups 1 KB apart; warpgroup 1's rows
// start 8 KB into the query box).
//
// Order: entries sort ascending by (distance, id), so ties go to the lower
// id (lax.top_k's order). The sorted top-k of a set under a total order
// does not depend on the order the set arrives in, so results are
// deterministic; nothing is accumulated with atomics.
//
// The lists. Up to k = 64 (kRegMaxK) a row's sorted list lives in
// registers (QuadRows, WarpRows) and takes one survivor at a time. Above
// k = 64 (the HNSW build's C = 4 R = 128, a flat top_k > 64, C = 512 at
// M = 64, efConstruction = 512) every row keeps a sorted list of k2 entries,
// k2 the power of two >= k (at least 128), whose entry k - 1 is the bar,
// in device memory, and beside it a buffer of up to CAP candidates in
// shared memory (BufRows; the buffered select of GPU k-selection, FAISS's
// WarpSelect):
//   append: in the epilogue each row's quad appends the tile's survivors of
//     the bar in parallel, each lane at the slot a ballot prefix gives it
//     past the row's count (held in registers by the quad);
//   flush: when a row's buffer could overflow, and once after the last
//     tile, the warp sorts the buffer in registers (bitonic), takes for list
//     position k2 - 1 - e the smaller of itself and buffer entry e (the list
//     and the reversed buffer form a bitonic sequence holding the k2
//     smallest of both), sorts that with a bitonic merge and reads the new
//     bar at k - 1 (fold_buffer). Up to k2 = 256 the list is merged in
//     registers between one load and one store; above, strides >= 32 go
//     through memory (generic pointers: the merges' lists lie in shared
//     memory, the tile kernel's in device memory).
// A flush costs O(k2 log k2 + CAP log^2 CAP) for up to CAP candidates, and
// its memory round trips bound it (the card showed a warp folding one row
// at a time faster than lane groups folding several); on a tile whose
// candidates all lose to the bar the epilogue costs what k <= 64 costs.
// The merges (topk_merge_lists) fold the column splits' partial lists with
// the same append and flush, W warps per row, then the warps' lists into
// each other's.
//
// What bounds each instance on the H100: the k-NN build (B2) at D = 384
// does 2 N^2 D operations and reads each corpus box once per 128 query rows
// from L2, so the products (operations) bound it at every k; the lists
// bound it only where a row's survivors are many (data in which each
// row's neighbours come in runs of columns). The flat search (B1) at
// B <= 128 queries reads the corpus once (bytes); above k = 64 its column
// splits each fill a list from empty, so there the flushes (about 400
// survivors per split and query at k = 128, 64 x 100K) and the merge's k
// entries per split bound it, and the planner makes no split narrower than
// k columns (ops/tile_plan.py).
//
// Shared memory per block (dynamic, held to the card's 227 KB by the
// static_asserts below):
//   registers (k <= 64): 1 KB alignment slack + 4 x 32 KB stages + 2 x 128
//     f32 column norms + 8 mbarriers = kSmemBytes = 133,184 B, whatever D.
//   BufRows (k > 64, any k): the 4-stage ring (128 KB) + 128 rows x
//     64-entry buffers x 8 B (64 KB) = 198,720 B. The lists are the
//     block's slice of a [rows, splits, k2] scratch the wrapper allocates,
//     read and written only by folds: in registers between one load and one
//     store up to k2 = 256, stage by stage above. The 132 resident blocks'
//     slices take 132 x 128 rows x k2 x 8 B: 17.3 MB at k2 = 128, within
//     the card's 50 MB of L2.
// The instance was chosen on the card (PERF.md §6): 128-entry buffers
// (3 stages) were 7-25% faster than 64 (4 stages) but spill; lists of
// k2 = 128 in shared memory (a 2-stage ring, 32-entry buffers) were 0-8%
// faster on the k = 128 builds, too little for a second instance, and a
// 64-row block with one consumer warpgroup was slower.
// Consumers compile to at most 168 registers (384 threads), and a fold
// inside the epilogue has the 64 accumulators live: BufRows keeps few
// fields (the buffer's ids at a fixed offset, the list length from its
// stride) so that it does not spill.
// One block per SM (the registers allow no second).
//
// The tensor maps are encoded on the host per launch with the driver API's
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (the
// runtime hands out the driver's entry point), so the libraries link only
// the CUDA runtime and need no -lcuda.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace leann {

constexpr float kInf = 3.4e38f;  // "no candidate": masked columns, empty slots
constexpr int kEmptyId = 0x7fffffff;
constexpr int kBM = 128;                         // query rows per block, 64 per consumer warpgroup
constexpr int kBN = 128;                         // corpus rows per tile
constexpr int kBoxK = 64;                        // features per TMA box
constexpr int kBoxBytes = 128 * kBoxK * 2;       // one box of 128 rows: 16 KB
constexpr int kStageBytes = 2 * kBoxBytes;       // a stage: query box + corpus box
constexpr int kRegMaxK = 64;                     // WarpRows: two list slots per lane; BufRows above
constexpr int kMinListLen = 128;                 // BufRows' shortest list (k2 >= the buffers' CAP)
constexpr int kStages = 4;                       // ring slots (one box in flight needs two)
constexpr int kMergeThreads = 256;
constexpr int kMergeWarps = kMergeThreads / 32;
constexpr int kMergeCap = 128;                   // topk_merge_lists: buffer entries per warp
constexpr int kMergeSmemMaxK2 = 2048;            // ... lists in shared memory up to this k2
constexpr int kRegFoldMaxK2 = 256;               // fold_buffer: lists up to this k2 folded in registers
constexpr int kMaxSmem = 227 * 1024;             // dynamic shared memory a block may take on sm_90

// k2: the length of a BufRows list for k > kRegMaxK, the power of two >= k.
__host__ __device__ __forceinline__ int list_len(int k) {
  int k2 = kMinListLen;
  while (k2 < k) k2 <<= 1;
  return k2;
}

// Warps per row of topk_merge_lists: each folds at least two of the lists.
__host__ __device__ __forceinline__ int merge_warps(int lists) {
  return lists >= 16 ? 8 : lists >= 8 ? 4 : lists >= 4 ? 2 : 1;
}

__host__ __device__ __forceinline__ int feature_boxes(int d) { return (d + kBoxK - 1) / kBoxK; }

// Bytes of dynamic shared memory the register instances take (layout above).
constexpr size_t kSmemBytes = 1024 + (size_t)kStages * kStageBytes + 2 * kBN * 4 + 2 * kStages * 8;
static_assert(kSmemBytes <= kMaxSmem, "a block takes at most 227 KB of shared memory on sm_90");

// ---------------------------------------------------------------------------
// PTX wrappers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// K-major operand in the 128-byte-swizzled layout TMA writes: rows of 128 B,
// 8-row groups 1 KB apart (stride byte offset 64 x 16 B; the leading byte
// offset is unused for swizzled K-major layouts and set to 1).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, both K-major bf16 in shared
// memory. Thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4
// (+8) and columns 8 j + 2 (t % 4) (+1): d[4j + 2h + e] is row (+8 h),
// column 8 j + 2 (t % 4) + e.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
        "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// Sorted lists

__device__ __forceinline__ bool lex_less(float a, int ai, float b, int bi) {
  return a < b || (a == b && ai < bi);
}

struct TopkArgs {
  const float* cn;  // corpus squared norms [n_cols] (l2), else null
  const float* qn;  // query squared norms [rows] (l2), else null
  float* ov;        // [rows, splits, k] distances (splits = gridDim.x)
  int* oi;          // [rows, splits, k] ids, -1 for empty slots
  int rows;         // query rows
  int self_excl;    // never take column self_col0 + r for query row r
  int self_col0;    // column of query row 0 itself (may lie outside the columns)
  int col_id0;      // id of column 0: added to every id written out
  int l2;           // |q|^2 + |c|^2 - 2 q.c, else -q.c
  int n_cols;       // candidate columns [0, n_cols); split s of S takes tiles
                    // [s T / S, (s + 1) T / S) of the T = ceil(n_cols / 128)
  int kb;           // feature boxes, ceil(D / 64)
  int k;
  int k2;           // BufRows: list length, the power of two >= k (list_len)
  float* lv;        // BufRows: [rows, splits, k2] lists
  int* li;
};

// ---------------------------------------------------------------------------
// The lists of a warp's 16 query rows, in registers. The accumulator gives
// each quad of lanes (4g .. 4g + 3) rows 16 w + g and 16 w + g + 8 ("r0"
// and "r1" below); each thread also keeps its two rows' position k - 1 as
// the bar a candidate must beat. Three layouts behind one interface:
//   QuadRows<SL> (k <= 4 SL; SL = 1 serves k <= 4, SL = 4 k <= 16): a row's list belongs to its quad
//     (lane `sub` holds positions 4 s + sub), so the eight quads insert into
//     their own rows at once;
//   WarpRows (k <= 64): a row's list spans the warp (lane l holds positions
//     l and l + 32), one insert at a time, with cheap shuffles per insert;
//   BufRows (k > 64, below): a buffer of survivors per row beside a sorted
//     list in shared or device memory, folded in by warp-wide flushes.

template <int SL>
struct QuadRows {
  float v[2][SL];
  int i[2][SL];
  float tv[2];  // position k - 1 of rows r0, r1
  int ti[2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int s = 0; s < SL; ++s) { v[h][s] = kInf; i[h][s] = kEmptyId; }
      tv[h] = kInf;
      ti[h] = kEmptyId;
    }
  }

  template <int H>
  __device__ __forceinline__ void refresh_last(int k) {
    float x = kInf;
    int id = kEmptyId;
#pragma unroll
    for (int s = 0; s < SL; ++s)
      if (s == (k - 1) >> 2) { x = v[H][s]; id = i[H][s]; }
    const int src = ((threadIdx.x & 31) & ~3) | ((k - 1) & 3);
    tv[H] = __shfl_sync(0xffffffffu, x, src);
    ti[H] = __shfl_sync(0xffffffffu, id, src);
  }

  // Insert the quad-uniform (cv, ci) into row H's list where `act`
  // (quad-uniform, and it beats position k - 1); every lane calls.
  template <int H>
  __device__ __forceinline__ void insert(int k, bool act, float cv, int ci) {
    const int lane = threadIdx.x & 31, sub = lane & 3;
    int p = 0;  // the candidate's position: entries before it
#pragma unroll
    for (int s = 0; s < SL; ++s) p += (4 * s + sub < k && lex_less(v[H][s], i[H][s], cv, ci)) ? 1 : 0;
    p += __shfl_xor_sync(0xffffffffu, p, 1);
    p += __shfl_xor_sync(0xffffffffu, p, 2);
    // position q > p takes q - 1: the left lane's same slot, or for sub 0
    // lane 3's slot s - 1
    const int left = (lane & ~3) | ((sub + 3) & 3);
    float nv[SL];
    int ni[SL];
#pragma unroll
    for (int s = 0; s < SL; ++s) {
      nv[s] = __shfl_sync(0xffffffffu, v[H][s], left);
      ni[s] = __shfl_sync(0xffffffffu, i[H][s], left);
    }
    if (act) {
#pragma unroll
      for (int s = SL - 1; s >= 0; --s) {
        const int q = 4 * s + sub;
        if (q > p) {
          if (sub) { v[H][s] = nv[s]; i[H][s] = ni[s]; }
          else if (s > 0) { v[H][s] = nv[s - 1]; i[H][s] = ni[s - 1]; }
        } else if (q == p) {
          v[H][s] = cv;
          i[H][s] = ci;
        }
      }
    }
    refresh_last<H>(k);
  }

  // Offer the quad-uniform candidate (cv, ci) where `want`.
  template <int H>
  __device__ __forceinline__ void offer(int k, bool want, float cv, int ci) {
    const bool act = want && lex_less(cv, ci, tv[H], ti[H]);
    if (__any_sync(0xffffffffu, act)) insert<H>(k, act, cv, ci);
  }

  // Offer row H's survivors of one column pair (x0 at column c, x1 at
  // c + 1, where ok0 / ok1), one per quad per step.
  template <int H>
  __device__ __forceinline__ void offer_pairs(int k, float x0, float x1, int c, bool ok0, bool ok1) {
    const int qbase = (threadIdx.x & 31) & ~3;
    unsigned b = ((__ballot_sync(0xffffffffu, ok0) >> qbase) & 0xFu) |
                 (((__ballot_sync(0xffffffffu, ok1) >> qbase) & 0xFu) << 4);
    while (__any_sync(0xffffffffu, b != 0)) {
      const bool want = b != 0;
      const int bit = want ? __ffs(b) - 1 : 0;
      b &= b - 1;
      const int src = qbase | (bit & 3), e = bit >> 2;  // quad-uniform
      const float cv = __shfl_sync(0xffffffffu, e ? x1 : x0, src);
      const int ci = __shfl_sync(0xffffffffu, c + e, src);
      offer<H>(k, want, cv, ci);
    }
  }

  // Out to the [rows, splits, k] partial lists; the warp's rows start at
  // query row wrow0.
  __device__ __forceinline__ void write(const TopkArgs& a, int wrow0, int split) const {
    const int sub = threadIdx.x & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qr = wrow0 + ((threadIdx.x & 31) >> 2) + 8 * h;
      if (qr >= a.rows) continue;
      const size_t out = ((size_t)qr * gridDim.x + split) * a.k;
#pragma unroll
      for (int s = 0; s < SL; ++s)
        if (4 * s + sub < a.k) {
          a.ov[out + 4 * s + sub] = v[h][s];
          a.oi[out + 4 * s + sub] = i[h][s] == kEmptyId ? -1 : i[h][s] + a.col_id0;
        }
    }
  }
};

// One row's list spanning a warp: lane l holds positions l and l + 32.
struct WarpList {
  float v[2];
  int i[2];
};

__device__ __forceinline__ void list_last(const WarpList& L, int k, float& tv, int& ti) {
  tv = __shfl_sync(0xffffffffu, k <= 32 ? L.v[0] : L.v[1], (k - 1) & 31);
  ti = __shfl_sync(0xffffffffu, k <= 32 ? L.i[0] : L.i[1], (k - 1) & 31);
}

// Insert (cv, ci), which beats position k - 1; all lanes call with it.
// (tv, ti) is position k - 1 afterwards.
__device__ __forceinline__ void list_insert(WarpList& L, int k, float cv, int ci, float& tv, int& ti) {
  const int lane = threadIdx.x & 31;
  const unsigned m0 = __ballot_sync(0xffffffffu, lane < k && lex_less(L.v[0], L.i[0], cv, ci));
  const unsigned m1 = __ballot_sync(0xffffffffu, lane + 32 < k && lex_less(L.v[1], L.i[1], cv, ci));
  const int p = __popc(m0) + __popc(m1);  // sorted: the smaller entries are a prefix
  float u0 = __shfl_up_sync(0xffffffffu, L.v[0], 1);  // position q takes q - 1
  int j0 = __shfl_up_sync(0xffffffffu, L.i[0], 1);
  float u1 = __shfl_up_sync(0xffffffffu, L.v[1], 1);
  int j1 = __shfl_up_sync(0xffffffffu, L.i[1], 1);
  const float w = __shfl_sync(0xffffffffu, L.v[0], 31);  // position 31 -> 32
  const int x = __shfl_sync(0xffffffffu, L.i[0], 31);
  if (lane == 0) { u1 = w; j1 = x; }
  if (lane > p) { L.v[0] = u0; L.i[0] = j0; } else if (lane == p) { L.v[0] = cv; L.i[0] = ci; }
  if (lane + 32 > p) { L.v[1] = u1; L.i[1] = j1; } else if (lane + 32 == p) { L.v[1] = cv; L.i[1] = ci; }
  list_last(L, k, tv, ti);
}

// Offer 64 candidates (two per lane) to the list; kInf is never taken.
__device__ __forceinline__ void list_offer64(WarpList& L, int k, float c0, int id0, float c1, int id1) {
  float tv;
  int ti;
  list_last(L, k, tv, ti);
  unsigned m0 = __ballot_sync(0xffffffffu, c0 < kInf && lex_less(c0, id0, tv, ti));
  unsigned m1 = __ballot_sync(0xffffffffu, c1 < kInf && lex_less(c1, id1, tv, ti));
  while (m0 | m1) {
    const bool first = m0 != 0;
    const int src = __ffs(first ? m0 : m1) - 1;
    if (first) m0 &= m0 - 1; else m1 &= m1 - 1;
    const float cv = __shfl_sync(0xffffffffu, first ? c0 : c1, src);
    const int ci = __shfl_sync(0xffffffffu, first ? id0 : id1, src);
    if (lex_less(cv, ci, tv, ti)) list_insert(L, k, cv, ci, tv, ti);  // the bar rises as the list fills
  }
}

#define LEANN_ROW_CASE(r) \
  case r:                 \
    list_insert(rows[r], k, cv, ci, tv, ti); \
    break;

struct WarpRows {
  WarpList rows[16];  // row 16 w + r
  float tv[2];        // position k - 1 of this thread's rows r0, r1
  int ti[2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < 16; ++r) rows[r] = WarpList{{kInf, kInf}, {kEmptyId, kEmptyId}};
    tv[0] = tv[1] = kInf;
    ti[0] = ti[1] = kEmptyId;
  }

  template <int H>
  __device__ __forceinline__ void offer_pairs(int k, float x0, float x1, int c, bool ok0, bool ok1) {
    const int lane = threadIdx.x & 31;
    unsigned m0 = __ballot_sync(0xffffffffu, ok0), m1 = __ballot_sync(0xffffffffu, ok1);
    while (m0 | m1) {
      const bool first = m0 != 0;
      const int src = __ffs(first ? m0 : m1) - 1;
      if (first) m0 &= m0 - 1; else m1 &= m1 - 1;
      const float cv = __shfl_sync(0xffffffffu, first ? x0 : x1, src);
      const int ci = __shfl_sync(0xffffffffu, first ? c : c + 1, src);
      float tv = __shfl_sync(0xffffffffu, this->tv[H], src);  // the row's bar now
      int ti = __shfl_sync(0xffffffffu, this->ti[H], src);
      if (!lex_less(cv, ci, tv, ti)) continue;
      switch ((src >> 2) + 8 * H) {
        LEANN_ROW_CASE(0) LEANN_ROW_CASE(1) LEANN_ROW_CASE(2) LEANN_ROW_CASE(3)
        LEANN_ROW_CASE(4) LEANN_ROW_CASE(5) LEANN_ROW_CASE(6) LEANN_ROW_CASE(7)
        LEANN_ROW_CASE(8) LEANN_ROW_CASE(9) LEANN_ROW_CASE(10) LEANN_ROW_CASE(11)
        LEANN_ROW_CASE(12) LEANN_ROW_CASE(13) LEANN_ROW_CASE(14) default: LEANN_ROW_CASE(15)
      }
      if ((lane >> 2) == (src >> 2)) { this->tv[H] = tv; this->ti[H] = ti; }  // the row's quad
    }
  }

  // Out to the [rows, splits, k] partial lists; the warp's rows start at
  // query row wrow0.
  __device__ __forceinline__ void write(const TopkArgs& a, int wrow0, int split) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int qr = wrow0 + r;
      if (qr >= a.rows) continue;
      const size_t out = ((size_t)qr * gridDim.x + split) * a.k;
      if (lane < a.k) {
        a.ov[out + lane] = rows[r].v[0];
        a.oi[out + lane] = rows[r].i[0] == kEmptyId ? -1 : rows[r].i[0] + a.col_id0;
      }
      if (lane + 32 < a.k) {
        a.ov[out + lane + 32] = rows[r].v[1];
        a.oi[out + lane + 32] = rows[r].i[1] == kEmptyId ? -1 : rows[r].i[1] + a.col_id0;
      }
    }
  }
};

#undef LEANN_ROW_CASE

// ---------------------------------------------------------------------------
// Lists above k = 64: a sorted list of k2 entries per row (entry k - 1 the
// bar) and a buffer of candidates that beat the bar (header note).

// Ascending bitonic sort of the 32 S entries a warp holds, entry
// e = 32 s + lane in slot s of lane `lane`: strides >= 32 pair two slots of
// one lane, strides < 32 two lanes' same slot.
template <int S>
__device__ __forceinline__ void warp_sort(float (&x)[S], int (&y)[S]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32 * S; size <<= 1) {
#pragma unroll
    for (int st = size >> 1; st > 0; st >>= 1) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const bool up = ((32 * s + lane) & size) == 0;  // the direction of this entry's block
        if (st >= 32) {
          const int t = s ^ (st >> 5);  // entry 32 t + lane, above this one where t > s
          if (t > s && (up ? lex_less(x[t], y[t], x[s], y[s]) : lex_less(x[s], y[s], x[t], y[t]))) {
            const float xv = x[s];
            const int yv = y[s];
            x[s] = x[t]; y[s] = y[t];
            x[t] = xv; y[t] = yv;
          }
        } else {
          const float ox = __shfl_xor_sync(0xffffffffu, x[s], st);
          const int oy = __shfl_xor_sync(0xffffffffu, y[s], st);
          const bool keep_min = ((lane & st) == 0) == up;
          if (keep_min ? lex_less(ox, oy, x[s], y[s]) : lex_less(x[s], y[s], ox, oy)) { x[s] = ox; y[s] = oy; }
        }
      }
    }
  }
}

// Sorts ascending the bitonic sequence (ascending, then descending) of the
// 32 L entries a warp holds as warp_sort does: strides >= 32 between two
// slots of a lane, then 16 .. 1 by shuffles.
template <int L>
__device__ __forceinline__ void warp_bitonic_merge(float (&a)[L], int (&b)[L]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = L >> 1; h > 0; h >>= 1)
#pragma unroll
    for (int t = 0; t < L; ++t) {
      const int u = t ^ h;
      if (u > t && lex_less(a[u], b[u], a[t], b[t])) {
        const float av = a[t];
        const int bv = b[t];
        a[t] = a[u]; b[t] = b[u];
        a[u] = av; b[u] = bv;
      }
    }
#pragma unroll
  for (int st = 16; st > 0; st >>= 1)
#pragma unroll
    for (int t = 0; t < L; ++t) {
      const float ox = __shfl_xor_sync(0xffffffffu, a[t], st);
      const int oy = __shfl_xor_sync(0xffffffffu, b[t], st);
      if ((lane & st) == 0 ? lex_less(ox, oy, a[t], b[t]) : lex_less(a[t], b[t], ox, oy)) { a[t] = ox; b[t] = oy; }
    }
}

// The list of 32 L entries in registers for the fold: one load, then the
// sorted buffer (32 S entries at bv / bi, entry e at e ^ swz, kInf past its
// count) folded in, one store. List position k2 - 1 - e (slot L - 1 - s of
// lane 31 - lane) takes buffer entry e = 32 s + lane where that is the
// smaller. (tv, ti) is entry k - 1 afterwards.
template <int S, int L>
__device__ __forceinline__ void fold_in_registers(const float* bv, const int* bi, int swz, float* lv, int* li, int k,
                                                  float& tv, int& ti) {
  static_assert(S <= L, "the buffer is no longer than the list");
  const int lane = threadIdx.x & 31;
  float a[L];
  int b[L];
#pragma unroll
  for (int t = 0; t < L; ++t) { a[t] = lv[32 * t + lane]; b[t] = li[32 * t + lane]; }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int e = (32 * s + 31 - lane) ^ swz;
    const float xr = bv[e];
    const int yr = bi[e];
    if (lex_less(xr, yr, a[L - 1 - s], b[L - 1 - s])) { a[L - 1 - s] = xr; b[L - 1 - s] = yr; }
  }
  warp_bitonic_merge<L>(a, b);
  float bv_k = kInf;
  int bi_k = kEmptyId;
#pragma unroll
  for (int t = 0; t < L; ++t) {
    lv[32 * t + lane] = a[t];
    li[32 * t + lane] = b[t];
    if (t == (k - 1) >> 5) { bv_k = a[t]; bi_k = b[t]; }
  }
  tv = __shfl_sync(0xffffffffu, bv_k, (k - 1) & 31);
  ti = __shfl_sync(0xffffffffu, bi_k, (k - 1) & 31);
}

// Sorts the bitonic sequence of k2 entries at (v, id) in memory, k2 a power
// of two >= 32, ascending: the compare-exchange stages of strides k2 / 2 ..
// 32 lane-parallel through memory (a __syncwarp between), then strides
// 16 .. 1 on each 32-entry run in registers.
__device__ __forceinline__ void bitonic_merge(float* v, int* id, int k2) {
  const int lane = threadIdx.x & 31;
  for (int st = k2 >> 1; st >= 32; st >>= 1) {
#pragma unroll 4
    for (int p = lane; p < (k2 >> 1); p += 32) {
      const int i = ((p & ~(st - 1)) << 1) | (p & (st - 1)), j = i + st;
      const float a = v[i], b = v[j];
      const int ia = id[i], ib = id[j];
      if (lex_less(b, ib, a, ia)) { v[i] = b; id[i] = ib; v[j] = a; id[j] = ia; }
    }
    __syncwarp();
  }
#pragma unroll 2
  for (int r = 0; r < k2; r += 32) {
    float x[1] = {v[r + lane]};
    int y[1] = {id[r + lane]};
    warp_bitonic_merge<1>(x, y);
    v[r + lane] = x[0];
    id[r + lane] = y[0];
  }
  __syncwarp();
}

// The flush. Folds the n <= CAP candidates of a buffer (bv, bi in shared
// memory; entry e at position e ^ swz, swz < 32) into a sorted list of k2
// entries (lv, li in shared or device memory; k2 a power of two >= CAP):
// afterwards the list holds the k2 smallest of both by (value, id), sorted,
// and (tv, ti) is its entry k - 1, the new bar. The buffer is sorted in
// registers; list position k2 - 1 - e takes buffer entry e where that is
// the smaller, which leaves a bitonic sequence holding exactly the k2
// smallest of list and buffer (the list ascends, the reversed buffer
// descends); a bitonic merge sorts it. Lists up to k2 = kRegFoldMaxK2 are
// folded in registers between one load and one store (the sorted buffer
// goes back to its place first, so its registers are free), longer ones
// stage by stage in memory. Every lane of the warp calls it.
template <int CAP>
__device__ __forceinline__ void fold_buffer(float* bv, int* bi, int swz, int n, float* lv, int* li, int k2, int k,
                                            float& tv, int& ti) {
  constexpr int S = CAP / 32;
  const int lane = threadIdx.x & 31;
  __syncwarp();  // the buffer's entries and the list, written by other lanes
  float x[S];
  int y[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int e = 32 * s + lane;
    x[s] = e < n ? bv[e ^ swz] : kInf;
    y[s] = e < n ? bi[e ^ swz] : kEmptyId;
  }
  warp_sort<S>(x, y);
  if (k2 <= kRegFoldMaxK2) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int e = (32 * s + lane) ^ swz;
      bv[e] = x[s];
      bi[e] = y[s];
    }
    __syncwarp();
    if (k2 == 128)
      fold_in_registers<S, 4>(bv, bi, swz, lv, li, k, tv, ti);
    else
      fold_in_registers<S, 8>(bv, bi, swz, lv, li, k, tv, ti);
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int e = 32 * s + lane, p = k2 - 1 - e;
      if (e < n && lex_less(x[s], y[s], lv[p], li[p])) { lv[p] = x[s]; li[p] = y[s]; }
    }
    __syncwarp();
    bitonic_merge(lv, li, k2);
    tv = lv[k - 1];
    ti = li[k - 1];
  }
  __syncwarp();  // the list is written before another lane reads it
}

// The lists of a warp's 16 query rows for k > 64: per row a buffer of CAP
// candidates in shared memory (appended by the row's quad) and a sorted list
// of k2 entries in the block's slice of the [rows, splits, k2] scratch in
// device memory. Rows past the query rows take nothing and have no list.
template <int STAGES, int CAP>
struct BufRows {
  static_assert(CAP % 32 == 0 && CAP <= kMinListLen, "the buffer is sorted in 32-entry slots and fits a list");
  static constexpr int kIds = kBM * CAP;  // the block's buffer ids: kIds floats past its values
  float* bv;       // row r's buffer at bv + r CAP (entry e at e ^ swz(r)), its ids kIds further
  float* lv;       // row r's list at lv + r lstride
  int* li;
  int lstride;     // splits x k2
  int live;        // the warp's rows inside the query rows
  int cnt[2];      // buffered candidates of this thread's rows r0, r1 (quad-uniform)
  float tv[2];     // position k - 1 of rows r0, r1
  int ti[2];

  // The quads of a warp write to 8 rows at once: an XOR of the slot's bank
  // by the row's quad keeps equal counts off one bank (the buffer's order
  // does not matter, it is sorted at the flush).
  static __device__ __forceinline__ int swz(int r) { return (r & 7) << 2; }

  // extra: the block's shared memory past the ring, norms and barriers:
  // [kBM][CAP] buffer values, then as many ids. (STAGES is the ring's,
  // BlockShape's.)
  __device__ __forceinline__ void bind(unsigned char* extra, const TopkArgs& a, int wg, int warp, int row0) {
    const int rb = 64 * wg + 16 * warp;  // the warp's first row in the block
    bv = reinterpret_cast<float*>(extra) + rb * CAP;
    const size_t off = ((size_t)(row0 + rb) * gridDim.x + blockIdx.x) * a.k2;
    lv = a.lv + off;
    li = a.li + off;
    lstride = gridDim.x * a.k2;
    live = max(0, min(16, a.rows - (row0 + rb)));
  }

  // The list length k2 (a field fewer in registers across the epilogue).
  __device__ __forceinline__ int list_len() const { return lstride / (int)gridDim.x; }

  __device__ __forceinline__ void init() {
    const int lane = threadIdx.x & 31, k2 = list_len();
    for (int r = 0; r < live; ++r)
      for (int q = lane; q < k2; q += 32) { lv[r * lstride + q] = kInf; li[r * lstride + q] = kEmptyId; }
    cnt[0] = cnt[1] = 0;
    tv[0] = tv[1] = kInf;
    ti[0] = ti[1] = kEmptyId;
  }

  // Flushes the rows of half H whose quads set `want` (quad-uniform), one
  // after another, and gives their quads the new bars.
  template <int H>
  __device__ __forceinline__ void flush_rows(int k, bool want) {
    const int lane = threadIdx.x & 31;
    unsigned m = __ballot_sync(0xffffffffu, want && (lane & 3) == 0);  // bit 4 g: row g + 8 H
    while (m) {
      const int g = (__ffs(m) - 1) >> 2, r = g + 8 * H;
      m &= m - 1;
      const int n = __shfl_sync(0xffffffffu, cnt[H], 4 * g);
      float nv;
      int ni;
      float* v = bv + r * CAP;
      fold_buffer<CAP>(v, reinterpret_cast<int*>(v + kIds), swz(r), n, lv + (size_t)r * lstride,
                       li + (size_t)r * lstride, list_len(), k, nv, ni);
      if ((lane >> 2) == g) {
        cnt[H] = 0;
        tv[H] = nv;
        ti[H] = ni;
      }
    }
  }

  // Append row H's survivors of one column pair (x0 at column c, x1 at
  // c + 1, where ok0 / ok1), at most 8 a row, flushing first the rows
  // whose buffers they would overflow.
  template <int H>
  __device__ __forceinline__ void offer_pairs(int k, float x0, float x1, int c, bool ok0, bool ok1) {
    const int lane = threadIdx.x & 31, qbase = lane & ~3;
    const unsigned below = (1u << (lane & 3)) - 1;
    unsigned qa = (__ballot_sync(0xffffffffu, ok0) >> qbase) & 0xFu;
    unsigned qb = (__ballot_sync(0xffffffffu, ok1) >> qbase) & 0xFu;
    const bool full = cnt[H] + __popc(qa) + __popc(qb) > CAP;
    if (__any_sync(0xffffffffu, full)) {
      flush_rows<H>(k, full);
      ok0 = ok0 && lex_less(x0, c, tv[H], ti[H]);  // the flushed rows' bars rose
      ok1 = ok1 && lex_less(x1, c + 1, tv[H], ti[H]);
      qa = (__ballot_sync(0xffffffffu, ok0) >> qbase) & 0xFu;
      qb = (__ballot_sync(0xffffffffu, ok1) >> qbase) & 0xFu;
    }
    const int r = (lane >> 2) + 8 * H, z = swz(r);
    float* v = bv + r * CAP;
    int* id = reinterpret_cast<int*>(v + kIds);
    if (ok0) {
      const int p = (cnt[H] + __popc(qa & below)) ^ z;
      v[p] = x0;
      id[p] = c;
    }
    if (ok1) {
      const int p = (cnt[H] + __popc(qa) + __popc(qb & below)) ^ z;
      v[p] = x1;
      id[p] = c + 1;
    }
    cnt[H] += __popc(qa) + __popc(qb);
  }

  // The last flushes, then the first k entries of each list out to the
  // [rows, splits, k] lists; the warp's rows start at query row wrow0.
  __device__ __forceinline__ void write(const TopkArgs& a, int wrow0, int split) {
    flush_rows<0>(a.k, cnt[0] > 0);
    flush_rows<1>(a.k, cnt[1] > 0);
    __syncwarp();
    const int lane = threadIdx.x & 31;
    for (int r = 0; r < live; ++r) {
      const size_t out = ((size_t)(wrow0 + r) * gridDim.x + split) * a.k;
      for (int q = lane; q < a.k; q += 32) {
        const int x = li[r * lstride + q];
        a.ov[out + q] = lv[r * lstride + q];
        a.oi[out + q] = x == kEmptyId ? -1 : x + a.col_id0;
      }
    }
  }
};

// Block shape of an instance: ring stages, whether the lists are buffered
// (BufRows), and the dynamic shared memory.
template <class Rows>
struct BlockShape {
  static constexpr int stages = kStages;
  static constexpr bool buffered = false;
  static constexpr size_t smem = kSmemBytes;
};
template <int STAGES, int CAP>
struct BlockShape<BufRows<STAGES, CAP>> {
  static constexpr int stages = STAGES;
  static constexpr bool buffered = true;
  static constexpr size_t smem =
      1024 + (size_t)STAGES * kStageBytes + 2 * kBN * 4 + 2 * STAGES * 8 + (size_t)kBM * CAP * 8;
};

// The buffered instance (header note): every k > 64, a 4-stage ring and
// 64-entry buffers.
using WideRows = BufRows<kStages, 64>;
static_assert(BlockShape<WideRows>::smem <= kMaxSmem, "a block takes at most 227 KB of shared memory on sm_90");

// ---------------------------------------------------------------------------
// The tile kernel

// The four accumulator registers of column group j: rows r0 and r1 (+8),
// columns 8 j + 2 (lane % 4) + {0, 1}.
#define LEANN_ACC_CASE(j) \
  case j:                 \
    d0 = acc[4 * j];      \
    d1 = acc[4 * j + 1];  \
    d2 = acc[4 * j + 2];  \
    d3 = acc[4 * j + 3];  \
    break;

template <class Rows>
__global__ void __launch_bounds__(384, 1)
    topk_tiles(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap cmap,
               const __grid_constant__ TopkArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // swizzle atoms: 1 KB
  const int kb = a.kb, k = a.k;
  constexpr int S = BlockShape<Rows>::stages;
  constexpr int QBOX = kBoxBytes, STAGE = kStageBytes;  // query box, then corpus box
  float* cn_s = reinterpret_cast<float*>(ring + S * STAGE);  // [2][kBN] norms, one copy per warpgroup
  uint64_t* full = reinterpret_cast<uint64_t*>(cn_s + 2 * kBN);
  uint64_t* empty = full + S;
  unsigned char* extra = reinterpret_cast<unsigned char*>(empty + S);  // BufRows' buffers

  const int split = blockIdx.x, row0 = blockIdx.y * kBM;
  const int all_tiles = (a.n_cols + kBN - 1) / kBN;
  const int tile_lo = (int)((long long)split * all_tiles / gridDim.x);
  const int n_tiles = (int)((long long)(split + 1) * all_tiles / gridDim.x) - tile_lo;
  const int col_lo = tile_lo * kBN;
  const int col_hi = min(a.n_cols, col_lo + n_tiles * kBN);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_u32(&full[s]), 1);     // the producer's expect_tx arrival + the bytes
      mbar_init(smem_u32(&empty[s]), 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256) {
      const int items = n_tiles * kb;
      for (int it = 0; it < items; ++it) {
        const int s = it % S, round = it / S;
        if (round > 0) mbar_wait(smem_u32(&empty[s]), (round - 1) & 1);
        const int t = it / kb, b = it - t * kb;
        unsigned char* stage = ring + s * STAGE;
        mbar_expect_tx(smem_u32(&full[s]), STAGE);
        tma_load_2d(smem_u32(stage), &qmap, smem_u32(&full[s]), b * kBoxK, row0);
        tma_load_2d(smem_u32(stage + QBOX), &cmap, smem_u32(&full[s]), b * kBoxK, col_lo + t * kBN);
      }
    }
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int r0 = 64 * wg + 16 * warp + (lane >> 2), r1 = r0 + 8;  // this thread's two rows (its quad's)
    const int self0 = a.self_excl ? a.self_col0 + row0 + r0 : -1;
    const int self1 = a.self_excl ? a.self_col0 + row0 + r1 : -1;
    const bool live0 = row0 + r0 < a.rows, live1 = row0 + r1 < a.rows;  // padding rows take nothing
    float qn0 = 0.0f, qn1 = 0.0f;
    if (a.l2) {
      if (live0) qn0 = a.qn[row0 + r0];
      if (live1) qn1 = a.qn[row0 + r1];
    }
    Rows R;  // this warp's 16 rows' lists
    if constexpr (BlockShape<Rows>::buffered) R.bind(extra, a, wg, warp, row0);
    R.init();
    float* cnw = cn_s + wg * kBN;
    const uint32_t ring_a = smem_u32(ring);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

    for (int t = 0; t < n_tiles; ++t) {
      const int tcol0 = col_lo + t * kBN;
      // the tile's column norms, loaded while the products run
      const float my_cn = (a.l2 && tcol0 + tid < col_hi) ? __ldg(a.cn + tcol0 + tid) : 0.0f;
      for (int b = 0; b < kb; ++b) {
        const int it = t * kb + b, s = it % S;
        mbar_wait(smem_u32(&full[s]), (it / S) & 1);
        fence_acc(acc);
        wgmma_fence();
        // A: this warpgroup's 64 rows of the query box (8-row groups of 1 KB);
        // B: the corpus box
        const uint32_t qa = ring_a + s * STAGE + wg * (kBoxBytes / 2), ca = ring_a + s * STAGE + QBOX;
#pragma unroll
        for (int kk = 0; kk < kBoxK / 16; ++kk)
          wgmma_m64n128k16(acc, sw128_desc(qa + kk * 32), sw128_desc(ca + kk * 32), (b | kk) != 0);
        wgmma_commit();
        if (b > 0) {  // keep one box in flight; release the one before
          wgmma_wait<1>();
          mbar_arrive(smem_u32(&empty[(it - 1) % S]));
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      mbar_arrive(smem_u32(&empty[(t * kb + kb - 1) % S]));
      bar_sync(1 + wg, 128);  // this warpgroup is past the previous tile's norms
      cnw[tid] = my_cn;
      bar_sync(1 + wg, 128);  // ... and this tile's are in place

      // epilogue: scores from the registers; the survivors of their row's
      // position k - 1 go into the row's list
#pragma unroll 1
      for (int j = 0; j < kBN / 8; ++j) {  // one copy of the insert path, not sixteen
        float d0, d1, d2, d3;
        switch (j) {
          LEANN_ACC_CASE(0) LEANN_ACC_CASE(1) LEANN_ACC_CASE(2) LEANN_ACC_CASE(3)
          LEANN_ACC_CASE(4) LEANN_ACC_CASE(5) LEANN_ACC_CASE(6) LEANN_ACC_CASE(7)
          LEANN_ACC_CASE(8) LEANN_ACC_CASE(9) LEANN_ACC_CASE(10) LEANN_ACC_CASE(11)
          LEANN_ACC_CASE(12) LEANN_ACC_CASE(13) LEANN_ACC_CASE(14) default: LEANN_ACC_CASE(15)
        }
        const int cl = 8 * j + 2 * (lane & 3), c = tcol0 + cl;
        const bool in0 = c < col_hi, in1 = c + 1 < col_hi;
        const float cn0 = cnw[cl], cn1 = cnw[cl + 1];
        const float s0 = a.l2 ? (qn0 + cn0) - 2.0f * d0 : -d0;
        const float s1 = a.l2 ? (qn0 + cn1) - 2.0f * d1 : -d1;
        const float s2 = a.l2 ? (qn1 + cn0) - 2.0f * d2 : -d2;
        const float s3 = a.l2 ? (qn1 + cn1) - 2.0f * d3 : -d3;
        const bool ok0 = live0 && in0 && c != self0 && lex_less(s0, c, R.tv[0], R.ti[0]);
        const bool ok1 = live0 && in1 && c + 1 != self0 && lex_less(s1, c + 1, R.tv[0], R.ti[0]);
        const bool ok2 = live1 && in0 && c != self1 && lex_less(s2, c, R.tv[1], R.ti[1]);
        const bool ok3 = live1 && in1 && c + 1 != self1 && lex_less(s3, c + 1, R.tv[1], R.ti[1]);
        if (__any_sync(0xffffffffu, ok0 || ok1)) R.template offer_pairs<0>(k, s0, s1, c, ok0, ok1);
        if (__any_sync(0xffffffffu, ok2 || ok3)) R.template offer_pairs<1>(k, s2, s3, c, ok2, ok3);
      }
    }
    R.write(a, row0 + 64 * wg + 16 * warp, split);
  }
}

#undef LEANN_ACC_CASE

// One warp per row folds its `splits` partial lists (ids -1 = empty).
__global__ void __launch_bounds__(kMergeThreads) topk_merge(const float* __restrict__ pv,
                                                            const int* __restrict__ pi,
                                                            float* __restrict__ ov, int* __restrict__ oi,
                                                            int rows, int splits, int k) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kMergeThreads / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;  // whole warp; no block-wide barrier below
  WarpList L = {{kInf, kInf}, {kEmptyId, kEmptyId}};
  const int n = splits * k;
  const size_t base = (size_t)r * n;
  for (int t0 = 0; t0 < n; t0 += 64) {
    float c[2];
    int id[2];
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + lane + 32 * h;
      c[h] = kInf;
      id[h] = kEmptyId;
      if (t < n && pi[base + t] >= 0) {
        c[h] = pv[base + t];
        id[h] = pi[base + t];
      }
    }
    list_offer64(L, k, c[0], id[0], c[1], id[1]);
  }
  if (lane < k) {
    ov[(size_t)r * k + lane] = L.v[0];
    oi[(size_t)r * k + lane] = L.i[0] == kEmptyId ? -1 : L.i[0];
  }
  if (lane + 32 < k) {
    ov[(size_t)r * k + lane + 32] = L.v[1];
    oi[(size_t)r * k + lane + 32] = L.i[1] == kEmptyId ? -1 : L.i[1];
  }
}

// One warp's list of k2 entries and its buffer in topk_merge_lists.
struct MergeWarp {
  float* bv;  // the warp's kMergeCap-entry buffer (shared memory)
  int* bi;
  float* lv;  // the warp's list (shared or device memory)
  int* li;
  int k, k2;
  int cnt;   // buffered entries
  float tv;  // the bar: list entry k - 1
  int ti;

  // Offer (c, cid) where `want`; every lane calls.
  __device__ __forceinline__ void offer(float c, int cid, bool want) {
    const int lane = threadIdx.x & 31;
    bool ok = want && lex_less(c, cid, tv, ti);
    unsigned m = __ballot_sync(0xffffffffu, ok);
    if (cnt + __popc(m) > kMergeCap) {
      fold_buffer<kMergeCap>(bv, bi, 0, cnt, lv, li, k2, k, tv, ti);
      cnt = 0;
      ok = ok && lex_less(c, cid, tv, ti);
      m = __ballot_sync(0xffffffffu, ok);
    }
    if (ok) {
      const int p = cnt + __popc(m & ((1u << lane) - 1));
      bv[p] = c;
      bi[p] = cid;
    }
    cnt += __popc(m);
  }

  __device__ __forceinline__ void flush() {
    if (cnt > 0) fold_buffer<kMergeCap>(bv, bi, 0, cnt, lv, li, k2, k, tv, ti);
    cnt = 0;
    __syncwarp();
  }
};

// The fold for k > 64: W = merge_warps(splits) warps per row (8 / W rows a
// block). Warp w of a row offers the entries of lists w, w + W, ... 32 at a
// time to its own list through a buffer (append past the bar, fold_buffer
// when it could overflow); then, halving, warp w folds the list of warp
// w + W / 2 into its own, and warp 0 writes the first k. The warps' lists
// (k2 entries) lie in dynamic shared memory up to k2 = kMergeSmemMaxK2,
// above in the [rows, kMergeWarps, k2] scratch sv / si.
__global__ void __launch_bounds__(kMergeThreads, 1) topk_merge_lists(const float* __restrict__ pv,
                                                                  const int* __restrict__ pi,
                                                                  float* __restrict__ ov, int* __restrict__ oi,
                                                                  float* sv, int* si, int rows, int splits,
                                                                  int k, int k2, int wpr) {
  extern __shared__ unsigned char merge_lists[];
  __shared__ float bufv[kMergeWarps][kMergeCap];
  __shared__ int bufi[kMergeWarps][kMergeCap];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, w = warp % wpr;
  const int r = blockIdx.x * (kMergeWarps / wpr) + warp / wpr;
  const bool live = r < rows;  // dead warps still reach every __syncthreads
  float* lv;
  int* li;
  if (sv) {
    const size_t off = ((size_t)r * kMergeWarps + w) * k2;
    lv = sv + off;
    li = si + off;
  } else {
    lv = reinterpret_cast<float*>(merge_lists) + (size_t)warp * k2;
    li = reinterpret_cast<int*>(merge_lists + (size_t)kMergeWarps * k2 * 4) + (size_t)warp * k2;
  }
  MergeWarp mw{bufv[warp], bufi[warp], lv, li, k, k2, 0, kInf, kEmptyId};
  if (live) {
    for (int q = lane; q < k2; q += 32) { lv[q] = kInf; li[q] = kEmptyId; }
    for (int l = w; l < splits; l += wpr) {
      const size_t base = ((size_t)r * splits + l) * k;
      for (int t0 = 0; t0 < k; t0 += 128) {  // four loads in flight
        float c[4];
        int cid[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = t0 + 32 * u + lane;
          const int x = t < k ? pi[base + t] : -1;
          c[u] = x >= 0 ? pv[base + t] : kInf;
          cid[u] = x >= 0 ? x : kEmptyId;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) mw.offer(c[u], cid[u], c[u] < kInf);
      }
    }
    mw.flush();
  }
  for (int half = wpr >> 1; half > 0; half >>= 1) {
    __syncthreads();  // the partner's list is complete
    if (live && w < half) {
      const float* ov2 = lv + (size_t)half * k2;  // warp w + half's list
      const int* oi2 = li + (size_t)half * k2;
      for (int q = lane; q < ((k + 31) & ~31); q += 32) {  // only its first k can be among the k smallest
        const float c = q < k ? ov2[q] : kInf;
        mw.offer(c, q < k ? oi2[q] : kEmptyId, c < kInf);
      }
      mw.flush();
    }
  }
  if (live && w == 0)
    for (int q = lane; q < k; q += 32) {
      ov[(size_t)r * k + q] = lv[q];
      oi[(size_t)r * k + q] = li[q] == kEmptyId ? -1 : li[q];
    }
}

// ---------------------------------------------------------------------------
// Host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Map of a row-major bf16 [rows, d] matrix read in boxes of 64 features x
// box_rows rows, 128-byte swizzle, zero fill out of bounds.
static bool make_map(CUtensorMap* map, const void* base, int rows, int d, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBoxK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// True when a launch's operands meet the TMA layout: d a multiple of 16
// (the wrappers zero-pad the features; row stride 2d a multiple of 16 B)
// and a 16-byte-aligned base.
static bool bf16_rows_ok(const void* base, int d) {
  return d % 16 == 0 && d > 0 && reinterpret_cast<uintptr_t>(base) % 16 == 0;
}

template <class Rows>
static void launch_tiles(const CUtensorMap& qmap, const CUtensorMap& cmap, const TopkArgs& a, int row_blocks,
                         int col_splits, cudaStream_t stream) {
  using B = BlockShape<Rows>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(topk_tiles<Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    attr_set = true;
  }
  topk_tiles<Rows><<<dim3(col_splits, row_blocks), 384, B::smem, stream>>>(qmap, cmap, a);
}

// Folds `lists` sorted lists of k entries per row, pv/pi [rows, lists, k]
// (ids -1 = empty, last), into ov/oi [rows, k]: up to k = 64 one warp per
// row with its list in registers, above topk_merge_lists, whose lists above
// k2 = kMergeSmemMaxK2 lie in the scratch mv / mi [rows, kMergeWarps, k2].
static int launch_merge(const float* pv, const int* pi, float* ov, int* oi, float* mv, int* mi, int rows,
                        int lists, int k, cudaStream_t stream) {
  if (k <= kRegMaxK) {
    const int blocks = (rows + kMergeWarps - 1) / kMergeWarps;
    topk_merge<<<blocks, kMergeThreads, 0, stream>>>(pv, pi, ov, oi, rows, lists, k);
    return 0;
  }
  const int k2 = list_len(k), wpr = merge_warps(lists), rpb = kMergeWarps / wpr;
  const bool in_smem = k2 <= kMergeSmemMaxK2;
  if (!in_smem && (!mv || !mi)) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(topk_merge_lists, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMergeWarps * kMergeSmemMaxK2 * 8);
    attr_set = true;
  }
  topk_merge_lists<<<(rows + rpb - 1) / rpb, kMergeThreads, in_smem ? (size_t)kMergeWarps * k2 * 8 : 0, stream>>>(
      pv, pi, ov, oi, in_smem ? nullptr : mv, in_smem ? nullptr : mi, rows, lists, k, k2, wpr);
  return 0;
}

// Checks the plan of ops/tile_plan.py, launches the tile kernel and, with
// more than one column split, the merge. The query rows are qbase [a.rows,
// d]; the corpus is cbase [c_rows, d]. lv / li: the [rows, splits, k2]
// lists of a launch at k > kRegMaxK; mv / mi: the
// merge's scratch above k2 = kMergeSmemMaxK2 (both null where not needed).
static int topk_launch(const void* qbase, const void* cbase, int c_rows, int d, TopkArgs a, int row_blocks,
                       int col_splits, float* pv, int* pi, float* ov, int* oi, float* lv, int* li, float* mv,
                       int* mi, cudaStream_t stream) {
  const bool reg = a.k <= kRegMaxK;
  a.k2 = reg ? 0 : list_len(a.k);
  if (a.k < 1 || a.rows < 1 || row_blocks != (a.rows + kBM - 1) / kBM || (!reg && (!lv || !li)) ||
      col_splits < 1 || (col_splits > 1 && col_splits > (a.n_cols + kBN - 1) / kBN) ||
      (col_splits > 1 && (!pv || !pi || (a.k2 > kMergeSmemMaxK2 && (!mv || !mi)))) || !bf16_rows_ok(qbase, d) ||
      !bf16_rows_ok(cbase, d))
    return (int)cudaErrorInvalidValue;  // checked before any launch: the merge's scratch too
  CUtensorMap qmap, cmap;
  if (!make_map(&qmap, qbase, a.rows, d, kBM) || !make_map(&cmap, cbase, c_rows, d, kBN))
    return (int)cudaErrorInvalidValue;
  a.kb = feature_boxes(d);
  a.ov = col_splits > 1 ? pv : ov;
  a.oi = col_splits > 1 ? pi : oi;
  a.lv = lv;
  a.li = li;
  // quad-owned lists up to k = 16 (eight rows insert at once), warp-wide in
  // registers up to 64, buffered above
  if (a.k <= 4)
    launch_tiles<QuadRows<1>>(qmap, cmap, a, row_blocks, col_splits, stream);
  else if (a.k <= 16)
    launch_tiles<QuadRows<4>>(qmap, cmap, a, row_blocks, col_splits, stream);
  else if (reg)
    launch_tiles<WarpRows>(qmap, cmap, a, row_blocks, col_splits, stream);
  else
    launch_tiles<WideRows>(qmap, cmap, a, row_blocks, col_splits, stream);
  if (col_splits > 1) {
    const int rc = launch_merge(pv, pi, ov, oi, mv, mi, a.rows, col_splits, a.k, stream);
    if (rc) return rc;
  }
  return (int)cudaGetLastError();
}

}  // namespace leann
