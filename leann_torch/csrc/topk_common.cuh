// The core shared by the two distance + top-k kernels (flat_topk.cu,
// knn_panel.cu): TMA loads into a ring of shared-memory stages behind
// mbarriers, wgmma products (bf16 in, f32 sums in registers), and a
// threshold-filtered top-k epilogue that works from the accumulator
// registers into sorted per-row lists held in registers.
//
// Block: 384 threads, 128 query rows, a range of corpus columns.
//   warpgroup 2 (producer, 40 registers after setmaxnreg): one thread
//     issues every TMA load. A stage holds one 64-feature box of the
//     block's 128 query rows and the same box of a 128-row corpus tile; the
//     ring has S stages, each behind a full and an empty mbarrier waited on
//     with phase parity.
//   warpgroups 0, 1 (consumers, 232 registers): warpgroup w owns query rows
//     64 w .. 64 w + 63 (one wgmma M) and issues wgmma m64n128k16 on every
//     stage, keeping one box in flight and releasing the one before. After
//     a tile's last box its accumulators hold the tile's 64 x 128 dot
//     products; the epilogue turns them into scores and offers each row's
//     survivors to that row's list. Both warpgroups read every stage and
//     arrive on its empty barrier, so no waiter is ever more than one phase
//     ahead of a barrier, which the parity waits need.
// Grid: (column splits, 128-row blocks). With more than one split each
// block writes a partial list per row and topk_merge folds them.
//
// Why 128 rows in two warpgroups and not 64 rows with the warpgroups taking
// alternate tiles (ping-pong): the epilogue's list inserts, not the
// products, bound the kernel, and ping-pong keeps two lists per row, each
// over half the columns, which costs about 1.8x the inserts of one list.
// With one list per row the products no longer overlap the epilogue of the
// same block; the other blocks on the card do not wait for it.
//
// Operands: bf16 row-major [rows, D], D a multiple of 16. A TMA box is 64
// features (128 B) x 128 rows with 128-byte swizzle; TMA's out-of-bounds
// zero fill covers the ragged row tails and D not a multiple of 64 (D = 400
// is 7 boxes, the last half filled). The wgmma descriptors read the same
// swizzled layout (K-major, 8-row groups 1 KB apart; warpgroup 1's rows
// start 8 KB into the query box).
//
// Order: entries sort ascending by (distance, id), so ties go to the lower
// id (lax.top_k's order). Inserts go one candidate per list at a time in a
// fixed order, and the sorted top-k of a set under a total order does not
// depend on insertion order, so results are deterministic; nothing is
// accumulated with atomics.
//
// Shared memory per block (kSmemBytes, fixed at compile time):
//   1 KB alignment slack + S x 32 KB stages + 2 x 128 f32 column norms +
//   2 S x 8 B mbarriers = 133,184 B at S = 4, whatever D and k: nothing is
//   resident but the ring (D = 384, 400 and 784 alike). One block per SM
//   (the registers allow no second).
//
// Above k = 64 (up to kMaxK = 256; the HNSW build asks for C = 4 R = 128)
// the lists no longer fit in registers: 16 rows x 4-8 slots x (value, id)
// per thread beside the 64 accumulators would spill. That instance
// (SmemRows) keeps each row's sorted list in shared memory and takes 64
// query rows per block, one consumer warpgroup and a producer warpgroup
// (256 threads), with a 3-stage ring of 8 KB query + 16 KB corpus boxes:
//   1 KB + 3 x 24 KB + 64 rows x 256 x 8 B lists (128 KB) + 1 KB norms +
//   48 B barriers = kWideSmemBytes = 206,896 B. With 128 rows the lists
//   alone would take 256 KB at k = 256.
//
// Above kMaxK (the HNSW build at M = 64, efConstruction = 512 asks for
// C = 512; a flat search may ask for any top_k) shared memory cannot hold
// the lists either: 64 rows x 512 x 8 B = 256 KB. That fifth instance
// (GmemRows) keeps each (block, row) list of k entries in device memory,
// in the block's own slice of the [rows, splits, k] output the wrapper
// allocates (the partial lists, or the final ones with one split), read
// and written through L2 by the same lane-owned insert as SmemRows
// (glist_insert). It takes the register instances' block: 128 rows, two
// consumer warpgroups, the 4-stage ring, kSmemBytes. Its merge
// (topk_merge_gmem) folds the partial lists into the [rows, k] output the
// same way. There is no limit on k but memory.
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
constexpr int kRegMaxK = 64;                     // WarpRows: two list slots per lane
constexpr int kMaxK = 256;                       // SmemRows: lists in shared memory; GmemRows above
constexpr int kGroup = 4;                        // GmemRows: 32-entry chunks an insert reads at once
constexpr int kStages = 4;                       // ring slots (one box in flight needs two)
constexpr int kMergeThreads = 256;

__host__ __device__ __forceinline__ int feature_boxes(int d) { return (d + kBoxK - 1) / kBoxK; }

// Bytes of dynamic shared memory the kernel takes (layout above).
constexpr size_t kSmemBytes = 1024 + (size_t)kStages * kStageBytes + 2 * kBN * 4 + 2 * kStages * 8;
static_assert(kSmemBytes <= 227 * 1024, "a block takes at most 227 KB of shared memory on sm_90");

// The shared-memory-list instance (64 < k <= kMaxK): 64-row blocks.
constexpr int kWideBM = 64;
constexpr int kWideStages = 3;
constexpr int kWideStageBytes = kWideBM * kBoxK * 2 + kBoxBytes;     // 8 KB query + 16 KB corpus box
constexpr size_t kListBytes = (size_t)kWideBM * kMaxK * (4 + 4);     // f32 values + i32 ids
constexpr size_t kWideSmemBytes =
    1024 + (size_t)kWideStages * kWideStageBytes + kListBytes + 2 * kBN * 4 + 2 * kWideStages * 8;
static_assert(kWideSmemBytes <= 227 * 1024, "a block takes at most 227 KB of shared memory on sm_90");

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
//   SmemRows (k <= 256): as WarpRows, but the lists lie in shared memory
//     (lane l owns positions l + 32 s), read and written back per insert;
//   GmemRows (any k): as SmemRows, with the lists in device memory.

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

// Insert (cv, ci), which beats position k - 1, into the sorted list (v, id)
// of k <= kMaxK entries in shared memory; all lanes of the warp call with it.
// Lane l reads and writes only its own positions l + 32 s, so no lane waits
// on another's stores. (tv, ti) is position k - 1 afterwards.
__device__ __forceinline__ void slist_insert(float* v, int* id, int k, float cv, int ci, float& tv, int& ti) {
  constexpr int SL = kMaxK / 32;
  const int lane = threadIdx.x & 31;
  float x[SL];
  int y[SL];
  int p = 0;  // the candidate's position: entries before it (a sorted prefix)
#pragma unroll
  for (int s = 0; s < SL; ++s) {
    const int q = lane + 32 * s;
    const bool in = q < k;
    x[s] = in ? v[q] : kInf;
    y[s] = in ? id[q] : kEmptyId;
    p += __popc(__ballot_sync(0xffffffffu, in && lex_less(x[s], y[s], cv, ci)));
  }
  float cw = kInf;  // lane 31's entry of slot s - 1 before the insert
  int cwi = kEmptyId;
#pragma unroll
  for (int s = 0; s < SL; ++s) {
    float u = __shfl_up_sync(0xffffffffu, x[s], 1);  // position q takes q - 1
    int j = __shfl_up_sync(0xffffffffu, y[s], 1);
    const float nw = __shfl_sync(0xffffffffu, x[s], 31);
    const int nwi = __shfl_sync(0xffffffffu, y[s], 31);
    if (lane == 0) { u = cw; j = cwi; }
    cw = nw;
    cwi = nwi;
    const int q = lane + 32 * s;
    if (q < k && q >= p) {
      if (q == p) { u = cv; j = ci; }
      v[q] = u;
      id[q] = j;
      x[s] = u;
      y[s] = j;
    }
  }
  float lv = kInf;
  int li = kEmptyId;
#pragma unroll
  for (int s = 0; s < SL; ++s)
    if (s == (k - 1) >> 5) { lv = x[s]; li = y[s]; }
  tv = __shfl_sync(0xffffffffu, lv, (k - 1) & 31);
  ti = __shfl_sync(0xffffffffu, li, (k - 1) & 31);
}

struct SmemRows {
  float* v;  // [16][kMaxK]: row 16 w + r at v + r kMaxK (bank = lane at every slot)
  int* id;
  float tv[2];  // position k - 1 of this thread's rows r0, r1
  int ti[2];

  // lists: the block's [kWideBM][kMaxK] values, then as many ids
  __device__ __forceinline__ void bind(unsigned char* lists, int warp) {
    v = reinterpret_cast<float*>(lists) + warp * 16 * kMaxK;
    id = reinterpret_cast<int*>(lists + (size_t)kWideBM * kMaxK * 4) + warp * 16 * kMaxK;
  }

  __device__ __forceinline__ void init() {
    const int lane = threadIdx.x & 31;
    for (int q = lane; q < 16 * kMaxK; q += 32) { v[q] = kInf; id[q] = kEmptyId; }
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
      const int r = (src >> 2) + 8 * H;
      slist_insert(v + r * kMaxK, id + r * kMaxK, k, cv, ci, tv, ti);
      if ((lane >> 2) == (src >> 2)) { this->tv[H] = tv; this->ti[H] = ti; }  // the row's quad
    }
  }

  __device__ __forceinline__ void write(const TopkArgs& a, int wrow0, int split) const {
    const int lane = threadIdx.x & 31;
    for (int r = 0; r < 16; ++r) {
      const int qr = wrow0 + r;
      if (qr >= a.rows) continue;
      const size_t out = ((size_t)qr * gridDim.x + split) * a.k;
      for (int q = lane; q < a.k; q += 32) {
        a.ov[out + q] = v[r * kMaxK + q];
        a.oi[out + q] = id[r * kMaxK + q] == kEmptyId ? -1 : id[r * kMaxK + q] + a.col_id0;
      }
    }
  }
};

// Insert (cv, ci), which beats position k - 1, into the sorted list (v, id)
// of k entries in device memory; all lanes of the warp call with it. As
// slist_insert, lane l reads and writes only its own positions l + 32 s, so
// it sees its own stores and no other lane's; the list is walked in groups
// of kGroup chunks of 32 (one load each, issued together): groups before
// the candidate's position are only counted, the rest shift by one.
// (tv, ti) is position k - 1 afterwards.
__device__ __forceinline__ void glist_insert(float* v, int* id, int k, float cv, int ci, float& tv, int& ti) {
  const int lane = threadIdx.x & 31;
  int p = -1;      // the candidate's position, once its group is reached
  int before = 0;  // entries before the candidate in the groups read so far
  float cw = kInf;  // lane 31's entry of the previous chunk before the insert
  int cwi = kEmptyId;
  float lv = kInf;  // position k - 1 afterwards (held by lane (k - 1) % 32)
  int li = kEmptyId;
  for (int g0 = 0; g0 < k; g0 += 32 * kGroup) {
    float x[kGroup];
    int y[kGroup];
#pragma unroll
    for (int s = 0; s < kGroup; ++s) {
      const int q = g0 + 32 * s + lane;
      x[s] = q < k ? v[q] : kInf;
      y[s] = q < k ? id[q] : kEmptyId;
    }
    if (p < 0) {
      int c = 0;  // sorted: the entries before the candidate are a prefix
#pragma unroll
      for (int s = 0; s < kGroup; ++s)
        c += __popc(__ballot_sync(0xffffffffu, g0 + 32 * s + lane < k && lex_less(x[s], y[s], cv, ci)));
      before += c;
      if (c == 32 * kGroup) {  // the whole group stays where it is
        cw = __shfl_sync(0xffffffffu, x[kGroup - 1], 31);
        cwi = __shfl_sync(0xffffffffu, y[kGroup - 1], 31);
        continue;
      }
      p = before;
    }
#pragma unroll
    for (int s = 0; s < kGroup; ++s) {
      const int q = g0 + 32 * s + lane;
      float u = __shfl_up_sync(0xffffffffu, x[s], 1);  // position q takes q - 1
      int j = __shfl_up_sync(0xffffffffu, y[s], 1);
      const float nw = __shfl_sync(0xffffffffu, x[s], 31);
      const int nwi = __shfl_sync(0xffffffffu, y[s], 31);
      if (lane == 0) { u = cw; j = cwi; }
      cw = nw;
      cwi = nwi;
      if (q < k && q >= p) {
        if (q == p) { u = cv; j = ci; }
        v[q] = u;
        id[q] = j;
        x[s] = u;
        y[s] = j;
      }
      if (q == k - 1) { lv = x[s]; li = y[s]; }
    }
  }
  tv = __shfl_sync(0xffffffffu, lv, (k - 1) & 31);
  ti = __shfl_sync(0xffffffffu, li, (k - 1) & 31);
}

// The lists of a warp's 16 query rows for k > kMaxK, in device memory: row
// r's list is the block's slice of the [rows, splits, k] output, k entries
// at v + r * stride. Rows past the query rows have no slice and take
// nothing.
struct GmemRows {
  float* v;
  int* id;
  size_t stride;  // splits x k
  int live;       // the warp's rows inside the query rows
  int len;        // k
  float tv[2];  // position k - 1 of this thread's rows r0, r1
  int ti[2];

  __device__ __forceinline__ void bind(const TopkArgs& a, int wrow0, int split) {
    const size_t off = ((size_t)wrow0 * gridDim.x + split) * a.k;
    v = a.ov + off;
    id = a.oi + off;
    stride = (size_t)gridDim.x * a.k;
    live = min(16, a.rows - wrow0);
    len = a.k;
  }

  __device__ __forceinline__ void init() {
    const int lane = threadIdx.x & 31;
    for (int r = 0; r < live; ++r)
      for (int q = lane; q < len; q += 32) { v[r * stride + q] = kInf; id[r * stride + q] = kEmptyId; }
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
      const size_t r = (src >> 2) + 8 * H;
      glist_insert(v + r * stride, id + r * stride, k, cv, ci, tv, ti);
      if ((lane >> 2) == (src >> 2)) { this->tv[H] = tv; this->ti[H] = ti; }  // the row's quad
    }
  }

  // The lists are the output already: empty slots to -1, ids made global.
  __device__ __forceinline__ void write(const TopkArgs& a, int, int) const {
    const int lane = threadIdx.x & 31;
    for (int r = 0; r < live; ++r)
      for (int q = lane; q < len; q += 32) {
        const int x = id[r * stride + q];
        id[r * stride + q] = x == kEmptyId ? -1 : x + a.col_id0;
      }
  }
};

// Block shape of an instance: consumer warpgroups (64 query rows each),
// ring stages, list bytes in shared memory, the dynamic shared memory, and
// whether the lists live in device memory.
template <class Rows>
struct BlockShape {
  static constexpr int warpgroups = 2, stages = kStages;
  static constexpr size_t lists = 0, smem = kSmemBytes;
  static constexpr bool gmem = false;
};
template <>
struct BlockShape<SmemRows> {
  static constexpr int warpgroups = 1, stages = kWideStages;
  static constexpr size_t lists = kListBytes, smem = kWideSmemBytes;
  static constexpr bool gmem = false;
};
template <>
struct BlockShape<GmemRows> {
  static constexpr int warpgroups = 2, stages = kStages;
  static constexpr size_t lists = 0, smem = kSmemBytes;
  static constexpr bool gmem = true;
};

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
__global__ void __launch_bounds__(128 * (BlockShape<Rows>::warpgroups + 1), 1)
    topk_tiles(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap cmap,
               const TopkArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // swizzle atoms: 1 KB
  const int kb = a.kb, k = a.k;
  constexpr int WG = BlockShape<Rows>::warpgroups, S = BlockShape<Rows>::stages;
  constexpr int BM = 64 * WG, QBOX = BM * kBoxK * 2, STAGE = QBOX + kBoxBytes;  // query box, then corpus box
  float* cn_s = reinterpret_cast<float*>(ring + S * STAGE);  // [2][kBN] norms, one copy per warpgroup
  uint64_t* full = reinterpret_cast<uint64_t*>(cn_s + 2 * kBN);
  uint64_t* empty = full + S;
  unsigned char* lists = reinterpret_cast<unsigned char*>(empty + S);  // SmemRows only

  const int split = blockIdx.x, row0 = blockIdx.y * BM;
  const int all_tiles = (a.n_cols + kBN - 1) / kBN;
  const int tile_lo = (int)((long long)split * all_tiles / gridDim.x);
  const int n_tiles = (int)((long long)(split + 1) * all_tiles / gridDim.x) - tile_lo;
  const int col_lo = tile_lo * kBN;
  const int col_hi = min(a.n_cols, col_lo + n_tiles * kBN);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_u32(&full[s]), 1);     // the producer's expect_tx arrival + the bytes
      mbar_init(smem_u32(&empty[s]), 128 * WG);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == WG) {
    // ---------------- producer ----------------
    if constexpr (WG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 128 * WG) {
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
    // (one consumer warpgroup: 256 threads may take 255 registers each)
    if constexpr (WG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
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
    if constexpr (BlockShape<Rows>::lists > 0) R.bind(lists, warp);
    if constexpr (BlockShape<Rows>::gmem) R.bind(a, row0 + 64 * wg + 16 * warp, split);
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

// The same fold for 64 < k <= kMaxK: each warp's list in shared memory.
__global__ void __launch_bounds__(kMergeThreads) topk_merge_wide(const float* __restrict__ pv,
                                                                 const int* __restrict__ pi,
                                                                 float* __restrict__ ov, int* __restrict__ oi,
                                                                 int rows, int splits, int k) {
  __shared__ float sv[kMergeThreads / 32][kMaxK];
  __shared__ int si[kMergeThreads / 32][kMaxK];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r = blockIdx.x * (kMergeThreads / 32) + w;
  if (r >= rows) return;  // whole warp; no block-wide barrier below
  float* v = sv[w];
  int* id = si[w];
  for (int q = lane; q < kMaxK; q += 32) { v[q] = kInf; id[q] = kEmptyId; }
  float tv = kInf;
  int ti = kEmptyId;
  const int n = splits * k;
  const size_t base = (size_t)r * n;
  for (int t0 = 0; t0 < n; t0 += 32) {
    const int t = t0 + lane;
    float c = kInf;
    int cid = kEmptyId;
    if (t < n && pi[base + t] >= 0) {
      c = pv[base + t];
      cid = pi[base + t];
    }
    unsigned m = __ballot_sync(0xffffffffu, c < kInf && lex_less(c, cid, tv, ti));
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float cv = __shfl_sync(0xffffffffu, c, src);
      const int ci = __shfl_sync(0xffffffffu, cid, src);
      if (lex_less(cv, ci, tv, ti)) slist_insert(v, id, k, cv, ci, tv, ti);  // the bar rises as the list fills
    }
  }
  for (int q = lane; q < k; q += 32) {
    ov[(size_t)r * k + q] = v[q];
    oi[(size_t)r * k + q] = id[q] == kEmptyId ? -1 : id[q];
  }
}

// The same fold for k > kMaxK: each warp's list is its row of the [rows, k]
// output, in device memory (glist_insert).
__global__ void __launch_bounds__(kMergeThreads) topk_merge_gmem(const float* __restrict__ pv,
                                                                 const int* __restrict__ pi, float* ov,
                                                                 int* oi, int rows, int splits, int k) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kMergeThreads / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;  // whole warp; no block-wide barrier below
  float* v = ov + (size_t)r * k;
  int* id = oi + (size_t)r * k;
  for (int q = lane; q < k; q += 32) { v[q] = kInf; id[q] = kEmptyId; }
  float tv = kInf;
  int ti = kEmptyId;
  const int n = splits * k;
  const size_t base = (size_t)r * n;
  for (int t0 = 0; t0 < n; t0 += 32) {
    const int t = t0 + lane;
    float c = kInf;
    int cid = kEmptyId;
    if (t < n && pi[base + t] >= 0) {
      c = pv[base + t];
      cid = pi[base + t];
    }
    unsigned m = __ballot_sync(0xffffffffu, c < kInf && lex_less(c, cid, tv, ti));
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float cv = __shfl_sync(0xffffffffu, c, src);
      const int ci = __shfl_sync(0xffffffffu, cid, src);
      if (lex_less(cv, ci, tv, ti)) glist_insert(v, id, k, cv, ci, tv, ti);  // the bar rises as the list fills
    }
  }
  for (int q = lane; q < k; q += 32)
    if (id[q] == kEmptyId) id[q] = -1;
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
    cudaFuncSetAttribute(topk_tiles<Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)B::smem);
    attr_set = true;
  }
  topk_tiles<Rows><<<dim3(col_splits, row_blocks), 128 * (B::warpgroups + 1), B::smem, stream>>>(qmap, cmap, a);
}

// Folds `lists` sorted lists of k entries per row, pv/pi [rows, lists, k]
// (ids -1 = empty), into ov/oi [rows, k]: one warp per row, its list in
// registers, shared memory or device memory by k.
static void launch_merge(const float* pv, const int* pi, float* ov, int* oi, int rows, int lists, int k,
                         cudaStream_t stream) {
  const int warps = kMergeThreads / 32, blocks = (rows + warps - 1) / warps;
  if (k <= kRegMaxK)
    topk_merge<<<blocks, kMergeThreads, 0, stream>>>(pv, pi, ov, oi, rows, lists, k);
  else if (k <= kMaxK)
    topk_merge_wide<<<blocks, kMergeThreads, 0, stream>>>(pv, pi, ov, oi, rows, lists, k);
  else
    topk_merge_gmem<<<blocks, kMergeThreads, 0, stream>>>(pv, pi, ov, oi, rows, lists, k);
}

// Checks the plan of ops/tile_plan.py, launches the tile kernel and, with
// more than one column split, the merge. The query rows are qbase [a.rows,
// d]; the corpus is cbase [c_rows, d].
static int topk_launch(const void* qbase, const void* cbase, int c_rows, int d, TopkArgs a,
                       int row_blocks, int col_splits, float* pv, int* pi, float* ov, int* oi,
                       cudaStream_t stream) {
  const bool wide = a.k > kRegMaxK && a.k <= kMaxK;
  const int bm = wide ? kWideBM : kBM;  // query rows per block
  if (a.k < 1 || a.rows < 1 || row_blocks != (a.rows + bm - 1) / bm ||
      col_splits < 1 || (col_splits > 1 && col_splits > (a.n_cols + kBN - 1) / kBN) ||
      (col_splits > 1 && (!pv || !pi)) || !bf16_rows_ok(qbase, d) || !bf16_rows_ok(cbase, d))
    return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, cmap;
  if (!make_map(&qmap, qbase, a.rows, d, bm) || !make_map(&cmap, cbase, c_rows, d, kBN))
    return (int)cudaErrorInvalidValue;
  a.kb = feature_boxes(d);
  a.ov = col_splits > 1 ? pv : ov;
  a.oi = col_splits > 1 ? pi : oi;
  // quad-owned lists up to k = 16 (eight rows insert at once), warp-wide in
  // registers up to 64, warp-wide in shared memory up to kMaxK, warp-wide
  // in device memory above
  if (a.k <= 4)
    launch_tiles<QuadRows<1>>(qmap, cmap, a, row_blocks, col_splits, stream);
  else if (a.k <= 16)
    launch_tiles<QuadRows<4>>(qmap, cmap, a, row_blocks, col_splits, stream);
  else if (a.k <= kRegMaxK)
    launch_tiles<WarpRows>(qmap, cmap, a, row_blocks, col_splits, stream);
  else if (wide)
    launch_tiles<SmemRows>(qmap, cmap, a, row_blocks, col_splits, stream);
  else
    launch_tiles<GmemRows>(qmap, cmap, a, row_blocks, col_splits, stream);
  if (col_splits > 1) launch_merge(pv, pi, ov, oi, a.rows, col_splits, a.k, stream);
  return (int)cudaGetLastError();
}

}  // namespace leann
