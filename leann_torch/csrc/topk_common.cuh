// Shared pieces of the two distance + top-k kernels (flat_topk.cu,
// knn_panel.cu): tile loads into shared memory, a WMMA bf16 tile product
// with f32 accumulation, and a running top-k list per query row that one
// warp maintains in shared memory.
//
// Order: entries are sorted ascending by (distance, id), so ties go to the
// lower id, the order lax.top_k and a stable sort give.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace leann {

constexpr float kInf = 3.4e38f;  // "no candidate": masked columns, empty slots
constexpr int kEmptyId = 0x7fffffff;
constexpr int kTile = 64;        // query rows and corpus rows per block tile
constexpr int kChunk = 128;      // feature columns per corpus-tile load
constexpr int kThreads = 256;    // 8 warps
constexpr int kMaxK = 64;        // two list slots per lane

__device__ __forceinline__ bool lex_less(float a, int ai, float b, int bi) {
  return a < b || (a == b && ai < bi);
}

// Insert (cv, ci) into the sorted list (lv, li) of length k; the caller has
// checked that it beats the last entry. All 32 lanes call with the same
// candidate.
__device__ __forceinline__ void warp_insert(float* lv, int* li, int k, float cv, int ci) {
  const int lane = threadIdx.x & 31;
  const bool h0 = lane < k, h1 = lane + 32 < k;
  const float v0 = h0 ? lv[lane] : kInf;
  const int i0 = h0 ? li[lane] : kEmptyId;
  const float v1 = h1 ? lv[lane + 32] : kInf;
  const int i1 = h1 ? li[lane + 32] : kEmptyId;
  const unsigned m0 = __ballot_sync(0xffffffffu, h0 && lex_less(v0, i0, cv, ci));
  const unsigned m1 = __ballot_sync(0xffffffffu, h1 && lex_less(v1, i1, cv, ci));
  const int p = __popc(m0) + __popc(m1);  // sorted list: the smaller ones are a prefix
  __syncwarp();
  if (h0 && lane >= p && lane + 1 < k) { lv[lane + 1] = v0; li[lane + 1] = i0; }
  if (h1 && lane + 32 >= p && lane + 33 < k) { lv[lane + 33] = v1; li[lane + 33] = i1; }
  if (lane == 0) { lv[p] = cv; li[p] = ci; }
  __syncwarp();
}

// Offer 64 candidates (two per lane: c0/id0 and c1/id1) to one row's list.
// Candidates at kInf are never taken.
__device__ __forceinline__ void warp_offer64(float* lv, int* li, int k,
                                             float c0, int id0, float c1, int id1) {
  float tv = lv[k - 1];
  int ti = li[k - 1];
  unsigned m0 = __ballot_sync(0xffffffffu, c0 < kInf && lex_less(c0, id0, tv, ti));
  unsigned m1 = __ballot_sync(0xffffffffu, c1 < kInf && lex_less(c1, id1, tv, ti));
  while (m0 | m1) {
    float cv;
    int ci;
    if (m0) {
      const int src = __ffs(m0) - 1;
      m0 &= m0 - 1;
      cv = __shfl_sync(0xffffffffu, c0, src);
      ci = __shfl_sync(0xffffffffu, id0, src);
    } else {
      const int src = __ffs(m1) - 1;
      m1 &= m1 - 1;
      cv = __shfl_sync(0xffffffffu, c1, src);
      ci = __shfl_sync(0xffffffffu, id1, src);
    }
    tv = lv[k - 1];  // the bar rises as the list fills
    ti = li[k - 1];
    if (lex_less(cv, ci, tv, ti)) warp_insert(lv, li, k, cv, ci);
  }
}

__device__ __forceinline__ void warp_init_list(float* lv, int* li, int k) {
  const int lane = threadIdx.x & 31;
  for (int j = lane; j < k; j += 32) { lv[j] = kInf; li[j] = kEmptyId; }
  __syncwarp();
}

// True when a launch's operands meet the tile loads' layout: d a multiple of
// 16 (the wrappers zero-pad the features) and a 16-byte-aligned base.
__host__ __forceinline__ bool bf16_rows_ok(const void* base, int d) {
  return d % 16 == 0 && reinterpret_cast<uintptr_t>(base) % 16 == 0;
}

// Copy rows [row0, row0 + rows) x features [d0, d0 + width) of a row-major
// bf16 matrix [n_rows, d] into shared memory with row stride `ld`, in 16-byte
// vectors (see bf16_rows_ok; width is a multiple of 16); rows past n_rows are
// zero-filled.
__device__ __forceinline__ void load_bf16_tile(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src,
                                               int n_rows, int d, int row0, int rows, int d0,
                                               int width) {
  const int per_row = width / 8;
  for (int t = threadIdx.x; t < rows * per_row; t += blockDim.x) {
    const int r = t / per_row, c = (t % per_row) * 8;
    const int gr = row0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (gr < n_rows) v = *reinterpret_cast<const uint4*>(src + (size_t)gr * d + d0 + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

// dots[64][ldd] (f32) = A[64 x width] . B[64 x width]^T for one feature
// chunk, accumulated into per-warp fragments. Warp w owns output rows
// 16*(w/2) .. +16 and columns 32*(w%2) .. +32 (two 16x16 fragments).
using namespace nvcuda;
struct TileAcc {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2];
  __device__ __forceinline__ void zero() {
    wmma::fill_fragment(c[0], 0.0f);
    wmma::fill_fragment(c[1], 0.0f);
  }
  __device__ __forceinline__ void mma(const __nv_bfloat16* a, int lda, const __nv_bfloat16* b, int ldb,
                                      int width) {
    const int w = threadIdx.x >> 5;
    const int r0 = 16 * (w >> 1), c0 = 32 * (w & 1);
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
    for (int kk = 0; kk < width; kk += 16) {
      wmma::load_matrix_sync(fa, a + r0 * lda + kk, lda);
      wmma::load_matrix_sync(fb, b + c0 * ldb + kk, ldb);
      wmma::mma_sync(c[0], fa, fb, c[0]);
      wmma::load_matrix_sync(fb, b + (c0 + 16) * ldb + kk, ldb);
      wmma::mma_sync(c[1], fa, fb, c[1]);
    }
  }
  __device__ __forceinline__ void store(float* dots, int ldd) {
    const int w = threadIdx.x >> 5;
    const int r0 = 16 * (w >> 1), c0 = 32 * (w & 1);
    wmma::store_matrix_sync(dots + r0 * ldd + c0, c[0], ldd, wmma::mem_row_major);
    wmma::store_matrix_sync(dots + r0 * ldd + c0 + 16, c[1], ldd, wmma::mem_row_major);
  }
};

}  // namespace leann
