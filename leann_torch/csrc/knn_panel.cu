// Exact k-NN panel of the graph build: for a block of query rows of the
// corpus, the k nearest corpus rows under squared L2, self and padding
// excluded.
//
// Replaces leann_tpu/ops/pallas_knn.py `_kernel` (driven by
// `panel_bucketmin_call`), together with what its caller does around it
// (ops/graph.py `_panel_winners` / `_exact_knn_device`: add |q|^2 back,
// per-row top-k of the panel, merge into the running top-k across tiles).
// The Pallas kernel folds each strip into 128 lane-bucket argmins only to
// fit TPU VMEM; that fold is an approximation this kernel does not need, so
// it returns the exact top-k, the result the JAX package returns below
// 200K rows.
//
// Bound on the H100: operations. The full build computes 2 * N^2 * D FLOP
// (7.7 TFLOP at N = 100K, D = 384: ~7.8 ms at the 989 TFLOP/s bf16 dense
// peak) and reads the corpus once per 64-row query block from L2. This
// simple design keeps each block's 64 query rows resident in shared memory,
// walks the corpus in 64-column tiles with WMMA (bf16 in, f32 accumulate),
// and keeps each row's running top-k (k <= 64) in shared memory, inserted
// warp by warp. WMMA through synchronous shared-memory loads reaches a small
// fraction of the wgmma/TMA peak, and the list inserts serialise within a
// warp; both are the known costs of this first version.
//
// Distances: |q|^2 + |c|^2 - 2 q.c with f32 norms of the f32 embeddings
// (passed in), the product on the bf16 rows. Columns >= n_real and the
// query's own row are never candidates. The caller zero-pads the features to
// a multiple of 16 (D = 385 under mips augmentation; ops/knn_panel.py
// panel_inputs), so every tile is loaded in 16-byte vectors. Ties go to the
// lower id, as lax.top_k.
#include "topk_common.cuh"

using namespace leann;

__global__ void __launch_bounds__(kThreads) knn_panel_kernel(
    const __nv_bfloat16* __restrict__ e, const float* __restrict__ norms, float* __restrict__ ov,
    int* __restrict__ oi, int N, int D, int q_start, int q_count, int n_real, int k) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldq = D + 8, ldc = kChunk + 8, ldd = kTile + 4;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* cs = qs + kTile * ldq;
  float* dots = reinterpret_cast<float*>(cs + kTile * ldc);
  float* qn = dots + kTile * ldd;
  float* lv = qn + kTile;
  int* li = reinterpret_cast<int*>(lv + kTile * k);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int local0 = blockIdx.x * kTile;  // first query of this block, local
  const int qb0 = q_start + local0;       // ... and its global row id
  const int n_cols = min(N, n_real);

  load_bf16_tile(qs, ldq, e, N, D, qb0, kTile, 0, D);
  for (int r = warp; r < kTile; r += kThreads / 32) {
    if (lane == 0) qn[r] = (qb0 + r < N) ? norms[qb0 + r] : 0.0f;
    warp_init_list(lv + r * k, li + r * k, k);
  }

  for (int col0 = 0; col0 < n_cols; col0 += kTile) {
    TileAcc acc;
    acc.zero();
    for (int d0 = 0; d0 < D; d0 += kChunk) {
      const int w = min(kChunk, D - d0);
      __syncthreads();  // the previous tile's readers of cs / dots are done
      load_bf16_tile(cs, ldc, e, n_cols, D, col0, kTile, d0, w);
      __syncthreads();
      acc.mma(qs + d0, ldq, cs, ldc, w);
    }
    acc.store(dots, ldd);
    __syncthreads();
    for (int r = warp; r < kTile; r += kThreads / 32) {
      if (local0 + r >= q_count || qb0 + r >= N) continue;  // warp-uniform
      float c[2];
      int id[2];
      for (int h = 0; h < 2; ++h) {
        const int col = lane + 32 * h, gid = col0 + col;
        id[h] = gid;
        c[h] = kInf;
        if (gid < n_cols && gid != qb0 + r) c[h] = qn[r] + norms[gid] - 2.0f * dots[r * ldd + col];
      }
      warp_offer64(lv + r * k, li + r * k, k, c[0], id[0], c[1], id[1]);
    }
  }

  for (int r = warp; r < kTile; r += kThreads / 32) {
    if (local0 + r >= q_count) continue;
    const size_t base = (size_t)(local0 + r) * k;
    for (int j = lane; j < k; j += 32) {
      ov[base + j] = lv[r * k + j];
      oi[base + j] = li[r * k + j] == kEmptyId ? -1 : li[r * k + j];
    }
  }
}

extern "C" size_t knn_panel_smem_bytes(int D, int k) {
  return (size_t)kTile * (D + 8) * 2 + (size_t)kTile * (kChunk + 8) * 2 +
         (size_t)kTile * (kTile + 4) * 4 + kTile * 4 + (size_t)kTile * k * 8;
}

// e bf16[N, D] (D a multiple of 16, 16-byte-aligned base; query rows are
// rows q_start .. q_start + q_count of e),
// norms f32[N]; outputs ov f32 / oi i32 [q_count, k].
// Returns cudaGetLastError() after the launch.
extern "C" int knn_panel_launch(const void* e, const float* norms, float* ov, int* oi, int N, int D,
                                int q_start, int q_count, int n_real, int k, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || q_count < 1 || q_start < 0 || q_start + q_count > N ||
      !bf16_rows_ok(e, D))
    return (int)cudaErrorInvalidValue;
  const size_t smem = knn_panel_smem_bytes(D, k);
  cudaFuncSetAttribute(knn_panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  knn_panel_kernel<<<(q_count + kTile - 1) / kTile, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(e), norms, ov, oi, N, D, q_start, q_count, n_real, k);
  return (int)cudaGetLastError();
}
