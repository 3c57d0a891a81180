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
// peak). The kernel is topk_tiles (topk_common.cuh) with the queries taken
// from the corpus itself: a block takes 128 query rows (64 per consumer
// warpgroup) and streams them with the corpus, box by box, through the TMA
// ring into wgmma m64n128k16; each row's running top-k (k <= 64) lives in
// registers across the warp. Above k = 64 (the HNSW build's C = 4 R = 128)
// the lists live in shared memory and a block takes 64 query rows. Each block reads the whole corpus and its
// query rows' boxes once per tile from L2: 782 blocks x 782 tiles x 192 KB
// = 117 GB for the 100K build, the 120 GB of the first version (64 rows
// resident, the corpus once per block), since no width is kept resident.
// What the redesign buys is the wgmma/TMA products and one list per row
// (the first version's warp-serial inserts through shared memory bounded
// it). When the query rows give fewer than 2 x SMs blocks (q_count below
// ~34K rows), the planner (ops/tile_plan.py) splits the columns, about one
// wave of blocks since every split refills its lists, and topk_merge folds
// the partial lists.
//
// Distances: |q|^2 + |c|^2 - 2 q.c with f32 norms of the f32 embeddings
// (passed in), the product on the bf16 rows. Columns >= n_real and the
// query's own row are never candidates. The caller zero-pads the features to
// a multiple of 16 (D = 385 under mips augmentation; ops/knn_panel.py
// panel_inputs). Ties go to the lower id, as lax.top_k.
//
// Shared memory per block: 133,184 B at every D, 206,896 B for k > 64
// (topk_common.cuh).
#include "topk_common.cuh"

using namespace leann;

// e bf16[N, D] (D a multiple of 16, 16-byte-aligned base; query rows are
// rows q_start .. q_start + q_count of e), norms f32[N]; partial lists
// pv/pi [q_count, col_splits, k] when col_splits > 1 (else may be null);
// outputs ov f32 / oi i32 [q_count, k]. The plan (row_blocks, col_splits)
// comes from ops/tile_plan.py plan_launch. Returns cudaGetLastError() after the
// launches.
extern "C" int knn_panel_launch(const void* e, const float* norms, float* pv, int* pi, float* ov, int* oi,
                                int N, int D, int q_start, int q_count, int n_real, int k, int row_blocks,
                                int col_splits, cudaStream_t stream) {
  if (q_count < 1 || q_start < 0 || q_start + q_count > N) return (int)cudaErrorInvalidValue;
  TopkArgs a{};
  a.cn = norms;
  a.qn = norms;
  a.rows = q_count;
  a.q_row0 = q_start;
  a.self_excl = 1;
  a.l2 = 1;
  a.n_cols = n_real < N ? (n_real > 0 ? n_real : 0) : N;
  a.k = k;
  return topk_launch(e, N, e, N, D, a, row_blocks, col_splits, pv, pi, ov, oi, stream);
}
