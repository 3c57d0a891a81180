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
// peak). The kernel is topk_tiles (topk_common.cuh): a block takes 128 query
// rows (64 per consumer warpgroup) and streams them with the corpus, box by
// box, through the TMA ring into wgmma m64n128k16; each row's running top-k
// (k <= 64) lives in registers across the warp. Above k = 64 (the HNSW
// build's C = 4 R = 128) the lists live in shared memory and a block takes
// 64 query rows; above k = 256 in device memory. Each block reads the whole
// corpus and its query rows' boxes once per tile from L2: 782 blocks x 782
// tiles x 192 KB = 117 GB for the 100K build, the 120 GB of the first
// version (64 rows resident, the corpus once per block), since no width is
// kept resident. What the redesign buys is the wgmma/TMA products and one
// list per row (the first version's warp-serial inserts through shared
// memory bounded it). When the query rows give fewer than 2 x SMs blocks
// (below ~34K rows), the planner (ops/tile_plan.py) splits the columns,
// about one wave of blocks since every split refills its lists, and
// topk_merge folds the partial lists.
//
// Distances: |q|^2 + |c|^2 - 2 q.c with f32 norms of the f32 embeddings
// (passed in), the product on the bf16 rows. Columns >= n_real_cols and the
// query's own row are never candidates. The caller zero-pads the features
// to a multiple of 16 (D = 385 under mips augmentation; ops/knn_panel.py
// panel_inputs). Ties go to the lower id, as lax.top_k.
//
// Shared memory per block: 133,184 B at every D and at k > 256 (lists in
// device memory), 206,896 B for 64 < k <= 256 (topk_common.cuh).
//
// One entry, knn_panel_launch, serves both builds. The one-pass k-NN
// (ops/graph.py exact_knn) passes rows of the corpus as the query rows and
// the whole corpus as the columns. The column-sharded k-NN (exact_knn_sharded,
// the counterpart of _exact_knn_shard_device: corpora whose bf16 matrix
// outgrows the card) passes an uploaded chunk or rows of the slab, and a
// column slab whose column 0 is global id col_id0; ids come out global. The
// running top-k the JAX package carries across shards with lax.top_k over
// concat([run, new]) is the second entry, topk_merge_launch: the two lists
// stacked as [S, 2, k] and folded by (distance, id) with the same merge
// kernels the column splits use.
#include "topk_common.cuh"

using namespace leann;

// q bf16[S, D] (query rows, 16-byte-aligned base; may be rows of c itself)
// with f32 squared norms qn[S]; c bf16[M, D] the column slab with norms
// cn[M]; columns >= n_real_cols are never candidates. Ids come out global:
// col_id0 + the slab column. Query row r is corpus row q_id0 + r and never
// takes itself; q_id0 < 0 excludes nothing. Partial lists pv/pi
// [S, col_splits, k] when col_splits > 1; outputs ov f32 / oi i32 [S, k].
extern "C" int knn_panel_launch(const void* q, const float* qn, const void* c, const float* cn, float* pv, int* pi,
                                float* ov, int* oi, int S, int M, int D, int n_real_cols, int col_id0, int q_id0,
                                int k, int row_blocks, int col_splits, cudaStream_t stream) {
  if (S < 1 || M < 1 || col_id0 < 0 || !qn || !cn) return (int)cudaErrorInvalidValue;
  TopkArgs a{};
  a.cn = cn;
  a.qn = qn;
  a.rows = S;
  a.self_excl = q_id0 >= 0;
  a.self_col0 = q_id0 - col_id0;
  a.col_id0 = col_id0;
  a.l2 = 1;
  a.n_cols = n_real_cols < M ? (n_real_cols > 0 ? n_real_cols : 0) : M;
  a.k = k;
  return topk_launch(q, c, M, D, a, row_blocks, col_splits, pv, pi, ov, oi, stream);
}

// Folds `lists` sorted lists per row, pv f32 / pi i32 [rows, lists, k] (ids
// -1 = empty), into ov / oi [rows, k] by (distance, id): the running-state
// merge of the sharded k-NN at lists = 2.
extern "C" int topk_merge_launch(const float* pv, const int* pi, float* ov, int* oi, int rows, int lists, int k,
                                 cudaStream_t stream) {
  if (rows < 1 || lists < 1 || k < 1) return (int)cudaErrorInvalidValue;
  launch_merge(pv, pi, ov, oi, rows, lists, k, stream);
  return (int)cudaGetLastError();
}
