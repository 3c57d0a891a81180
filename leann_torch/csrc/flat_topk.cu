// Exact flat search: fused distance + top-k over the whole corpus.
//
// Replaces leann_tpu/ops/pallas_topk.py `_kernel` (driven by
// `pallas_flat_search` / `pallas_flat_search_packed`): the TPU kernel walks
// the corpus in a sequential grid and keeps the running top-k of every
// query in VMEM scratch across grid steps. Here:
//   1. flat_query_prep: rounds the f32 queries to bf16 and takes their f32
//      squared norms, once per launch;
//   2. topk_tiles (topk_common.cuh): block (s, g) takes query group g (128
//      rows, the batch padded by TMA's zero fill) against corpus column
//      split s, both streamed box by box through the TMA ring into wgmma,
//      with each row's running top-k in registers;
//   3. topk_merge: folds the splits' partial lists, one warp per query.
//
// Bound on the H100: bytes. At B = 64, N = 100K, D = 384 the kernel reads
// 76.8 MB of bf16 corpus for 4.9 GFLOP (64 FLOP/byte, far below the ~295
// where bf16 tensor cores become the limit): ~23 us at 3.35 TB/s. A batch
// of B <= 128 is one query group, so the planner (ops/tile_plan.py) splits
// the columns into one block per SM; each block keeps up to S = 4 corpus
// boxes of 16 KB in flight (64 KB per SM, above the ~25 KB that streaming
// HBM at full rate needs). The query boxes come from L2 with every tile.
// At B <= 64 the second warpgroup's rows are all padding: it runs the
// products and skips the epilogue.
//
// Scores: l2 -> |q|^2 + |e|^2 - 2 q.e with f32 norms (|e|^2 passed in,
// |q|^2 from the f32 query); mips/cosine -> -q.e. Rows >= valid_n are
// never candidates; -1 / 3.4e38 fill rows with fewer than k valid rows.
// k <= 16 (the oracle's k = 3, search's default 5) takes the quad-owned
// lists, the cheapest inserts; any k is taken. Above k = 64 each split's
// rows buffer their survivors and fold them into sorted lists in batches
// (topk_common.cuh BufRows), and topk_merge_lists folds the splits' lists
// with W warps per query; there the list work, not the corpus read, bounds
// the call, so the planner makes no split narrower than k columns.
//
// Shared memory per block: 133,184 B at every D up to k = 64, 198,720 to
// 231,456 B above by the instance (topk_common.cuh).
#include "topk_common.cuh"

using namespace leann;

__global__ void __launch_bounds__(128) flat_query_prep(const float* __restrict__ q,
                                                       __nv_bfloat16* __restrict__ qb,
                                                       float* __restrict__ qn, int D) {
  __shared__ float part[4];
  const size_t row = (size_t)blockIdx.x * D;
  float s = 0.0f;
  for (int c = threadIdx.x; c < D; c += 128) {
    const float x = q[row + c];
    qb[row + c] = __float2bfloat16(x);
    s += x * x;
  }
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) qn[blockIdx.x] = (part[0] + part[1]) + (part[2] + part[3]);
}

// q f32[B, D], e bf16[N, D] (D a multiple of 16, 16-byte-aligned base),
// en f32[N] (l2 only, else may be null); scratch qb bf16[B, D], qn f32[B],
// (col_splits > 1) partial lists pv/pi [B, col_splits, k], (k > 64) the
// buffered lists lv/li [B, col_splits, k2] and (k2 > 2048, split) the
// merge's mv/mi [B, 8, k2]; outputs ov/oi [B, k]. The plan (row_blocks,
// col_splits) comes from ops/tile_plan.py plan_launch. Returns
// cudaGetLastError() after the launches.
extern "C" int flat_topk_launch(const float* q, const void* e, const float* en, void* qb, float* qn, float* pv,
                                int* pi, float* ov, int* oi, float* lv, int* li, float* mv, int* mi, int B, int N,
                                int D, int valid_n, int k, int l2, int row_blocks, int col_splits,
                                cudaStream_t stream) {
  if (B < 1 || N < 1 || (l2 && !en) || !bf16_rows_ok(e, D)) return (int)cudaErrorInvalidValue;
  TopkArgs a{};
  a.cn = en;
  a.qn = qn;
  a.rows = B;
  a.self_excl = 0;
  a.col_id0 = 0;
  a.l2 = l2;
  a.n_cols = valid_n < N ? (valid_n > 0 ? valid_n : 0) : N;
  a.k = k;
  flat_query_prep<<<B, 128, 0, stream>>>(q, static_cast<__nv_bfloat16*>(qb), qn, D);
  return topk_launch(qb, e, N, D, a, row_blocks, col_splits, pv, pi, ov, oi, lv, li, mv, mi, stream);
}
