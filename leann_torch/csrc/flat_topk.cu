// Exact flat search: fused distance + top-k over the whole corpus.
//
// Replaces leann_tpu/ops/pallas_topk.py `_kernel` (driven by
// `pallas_flat_search` / `pallas_flat_search_packed`): the TPU kernel walks
// the corpus in a sequential grid and keeps the running top-k of every
// query in VMEM scratch across grid steps. Blocks of a GPU grid run in
// parallel and carry nothing between them, so the sequential grid becomes
// two launches:
//   1. flat_topk_partial: block (s, g) takes query group g (64 queries,
//      resident in shared memory as bf16) against corpus slice s, walks the
//      slice in 64-row tiles (WMMA bf16 products, f32 accumulation) and keeps
//      a running top-k per query in shared memory; writes [B, S, k] partials.
//   2. flat_topk_merge: one warp per query merges its S partial lists.
//
// Bound on the H100: bytes. At B = 64, N = 100K, D = 384 the kernel reads
// 76.8 MB of bf16 corpus for 4.9 GFLOP (64 FLOP/byte, far below the ~295
// where bf16 tensor cores become the limit), so the floor is ~23 us at
// 3.35 TB/s. This simple design reads every corpus row once (the query
// group stays in shared memory); what it leaves on the table is overlap:
// loads, products and the warp-serial list inserts of one tile do not
// overlap (no cp.async/TMA pipeline), and with 64 queries per group a batch
// of B <= 64 gives one block per corpus slice.
//
// Scores: l2 -> |q|^2 + |e|^2 - 2 q.e with f32 norms (|e|^2 passed in,
// |q|^2 from the f32 query); mips/cosine -> -q.e. The query is rounded to
// bf16 for the product, as the TPU kernel does. Rows >= valid_n are never
// candidates. Ties go to the lower id. The caller zero-pads the features of
// both operands to a multiple of 16 (D = 385 under mips augmentation), so
// every corpus tile is loaded in 16-byte vectors.
#include "topk_common.cuh"

using namespace leann;

__global__ void __launch_bounds__(kThreads) flat_topk_partial(
    const float* __restrict__ q, const __nv_bfloat16* __restrict__ e, const float* __restrict__ en,
    float* __restrict__ pv, int* __restrict__ pi, int B, int N, int D, int valid_n, int k, int l2,
    int n_splits, int rows_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldq = D + 8, ldc = kChunk + 8, ldd = kTile + 4;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* cs = qs + kTile * ldq;
  float* dots = reinterpret_cast<float*>(cs + kTile * ldc);
  float* qn = dots + kTile * ldd;
  float* lv = qn + kTile;
  int* li = reinterpret_cast<int*>(lv + kTile * k);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int split = blockIdx.x, qb0 = blockIdx.y * kTile;

  for (int t = threadIdx.x; t < kTile * D; t += blockDim.x) {
    const int r = t / D, c = t % D, gr = qb0 + r;
    qs[r * ldq + c] = __float2bfloat16(gr < B ? q[(size_t)gr * D + c] : 0.0f);
  }
  for (int r = warp; r < kTile; r += kThreads / 32) {
    float s = 0.0f;
    if (qb0 + r < B)
      for (int c = lane; c < D; c += 32) {
        const float x = q[(size_t)(qb0 + r) * D + c];
        s += x * x;
      }
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) qn[r] = s;
    warp_init_list(lv + r * k, li + r * k, k);
  }

  const int row_lo = split * rows_per_split;
  const int row_hi = min(min(N, valid_n), row_lo + rows_per_split);
  for (int col0 = row_lo; col0 < row_hi; col0 += kTile) {
    TileAcc acc;
    acc.zero();
    for (int d0 = 0; d0 < D; d0 += kChunk) {
      const int w = min(kChunk, D - d0);
      __syncthreads();  // the previous tile's readers of cs / dots are done
      load_bf16_tile(cs, ldc, e, row_hi, D, col0, kTile, d0, w);
      __syncthreads();
      acc.mma(qs + d0, ldq, cs, ldc, w);
    }
    acc.store(dots, ldd);
    __syncthreads();
    for (int r = warp; r < kTile; r += kThreads / 32) {
      if (qb0 + r >= B) continue;  // warp-uniform
      float c[2];
      int id[2];
      for (int h = 0; h < 2; ++h) {
        const int col = lane + 32 * h, gid = col0 + col;
        id[h] = gid;
        c[h] = kInf;
        if (gid < row_hi) {
          const float dot = dots[r * ldd + col];
          c[h] = l2 ? qn[r] + en[gid] - 2.0f * dot : -dot;
        }
      }
      warp_offer64(lv + r * k, li + r * k, k, c[0], id[0], c[1], id[1]);
    }
  }

  for (int r = warp; r < kTile; r += kThreads / 32) {
    if (qb0 + r >= B) continue;
    const size_t base = ((size_t)(qb0 + r) * n_splits + split) * k;
    for (int j = lane; j < k; j += 32) {
      pv[base + j] = lv[r * k + j];
      pi[base + j] = li[r * k + j] == kEmptyId ? -1 : li[r * k + j];
    }
  }
}

__global__ void __launch_bounds__(kThreads) flat_topk_merge(
    const float* __restrict__ pv, const int* __restrict__ pi, float* __restrict__ ov,
    int* __restrict__ oi, int B, int n_splits, int k) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* lv = reinterpret_cast<float*>(smem) + warp * k;
  int* li = reinterpret_cast<int*>(reinterpret_cast<float*>(smem) + (kThreads / 32) * k) + warp * k;
  const int b = blockIdx.x * (kThreads / 32) + warp;
  if (b >= B) return;  // whole warp; no block-wide barrier below
  warp_init_list(lv, li, k);
  const int n = n_splits * k;
  const size_t base = (size_t)b * n;
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
    warp_offer64(lv, li, k, c[0], id[0], c[1], id[1]);
  }
  for (int j = lane; j < k; j += 32) {
    ov[(size_t)b * k + j] = lv[j];
    oi[(size_t)b * k + j] = li[j] == kEmptyId ? -1 : li[j];
  }
}

extern "C" size_t flat_topk_smem_bytes(int D, int k) {
  return (size_t)kTile * (D + 8) * 2 + (size_t)kTile * (kChunk + 8) * 2 +
         (size_t)kTile * (kTile + 4) * 4 + kTile * 4 + (size_t)kTile * k * 8;
}

// q f32[B, D], e bf16[N, D] (D a multiple of 16, 16-byte-aligned base),
// en f32[N] (l2 only, else may be null),
// partial buffers pv/pi [B, n_splits, k], outputs ov/oi [B, k].
// Returns cudaGetLastError() after the two launches.
extern "C" int flat_topk_launch(const float* q, const void* e, const float* en, float* pv, int* pi,
                                float* ov, int* oi, int B, int N, int D, int valid_n, int k, int l2,
                                int n_splits, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || B < 1 || n_splits < 1 || !bf16_rows_ok(e, D))
    return (int)cudaErrorInvalidValue;
  const int n_eff = valid_n < N ? valid_n : N;
  int rows_per_split = (n_eff + n_splits - 1) / n_splits;
  rows_per_split = ((rows_per_split + kTile - 1) / kTile) * kTile;
  if (rows_per_split < kTile) rows_per_split = kTile;
  const size_t smem = flat_topk_smem_bytes(D, k);
  cudaFuncSetAttribute(flat_topk_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid(n_splits, (B + kTile - 1) / kTile);
  flat_topk_partial<<<grid, kThreads, smem, stream>>>(
      q, static_cast<const __nv_bfloat16*>(e), en, pv, pi, B, N, D, valid_n, k, l2, n_splits,
      rows_per_split);
  const int warps = kThreads / 32;
  flat_topk_merge<<<(B + warps - 1) / warps, kThreads, (size_t)warps * k * 8, stream>>>(
      pv, pi, ov, oi, B, n_splits, k);
  return (int)cudaGetLastError();
}
