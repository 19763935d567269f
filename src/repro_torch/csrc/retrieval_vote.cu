// Fused cosine similarity -> running top-k -> per-label neighbour vote.
//
// Replaces the TPU kernels repro/kernels/topk_retrieval/kernel.py:
// retrieval_vote_kernel (bodies _vote_kernel, _fold_topk, _masked_sims),
// entry point retrieval_vote_launch, and topk_retrieval_kernel (body
// _topk_kernel, the vote kernel's phase 0), entry point
// topk_retrieval_launch.  Both entry points run one kernel, templated on
// VOTE: the same CTA, similarity tiles and fold, so their (vals, idx) are
// equal bit for bit; the top-k one skips the label gather and the votes.
// In a trace the vote is retrieval_kernel<true>, the top-k
// retrieval_kernel<false>.
//
// Contract (the JAX package's): sim = Q . S^T in float32; store rows at or
// past n_valid are masked to NEG_INF; a running top-k keeps ties on the lower
// db index; slots past the number of valid rows stay (NEG_INF, -1); the vote
// is the mean label over the valid neighbours only.
//
// What bounds it on the H100: the B x N_db x d float32 product on the CUDA
// cores (2*B*N_db*d operations at the card's 67 TFLOP/s fp32 rate; no TF32 —
// parity with the reference needs full fp32).  The store (128 MiB at the
// main path's size) is read once per query block, from L2 where the blocks
// that run together stream the same tiles.
//
// Design: one 256-thread CTA per block of 64 queries.  The queries sit
// transposed in shared memory for the whole launch; the store walks by in
// tiles of 64 rows, staged transposed in shared memory, so every thread
// reads one float4 of queries and one float4 of store rows per depth step
// and does 16 FMAs on a 4x4 register tile.  Each dot is a sequential fmaf
// chain over d in ascending order, so a row's similarity does not depend on
// where the row sits in the store (duplicated rows tie exactly).  After each
// tile a warp per query folds the 64 masked similarities into the query's
// sorted top-k list (kept in shared memory): candidates arrive in ascending
// db index, so a candidate enters only if strictly above the k-th value and
// lands after every equal entry — the lower-index tie rule.  The TPU kernel's
// second pass (membership @ labels, shaped for the MXU) becomes a gather of
// labels[idx] by index, which gives the same vote.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // queries per CTA
constexpr int TN = 64;        // store rows per tile
constexpr int THREADS = 256;
constexpr int KMAX = 64;      // top-k slots (paper Table 4 range: k <= 64)
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;

__host__ __device__ inline size_t smem_floats(int d) {
  return (size_t)d * BQ            // qT [d][BQ]
         + (size_t)d * TN          // sT [d][TN]
         + (size_t)BQ * (TN + 1)   // sim [BQ][TN+1]
         + (size_t)2 * BQ * KMAX;  // topv [BQ][KMAX], topi [BQ][KMAX]
}

// Fold one lane-held candidate group (db indices ascending with the lane)
// into a warp-held sorted list: slot s0 = lane (a0, b0), s1 = lane + 32.
__device__ inline void fold_group(float c, int cidx, int lane, int k,
                                  float& a0, int& b0, float& a1, int& b1,
                                  float& kth) {
  bool pending = true;
  while (true) {
    unsigned m = __ballot_sync(FULL, pending && c > kth);
    if (m == 0) break;
    int src = __ffs(m) - 1;
    float v = __shfl_sync(FULL, c, src);
    int vi = __shfl_sync(FULL, cidx, src);
    if (lane <= src) pending = false;
    // entries >= v are a prefix of the sorted list; the newcomer goes after
    // them (they all hold lower db indices)
    int pos = __popc(__ballot_sync(FULL, lane < k && a0 >= v))
              + __popc(__ballot_sync(FULL, lane + 32 < k && a1 >= v));
    float up0 = __shfl_up_sync(FULL, a0, 1);
    int upi0 = __shfl_up_sync(FULL, b0, 1);
    float up1 = __shfl_up_sync(FULL, a1, 1);
    int upi1 = __shfl_up_sync(FULL, b1, 1);
    float last0 = __shfl_sync(FULL, a0, 31);
    int lasti0 = __shfl_sync(FULL, b0, 31);
    if (lane == 0) { up1 = last0; upi1 = lasti0; }
    if (lane == pos) { a0 = v; b0 = vi; }
    else if (lane > pos) { a0 = up0; b0 = upi0; }
    if (lane + 32 == pos) { a1 = v; b1 = vi; }
    else if (lane + 32 > pos) { a1 = up1; b1 = upi1; }
    float kv = (k - 1 < 32) ? a0 : a1;
    kth = __shfl_sync(FULL, kv, (k - 1) & 31);
  }
}

template <bool VOTE>
__global__ void __launch_bounds__(THREADS, 1)
retrieval_kernel(const float* __restrict__ store,
                 const float* __restrict__ labels,
                 const float* __restrict__ queries, float* __restrict__ vals,
                 int* __restrict__ idx, float* __restrict__ votes, int n_rows,
                 int d, int n_lab, int b, int k) {
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);
  float* sT = qT + (size_t)d * BQ;
  float* sim = sT + (size_t)d * TN;
  float* topv = sim + BQ * (TN + 1);
  int* topi = reinterpret_cast<int*>(topv + BQ * KMAX);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int d4 = d >> 2;

  // queries, transposed and zero-padded past b: lanes walk the rows so the
  // transposed stores hit distinct banks
  for (int f = tid; f < BQ * d4; f += THREADS) {
    int q = f % BQ, c4 = f / BQ;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + q < b)
      v = __ldg(reinterpret_cast<const float4*>(
          queries + (size_t)(q0 + q) * d) + c4);
    qT[(4 * c4 + 0) * BQ + q] = v.x;
    qT[(4 * c4 + 1) * BQ + q] = v.y;
    qT[(4 * c4 + 2) * BQ + q] = v.z;
    qT[(4 * c4 + 3) * BQ + q] = v.w;
  }
  for (int f = tid; f < BQ * KMAX; f += THREADS) {
    topv[f] = NEG_INF;
    topi[f] = -1;
  }

  const int tq = tid >> 4;   // queries 4tq .. 4tq+3
  const int tr = tid & 15;   // tile rows 4tr .. 4tr+3
  for (int r0 = 0; r0 < n_rows; r0 += TN) {
    __syncthreads();   // the previous tile's readers are done
    for (int f = tid; f < TN * d4; f += THREADS) {
      int r = f % TN, c4 = f / TN;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < n_rows)
        v = __ldg(reinterpret_cast<const float4*>(
            store + (size_t)(r0 + r) * d) + c4);
      sT[(4 * c4 + 0) * TN + r] = v.x;
      sT[(4 * c4 + 1) * TN + r] = v.y;
      sT[(4 * c4 + 2) * TN + r] = v.z;
      sT[(4 * c4 + 3) * TN + r] = v.w;
    }
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float4 qv = *reinterpret_cast<const float4*>(qT + c * BQ + 4 * tq);
      float4 sv = *reinterpret_cast<const float4*>(sT + c * TN + 4 * tr);
      float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qa[i], sa[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int r = 4 * tr + j;
        sim[(4 * tq + i) * (TN + 1) + r] =
            (r0 + r < n_rows) ? acc[i][j] : NEG_INF;
      }
    __syncthreads();

    // fold: one warp per query, 8 queries per warp
    for (int qq = warp; qq < BQ; qq += THREADS / 32) {
      float* tv = topv + qq * KMAX;
      int* ti = topi + qq * KMAX;
      // slots at or past k hold -inf: never counted, never stored
      float a0 = lane < k ? tv[lane] : -INFINITY;
      int b0 = lane < k ? ti[lane] : -1;
      float a1 = lane + 32 < k ? tv[lane + 32] : -INFINITY;
      int b1 = lane + 32 < k ? ti[lane + 32] : -1;
      float kth = __shfl_sync(FULL, (k - 1 < 32) ? a0 : a1, (k - 1) & 31);
      const float* srow = sim + qq * (TN + 1);
      fold_group(srow[lane], r0 + lane, lane, k, a0, b0, a1, b1, kth);
      fold_group(srow[lane + 32], r0 + lane + 32, lane, k, a0, b0, a1, b1,
                 kth);
      if (lane < k) { tv[lane] = a0; ti[lane] = b0; }
      if (lane + 32 < k) { tv[lane + 32] = a1; ti[lane + 32] = b1; }
    }
  }
  __syncthreads();

  // emit top-k and the vote: one warp per query, one lane per label; the
  // label sum runs over the slots in order
  for (int qq = warp; qq < BQ; qq += THREADS / 32) {
    int q = q0 + qq;
    if (q >= b) continue;
    const float* tv = topv + qq * KMAX;
    const int* ti = topi + qq * KMAX;
    for (int s = lane; s < k; s += 32) {
      vals[(size_t)q * k + s] = tv[s];
      idx[(size_t)q * k + s] = ti[s];
    }
    if constexpr (!VOTE) continue;
    int cnt = 0;
    for (int s = 0; s < k; ++s) cnt += ti[s] >= 0;
    float denom = fmaxf((float)cnt, 1.f);
    for (int l = lane; l < n_lab; l += 32) {
      float sum = 0.f;
      for (int s = 0; s < k; ++s) {
        int id = ti[s];
        if (id >= 0) sum += __ldg(labels + (size_t)id * n_lab + l);
      }
      votes[(size_t)q * n_lab + l] = sum / denom;
    }
  }
}

// One launch of retrieval_kernel<VOTE> on ``stream``; labels and votes are
// read and written only when VOTE.
template <bool VOTE>
int launch(const float* store, const float* labels, const float* queries,
           float* vals, int* idx, float* votes, int n_db, int d, int n_lab,
           int b, int k, int n_valid, void* stream) {
  if (d <= 0 || d % 4 != 0 || k < 1 || k > KMAX) return (int)cudaErrorInvalidValue;
  size_t bytes = smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      retrieval_kernel<VOTE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  int n_rows = n_valid < n_db ? n_valid : n_db;
  if (n_rows < 0) n_rows = 0;
  int grid = (b + BQ - 1) / BQ;
  if (grid == 0) return 0;
  retrieval_kernel<VOTE><<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      store, labels, queries, vals, idx, votes, n_rows, d, n_lab, b, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int retrieval_vote_launch(const float* store, const float* labels,
                                     const float* queries, float* vals,
                                     int* idx, float* votes, int n_db, int d,
                                     int n_lab, int b, int k, int n_valid,
                                     void* stream) {
  return launch<true>(store, labels, queries, vals, idx, votes, n_db, d,
                      n_lab, b, k, n_valid, stream);
}

extern "C" int topk_retrieval_launch(const float* store, const float* queries,
                                     float* vals, int* idx, int n_db, int d,
                                     int b, int k, int n_valid,
                                     void* stream) {
  return launch<false>(store, nullptr, queries, vals, idx, nullptr, n_db, d,
                       0, b, k, n_valid, stream);
}
