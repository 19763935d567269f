// One 256-row block's partial [sum A, sum B, histogram] of a dual-ascent
// iteration, in the fixed order the plain versions repeat
// (repro_torch/kernels/lagrangian_assign/ref.py: _kernel_order_sum): a
// shuffle-down tree inside each warp, then the block's 8 warp sums in order
// from 0.0 (one thread a column); the histogram from ballot counts, exact.
// Included by shard_stats.cu (one block per CTA) and dual_solve.cu (four
// blocks per CTA), so both reduce a block in the same order.  Both build
// with --fmad=false.
#pragma once

#include <cuda_runtime.h>

namespace ascent {

constexpr int UNIT = 256;                 // rows per block partial
constexpr int UNIT_WARPS = UNIT / 32;
constexpr int MMAX = 16;                  // models per solve
constexpr unsigned FULL = 0xffffffffu;

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_down_sync(FULL, v, o));
  return v;
}

// The CTA's threads form GROUPS blocks of 256 rows, one row a thread; group
// g's partial (2 + m floats: sum va, sum vb, histogram of col) goes to
// `out`, which every thread of the group passes alike (nullptr: nowhere).
// col is -1 for a row that adds nothing.  Every thread of the CTA calls
// it; a caller that calls it again must __syncthreads() first.
template <int GROUPS>
__device__ inline void block_partial(float va, float vb, int col, int m,
                                     float* __restrict__ out) {
  __shared__ float s_wa[GROUPS * UNIT_WARPS], s_wb[GROUPS * UNIT_WARPS];
  __shared__ int s_wc[GROUPS * UNIT_WARPS][MMAX];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  va = warp_sum(va);
  vb = warp_sum(vb);
  for (int j = 0; j < m; ++j) {
    const int c = __popc(__ballot_sync(FULL, col == j));
    if (lane == 0) s_wc[warp][j] = c;
  }
  if (lane == 0) {
    s_wa[warp] = va;
    s_wb[warp] = vb;
  }
  __syncthreads();
  // thread c of the group writes column c
  const int c = tid & (UNIT - 1), w0 = (tid / UNIT) * UNIT_WARPS;
  if (c < 2 && out != nullptr) {
    const float* sw = c == 0 ? s_wa : s_wb;
    float acc = 0.f;
    for (int w = 0; w < UNIT_WARPS; ++w) acc = __fadd_rn(acc, sw[w0 + w]);
    out[c] = acc;
  } else if (c < 2 + m && out != nullptr) {
    int cnt = 0;
    for (int w = 0; w < UNIT_WARPS; ++w) cnt += s_wc[w0 + w][c - 2];
    out[c] = (float)cnt;
  }
}

}  // namespace ascent
