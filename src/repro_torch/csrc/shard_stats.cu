// One dual-ascent iteration's per-shard statistics [sum A, sum B, histogram]
// for the blocked (and masked) window solve.
//
// Replaces the TPU kernel repro/kernels/lagrangian_assign/kernel.py:
// shard_stats (body _shard_stats_kernel).  Inputs: the unified problem
// A, B (lblocks * nl, M) float32, viewed as lblocks contiguous query shards of
// nl rows; lam (a device scalar), lam2 (M,), nv (lblocks,) per-shard valid-row
// counts (float, integral).  Output (lblocks, 2 + M) float32: per shard the
// sums of A and B over each valid row's argmin column, and the histogram of
// those columns.  A row at or past its shard's nv is padding and adds
// nothing.
//
// Row argmin: scores A + lam*B + lam2 in that order, every multiply and add
// rounded on its own (built with --fmad=false, as the dual solve), models
// scanned in ascending order with a strict <, so ties go to the lowest index
// (jnp.argmin / torch.argmin).
//
// What bounds it on the H100: bytes.  Each row is read once (2*M floats) for
// ~4*M operations, far below the card's operations per byte, so the floor is
// 2*N*M*4 bytes over 3.35 TB/s — under a microsecond at the window sizes
// (4,096-16,384 rows, M = 8), i.e. well below the launch latency, which is
// the real floor.
//
// Design (simple first): grid (blocks per shard, lblocks), one 256-thread CTA
// per 256-row block of a shard, one row per thread.  Each CTA writes its
// block's partial [sum A, sum B, histogram] in a fixed order
// (block_partial.cuh, shared with the dual solve): a warp-shuffle tree
// inside each warp, then thread 0 over the eight warp partials; the
// histogram is exact (ballot counts).  A second small launch sums each
// shard's block partials in block order, one thread per output column.  No
// float atomics, so every run gives the same bits.  The TPU kernel carried
// the per-shard sum from grid step to grid step in its output block; here the
// block order of the second pass takes its place.
//
// Second entry point, assign_step_launch: one step of the seed's
// per-iteration dual solve.  Replaces the TPU kernel
// repro/kernels/lagrangian_assign/kernel.py: assign_step_kernel (body
// _step_kernel).  Inputs cost, quality (N, M) float32 and lam = [lam1,
// lam2 (M)] in device memory (so a loop of steps never reads the host).
// Each row's scores are (c - (lam1*a)/N) + lam2, every operation rounded
// on its own, argmin by the same strict < scan; x is written per row, and
// [qsum, csum, histogram] = [sum a[i, x_i], sum c[i, x_i], counts] go
// through the same block partials and block-order merge as the statistics
// above.  Bound: bytes, (2*N*M + N)*4 read and written once — under a
// microsecond at N = 16,384, M = 6, so the launch latency is the floor.
#include <cuda_runtime.h>

#include "block_partial.cuh"

namespace {

using ascent::MMAX;
constexpr int THREADS = ascent::UNIT;   // rows per block (one per thread)

// grid (bps, lblocks); part (lblocks, bps, 2 + M)
__global__ void __launch_bounds__(THREADS)
block_stats_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ lam_p,
                   const float* __restrict__ lam2, const float* __restrict__ nv,
                   float* __restrict__ part, int nl, int m) {
  __shared__ float s_lam2[MMAX];
  const int blk = blockIdx.x, s = blockIdx.y, bps = gridDim.x;
  const int tid = threadIdx.x;
  if (tid < m) s_lam2[tid] = lam2[tid];
  __syncthreads();

  const float lam = *lam_p;
  const int bound = min((int)nv[s], nl);
  const int r = blk * THREADS + tid;              // row within the shard
  float va = 0.f, vb = 0.f;
  int col = -1;
  if (r < bound) {
    const size_t row = ((size_t)s * nl + r) * m;
    float best = __fadd_rn(__fadd_rn(a[row], __fmul_rn(lam, b[row])), s_lam2[0]);
    col = 0;
    for (int j = 1; j < m; ++j) {
      const float sc = __fadd_rn(__fadd_rn(a[row + j], __fmul_rn(lam, b[row + j])),
                                 s_lam2[j]);
      if (sc < best) { best = sc; col = j; }
    }
    va = a[row + col];
    vb = b[row + col];
  }
  ascent::block_partial<1>(va, vb, col, m, part + ((size_t)s * bps + blk) * (2 + m));
}

// grid (bps); part (bps, 2 + M): per 256-row block [qsum, csum, histogram]
__global__ void __launch_bounds__(THREADS)
assign_step_kernel(const float* __restrict__ cost,
                   const float* __restrict__ quality,
                   const float* __restrict__ lam, int* __restrict__ x,
                   float* __restrict__ part, int n, int m) {
  __shared__ float s_lam[1 + MMAX];
  const int tid = threadIdx.x;
  if (tid <= m) s_lam[tid] = lam[tid];
  __syncthreads();

  const float lam1 = s_lam[0];
  const float nf = (float)n;
  const int r = blockIdx.x * THREADS + tid;
  float vq = 0.f, vc = 0.f;
  int col = -1;
  if (r < n) {
    const size_t row = (size_t)r * m;
    float best = __fadd_rn(
        __fsub_rn(cost[row], __fdiv_rn(__fmul_rn(lam1, quality[row]), nf)),
        s_lam[1]);
    col = 0;
    for (int j = 1; j < m; ++j) {
      const float sc = __fadd_rn(
          __fsub_rn(cost[row + j],
                    __fdiv_rn(__fmul_rn(lam1, quality[row + j]), nf)),
          s_lam[1 + j]);
      if (sc < best) { best = sc; col = j; }
    }
    x[r] = col;
    vq = quality[row + col];
    vc = cost[row + col];
  }
  ascent::block_partial<1>(vq, vc, col, m, part + (size_t)blockIdx.x * (2 + m));
}

// grid (lblocks), one thread per output column: block partials in order
__global__ void merge_kernel(const float* __restrict__ part,
                             float* __restrict__ out, int bps, int width) {
  const int s = blockIdx.x, c = threadIdx.x;
  if (c >= width) return;
  float acc = 0.f;
  for (int k = 0; k < bps; ++k)
    acc = __fadd_rn(acc, part[((size_t)s * bps + k) * width + c]);
  out[(size_t)s * width + c] = acc;
}

}  // namespace

// a, b (lblocks * nl, m) float32; lam (1,); lam2 (m,); nv (lblocks,);
// part (lblocks, bps, 2 + m) scratch with bps = ceil(nl / 256); out
// (lblocks, 2 + m).  Launches on ``stream``; allocates nothing.
extern "C" int shard_stats_launch(const float* a, const float* b,
                                  const float* lam, const float* lam2,
                                  const float* nv, float* part, float* out,
                                  int lblocks, int nl, int m, int bps,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (lblocks <= 0 || nl <= 0 || m < 1 || m > MMAX
      || (long long)bps * THREADS < nl || bps > 65535 || lblocks > 65535)
    return (int)cudaErrorInvalidValue;
  block_stats_kernel<<<dim3(bps, lblocks), THREADS, 0, st>>>(
      a, b, lam, lam2, nv, part, nl, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<lblocks, 32, 0, st>>>(part, out, bps, 2 + m);
  return (int)cudaGetLastError();
}

// cost, quality (n, m) float32; lam (1 + m,) = [lam1, lam2]; x (n,) int32;
// part (bps, 2 + m) scratch with bps = ceil(n / 256); out (2 + m,) =
// [qsum, csum, counts].  Launches on ``stream``; allocates nothing.
extern "C" int assign_step_launch(const float* cost, const float* quality,
                                  const float* lam, int* x, float* part,
                                  float* out, int n, int m, int bps,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0 || m < 1 || m > MMAX || (long long)bps * THREADS < n
      || bps > 2147483647 / THREADS)
    return (int)cudaErrorInvalidValue;
  assign_step_kernel<<<bps, THREADS, 0, st>>>(cost, quality, lam, x, part,
                                              n, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<1, 32, 0, st>>>(part, out, bps, 2 + m);
  return (int)cudaGetLastError();
}
