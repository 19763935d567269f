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
// _step_kernel).  Inputs cost, quality (N, M) float32, lam1 (a device
// scalar) and lam2 (M,), each through its own pointer (so a loop of steps
// never reads the host and the wrapper joins nothing).  Each row's scores
// are (c - (lam1*a)/N) + lam2, every operation rounded on its own (the
// reference divides: __fdiv_rn), argmin by the same strict < scan; x is
// written per row, and [qsum, csum, histogram] = [sum a[i, x_i],
// sum c[i, x_i], counts] go through the same 256-row block partials.
//
// One launch: the block partials are summed by the CTA that finishes last.
// Each CTA stores its partial, and its thread 0 draws a ticket from an
// integer counter with one acquire-release atomic add (a fence on each side
// of the add, in one instruction).  The CTA that draws
// the last ticket stages every partial from L2 in shared memory (all
// threads loading) and adds them in block order from 0.0, one thread a
// column: the order of the two-launch statistics above and of the plain
// version (ref.assign_step_ref).  It then sets the counter back to 0, so
// the next launch on the stream, or the next replay of a CUDA graph, starts
// clean.  No float atomics: every run gives the same bits.
//
// Bound: bytes, (2*N*M + N)*4 read and written once — under a microsecond
// at N = 16,384, M = 6, so one launch's latency is the floor.  What the
// design does about latency: one launch; every load issued before the
// first barrier (the row's M values kept in registers, so the chosen
// column's a and c need no second read); the partials gathered in one L2
// round trip.
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

// Thread 0's ticket: an integer add with acquire-release semantics at device
// scope, a fence on each side of the atomicAdd in one instruction.  The
// release makes the CTA's partial (ordered before it by the barrier)
// visible to every later drawer; the acquire lets the last drawer's CTA,
// after the next barrier, read every earlier partial.
__device__ inline unsigned take_ticket(unsigned* ticket) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(old) : "l"(ticket) : "memory");
  return old;
}

// The last CTA stages the block partials in shared memory this many floats
// at a time (every thread loads, so they come in one L2 round trip).
constexpr int MERGE_FLOATS = 2048;

// grid (bps); part (bps, 2 + M) scratch: per 256-row block [qsum, csum,
// histogram]; *ticket 0 at the launch and again at its end; out (2 + M,)
__global__ void __launch_bounds__(THREADS)
assign_step_kernel(const float* __restrict__ cost,
                   const float* __restrict__ quality,
                   const float* __restrict__ lam1_p,
                   const float* __restrict__ lam2, int* __restrict__ x,
                   float* part, unsigned* ticket, float* __restrict__ out,
                   int n, int m) {
  __shared__ float s_lam2[MMAX];
  __shared__ float s_part[MERGE_FLOATS];
  __shared__ bool s_last;
  const int tid = threadIdx.x, width = 2 + m;
  const int r = blockIdx.x * THREADS + tid;
  const bool live = r < n;

  // every load of the step is issued before the first barrier, so the
  // multipliers and the thread's row arrive in one memory round trip
  const float lam1 = *lam1_p;
  if (tid < m) s_lam2[tid] = lam2[tid];
  const size_t row = (size_t)(live ? r : 0) * m;
  float cr[MMAX], qr[MMAX];
#pragma unroll
  for (int j = 0; j < MMAX; ++j) {
    cr[j] = live && j < m ? cost[row + j] : 0.f;
    qr[j] = live && j < m ? quality[row + j] : 0.f;
  }
  __syncthreads();

  const float nf = (float)n;
  float vq = 0.f, vc = 0.f;
  int col = -1;
  if (live) {
    float best = __fadd_rn(
        __fsub_rn(cr[0], __fdiv_rn(__fmul_rn(lam1, qr[0]), nf)), s_lam2[0]);
    col = 0;
    vq = qr[0];
    vc = cr[0];
#pragma unroll
    for (int j = 1; j < MMAX; ++j) {
      if (j < m) {
        const float sc = __fadd_rn(
            __fsub_rn(cr[j], __fdiv_rn(__fmul_rn(lam1, qr[j]), nf)), s_lam2[j]);
        if (sc < best) {
          best = sc;
          col = j;
          vq = qr[j];
          vc = cr[j];
        }
      }
    }
    x[r] = col;
  }
  ascent::block_partial<1>(vq, vc, col, m, part + (size_t)blockIdx.x * width);

  // the barrier orders the partial's writes before thread 0's ticket
  __syncthreads();
  if (tid == 0) s_last = take_ticket(ticket) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  // thread c adds column c over the blocks in order, from 0.0
  const int per = MERGE_FLOATS / width;          // blocks staged at a time
  float acc = 0.f;
  for (int k0 = 0; k0 < (int)gridDim.x; k0 += per) {
    const int blocks = min(per, (int)gridDim.x - k0);
    for (int i = tid; i < blocks * width; i += THREADS)
      s_part[i] = __ldcg(part + (size_t)k0 * width + i);
    __syncthreads();
    // one dependent chain of adds: unrolled, its reads run ahead of it
    if (tid < width)
#pragma unroll 16
      for (int k = 0; k < blocks; ++k)
        acc = __fadd_rn(acc, s_part[k * width + tid]);
    __syncthreads();
  }
  if (tid < width) out[tid] = acc;
  if (tid == 0) *ticket = 0u;
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

// cost, quality (n, m) float32; lam1 (1,); lam2 (m,); x (n,) int32; part
// (ceil(n / 256), 2 + m) scratch; ticket (1,) zero, as every launch leaves
// it; out (2 + m,) = [qsum, csum, counts].  One launch on ``stream``;
// allocates nothing.
extern "C" int assign_step_launch(const float* cost, const float* quality,
                                  const float* lam1, const float* lam2,
                                  int* x, float* part, unsigned* ticket,
                                  float* out, int n, int m, void* stream) {
  if (n <= 0 || m < 1 || m > MMAX) return (int)cudaErrorInvalidValue;
  const int bps = (int)(((long long)n + THREADS - 1) / THREADS);
  assign_step_kernel<<<bps, THREADS, 0, (cudaStream_t)stream>>>(
      cost, quality, lam1, lam2, x, part, ticket, out, n, m);
  return (int)cudaGetLastError();
}
