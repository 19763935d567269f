// Whole Lagrangian dual ascent (ECCOS optimizer, paper Eq. 9-12) in one
// launch of one thread-block cluster, with two entry points.
//
// dual_solve_launch replaces the TPU kernel
// repro/kernels/lagrangian_assign/kernel.py: fused_dual_solve (bodies
// _fused_kernel and _fused_kernel_whole): the one-shot solve.
// blocked_dual_ascent_launch runs the whole loop of the blocked, masked
// window solve (repro/core/optimizer.py: _blocked_window_core's
// lax.while_loop, whose per-iteration statistics are the TPU kernel
// repro/kernels/lagrangian_assign/kernel.py: shard_stats): S contiguous query
// shards of nl rows, shard s valid below nv[s].  The one-shot solve is the
// same loop with one shard, every row valid.  Both write the packed (8 + 3M,)
// vector, fully finalised:
//   [lam, lam_best, best_objective, found, 0, 0, iters_run, 0,
//    lam2 (M), lam2_best (M), 0 (M)]
//
// Each iteration: scores = A + lam*B + lam2, row argmin (ties to the lowest
// model index), [sum A, sum B, histogram] of the chosen entries, best-feasible
// bookkeeping, projected step 1/sqrt(1 + step0 + t), and the cumulative stall
// count that ends the ascent after `patience` stalls (the flow of the
// reference's _solve_ref and of _blocked_window_core's loop).
//
// What bounds it on the H100: the iterations are serial and each is small
// (786 KB of A|B at N=16384, M=6), so the whole card's floor (the bytes
// once, or iters x N x (4M+1) operations at 67 TFLOP/s) is a microsecond.
// The design's own floor is, per iteration, a fixed cost (one cluster
// barrier, the gather of the block partials through distributed shared
// memory, one warp's bookkeeping) plus the slice's bytes read from shared
// memory by C SMs.
//
// Design: one cluster of C CTAs (16 where the card can place one, else 8)
// of 1024 threads.  The rows fall into 256-row blocks (per shard: block k
// holds shard rows [256k, 256k+256)); CTA r owns a contiguous run of
// blocks, four in flight, one row a thread.  It copies its valid rows of A
// and B into shared memory once (cp.async, column-major so a warp's reads
// hit distinct banks); where the slice does not fit, it reads them from L2
// every iteration (ld.global.cg).  Each iteration every CTA writes its
// block partials (block_partial.cuh) into its own shared memory, in a
// buffer per iteration parity, so one cluster barrier per iteration
// suffices: after it, every CTA gathers all partials through
// cluster.map_shared_rank in one fixed order, and warp 0 of every CTA runs
// the same bookkeeping and dual update on the same bits (lane j holds model
// j, so the per-model work and the M-sums are parallel, not one thread's
// serial loop).  So every CTA holds the same lam and lam2 without a
// broadcast, and all leave the loop on the same iteration (a CTA that left
// alone would hang the barrier).  A last barrier keeps every CTA's shared
// memory alive until all gathers end.
//
// Reduction order (both entry points): each 256-row block as
// block_partial.cuh reduces it (shuffle-down tree per warp, then the 8 warp
// sums in order from 0.0; padding rows add nothing); each shard's blocks in
// block order from 0.0; the shards in order from shard 0's sum
// (ref._kernel_order_sum, ref.in_shard_order); the M-sums of the stall
// test as a pairwise tree padded to a power of two (ref.ordered_sum; warp
// 0's shuffle-down tree over zeros past M adds the same pairs).  The
// blocked loop's CPU path takes the same order, so card and CPU agree bit
// for bit.  The one-shot solve's plain
// version (ref.fused_dual_solve_ref) sums with Tensor.sum, so there the
// multipliers agree to float32 rounding and the assignment exactly.
//
// Parity: every multiply and add is rounded on its own (__fmul_rn/__fadd_rn,
// and the file is built with --fmad=false), the step is an IEEE
// 1/sqrt, and the argmin scans models in ascending order with a strict <.
// No float atomics: every run gives the same bits.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <mutex>
#include <vector>

#include "block_partial.cuh"

namespace cg = cooperative_groups;

namespace {

using ascent::MMAX;
using ascent::UNIT;
constexpr int THREADS = 1024;
constexpr int GROUPS = THREADS / UNIT;     // blocks in flight per CTA
constexpr int WARPS = THREADS / 32;
constexpr int LOADS = 4;                   // loads in flight in the gather
// every CTA holds all block partials (units x (2 + m) floats): up to
// 160 KB, 1.31M rows at M = 6 and 582K at M = 16 (kernel.py checks it)
constexpr size_t MAX_GATHER_BYTES = 160 * 1024;

struct Params {
  const float* a;          // (shards * nl, m) row-major
  const float* b;
  const float* nv;         // (shards,) valid rows; nullptr: all nl
  const float* t_eff;      // 0-dim scalars
  const float* lr_eff;
  const float* lr_load;
  const float* lam0;
  const float* lam20;      // (m,)
  const float* stall_tol;
  const float* step0;
  const float* loads;      // (m,)
  float* out;              // (8 + 3m,)
  int shards, nl, m, bps, units, upc, iters, patience;
};

// torch.clamp(x, min=0): NaN propagates
__device__ inline float relu(float x) { return x < 0.f ? 0.f : x; }

template <bool SMEM>
__device__ inline float ld(const float* p) {
  if constexpr (SMEM) return *p;
  else return __ldcg(p);
}

__device__ inline void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ inline int valid_rows(const Params& p, int s) {
  return p.nv == nullptr ? p.nl : min((int)p.nv[s], p.nl);
}

template <bool SMEM>
__global__ void __launch_bounds__(THREADS, 1) ascent_kernel(const Params p) {
  extern __shared__ float4 dyn4[];
  __shared__ float s_lam2[MMAX], s_lam2b[MMAX], s_loads[MMAX];
  __shared__ float s_lam;
  __shared__ int s_stop;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, grp = tid / UNIT, lrow = tid % UNIT;
  const int m = p.m, width = 2 + m;
  const int rows = p.upc * UNIT;                  // rows a CTA holds
  const int u0 = rank * p.upc;
  const int u1 = min(u0 + p.upc, p.units);
  // dynamic shared memory: [A slice | B slice] (SMEM only), the block
  // partials of two iteration parities, the gather buffer (all units)
  float* dyn = reinterpret_cast<float*>(dyn4);
  float* s_a = dyn;
  float* s_b = dyn + (SMEM ? m * rows : 0);
  float* s_part = dyn + (SMEM ? 2 * m * rows : 0);
  float* s_all = s_part + 2 * p.upc * width;

  if constexpr (SMEM) {
    for (int u = u0; u < u1; ++u) {
      const int s = u / p.bps, r0 = (u - s * p.bps) * UNIT;
      const int cnt = (min(valid_rows(p, s) - r0, UNIT)) * m;
      const size_t base = ((size_t)s * p.nl + r0) * m;
      for (int e = tid; e < cnt; e += THREADS) {
        const int r = e / m, j = e - r * m;
        const int dst = j * rows + (u - u0) * UNIT + r;
        cp_async4(s_a + dst, p.a + base + e);
        cp_async4(s_b + dst, p.b + base + e);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }

  // this warp's share of the gather: owner CTA g_owner's local units
  // g_first, g_first + g_step, ... (global units g_u0 + l)
  const int warp = tid >> 5, lane = tid & 31;
  const int csize = (int)cluster.num_blocks();
  const int g_owner = warp % csize, g_first = warp / csize;
  const int g_step = WARPS / csize, g_u0 = g_owner * p.upc;
  const int g_units = max(0, min(p.upc, p.units - g_u0));
  const float* remote_part = cluster.map_shared_rank(s_part, g_owner);

  // warp 0's bookkeeping state (the same in every lane and every CTA)
  const float t_eff = *p.t_eff, lr_eff = *p.lr_eff, lr_load = *p.lr_load;
  const float stall_tol = *p.stall_tol, step0 = *p.step0;
  float lam_best = 0.f, best = INFINITY;
  bool found = false;
  int stall = 0, t_run = 0;
  if (tid == 0) {
    s_lam = *p.lam0;
    s_stop = p.patience <= 0;
  }
  if (tid < m) {
    s_loads[tid] = p.loads[tid];
    s_lam2[tid] = p.lam20[tid];
    s_lam2b[tid] = 0.f;
  }
  __syncthreads();

  for (int t = 0; t < p.iters && !s_stop; ++t) {
    const float lam = s_lam;
    float* part = s_part + (t & 1) * p.upc * width;
    for (int base = u0; base < u1; base += GROUPS) {
      const int u = base + grp;
      float va = 0.f, vb = 0.f;
      int col = -1;
      if (u < u1) {
        const int s = u / p.bps, r = (u - s * p.bps) * UNIT + lrow;
        if (r < valid_rows(p, s)) {
          const float* ra = SMEM ? s_a + (u - u0) * UNIT + lrow
                                 : p.a + ((size_t)s * p.nl + r) * m;
          const float* rb = SMEM ? s_b + (u - u0) * UNIT + lrow
                                 : p.b + ((size_t)s * p.nl + r) * m;
          const int stride = SMEM ? rows : 1;
          float bs = __fadd_rn(__fadd_rn(ld<SMEM>(ra), __fmul_rn(lam, ld<SMEM>(rb))),
                               s_lam2[0]);
          col = 0;
          for (int j = 1; j < m; ++j) {
            const float sc = __fadd_rn(
                __fadd_rn(ld<SMEM>(ra + j * stride),
                          __fmul_rn(lam, ld<SMEM>(rb + j * stride))),
                s_lam2[j]);
            if (sc < bs) { bs = sc; col = j; }
          }
          va = ld<SMEM>(ra + col * stride);
          vb = ld<SMEM>(rb + col * stride);
        }
      }
      ascent::block_partial<GROUPS>(va, vb, col, m,
                                    u < u1 ? part + (u - u0) * width : nullptr);
      if (base + GROUPS < u1) __syncthreads();
    }
    // every CTA's partials of iteration t are written and visible (the
    // cluster barrier is also this CTA's barrier)
    cluster.sync();

    // gather all block partials into s_all in unit order: warp w reads
    // owner CTA w % C's units w / C, w / C + 32 / C, ... (LOADS loads in
    // flight); then lanes 0..width-1 of warp 0 sum each shard's blocks in
    // order from 0.0 and the shards in order from shard 0's sum
    {
      const float* remote = remote_part + (t & 1) * p.upc * width;
      for (int l0 = g_first; l0 < p.upc; l0 += LOADS * g_step) {
        float v[LOADS];
#pragma unroll
        for (int j = 0; j < LOADS; ++j) {
          const int l = l0 + j * g_step;
          v[j] = l < g_units && lane < width ? remote[l * width + lane] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < LOADS; ++j) {
          const int l = l0 + j * g_step;
          if (l < g_units && lane < width)
            s_all[(g_u0 + l) * width + lane] = v[j];
        }
      }
    }
    __syncthreads();
    float tot = 0.f;
    if (warp == 0 && lane < width) {
      const float* col = s_all + lane;
      for (int sh = 0; sh < p.shards; ++sh, col += p.bps * width) {
        float acc = 0.f;
#pragma unroll 8
        for (int k = 0; k < p.bps; ++k) acc = __fadd_rn(acc, col[k * width]);
        tot = sh == 0 ? acc : __fadd_rn(tot, acc);
      }
    }

    if (warp == 0) {
      // lane c holds column c of the totals; lane j < m takes model j
      const float asum = __shfl_sync(ascent::FULL, tot, 0);
      const float bsum = __shfl_sync(ascent::FULL, tot, 1);
      const float cnt = __shfl_down_sync(ascent::FULL, tot, 2);
      const bool model = lane < m;
      const float load = model ? s_loads[lane] : 0.f;
      const float l2 = model ? s_lam2[lane] : 0.f;
      const bool fits = __all_sync(ascent::FULL, !model || cnt <= load);
      const bool feasible = (bsum <= t_eff) && fits;
      if (feasible && asum < best) {
        best = asum;
        lam_best = lam;
        if (model) s_lam2b[lane] = l2;
      }
      found = found || feasible;
      const float step = __fdiv_rn(
          1.0f, __fsqrt_rn(__fadd_rn(__fadd_rn(1.0f, step0), (float)t)));
      const float lr_step = __fmul_rn(lr_eff, step);
      const float load_step = __fmul_rn(lr_load, step);
      const float lam_new =
          relu(__fadd_rn(lam, __fmul_rn(lr_step, __fsub_rn(bsum, t_eff))));
      const float l2_new =
          model ? relu(__fadd_rn(l2, __fmul_rn(load_step, __fsub_rn(cnt, load))))
                : 0.f;
      // the M-sums as ref.ordered_sum's pairwise tree: with zeros
      // past m (and every term >= 0), the shuffle-down tree adds the same
      // pairs in the same order
      const float dsum = __shfl_sync(
          ascent::FULL, ascent::warp_sum(fabsf(__fsub_rn(l2_new, l2))), 0);
      const float nsum =
          __shfl_sync(ascent::FULL, ascent::warp_sum(fabsf(l2_new)), 0);
      const float delta = __fadd_rn(fabsf(__fsub_rn(lam_new, lam)), dsum);
      const float denom = __fadd_rn(__fadd_rn(1.0f, fabsf(lam_new)), nsum);
      const float resid = __fdiv_rn(fabsf(__fsub_rn(bsum, t_eff)),
                                    __fadd_rn(1.0f, fabsf(t_eff)));
      const bool stalled = found && ((delta < __fmul_rn(stall_tol, denom)) ||
                                     (resid < stall_tol));
      stall += stalled ? 1 : 0;
      t_run += 1;
      if (model) s_lam2[lane] = l2_new;
      if (lane == 0) {
        s_lam = lam_new;
        s_stop = stall >= p.patience;
      }
    }
    __syncthreads();
  }
  // no CTA leaves while another may still read its partials
  cluster.sync();

  if (rank != 0) return;
  if (tid == 0) {
    p.out[0] = s_lam;
    p.out[1] = lam_best;
    p.out[2] = best;
    p.out[3] = found ? 1.f : 0.f;
    p.out[4] = 0.f;
    p.out[5] = 0.f;
    p.out[6] = (float)t_run;
    p.out[7] = 0.f;
  }
  if (tid < m) {
    p.out[8 + tid] = s_lam2[tid];
    p.out[8 + m + tid] = s_lam2b[tid];
    p.out[8 + 2 * m + tid] = 0.f;
  }
}

std::mutex g_mu;
// What a launch needs to know of a device, asked once per device: its
// opt-in shared memory per block, each instance's static shared memory,
// and the attributes set on each instance so far (the largest dynamic
// shared memory allowed, whether a non-portable cluster size is allowed).
struct Dev {
  int dev, optin;
  size_t stat[2];
  size_t dyn_set[2];
  bool nonportable[2];
};
std::vector<Dev> g_devs;
// cudaOccupancyMaxActiveClusters answers per device and launch shape
struct Fit { int dev, cluster; bool smem; size_t dyn; bool ok; };
std::vector<Fit> g_fits;

cudaError_t device(Dev** out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  for (Dev& d : g_devs)
    if (d.dev == dev) {
      *out = &d;
      return cudaSuccess;
    }
  Dev d = {dev, 0, {0, 0}, {0, 0}, {false, false}};
  cudaFuncAttributes fa_g, fa_s;
  e = cudaDeviceGetAttribute(&d.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa_g, ascent_kernel<false>);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa_s, ascent_kernel<true>);
  if (e != cudaSuccess) return e;
  d.stat[0] = fa_g.sharedSizeBytes;
  d.stat[1] = fa_s.sharedSizeBytes;
  g_devs.push_back(d);
  *out = &g_devs.back();
  return cudaSuccess;
}

cudaLaunchConfig_t config(int c, size_t dyn, cudaStream_t st,
                          cudaLaunchAttribute* at) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = st;
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = c;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cfg;
}

// Allows the kernel a cluster of c with dyn bytes on device d (each
// attribute set once per device, the dynamic size only when it grows), and
// whether the card can place one such cluster (asked once per shape).
template <bool SMEM>
cudaError_t prepare(Dev& d, int c, size_t dyn, cudaStream_t st, bool* ok) {
  auto kern = ascent_kernel<SMEM>;
  cudaError_t e;
  if (dyn > d.dyn_set[SMEM]) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return e;
    d.dyn_set[SMEM] = dyn;
  }
  if (c > 8 && !d.nonportable[SMEM]) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    d.nonportable[SMEM] = true;
  }
  for (const Fit& f : g_fits)
    if (f.dev == d.dev && f.cluster == c && f.smem == SMEM && f.dyn == dyn) {
      *ok = f.ok;
      return cudaSuccess;
    }
  cudaLaunchAttribute at[1];
  cudaLaunchConfig_t cfg = config(c, dyn, st, at);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();    // a refused size: try the next
    n = 0;
  }
  *ok = n >= 1;
  g_fits.push_back({d.dev, c, SMEM, dyn, *ok});
  return cudaSuccess;
}

template <bool SMEM>
cudaError_t launch(const Params& p, int c, size_t dyn, cudaStream_t st) {
  cudaLaunchAttribute at[1];
  cudaLaunchConfig_t cfg = config(c, dyn, st, at);
  return cudaLaunchKernelEx(&cfg, ascent_kernel<SMEM>, p);
}

// Picks the cluster size (16, else 8) and whether the slices fit shared
// memory, launches, and reports both in info[0], info[1].
int run(Params p, int* info, cudaStream_t st) {
  if (p.m < 1 || p.m > MMAX || p.nl < 0 || p.shards < 1 || p.iters < 0)
    return (int)cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(g_mu);
  p.bps = p.nl > 0 ? (p.nl + UNIT - 1) / UNIT : 1;
  p.units = p.shards * p.bps;
  Dev* d = nullptr;
  cudaError_t e = device(&d);
  if (e != cudaSuccess) return (int)e;
  const size_t width = 2 + p.m;
  const size_t gather = (size_t)p.units * width * 4;
  if (gather > MAX_GATHER_BYTES) return (int)cudaErrorInvalidValue;
  for (int c : {16, 8}) {
    p.upc = (p.units + c - 1) / c;
    const size_t part = 2 * (size_t)p.upc * width * 4;
    const size_t slice = 2 * (size_t)p.m * p.upc * UNIT * 4;
    const bool smem = d->stat[1] + slice + part + gather <= (size_t)d->optin;
    const size_t dyn = (smem ? slice : 0) + part + gather;
    if (!smem && d->stat[0] + dyn > (size_t)d->optin) continue;
    bool ok = false;
    e = smem ? prepare<true>(*d, c, dyn, st, &ok)
             : prepare<false>(*d, c, dyn, st, &ok);
    if (e != cudaSuccess) return (int)e;
    if (!ok) continue;
    info[0] = c;
    info[1] = smem ? 1 : 0;
    e = smem ? launch<true>(p, c, dyn, st) : launch<false>(p, c, dyn, st);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidConfiguration;   // no cluster fits the card
}

}  // namespace

// The one-shot solve: a, b (n, m) float32; the scalars t_eff (the
// threshold), lr_eff, lr_load, lam0, stall_tol, step0 and lam20, loads
// (m,) in device memory; out (8 + 3m,).  info (host, 2 ints) receives the
// cluster size and whether the slices sit in shared memory.  Launches on
// ``stream``; allocates nothing.
extern "C" int dual_solve_launch(const float* a, const float* b,
                                 const float* t_eff, const float* lr_eff,
                                 const float* lr_load, const float* lam0,
                                 const float* lam20, const float* stall_tol,
                                 const float* step0, const float* loads,
                                 float* out, int n, int m, int iters,
                                 int patience, int* info, void* stream) {
  Params p = {a, b, nullptr, t_eff, lr_eff, lr_load, lam0, lam20, stall_tol,
              step0, loads, out, 1, n, m, 0, 0, 0, iters, patience};
  return run(p, info, (cudaStream_t)stream);
}

// The blocked, masked window's loop: a, b (shards * nl, m) float32, nv
// (shards,) valid rows per shard (float, integral); the rest as above.
extern "C" int blocked_dual_ascent_launch(
    const float* a, const float* b, const float* nv, const float* t_eff,
    const float* lr_eff, const float* lr_load, const float* lam0,
    const float* lam20, const float* stall_tol, const float* step0,
    const float* loads, float* out, int shards, int nl, int m, int iters,
    int patience, int* info, void* stream) {
  Params p = {a, b, nv, t_eff, lr_eff, lr_load, lam0, lam20, stall_tol,
              step0, loads, out, shards, nl, m, 0, 0, 0, iters, patience};
  return run(p, info, (cudaStream_t)stream);
}
