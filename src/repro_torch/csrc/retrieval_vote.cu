// Fused cosine similarity -> running top-k -> per-label neighbour vote, on
// the tensor cores.
//
// Replaces the TPU kernels repro/kernels/topk_retrieval/kernel.py:
// retrieval_vote_kernel (bodies _vote_kernel, _fold_topk, _masked_sims),
// entry point retrieval_vote_launch, and topk_retrieval_kernel (body
// _topk_kernel, the vote kernel's phase 0), entry point
// topk_retrieval_launch.  Both entry points run one kernel, templated on
// VOTE: the same CTAs, products, folds and merge, so their (vals, idx) are
// equal bit for bit; the top-k one skips the label gather and the votes.
// In a trace the vote is retrieval_kernel<true>, the top-k
// retrieval_kernel<false>.
//
// Contract (the JAX package's): sim = Q . S^T in float32 (within 1e-5 of
// the plain float32 product); store rows at or past n_valid are masked to
// NEG_INF; the top-k keeps ties on the lower db index; slots past the
// number of valid rows stay (NEG_INF, -1); the vote is the mean label over
// the valid neighbours only.
//
// What bounds it on the H100: the B x N_db x d product.  In float32 on the
// CUDA cores that is 2*B*N_db*d operations at 67 TFLOP/s; here it runs on
// the tensor cores as three TF32 products (3xTF32): every operand x is
// split in registers into hi = rna_tf32(x) and lo = rna_tf32(x - hi), and
// lo*hi' + hi*lo' + hi*hi' keeps ~21 bits of each product, so the bound is
// 3 * 2*B*N_db*d operations at 495 TFLOP/s.  A single TF32 pass (10
// mantissa bits) would miss the 1e-5 contract.
//
// Design:
// - Grid: query blocks of BQ = 128 (x) times S store slices (y), S chosen by
//   the wrapper so the grid fills every SM at any batch size.  A slice is a
//   run of whole TN = 128-row tiles, so a store row sits at the same place
//   in its tile whatever S is.
// - Product: a CTA tile is 128 queries x 128 store rows; d runs in chunks
//   of KC = 32 through a two-stage ring of 16-byte cp.async copies (rows
//   padded to 36 floats).  Two warpgroups each own 64 queries and issue
//   wgmma m64n128k8 TF32: the queries' hi and lo come from registers (split
//   after the fragment load), the store chunk's from shared memory, split
//   once by all threads into the tensor cores' K-major layout (core
//   matrices of 8 rows x 16 bytes, no swizzle), double-buffered so one chunk
//   is split while the previous chunk's products run.  In every k-step the
//   order is lo*hi', hi*lo', hi*hi'.  The tensor cores truncate as they
//   accumulate, which biased 96 accumulations by about -4e-7 against the
//   plain product, so each chunk sums into a fresh partial that a
//   round-to-nearest float32 add folds into the tile's total (bias about
//   -5e-8).  The order is the same for every output element, so identical
//   operands give identical sums wherever they sit.
// - Fold: a tile's 128 x 128 similarities go to shared memory over the two
//   chunk buffers (columns XOR-swizzled by row: conflict-free writes), rows
//   past n_valid as NEG_INF; a warp per query compares them with the
//   query's k-th value and folds the few that pass into its sorted list,
//   candidates in ascending db index: a candidate enters only if strictly
//   above the k-th value and lands after every equal entry (the lower-index
//   tie rule).
// - Merge: each CTA writes its slice's sorted list to scratch; the last CTA
//   of a query block to arrive folds the S lists in slice order (ascending
//   db index) through the same rule, which gives exactly the list one
//   sequential fold over the whole store gives, whatever the arrival order.
//   It then writes (vals, idx) and, for the vote, gathers labels[idx] and
//   sums them in slot order over the valid slots.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;          // queries per CTA
constexpr int TN = 128;          // store rows per tile
constexpr int KC = 32;           // depth per ring stage and per partial sum
constexpr int STAGES = 2;        // ring stages of cp.async copies
constexpr int LDR = KC + 4;      // ring row stride, floats (36)
constexpr int SP = TN;           // similarity row stride (columns swizzled)
constexpr int BTILE = TN * 8;    // floats of one k8 step of one B operand
constexpr uint32_t LBO = BTILE / 2 * 4;   // bytes between K-adjacent core
constexpr uint32_t SBO = 8 * 4 * 4;       // ... and N-adjacent core matrices
constexpr int THREADS = 256;
constexpr int KMAX = 64;         // top-k slots (paper Table 4 range: k <= 64)
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;

constexpr int STAGE_FLOATS = (BQ + TN) * LDR;
constexpr int RING_FLOATS = STAGES * STAGE_FLOATS;
constexpr int BBUF_FLOATS = 2 * TN * KC;        // hi and lo of one chunk
constexpr int SIM_FLOATS = BQ * SP;
static_assert(SIM_FLOATS >= 2 * BBUF_FLOATS, "sims alias the chunk buffers");

// ring, two chunk buffers or the similarity tile, BQ sorted lists of k
// (value, index), the last-CTA flag
__host__ __device__ inline size_t smem_bytes(int k) {
  return (size_t)(RING_FLOATS + SIM_FLOATS) * 4 + (size_t)BQ * k * 8 + 16;
}

// cvt.rna.tf32.f32 on a finite float: round to nearest, ties away from zero,
// at 10 mantissa bits (the low 13 bits cleared), as two integer operations
__device__ inline uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ inline void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));   // exact difference
}

// d += A (registers, TF32) x B (shared memory, K-major TF32), m64n128k8
__device__ inline void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                  uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// Shared-memory matrix descriptor, no swizzle: core matrices of 8 rows x 16
// bytes; lbo = byte stride between core matrices along K, sbo = along N.
__device__ inline uint64_t smem_desc(const float* p, uint32_t lbo,
                                     uint32_t sbo) {
  uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16)
         | ((uint64_t)(sbo >> 4) << 32);
}

// wgmma's ordering: fence before a batch reads registers or shared memory
// that ordinary instructions wrote, commit the batch, wait for it
__device__ inline void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ inline void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ inline void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// The compiler sees a wgmma read its registers at issue; the tensor cores
// read and write them until the wait.  A volatile use after the wait keeps
// them live and unmoved until then.
template <int N>
__device__ inline void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ inline void keep(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ inline void cp_async16(float* dst, const float* src, bool valid) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

// One ring stage: depth chunk c of the CTA's queries and of the store tile
// starting at row r0; rows past b or n_rows and depth past d are zero.
__device__ inline void load_stage(float* st, const float* queries,
                                  const float* store, int q0, int b, int r0,
                                  int n_rows, int d, int c, int tid) {
#pragma unroll
  for (int i = 0; i < (BQ + TN) * (KC / 4) / THREADS; ++i) {
    int f = tid + i * THREADS;
    int row = f / (KC / 4), col = c * KC + (f % (KC / 4)) * 4;
    bool ok;
    const float* src;
    if (row < BQ) {
      ok = q0 + row < b && col < d;
      src = queries + (size_t)(q0 + row) * d + col;
    } else {
      ok = r0 + row - BQ < n_rows && col < d;
      src = store + (size_t)(r0 + row - BQ) * d + col;
    }
    cp_async16(st + row * LDR + (f % (KC / 4)) * 4, ok ? src : store, ok);
  }
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
                 int* __restrict__ idx, float* __restrict__ votes,
                 float* __restrict__ part_v, int* __restrict__ part_i,
                 int* __restrict__ arrived, int n_rows, int d, int n_lab,
                 int b, int k) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* bbuf = ring + RING_FLOATS;     // B hi|lo, two chunks; or the sims
  float* sim = bbuf;
  float* topv = sim + SIM_FLOATS;
  int* topi = reinterpret_cast<int*>(topv + BQ * k);
  int* is_last = topi + BQ * k;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // the thread's query rows arow and arow + 8: warpgroup warp / 4 owns 64,
  // its warp warp % 4 sixteen of them
  const int arow = (warp >> 2) * 64 + (warp & 3) * 16 + g;
  const int q0 = blockIdx.x * BQ;
  const int n_q = min(BQ, b - q0);
  const int slice = blockIdx.y, n_slices = gridDim.y;
  const int n_tiles = (n_rows + TN - 1) / TN;
  const int t_begin = (int)((long long)n_tiles * slice / n_slices);
  const int t_end = (int)((long long)n_tiles * (slice + 1) / n_slices);
  const int n_chunks = (d + KC - 1) / KC;
  const int total = (t_end - t_begin) * n_chunks;

  for (int f = tid; f < BQ * k; f += THREADS) {
    topv[f] = NEG_INF;
    topi[f] = -1;
  }

  // the tile's sums and the current chunk's partial: rows arow, arow + 8;
  // columns 8j + 2t, 8j + 2t + 1 at 4j .. 4j + 3
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  float part[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) part[e] = 0.f;
  uint32_t ahi[KC / 8][4], alo[KC / 8][4];
#pragma unroll
  for (int s = 0; s < KC / 8; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) ahi[s][e] = alo[s][e] = 0u;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total)
      load_stage(ring + s * STAGE_FLOATS, queries, store, q0, b,
                 (t_begin + s / n_chunks) * TN, n_rows, d, s % n_chunks, tid);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int it = 0; it < total; ++it) {
    const int tile = t_begin + it / n_chunks, c = it % n_chunks;
    const int nx = it + STAGES - 1;
    if (nx < total)
      load_stage(ring + (nx % STAGES) * STAGE_FLOATS, queries, store, q0, b,
                 (t_begin + nx / n_chunks) * TN, n_rows, d, nx % n_chunks,
                 tid);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1));
    __syncthreads();

    const float* qs = ring + (it % STAGES) * STAGE_FLOATS;
    const float* ss = qs + BQ * LDR;
    // raw A fragments of this chunk: (g, t), (g + 8, t), (g, t + 4),
    // (g + 8, t + 4) of each k8 step
    float araw[KC / 8][4];
#pragma unroll
    for (int s = 0; s < KC / 8; ++s) {
      const float* p = qs + arow * LDR + s * 8 + t;
      araw[s][0] = p[0];
      araw[s][1] = p[8 * LDR];
      araw[s][2] = p[4];
      araw[s][3] = p[8 * LDR + 4];
    }
    // the store chunk split into hi and lo, laid out as core matrices
    // [k4 group][8-row group][8][4] for the tensor cores
    float* bhi = bbuf + (it & 1) * BBUF_FLOATS;
    float* blo = bhi + TN * KC;
#pragma unroll
    for (int i = 0; i < TN * (KC / 4) / THREADS; ++i) {
      const int f = tid + i * THREADS;
      const int n = f % TN, kg = f / TN;
      float4 x = *reinterpret_cast<const float4*>(ss + n * LDR + kg * 4);
      uint32_t h[4], l[4];
      split(x.x, h[0], l[0]);
      split(x.y, h[1], l[1]);
      split(x.z, h[2], l[2]);
      split(x.w, h[3], l[3]);
      const int o = (kg * (TN / 8) + n / 8) * 32 + (n % 8) * 4;
      *reinterpret_cast<uint4*>(bhi + o) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(blo + o) = make_uint4(l[0], l[1], l[2], l[3]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // the previous chunk's products are done: its A registers and partial
    // are free
    wg_wait0();
    keep(ahi);
    keep(alo);
    keep(part);
    if (c != 0) {
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] += part[e];
    }
#pragma unroll
    for (int s = 0; s < KC / 8; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) split(araw[s][e], ahi[s][e], alo[s][e]);
    wg_fence();
#pragma unroll
    for (int s = 0; s < KC / 8; ++s) {
      const uint64_t dh = smem_desc(bhi + s * BTILE, LBO, SBO);
      const uint64_t dl = smem_desc(blo + s * BTILE, LBO, SBO);
      wgmma_tf32(part, alo[s], dh, s != 0);
      wgmma_tf32(part, ahi[s], dl);
      wgmma_tf32(part, ahi[s], dh);
    }
    wg_commit();

    if (c == n_chunks - 1) {
      // the tile's similarities, rows past n_rows masked, then the fold
      wg_wait0();
      keep(part);
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] += part[e];
      __syncthreads();   // every warpgroup is done with the B chunks
      const int r0 = tile * TN;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const int col = j * 8 + 2 * t;
        const bool v0 = r0 + col < n_rows, v1 = r0 + col + 1 < n_rows;
        const int sw = (g & 3) << 3;   // arow & 3 == g & 3
        *reinterpret_cast<float2*>(sim + arow * SP + (col ^ sw)) =
            make_float2(v0 ? acc[4 * j] : NEG_INF,
                        v1 ? acc[4 * j + 1] : NEG_INF);
        *reinterpret_cast<float2*>(sim + (arow + 8) * SP + (col ^ sw)) =
            make_float2(v0 ? acc[4 * j + 2] : NEG_INF,
                        v1 ? acc[4 * j + 3] : NEG_INF);
      }
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = 0.f;
      __syncthreads();
      for (int qq = warp; qq < n_q; qq += THREADS / 32) {
        const float* srow = sim + qq * SP;
        const int sw = (qq & 3) << 3;
        float c0 = srow[lane ^ sw], c1 = srow[(lane + 32) ^ sw],
              c2 = srow[(lane + 64) ^ sw], c3 = srow[(lane + 96) ^ sw];
        float* tv = topv + qq * k;
        int* ti = topi + qq * k;
        float kth = tv[k - 1];
        // most tiles hold no candidate above the k-th value
        if (!__any_sync(FULL, c0 > kth || c1 > kth || c2 > kth || c3 > kth))
          continue;
        // slots at or past k hold -inf: never counted, never stored
        float a0 = lane < k ? tv[lane] : -INFINITY;
        int b0 = lane < k ? ti[lane] : -1;
        float a1 = lane + 32 < k ? tv[lane + 32] : -INFINITY;
        int b1 = lane + 32 < k ? ti[lane + 32] : -1;
        fold_group(c0, r0 + lane, lane, k, a0, b0, a1, b1, kth);
        fold_group(c1, r0 + lane + 32, lane, k, a0, b0, a1, b1, kth);
        fold_group(c2, r0 + lane + 64, lane, k, a0, b0, a1, b1, kth);
        fold_group(c3, r0 + lane + 96, lane, k, a0, b0, a1, b1, kth);
        if (lane < k) { tv[lane] = a0; ti[lane] = b0; }
        if (lane + 32 < k) { tv[lane + 32] = a1; ti[lane + 32] = b1; }
      }
    }
  }
  __syncthreads();

  // this slice's sorted lists to scratch [b][S][k]
  for (int f = tid; f < n_q * k; f += THREADS) {
    size_t o = ((size_t)(q0 + f / k) * n_slices + slice) * k + f % k;
    part_v[o] = topv[f];
    part_i[o] = topi[f];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    *is_last = atomicAdd(arrived + blockIdx.x, 1) == n_slices - 1;
  __syncthreads();
  if (!*is_last) return;
  __threadfence();

  // the last CTA of the query block: merge the S lists in slice order, then
  // emit top-k and the vote (one warp per query, one lane per label; the
  // label sum runs over the slots in order)
  for (int qq = warp; qq < n_q; qq += THREADS / 32) {
    const int q = q0 + qq;
    float a0 = lane < k ? NEG_INF : -INFINITY, a1 =
        lane + 32 < k ? NEG_INF : -INFINITY;
    int b0 = -1, b1 = -1;
    float kth = NEG_INF;
    for (int s = 0; s < n_slices; ++s) {
      const size_t o = ((size_t)q * n_slices + s) * k;
      float c0 = lane < k ? __ldcg(part_v + o + lane) : -INFINITY;
      int i0 = lane < k ? __ldcg(part_i + o + lane) : -1;
      fold_group(c0, i0, lane, k, a0, b0, a1, b1, kth);
      if (k > 32) {
        float c1 = lane + 32 < k ? __ldcg(part_v + o + lane + 32) : -INFINITY;
        int i1 = lane + 32 < k ? __ldcg(part_i + o + lane + 32) : -1;
        fold_group(c1, i1, lane, k, a0, b0, a1, b1, kth);
      }
    }
    if (lane < k) {
      vals[(size_t)q * k + lane] = a0;
      idx[(size_t)q * k + lane] = b0;
    }
    if (lane + 32 < k) {
      vals[(size_t)q * k + lane + 32] = a1;
      idx[(size_t)q * k + lane + 32] = b1;
    }
    if constexpr (!VOTE) continue;
    int* ti = topi + qq * k;
    if (lane < k) ti[lane] = b0;
    if (lane + 32 < k) ti[lane + 32] = b1;
    __syncwarp();
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

// One launch of retrieval_kernel<VOTE> on ``stream`` over ``slices`` store
// slices; part_v / part_i hold b x slices x k entries and ``arrived`` one
// zeroed counter per query block.  Labels and votes are read and written
// only when VOTE.  The shared-memory limit is raised once per device.
template <bool VOTE>
int launch(const float* store, const float* labels, const float* queries,
           float* vals, int* idx, float* votes, float* part_v, int* part_i,
           int* arrived, int n_db, int d, int n_lab, int b, int k,
           int n_valid, int slices, void* stream) {
  if (d <= 0 || d % 4 != 0 || k < 1 || k > KMAX || slices < 1
      || slices > 65535)
    return (int)cudaErrorInvalidValue;
  static bool raised[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(retrieval_kernel<VOTE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(KMAX));
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  int n_rows = n_valid < n_db ? n_valid : n_db;
  if (n_rows < 0) n_rows = 0;
  dim3 grid((b + BQ - 1) / BQ, slices);
  if (grid.x == 0) return 0;
  retrieval_kernel<VOTE><<<grid, THREADS, smem_bytes(k),
                           (cudaStream_t)stream>>>(
      store, labels, queries, vals, idx, votes, part_v, part_i, arrived,
      n_rows, d, n_lab, b, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int retrieval_vote_launch(const float* store, const float* labels,
                                     const float* queries, float* vals,
                                     int* idx, float* votes, float* part_v,
                                     int* part_i, int* arrived, int n_db,
                                     int d, int n_lab, int b, int k,
                                     int n_valid, int slices, void* stream) {
  return launch<true>(store, labels, queries, vals, idx, votes, part_v,
                      part_i, arrived, n_db, d, n_lab, b, k, n_valid, slices,
                      stream);
}

extern "C" int topk_retrieval_launch(const float* store, const float* queries,
                                     float* vals, int* idx, float* part_v,
                                     int* part_i, int* arrived, int n_db,
                                     int d, int b, int k, int n_valid,
                                     int slices, void* stream) {
  return launch<false>(store, nullptr, queries, vals, idx, nullptr, part_v,
                       part_i, arrived, n_db, d, 0, b, k, n_valid, slices,
                       stream);
}
