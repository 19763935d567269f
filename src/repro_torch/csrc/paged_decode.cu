// Split-KV paged decode and speculative-verify attention: S query positions
// per sequence (S = 1 for decode) against a block-tabled page pool, GQA
// groups folded onto each KV head, lens/window masked per position, split
// partials merged by log-sum-exp.
//
// Replaces the TPU kernels repro/kernels/decode_attention/kernel.py:
// paged_decode_attention_kernel (bodies _paged_kernel, _split_partials; the
// merge is ops.py:merge_partials, jnp outside the Pallas kernel there) —
// entry point paged_decode_launch — paged_verify_attention_kernel (body
// _paged_verify_kernel, which folds the S positions into the q block's rows)
// — entry point paged_verify_launch — and the dense-cache
// decode_attention_kernel (body _kernel over a (B, T, K, D) cache, ragged T
// masked) — entry point decode_launch, which also runs the multi-position
// verify over a dense cache (the int8 pools' dequantized view; the reference
// runs that one as plain jnp).  All three run the same split kernel.  A
// fourth entry point, decode_partials_launch, runs the dense decode's split
// pass alone and leaves its partials unmerged: the reference kernel's own
// output, which the sequence-sharded decode merges across ranks
// (ops.merge_partials there).
// The dense one reads the contiguous cache as pages of one position whose
// ids are b*T + t (no block table), so at the same split boundaries
// (SPLIT_POS positions) it equals the paged decode bit for bit.  Verify and
// decode: a verify CTA holds all S*G query rows and reads each K and V row
// once for all of them, and each row runs exactly the operations, in the
// same order, of the decode kernel at that row's length, so verify position
// s is bit-identical to decode at lens[b] + s.
//
// Contract (the TPU kernel's numerics): q, K and V are read in their storage
// type (bf16 or float32) and widened to float32; q is scaled by d**-0.5 in
// float32; scores, the softmax and the P.V product stay in float32 (p is not
// rounded to bf16); the merged result is rounded once to q's type.  Position
// t of sequence b is valid when t < lens[b] and, with window > 0, when
// t >= lens[b] - window.  A sequence with no valid position gets 0 (the
// NumPy oracle's answer; the TPU kernel's jnp merge gives the mean of every
// gathered V there).  The serving path always attends over lens + 1 >= 1
// positions, so the two never meet on it.
//
// What bounds it on the H100: bytes.  Each valid position costs 2*K*D
// storage elements (its K and V rows) and 4*H*D operations per query
// position, i.e. S*G operations per byte for bf16: 4 for decode at G = 4,
// 32 for a verify of S = 8.  Half of them are the Q.K dots, exact in bf16
// on the tensor cores (989 TFLOP/s); the P.V half stays in float32
// (67 TFLOP/s, ~20 operations per byte).  Either way the floor is the valid
// KV bytes (for verify, those of the longest row) over 3.35 TB/s; this
// kernel runs the Q.K dots on the CUDA cores as well, which a verify at
// S*G = 32 does feel.
//
// Design: one 256-thread CTA per (split of pages, kv head, sequence).  A
// split covers pages_per_split pages (<= 256 positions).  The CTA reads its
// own page ids from the block table into a per-position table of cache
// rows and clips its positions to [max(0, lens - window), lens): a split
// with no valid position writes the empty partial (o = 0, m = NEG_INF,
// l = 0) and touches no page, so the dump page and free slots cost
// nothing.  The K rows, then the V rows, of the positions the rows can see
// stream through a ring of three shared-memory chunks (64 positions at
// rows of up to 256 bytes; 32 or 16 at wider rows) by 16-byte cp.async
// copies: neighbouring threads copy neighbouring 16-byte vectors of a row,
// so a warp reads whole rows, and two chunks are in flight while one is
// consumed.  The staged row stride is an odd number of 16-byte units, so
// the 16-byte reads of eight rows hit distinct banks.
//   Scores: the four lanes of a quad share a position; lane a takes the
// K row's 16-byte vectors a, a + 4, .. (widened once) against every query
// row, and a fixed xor tree adds the four partial sums as (s0 + s1) +
// (s2 + s3).  Softmax: one warp per query row over the split.  P.V:
// thread (row group, 16-byte vector of head dims, part) sums, for the rows
// of its group, the positions i = part (mod NPART) in ascending order
// (NPART = 64 / (D / vector) rounded down to a power of 2), V read as
// 16-byte vectors; the NPART parts of a vector are neighbouring lanes and
// meet in a fixed xor tree.  Each row's float32 operations and their order
// depend on D and the element type only, never on the page size, on R or
// on the other rows: hence dense == paged and verify row s == decode at
// lens + s, bit for bit.  A second launch merges the splits, one CTA per
// (sequence, kv head, row).  Nothing gathers a dense copy of the cache.
// Not yet done: tensor-core Q.K dots for the verify rows, TMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int SPLIT_POS = 256;   // positions per split at most (= THREADS)
constexpr int GMAX = 8;          // query heads per kv head at most
constexpr int RMAX_VERIFY = 64;  // verify rows (positions x heads) per CTA
constexpr int DMAX = 256;
constexpr int NBUF = 3;          // shared-memory chunks of the cp.async ring
constexpr int PSTR = SPLIT_POS + 1;  // row stride of the score buffer
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;

__device__ inline float to_f32(float x) { return x; }
__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline void from_f32(float x, float* out) { *out = x; }
__device__ inline void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

// One 16-byte vector of a row in shared memory, widened to float32.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ void load(const float* p, float* out) {
    float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ void load(const __nv_bfloat16* p, float* out) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// Shared-memory geometry, a function of D and the element size only.
// 16-byte units of a staged K/V row: D * elem / 16 made odd.
__host__ __device__ inline int row_units(int D, int elem) {
  return (D * elem / 16) | 1;
}
// positions per staged chunk: at most 64 x 17 16-byte units
__host__ __device__ inline int chunk_pos(int D, int elem) {
  return D * elem <= 256 ? 64 : D * elem <= 512 ? 32 : 16;
}
// P.V position parts: the largest power of 2 <= 32 with parts * (16-byte
// vectors of a row) <= 64
__host__ __device__ inline int pv_parts(int D, int elem) {
  const int dv = D * elem / 16;
  int p = 1;
  while (2 * p <= 32 && 2 * p * dv <= 64) p *= 2;
  return p;
}
__host__ __device__ inline size_t split_smem(int R, int D, int elem) {
  return (size_t)NBUF * chunk_pos(D, elem) * row_units(D, elem) * 16
      + sizeof(float) * ((size_t)R * D + (size_t)R * PSTR);
}

__device__ inline void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}
__device__ inline void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ inline void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ inline float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// One CTA per (split, kv head, sequence) over R = S*G query rows: row r is
// query position s = r / G (valid length lens[b] + s) and query head k*G +
// r % G.  Decode is S = 1.  Every per-row quantity is indexed by the position
// i relative to the split's FIXED start t0 (never by the row's own first
// valid position), and invalid positions are skipped, so a row runs the same
// operations in the same order whatever the other rows are: verify row s is
// bit-identical to the decode of the same query at lens[b] + s.
// Partials o (B, KH, S, R, D), m/l (B, KH, S, R) with S = n_splits.
// dense_t > 0: no block table; page i of sequence b is cache row b*dense_t +
// i (PS = 1, P = dense_t).
template <typename T, int RMAX>
__global__ void __launch_bounds__(THREADS)
split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
             const T* __restrict__ vp, const int* __restrict__ bt,
             const int* __restrict__ lens, float* __restrict__ o_part,
             float* __restrict__ m_part, float* __restrict__ l_part, int H,
             int KH, int D, int PS, int P, int pps, int window, float scale,
             int S, int dense_t) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int srow[SPLIT_POS];       // cache row of each position
  __shared__ int r_lo[RMAX], r_hi[RMAX];
  __shared__ float row_m[RMAX], row_l[RMAX];
  const int sp = blockIdx.x, k = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int G = H / KH, R = S * G;
  const int tid = threadIdx.x;
  const size_t part = ((size_t)b * KH + k) * n_splits + sp;
  const int t0 = sp * pps * PS;

  // each row's valid positions in this split, relative to t0: [lo, hi)
  if (tid < R) {
    int len = lens[b] + tid / G;
    len = len < 0 ? 0 : (len > P * PS ? P * PS : len);
    const int lo = window > 0 ? max(0, len - window) : 0;
    const int a = max(t0, lo);
    const int t1 = min(t0 + pps * PS, len);
    r_lo[tid] = a - t0;
    r_hi[tid] = a < t1 ? t1 - t0 : a - t0;
  }
  __syncthreads();
  // the union of the rows' ranges (rows of a later position reach further)
  int u_lo = SPLIT_POS, u_hi = 0;
  for (int r = 0; r < R; ++r)
    if (r_lo[r] < r_hi[r]) {
      u_lo = min(u_lo, r_lo[r]);
      u_hi = max(u_hi, r_hi[r]);
    }
  if (u_lo >= u_hi) {   // no valid position in this split: empty partials
    for (int i = tid; i < R * D; i += THREADS) o_part[part * R * D + i] = 0.f;
    if (tid < R) {
      m_part[part * R + tid] = NEG_INF;
      l_part[part * R + tid] = 0.f;
    }
    return;
  }
  constexpr int V = Vec16<T>::N;
  const int DV = D / V;                 // 16-byte vectors of a row
  const int ST = row_units(D, sizeof(T)) * V;   // staged row stride
  const int CH = chunk_pos(D, sizeof(T));
  const int NPART = pv_parts(D, sizeof(T));
  T* ring = reinterpret_cast<T*>(smem_raw);     // [NBUF][CH][ST]
  float* qs = reinterpret_cast<float*>(ring + (size_t)NBUF * CH * ST);
  float* ps = qs + R * D;               // [R][PSTR] scores, then p

  for (int i = tid; i < R * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    const int srow_q = r / G, g = r - srow_q * G;
    qs[i] = to_f32(q[(((size_t)b * S + srow_q) * H + k * G + g) * D + d])
        * scale;
  }
  const int pg0 = t0 / PS;
  for (int i = tid; i < pps * PS; i += THREADS) {
    const int pg = i / PS, pi = pg0 + pg;
    const int page = pi >= P ? 0
        : dense_t > 0 ? b * dense_t + pi : bt[(size_t)b * P + pi];
    srow[i] = page * PS + i - pg * PS;
  }
  __syncthreads();

  // stages: the K chunks of the union, then its V chunks
  const int c_first = u_lo / CH;
  const int n_ch = (u_hi - 1) / CH - c_first + 1;
  const int n_stages = 2 * n_ch;
  auto issue = [&](int st) {
    if (st < n_stages) {
      const bool is_v = st >= n_ch;
      const int c0 = (c_first + (is_v ? st - n_ch : st)) * CH;
      const T* src = is_v ? vp : kp;
      T* dst = ring + (size_t)(st % NBUF) * CH * ST;
      const int i0 = max(c0, u_lo), i1 = min(c0 + CH, u_hi);
      for (int x = tid; x < (i1 - i0) * DV; x += THREADS) {
        const int j = x / DV, e = x - j * DV;
        const int i = i0 + j;
        cp_async16(dst + (i - c0) * ST + e * V,
                   src + ((size_t)srow[i] * KH + k) * D + e * V);
      }
    }
    cp_commit();                        // one group per stage, maybe empty
  };
#pragma unroll
  for (int st = 0; st < NBUF - 1; ++st) issue(st);

  // K stages, the scores: the lanes of quad j (position j of the chunk)
  // take the 16-byte vectors e = a, a + 4, .. (a = lane % 4) of the K row
  // for every query row; a row's dot is the four partial sums (each
  // vector's elements in order) added as (s0 + s1) + (s2 + s3) by a fixed
  // xor tree over the quad
  const int quarter = tid & 3;
  for (int st = 0; st < n_ch; ++st) {
    issue(st + NBUF - 1);
    cp_wait<NBUF - 1>();                // stage st has landed
    __syncthreads();
    const T* buf = ring + (size_t)(st % NBUF) * CH * ST;
    const int c0 = (c_first + st) * CH;
    for (int j = tid >> 2; j < CH; j += THREADS / 4) {  // warp-uniform
      const int i = c0 + j;
      const bool live = i >= u_lo && i < u_hi;           // quad-uniform
      float sc[RMAX];
#pragma unroll
      for (int r = 0; r < RMAX; ++r) sc[r] = 0.f;
      if (live) {
        const T* kr = buf + j * ST;
        for (int e = quarter; e < DV; e += 4) {
          float kv[V];
          Vec16<T>::load(kr + e * V, kv);
#pragma unroll
          for (int r = 0; r < RMAX; ++r) {
            if (r < R) {
              const float* qr = qs + r * D + e * V;
#pragma unroll
              for (int x = 0; x < V; x += 4) {
                const float4 q4 = *reinterpret_cast<const float4*>(qr + x);
                sc[r] = fmaf(q4.x, kv[x], sc[r]);
                sc[r] = fmaf(q4.y, kv[x + 1], sc[r]);
                sc[r] = fmaf(q4.z, kv[x + 2], sc[r]);
                sc[r] = fmaf(q4.w, kv[x + 3], sc[r]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (r < R) {
          float v = sc[r];
          v += __shfl_xor_sync(FULL, v, 1);
          v += __shfl_xor_sync(FULL, v, 2);
          if (live && quarter == (r & 3)) ps[r * PSTR + i] = v;
        }
      }
    }
    __syncthreads();                    // the chunk's buffer is free
  }

  // softmax of the split: one warp per row (rows warp, warp + 8, ...)
  {
    const int warp = tid >> 5, lane = tid & 31;
    for (int r = warp; r < R; r += THREADS / 32) {
      float* row = ps + r * PSTR;
      const int lo = r_lo[r], hi = r_hi[r];
      float mx = NEG_INF;
      for (int i = lane; i < hi; i += 32)
        if (i >= lo) mx = fmaxf(mx, row[i]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int i = lane; i < hi; i += 32) {
        if (i >= lo) {
          const float p = expf(row[i] - mx);
          row[i] = p;
          sum += p;
        }
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        row_m[r] = lo < hi ? mx : NEG_INF;
        row_l[r] = sum;
      }
    }
  }
  __syncthreads();

  // V stages, P.V: thread (row group rg, vector e, part) owns rows rg,
  // rg + nrg, .. (nrg = THREADS / (DV * NPART) >= 4 groups) and sums the
  // positions i = part (mod NPART) in ascending order, each V vector read
  // once for its rows; the NPART parts of a (row group, vector) are
  // neighbouring lanes and meet in a fixed xor tree
  const int pairs = DV * NPART;
  const int nrg = THREADS / pairs;
  const int my_part = tid % NPART;
  const int my_e = tid / NPART % DV;
  const int my_rg = tid / pairs;
  int rlo[RMAX / 4], rhi[RMAX / 4];
  float acc[RMAX / 4][V];
#pragma unroll
  for (int rr = 0; rr < RMAX / 4; ++rr) {
    const int r = my_rg + rr * nrg;
    const bool live = my_rg < nrg && r < R;
    rlo[rr] = live ? r_lo[r] : 0;
    rhi[rr] = live ? r_hi[r] : 0;
#pragma unroll
    for (int x = 0; x < V; ++x) acc[rr][x] = 0.f;
  }
  for (int st = n_ch; st < n_stages; ++st) {
    issue(st + NBUF - 1);
    cp_wait<NBUF - 1>();
    __syncthreads();
    const T* buf = ring + (size_t)(st % NBUF) * CH * ST;
    const int c0 = (c_first + st - n_ch) * CH;
    if (my_rg < nrg) {
      const int hi = min(c0 + CH, u_hi);
      for (int i = c0 + my_part; i < hi; i += NPART) {
        if (i < u_lo) continue;
        float vv[V];
        Vec16<T>::load(buf + (i - c0) * ST + my_e * V, vv);
#pragma unroll
        for (int rr = 0; rr < RMAX / 4; ++rr) {
          if (i >= rlo[rr] && i < rhi[rr]) {
            const float p = ps[(my_rg + rr * nrg) * PSTR + i];
#pragma unroll
            for (int x = 0; x < V; ++x)
              acc[rr][x] = fmaf(p, vv[x], acc[rr][x]);
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int rr = 0; rr < RMAX / 4; ++rr) {
    float o[V];
#pragma unroll
    for (int x = 0; x < V; ++x) {
      o[x] = acc[rr][x];
      for (int off = 1; off < NPART; off <<= 1)
        o[x] += __shfl_xor_sync(FULL, o[x], off);
    }
    const int r = my_rg + rr * nrg;
    if (my_rg < nrg && r < R && my_part == 0) {
      float* dst = o_part + (part * R + r) * D + my_e * V;
#pragma unroll
      for (int x = 0; x < V; x += 4)
        *reinterpret_cast<float4*>(dst + x) =
            make_float4(o[x], o[x + 1], o[x + 2], o[x + 3]);
    }
  }
  if (tid < R) {
    m_part[part * R + tid] = row_m[tid];
    l_part[part * R + tid] = row_l[tid];
  }
}

// grid (B * KH, R), D threads: merge the splits of one (sequence, kv
// head, row) -> out (B, S, H, D)
template <typename T>
__global__ void __launch_bounds__(DMAX)
merge_kernel(const float* __restrict__ o_part, const float* __restrict__ m_part,
             const float* __restrict__ l_part, T* __restrict__ out, int H,
             int KH, int D, int n_splits, int S) {
  const int bk = blockIdx.x, r = blockIdx.y, d = threadIdx.x;
  const int b = bk / KH, k = bk - b * KH;
  const int G = H / KH, R = S * G;
  const int srow = r / G, g = r - srow * G;
  const float* m = m_part + (size_t)bk * n_splits * R + r;
  const float* l = l_part + (size_t)bk * n_splits * R + r;
  const float* o = o_part + ((size_t)bk * n_splits * R + r) * D + d;
  float mg = NEG_INF;
  for (int s = 0; s < n_splits; ++s) mg = fmaxf(mg, m[s * R]);
  float lg = 0.f, og = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float c = expf(m[s * R] - mg);
    lg = fmaf(l[s * R], c, lg);
    og = fmaf(o[(size_t)s * R * D], c, og);
  }
  from_f32(og / fmaxf(lg, 1e-30f),
           out + (((size_t)b * S + srow) * H + k * G + g) * D + d);
}

template <typename T, int RMAX>
int launch_rows(const void* q, const void* kp, const void* vp, const int* bt,
                const int* lens, float* o_part, float* m_part, float* l_part,
                void* out, int B, int H, int KH, int D, int PS, int P,
                int window, float scale, int pps, int n_splits, int S,
                int dense_t, cudaStream_t stream) {
  const int R = S * (H / KH);
  const size_t smem = split_smem(R, D, sizeof(T));
  // Once per instance, at its largest layout (R = RMAX, D = DMAX, the ring
  // at its largest: 64 positions x 17 units), on the device of its first
  // launch.
  static const cudaError_t attr = cudaFuncSetAttribute(
      split_kernel<T, RMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(NBUF * 64 * 17 * 16
            + sizeof(float) * RMAX * ((size_t)DMAX + PSTR)));
  if (attr != cudaSuccess) return (int)attr;
  split_kernel<T, RMAX><<<dim3(n_splits, KH, B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, lens, o_part, m_part, l_part, H, KH, D,
      PS, P, pps, window, scale, S, dense_t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || out == nullptr) return (int)err;
  merge_kernel<T><<<dim3(B * KH, R), D, 0, stream>>>(
      o_part, m_part, l_part, static_cast<T*>(out), H, KH, D, n_splits, S);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* bt,
           const int* lens, float* o_part, float* m_part, float* l_part,
           void* out, int B, int H, int KH, int D, int PS, int P, int window,
           float scale, int pps, int n_splits, int S, int dense_t,
           cudaStream_t stream) {
  if (B <= 0 || KH <= 0 || S <= 0 || H % KH != 0 || D <= 0 || D > DMAX
      || D % Vec16<T>::N != 0 || PS <= 0 || pps <= 0 || pps * PS > SPLIT_POS
      || n_splits <= 0 || (long long)n_splits * pps < P)
    return (int)cudaErrorInvalidValue;
  const int R = S * (H / KH);
#define ROWS(RM)                                                              \
  return launch_rows<T, RM>(q, kp, vp, bt, lens, o_part, m_part, l_part, out, \
                            B, H, KH, D, PS, P, window, scale, pps, n_splits, \
                            S, dense_t, stream)
  if (R <= 4) ROWS(4);
  if (R <= GMAX) ROWS(GMAX);
  if (R <= 16) ROWS(16);
  if (R <= 32) ROWS(32);
  if (R <= RMAX_VERIFY) ROWS(RMAX_VERIFY);
#undef ROWS
  return (int)cudaErrorInvalidValue;
}

int dispatch(int dtype, const void* q, const void* kp, const void* vp,
             const int* bt, const int* lens, float* o_part, float* m_part,
             float* l_part, void* out, int B, int H, int KH, int D, int PS,
             int P, int window, float scale, int pps, int n_splits, int S,
             int dense_t, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, kp, vp, bt, lens, o_part, m_part, l_part, out, B,
                         H, KH, D, PS, P, window, scale, pps, n_splits, S,
                         dense_t, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kp, vp, bt, lens, o_part, m_part, l_part,
                                 out, B, H, KH, D, PS, P, window, scale, pps,
                                 n_splits, S, dense_t, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, the pools and out share it).
// Partials: o (B, KH, n_splits, G, D), m and l (B, KH, n_splits, G), float32,
// allocated by the caller.  Launches on ``stream``; allocates nothing.
extern "C" int paged_decode_launch(int dtype, const void* q, const void* kp,
                                   const void* vp, const int* bt,
                                   const int* lens, float* o_part,
                                   float* m_part, float* l_part, void* out,
                                   int B, int H, int KH, int D, int PS, int P,
                                   int window, float scale, int pps,
                                   int n_splits, void* stream) {
  if (H % KH != 0 || H / KH > GMAX) return (int)cudaErrorInvalidValue;
  return dispatch(dtype, q, kp, vp, bt, lens, o_part, m_part, l_part, out, B,
                  H, KH, D, PS, P, window, scale, pps, n_splits, 1, 0, stream);
}

// The speculative-verify entry point: q and out (B, S, H, D), query position
// s of sequence b masked to positions < lens[b] + s (and, with window > 0,
// >= lens[b] + s - window).  Partials o (B, KH, n_splits, S*G, D), m and l
// (B, KH, n_splits, S*G).  S*G at most 64.
extern "C" int paged_verify_launch(int dtype, const void* q, const void* kp,
                                   const void* vp, const int* bt,
                                   const int* lens, float* o_part,
                                   float* m_part, float* l_part, void* out,
                                   int B, int S, int H, int KH, int D, int PS,
                                   int P, int window, float scale, int pps,
                                   int n_splits, void* stream) {
  if (H % KH != 0 || S <= 0 || (long long)S * (H / KH) > RMAX_VERIFY)
    return (int)cudaErrorInvalidValue;
  return dispatch(dtype, q, kp, vp, bt, lens, o_part, m_part, l_part, out, B,
                  H, KH, D, PS, P, window, scale, pps, n_splits, S, 0, stream);
}

// The dense-cache entry point, decode (S = 1) and verify (S > 1): q and out
// (B, S, H, D), caches k and v (B, T, KH, D) contiguous, lens (B,) valid
// lengths of query 0: query s is masked to positions < lens[b] + s (clamped
// to [0, T]; with window > 0, >= lens[b] + s - window).  Splits of SPLIT_POS
// positions; partials o (B, KH, n_splits, S*G, D), m and l (B, KH, n_splits,
// S*G), n_splits = ceil(T / SPLIT_POS).  G at most GMAX for decode, S*G at
// most RMAX_VERIFY for verify.
extern "C" int decode_launch(int dtype, const void* q, const void* k,
                             const void* v, const int* lens, float* o_part,
                             float* m_part, float* l_part, void* out, int B,
                             int S, int H, int KH, int D, int T, int window,
                             float scale, int n_splits, void* stream) {
  if (T <= 0 || S <= 0 || H % KH != 0
      || (long long)S * (H / KH) > (S == 1 ? GMAX : RMAX_VERIFY)
      || (long long)n_splits * SPLIT_POS < T)
    return (int)cudaErrorInvalidValue;
  return dispatch(dtype, q, k, v, nullptr, lens, o_part, m_part, l_part, out,
                  B, H, KH, D, 1, T, window, scale, SPLIT_POS, n_splits, S, T,
                  stream);
}

// The dense decode's split partials, unmerged (decode_launch without its
// merge): q (B, 1, H, D), caches (B, T, KH, D), lens (B,) valid lengths
// (0 allowed: every split empty).  o (B, KH, n_splits, G, D) holds each
// split's unnormalised P.V numerator, m and l (B, KH, n_splits, G) its
// score max and exp sum; a split with no valid position holds (0, NEG_INF,
// 0).  n_splits = ceil(T / SPLIT_POS), G at most GMAX.
extern "C" int decode_partials_launch(int dtype, const void* q, const void* k,
                                      const void* v, const int* lens,
                                      float* o_part, float* m_part,
                                      float* l_part, int B, int H, int KH,
                                      int D, int T, float scale, int n_splits,
                                      void* stream) {
  if (T <= 0 || H % KH != 0 || H / KH > GMAX
      || (long long)n_splits * SPLIT_POS < T)
    return (int)cudaErrorInvalidValue;
  return dispatch(dtype, q, k, v, nullptr, lens, o_part, m_part, l_part,
                  nullptr, B, H, KH, D, 1, T, 0, scale, SPLIT_POS, n_splits,
                  1, T, stream);
}
