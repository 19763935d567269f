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
// masked) — entry point decode_launch.  All three run the same split kernel.
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
// Design (simple first): one 256-thread CTA per (split of pages, kv head,
// sequence).  A split covers pages_per_split pages (<= 256 positions).  The
// CTA reads its own page ids from the block table and clips its positions
// to [max(0, lens - window), lens): a split with no valid position writes
// the empty partial (o = 0, m = NEG_INF, l = 0) and touches no page, so the
// dump page and free slots cost nothing.  Scores: one thread per position,
// the K row read as 16-byte vectors against the S*G query rows held in
// shared memory (up to 64 rows; above 48 KB the shared memory is dynamic).
// Softmax: one warp per query row.  P.V: threads own one head dim
// each (several position strides when D < 256), V read coalesced along D,
// the strides summed through shared memory.  A second small launch merges
// the splits per (sequence, kv head).  Nothing gathers a dense copy of the
// cache.  Not yet done: overlapping the K loads (cp.async/TMA), vector V
// loads, and tensor-core dots.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int SPLIT_POS = 256;   // positions per split at most (= THREADS)
constexpr int GMAX = 8;          // query heads per kv head at most
constexpr int RMAX_VERIFY = 64;  // verify rows (positions x heads) per CTA
constexpr int DMAX = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;

__device__ inline float to_f32(float x) { return x; }
__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline void from_f32(float x, float* out) { *out = x; }
__device__ inline void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

// One 16-byte vector of a row, widened to float32.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ void load(const float* p, float* out) {
    float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ void load(const __nv_bfloat16* p, float* out) {
    uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

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
// t relative to the split's FIXED start t0 (never by the row's own first
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
  extern __shared__ float smem[];
  __shared__ int spage[SPLIT_POS];
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
  const int npart = THREADS / D;        // position strides of the P.V pass
  float* qs = smem;                     // [R][D], scaled float32
  float* ps = qs + R * D;               // [R][SPLIT_POS] scores, then p
  float* red = ps + R * SPLIT_POS;      // [npart][R][D] P.V partial sums

  for (int i = tid; i < R * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    const int srow = r / G, g = r - srow * G;
    qs[i] = to_f32(q[(((size_t)b * S + srow) * H + k * G + g) * D + d]) * scale;
  }
  const int pg0 = t0 / PS;
  for (int i = tid; i < pps; i += THREADS)
    spage[i] = pg0 + i >= P ? 0
        : dense_t > 0 ? b * dense_t + pg0 + i : bt[(size_t)b * P + pg0 + i];
  __syncthreads();

  // scores: one thread per position of the union, its K row read once for
  // every row
  if (tid >= u_lo && tid < u_hi) {
    const int t = t0 + tid;
    const int page = spage[tid / PS];
    const T* kr = kp + (((size_t)page * PS + t % PS) * KH + k) * D;
    float acc[RMAX];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) acc[r] = 0.f;
    constexpr int V = Vec16<T>::N;
    for (int d0 = 0; d0 < D; d0 += V) {
      float kv[V];
      Vec16<T>::load(kr + d0, kv);
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (r < R) {
#pragma unroll
          for (int j = 0; j < V; ++j)
            acc[r] = fmaf(qs[r * D + d0 + j], kv[j], acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
      if (r < R) ps[r * SPLIT_POS + tid] = acc[r];
  }
  __syncthreads();

  // softmax of the split: one warp per row (rows warp, warp + 8, ...)
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < R; r += THREADS / 32) {
    float* row = ps + r * SPLIT_POS;
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
  __syncthreads();

  // P.V: thread (part, d) sums positions part, part + npart, ... of each
  // row's range; each V element read once for every row
  const int d = tid % D, pi = tid / D;
  if (pi < npart) {
    float acc[RMAX];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) acc[r] = 0.f;
    for (int i = pi; i < u_hi; i += npart) {
      if (i < u_lo) continue;
      const int t = t0 + i;
      const int page = spage[i / PS];
      const float v = to_f32(vp[(((size_t)page * PS + t % PS) * KH + k) * D + d]);
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
        if (r < R && i >= r_lo[r] && i < r_hi[r])
          acc[r] = fmaf(ps[r * SPLIT_POS + i], v, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
      if (r < R) red[(pi * R + r) * D + d] = acc[r];
  }
  __syncthreads();
  for (int i = tid; i < R * D; i += THREADS) {
    float o = 0.f;
    for (int p = 0; p < npart; ++p) o += red[p * R * D + i];
    o_part[part * R * D + i] = o;
  }
  if (tid < R) {
    m_part[part * R + tid] = row_m[tid];
    l_part[part * R + tid] = row_l[tid];
  }
}

// grid (B * KH): merge the splits of one (sequence, kv head) -> out (B, S, H, D)
template <typename T>
__global__ void __launch_bounds__(THREADS)
merge_kernel(const float* __restrict__ o_part, const float* __restrict__ m_part,
             const float* __restrict__ l_part, T* __restrict__ out, int H,
             int KH, int D, int n_splits, int S) {
  const int bk = blockIdx.x;
  const int b = bk / KH, k = bk - b * KH;
  const int G = H / KH, R = S * G;
  for (int i = threadIdx.x; i < R * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    const int srow = r / G, g = r - srow * G;
    const float* m = m_part + (size_t)bk * n_splits * R + r;
    const float* l = l_part + (size_t)bk * n_splits * R + r;
    const float* o = o_part + (size_t)bk * n_splits * R * D + i;
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
}

template <typename T, int RMAX>
int launch_rows(const void* q, const void* kp, const void* vp, const int* bt,
                const int* lens, float* o_part, float* m_part, float* l_part,
                void* out, int B, int H, int KH, int D, int PS, int P,
                int window, float scale, int pps, int n_splits, int S,
                int dense_t, cudaStream_t stream) {
  const int R = S * (H / KH);
  const size_t smem = sizeof(float)
      * ((size_t)R * D + (size_t)R * SPLIT_POS + (size_t)(THREADS / D) * R * D);
  // Once per instance, at its largest layout (R = RMAX, THREADS / D * D <=
  // THREADS), on the device of its first launch.
  static const cudaError_t attr = cudaFuncSetAttribute(
      split_kernel<T, RMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * RMAX * (DMAX + SPLIT_POS + THREADS)));
  if (attr != cudaSuccess) return (int)attr;
  split_kernel<T, RMAX><<<dim3(n_splits, KH, B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, lens, o_part, m_part, l_part, H, KH, D,
      PS, P, pps, window, scale, S, dense_t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<T><<<B * KH, THREADS, 0, stream>>>(
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

// The dense-cache decode entry point: q and out (B, 1, H, D), caches k and
// v (B, T, KH, D) contiguous, lens (B,) valid lengths (clamped to [0, T]).
// Splits of SPLIT_POS positions; partials o (B, KH, n_splits, G, D), m and
// l (B, KH, n_splits, G), n_splits = ceil(T / SPLIT_POS).
extern "C" int decode_launch(int dtype, const void* q, const void* k,
                             const void* v, const int* lens, float* o_part,
                             float* m_part, float* l_part, void* out, int B,
                             int H, int KH, int D, int T, int window,
                             float scale, int n_splits, void* stream) {
  if (T <= 0 || H % KH != 0 || H / KH > GMAX
      || (long long)n_splits * SPLIT_POS < T)
    return (int)cudaErrorInvalidValue;
  return dispatch(dtype, q, k, v, nullptr, lens, o_part, m_part, l_part, out,
                  B, H, KH, D, 1, T, window, scale, SPLIT_POS, n_splits, 1, T,
                  stream);
}
