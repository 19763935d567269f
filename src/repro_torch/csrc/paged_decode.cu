// Split-KV paged decode attention: one decode query per sequence against a
// block-tabled page pool, GQA groups folded onto each KV head, lens/window
// masked, split partials merged by log-sum-exp.
//
// Replaces the TPU kernel repro/kernels/decode_attention/kernel.py:
// paged_decode_attention_kernel (bodies _paged_kernel, _split_partials; the
// merge is ops.py:merge_partials, jnp outside the Pallas kernel there).
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
// storage elements (its K and V rows) and about 4*H*D float32 operations,
// i.e. ~1 operation per byte for bf16 at G = 4, far below the card's
// ~20 fp32 operations per byte.  So the floor is the valid KV bytes over
// 3.35 TB/s.
//
// Design (simple first): one 256-thread CTA per (split of pages, kv head,
// sequence).  A split covers pages_per_split pages (<= 256 positions).  The
// CTA reads its own page ids from the block table and clips its positions
// to [max(0, lens - window), lens): a split with no valid position writes
// the empty partial (o = 0, m = NEG_INF, l = 0) and touches no page, so the
// dump page and free slots cost nothing.  Scores: one thread per position,
// the K row read as 16-byte vectors against the G query rows held in shared
// memory.  Softmax: one warp per query row.  P.V: threads own one head dim
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

// grid (n_splits, KH, B); partials o (B, KH, S, G, D), m/l (B, KH, S, G)
template <typename T>
__global__ void __launch_bounds__(THREADS)
split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
             const T* __restrict__ vp, const int* __restrict__ bt,
             const int* __restrict__ lens, float* __restrict__ o_part,
             float* __restrict__ m_part, float* __restrict__ l_part, int H,
             int KH, int D, int PS, int P, int pps, int window, float scale) {
  extern __shared__ float smem[];
  __shared__ int spage[SPLIT_POS];
  __shared__ float row_m[GMAX], row_l[GMAX];
  const int s = blockIdx.x, k = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int G = H / KH;
  const int tid = threadIdx.x;
  const size_t part = ((size_t)b * KH + k) * n_splits + s;

  int len = lens[b];
  len = len < 0 ? 0 : (len > P * PS ? P * PS : len);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int t0 = s * pps * PS;
  const int a = max(t0, lo);
  const int t1 = min(t0 + pps * PS, len);
  if (a >= t1) {   // no valid position in this split: the empty partial
    for (int i = tid; i < G * D; i += THREADS) o_part[part * G * D + i] = 0.f;
    if (tid < G) {
      m_part[part * G + tid] = NEG_INF;
      l_part[part * G + tid] = 0.f;
    }
    return;
  }
  const int n = t1 - a;                 // valid positions, 1..SPLIT_POS
  const int npart = THREADS / D;        // position strides of the P.V pass
  float* qs = smem;                     // [G][D], scaled float32
  float* ps = qs + G * D;               // [G][SPLIT_POS] scores, then p
  float* red = ps + G * SPLIT_POS;      // [npart][G][D] P.V partial sums

  for (int i = tid; i < G * D; i += THREADS) {
    int g = i / D, d = i - g * D;
    qs[i] = to_f32(q[((size_t)b * H + k * G + g) * D + d]) * scale;
  }
  const int pg0 = t0 / PS;
  for (int i = tid; i < pps; i += THREADS)
    spage[i] = pg0 + i < P ? bt[(size_t)b * P + pg0 + i] : 0;
  __syncthreads();

  // scores: one thread per valid position
  if (tid < n) {
    const int t = a + tid;
    const int page = spage[t / PS - pg0];
    const T* kr = kp + (((size_t)page * PS + t % PS) * KH + k) * D;
    float acc[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) acc[g] = 0.f;
    constexpr int V = Vec16<T>::N;
    for (int d0 = 0; d0 < D; d0 += V) {
      float kv[V];
      Vec16<T>::load(kr + d0, kv);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
#pragma unroll
          for (int j = 0; j < V; ++j)
            acc[g] = fmaf(qs[g * D + d0 + j], kv[j], acc[g]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < G) ps[g * SPLIT_POS + tid] = acc[g];
  }
  __syncthreads();

  // softmax of the split: one warp per query row
  const int warp = tid >> 5, lane = tid & 31;
  if (warp < G) {
    float* row = ps + warp * SPLIT_POS;
    float mx = NEG_INF;
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, row[i]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) {
      float p = expf(row[i] - mx);
      row[i] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      row_m[warp] = mx;
      row_l[warp] = sum;
    }
  }
  __syncthreads();

  // P.V: thread (part, d) sums positions part, part + npart, ...
  const int d = tid % D, pi = tid / D;
  if (pi < npart) {
    float acc[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) acc[g] = 0.f;
    for (int i = pi; i < n; i += npart) {
      const int t = a + i;
      const int page = spage[t / PS - pg0];
      const float v = to_f32(vp[(((size_t)page * PS + t % PS) * KH + k) * D + d]);
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < G) acc[g] = fmaf(ps[g * SPLIT_POS + i], v, acc[g]);
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (g < G) red[(pi * G + g) * D + d] = acc[g];
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += THREADS) {
    float o = 0.f;
    for (int p = 0; p < npart; ++p) o += red[p * G * D + i];
    o_part[part * G * D + i] = o;
  }
  if (tid < G) {
    m_part[part * G + tid] = row_m[tid];
    l_part[part * G + tid] = row_l[tid];
  }
}

// grid (B * KH): merge the splits of one (sequence, kv head) -> out (B, H, D)
template <typename T>
__global__ void __launch_bounds__(THREADS)
merge_kernel(const float* __restrict__ o_part, const float* __restrict__ m_part,
             const float* __restrict__ l_part, T* __restrict__ out, int H,
             int KH, int D, int n_splits) {
  const int bk = blockIdx.x;
  const int b = bk / KH, k = bk - b * KH;
  const int G = H / KH;
  for (int i = threadIdx.x; i < G * D; i += THREADS) {
    const int g = i / D, d = i - g * D;
    const float* m = m_part + (size_t)bk * n_splits * G + g;
    const float* l = l_part + (size_t)bk * n_splits * G + g;
    const float* o = o_part + (size_t)bk * n_splits * G * D + i;
    float mg = NEG_INF;
    for (int s = 0; s < n_splits; ++s) mg = fmaxf(mg, m[s * G]);
    float lg = 0.f, og = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float c = expf(m[s * G] - mg);
      lg += l[s * G] * c;
      og += o[(size_t)s * G * D] * c;
    }
    from_f32(og / fmaxf(lg, 1e-30f), out + ((size_t)b * H + k * G + g) * D + d);
  }
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* bt,
           const int* lens, float* o_part, float* m_part, float* l_part,
           void* out, int B, int H, int KH, int D, int PS, int P, int window,
           float scale, int pps, int n_splits, cudaStream_t stream) {
  const int G = H / KH;
  if (B <= 0 || KH <= 0 || H % KH != 0 || G > GMAX || D <= 0 || D > DMAX
      || D % Vec16<T>::N != 0 || PS <= 0 || pps <= 0 || pps * PS > SPLIT_POS
      || n_splits <= 0 || (long long)n_splits * pps < P)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float)
      * ((size_t)G * D + (size_t)G * SPLIT_POS + (size_t)(THREADS / D) * G * D);
  split_kernel<T><<<dim3(n_splits, KH, B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, lens, o_part, m_part, l_part, H, KH, D,
      PS, P, pps, window, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<T><<<B * KH, THREADS, 0, stream>>>(
      o_part, m_part, l_part, static_cast<T*>(out), H, KH, D, n_splits);
  return (int)cudaGetLastError();
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
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, kp, vp, bt, lens, o_part, m_part, l_part, out, B,
                         H, KH, D, PS, P, window, scale, pps, n_splits, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kp, vp, bt, lens, o_part, m_part, l_part,
                                 out, B, H, KH, D, PS, P, window, scale, pps,
                                 n_splits, st);
  return (int)cudaErrorInvalidValue;
}
