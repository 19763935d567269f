// Causal / sliding-window GQA flash attention forward: q (B, Sq, H, D)
// against k, v (B, Skv, KH, D), online softmax over tiles of 64 positions,
// fully masked tiles skipped.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:
// flash_attention_kernel (body _kernel).  The function computed is the one
// the JAX model computes in plain jnp for every full-sequence attention
// (repro/models/attention.py: flash_attention_jnp): q is scaled by
// d**-0.5 rounded to q's type and the product rounded to q's type; scores,
// the running max m, the denominator l and the accumulator stay in
// float32; p is rounded to the operand type before the P.V product (in
// float32 that is the TPU kernel's arithmetic exactly); the result is
// acc / max(l, 1e-30) rounded once to q's type.  Query row i sits at
// position q_offset + i; key position t is valid when t <= q_offset + i
// (causal) and t > q_offset + i - window (window > 0).  A row with no valid
// position gets 0 (the chunked plain version gives the mean of V there);
// causal rows always see at least their own position.
//
// What bounds it on the H100: operations at long sequences.  A tile pair
// costs 4*D operations per (query row, visible position) against 2*D
// stored elements per position read once per CTA, so at a 64-position
// query block and G heads per kv head it does 128*G operations per byte
// (bf16) -- above the ~295 the tensor cores need only with G >= 4, and far
// above what the CUDA cores it runs on can take (67 TFLOP/s float32).  The
// bound counts both products at the bf16 tensor-core rate; this kernel runs
// them as float32 FMAs on the CUDA cores, so it sits well above that bound.
//
// Design (simple first): one 512-thread CTA per (block of query positions,
// kv head, sequence).  The CTA holds every query head of its GQA group, so
// each K/V tile is read from memory once for all G heads: R = 16 * RW rows
// (query position x head), RW rows per warp, BQ = R / G query positions
// (64 at h2o-danube-3-4b's G 4 / D 120 and gemma3-4b's G 2 / D 256).  The
// scaled Q block lives in shared memory in q's type; K and V tiles of 64
// positions are staged in shared memory with 16-byte loads (the K row
// stride padded to an odd number of 16-byte units, so the 16-byte row reads
// of a warp's lanes hit distinct banks).  Each tile runs as two halves of 32
// positions: lane j scores position j against the warp's RW rows (K row
// from shared memory, Q broadcast), a warp max / sum per row updates m and
// l (lane r holds row r's m and l), p goes to a per-row shared buffer, and
// each lane accumulates D / 32 head dims of every row in registers
// (acc[RW][DL]), V read along D.  Not yet done: tensor cores (mma/wgmma),
// cp.async/TMA double buffering, warp specialisation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int BK = 64;                 // key positions per tile
constexpr int HALF = 32;               // positions per online-softmax step
constexpr int MAX_SMEM = 232448;       // dynamic shared memory of one CTA
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;

__device__ inline float to_f32(float x) { return x; }
__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline float from_f32(float x, float*) { return x; }
__device__ inline __nv_bfloat16 from_f32(float x, __nv_bfloat16*) {
  return __float2bfloat16_rn(x);
}
template <typename T> __device__ inline T cast(float x) {
  return from_f32(x, (T*)nullptr);
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

// elements of T in one 16-byte vector
template <typename T> __host__ __device__ constexpr int vec() {
  return 16 / (int)sizeof(T);
}

// K/V row stride in elements: D rounded to 16-byte units, made odd
template <typename T> __host__ __device__ inline int kv_stride(int D) {
  int units = D * (int)sizeof(T) / 16;
  if (units % 2 == 0) units += 1;
  return units * (16 / (int)sizeof(T));
}

template <typename T, int RW>
__host__ __device__ inline size_t smem_bytes(int D) {
  const int R = WARPS * RW;
  return sizeof(float) * (size_t)R * HALF + sizeof(T) * (size_t)R * D
      + 2 * sizeof(T) * (size_t)BK * kv_stride<T>(D);
}

// grid (n_qblocks, KH, B); RW rows per warp, DL = ceil(D / 32) head dims
// per lane.  Row r of the CTA is query position q0 + r / G, head kh*G + r%G.
template <typename T, int RW, int DL>
__global__ void __launch_bounds__(THREADS, 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv,
             int H, int KH, int D, int BQ, int causal, int window,
             int q_offset, float scale_q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int R = WARPS * RW;
  constexpr int V = vec<T>();
  const int G = H / KH;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = warp * RW;
  const int DV = D / V;
  const int ks_stride = kv_stride<T>(D);
  float* ps = reinterpret_cast<float*>(smem_raw);                 // [R][32]
  T* qs = reinterpret_cast<T*>(ps + R * HALF);                    // [R][D]
  T* ks = qs + (size_t)R * D;                                     // [BK][st]
  T* vs = ks + (size_t)BK * ks_stride;                            // [BK][st]

  // the scaled Q block, rounded to T as the plain version rounds q * scale
  for (int i = tid; i < R * DV; i += THREADS) {
    const int r = i / DV, c = i - r * DV;
    const int qi = r / G, g = r - qi * G;
    T* dst = qs + (size_t)r * D + c * V;
    if (qi < BQ && q0 + qi < Sq) {
      const T* src = q + (((size_t)b * Sq + q0 + qi) * H + kh * G + g) * D
          + c * V;
      uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) dst[j] = cast<T>(to_f32(e[j]) * scale_q);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) dst[j] = cast<T>(0.f);
    }
  }

  // key positions any row of this block can see: [lo, hi)
  const int q_last = min(q0 + BQ, Sq) - 1;
  int lo = 0, hi = Skv;
  if (causal) hi = min(hi, q_offset + q_last + 1);
  if (window > 0) lo = max(0, q_offset + q0 - window + 1);

  float acc[RW][DL];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[r][i] = 0.f;
  float m_reg = NEG_INF, l_reg = 0.f;   // lane r: row row0 + r

  for (int t0 = (lo / BK) * BK; t0 < hi; t0 += BK) {
    __syncthreads();                    // the previous tile is consumed
    for (int i = tid; i < BK * DV; i += THREADS) {
      const int j = i / DV, c = i - j * DV;
      const int t = t0 + j;
      uint4 kr = make_uint4(0, 0, 0, 0), vr = kr;
      if (t < Skv) {
        const size_t off = (((size_t)b * Skv + t) * KH + kh) * D + c * V;
        kr = __ldg(reinterpret_cast<const uint4*>(k + off));
        vr = __ldg(reinterpret_cast<const uint4*>(v + off));
      }
      *reinterpret_cast<uint4*>(ks + (size_t)j * ks_stride + c * V) = kr;
      *reinterpret_cast<uint4*>(vs + (size_t)j * ks_stride + c * V) = vr;
    }
    __syncthreads();

#pragma unroll 1
    for (int h = 0; h < BK / HALF; ++h) {
      const int jj = h * HALF + lane;
      const int t = t0 + jj;
      // scores of position t against the warp's rows
      float s[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r) s[r] = 0.f;
      const T* krow = ks + (size_t)jj * ks_stride;
      for (int c = 0; c < DV; ++c) {
        float kv[V];
        {
          uint4 raw = *reinterpret_cast<const uint4*>(krow + c * V);
          const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int j = 0; j < V; ++j) kv[j] = to_f32(e[j]);
        }
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          uint4 raw = *reinterpret_cast<const uint4*>(
              qs + (size_t)(row0 + r) * D + c * V);
          const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int j = 0; j < V; ++j) s[r] = fmaf(to_f32(e[j]), kv[j], s[r]);
        }
      }
      // online softmax per row; p rounded to T into the row's buffer
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int qpos = q_offset + q0 + (row0 + r) / G;
        const bool valid = t < Skv && t >= lo && t < hi
            && (!causal || t <= qpos) && (window <= 0 || t > qpos - window);
        const float sv = valid ? s[r] : NEG_INF;
        const float m_old = __shfl_sync(FULL, m_reg, r);
        const float m_new = fmaxf(m_old, warp_max(sv));
        const float p = valid ? expf(sv - m_new) : 0.f;
        const float corr = expf(m_old - m_new);
        const float psum = warp_sum(p);
        if (lane == r) {
          m_reg = m_new;
          l_reg = l_reg * corr + psum;
        }
        ps[(row0 + r) * HALF + lane] = to_f32(cast<T>(p));
#pragma unroll
        for (int i = 0; i < DL; ++i) acc[r][i] *= corr;
      }
      __syncwarp();
      // acc += p . V over the half's 32 positions, four at a time
#pragma unroll 1
      for (int j4 = 0; j4 < HALF; j4 += 4) {
        float vv[4][DL];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const T* vrow = vs + (size_t)(h * HALF + j4 + u) * ks_stride;
#pragma unroll
          for (int i = 0; i < DL; ++i) {
            const int d = lane + 32 * i;
            vv[u][i] = d < D ? to_f32(vrow[d]) : 0.f;
          }
        }
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const float4 p4 = *reinterpret_cast<const float4*>(
              ps + (row0 + r) * HALF + j4);
#pragma unroll
          for (int i = 0; i < DL; ++i) {
            float a = acc[r][i];
            a = fmaf(p4.x, vv[0][i], a);
            a = fmaf(p4.y, vv[1][i], a);
            a = fmaf(p4.z, vv[2][i], a);
            a = fmaf(p4.w, vv[3][i], a);
            acc[r][i] = a;
          }
        }
      }
      __syncwarp();                     // the buffer is free for the next half
    }
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const float l = __shfl_sync(FULL, l_reg, r);
    const int row = row0 + r;
    const int qi = row / G, g = row - qi * G;
    if (qi >= BQ || q0 + qi >= Sq) continue;
    T* dst = out + (((size_t)b * Sq + q0 + qi) * H + kh * G + g) * D;
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) dst[d] = cast<T>(acc[r][i] / denom);
    }
  }
}

template <typename T, int RW, int DL>
int launch_inst(const void* q, const void* k, const void* v, void* out, int B,
                int Sq, int Skv, int H, int KH, int D, int causal, int window,
                int q_offset, float scale_q, cudaStream_t stream) {
  const int G = H / KH;
  const int BQ = WARPS * RW / G;
  const size_t smem = smem_bytes<T, RW>(D);
  // once per instance, at its largest layout (D = 32 * DL) or the card's
  // limit, on the device of its first launch
  static const int smem_max = (int)(smem_bytes<T, RW>(32 * DL) < MAX_SMEM
                                        ? smem_bytes<T, RW>(32 * DL)
                                        : MAX_SMEM);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<T, RW, DL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_max);
  if (attr != cudaSuccess) return (int)attr;
  if (BQ < 1 || smem > (size_t)smem_max) return (int)cudaErrorInvalidValue;
  const dim3 grid((Sq + BQ - 1) / BQ, KH, B);
  flash_kernel<T, RW, DL><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, KH, D, BQ,
      causal, window, q_offset, scale_q);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int KH, int D, int causal, int window,
           int q_offset, float scale_q, cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KH <= 0 || H % KH != 0)
    return (int)cudaErrorInvalidValue;
#define INST(RW, DL)                                                          \
  return launch_inst<T, RW, DL>(q, k, v, out, B, Sq, Skv, H, KH, D, causal,   \
                                window, q_offset, scale_q, stream)
  switch (D) {
    case 16: INST(16, 1);
    case 96: INST(16, 3);
    case 120:
    case 128: INST(16, 4);
    case 256: INST(8, 8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef INST
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).  q and out
// (B, Sq, H, D), k and v (B, Skv, KH, D), contiguous, 16-byte aligned;
// D in {16, 96, 120, 128, 256}.  scale_q is d**-0.5 rounded to q's type.
// Launches on ``stream``; allocates nothing.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Skv, int H, int KH, int D,
                                      int causal, int window, int q_offset,
                                      float scale_q, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, Sq, Skv, H, KH, D, causal, window,
                         q_offset, scale_q, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, KH, D, causal,
                                 window, q_offset, scale_q, st);
  return (int)cudaErrorInvalidValue;
}
