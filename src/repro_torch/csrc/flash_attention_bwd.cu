// Flash attention backward: the gradient of the forward in
// flash_attention.cu, q (B, Sq, H, D) against k, v (B, Skv, KH, D), causal
// or not, with a sliding window, q_offset, GQA groups and Sq != Skv.
//
// Replaces no TPU kernel: the JAX model takes this gradient by autodiff of
// the plain jnp function (repro/models/attention.py: flash_attention_jnp),
// which its training path runs; the port's counterpart of that function on
// the card is the hand-written forward, so its gradient is a kernel too.
//
// The FlashAttention-2 form, from the forward's per-row log-sum-exp
// lse = m + log(l) (float32, (B, H, Sq)) and its output O:
//   S = (q * scale rounded to T) . K^T        (float32 sums)
//   P = exp(S - lse), 0 where masked
//   Delta = rowsum(dO o O)
//   dV = P^T . dO;  dP = dO . V^T;  dS = P o (dP - Delta)
//   dQ = scale * (dS . K);  dK = dS^T . (q * scale)
// P and dS are rounded to T before their products, as the forward rounds
// p; every sum is float32.  dQ rounds twice, as the JAX gradient of
// ``q * scale`` does: the product dS.K to T, then times scale to T.  A row
// with no visible position (forward output 0) has every P = 0, so it gets
// and gives zero gradients.
//
// Deterministic, with no atomics: two kernels, each owning its outputs.
//   bwd_dq_kernel: one CTA per (block of query rows, kv head, sequence),
//     the rows of the forward's layout (row r = query position q0 + r / G,
//     head kh*G + r % G), 8 warps of 8 rows.  Its prologue computes Delta
//     of its rows and writes it (scratch, (B, H, Sq)); then it loops over
//     the visible key tiles of 32 positions: lane j scores position j
//     against the warp's rows (S and dP), dS goes to a per-row shared
//     buffer, and each lane accumulates D / 32 head dims of dQ.
//   bwd_dkv_kernel: one CTA per (block of 64 key positions, kv head,
//     sequence), 8 warps of 8 positions, launched after the first (it reads
//     Delta).  It loops over the query rows that can see the block (every
//     head of the GQA group, position-major), 32 rows a tile: lane j
//     scores row j against the warp's positions, P and dS go to shared
//     buffers, and each lane accumulates D / 32 head dims of dK and dV.
//     The G heads of a group are summed in this one fixed order.
//
// bfloat16 at D <= 128 runs the same two kernels on the tensor cores
// (bwd_dq_tc_kernel, bwd_dkv_tc_kernel): 4 warps of 16 rows (dQ: query
// rows; dK/dV: key positions), mma.sync m16n8k16 bf16 x bf16 -> float32
// with ldmatrix operands, the forward's fragment layout.  dQ: S = Q.K^T and
// dP = dO.V^T as the forward's Q.K^T step over key tiles of 64, dS formed
// in the accumulator fragments and reused, rounded to bf16, as the A
// operand of dQ += dS.K (K by .trans ldmatrix, the forward's P.V step).
// dK/dV: S^T = K.Q^T and dP^T = V.dO^T over query-row tiles of 32, then
// dV += P^T.dO and dK += dS^T.(q * scale) the same way.  Every product is
// bf16 x bf16, exact in float32, so the result is the CUDA-core one's up to
// the order of the float32 sums.  The tiles each CTA streams (K and V in
// dQ; the scaled Q rows, dO, lse and Delta in dK/dV) arrive by cp.async,
// double buffered, as in the forward; the dQ kernel leaves the scaled Q
// rows it forms in a scratch buffer for the dK/dV kernel.  D 256 and
// float32 run on the CUDA cores.
//
// What bounds it on the H100: operations.  Five products of 2*D
// operations per (query row, visible key position) pair, at the bf16
// tensor-core rate.  Not yet done: wgmma, TMA, warp specialisation, and
// an even split of the causal work (the dK/dV CTA of the first key block
// walks every query row).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RW = 8;                  // rows (dQ) or positions (dK, dV) a warp
constexpr int ROWS = WARPS * RW;       // 64 a CTA
constexpr int BK = 32;                 // key positions per tile (dQ)
constexpr int QT = 32;                 // query rows per tile (dK, dV)
constexpr int MAX_SMEM = 232448;       // dynamic shared memory of one CTA
constexpr unsigned FULL = 0xffffffffu;

__device__ inline float to_f32(float x) { return x; }
__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline float from_f32(float x, float*) { return x; }
__device__ inline __nv_bfloat16 from_f32(float x, __nv_bfloat16*) {
  return __float2bfloat16_rn(x);
}
template <typename T> __device__ inline T cast(float x) {
  return from_f32(x, (T*)nullptr);
}
// x rounded to T and back
template <typename T> __device__ inline float round_to(float x) {
  return to_f32(cast<T>(x));
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

// shared row stride in elements: D rounded to 16-byte units, made odd, so
// 32 lanes reading 16 bytes of 32 different rows hit distinct banks
template <typename T> __host__ __device__ inline int row_stride(int D) {
  int units = D * (int)sizeof(T) / 16;
  if (units % 2 == 0) units += 1;
  return units * (16 / (int)sizeof(T));
}

template <typename T> __host__ __device__ inline size_t dq_smem(int D) {
  const size_t st = row_stride<T>(D);
  return sizeof(float) * ROWS * BK + sizeof(T) * st * (2 * ROWS + 2 * BK);
}

template <typename T> __host__ __device__ inline size_t dkv_smem(int D) {
  const size_t st = row_stride<T>(D);
  return sizeof(T) * st * (2 * ROWS + 2 * QT)
      + sizeof(float) * (2 * ROWS * QT + 2 * QT);
}

template <typename T>
__device__ inline uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// q * scale rounded to T, in place in a 16-byte vector
template <typename T>
__device__ inline void scale_vec(uint4& raw, float scale_q) {
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < vec<T>(); ++j) e[j] = cast<T>(to_f32(e[j]) * scale_q);
}

__device__ inline bool visible(int t, int qpos, int Skv, int causal,
                               int window) {
  return t < Skv && (!causal || t <= qpos)
      && (window <= 0 || t > qpos - window);
}

// grid (n_qblocks, KH, B); DL = ceil(D / 32) head dims per lane
template <typename T, int DL>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ o,
              const T* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ delta, T* __restrict__ dq, int Sq, int Skv,
              int H, int KH, int D, int BQ, int causal, int window,
              int q_offset, float scale_q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int V = vec<T>();
  const int G = H / KH;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = warp * RW;
  const int DV = D / V;
  const int st = row_stride<T>(D);
  float* dsb = reinterpret_cast<float*>(smem_raw);             // [ROWS][BK]
  T* qs = reinterpret_cast<T*>(dsb + ROWS * BK);               // [ROWS][st]
  T* dos = qs + (size_t)ROWS * st;                             // [ROWS][st]
  T* ks = dos + (size_t)ROWS * st;                             // [BK][st]
  T* vs = ks + (size_t)BK * st;                                // [BK][st]

  // the scaled Q rows (rounded to T as the forward rounds them) and dO
  for (int i = tid; i < ROWS * DV; i += THREADS) {
    const int r = i / DV, c = i - r * DV;
    const int qi = r / G, g = r - qi * G;
    uint4 qr = make_uint4(0, 0, 0, 0), dr = qr;
    if (qi < BQ && q0 + qi < Sq) {
      const size_t off =
          (((size_t)b * Sq + q0 + qi) * H + kh * G + g) * D + c * V;
      qr = load16(q + off);
      dr = load16(dout + off);
      scale_vec<T>(qr, scale_q);
    }
    *reinterpret_cast<uint4*>(qs + (size_t)r * st + c * V) = qr;
    *reinterpret_cast<uint4*>(dos + (size_t)r * st + c * V) = dr;
  }
  __syncthreads();

  // Delta and lse of the warp's rows: lane r holds row row0 + r's
  float delta_reg = 0.f, lse_reg = 0.f;
  bool live[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = row0 + r;
    const int qi = row / G, g = row - qi * G;
    live[r] = qi < BQ && q0 + qi < Sq;
    if (!live[r]) continue;              // uniform across the warp
    const size_t base = ((size_t)b * Sq + q0 + qi) * H + kh * G + g;
    float part = 0.f;
    for (int d = lane; d < D; d += 32)
      part = fmaf(to_f32(dos[(size_t)row * st + d]), to_f32(o[base * D + d]),
                  part);
    const float dl = warp_sum(part);
    const size_t li = ((size_t)b * H + kh * G + g) * Sq + q0 + qi;
    if (lane == r) {
      delta_reg = dl;
      lse_reg = lse[li];
    }
    if (lane == 0) delta[li] = dl;
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

  for (int t0 = (lo / BK) * BK; t0 < hi; t0 += BK) {
    __syncthreads();                    // the previous tile is consumed
    for (int i = tid; i < BK * DV; i += THREADS) {
      const int j = i / DV, c = i - j * DV;
      const int t = t0 + j;
      uint4 kr = make_uint4(0, 0, 0, 0), vr = kr;
      if (t < Skv) {
        const size_t off = (((size_t)b * Skv + t) * KH + kh) * D + c * V;
        kr = load16(k + off);
        vr = load16(v + off);
      }
      *reinterpret_cast<uint4*>(ks + (size_t)j * st + c * V) = kr;
      *reinterpret_cast<uint4*>(vs + (size_t)j * st + c * V) = vr;
    }
    __syncthreads();

    // S and dP of position t0 + lane against the warp's rows
    const int t = t0 + lane;
    float s[RW], dp[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) s[r] = dp[r] = 0.f;
    const T* krow = ks + (size_t)lane * st;
    const T* vrow = vs + (size_t)lane * st;
    for (int c = 0; c < DV; ++c) {
      float kv[V], vv[V];
      {
        uint4 kr = *reinterpret_cast<const uint4*>(krow + c * V);
        uint4 vr = *reinterpret_cast<const uint4*>(vrow + c * V);
        const T* ke = reinterpret_cast<const T*>(&kr);
        const T* ve = reinterpret_cast<const T*>(&vr);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          kv[j] = to_f32(ke[j]);
          vv[j] = to_f32(ve[j]);
        }
      }
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        uint4 qr = *reinterpret_cast<const uint4*>(
            qs + (size_t)(row0 + r) * st + c * V);
        uint4 dr = *reinterpret_cast<const uint4*>(
            dos + (size_t)(row0 + r) * st + c * V);
        const T* qe = reinterpret_cast<const T*>(&qr);
        const T* de = reinterpret_cast<const T*>(&dr);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          s[r] = fmaf(to_f32(qe[j]), kv[j], s[r]);
          dp[r] = fmaf(to_f32(de[j]), vv[j], dp[r]);
        }
      }
    }
    // dS = P o (dP - Delta), rounded to T, into the row's buffer
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int qpos = q_offset + q0 + (row0 + r) / G;
      const float l_r = __shfl_sync(FULL, lse_reg, r);
      const float d_r = __shfl_sync(FULL, delta_reg, r);
      const bool ok = live[r] && visible(t, qpos, Skv, causal, window);
      const float p = ok ? expf(s[r] - l_r) : 0.f;
      dsb[(row0 + r) * BK + lane] = round_to<T>(p * (dp[r] - d_r));
    }
    __syncwarp();
    // dQ += dS . K over the tile's positions, two at a time
#pragma unroll 1
    for (int j2 = 0; j2 < BK; j2 += 2) {
      float kk[2][DL];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int i = 0; i < DL; ++i) {
          const int d = lane + 32 * i;
          kk[u][i] = d < D ? to_f32(ks[(size_t)(j2 + u) * st + d]) : 0.f;
        }
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(dsb + (row0 + r) * BK + j2);
#pragma unroll
        for (int i = 0; i < DL; ++i)
          acc[r][i] = fmaf(d2.y, kk[1][i], fmaf(d2.x, kk[0][i], acc[r][i]));
      }
    }
    __syncwarp();                       // the buffer is free for the next tile
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    if (!live[r]) continue;
    const int row = row0 + r;
    const int qi = row / G, g = row - qi * G;
    T* dst = dq + (((size_t)b * Sq + q0 + qi) * H + kh * G + g) * D;
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) dst[d] = cast<T>(round_to<T>(acc[r][i]) * scale_q);
    }
  }
}

// grid (n_kvblocks, KH, B)
template <typename T, int DL>
__global__ void __launch_bounds__(THREADS)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int H,
               int KH, int D, int causal, int window, int q_offset,
               float scale_q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int V = vec<T>();
  const int G = H / KH;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = warp * RW;             // the warp's positions in the block
  const int DV = D / V;
  const int st = row_stride<T>(D);
  T* kb = reinterpret_cast<T*>(smem_raw);                      // [ROWS][st]
  T* vb = kb + (size_t)ROWS * st;                              // [ROWS][st]
  T* qt = vb + (size_t)ROWS * st;                              // [QT][st]
  T* dot = qt + (size_t)QT * st;                               // [QT][st]
  float* pb = reinterpret_cast<float*>(dot + (size_t)QT * st); // [ROWS][QT]
  float* db = pb + ROWS * QT;                                  // [ROWS][QT]
  float* lt = db + ROWS * QT;                                  // [QT]
  float* dt = lt + QT;                                         // [QT]

  for (int i = tid; i < ROWS * DV; i += THREADS) {
    const int j = i / DV, c = i - j * DV;
    const int t = k0 + j;
    uint4 kr = make_uint4(0, 0, 0, 0), vr = kr;
    if (t < Skv) {
      const size_t off = (((size_t)b * Skv + t) * KH + kh) * D + c * V;
      kr = load16(k + off);
      vr = load16(v + off);
    }
    *reinterpret_cast<uint4*>(kb + (size_t)j * st + c * V) = kr;
    *reinterpret_cast<uint4*>(vb + (size_t)j * st + c * V) = vr;
  }

  // query positions i that can see some position of the block: [i_lo, i_hi)
  const int k_last = min(k0 + ROWS, Skv) - 1;
  int i_lo = 0, i_hi = Sq;
  if (causal) i_lo = max(0, k0 - q_offset);
  if (window > 0) i_hi = min(Sq, k_last + window - q_offset);
  const int rho_end = i_hi * G;

  float dka[RW][DL], dva[RW][DL];
#pragma unroll
  for (int u = 0; u < RW; ++u)
#pragma unroll
    for (int i = 0; i < DL; ++i) dka[u][i] = dva[u][i] = 0.f;

  for (int r0 = i_lo * G; r0 < rho_end; r0 += QT) {
    __syncthreads();                    // the previous tile is consumed
    for (int i = tid; i < QT * DV; i += THREADS) {
      const int rr = i / DV, c = i - rr * DV;
      const int rho = r0 + rr;
      uint4 qr = make_uint4(0, 0, 0, 0), dr = qr;
      if (rho < rho_end) {
        const int qi = rho / G, g = rho - qi * G;
        const size_t off = (((size_t)b * Sq + qi) * H + kh * G + g) * D + c * V;
        qr = load16(q + off);
        dr = load16(dout + off);
        scale_vec<T>(qr, scale_q);
      }
      *reinterpret_cast<uint4*>(qt + (size_t)rr * st + c * V) = qr;
      *reinterpret_cast<uint4*>(dot + (size_t)rr * st + c * V) = dr;
    }
    if (tid < QT) {
      const int rho = r0 + tid;
      float l = 0.f, dl = 0.f;
      if (rho < rho_end) {
        const int qi = rho / G, g = rho - qi * G;
        const size_t li = ((size_t)b * H + kh * G + g) * Sq + qi;
        l = lse[li];
        dl = delta[li];
      }
      lt[tid] = l;
      dt[tid] = dl;
    }
    __syncthreads();

    // S and dP of row r0 + lane against the warp's positions
    const int rho = r0 + lane;
    const bool live = rho < rho_end;
    const int qpos = q_offset + rho / G;
    float s[RW], dp[RW];
#pragma unroll
    for (int u = 0; u < RW; ++u) s[u] = dp[u] = 0.f;
    const T* qrow = qt + (size_t)lane * st;
    const T* drow = dot + (size_t)lane * st;
    for (int c = 0; c < DV; ++c) {
      float qv[V], dv_[V];
      {
        uint4 qr = *reinterpret_cast<const uint4*>(qrow + c * V);
        uint4 dr = *reinterpret_cast<const uint4*>(drow + c * V);
        const T* qe = reinterpret_cast<const T*>(&qr);
        const T* de = reinterpret_cast<const T*>(&dr);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          qv[j] = to_f32(qe[j]);
          dv_[j] = to_f32(de[j]);
        }
      }
#pragma unroll
      for (int u = 0; u < RW; ++u) {
        uint4 kr = *reinterpret_cast<const uint4*>(
            kb + (size_t)(c0 + u) * st + c * V);
        uint4 vr = *reinterpret_cast<const uint4*>(
            vb + (size_t)(c0 + u) * st + c * V);
        const T* ke = reinterpret_cast<const T*>(&kr);
        const T* ve = reinterpret_cast<const T*>(&vr);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          s[u] = fmaf(qv[j], to_f32(ke[j]), s[u]);
          dp[u] = fmaf(dv_[j], to_f32(ve[j]), dp[u]);
        }
      }
    }
    const float l_r = lt[lane], d_r = dt[lane];
#pragma unroll
    for (int u = 0; u < RW; ++u) {
      const int t = k0 + c0 + u;
      const bool ok = live && visible(t, qpos, Skv, causal, window);
      const float p = ok ? expf(s[u] - l_r) : 0.f;
      pb[(c0 + u) * QT + lane] = round_to<T>(p);
      db[(c0 + u) * QT + lane] = round_to<T>(p * (dp[u] - d_r));
    }
    __syncwarp();
    // dV += P^T . dO and dK += dS^T . (q * scale) over the tile's rows
#pragma unroll 1
    for (int j2 = 0; j2 < QT; j2 += 2) {
      float dd[2][DL], qq[2][DL];
#pragma unroll
      for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int i = 0; i < DL; ++i) {
          const int d = lane + 32 * i;
          const size_t at = (size_t)(j2 + w) * st + d;
          dd[w][i] = d < D ? to_f32(dot[at]) : 0.f;
          qq[w][i] = d < D ? to_f32(qt[at]) : 0.f;
        }
#pragma unroll
      for (int u = 0; u < RW; ++u) {
        const float2 p2 =
            *reinterpret_cast<const float2*>(pb + (c0 + u) * QT + j2);
        const float2 s2 =
            *reinterpret_cast<const float2*>(db + (c0 + u) * QT + j2);
#pragma unroll
        for (int i = 0; i < DL; ++i) {
          dva[u][i] = fmaf(p2.y, dd[1][i], fmaf(p2.x, dd[0][i], dva[u][i]));
          dka[u][i] = fmaf(s2.y, qq[1][i], fmaf(s2.x, qq[0][i], dka[u][i]));
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int u = 0; u < RW; ++u) {
    const int t = k0 + c0 + u;
    if (t >= Skv) continue;
    const size_t base = (((size_t)b * Skv + t) * KH + kh) * D;
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) {
        dk[base + d] = cast<T>(dka[u][i]);
        dv[base + d] = cast<T>(dva[u][i]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores (D <= 128): mma.sync m16n8k16 bf16 x bf16 ->
// float32 with ldmatrix operands, the forward's fragment layout (lane l of a
// warp holds rows l/4 and l/4 + 8 and columns 2*(l%4), 2*(l%4)+1 of each
// 8-wide n-tile).  Shared rows are D rounded up to 16 (zeros past D, so the
// k-steps over D see zero products there) plus 8 elements: an odd number of
// 16-byte units, so the eight rows of an ldmatrix hit distinct banks.

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_ROWS = 16 * TC_WARPS;   // query rows (dQ) or positions (dK, dV)
constexpr int TC_BK = 64;                // key positions per tile (dQ)
constexpr int TC_QT = 32;                // query rows per tile (dK, dV)

__host__ __device__ constexpr int tc_dp(int D) { return (D + 15) / 16 * 16; }
__host__ __device__ constexpr int tc_stride(int D) { return tc_dp(D) + 8; }
// dQ: the scaled Q and dO rows, two K and two V tiles, lse and Delta
__host__ __device__ constexpr size_t tc_dq_smem(int D) {
  return sizeof(__nv_bfloat16) * (size_t)tc_stride(D) * (2 * TC_ROWS + 4 * TC_BK)
      + sizeof(float) * 2 * TC_ROWS;
}
// dK/dV: the K and V rows, two tiles each of scaled Q and dO rows, with
// their lse and Delta
__host__ __device__ constexpr size_t tc_dkv_smem(int D) {
  return sizeof(__nv_bfloat16) * (size_t)tc_stride(D) * (2 * TC_ROWS + 4 * TC_QT)
      + sizeof(float) * 4 * TC_QT;
}

__device__ inline unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ inline void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ inline void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ inline void ldsm_x2_t(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ inline void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ inline unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// acc[NT][4] (16 rows x 8*NT columns) += A (16 x DP, rows of `a_rows`) .
// B^T with B's rows the NT*8 rows of `b_rows` (both row-major in shared
// memory, stride ST): the forward's Q.K^T step
template <int NT, int KSTEPS, int ST>
__device__ inline void mma_abt(float (&acc)[NT][4],
                               const __nv_bfloat16* a_rows,
                               const __nv_bfloat16* b_rows, int lane) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    unsigned a[4];
    ldsm_x4(a, a_rows + (lane & 15) * ST + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      unsigned b[4];
      ldsm_x4(b, b_rows + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * ST
                     + kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// out[DT][4] (16 rows x D) += X (16 x 16*KT, bf16 fragments from the
// float32 accumulator x[2*KT][4]) . B (16*KT rows of `b_rows`, D columns):
// the forward's P.V step
template <int KT, int DT, int ST>
__device__ inline void mma_xb(float (&out)[DT][4], const float (&x)[2 * KT][4],
                              const __nv_bfloat16* b_rows, int lane) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    unsigned a[4];
    a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    const __nv_bfloat16* row =
        b_rows + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ST;
#pragma unroll
    for (int np = 0; np < DT / 2; ++np) {
      unsigned b[4];
      ldsm_x4_t(b, row + np * 16 + (lane >> 4) * 8);
      mma_bf16(out[2 * np], a, b[0], b[1]);
      mma_bf16(out[2 * np + 1], a, b[2], b[3]);
    }
    if (DT & 1) {
      unsigned b[2];
      ldsm_x2_t(b, row + (DT - 1) * 8);
      mma_bf16(out[DT - 1], a, b[0], b[1]);
    }
  }
}

// one row of D bf16 from global into shared (zeros past D up to DP), the
// row scaled by `scale` (rounded to bf16) when scale != 0; `src` null
// writes zeros.  One 16-byte vector per call.
template <int D, int ST>
__device__ inline void tc_row_vec(__nv_bfloat16* dst_row,
                                  const __nv_bfloat16* src_row, int c,
                                  float scale) {
  uint4 raw = make_uint4(0, 0, 0, 0);
  if (src_row != nullptr && c * 8 < D) {
    raw = __ldg(reinterpret_cast<const uint4*>(src_row + c * 8));
    if (scale != 0.f) {
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * scale);
    }
  }
  *reinterpret_cast<uint4*>(dst_row + c * 8) = raw;
}

// 16-byte global -> shared copy; bytes = 0 writes 16 zero bytes
__device__ inline void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
// 4-byte global -> shared copy; bytes = 0 writes 4 zero bytes
__device__ inline void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ inline void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ inline void cp_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// columns D..DP-1 of `rows` shared rows: zeros (the copies never write them)
template <int D, int ST>
__device__ inline void tc_zero_tail(__nv_bfloat16* base, int rows, int tid) {
  constexpr int DP = tc_dp(D);
  if (DP > D) {
    for (int r = tid; r < rows; r += TC_THREADS)
#pragma unroll
      for (int c = D; c < DP; c += 8)
        *reinterpret_cast<uint4*>(base + r * ST + c) = make_uint4(0, 0, 0, 0);
  }
}

// grid (n_qblocks, KH, B): 4 warps of 16 query rows (the forward's layout,
// row r = position q0 + r / G, head kh*G + r % G).  Writes the scaled Q
// rows it loads to qs_g ((B, Sq, H, D) scratch) for the dK/dV kernel.  K
// and V tiles of 64 positions by cp.async, double buffered.
template <int D>
__global__ void __launch_bounds__(TC_THREADS)
bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const __nv_bfloat16* __restrict__ o,
                 const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ qs_g,
                 __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H,
                 int KH, int BQ, int causal, int window, int q_offset,
                 float scale_q) {
  constexpr int DP = tc_dp(D), ST = tc_stride(D);
  constexpr int KSTEPS = DP / 16, NT = TC_BK / 8, DT = D / 8;
  constexpr int DV = DP / 8;               // 16-byte vectors of a shared row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [ROWS][ST]
  __nv_bfloat16* ds_ = qs + TC_ROWS * ST;                         // dO rows
  __nv_bfloat16* ks = ds_ + TC_ROWS * ST;                         // [2][BK][ST]
  __nv_bfloat16* vs = ks + 2 * TC_BK * ST;                        // [2][BK][ST]
  float* lse_s = reinterpret_cast<float*>(vs + 2 * TC_BK * ST);   // [ROWS]
  float* dl_s = lse_s + TC_ROWS;                                  // [ROWS]
  const int G = H / KH;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // the longest first
  const int q_end = min(q0 + BQ, Sq);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tig = lane & 3;

  for (int i = tid; i < TC_ROWS * DV; i += TC_THREADS) {
    const int r = i / DV, c = i - r * DV;
    const int qi = r / G, g = r - qi * G;
    const bool live = q0 + qi < q_end;
    const size_t off = (((size_t)b * Sq + q0 + qi) * H + kh * G + g) * D;
    tc_row_vec<D, ST>(qs + r * ST, live ? q + off : nullptr, c, scale_q);
    tc_row_vec<D, ST>(ds_ + r * ST, live ? dout + off : nullptr, c, 0.f);
    if (live && c < DT)
      *reinterpret_cast<uint4*>(qs_g + off + c * 8) =
          *reinterpret_cast<const uint4*>(qs + r * ST + c * 8);
  }
  tc_zero_tail<D, ST>(ks, 4 * TC_BK, tid);   // both K and both V buffers
  // Delta = rowsum(dO o O) and lse of the CTA's rows, 16 a warp
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
    const int qi = r / G, g = r - qi * G;
    float dl = 0.f, l = 0.f;
    if (q0 + qi < q_end) {               // uniform across the warp
      const size_t row = ((size_t)b * Sq + q0 + qi) * H + kh * G + g;
      float part = 0.f;
      for (int d = lane; d < D; d += 32)
        part = fmaf(__bfloat162float(dout[row * D + d]),
                    __bfloat162float(o[row * D + d]), part);
      dl = warp_sum(part);
      const size_t li = ((size_t)b * H + kh * G + g) * Sq + q0 + qi;
      l = lse[li];
      if (lane == 0) delta[li] = dl;
    }
    if (lane == 0) {
      dl_s[r] = dl;
      lse_s[r] = l;
    }
  }
  __syncthreads();

  const int row_a = warp * 16 + (lane >> 2);
  int pos[2];
  bool act[2];
  float l_row[2], d_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row_a + 8 * h;
    act[h] = q0 + r / G < q_end;
    pos[h] = q_offset + q0 + r / G;
    l_row[h] = lse_s[r];
    d_row[h] = dl_s[r];
  }
  const int w_first = warp * 16 / G, w_last = (warp * 16 + 15) / G;
  const bool w_any = q0 + w_first < q_end;
  const int wq_lo = q_offset + q0 + w_first;
  const int wq_hi = q_offset + min(q0 + w_last, q_end - 1);

  int lo = 0, hi = Skv;
  if (causal) hi = min(hi, q_offset + q_end);
  if (window > 0) lo = max(0, q_offset + q0 - window + 1);
  const int t_first = (lo / TC_BK) * TC_BK;
  const int n_tiles = hi > t_first ? (hi - t_first + TC_BK - 1) / TC_BK : 0;

  // K and V rows t0..t0+BK-1 into buffer buf; rows past Skv are zeros
  auto issue = [&](int tile, int buf) {
    const int t0 = t_first + tile * TC_BK;
    __nv_bfloat16* kd = ks + buf * TC_BK * ST;
    __nv_bfloat16* vd = vs + buf * TC_BK * ST;
    for (int i = tid; i < TC_BK * DT; i += TC_THREADS) {
      const int j = i / DT, c = i - j * DT;
      const int t = t0 + j;
      const bool in = t < Skv;
      const size_t off =
          (((size_t)b * Skv + (in ? t : Skv - 1)) * KH + kh) * D + c * 8;
      cp_async16(kd + j * ST + c * 8, k + off, in ? 16 : 0);
      cp_async16(vd + j * ST + c * 8, v + off, in ? 16 : 0);
    }
  };

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  if (n_tiles > 0) issue(0, 0);
  cp_commit();
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) issue(it + 1, (it + 1) & 1);
    cp_commit();
    cp_wait1();                          // tile it has landed
    __syncthreads();
    const int t0 = t_first + it * TC_BK;
    const bool skip = !w_any || (causal && t0 > wq_hi)
        || (window > 0 && t0 + TC_BK - 1 <= wq_lo - window);
    if (!skip) {
      const __nv_bfloat16* kb = ks + (it & 1) * TC_BK * ST;
      const __nv_bfloat16* vb = vs + (it & 1) * TC_BK * ST;
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      mma_abt<NT, KSTEPS, ST>(s, qs + warp * 16 * ST, kb, lane);
      mma_abt<NT, KSTEPS, ST>(dp, ds_ + warp * 16 * ST, vb, lane);
      // dS = P o (dP - Delta), P = exp(S - lse), 0 where masked
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int t = t0 + 8 * j + 2 * tig + (e & 1);
          const bool ok = act[h] && visible(t, pos[h], Skv, causal, window);
          const float p = ok ? expf(s[j][e] - l_row[h]) : 0.f;
          s[j][e] = p * (dp[j][e] - d_row[h]);
        }
      // dQ += bf16(dS) . K
      mma_xb<TC_BK / 16, DT, ST>(acc, s, kb, lane);
    }
    __syncthreads();                     // buffer it & 1 is free
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!act[h]) continue;
    const int r = row_a + 8 * h;
    const int qi = r / G, g = r - qi * G;
    __nv_bfloat16* dst =
        dq + (((size_t)b * Sq + q0 + qi) * H + kh * G + g) * D + 2 * tig;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const float x0 = round_to<__nv_bfloat16>(acc[d][2 * h]) * scale_q;
      const float x1 = round_to<__nv_bfloat16>(acc[d][2 * h + 1]) * scale_q;
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * d) =
          __floats2bfloat162_rn(x0, x1);
    }
  }
}

// grid (n_kvblocks, KH, B): 4 warps of 16 key positions; loops over the
// query rows that can see the block, TC_QT a tile, position-major: the
// scaled Q rows (qs_g, from the dQ kernel), dO, lse and Delta of a tile by
// cp.async, double buffered
template <int D>
__global__ void __launch_bounds__(TC_THREADS)
bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ qs_g,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int H,
                  int KH, int causal, int window, int q_offset) {
  constexpr int DP = tc_dp(D), ST = tc_stride(D);
  constexpr int KSTEPS = DP / 16, NT = TC_QT / 8, DT = D / 8;
  constexpr int DV = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* kb = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [ROWS][ST]
  __nv_bfloat16* vb = kb + TC_ROWS * ST;                          // [ROWS][ST]
  __nv_bfloat16* qt = vb + TC_ROWS * ST;                          // [2][QT][ST]
  __nv_bfloat16* dot = qt + 2 * TC_QT * ST;                       // [2][QT][ST]
  float* lt = reinterpret_cast<float*>(dot + 2 * TC_QT * ST);     // [2][QT]
  float* dt = lt + 2 * TC_QT;                                     // [2][QT]
  const int G = H / KH;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * TC_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tig = lane & 3;

  for (int i = tid; i < TC_ROWS * DV; i += TC_THREADS) {
    const int j = i / DV, c = i - j * DV;
    const int t = k0 + j;
    const size_t off = (((size_t)b * Skv + t) * KH + kh) * D;
    tc_row_vec<D, ST>(kb + j * ST, t < Skv ? k + off : nullptr, c, 0.f);
    tc_row_vec<D, ST>(vb + j * ST, t < Skv ? v + off : nullptr, c, 0.f);
  }
  tc_zero_tail<D, ST>(qt, 4 * TC_QT, tid);   // both Q and both dO buffers

  const int k_last = min(k0 + TC_ROWS, Skv) - 1;
  int i_lo = 0, i_hi = Sq;
  if (causal) i_lo = max(0, k0 - q_offset);
  if (window > 0) i_hi = min(Sq, k_last + window - q_offset);
  const int rho_start = i_lo * G, rho_end = i_hi * G;
  const int n_tiles =
      rho_end > rho_start ? (rho_end - rho_start + TC_QT - 1) / TC_QT : 0;

  // query rows r0..r0+QT-1 of tile `tile` into buffer buf; rows past the
  // range are zeros (lse and Delta 0)
  auto issue = [&](int tile, int buf) {
    const int r0 = rho_start + tile * TC_QT;
    __nv_bfloat16* qd = qt + buf * TC_QT * ST;
    __nv_bfloat16* dd = dot + buf * TC_QT * ST;
    for (int i = tid; i < TC_QT * DT; i += TC_THREADS) {
      const int rr = i / DT, c = i - rr * DT;
      const int rho = r0 + rr;
      const bool live = rho < rho_end;
      const int qi = live ? rho / G : 0, g = live ? rho - qi * G : 0;
      const size_t off = (((size_t)b * Sq + qi) * H + kh * G + g) * D + c * 8;
      cp_async16(qd + rr * ST + c * 8, qs_g + off, live ? 16 : 0);
      cp_async16(dd + rr * ST + c * 8, dout + off, live ? 16 : 0);
    }
    if (tid < TC_QT) {
      const int rho = r0 + tid;
      const bool live = rho < rho_end;
      const int qi = live ? rho / G : 0, g = live ? rho - qi * G : 0;
      const size_t li = ((size_t)b * H + kh * G + g) * Sq + qi;
      cp_async4(lt + buf * TC_QT + tid, lse + li, live ? 4 : 0);
      cp_async4(dt + buf * TC_QT + tid, delta + li, live ? 4 : 0);
    }
  };

  // this lane's two key positions
  int t_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) t_row[h] = k0 + warp * 16 + (lane >> 2) + 8 * h;

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;

  if (n_tiles > 0) issue(0, 0);
  cp_commit();
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) issue(it + 1, (it + 1) & 1);
    cp_commit();
    cp_wait1();                          // tile it has landed
    __syncthreads();
    const int buf = it & 1;
    const int r0 = rho_start + it * TC_QT;
    const __nv_bfloat16* qb = qt + buf * TC_QT * ST;
    const __nv_bfloat16* db = dot + buf * TC_QT * ST;
    const float* lb = lt + buf * TC_QT;
    const float* dlb = dt + buf * TC_QT;
    // S^T = K . (q * scale)^T and dP^T = V . dO^T over the tile's rows
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_abt<NT, KSTEPS, ST>(s, kb + warp * 16 * ST, qb, lane);
    mma_abt<NT, KSTEPS, ST>(dp, vb + warp * 16 * ST, db, lane);
    // P^T and dS^T; column c of the tile is query row r0 + c
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int lo2 = 0; lo2 < 2; ++lo2) {
        const int c = 8 * j + 2 * tig + lo2;
        const int rho = r0 + c;
        const int qpos = q_offset + rho / G;
        const bool live = rho < rho_end;
        const float l_c = lb[c], d_c = dlb[c];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 2 * h + lo2;
          const bool ok = live
              && visible(t_row[h], qpos, Skv, causal, window);
          const float p = ok ? expf(s[j][e] - l_c) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - d_c);
        }
      }
    // dV += bf16(P^T) . dO;  dK += bf16(dS^T) . (q * scale)
    mma_xb<TC_QT / 16, DT, ST>(dva, s, db, lane);
    mma_xb<TC_QT / 16, DT, ST>(dka, dp, qb, lane);
    __syncthreads();                     // buffer it & 1 is free
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t_row[h];
    if (t >= Skv) continue;
    const size_t base = (((size_t)b * Skv + t) * KH + kh) * D + 2 * tig;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      *reinterpret_cast<__nv_bfloat162*>(dk + base + 8 * d) =
          __floats2bfloat162_rn(dka[d][2 * h], dka[d][2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + base + 8 * d) =
          __floats2bfloat162_rn(dva[d][2 * h], dva[d][2 * h + 1]);
    }
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* delta, void* dq,
              void* dk, void* dv, void* qs, int B, int Sq, int Skv, int H,
              int KH, int causal, int window, int q_offset, float scale_q,
              cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const int BQ = TC_ROWS / (H / KH);
  constexpr size_t s1 = tc_dq_smem(D), s2 = tc_dkv_smem(D);
  static_assert(s1 <= MAX_SMEM && s2 <= MAX_SMEM, "shared memory of a CTA");
  static const cudaError_t a1 = cudaFuncSetAttribute(
      bwd_dq_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)s1);
  static const cudaError_t a2 = cudaFuncSetAttribute(
      bwd_dkv_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)s2);
  if (a1 != cudaSuccess) return (int)a1;
  if (a2 != cudaSuccess) return (int)a2;
  if (BQ < 1 || qs == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 g1((Sq + BQ - 1) / BQ, KH, B);
  bwd_dq_tc_kernel<D><<<g1, TC_THREADS, s1, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(o),
      static_cast<const bf*>(dout), lse, delta, static_cast<bf*>(qs),
      static_cast<bf*>(dq), Sq, Skv, H, KH, BQ, causal, window, q_offset,
      scale_q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2((Skv + TC_ROWS - 1) / TC_ROWS, KH, B);
  bwd_dkv_tc_kernel<D><<<g2, TC_THREADS, s2, stream>>>(
      static_cast<const bf*>(qs), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, delta,
      static_cast<bf*>(dk), static_cast<bf*>(dv), Sq, Skv, H, KH, causal,
      window, q_offset);
  return (int)cudaGetLastError();
}

template <typename T, int DL>
int launch_inst(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* delta, void* dq,
                void* dk, void* dv, int B, int Sq, int Skv, int H, int KH,
                int D, int causal, int window, int q_offset, float scale_q,
                cudaStream_t stream) {
  const int G = H / KH;
  const int BQ = ROWS / G;
  const size_t s1 = dq_smem<T>(D), s2 = dkv_smem<T>(D);
  // once per instance, at its largest layout (D = 32 * DL)
  static const cudaError_t a1 = cudaFuncSetAttribute(
      bwd_dq_kernel<T, DL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dq_smem<T>(32 * DL));
  static const cudaError_t a2 = cudaFuncSetAttribute(
      bwd_dkv_kernel<T, DL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dkv_smem<T>(32 * DL));
  if (a1 != cudaSuccess) return (int)a1;
  if (a2 != cudaSuccess) return (int)a2;
  if (BQ < 1 || s1 > (size_t)MAX_SMEM || s2 > (size_t)MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const dim3 g1((Sq + BQ - 1) / BQ, KH, B);
  bwd_dq_kernel<T, DL><<<g1, THREADS, s1, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), Sq, Skv,
      H, KH, D, BQ, causal, window, q_offset, scale_q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2((Skv + ROWS - 1) / ROWS, KH, B);
  bwd_dkv_kernel<T, DL><<<g2, THREADS, s2, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, H, KH, D, causal,
      window, q_offset, scale_q);
  return (int)cudaGetLastError();
}

int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int B, int Sq, int Skv, int H, int KH,
               int D, int causal, int window, int q_offset, float scale_q,
               cudaStream_t stream) {
#define INST(DL)                                                              \
  return launch_inst<float, DL>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,  \
                                Sq, Skv, H, KH, D, causal, window, q_offset,  \
                                scale_q, stream)
  switch (D) {
    case 16: INST(1);
    case 64: INST(2);
    case 96: INST(3);
    case 120:
    case 128: INST(4);
    case 256: INST(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef INST
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; q, o, dout and dq (B, Sq, H, D), k, v,
// dk, dv (B, Skv, KH, D) of that type, contiguous, 16-byte aligned; lse and
// delta float32 (B, H, Sq), delta scratch written here; qs scratch of q's
// shape and type for the tensor-core path (bf16, D <= 128; null
// otherwise).  D in {16, 64, 96, 120, 128, 256}; scale_q is d**-0.5
// rounded to the type.  Two launches on ``stream`` (dQ and Delta, then dK
// and dV); allocates nothing.
extern "C" int flash_attention_bwd_launch(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, void* qs, int B, int Sq, int Skv, int H, int KH, int D,
    int causal, int window, int q_offset, float scale_q, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KH <= 0 || H % KH != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_f32(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H,
                      KH, D, causal, window, q_offset, scale_q, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
#define TC(DD)                                                                \
  return launch_tc<DD>(q, k, v, o, dout, lse, delta, dq, dk, dv, qs, B, Sq,   \
                       Skv, H, KH, causal, window, q_offset, scale_q, s)
  switch (D) {
    case 16: TC(16);
    case 64: TC(64);
    case 96: TC(96);
    case 120: TC(120);
    case 128: TC(128);
    case 256:     // the dK and dV accumulators outgrow the registers
      return launch_inst<__nv_bfloat16, 8>(q, k, v, o, dout, lse, delta, dq,
                                           dk, dv, B, Sq, Skv, H, KH, D,
                                           causal, window, q_offset, scale_q,
                                           s);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TC
}
