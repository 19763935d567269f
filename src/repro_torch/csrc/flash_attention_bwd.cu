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
// What bounds it on the H100: operations.  Five products of 2*D operations
// per (query row, visible key position) pair at the bf16 tensor-core rate;
// the bytes (q, k, v, O, dO, lse in, dq, dk, dv out) are a few per cent of
// that time at training lengths.  This design does seven products, not
// five: deterministic with no float atomics means two kernels that each
// own their outputs, so S and dP are formed in both.
//
// bfloat16 at D <= 128, on the tensor cores (bwd_dq_tc_kernel,
// bwd_dkv_tc_kernel): warpgroup tiles of 64 rows on wgmma (sm_90a,
// csrc/hopper.cuh), fed by TMA.  A CTA is one producer warp (in a
// warpgroup that gives its registers away with setmaxnreg) and two
// consumer warpgroups; the producer streams tiles of 64 rows through a
// ring of STAGES stages with mbarriers past the rows the CTA keeps in
// shared memory.  Every panel is 64 rows x 64 bf16 in the 128-byte
// swizzle; D 96 and 120 take a second panel whose columns past D TMA
// fills with zeros (the contraction over D needs them zero).
// P = exp2((S - lse) * log2 e), the plain version's argument S - lse.
//   bwd_dq_tc_kernel: each consumer owns 64 query rows (the forward's
//     layout, row r = position q0 + r / G, head kh*G + r % G; G that does
//     not divide 64 leaves 64 mod G dead rows of zeros).  It loads them
//     itself, q * scale rounded to bf16 (also written to a scratch for
//     dK/dV) and dO, with Delta and lse, which it also writes per query
//     tile for dK/dV.  Per streamed K/V tile: S = Qs.K^T and dP = dO.V^T
//     (both operands in shared memory), P and dS in the accumulator
//     registers, then dQ += dS.K with dS as the register A operand and K
//     as an MN-major B operand; dQ is one m64n(64 NC) accumulator.
//   bwd_dkv_tc_kernel: a CTA owns 64 key positions (K and V by TMA) and
//     streams query tiles (scaled Q, dO by a 5-d TMA box (D, G, positions)
//     that gives the row layout above; lse and Delta by a bulk copy).
//     The consumers split the work by role: consumer 0 forms S^T = K.Qs^T,
//     P^T in its accumulator registers and dV += P^T.dO; consumer 1 forms
//     dP^T = V.dO^T, takes consumer 0's float32 P^T of the tile from
//     shared memory (two buffers, named barriers), forms dS^T and dK +=
//     dS^T.Qs; both A operands from registers.  Each warpgroup holds one
//     m64n(64 NC) accumulator: with both dK and dV in one warpgroup
//     (about 238 registers) the compiler serialised every wgmma of the
//     kernel (ptxas C7512) under setmaxnreg's 240.  The G heads of a
//     group are summed in one fixed order, the tile's rows.
// Masks only where needed: each (warpgroup, tile) pair is classified once
// as empty (skipped), full (no mask) or partial (masked per element) from
// causal, window, q_offset and the real rows and keys.  Rows past Sq, dead
// rows and keys past Skv are zeros in shared memory and add nothing (a key
// past Skv is masked all the same: with a zero K row, exp(-lse) could
// overflow).
// A balanced causal schedule: a kernel's units (dQ: 128 query rows; dK/dV:
// 64 keys) are paired, unit x with unit n-1-x in CTA x, so under a causal
// mask every CTA walks about the same number of tiles (kernel.py:
// bwd_schedule).  Deterministic:
// every float32 sum runs in one order fixed by the schedule, with no
// atomics, so two launches are bit-identical.
//
// float32, and bf16 at D 256 (whose dK and dV accumulators outgrow the
// registers), run on the CUDA cores: bwd_dq_kernel, one CTA per (block of
// query rows, kv head, sequence), 8 warps of 8 rows, lane j scoring key
// position j of a tile of 32; bwd_dkv_kernel, one CTA per block of 64 key
// positions, lane j scoring query row j of a tile of 32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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
// bfloat16 on the tensor cores (D <= 128): wgmma warpgroup tiles fed by TMA.

using bf = __nv_bfloat16;
using hopper::PANEL;

constexpr int WG = 128;                  // threads of a warpgroup
constexpr int NCONS = 2;                 // consumer warpgroups a CTA
constexpr int TC_THREADS = WG * (1 + NCONS);
constexpr int TILE = 64;                 // rows of an own or a streamed tile
constexpr int STAGES = 2;                // ring stages of streamed tiles
constexpr int AUX = 2 * TILE;            // floats of a query tile's lse, Delta
constexpr int XBUF = 32 * WG * 4;        // bytes of one float32 P^T tile
constexpr int XREADY = 3, XFREE = 5;     // named barriers (two each)
constexpr float L2E = 1.4426950408889634f;
enum { TILE_EMPTY = 0, TILE_PARTIAL = 1, TILE_FULL = 2 };

// panels of a row, and k16 steps of a contraction over D
__host__ __device__ constexpr int tc_nc(int D) { return (D + 63) / 64; }
__host__ __device__ constexpr int tc_kd(int D) { return (D + 15) / 16; }
// dQ: each consumer's scaled-Q and dO panels, STAGES of K and V panels, a
// full and an empty barrier a stage, 1024 bytes to align the panels
__host__ __device__ constexpr size_t tc_dq_smem(int D) {
  return (size_t)PANEL * tc_nc(D) * (2 * NCONS + 2 * STAGES) + 16 * STAGES
      + 1024;
}
// dK/dV: the unit's K and V panels, STAGES of scaled-Q and dO panels with
// the tile's lse and Delta, two float32 P^T tiles, the ring's barriers and
// the K/V pair's
__host__ __device__ constexpr size_t tc_dkv_smem(int D) {
  return (size_t)PANEL * tc_nc(D) * (2 + 2 * STAGES) + 2 * XBUF
      + (size_t)4 * AUX * STAGES + 16 * STAGES + 16 + 1024;
}

// Real query positions [p_lo, p_hi] (q_offset added) against the 64 keys
// from t_lo: EMPTY (no visible pair), FULL (every pair visible, every key
// below Skv) or PARTIAL.  kernel.py's bwd_tile_class is this function.
__device__ inline int tile_class(int p_lo, int p_hi, int t_lo, int Skv,
                                 int causal, int window) {
  const int t_hi = t_lo + TILE - 1, te = min(t_hi, Skv - 1);
  if (p_hi < p_lo || t_lo > te) return TILE_EMPTY;
  if (causal && t_lo > p_hi) return TILE_EMPTY;
  if (window > 0 && te <= p_lo - window) return TILE_EMPTY;
  if (t_hi < Skv && (!causal || t_hi <= p_lo)
      && (window <= 0 || t_lo > p_hi - window))
    return TILE_FULL;
  return TILE_PARTIAL;
}

// The key tiles (first key, count) that dQ unit u (positions from
// u * NCONS * BQ) walks, and the query tiles (first position, count) that
// dK/dV unit u (keys from u * TILE) walks; kernel.py's bwd_schedule.
__device__ inline void dq_range(int u, int BQ, int Sq, int Skv, int causal,
                                int window, int q_offset, int& first,
                                int& n) {
  const int p_lo = q_offset + u * NCONS * BQ;
  const int p_hi = q_offset + min((u + 1) * NCONS * BQ, Sq) - 1;
  const int hi = causal ? min(Skv, p_hi + 1) : Skv;
  const int lo = window > 0 ? max(0, p_lo - window + 1) : 0;
  first = lo / TILE * TILE;
  n = lo < hi ? (hi - first + TILE - 1) / TILE : 0;
}
__device__ inline void dkv_range(int u, int BQ, int Sq, int Skv, int causal,
                                 int window, int q_offset, int& first,
                                 int& n) {
  const int t_lo = u * TILE, t_hi = min(t_lo + TILE, Skv) - 1;
  const int lo = causal ? max(0, t_lo - q_offset) : 0;
  const int hi = window > 0 ? min(Sq, t_hi + window - q_offset) : Sq;
  first = lo / BQ * BQ;
  n = lo < hi ? (hi - first + BQ - 1) / BQ : 0;
}

// descriptors of panels from `addr` (k16 steps over D: kstep(kk) added to
// a K-major one; over rows: 2048 kk bytes, 128 kk, added to an MN-major one
// spanning a row's NC panels)
__device__ inline uint64_t desc(uint32_t addr) {
  return hopper::desc_sw128(addr);
}
__device__ inline uint64_t desc_mn(uint32_t addr) {
  return hopper::desc_sw128(addr, PANEL);
}
__host__ __device__ constexpr uint32_t kstep(int kk) {
  return ((kk / 4) * PANEL + 32 * (kk % 4)) >> 4;
}

// Shared memory from its 1024-aligned base: (shared address, generic
// pointer)
__device__ inline uint32_t aligned_base(unsigned char* raw,
                                        unsigned char*& gen) {
  const uint32_t at = hopper::smem_u32(raw);
  const uint32_t base = (at + 1023) & ~1023u;
  gen = raw + (base - at);
  return base;
}

// grid (ceil(units / 2), KH, B); CTA x takes dQ units x and units-1-x of
// 128 query rows
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const bf* __restrict__ q, const bf* __restrict__ o,
                 const bf* __restrict__ dout, const float* __restrict__ lse,
                 float* __restrict__ aux, bf* __restrict__ qs_g,
                 bf* __restrict__ dq, int Sq, int Skv, int H, int KH,
                 int causal, int window, int q_offset, float scale_q) {
  constexpr int NC = tc_nc(D), KD = tc_kd(D);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* gen;
  const uint32_t base = aligned_base(smem_raw, gen);
  const uint32_t own_q = base;                            // [NCONS][NC]
  const uint32_t own_do = own_q + NCONS * NC * PANEL;     // [NCONS][NC]
  const uint32_t ring = own_do + NCONS * NC * PANEL;      // [STAGES][2][NC]
  const uint32_t full = ring + STAGES * 2 * NC * PANEL;   // [STAGES]
  const uint32_t empty = full + 8 * STAGES;               // [STAGES]
  const int G = H / KH, BQ = TILE / G;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int units = (Sq + NCONS * BQ - 1) / (NCONS * BQ);
  const int u0 = blockIdx.x, u1 = units - 1 - blockIdx.x;
  const int n_mine = u1 > u0 ? 2 : 1;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, NCONS * WG);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {                          // the producer: K and V tiles
    hopper::reg_dealloc<24>();
    if (threadIdx.x != 0) return;
    int it = 0;
    for (int m = 0; m < n_mine; ++m) {
      int first, n;
      dq_range(m ? u1 : u0, BQ, Sq, Skv, causal, window, q_offset, first, n);
      for (int j = 0; j < n; ++j, ++it) {
        const int s = it % STAGES;
        hopper::mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(full + 8 * s, 2 * NC * PANEL);
        const uint32_t kt = ring + s * 2 * NC * PANEL;
        for (int c = 0; c < NC; ++c) {
          hopper::tma_load_4d(kt + c * PANEL, &k_map, full + 8 * s, 64 * c,
                              kh, first + j * TILE, b);
          hopper::tma_load_4d(kt + (NC + c) * PANEL, &v_map, full + 8 * s,
                              64 * c, kh, first + j * TILE, b);
        }
      }
    }
    return;
  }

  hopper::reg_alloc<240>();
  const int cw = wg - 1, ct = threadIdx.x - wg * WG;
  const int warp = ct >> 5, lane = ct & 31, tig = lane & 3;
  const uint32_t my_q = own_q + cw * NC * PANEL;
  const uint32_t my_do = own_do + cw * NC * PANEL;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int r0 = warp * 16 + (lane >> 2);   // the lane's rows r0, r0 + 8
  int it = 0;
  for (int m = 0; m < n_mine; ++m) {
    const int unit = m ? u1 : u0;
    const int q0 = (unit * NCONS + cw) * BQ;   // the warpgroup's positions
    const int q_end = min(q0 + BQ, Sq);        // <= q0: no rows
    hopper::named_sync(1 + cw, WG);            // the last unit's products
    // the own rows: q * scale rounded to bf16 (also to qs_g) and dO, zeros
    // past D, past Sq and in the dead rows
    for (int i = ct; i < TILE * NC * 8; i += WG) {
      const int r = i / (NC * 8), c = i % (NC * 8);
      const int qi = r / G, g = r - qi * G;
      uint4 qv = make_uint4(0, 0, 0, 0), dv = qv;
      if (qi < BQ && q0 + qi < q_end && c * 8 < D) {
        const size_t off =
            (((size_t)b * Sq + q0 + qi) * H + kh * G + g) * D + c * 8;
        qv = __ldg(reinterpret_cast<const uint4*>(q + off));
        scale_vec<bf>(qv, scale_q);
        *reinterpret_cast<uint4*>(qs_g + off) = qv;
        dv = __ldg(reinterpret_cast<const uint4*>(dout + off));
      }
      const uint32_t at = (c / 8) * PANEL + hopper::swz(r, c % 8);
      *reinterpret_cast<uint4*>(gen + (my_q - base) + at) = qv;
      *reinterpret_cast<uint4*>(gen + (my_do - base) + at) = dv;
    }
    // Delta = rowsum(dO o O) and lse of the warp's 16 rows, to the query
    // tile's aux slot (0 for a row that is not real); the lane keeps its two
    float lse_r[2], dlt[2];
    const size_t slot = ((size_t)(b * KH + kh) * n_qt + q0 / BQ) * AUX;
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const int qi = r / G, g = r - qi * G;
      float dl = 0.f, l = 0.f;
      if (qi < BQ && q0 + qi < q_end) {     // uniform across the warp
        const size_t row = ((size_t)b * Sq + q0 + qi) * H + kh * G + g;
        float part = 0.f;
        if (lane * 8 < D) {
          uint4 x = __ldg(reinterpret_cast<const uint4*>(dout + row * D
                                                         + lane * 8));
          uint4 y = __ldg(reinterpret_cast<const uint4*>(o + row * D
                                                         + lane * 8));
          const bf* xe = reinterpret_cast<const bf*>(&x);
          const bf* ye = reinterpret_cast<const bf*>(&y);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            part = fmaf(to_f32(xe[e]), to_f32(ye[e]), part);
        }
        dl = warp_sum(part);
        l = lse[((size_t)b * H + kh * G + g) * Sq + q0 + qi];
      }
      if (q0 < Sq && lane == 0) {
        aux[slot + r] = l;
        aux[slot + TILE + r] = dl;
      }
      if ((lane >> 2) == (rr & 7)) {
        lse_r[rr >> 3] = l;
        dlt[rr >> 3] = dl;
      }
    }
    hopper::fence_proxy_async();
    hopper::named_sync(1 + cw, WG);

    int pos[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) pos[h] = q_offset + q0 + (r0 + 8 * h) / G;
    const int p_lo = q_offset + q0, p_hi = q_offset + q_end - 1;
    float acc[32 * NC];     // dQ, 64 x 64 NC: one accumulator over the panels
#pragma unroll
    for (int x = 0; x < 32 * NC; ++x) acc[x] = 0.f;

    int first, n;
    dq_range(unit, BQ, Sq, Skv, causal, window, q_offset, first, n);
    for (int j = 0; j < n; ++j, ++it) {
      const int s = it % STAGES, t0 = first + j * TILE;
      hopper::mbar_wait(full + 8 * s, (it / STAGES) & 1);
      const int cls = tile_class(p_lo, p_hi, t0, Skv, causal, window);
      if (cls != TILE_EMPTY) {
        const uint32_t kt = ring + s * 2 * NC * PANEL, vt = kt + NC * PANEL;
        float sc[32], dp[32];
        const uint64_t qd = desc(my_q), kd = desc(kt);
        const uint64_t od = desc(my_do), vd = desc(vt);
        hopper::wg_fence();
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          hopper::wgmma_ss<0>(sc, qd + kstep(kk), kd + kstep(kk), kk > 0);
        hopper::wg_commit();
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          hopper::wgmma_ss<0>(dp, od + kstep(kk), vd + kstep(kk), kk > 0);
        hopper::wg_commit();
        hopper::wg_wait<1>();
        hopper::keep(sc);
        // P = exp(S - lse); element x: row r0 + 8 ((x >> 1) & 1), key
        // t0 + 8 (x >> 2) + 2 tig + (x & 1)
        if (cls == TILE_FULL) {
#pragma unroll
          for (int x = 0; x < 32; ++x)
            sc[x] = exp2f((sc[x] - lse_r[(x >> 1) & 1]) * L2E);
        } else {
#pragma unroll
          for (int x = 0; x < 32; ++x) {
            const int h = (x >> 1) & 1;
            const int t = t0 + 8 * (x >> 2) + 2 * tig + (x & 1);
            sc[x] = visible(t, pos[h], Skv, causal, window)
                ? exp2f((sc[x] - lse_r[h]) * L2E) : 0.f;
          }
        }
        hopper::wg_wait<0>();
        hopper::keep(dp);
        // dS = P o (dP - Delta), rounded to bf16 as the A operand
#pragma unroll
        for (int x = 0; x < 32; ++x)
          dp[x] = sc[x] * (dp[x] - dlt[(x >> 1) & 1]);
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) hopper::acc_to_a(a[kk], dp, kk);
        const uint64_t kmn = desc_mn(kt);
        hopper::wg_fence();
        hopper::keep(acc);
        // dQ += dS . K: K rows are the contraction, MN-major
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_rs<1>(acc, a[kk], kmn + 128 * kk);
        hopper::wg_commit();
        hopper::wg_wait<0>();
        hopper::keep(acc);
      }
      hopper::mbar_arrive(empty + 8 * s);
    }

    // dQ = (dS.K rounded to bf16) * scale, rounded to bf16
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h, qi = r / G, g = r - qi * G;
      if (qi >= BQ || q0 + qi >= q_end) continue;
      bf* dst = dq + (((size_t)b * Sq + q0 + qi) * H + kh * G + g) * D;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * c + 8 * j + 2 * tig;
          if (col >= D) continue;
          const float x0 = round_to<bf>(acc[32 * c + 4 * j + 2 * h]) * scale_q;
          const float x1 =
              round_to<bf>(acc[32 * c + 4 * j + 2 * h + 1]) * scale_q;
          *reinterpret_cast<__nv_bfloat162*>(dst + col) =
              __floats2bfloat162_rn(x0, x1);
        }
    }
  }
}

// grid (ceil(units / 2), KH, B); CTA x takes dK/dV units x and units-1-x
// of 64 key positions.  Consumer 0 forms S^T, P^T and dV; consumer 1 dP^T,
// dS^T and dK, reading consumer 0's float32 P^T of the tile from shared
// memory (two buffers, named barriers XREADY and XFREE): one accumulator a
// warpgroup
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap qs_map,
                  const __grid_constant__ CUtensorMap do_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  const float* __restrict__ aux, bf* __restrict__ dk,
                  bf* __restrict__ dv, int Sq, int Skv, int H, int KH,
                  int causal, int window, int q_offset) {
  constexpr int NC = tc_nc(D), KD = tc_kd(D);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* gen;
  const uint32_t base = aligned_base(smem_raw, gen);
  const uint32_t own_k = base;                            // [NC]
  const uint32_t own_v = own_k + NC * PANEL;              // [NC]
  const uint32_t ring = own_v + NC * PANEL;               // [STAGES][2][NC]
  const uint32_t xbuf = ring + STAGES * 2 * NC * PANEL;   // [2][32][WG]
  const uint32_t auxs = xbuf + 2 * XBUF;                  // [STAGES][AUX]
  const uint32_t full = auxs + 4 * AUX * STAGES;          // [STAGES]
  const uint32_t empty = full + 8 * STAGES;               // [STAGES]
  const uint32_t kv_full = empty + 8 * STAGES, kv_empty = kv_full + 8;
  const int G = H / KH, BQ = TILE / G, n_qt = (Sq + BQ - 1) / BQ;
  const uint32_t box_q = 128 * G * BQ;    // bytes of a scaled-Q or dO box
  const int kh = blockIdx.y, b = blockIdx.z;
  const int units = (Skv + TILE - 1) / TILE;
  const int u0 = blockIdx.x, u1 = units - 1 - blockIdx.x;
  const int n_mine = u1 > u0 ? 2 : 1;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, NCONS * WG);
    }
    hopper::mbar_init(kv_full, 1);
    hopper::mbar_init(kv_empty, NCONS * WG);
    hopper::mbar_fence_init();
  }
  // the dead rows of the ring's panels (64 mod G), which TMA never writes
  for (int i = threadIdx.x; i < STAGES * 2 * NC * (TILE - G * BQ) * 8;
       i += TC_THREADS) {
    const int p = i / ((TILE - G * BQ) * 8), e = i % ((TILE - G * BQ) * 8);
    *reinterpret_cast<uint4*>(gen + (ring - base) + p * PANEL
                              + hopper::swz(G * BQ + e / 8, e % 8)) =
        make_uint4(0, 0, 0, 0);
  }
  hopper::fence_proxy_async();
  __syncthreads();

  if (wg == 0) {           // the producer: own K, V; scaled-Q, dO, aux tiles
    hopper::reg_dealloc<24>();
    if (threadIdx.x != 0) return;
    int it = 0;
    for (int m = 0; m < n_mine; ++m) {
      const int unit = m ? u1 : u0;
      if (m > 0) hopper::mbar_wait(kv_empty, (m - 1) & 1);
      hopper::mbar_expect_tx(kv_full, 2 * NC * PANEL);
      for (int c = 0; c < NC; ++c) {
        hopper::tma_load_4d(own_k + c * PANEL, &k_map, kv_full, 64 * c, kh,
                            unit * TILE, b);
        hopper::tma_load_4d(own_v + c * PANEL, &v_map, kv_full, 64 * c, kh,
                            unit * TILE, b);
      }
      int first, n;
      dkv_range(unit, BQ, Sq, Skv, causal, window, q_offset, first, n);
      for (int j = 0; j < n; ++j, ++it) {
        const int s = it % STAGES, pos0 = first + j * BQ;
        hopper::mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(full + 8 * s, 2 * NC * box_q + 4 * AUX);
        const uint32_t qt = ring + s * 2 * NC * PANEL;
        for (int c = 0; c < NC; ++c) {
          hopper::tma_load_5d(qt + c * PANEL, &qs_map, full + 8 * s, 64 * c,
                              0, kh, pos0, b);
          hopper::tma_load_5d(qt + (NC + c) * PANEL, &do_map, full + 8 * s,
                              64 * c, 0, kh, pos0, b);
        }
        hopper::bulk_load(auxs + s * 4 * AUX,
                          aux + ((size_t)(b * KH + kh) * n_qt + pos0 / BQ)
                                    * AUX,
                          4 * AUX, full + 8 * s);
      }
    }
    return;
  }

  hopper::reg_alloc<240>();
  const int cw = wg - 1, ct = threadIdx.x - wg * WG;
  const int warp = ct >> 5, lane = ct & 31, tig = lane & 3;
  const uint32_t my_a = cw ? own_v : own_k;   // V (dP^T) or K (S^T)
  int it = 0, used = 0;                       // tiles, tiles not skipped
  for (int m = 0; m < n_mine; ++m) {
    const int unit = m ? u1 : u0;
    const int k0 = unit * TILE;               // the unit's keys
    int t_row[2];                             // the lane's two keys
#pragma unroll
    for (int h = 0; h < 2; ++h) t_row[h] = k0 + warp * 16 + (lane >> 2) + 8 * h;
    float acc[32 * NC];                       // dV (consumer 0), dK (1)
#pragma unroll
    for (int x = 0; x < 32 * NC; ++x) acc[x] = 0.f;
    hopper::mbar_wait(kv_full, m & 1);

    int first, n;
    dkv_range(unit, BQ, Sq, Skv, causal, window, q_offset, first, n);
    for (int j = 0; j < n; ++j, ++it) {
      const int s = it % STAGES, pos0 = first + j * BQ;
      hopper::mbar_wait(full + 8 * s, (it / STAGES) & 1);
      const int cls = tile_class(q_offset + pos0,
                                 q_offset + min(pos0 + BQ, Sq) - 1, k0, Skv,
                                 causal, window);
      if (cls != TILE_EMPTY) {
        const uint32_t qt = ring + s * 2 * NC * PANEL, dt = qt + NC * PANEL;
        const float* la =
            reinterpret_cast<const float*>(gen + (auxs - base) + s * 4 * AUX);
        float* xb = reinterpret_cast<float*>(gen + (xbuf - base)
                                             + (used & 1) * XBUF);
        // S^T = K . Qs^T (consumer 0) or dP^T = V . dO^T (consumer 1)
        float sc[32];
        const uint64_t ad = desc(my_a), bd = desc(cw ? dt : qt);
        hopper::wg_fence();
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          hopper::wgmma_ss<0>(sc, ad + kstep(kk), bd + kstep(kk), kk > 0);
        hopper::wg_commit();
        hopper::wg_wait<0>();
        hopper::keep(sc);
        if (cw == 0) {
          // P^T = exp(S^T - lse); element x: key t_row[(x >> 1) & 1],
          // column 8 (x >> 2) + 2 tig + (x & 1).  Key t sees column col
          // (position q_offset + pos0 + col / G) when col >= lo[h]
          // (causal) and col < hi[h] (window).
          int lo[2], hi[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = t_row[h] - q_offset - pos0;
            lo[h] = causal ? k * G : INT_MIN;
            hi[h] = t_row[h] >= Skv ? INT_MIN
                : window > 0 ? (k + window) * G : INT_MAX;
          }
#pragma unroll
          for (int x = 0; x < 32; ++x) {
            const int col = 8 * (x >> 2) + 2 * tig + (x & 1);
            const int h = (x >> 1) & 1;
            const float p = exp2f((sc[x] - la[col]) * L2E);
            sc[x] = cls == TILE_FULL || (col >= lo[h] && col < hi[h]) ? p
                                                                     : 0.f;
          }
          // hand P^T to consumer 1 once it has read this buffer's last
          if (used >= 2) hopper::named_sync(XFREE + (used & 1), 2 * WG);
#pragma unroll
          for (int x = 0; x < 32; ++x) xb[x * WG + ct] = sc[x];
          hopper::named_arrive(XREADY + (used & 1), 2 * WG);
        } else {
          // dS^T = P^T o (dP^T - Delta), with consumer 0's P^T
          const float* da = la + TILE;
          hopper::named_sync(XREADY + (used & 1), 2 * WG);
#pragma unroll
          for (int x = 0; x < 32; ++x)
            sc[x] = xb[x * WG + ct]
                * (sc[x] - da[8 * (x >> 2) + 2 * tig + (x & 1)]);
          hopper::named_arrive(XFREE + (used & 1), 2 * WG);
        }
        // dV += P^T . dO or dK += dS^T . Qs: the A operand rounded to bf16
        // in registers, the tile's rows the contraction, B MN-major
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) hopper::acc_to_a(a[kk], sc, kk);
        const uint64_t bmn = desc_mn(cw ? qt : dt);
        hopper::wg_fence();
        hopper::keep(acc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_rs<1>(acc, a[kk], bmn + 128 * kk);
        hopper::wg_commit();
        hopper::wg_wait<0>();
        hopper::keep(acc);
        ++used;
      }
      hopper::mbar_arrive(empty + 8 * s);
    }
    hopper::mbar_arrive(kv_empty);       // this unit's K and V are read

    bf* out = cw ? dk : dv;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t_row[h];
      if (t >= Skv) continue;
      bf* dst = out + (((size_t)b * Skv + t) * KH + kh) * D;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * c + 8 * j + 2 * tig;
          if (col >= D) continue;
          *reinterpret_cast<__nv_bfloat162*>(dst + col) =
              __floats2bfloat162_rn(acc[32 * c + 4 * j + 2 * h],
                                    acc[32 * c + 4 * j + 2 * h + 1]);
        }
    }
  }
  // the hand-offs consumer 1 released last, which consumer 0 never awaited
  if (cw == 0)
    for (int u = max(used - 2, 0); u < used; ++u)
      hopper::named_sync(XFREE + (u & 1), 2 * WG);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime: no -lcuda
EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &status)
        != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &status) != cudaSuccess)
      return nullptr;
#endif
    return status == cudaDriverEntryPointSuccess
        ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A bf16 map over `ptr`: dims innermost first, byte strides of dims 1..,
// the box; 128-byte swizzle, zeros outside the tensor
bool make_map(CUtensorMap* map, const void* ptr, int rank,
              const cuuint64_t* dims, const cuuint64_t* strides,
              const cuuint32_t* box) {
  const EncodeTiled fn = encoder();
  const cuuint32_t one[5] = {1, 1, 1, 1, 1};
  return fn != nullptr
      && fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(ptr), dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* aux, void* dq,
              void* dk, void* dv, void* qs, int B, int Sq, int Skv, int H,
              int KH, int causal, int window, int q_offset, float scale_q,
              cudaStream_t stream) {
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
  const int G = H / KH;
  if (G > TILE || qs == nullptr) return (int)cudaErrorInvalidValue;
  const int BQ = TILE / G;
  const cuuint64_t e = sizeof(bf);
  // k, v (B, Skv, KH, D) as (D, KH, Skv, B), boxes of 64 keys; q-shaped
  // (B, Sq, H, D) as (D, G, KH, Sq, B), boxes of BQ positions x G heads
  const cuuint64_t kd[4] = {(cuuint64_t)D, (cuuint64_t)KH, (cuuint64_t)Skv,
                            (cuuint64_t)B};
  const cuuint64_t ks[3] = {D * e, KH * D * e, (cuuint64_t)Skv * KH * D * e};
  const cuuint32_t kb[4] = {64, 1, TILE, 1};
  const cuuint64_t qd[5] = {(cuuint64_t)D, (cuuint64_t)G, (cuuint64_t)KH,
                            (cuuint64_t)Sq, (cuuint64_t)B};
  const cuuint64_t qstr[4] = {D * e, G * D * e, H * D * e,
                              (cuuint64_t)Sq * H * D * e};
  const cuuint32_t qb[5] = {64, (cuuint32_t)G, 1, (cuuint32_t)BQ, 1};
  CUtensorMap km, vm, qm, dm;
  if (!make_map(&km, k, 4, kd, ks, kb) || !make_map(&vm, v, 4, kd, ks, kb)
      || !make_map(&qm, qs, 5, qd, qstr, qb)
      || !make_map(&dm, dout, 5, qd, qstr, qb))
    return (int)cudaErrorNotSupported;
  const int nq = (Sq + NCONS * BQ - 1) / (NCONS * BQ);
  const int nk = (Skv + TILE - 1) / TILE;
  bwd_dq_tc_kernel<D><<<dim3((nq + 1) / 2, KH, B), TC_THREADS, s1, stream>>>(
      km, vm, static_cast<const bf*>(q), static_cast<const bf*>(o),
      static_cast<const bf*>(dout), lse, aux, static_cast<bf*>(qs),
      static_cast<bf*>(dq), Sq, Skv, H, KH, causal, window, q_offset,
      scale_q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dkv_tc_kernel<D><<<dim3((nk + 1) / 2, KH, B), TC_THREADS, s2, stream>>>(
      qm, dm, km, vm, aux, static_cast<bf*>(dk), static_cast<bf*>(dv), Sq,
      Skv, H, KH, causal, window, q_offset);
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
// dk, dv (B, Skv, KH, D) of that type, contiguous, 16-byte aligned; lse
// float32 (B, H, Sq).  scratch: float32 written here, Delta (B, H, Sq) on
// the CUDA cores, each query tile's lse and Delta (B, KH, ceil(Sq / BQ),
// 128) on the tensor cores (bf16, D <= 128; BQ = 64 / G); qs scratch of
// q's shape and type on the tensor cores (null otherwise).  D in {16, 64,
// 96, 120, 128, 256}; scale_q is d**-0.5 rounded to the type.  Two
// launches on ``stream`` (dQ and Delta, then dK and dV); allocates
// nothing.
extern "C" int flash_attention_bwd_launch(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* scratch, void* dq, void* dk,
    void* dv, void* qs, int B, int Sq, int Skv, int H, int KH, int D,
    int causal, int window, int q_offset, float scale_q, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KH <= 0 || H % KH != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_f32(q, k, v, o, dout, lse, scratch, dq, dk, dv, B, Sq, Skv, H,
                      KH, D, causal, window, q_offset, scale_q, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
#define TC(DD)                                                                \
  return launch_tc<DD>(q, k, v, o, dout, lse, scratch, dq, dk, dv, qs, B, Sq, \
                       Skv, H, KH, causal, window, q_offset, scale_q, s)
  switch (D) {
    case 16: TC(16);
    case 64: TC(64);
    case 96: TC(96);
    case 120: TC(120);
    case 128: TC(128);
    case 256:     // the dK and dV accumulators outgrow the registers
      return launch_inst<__nv_bfloat16, 8>(q, k, v, o, dout, lse, scratch, dq,
                                           dk, dv, B, Sq, Skv, H, KH, D,
                                           causal, window, q_offset, scale_q,
                                           s);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TC
}
