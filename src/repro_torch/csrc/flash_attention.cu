// Causal / sliding-window GQA flash attention forward: q (B, Sq, H, D)
// against k, v (B, Skv, KH, D), online softmax per tile of key positions
// (64 in bfloat16, 32 in float32), fully masked tiles skipped.
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
// causal rows always see at least their own position.  When the caller
// passes an lse buffer (the training path), each row's log-sum-exp
// m + log(l) of the running max and denominator is written beside the
// output for the backward (flash_attention_bwd.cu); O is the same either
// way.
//
// What bounds it on the H100: operations at long sequences.  A tile pair
// costs 4*D operations per (query row, visible position) against 2*D
// stored elements per position read once per CTA, so with R rows (query
// position x head) per CTA it does 2*R operations per byte (bf16): 256 at
// 128 rows, near the ~295 the tensor cores need.  The bound counts both
// products at the bf16 tensor-core rate.
//
// Two kernels behind one entry point, both one CTA per (block of query
// positions, kv head, sequence) holding every query head of its GQA group,
// so each K/V tile is read from memory once for all G heads: row r of the
// CTA is query position q0 + r / G, head kh*G + r % G.
//
// bfloat16: the tensor cores (flash_tc_kernel).  8 warps, 16 rows each
// (128 rows, BQ = 128 / G query positions: 32 at h2o-danube-3-4b's G 4, 64
// at gemma3-4b's G 2, 25 at hymba-1.5b's G 5, whose last 3 rows are
// padding).  Both products are mma.sync m16n8k16 bf16 x bf16 ->
// float32 with operands from shared memory by ldmatrix: S = Q.K^T, then p
// rounded to bf16 in registers, the S accumulator fragment reused as the A
// operand of P.V (.trans ldmatrix of V), as in FlashAttention-2.  The
// contract makes that exact up to the order of the float32 sums: q*scale is
// rounded to bf16 before Q.K^T and p before P.V, so every product is a
// bf16 x bf16 product, exact in float32.  K and V tiles of BK = 64
// positions are staged with 16-byte cp.async copies, double buffered; the
// shared-memory rows are padded to an odd number of 16-byte units, so the
// eight rows of an ldmatrix hit distinct banks.  Q.K^T runs its k-dimension
// over D rounded up to 16: at D = 120 columns 120..127 of the Q and K tiles
// are zeros in shared memory (exact zero products; memory rows stay 120
// wide, 15 16-byte copies), and P.V runs D / 8 = 15 n-tiles.  The online
// softmax updates m, l and the accumulator (float32) once per tile of BK
// positions at tile boundaries aligned to multiples of BK: the chunks of
// flash_attention_chunked(kv_chunk=BK).  Tiles no row of the CTA can see
// are not loaded; a warp skips the tiles none of its rows can see (a no-op
// of the online softmax) and masks only the tiles it sees in part.  Not yet
// done: wgmma, TMA, warp specialisation.
//
// float32: the CUDA cores (flash_kernel), IEEE products (tensor-core
// float32 is TF32).  One 512-thread CTA of R = 16 * RW rows, RW rows per
// warp, BQ = R / G query positions.  The scaled Q block lives in shared
// memory; K and V tiles of 64 positions are staged with 16-byte loads (the
// row stride padded to an odd number of 16-byte units).  Each tile runs as
// two halves of 32 positions (the softmax step): lane j scores position j
// against the warp's RW rows, a warp max / sum per row updates m and l, p
// goes to a per-row shared buffer, and each lane accumulates D / 32 head
// dims of every row in registers, V read along D.
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
             const T* __restrict__ v, T* __restrict__ out,
             float* __restrict__ lse, int Sq, int Skv, int H, int KH, int D,
             int BQ, int causal, int window, int q_offset, float scale_q) {
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
    const float m = __shfl_sync(FULL, m_reg, r);
    const int row = row0 + r;
    const int qi = row / G, g = row - qi * G;
    if (qi >= BQ || q0 + qi >= Sq) continue;
    T* dst = out + (((size_t)b * Sq + q0 + qi) * H + kh * G + g) * D;
    // the log-sum-exp of the row for the backward (-inf where no position
    // is visible), only when asked for
    if (lse != nullptr && lane == 0)
      lse[((size_t)b * H + kh * G + g) * Sq + q0 + qi] = m + logf(l);
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) dst[d] = cast<T>(acc[r][i] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores

constexpr int TC_WARPS = 8;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_ROWS = 16 * TC_WARPS;  // rows per CTA, 16 a warp
constexpr int TC_BK = 64;               // key positions per tile (softmax step)

// k-dimension of Q.K^T: D rounded up to 16
__host__ __device__ constexpr int tc_dp(int D) { return (D + 15) / 16 * 16; }
// shared-memory row stride in elements: an odd number of 16-byte units
__host__ __device__ constexpr int tc_stride(int D) { return tc_dp(D) + 8; }
// the scaled Q block and two K and two V tiles
__host__ __device__ constexpr size_t tc_smem(int D) {
  return sizeof(__nv_bfloat16) * (size_t)tc_stride(D) * (TC_ROWS + 4 * TC_BK);
}

__device__ inline unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16-byte global -> shared copy; bytes = 0 writes 16 zero bytes
__device__ inline void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ inline void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ inline void cp_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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
// d += a . b: one m16n8k16 tile, bf16 operands, float32 accumulator
__device__ inline void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two floats rounded to bf16, the first in the low half
__device__ inline unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// grid (n_qblocks, KH, B).  Warp w owns rows 16w..16w+15; in the mma
// fragments lane l holds rows 16w + l/4 ("A") and 16w + l/4 + 8 ("B") and
// columns 2*(l%4), 2*(l%4)+1 of each 8-wide n-tile.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, D <= 128 ? 2 : 1)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                int Sq, int Skv, int H, int KH, int BQ, int causal,
                int window, int q_offset, float scale_q) {
  constexpr int DP = tc_dp(D), ST = tc_stride(D);
  constexpr int KSTEPS = DP / 16;       // k-steps of Q.K^T
  constexpr int NT = TC_BK / 8;         // n-tiles of S
  constexpr int DT = D / 8;             // n-tiles of P.V (16-byte vectors
                                        // of a row)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [ROWS][ST]
  __nv_bfloat16* ks = qs + TC_ROWS * ST;                          // [2][BK][ST]
  __nv_bfloat16* vs = ks + 2 * TC_BK * ST;                        // [2][BK][ST]
  const int G = H / KH;
  const int kh = blockIdx.y, b = blockIdx.z;
  // the last query blocks (the most key tiles under causality) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int q_end = min(q0 + BQ, Sq);   // this block's query positions
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tig = lane & 3;

  // the scaled Q block, rounded to bf16 as the plain version rounds
  // q * scale; rows past the block are zero
  for (int i = tid; i < TC_ROWS * DT; i += TC_THREADS) {
    const int r = i / DT, c = i - r * DT;
    const int qi = r / G, g = r - qi * G;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (q0 + qi < q_end) {
      raw = __ldg(reinterpret_cast<const uint4*>(
          q + (((size_t)b * Sq + q0 + qi) * H + kh * G + g) * D + c * 8));
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * scale_q);
    }
    *reinterpret_cast<uint4*>(qs + r * ST + c * 8) = raw;
  }
  // columns D..DP-1 of Q and of both K buffers: zeros (cp.async never
  // writes them)
  if (DP > D) {
    for (int r = tid; r < TC_ROWS + 2 * TC_BK; r += TC_THREADS) {
      __nv_bfloat16* row = r < TC_ROWS ? qs + r * ST : ks + (r - TC_ROWS) * ST;
#pragma unroll
      for (int c = D; c < DP; c += 8)
        *reinterpret_cast<uint4*>(row + c) = make_uint4(0, 0, 0, 0);
    }
  }

  // key positions any row of this block can see: [lo, hi), in tiles from
  // a multiple of BK
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

  // this lane's two rows and this warp's query positions
  const int row_a = warp * 16 + (lane >> 2);
  int pos[2];
  bool act[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = (row_a + 8 * h) / G;
    act[h] = q0 + qi < q_end;
    pos[h] = q_offset + q0 + qi;
  }
  const int w_first = warp * 16 / G, w_last = (warp * 16 + 15) / G;
  const bool w_any = q0 + w_first < q_end;   // some row of the warp is live
  const bool w_all = q0 + w_last < q_end;    // every row is
  const int wq_lo = q_offset + q0 + w_first;
  const int wq_hi = q_offset + min(q0 + w_last, q_end - 1);

  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  if (n_tiles > 0) issue(0, 0);
  cp_commit();
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) issue(it + 1, (it + 1) & 1);
    cp_commit();
    cp_wait1();                         // tile it has landed
    __syncthreads();
    const int t0 = t_first + it * TC_BK;
    const bool skip = !w_any || (causal && t0 > wq_hi)
        || (window > 0 && t0 + TC_BK - 1 <= wq_lo - window);
    if (!skip) {
      const __nv_bfloat16* kb = ks + (it & 1) * TC_BK * ST;
      const __nv_bfloat16* vb = vs + (it & 1) * TC_BK * ST;
      // S = Q.K^T over the tile
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        unsigned a[4];
        ldsm_x4(a, qs + (warp * 16 + (lane & 15)) * ST + kk * 16
                       + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          unsigned bk[4];
          ldsm_x4(bk, kb + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * ST
                          + kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], a, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }
      // mask, unless every row of the warp sees the whole tile
      const bool full = w_all && t0 + TC_BK <= Skv
          && (!causal || t0 + TC_BK - 1 <= wq_lo)
          && (window <= 0 || t0 > wq_hi - window);
      if (!full) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const int t = t0 + 8 * j + 2 * tig + (e & 1);
            const bool ok = act[h] && t < Skv && (!causal || t <= pos[h])
                && (window <= 0 || t > pos[h] - window);
            if (!ok) s[j][e] = NEG_INF;
          }
      }
      // online softmax: the row max over the quad, m, l and the rescale
      float corr[2], mn[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        mn[h] = fmaxf(m[h], mx);
        corr[h] = expf(m[h] - mn[h]);
        m[h] = mn[h];
      }
      // p = exp(s - m), 0 where masked (a masked s is -1e30, so exp gives
      // 0 there once the row has a real max; before, the row has none)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float p = mn[h] == NEG_INF ? 0.f : expf(s[j][e] - mn[h]);
          s[j][e] = p;
          psum[h] += p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        psum[h] += __shfl_xor_sync(FULL, psum[h], 1);
        psum[h] += __shfl_xor_sync(FULL, psum[h], 2);
        l[h] = l[h] * corr[h] + psum[h];
      }
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        o[d][0] *= corr[0];
        o[d][1] *= corr[0];
        o[d][2] *= corr[1];
        o[d][3] *= corr[1];
      }
      // acc += bf16(p) . V: the S fragments of n-tiles 2kk, 2kk+1 are the
      // A fragment of k-step kk
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk) {
        unsigned a[4];
        a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        const __nv_bfloat16* vrow =
            vb + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ST;
#pragma unroll
        for (int np = 0; np < DT / 2; ++np) {
          unsigned bv[4];
          ldsm_x4_t(bv, vrow + np * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * np], a, bv[0], bv[1]);
          mma_bf16(o[2 * np + 1], a, bv[2], bv[3]);
        }
        if (DT & 1) {
          unsigned bv[2];
          ldsm_x2_t(bv, vrow + (DT - 1) * 8);
          mma_bf16(o[DT - 1], a, bv[0], bv[1]);
        }
      }
    }
    __syncthreads();                    // buffer it & 1 is free
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!act[h]) continue;
    const int r = row_a + 8 * h;
    const int qi = r / G, g = r - qi * G;
    __nv_bfloat16* dst =
        out + (((size_t)b * Sq + q0 + qi) * H + kh * G + g) * D + 2 * tig;
    // the row's log-sum-exp for the backward (the quad holds one m and l)
    if (lse != nullptr && tig == 0)
      lse[((size_t)b * H + kh * G + g) * Sq + q0 + qi] = m[h] + logf(l[h]);
    const float den = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * d) =
          __floats2bfloat162_rn(o[d][2 * h] / den, o[d][2 * h + 1] / den);
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              float* lse, int B, int Sq, int Skv, int H, int KH, int causal,
              int window, int q_offset, float scale_q, cudaStream_t stream) {
  const int BQ = TC_ROWS / (H / KH);
  constexpr size_t smem = tc_smem(D);
  static_assert(smem <= MAX_SMEM, "shared memory of one CTA");
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  if (BQ < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((Sq + BQ - 1) / BQ, KH, B);
  flash_tc_kernel<D><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lse, Sq, Skv, H, KH, BQ, causal, window, q_offset, scale_q);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------

template <int RW, int DL>
int launch_inst(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int Sq, int Skv, int H, int KH, int D,
                int causal, int window, int q_offset, float scale_q,
                cudaStream_t stream) {
  using T = float;
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
      static_cast<const T*>(v), static_cast<T*>(out), lse, Sq, Skv, H, KH, D,
      BQ, causal, window, q_offset, scale_q);
  return (int)cudaGetLastError();
}

int launch(int dtype, const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Sq, int Skv, int H, int KH, int D,
           int causal, int window, int q_offset, float scale_q,
           cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KH <= 0 || H % KH != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
#define TC(DD)                                                                \
  return launch_tc<DD>(q, k, v, out, lse, B, Sq, Skv, H, KH, causal, window,  \
                       q_offset, scale_q, stream)
    switch (D) {
      case 16: TC(16);
      case 64: TC(64);
      case 96: TC(96);
      case 120: TC(120);
      case 128: TC(128);
      case 256: TC(256);
      default: return (int)cudaErrorInvalidValue;
    }
#undef TC
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
#define INST(RW, DL)                                                          \
  return launch_inst<RW, DL>(q, k, v, out, lse, B, Sq, Skv, H, KH, D, causal, \
                             window, q_offset, scale_q, stream)
  switch (D) {
    case 16: INST(16, 1);
    case 64: INST(16, 2);
    case 96: INST(16, 3);
    case 120:
    case 128: INST(16, 4);
    case 256: INST(8, 8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef INST
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores); q, k, v
// and out share it.  q and out (B, Sq, H, D), k and v (B, Skv, KH, D),
// contiguous, 16-byte aligned; D in {16, 64, 96, 120, 128, 256}.  scale_q is
// d**-0.5 rounded to q's type.  lse: null, or float32 (B, H, Sq) that
// receives each row's m + log(l) for the backward.  Launches on ``stream``;
// allocates nothing.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      int B, int Sq, int Skv, int H, int KH,
                                      int D, int causal, int window,
                                      int q_offset, float scale_q,
                                      void* stream) {
  return launch(dtype, q, k, v, out, lse, B, Sq, Skv, H, KH, D, causal,
                window, q_offset, scale_q, (cudaStream_t)stream);
}
