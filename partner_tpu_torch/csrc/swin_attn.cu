// Fused vote-Swin window attention for the PARTNER E2E head (sm_90a).
//
// Replaces the TPU kernel partner_tpu/ops/swin_attn_pallas.py:
// swin_vote_attention (the pl.pallas_call at :137). Plain twin and wrapper:
// partner_tpu_torch/ops/swin_attn.py.
//
// Computes, for one window w (T = 64 tokens) and each of its 4 heads h
// (hd = 64), with the twin's cast points:
//   rel_ij = pos_i - pos_j                                   (f32)
//   rpe_ij = sum_k relu(rel_ij . W1[:, k] + b1_k) W2[k, h] + b2_h   (f32)
//   l_ij   = ((q_i . k_j) / (|q_i| |k_j|)) / tau_h + rpe_ij [+ mask_ij]
//   P      = bf16(softmax_j(l))        normalised in f32, then rounded
//   out_i  = bf16(sum_j P_ij v_j)                            f32 accumulation
// with |x| = sqrt(sum x^2 + 1e-12) and f32 accumulation throughout, and
// mask = mask[w % nW_mask] (shifted blocks only).
//
// What bounds it on the H100: bytes. At the flagship shape (576 windows x 4
// heads) a call reads q, k, v (18.9 MB each, bf16), the mask (9.4 MB) and
// writes the output (18.9 MB): 85.2 MB with the mask, 75.8 MB without,
// 0.0254 / 0.0226 ms at 3.35 TB/s. The bf16 products are 2.42 GFLOP
// (0.0024 ms at the tensor-core peak) and the f32 RPE MLP 0.05 GFLOP. In
// practice one window per SM (the shared memory allows no second) runs its
// phases one after another, and their latency and f32 work set the time;
// no part dominates, the RPE MLP and the copies are the largest
// (tools/attn_kernel_parts.py times the kernel with parts removed;
// PERF.md).
//
// Design, against what held the previous kernel (one 256-thread block per
// (window, head), scalar FMAs, the f32 logits in shared memory) back:
// - Both products on the tensor cores. q.k^T and P.v are mma.sync m16n8k16
//   bf16 -> f32; ldmatrix.x4 loads q (A) and k (B) from their natural
//   layout, ldmatrix.x4.trans loads v (B of P.v). q, k and v are staged in
//   shared rows padded to 72 values (144 bytes), so the 8 row addresses of
//   an ldmatrix phase fall in 8 distinct 16-byte bank groups.
// - One block per window over all 4 heads: 16 warps, warp (rt, h) owns
//   query rows 16 rt .. 16 rt + 15 of head h against all 64 keys. The
//   logits stay in the mma accumulators (32 floats a thread: rows g and
//   g + 8, g = lane / 4); norms, 1 / tau, RPE and mask are applied there,
//   row max and sum come from quad shuffles (no exchange between warps),
//   and the normalised P is packed into bf16 A fragments of P.v straight
//   from the accumulator layout. The output (32 f32 accumulators) is
//   written once as bf16.
// - The RPE hidden layer once per window for all heads: the block fills an
//   f32 table of rpe for all 4 heads (64 KB), each thread 8 pairs, in the
//   order the warps' accumulators read it (entry (h, rt, j, r, lane) is a
//   float2: row 16 rt + lane / 4 + 8 r, keys 8 j + 2 (lane % 4) + {0, 1}),
//   so both the fill and the reads move 256 contiguous bytes a warp.
//   rel . W1 is taken from the f32 difference of the positions, as the twin
//   does, not split into row and column terms (positions reach ~75 m, and
//   p_i . W1 - p_j . W1 loses those bits).
// - The mask is copied into shared memory once per window (rows padded to
//   72 floats), not read once per head; the unshifted blocks take the
//   template without it.
// - Copies by 16-byte cp.async in three groups, waited for one at a time:
//   positions and mask (the table is filled while q and k land), q and k,
//   then v (it lands while the norms, logits and softmax run).
// - One block per window: 576 blocks, one resident per SM (197,664 bytes
//   of shared memory), 4.4 waves. A persistent grid of one block per SM
//   that walked the windows, issuing the next window's copies while one
//   computed, measured slower (PERF.md).
// - Rounding: f32 throughout, with reciprocal multiplies where the twin
//   divides (1 / (|q| tau) per row, 1 / |k| per key, 1 / sum per row of P;
//   two IEEE divisions and one more a logit made the kernel 1.3-1.5x
//   slower), rel . W1 + b1 as two FMAs, and the softmax's max and sum as
//   trees;
//   these move f32 roundings only, and the card tests hold the kernel to
//   the twin at 2^-7 (1 + |twin|). expf is kept (not __expf); P is
//   normalised before its bf16 cast (no deferred normalisation).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int T = 64;    // tokens per window
constexpr int HD = 64;   // head width
constexpr int HID = 16;  // RPE hidden width
constexpr int NH = 4;    // heads
constexpr int RT = T / 16;             // row tiles of 16 queries
constexpr int NT = T / 8;              // n-tiles of 8 keys, or 8 columns
constexpr int THREADS = 32 * RT * NH;  // 16 warps: warp (rt, h)
constexpr int SS = HD + 8;  // bf16 row stride of q, k, v in shared memory
constexpr int MS = T + 8;   // f32 row stride of the mask in shared memory

// shared layout, bytes
constexpr int QKV = NH * T * SS * 2;              // one of q, k, v: [h][T][SS]
constexpr int OFF_Q = 0;
constexpr int OFF_K = OFF_Q + QKV;
constexpr int OFF_V = OFF_K + QKV;
constexpr int OFF_RPE = OFF_V + QKV;              // float2 [h][rt][j][r][32]
constexpr int OFF_MASK = OFF_RPE + NH * T * T * 4;  // f32 [T][MS]
constexpr int OFF_NORM = OFF_MASK + T * MS * 4;   // f32 [q|k][h][T]
constexpr int OFF_POS = OFF_NORM + 2 * NH * T * 4;  // f32 [T][2]
constexpr int OFF_PAR = OFF_POS + 2 * T * 4;      // f32, see below
constexpr int SMEM = OFF_PAR + (8 * HID + 2 * NH) * 4;
static_assert(SMEM <= 232448, "shared memory beyond the H100's 227 KB");
static_assert(THREADS == 2 * NH * T, "one thread a row of q or k for norms");
static_assert(OFF_K % 16 == 0 && OFF_V % 16 == 0 && OFF_RPE % 16 == 0 &&
                  OFF_MASK % 16 == 0 && OFF_POS % 16 == 0 &&
                  OFF_PAR % 16 == 0,
              "cp.async, ldmatrix and float4 reads need 16-byte alignment");
// parameters: [k][8] = w1[0][k], w1[1][k], b1[k], 0, w2[k][0..3]; then
// b2[0..3], tau[0..3]
constexpr int PAR_B2 = 8 * HID;
constexpr int PAR_TAU = PAR_B2 + NH;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// every copy group but the newest N has landed (this thread's copies)
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// over the 4 lanes of a quad: the lanes that hold one row of a fragment
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// two floats as the bf16 pair of one fragment register (a in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4): acc[j][0..1]
// are row g, columns 8j + 2t + {0, 1}; acc[j][2..3] the same columns of
// row g + 8. A fragments: ldmatrix.x4 of rows 0-15 at columns k and k + 8.
// B fragments of two n-tiles: ldmatrix.x4 of the 16 (n) rows at k, k + 8.

// Copy group 1 of window win: its positions and its mask.
template <bool HAS_MASK>
__device__ __forceinline__ void stage_pos_mask(const float* __restrict__ pos,
                                               const float* __restrict__ mask,
                                               unsigned char* smem, int win,
                                               int nw_mask) {
  const int tid = threadIdx.x;
  if (tid < 2 * T / 4)
    cp_async16(reinterpret_cast<float*>(smem + OFF_POS) + 4 * tid,
               pos + (int64_t)win * 2 * T + 4 * tid);
  if constexpr (HAS_MASK) {
    const float* gm = mask + (int64_t)(win % nw_mask) * T * T;
    float* sm = reinterpret_cast<float*>(smem + OFF_MASK);
#pragma unroll
    for (int i = 0; i < T * T / 4 / THREADS; ++i) {
      const int e = tid + i * THREADS;
      cp_async16(sm + (e / (T / 4)) * MS + 4 * (e % (T / 4)), gm + 4 * e);
    }
  }
}

// Copy group 2 of window win: q and k.
__device__ __forceinline__ void stage_qk(const bf16* __restrict__ q,
                                         const bf16* __restrict__ k,
                                         unsigned char* smem, int win) {
  const int64_t base = (int64_t)win * NH * T * HD;
  bf16* sq = reinterpret_cast<bf16*>(smem + OFF_Q);
  bf16* sk = reinterpret_cast<bf16*>(smem + OFF_K);
#pragma unroll
  for (int i = 0; i < NH * T * HD / 8 / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;  // 16-byte chunk of row e / 8
    const int r = e / (HD / 8), c = e % (HD / 8);
    cp_async16(sq + r * SS + 8 * c, q + base + 8 * e);
    cp_async16(sk + r * SS + 8 * c, k + base + 8 * e);
  }
}

// Copy group 3 of window win: v.
__device__ __forceinline__ void stage_v(const bf16* __restrict__ v,
                                        unsigned char* smem, int win) {
  const int64_t base = (int64_t)win * NH * T * HD;
  bf16* sv = reinterpret_cast<bf16*>(smem + OFF_V);
#pragma unroll
  for (int i = 0; i < NH * T * HD / 8 / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    cp_async16(sv + (e / (HD / 8)) * SS + 8 * (e % (HD / 8)),
               v + base + 8 * e);
  }
}

template <bool HAS_MASK>
__global__ void __launch_bounds__(THREADS, 1)
swin_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ pos,
                 const float* __restrict__ mask,
                 const float* __restrict__ w1, const float* __restrict__ b1,
                 const float* __restrict__ w2, const float* __restrict__ b2,
                 const float* __restrict__ tau, bf16* __restrict__ out,
                 int nw_mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bf16* sq = reinterpret_cast<const bf16*>(smem + OFF_Q);
  const bf16* sk = reinterpret_cast<const bf16*>(smem + OFF_K);
  const bf16* sv = reinterpret_cast<const bf16*>(smem + OFF_V);
  float2* srpe = reinterpret_cast<float2*>(smem + OFF_RPE);
  const float* smask = reinterpret_cast<const float*>(smem + OFF_MASK);
  float* snorm = reinterpret_cast<float*>(smem + OFF_NORM);
  const float* spos = reinterpret_cast<const float*>(smem + OFF_POS);
  float* spar = reinterpret_cast<float*>(smem + OFF_PAR);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rt = warp % RT, h = warp / RT;  // this warp's rows and head
  const int i0 = 16 * rt + g;               // its rows i0 and i0 + 8
  const int win = blockIdx.x;               // this block's window

  if (tid < HID) {
    float* p = spar + 8 * tid;
    p[0] = w1[tid];
    p[1] = w1[HID + tid];
    p[2] = b1[tid];
    p[3] = 0.0f;
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) p[4 + hh] = w2[tid * NH + hh];
  } else if (tid < HID + NH) {
    spar[PAR_B2 + tid - HID] = b2[tid - HID];
    spar[PAR_TAU + tid - HID] = tau[tid - HID];
  }
  stage_pos_mask<HAS_MASK>(pos, mask, smem, win, nw_mask);
  cp_async_commit();
  stage_qk(q, k, smem, win);
  cp_async_commit();
  stage_v(v, smem, win);
  cp_async_commit();

  cp_async_wait<2>();  // positions and mask (q, k, v in flight)
  __syncthreads();

  // ---- RPE table for all heads: warp w fills the units (rt, j) = w and
  // w + 16 (of RT x NT), each thread its 8 pairs (unit, r, c)
  {
    float rx[8], ry[8], acc[8][NH];
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int u = warp + 16 * (p >> 2);
      const int i = 16 * (u / NT) + g + 8 * ((p >> 1) & 1);
      const int j = 8 * (u % NT) + 2 * t4 + (p & 1);
      rx[p] = spos[2 * i] - spos[2 * j];
      ry[p] = spos[2 * i + 1] - spos[2 * j + 1];
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) acc[p][hh] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < HID; ++kk) {
      const float4 wa = reinterpret_cast<const float4*>(spar)[2 * kk];
      const float4 wb = reinterpret_cast<const float4*>(spar)[2 * kk + 1];
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const float hk =
            fmaxf(fmaf(ry[p], wa.y, fmaf(rx[p], wa.x, wa.z)), 0.0f);
        acc[p][0] = fmaf(hk, wb.x, acc[p][0]);
        acc[p][1] = fmaf(hk, wb.y, acc[p][1]);
        acc[p][2] = fmaf(hk, wb.z, acc[p][2]);
        acc[p][3] = fmaf(hk, wb.w, acc[p][3]);
      }
    }
#pragma unroll
    for (int p = 0; p < 8; p += 2) {
      const int u = warp + 16 * (p >> 2);
      const int r = (p >> 1) & 1;
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) {
        const float b2h = spar[PAR_B2 + hh];
        srpe[(((hh * RT + u / NT) * NT + u % NT) * 2 + r) * 32 + lane] =
            make_float2(acc[p][hh] + b2h, acc[p + 1][hh] + b2h);
      }
    }
  }

  cp_async_wait<1>();  // q and k
  __syncthreads();

  // ---- reciprocal norms: thread tid takes row tid % 256 of [h][T] of
  // q (1 / (|q| tau_h)), then of k (1 / |k|)
  {
    const int r = tid % (NH * T);
    const uint4* row =
        reinterpret_cast<const uint4*>((tid < NH * T ? sq : sk) + r * SS);
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      const uint4 u = row[c];
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
        s = fmaf(x.x, x.x, s);
        s = fmaf(x.y, x.y, s);
      }
    }
    const float n = sqrtf(s + 1e-12f);
    snorm[tid] = 1.0f / (tid < NH * T ? n * spar[PAR_TAU + r / T] : n);
  }
  __syncthreads();

  // ---- logits of rows i0, i0 + 8 of head h against all keys: q . k^T
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  {
    const bf16* a_p =
        sq + (h * T + 16 * rt + (lane & 15)) * SS + ((lane >> 4) << 3);
    const bf16* b_p = sk + (h * T + (lane & 7) + ((lane >> 4) << 3)) * SS +
                      (((lane >> 3) & 1) << 3);
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, a_p + kk);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        ldsm_x4(b, b_p + 8 * j * SS + kk);
        mma_bf16(acc[j], a, b[0], b[1]);
        mma_bf16(acc[j + 1], a, b[2], b[3]);
      }
    }
  }
  // l = (q . k) / (|q| tau |k|) + rpe [+ mask], in the accumulators
  {
    const float* qn = snorm + h * T;
    const float* kn = snorm + NH * T + h * T;
    const float2* tb = srpe + (h * RT + rt) * NT * 2 * 32 + lane;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 knj =
          *reinterpret_cast<const float2*>(kn + 8 * j + 2 * t4);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float qni = qn[i0 + 8 * r];
        const float2 bias = tb[(j * 2 + r) * 32];
        float l0 = acc[j][2 * r] * qni * knj.x + bias.x;
        float l1 = acc[j][2 * r + 1] * qni * knj.y + bias.y;
        if constexpr (HAS_MASK) {
          const float2 m = *reinterpret_cast<const float2*>(
              smask + (i0 + 8 * r) * MS + 8 * j + 2 * t4);
          l0 = l0 + m.x;
          l1 = l1 + m.y;
        }
        acc[j][2 * r] = l0;
        acc[j][2 * r + 1] = l1;
      }
    }
  }

  // ---- P = bf16(softmax(l)) per row: max and sum over the row's quad,
  // each a tree over the thread's 16 values
  uint32_t pa[T / 16][4];  // A fragments of P . v, keys 16 kk ..
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float t[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      t[j] = fmaxf(acc[j][2 * r], acc[j][2 * r + 1]);
#pragma unroll
    for (int w = NT / 2; w > 0; w /= 2)
#pragma unroll
      for (int j = 0; j < w; ++j) t[j] = fmaxf(t[j], t[j + w]);
    const float m = quad_max(t[0]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][2 * r] = expf(acc[j][2 * r] - m);
      acc[j][2 * r + 1] = expf(acc[j][2 * r + 1] - m);
      t[j] = acc[j][2 * r] + acc[j][2 * r + 1];
    }
#pragma unroll
    for (int w = NT / 2; w > 0; w /= 2)
#pragma unroll
      for (int j = 0; j < w; ++j) t[j] += t[j + w];
    const float rs = 1.0f / quad_sum(t[0]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      pa[j / 2][2 * (j & 1) + r] =
          pack_bf16(acc[j][2 * r] * rs, acc[j][2 * r + 1] * rs);
  }

  cp_async_wait<0>();  // v
  __syncthreads();
  // ---- out = bf16(P . v): columns 8 j .. of rows i0, i0 + 8
  {
    float o[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
    const bf16* b_p = sv +
                      (h * T + (lane & 7) + (((lane >> 3) & 1) << 3)) * SS +
                      ((lane >> 4) << 3);
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk)
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, b_p + 16 * kk * SS + 8 * j);
        mma_bf16(o[j], pa[kk], b[0], b[1]);
        mma_bf16(o[j + 1], pa[kk], b[2], b[3]);
      }
    bf16* dst = out + (((int64_t)win * NH + h) * T + i0) * HD + 2 * t4;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(o[j][0], o[j][1]);
      *reinterpret_cast<uint32_t*>(dst + 8 * HD + 8 * j) =
          pack_bf16(o[j][2], o[j][3]);
    }
  }
}

// One block per window. The shared-memory attribute is set once per
// device, on its first launch there.
template <bool HAS_MASK>
int launch(const bf16* q, const bf16* k, const bf16* v, const float* pos,
           const float* mask, const float* w1, const float* b1,
           const float* w2, const float* b2, const float* tau, bf16* out,
           int nw, int nw_mask, cudaStream_t stream) {
  constexpr int MAX_DEVICES = 64;
  static bool ready[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    if ((err = cudaFuncSetAttribute(
             swin_attn_kernel<HAS_MASK>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM)) !=
        cudaSuccess)
      return (int)err;
    ready[dev] = true;
  }
  swin_attn_kernel<HAS_MASK><<<nw, THREADS, SMEM, stream>>>(
      q, k, v, pos, mask, w1, b1, w2, b2, tau, out, nw_mask);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ptt_swin_attn_bf16(const void* q, const void* k, const void* v,
                                  const void* pos, const void* mask,
                                  const void* w1, const void* b1,
                                  const void* w2, const void* b2,
                                  const void* tau, void* out, int nw, int nh,
                                  int nw_mask, void* stream) {
  if (nh != NH) return (int)cudaErrorInvalidValue;
  const auto* q_ = (const bf16*)q;
  const auto* k_ = (const bf16*)k;
  const auto* v_ = (const bf16*)v;
  const auto* pos_ = (const float*)pos;
  const auto* w1_ = (const float*)w1;
  const auto* b1_ = (const float*)b1;
  const auto* w2_ = (const float*)w2;
  const auto* b2_ = (const float*)b2;
  const auto* tau_ = (const float*)tau;
  auto* o_ = (bf16*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  if (mask != nullptr)
    return launch<true>(q_, k_, v_, pos_, (const float*)mask, w1_, b1_, w2_,
                        b2_, tau_, o_, nw, nw_mask, s);
  return launch<false>(q_, k_, v_, pos_, nullptr, w1_, b1_, w2_, b2_, tau_,
                       o_, nw, nw_mask, s);
}
