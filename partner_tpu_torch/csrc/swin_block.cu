// Whole-block fused SwinVote transformer block for the PARTNER E2E head
// (sm_90a).
//
// Replaces the TPU kernel partner_tpu/ops/swin_block_pallas.py:
// swin_vote_block (the pl.pallas_call at :253). Plain twin, parameter
// packing, bias table and wrapper: partner_tpu_torch/ops/swin_block.py.
//
// Computes one SwinVote block on a map that tiles into 8x8 windows (C 256,
// 4 heads of 64, MLP hidden 256, vote-MLP hidden 16), per window of T = 64
// tokens, with the TPU kernel's cast points (bf16 = the compute dtype):
//   x   = f32(bf16 input)                         residual stream, f32
//   y   = bf16(LN1(x))                            eps 1e-6, two-pass variance
//   vh  = relu(vote . Wv1 + bv1)                  f32
//   per head h:
//     e   = vh . Wv2[:, h] + bv2[h]               f32 vote embed
//     q, k, v = (y . Wqkv_h) + bqkv_h + e         f32 accumulation
//     qh  = bf16(q * (itau_h / |q|)),  kh = bf16(k / |k|)
//     l   = qh . kh^T + bias[window, h]           bias: RPE + region mask
//     P   = bf16(softmax(l))
//     o_h = bf16(P . bf16(v))                     f32 accumulation
//   x1  = x + concat_h(o_h) . Wproj + bproj       f32 sum over heads
//   y2  = bf16(LN2(x1))
//   g   = bf16(gelu_tanh(y2 . W1 + b1))           tanhf, not tanh.approx
//   out = bf16(x1 + (g . W2 + b2))
// with |a| = sqrt(sum a^2 + 1e-12).
//
// What bounds it on the H100: per window ~27 M multiply-adds in bf16
// products (qkv 12.6 M, proj and the two MLP layers 4.2 M each, attention
// 2.1 M) on 32 KB of input, and 0.8 MB of bf16 weights that every window
// reads again (they stay in the 50 MB L2). So tensor-core issue and the
// latency of the weight reads, not device-memory bytes.
// Design: one 256-thread block (8 warps) per window; the whole window
// stays in dynamic shared memory (184 KB: the f32 residual stream, the
// bf16 LayerNorm output, the four heads' outputs, one head's q/k/v and
// its f32 logits), so nothing between the block's input and output
// touches device memory. Every product is mma.sync m16n8k16 bf16 -> f32:
// warp w owns rows 16 (w % 4) .. +15 and half w / 4 of the output
// columns; the A operand comes from shared memory and the weights (torch's
// (out, in) layout, K contiguous) are read straight from global memory
// into the B fragments. LayerNorm and softmax are one warp per 8 rows with
// shuffles. wgmma, TMA and a persistent schedule are left to a later
// version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WS = 8;
constexpr int T = WS * WS;  // tokens per window
constexpr int C = 256;
constexpr int NH = 4;
constexpr int HD = 64;
constexpr int HID = 16;  // vote-MLP hidden width
constexpr int MLP = 256;  // MLP hidden width
constexpr int THREADS = 256;

// shared row strides in elements: 16 bytes of padding put the 8 rows of an
// mma fragment load in distinct banks
constexpr int SA = C + 8;   // bf16 rows of 256: y, heads' outputs, GELU out
constexpr int SH = HD + 8;  // bf16 rows of 64: qh (then P), kh, v^T
constexpr int SX = C + 4;   // f32 rows of the residual stream
constexpr int SL = T + 4;   // f32 rows of the vote embed, then the logits

// shared layout, bytes
constexpr int OFF_X = 0;                      // f32 [T][SX]   x, then x1
constexpr int OFF_Y = OFF_X + T * SX * 4;     // bf16 [T][SA]  y, y2, output
constexpr int OFF_O = OFF_Y + T * SA * 2;     // bf16 [T][SA]  o_h, then g
constexpr int OFF_Q = OFF_O + T * SA * 2;     // bf16 [T][SH]  qh, then P
constexpr int OFF_K = OFF_Q + T * SH * 2;     // bf16 [T][SH]  kh
constexpr int OFF_V = OFF_K + T * SH * 2;     // bf16 [HD][SH] v^T
constexpr int OFF_L = OFF_V + HD * SH * 2;    // f32 [T][SL]   e, then l
constexpr int OFF_VH = OFF_L + T * SL * 4;    // f32 [T][HID]  vh
constexpr int OFF_SS = OFF_VH + T * HID * 4;  // f32 [2][2][T] row sums of
                                              // squares (q|k, column half)
constexpr int SMEM = OFF_SS + 4 * T * 4;
static_assert(SMEM <= 232448, "shared memory beyond the H100's 227 KB");
static_assert(MLP == C, "g reuses the heads' output buffer");

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ void sts_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// acc[j] += A[0:16, 0:K] . B_j[0:8, 0:K]^T for j < NT. A: 16 bf16 rows in
// shared memory, row stride lda. brow(j): the first of the 8 bf16 rows of
// B_j (row stride ldb, K contiguous), in global memory when B_GLOBAL.
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4): acc[j][0..1]
// are row g, columns 8j + 2t + {0, 1}; acc[j][2..3] the same columns of
// row g + 8.
template <int NT, bool B_GLOBAL, class BRow>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4],
                                          const bf16* A, int lda, BRow brow,
                                          int ldb, int K) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* a_lo = A + g * lda + 2 * t;
  const bf16* a_hi = a_lo + 8 * lda;
  const int boff = g * ldb + 2 * t;
  for (int k0 = 0; k0 < K; k0 += 16) {
    const uint32_t a0 = lds32(a_lo + k0), a1 = lds32(a_hi + k0);
    const uint32_t a2 = lds32(a_lo + k0 + 8), a3 = lds32(a_hi + k0 + 8);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const bf16* bp = brow(j) + boff + k0;
      const uint32_t b0 = B_GLOBAL ? ldg32(bp) : lds32(bp);
      const uint32_t b1 = B_GLOBAL ? ldg32(bp + 8) : lds32(bp + 8);
      mma_bf16(acc[j], a0, a1, a2, a3, b0, b1);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.0f;
}

// LayerNorm of the 64 f32 rows of src into bf16 dst, warp w taking rows
// 8w .. 8w + 7: xc = x - mean, xc * rsqrt(mean(xc^2) + 1e-6) * s + b.
__device__ __forceinline__ void layer_norm_rows(const float* src, bf16* dst,
                                                const float* __restrict__ s,
                                                const float* __restrict__ b) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = 0; r < T / 8; ++r) {
    const int i = warp * (T / 8) + r;
    float v[C / 32];
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < C / 32; ++k) {
      v[k] = src[i * SX + lane + 32 * k];
      sum += v[k];
    }
    const float mu = warp_sum(sum) / C;
    float sq = 0.0f;
#pragma unroll
    for (int k = 0; k < C / 32; ++k) {
      v[k] -= mu;
      sq = fmaf(v[k], v[k], sq);
    }
    const float rs = rsqrtf(warp_sum(sq) / C + 1e-6f);
#pragma unroll
    for (int k = 0; k < C / 32; ++k) {
      const int c = lane + 32 * k;
      dst[i * SA + c] = __float2bfloat16(v[k] * rs * s[c] + b[c]);
    }
  }
}

__device__ __forceinline__ float gelu_tanh(float v) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return v * (0.5f * (1.0f + tanhf(k0 * (v + 0.044715f * (v * v * v)))));
}

__global__ void __launch_bounds__(THREADS, 1)
swin_block_kernel(const bf16* __restrict__ x, const float* __restrict__ vote,
                  const float* __restrict__ bias,
                  const float* __restrict__ ln1s,
                  const float* __restrict__ ln1b,
                  const bf16* __restrict__ qkvw,
                  const float* __restrict__ qkvb,
                  const float* __restrict__ vw1,
                  const float* __restrict__ vb1,
                  const float* __restrict__ vw2,
                  const float* __restrict__ vb2,
                  const float* __restrict__ itau,
                  const bf16* __restrict__ projw,
                  const float* __restrict__ projb,
                  const float* __restrict__ ln2s,
                  const float* __restrict__ ln2b,
                  const bf16* __restrict__ f1w,
                  const float* __restrict__ f1b,
                  const bf16* __restrict__ f2w,
                  const float* __restrict__ f2b, bf16* __restrict__ out,
                  int nwy, int nwx) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sx = reinterpret_cast<float*>(smem + OFF_X);
  bf16* sy = reinterpret_cast<bf16*>(smem + OFF_Y);
  bf16* so = reinterpret_cast<bf16*>(smem + OFF_O);
  bf16* sq = reinterpret_cast<bf16*>(smem + OFF_Q);
  bf16* sk = reinterpret_cast<bf16*>(smem + OFF_K);
  bf16* svt = reinterpret_cast<bf16*>(smem + OFF_V);
  float* sl = reinterpret_cast<float*>(smem + OFF_L);
  float* svh = reinterpret_cast<float*>(smem + OFF_VH);
  float* sss = reinterpret_cast<float*>(smem + OFF_SS);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int mt = warp & 3;    // rows 16 mt .. 16 mt + 15
  const int half = warp >> 2;  // half of the output columns
  const int row0 = 16 * mt + g, row1 = row0 + 8;

  // window blockIdx.x = (b * nwy + wy) * nwx + wx; its token i = r * 8 + c
  // is the pixel (b, 8 wy + r, 8 wx + c) of the (B, 8 nwy, 8 nwx, .) maps
  const int wx = blockIdx.x % nwx;
  const int wy = (blockIdx.x / nwx) % nwy;
  const int b = blockIdx.x / (nwx * nwy);
  const int W = nwx * WS;
  auto pix = [&](int i) -> int64_t {
    return ((int64_t)b * nwy * WS + wy * WS + i / WS) * W + wx * WS + i % WS;
  };

  // ---- x (bf16, 16-byte loads) -> f32 residual stream; vote MLP hidden
  for (int e = tid; e < T * (C / 8); e += THREADS) {
    const int i = e / (C / 8), c8 = e % (C / 8);
    const uint4 raw =
        __ldg(reinterpret_cast<const uint4*>(x + pix(i) * C) + c8);
    const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int k = 0; k < 8; ++k) sx[i * SX + c8 * 8 + k] = __bfloat162float(v[k]);
  }
  for (int e = tid; e < T * HID; e += THREADS) {
    const int i = e / HID, kk = e % HID;
    const float* vp = vote + pix(i) * 3;
    float s = vp[0] * vw1[kk];
    s = fmaf(vp[1], vw1[HID + kk], s);
    s = fmaf(vp[2], vw1[2 * HID + kk], s);
    svh[i * HID + kk] = fmaxf(s + vb1[kk], 0.0f);
  }
  __syncthreads();
  layer_norm_rows(sx, sy, ln1s, ln1b);

  for (int h = 0; h < NH; ++h) {
    // ---- vote embed of head h: e[i][d] = vh[i] . Wv2[:, 64h + d] + bv2
    for (int e = tid; e < T * HD; e += THREADS) {
      const int i = e / HD, d = e % HD;
      float s = 0.0f;
#pragma unroll
      for (int kk = 0; kk < HID; ++kk)
        s = fmaf(svh[i * HID + kk], __ldg(vw2 + kk * C + h * HD + d), s);
      sl[i * SL + d] = s + vb2[h * HD + d];
    }
    __syncthreads();  // also: the previous head is done with sq, sk, svt

    // ---- [q | k | v] of head h: 192 columns = 24 tiles of 8, 12 a warp;
    // tile jj is part jj / 8 (q, k, v), columns 8 (jj % 8) .. of the part
    float acc[12][4];
    zero(acc);
    warp_gemm<12, true>(
        acc, sy + 16 * mt * SA, SA,
        [&](int j) {
          const int jj = 12 * half + j;
          return qkvw + (int64_t)((jj / 8) * C + h * HD + (jj % 8) * 8) * C;
        },
        C, C);
    float ssq[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};  // [q|k][row0|row1]
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const int jj = 12 * half + j, part = jj / 8;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = r < 2 ? row0 : row1;
        const int d = (jj % 8) * 8 + 2 * t4 + (r & 1);
        const float v =
            acc[j][r] + qkvb[part * C + h * HD + d] + sl[i * SL + d];
        acc[j][r] = v;
        if (part < 2) ssq[part][r >> 1] = fmaf(v, v, ssq[part][r >> 1]);
      }
    }
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float s = ssq[p][rr];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (t4 == 0) sss[(p * 2 + half) * T + (rr ? row1 : row0)] = s;
      }
    __syncthreads();
    {
      const float it = itau[h];
      float qs[2], kn[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = rr ? row1 : row0;
        qs[rr] = it / sqrtf(sss[i] + sss[T + i] + 1e-12f);
        kn[rr] = sqrtf(sss[2 * T + i] + sss[3 * T + i] + 1e-12f);
      }
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const int jj = 12 * half + j, part = jj / 8;
        const int d = (jj % 8) * 8 + 2 * t4;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = rr ? row1 : row0;
          const float v0 = acc[j][2 * rr], v1 = acc[j][2 * rr + 1];
          if (part == 0) {
            sts_pair(sq + i * SH + d, v0 * qs[rr], v1 * qs[rr]);
          } else if (part == 1) {
            sts_pair(sk + i * SH + d, v0 / kn[rr], v1 / kn[rr]);
          } else {
            svt[d * SH + i] = __float2bfloat16(v0);
            svt[(d + 1) * SH + i] = __float2bfloat16(v1);
          }
        }
      }
    }
    __syncthreads();

    // ---- logits l = qh . kh^T + bias: 64 columns, 4 tiles a warp
    {
      float la[4][4];
      zero(la);
      warp_gemm<4, false>(
          la, sq + 16 * mt * SH, SH,
          [&](int j) { return sk + (32 * half + 8 * j) * SH; }, SH, HD);
      const float* bw = bias + ((int64_t)blockIdx.x * NH + h) * T * T;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = rr ? row1 : row0;
          const int c = 32 * half + 8 * j + 2 * t4;
          const float2 bb = __ldg(reinterpret_cast<const float2*>(bw + i * T + c));
          sl[i * SL + c] = la[j][2 * rr] + bb.x;
          sl[i * SL + c + 1] = la[j][2 * rr + 1] + bb.y;
        }
    }
    __syncthreads();

    // ---- P = bf16(softmax(l)) into the qh buffer, warp w rows 8w .. +7
    for (int r = 0; r < T / 8; ++r) {
      const int i = warp * (T / 8) + r;
      const float l0 = sl[i * SL + lane], l1 = sl[i * SL + lane + 32];
      const float mx = warp_max(fmaxf(l0, l1));
      const float e0 = expf(l0 - mx), e1 = expf(l1 - mx);
      const float s = warp_sum(e0 + e1);
      sq[i * SH + lane] = __float2bfloat16(e0 / s);
      sq[i * SH + lane + 32] = __float2bfloat16(e1 / s);
    }
    __syncthreads();

    // ---- o_h = bf16(P . v) into columns 64h .. of the heads' outputs
    {
      float oa[4][4];
      zero(oa);
      warp_gemm<4, false>(
          oa, sq + 16 * mt * SH, SH,
          [&](int j) { return svt + (32 * half + 8 * j) * SH; }, SH, T);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = h * HD + 32 * half + 8 * j + 2 * t4;
        sts_pair(so + row0 * SA + c, oa[j][0], oa[j][1]);
        sts_pair(so + row1 * SA + c, oa[j][2], oa[j][3]);
      }
    }
  }
  __syncthreads();

  // 256-column products below: 16 tiles of 8 a warp
  auto rows_of = [&](const bf16* w) {
    return [=](int j) { return w + (int64_t)(128 * half + 8 * j) * C; };
  };

  // ---- x1 = x + o . Wproj + bproj (in place in the residual stream)
  {
    float acc[16][4];
    zero(acc);
    warp_gemm<16, true>(acc, so + 16 * mt * SA, SA, rows_of(projw), C, C);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = r < 2 ? row0 : row1;
        const int c = 128 * half + 8 * j + 2 * t4 + (r & 1);
        sx[i * SX + c] = sx[i * SX + c] + acc[j][r] + projb[c];
      }
  }
  __syncthreads();
  layer_norm_rows(sx, sy, ln2s, ln2b);
  __syncthreads();

  // ---- g = bf16(gelu(y2 . W1 + b1)) into the heads' output buffer
  {
    float acc[16][4];
    zero(acc);
    warp_gemm<16, true>(acc, sy + 16 * mt * SA, SA, rows_of(f1w), C, C);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 128 * half + 8 * j + 2 * t4;
      sts_pair(so + row0 * SA + c, gelu_tanh(acc[j][0] + f1b[c]),
               gelu_tanh(acc[j][1] + f1b[c + 1]));
      sts_pair(so + row1 * SA + c, gelu_tanh(acc[j][2] + f1b[c]),
               gelu_tanh(acc[j][3] + f1b[c + 1]));
    }
  }
  __syncthreads();

  // ---- out = bf16(x1 + (g . W2 + b2)), staged in the y buffer
  {
    float acc[16][4];
    zero(acc);
    warp_gemm<16, true>(acc, so + 16 * mt * SA, SA, rows_of(f2w), MLP, MLP);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = rr ? row1 : row0;
        const int c = 128 * half + 8 * j + 2 * t4;
        sts_pair(sy + i * SA + c,
                 sx[i * SX + c] + (acc[j][2 * rr] + f2b[c]),
                 sx[i * SX + c + 1] + (acc[j][2 * rr + 1] + f2b[c + 1]));
      }
  }
  __syncthreads();
  for (int e = tid; e < T * (C / 8); e += THREADS) {
    const int i = e / (C / 8), c8 = e % (C / 8);
    reinterpret_cast<uint4*>(out + pix(i) * C)[c8] =
        reinterpret_cast<const uint4*>(sy + i * SA)[c8];
  }
}

}  // namespace

extern "C" int ptt_swin_block_bf16(
    const void* x, const void* vote, const void* bias, const void* ln1s,
    const void* ln1b, const void* qkvw, const void* qkvb, const void* vw1,
    const void* vb1, const void* vw2, const void* vb2, const void* itau,
    const void* projw, const void* projb, const void* ln2s, const void* ln2b,
    const void* f1w, const void* f1b, const void* f2w, const void* f2b,
    void* out, int B, int nwy, int nwx, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      swin_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  swin_block_kernel<<<B * nwy * nwx, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)vote, (const float*)bias,
      (const float*)ln1s, (const float*)ln1b, (const bf16*)qkvw,
      (const float*)qkvb, (const float*)vw1, (const float*)vb1,
      (const float*)vw2, (const float*)vb2, (const float*)itau,
      (const bf16*)projw, (const float*)projb, (const float*)ln2s,
      (const float*)ln2b, (const bf16*)f1w, (const float*)f1b,
      (const bf16*)f2w, (const float*)f2b, (bf16*)out, nwy, nwx);
  return (int)cudaGetLastError();
}
