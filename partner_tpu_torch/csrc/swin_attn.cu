// Fused vote-Swin window attention for the PARTNER E2E head (sm_90a).
//
// Replaces the TPU kernel partner_tpu/ops/swin_attn_pallas.py:
// swin_vote_attention (the pl.pallas_call at :137). Plain twin and wrapper:
// partner_tpu_torch/ops/swin_attn.py.
//
// Computes, for one window w and head h (T = 64 tokens, hd = 64):
//   rel_ij = pos_i - pos_j                                   (f32)
//   rpe_ij = sum_k relu(rel_ij . W1[:, k] + b1_k) W2[k, h] + b2_h
//   l_ij   = (q_i . k_j) / (|q_i| |k_j|) / tau_h + rpe_ij [+ mask_ij]
//   out_i  = sum_j bf16(softmax_j(l_ij)) v_j                  -> bf16
// with |x| = sqrt(sum x^2 + 1e-12) and f32 accumulation throughout, as the
// TPU kernel does (logits divided by the norm product, not pre-normalized
// operands).
//
// What bounds it on the H100: a small tile. One (window, head) reads 24 KB
// of q/k/v and writes 8 KB, and does 0.5 MFMA of products plus the
// 4,096-pair RPE MLP; at 576 windows x 4 heads the whole call moves ~75 MB
// (~25 us at 3.35 TB/s). The work per tile is shared-memory reads, not
// device-memory bytes or tensor-core rate.
// Design: one 256-thread block per (window, head); q/k/v are copied once
// into shared memory with 16-byte loads (rows padded to 72 values so the
// k-row reads of a warp spread over the banks), the 64x64 f32 logits stay
// in shared memory, the RPE MLP is evaluated in registers from the 64
// positions, softmax is one warp per row group with shuffles, and each
// thread keeps a 4x4 register tile of the logits and of the output. The
// logits, the RPE table and the softmax never touch device memory, and the
// unshifted blocks take a template without the mask (no zero mask is
// streamed). Tensor cores (mma/wgmma) are left to a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 64;
constexpr int HD = 64;
constexpr int HID = 16;
constexpr int THREADS = 256;
constexpr int SS = HD + 8;  // padded shared row stride of q/k/v (bf16)
constexpr int LS = T + 1;   // padded shared row stride of the logits (f32)

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <bool HAS_MASK>
__global__ void __launch_bounds__(THREADS)
swin_attn_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const float* __restrict__ pos,
                 const float* __restrict__ mask,
                 const float* __restrict__ w1, const float* __restrict__ b1,
                 const float* __restrict__ w2, const float* __restrict__ b2,
                 const float* __restrict__ tau,
                 __nv_bfloat16* __restrict__ out, int nh, int nw_mask) {
  __shared__ __align__(16) __nv_bfloat16 sq[T * SS];
  __shared__ __align__(16) __nv_bfloat16 sk[T * SS];
  __shared__ __align__(16) __nv_bfloat16 sv[T * SS];
  __shared__ float sl[T * LS];
  __shared__ float spos[2 * T];
  __shared__ float sqn[T], skn[T];
  __shared__ float sw1[2 * HID], sb1[HID], sw2[HID];

  const int tid = threadIdx.x;
  const int w = blockIdx.x / nh;
  const int h = blockIdx.x % nh;
  const int64_t base = (int64_t)blockIdx.x * T * HD;  // (w * nh + h) tile

  // ---- stage q, k, v (16-byte vectors), positions and RPE params
  {
    const uint4* gq = reinterpret_cast<const uint4*>(q + base);
    const uint4* gk = reinterpret_cast<const uint4*>(k + base);
    const uint4* gv = reinterpret_cast<const uint4*>(v + base);
    uint4* q4 = reinterpret_cast<uint4*>(sq);
    uint4* k4 = reinterpret_cast<uint4*>(sk);
    uint4* v4 = reinterpret_cast<uint4*>(sv);
    constexpr int VPR = HD / 8;  // 16-byte vectors per row
    constexpr int SPR = SS / 8;
    for (int i = tid; i < T * VPR; i += THREADS) {
      const int r = i / VPR, c = i % VPR;
      q4[r * SPR + c] = gq[i];
      k4[r * SPR + c] = gk[i];
      v4[r * SPR + c] = gv[i];
    }
  }
  for (int i = tid; i < 2 * T; i += THREADS)
    spos[i] = pos[(int64_t)w * 2 * T + i];
  if (tid < 2 * HID) sw1[tid] = w1[tid];
  if (tid < HID) {
    sb1[tid] = b1[tid];
    sw2[tid] = w2[tid * nh + h];
  }
  __syncthreads();

  // ---- row norms: threads 0..63 take q rows, 64..127 k rows
  if (tid < 2 * T) {
    const __nv_bfloat16* row = (tid < T ? sq : sk) + (tid % T) * SS;
    float s = 0.0f;
    for (int d = 0; d < HD; ++d) {
      const float x = __bfloat162float(row[d]);
      s = fmaf(x, x, s);
    }
    (tid < T ? sqn : skn)[tid % T] = sqrtf(s + 1e-12f);
  }
  __syncthreads();

  // ---- logits: thread (ti, tj) owns rows 4ti..4ti+3, cols tj + 16c
  const int ti = tid >> 4;
  const int tj = tid & 15;
  {
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
    for (int d = 0; d < HD; d += 2) {
      float2 qa[4], kb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qa[r] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            &sq[(ti * 4 + r) * SS + d]));
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kb[c] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            &sk[(tj + 16 * c) * SS + d]));
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[r][c] = fmaf(qa[r].x, kb[c].x, acc[r][c]);
          acc[r][c] = fmaf(qa[r].y, kb[c].y, acc[r][c]);
        }
    }
    const float tau_h = tau[h];
    const float b2_h = b2[h];
    const float* mrow =
        HAS_MASK ? mask + (int64_t)(w % nw_mask) * T * T : nullptr;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ti * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tj + 16 * c;
        float l = acc[r][c] / (sqn[i] * skn[j]);
        l = l / tau_h;
        const float rx = spos[2 * i] - spos[2 * j];
        const float ry = spos[2 * i + 1] - spos[2 * j + 1];
        float rpe = 0.0f;
#pragma unroll
        for (int kk = 0; kk < HID; ++kk) {
          const float hk = fmaf(ry, sw1[HID + kk], rx * sw1[kk]) + sb1[kk];
          rpe = fmaf(fmaxf(hk, 0.0f), sw2[kk], rpe);
        }
        l = l + (rpe + b2_h);
        if constexpr (HAS_MASK) l = l + mrow[i * T + j];
        sl[i * LS + j] = l;
      }
    }
  }
  __syncthreads();

  // ---- softmax: warp wid takes rows 8wid..8wid+7, lane takes cols
  // lane and lane + 32; probabilities are rounded to bf16 (the dtype of v)
  {
    const int lane = tid & 31;
    const int wid = tid >> 5;
    for (int rr = 0; rr < T / 8; ++rr) {
      float* row = sl + (wid * (T / 8) + rr) * LS;
      const float x0 = row[lane];
      const float x1 = row[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float e0 = expf(x0 - mx);
      const float e1 = expf(x1 - mx);
      float s = e0 + e1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      row[lane] = round_bf16(e0 / s);
      row[lane + 32] = round_bf16(e1 / s);
    }
  }
  __syncthreads();

  // ---- out = P V: thread (ti, td) owns rows 4ti..4ti+3, cols 4td..4td+3
  {
    const int td = tid & 15;
    float o[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[r][c] = 0.0f;
    for (int j = 0; j < T; ++j) {
      const __nv_bfloat162* vr =
          reinterpret_cast<const __nv_bfloat162*>(&sv[j * SS + td * 4]);
      const float2 v01 = __bfloat1622float2(vr[0]);
      const float2 v23 = __bfloat1622float2(vr[1]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float pj = sl[(ti * 4 + r) * LS + j];
        o[r][0] = fmaf(pj, v01.x, o[r][0]);
        o[r][1] = fmaf(pj, v01.y, o[r][1]);
        o[r][2] = fmaf(pj, v23.x, o[r][2]);
        o[r][3] = fmaf(pj, v23.y, o[r][3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
          out + base + (ti * 4 + r) * HD + td * 4);
      dst[0] = __floats2bfloat162_rn(o[r][0], o[r][1]);
      dst[1] = __floats2bfloat162_rn(o[r][2], o[r][3]);
    }
  }
}

}  // namespace

extern "C" int ptt_swin_attn_bf16(const void* q, const void* k, const void* v,
                                  const void* pos, const void* mask,
                                  const void* w1, const void* b1,
                                  const void* w2, const void* b2,
                                  const void* tau, void* out, int nw, int nh,
                                  int nw_mask, void* stream) {
  const dim3 grid(nw * nh);
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* q_ = (const __nv_bfloat16*)q;
  const auto* k_ = (const __nv_bfloat16*)k;
  const auto* v_ = (const __nv_bfloat16*)v;
  auto* o_ = (__nv_bfloat16*)out;
  if (mask != nullptr) {
    swin_attn_kernel<true><<<grid, THREADS, 0, s>>>(
        q_, k_, v_, (const float*)pos, (const float*)mask, (const float*)w1,
        (const float*)b1, (const float*)w2, (const float*)b2,
        (const float*)tau, o_, nh, nw_mask);
  } else {
    swin_attn_kernel<false><<<grid, THREADS, 0, s>>>(
        q_, k_, v_, (const float*)pos, nullptr, (const float*)w1,
        (const float*)b1, (const float*)w2, (const float*)b2,
        (const float*)tau, o_, nh, nw_mask);
  }
  return (int)cudaGetLastError();
}
