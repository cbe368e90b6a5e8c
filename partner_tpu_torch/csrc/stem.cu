// Fused two-layer point stem for the PARTNER point fast path (sm_90a).
//
// Replaces the TPU kernel partner_tpu/ops/stem_pallas.py:stem2_channel_major
// (the pl.pallas_call at :79). Plain twin and wrapper:
// partner_tpu_torch/ops/stem.py.
//
// Computes, per point p of x (B, 10, P) bf16, channel-major:
//   h   = relu(fl(bf16(W1 x) * m) * a1 + b1)          -> bf16, 32 wide
//   out = relu(fl(bf16(W2 h) * m) * a2 + b2)          -> bf16, 64 wide
// with f32 accumulation, m the point mask, and a/b the folded inference
// BatchNorm (a = scale * rsqrt(var + 1e-3), b = shift - mean * a) computed
// by the wrapper. The bf16 round trips are the TPU kernel's.
//
// What bounds it on the H100: by its algorithm, bytes. A point reads 20 B
// of features and 1 B of mask and writes 128 B, against ~2.4k FMAs; at
// P = 216,000 that is ~32 MB of traffic (~10 us at 3.35 TB/s) and ~1 GFLOP
// of f32 FMA (~15 us at 67 TFLOP/s). This version runs at ~0.1 ms, ~10x
// that floor: it loads a weight from shared memory beside every FMA, and
// its 844 blocks fill the 132 SMs in under two waves, so instruction
// throughput and latency hold it, not bytes. Reusing each loaded weight
// for several points per thread is the next step.
// Design: one thread per point, so the channel-major rows are read and
// written coalesced across a warp (neighbouring threads, neighbouring
// points); the 2,368 weights and the folded affines sit in shared memory
// (every thread of a warp reads the same word: a broadcast), the 32 hidden
// values stay in registers, and nothing but the 64 outputs goes back to
// device memory. The affine is t * a + b without FMA contraction, so the
// kernel rounds exactly as the plain twin does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CIN = 10;
constexpr int F1 = 32;
constexpr int F2 = 64;
constexpr int THREADS = 256;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__global__ void __launch_bounds__(THREADS)
stem2_kernel(const __nv_bfloat16* __restrict__ x,
             const uint8_t* __restrict__ mask,
             const __nv_bfloat16* __restrict__ w1,
             const float* __restrict__ a1, const float* __restrict__ b1,
             const __nv_bfloat16* __restrict__ w2,
             const float* __restrict__ a2, const float* __restrict__ b2,
             __nv_bfloat16* __restrict__ out, int P) {
  __shared__ float sw1[F1 * CIN];
  __shared__ float sw2[F2 * F1];
  __shared__ float sa1[F1], sb1[F1], sa2[F2], sb2[F2];
  for (int i = threadIdx.x; i < F1 * CIN; i += THREADS)
    sw1[i] = __bfloat162float(w1[i]);
  for (int i = threadIdx.x; i < F2 * F1; i += THREADS)
    sw2[i] = __bfloat162float(w2[i]);
  for (int i = threadIdx.x; i < F1; i += THREADS) {
    sa1[i] = a1[i];
    sb1[i] = b1[i];
  }
  for (int i = threadIdx.x; i < F2; i += THREADS) {
    sa2[i] = a2[i];
    sb2[i] = b2[i];
  }
  __syncthreads();

  const int64_t p = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (p >= P) return;
  const int64_t b = blockIdx.y;
  const __nv_bfloat16* xb = x + b * CIN * (int64_t)P;
  const float m = mask[b * P + p] ? 1.0f : 0.0f;

  float xin[CIN];
#pragma unroll
  for (int c = 0; c < CIN; ++c) xin[c] = __bfloat162float(xb[c * (int64_t)P + p]);

  float h[F1];
#pragma unroll
  for (int f = 0; f < F1; ++f) {
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < CIN; ++c) acc = fmaf(sw1[f * CIN + c], xin[c], acc);
    float t = round_bf16(acc) * m;
    t = __fadd_rn(__fmul_rn(t, sa1[f]), sb1[f]);
    h[f] = round_bf16(fmaxf(t, 0.0f));
  }

  __nv_bfloat16* ob = out + b * F2 * (int64_t)P;
#pragma unroll 4
  for (int f = 0; f < F2; ++f) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < F1; ++j) acc = fmaf(sw2[f * F1 + j], h[j], acc);
    float t = round_bf16(acc) * m;
    t = __fadd_rn(__fmul_rn(t, sa2[f]), sb2[f]);
    ob[f * (int64_t)P + p] = __float2bfloat16(fmaxf(t, 0.0f));
  }
}

}  // namespace

extern "C" int ptt_stem2_bf16(const void* x, const void* mask, const void* w1,
                              const void* a1, const void* b1, const void* w2,
                              const void* a2, const void* b2, void* out,
                              int B, int P, void* stream) {
  dim3 grid((P + THREADS - 1) / THREADS, B);
  stem2_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)mask,
      (const __nv_bfloat16*)w1, (const float*)a1, (const float*)b1,
      (const __nv_bfloat16*)w2, (const float*)a2, (const float*)b2,
      (__nv_bfloat16*)out, P);
  return (int)cudaGetLastError();
}
