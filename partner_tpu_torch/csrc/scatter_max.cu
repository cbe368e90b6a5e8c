// Scatter-max of point features into the z-folded canvas for the PARTNER
// point backbone (sm_90a).
//
// Replaces the TPU kernel tools/probes/pallas_scatter_stripe.py:
// pallas_scatter (the pl.pallas_call at :101), the kernel candidate for the
// main path's scatter_canvas(fold2d=True) in
// partner_tpu/models/backbone_dense.py. Plain twin and wrapper:
// partner_tpu_torch/ops/scatter_max.py.
//
// Computes, for each unmasked point p of sample b and channel c,
//   canvas[b, (y_p * cx + x_p) * cz + z_p, c] = max over p of x[b, c, p]
// on a zero-initialized canvas (the wrapper zeroes it): the features are
// post-ReLU, so cells no point reaches read 0. Two entry points: bf16 (the
// model's compute dtype) and float32 (the float32 configuration, which the
// card-against-CPU train check runs).
//
// What bounds it on the H100: memory traffic and atomic round trips, not
// arithmetic. At the flagship frame it reads 216,000 x 64 bf16 features
// (27.6 MB) and their coords, and updates a 737,280 x 64 bf16 canvas
// (94 MB, zeroed by the wrapper) scattered one 32-bit word at a time.
// Design: one thread per (point, channel pair). Threads along x walk the
// points, so the channel-major feature rows of the stem are read
// coalesced as they are, with no transpose. Each thread does one
// compare-and-swap loop on the 32-bit canvas word that holds its two bf16
// channels. The TPU probe's sort-by-cell and per-stripe read-modify-write
// exist for a machine without atomics and are not carried over. The values
// are compared as floats (never as raw bf16 bits: the -0.0 a masked stem
// row can carry is 0x8000, which as an unsigned integer beats every
// positive value), and a value <= 0 is never written: it cannot raise a
// zero cell, so a pair with both values <= 0 skips its atomic. Max is exact
// and does not depend on order, so the result is the same every run.
// The float32 kernel takes one thread per (point, channel) and one
// atomicMax on the value's bits as a signed int: for values > 0 the bit
// patterns order as the floats do, and nothing <= 0 is written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float lo_bf16(unsigned int w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float hi_bf16(unsigned int w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Row of point p's cell in the canvas of all B samples (b * cells + cell);
// -1 when its coords fall outside the canvas.
__device__ __forceinline__ int64_t cell_of(const int* __restrict__ coords,
                                           int b, int p, int P, int cz,
                                           int cy, int cx) {
  const int* co = coords + (int64_t)b * 3 * P + p;
  const int z = co[0], y = co[P], xx = co[2 * P];
  if (z < 0 || z >= cz || y < 0 || y >= cy || xx < 0 || xx >= cx) return -1;
  return (int64_t)b * cz * cy * cx + ((int64_t)y * cx + xx) * cz + z;
}

__global__ void __launch_bounds__(THREADS)
scatter_max_kernel(const __nv_bfloat16* __restrict__ x,
                   const int* __restrict__ coords,
                   const bool* __restrict__ mask,
                   unsigned int* __restrict__ canvas, int P, int C, int cz,
                   int cy, int cx) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  const int cp = blockIdx.y;  // channel pair 2cp, 2cp + 1
  const int b = blockIdx.z;
  if (p >= P || !mask[(int64_t)b * P + p]) return;
  const __nv_bfloat16* xr = x + ((int64_t)b * C + 2 * cp) * P + p;
  const float v0 = __bfloat162float(xr[0]);
  const float v1 = __bfloat162float(xr[P]);
  if (!(v0 > 0.0f) && !(v1 > 0.0f)) return;
  const int64_t cell = cell_of(coords, b, p, P, cz, cy, cx);
  if (cell < 0) return;
  unsigned int* word = canvas + cell * (C / 2) + cp;
  const unsigned int b0 = __bfloat16_as_ushort(xr[0]);
  const unsigned int b1 = __bfloat16_as_ushort(xr[P]);
  // first guess: the zero the canvas starts at
  unsigned int old = 0u;
  while (true) {
    const bool up0 = v0 > lo_bf16(old);
    const bool up1 = v1 > hi_bf16(old);
    if (!up0 && !up1) break;
    const unsigned int nw = (up0 ? b0 : (old & 0xffffu)) |
                            (up1 ? (b1 << 16) : (old & 0xffff0000u));
    const unsigned int seen = atomicCAS(word, old, nw);
    if (seen == old) break;
    old = seen;
  }
}

__global__ void __launch_bounds__(THREADS)
scatter_max_f32_kernel(const float* __restrict__ x,
                       const int* __restrict__ coords,
                       const bool* __restrict__ mask, int* __restrict__ canvas,
                       int P, int C, int cz, int cy, int cx) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  if (p >= P || !mask[(int64_t)b * P + p]) return;
  const float v = x[((int64_t)b * C + c) * P + p];
  if (!(v > 0.0f)) return;
  const int64_t cell = cell_of(coords, b, p, P, cz, cy, cx);
  if (cell < 0) return;
  atomicMax(canvas + cell * C + c, __float_as_int(v));
}

}  // namespace

extern "C" int ptt_scatter_max_bf16(const void* x, const void* coords,
                                    const void* mask, void* canvas, int B,
                                    int P, int C, int cz, int cy, int cx,
                                    void* stream) {
  const dim3 grid((P + THREADS - 1) / THREADS, C / 2, B);
  scatter_max_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const int*)coords, (const bool*)mask,
      (unsigned int*)canvas, P, C, cz, cy, cx);
  return (int)cudaGetLastError();
}

extern "C" int ptt_scatter_max_f32(const void* x, const void* coords,
                                   const void* mask, void* canvas, int B,
                                   int P, int C, int cz, int cy, int cx,
                                   void* stream) {
  const dim3 grid((P + THREADS - 1) / THREADS, C, B);
  scatter_max_f32_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)coords, (const bool*)mask, (int*)canvas,
      P, C, cz, cy, cx);
  return (int)cudaGetLastError();
}
