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
// post-ReLU, so cells no point reaches read 0. Points whose coords fall
// outside the canvas are dropped. Two entry points: bf16 (the model's
// compute dtype) and float32 (the float32 configuration, which the
// card-against-CPU train check runs). C is a multiple of 8.
//
// What bounds it on the H100: bytes. At the flagship frame the call must
// write the 94.4 MB canvas once (the wrapper's zero fill) and read the kept
// rows once (180,000 x 64 bf16, 23 MB, and their coords): 0.036 ms at
// 3.35 TB/s. The fill is most of that. Beside it the kernel reads 27.6 MB
// of features and 3.5 MB of coords and mask, and its reductions read and
// write back each touched cell row through L2 (the canvas does not fit in
// its 50 MB). Measured (PERF.md), the fill takes about half the call; the
// kernel's own time is mostly its loads, whose latency each block waits
// out twice (the mask, then the coords and the slab): without its
// reductions it is barely faster.
//
// Design, against what held the first version (one thread per (point,
// channel pair), a compare-and-swap loop on each 32-bit canvas word) back:
// - Point-major, coalesced reductions. A block takes a tile of TP = 128
//   points across all channels. It reads each point's mask and coords once
//   (the first version read them once per channel pair, ~90 MB) and the
//   tile's channel-major slab with 16-byte loads along the points, and
//   transposes the slab in shared memory into point-major rows: 64 bf16
//   channels are 128 bytes, one canvas cell row. Eight threads of 16 bytes
//   then cover a row, so one warp instruction reduces four whole 128-byte
//   cell rows, not 32 scattered words.
// - No return value, no retry loop: bf16 rows go out as
//   red.global.v4.bf16x2.max (sm_90; REDG.E.MAX.BF16x8, eight bf16 maxima
//   in one 16-byte reduction), float32 rows as red.global.max.s32 on the
//   bits (atomicMax with its result unused; there is no float32 max
//   reduction), a warp on 128 contiguous bytes of one row.
// - Values <= 0 are replaced by +0 before the reduction, and a 16-byte
//   chunk that holds no value > 0 is skipped: a value <= 0 cannot raise a
//   zero cell, and the -0.0 a masked stem row carries (0x8000) never
//   reaches the canvas. For float32, values > 0 order as their bits do as
//   signed integers. Max is exact and does not depend on order, so the
//   result is the same every run.
// - The tile's mask is read first, and a tile with no kept point returns
//   (the padded tail of the point buffer); then its coords and its slab
//   are loaded together, the coords held in registers until the slab is
//   in shared memory. Loading every tile's slab without that check, one
//   wait fewer, measured slower (PERF.md).
// - The slab goes through shared memory in slices of 128-byte rows (64
//   bf16 or 32 float32 channels, 16 KB), so any C that is a multiple of 8
//   fits.
// - The 16-byte loads serve tiles inside P when P and x allow them (P a
//   multiple of 8 in bf16, of 4 in float32, x 16-byte aligned); the ragged
//   tail tile and other P take scalar loads in the same kernel.
// The zero fill stays in the wrapper: a counting sort by cell that writes
// each cell once needs no fill and no atomics, but takes three or more
// launches and a scan on a frame that is host-bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TP = 128;       // points a tile
constexpr int THREADS = 256;
constexpr int CS_BF16 = 64;   // channels a slice of the slab: 128-byte rows
constexpr int CS_F32 = 32;
static_assert(TP <= THREADS, "a thread reads the coords of one point");

// Whether the tile holds a kept point: its mask, read before anything else
// (false: the block has nothing to do).
__device__ __forceinline__ bool tile_kept(const bool* __restrict__ mask,
                                          int b, int p0, int n, int P) {
  const int i = threadIdx.x;
  return __syncthreads_or(i < n && mask[(int64_t)b * P + p0 + i]);
}

// The coords of point p0 + threadIdx.x, held in registers from before the
// slab's loads until after them, so that both are in flight together.
struct PointCell {
  int z = 0, y = 0, xx = 0;
  bool keep = false;

  __device__ __forceinline__ void load(const int* __restrict__ coords,
                                       const bool* __restrict__ mask, int b,
                                       int p0, int n, int P) {
    const int i = threadIdx.x;
    if (i < n) {
      const int* co = coords + (int64_t)b * 3 * P + p0 + i;
      keep = mask[(int64_t)b * P + p0 + i];
      z = co[0];
      y = co[P];
      xx = co[2 * P];
    }
  }

  // cell[i]: the row of point p0 + i in its sample's canvas, or -1 when it
  // is masked, past P or outside the canvas
  __device__ __forceinline__ void store(int* cell, int cz, int cy,
                                        int cx) const {
    const int i = threadIdx.x;
    const bool in = keep && z >= 0 && z < cz && y >= 0 && y < cy && xx >= 0 &&
                    xx < cx;
    if (i < TP) cell[i] = in ? (y * cx + xx) * cz + z : -1;
  }
};

// bf16: rows[i * cs / 2 + k] holds channels c0 + 2k, c0 + 2k + 1 of point
// p0 + i (a word each, the lower channel in the low half).
template <bool VEC>
__device__ __forceinline__ void stage_slab_bf16(
    const uint16_t* __restrict__ x, uint32_t* rows, int64_t row0, int P,
    int p0, int n, int cs) {
  const int pairs = cs / 2;
  if (VEC && n == TP) {
    // a thread: one channel pair, 16 points (two 32-byte runs)
    for (int e = threadIdx.x; e < pairs * (TP / 16); e += THREADS) {
      const int k = e % pairs, grp = e / pairs;
      const uint4* r0 = reinterpret_cast<const uint4*>(
          x + (row0 + 2 * k) * P + p0 + 16 * grp);
      const uint4* r1 = reinterpret_cast<const uint4*>(
          reinterpret_cast<const uint16_t*>(r0) + P);
      const uint4 a[2] = {__ldg(r0), __ldg(r0 + 1)};
      const uint4 c[2] = {__ldg(r1), __ldg(r1 + 1)};
      uint32_t* dst = rows + 16 * grp * pairs + k;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t lo[4] = {a[h].x, a[h].y, a[h].z, a[h].w};
        const uint32_t hi[4] = {c[h].x, c[h].y, c[h].z, c[h].w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int j = 8 * h + 2 * w;
          dst[j * pairs] = __byte_perm(lo[w], hi[w], 0x5410);
          dst[(j + 1) * pairs] = __byte_perm(lo[w], hi[w], 0x7632);
        }
      }
    }
  } else {
    for (int e = threadIdx.x; e < pairs * TP; e += THREADS) {
      const int k = e % pairs, i = e / pairs;
      uint32_t w = 0u;
      if (i < n) {
        const uint16_t* s = x + (row0 + 2 * k) * P + p0 + i;
        w = (uint32_t)s[0] | ((uint32_t)s[P] << 16);
      }
      rows[i * pairs + k] = w;
    }
  }
}

// float32: rows[i * cs + k] is channel c0 + k of point p0 + i.
template <bool VEC>
__device__ __forceinline__ void stage_slab_f32(const float* __restrict__ x,
                                               float* rows, int64_t row0,
                                               int P, int p0, int n, int cs) {
  if (VEC && n == TP) {
    // a thread: one channel, 8 points (one 32-byte run)
    for (int e = threadIdx.x; e < cs * (TP / 8); e += THREADS) {
      const int k = e % cs, grp = e / cs;
      const float4* r = reinterpret_cast<const float4*>(
          x + (row0 + k) * P + p0 + 8 * grp);
      const float4 a = __ldg(r), c = __ldg(r + 1);
      const float v[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
      float* dst = rows + 8 * grp * cs + k;
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[j * cs] = v[j];
    }
  } else {
    for (int e = threadIdx.x; e < cs * TP; e += THREADS) {
      const int k = e % cs, i = e / cs;
      rows[i * cs + k] = i < n ? x[(row0 + k) * P + p0 + i] : 0.0f;
    }
  }
}

// a word of two bf16 with each value <= 0 replaced by +0
__device__ __forceinline__ uint32_t positive_bf16x2(uint32_t w) {
  return w & __vcmpgts2(w, 0u);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
scatter_max_bf16_kernel(const uint16_t* __restrict__ x,
                        const int* __restrict__ coords,
                        const bool* __restrict__ mask,
                        __nv_bfloat16* __restrict__ canvas, int P, int C,
                        int cz, int cy, int cx) {
  __shared__ __align__(16) uint32_t rows[TP * CS_BF16 / 2];
  __shared__ int cell[TP];
  const int b = blockIdx.y, p0 = blockIdx.x * TP;
  const int n = min(TP, P - p0);
  if (!tile_kept(mask, b, p0, n, P)) return;
  PointCell pc;
  pc.load(coords, mask, b, p0, n, P);
  const int64_t cells = (int64_t)cz * cy * cx;
  for (int c0 = 0; c0 < C; c0 += CS_BF16) {
    const int cs = min(CS_BF16, C - c0), chunks = cs / 8;
    if (c0) __syncthreads();  // the previous slice's reductions are done
    stage_slab_bf16<VEC>(x, rows, (int64_t)b * C + c0, P, p0, n, cs);
    if (c0 == 0) pc.store(cell, cz, cy, cx);
    __syncthreads();
    // a thread: 16 bytes (8 channels) of one point's row
    for (int e = threadIdx.x; e < TP * chunks; e += THREADS) {
      const int i = e / chunks, q = e % chunks;
      const int cl = cell[i];
      if (cl < 0) continue;
      uint4 v = reinterpret_cast<const uint4*>(rows + i * (cs / 2))[q];
      v.x = positive_bf16x2(v.x);
      v.y = positive_bf16x2(v.y);
      v.z = positive_bf16x2(v.z);
      v.w = positive_bf16x2(v.w);
      if ((v.x | v.y | v.z | v.w) == 0u) continue;
      __nv_bfloat16* dst = canvas + (b * cells + cl) * C + c0 + 8 * q;
      asm volatile(
          "red.global.v4.bf16x2.max.noftz [%0], {%1, %2, %3, %4};\n" ::"l"(
              dst),
          "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
          : "memory");
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
scatter_max_f32_kernel(const float* __restrict__ x,
                       const int* __restrict__ coords,
                       const bool* __restrict__ mask, int* __restrict__ canvas,
                       int P, int C, int cz, int cy, int cx) {
  __shared__ __align__(16) float rows[TP * CS_F32];
  __shared__ int cell[TP];
  const int b = blockIdx.y, p0 = blockIdx.x * TP;
  const int n = min(TP, P - p0);
  if (!tile_kept(mask, b, p0, n, P)) return;
  PointCell pc;
  pc.load(coords, mask, b, p0, n, P);
  const int64_t cells = (int64_t)cz * cy * cx;
  for (int c0 = 0; c0 < C; c0 += CS_F32) {
    const int cs = min(CS_F32, C - c0);
    if (c0) __syncthreads();
    stage_slab_f32<VEC>(x, rows, (int64_t)b * C + c0, P, p0, n, cs);
    if (c0 == 0) pc.store(cell, cz, cy, cx);
    __syncthreads();
    // a warp: 32 neighbouring channels of one point's row, 128 bytes
    for (int e = threadIdx.x; e < TP * cs; e += THREADS) {
      const int i = e / cs, k = e % cs;
      const int cl = cell[i];
      const int v = __float_as_int(rows[i * cs + k]);
      if (cl >= 0 && v > 0)
        atomicMax(canvas + (b * cells + cl) * C + c0 + k, v);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" int ptt_scatter_max_bf16(const void* x, const void* coords,
                                    const void* mask, void* canvas, int B,
                                    int P, int C, int cz, int cy, int cx,
                                    void* stream) {
  if (C % 8 != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((P + TP - 1) / TP, B);
  const auto s = (cudaStream_t)stream;
  const auto* x_ = (const uint16_t*)x;
  const auto* co = (const int*)coords;
  const auto* m = (const bool*)mask;
  auto* out = (__nv_bfloat16*)canvas;
  if (P % 8 == 0 && aligned16(x))
    scatter_max_bf16_kernel<true><<<grid, THREADS, 0, s>>>(x_, co, m, out, P,
                                                           C, cz, cy, cx);
  else
    scatter_max_bf16_kernel<false><<<grid, THREADS, 0, s>>>(x_, co, m, out, P,
                                                            C, cz, cy, cx);
  return (int)cudaGetLastError();
}

extern "C" int ptt_scatter_max_f32(const void* x, const void* coords,
                                   const void* mask, void* canvas, int B,
                                   int P, int C, int cz, int cy, int cx,
                                   void* stream) {
  if (C % 8 != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((P + TP - 1) / TP, B);
  const auto s = (cudaStream_t)stream;
  const auto* x_ = (const float*)x;
  const auto* co = (const int*)coords;
  const auto* m = (const bool*)mask;
  auto* out = (int*)canvas;
  if (P % 4 == 0 && aligned16(x))
    scatter_max_f32_kernel<true><<<grid, THREADS, 0, s>>>(x_, co, m, out, P,
                                                          C, cz, cy, cx);
  else
    scatter_max_f32_kernel<false><<<grid, THREADS, 0, s>>>(x_, co, m, out, P,
                                                           C, cz, cy, cx);
  return (int)cudaGetLastError();
}
