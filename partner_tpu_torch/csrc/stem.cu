// Fused two-layer point stem for the PARTNER point fast path (sm_90a).
//
// Replaces the TPU kernel partner_tpu/ops/stem_pallas.py:stem2_channel_major
// (the pl.pallas_call at :79). Plain twin and wrapper:
// partner_tpu_torch/ops/stem.py.
//
// Computes, per point p of x (B, C_in, P) bf16, channel-major, for the
// point-path widths of the repo's configs, C_in = 8 (the cuboid nuScenes
// configs' 5 point features + 3 decorations), 10 (7 + 3) and 11 (the
// two-sweep configs' 8 + 3), each its own instantiation of the kernel
// template on CIN:
//   h   = relu(fl(bf16(W1 x) * m) * a1 + b1)          -> bf16, 32 wide
//   out = relu(fl(bf16(W2 h) * m) * a2 + b2)          -> bf16, 64 wide
// with f32 accumulation, m the point mask, and a/b the folded inference
// BatchNorm (a = scale * rsqrt(var + 1e-3), b = shift - mean * a) computed
// by the wrapper. The bf16 round trips are the TPU kernel's.
//
// What bounds it on the H100: by its algorithm, bytes. A point reads 20 B
// (C_in 10) of features and 1 B of mask and writes 128 B; at P = 216,000
// that is
// 32 MB, 0.0096 ms at 3.35 TB/s, 86% of it the output. Its 1.02 GFLOP of
// products would take 0.015 ms on the float32 units alone, more than the
// byte bound, so they run on the tensor cores (0.001 ms at the bf16 peak).
// Measured (PERF.md), the kernel without its output stores is barely
// faster: the instructions of the epilogues (~6 a value, 96 values a
// point) and their latency set its time.
//
// Design, against what held the first version (one thread per point, all
// 2,368 multiply-adds in f32 on the CUDA cores beside a shared-memory
// weight load each, 2-byte output stores) back:
// - Both layers on mma.sync m16n8k16 (bf16 in, f32 accumulators), points
//   as M: a tile of TP = 64 points is one m-tile for each of a block's 4
//   warps.
// - A persistent grid (the blocks that fit on the SMs at once) walks the
//   tiles. Each block reads the B fragments of W1 and W2 (W is N x K with
//   K contiguous, the col layout mma wants) into 40 registers once, and
//   copies the next tile's x and mask into the second of two shared
//   buffers by cp.async (16-byte copies along the points, 4-byte for the
//   mask) while it computes the current one.
// - x stays channel-major in shared memory, rows C_in-15 zeros (K padded
//   to 16); ldmatrix.x4.trans gives the A fragments straight from that layout
//   (rows padded to 72 values: the 8 row addresses of a phase fall in
//   distinct 16-byte bank groups).
// - Layer 1 feeds layer 2 from registers: the m16n8 accumulators of
//   hidden columns 16 kk .. 16 kk + 15 are exactly the m16k16 A fragment
//   of layer 2's k-step kk, so the hidden layer is rounded, masked,
//   normalised and packed in place and never touches shared memory.
// - Both epilogues round as the twin does: bf16 of the accumulator, times
//   the mask, __fmul_rn / __fadd_rn (no FMA contraction), ReLU, bf16. They
//   take two neighbouring columns at a time (one bf16x2 conversion each
//   way, the four affine values of the pair in one float4).
// - Layer 2's bf16 pairs go to a (64 channels x 64 points) output tile in
//   shared memory by stmatrix.trans, which turns the accumulator layout
//   into channel rows; the tile is then written channel row by channel
//   row with 16-byte stores along the points.
// - Any P: the 16-byte copies and stores serve tiles inside P when P is a
//   multiple of 8 and x, out and the mask are aligned; the ragged tail
//   tile and other P take scalar loads and stores in the same kernel. A
//   sample's x starts at b * C_in * P values, a multiple of 8 with P for
//   any C_in, so the 16-byte path holds at 11 as at 10.
// Numerics: bf16 x bf16 products are exact in f32, but the tensor cores
// add them in another order (and not as a chain of IEEE adds) than the
// twin's f32 matmul, so a bf16 rounding of a hidden value or an output can
// flip by one ulp; the kernel is held to the twin at 2^-7 (1 + |twin|),
// and chip_smoke.py reports how many outputs are not equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int K1 = 16;  // CIN padded to the mma's K
constexpr int F1 = 32;
constexpr int F2 = 64;
constexpr int TP = 64;  // points a tile
constexpr int THREADS = 128;
constexpr int SXS = TP + 8;  // row stride of the staged x and output, bf16
static_assert(16 * (THREADS / 32) == TP, "a warp takes one m-tile");
// shared layout, bytes: two x buffers [K1][SXS], output [F2][SXS], two
// mask buffers [TP], a1 b1 a2 b2
constexpr int XBUF = K1 * SXS * 2;
constexpr int OFF_SO = 2 * XBUF;
constexpr int OFF_MASK = OFF_SO + F2 * SXS * 2;
constexpr int OFF_AB = OFF_MASK + 2 * TP;
constexpr int SMEM = OFF_AB + (2 * F1 + 2 * F2) * 4;
static_assert(SMEM <= 48 * 1024, "no opt-in to more shared memory");
static_assert(OFF_AB % 16 == 0, "the affines are read as float4");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
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

// two floats as the bf16 pair of one fragment register (a in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// the twin's epilogue on two neighbouring columns of one row, rounded to a
// bf16 pair: relu(fl(bf16(acc) * m) * a + b) for (acc0, ab.x, ab.z) and
// (acc1, ab.y, ab.w)
__device__ __forceinline__ uint32_t epilogue2(float acc0, float acc1, float m,
                                              float4 ab) {
  const float2 t = __bfloat1622float2(__floats2bfloat162_rn(acc0, acc1));
  return pack_bf16(fmaxf(__fadd_rn(__fmul_rn(t.x * m, ab.x), ab.z), 0.0f),
                   fmaxf(__fadd_rn(__fmul_rn(t.y * m, ab.y), ab.w), 0.0f));
}

// four 8x8 bf16 matrices stored transposed; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void stsm_x4_trans(const uint32_t (&r)[4],
                                              bf16* p) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, "
      "%4};\n" ::"r"(smem_addr(p)),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4): acc[j][0..1]
// are row g, columns 8j + 2t + {0, 1}; acc[j][2..3] the same columns of
// row g + 8. A fragment a[0..3]: rows g, g + 8 at k 2t, then at k 2t + 8.
// B fragment of n-tile j: b0 = B[k 2t, 2t + 1][n g], b1 = the same at
// k 2t + 8; B[k][n] = W[n][k], so a register is two neighbouring W values.

// Copies tile t (sample t / tiles, points p0 = (t % tiles) TP ..) of x and
// the mask into buffer buf: 16-byte and 4-byte cp.async for a whole tile on
// the vector path, plain loads otherwise (zeros past P).
template <int CIN, bool VEC>
__device__ __forceinline__ void stage(const bf16* __restrict__ x,
                                      const uint8_t* __restrict__ mask,
                                      unsigned char* smem, int buf, int t,
                                      int tiles, int P) {
  const int tid = threadIdx.x;
  const int64_t b = t / tiles;
  const int p0 = (t % tiles) * TP, n = min(TP, P - p0);
  const bf16* xb = x + b * CIN * P + p0;
  const uint8_t* mb = mask + b * P + p0;
  bf16* sx = reinterpret_cast<bf16*>(smem + buf * XBUF);
  uint8_t* sm = smem + OFF_MASK + buf * TP;
  if (VEC && n == TP) {
    for (int e = tid; e < CIN * TP / 8; e += THREADS) {
      const int r = e / (TP / 8), c = e % (TP / 8);
      cp_async16(sx + r * SXS + 8 * c, xb + (int64_t)r * P + 8 * c);
    }
    for (int e = tid; e < TP / 4; e += THREADS)
      cp_async4(sm + 4 * e, mb + 4 * e);
  } else {
    for (int e = tid; e < CIN * TP; e += THREADS) {
      const int r = e / TP, i = e % TP;
      sx[r * SXS + i] =
          i < n ? xb[(int64_t)r * P + i] : __float2bfloat16(0.0f);
    }
    for (int i = tid; i < TP; i += THREADS) sm[i] = i < n ? mb[i] : 0;
  }
}

template <int CIN, bool VEC>
__global__ void __launch_bounds__(THREADS)
stem2_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ mask,
             const bf16* __restrict__ w1, const float* __restrict__ a1,
             const float* __restrict__ b1, const bf16* __restrict__ w2,
             const float* __restrict__ a2, const float* __restrict__ b2,
             bf16* __restrict__ out, int P, int tiles, int total) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* so = reinterpret_cast<bf16*>(smem + OFF_SO);
  // the affines of column pair k: {a[2k], a[2k + 1], b[2k], b[2k + 1]}
  float4* ab1 = reinterpret_cast<float4*>(smem + OFF_AB);
  const float4* ab2 = ab1 + F1 / 2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;

  int t = blockIdx.x;
  static_assert(CIN >= 8 && CIN <= K1, "K rows 0-7 of W1 are all read");
  stage<CIN, VEC>(x, mask, smem, 0, t, tiles, P);
  asm volatile("cp.async.commit_group;\n" ::);
  // K padded with zero rows in both buffers; the affines
  for (int e = tid; e < 2 * (K1 - CIN) * TP / 2; e += THREADS) {
    const int buf = e / ((K1 - CIN) * TP / 2);
    const int r = CIN + (e / (TP / 2)) % (K1 - CIN), w = e % (TP / 2);
    reinterpret_cast<uint32_t*>(smem + buf * XBUF + r * SXS * 2)[w] = 0u;
  }
  for (int e = tid; e < (F1 + F2) / 2; e += THREADS) {
    const bool l1 = e < F1 / 2;
    const int k = 2 * (l1 ? e : e - F1 / 2);
    const float* a = l1 ? a1 : a2;
    const float* bb = l1 ? b1 : b2;
    ab1[e] = make_float4(a[k], a[k + 1], bb[k], bb[k + 1]);
  }

  // ---- B fragments, once a block
  const uint16_t* w1u = reinterpret_cast<const uint16_t*>(w1);
  const uint32_t* w2u = reinterpret_cast<const uint32_t*>(w2);
  uint32_t bw1[F1 / 8][2];
#pragma unroll
  for (int j = 0; j < F1 / 8; ++j) {
    const uint16_t* r = w1u + (8 * j + g) * CIN;
    bw1[j][0] = (uint32_t)__ldg(r + 2 * t4) |
                ((uint32_t)__ldg(r + 2 * t4 + 1) << 16);
    // k 2t + 8 and 2t + 9, zero at and past CIN (the padded K rows): at
    // C_in 8 none reads, at 10 only t = 0, at 11 also t = 1 its low half
    const int k = 2 * t4 + 8;
    bw1[j][1] = (k < CIN ? (uint32_t)__ldg(r + k) : 0u) |
                ((k + 1 < CIN ? (uint32_t)__ldg(r + k + 1) : 0u) << 16);
  }
  uint32_t bw2[F2 / 8][F1 / 16][2];
#pragma unroll
  for (int j = 0; j < F2 / 8; ++j)
#pragma unroll
    for (int kk = 0; kk < F1 / 16; ++kk) {
      const uint32_t* r = w2u + ((8 * j + g) * F1 + 16 * kk) / 2;
      bw2[j][kk][0] = __ldg(r + t4);
      bw2[j][kk][1] = __ldg(r + 4 + t4);
    }

  for (int it = 0; t < total; t += gridDim.x, ++it) {
    const int buf = it & 1;
    // the next tile's copies go out before this one is computed
    if (t + gridDim.x < total)
      stage<CIN, VEC>(x, mask, smem, buf ^ 1, t + gridDim.x, tiles, P);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const bf16* sx = reinterpret_cast<const bf16*>(smem + buf * XBUF);
    const uint8_t* sm = smem + OFF_MASK + buf * TP;

    const int m0 = 16 * warp;  // this warp's m-tile
    const float m[2] = {sm[m0 + g] ? 1.0f : 0.0f,
                        sm[m0 + g + 8] ? 1.0f : 0.0f};
    // layer 1: rows m0 .. m0 + 15 against the 32 hidden columns, one
    // k-step
    uint32_t a[4];
    ldsm_x4_trans(a, sx + (((lane >> 4) << 3) + (lane & 7)) * SXS + m0 +
                         (((lane >> 3) & 1) << 3));
    float acc1[F1 / 8][4];
#pragma unroll
    for (int j = 0; j < F1 / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[j][e] = 0.0f;
      mma_bf16(acc1[j], a, bw1[j][0], bw1[j][1]);
    }
    // its epilogue, packed in place into layer 2's A fragments
    uint32_t ha[F1 / 16][4];
#pragma unroll
    for (int j = 0; j < F1 / 8; ++j) {
      const float4 ab = ab1[4 * j + t4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        ha[j / 2][2 * (j & 1) + r] =
            epilogue2(acc1[j][2 * r], acc1[j][2 * r + 1], m[r], ab);
    }
    // layer 2: 64 output columns, two k-steps, two n-tiles at a time; the
    // epilogue's bf16 pairs go to the tile by one stmatrix.trans: matrices
    // (n-tile j, rows 0-7), (j, rows 8-15), (j + 1, 0-7), (j + 1, 8-15)
#pragma unroll
    for (int j = 0; j < F2 / 8; j += 2) {
      uint32_t o[4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int kk = 0; kk < F1 / 16; ++kk)
          mma_bf16(acc, ha[kk], bw2[j + jj][kk][0], bw2[j + jj][kk][1]);
        const float4 ab = ab2[4 * (j + jj) + t4];
        o[2 * jj] = epilogue2(acc[0], acc[1], m[0], ab);
        o[2 * jj + 1] = epilogue2(acc[2], acc[3], m[1], ab);
      }
      stsm_x4_trans(o, so +
                           (8 * j + ((lane >> 4) << 3) + (lane & 7)) * SXS +
                           m0 + (((lane >> 3) & 1) << 3));
    }
    __syncthreads();

    // ---- the output tile, channel row by channel row
    const int64_t b = t / tiles;
    const int p0 = (t % tiles) * TP, n = min(TP, P - p0);
    bf16* ob = out + b * F2 * P + p0;
    if (VEC && n == TP) {
      for (int e = tid; e < F2 * TP / 8; e += THREADS) {
        const int f = e / (TP / 8), c = e % (TP / 8);
        *reinterpret_cast<uint4*>(ob + (int64_t)f * P + 8 * c) =
            *reinterpret_cast<const uint4*>(so + f * SXS + 8 * c);
      }
    } else {
      for (int e = tid; e < F2 * TP; e += THREADS) {
        const int f = e / TP, i = e % TP;
        if (i < n) ob[(int64_t)f * P + i] = so[f * SXS + i];
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Blocks of the persistent grid on the current device (SMs x blocks that
// fit on one), worked out once per device and instantiation.
template <int CIN, bool VEC>
int persistent_slots(int* slots) {
  constexpr int MAX_DEVICES = 64;
  static int cached[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  int& c = cached[dev];
  if (c == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, stem2_kernel<CIN, VEC>, THREADS, SMEM)) != cudaSuccess)
      return (int)err;
    c = sms * per_sm;
  }
  *slots = c;
  return 0;
}

template <int CIN, bool VEC>
int launch(const bf16* x, const uint8_t* mask, const bf16* w1,
           const float* a1, const float* b1, const bf16* w2, const float* a2,
           const float* b2, bf16* out, int B, int P, cudaStream_t s) {
  const int tiles = (P + TP - 1) / TP, total = B * tiles;
  int slots = 0;
  const int err = persistent_slots<CIN, VEC>(&slots);
  if (err) return err;
  stem2_kernel<CIN, VEC><<<total < slots ? total : slots, THREADS, SMEM, s>>>(
      x, mask, w1, a1, b1, w2, a2, b2, out, P, tiles, total);
  return (int)cudaGetLastError();
}

}  // namespace

// cin selects the instantiation: 8, 10 or 11, else cudaErrorInvalidValue.
extern "C" int ptt_stem2_bf16(const void* x, const void* mask, const void* w1,
                              const void* a1, const void* b1, const void* w2,
                              const void* a2, const void* b2, void* out,
                              int B, int P, int cin, void* stream) {
  // the B fragments read W2 as 32-bit words
  if (reinterpret_cast<uintptr_t>(w2) & 3u) return (int)cudaErrorInvalidValue;
  const auto s = (cudaStream_t)stream;
  const auto* x_ = (const bf16*)x;
  const auto* m_ = (const uint8_t*)mask;
  const auto* w1_ = (const bf16*)w1;
  const auto* w2_ = (const bf16*)w2;
  const auto* a1_ = (const float*)a1;
  const auto* b1_ = (const float*)b1;
  const auto* a2_ = (const float*)a2;
  const auto* b2_ = (const float*)b2;
  auto* o_ = (bf16*)out;
  const bool vec = P % 8 == 0 && aligned16(x) && aligned16(out) &&
                   (reinterpret_cast<uintptr_t>(mask) & 3u) == 0;
#define PTT_STEM_LAUNCH(C, V) \
  launch<C, V>(x_, m_, w1_, a1_, b1_, w2_, a2_, b2_, o_, B, P, s)
  switch (cin) {
    case 8:
      return vec ? PTT_STEM_LAUNCH(8, true) : PTT_STEM_LAUNCH(8, false);
    case 10:
      return vec ? PTT_STEM_LAUNCH(10, true) : PTT_STEM_LAUNCH(10, false);
    case 11:
      return vec ? PTT_STEM_LAUNCH(11, true) : PTT_STEM_LAUNCH(11, false);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PTT_STEM_LAUNCH
}
