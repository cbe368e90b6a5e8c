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
// What bounds it on the H100: per window 27.3 M multiply-adds in bf16
// products (qkv 12.6 M, proj and the two MLP layers 4.2 M each, attention
// 2.1 M) on 32 KB of bf16 input, 64 KB of f32 bias and 0.79 MB of bf16
// weights that every window needs. At the flagship shape (576 windows)
// that is 31.4 GFLOP against 76.7 MB of device memory: 0.032 ms at the
// bf16 tensor-core peak, so operations bound it; the weights stay in the
// 50 MB L2. In practice one window per SM runs its phases one after
// another (LayerNorm, products, epilogues, softmax, each behind a barrier),
// and their latency, not the tensor cores, sets the time: measured on an
// H100 SXM (700 W) by removing parts, the mma instructions of the four
// weight products account for ~20% of it and the weight copies for less
// than 10% (PERF.md; `tools/block_kernel_parts.py`).
//
// Design:
// - A persistent grid of (SMs x blocks per SM) blocks of 512 threads (16
//   warps) walks over the windows; one window at a time stays whole in
//   shared memory, so nothing between the block's input and output touches
//   device memory. Warp w owns rows 16 (w % 4) .. +15 of every product and
//   column group w / 4 (a quarter of the product's output columns, or of
//   the keys).
// - The four weight matrices stream through a two-stage ring of shared
//   memory in K-contiguous tiles of 64 columns (all N rows of the product:
//   192 for a head's [q | k | v], 256 for proj, fc1, fc2), copied by
//   cp.async (16 bytes a thread, L2 only). A window is 28 tiles: 4 per
//   head's qkv, then 4 each for proj, fc1 and fc2. Tile t + 1 is copied
//   while tile t feeds the tensor cores, and the stream runs on across
//   product boundaries and into the next window, so the copy of the next
//   product's first tile hides behind the epilogue and the attention. Each
//   block copies each weight byte once per window: 786,432 bytes, so
//   576 x 786,432 = 0.453 GB from L2 per call at the flagship shape (the
//   previous kernel's warps read every B fragment from L2 themselves, four
//   warps the same fragment: ~1.8 GB).
// - Every product is mma.sync m16n8k16 bf16 -> f32 with both operands
//   loaded by ldmatrix.x4 from shared memory (the v operand of P . V by
//   ldmatrix.trans from v's natural layout). Every bf16 row in shared
//   memory is padded by 16 bytes (strides of 528 and 144 bytes), so the 8
//   row addresses of each ldmatrix phase fall in 8 distinct 16-byte bank
//   groups.
// - Attention per head: the logits of a warp's 16 x 16 tile stay in its
//   mma accumulators; the softmax takes row maxima and sums by quad
//   shuffles and exchanges them with the three warps that hold the row's
//   other keys through shared memory and a 128-thread named barrier; P is
//   written in bf16 over the rows of qh the group has consumed. The vote
//   embed is computed in the qkv epilogue from vh and Wv2, both staged in
//   shared memory, into the fragment's own registers.
// - x arrives by cp.async as bf16 (f32(x) is exact, so it is not widened
//   in shared memory); x1 = x + proj, f32, is written over x and the
//   attention buffers once the heads are done and stays there through
//   LN2 and the fc2 epilogue.
//
// Shared memory (bytes):
//   while the heads run: x bf16 [64][264] 33,792; qh|P, kh, v bf16
//     [64][72] x 3 27,648; vh f32 [64][17] 4,352; row sums of squares and
//     the softmax exchange f32 [2][4][64] x 2 4,096          69,888
//   from the proj epilogue on: x1 f32 [64][260] 66,560 over the same bytes
//   y        bf16 [64][264]   LN1 out, LN2 out, output      33,792
//   o        bf16 [64][264]   heads' outputs, then g         33,792
//   weight ring  bf16 [2][256][72]                           73,728
//   Wv2      f32  [16][256]                                  16,384
//   total                                                   227,584
// So one block per SM (of 228 KB), and ptxas gives 125 registers a thread
// (the 512 threads fill the register file as well). Two windows in flight
// per SM, or wgmma (64-row warpgroup products straight from the ring), is
// the next step for this kernel.

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
constexpr int NQ = 4;  // column groups: warp w takes group w / 4
constexpr int THREADS = 4 * 32 * NQ;  // 16 warps: 4 row tiles x NQ groups
constexpr int NWARP = THREADS / 32;

// shared row strides in elements: 16 bytes of padding put the 8 rows of an
// ldmatrix phase in distinct bank groups
constexpr int SA = C + 8;     // bf16 rows of 256: y, heads' outputs, g
constexpr int SH = HD + 8;    // bf16 rows of 64: qh (then P), kh, v
constexpr int SX = C + 4;     // f32 rows of the residual stream
constexpr int SVH = HID + 1;  // f32 rows of vh

// the weight stream: K-contiguous tiles of KT columns, two stages
constexpr int KT = 64;
constexpr int SW = KT + 8;            // staged row stride (144 bytes)
constexpr int KTILES = C / KT;        // tiles per product (every K is 256)
constexpr int TILES = (NH + 3) * KTILES;  // per window: 4 qkv, proj, fc1, fc2
constexpr int STAGE = C * SW;         // elements of one stage (<= 256 rows)

// shared layout, bytes. The first region holds x (bf16) and the attention
// buffers while the heads run, then x1 (f32) from the proj epilogue on.
constexpr int OFF_X = 0;                        // bf16 [T][SA]  x
constexpr int OFF_Q = OFF_X + T * SA * 2;       // bf16 [T][SH]  qh, then P
constexpr int OFF_K = OFF_Q + T * SH * 2;       // bf16 [T][SH]  kh
constexpr int OFF_V = OFF_K + T * SH * 2;       // bf16 [T][SH]  v
constexpr int OFF_VH = OFF_V + T * SH * 2;      // f32 [T][SVH]  vh
constexpr int OFF_SS = OFF_VH + T * SVH * 4;    // f32 [q|k][group][T]
constexpr int OFF_RED = OFF_SS + 2 * NQ * T * 4;  // f32 [max|sum][group][T]
constexpr int OFF_X1 = 0;                       // f32 [T][SX]   x1
constexpr int OFF_Y = OFF_RED + 2 * NQ * T * 4;  // bf16 [T][SA] y, y2, out
constexpr int OFF_O = OFF_Y + T * SA * 2;       // bf16 [T][SA]  o_h, then g
constexpr int OFF_W = OFF_O + T * SA * 2;       // bf16 [2][STAGE]
constexpr int OFF_VW2 = OFF_W + 2 * STAGE * 2;  // f32 [HID][C]
constexpr int SMEM = OFF_VW2 + HID * C * 4;
static_assert(OFF_X1 + T * SX * 4 <= OFF_Y, "x1 overlays x .. red only");
static_assert(SMEM <= 232448, "shared memory beyond the H100's 227 KB");
static_assert(OFF_Q % 16 == 0 && OFF_Y % 16 == 0 && OFF_O % 16 == 0 &&
                  OFF_W % 16 == 0 && OFF_VW2 % 16 == 0,
              "cp.async and ldmatrix need 16-byte aligned rows");
static_assert(MLP == C, "g reuses the heads' output buffer; fc2's K is C");

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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

// the NQ warps mt, mt + 4, .., which own the same 16 rows
__device__ __forceinline__ void group_sync(int mt) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + mt), "r"(32 * NQ) : "memory");
}

__device__ __forceinline__ void sts_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.0f;
}

// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4): acc[j][0..1]
// are row g, columns 8j + 2t + {0, 1}; acc[j][2..3] the same columns of
// row g + 8. A fragments: ldmatrix.x4 of rows 0-15 at columns k and k + 8.
// B fragments of two n-tiles: ldmatrix.x4 of the 16 (n) rows at k, k + 8.

// acc[j] += A[0:16, 0:K] . B[8j:8j+8, 0:K]^T, A and B (n rows, K
// contiguous) in shared memory; with TRANS_B, B is stored (K rows, n
// contiguous) and acc[j] += A . B[0:K, 8j:8j+8].
template <int NT, bool TRANS_B>
__device__ __forceinline__ void gemm_smem(float (&acc)[NT][4], const bf16* A,
                                          int lda, const bf16* B, int ldb,
                                          int K) {
  const int lane = threadIdx.x & 31;
  const bf16* a_p = A + (lane & 15) * lda + ((lane >> 4) << 3);
  const bf16* b_p =
      TRANS_B ? B + ((lane & 7) + (((lane >> 3) & 1) << 3)) * ldb +
                    ((lane >> 4) << 3)
              : B + ((lane & 7) + ((lane >> 4) << 3)) * ldb +
                    (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int k = 0; k < K; k += 16) {
    uint32_t a[4];
    ldsm_x4(a, a_p + k);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      if (TRANS_B)
        ldsm_x4_trans(b, b_p + k * ldb + 8 * j);
      else
        ldsm_x4(b, b_p + 8 * j * ldb + k);
      mma_bf16(acc[j], a, b[0], b[1]);
      mma_bf16(acc[j + 1], a, b[2], b[3]);
    }
  }
}

// The weight stream of one block: tile t (counted over all of the block's
// windows) goes to ring stage t % 2.
struct Stream {
  const bf16* qkvw;
  const bf16* projw;
  const bf16* f1w;
  const bf16* f2w;
  bf16* ring;
  int t;    // the next tile a product consumes
  int end;  // tiles of all the block's windows
};

// Copy tile t into its stage, one cp.async group. Tile u = t % TILES of a
// window: product u / KTILES (head 0-3's [q | k | v] rows, then proj, fc1,
// fc2), columns KT (u % KTILES) .. + KT of all its rows (torch's (out, in)
// layout, K contiguous). Thread tid copies 16 bytes, columns 8 (tid % 8)
// .. + 7, of the staged rows tid / 8 + 32 i; a head's staged row
// 64 p + r is weight row p C + 64 h + r (part p of q, k, v).
constexpr int CH = KT / 8;       // 16-byte chunks of a staged row
constexpr int RSTEP = THREADS / CH;  // rows one pass of the block covers
static_assert(HD % RSTEP == 0, "a pass stays inside one part of q, k, v");
__device__ __forceinline__ void issue_tile(const Stream& s, int t) {
  const int u = t % TILES, prod = u / KTILES;
  const int r = threadIdx.x / CH, ch = (threadIdx.x % CH) * 8;
  const int col = (u % KTILES) * KT + ch;
  bf16* dst = s.ring + (t & 1) * STAGE + r * SW + ch;
  if (prod < NH) {
    const bf16* src = s.qkvw + (int64_t)(prod * HD + r) * C + col;
#pragma unroll
    for (int i = 0; i < 3 * HD / RSTEP; ++i)
      cp_async16(dst + i * RSTEP * SW,
                 src + ((int64_t)(i * RSTEP / HD) * C * C +
                        (i * RSTEP % HD) * C));
  } else {
    const bf16* src =
        (prod == NH ? s.projw : prod == NH + 1 ? s.f1w : s.f2w) +
        (int64_t)r * C + col;
#pragma unroll
    for (int i = 0; i < C / RSTEP; ++i)
      cp_async16(dst + i * RSTEP * SW, src + (int64_t)i * RSTEP * C);
  }
  cp_async_commit();
}

// acc[j] += A[0:16, 0:256] . W[brow0 + 8j .. + 8, 0:256]^T over the
// stream's next KTILES tiles. Each tile: wait for its copy, one barrier
// (the copy is visible to all, and every warp is done with the stage the
// next copy overwrites), start the next copy, then the products.
template <int NT>
__device__ __forceinline__ void gemm_stream(float (&acc)[NT][4], const bf16* A,
                                            int lda, int brow0, Stream& s) {
  const int lane = threadIdx.x & 31;
  const bf16* a_p = A + (lane & 15) * lda + ((lane >> 4) << 3);
  const int b_off = (brow0 + (lane & 7) + ((lane >> 4) << 3)) * SW +
                    (((lane >> 3) & 1) << 3);
  for (int kt = 0; kt < KTILES; ++kt) {
    cp_async_wait_all();
    __syncthreads();
    if (s.t + 1 < s.end) issue_tile(s, s.t + 1);
    const bf16* b_p = s.ring + (s.t & 1) * STAGE + b_off;
#pragma unroll
    for (int ks = 0; ks < KT; ks += 16) {
      uint32_t a[4];
      ldsm_x4(a, a_p + kt * KT + ks);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        ldsm_x4(b, b_p + 8 * j * SW + ks);
        mma_bf16(acc[j], a, b[0], b[1]);
        mma_bf16(acc[j + 1], a, b[2], b[3]);
      }
    }
    ++s.t;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// LayerNorm of the 64 rows of src (row stride ld; f32, or bf16 read
// exactly as f32) into bf16 dst, warp w taking rows 4w .. 4w + 3:
// xc = x - mean, xc * rsqrt(mean(xc^2) + 1e-6) * s + b.
template <class Src>
__device__ __forceinline__ void layer_norm_rows(const Src* src, int ld,
                                                bf16* dst,
                                                const float* __restrict__ s,
                                                const float* __restrict__ b) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 2
  for (int r = 0; r < T / NWARP; ++r) {
    const int i = warp * (T / NWARP) + r;
    float v[C / 32];
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < C / 32; ++k) {
      v[k] = to_f32(src[i * ld + lane + 32 * k]);
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
                  int nwin, int nwy, int nwx) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sx = reinterpret_cast<bf16*>(smem + OFF_X);
  float* sx1 = reinterpret_cast<float*>(smem + OFF_X1);
  bf16* sy = reinterpret_cast<bf16*>(smem + OFF_Y);
  bf16* so = reinterpret_cast<bf16*>(smem + OFF_O);
  bf16* sq = reinterpret_cast<bf16*>(smem + OFF_Q);
  bf16* sk = reinterpret_cast<bf16*>(smem + OFF_K);
  bf16* sv = reinterpret_cast<bf16*>(smem + OFF_V);
  float* svw2 = reinterpret_cast<float*>(smem + OFF_VW2);
  float* svh = reinterpret_cast<float*>(smem + OFF_VH);
  float* sss = reinterpret_cast<float*>(smem + OFF_SS);
  float* sred = reinterpret_cast<float*>(smem + OFF_RED);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int mt = warp & 3;     // rows 16 mt .. 16 mt + 15
  const int cq = warp >> 2;    // column group (of outputs, or of keys)
  const int row0 = 16 * mt + g, row1 = row0 + 8;

  if ((int)blockIdx.x >= nwin) return;
  const int my_windows = (nwin - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  Stream s{qkvw, projw, f1w, f2w, reinterpret_cast<bf16*>(smem + OFF_W), 0,
           my_windows * TILES};
  // Wv2 rides with the first tile's copy group
  for (int c = tid; c < HID * C / 4; c += THREADS)
    cp_async16(svw2 + 4 * c, vw2 + 4 * c);
  issue_tile(s, 0);

  for (int win = blockIdx.x; win < nwin; win += gridDim.x) {
    // window win = (b * nwy + wy) * nwx + wx; its token i = r * 8 + c is
    // the pixel (b, 8 wy + r, 8 wx + c) of the (B, 8 nwy, 8 nwx, .) maps
    const int wx = win % nwx;
    const int wy = (win / nwx) % nwy;
    const int b = win / (nwx * nwy);
    const int W = nwx * WS;
    auto pix = [&](int i) -> int64_t {
      return ((int64_t)b * nwy * WS + wy * WS + i / WS) * W + wx * WS +
             i % WS;
    };

    // ---- x (bf16) copied into shared memory; vote MLP hidden. The last
    // window's fc2 epilogue was the last reader of x1, which overlays x
    // and vh: the barrier before its output store ordered it.
#pragma unroll
    for (int k = 0; k < T * (C / 8) / THREADS; ++k) {
      const int e = tid + k * THREADS, i = e / (C / 8), c8 = e % (C / 8);
      cp_async16(sx + i * SA + c8 * 8, x + pix(i) * C + c8 * 8);
    }
    cp_async_commit();
#pragma unroll
    for (int k = 0; k < T * HID / THREADS; ++k) {
      const int e = tid + k * THREADS, i = e / HID, kk = e % HID;
      const float* vp = vote + pix(i) * 3;
      float a = vp[0] * vw1[kk];
      a = fmaf(vp[1], vw1[HID + kk], a);
      a = fmaf(vp[2], vw1[2 * HID + kk], a);
      svh[i * SVH + kk] = fmaxf(a + vb1[kk], 0.0f);
    }
    cp_async_wait_all();
    __syncthreads();  // also: every thread is done storing the last output
    layer_norm_rows(sx, SA, sy, ln1s, ln1b);

    for (int h = 0; h < NH; ++h) {
      // ---- [q | k | v] of head h: 192 staged rows = 24 tiles of 8, 6 a
      // warp; tile jj is part jj / 8 (q, k, v), columns 8 (jj % 8) ..
      constexpr int NTQ = 3 * HD / 8 / NQ;
      float acc[NTQ][4];
      zero(acc);
      gemm_stream<NTQ>(acc, sy + 16 * mt * SA, SA, 8 * NTQ * cq, s);

      // the bias of the warp's logits (keys 16 cq ..), loaded before the
      // epilogue
      const float* bw = bias + ((int64_t)win * NH + h) * T * T;
      constexpr int NTK = T / 8 / NQ;
      float2 bb[NTK][2];
#pragma unroll
      for (int j = 0; j < NTK; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          bb[j][rr] = __ldg(reinterpret_cast<const float2*>(
              bw + (rr ? row1 : row0) * T + 8 * NTK * cq + 8 * j + 2 * t4));

      // + qkv bias + vote embed (e = vh . Wv2[:, 64h + d] + bv2)
      float ssq[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};  // [q|k][row0|row1]
#pragma unroll
      for (int j = 0; j < NTQ; ++j) {
        const int jj = NTQ * cq + j, part = jj / 8;
        const int d = (jj % 8) * 8 + 2 * t4;
        const float2 qb =
            *reinterpret_cast<const float2*>(qkvb + part * C + h * HD + d);
        const float2 eb = *reinterpret_cast<const float2*>(vb2 + h * HD + d);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float* vh = svh + (rr ? row1 : row0) * SVH;
          float e0 = 0.0f, e1 = 0.0f;
#pragma unroll
          for (int kk = 0; kk < HID; ++kk) {
            const float2 w =
                *reinterpret_cast<const float2*>(svw2 + kk * C + h * HD + d);
            e0 = fmaf(vh[kk], w.x, e0);
            e1 = fmaf(vh[kk], w.y, e1);
          }
          const float v0 = acc[j][2 * rr] + qb.x + (e0 + eb.x);
          const float v1 = acc[j][2 * rr + 1] + qb.y + (e1 + eb.y);
          acc[j][2 * rr] = v0;
          acc[j][2 * rr + 1] = v1;
          if (part < 2)
            ssq[part][rr] = fmaf(v1, v1, fmaf(v0, v0, ssq[part][rr]));
        }
      }
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float a = quad_sum(ssq[p][rr]);
          if (t4 == 0) sss[(p * NQ + cq) * T + (rr ? row1 : row0)] = a;
        }
      group_sync(mt);
      {
        const float it = itau[h];
        float qs[2], kn[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = rr ? row1 : row0;
          float sqq = 0.0f, skk = 0.0f;
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            sqq += sss[q * T + i];
            skk += sss[(NQ + q) * T + i];
          }
          qs[rr] = it / sqrtf(sqq + 1e-12f);
          kn[rr] = sqrtf(skk + 1e-12f);
        }
#pragma unroll
        for (int j = 0; j < NTQ; ++j) {
          const int jj = NTQ * cq + j, part = jj / 8;
          const int d = (jj % 8) * 8 + 2 * t4;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int i = rr ? row1 : row0;
            const float v0 = acc[j][2 * rr], v1 = acc[j][2 * rr + 1];
            if (part == 0)
              sts_pair(sq + i * SH + d, v0 * qs[rr], v1 * qs[rr]);
            else if (part == 1)
              sts_pair(sk + i * SH + d, v0 / kn[rr], v1 / kn[rr]);
            else
              sts_pair(sv + i * SH + d, v0, v1);
          }
        }
      }
      __syncthreads();  // every warp reads all 64 rows of kh and v

      // ---- logits l = qh . kh^T + bias: keys 16 cq .. + 15, 2 tiles
      float la[NTK][4];
      zero(la);
      gemm_smem<NTK, false>(la, sq + 16 * mt * SH, SH,
                            sk + 8 * NTK * cq * SH, SH, HD);
      // ---- P = bf16(softmax(l)): row max and sum over the quad, then over
      // the NQ warps that hold the row's keys
      float m[2], sum[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float a = -__int_as_float(0x7f800000);  // -inf
#pragma unroll
        for (int j = 0; j < NTK; ++j) {
          la[j][2 * rr] += bb[j][rr].x;
          la[j][2 * rr + 1] += bb[j][rr].y;
          a = fmaxf(a, fmaxf(la[j][2 * rr], la[j][2 * rr + 1]));
        }
        a = quad_max(a);
        if (t4 == 0) sred[cq * T + (rr ? row1 : row0)] = a;
      }
      group_sync(mt);  // also: the group is done reading its rows of qh
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = rr ? row1 : row0;
        m[rr] = sred[i];
#pragma unroll
        for (int q = 1; q < NQ; ++q) m[rr] = fmaxf(m[rr], sred[q * T + i]);
        float a = 0.0f;
#pragma unroll
        for (int j = 0; j < NTK; ++j) {
          la[j][2 * rr] = expf(la[j][2 * rr] - m[rr]);
          la[j][2 * rr + 1] = expf(la[j][2 * rr + 1] - m[rr]);
          a += la[j][2 * rr] + la[j][2 * rr + 1];
        }
        a = quad_sum(a);
        if (t4 == 0) sred[(NQ + cq) * T + i] = a;
      }
      group_sync(mt);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = rr ? row1 : row0;
        sum[rr] = 0.0f;
#pragma unroll
        for (int q = 0; q < NQ; ++q) sum[rr] += sred[(NQ + q) * T + i];
#pragma unroll
        for (int j = 0; j < NTK; ++j)
          sts_pair(sq + i * SH + 8 * NTK * cq + 8 * j + 2 * t4,
                   la[j][2 * rr] / sum[rr], la[j][2 * rr + 1] / sum[rr]);
      }
      group_sync(mt);  // the group's P rows are whole

      // ---- o_h = bf16(P . v): columns 16 cq .. + 15 of head h
      {
        float oa[NTK][4];
        zero(oa);
        gemm_smem<NTK, true>(oa, sq + 16 * mt * SH, SH, sv + 8 * NTK * cq,
                             SH, T);
#pragma unroll
        for (int j = 0; j < NTK; ++j) {
          const int c = h * HD + 8 * NTK * cq + 8 * j + 2 * t4;
          sts_pair(so + row0 * SA + c, oa[j][0], oa[j][1]);
          sts_pair(so + row1 * SA + c, oa[j][2], oa[j][3]);
        }
      }
    }

    // 256-column products below: 8 tiles of 8 a warp, staged rows 64 cq ..
    constexpr int NTC = C / 8 / NQ;
    // ---- x1 = x + o . Wproj + bproj, written over x (f32 over bf16: every
    // thread reads its x first, then a barrier)
    {
      float acc[NTC][4];
      zero(acc);
      gemm_stream<NTC>(acc, so + 16 * mt * SA, SA, 8 * NTC * cq, s);
#pragma unroll
      for (int j = 0; j < NTC; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = rr ? row1 : row0;
          const int c = 8 * NTC * cq + 8 * j + 2 * t4;
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(sx + i * SA + c));
          acc[j][2 * rr] = xv.x + acc[j][2 * rr] + projb[c];
          acc[j][2 * rr + 1] = xv.y + acc[j][2 * rr + 1] + projb[c + 1];
        }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < NTC; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = rr ? row1 : row0;
          const int c = 8 * NTC * cq + 8 * j + 2 * t4;
          *reinterpret_cast<float2*>(sx1 + i * SX + c) =
              make_float2(acc[j][2 * rr], acc[j][2 * rr + 1]);
        }
    }
    __syncthreads();
    layer_norm_rows(sx1, SX, sy, ln2s, ln2b);

    // ---- g = bf16(gelu(y2 . W1 + b1)) into the heads' output buffer
    {
      float acc[NTC][4];
      zero(acc);
      gemm_stream<NTC>(acc, sy + 16 * mt * SA, SA, 8 * NTC * cq, s);
#pragma unroll
      for (int j = 0; j < NTC; ++j) {
        const int c = 8 * NTC * cq + 8 * j + 2 * t4;
        sts_pair(so + row0 * SA + c, gelu_tanh(acc[j][0] + f1b[c]),
                 gelu_tanh(acc[j][1] + f1b[c + 1]));
        sts_pair(so + row1 * SA + c, gelu_tanh(acc[j][2] + f1b[c]),
                 gelu_tanh(acc[j][3] + f1b[c + 1]));
      }
    }

    // ---- out = bf16(x1 + (g . W2 + b2)), staged in the y buffer
    {
      float acc[NTC][4];
      zero(acc);
      gemm_stream<NTC>(acc, so + 16 * mt * SA, SA, 8 * NTC * cq, s);
#pragma unroll
      for (int j = 0; j < NTC; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = rr ? row1 : row0;
          const int c = 8 * NTC * cq + 8 * j + 2 * t4;
          const float2 x1 =
              *reinterpret_cast<const float2*>(sx1 + i * SX + c);
          sts_pair(sy + i * SA + c, x1.x + (acc[j][2 * rr] + f2b[c]),
                   x1.y + (acc[j][2 * rr + 1] + f2b[c + 1]));
        }
    }
    __syncthreads();
    for (int e = tid; e < T * (C / 8); e += THREADS) {
      const int i = e / (C / 8), c8 = e % (C / 8);
      reinterpret_cast<uint4*>(out + pix(i) * C)[c8] =
          reinterpret_cast<const uint4*>(sy + i * SA)[c8];
    }
  }
  cp_async_wait_all();
}

}  // namespace

extern "C" int ptt_swin_block_bf16(
    const void* x, const void* vote, const void* bias, const void* ln1s,
    const void* ln1b, const void* qkvw, const void* qkvb, const void* vw1,
    const void* vb1, const void* vw2, const void* vb2, const void* itau,
    const void* projw, const void* projb, const void* ln2s, const void* ln2b,
    const void* f1w, const void* f1b, const void* f2w, const void* f2b,
    void* out, int B, int nwy, int nwx, void* stream) {
  // the persistent grid (#SMs x blocks per SM) depends only on the device:
  // worked out, with the shared-memory attribute, on its first launch there
  constexpr int MAX_DEVICES = 64;
  static int resident[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!resident[dev]) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(
             swin_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             SMEM)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, swin_block_kernel, THREADS, SMEM)) != cudaSuccess)
      return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident[dev] = sms * per_sm;
  }
  const int nwin = B * nwy * nwx;
  const int grid = nwin < resident[dev] ? nwin : resident[dev];
  swin_block_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)vote, (const float*)bias,
      (const float*)ln1s, (const float*)ln1b, (const bf16*)qkvw,
      (const float*)qkvb, (const float*)vw1, (const float*)vb1,
      (const float*)vw2, (const float*)vb2, (const float*)itau,
      (const bf16*)projw, (const float*)projb, (const float*)ln2s,
      (const float*)ln2b, (const bf16*)f1w, (const float*)f1b,
      (const bf16*)f2w, (const float*)f2b, (bf16*)out, nwin, nwy, nwx);
  return (int)cudaGetLastError();
}
