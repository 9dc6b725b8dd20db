// The fused full-resolution decoder tail (K6) for Hopper (sm_90a).
//
// Replaces the TPU kernel bts_tpu/ops/tail_pallas.py::_tail_kernel (launched
// by fused_tail, reached with --fused_tail always).  Same function, in the
// 2x2 phase domain: full-resolution pixel (2u+py, 2v+pz) is pixel (u, v) of
// phase q = 2*py + pz, and with x = iconv2 (B, Hh, W2, 64) bf16,
//
//   up[q]   = ELU(sum_{dy,dx in {0,1}} x[u+py-1+dy, v+pz-1+dx] . K4[py+2dy, pz+2dx] + b_up)
//             (K4 = the 3x3 upconv kernel folded over the nearest-2x upsample,
//              summed in f32 and rounded to bf16 once: the upsample never exists)
//   d1[q]   = sigmoid(r3 . bf16(ELU(r2 . bf16(ELU(r1 . bf16(up[q]) + b1)) + b2)) + b3)
//   i1[q]   = ELU(3x3 conv over the phases of [up, d1, d2, d4, d8] (36 ch) -> 32, + b_i1)
//   fin[q]  = sigmoid(3x3 conv over the phases of i1 (32 ch) -> 1, + b_f)
//
// Outputs: fin and d1 as phase planes (B, 4, Hh, W2) f32; the caller
// interleaves them and applies max_depth and the focal scaling.
//
// Rounding, as the TPU kernel: every dot takes bf16 operands and sums in f32
// (here bf16 tensor-core products summed in f32, and f32 FMAs on bf16 values
// for the reduction chain and the final conv: the products are exact either
// way); the upconv, r1, r2 and iconv1 biases are bf16 values, r3's and the
// final conv's stay f32; ELU is where(x > 0, x, exp(x) - 1) in f32.  Each
// intermediate is read only as bf16 by its consumers, so it is kept in
// shared memory as bf16 with no further loss.  Values outside
// [0, Hh) x [0, W2) are zero when a conv reads them (SAME padding), which the
// kernel enforces by absolute position.
//
// What bounds it: 38,992 flops per full-resolution pixel (upconv 16,384,
// reduction 1,296, iconv1 20,736, final 576) against ~52 bytes moved, so
// operations; 95% of them are bf16 products with f32 sums, which is what the
// tensor cores compute (989 TFLOP/s dense), against 67 TFLOP/s for f32 FMAs.
// Design: the upconv and iconv1 are implicit GEMMs on mma.sync (m16n8k16
// bf16 -> f32); the reduction chain and the final conv (5% of the flops)
// stay on the CUDA cores, their weights a by-value kernel parameter read as
// uniform constants (no shared-memory loads beside the FMAs).  One block of
// 16 warps per (b, 8 phase rows x 16 phase cols) output tile, for all four
// phases; 199 KB of shared memory, so 1 block per SM; 836 blocks at
// (1, 176, 608), 6.3 waves on 132 SMs; ptxas: 128 registers, no spills.
// Stage by stage, in shared memory as bf16:
//
//   x window   14 x 22 x 64      (rows r0-3.., cols c0-3..; pitch 72), read through
//                                 iconv2's strides (bf16 or f32) and rounded to bf16
//   up + maps  4 x 12 x 20 x 40  (rows r0-2..; 32 up, d1, d2, d4, d8, 4 zero; pitch 40)
//   iconv1     4 x 10 x 18 x 32  (rows r0-1..; pitch 40; takes the x window's space)
//   weights    the folded upconv of all four phases (64 KB), then iconv1's (22.5 KB),
//              bf16 in the order the B fragments are read (one 16-byte load per
//              lane per k-step and pair of 8-column tiles)
//
// Halo recompute: 12 x 20 up and 10 x 18 iconv1 positions per 8 x 16
// outputs and phase (1.9x and 1.4x).  Upconv: per phase a GEMM of the
// 240 up positions (15 m16 tiles) by N = 32, K = 4 taps x 64 channels
// (16 k-steps); A rows come from the x window by ldmatrix (one row = one
// position's 16 channels at tap (dy, dx)); 4 warps per phase take 4 tiles
// each (one slot idle) and reuse each B fragment for all four.  iconv1: a
// GEMM of 4 phases x 180 positions (45 tiles) by N = 32, K = 9 taps x (32 up
// channels in two k16 steps + the four maps and four zeros in one m16n8k8
// step, the simpler of the two ways to fold them in), each tap's A row read
// from its source phase; 15 warps take 3 tiles each.  Channel pitches are
// multiples of 8 bf16 (16-byte ldmatrix rows) and odd in 16-byte units
// (72 = 9, 40 = 5), so the 8 rows of one ldmatrix phase fall in distinct
// 4-bank groups, as do the epilogue's stores and the 16-byte loads of the
// CUDA-core stages.  ELU computes exp(min(x, 0)) in every lane and selects:
// a branch around expf diverged in every warp and doubled the epilogues.
// The TPU kernel's 128-column tiles, 64->128 channel pad, 8-lane map packing
// and aligned DMA windows exist for Mosaic's tiling and have no counterpart.
//
// Measured per block at (1, 176, 608) (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py's stage clocks, median SM cycles): staging 6.0k, upconv
// 13.6k, reduction chain 15.9k, iconv1 13.9k, final conv 5.2k.  The
// CUDA-core reduction chain is the largest stage; r1 (32 -> 16) on mma.sync
// is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int TR = 8, TC = 16;                   // output tile: phase rows x phase cols
constexpr int XR = TR + 6, XC = TC + 6;          // x window
constexpr int UR = TR + 4, UC = TC + 4, UN = UR * UC;  // up grid (240 positions)
constexpr int IR = TR + 2, IC = TC + 2, IN = IR * IC;  // iconv1 grid (180 positions)
constexpr int CIN = 64;
constexpr int XP = 72;  // x channel pitch (bf16): 9 x 16 bytes
constexpr int UP = 40;  // up + maps pitch: 32 up, d1, d2, d4, d8, 4 zero = 5 x 16 bytes
constexpr int IP = 40;  // iconv1 pitch: 32 + 8 pad
constexpr int UP_TILES = UN / 16;                // 15 m16 tiles per phase
constexpr int I1_TILES = 4 * IN / 16;            // 45 m16 tiles over the four phases
static_assert(UN % 16 == 0 && (4 * IN) % 16 == 0, "whole m16 tiles");
static_assert(I1_TILES == 3 * (kWarps - 1), "iconv1: 3 tiles for each of 15 warps");
static_assert(4 * 4 == kWarps && 4 * 4 >= UP_TILES, "upconv: 4 warps per phase, 4 tiles each");
static_assert(kThreads == 4 * TR * TC, "one final output per thread");

// The packed parameters (bytes, tail_cuda.py::pack_tail_params), in this order:
//   K4   bf16 [4 phases][16 k-steps][2 tile pairs][32 lanes][8]: the B fragments
//        {b0, b1 of tile 2h, b0, b1 of tile 2h+1} of the GEMM B[tap*64 + c][n]
//   KI1  bf16 [9 taps]([2 k-steps][2 tile pairs][32 lanes][8], then [32 lanes][8]:
//        the m16n8k8 b0 of tiles 0..3 for channels 32..39 = maps and 4 zeros)
//   f32  r1[32][16] b1[16] r2[16][8] b2[8] r3[8] b3 kf[3][3][32] b_f (the CUDA-core
//        stages' weights, also passed by value as a kernel parameter, read as
//        uniform constants rather than shared-memory loads), then b_up[32] b_i1[32], pad
constexpr int K4_BYTES = 4 * 16 * 2 * 32 * 16;            // 65,536
constexpr int KI1_TAP_BYTES = 2 * 2 * 32 * 16 + 32 * 16;  // 2,560
constexpr int KI1_BYTES = 9 * KI1_TAP_BYTES;              // 23,040
constexpr int C_WR1 = 0;
constexpr int C_BR1 = C_WR1 + 32 * 16;
constexpr int C_WR2 = C_BR1 + 16;
constexpr int C_BR2 = C_WR2 + 16 * 8;
constexpr int C_WR3 = C_BR2 + 8;
constexpr int C_BR3 = C_WR3 + 8;
constexpr int C_KF = C_BR3 + 1;
constexpr int C_BF = C_KF + 9 * 32;
constexpr int C_FLOATS = C_BF + 1;  // 962
constexpr int S_BUP = 0, S_BI1 = 32, S_FLOATS = 64;  // the epilogue biases, in shared memory
constexpr int SMALL_FLOATS = (C_FLOATS + S_FLOATS + 3) / 4 * 4;
constexpr int PARAM_BYTES = K4_BYTES + KI1_BYTES + SMALL_FLOATS * 4;

struct ConstParams {
  float v[C_FLOATS];
};
// with the strides (4 x 8 bytes), seven pointers and two ints
static_assert(sizeof(ConstParams) + 4 * 8 + 7 * 8 + 2 * 4 <= 4096, "kernel parameters within 4 KB");

constexpr int X_BYTES = XR * XC * XP * 2;
constexpr int I_BYTES = 4 * IN * IP * 2;
constexpr int A_BYTES = I_BYTES > X_BYTES ? I_BYTES : X_BYTES;
constexpr int U_BYTES = 4 * UN * UP * 2;
constexpr int W_BYTES = K4_BYTES > KI1_BYTES ? K4_BYTES : KI1_BYTES;
constexpr int SMEM_BYTES = A_BYTES + U_BYTES + W_BYTES + S_FLOATS * 4;
static_assert(A_BYTES % 16 == 0 && U_BYTES % 16 == 0 && W_BYTES % 16 == 0, "16-byte regions");
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");

// exp of min(x, 0) for every lane and a select: no divergent branch around expf
__device__ __forceinline__ float elu(float x) {
  const float e = expf(fminf(x, 0.f)) - 1.0f;
  return x > 0.f ? x : e;
}
__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16x2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zeros instead when !fill
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// A fragments of m16n8k16 (x4: rows lane%16, k offset 8*(lane/16)) and of
// m16n8k8 (x2: rows lane%16 of lanes 0..15)
__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&a)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(a[0]), "=r"(a[1])
               : "r"(addr));
}
__device__ __forceinline__ void mma_k16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_k8(float (&c)[4], const uint32_t (&a)[2], uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// The accumulators of one m16 tile by N = 32 (four n8 tiles) -> bias, ELU,
// one bf16 round, zero outside the image; row r of the tile goes to
// dst_row(r) (32 channels), inside(r) says whether its position is real.
template <class Row, class Inside>
__device__ __forceinline__ void epilogue(const float (&acc)[4][4], const float* bias, int lane,
                                         Row dst_row, Inside inside) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    uint32_t* dst = dst_row(g + 8 * hf);
    const bool in = inside(g + 8 * hf);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = nt * 8 + 2 * t4;
      const float v0 = elu(acc[nt][2 * hf] + bias[col]);
      const float v1 = elu(acc[nt][2 * hf + 1] + bias[col + 1]);
      dst[col / 2] = in ? pack_bf16x2(v0, v1) : 0u;
    }
  }
}

#ifdef K6_STAGE_CLOCKS
// A profiling build (nvcc -DK6_STAGE_CLOCKS; chip_smoke.py reads it): thread
// 0 of each of the first kClockBlocks blocks records clock64() at the start
// and after each stage: staging, upconv, reduction chain, iconv1, final conv.
constexpr int kStamps = 6, kClockBlocks = 4096;
__device__ long long g_stage_clock[kStamps * kClockBlocks];
#define STAGE_CLOCK(k)                                                                  \
  do {                                                                                  \
    const int blk = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;     \
    if (threadIdx.x == 0 && blk < kClockBlocks) g_stage_clock[blk * kStamps + (k)] = clock64(); \
  } while (0)
#else
#define STAGE_CLOCK(k)
#endif

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

struct Strides {
  int64_t b, h, w, c;
};

// x: (B, Hh, W2, 64) bf16 or f32 with element strides xs (the decoder's NCHW
// activation as a view), rounded to bf16 as it is staged; d2, d4, d8:
// (B, 4, Hh, W2) f32 contiguous; prm: PARAM_BYTES, 16-byte aligned; cp: the
// first C_FLOATS of prm's f32 part; fin, d1x1: (B, 4, Hh, W2) f32.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fused_tail_kernel(const T* __restrict__ x, const Strides xs, const float* __restrict__ d2,
                  const float* __restrict__ d4, const float* __restrict__ d8,
                  const unsigned char* __restrict__ prm, const __grid_constant__ ConstParams cp,
                  float* __restrict__ fin, float* __restrict__ d1x1, int Hh, int W2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sI = sX;  // iconv1 takes the x window's space after the upconv
  __nv_bfloat16* sU = reinterpret_cast<__nv_bfloat16*>(smem + A_BYTES);
  unsigned char* sW = smem + A_BYTES + U_BYTES;
  float* sS = reinterpret_cast<float*>(smem + A_BYTES + U_BYTES + W_BYTES);
  const uint32_t sXa = smem_addr(sX), sUa = smem_addr(sU), sWa = smem_addr(sW);

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TR, c0 = blockIdx.x * TC;
  const int64_t plane = (int64_t)Hh * W2;
  auto inside = [&](int r, int c) { return r >= 0 && r < Hh && c >= 0 && c < W2; };
  STAGE_CLOCK(0);

  // --- stage the upconv weights (async), the x window, the maps and the
  // epilogue biases ----------------------------------------------------------
  {
    for (int i = t; i < K4_BYTES / 16; i += kThreads) cp_async16(sWa + i * 16, prm + i * 16, true);
    // 8 channels of one position per item: 8 loads along the channel stride
    // (neighbouring lanes take neighbouring positions), one 16-byte store
    const T* xb = x + (int64_t)b * xs.b;
    for (int i = t; i < XR * XC * 8; i += kThreads) {
      const int cg = i / (XR * XC), pos = i % (XR * XC);
      const int gr = r0 - 3 + pos / XC, gc = c0 - 3 + pos % XC;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (inside(gr, gc)) {
        const T* px = xb + gr * xs.h + gc * xs.w + cg * 8 * xs.c;
        float f[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) f[k] = to_float(px[k * xs.c]);
        v = make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]), pack_bf16x2(f[4], f[5]),
                       pack_bf16x2(f[6], f[7]));
      }
      *reinterpret_cast<uint4*>(sX + pos * XP + cg * 8) = v;
    }
    for (int i = t; i < 4 * UN; i += kThreads) {
      const int q = i / UN, pos = i % UN;
      const int gr = r0 - 2 + pos / UC, gc = c0 - 2 + pos % UC;
      const bool in = inside(gr, gc);
      const int64_t g = (int64_t)(b * 4 + q) * plane + (int64_t)gr * W2 + gc;
      uint4 m;  // channels 32..39: d1 (written by the reduction), d2, d4, d8, zeros
      m.x = pack_bf16x2(0.f, in ? d2[g] : 0.f);
      m.y = pack_bf16x2(in ? d4[g] : 0.f, in ? d8[g] : 0.f);
      m.z = m.w = 0u;
      *reinterpret_cast<uint4*>(sU + i * UP + 32) = m;
    }
    const float* biases = reinterpret_cast<const float*>(prm + K4_BYTES + KI1_BYTES) + C_FLOATS;
    for (int i = t; i < S_FLOATS; i += kThreads) sS[i] = biases[i];
    cp_async_wait_all();
  }
  __syncthreads();
  STAGE_CLOCK(1);

  // --- upconv1 + ELU: per phase, up positions x 32 = (taps x 64) . K4 -------
  {
    const int q = warp >> 2, py = q >> 1, pz = q & 1;  // 4 warps per phase, 4 m16 tiles each
    const int mt0 = 4 * (warp & 3);
    const int ntiles = min(4, UP_TILES - mt0);  // warp-uniform
    uint32_t abase[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = min((mt0 + i) * 16 + (lane & 15), UN - 1);
      abase[i] = sXa + (((m / UC + py) * XC + m % UC + pz) * XP + (lane >> 4) * 8) * 2;
    }
    float acc[4][4][4] = {};
    const uint4* wq = reinterpret_cast<const uint4*>(sW + q * (K4_BYTES / 4));
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      const int tap = s >> 2, kk = s & 3;
      const uint32_t off = (((tap >> 1) * XC + (tap & 1)) * XP + kk * 16) * 2;
      const uint4 b01 = wq[(2 * s) * 32 + lane], b23 = wq[(2 * s + 1) * 32 + lane];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < ntiles) {
          uint32_t a[4];
          ldsm_x4(a, abase[i] + off);
          mma_k16(acc[i][0], a, b01.x, b01.y);
          mma_k16(acc[i][1], a, b01.z, b01.w);
          mma_k16(acc[i][2], a, b23.x, b23.y);
          mma_k16(acc[i][3], a, b23.z, b23.w);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < ntiles) {
        const int m0 = (mt0 + i) * 16;
        epilogue(
            acc[i], sS + S_BUP, lane,
            [&](int r) { return reinterpret_cast<uint32_t*>(sU + (q * UN + m0 + r) * UP); },
            [&](int r) { return inside(r0 - 2 + (m0 + r) / UC, c0 - 2 + (m0 + r) % UC); });
      }
    }
  }
  __syncthreads();  // up is complete and the upconv weights are dead
  STAGE_CLOCK(2);

  // --- iconv1's weights (async) under the reduction_1x1 chain 32 -> 16 -> 8
  // -> 1 + sigmoid (d1x1), on the CUDA cores -------------------------------
  for (int i = t; i < KI1_BYTES / 16; i += kThreads) cp_async16(sWa + i * 16, prm + K4_BYTES + i * 16, true);
  for (int i = t; i < 4 * UN; i += kThreads) {
    const int q = i / UN, pos = i % UN;
    const int ur = pos / UC, uc = pos % UC;
    const int gr = r0 - 2 + ur, gc = c0 - 2 + uc;
    const uint4* u4 = reinterpret_cast<const uint4*>(sU + i * UP);
    float r1[16] = {};  // sums over the channels in order, 16 independent chains
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint4 u = u4[j];
      const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float2 f = unpack_bf16x2(words[h]);
        const int c = 8 * j + 2 * h;
#pragma unroll
        for (int o = 0; o < 16; ++o) r1[o] = fmaf(f.x, cp.v[C_WR1 + c * 16 + o], r1[o]);
#pragma unroll
        for (int o = 0; o < 16; ++o) r1[o] = fmaf(f.y, cp.v[C_WR1 + (c + 1) * 16 + o], r1[o]);
      }
    }
#pragma unroll
    for (int o = 0; o < 16; ++o) r1[o] = bf16_round(elu(r1[o] + cp.v[C_BR1 + o]));
    float r2[8];
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) s = fmaf(r1[c], cp.v[C_WR2 + c * 8 + o], s);
      r2[o] = bf16_round(elu(s + cp.v[C_BR2 + o]));
    }
    float logit = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) logit = fmaf(r2[c], cp.v[C_WR3 + c], logit);
    const bool in = inside(gr, gc);
    const float d = in ? sigmoid(logit + cp.v[C_BR3]) : 0.f;
    sU[i * UP + 32] = __float2bfloat16_rn(d);
    if (in && ur >= 2 && ur < 2 + TR && uc >= 2 && uc < 2 + TC) {
      d1x1[(int64_t)(b * 4 + q) * plane + (int64_t)gr * W2 + gc] = d;
    }
  }
  cp_async_wait_all();
  __syncthreads();
  STAGE_CLOCK(3);

  // --- iconv1 + ELU: (4 phases x iconv1 positions) x 32 = (9 taps x 36) . KI1
  if (warp < kWarps - 1) {
    const int mt0 = 3 * warp;
    int rq[3], rir[3], ric[3];  // this lane's ldmatrix row of each tile
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int row = (mt0 + i) * 16 + (lane & 15);
      rq[i] = row / IN;
      rir[i] = row % IN / IC;
      ric[i] = row % IC;
    }
    float acc[3][4][4] = {};
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      uint32_t aaddr[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int sy = (rq[i] >> 1) + tap / 3 - 1, sx = (rq[i] & 1) + tap % 3 - 1;  // full-res offsets
        const int ps = 2 * (sy & 1) + (sx & 1);                                    // source phase
        const int upos = (rir[i] + 1 + (sy >> 1)) * UC + ric[i] + 1 + (sx >> 1);
        aaddr[i] = sUa + ((ps * UN + upos) * UP + (lane >> 4) * 8) * 2;
      }
      const uint4* wt = reinterpret_cast<const uint4*>(sW + tap * KI1_TAP_BYTES);
#pragma unroll
      for (int s = 0; s < 2; ++s) {  // the 32 up channels
        const uint4 b01 = wt[(2 * s) * 32 + lane], b23 = wt[(2 * s + 1) * 32 + lane];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          uint32_t a[4];
          ldsm_x4(a, aaddr[i] + s * 32);
          mma_k16(acc[i][0], a, b01.x, b01.y);
          mma_k16(acc[i][1], a, b01.z, b01.w);
          mma_k16(acc[i][2], a, b23.x, b23.y);
          mma_k16(acc[i][3], a, b23.z, b23.w);
        }
      }
      const uint4 bm = wt[4 * 32 + lane];  // channels 32..39: d1, d2, d4, d8, zeros
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        uint32_t a[2];
        ldsm_x2(a, aaddr[i] + 64);
        mma_k8(acc[i][0], a, bm.x);
        mma_k8(acc[i][1], a, bm.y);
        mma_k8(acc[i][2], a, bm.z);
        mma_k8(acc[i][3], a, bm.w);
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int row0 = (mt0 + i) * 16;
      epilogue(
          acc[i], sS + S_BI1, lane,
          [&](int r) { return reinterpret_cast<uint32_t*>(sI + (row0 + r) * IP); },
          [&](int r) {
            const int pos = (row0 + r) % IN;
            return inside(r0 - 1 + pos / IC, c0 - 1 + pos % IC);
          });
    }
  }
  __syncthreads();
  STAGE_CLOCK(4);

  // --- final 3x3 conv 32 -> 1 + sigmoid, one output per thread -------------
  {
    const int q = t / (TR * TC), pos = t % (TR * TC);
    const int a = pos / TC, c = pos % TC;
    const int qy = q >> 1, qz = q & 1;
    float acc = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int sy = qy + tap / 3 - 1, sx = qz + tap % 3 - 1;
      const int ps = 2 * (sy & 1) + (sx & 1);
      const uint4* in = reinterpret_cast<const uint4*>(
          sI + (ps * IN + (a + 1 + (sy >> 1)) * IC + c + 1 + (sx >> 1)) * IP);
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint4 v = in[j];
        const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float2 f = unpack_bf16x2(words[h]);
          s = fmaf(f.x, cp.v[C_KF + tap * 32 + 8 * j + 2 * h], s);
          s = fmaf(f.y, cp.v[C_KF + tap * 32 + 8 * j + 2 * h + 1], s);
        }
      }
      acc += s;
    }
    const int gr = r0 + a, gc = c0 + c;
    if (gr < Hh && gc < W2) fin[(int64_t)(b * 4 + q) * plane + (int64_t)gr * W2 + gc] = sigmoid(acc + cp.v[C_BF]);
  }
#ifdef K6_STAGE_CLOCKS
  __syncthreads();
  STAGE_CLOCK(5);
#endif
}

template <typename T>
cudaError_t launch(const void* x, const Strides& xs, const float* d2, const float* d4, const float* d8,
                   const void* prm, const ConstParams& cp, float* fin, float* d1x1, int B, int Hh, int W2,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fused_tail_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((W2 + TC - 1) / TC, (Hh + TR - 1) / TR, B);
  fused_tail_kernel<T><<<grid, kThreads, SMEM_BYTES, stream>>>(
      static_cast<const T*>(x), xs, d2, d4, d8, static_cast<const unsigned char*>(prm), cp, fin, d1x1, Hh, W2);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_tail_param_bytes() { return PARAM_BYTES; }

// x: bf16 (x_f32 = 0) or f32 (x_f32 = 1) with element strides sb, sh, sw,
// sc; `small`: a host copy of prm's f32 part, whose first C_FLOATS become
// the kernel parameter cp.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int fused_tail_forward(const void* x, int x_f32, int64_t sb, int64_t sh, int64_t sw, int64_t sc,
                                  const float* d2, const float* d4, const float* d8, const void* prm,
                                  const float* small, float* fin, float* d1x1, int B, int Hh, int W2,
                                  void* stream) {
  ConstParams cp;
  for (int i = 0; i < C_FLOATS; ++i) cp.v[i] = small[i];
  const Strides xs{sb, sh, sw, sc};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(x_f32 ? launch<float>(x, xs, d2, d4, d8, prm, cp, fin, d1x1, B, Hh, W2, st)
                     : launch<__nv_bfloat16>(x, xs, d2, d4, d8, prm, cp, fin, d1x1, B, Hh, W2, st));
}

#ifdef K6_STAGE_CLOCKS
// The stamps of the last launch: n = kStamps * blocks values, block-major.
extern "C" int fused_tail_stage_clocks(long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, g_stage_clock, sizeof(long long) * n);
}
#endif

extern "C" const char* fused_tail_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
