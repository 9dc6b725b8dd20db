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
// (here f32 FMAs on bf16 values, whose products are exact); the upconv, r1,
// r2 and iconv1 biases are bf16 values, r3's and the final conv's stay f32;
// ELU is where(x > 0, x, exp(x) - 1) in f32.  Each intermediate is read only
// as bf16 by its consumers, so it is kept in shared memory as bf16 with no
// further loss.  Values outside [0, Hh) x [0, W2) are zero when a conv reads
// them (SAME padding), which the kernel enforces by absolute position.
//
// What bounds it: 38,992 flops per full-resolution pixel (upconv 16,384,
// reduction 1,296, iconv1 20,736, final 576) against ~52 bytes moved, so
// operations, not bytes.  Design, correct first: one block of 512 threads
// per (b, 8 phase rows x 16 phase cols) output tile, for all four phases;
// the halos are staged in bf16 in shared memory, stage after stage:
//
//   x window   14 x 22 x 64      (rows r0-3.., cols c0-3..)
//   up + maps  4 x 12 x 20 x 36  (rows r0-2.., cols c0-2..; 32 up, d1, d2, d4, d8)
//   iconv1     4 x 10 x 18 x 32  (rows r0-1.., cols c0-1..; reuses the x window's space)
//
// Each thread computes 16 output channels of one position with f32 FMAs;
// the weights are f32 in shared memory, read as broadcasts; channel pitches
// are odd in 32-bit words, so a warp's 32 positions hit 32 banks.  The TPU
// kernel's 128-column tiles, 64->128 channel pad, 8-lane map packing and
// aligned DMA windows exist for Mosaic's tiling and have no counterpart.
// Tensor cores (mma / wgmma) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int TR = 8, TC = 16;           // output tile: phase rows x phase cols
constexpr int XR = TR + 6, XC = TC + 6;  // x window
constexpr int UR = TR + 4, UC = TC + 4;  // up grid
constexpr int IR = TR + 2, IC = TC + 2;  // iconv1 grid
constexpr int CIN = 64;
constexpr int XP = 66;  // x channel pitch (bf16): 33 words
constexpr int UP = 38;  // up + maps pitch: 32 up, d1, d2, d4, d8, 2 pad = 19 words
constexpr int IP = 34;  // iconv1 pitch: 17 words

// The packed parameters (f32, tail_cuda.py::pack_tail_params), in this order:
constexpr int OFF_K4 = 0;                         // [4 phases][2 dy][2 dx][64][32]
constexpr int OFF_BUP = OFF_K4 + 4 * 4 * CIN * 32;
constexpr int OFF_WR1 = OFF_BUP + 32;             // [32][16]
constexpr int OFF_BR1 = OFF_WR1 + 32 * 16;
constexpr int OFF_WR2 = OFF_BR1 + 16;             // [16][8]
constexpr int OFF_BR2 = OFF_WR2 + 16 * 8;
constexpr int OFF_WR3 = OFF_BR2 + 8;              // [8]
constexpr int OFF_BR3 = OFF_WR3 + 8;
constexpr int OFF_KI1 = OFF_BR3 + 1;              // [3][3][36][32]
constexpr int OFF_BI1 = OFF_KI1 + 9 * 36 * 32;
constexpr int OFF_KF = OFF_BI1 + 32;              // [3][3][32]
constexpr int OFF_BF = OFF_KF + 9 * 32;
constexpr int N_PARAMS = OFF_BF + 1;

// the small parameters in shared memory: [OFF_BUP, OFF_KI1) then [OFF_BI1, N_PARAMS)
constexpr int S_BUP = 0;
constexpr int S_WR1 = OFF_WR1 - OFF_BUP;
constexpr int S_BR1 = OFF_BR1 - OFF_BUP;
constexpr int S_WR2 = OFF_WR2 - OFF_BUP;
constexpr int S_BR2 = OFF_BR2 - OFF_BUP;
constexpr int S_WR3 = OFF_WR3 - OFF_BUP;
constexpr int S_BR3 = OFF_BR3 - OFF_BUP;
constexpr int S_BI1 = OFF_KI1 - OFF_BUP;
constexpr int S_KF = S_BI1 + (OFF_KF - OFF_BI1);
constexpr int S_BF = S_BI1 + (OFF_BF - OFF_BI1);
constexpr int S_FLOATS = S_BI1 + (N_PARAMS - OFF_BI1);

constexpr int X_BYTES = XR * XC * XP * 2;
constexpr int I_BYTES = 4 * IR * IC * IP * 2;
constexpr int A_BYTES = ((I_BYTES > X_BYTES ? I_BYTES : X_BYTES) + 15) / 16 * 16;
constexpr int U_BYTES = (4 * UR * UC * UP * 2 + 15) / 16 * 16;
constexpr int W_FLOATS = (9 * 36 * 32 > 4 * CIN * 32) ? 9 * 36 * 32 : 4 * CIN * 32;
constexpr int W_BYTES = W_FLOATS * 4;
constexpr int SMEM_BYTES = A_BYTES + U_BYTES + W_BYTES + S_FLOATS * 4;
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");
static_assert(UR * UC <= kThreads / 2, "one up position per thread of each half");

__device__ __forceinline__ float elu(float x) { return x > 0.f ? x : expf(x) - 1.0f; }
__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// acc[0..15] += sum over channel pairs of in[c] * w[c][0..15] (w row pitch 32)
template <int kPairs>
__device__ __forceinline__ void dot16(float (&acc)[16], const __nv_bfloat162* in, const float* w) {
#pragma unroll 2
  for (int c2 = 0; c2 < kPairs; ++c2) {
    const float2 v = __bfloat1622float2(in[c2]);
    const float4* w0 = reinterpret_cast<const float4*>(w + (2 * c2) * 32);
    const float4* w1 = reinterpret_cast<const float4*>(w + (2 * c2 + 1) * 32);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 a = w0[j];
      acc[4 * j + 0] = fmaf(v.x, a.x, acc[4 * j + 0]);
      acc[4 * j + 1] = fmaf(v.x, a.y, acc[4 * j + 1]);
      acc[4 * j + 2] = fmaf(v.x, a.z, acc[4 * j + 2]);
      acc[4 * j + 3] = fmaf(v.x, a.w, acc[4 * j + 3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 a = w1[j];
      acc[4 * j + 0] = fmaf(v.y, a.x, acc[4 * j + 0]);
      acc[4 * j + 1] = fmaf(v.y, a.y, acc[4 * j + 1]);
      acc[4 * j + 2] = fmaf(v.y, a.z, acc[4 * j + 2]);
      acc[4 * j + 3] = fmaf(v.y, a.w, acc[4 * j + 3]);
    }
  }
}

// x: (B, Hh, W2, 64) bf16 contiguous; d2, d4, d8: (B, 4, Hh, W2) f32
// contiguous; prm: N_PARAMS f32; fin, d1x1: (B, 4, Hh, W2) f32 contiguous.
__global__ void __launch_bounds__(kThreads, 1)
fused_tail_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ d2,
                  const float* __restrict__ d4, const float* __restrict__ d8,
                  const float* __restrict__ prm, float* __restrict__ fin,
                  float* __restrict__ d1x1, int Hh, int W2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sI = sX;  // iconv1 takes the x window's space after the upconv
  __nv_bfloat16* sU = reinterpret_cast<__nv_bfloat16*>(smem + A_BYTES);
  float* sW = reinterpret_cast<float*>(smem + A_BYTES + U_BYTES);
  float* sS = sW + W_FLOATS;

  const int t = threadIdx.x;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TR, c0 = blockIdx.x * TC;
  const int64_t plane = (int64_t)Hh * W2;
  auto inside = [&](int r, int c) { return r >= 0 && r < Hh && c >= 0 && c < W2; };

  // --- stage the x window, the three maps and the small parameters ---------
  {
    const __nv_bfloat162* xb = reinterpret_cast<const __nv_bfloat162*>(x) + (int64_t)b * plane * (CIN / 2);
    __nv_bfloat162* sx2 = reinterpret_cast<__nv_bfloat162*>(sX);
    for (int i = t; i < XR * XC * (CIN / 2); i += kThreads) {
      const int c2 = i % (CIN / 2), pos = i / (CIN / 2);
      const int gr = r0 - 3 + pos / XC, gc = c0 - 3 + pos % XC;
      sx2[pos * (XP / 2) + c2] =
          inside(gr, gc) ? xb[((int64_t)gr * W2 + gc) * (CIN / 2) + c2] : __float2bfloat162_rn(0.f);
    }
    for (int i = t; i < 4 * UR * UC; i += kThreads) {
      const int q = i / (UR * UC), pos = i % (UR * UC);
      const int gr = r0 - 2 + pos / UC, gc = c0 - 2 + pos % UC;
      const bool in = inside(gr, gc);
      const int64_t g = (int64_t)(b * 4 + q) * plane + (int64_t)gr * W2 + gc;
      __nv_bfloat16* u = sU + i * UP;
      u[33] = __float2bfloat16_rn(in ? d2[g] : 0.f);
      u[34] = __float2bfloat16_rn(in ? d4[g] : 0.f);
      u[35] = __float2bfloat16_rn(in ? d8[g] : 0.f);
    }
    for (int i = t; i < S_BI1; i += kThreads) sS[i] = prm[OFF_BUP + i];
    for (int i = t; i < N_PARAMS - OFF_BI1; i += kThreads) sS[S_BI1 + i] = prm[OFF_BI1 + i];
  }

  // --- upconv1 + ELU, one phase per round; 16 channels per thread ---------
  const int half = t / (kThreads / 2);
  const int upos = t % (kThreads / 2);
  for (int q = 0; q < 4; ++q) {
    __syncthreads();  // the staging (q = 0) or the last round's reads of sW are done
    for (int i = t; i < 4 * CIN * 32; i += kThreads) sW[i] = prm[OFF_K4 + q * 4 * CIN * 32 + i];
    __syncthreads();
    if (upos < UR * UC) {
      const int ur = upos / UC, uc = upos % UC;
      const int py = q >> 1, pz = q & 1;
      float acc[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[j] = 0.f;
#pragma unroll
      for (int tap = 0; tap < 4; ++tap) {
        const int dy = tap >> 1, dx = tap & 1;
        const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(
            sX + ((ur + py + dy) * XC + uc + pz + dx) * XP);
        dot16<CIN / 2>(acc, xs, sW + tap * CIN * 32 + half * 16);
      }
      const bool in = inside(r0 - 2 + ur, c0 - 2 + uc);
      __nv_bfloat16* u = sU + (q * UR * UC + upos) * UP + half * 16;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        u[j] = __float2bfloat16_rn(in ? elu(acc[j] + sS[S_BUP + half * 16 + j]) : 0.f);
      }
    }
  }
  __syncthreads();

  // --- reduction_1x1 chain 32 -> 16 -> 8 -> 1 + sigmoid (d1x1) ------------
  for (int i = t; i < 4 * UR * UC; i += kThreads) {
    const int q = i / (UR * UC), pos = i % (UR * UC);
    const int ur = pos / UC, uc = pos % UC;
    const int gr = r0 - 2 + ur, gc = c0 - 2 + uc;
    __nv_bfloat16* u = sU + i * UP;
    float v[32];
#pragma unroll
    for (int c2 = 0; c2 < 16; ++c2) {
      const float2 f = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(u)[c2]);
      v[2 * c2] = f.x, v[2 * c2 + 1] = f.y;
    }
    float r1[16];
#pragma unroll
    for (int o = 0; o < 16; ++o) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) s = fmaf(v[c], sS[S_WR1 + c * 16 + o], s);
      r1[o] = bf16_round(elu(s + sS[S_BR1 + o]));
    }
    float r2[8];
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) s = fmaf(r1[c], sS[S_WR2 + c * 8 + o], s);
      r2[o] = bf16_round(elu(s + sS[S_BR2 + o]));
    }
    float logit = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) logit = fmaf(r2[c], sS[S_WR3 + c], logit);
    const bool in = inside(gr, gc);
    const float d = in ? sigmoid(logit + sS[S_BR3]) : 0.f;
    u[32] = __float2bfloat16_rn(d);
    if (in && ur >= 2 && ur < 2 + TR && uc >= 2 && uc < 2 + TC) {
      d1x1[(int64_t)(b * 4 + q) * plane + (int64_t)gr * W2 + gc] = d;
    }
  }
  for (int i = t; i < 9 * 36 * 32; i += kThreads) sW[i] = prm[OFF_KI1 + i];
  __syncthreads();

  // --- iconv1: 3x3 over the phases of the 36-channel concat + ELU ----------
  for (int it = t; it < 2 * 4 * IR * IC; it += kThreads) {
    const int h16 = it / (4 * IR * IC), rest = it % (4 * IR * IC);
    const int q = rest / (IR * IC), pos = rest % (IR * IC);
    const int ir = pos / IC, ic = pos % IC;
    const int qy = q >> 1, qz = q & 1;
    float acc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int sy = qy + tap / 3 - 1, sx = qz + tap % 3 - 1;  // full-res offsets
      const int ps = 2 * (sy & 1) + (sx & 1);                  // source phase
      const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(
          sU + ((ps * UR + ir + 1 + (sy >> 1)) * UC + ic + 1 + (sx >> 1)) * UP);
      dot16<18>(acc, in, sW + tap * 36 * 32 + h16 * 16);
    }
    const bool in = inside(r0 - 1 + ir, c0 - 1 + ic);
    __nv_bfloat16* o = sI + ((q * IR + ir) * IC + ic) * IP + h16 * 16;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      o[j] = __float2bfloat16_rn(in ? elu(acc[j] + sS[S_BI1 + h16 * 16 + j]) : 0.f);
    }
  }
  __syncthreads();

  // --- final 3x3 conv 32 -> 1 + sigmoid ------------------------------------
  for (int it = t; it < 4 * TR * TC; it += kThreads) {
    const int q = it / (TR * TC), pos = it % (TR * TC);
    const int a = pos / TC, c = pos % TC;
    const int qy = q >> 1, qz = q & 1;
    float acc = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int sy = qy + tap / 3 - 1, sx = qz + tap % 3 - 1;
      const int ps = 2 * (sy & 1) + (sx & 1);
      const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(
          sI + ((ps * IR + a + 1 + (sy >> 1)) * IC + c + 1 + (sx >> 1)) * IP);
      const float* w = sS + S_KF + tap * 32;
      float s = 0.f;
#pragma unroll
      for (int c2 = 0; c2 < 16; ++c2) {
        const float2 f = __bfloat1622float2(in[c2]);
        s = fmaf(f.x, w[2 * c2], s);
        s = fmaf(f.y, w[2 * c2 + 1], s);
      }
      acc += s;
    }
    const int gr = r0 + a, gc = c0 + c;
    if (gr < Hh && gc < W2) fin[(int64_t)(b * 4 + q) * plane + (int64_t)gr * W2 + gc] = sigmoid(acc + sS[S_BF]);
  }
}

}  // namespace

extern "C" int fused_tail_num_params() { return N_PARAMS; }

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int fused_tail_forward(const void* x, const float* d2, const float* d4, const float* d8,
                                  const float* prm, float* fin, float* d1x1, int B, int Hh, int W2,
                                  void* stream) {
  cudaError_t err = cudaFuncSetAttribute(fused_tail_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W2 + TC - 1) / TC, (Hh + TR - 1) / TR, B);
  fused_tail_kernel<<<grid, kThreads, SMEM_BYTES, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x), d2, d4, d8, prm, fin, d1x1, Hh, W2);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_tail_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
