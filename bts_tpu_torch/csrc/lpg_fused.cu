// Fused reduction_1x1 -> Local Planar Guidance head, forward and backward,
// for Hopper (sm_90a).
//
// The forward replaces the TPU kernel bts_tpu/ops/lpg_pallas.py::_fused_fwd_kernel
// (launched by _fused_fwd_call, reached through lpg_fused).  Same function:
//
//   theta = sigmoid(x0) * pi/3,  phi = sigmoid(x1) * 2pi,  n4s = sigmoid(x2)
//   n = (sin t cos p, sin t sin p, cos t)                 (at low resolution)
//   out[b, y, x] = n4s / (n1 * u + n2 * v + n3)           (at full resolution)
//
// with (y, x) in the k x k patch of cell (y / k, x / k), u = (x % k - (k-1)/2) / k
// the column offset and v = (y % k - (k-1)/2) / k the row offset.  The output
// is depth / max_depth (the max_depth factors of n4 and of the scaling cancel).
//
// What bounds it: it reads 12*B*h*w bytes and writes 4*B*H*W = 4*k*k*B*h*w
// bytes, so it is store-bound (k = 8: 21x more bytes out than in).  Design:
// one block covers 256 consecutive output pixels of one row, one thread per
// pixel, so each warp stores 128 contiguous bytes.  The 256/k cells under the
// segment are transformed once per block into shared memory (not once per
// pixel), and each cell's 12 input bytes come from L2 for the k rows that
// share it.  The TPU kernel's 0/1 selector matmuls were a way to repeat
// elements on the MXU; here a thread indexes its cell as x / k directly.
//
// Rounding: products and sums use the _rn intrinsics in the order of the
// plain PyTorch version (lpg_cuda.py::lpg_fused_plain), so that no multiply-add
// is contracted; expf / sinf / cosf are the accurate library functions (the
// build uses no --use_fast_math).
//
// The backward (lpg_fused_bwd_kernel below) replaces the TPU kernel
// lpg_pallas.py::_fused_bwd_kernel (launched by _fused_bwd_call, reached
// through _lpg_fused_bwd, the VJP of lpg_fused).  For each low-res cell it
// sums the cotangent g over the cell's k x k pixels into the cotangents of
// (n1, n2, n3, n4s),
//
//   inv = 1 / (n1*u + n2*v + n3),  c = -g * inv * n4s * inv
//   dn1 = sum c*u,  dn2 = sum c*v,  dn3 = sum c,  dn4 = sum g * inv,
//
// and chains them through the spherical transform at low resolution into
// d(raw) (B, h, w, 3), written in raw's dtype.  What bounds it: it reads g,
// 4*B*H*W bytes, and writes 12*B*h*w bytes or fewer, so it is read-bound.
// Design: one thread per cell, a (32 x 8)-cell block, so a warp covers 32
// neighbouring cells of one cell row and reads k*k*32 contiguous floats of g
// per patch row group; k is a template argument, so the k*k loads of a cell
// are unrolled and in flight together.  The cell's n1..n4s are recomputed
// from raw, as the TPU kernel does, so the forward saves nothing at full
// resolution.  d(raw) goes to a (B, 3, h, w)-contiguous buffer (the NCHW
// layout of the reduction conv's output, so its backward gets it without a
// copy); the TPU kernel's transposed 0/1 selector matmuls were its way to sum
// patches on the MXU and have no counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // output pixels per block; a multiple of every k
constexpr float kPiOver3 = 1.04719755119659774615f;  // float(pi / 3)
constexpr float kTwoPi = 6.28318530717958647693f;    // float(2 * pi)

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// raw: (B, h, w, 3) f32 read through element strides (sb, sh, sw, sc), so a
// permuted NCHW tensor needs no copy.  out: (B, h*k, w*k) f32, contiguous.
__global__ void __launch_bounds__(kThreads)
lpg_fused_fwd_kernel(const float* __restrict__ raw, int64_t sb, int64_t sh, int64_t sw,
                     int64_t sc, float* __restrict__ out, int h, int w, int k) {
  __shared__ float4 cell[kThreads / 2];  // (n1, n2, n3, n4s); k >= 2
  const int W = w * k;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kThreads;  // a multiple of k
  const int c0 = x0 / k;
  const int t = threadIdx.x;

  if (t < kThreads / k && c0 + t < w) {
    const float* p = raw + b * sb + (int64_t)(y / k) * sh + (int64_t)(c0 + t) * sw;
    const float th = __fmul_rn(sigmoid(p[0]), kPiOver3);
    const float ph = __fmul_rn(sigmoid(p[sc]), kTwoPi);
    const float st = sinf(th), ct = cosf(th);
    const float sp = sinf(ph), cp = cosf(ph);
    cell[t] = make_float4(__fmul_rn(st, cp), __fmul_rn(st, sp), ct, sigmoid(p[2 * sc]));
  }
  __syncthreads();

  const int x = x0 + t;
  if (x >= W) return;
  const float4 c = cell[t / k];
  const float mid = 0.5f * (float)(k - 1);
  const float u = __fdiv_rn((float)(x % k) - mid, (float)k);
  const float v = __fdiv_rn((float)(y % k) - mid, (float)k);
  const float den = __fadd_rn(__fadd_rn(__fmul_rn(c.x, u), __fmul_rn(c.y, v)), c.z);
  out[((int64_t)b * h * k + y) * W + x] = __fdiv_rn(c.w, den);
}

constexpr int kBwdCellsX = 32;  // cells of one row per block (a warp)
constexpr int kBwdCellsY = 8;   // cell rows per block

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// raw: (B, h, w, 3) f32 through element strides (sb, sh, sw, sc); g: (B, h*k,
// w*k) f32 through element strides (gb, gh, gw); draw: (B, 3, h, w) contiguous.
template <int K, typename Out>
__global__ void __launch_bounds__(kBwdCellsX * kBwdCellsY)
lpg_fused_bwd_kernel(const float* __restrict__ raw, int64_t sb, int64_t sh, int64_t sw,
                     int64_t sc, const float* __restrict__ g, int64_t gb, int64_t gh,
                     int64_t gw, Out* __restrict__ draw, int h, int w) {
  const int cx = blockIdx.x * kBwdCellsX + threadIdx.x;
  const int cy = blockIdx.y * kBwdCellsY + threadIdx.y;
  const int b = blockIdx.z;
  if (cx >= w || cy >= h) return;

  const float* p = raw + b * sb + (int64_t)cy * sh + (int64_t)cx * sw;
  const float s0 = sigmoid(p[0]);
  const float s1 = sigmoid(p[sc]);
  const float s2 = sigmoid(p[2 * sc]);
  const float th = s0 * kPiOver3;
  const float ph = s1 * kTwoPi;
  const float st = sinf(th), ct = cosf(th);
  const float sp = sinf(ph), cp = cosf(ph);
  const float n1 = st * cp, n2 = st * sp, n3 = ct, n4s = s2;

  const float* gc = g + b * gb + (int64_t)(cy * K) * gh + (int64_t)(cx * K) * gw;
  constexpr float mid = 0.5f * (float)(K - 1);
  float dn1 = 0.f, dn2 = 0.f, dn3 = 0.f, dn4 = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float v = ((float)i - mid) / (float)K;  // row offset
    float r1 = 0.f, r3 = 0.f, r4 = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float u = ((float)j - mid) / (float)K;  // column offset
      const float inv = 1.0f / (n1 * u + n2 * v + n3);
      const float ginv = gc[i * gh + j * gw] * inv;
      const float c = -ginv * n4s * inv;
      r1 += c * u;
      r3 += c;
      r4 += ginv;
    }
    dn1 += r1;
    dn2 += r3 * v;
    dn3 += r3;
    dn4 += r4;
  }
  // chain through the spherical transform at low resolution
  const float dt = dn1 * (ct * cp) + dn2 * (ct * sp) - dn3 * st;
  const float dp = dn1 * (-st * sp) + dn2 * (st * cp);
  const int64_t plane = (int64_t)h * w;
  Out* o = draw + (int64_t)b * 3 * plane + (int64_t)cy * w + cx;
  o[0] = from_float<Out>(dt * (s0 * (1.0f - s0)) * kPiOver3);
  o[plane] = from_float<Out>(dp * (s1 * (1.0f - s1)) * kTwoPi);
  o[2 * plane] = from_float<Out>(dn4 * (s2 * (1.0f - s2)));
}

template <int K>
int launch_bwd(const float* raw, int64_t sb, int64_t sh, int64_t sw, int64_t sc, const float* g,
               int64_t gb, int64_t gh, int64_t gw, void* draw, int out_dtype, int B, int h, int w,
               cudaStream_t stream) {
  const dim3 block(kBwdCellsX, kBwdCellsY);
  const dim3 grid((w + kBwdCellsX - 1) / kBwdCellsX, (h + kBwdCellsY - 1) / kBwdCellsY, B);
  switch (out_dtype) {
    case 0:
      lpg_fused_bwd_kernel<K, float><<<grid, block, 0, stream>>>(
          raw, sb, sh, sw, sc, g, gb, gh, gw, static_cast<float*>(draw), h, w);
      break;
    case 1:
      lpg_fused_bwd_kernel<K, __nv_bfloat16><<<grid, block, 0, stream>>>(
          raw, sb, sh, sw, sc, g, gb, gh, gw, static_cast<__nv_bfloat16*>(draw), h, w);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int lpg_fused_forward(const float* raw, int64_t sb, int64_t sh, int64_t sw,
                                 int64_t sc, float* out, int B, int h, int w, int k,
                                 void* stream) {
  if (k != 2 && k != 4 && k != 8) return (int)cudaErrorInvalidValue;
  const dim3 grid((w * k + kThreads - 1) / kThreads, h * k, B);
  lpg_fused_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(raw, sb, sh, sw, sc, out,
                                                                     h, w, k);
  return (int)cudaGetLastError();
}

// d(raw) of the fused head; out_dtype 0 = f32, 1 = bf16.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int lpg_fused_backward(const float* raw, int64_t sb, int64_t sh, int64_t sw,
                                  int64_t sc, const float* g, int64_t gb, int64_t gh, int64_t gw,
                                  void* draw, int out_dtype, int B, int h, int w, int k,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 2: return launch_bwd<2>(raw, sb, sh, sw, sc, g, gb, gh, gw, draw, out_dtype, B, h, w, s);
    case 4: return launch_bwd<4>(raw, sb, sh, sw, sc, g, gb, gh, gw, draw, out_dtype, B, h, w, s);
    case 8: return launch_bwd<8>(raw, sb, sh, sw, sc, g, gb, gh, gw, draw, out_dtype, B, h, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* lpg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
