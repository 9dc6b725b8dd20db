// Fused reduction_1x1 -> Local Planar Guidance head, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel bts_tpu/ops/lpg_pallas.py::_fused_fwd_kernel
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
  const float half = 0.5f * (float)(k - 1);
  const float u = __fdiv_rn((float)(x % k) - half, (float)k);
  const float v = __fdiv_rn((float)(y % k) - half, (float)k);
  const float den = __fadd_rn(__fadd_rn(__fmul_rn(c.x, u), __fmul_rn(c.y, v)), c.z);
  out[((int64_t)b * h * k + y) * W + x] = __fdiv_rn(c.w, den);
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

extern "C" const char* lpg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
