// Local Planar Guidance kernels for Hopper (sm_90a): the fused reduction_1x1
// -> LPG head (forward K1, backward K2), its phase-plane form K5, and the
// LPG of an already-transformed plane (forward K3, backward K4).
//
// K1 replaces the TPU kernel bts_tpu/ops/lpg_pallas.py::_fused_fwd_kernel
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
// K3 replaces lpg_pallas.py::_fwd_kernel (launched by _fwd_call, reached
// through lpg, the public local_planar_guidance op): the same kernel body on
// a plane (B, h, w, 4) = (n1, n2, n3, n4) read as it is, without the
// spherical transform (lpg_fwd_kernel<false>).
//
// K5 replaces bts_tpu/ops/tail_pallas.py::_phase_lpg_kernel (launched by
// _phase_lpg_call, reached through lpg_phase_planes on the fused decoder
// tail): K1's map as four 2x2 phase planes (B, 4, h*k/2, w*k/2), plane
// q = 2*py + pz holding full-resolution pixel (2U+py, 2V+pz).  Its in-patch
// indices are 2*(U % (k/2)) + py and 2*(V % (k/2)) + pz, exact small
// integers, so u, v and every later operation are K1's: interleaving the
// planes gives K1's output bit for bit.  One block covers 256 consecutive
// phase columns V of one phase row U for all four planes; each store of a
// warp is 128 contiguous bytes of one plane.  Bound as K1: the same bytes.
//
// Rounding: products and sums use the _rn intrinsics in the order of the
// plain PyTorch version (lpg_cuda.py::lpg_fused_plain), so that no multiply-add
// is contracted; expf / sinf / cosf are the accurate library functions (the
// build uses no --use_fast_math).
//
// K2 (lpg_bwd_kernel<K, false, Out>) replaces the TPU kernel
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
//
// K4 (lpg_bwd_kernel<K, true, Out>) replaces lpg_pallas.py::_bwd_kernel
// (launched by _bwd_call, reached through _lpg_bwd, the VJP of lpg): K2's
// patch sums on a plane read as it is, written as d(plane) (B, h, w, 4) in
// the plane's dtype, as _lpg_bwd stacks and casts them.  Read-bound as K2.

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

// (n1, n2, n3, n4s) of one cell from raw (x0, x1, x2) at p, channel stride sc.
__device__ __forceinline__ float4 spherical_cell(const float* p, int64_t sc) {
  const float th = __fmul_rn(sigmoid(p[0]), kPiOver3);
  const float ph = __fmul_rn(sigmoid(p[sc]), kTwoPi);
  const float st = sinf(th), ct = cosf(th);
  const float sp = sinf(ph), cp = cosf(ph);
  return make_float4(__fmul_rn(st, cp), __fmul_rn(st, sp), ct, sigmoid(p[2 * sc]));
}

// (n1, n2, n3, n4) of one cell of a plane at p, channel stride sc.
__device__ __forceinline__ float4 plane_cell(const float* p, int64_t sc) {
  return make_float4(p[0], p[sc], p[2 * sc], p[3 * sc]);
}

// n4 / (n1*u + n2*v + n3), in the plain version's order
__device__ __forceinline__ float lpg_value(float4 c, float u, float v) {
  const float den = __fadd_rn(__fadd_rn(__fmul_rn(c.x, u), __fmul_rn(c.y, v)), c.z);
  return __fdiv_rn(c.w, den);
}

// in-patch offset (i - (k-1)/2) / k of index i
__device__ __forceinline__ float patch_offset(int i, int k) {
  return __fdiv_rn((float)i - 0.5f * (float)(k - 1), (float)k);
}

// K1 (kRaw: in = raw (B, h, w, 3), spherical transform) and K3 (in = plane
// (B, h, w, 4)), f32 read through element strides (sb, sh, sw, sc), so a
// permuted NCHW tensor needs no copy.  out: (B, h*k, w*k) f32, contiguous.
template <bool kRaw>
__global__ void __launch_bounds__(kThreads)
lpg_fwd_kernel(const float* __restrict__ in, int64_t sb, int64_t sh, int64_t sw, int64_t sc,
               float* __restrict__ out, int h, int w, int k) {
  __shared__ float4 cell[kThreads / 2];  // k >= 2
  const int W = w * k;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kThreads;  // a multiple of k
  const int c0 = x0 / k;
  const int t = threadIdx.x;

  if (t < kThreads / k && c0 + t < w) {
    const float* p = in + b * sb + (int64_t)(y / k) * sh + (int64_t)(c0 + t) * sw;
    cell[t] = kRaw ? spherical_cell(p, sc) : plane_cell(p, sc);
  }
  __syncthreads();

  const int x = x0 + t;
  if (x >= W) return;
  out[((int64_t)b * h * k + y) * W + x] =
      lpg_value(cell[t / k], patch_offset(x % k, k), patch_offset(y % k, k));
}

// K5: raw (B, h, w, 3) f32 through element strides; out (B, 4, h*k/2, w*k/2)
// f32, contiguous.  Block: phase columns [v0, v0 + 256) of phase row U.
__global__ void __launch_bounds__(kThreads)
lpg_phase_kernel(const float* __restrict__ raw, int64_t sb, int64_t sh, int64_t sw, int64_t sc,
                 float* __restrict__ out, int h, int w, int k) {
  __shared__ float4 cell[kThreads];  // k/2 >= 1 phase columns per cell
  const int kk = k / 2;
  const int Hh = h * kk, Wh = w * kk;
  const int U = blockIdx.y;
  const int b = blockIdx.z;
  const int v0 = blockIdx.x * kThreads;  // a multiple of kk
  const int c0 = v0 / kk;
  const int t = threadIdx.x;

  if (t < kThreads / kk && c0 + t < w) {
    cell[t] = spherical_cell(raw + b * sb + (int64_t)(U / kk) * sh + (int64_t)(c0 + t) * sw, sc);
  }
  __syncthreads();

  const int V = v0 + t;
  if (V >= Wh) return;
  const float4 c = cell[t / kk];
  const int64_t plane = (int64_t)Hh * Wh;
  float* o = out + (int64_t)b * 4 * plane + (int64_t)U * Wh + V;
#pragma unroll
  for (int py = 0; py < 2; ++py) {
    const float v = patch_offset(2 * (U % kk) + py, k);
#pragma unroll
    for (int pz = 0; pz < 2; ++pz) {
      o[(2 * py + pz) * plane] = lpg_value(c, patch_offset(2 * (V % kk) + pz, k), v);
    }
  }
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

// K2 (kPlane false): in = raw (B, h, w, 3); dout = d(raw) (B, 3, h, w) contiguous.
// K4 (kPlane true): in = plane (B, h, w, 4); dout = d(plane) (B, h, w, 4) contiguous.
// in is f32 through element strides (sb, sh, sw, sc); g (B, h*k, w*k) f32
// through element strides (gb, gh, gw).
template <int K, bool kPlane, typename Out>
__global__ void __launch_bounds__(kBwdCellsX * kBwdCellsY)
lpg_bwd_kernel(const float* __restrict__ in, int64_t sb, int64_t sh, int64_t sw, int64_t sc,
               const float* __restrict__ g, int64_t gb, int64_t gh, int64_t gw,
               Out* __restrict__ dout, int h, int w) {
  const int cx = blockIdx.x * kBwdCellsX + threadIdx.x;
  const int cy = blockIdx.y * kBwdCellsY + threadIdx.y;
  const int b = blockIdx.z;
  if (cx >= w || cy >= h) return;

  const float* p = in + b * sb + (int64_t)cy * sh + (int64_t)cx * sw;
  float n1, n2, n3, n4s, s0 = 0.f, s1 = 0.f, s2 = 0.f, st = 0.f, ct = 0.f, sp = 0.f, cp = 0.f;
  if constexpr (kPlane) {
    n1 = p[0], n2 = p[sc], n3 = p[2 * sc], n4s = p[3 * sc];
  } else {
    s0 = sigmoid(p[0]);
    s1 = sigmoid(p[sc]);
    s2 = sigmoid(p[2 * sc]);
    const float th = s0 * kPiOver3;
    const float ph = s1 * kTwoPi;
    st = sinf(th), ct = cosf(th);
    sp = sinf(ph), cp = cosf(ph);
    n1 = st * cp, n2 = st * sp, n3 = ct, n4s = s2;
  }

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
  if constexpr (kPlane) {
    Out* o = dout + (((int64_t)b * h + cy) * w + cx) * 4;
    o[0] = from_float<Out>(dn1);
    o[1] = from_float<Out>(dn2);
    o[2] = from_float<Out>(dn3);
    o[3] = from_float<Out>(dn4);
  } else {
    // chain through the spherical transform at low resolution
    const float dt = dn1 * (ct * cp) + dn2 * (ct * sp) - dn3 * st;
    const float dp = dn1 * (-st * sp) + dn2 * (st * cp);
    const int64_t plane = (int64_t)h * w;
    Out* o = dout + (int64_t)b * 3 * plane + (int64_t)cy * w + cx;
    o[0] = from_float<Out>(dt * (s0 * (1.0f - s0)) * kPiOver3);
    o[plane] = from_float<Out>(dp * (s1 * (1.0f - s1)) * kTwoPi);
    o[2 * plane] = from_float<Out>(dn4 * (s2 * (1.0f - s2)));
  }
}

template <int K, bool kPlane>
int launch_bwd(const float* in, int64_t sb, int64_t sh, int64_t sw, int64_t sc, const float* g,
               int64_t gb, int64_t gh, int64_t gw, void* dout, int out_dtype, int B, int h, int w,
               cudaStream_t stream) {
  const dim3 block(kBwdCellsX, kBwdCellsY);
  const dim3 grid((w + kBwdCellsX - 1) / kBwdCellsX, (h + kBwdCellsY - 1) / kBwdCellsY, B);
  switch (out_dtype) {
    case 0:
      lpg_bwd_kernel<K, kPlane, float><<<grid, block, 0, stream>>>(
          in, sb, sh, sw, sc, g, gb, gh, gw, static_cast<float*>(dout), h, w);
      break;
    case 1:
      lpg_bwd_kernel<K, kPlane, __nv_bfloat16><<<grid, block, 0, stream>>>(
          in, sb, sh, sw, sc, g, gb, gh, gw, static_cast<__nv_bfloat16*>(dout), h, w);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <bool kPlane>
int backward(const float* in, int64_t sb, int64_t sh, int64_t sw, int64_t sc, const float* g,
             int64_t gb, int64_t gh, int64_t gw, void* dout, int out_dtype, int B, int h, int w,
             int k, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 2: return launch_bwd<2, kPlane>(in, sb, sh, sw, sc, g, gb, gh, gw, dout, out_dtype, B, h, w, s);
    case 4: return launch_bwd<4, kPlane>(in, sb, sh, sw, sc, g, gb, gh, gw, dout, out_dtype, B, h, w, s);
    case 8: return launch_bwd<8, kPlane>(in, sb, sh, sw, sc, g, gb, gh, gw, dout, out_dtype, B, h, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kRaw>
int forward(const float* in, int64_t sb, int64_t sh, int64_t sw, int64_t sc, float* out, int B,
            int h, int w, int k, void* stream) {
  if (k != 2 && k != 4 && k != 8) return (int)cudaErrorInvalidValue;
  const dim3 grid((w * k + kThreads - 1) / kThreads, h * k, B);
  lpg_fwd_kernel<kRaw><<<grid, kThreads, 0, (cudaStream_t)stream>>>(in, sb, sh, sw, sc, out, h, w, k);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError() (0 on
// success).  out_dtype: 0 = f32, 1 = bf16.

// K1: raw (B, h, w, 3) -> depth / max_depth (B, h*k, w*k)
extern "C" int lpg_fused_forward(const float* raw, int64_t sb, int64_t sh, int64_t sw,
                                 int64_t sc, float* out, int B, int h, int w, int k,
                                 void* stream) {
  return forward<true>(raw, sb, sh, sw, sc, out, B, h, w, k, stream);
}

// K2: d(raw) (B, 3, h, w) of the fused head
extern "C" int lpg_fused_backward(const float* raw, int64_t sb, int64_t sh, int64_t sw,
                                  int64_t sc, const float* g, int64_t gb, int64_t gh, int64_t gw,
                                  void* draw, int out_dtype, int B, int h, int w, int k,
                                  void* stream) {
  return backward<false>(raw, sb, sh, sw, sc, g, gb, gh, gw, draw, out_dtype, B, h, w, k, stream);
}

// K3: plane (B, h, w, 4) -> depth (B, h*k, w*k)
extern "C" int lpg_forward(const float* plane, int64_t sb, int64_t sh, int64_t sw, int64_t sc,
                           float* out, int B, int h, int w, int k, void* stream) {
  return forward<false>(plane, sb, sh, sw, sc, out, B, h, w, k, stream);
}

// K4: d(plane) (B, h, w, 4)
extern "C" int lpg_backward(const float* plane, int64_t sb, int64_t sh, int64_t sw, int64_t sc,
                            const float* g, int64_t gb, int64_t gh, int64_t gw, void* dplane,
                            int out_dtype, int B, int h, int w, int k, void* stream) {
  return backward<true>(plane, sb, sh, sw, sc, g, gb, gh, gw, dplane, out_dtype, B, h, w, k, stream);
}

// K5: raw (B, h, w, 3) -> phase planes (B, 4, h*k/2, w*k/2)
extern "C" int lpg_phase_forward(const float* raw, int64_t sb, int64_t sh, int64_t sw,
                                 int64_t sc, float* out, int B, int h, int w, int k,
                                 void* stream) {
  if (k != 2 && k != 4 && k != 8) return (int)cudaErrorInvalidValue;
  const int kk = k / 2;
  const dim3 grid((w * kk + kThreads - 1) / kThreads, h * kk, B);
  lpg_phase_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(raw, sb, sh, sw, sc, out, h, w, k);
  return (int)cudaGetLastError();
}

extern "C" const char* lpg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
