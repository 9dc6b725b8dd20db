// Eval-mode BatchNorm, with the activation after it where asked (ReLU or
// SiLU), in one pass over an NCHW-contiguous tensor (K7), for Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX package leaves BatchNorm to XLA, which
// fuses it into its neighbours.  The port ran the literal ATen chain of
// models/layers.py::BatchNorm, eight launches (x.float(), var + eps, rsqrt,
// * weight, x - mean, * mul, + bias, .to(dtype)) and a ninth for the F.relu
// after it (F.silu after EfficientNet's): a bf16 tensor was read and written
// as f32 three times over, about 40 bytes an element, and the DenseNet-161
// serving forward issued ~1,500 launches a 352x1216 frame for its BatchNorms.
//
// Function, in f32, each step rounded once as the chain rounds it:
//
//   mul[c] = rsqrt(var[c] + eps) * weight[c]
//   z      = ((float(x) - mean[c]) * mul[c]) + bias[c]
//   y      = dtype(z), dtype(max(z, 0)) (relu) or dtype(z / (1 + exp(-z))) (silu)
//
// with c the channel of the element.  The __f*_rn intrinsics keep nvcc from
// contracting a multiply and an add into an FMA, which would round once where
// ATen's separate kernels round twice; rsqrtf is the function ATen's rsqrt
// calls; the cast to bf16 rounds to nearest even, as ATen's.  ReLU commutes
// with the rounding (both are monotone and keep 0), so it is applied in f32.
// SiLU is ATen's own f32 formula, z / (1 + expf(-z)) with an IEEE division,
// taken of the f32 z before the one rounding, as ops/bn_cuda.py::normalize
// orders it.  The output equals the plain version's bit for bit
// (tests/test_torch_port_cuda.py).
//
// What bounds it: bytes.  Each element is read once and written once in x's
// dtype, 4 bytes an element in bf16 and 8 in f32, about 4 flops an element
// against the ~295 the card can do a byte; the parameters are 16 bytes a
// channel, from L2.  At 352x1216 the serving forward's 175 BatchNorms
// normalise 294.6 M elements an image: 0.352 ms at 3.35 TB/s.
//
// Design, from that bound:
// - One flat pass over the tensor in 16-byte vectors (8 bf16 or 4 f32
//   elements), loaded and stored whole.  Block b takes vectors
//   [b * chunk, (b + 1) * chunk): each of its 256 threads up to four of
//   them, all four loads issued before anything waits on them.
// - A block computes the (mean, mul, bias) of every (n, c) plane its chunk
//   touches once, into shared memory, while its loads are in flight; no
//   other launch builds them.  The launcher bounds the chunk so that it
//   touches at most kMaxPlanes planes.
// - Where H*W is a multiple of the vector, every vector lies in one plane:
//   one table entry a vector (kWhole).  Where it is not (an odd plane, or
//   H/32 of a 352x1216 frame: 11 x 38 = 418 pixels), a vector may straddle
//   planes, and the exact path walks its elements across the boundary; a
//   last partial vector is read and written element by element.
// - Where x is not 16 bytes aligned (a view with an offset), the same
//   kernel runs on 1-element vectors.
// - Index arithmetic in 32 bits, plane numbers by a multiply-high divider:
//   a first version with 64-bit divisions in every thread reached 20-28% of
//   the bound at the serving forward's shapes (PERF.md).  A tensor of 2**31
//   elements or more is refused (the largest of the port's forwards holds
//   ~82 M), and BatchNorm keeps the ATen chain for it.
// - Chunks of 1,024 vectors, fewer where that leaves under 4 blocks an SM,
//   so that a small tensor still spreads over the card.
// - The activation is a template parameter: none, ReLU and SiLU compile to
//   separate kernels with no branch in the element loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecsPerThread = 4;
constexpr int kMaxChunk = kThreads * kVecsPerThread;  // vectors a block takes
constexpr int kMinChunk = 64;
constexpr int kMaxPlanes = 512;  // planes a chunk may touch: the block's parameter table
constexpr int64_t kMaxNumel = 1LL << 31;  // a launch indexes its elements in 32 bits

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T e[V];
};

// n / d for n < 2**31 by a multiply-high, an add and a shift (the divider
// of PyTorch's IntDivider): one launch divides by the same plane size
// throughout, and an integer division is ~20 instructions.
struct Div {
  uint32_t d, m, s;
};

Div make_div(uint32_t d) {
  uint32_t s = 0;
  while ((1ULL << s) < d) ++s;
  const uint64_t one = 1;
  return {d, (uint32_t)(((one << 32) * ((one << s) - d)) / d + 1), s};
}

__device__ __forceinline__ uint32_t quotient(uint32_t n, Div q) { return (__umulhi(n, q.m) + n) >> q.s; }

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

enum Act { kNone = 0, kRelu = 1, kSilu = 2 };

// (x - mean) * mul + bias, each step rounded, then the activation, in x's
// dtype; p = (mean, mul, bias, -).  y < 0 is false for NaN, which passes, as
// in F.relu.
template <typename T, int kAct>
__device__ __forceinline__ T bn(T x, float4 p) {
  float y = __fadd_rn(__fmul_rn(__fsub_rn(to_float(x), p.x), p.y), p.z);
  if (kAct == kRelu && y < 0.f) y = 0.f;
  if (kAct == kSilu) y = __fdiv_rn(y, __fadd_rn(1.f, expf(-y)));
  return from_float<T>(y);
}

// n < 2**31 elements of whole planes, plane p of channel p % C; block b
// takes its vectors [b * chunk, (b + 1) * chunk).
template <typename T, int V, bool kWhole, int kAct>
__global__ void __launch_bounds__(kThreads)
bn_act_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ mean,
              const float* __restrict__ var, const float* __restrict__ weight,
              const float* __restrict__ bias, float eps, uint32_t n, uint32_t C, Div hw,
              uint32_t chunk) {
  __shared__ float4 table[kMaxPlanes];
  const uint32_t nvec = (n + V - 1) / V;
  const uint32_t v0 = blockIdx.x * chunk;
  const int nv = (int)(nvec - v0 < chunk ? nvec - v0 : chunk);  // this block's vectors
  const uint32_t e0 = v0 * V;
  const uint32_t p0 = quotient(e0, hw);  // the plane of its first element
  const uint32_t off0 = e0 - p0 * hw.d;  // that element's offset in it
  const uint32_t e_end = e0 + (uint32_t)nv * V < n ? e0 + (uint32_t)nv * V : n;
  const int planes = (int)(quotient(e_end - 1, hw) - p0) + 1;

  Vec<T, V> in[kVecsPerThread];
#pragma unroll
  for (int k = 0; k < kVecsPerThread; ++k) {
    const int j = threadIdx.x + k * kThreads;
    if (j >= nv) continue;
    const uint32_t e = e0 + (uint32_t)j * V;
    if (kWhole || e + V <= n) {
      in[k] = *reinterpret_cast<const Vec<T, V>*>(x + e);
    } else {  // the last, partial vector
#pragma unroll
      for (int i = 0; i < V; ++i) in[k].e[i] = e + i < n ? x[e + i] : T{};
    }
  }

  for (int i = threadIdx.x; i < planes; i += kThreads) {
    const uint32_t c = (p0 + i) % C;
    const float mul = __fmul_rn(rsqrtf(__fadd_rn(var[c], eps)), weight[c]);
    table[i] = make_float4(mean[c], mul, bias[c], 0.f);
  }
  __syncthreads();

#pragma unroll
  for (int k = 0; k < kVecsPerThread; ++k) {
    const int j = threadIdx.x + k * kThreads;
    if (j >= nv) continue;
    const uint32_t e = e0 + (uint32_t)j * V;
    const uint32_t local = off0 + (uint32_t)j * V;  // from the start of plane p0
    Vec<T, V> out;
    if (kWhole) {
      const float4 p = table[quotient(local, hw)];
#pragma unroll
      for (int i = 0; i < V; ++i) out.e[i] = bn<T, kAct>(in[k].e[i], p);
      *reinterpret_cast<Vec<T, V>*>(y + e) = out;
    } else {
      // walk the vector's elements across plane boundaries (any number of
      // them where HW < V); past n (a partial vector) the plane is held at
      // the chunk's last, and those elements are not stored
      int plane = (int)quotient(local, hw);
      uint32_t pos = local - plane * hw.d;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (pos == hw.d) pos = 0, ++plane;
        out.e[i] = bn<T, kAct>(in[k].e[i], table[min(plane, planes - 1)]);
        ++pos;
      }
      if (e + V <= n) {
        *reinterpret_cast<Vec<T, V>*>(y + e) = out;
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (e + i < n) y[e + i] = out.e[i];
        }
      }
    }
  }
}

// The SM count of the current device, read once per device.
inline int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0) cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

// Vectors a block takes: kMaxChunk, fewer where the launch would give under
// 4 blocks an SM (not under kMinChunk), and few enough that a chunk touches
// at most kMaxPlanes planes: chunk * V <= (kMaxPlanes - 2) * HW.
int64_t chunk_for(int64_t nvec, int64_t HW, int V) {
  const int64_t spread = 4LL * (sm_count() > 0 ? sm_count() : 132);
  int64_t chunk = (nvec + spread - 1) / spread;
  chunk = chunk < kMinChunk ? kMinChunk : chunk > kMaxChunk ? kMaxChunk : chunk;
  const int64_t by_planes = (kMaxPlanes - 2) * HW / V;
  return chunk < by_planes ? chunk : by_planes;
}

template <typename T, int V, bool kWhole, int kAct>
void launch(const void* x, void* y, const float* mean, const float* var, const float* weight,
            const float* bias, float eps, int64_t numel, int64_t C, int64_t HW, cudaStream_t s) {
  const int64_t nvec = (numel + V - 1) / V;
  const int64_t chunk = chunk_for(nvec, HW, V);
  const int64_t blocks = (nvec + chunk - 1) / chunk;
  bn_act_kernel<T, V, kWhole, kAct><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), mean, var, weight, bias, eps, (uint32_t)numel,
      (uint32_t)C, make_div((uint32_t)HW), (uint32_t)chunk);
}

template <typename T, int kAct>
void dispatch(const void* x, void* y, const float* mean, const float* var, const float* weight,
              const float* bias, float eps, int64_t numel, int64_t C, int64_t HW, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if ((uintptr_t)x % 16 != 0 || (uintptr_t)y % 16 != 0) {
    launch<T, 1, true, kAct>(x, y, mean, var, weight, bias, eps, numel, C, HW, s);
  } else if (HW % V == 0) {
    launch<T, V, true, kAct>(x, y, mean, var, weight, bias, eps, numel, C, HW, s);
  } else {
    launch<T, V, false, kAct>(x, y, mean, var, weight, bias, eps, numel, C, HW, s);
  }
}

template <typename T>
void dispatch_act(const void* x, void* y, const float* mean, const float* var, const float* weight,
                  const float* bias, float eps, int64_t numel, int64_t C, int64_t HW, int act,
                  cudaStream_t s) {
  if (act == kRelu) {
    dispatch<T, kRelu>(x, y, mean, var, weight, bias, eps, numel, C, HW, s);
  } else if (act == kSilu) {
    dispatch<T, kSilu>(x, y, mean, var, weight, bias, eps, numel, C, HW, s);
  } else {
    dispatch<T, kNone>(x, y, mean, var, weight, bias, eps, numel, C, HW, s);
  }
}

}  // namespace

// y = BatchNorm(x), then the activation `act` (0 none, 1 ReLU, 2 SiLU), for
// an NCHW-contiguous x of numel = N * C * HW elements in `dtype` (0 = f32,
// 1 = bf16) into y (same dtype, contiguous), with f32 per-channel mean, var,
// weight and bias, on
// `device`'s `stream`.  numel < 2**31 and HW <= 2**27, so that every index
// and plane offset fits the divider's 31 bits.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int bn_act_forward(const void* x, void* y, int dtype, const float* mean,
                              const float* var, const float* weight, const float* bias, float eps,
                              int64_t numel, int C, int HW, int act, int device, void* stream) {
  if (numel <= 0 || numel >= kMaxNumel || C <= 0 || HW <= 0 || HW > (1 << 27) ||
      numel % ((int64_t)C * HW) != 0 || (dtype != 0 && dtype != 1) || act < kNone || act > kSilu) {
    return (int)cudaErrorInvalidValue;
  }
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    dispatch_act<float>(x, y, mean, var, weight, bias, eps, numel, C, HW, act, s);
  } else {
    dispatch_act<__nv_bfloat16>(x, y, mean, var, weight, bias, eps, numel, C, HW, act, s);
  }
  err = cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return (int)err;
}

extern "C" const char* bn_act_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
