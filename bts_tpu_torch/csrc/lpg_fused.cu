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
// What bounds it: it reads 3 values per cell (12*B*h*w bytes in f32, 6 in
// bf16) and writes 4*B*H*W = 4*k*k*B*h*w bytes, so it is store-bound (k = 8:
// 21x more bytes out than in).  The first design (one 256-thread block per
// 256 pixels of one output row, one float stored per thread) reached 8-12%
// of that bound: 16,896 short blocks per config-4 head, each waiting on a
// global load, then on the transform in 256/k of its threads, then on a
// __syncthreads() before its one store; the transform of a cell row was
// recomputed for each of its k output rows, and every pixel divided twice
// for patch offsets that depend only on x % k and y % k.
//
// Design: a lane owns 4 consecutive output columns (a column group) and
// stores them as one float4 in each of the k rows of its cell row, so a
// warp's store is 512 contiguous bytes; k = 8: two lanes share a cell,
// k = 4: one cell per lane, k = 2: two cells per lane.  A warp's work item
// is (cell row b*h + cy, 32 column groups); each lane transforms its cells
// once, in registers, and reuses them for all k rows; its 4 column offsets
// are computed once and each row offset once per row, not per pixel.  One
// warp per item, 8 per block (a config-4 head: 528 to 2,112 blocks, 4 KB
// of stores per warp at k = 8 to 1 KB at k = 2), and the block scheduler
// keeps the card full.  raw is read in its own dtype (f32 or bf16,
// converted in registers: exact) through its strides.  Where a row's pitch
// is not a multiple of 4 floats (k = 2, odd w), odd rows are not 16-byte
// aligned and the lane stores two float2 instead (store_cols).  Every
// per-pixel operation (spherical_cell, patch_offset, lpg_value) is the
// first design's, in the same order, so the output is bit for bit the same.
//
// Small grids (fwd_launch): a b1 serving head gives 440 (k = 8) to 1,760
// (k = 2) work items, 3.3 to 13 warps per SM of the H100's 132, and each
// warp runs its k rows of 4 divisions per lane back to back with too few
// warps beside it to hide their latency.  Each head writes ~1.7 MB, so
// bandwidth per SM is not the limit; the launch ramp and the number of
// warps at work are (TMA, wgmma and clusters would not help here).  At
// k = 8, where the grid holds fewer than kSplitBelow warps per SM, the cell
// row's 8 output rows are split among kSplitRows = 4 warps, each re-reading
// its cells' inputs (12 or 16 bytes per cell, from L2) and storing 2 rows,
// in blocks of kSplitWarps warps so the blocks spread evenly.  Only k = 8
// splits: the b1 k = 4 head measured the same split in two (0.00375 ms
// against 0.00374 unsplit, tools/phase_ab.py) and k = 2 already has 13
// warps per SM.  Every config-4 (b16) and config-3 (b4) head keeps one warp
// per cell row and 8 warps per block, as before.  K1 at the b1 k = 8 head:
// 0.00394 ms, against 0.00462 without the split, 0.00404 with 2 warps per
// cell row and 0.00435 with 8 (each warp still transforms its cells, so
// more warps add work); K3 0.00327, 0.00393, 0.00337 and 0.00357
// (bts_tpu_torch/tools/lpg_launch_shapes.py on an H100, PERF.md).  The SM
// count is read once per device (cudaDevAttrMultiProcessorCount).
//
// K3 replaces lpg_pallas.py::_fwd_kernel (launched by _fwd_call, reached
// through lpg, the public local_planar_guidance op): the same kernel and
// launch on a plane (B, h, w, 4) = (n1, n2, n3, n4) read as it is, without
// the spherical transform (lpg_fwd_kernel<false, K, R, W, In>).  It runs at
// b1 serving heads, so it is the split launch's main user.
//
// K5 replaces bts_tpu/ops/tail_pallas.py::_phase_lpg_kernel (launched by
// _phase_lpg_call, reached through lpg_phase_planes on the fused decoder
// tail): K1's map as four 2x2 phase planes (B, 4, h*k/2, w*k/2), plane
// q = 2*py + pz holding full-resolution pixel (2U+py, 2V+pz).  Its in-patch
// indices are 2*(U % (k/2)) + py and 2*(V % (k/2)) + pz, exact small
// integers, so u, v and every later operation are K1's: interleaving the
// planes gives K1's output bit for bit.  Bound as K1: the same bytes.  Its
// first design (one 256-thread block per 256 phase columns of one phase
// row; 256/(k/2) threads transforming while the rest waited on a
// __syncthreads(); one scalar store per thread and plane) reached 15% of
// that bound at the serving heads.  Design: no shared memory, no barrier.
// A lane owns the k/2 phase columns of one cell, transforms that cell
// itself, in registers, and stores its columns in each of the four planes
// as one float4 (k = 8), float2 (k = 4) or float (k = 2) - a warp's store
// is 128 to 512 contiguous bytes of one plane; float2 or scalars where the
// pitch w*k/2 does not allow the vector.  A warp's work item is (b, phase
// row U, 32 cells), in blocks of kK5Warps = 4: 880, 1,760 and 3,344 warps
// at the b1 serving heads.  At these sizes the time goes to each warp's
// serial chain (the raw load, the transform's expf, sinf, cosf and
// divisions, then its stores), not to bandwidth, so each lane transforms
// one cell and the warps are many.  Measured and left out (PERF.md):
// lanes on 4 phase columns (1 to 4 cells each) took 0.0137 ms per b1
// forward against 0.0116; lanes on 2 cells 0.0124; a cell row per warp
// (all k/2 phase rows, each cell transformed once) 0.0131, though 5%
// faster at the b4 export heads.  raw is read in its dtype (f32 or bf16)
// through its strides, as K1 reads it, so a bf16 decoder needs no cast
// before K5.
//
// Launch floor: lpg_empty_launch runs an empty kernel on a forward's grid
// and block, so its device time is the least a launch of that shape costs.
//
// Rounding: products and sums use the _rn intrinsics in the order of the
// plain PyTorch version (lpg_cuda.py::lpg_fused_plain), so that no multiply-add
// is contracted; expf / sinf / cosf are the accurate library functions (the
// build uses no --use_fast_math).
//
// K2 (lpg_bwd_kernel<K, false, kVec, T>) replaces the TPU kernel
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
// The first design (one thread per cell in a 32 x 8-cell block, k*k scalar
// loads each) reached 32% of that bound: at k = 8 each warp-wide load touched
// 32 sectors for 128 useful bytes, and the k = 8 head had 288 blocks, ~560
// threads per SM.  Design: a lane loads V = 4 consecutive floats of a patch
// row (V = 2 at k = 2) as one vector, k rows at once, so a warp's load is
// 512 (256) contiguous bytes; at k = 8 two lanes share a cell and add their
// partial sums with __shfl_xor_sync.  A warp's work item is (cell row, 16 or
// 32 cells), one warp per item as in K1.  A g whose strides or base do not
// allow the vector (a sliced view) is read by the same kernel's scalar-load
// instance (kVec false).
// raw is read in its dtype.  The cell's n1..n4s are recomputed from raw, as
// the TPU kernel does, so the forward saves nothing at full resolution.
// d(raw) goes to a (B, 3, h, w)-contiguous buffer (the NCHW layout of the
// reduction conv's output, so its backward gets it without a copy); the TPU
// kernel's transposed 0/1 selector matmuls were its way to sum patches on
// the MXU and have no counterpart here.
//
// K4 (lpg_bwd_kernel<K, true, kVec, T>) replaces lpg_pallas.py::_bwd_kernel
// (launched by _bwd_call, reached through _lpg_bwd, the VJP of lpg): K2's
// patch sums on a plane read as it is, written as d(plane) (B, h, w, 4) in
// the plane's dtype, as _lpg_bwd stacks and casts them.  Read-bound as K2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;       // K1-K4: warps per block, each on its own work item
constexpr int kSplitBelow = 7;  // K1, K3 at k = 8: split rows where the grid has fewer warps per SM
constexpr int kSplitRows = 4;   // K1, K3 at k = 8: warps per cell row of a split launch
constexpr int kSplitWarps = 4;  // K1, K3: warps per block of a split launch
constexpr int kK5Warps = 4;     // K5: warps per block
constexpr float kPiOver3 = 1.04719755119659774615f;  // float(pi / 3)
constexpr float kTwoPi = 6.28318530717958647693f;    // float(2 * pi)

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// (n1, n2, n3, n4s) of one cell from raw (x0, x1, x2) at p, channel stride sc.
template <typename In>
__device__ __forceinline__ float4 spherical_cell(const In* p, int64_t sc) {
  const float th = __fmul_rn(sigmoid(to_float(p[0])), kPiOver3);
  const float ph = __fmul_rn(sigmoid(to_float(p[sc])), kTwoPi);
  const float st = sinf(th), ct = cosf(th);
  const float sp = sinf(ph), cp = cosf(ph);
  return make_float4(__fmul_rn(st, cp), __fmul_rn(st, sp), ct, sigmoid(to_float(p[2 * sc])));
}

// (n1, n2, n3, n4) of one cell of a plane at p, channel stride sc.
template <typename In>
__device__ __forceinline__ float4 plane_cell(const In* p, int64_t sc) {
  return make_float4(to_float(p[0]), to_float(p[sc]), to_float(p[2 * sc]), to_float(p[3 * sc]));
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

// (n1, n2, n3, n4s) of a cell of raw, or (n1..n4) of a cell of a plane, at p.
template <bool kRaw, typename In>
__device__ __forceinline__ float4 cell_at(const In* p, int64_t sc) {
  if constexpr (kRaw) {
    return spherical_cell(p, sc);
  } else {
    return plane_cell(p, sc);
  }
}

// The C floats of val at o, columns x0 .. x0+C-1 of a row of W floats (x0 a
// multiple of C): one float4 (C = 4) or float2 (C = 2) where W is a
// multiple of C (rows aligned, groups whole), else float2 (W even) or
// scalars, none past the row's end.
template <int C>
__device__ __forceinline__ void store_cols(float* o, const float (&val)[C], int x0, int W) {
  if constexpr (C == 4) {
    if (W % 4 == 0) {
      *reinterpret_cast<float4*>(o) = make_float4(val[0], val[1], val[2], val[3]);
      return;
    }
  }
  if constexpr (C >= 2) {
    if (W % 2 == 0) {
#pragma unroll
      for (int j = 0; j < C; j += 2) {
        if (j == 0 || x0 + j < W) *reinterpret_cast<float2*>(o + j) = make_float2(val[j], val[j + 1]);
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < C; ++j) {
    if (j == 0 || x0 + j < W) o[j] = val[j];
  }
}

// K1 (kRaw: in = raw (B, h, w, 3), spherical transform) and K3 (in = plane
// (B, h, w, 4)), read in its dtype In through element strides (sb, sh, sw,
// sc), so a permuted NCHW tensor needs no copy.  out: (B, h*k, w*k) f32,
// contiguous, 16-byte aligned.  One warp per work item (cell row b*h + cy,
// 32 groups of 4 output columns, the item's part of the k rows: rows
// [part*K/R, (part+1)*K/R)), kW warps per block:
// items = B * h * ceil(w*k / 128) * R.
template <bool kRaw, int K, int R, int kW, typename In>
__global__ void __launch_bounds__(kW * 32)
lpg_fwd_kernel(const In* __restrict__ in, int64_t sb, int64_t sh, int64_t sw, int64_t sc,
               float* __restrict__ out, int h, int w, int items) {
  constexpr int kRows = K / R;  // output rows per item
  const int item = blockIdx.x * kW + threadIdx.x / 32;
  const int W = w * K;
  const int chunks = (W + 127) / 128;
  const int group = item / R;             // (cell row, chunk); its R items are neighbours
  const int part = item - group * R;
  const int row = group / chunks;  // b * h + cy
  const int x0 = ((group - row * chunks) * 32 + threadIdx.x % 32) * 4;  // the lane's first column
  if (item >= items || x0 >= W) return;
  const int b = row / h, cy = row - b * h, cx = x0 / K;
  const In* p = in + b * sb + (int64_t)cy * sh + (int64_t)cx * sw;
  const float4 c0 = cell_at<kRaw>(p, sc);
  float4 c1 = c0;  // k = 2: columns 2, 3 are the next cell's (none past an odd w)
  if (K == 2 && cx + 1 < w) c1 = cell_at<kRaw>(p + sw, sc);
  float u[4];  // the four columns' offsets
#pragma unroll
  for (int j = 0; j < 4; ++j) u[j] = patch_offset((x0 + j) % K, K);

  float* o = out + ((int64_t)row * K + part * kRows) * W + x0;
#pragma unroll
  for (int i = 0; i < kRows; ++i, o += W) {
    const float v = patch_offset(part * kRows + i, K);
    const float val[4] = {lpg_value(c0, u[0], v), lpg_value(c0, u[1], v), lpg_value(c1, u[2], v),
                          lpg_value(c1, u[3], v)};
    store_cols<4>(o, val, x0, W);
  }
}

// K5: raw (B, h, w, 3) in its dtype In through element strides; out
// (B, 4, Hh, Wh) f32, contiguous, Hh = h*KK, Wh = w*KK, KK = k/2.  A lane
// owns one cell's KK consecutive phase columns; one warp per work item (b,
// phase row U, 32 cells), kK5Warps per block: items = B * Hh * ceil(w / 32).
template <int KK, typename In>
__global__ void __launch_bounds__(kK5Warps * 32)
lpg_phase_kernel(const In* __restrict__ raw, int64_t sb, int64_t sh, int64_t sw, int64_t sc,
                 float* __restrict__ out, int h, int w, int items) {
  constexpr int K = 2 * KK;
  const int item = blockIdx.x * kK5Warps + threadIdx.x / 32;
  const int Hh = h * KK, Wh = w * KK;
  const int chunks = (w + 31) / 32;
  const int row = item / chunks;  // b * Hh + U
  const int cx = (item - row * chunks) * 32 + threadIdx.x % 32;
  if (item >= items || cx >= w) return;
  const int b = row / Hh, U = row - b * Hh;
  const float4 c = spherical_cell(raw + b * sb + (int64_t)(U / KK) * sh + (int64_t)cx * sw, sc);
  float u[2][KK];  // phase column j's offset in plane column pz: in-patch column 2*j + pz
#pragma unroll
  for (int pz = 0; pz < 2; ++pz) {
#pragma unroll
    for (int j = 0; j < KK; ++j) u[pz][j] = patch_offset(2 * j + pz, K);
  }

  const int64_t plane = (int64_t)Hh * Wh;
  const int V0 = cx * KK;
  float* o = out + (int64_t)b * 4 * plane + (int64_t)U * Wh + V0;
#pragma unroll
  for (int py = 0; py < 2; ++py) {
    const float v = patch_offset(2 * (U % KK) + py, K);
#pragma unroll
    for (int pz = 0; pz < 2; ++pz) {
      float val[KK];
#pragma unroll
      for (int j = 0; j < KK; ++j) val[j] = lpg_value(c, u[pz][j], v);
      store_cols<KK>(o + (2 * py + pz) * plane, val, V0, Wh);
    }
  }
}

__global__ void empty_kernel() {}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// V consecutive floats of g at p (column stride gw): one vector load where
// kVec (gw == 1 and p aligned to 4*V bytes), else V scalar loads.
template <int V, bool kVec>
__device__ __forceinline__ void load_cols(const float* p, int64_t gw, float (&x)[V]) {
  if constexpr (kVec && V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
  } else if constexpr (kVec && V == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    x[0] = q.x, x[1] = q.y;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) x[j] = p[j * gw];
  }
}

// K2 (kPlane false): in = raw (B, h, w, 3); dout = d(raw) (B, 3, h, w) contiguous.
// K4 (kPlane true): in = plane (B, h, w, 4); dout = d(plane) (B, h, w, 4) contiguous.
// in and dout in dtype T (f32 or bf16), in through element strides (sb, sh,
// sw, sc); g (B, h*k, w*k) f32 through element strides (gb, gh, gw), read
// with vector loads where kVec.  items = B * h * chunks of a warp's cells.
template <int K, bool kPlane, bool kVec, typename T>
__global__ void __launch_bounds__(kWarps * 32)
lpg_bwd_kernel(const T* __restrict__ in, int64_t sb, int64_t sh, int64_t sw, int64_t sc,
               const float* __restrict__ g, int64_t gb, int64_t gh, int64_t gw,
               T* __restrict__ dout, int h, int w, int items) {
  constexpr int V = K < 4 ? K : 4;  // patch columns per lane: a float4, a float2 at k = 2
  constexpr int L = K / V;          // lanes per cell: 2 at k = 8, else 1
  constexpr int kCellsPerWarp = 32 / L;
  constexpr float mid = 0.5f * (float)(K - 1);
  // one warp per item, so every lane of a warp reaches the shuffles
  const int item = blockIdx.x * kWarps + threadIdx.x / 32;
  if (item >= items) return;
  const int lane = threadIdx.x % 32;
  const int part = lane % L;  // the lane's V columns of each patch row
  const int chunks = (w + kCellsPerWarp - 1) / kCellsPerWarp;
  const int row = item / chunks;  // b * h + cy
  const int cx = (item - row * chunks) * kCellsPerWarp + lane / L;
  const int b = row / h, cy = row - b * h;
  const bool valid = cx < w;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, st = 0.f, ct = 0.f, sp = 0.f, cp = 0.f;
  float dn1 = 0.f, dn2 = 0.f, dn3 = 0.f, dn4 = 0.f;
  if (valid) {
    // the patch's k rows of g first: in flight during the transform
    const float* gc = g + b * gb + (int64_t)(cy * K) * gh + (int64_t)(cx * K + part * V) * gw;
    float gv[K][V];
#pragma unroll
    for (int i = 0; i < K; ++i) load_cols<V, kVec>(gc + i * gh, gw, gv[i]);

    const T* p = in + b * sb + (int64_t)cy * sh + (int64_t)cx * sw;
    float n1, n2, n3, n4s;
    if constexpr (kPlane) {
      n1 = to_float(p[0]), n2 = to_float(p[sc]);
      n3 = to_float(p[2 * sc]), n4s = to_float(p[3 * sc]);
    } else {
      s0 = sigmoid(to_float(p[0]));
      s1 = sigmoid(to_float(p[sc]));
      s2 = sigmoid(to_float(p[2 * sc]));
      const float th = s0 * kPiOver3;
      const float ph = s1 * kTwoPi;
      st = sinf(th), ct = cosf(th);
      sp = sinf(ph), cp = cosf(ph);
      n1 = st * cp, n2 = st * sp, n3 = ct, n4s = s2;
    }
    float u[V];  // the lane's column offsets
#pragma unroll
    for (int j = 0; j < V; ++j) u[j] = ((float)(part * V + j) - mid) / (float)K;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float v = ((float)i - mid) / (float)K;  // row offset
      float r1 = 0.f, r3 = 0.f, r4 = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float inv = 1.0f / (n1 * u[j] + n2 * v + n3);
        const float ginv = gv[i][j] * inv;
        const float c = -ginv * n4s * inv;
        r1 += c * u[j];
        r3 += c;
        r4 += ginv;
      }
      dn1 += r1;
      dn2 += r3 * v;
      dn3 += r3;
      dn4 += r4;
    }
  }
#pragma unroll
  for (int m = 1; m < L; m *= 2) {  // the cell's other columns, from its other lanes
    dn1 += __shfl_xor_sync(0xffffffffu, dn1, m);
    dn2 += __shfl_xor_sync(0xffffffffu, dn2, m);
    dn3 += __shfl_xor_sync(0xffffffffu, dn3, m);
    dn4 += __shfl_xor_sync(0xffffffffu, dn4, m);
  }
  if (!valid || part != 0) return;
  if constexpr (kPlane) {
    T* o = dout + (((int64_t)b * h + cy) * w + cx) * 4;
    o[0] = from_float<T>(dn1);
    o[1] = from_float<T>(dn2);
    o[2] = from_float<T>(dn3);
    o[3] = from_float<T>(dn4);
  } else {
    // chain through the spherical transform at low resolution
    const float dt = dn1 * (ct * cp) + dn2 * (ct * sp) - dn3 * st;
    const float dp = dn1 * (-st * sp) + dn2 * (st * cp);
    const int64_t plane = (int64_t)h * w;
    T* o = dout + (int64_t)b * 3 * plane + (int64_t)cy * w + cx;
    o[0] = from_float<T>(dt * (s0 * (1.0f - s0)) * kPiOver3);
    o[plane] = from_float<T>(dp * (s1 * (1.0f - s1)) * kTwoPi);
    o[2 * plane] = from_float<T>(dn4 * (s2 * (1.0f - s2)));
  }
}

// The grid for `warp_items` work items, one warp each.  (A grid of as many
// blocks as the card holds, walking the items in a grid-stride loop, was
// not faster at the config-4 heads: PERF.md.)
inline int grid_for(int warp_items) { return (warp_items + kWarps - 1) / kWarps; }

template <int K, bool kPlane, bool kVec, typename T>
int launch_bwd(const void* in, int64_t sb, int64_t sh, int64_t sw, int64_t sc, const float* g,
               int64_t gb, int64_t gh, int64_t gw, void* dout, int B, int h, int w,
               cudaStream_t stream) {
  constexpr int kCellsPerWarp = K == 8 ? 16 : 32;
  const int items = B * h * ((w + kCellsPerWarp - 1) / kCellsPerWarp);
  lpg_bwd_kernel<K, kPlane, kVec, T><<<grid_for(items), kWarps * 32, 0, stream>>>(
      static_cast<const T*>(in), sb, sh, sw, sc, g, gb, gh, gw, static_cast<T*>(dout), h, w, items);
  return (int)cudaGetLastError();
}

// The vector-load instance where g allows it: unit column stride, and base,
// batch and row pitches that keep every lane's V floats aligned to 4*V bytes.
template <int K, bool kPlane, typename T>
int backward_k(const void* in, int64_t sb, int64_t sh, int64_t sw, int64_t sc, const float* g,
               int64_t gb, int64_t gh, int64_t gw, void* dout, int B, int h, int w,
               cudaStream_t s) {
  constexpr int V = K < 4 ? K : 4;
  const bool vec = gw == 1 && gb % V == 0 && gh % V == 0 && (uintptr_t)g % (4 * V) == 0;
  return vec ? launch_bwd<K, kPlane, true, T>(in, sb, sh, sw, sc, g, gb, gh, gw, dout, B, h, w, s)
             : launch_bwd<K, kPlane, false, T>(in, sb, sh, sw, sc, g, gb, gh, gw, dout, B, h, w, s);
}

template <bool kPlane, typename T>
int backward_t(const void* in, int64_t sb, int64_t sh, int64_t sw, int64_t sc, const float* g,
               int64_t gb, int64_t gh, int64_t gw, void* dout, int B, int h, int w, int k,
               cudaStream_t s) {
  switch (k) {
    case 2: return backward_k<2, kPlane, T>(in, sb, sh, sw, sc, g, gb, gh, gw, dout, B, h, w, s);
    case 4: return backward_k<4, kPlane, T>(in, sb, sh, sw, sc, g, gb, gh, gw, dout, B, h, w, s);
    case 8: return backward_k<8, kPlane, T>(in, sb, sh, sw, sc, g, gb, gh, gw, dout, B, h, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kPlane>
int backward(const void* in, int dtype, int64_t sb, int64_t sh, int64_t sw, int64_t sc,
             const float* g, int64_t gb, int64_t gh, int64_t gw, void* dout, int B, int h, int w,
             int k, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return backward_t<kPlane, float>(in, sb, sh, sw, sc, g, gb, gh, gw, dout, B, h, w, k, s);
    case 1: return backward_t<kPlane, __nv_bfloat16>(in, sb, sh, sw, sc, g, gb, gh, gw, dout, B, h, w, k, s);
    default: return (int)cudaErrorInvalidValue;
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

// A forward launch: warps per cell row (K1, K3: R, the split of its k rows;
// K5: its k/2 phase rows), warps per block, blocks and work items.
struct Launch {
  int split, warps, blocks, items;
};

Launch fwd_launch(int B, int h, int w, int k) {
  const int cells = B * h * ((w * k + 127) / 128);  // items without a split
  const int split = k == 8 && cells < kSplitBelow * sm_count() ? kSplitRows : 1;
  const int warps = split == 1 ? kWarps : kSplitWarps;
  const int items = cells * split;
  return {split, warps, (items + warps - 1) / warps, items};
}

Launch phase_launch(int B, int h, int w, int k) {
  const int kk = k / 2, items = B * h * kk * ((w + 31) / 32);
  return {kk, kK5Warps, (items + kK5Warps - 1) / kK5Warps, items};
}

template <bool kRaw, int K, int R, typename In>
int launch_fwd_split(const void* in, int64_t sb, int64_t sh, int64_t sw, int64_t sc, float* out,
                     int h, int w, Launch l, cudaStream_t stream) {
  constexpr int kW = R == 1 ? kWarps : kSplitWarps;
  lpg_fwd_kernel<kRaw, K, R, kW, In><<<l.blocks, kW * 32, 0, stream>>>(
      static_cast<const In*>(in), sb, sh, sw, sc, out, h, w, l.items);
  return (int)cudaGetLastError();
}

template <bool kRaw, int K, typename In>
int launch_fwd(const void* in, int64_t sb, int64_t sh, int64_t sw, int64_t sc, float* out, int B,
               int h, int w, cudaStream_t stream) {
  const Launch l = fwd_launch(B, h, w, K);
  if constexpr (K == 8) {
    if (l.split == kSplitRows) {
      return launch_fwd_split<kRaw, K, kSplitRows, In>(in, sb, sh, sw, sc, out, h, w, l, stream);
    }
  }
  return launch_fwd_split<kRaw, K, 1, In>(in, sb, sh, sw, sc, out, h, w, l, stream);
}

template <int KK, typename In>
int launch_phase(const void* raw, int64_t sb, int64_t sh, int64_t sw, int64_t sc, float* out, int B,
                 int h, int w, cudaStream_t stream) {
  const Launch l = phase_launch(B, h, w, 2 * KK);
  lpg_phase_kernel<KK, In><<<l.blocks, kK5Warps * 32, 0, stream>>>(
      static_cast<const In*>(raw), sb, sh, sw, sc, out, h, w, l.items);
  return (int)cudaGetLastError();
}

template <typename In>
int phase_k(const void* raw, int64_t sb, int64_t sh, int64_t sw, int64_t sc, float* out, int B, int h,
            int w, int k, cudaStream_t s) {
  switch (k) {
    case 2: return launch_phase<1, In>(raw, sb, sh, sw, sc, out, B, h, w, s);
    case 4: return launch_phase<2, In>(raw, sb, sh, sw, sc, out, B, h, w, s);
    case 8: return launch_phase<4, In>(raw, sb, sh, sw, sc, out, B, h, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kRaw, typename In>
int forward_k(const void* in, int64_t sb, int64_t sh, int64_t sw, int64_t sc, float* out, int B,
              int h, int w, int k, cudaStream_t s) {
  switch (k) {
    case 2: return launch_fwd<kRaw, 2, In>(in, sb, sh, sw, sc, out, B, h, w, s);
    case 4: return launch_fwd<kRaw, 4, In>(in, sb, sh, sw, sc, out, B, h, w, s);
    case 8: return launch_fwd<kRaw, 8, In>(in, sb, sh, sw, sc, out, B, h, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kRaw>
int forward(const void* in, int dtype, int64_t sb, int64_t sh, int64_t sw, int64_t sc, float* out,
            int B, int h, int w, int k, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return forward_k<kRaw, float>(in, sb, sh, sw, sc, out, B, h, w, k, s);
    case 1: return forward_k<kRaw, __nv_bfloat16>(in, sb, sh, sw, sc, out, B, h, w, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError() (0 on
// success).  dtype: 0 = f32, 1 = bf16.

// K1: raw (B, h, w, 3) in `dtype` -> depth / max_depth (B, h*k, w*k)
extern "C" int lpg_fused_forward(const void* raw, int dtype, int64_t sb, int64_t sh, int64_t sw,
                                 int64_t sc, float* out, int B, int h, int w, int k,
                                 void* stream) {
  return forward<true>(raw, dtype, sb, sh, sw, sc, out, B, h, w, k, stream);
}

// K2: d(raw) (B, 3, h, w) in `dtype`, raw's, of the fused head
extern "C" int lpg_fused_backward(const void* raw, int dtype, int64_t sb, int64_t sh, int64_t sw,
                                  int64_t sc, const float* g, int64_t gb, int64_t gh, int64_t gw,
                                  void* draw, int B, int h, int w, int k, void* stream) {
  return backward<false>(raw, dtype, sb, sh, sw, sc, g, gb, gh, gw, draw, B, h, w, k, stream);
}

// K3: plane (B, h, w, 4) in `dtype` -> depth (B, h*k, w*k)
extern "C" int lpg_forward(const void* plane, int dtype, int64_t sb, int64_t sh, int64_t sw,
                           int64_t sc, float* out, int B, int h, int w, int k, void* stream) {
  return forward<false>(plane, dtype, sb, sh, sw, sc, out, B, h, w, k, stream);
}

// K4: d(plane) (B, h, w, 4) in `dtype`, the plane's
extern "C" int lpg_backward(const void* plane, int dtype, int64_t sb, int64_t sh, int64_t sw,
                            int64_t sc, const float* g, int64_t gb, int64_t gh, int64_t gw,
                            void* dplane, int B, int h, int w, int k, void* stream) {
  return backward<true>(plane, dtype, sb, sh, sw, sc, g, gb, gh, gw, dplane, B, h, w, k, stream);
}

// K5: raw (B, h, w, 3) in `dtype` -> phase planes (B, 4, h*k/2, w*k/2)
extern "C" int lpg_phase_forward(const void* raw, int dtype, int64_t sb, int64_t sh, int64_t sw,
                                 int64_t sc, float* out, int B, int h, int w, int k, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return phase_k<float>(raw, sb, sh, sw, sc, out, B, h, w, k, s);
    case 1: return phase_k<__nv_bfloat16>(raw, sb, sh, sw, sc, out, B, h, w, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch of a forward at (B, h, w, k): kernel 0 = K1 and K3, 1 = K5.
// shape[0..3] = warps per cell row, warps per block, blocks, work items.
extern "C" int lpg_forward_launch(int kernel, int B, int h, int w, int k, int* shape) {
  if ((k != 2 && k != 4 && k != 8) || (kernel != 0 && kernel != 1)) return (int)cudaErrorInvalidValue;
  const Launch l = kernel == 0 ? fwd_launch(B, h, w, k) : phase_launch(B, h, w, k);
  shape[0] = l.split, shape[1] = l.warps, shape[2] = l.blocks, shape[3] = l.items;
  return 0;
}

// An empty kernel on the grid and block of that forward: the device time
// a launch of this shape cannot go under.
extern "C" int lpg_empty_launch(int kernel, int B, int h, int w, int k, void* stream) {
  int shape[4];
  const int err = lpg_forward_launch(kernel, B, h, w, k, shape);
  if (err != 0) return err;
  empty_kernel<<<shape[2], shape[1] * 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* lpg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
