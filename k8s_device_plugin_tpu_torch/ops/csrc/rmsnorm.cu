// RMSNorm forward for Hopper (sm_90a): one row per block, f32 statistics.
//
// Replaces: k8s_device_plugin_tpu/ops/rmsnorm.py::_rmsnorm_kernel (K4), the
// Pallas TPU kernel launched by _rmsnorm_fwd_pallas over 256-row blocks.
// Computes, per row r of x (rows, d), in f32:
//   rrms_r = rsqrt(sum_j x_rj^2 / d + eps)
//   y_rj   = (x_rj * rrms_r) * scale_j, rounded to x's dtype
// and stores rrms as [rows] f32. x is bf16 or f32; scale is bf16 or f32.
//
// What bounds it on this card: bytes. It reads x once and writes y once
// (2 * rows * d * sizeof(x) bytes, plus rrms and scale) and does about four
// f32 operations per element: at (16384, 2048) bf16 that is 134 MB against
// 134 MFLOP, 0.040 ms at 3.35 TB/s against 0.002 ms on the CUDA cores.
//
// What the design does about it: each block owns one row, so no state
// crosses blocks and any row count works (the TPU grid's ragged last block
// becomes nothing at all). Each thread loads up to kVecsPerThread 16-byte
// vectors of the row, neighbouring threads on neighbouring vectors, and
// keeps them in registers: x is read from device memory once. The sum of
// squares is reduced with warp shuffles, then across warps through shared
// memory; every thread then scales its own vectors and writes them back as
// 16-byte stores. The block is as wide as the row needs (d / 8 / 4 threads
// for bf16, rounded up to whole warps), so narrow rows use small blocks and
// many of them fit on one SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rmsnorm {

using bf16 = __nv_bfloat16;

constexpr int kVecsPerThread = 4;
constexpr int kMaxThreads = 512;

// Elements of T in one 16-byte vector.
template <typename T>
struct Vec {
  static constexpr int kElems = 16 / sizeof(T);
};

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// Load N consecutive values of type T at p (aligned to N * sizeof(T)) as f32.
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&out)[N]) {
  static_assert(N % 4 == 0, "whole float4 vectors");
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 r = reinterpret_cast<const float4*>(p)[i];
    out[4 * i] = r.x;
    out[4 * i + 1] = r.y;
    out[4 * i + 2] = r.z;
    out[4 * i + 3] = r.w;
  }
}

template <int N>
__device__ __forceinline__ void load_f32(const bf16* p, float (&out)[N]) {
  static_assert(N == 4 || N == 8, "one 8- or 16-byte vector");
  if constexpr (N == 8) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = bf16_lo(w[i]);
      out[2 * i + 1] = bf16_hi(w[i]);
    }
  } else {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    out[0] = bf16_lo(r.x);
    out[1] = bf16_hi(r.x);
    out[2] = bf16_lo(r.y);
    out[3] = bf16_hi(r.y);
  }
}

// Store one 16-byte vector of T at p from f32 values (bf16: round to nearest
// even, as XLA's convert does).
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_vec(bf16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                            pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, typename S>
__global__ void __launch_bounds__(kMaxThreads)
    fwd_kernel(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ y,
               float* __restrict__ rrms, int d, float eps) {
  constexpr int V = Vec<T>::kElems;
  __shared__ float warp_sums[kMaxThreads / 32];
  __shared__ float row_rrms;

  const int nvec = d / V;
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float v[kVecsPerThread][V];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < kVecsPerThread; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i < nvec) {
      load_f32(xr + (size_t)i * V, v[j]);
#pragma unroll
      for (int e = 0; e < V; ++e) ss += v[j][e] * v[j][e];
    }
  }

  ss = warp_sum(ss);
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (int)(blockDim.x / 32) ? warp_sums[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) {
      const float r = rsqrtf(t / (float)d + eps);
      row_rrms = r;
      rrms[row] = r;
    }
  }
  __syncthreads();
  const float r = row_rrms;

#pragma unroll
  for (int j = 0; j < kVecsPerThread; ++j) {
    const int i = threadIdx.x + j * blockDim.x;
    if (i < nvec) {
      float s[V];
      load_f32(scale + (size_t)i * V, s);
      float out[V];
#pragma unroll
      for (int e = 0; e < V; ++e) out[e] = (v[j][e] * r) * s[e];
      store_vec(yr + (size_t)i * V, out);
    }
  }
}

template <typename T, typename S>
cudaError_t launch(const void* x, const void* scale, void* y, void* rrms, int rows, int d,
                   float eps, cudaStream_t stream) {
  constexpr int V = Vec<T>::kElems;
  const int nvec = d / V;
  const int per_thread = (nvec + kVecsPerThread - 1) / kVecsPerThread;
  const int threads = ((per_thread + 31) / 32) * 32;
  if (d % V != 0 || threads > kMaxThreads || rows < 1) return cudaErrorInvalidValue;
  fwd_kernel<T, S><<<rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(y),
      static_cast<float*>(rrms), d, eps);
  return cudaGetLastError();
}

}  // namespace rmsnorm

// x, y: [rows][d] contiguous, x_dtype 0 = f32, 1 = bf16 (y has x's dtype);
// scale: [d], scale_dtype 0 = f32, 1 = bf16; rrms: [rows] f32. Every pointer
// 16-byte aligned, d a multiple of 8 and at most 8192. Returns the launch's
// cudaGetLastError().
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* y, void* rrms, int rows,
                           int d, int x_dtype, int scale_dtype, float eps, void* stream) {
  using rmsnorm::bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype * 2 + scale_dtype) {
    case 0:
      return rmsnorm::launch<float, float>(x, scale, y, rrms, rows, d, eps, s);
    case 1:
      return rmsnorm::launch<float, bf16>(x, scale, y, rrms, rows, d, eps, s);
    case 2:
      return rmsnorm::launch<bf16, float>(x, scale, y, rrms, rows, d, eps, s);
    case 3:
      return rmsnorm::launch<bf16, bf16>(x, scale, y, rrms, rows, d, eps, s);
    default:
      return cudaErrorInvalidValue;
  }
}
