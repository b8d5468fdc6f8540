// Depthwise SAME 3x3 convolution, one layer per launch, NHWC.
//
// Replaces the depthwise branch (`kind == "dw3"`) of nerve_tpu/ops/
// conv_chain.py `_chain_kernel` (reached via `_chain_pallas` <-
// `conv_chain_fused` <- `conv_chain_apply`); the wrapper runs it beside the
// dense layers of `conv_chain.cu`, one launch per layer.
//
// Numerics follow the reference formulation `_chain_xla`'s depthwise branch
// (conv_chain.py:427-434): the 9-tap sum in float32 (taps in order, dy
// outer, dx inner), rounded to the input dtype, then the float32 bias, the
// optional relu, and a rounding to the input dtype.
//
// Bound: bytes. 18 FLOPs per element against 2 x sizeof(T) bytes moved, so
// at 1080p x 32 channels in bfloat16 the layer moves ~265 MB (~0.08 ms at
// 3.35 TB/s) for 1.2 GFLOP. The design keeps the load path wide: a block
// stages a haloed TH x TW tile of every channel in shared memory with
// 16-byte vectors along C (8 bfloat16 or 4 float32 channels), then each
// thread owns one channel vector of a P-pixel column segment, reads each
// input vector of its (P + 2) x 3 window once from shared memory and keeps
// the P x VEC sums in registers; the stores are 16-byte vectors again.
// Channels are padded to the vector width in shared memory with zeros, so
// any C works; unaligned or ragged rows fall back to element loads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nerve_tpu_torch.h"

namespace {

constexpr int TH = 16, TW = 32, P = 4, NTHREADS = 256;
constexpr int MAX_C = 64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One 16-byte vector of VEC = 16 / sizeof(T) channels.
template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    dw3_kernel(const T* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ out, int h,
               int wd, int c, int relu, int vec) {
  constexpr int VEC = Vec<T>::N, IH = TH + 2, IW = TW + 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int cv = (c + VEC - 1) / VEC;  // channel vectors per pixel
  Vec<T>* sx = reinterpret_cast<Vec<T>*>(smem);                 // [IH][IW][cv]
  float* sw = reinterpret_cast<float*>(sx + IH * IW * cv);        // [9][cv*VEC]
  float* sb = sw + 9 * cv * VEC;                                  // [cv*VEC]

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const long long img = (long long)blockIdx.z * h * wd;
  const int cp = cv * VEC;

  for (int i = tid; i < 10 * cp; i += NTHREADS) {
    const int ch = i % cp, t = i / cp;
    const float v = ch < c ? (t < 9 ? w[t * c + ch] : bias[ch]) : 0.f;
    if (t < 9) sw[t * cp + ch] = v; else sb[ch] = v;
  }
  for (int i = tid; i < IH * IW * cv; i += NTHREADS) {
    const int k = i % cv, pix = i / cv, xx = pix % IW, yy = pix / IW;
    const int gy = y0 + yy - 1, gx = x0 + xx - 1, gc = k * VEC;
    Vec<T> v;
    *reinterpret_cast<uint4*>(&v) = make_uint4(0, 0, 0, 0);
    if (gy >= 0 && gy < h && gx >= 0 && gx < wd) {
      const T* src = x + (img + (long long)gy * wd + gx) * c + gc;
      if (vec) {
        v = *reinterpret_cast<const Vec<T>*>(src);
      } else {
        for (int j = 0; j < VEC && gc + j < c; ++j) v.v[j] = src[j];
      }
    }
    sx[pix * cv + k] = v;
  }
  __syncthreads();

  // Work item: channel vector k (fastest, so neighbouring threads touch
  // neighbouring 16-byte words), output column tx, column segment sg.
  for (int item = tid; item < cv * TW * (TH / P); item += NTHREADS) {
    const int k = item % cv, tx = (item / cv) % TW, sg = item / (cv * TW);
    float acc[P][VEC];
#pragma unroll
    for (int j = 0; j < P; ++j)
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[j][q] = 0.f;
    // Input row r of the segment feeds output rows j = r - dy.
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float wv[VEC];
#pragma unroll
        for (int q = 0; q < VEC; ++q) wv[q] = sw[(dy * 3 + dx) * cp + k * VEC + q];
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const Vec<T> v = sx[((sg * P + j + dy) * IW + tx + dx) * cv + k];
#pragma unroll
          for (int q = 0; q < VEC; ++q) acc[j][q] = fmaf(to_f(v.v[q]), wv[q], acc[j][q]);
        }
      }
    }
    const int gx = x0 + tx;
    if (gx >= wd) continue;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int gy = y0 + sg * P + j;
      if (gy >= h) continue;
      Vec<T> o;
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        float v = __fadd_rn(to_f(from_f<T>(acc[j][q])), sb[k * VEC + q]);
        if (relu) v = fmaxf(v, 0.f);
        o.v[q] = from_f<T>(v);
      }
      T* dst = out + (img + (long long)gy * wd + gx) * c + k * VEC;
      if (vec) {
        *reinterpret_cast<Vec<T>*>(dst) = o;
      } else {
        for (int q = 0; q < VEC && k * VEC + q < c; ++q) dst[q] = o.v[q];
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* w, const float* bias, void* out,
                   int b, int h, int wd, int c, int relu, cudaStream_t stream) {
  constexpr int VEC = Vec<T>::N;
  if (c < 1 || c > MAX_C) return cudaErrorInvalidValue;
  const int cv = (c + VEC - 1) / VEC;
  const size_t smem = (size_t)(TH + 2) * (TW + 2) * cv * 16 + 10 * cv * VEC * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(dw3_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int vec = c % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((wd + TW - 1) / TW, (h + TH - 1) / TH, b);
  dw3_kernel<T><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(x), w, bias, static_cast<T*>(out), h, wd, c, relu, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nt_dwconv3(const void* x, const float* w, const float* bias,
                          void* out, int c, int b, int h, int w_, int relu,
                          int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == NT_BF16)
    return (int)launch<__nv_bfloat16>(x, w, bias, out, b, h, w_, c, relu, st);
  if (dtype == NT_F32) return (int)launch<float>(x, w, bias, out, b, h, w_, c, relu, st);
  return (int)cudaErrorInvalidValue;
}
