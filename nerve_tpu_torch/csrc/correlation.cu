// Cost-volume correlation for the flow estimator.
//
// Replaces nerve_tpu/ops/correlation.py `_corr_kernel_planar` (reached via
// `_correlation_pallas_planar`) and computes the same function as its NHWC
// sibling `_corr_kernel`:
//
//   out[b,y,x,(i+d)(2d+1)+(j+d)] = (1/C) sum_c f1[b,y,x,c] * f2[b,y+i,x+j,c]
//
// with zeros outside f2. Numerics are the TPU kernels' (correlation.py:74,
// :177): each product is rounded to the input dtype (in bfloat16 the float32
// product of two bfloat16 values is exact, so this is one rounding), the
// products are summed in float32, the sum is multiplied by the float32 1/C
// and rounded once to the input dtype. `_corr_kernel` is the same function
// on the same NHWC input and output, so this kernel covers both TPU rows.
//
// Bound: at the serving shape (2 x 540 x 960 x 64, d=4) it is 81 FMAs per
// input element, so shared-memory reads bound it, not device memory. Each
// block keeps a TH x TW tile of f1 and the f2 window with its d-pixel halo
// in shared memory, a channel chunk at a time; each thread owns one output
// pixel and its (2d+1)^2 sums in registers. What the simple design gives
// up: one shared-memory read per FMA (a thread owning several pixels would
// reuse each f2 value), and per-pixel 81-value output rows that are written
// without staging.

#include <cuda_runtime.h>

#include "nerve_tpu_torch.h"

namespace {

constexpr int TH = 8, TW = 32, CK = 8, NTHREADS = TH * TW;

// Loads widen to float32; stores round to nearest even, as torch's .to() does.
// round_product rounds a float32 product of two T values to T.
__device__ __forceinline__ float nt_load(float v) { return v; }
__device__ __forceinline__ float nt_load(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T nt_store(float v);
template <>
__device__ __forceinline__ float nt_store<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 nt_store<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T>
__device__ __forceinline__ float round_product(float a, float b) {
  return nt_load(nt_store<T>(__fmul_rn(a, b)));
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
    corr_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                T* __restrict__ out, int h, int w, int c, float inv_c) {
  constexpr int R = D / 2, IH = TH + 2 * R, IW = TW + 2 * R;
  __shared__ float s1[CK][TH][TW];
  __shared__ float s2[CK][IH][IW];
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH, b = blockIdx.z;
  const long long img = (long long)b * h * w;
  float acc[D * D];
#pragma unroll
  for (int k = 0; k < D * D; ++k) acc[k] = 0.f;

  for (int c0 = 0; c0 < c; c0 += CK) {
    __syncthreads();
    for (int i = threadIdx.x; i < CK * TH * TW; i += NTHREADS) {
      const int k = i % CK, r = i / CK, xx = r % TW, yy = r / TW;
      const int gy = y0 + yy, gx = x0 + xx, gc = c0 + k;
      float v = 0.f;
      if (gy < h && gx < w && gc < c)
        v = nt_load(f1[(img + (long long)gy * w + gx) * c + gc]);
      s1[k][yy][xx] = v;
    }
    for (int i = threadIdx.x; i < CK * IH * IW; i += NTHREADS) {
      const int k = i % CK, r = i / CK, xx = r % IW, yy = r / IW;
      const int gy = y0 + yy - R, gx = x0 + xx - R, gc = c0 + k;
      float v = 0.f;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w && gc < c)
        v = nt_load(f2[(img + (long long)gy * w + gx) * c + gc]);
      s2[k][yy][xx] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < CK; ++k) {
      const float a = s1[k][ty][tx];
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j)
          acc[i * D + j] = sizeof(T) == 4
                               ? fmaf(a, s2[k][ty + i][tx + j], acc[i * D + j])
                               : __fadd_rn(acc[i * D + j],
                                           round_product<T>(a, s2[k][ty + i][tx + j]));
    }
  }

  const int y = y0 + ty, x = x0 + tx;
  if (y < h && x < w) {
    T* o = out + (img + (long long)y * w + x) * (D * D);
#pragma unroll
    for (int k = 0; k < D * D; ++k) o[k] = nt_store<T>(acc[k] * inv_c);
  }
}

template <typename T, int D>
cudaError_t launch(const void* f1, const void* f2, void* out, int b, int h,
                   int w, int c, cudaStream_t stream) {
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, b);
  corr_kernel<T, D><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<T*>(out), h, w, c, 1.0f / (float)c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* f1, const void* f2, void* out, int b,
                       int h, int w, int c, int d, cudaStream_t stream) {
  switch (d) {
    case 1: return launch<T, 3>(f1, f2, out, b, h, w, c, stream);
    case 2: return launch<T, 5>(f1, f2, out, b, h, w, c, stream);
    case 3: return launch<T, 7>(f1, f2, out, b, h, w, c, stream);
    case 4: return launch<T, 9>(f1, f2, out, b, h, w, c, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int nt_correlation(const void* f1, const void* f2, void* out,
                              int b, int h, int w, int c, int d, int dtype,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == NT_BF16)
    return (int)dispatch_d<__nv_bfloat16>(f1, f2, out, b, h, w, c, d, st);
  if (dtype == NT_F32)
    return (int)dispatch_d<float>(f1, f2, out, b, h, w, c, d, st);
  return (int)cudaErrorInvalidValue;
}
