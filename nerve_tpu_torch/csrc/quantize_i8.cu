// Input quantisation of the int8 serving paths, in one pass.
//
// Replaces the in-graph quantisation of the JAX package's int8 paths,
// nerve_tpu/ops/conv_chain_int8.py:284-290 (`conv_chain_int8_pallas`, "fuses
// with the producer") and its RDB counterpart (rdb_int8.py:482): not a
// Pallas kernel there, an XLA fusion. One launch reads each input tensor of
// a site once (a list input's parts, bf16 or float32) and writes
// clip(rint(x / s_in), -127, 127) as int8 into each part's channel slot of
// the layer's int8 input buffer, the pad channels as zeros. The division is
// an IEEE division (`__fdiv_rn`), as `x.float() / scale` is, and rintf rounds
// half to even, so the result is bit-exact against ops/conv_chain_int8.py
// `quantize_activation`.
//
// Bound: bytes, one read of the activations and one int8 write (1.19 GB for
// the attention site's 1080p x 192 bf16 input, 0.36 ms at 3.35 TB/s). A
// thread takes 16 output channels of one pixel: two 16-byte loads (bf16) or
// four (float32) where the 16 channels lie in one part at a 16-byte aligned
// address, element loads otherwise (the 3-channel frames, the 81-channel
// cost volume), and one 16-byte store.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "nerve_tpu_torch.h"

namespace {

constexpr int THREADS = 256;
constexpr int GROUP = 16;  // output channels a thread writes

struct QParams {
  const void* x[3];
  int c[3], start[4];  // part widths; part i holds channels [start[i], start[i + 1])
  int nx, ocs, oc, ngroups;
  long long npix;
  const float* scale;
  int8_t* out;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int8_t quant(float v, float s) {
  return static_cast<int8_t>(__float2int_rn(fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f)));
}

template <typename T>
__global__ void __launch_bounds__(THREADS) quantize_i8_kernel(const QParams p) {
  const float s = *p.scale;
  const long long total = p.npix * p.ngroups;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (long long)gridDim.x * THREADS) {
    const long long pix = i / p.ngroups;
    const int cb = (int)(i % p.ngroups) * GROUP;
    int part = 0;
    while (part + 1 < p.nx && cb >= p.start[part + 1]) ++part;
    const int off = cb - p.start[part];
    const T* src = static_cast<const T*>(p.x[part]) + pix * p.c[part] + off;
    alignas(16) int8_t q[GROUP];
    if (part < p.nx && off + GROUP <= p.c[part] &&
        reinterpret_cast<uintptr_t>(src) % 16 == 0) {
      constexpr int PER = 16 / sizeof(T);  // elements of one 16-byte load
#pragma unroll
      for (int v = 0; v < GROUP / PER; ++v) {
        alignas(16) T e[PER];
        *reinterpret_cast<uint4*>(e) = reinterpret_cast<const uint4*>(src)[v];
#pragma unroll
        for (int k = 0; k < PER; ++k) q[v * PER + k] = quant(to_float(e[k]), s);
      }
    } else {
#pragma unroll
      for (int k = 0; k < GROUP; ++k) {
        const int ch = cb + k;
        int pt = 0;
        while (pt + 1 < p.nx && ch >= p.start[pt + 1]) ++pt;
        q[k] = ch < p.start[p.nx]
                   ? quant(to_float(static_cast<const T*>(p.x[pt])[pix * p.c[pt] + ch -
                                                                     p.start[pt]]), s)
                   : int8_t(0);
      }
    }
    int8_t* dst = p.out + pix * p.ocs + cb;
    if (cb + GROUP <= p.oc && reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(q);
    } else {
      for (int k = 0; k < GROUP && cb + k < p.oc; ++k) dst[k] = q[k];
    }
  }
}

}  // namespace

extern "C" int nt_quantize_i8(const void* x0, const void* x1, const void* x2, int nx, int c0,
                              int c1, int c2, const float* scale, void* out, int out_cstride,
                              int out_c, int b, int h, int w_, int dtype, void* stream) {
  QParams p;
  p.x[0] = x0;
  p.x[1] = x1;
  p.x[2] = x2;
  p.c[0] = c0;
  p.c[1] = c1;
  p.c[2] = c2;
  p.nx = nx;
  if (nx < 1 || nx > 3 || (dtype != NT_BF16 && dtype != NT_F32)) return (int)cudaErrorInvalidValue;
  p.start[0] = 0;
  for (int i = 0; i < 3; ++i) {
    if (i < nx && p.c[i] < 1) return (int)cudaErrorInvalidValue;
    p.start[i + 1] = p.start[i] + (i < nx ? p.c[i] : 0);
  }
  if (out_c < p.start[nx] || out_cstride < out_c || b < 0 || h < 0 || w_ < 0)
    return (int)cudaErrorInvalidValue;
  p.ocs = out_cstride;
  p.oc = out_c;
  p.ngroups = (out_c + GROUP - 1) / GROUP;
  p.npix = (long long)b * h * w_;
  p.scale = scale;
  p.out = static_cast<int8_t*>(out);
  const long long total = p.npix * p.ngroups;
  if (total == 0) return (int)cudaSuccess;
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)std::min<long long>((total + THREADS - 1) / THREADS, 16LL * sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == NT_BF16)
    quantize_i8_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(p);
  else
    quantize_i8_kernel<float><<<grid, THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}
