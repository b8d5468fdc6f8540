// Depth-to-space into packed rows.
//
// Replaces nerve_tpu/ops/pixel_shuffle.py `_d2s_packed_kernel` (reached via
// `depth_to_space_packed`). The TPU kernel built the lane interleave out of
// MXU matmuls against 0/1 scatter matrices, because Mosaic could not lower
// the shape cast. Here it is what it is: an index permutation.
//
//   out[b, y*s + sy, (x*s + sx)*C + c] = in[b, y, x, c*s*s + sy*s + sx]
//
// Bound: device-memory bytes (one read and one write of the frame, no
// arithmetic). Each thread assembles 16 bytes of one output row and writes
// them with one vector store; its reads gather from s*C neighbouring input
// values of one input row, which the L1/L2 caches serve. The data is moved
// as raw 16- or 32-bit words, so the result is bit-exact by construction.
// What the simple design gives up: the reads are not vectorised, and no
// shared-memory staging makes them fully coalesced.
//
// The planar variant replaces scripts/diag_d2s.py `d2s_packed_planar`
// (`_kernel_planar`, the same interleave from channel-planar phases):
//
//   out[b, y*s + sy, (x*s + sx)*C + c] = in[b, c*s*s + sy*s + sx, y, x]
//
// with the same thread layout; neighbouring threads now read neighbouring
// x of one phase plane. The script's `d2s_packed_mxu` computes the NHWC
// function above and is covered by `nt_d2s_packed`.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nerve_tpu_torch.h"

namespace {

template <typename T>
__global__ void d2s_packed_kernel(const T* __restrict__ x, T* __restrict__ out,
                                  int h, int w, int c, int s, long long rows,
                                  int row_len, int vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  const int chunks = (row_len + VEC - 1) / VEC;
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= rows * chunks) return;
  const long long row = t / chunks;  // b * (h*s) + oy
  const int e0 = (int)(t % chunks) * VEC;
  const int hs = h * s;
  const int b = (int)(row / hs);
  const int oy = (int)(row % hs);
  const int y = oy / s, sy = oy % s;
  const int cin = c * s * s;
  const T* src = x + ((long long)b * h + y) * (long long)w * cin + sy * s;
  const int n = min(VEC, row_len - e0);
  alignas(16) T vals[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    if (k < n) {
      const int e = e0 + k;
      const int ox = e / c, ch = e % c;
      vals[k] = src[(long long)(ox / s) * cin + ch * s * s + ox % s];
    }
  }
  T* dst = out + row * (long long)row_len + e0;
  if (vec_ok && n == VEC) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(vals);
  } else {
    for (int k = 0; k < n; ++k) dst[k] = vals[k];
  }
}

template <typename T>
__global__ void d2s_planar_kernel(const T* __restrict__ x, T* __restrict__ out, int h,
                                  int w, int c, int s, long long rows, int row_len,
                                  int vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  const int chunks = (row_len + VEC - 1) / VEC;
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= rows * chunks) return;
  const long long row = t / chunks;  // b * (h*s) + oy
  const int e0 = (int)(t % chunks) * VEC;
  const int hs = h * s;
  const int b = (int)(row / hs);
  const int oy = (int)(row % hs);
  const int y = oy / s, sy = oy % s;
  const long long plane = (long long)h * w;
  const T* src = x + (long long)b * c * s * s * plane + (long long)sy * s * plane +
                 (long long)y * w;
  const int n = min(VEC, row_len - e0);
  alignas(16) T vals[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    if (k < n) {
      const int e = e0 + k;
      const int ox = e / c, ch = e % c;
      vals[k] = src[((long long)ch * s * s + ox % s) * plane + ox / s];
    }
  }
  T* dst = out + row * (long long)row_len + e0;
  if (vec_ok && n == VEC) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(vals);
  } else {
    for (int k = 0; k < n; ++k) dst[k] = vals[k];
  }
}

template <typename T, bool PLANAR>
cudaError_t launch(const void* x, void* out, int b, int h, int w, int c, int s,
                   cudaStream_t stream) {
  const int row_len = w * s * c;
  const long long rows = (long long)b * h * s;
  const int vec = 16 / sizeof(T);
  const int vec_ok = ((long long)row_len * sizeof(T)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long threads = rows * ((row_len + vec - 1) / vec);
  const int block = 256;
  const long long grid = (threads + block - 1) / block;
  if constexpr (PLANAR)
    d2s_planar_kernel<T><<<(unsigned)grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), h, w, c, s, rows, row_len, vec_ok);
  else
    d2s_packed_kernel<T><<<(unsigned)grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), h, w, c, s, rows, row_len, vec_ok);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nt_d2s_packed(const void* x, void* out, int b, int h, int w,
                             int c, int s, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == NT_BF16) return (int)launch<uint16_t, false>(x, out, b, h, w, c, s, st);
  if (dtype == NT_F32) return (int)launch<uint32_t, false>(x, out, b, h, w, c, s, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int nt_d2s_packed_planar(const void* x, void* out, int b, int h, int w, int c,
                                    int s, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == NT_BF16) return (int)launch<uint16_t, true>(x, out, b, h, w, c, s, st);
  if (dtype == NT_F32) return (int)launch<uint32_t, true>(x, out, b, h, w, c, s, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* nt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
