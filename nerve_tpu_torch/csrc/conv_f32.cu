// The float32 dense convolution (`nt_conv2d`, NT_F32): the 3x3 instances of
// the implicit-GEMM family in conv_f32.cuh, whose note says what the family
// replaces, what bounds it and how it is built; the 1x1 instances are in
// conv_f32_1x1.cu, so that the two compile side by side.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_f32.cuh"
#include "nerve_tpu_torch.h"

using namespace ntf32;


cudaError_t nt_conv2d_f32(const void* const* xs, int nx, int xcs, int cin, const float* w,
                          const float* bias, void* out, int ocs, int ocoff, int cout, int b, int h,
                          int wd, int k, int relu, cudaStream_t stream, int* rec) {
  NtDeviceLimits lim;
  cudaError_t err = nt_device_limits(lim);
  if (err != cudaSuccess) return err;
  if (rec == nullptr && (ocoff < 0 || ocoff + cout > ocs)) return cudaErrorInvalidValue;
  const int route = f32_route(xs, nx, xcs, cin, k);
  F32Plan pl;
  F32Params p;
  CUtensorMap maps[4];
  if (!f32_setup(xs, nx, xcs, cin, cout, k, b, h, wd, route == F32_ROUTE_TMA, lim, pl, p, maps))
    return cudaErrorInvalidValue;
  p.wt = w;
  p.wvec = p.cout % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  p.bias = bias;
  p.out = static_cast<float*>(out);
  p.ocs = ocs;
  p.ocoff = ocoff;
  p.relu = relu;
  p.vec = out != nullptr && ocs % 4 == 0 && ocoff % 4 == 0 &&
          reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (!f32_output_map(pl, p, b, maps[3])) return cudaErrorInvalidValue;
  return k == 3 ? f32_dense_launch<3>(pl, p, maps, route, lim, stream, rec)
                : nt_conv2d_f32_1x1(pl, p, maps, route, lim, stream, rec);
}

extern "C" int nt_conv2d_f32_launch(const void* x0, const void* x1, const void* x2, int nx,
                                    int x_cstride, int cin, int cout, int b, int h, int w_,
                                    int ksize, int lff, int* rec, void* stream) {
  (void)stream;
  if (lff)
    return ksize != 1 || nx != 1
               ? (int)cudaErrorInvalidValue
               : (int)nt_lff_f32(x0, x_cstride, cin, nullptr, nullptr, nullptr, cout, 0, cout, b,
                                 h, w_, 0.f, nullptr, rec);
  const void* xs[3] = {x0, x1, x2};
  return (int)nt_conv2d_f32(xs, nx, x_cstride, cin, nullptr, nullptr, nullptr, cout, 0, cout, b,
                            h, w_, ksize, 0, nullptr, rec);
}
