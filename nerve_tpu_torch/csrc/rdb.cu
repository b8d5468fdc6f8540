// Residual dense block: local feature fusion (1x1) and the 0.2-scaled
// residual.
//
// Together with the direct convolution of conv_chain.cu this replaces
// nerve_tpu/ops/rdb.py `_rdb_kernel` (reached via `_rdb_pallas_nhwc` <-
// `rdb_chain_fused` / `rdb_fused`). The TPU kernel kept the whole block in
// VMEM. Here the wrapper (ops/rdb.py) keeps two (B, H, W, C + 5*32)
// concatenation buffers per stack call: the stack's input is copied into
// channels [0, C) of the first once, the five dense 3x3 layers run
// `nt_conv2d`, each reading the channels written so far and writing its 32
// channels into its own slot (zero padding per layer by construction, as in
// `_rdb_xla`, rdb.py:414-436), and the fusion computes
//
//   out[p, n] = (sum_k cat[p, k] * w[k, n] + bias[n]) * res_scale + cat[p, n]
//
// in float32 and rounds once to the dtype, into channels [0, C) of the
// other buffer: the next block's input (or, after the last block, the
// stack's output).
//
// Bound: bytes. At 1080p x 64 features the fusion reads 448 bytes (the
// 224-channel bf16 concatenation) and writes 128 a pixel: 1.19 GB, 0.357 ms
// at 3.35 TB/s, against 0.06 TFLOP of products (0.06 ms at the bf16 peak).
//
// bfloat16 runs `lff_wgmma_kernel` (conv_chain.cu): the dense layers'
// warpgroup kernel as a 1x1 layer with K = ccat, N = 64 (one N tile for the
// model's 64 channels), and this epilogue. TMA streams the concatenation in
// 16-channel boxes of a 4 x 64-pixel tile (zero fill past ccat and past the
// frame's edges) through a ring of up to 8 stages per consumer warpgroup;
// the weights, packed once per call by ops/conv_chain.py
// `pack_conv_weights`, stay resident in shared memory (224 x 64 bf16 is
// 28 KB); persistent blocks walk the tiles, two consumer warpgroups in
// ping-pong. The epilogue rounds each float32 operation to nearest (no
// contraction into an FMA) and reads the residual channels from device memory,
// where they are L2-hot because this tile's TMA loads just fetched them,
// all of a row's pairs before any use. (Reading them from the staged tile
// instead would hold the 4 residual stages of 8 through each epilogue,
// half of the ring that keeps the loads in flight.)
// float32 (kept exact, no TF32) runs `lff_f32_kernel` below: the float32
// dense layers' implicit-GEMM family (conv_f32.cuh, whose note covers both)
// as a 1x1 layer with this epilogue. In float32 the fusion is bound by its
// operations (at 1080p x 64: 59.4 GFLOP, 0.887 ms at 67 TFLOP/s, against
// 2.39 GB, 0.713 ms).

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_f32.cuh"
#include "nerve_tpu_torch.h"

using namespace ntf32;

namespace {

template <int CFG, bool TMA>
__global__ void __launch_bounds__(f32_max_threads(1, CFG), 1)
    lff_f32_kernel(const __grid_constant__ CUtensorMap m0, const __grid_constant__ CUtensorMap m1,
                   const __grid_constant__ CUtensorMap m2,
                   const __grid_constant__ CUtensorMap om, const F32Params p) {
  conv_f32<1, CFG, TMA, F32_EPI_LFF>(&m0, &m1, &m2, &om, p);
}

template <int CFG>
cudaError_t launch_lff_cfg(const F32Plan& pl, const F32Params& p, const CUtensorMap (&maps)[4],
                           int route, const NtDeviceLimits& lim, cudaStream_t st, int* rec) {
  if (route == F32_ROUTE_TMA)
    return f32_launch<1, CFG, true, F32_EPI_LFF>(lff_f32_kernel<CFG, true>, pl, p, maps, route,
                                                 lim, st, rec);
  return f32_launch<1, CFG, false, F32_EPI_LFF>(lff_f32_kernel<CFG, false>, pl, p, maps, route,
                                                lim, st, rec);
}

}  // namespace

cudaError_t nt_lff_f32(const void* cat, int xcs, int ccat, const float* w, const float* bias,
                       void* out, int ocs, int ocoff, int c, int b, int h, int wd,
                       float res_scale, cudaStream_t stream, int* rec) {
  NtDeviceLimits lim;
  cudaError_t err = nt_device_limits(lim);
  if (err != cudaSuccess) return err;
  const void* xs[3] = {cat, cat, cat};
  const int route = f32_route(xs, 1, xcs, ccat, 1);
  F32Plan pl;
  F32Params p;
  CUtensorMap maps[4];
  if (!f32_setup(xs, 1, xcs, ccat, c, 1, b, h, wd, route == F32_ROUTE_TMA, lim, pl, p, maps))
    return cudaErrorInvalidValue;
  p.wt = w;
  p.wvec = p.cout % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  p.bias = bias;
  p.out = static_cast<float*>(out);
  p.ocs = ocs;
  p.ocoff = ocoff;
  p.vec = out != nullptr && ocs % 4 == 0 && ocoff % 4 == 0 &&
          reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (!f32_output_map(pl, p, b, maps[3])) return cudaErrorInvalidValue;
  p.res = static_cast<const float*>(cat);
  p.rcs = xcs;
  p.rvec = xcs % 4 == 0 && reinterpret_cast<uintptr_t>(cat) % 16 == 0;
  p.res_scale = res_scale;
  switch (pl.cfg) {
    case 0: return launch_lff_cfg<0>(pl, p, maps, route, lim, stream, rec);
    case 1: return launch_lff_cfg<1>(pl, p, maps, route, lim, stream, rec);
    case 2: return launch_lff_cfg<2>(pl, p, maps, route, lim, stream, rec);
    default: return launch_lff_cfg<3>(pl, p, maps, route, lim, stream, rec);
  }
}

extern "C" int nt_rdb_lff(const void* cat, int cat_cstride, int ccat, const void* w,
                          const float* bias, void* out, int out_cstride, int out_coff, int c,
                          int b, int h, int w_, float res_scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c < 1 || ccat < c || ccat > cat_cstride || out_coff < 0 || out_coff + c > out_cstride)
    return (int)cudaErrorInvalidValue;
  if (dtype == NT_BF16) {
    if (cat_cstride % 8 != 0 || reinterpret_cast<uintptr_t>(cat) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(w) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return (int)nt_lff_bf16_wgmma(cat, cat_cstride, ccat, w, bias, out, out_cstride, out_coff,
                                  c, b, h, w_, res_scale, st);
  }
  if (dtype == NT_F32)
    return (int)nt_lff_f32(cat, cat_cstride, ccat, static_cast<const float*>(w), bias, out,
                           out_cstride, out_coff, c, b, h, w_, res_scale, st, nullptr);
  return (int)cudaErrorInvalidValue;
}
