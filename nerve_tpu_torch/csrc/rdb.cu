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
// float32 (kept exact, no TF32) runs as FP32 FMAs on the CUDA cores, a
// block computing 64 pixels x 64 channels with 4 x 4 sums per thread over
// 32-channel slices staged in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nerve_tpu_torch.h"

namespace {

constexpr int NTHREADS = 256, NT = 64;

// ----------------------------------------------------------------- float32

constexpr int FMA_PT = 64, FMA_KC = 32;

__global__ void __launch_bounds__(NTHREADS)
    lff_fma_kernel(const float* __restrict__ cat, int ccs, int ccat, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out, int ocs, int c,
                   long long npix, float res_scale) {
  __shared__ float sa[FMA_KC][FMA_PT + 1];
  __shared__ float sw[FMA_KC][NT];
  const int tid = threadIdx.x;
  const int tp = tid % 16, tn = tid / 16;
  const long long p0 = blockIdx.x * (long long)FMA_PT;
  const int n0 = blockIdx.y * NT;
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int l = 0; l < 4; ++l) acc[j][l] = 0.f;

  for (int k0 = 0; k0 < ccat; k0 += FMA_KC) {
    __syncthreads();
    for (int i = tid; i < FMA_PT * FMA_KC; i += NTHREADS) {
      const int k = i % FMA_KC, p = i / FMA_KC;
      const long long gp = p0 + p;
      const int gk = k0 + k;
      sa[k][p] = (gp < npix && gk < ccat) ? cat[gp * ccs + gk] : 0.f;
    }
    for (int i = tid; i < FMA_KC * NT; i += NTHREADS) {
      const int n = i % NT, k = i / NT;
      const int gk = k0 + k, gn = n0 + n;
      sw[k][n] = (gk < ccat && gn < c) ? w[(long long)gk * c + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < FMA_KC; ++k) {
      float a[4], bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] = sa[k][tp + 16 * j];
#pragma unroll
      for (int l = 0; l < 4; ++l) bv[l] = sw[k][tn + 16 * l];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int l = 0; l < 4; ++l) acc[j][l] = fmaf(a[j], bv[l], acc[j][l]);
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long p = p0 + tp + 16 * j;
    if (p >= npix) continue;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int n = n0 + tn + 16 * l;
      if (n < c) out[p * ocs + n] = (acc[j][l] + bias[n]) * res_scale + cat[p * ccs + n];
    }
  }
}

}  // namespace

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
  if (dtype == NT_F32) {
    const long long npix = (long long)b * h * w_;
    const dim3 grid((unsigned)((npix + FMA_PT - 1) / FMA_PT), (c + NT - 1) / NT);
    lff_fma_kernel<<<grid, NTHREADS, 0, st>>>(
        static_cast<const float*>(cat), cat_cstride, ccat, static_cast<const float*>(w), bias,
        static_cast<float*>(out) + out_coff, out_cstride, c, npix, res_scale);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
