// int8 residual dense block: the 1x1 local feature fusion, the 0.2-scaled
// residual and the requantisation to the next block's input scale.
//
// Together with the int8 convolution of conv_int8.cu this replaces
// nerve_tpu/ops/rdb_int8.py `_rdb_int8_kernel` (reached via
// `_rdb_int8_pallas` <- `rdb_chain_int8_pallas` <- `rdb_chain_int8_apply`).
// The TPU kernel kept the block's int8 concatenation in VMEM. Here the
// wrapper (ops/rdb_int8.py) keeps two int8 (B, H, W, C + L*G) buffers: the
// block's int8 input sits in channels [0, C) of one, each dense layer is
// `nt_conv2d_i8` writing its requantised G channels into its slot, and this
// kernel then computes, per pixel p and output channel n,
//
//   lff = sum_k cat[p, k] * lw[n, k]                         (int32)
//   v   = (lff * ldq[n] + lbias[n]) * 0.2 + cat[p, n] * s_in
//
// as `rdb_chain_int8_xla` does (rdb_int8.py:563-575): the residual is the
// dequantised int8 block input, not the original activation. v is then
// requantised by division by the next block's input scale into channels
// [0, C) of the other buffer, or, after the last block, rounded once to the
// model's dtype. Each float operation is an explicit round-to-nearest
// intrinsic, so none is contracted into an FMA.
//
// Bound: bytes. The fusion is 2 * 224 * 64 int8 operations per pixel
// (0.06 T per 1080p block) but reads the 224-byte concatenation of every
// pixel once (0.46 GB per block at 1080p): ~0.14 ms at 3.35 TB/s, against
// ~0.03 ms of int8 tensor-core work. A block computes 128 pixels x 64
// output channels, each warp one 16-pixel m-tile against eight n8 tiles
// with mma.sync.m16n8k32 (s8 x s8 -> s32), over 32-channel slices staged
// in shared memory with 16-byte loads. What the simple design gives up:
// the loads are not overlapped with the math (no cp.async or TMA pipeline),
// and the concatenation round-trips device memory once per dense layer.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nerve_tpu_torch.h"

namespace {

constexpr int NTHREADS = 256, PT = 128, NT = 64, KC = 32, KS = KC + 16;

__global__ void __launch_bounds__(NTHREADS)
    lff_i8_kernel(const int8_t* __restrict__ cat, int ccs, int ccat,
                  const int8_t* __restrict__ lw, const float* __restrict__ ldq,
                  const float* __restrict__ lbias, const float* __restrict__ s_in,
                  const float* __restrict__ s_next, void* __restrict__ out, int ocs,
                  int c, long long npix, int odt) {
  __shared__ __align__(16) int8_t sa[PT][KS];
  __shared__ __align__(16) int8_t sw[NT][KS];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long p0 = blockIdx.x * (long long)PT;
  const int n0 = blockIdx.y * NT;
  const int lks = (ccat + 15) / 16 * 16;
  int acc[NT / 8][4];
#pragma unroll
  for (int n = 0; n < NT / 8; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[n][q] = 0;

  for (int k0 = 0; k0 < ccat; k0 += KC) {
    __syncthreads();
    for (int i = tid; i < PT * (KC / 16); i += NTHREADS) {
      const int q = i % (KC / 16), p = i / (KC / 16);
      const long long gp = p0 + p;
      const int gk = k0 + q * 16;
      alignas(16) int8_t v[16];
      *reinterpret_cast<uint4*>(v) = make_uint4(0, 0, 0, 0);
      if (gp < npix && gk < ccat) {
        *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(cat + gp * ccs + gk);
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if (gk + k >= ccat) v[k] = 0;
      }
      *reinterpret_cast<uint4*>(&sa[p][q * 16]) = *reinterpret_cast<uint4*>(v);
    }
    for (int i = tid; i < NT * (KC / 16); i += NTHREADS) {
      const int q = i % (KC / 16), n = i / (KC / 16);
      const int gn = n0 + n, gk = k0 + q * 16;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gn < c && gk < lks) v = *reinterpret_cast<const uint4*>(lw + (long long)gn * lks + gk);
      *reinterpret_cast<uint4*>(&sw[n][q * 16]) = v;
    }
    __syncthreads();
    unsigned a[4];
    nt_ldmatrix_x4(&sa[warp * 16 + lane % 16][(lane / 16) * 16], a);
#pragma unroll
    for (int np = 0; np < NT / 16; ++np) {
      unsigned bq[4];
      nt_ldmatrix_x4(&sw[np * 16 + (lane / 16) * 8 + lane % 8][((lane / 8) % 2) * 16], bq);
      nt_mma_s8(acc[2 * np], a, bq[0], bq[1]);
      nt_mma_s8(acc[2 * np + 1], a, bq[2], bq[3]);
    }
  }

  const float sx = s_in[0];
  const float snext = odt == NT_I8 ? s_next[0] : 1.f;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const long long p = p0 + warp * 16 + lane / 4 + hf * 8;
    if (p >= npix) continue;
#pragma unroll
    for (int n = 0; n < NT / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int gn = n0 + n * 8 + (lane % 4) * 2 + j;
        if (gn >= c) continue;
        float t = __fmul_rn(__int2float_rn(acc[n][hf * 2 + j]), ldq[gn]);
        t = __fmul_rn(__fadd_rn(t, lbias[gn]), 0.2f);
        const float xin = __fmul_rn(static_cast<float>(cat[p * ccs + gn]), sx);
        const float v = __fadd_rn(t, xin);
        if (odt == NT_I8) {
          const float q = fminf(fmaxf(rintf(__fdiv_rn(v, snext)), -127.f), 127.f);
          static_cast<int8_t*>(out)[p * ocs + gn] = static_cast<int8_t>(__float2int_rn(q));
        } else if (odt == NT_BF16) {
          static_cast<__nv_bfloat16*>(out)[p * ocs + gn] = __float2bfloat16_rn(v);
        } else {
          static_cast<float*>(out)[p * ocs + gn] = v;
        }
      }
    }
  }
}

}  // namespace

extern "C" int nt_rdb_lff_i8(const void* cat, int cat_cstride, int ccat, const void* lw,
                             const float* ldq, const float* lbias, const float* s_in,
                             const float* s_next, void* out, int out_cstride, int c, int b,
                             int h, int w_, int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cat_cstride % 16 != 0 || reinterpret_cast<uintptr_t>(cat) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(lw) % 16 != 0 || ccat > cat_cstride ||
      (out_dtype != NT_I8 && out_dtype != NT_BF16 && out_dtype != NT_F32))
    return (int)cudaErrorInvalidValue;
  const long long npix = (long long)b * h * w_;
  const dim3 grid((unsigned)((npix + PT - 1) / PT), (c + NT - 1) / NT);
  lff_i8_kernel<<<grid, NTHREADS, 0, st>>>(
      static_cast<const int8_t*>(cat), cat_cstride, ccat, static_cast<const int8_t*>(lw), ldq,
      lbias, s_in, s_next, out, out_cstride, c, npix, out_dtype);
  return (int)cudaGetLastError();
}
