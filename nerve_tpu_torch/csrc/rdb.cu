// Residual dense block: local feature fusion (1x1) and the 0.2-scaled
// residual.
//
// Together with the direct convolution of conv_chain.cu this replaces
// nerve_tpu/ops/rdb.py `_rdb_kernel` (reached via `_rdb_pallas_nhwc` <-
// `rdb_chain_fused` / `rdb_fused`). The TPU kernel kept the whole block in
// VMEM. Here the wrapper (ops/rdb.py) allocates one (B, H, W, C + 5*32)
// concatenation buffer per block, copies the input into its leading C
// channels, and runs the five dense 3x3 layers with `nt_conv2d`, each
// reading the channels written so far and writing its 32 channels into its
// own slot; zero padding is per layer by construction, as in `_rdb_xla`
// (rdb.py:414-436). This kernel then computes
//
//   out[p, n] = (sum_k cat[p, k] * w[k, n] + bias[n]) * res_scale + cat[p, n]
//
// in float32 and rounds once to the input dtype.
//
// Bound: at 1080p x 64 features the fusion is 0.06 TFLOP and one read of
// the 224-channel buffer (0.9 GB in bf16) per block. bfloat16 runs on the
// tensor cores: a block computes 128 pixels x 64 output channels, each warp
// one 16-pixel m-tile against eight n8 tiles with mma.sync.m16n8k16, over
// 32-channel slices staged in shared memory. float32 runs as FP32 FMAs, a
// block computing 64 pixels x 64 channels with 4 x 4 sums per thread. What
// the simple design gives up: the concatenation round-trips device memory
// five times per block (the TPU kernel kept it on chip), and the loads are
// not overlapped with the math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nerve_tpu_torch.h"

namespace {

constexpr int NTHREADS = 256, NT = 64;

// ---------------------------------------------------------------- bfloat16

// Rows of 32 channels padded to 40 (80 bytes): ldmatrix phases hit distinct
// banks.
constexpr int MMA_PT = 128, MMA_KC = 32, MMA_KP = 40;

__global__ void __launch_bounds__(NTHREADS)
    lff_mma_kernel(const __nv_bfloat16* __restrict__ cat, int ccat, int vec,
                   const float* __restrict__ w, const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out, int c, long long npix,
                   float res_scale) {
  __shared__ __align__(16) __nv_bfloat16 sa[MMA_PT][MMA_KP];
  __shared__ __align__(16) __nv_bfloat16 sw[NT][MMA_KP];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long p0 = blockIdx.x * (long long)MMA_PT;
  const int n0 = blockIdx.y * NT;
  float acc[NT / 8][4];
#pragma unroll
  for (int n = 0; n < NT / 8; ++n)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[n][q] = 0.f;

  for (int k0 = 0; k0 < ccat; k0 += MMA_KC) {
    __syncthreads();
    for (int i = tid; i < MMA_PT * (MMA_KC / 8); i += NTHREADS) {
      const int q = i % (MMA_KC / 8), p = i / (MMA_KC / 8);
      const long long gp = p0 + p;
      const int gk = k0 + q * 8;
      alignas(16) __nv_bfloat16 v[8];
      *reinterpret_cast<uint4*>(v) = make_uint4(0, 0, 0, 0);
      if (gp < npix) {
        const __nv_bfloat16* src = cat + gp * ccat + gk;
        if (vec && gk + 8 <= ccat) {
          *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int k = 0; k < 8 && gk + k < ccat; ++k) v[k] = src[k];
        }
      }
      *reinterpret_cast<uint4*>(&sa[p][q * 8]) = *reinterpret_cast<uint4*>(v);
    }
    for (int i = tid; i < MMA_KC * NT; i += NTHREADS) {
      const int n = i % NT, k = i / NT;
      const int gk = k0 + k, gn = n0 + n;
      sw[n][k] = __float2bfloat16_rn((gk < ccat && gn < c) ? w[(long long)gk * c + gn] : 0.f);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < MMA_KC / 16; ++ks) {
      unsigned a[4];
      nt_ldmatrix_x4(&sa[warp * 16 + lane % 16][ks * 16 + (lane / 16) * 8], a);
#pragma unroll
      for (int np = 0; np < NT / 16; ++np) {
        unsigned bq[4];
        nt_ldmatrix_x4(&sw[np * 16 + (lane / 16) * 8 + lane % 8][ks * 16 + ((lane / 8) % 2) * 8], bq);
        nt_mma_bf16(acc[2 * np], a, bq[0], bq[1]);
        nt_mma_bf16(acc[2 * np + 1], a, bq[2], bq[3]);
      }
    }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const long long p = p0 + warp * 16 + lane / 4 + hf * 8;
    if (p >= npix) continue;
#pragma unroll
    for (int n = 0; n < NT / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int gn = n0 + n * 8 + (lane % 4) * 2 + j;
        if (gn < c) {
          const float v = (acc[n][hf * 2 + j] + bias[gn]) * res_scale +
                          __bfloat162float(cat[p * ccat + gn]);
          out[p * c + gn] = __float2bfloat16_rn(v);
        }
      }
    }
  }
}

// ----------------------------------------------------------------- float32

constexpr int FMA_PT = 64, FMA_KC = 32;

__global__ void __launch_bounds__(NTHREADS)
    lff_fma_kernel(const float* __restrict__ cat, int ccat, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out, int c,
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
      sa[k][p] = (gp < npix && gk < ccat) ? cat[gp * ccat + gk] : 0.f;
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
      if (n < c) out[p * c + n] = (acc[j][l] + bias[n]) * res_scale + cat[p * ccat + n];
    }
  }
}

}  // namespace

extern "C" int nt_rdb_lff(const void* cat, int ccat, const float* w,
                          const float* bias, void* out, int c, int b, int h,
                          int w_, float res_scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long npix = (long long)b * h * w_;
  if (dtype == NT_BF16) {
    const dim3 grid((unsigned)((npix + MMA_PT - 1) / MMA_PT), (c + NT - 1) / NT);
    const int vec = ccat % 8 == 0 && reinterpret_cast<uintptr_t>(cat) % 16 == 0;
    lff_mma_kernel<<<grid, NTHREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(cat), ccat, vec, w, bias,
        static_cast<__nv_bfloat16*>(out), c, npix, res_scale);
    return (int)cudaGetLastError();
  }
  if (dtype == NT_F32) {
    const dim3 grid((unsigned)((npix + FMA_PT - 1) / FMA_PT), (c + NT - 1) / NT);
    lff_fma_kernel<<<grid, NTHREADS, 0, st>>>(
        static_cast<const float*>(cat), ccat, w, bias, static_cast<float*>(out), c,
        npix, res_scale);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
