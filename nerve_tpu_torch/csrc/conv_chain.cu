// Direct SAME convolution, one dense 3x3 or 1x1 layer per launch.
//
// Replaces nerve_tpu/ops/conv_chain.py `_chain_kernel` (reached via
// `_chain_pallas` <- `conv_chain_fused` <- `conv_chain_apply`) for its dense
// layers; the wrapper runs one launch per layer of a chain. It is also the
// dense-layer kernel of the residual dense block (see rdb.cu): the layer
// reads the leading `cin` channels of a wider buffer and writes its output
// into a channel slot of another, so an RDB grows its concatenation in place.
//
// Numerics follow the reference formulation `_chain_xla`
// (conv_chain.py:411-443): float32 accumulation, the sum rounded to the
// input dtype (as XLA's convolution returns it), float32 bias, optional
// relu, the result rounded to the input dtype.
//
// Bound: arithmetic. At the serving shapes these layers do 0.1-0.8 TFLOP
// each. A block computes an 8 x 32 pixel tile for a CO-wide slice of output
// channels and walks the input channels in chunks: the haloed input chunk
// and the chunk's weights sit in shared memory.
//   * bfloat16 runs on the tensor cores: each warp owns one tile row (two
//     16-pixel m-tiles) and runs mma.sync.m16n8k16 per tap, its operands
//     fetched from shared memory with ldmatrix; sums stay float32.
//   * float32 (kept exact, no TF32) runs as FP32 FMAs on the CUDA cores:
//     each thread keeps a 4-pixel column x 8-channel block of sums in
//     registers, reusing a column segment of the input for the three
//     vertical taps.
// What the simple design gives up: wgmma and TMA, asynchronous copies that
// overlap the next chunk's loads with this chunk's math, a weight layout
// packed once instead of per block and chunk, and keeping a chain's
// intermediates on chip (each layer round-trips device memory).

#include <cuda_runtime.h>
#include <stdint.h>

#include "nerve_tpu_torch.h"

namespace {

constexpr int TH = 8, TW = 32;

// ---------------------------------------------------------------- bfloat16

// A chunk is 16 input channels; a pixel's row in shared memory is padded to
// 24 (48 bytes) so that the 8 rows one ldmatrix phase reads hit distinct banks.
constexpr int MMA_CK = 16, MMA_CKP = 24, MMA_THREADS = 32 * TH;

// Warp w computes output row w of the tile: pixels [0, 16) and [16, 32) are
// the A operand's two m-tiles (rows = pixels, k = input channels of one
// tap), output channels the n8 tiles of B. GEMM K runs over taps x chunks.
template <int K, int CO>
__global__ void __launch_bounds__(MMA_THREADS)
    conv_mma_kernel(const __nv_bfloat16* x, int xcs, int cin, int vec,
                    const float* __restrict__ w, const float* __restrict__ bias,
                    __nv_bfloat16* out, int ocs, int ocoff, int cout, int h,
                    int wd, int relu) {
  constexpr int R = K / 2, IH = TH + 2 * R, IW = TW + 2 * R, NT = CO / 8;
  static_assert(NT % 2 == 0, "CO must be a multiple of 16");
  __shared__ __align__(16) __nv_bfloat16 sx[IH][IW][MMA_CKP];
  __shared__ __align__(16) __nv_bfloat16 sw[K * K][CO][MMA_CKP];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int nco = (cout + CO - 1) / CO;
  const int b = blockIdx.z / nco, co0 = (blockIdx.z % nco) * CO;
  const long long img = (long long)b * h * wd;

  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += MMA_CK) {
    __syncthreads();
    // Input chunk: 16 channels per pixel, moved as two 8-channel halves.
    for (int i = tid; i < IH * IW * 2; i += MMA_THREADS) {
      const int half = i % 2, pix = i / 2, xx = pix % IW, yy = pix / IW;
      const int gy = y0 + yy - R, gx = x0 + xx - R, gc = c0 + half * 8;
      alignas(16) __nv_bfloat16 v[8];
      *reinterpret_cast<uint4*>(v) = make_uint4(0, 0, 0, 0);
      if (gy >= 0 && gy < h && gx >= 0 && gx < wd) {
        const __nv_bfloat16* src = x + (img + (long long)gy * wd + gx) * xcs + gc;
        if (vec && gc + 8 <= cin) {
          *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int k = 0; k < 8 && gc + k < cin; ++k) v[k] = src[k];
        }
      }
      *reinterpret_cast<uint4*>(&sx[yy][xx][half * 8]) = *reinterpret_cast<uint4*>(v);
    }
    // Weights, transposed to [tap][out channel][in channel] for ldmatrix.
    for (int i = tid; i < K * K * MMA_CK * CO; i += MMA_THREADS) {
      const int n = i % CO, r = i / CO, c = r % MMA_CK, tap = r / MMA_CK;
      const int gc = c0 + c, go = co0 + n;
      const float v = (gc < cin && go < cout) ? w[((long long)tap * cin + gc) * cout + go] : 0.f;
      sw[tap][n][c] = __float2bfloat16_rn(v);
    }
    __syncthreads();
#pragma unroll
    for (int ky = 0; ky < K; ++ky) {
#pragma unroll
      for (int kx = 0; kx < K; ++kx) {
        unsigned a[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
          nt_ldmatrix_x4(&sx[warp + ky][m * 16 + lane % 16 + kx][(lane / 16) * 8], a[m]);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          unsigned bq[4];
          nt_ldmatrix_x4(&sw[ky * K + kx][np * 16 + (lane / 16) * 8 + lane % 8]
                            [((lane / 8) % 2) * 8], bq);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            nt_mma_bf16(acc[m][2 * np], a[m], bq[0], bq[1]);
            nt_mma_bf16(acc[m][2 * np + 1], a[m], bq[2], bq[3]);
          }
        }
      }
    }
  }

  const int gy = y0 + warp;
  if (gy >= h) return;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int gx = x0 + m * 16 + lane / 4 + hf * 8;
      if (gx >= wd) continue;
      __nv_bfloat16* o = out + (img + (long long)gy * wd + gx) * ocs + ocoff;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int go = co0 + n * 8 + (lane % 4) * 2 + j;
          if (go < cout) {
            float v = __bfloat162float(__float2bfloat16_rn(acc[m][n][hf * 2 + j])) + bias[go];
            if (relu) v = fmaxf(v, 0.f);
            o[go] = __float2bfloat16_rn(v);
          }
        }
      }
    }
  }
}

template <int K, int CO>
cudaError_t launch_mma_cfg(const void* x, int xcs, int cin, const float* w,
                           const float* bias, void* out, int ocs, int ocoff,
                           int cout, int b, int h, int wd, int relu,
                           cudaStream_t stream) {
  const int nco = (cout + CO - 1) / CO;
  const dim3 grid((wd + TW - 1) / TW, (h + TH - 1) / TH, b * nco);
  const int vec = xcs % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  conv_mma_kernel<K, CO><<<grid, MMA_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), xcs, cin, vec, w, bias,
      static_cast<__nv_bfloat16*>(out), ocs, ocoff, cout, h, wd, relu);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_mma(const void* x, int xcs, int cin, const float* w,
                       const float* bias, void* out, int ocs, int ocoff,
                       int cout, int b, int h, int wd, int relu,
                       cudaStream_t st) {
  if (cout > 32)
    return launch_mma_cfg<K, 64>(x, xcs, cin, w, bias, out, ocs, ocoff, cout, b, h, wd, relu, st);
  if (cout > 16)
    return launch_mma_cfg<K, 32>(x, xcs, cin, w, bias, out, ocs, ocoff, cout, b, h, wd, relu, st);
  return launch_mma_cfg<K, 16>(x, xcs, cin, w, bias, out, ocs, ocoff, cout, b, h, wd, relu, st);
}

// ----------------------------------------------------------------- float32

constexpr int P = 4, FMA_CK = 8;
constexpr int PIX_THREADS = TW * (TH / P);

template <int K, int CO, int O>
__global__ void __launch_bounds__(PIX_THREADS*(CO / O))
    conv_fma_kernel(const float* x, int xcs, int cin, const float* __restrict__ w,
                    const float* __restrict__ bias, float* out, int ocs,
                    int ocoff, int cout, int h, int wd, int relu) {
  constexpr int R = K / 2, IH = TH + 2 * R, IW = TW + 2 * R;
  constexpr int NTHREADS = PIX_THREADS * (CO / O);
  static_assert(O % 4 == 0 && CO % O == 0, "O must be a multiple of 4");
  __shared__ float sx[FMA_CK][IH][IW];
  __shared__ __align__(16) float sw[FMA_CK][K * K][CO];

  const int tid = threadIdx.x;
  const int tx = tid % TW, tg = (tid / TW) % (TH / P), og = tid / PIX_THREADS;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int nco = (cout + CO - 1) / CO;
  const int b = blockIdx.z / nco, co0 = (blockIdx.z % nco) * CO;
  const long long img = (long long)b * h * wd;

  float acc[P][O];
#pragma unroll
  for (int j = 0; j < P; ++j)
#pragma unroll
    for (int q = 0; q < O; ++q) acc[j][q] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += FMA_CK) {
    __syncthreads();
    for (int i = tid; i < FMA_CK * IH * IW; i += NTHREADS) {
      const int k = i % FMA_CK, r = i / FMA_CK, xx = r % IW, yy = r / IW;
      const int gy = y0 + yy - R, gx = x0 + xx - R, gc = c0 + k;
      float v = 0.f;
      if (gy >= 0 && gy < h && gx >= 0 && gx < wd && gc < cin)
        v = x[(img + (long long)gy * wd + gx) * xcs + gc];
      sx[k][yy][xx] = v;
    }
    for (int i = tid; i < FMA_CK * K * K * CO; i += NTHREADS) {
      const int o = i % CO, r = i / CO, tap = r % (K * K), k = r / (K * K);
      const int gc = c0 + k, go = co0 + o;
      float v = 0.f;
      if (gc < cin && go < cout) v = w[((long long)tap * cin + gc) * cout + go];
      sw[k][tap][o] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FMA_CK; ++k) {
#pragma unroll
      for (int kx = 0; kx < K; ++kx) {
        float seg[P + K - 1];
#pragma unroll
        for (int j = 0; j < P + K - 1; ++j) seg[j] = sx[k][tg * P + j][tx + kx];
#pragma unroll
        for (int ky = 0; ky < K; ++ky) {
          float wv[O];
#pragma unroll
          for (int q = 0; q < O; q += 4) {
            const float4 t =
                *reinterpret_cast<const float4*>(&sw[k][ky * K + kx][og * O + q]);
            wv[q] = t.x;
            wv[q + 1] = t.y;
            wv[q + 2] = t.z;
            wv[q + 3] = t.w;
          }
#pragma unroll
          for (int j = 0; j < P; ++j)
#pragma unroll
            for (int q = 0; q < O; ++q)
              acc[j][q] = fmaf(seg[j + ky], wv[q], acc[j][q]);
        }
      }
    }
  }

  const int gx = x0 + tx;
  if (gx >= wd) return;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int gy = y0 + tg * P + j;
    if (gy >= h) continue;
    float* o = out + (img + (long long)gy * wd + gx) * ocs + ocoff;
#pragma unroll
    for (int q = 0; q < O; ++q) {
      const int go = co0 + og * O + q;
      if (go < cout) {
        float v = acc[j][q] + bias[go];
        if (relu) v = fmaxf(v, 0.f);
        o[go] = v;
      }
    }
  }
}

template <int K, int CO, int O>
cudaError_t launch_fma_cfg(const void* x, int xcs, int cin, const float* w,
                           const float* bias, void* out, int ocs, int ocoff,
                           int cout, int b, int h, int wd, int relu,
                           cudaStream_t stream) {
  const int nco = (cout + CO - 1) / CO;
  const dim3 grid((wd + TW - 1) / TW, (h + TH - 1) / TH, b * nco);
  conv_fma_kernel<K, CO, O><<<grid, PIX_THREADS * (CO / O), 0, stream>>>(
      static_cast<const float*>(x), xcs, cin, w, bias, static_cast<float*>(out),
      ocs, ocoff, cout, h, wd, relu);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_fma(const void* x, int xcs, int cin, const float* w,
                       const float* bias, void* out, int ocs, int ocoff,
                       int cout, int b, int h, int wd, int relu,
                       cudaStream_t st) {
  // The output-channel tile follows the layer's width so that the 2- and
  // 3-channel heads do not run 64-wide blocks of zeros.
  if (cout > 32)
    return launch_fma_cfg<K, 64, 8>(x, xcs, cin, w, bias, out, ocs, ocoff, cout, b, h, wd, relu, st);
  if (cout > 16)
    return launch_fma_cfg<K, 32, 8>(x, xcs, cin, w, bias, out, ocs, ocoff, cout, b, h, wd, relu, st);
  if (cout > 4)
    return launch_fma_cfg<K, 16, 8>(x, xcs, cin, w, bias, out, ocs, ocoff, cout, b, h, wd, relu, st);
  return launch_fma_cfg<K, 4, 4>(x, xcs, cin, w, bias, out, ocs, ocoff, cout, b, h, wd, relu, st);
}

}  // namespace

extern "C" int nt_conv2d(const void* x, int x_cstride, int cin, const float* w,
                         const float* bias, void* out, int out_cstride,
                         int out_coff, int cout, int b, int h, int w_,
                         int ksize, int relu, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ksize != 1 && ksize != 3) return (int)cudaErrorInvalidValue;
  if (dtype == NT_BF16)
    return (int)(ksize == 3 ? launch_mma<3> : launch_mma<1>)(
        x, x_cstride, cin, w, bias, out, out_cstride, out_coff, cout, b, h, w_, relu, st);
  if (dtype == NT_F32)
    return (int)(ksize == 3 ? launch_fma<3> : launch_fma<1>)(
        x, x_cstride, cin, w, bias, out, out_cstride, out_coff, cout, b, h, w_, relu, st);
  return (int)cudaErrorInvalidValue;
}
