// int8 direct SAME convolution, one dense 3x3 or 1x1 layer per launch.
//
// Replaces nerve_tpu/ops/conv_chain_int8.py `_chain_int8_kernel` (reached
// via `conv_chain_int8_pallas` <- `conv_chain_int8_apply`); the wrapper
// (ops/conv_chain_int8.py) runs one launch per layer of a chain. It is also
// the dense-layer kernel of the int8 residual dense block that replaces
// nerve_tpu/ops/rdb_int8.py `_rdb_int8_kernel` (see rdb_int8.cu): the layer
// reads the leading `cin` channels of the block's int8 concatenation buffer
// and requantises its output into its own channel slot.
//
// Numerics are those of the reference formulations `conv_chain_int8_xla`
// (conv_chain_int8.py:392-425) and `rdb_chain_int8_xla` (rdb_int8.py:537-562):
// int8 x int8 products summed in int32, one sum per tap, each dequantised
// by its own column factor and rounded to bfloat16, the nine taps added in
// float32 in the order dy outer, dx inner, then float32 bias, relu, and
// either requantisation to int8 (multiplication by the stored reciprocal,
// rounded half to even, clipped to +-127) or the real value. Every float
// operation of the epilogue is an explicit round-to-nearest intrinsic, so
// the compiler contracts none of them into an FMA. Two more tap schedules
// serve the int8 RDB's other schemes (`_rdb_int8_kernel`, rdb_int8.py:324-371):
//   * NT_TAPS_DX: the same per-tap epilogue with dx as the outer loop
//     (`DX_MAJOR_INT8`);
//   * NT_TAPS_INT32: per-channel scales (`PER_CHANNEL_INT8`, `int32_taps`):
//     the nine taps' int32 sums add in int32 (|sum| <= 127^2 * 9 * K, below
//     2^31 for any K the shared memory holds) and the layer dequantises
//     once, f32(int32) * dq[n], before the bias. The tensor cores' int32
//     accumulator then runs over every tap and channel, and the epilogue
//     is one multiply instead of nine multiply-round-adds.
//
// Bound: neither side by much. A dense layer does 18 * cin * cout int8
// operations per pixel for cin + cout bytes of int8 in and out: 384 to 494
// operations a byte on the RDB's layers and up to 893 on the chains', about
// the card's balance point of 590 (1,979 TOPS dense int8 over 3.35 TB/s), so
// an RDB layer's floor at 1080p is 0.06-0.14 ms either way. The design aims
// at the arithmetic first, and at reading each input byte once per
// output-channel slice (one slice for the RDB's 32-wide layers). A block
// computes an 8 x 32 pixel tile for a 32- or 16-wide slice of output
// channels. The whole haloed input tile
// (every input channel) sits in shared memory, since each tap's int32 sum
// must be complete before it is dequantised; the weights of one tap are
// staged per tap. Each warp owns one tile row (two 16-pixel m-tiles) and
// runs mma.sync.m16n8k32 (s8 x s8 -> s32) over 32-channel steps, its
// operands fetched with ldmatrix from rows padded to an odd multiple of 16
// bytes (conflict-free). What the simple design gives up: wgmma and TMA,
// overlap of the next tap's weight loads with this tap's math, and keeping
// a chain's intermediates on chip (each layer round-trips device memory,
// in int8).

#include <cuda_runtime.h>
#include <stdint.h>

#include "nerve_tpu_torch.h"

namespace {

constexpr int TH = 8, TW = 32, NTHREADS = 32 * TH;
constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block may use

__host__ __device__ constexpr int ceil_to(int v, int m) { return (v + m - 1) / m * m; }

// Shared-memory layout: the haloed input tile [IH*IW][ks], one tap's
// weights [CO][ks], the dequant factors [taps][CO] (one row for
// NT_TAPS_INT32). ks = ceil32(cin) + 16. The tap schedule is a template
// parameter, so each schedule compiles to its own straight-line code.
template <int K, int CO>
__host__ __device__ constexpr int smem_bytes_for(int cin) {
  return ((TH + K - 1) * (TW + K - 1) + CO) * (ceil_to(cin, 32) + 16) + K * K * CO * 4;
}

__device__ __forceinline__ uint4 mask_tail(uint4 v, int keep) {
  // Zero the bytes at positions >= keep (0 < keep < 16) of a 16-byte vector.
  alignas(16) int8_t b[16];
  *reinterpret_cast<uint4*>(b) = v;
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i >= keep) b[i] = 0;
  return *reinterpret_cast<uint4*>(b);
}

template <int K, int CO, int MODE>
__global__ void __launch_bounds__(NTHREADS)
    conv_i8_kernel(const int8_t* __restrict__ x, int xcs, int cin,
                   const int8_t* __restrict__ w, const float* __restrict__ dq,
                   const float* __restrict__ bias, const float* __restrict__ inv,
                   void* __restrict__ out, int ocs, int ocoff, int cout, int h,
                   int wd, int relu, int odt) {
  constexpr int R = K / 2, IH = TH + 2 * R, IW = TW + 2 * R, NT = CO / 8, TAPS = K * K;
  constexpr bool int32_taps = MODE == NT_TAPS_INT32;
  static_assert(NT % 2 == 0, "CO must be a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem[];
  const int kc = ceil_to(cin, 32), ks = kc + 16, wks = ceil_to(cin, 16);
  int8_t* sx = reinterpret_cast<int8_t*>(smem);
  int8_t* sw = sx + IH * IW * ks;
  float* sdq = reinterpret_cast<float*>(sw + CO * ks);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int nco = (cout + CO - 1) / CO;
  const int b = blockIdx.z / nco, co0 = (blockIdx.z % nco) * CO;
  const long long img = (long long)b * h * wd;

  // The haloed input tile, every input channel, zero outside the image and
  // beyond cin; 16-byte moves.
  const int nvx = kc / 16;
  for (int i = tid; i < IH * IW * nvx; i += NTHREADS) {
    const int v = i % nvx, pix = i / nvx, xx = pix % IW, yy = pix / IW;
    const int gy = y0 + yy - R, gx = x0 + xx - R, gc = v * 16;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (gy >= 0 && gy < h && gx >= 0 && gx < wd && gc < cin) {
      val = *reinterpret_cast<const uint4*>(x + (img + (long long)gy * wd + gx) * xcs + gc);
      if (cin - gc < 16) val = mask_tail(val, cin - gc);
    }
    *reinterpret_cast<uint4*>(sx + pix * ks + gc) = val;
  }
  for (int i = tid; i < (int32_taps ? 1 : TAPS) * CO; i += NTHREADS) {
    const int go = co0 + i % CO;
    sdq[i] = go < cout ? dq[(i / CO) * cout + go] : 0.f;
  }

  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;

  int iacc[2][NT][4];
  for (int t = 0; t < TAPS; ++t) {
    const int tap = MODE == NT_TAPS_DX ? (t % K) * K + t / K : t;
    __syncthreads();  // the previous tap's weights are no longer read
    for (int i = tid; i < CO * nvx; i += NTHREADS) {
      const int v = i % nvx, n = i / nvx, go = co0 + n, gc = v * 16;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (go < cout && gc < wks)
        val = *reinterpret_cast<const uint4*>(w + ((long long)tap * cout + go) * wks + gc);
      *reinterpret_cast<uint4*>(sw + n * ks + gc) = val;
    }
    __syncthreads();
    const int ky = tap / K, kx = tap % K;
    if (!int32_taps || t == 0) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) iacc[m][n][q] = 0;
    }
    for (int k0 = 0; k0 < kc; k0 += 32) {
      unsigned a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
        nt_ldmatrix_x4(sx + ((warp + ky) * IW + m * 16 + lane % 16 + kx) * ks + k0 +
                           (lane / 16) * 16, a[m]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned bq[4];
        nt_ldmatrix_x4(sw + (np * 16 + (lane / 16) * 8 + lane % 8) * ks + k0 +
                           ((lane / 8) % 2) * 16, bq);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          nt_mma_s8(iacc[m][2 * np], a[m], bq[0], bq[1]);
          nt_mma_s8(iacc[m][2 * np + 1], a[m], bq[2], bq[3]);
        }
      }
    }
    if constexpr (int32_taps) continue;
    // This tap's dequantisation: f32(int32) * dq, rounded to bf16, added.
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float d = sdq[tap * CO + n * 8 + (lane % 4) * 2 + q % 2];
          const float tv = __bfloat162float(
              __float2bfloat16_rn(__fmul_rn(__int2float_rn(iacc[m][n][q]), d)));
          acc[m][n][q] = __fadd_rn(acc[m][n][q], tv);
        }
  }
  if constexpr (int32_taps) {
    // The layer's one dequantisation: f32(int32 sum of nine taps) * dq[n].
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[m][n][q] = __fmul_rn(__int2float_rn(iacc[m][n][q]),
                                   sdq[n * 8 + (lane % 4) * 2 + q % 2]);
  }

  const int gy = y0 + warp;
  if (gy >= h) return;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int gx = x0 + m * 16 + lane / 4 + hf * 8;
      if (gx >= wd) continue;
      const long long o = (img + (long long)gy * wd + gx) * ocs + ocoff;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int go = co0 + n * 8 + (lane % 4) * 2 + j;
          if (go >= cout) continue;
          float v = __fadd_rn(acc[m][n][hf * 2 + j], bias[go]);
          if (relu) v = fmaxf(v, 0.f);
          if (odt == NT_I8) {
            const float q = fminf(fmaxf(rintf(__fmul_rn(v, inv[go])), -127.f), 127.f);
            static_cast<int8_t*>(out)[o + go] = static_cast<int8_t>(__float2int_rn(q));
          } else if (odt == NT_BF16) {
            static_cast<__nv_bfloat16*>(out)[o + go] = __float2bfloat16_rn(v);
          } else {
            static_cast<float*>(out)[o + go] = v;
          }
        }
      }
    }
  }
}

template <int K, int CO, int MODE>
cudaError_t launch_cfg(const void* x, int xcs, int cin, const void* w, const float* dq,
                       const float* bias, const float* inv, void* out, int ocs,
                       int ocoff, int cout, int b, int h, int wd, int relu, int odt,
                       cudaStream_t stream) {
  const int smem = smem_bytes_for<K, CO>(cin);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv_i8_kernel<K, CO, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nco = (cout + CO - 1) / CO;
  const dim3 grid((wd + TW - 1) / TW, (h + TH - 1) / TH, b * nco);
  conv_i8_kernel<K, CO, MODE><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const int8_t*>(x), xcs, cin, static_cast<const int8_t*>(w), dq, bias, inv,
      out, ocs, ocoff, cout, h, wd, relu, odt);
  return cudaGetLastError();
}

template <int K, int MODE>
cudaError_t launch_k(const void* x, int xcs, int cin, const void* w, const float* dq,
                     const float* bias, const float* inv, void* out, int ocs, int ocoff,
                     int cout, int b, int h, int wd, int relu, int odt, cudaStream_t st) {
  // The output-channel slice follows the layer's width: the RDB's growth-32
  // layers take one 32-wide slice, the 2- and 3-channel heads a 16-wide one.
  if (cout > 16)
    return launch_cfg<K, 32, MODE>(x, xcs, cin, w, dq, bias, inv, out, ocs, ocoff, cout, b, h,
                                   wd, relu, odt, st);
  return launch_cfg<K, 16, MODE>(x, xcs, cin, w, dq, bias, inv, out, ocs, ocoff, cout, b, h,
                                 wd, relu, odt, st);
}

}  // namespace

extern "C" int nt_conv2d_i8(const void* x, int x_cstride, int cin, const void* w,
                            const float* dq, const float* bias, const float* inv,
                            void* out, int out_cstride, int out_coff, int cout, int b,
                            int h, int w_, int ksize, int relu, int out_dtype,
                            int taps_mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // The 1x1 layers (the conv chains') take the per-column schedule only.
  if ((ksize != 1 && ksize != 3) || x_cstride % 16 != 0 ||
      (taps_mode != NT_TAPS_DY && (ksize != 3 || (taps_mode != NT_TAPS_DX &&
                                                  taps_mode != NT_TAPS_INT32))) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      (out_dtype != NT_I8 && out_dtype != NT_BF16 && out_dtype != NT_F32))
    return (int)cudaErrorInvalidValue;
  auto launch = ksize == 1 ? launch_k<1, NT_TAPS_DY>
                : taps_mode == NT_TAPS_DX ? launch_k<3, NT_TAPS_DX>
                : taps_mode == NT_TAPS_INT32 ? launch_k<3, NT_TAPS_INT32>
                : launch_k<3, NT_TAPS_DY>;
  return (int)launch(x, x_cstride, cin, w, dq, bias, inv, out, out_cstride, out_coff, cout, b,
                     h, w_, relu, out_dtype, st);
}
