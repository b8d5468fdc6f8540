// A dense 3x3 layer of the residual dense block under the TPU kernels' own
// rounding contracts: the taps' sums grouped, each group rounded, the
// groups added in a given order.
//
// Replaces the fused RDB variants of scripts/diag_rdb.py (`call`, the
// pallas_call of `make_kernel`'s modes) and scripts/diag_rdb_s2d.py
// (`rdb_s2d`), and reproduces the numerics of nerve_tpu/ops/rdb.py
// `_rdb_kernel` itself, which the port's serving RDB (conv_chain.cu +
// rdb.cu) leaves for `_rdb_xla`'s. The wrapper (ops/rdb_taps.py) runs one
// launch per dense layer, each reading the leading `cin` channels of the
// block's concatenation buffer and writing its own channel slot, then the
// fusion and residual with rdb.cu's `nt_rdb_lff`.
//
// The contract is a table per output-row parity: the nine taps (t = 3*dy +
// dx) in the order they are walked, and where each group ends. A group's
// products sum in float32 (the tensor cores' accumulator); the bias, at the
// activation dtype, joins the group holding the centre tap; the group is
// rounded to the dtype and added to a float32 accumulator (or, with
// NT_TAPS_ACC_DTYPE, to one rounded to the dtype after every add); then
// relu and a round to the dtype. The Pallas kernels' tap matmuls are these
// groups: one per tap (`pallas_dy`, `pallas_dx`), one for all nine
// (`f32_taps`), or the s2d kernel's row-phase pairs and singles (`s2d`).
// Two ablations time parts of the work: NT_TAPS_NOSHIFT keeps only the
// centre tap's group (relu(round(centre + bias))) with every tap's product
// still computed; NT_TAPS_MATONLY walks the same groups, folds each group's
// sum into the accumulator unrounded and without the bias, and stores one
// token per warp instead of the layer.
//
// Bound: arithmetic, as the serving RDB's layers (18 * cin * cout
// operations per pixel in bf16, ~0.82 TFLOP per 1080p block). A block
// computes an 8 x 32 pixel tile for a CO-wide slice of output channels.
// Grouped rounding needs each group's sum complete before it is rounded, so
// the channel loop is inside the tap loop: the whole haloed input tile, every
// input channel, and all nine taps' weights for the slice sit in shared
// memory (CO = 32 where that fits in 227 KB, else 16: 194 KB for the widest
// layer, cin = 192), staged once. Each warp owns one tile row (two 16-pixel
// m-tiles) and walks its row parity's table with mma.sync.m16n8k16, its
// operands fetched with ldmatrix from rows padded to an odd multiple of 16
// bytes. Warps of the two parities walk different tables from the same
// shared memory. float32 runs as FP32 FMAs, one thread per pixel and eight
// output channels, reading through the caches: it exists for the tests.
// What the simple design gives up: the one-block-per-SM occupancy of the
// wide layers, staging overlapped with math, wgmma and TMA, and keeping the
// block's concatenation on chip (it round-trips device memory per layer).

#include <cuda_runtime.h>
#include <stdint.h>

#include "nerve_tpu_torch.h"

namespace {

constexpr int TH = 8, TW = 32, IH = TH + 2, IW = TW + 2, NTHREADS = 32 * TH;
constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block may use

struct TapTable {
  int order[2][9];  // taps in walk order, per output-row parity
  int ends[2];      // bit i: a group ends after the i-th tap of the walk
};

__host__ __device__ constexpr int ceil_to(int v, int m) { return (v + m - 1) / m * m; }

// Row length in shared memory: channels padded to 16, plus 8 (16 bytes), so
// a row is an odd multiple of 16 bytes and ldmatrix phases hit distinct banks.
__host__ __device__ constexpr int row_len(int cin) { return ceil_to(cin, 16) + 8; }

template <int CO>
__host__ __device__ constexpr int smem_bytes_for(int cin) {
  return (IH * IW + 9 * CO) * row_len(cin) * 2 + CO * 4;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int CO>
__global__ void __launch_bounds__(NTHREADS)
    taps_mma_kernel(const __nv_bfloat16* __restrict__ x, int xcs, int cin, int vec,
                    const float* __restrict__ w, const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, int ocs, int ocoff, int cout, int h,
                    int wd, TapTable tbl, int flags) {
  constexpr int NT = CO / 8;
  static_assert(NT % 2 == 0, "CO must be a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem[];
  const int kc = ceil_to(cin, 16), ks = row_len(cin);
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sw = sx + IH * IW * ks;
  float* sb = reinterpret_cast<float*>(sw + 9 * CO * ks);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int nco = (cout + CO - 1) / CO;
  const int b = blockIdx.z / nco, co0 = (blockIdx.z % nco) * CO;
  const long long img = (long long)b * h * wd;

  // The haloed input tile, every input channel, zero outside the image and
  // beyond cin, in 8-channel (16-byte) pieces.
  const int nv = kc / 8;
  for (int i = tid; i < IH * IW * nv; i += NTHREADS) {
    const int v = i % nv, pix = i / nv, xx = pix % IW, yy = pix / IW;
    const int gy = y0 + yy - 1, gx = x0 + xx - 1, gc = v * 8;
    alignas(16) __nv_bfloat16 vals[8];
    *reinterpret_cast<uint4*>(vals) = make_uint4(0, 0, 0, 0);
    if (gy >= 0 && gy < h && gx >= 0 && gx < wd) {
      const __nv_bfloat16* src = x + (img + (long long)gy * wd + gx) * xcs + gc;
      if (vec && gc + 8 <= cin) {
        *reinterpret_cast<uint4*>(vals) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int k = 0; k < 8 && gc + k < cin; ++k) vals[k] = src[k];
      }
    }
    *reinterpret_cast<uint4*>(sx + pix * ks + gc) = *reinterpret_cast<uint4*>(vals);
  }
  // All nine taps' weights of the slice, as [tap][out channel][in channel].
  for (int i = tid; i < 9 * kc * CO; i += NTHREADS) {
    const int n = i % CO, r = i / CO, c = r % kc, tap = r / kc, go = co0 + n;
    const float v = (c < cin && go < cout) ? w[((long long)tap * cin + c) * cout + go] : 0.f;
    sw[(tap * CO + n) * ks + c] = __float2bfloat16_rn(v);
  }
  for (int i = tid; i < CO; i += NTHREADS) sb[i] = co0 + i < cout ? bias[co0 + i] : 0.f;
  __shared__ int s_order[2][9], s_ends[2];
  if (tid < 18) s_order[tid / 9][tid % 9] = tbl.order[tid / 9][tid % 9];
  if (tid < 2) s_ends[tid] = tbl.ends[tid];
  __syncthreads();

  const int gy = y0 + warp, par = gy & 1;
  const bool acc_dtype = flags & NT_TAPS_ACC_DTYPE, noshift = flags & NT_TAPS_NOSHIFT;
  const bool matonly = flags & NT_TAPS_MATONLY;
  float acc[2][NT][4], gacc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;

  bool fresh = true, has_bias = false;
  for (int i = 0; i < 9; ++i) {
    const int tap = s_order[par][i], ky = tap / 3, kx = tap % 3;
    if (fresh) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) gacc[m][n][q] = 0.f;
      has_bias = false;
      fresh = false;
    }
    has_bias |= tap == 4;
    for (int k0 = 0; k0 < kc; k0 += 16) {
      unsigned a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
        nt_ldmatrix_x4(sx + ((warp + ky) * IW + m * 16 + lane % 16 + kx) * ks + k0 +
                           (lane / 16) * 8, a[m]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned bq[4];
        nt_ldmatrix_x4(sw + (tap * CO + np * 16 + (lane / 16) * 8 + lane % 8) * ks + k0 +
                           ((lane / 8) % 2) * 8, bq);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          nt_mma_bf16(gacc[m][2 * np], a[m], bq[0], bq[1]);
          nt_mma_bf16(gacc[m][2 * np + 1], a[m], bq[2], bq[3]);
        }
      }
    }
    if (!((s_ends[par] >> i) & 1)) continue;
    // The group ends: bias if it holds the centre tap, round, accumulate.
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float g = gacc[m][n][q];
          if (matonly) {
            acc[m][n][q] += g;
            continue;
          }
          if (has_bias) g = __fadd_rn(g, sb[n * 8 + (lane % 4) * 2 + q % 2]);
          g = round_bf16(g);
          if (noshift) {
            if (has_bias) acc[m][n][q] = g;
          } else if (acc_dtype) {
            acc[m][n][q] = round_bf16(__fadd_rn(acc[m][n][q], g));
          } else {
            acc[m][n][q] = __fadd_rn(acc[m][n][q], g);
          }
        }
    fresh = true;
  }

  if (gy >= h) return;
  if (matonly) {
    // One token per warp keeps the products; the layer is not stored.
    float tok = 0.f;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) tok += acc[m][n][q];
    if (lane == 0) out[(img + (long long)gy * wd + x0) * ocs + ocoff + co0] = __float2bfloat16_rn(tok);
    return;
  }
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
          if (go < cout) o[go] = __float2bfloat16_rn(fmaxf(acc[m][n][hf * 2 + j], 0.f));
        }
      }
    }
  }
}

template <int CO>
cudaError_t launch_mma(const void* x, int xcs, int cin, const float* w, const float* bias,
                       void* out, int ocs, int ocoff, int cout, int b, int h, int wd,
                       const TapTable& tbl, int flags, cudaStream_t stream) {
  const int smem = smem_bytes_for<CO>(cin);
  cudaError_t err = cudaFuncSetAttribute(taps_mma_kernel<CO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nco = (cout + CO - 1) / CO;
  const dim3 grid((wd + TW - 1) / TW, (h + TH - 1) / TH, b * nco);
  const int vec = xcs % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  taps_mma_kernel<CO><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), xcs, cin, vec, w, bias,
      static_cast<__nv_bfloat16*>(out), ocs, ocoff, cout, h, wd, tbl, flags);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- float32

constexpr int FMA_O = 8, FMA_THREADS = 128;

__global__ void __launch_bounds__(FMA_THREADS)
    taps_fma_kernel(const float* __restrict__ x, int xcs, int cin, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ out, int ocs,
                    int ocoff, int cout, int b, int h, int wd, TapTable tbl, int flags) {
  const long long p = blockIdx.x * (long long)FMA_THREADS + threadIdx.x;
  if (p >= (long long)b * h * wd) return;
  const int n0 = blockIdx.y * FMA_O;
  const int px = (int)(p % wd), py = (int)((p / wd) % h);
  const long long img = p - (long long)py * wd - px;
  const int par = py & 1;
  const bool noshift = flags & NT_TAPS_NOSHIFT, matonly = flags & NT_TAPS_MATONLY;
  float acc[FMA_O], g[FMA_O];
  for (int o = 0; o < FMA_O; ++o) acc[o] = 0.f;
  bool fresh = true, has_bias = false;
  for (int i = 0; i < 9; ++i) {
    const int tap = tbl.order[par][i], gy = py + tap / 3 - 1, gx = px + tap % 3 - 1;
    if (fresh) {
      for (int o = 0; o < FMA_O; ++o) g[o] = 0.f;
      has_bias = false;
      fresh = false;
    }
    has_bias |= tap == 4;
    if (gy >= 0 && gy < h && gx >= 0 && gx < wd) {
      const float* src = x + (img + (long long)gy * wd + gx) * xcs;
      const float* wt = w + (long long)tap * cin * cout + n0;
      for (int c = 0; c < cin; ++c) {
        const float xv = src[c];
#pragma unroll
        for (int o = 0; o < FMA_O; ++o)
          if (n0 + o < cout) g[o] = __fmaf_rn(xv, wt[(long long)c * cout + o], g[o]);
      }
    }
    if (!((tbl.ends[par] >> i) & 1)) continue;
    for (int o = 0; o < FMA_O; ++o) {
      if (matonly) {
        acc[o] += g[o];
        continue;
      }
      const float v = has_bias && n0 + o < cout ? __fadd_rn(g[o], bias[n0 + o]) : g[o];
      if (!noshift) acc[o] = __fadd_rn(acc[o], v);
      else if (has_bias) acc[o] = v;
    }
    fresh = true;
  }
  float* dst = out + p * ocs + ocoff + n0;
  if (matonly) {
    if (n0 == 0 && px == 0) {
      float tok = 0.f;
      for (int o = 0; o < FMA_O; ++o) tok += acc[o];
      dst[0] = tok;
    }
    return;
  }
  for (int o = 0; o < FMA_O; ++o)
    if (n0 + o < cout) dst[o] = fmaxf(acc[o], 0.f);
}

}  // namespace

extern "C" int nt_rdb_taps_conv(const void* x, int x_cstride, int cin, const float* w,
                                const float* bias, void* out, int out_cstride,
                                int out_coff, int cout, int b, int h, int w_,
                                const int* table, int flags, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TapTable tbl;
  for (int p = 0; p < 2; ++p) {
    for (int i = 0; i < 9; ++i) {
      tbl.order[p][i] = table[p * 9 + i];
      if (tbl.order[p][i] < 0 || tbl.order[p][i] > 8) return (int)cudaErrorInvalidValue;
    }
    tbl.ends[p] = table[18 + p];
  }
  if (cin < 1 || cout < 1) return (int)cudaErrorInvalidValue;
  if (dtype == NT_F32) {
    const long long npix = (long long)b * h * w_;
    const dim3 grid((unsigned)((npix + FMA_THREADS - 1) / FMA_THREADS), (cout + FMA_O - 1) / FMA_O);
    taps_fma_kernel<<<grid, FMA_THREADS, 0, st>>>(
        static_cast<const float*>(x), x_cstride, cin, w, bias, static_cast<float*>(out),
        out_cstride, out_coff, cout, b, h, w_, tbl, flags);
    return (int)cudaGetLastError();
  }
  if (dtype != NT_BF16) return (int)cudaErrorInvalidValue;
  if (cout > 16 && smem_bytes_for<32>(cin) <= MAX_SMEM)
    return (int)launch_mma<32>(x, x_cstride, cin, w, bias, out, out_cstride, out_coff, cout,
                               b, h, w_, tbl, flags, st);
  if (smem_bytes_for<16>(cin) > MAX_SMEM) return (int)cudaErrorInvalidValue;
  return (int)launch_mma<16>(x, x_cstride, cin, w, bias, out, out_cstride, out_coff, cout, b,
                             h, w_, tbl, flags, st);
}
