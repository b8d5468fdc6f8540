// A whole chain of SAME 3x3 / 1x1 / depthwise 3x3 layers in one launch, on
// planar (B, C, H, W) input and output.
//
// Replaces nerve_tpu/ops/planar_chain.py `_planar_kernel` (reached via
// `_planar_pallas` <- `planar_chain_fused` <- `planar_chain_apply`).
// Numerics follow the reference formulation `_planar_xla`, which is
// `_chain_xla` on the NHWC view (conv_chain.py:411-443): per layer the sum
// in float32, rounded to the input dtype, the float32 bias, the activation,
// and a rounding to the input dtype. The Pallas kernel's dense-diagonal form
// of the depthwise layers (`_expand_dw_to_dense`) was a Mosaic workaround
// and is not copied: a depthwise layer here is nine per-channel FMAs.
//
// Bound: at the lightweight body at 1080p (3 -> 32, 4 x (dw3 32, 1x1 32),
// 32 -> 12) the chain does ~40 GFLOP (0.040 ms at the bf16 tensor-core
// peak) and must move only its input and output (~62 MB, 0.019 ms): the
// per-layer path instead writes and reads ~2.4 GB of 32-channel
// intermediates. So every intermediate stays in shared memory.
//
// Design. A block owns a TH x TW output tile and loads its input region,
// the tile plus a halo of one ring per 3x3 / depthwise layer, into shared
// memory as [pixel][channel] rows (channel stride ceil16(C) + 8 elements:
// 16-byte aligned, and the 8 rows one ldmatrix phase reads hit distinct
// banks). Two such buffers alternate between layers. The region is treated
// as a flat run of pixels: a 3x3 tap is a fixed offset (dy-1) * RW + (dx-1),
// and layer l computes the full rows [h_l, RH - h_l) of the region, h_l
// being the rings used so far. Pixels in the side columns of those rows
// come out wrong (their taps wrap to the neighbouring row), but no pixel
// that later layers need reads them: a layer's valid area shrinks by one
// ring per 3x3 layer, exactly as its inputs do. Out-of-image pixels are
// stored as zero after every layer, as SAME padding needs. The last layer
// writes the tile's pixels to the planar output in device memory.
//   * bfloat16 dense layers run on the tensor cores: each warp takes
//     16-pixel m-tiles, ldmatrix-loads them and the layer's weights
//     ([tap][out channel][in channel], staged per layer) and runs
//     mma.sync.m16n8k16 per tap and 16-channel chunk, sums in float32.
//     Channels past a layer's width are zero in the weights and biases, so
//     the padded channels of every buffer hold zeros.
//   * float32 dense layers (kept exact, no TF32) and every depthwise layer
//     run as FP32 FMAs on the CUDA cores; a depthwise thread owns one
//     16-byte channel vector of one pixel.
// Tile: 16 x 32 output pixels in bfloat16 for the lightweight body: its
// halo of 6 makes a 28 x 44 region (1.9x recompute over the layers, by
// FLOPs), and two 32-channel buffers of it plus the largest layer's weights
// take 216 KB of the 227 KB a block may use, so one block runs per SM with
// 16 warps. Larger tiles do not fit; smaller ones recompute more of the
// halo (8 x 32: 2.6x). The host picks the first tile of TILES that fits, so
// float32 and wider chains get smaller tiles.
// What the simple design gives up: wgmma, overlap of one layer's weight
// loads with the previous layer's math, a depthwise thread that reuses its
// vertical neighbours, and coalesced staging of the planar output.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "nerve_tpu_torch.h"

namespace {

constexpr int NTHREADS = 512, NWARPS = NTHREADS / 32;
constexpr int MAX_LAYERS = 16, MAX_C = 64;
constexpr int SLACK_F = 8, SLACK_B = 24;  // pixels before / after a buffer's region
constexpr int SMEM_LIMIT = 232448;
constexpr int TILES[][2] = {{16, 32}, {16, 16}, {8, 32}, {8, 16}, {8, 8}, {4, 8}, {2, 8}, {1, 8}};

enum { K3X3 = 0, K1X1 = 1, KDW3 = 2 };

struct Layer {
  int kind, cin, cout, relu, w_off, b_off;  // offsets in bytes into the weight pack
};
struct Chain {
  Layer l[MAX_LAYERS];
  int n, halo, smax, wmax, bmax;
};

__host__ __device__ constexpr int ceil16(int c) { return (c + 15) / 16 * 16; }
__host__ __device__ constexpr int row_stride(int c) { return ceil16(c) + 8; }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The reference's epilogue: round the sum, add the bias, activation, round.
template <typename T>
__device__ __forceinline__ T finish(float acc, float bias, int relu) {
  float v = __fadd_rn(to_f(from_f<T>(acc)), bias);
  if (relu) v = fmaxf(v, 0.f);
  return from_f<T>(v);
}

// Where layer outputs go: the next buffer (zero outside the image) or, for
// the last layer, the tile's pixels of the planar output.
template <typename T>
struct Sink {
  T* dst;       // next buffer, pixel 0; null for the last layer
  int stride;   // its channel stride
  T* out;       // planar output, image b
  int cout, h, wd, rw, halo, th, tw, y0, x0;

  // (row, column) of region pixel p, and whether it lies in the image.
  __device__ __forceinline__ bool in_image(int p, int& gy, int& gx) const {
    const int i = p / rw, j = p - i * rw;
    gy = y0 - halo + i;
    gx = x0 - halo + j;
    return gy >= 0 && gy < h && gx >= 0 && gx < wd;
  }
  __device__ __forceinline__ void put(int p, int n, T v) const {
    int gy, gx;
    const bool inside = in_image(p, gy, gx);
    if (dst) {
      dst[(long long)p * stride + n] = inside ? v : from_f<T>(0.f);
    } else if (inside && n < cout && gx >= x0 && gx < x0 + tw) {
      out[((long long)n * h + gy) * wd + gx] = v;
    }
  }
};

// One dense layer on the tensor cores (bfloat16). NT n8-tiles of output
// channels; weights sw [taps][NT * 8][ceil16(cin) + 8].
template <int NT>
__device__ void dense_mma(const __nv_bfloat16* src, int s_in, int cin16, int taps,
                          int rw, int p_begin, int p_end, const __nv_bfloat16* sw,
                          const float* sb, int relu, const Sink<__nv_bfloat16>& sink) {
  constexpr int NP = NT * 8;
  const int ks = cin16 + 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ntiles = (p_end - p_begin + 15) / 16;
  for (int t = warp; t < ntiles; t += NWARPS) {
    const int p0 = p_begin + 16 * t;
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[n][q] = 0.f;
    for (int tap = 0; tap < taps; ++tap) {
      const int off = taps == 9 ? (tap / 3 - 1) * rw + (tap % 3 - 1) : 0;
      const __nv_bfloat16* arow = src + (long long)(p0 + off + lane % 16) * s_in + (lane / 16) * 8;
      const __nv_bfloat16* wrow =
          sw + (tap * NP + (lane / 16) * 8 + lane % 8) * ks + ((lane / 8) % 2) * 8;
      for (int kc = 0; kc < cin16; kc += 16) {
        unsigned a[4];
        nt_ldmatrix_x4(arow + kc, a);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          unsigned bq[4];
          nt_ldmatrix_x4(wrow + np * 16 * ks + kc, bq);
          nt_mma_bf16(acc[2 * np], a, bq[0], bq[1]);
          nt_mma_bf16(acc[2 * np + 1], a, bq[2], bq[3]);
        }
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = p0 + lane / 4 + hf * 8;
      if (p >= p_end) continue;
#pragma unroll
      for (int n8 = 0; n8 < NT; ++n8) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n8 * 8 + (lane % 4) * 2 + j;
          sink.put(p, n, finish<__nv_bfloat16>(acc[n8][hf * 2 + j], sb[n], relu));
        }
      }
    }
  }
}

// One dense layer as FP32 FMAs: a thread per (pixel, output channel).
template <typename T>
__device__ void dense_fma(const T* src, int s_in, int cin, int np, int taps, int rw,
                          int p_begin, int p_end, const T* sw, const float* sb, int relu,
                          const Sink<T>& sink) {
  const int ks = ceil16(cin) + 8;
  for (int item = threadIdx.x; item < (p_end - p_begin) * np; item += NTHREADS) {
    const int n = item % np, p = p_begin + item / np;
    float acc = 0.f;
    for (int tap = 0; tap < taps; ++tap) {
      const int off = taps == 9 ? (tap / 3 - 1) * rw + (tap % 3 - 1) : 0;
      const T* a = src + (long long)(p + off) * s_in;
      const T* wr = sw + (tap * np + n) * ks;
      for (int ci = 0; ci < cin; ++ci) acc = fmaf(to_f(a[ci]), to_f(wr[ci]), acc);
    }
    sink.put(p, n, finish<T>(acc, sb[n], relu));
  }
}

// One depthwise layer: a thread per (pixel, 16-byte channel vector);
// weights swf [9][ceil16(c)] float32.
template <typename T>
__device__ void depthwise(const T* src, int s_in, int c16, int rw, int p_begin, int p_end,
                          const float* swf, const float* sb, int relu, const Sink<T>& sink) {
  constexpr int VEC = 16 / sizeof(T);
  const int cv = c16 / VEC;
  for (int item = threadIdx.x; item < (p_end - p_begin) * cv; item += NTHREADS) {
    const int k = item % cv, p = p_begin + item / cv;
    float acc[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3 - 1) * rw + (tap % 3 - 1);
      alignas(16) T v[VEC];
      *reinterpret_cast<uint4*>(v) =
          *reinterpret_cast<const uint4*>(src + (long long)(p + off) * s_in + k * VEC);
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = fmaf(to_f(v[q]), swf[tap * c16 + k * VEC + q], acc[q]);
    }
    if (sink.dst) {
      int gy, gx;
      const bool inside = sink.in_image(p, gy, gx);
      alignas(16) T o[VEC];
#pragma unroll
      for (int q = 0; q < VEC; ++q)
        o[q] = inside ? finish<T>(acc[q], sb[k * VEC + q], relu) : from_f<T>(0.f);
      *reinterpret_cast<uint4*>(sink.dst + (long long)p * sink.stride + k * VEC) =
          *reinterpret_cast<uint4*>(o);
    } else {
#pragma unroll
      for (int q = 0; q < VEC; ++q)
        sink.put(p, k * VEC + q, finish<T>(acc[q], sb[k * VEC + q], relu));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
    planar_chain_kernel(const T* __restrict__ x, T* __restrict__ out,
                        const unsigned char* __restrict__ wpack, const Chain ch, int h,
                        int wd, int th, int tw) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int halo = ch.halo, rh = th + 2 * halo, rw = tw + 2 * halo, npix = rh * rw;
  const int buf_elems = (SLACK_F + npix + SLACK_B) * ch.smax;
  T* bufs[2] = {reinterpret_cast<T*>(smem), reinterpret_cast<T*>(smem) + buf_elems};
  unsigned char* wsm = smem + 2 * buf_elems * sizeof(T);
  float* sb = reinterpret_cast<float*>(wsm + ch.wmax);
  const int x0 = blockIdx.x * tw, y0 = blockIdx.y * th, b = blockIdx.z;
  const int c0 = ch.l[0].cin, cout = ch.l[ch.n - 1].cout;

  // Both buffers zeroed, then the input region with its channels padded.
  for (int i = threadIdx.x; i < 2 * buf_elems * (int)sizeof(T) / 16; i += NTHREADS)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  {
    const int s0 = row_stride(c0);
    T* base = bufs[0] + SLACK_F * s0;
    const T* xb = x + (long long)b * c0 * h * wd;
    for (int i = threadIdx.x; i < c0 * npix; i += NTHREADS) {
      const int c = i / npix, q = i - c * npix, r = q / rw;
      const int gy = y0 - halo + r, gx = x0 - halo + q - r * rw;
      if (gy >= 0 && gy < h && gx >= 0 && gx < wd)
        base[(long long)q * s0 + c] = xb[((long long)c * h + gy) * wd + gx];
    }
  }

  int hl = 0;
  for (int li = 0; li < ch.n; ++li) {
    const Layer L = ch.l[li];
    const bool last = li == ch.n - 1;
    const int taps = L.kind == K3X3 ? 9 : 1, cin16 = ceil16(L.cin), np = ceil16(L.cout);
    const int wbytes = L.kind == KDW3 ? 9 * cin16 * 4 : taps * np * (cin16 + 8) * (int)sizeof(T);
    if (L.kind != K1X1) ++hl;
    __syncthreads();  // the previous layer is done with the weights and its buffers
    for (int i = threadIdx.x; i < wbytes / 16; i += NTHREADS)
      reinterpret_cast<uint4*>(wsm)[i] = reinterpret_cast<const uint4*>(wpack + L.w_off)[i];
    for (int i = threadIdx.x; i < np; i += NTHREADS)
      sb[i] = reinterpret_cast<const float*>(wpack + L.b_off)[i];
    __syncthreads();

    const int s_in = row_stride(L.cin), s_out = row_stride(L.cout);
    const T* src = bufs[li % 2] + SLACK_F * s_in;
    const Sink<T> sink{last ? nullptr : bufs[(li + 1) % 2] + SLACK_F * s_out, s_out,
                       out + (long long)b * cout * h * wd, cout, h, wd, rw, halo, th, tw, y0,
                       x0};
    const int p_begin = hl * rw, p_end = (rh - hl) * rw;
    if (L.kind == KDW3) {
      depthwise<T>(src, s_in, cin16, rw, p_begin, p_end, reinterpret_cast<const float*>(wsm),
                   sb, L.relu, sink);
    } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      const __nv_bfloat16* sw = reinterpret_cast<const __nv_bfloat16*>(wsm);
      switch (np / 8) {
        case 2: dense_mma<2>(src, s_in, cin16, taps, rw, p_begin, p_end, sw, sb, L.relu, sink); break;
        case 4: dense_mma<4>(src, s_in, cin16, taps, rw, p_begin, p_end, sw, sb, L.relu, sink); break;
        case 6: dense_mma<6>(src, s_in, cin16, taps, rw, p_begin, p_end, sw, sb, L.relu, sink); break;
        default: dense_mma<8>(src, s_in, cin16, taps, rw, p_begin, p_end, sw, sb, L.relu, sink); break;
      }
    } else {
      dense_fma<T>(src, s_in, L.cin, np, taps, rw, p_begin, p_end, reinterpret_cast<const T*>(wsm),
                   sb, L.relu, sink);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, const void* wpack, const int* layers, int nl,
                   int b, int h, int wd, cudaStream_t stream) {
  if (nl < 1 || nl > MAX_LAYERS) return cudaErrorInvalidValue;
  Chain ch{};
  ch.n = nl;
  ch.smax = row_stride(layers[1]);  // the input's channels
  for (int i = 0; i < nl; ++i) {
    Layer& L = ch.l[i];
    const int* d = layers + 6 * i;
    L = Layer{d[0], d[1], d[2], d[3], d[4], d[5]};
    if (L.kind < K3X3 || L.kind > KDW3 || L.cin < 1 || L.cout < 1 || L.cin > MAX_C ||
        L.cout > MAX_C || (L.kind == KDW3 && L.cin != L.cout) ||
        (i > 0 && L.cin != ch.l[i - 1].cout) || L.w_off % 16 || L.b_off % 16)
      return cudaErrorInvalidValue;
    const int taps = L.kind == K3X3 ? 9 : 1, cin16 = ceil16(L.cin), np = ceil16(L.cout);
    const int wbytes = L.kind == KDW3 ? 9 * cin16 * 4 : taps * np * (cin16 + 8) * (int)sizeof(T);
    ch.halo += L.kind != K1X1;
    ch.wmax = wbytes > ch.wmax ? wbytes : ch.wmax;
    ch.bmax = np * 4 > ch.bmax ? np * 4 : ch.bmax;
    if (i < nl - 1 && row_stride(L.cout) > ch.smax) ch.smax = row_stride(L.cout);
  }
  for (const auto& tile : TILES) {
    const int th = tile[0], tw = tile[1];
    const long long npix = (long long)(th + 2 * ch.halo) * (tw + 2 * ch.halo);
    const long long smem =
        2 * (SLACK_F + npix + SLACK_B) * ch.smax * (long long)sizeof(T) + ch.wmax + ch.bmax;
    if (smem > SMEM_LIMIT) continue;
    cudaError_t err = cudaFuncSetAttribute(
        planar_chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((wd + tw - 1) / tw, (h + th - 1) / th, b);
    planar_chain_kernel<T><<<grid, NTHREADS, smem, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out),
        static_cast<const unsigned char*>(wpack), ch, h, wd, th, tw);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;  // not even the smallest tile fits
}

}  // namespace

extern "C" int nt_planar_chain(const void* x, void* out, const void* wpack, const int* layers,
                               int nl, int b, int h, int w_, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == NT_BF16)
    return (int)launch<__nv_bfloat16>(x, out, wpack, layers, nl, b, h, w_, st);
  if (dtype == NT_F32) return (int)launch<float>(x, out, wpack, layers, nl, b, h, w_, st);
  return (int)cudaErrorInvalidValue;
}
