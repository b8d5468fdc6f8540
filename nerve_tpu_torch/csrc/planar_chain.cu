// A whole chain of SAME 3x3 / 1x1 / depthwise 3x3 layers in one launch, on
// planar (B, C, H, W) input and output.
//
// Replaces nerve_tpu/ops/planar_chain.py `_planar_kernel` (reached via
// `_planar_pallas` <- `planar_chain_fused` <- `planar_chain_apply`).
// Numerics follow the reference formulation `_planar_xla`, which is
// `_chain_xla` on the NHWC view (conv_chain.py:411-443): per layer the sum
// in float32, rounded to the input dtype, the float32 bias, the activation,
// and a rounding to the input dtype. The Pallas kernel ran the depthwise
// layers as dense diagonal matrices (`_expand_dw_to_dense`); the bfloat16
// kernel here runs them on the tensor cores too, as one 16 x 16 diagonal
// block per 16-channel chunk and tap, the float32 one as per-channel FMAs.
//
// Bound: at the lightweight body at 1080p (3 -> 32, 4 x (dw3 32, 1x1 32),
// 32 -> 12) the chain does ~40 GFLOP (0.040 ms at the bf16 tensor-core
// peak) and must move only its input and output (~62 MB, 0.019 ms): the
// per-layer path instead writes and reads ~2.4 GB of 32-channel
// intermediates. So every intermediate stays in shared memory. What holds
// the kernel far above that bound is latency: 12 warps a SM (the registers
// of the weights held per stage), product chains that depend tap on tap in
// each 16-pixel m-tile, a barrier per stage, and the halo recomputed around
// each tile.
//
// Region. A block computes a TH x TW output tile from its input region, the
// tile plus a halo of one ring per 3x3 / depthwise layer, held in shared
// memory as [pixel][channel] rows (channel stride ceil16(C) + 8 elements:
// 16-byte aligned, the 8 rows one ldmatrix phase reads and the (pixel,
// channel pair) words a warp's fragment loads and stores touch all hit
// distinct banks). Two such buffers alternate between stages. The region is
// a flat run of pixels: a 3x3 tap is a fixed offset (dy-1) * RW + (dx-1),
// and a stage computes the full rows [h, RH - h) of the region, h being the
// rings used so far. Pixels in the side columns of those rows come out
// wrong (their taps wrap to the neighbouring row), but no pixel that later
// stages need reads them. Out-of-image pixels are stored as zero after
// every stage, as SAME padding needs. The last stage computes only the
// tile's own pixels (16-pixel row pieces; TW is a multiple of 16).
//
// bfloat16 (the serving path), one launch:
//   * Persistent blocks, one per SM (384 threads, 12 warps), walk the
//     output tiles. Each copies the whole chain's weights and biases (the
//     pack of ops/planar_chain.py, ~30 KB for the lightweight body) into
//     shared memory once, by one bulk copy.
//   * The input region arrives by TMA as a planar [C0][RH][RWP] box whose
//     zero fill outside the image is the first layer's SAME padding; it
//     starts XOFF columns left of the region so that its first column is a
//     multiple of 8 (TMA faults on an innermost start coordinate that is
//     not 16-byte aligned), and RWP = ceil8(RW + XOFF). Two staging buffers
//     on two mbarriers let tile t + 1's load run under tile t's stages.
//   * A first 3x3 layer of at most 3 channels (the lightweight head) is one
//     product over K = 9 * 3 = 27 -> 32, its A fragment gathered from the
//     planar box (k = c * 9 + tap), instead of 9 taps x K = 16. Any other
//     first layer reads the box transposed once into a pixel buffer.
//   * Each (depthwise, 1x1) pair is one stage: a warp computes the
//     depthwise sums of its 16-pixel m-tile on the tensor cores (nine
//     products per 16-channel chunk with the taps' diagonal blocks, summed
//     in float32), whose accumulator layout is the 1x1 product's A
//     fragment: each sum is rounded, gets its bias and activation and is
//     rounded again (the reference's contract) in registers, and the 1x1
//     runs at once: one pass through shared memory and one barrier per
//     pair. A stage's diagonal blocks and the 1x1's B fragments sit in
//     registers for chains up to 32 channels. (Nine per-channel FMAs on the
//     CUDA cores cost a shared-memory word and two integer unpacks per two
//     FMAs; the tensor cores take the whole tap from one ldmatrix.) On
//     finite values the sums are the reference's; the diagonal blocks add
//     0 * x for a pixel's 15 other channels of the chunk, so an Inf or NaN
//     in one channel of a pixel makes that pixel's whole 16-channel chunk
//     NaN, where the reference keeps it to its own channel.
//   * Dense layers run mma.sync.m16n8k16 per tap and 16-channel chunk.
//   * The last stage writes its tile into a planar [Cout][TH][TW] staging
//     area, stored by one TMA store whose tensor map clips the ragged edge;
//     the store runs under the next tile's stages.
// Tile: the first of BF16_TILES whose buffers, staging areas and the whole
// weight pack fit. A chain for which none does (a pack too large to keep:
// a 3 -> 64 head and three 64 -> 64 3x3 layers need ~255 KB) runs on the
// per-tile kernel below instead, which stages one layer's weights at a
// time and so runs every chain the first port ran. The lightweight body
// takes 12 x 32 (region 24 x 44, 227 KB of shared memory): 1.66x its
// FLOPs are computed, the halo's share (the first port's 16 x 32 tile,
// whose every layer computed full-width rows, 1.9x); 16 x 16 tiles (2.1x)
// ran slower.
// mma.sync rather than wgmma: the pair's A operand is made in registers
// one warp's 16 pixels at a time, which is mma.sync's fragment; the tensor
// cores' share of the work (~0.04 ms at peak) is not what bounds the chain.
// Not taken: a column strip walked downwards with each layer keeping its
// last two rows (no vertical halo): it needs a ring of rows per stage (five
// for the lightweight body, more shared memory than two region buffers at
// useful widths) and a barrier per stage per row.
//
// The per-tile kernel (planar_tile_kernel) is the first port's design: one
// block per output tile, each layer's weights staged in turn, dense layers
// as FP32 FMAs (float32) or mma.sync per tap (bfloat16), depthwise layers
// and a folded head as FP32 FMAs. It runs float32 (parity tests only, on no
// serving path) and the bfloat16 chains the persistent kernel cannot hold.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "nerve_tpu_torch.h"

namespace {

constexpr int MAX_LAYERS = 16, MAX_C = 64;
constexpr int SLACK_F = 8, SLACK_B = 24;  // pixels before / after a buffer's region
constexpr int HEAD_KS = 40;  // a folded head's weight row: K = 32, + 8

enum { K3X3 = 0, K1X1 = 1, KDW3 = 2, K3X3_HEAD = 3 };  // layer kinds of the table

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int ceil16(int c) { return (c + 15) / 16 * 16; }
__host__ __device__ constexpr int row_stride(int c) { return ceil16(c) + 8; }
constexpr int align128(long long v) { return (int)((v + 127) / 128 * 128); }

struct Layer {
  int kind, cin, cout, relu, w_off, b_off;  // offsets in bytes into the weight pack
};

// Bytes of a layer's weights in the pack (its biases follow at b_off).
__host__ __device__ inline int layer_wbytes(const Layer& L, int esize) {
  const int cin16 = ceil16(L.cin), np = ceil16(L.cout);
  if (L.kind == KDW3) return 9 * cin16 * 4;
  if (L.kind == K3X3_HEAD) return np * HEAD_KS * esize;
  return (L.kind == K3X3 ? 9 : 1) * np * (cin16 + 8) * esize;
}

// ------------------------------------------------------------------------ //
// One block per tile, each layer's weights staged in turn
// ------------------------------------------------------------------------ //
constexpr int F_THREADS = 512, F_WARPS = F_THREADS / 32;
constexpr int F_TILES[][2] = {{16, 32}, {16, 16}, {8, 32}, {8, 16}, {8, 8}, {4, 8}, {2, 8}, {1, 8}};

struct Chain {
  Layer l[MAX_LAYERS];
  int n, halo, smax, wmax, bmax;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// The reference's epilogue: round the sum, add the bias, activation, round.
template <typename T>
__device__ __forceinline__ T finish(float acc, float bias, int relu) {
  float v = __fadd_rn(to_f(from_f<T>(acc)), bias);
  if (relu) v = fmaxf(v, 0.f);
  return from_f<T>(v);
}

// Where layer outputs go: the next buffer (zero outside the image) or, for
// the last layer, the tile's pixels of the planar output (rows ws apart).
template <typename T>
struct TileSink {
  T* dst;       // next buffer, pixel 0; null for the last layer
  int stride;   // its channel stride
  T* out;       // planar output, image b
  int cout, h, wd, ws, rw, halo, th, tw, y0, x0;

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
      out[((long long)n * h + gy) * ws + gx] = v;
    }
  }
};

// One dense bfloat16 layer on the tensor cores. NT n8-tiles of output
// channels; weights sw [taps][NT * 8][ceil16(cin) + 8].
template <int NT>
__device__ void dense_mma(const bf16* src, int s_in, int cin16, int taps, int rw, int p_begin,
                          int p_end, const bf16* sw, const float* sb, int relu,
                          const TileSink<bf16>& sink) {
  constexpr int NP = NT * 8;
  const int ks = cin16 + 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ntiles = (p_end - p_begin + 15) / 16;
  for (int t = warp; t < ntiles; t += F_WARPS) {
    const int p0 = p_begin + 16 * t;
    float acc[NT][4] = {};
    for (int tap = 0; tap < taps; ++tap) {
      const int off = taps == 9 ? (tap / 3 - 1) * rw + (tap % 3 - 1) : 0;
      const bf16* arow = src + (long long)(p0 + off + lane % 16) * s_in + (lane / 16) * 8;
      const bf16* wrow = sw + (tap * NP + (lane / 16) * 8 + lane % 8) * ks + ((lane / 8) % 2) * 8;
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
      for (int n8 = 0; n8 < NT; ++n8)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n8 * 8 + (lane % 4) * 2 + j;
          sink.put(p, n, finish<bf16>(acc[n8][hf * 2 + j], sb[n], relu));
        }
    }
  }
}

// One dense layer as FP32 FMAs: a thread per (pixel, output channel); the
// weight of (tap, n, ci) at sw[tap * ts + n * ns + ci * cs].
template <typename T>
__device__ void dense_fma(const T* src, int s_in, int cin, int np, int taps, int rw, int p_begin,
                          int p_end, const T* sw, int ts, int ns, int cs, const float* sb,
                          int relu, const TileSink<T>& sink) {
  for (int item = threadIdx.x; item < (p_end - p_begin) * np; item += F_THREADS) {
    const int n = item % np, p = p_begin + item / np;
    float acc = 0.f;
    for (int tap = 0; tap < taps; ++tap) {
      const int off = taps == 9 ? (tap / 3 - 1) * rw + (tap % 3 - 1) : 0;
      const T* a = src + (long long)(p + off) * s_in;
      const T* wr = sw + tap * ts + n * ns;
      for (int ci = 0; ci < cin; ++ci) acc = fmaf(to_f(a[ci]), to_f(wr[ci * cs]), acc);
    }
    sink.put(p, n, finish<T>(acc, sb[n], relu));
  }
}

// One depthwise layer: a thread per (pixel, 16-byte channel vector);
// weights swf [9][ceil16(c)] float32.
template <typename T>
__device__ void depthwise(const T* src, int s_in, int c16, int rw, int p_begin, int p_end,
                          const float* swf, const float* sb, int relu, const TileSink<T>& sink) {
  constexpr int VEC = 16 / sizeof(T);
  const int cv = c16 / VEC;
  for (int item = threadIdx.x; item < (p_end - p_begin) * cv; item += F_THREADS) {
    const int k = item % cv, p = p_begin + item / cv;
    float acc[VEC] = {};
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3 - 1) * rw + (tap % 3 - 1);
      alignas(16) T v[VEC];
      *reinterpret_cast<uint4*>(v) =
          *reinterpret_cast<const uint4*>(src + (long long)(p + off) * s_in + k * VEC);
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = fmaf(to_f(v[q]), swf[tap * c16 + k * VEC + q], acc[q]);
    }
#pragma unroll
    for (int q = 0; q < VEC; ++q)
      sink.put(p, k * VEC + q, finish<T>(acc[q], sb[k * VEC + q], relu));
  }
}

template <typename T>
__global__ void __launch_bounds__(F_THREADS, 1)
    planar_tile_kernel(const T* __restrict__ x, T* __restrict__ out,
                       const unsigned char* __restrict__ wpack, const Chain ch, int h, int wd,
                       int ws, int th, int tw) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int halo = ch.halo, rh = th + 2 * halo, rw = tw + 2 * halo, npix = rh * rw;
  const int buf_elems = (SLACK_F + npix + SLACK_B) * ch.smax;
  T* bufs[2] = {reinterpret_cast<T*>(smem), reinterpret_cast<T*>(smem) + buf_elems};
  unsigned char* wsm = smem + 2 * buf_elems * sizeof(T);
  float* sb = reinterpret_cast<float*>(wsm + ch.wmax);
  const int x0 = blockIdx.x * tw, y0 = blockIdx.y * th, b = blockIdx.z;
  const int c0 = ch.l[0].cin, cout = ch.l[ch.n - 1].cout;

  // Both buffers zeroed, then the input region with its channels padded.
  for (int i = threadIdx.x; i < 2 * buf_elems * (int)sizeof(T) / 16; i += F_THREADS)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  {
    const int s0 = row_stride(c0);
    T* base = bufs[0] + SLACK_F * s0;
    const T* xb = x + (long long)b * c0 * h * ws;
    for (int i = threadIdx.x; i < c0 * npix; i += F_THREADS) {
      const int c = i / npix, q = i - c * npix, r = q / rw;
      const int gy = y0 - halo + r, gx = x0 - halo + q - r * rw;
      if (gy >= 0 && gy < h && gx >= 0 && gx < wd)
        base[(long long)q * s0 + c] = xb[((long long)c * h + gy) * ws + gx];
    }
  }

  int hl = 0;
  for (int li = 0; li < ch.n; ++li) {
    const Layer L = ch.l[li];
    const bool last = li == ch.n - 1;
    const int taps = L.kind == K1X1 ? 1 : 9, cin16 = ceil16(L.cin), np = ceil16(L.cout);
    const int wbytes = layer_wbytes(L, sizeof(T));
    if (L.kind != K1X1) ++hl;
    __syncthreads();  // the previous layer is done with the weights and its buffers
    for (int i = threadIdx.x; i < wbytes / 16; i += F_THREADS)
      reinterpret_cast<uint4*>(wsm)[i] = reinterpret_cast<const uint4*>(wpack + L.w_off)[i];
    for (int i = threadIdx.x; i < np; i += F_THREADS)
      sb[i] = reinterpret_cast<const float*>(wpack + L.b_off)[i];
    __syncthreads();

    const int s_in = row_stride(L.cin), s_out = row_stride(L.cout);
    const T* src = bufs[li % 2] + SLACK_F * s_in;
    const TileSink<T> sink{last ? nullptr : bufs[(li + 1) % 2] + SLACK_F * s_out, s_out,
                           out + (long long)b * cout * h * ws, cout, h, wd, ws, rw, halo, th, tw,
                           y0, x0};
    const int p_begin = hl * rw, p_end = (rh - hl) * rw;
    const T* sw = reinterpret_cast<const T*>(wsm);
    if (L.kind == KDW3) {
      depthwise<T>(src, s_in, cin16, rw, p_begin, p_end, reinterpret_cast<const float*>(wsm),
                   sb, L.relu, sink);
    } else if (L.kind == K3X3_HEAD) {  // weights [np][HEAD_KS], column c * 9 + tap
      dense_fma<T>(src, s_in, L.cin, np, 9, rw, p_begin, p_end, sw, 1, HEAD_KS, 9, sb, L.relu,
                   sink);
    } else if constexpr (std::is_same<T, bf16>::value) {
      switch (np / 8) {
        case 2: dense_mma<2>(src, s_in, cin16, taps, rw, p_begin, p_end, sw, sb, L.relu, sink); break;
        case 4: dense_mma<4>(src, s_in, cin16, taps, rw, p_begin, p_end, sw, sb, L.relu, sink); break;
        case 6: dense_mma<6>(src, s_in, cin16, taps, rw, p_begin, p_end, sw, sb, L.relu, sink); break;
        default: dense_mma<8>(src, s_in, cin16, taps, rw, p_begin, p_end, sw, sb, L.relu, sink); break;
      }
    } else {
      dense_fma<T>(src, s_in, L.cin, np, taps, rw, p_begin, p_end, sw, np * (cin16 + 8),
                   cin16 + 8, 1, sb, L.relu, sink);
    }
  }
}

template <typename T>
cudaError_t launch_tile(const void* x, void* out, const void* wpack, const Layer* layers, int nl,
                        int b, int h, int wd, int ws, cudaStream_t stream) {
  Chain ch{};
  ch.n = nl;
  ch.smax = row_stride(layers[0].cin);
  for (int i = 0; i < nl; ++i) {
    const Layer& L = ch.l[i] = layers[i];
    const int wbytes = layer_wbytes(L, sizeof(T)), np = ceil16(L.cout);
    ch.halo += L.kind != K1X1;
    ch.wmax = wbytes > ch.wmax ? wbytes : ch.wmax;
    ch.bmax = np * 4 > ch.bmax ? np * 4 : ch.bmax;
    if (i < nl - 1 && row_stride(L.cout) > ch.smax) ch.smax = row_stride(L.cout);
  }
  NtDeviceLimits lim;
  cudaError_t err = nt_device_limits(lim);
  if (err != cudaSuccess) return err;
  static bool configured[64] = {};
  for (const auto& tile : F_TILES) {
    const int th = tile[0], tw = tile[1];
    const long long npix = (long long)(th + 2 * ch.halo) * (tw + 2 * ch.halo);
    const long long smem =
        2 * (SLACK_F + npix + SLACK_B) * ch.smax * (long long)sizeof(T) + ch.wmax + ch.bmax;
    if (smem > lim.smem) continue;
    int dev;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if (!configured[dev]) {
      err = cudaFuncSetAttribute(planar_tile_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, lim.smem);
      if (err != cudaSuccess) return err;
      configured[dev] = true;
    }
    const dim3 grid((wd + tw - 1) / tw, (h + th - 1) / th, b);
    planar_tile_kernel<T><<<grid, F_THREADS, smem, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out),
        static_cast<const unsigned char*>(wpack), ch, h, wd, ws, th, tw);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;  // not even the smallest tile fits
}

// ------------------------------------------------------------------------ //
// bfloat16: persistent blocks, TMA in and out, fused (depthwise, 1x1) pairs
// ------------------------------------------------------------------------ //
constexpr int BT = 384, BW = BT / 32;  // threads and warps of a block
// Output tiles (rows, columns) in order of preference; columns a multiple of 16.
constexpr int BF16_TILES[][2] = {{16, 32}, {12, 32}, {16, 16}, {8, 32},
                                 {8, 16},  {4, 16},  {2, 16},  {1, 16}};

enum { ST_DENSE = 0, ST_HEAD = 1, ST_DW = 2, ST_PAIR = 3 };

// One pass over the region: a dense layer, the folded head, a depthwise
// layer alone, or a depthwise layer with the 1x1 layer after it.
struct Stage {
  int kind, taps, h;                  // dense taps (9 or 1); rows [h, rh - h) computed
  int cin, cout, relu, w_off, b_off;  // the layer it writes (a pair's 1x1)
  int dw_w, dw_b, dw_relu;            // ST_DW, ST_PAIR: the depthwise layer
};

struct Plan {
  Stage st[MAX_LAYERS];
  int ns, c0, cout, halo, th, tw, rh, rw, smax, transpose;
  int rwp, xoff;   // the input box: rwp columns from xoff left of the region
  int h, w, tiles_x, tiles_y, ntiles;
  unsigned magic;  // p / rw == __umulhi(p, magic) for the region's pixels
  int wbytes, off_stg, stg_bytes, off_buf, buf_bytes, off_out, off_bar;
};

// What the stages read of the plan, copied into registers once per block.
struct Geo {
  int h, w, halo, th, tw, rh, rw, rwp, xoff, smax, cout;
  unsigned magic;
};

__device__ __forceinline__ unsigned pack2(bf16 lo, bf16 hi) {
  return (unsigned)__bfloat16_as_ushort(lo) | ((unsigned)__bfloat16_as_ushort(hi) << 16);
}
__device__ __forceinline__ unsigned round2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ float lo_f(unsigned v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f(unsigned v) { return __uint_as_float(v & 0xffff0000u); }
// The reference's epilogue on two channels' sums: round each to bf16, add
// the float32 bias, activation, round; returned as a bf16 pair (lo first).
__device__ __forceinline__ unsigned finish2(float a0, float a1, const float (&bias)[2], int relu) {
  const unsigned r = round2(a0, a1);
  float v0 = __fadd_rn(lo_f(r), bias[0]), v1 = __fadd_rn(hi_f(r), bias[1]);
  if (relu) {
    v0 = fmaxf(v0, 0.f);
    v1 = fmaxf(v1, 0.f);
  }
  return round2(v0, v1);
}

// A pixel of an m-tile, as the stage's sink needs it.
struct Px {
  int p;        // flat index in the region
  int o;        // index in the output stage (the last stage)
  bool keep;    // the stage stores it
  bool inside;  // it lies in the image
};

// Where a stage's values go: the next buffer (zero outside the image), or
// the planar output stage [cout][th][tw] for the last stage.
struct Sink {
  bf16* dst;
  int stride;
  bf16* ostg;
  int cout, plane;

  // Channels n, n + 1 of a pixel, a bf16 pair (n first).
  __device__ __forceinline__ void put(const Px& px, int n, unsigned v) const {
    if (!px.keep) return;
    if (dst) {
      *reinterpret_cast<unsigned*>(dst + px.p * stride + n) = px.inside ? v : 0u;
    } else {
      if (n < cout) ostg[n * plane + px.o] = __ushort_as_bfloat16((unsigned short)(v & 0xffffu));
      if (n + 1 < cout) ostg[(n + 1) * plane + px.o] = __ushort_as_bfloat16((unsigned short)(v >> 16));
    }
  }
};

// The pixels of m-tiles: a flat run [p_begin, p_end) of the region, or
// (rect) the tile's own rows in 16-pixel pieces.
struct Walk {
  int p_begin, p_end, nmt, rect, y0, x0;

  __device__ __forceinline__ int p0(const Geo& G, int mt) const {
    if (!rect) return p_begin + 16 * mt;
    const int per_row = G.tw / 16, r = mt / per_row;
    return (G.halo + r) * G.rw + G.halo + 16 * (mt - r * per_row);
  }
  __device__ __forceinline__ Px pixel(const Geo& G, int p) const {
    const int i = __umulhi((unsigned)p, G.magic), j = p - i * G.rw;
    const int gy = y0 - G.halo + i, gx = x0 - G.halo + j;
    return Px{p, (i - G.halo) * G.tw + (j - G.halo), rect || p < p_end,
              gy >= 0 && gy < G.h && gx >= 0 && gx < G.w};
  }
};

// B fragments of n8 tiles 2 np and 2 np + 1, k16 chunk kc, tap `tap` of
// weights [taps][NP][ks].
__device__ __forceinline__ void load_b(const bf16* sw, int tap, int NP, int ks, int np, int kc,
                                       unsigned (&bq)[4]) {
  const int lane = threadIdx.x % 32;
  nt_ldmatrix_x4(sw + (tap * NP + np * 16 + (lane / 16) * 8 + lane % 8) * ks +
                     ((lane / 8) % 2) * 8 + kc * 16,
                 bq);
}

// This thread's bias pairs of an accumulator's NT n8 tiles (channels 8 n8 + 2 t, + 1).
template <int NT>
__device__ __forceinline__ void load_bias(const float* sb, float (&bias)[NT][2]) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int n8 = 0; n8 < NT; ++n8) {
    bias[n8][0] = sb[n8 * 8 + 2 * t];
    bias[n8][1] = sb[n8 * 8 + 2 * t + 1];
  }
}

template <int NT>
__device__ __forceinline__ void store_acc(const float (&acc)[NT][4], const float (&bias)[NT][2],
                                          int relu, const Px& pa, const Px& pb, const Sink& sink) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int n8 = 0; n8 < NT; ++n8) {
    const int n = n8 * 8 + 2 * t;
    sink.put(pa, n, finish2(acc[n8][0], acc[n8][1], bias[n8], relu));
    sink.put(pb, n, finish2(acc[n8][2], acc[n8][3], bias[n8], relu));
  }
}

// A dense 3x3 or 1x1 layer: A by ldmatrix from the pixel buffer.
template <int NT>
__device__ void stage_dense(const Geo& G, const Stage& S, const bf16* src,
                            const unsigned char* wsm, const Sink& sink, const Walk& wk) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cin16 = ceil16(S.cin), ks = cin16 + 8, s_in = G.smax;
  const bf16* sw = reinterpret_cast<const bf16*>(wsm + S.w_off);
  float bias[NT][2];
  load_bias<NT>(reinterpret_cast<const float*>(wsm + S.b_off), bias);
  for (int mt = warp; mt < wk.nmt; mt += BW) {
    const int p0 = wk.p0(G, mt);
    float acc[NT][4] = {};
    for (int tap = 0; tap < S.taps; ++tap) {
      const int off = S.taps == 9 ? (tap / 3 - 1) * G.rw + (tap % 3 - 1) : 0;
      const bf16* arow = src + (p0 + off + lane % 16) * s_in + (lane / 16) * 8;
      for (int kc = 0; kc < cin16 / 16; ++kc) {
        unsigned a[4];
        nt_ldmatrix_x4(arow + kc * 16, a);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          unsigned bq[4];
          load_b(sw, tap, NT * 8, ks, np, kc, bq);
          nt_mma_bf16(acc[2 * np], a, bq[0], bq[1]);
          nt_mma_bf16(acc[2 * np + 1], a, bq[2], bq[3]);
        }
      }
    }
    store_acc<NT>(acc, bias, S.relu, wk.pixel(G, p0 + lane / 4),
                  wk.pixel(G, p0 + lane / 4 + 8), sink);
  }
}

// The folded head: a 3x3 layer of cin <= 3 channels as one product over
// K = 32, k = c * 9 + tap, A gathered from the planar input box.
template <int NT>
__device__ void stage_head(const Geo& G, const Stage& S, const bf16* stg,
                           const unsigned char* wsm, const Sink& sink, const Walk& wk) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const bf16* sw = reinterpret_cast<const bf16*>(wsm + S.w_off);
  float bias[NT][2];
  load_bias<NT>(reinterpret_cast<const float*>(wsm + S.b_off), bias);
  // This thread's eight k: chunk kc, element e -> 16 kc + 2 t + (e & 1) + 8 (e >> 1);
  // their offsets in the box from the pixel, and which of them are < 9 cin.
  int koff[2][4];
  bool kuse[2][4];
#pragma unroll
  for (int kc = 0; kc < 2; ++kc)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 16 * kc + 2 * t + (e & 1) + 8 * (e >> 1), c = k / 9, tap = k % 9;
      kuse[kc][e] = k < 9 * S.cin;
      koff[kc][e] = c * G.rh * G.rwp + (tap / 3 - 1) * G.rwp + (tap % 3 - 1);
    }
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int mt = warp; mt < wk.nmt; mt += BW) {
    const int p0 = wk.p0(G, mt);
    int sbase[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = p0 + lane / 4 + 8 * hf, i = __umulhi((unsigned)p, G.magic);
      sbase[hf] = i * G.rwp + p - i * G.rw + G.xoff;
    }
    float acc[NT][4] = {};
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {
      bf16 v[2][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[hf][e] = kuse[kc][e] ? stg[sbase[hf] + koff[kc][e]] : zero;
      const unsigned a[4] = {pack2(v[0][0], v[0][1]), pack2(v[1][0], v[1][1]),
                             pack2(v[0][2], v[0][3]), pack2(v[1][2], v[1][3])};
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned bq[4];
        load_b(sw, 0, NT * 8, HEAD_KS, np, kc, bq);
        nt_mma_bf16(acc[2 * np], a, bq[0], bq[1]);
        nt_mma_bf16(acc[2 * np + 1], a, bq[2], bq[3]);
      }
    }
    store_acc<NT>(acc, bias, S.relu, wk.pixel(G, p0 + lane / 4),
                  wk.pixel(G, p0 + lane / 4 + 8), sink);
  }
}

// A depthwise layer's B fragments for chunk q, tap `tap`: the layer as a
// block-diagonal 16 x 16 matrix per chunk, whose n8 tile 0 has its
// diagonal in b0 and tile 1 in b1 (the other register is zero). Thread
// (g, t) holds the weight of channel 16 q + g (tile 0) and 16 q + 8 + g
// (tile 1) in the half whose k (2 t or 2 t + 1) equals g, zeros elsewhere.
__device__ __forceinline__ void dw_b(const float* wd, int c16, int q, int tap, unsigned& u0,
                                     unsigned& u1) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const float w0 = wd[tap * c16 + 16 * q + g], w1 = wd[tap * c16 + 16 * q + 8 + g];
  const float z = 0.f;
  u0 = round2(2 * t == g ? w0 : z, 2 * t + 1 == g ? w0 : z);
  u1 = round2(2 * t == g ? w1 : z, 2 * t + 1 == g ? w1 : z);
}

// A depthwise layer of KC 16-channel chunks, alone or (PAIR) with the 1x1
// layer after it (NT n8 tiles of output channels). The depthwise layer runs
// on the tensor cores as nine products per chunk with its block-diagonal
// weights (dw_b): its sums come out in the accumulator layout, which is the
// 1x1 product's A fragment layout, so they are finished (rounded, bias,
// activation, rounded) in registers and fed to the 1x1 at once.
template <int KC, int NT, bool PAIR>
__device__ void stage_dw(const Geo& G, const Stage& S, const bf16* src,
                         const unsigned char* wsm, const Sink& sink, const Walk& wk) {
  constexpr bool REG_W = KC <= 2, REG_B = PAIR && KC * NT <= 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const int s_in = G.smax, ks = KC * 16 + 8;
  const float* wd = reinterpret_cast<const float*>(wsm + S.dw_w);
  const bf16* sw = reinterpret_cast<const bf16*>(wsm + S.w_off);
  float bdw[KC * 2][2], bias[PAIR ? NT : 1][2];  // depthwise: the KC * 2 n8 tiles of its channels
  load_bias<KC * 2>(reinterpret_cast<const float*>(wsm + S.dw_b), bdw);
  if constexpr (PAIR) load_bias<NT>(reinterpret_cast<const float*>(wsm + S.b_off), bias);
  unsigned wr[REG_W ? KC : 1][9][2];
  if constexpr (REG_W) {
#pragma unroll
    for (int q = 0; q < KC; ++q)
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) dw_b(wd, KC * 16, q, tap, wr[q][tap][0], wr[q][tap][1]);
  }
  unsigned breg[REG_B ? KC : 1][REG_B ? NT / 2 : 1][4];
  if constexpr (REG_B) {
#pragma unroll
    for (int q = 0; q < KC; ++q)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) load_b(sw, 0, NT * 8, ks, np, q, breg[q][np]);
  }
  for (int mt = warp; mt < wk.nmt; mt += BW) {
    const int p0 = wk.p0(G, mt);
    const Px pa = wk.pixel(G, p0 + lane / 4), pb = wk.pixel(G, p0 + lane / 4 + 8);
    float acc[PAIR ? NT : 1][4] = {};
#pragma unroll
    for (int q = 0; q < KC; ++q) {
      float d[2][4] = {};  // n8 tiles 0 and 1 of chunk q
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int off = (tap / 3 - 1) * G.rw + (tap % 3 - 1);
        unsigned a[4], u0, u1;
        nt_ldmatrix_x4(src + (p0 + off + lane % 16) * s_in + (lane / 16) * 8 + 16 * q, a);
        if constexpr (REG_W) {
          u0 = wr[REG_W ? q : 0][tap][0];
          u1 = wr[REG_W ? q : 0][tap][1];
        } else {
          dw_b(wd, KC * 16, q, tap, u0, u1);
        }
        nt_mma_bf16(d[0], a, u0, 0u);
        nt_mma_bf16(d[1], a, 0u, u1);
      }
      // The A fragment: (pixel g, channels 2t, 2t+1), (g + 8, same), (g, + 8), (g + 8, + 8).
      const unsigned a[4] = {finish2(d[0][0], d[0][1], bdw[2 * q], S.dw_relu),
                             finish2(d[0][2], d[0][3], bdw[2 * q], S.dw_relu),
                             finish2(d[1][0], d[1][1], bdw[2 * q + 1], S.dw_relu),
                             finish2(d[1][2], d[1][3], bdw[2 * q + 1], S.dw_relu)};
      if constexpr (PAIR) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          unsigned bq[4];
          if constexpr (REG_B) {
#pragma unroll
            for (int z = 0; z < 4; ++z) bq[z] = breg[REG_B ? q : 0][REG_B ? np : 0][z];
          } else {
            load_b(sw, 0, NT * 8, ks, np, q, bq);
          }
          nt_mma_bf16(acc[2 * np], a, bq[0], bq[1]);
          nt_mma_bf16(acc[2 * np + 1], a, bq[2], bq[3]);
        }
      } else {
        sink.put(pa, 16 * q + 2 * t, a[0]);
        sink.put(pb, 16 * q + 2 * t, a[1]);
        sink.put(pa, 16 * q + 8 + 2 * t, a[2]);
        sink.put(pb, 16 * q + 8 + 2 * t, a[3]);
      }
    }
    if constexpr (PAIR) store_acc<NT>(acc, bias, S.relu, pa, pb, sink);
  }
}

template <int KC>
__device__ void stage_pair(int nt, const Geo& G, const Stage& S, const bf16* src,
                           const unsigned char* wsm, const Sink& sink, const Walk& wk) {
  switch (nt) {
    case 2: stage_dw<KC, 2, true>(G, S, src, wsm, sink, wk); break;
    case 4: stage_dw<KC, 4, true>(G, S, src, wsm, sink, wk); break;
    case 6: stage_dw<KC, 6, true>(G, S, src, wsm, sink, wk); break;
    default: stage_dw<KC, 8, true>(G, S, src, wsm, sink, wk); break;
  }
}

__device__ void run_stage(const Geo& G, const Stage& S, const bf16* src,
                          const unsigned char* wsm, const Sink& sink, const Walk& wk) {
  const int nt = ceil16(S.cout) / 8, kc = ceil16(S.cin) / 16;
  switch (S.kind) {
    case ST_HEAD:
      switch (nt) {
        case 2: stage_head<2>(G, S, src, wsm, sink, wk); break;
        case 4: stage_head<4>(G, S, src, wsm, sink, wk); break;
        case 6: stage_head<6>(G, S, src, wsm, sink, wk); break;
        default: stage_head<8>(G, S, src, wsm, sink, wk); break;
      }
      break;
    case ST_DENSE:
      switch (nt) {
        case 2: stage_dense<2>(G, S, src, wsm, sink, wk); break;
        case 4: stage_dense<4>(G, S, src, wsm, sink, wk); break;
        case 6: stage_dense<6>(G, S, src, wsm, sink, wk); break;
        default: stage_dense<8>(G, S, src, wsm, sink, wk); break;
      }
      break;
    case ST_DW:
      switch (kc) {
        case 1: stage_dw<1, 2, false>(G, S, src, wsm, sink, wk); break;
        case 2: stage_dw<2, 2, false>(G, S, src, wsm, sink, wk); break;
        case 3: stage_dw<3, 2, false>(G, S, src, wsm, sink, wk); break;
        default: stage_dw<4, 2, false>(G, S, src, wsm, sink, wk); break;
      }
      break;
    default:
      switch (kc) {
        case 1: stage_pair<1>(nt, G, S, src, wsm, sink, wk); break;
        case 2: stage_pair<2>(nt, G, S, src, wsm, sink, wk); break;
        case 3: stage_pair<3>(nt, G, S, src, wsm, sink, wk); break;
        default: stage_pair<4>(nt, G, S, src, wsm, sink, wk); break;
      }
      break;
  }
}

// Pixel 0 of region buffer i (0 or 1).
__device__ __forceinline__ bf16* buffer(const Plan& P, unsigned char* smem, int i) {
  return reinterpret_cast<bf16*>(smem + P.off_buf + i * P.buf_bytes) + SLACK_F * P.smax;
}

// Image, row and column of tile t's first output pixel.
__device__ __forceinline__ void tile_origin(const Plan& P, int t, int& b, int& y0, int& x0) {
  const int per_image = P.tiles_x * P.tiles_y;
  b = t / per_image;
  const int r = t - b * per_image, ty = r / P.tiles_x;
  y0 = ty * P.th;
  x0 = (r - ty * P.tiles_x) * P.tw;
}

// Tile t's input region, [c0][rh][rwp], into staging buffer s by TMA
// (one thread); zeros outside the image. The box starts xoff columns left
// of the region: TMA takes an innermost start coordinate 16-byte aligned.
__device__ __forceinline__ void load_box(const Plan& P, const CUtensorMap* xmap,
                                         unsigned char* smem, uint64_t* bars, int t, int s) {
  int b, y0, x0;
  tile_origin(P, t, b, y0, x0);
  nt_mbar_expect_tx(&bars[s], (unsigned)(P.c0 * P.rh * P.rwp * 2));
  nt_tma_load_4d(smem + P.off_stg + s * P.stg_bytes, xmap, &bars[s], x0 - P.halo - P.xoff,
                 y0 - P.halo, 0, b);
}

__global__ void __launch_bounds__(BT, 1)
    planar_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap omap,
                       const unsigned char* __restrict__ wpack,
                       const __grid_constant__ Plan P) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + P.off_bar);  // staging 0, 1; weights
  bf16* ostg = reinterpret_cast<bf16*>(smem + P.off_out);
  const int tid = threadIdx.x, npix = P.rh * P.rw;
  const Geo G{P.h, P.w, P.halo, P.th, P.tw, P.rh, P.rw, P.rwp, P.xoff, P.smax, P.cout, P.magic};

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) nt_mbar_init(&bars[i], 1);
    nt_fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    nt_mbar_expect_tx(&bars[2], (unsigned)P.wbytes);
    nt_bulk_load(smem, wpack, (unsigned)P.wbytes, &bars[2]);
    if ((int)blockIdx.x < P.ntiles) load_box(P, &xmap, smem, bars, blockIdx.x, 0);
  }
  nt_mbar_wait(&bars[2], 0);

  for (int t = blockIdx.x, it = 0; t < P.ntiles; t += gridDim.x, ++it) {
    const int s = it & 1;
    int b, y0, x0;
    tile_origin(P, t, b, y0, x0);
    const bf16* stg = reinterpret_cast<const bf16*>(smem + P.off_stg + s * P.stg_bytes);
    // Tile t + gridDim.x's input into the other staging buffer, which the
    // previous tile finished reading before its last barrier.
    if (tid == 0 && t + (int)gridDim.x < P.ntiles)
      load_box(P, &xmap, smem, bars, t + gridDim.x, s ^ 1);
    nt_mbar_wait(&bars[s], (it >> 1) & 1);
    if (P.transpose) {
      // The input box [c0][rh][rwp] as pixel rows of buffer 1, channels padded with zeros.
      const int cp = ceil16(P.c0) / 2;
      for (int i = tid; i < npix * cp; i += BT) {
        const int p = i / cp, c = 2 * (i - p * cp), row = __umulhi((unsigned)p, P.magic);
        const int sidx = row * P.rwp + p - row * P.rw + P.xoff, plane = P.rh * P.rwp;
        const bf16 z = __float2bfloat16_rn(0.f);
        *reinterpret_cast<unsigned*>(buffer(P, smem, 1) + p * P.smax + c) =
            pack2(c < P.c0 ? stg[c * plane + sidx] : z,
                  c + 1 < P.c0 ? stg[(c + 1) * plane + sidx] : z);
      }
    }
    for (int si = 0; si < P.ns; ++si) {
      const Stage S = P.st[si];
      const bool last = si == P.ns - 1;
      // The previous tile's output store has read the output stage.
      if (last && tid == 0) nt_bulk_wait_read<0>();
      __syncthreads();
      const bf16* src = si > 0 ? buffer(P, smem, (si - 1) & 1)
                               : P.transpose ? buffer(P, smem, 1) : stg;
      const Sink sink{last ? nullptr : buffer(P, smem, si & 1), P.smax, ostg, P.cout,
                      P.th * P.tw};
      const Walk wk = last ? Walk{0, 0, P.th * (P.tw / 16), 1, y0, x0}
                           : Walk{S.h * P.rw, (P.rh - S.h) * P.rw,
                                  ((P.rh - 2 * S.h) * P.rw + 15) / 16, 0, y0, x0};
      run_stage(G, S, src, smem, sink, wk);
    }
    nt_fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      nt_tma_store_4d(&omap, ostg, x0, y0, 0, b);
      nt_bulk_commit();
    }
  }
  if (tid == 0) nt_bulk_wait<0>();
}

cudaError_t launch_bf16(const void* x, void* out, const void* wpack, const Layer* layers, int nl,
                        int b, int h, int wd, int ws, cudaStream_t stream) {
  if (ws % 8 || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  Plan P{};
  int hl = 0;
  for (int i = 0; i < nl;) {
    const Layer& L = layers[i];
    Stage& S = P.st[P.ns++];
    S = Stage{ST_DENSE, 1, 0, L.cin, L.cout, L.relu, L.w_off, L.b_off, 0, 0, 0};
    if (L.kind == KDW3) {
      S.kind = ST_DW;
      S.dw_w = L.w_off;
      S.dw_b = L.b_off;
      S.dw_relu = L.relu;
      if (i + 1 < nl && layers[i + 1].kind == K1X1) {
        const Layer& M = layers[i + 1];
        S.kind = ST_PAIR;
        S.cout = M.cout;
        S.relu = M.relu;
        S.w_off = M.w_off;
        S.b_off = M.b_off;
        ++i;
      }
    } else if (L.kind == K3X3_HEAD) {
      S.kind = ST_HEAD;
    } else if (L.kind == K3X3) {
      S.taps = 9;
    }
    hl += L.kind != K1X1;
    S.h = hl;
    ++i;
  }
  const Layer& last = layers[nl - 1];
  P.c0 = layers[0].cin;
  P.cout = last.cout;
  P.halo = hl;
  P.transpose = P.st[0].kind != ST_HEAD;
  P.smax = P.transpose ? row_stride(P.c0) : 8;
  for (int i = 0; i < P.ns - 1; ++i)
    if (row_stride(P.st[i].cout) > P.smax) P.smax = row_stride(P.st[i].cout);
  P.wbytes = last.b_off + 4 * ceil16(last.cout);
  P.h = h;
  P.w = wd;

  NtDeviceLimits lim;
  cudaError_t err = nt_device_limits(lim);
  if (err != cudaSuccess) return err;
  const NtEncodeTiled encode = nt_encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  int smem = 0;
  for (const auto& tile : BF16_TILES) {
    const int th = tile[0], tw = tile[1], rh = th + 2 * hl, rw = tw + 2 * hl;
    const int xoff = (8 - hl % 8) % 8, rwp = (rw + xoff + 7) / 8 * 8;
    if (rwp > 256 || rh > 256) continue;
    const int off_stg = align128(P.wbytes), stg_bytes = align128(2LL * P.c0 * rh * rwp);
    const int off_buf = off_stg + 2 * stg_bytes;
    const int buf_bytes = align128(2LL * (SLACK_F + rh * rw + SLACK_B) * P.smax);
    const int off_out = off_buf + 2 * buf_bytes;
    const int off_bar = off_out + align128(2LL * P.cout * th * tw);
    if (off_bar + 3 * 8 > lim.smem) continue;
    P.th = th;
    P.tw = tw;
    P.rh = rh;
    P.rw = rw;
    P.rwp = rwp;
    P.xoff = xoff;
    P.off_stg = off_stg;
    P.stg_bytes = stg_bytes;
    P.off_buf = off_buf;
    P.buf_bytes = buf_bytes;
    P.off_out = off_out;
    P.off_bar = off_bar;
    smem = off_bar + 3 * 8;
    break;
  }
  // The whole pack does not fit beside the buffers: one block per tile.
  if (smem == 0) return launch_tile<bf16>(x, out, wpack, layers, nl, b, h, wd, ws, stream);
  P.magic = 0xffffffffu / (unsigned)P.rw + 1;
  P.tiles_x = (wd + P.tw - 1) / P.tw;
  P.tiles_y = (h + P.th - 1) / P.th;
  const long long ntiles = (long long)b * P.tiles_x * P.tiles_y;
  if (ntiles > INT32_MAX) return cudaErrorInvalidValue;
  P.ntiles = (int)ntiles;

  // (W, H, C, B), innermost first; rows ws elements apart. The input box is
  // the region (columns padded to 8), the output box the tile.
  CUtensorMap xmap, omap;
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const cuuint64_t xdims[4] = {(cuuint64_t)wd, (cuuint64_t)h, (cuuint64_t)P.c0, (cuuint64_t)b};
  const cuuint64_t xstr[3] = {(cuuint64_t)ws * 2, (cuuint64_t)ws * h * 2,
                              (cuuint64_t)ws * h * P.c0 * 2};
  const cuuint32_t xbox[4] = {(cuuint32_t)P.rwp, (cuuint32_t)P.rh, (cuuint32_t)P.c0, 1};
  const cuuint64_t odims[4] = {(cuuint64_t)wd, (cuuint64_t)h, (cuuint64_t)P.cout, (cuuint64_t)b};
  const cuuint64_t ostr[3] = {(cuuint64_t)ws * 2, (cuuint64_t)ws * h * 2,
                              (cuuint64_t)ws * h * P.cout * 2};
  const cuuint32_t obox[4] = {(cuuint32_t)P.tw, (cuuint32_t)P.th, (cuuint32_t)P.cout, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), xdims, xstr, xbox,
             estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&omap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, out, odims, ostr, obox, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;

  static bool configured[64] = {};
  int dev;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(planar_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               lim.smem);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const int grid = (int)(ntiles < lim.sms ? ntiles : lim.sms);
  planar_bf16_kernel<<<grid, BT, smem, stream>>>(xmap, omap,
                                                 static_cast<const unsigned char*>(wpack), P);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nt_planar_chain(const void* x, void* out, const void* wpack, const int* layers,
                               int nl, int b, int h, int w_, int ws, int dtype, void* stream) {
  if (nl < 1 || nl > MAX_LAYERS || b < 1 || h < 1 || w_ < 1 || ws < w_)
    return (int)cudaErrorInvalidValue;
  Layer ls[MAX_LAYERS];
  for (int i = 0; i < nl; ++i) {
    const int* d = layers + 6 * i;
    const Layer L{d[0], d[1], d[2], d[3], d[4], d[5]};
    if (L.kind < K3X3 || L.kind > K3X3_HEAD || L.cin < 1 || L.cout < 1 || L.cin > MAX_C ||
        L.cout > MAX_C || (L.kind == KDW3 && L.cin != L.cout) ||
        (L.kind == K3X3_HEAD && (i > 0 || L.cin > 3 || dtype != NT_BF16)) ||
        (i > 0 && L.cin != ls[i - 1].cout) || L.w_off % 16 || L.b_off % 16)
      return (int)cudaErrorInvalidValue;
    ls[i] = L;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == NT_BF16) return (int)launch_bf16(x, out, wpack, ls, nl, b, h, w_, ws, st);
  if (dtype == NT_F32) return (int)launch_tile<float>(x, out, wpack, ls, nl, b, h, w_, ws, st);
  return (int)cudaErrorInvalidValue;
}
