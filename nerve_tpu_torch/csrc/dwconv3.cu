// Depthwise SAME 3x3 convolution, one layer per launch, NHWC.
//
// Replaces the depthwise branch (`kind == "dw3"`) of nerve_tpu/ops/
// conv_chain.py `_chain_kernel` (reached via `_chain_pallas` <-
// `conv_chain_fused` <- `conv_chain_apply`); the wrapper runs it beside the
// dense layers of `conv_chain.cu`, one launch per layer.
//
// Numerics follow the reference formulation `_chain_xla`'s depthwise branch
// (conv_chain.py:427-434): the weights rounded to the input dtype T (here,
// in the kernel: the wrapper passes the float32 weights as they are), the
// 9-tap sum in float32 from 0 with `fmaf`, taps in order (dy outer, dx
// inner), rounded to T, then the float32 bias, the optional relu, and a
// rounding to T.
//
// Bound: bytes. 18 FLOPs per element against 2 x sizeof(T) bytes moved: at
// 1080p x 32 channels in bfloat16 one layer moves 265 MB (0.079 ms at 3.35
// TB/s) for 1.2 GFLOP.
//
// Two routes, chosen by shape (ops/conv_chain.py `dwconv3_route`):
//
// * NT_DW_TMA, where a pixel is a multiple of 16 bytes (C a multiple of 8
//   in bfloat16, of 4 in float32) and the input and output are 16-byte
//   aligned. Persistent blocks, one per SM, walk TILE_H x tw output tiles
//   in order. Each tile's haloed input box, (TILE_H + 2) x (tw + 2) pixels
//   of all C channels, arrives by one TMA load of a 4-D tensor map (C, W,
//   H, B) on a ring of mbarrier stages (three where they fit, two for
//   float32 at C = 56 and 64), so the next tiles' boxes are in flight while
//   this one is computed; the map's zero fill outside the tensor is the
//   SAME padding (the box starts at x0 - 1, y0 - 1; the
//   innermost start, channel 0, is 16-byte aligned). A thread owns one
//   16-byte channel vector k of one column and walks ROWS output rows down
//   it: each input row is read once from shared memory (3 vectors: the
//   column and its two neighbours) and feeds the three output rows it
//   touches, whose running sums stay in registers (row y gets its dy = 0
//   taps from input row y - 1, dy = 1 from y, dy = 2 from y + 1: taps in
//   the reference's order). A warp's lanes read neighbouring 16-byte
//   pieces of one box row: no bank conflicts. The layer's 9 x C weights
//   and C biases are read once per block, rounded to T, and held in
//   registers (the thread's VEC channels). Results go out as one 16-byte
//   store per thread and row; a warp writes whole contiguous pixels.
//   The tile width is chosen so that cv x tw is about 128 threads (cv =
//   16-byte vectors a pixel); SEGS such column groups stack down a tile.
// * NT_DW_TILE, any other C or alignment: one block per 16 x 32 tile
//   stages its haloed tile of every channel in shared memory (channels
//   padded to the vector width with zeros; element loads where a pixel is
//   not a multiple of 16 bytes), then each thread sums one channel vector
//   of a 4-pixel column segment.
//
// Channel slices. Depthwise is separable by channel, so a layer wider than
// MAX_C channels runs as `nslices` slices of `cs` <= MAX_C channels (cs a
// multiple of the vector width; ops/conv_chain.py `dw_slices` is the same
// rule), one launch a layer either way. On NT_DW_TMA the slice is the
// fastest index of the tile walk and the grid a multiple of nslices, so a
// persistent block keeps one slice (and its weights in registers) for its
// whole walk; its box is the slice's channels (TMA starts it at channel
// slice * cs and zero-fills channels past C). On NT_DW_TILE the slice is a
// grid dimension. A layer of C <= MAX_C is one slice of C channels and
// launches what it did before slices existed, on NT_DW_TMA the kernel
// instance without the slice arithmetic (SLICED = false).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "nerve_tpu_torch.h"

namespace {

constexpr int MAX_C = 64;

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
// v rounded to T and widened back.
template <typename T>
__device__ __forceinline__ float round_t(float v) { return to_f(from_f<T>(v)); }

// One 16-byte vector of VEC = 16 / sizeof(T) channels.
template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

// Element q of a 16-byte vector, widened to float32 (a shift or a mask in
// bfloat16).
template <typename T>
__device__ __forceinline__ float widen(const uint4& u, int q);
template <>
__device__ __forceinline__ float widen<float>(const uint4& u, int q) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
  return __uint_as_float(w[q]);
}
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(const uint4& u, int q) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
  const unsigned v = w[q >> 1];
  return __uint_as_float(q & 1 ? v & 0xffff0000u : v << 16);
}

// ---------------------------------------------------------------------------
// NT_DW_TMA: persistent blocks, TMA-fed tiles, a sliding window per thread.
// ---------------------------------------------------------------------------
constexpr int ROWS = 10;                      // output rows a thread walks per tile
constexpr int SEGS = 3;                       // thread groups stacked down a tile
constexpr int TILE_H = ROWS * SEGS;           // tile rows
constexpr int ROW_THREADS = 128;              // cv x tw, at most
constexpr int TMA_THREADS = ROW_THREADS * SEGS;
constexpr int MAX_STAGES = 3;                 // boxes in flight: as many as fit

struct DwParams {
  int h, w, c, cs, nslices, cv, tw, tiles_x, tiles_y, ntiles, relu, stage, nstages;
};

// Slices of a layer of c channels: the fewest of at most MAX_C channels,
// each a multiple of vec channels (ops/conv_chain.py `dw_slices`).
void slices_for(int c, int vec, int& nslices, int& cs) {
  nslices = (c + MAX_C - 1) / MAX_C;
  cs = ((c + nslices - 1) / nslices + vec - 1) / vec * vec;
}

int tile_w_for(int cv) { return std::max(8, ROW_THREADS / cv); }

template <bool SLICED>
__device__ __forceinline__ void decode_tile(const DwParams& p, int t, int& b, int& y0, int& x0) {
  if (SLICED) t /= p.nslices;  // the slice is t % nslices
  const int tx = t % p.tiles_x, r = t / p.tiles_x;
  x0 = tx * p.tw;
  y0 = (r % p.tiles_y) * TILE_H;
  b = r / p.tiles_y;
}

template <bool SLICED>
__device__ __forceinline__ void issue_tile(const CUtensorMap* m, unsigned char* smem,
                                           uint64_t* full, const DwParams& p, int t, int s) {
  int b, y0, x0;
  decode_tile<SLICED>(p, t, b, y0, x0);
  nt_mbar_expect_tx(&full[s], p.stage);
  nt_tma_load_4d(smem + s * p.stage, m, &full[s], SLICED ? t % p.nslices * p.cs : 0, x0 - 1,
                 y0 - 1, b);
}

// SLICED: more than one channel slice (a layer of C <= MAX_C compiles to
// the kernel without slices).
template <typename T, bool SLICED>
__global__ void __launch_bounds__(TMA_THREADS, 1)
    dw3_tma_kernel(const __grid_constant__ CUtensorMap mx, const float* __restrict__ w,
                   const float* __restrict__ bias, T* __restrict__ out, const DwParams p) {
  constexpr int VEC = Vec<T>::N;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.nstages * p.stage);
  const int tid = threadIdx.x;
  const int k = tid % p.cv, col = tid / p.cv % p.tw, seg = tid / (p.cv * p.tw);
  const int mine = (p.ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  if (tid == 0) {
    for (int s = 0; s < p.nstages; ++s) nt_mbar_init(&full[s], 1);
    nt_fence_mbar_init();
    for (int i = 0; i < p.nstages && i < mine; ++i)
      issue_tile<SLICED>(&mx, smem, full, p, blockIdx.x + i * gridDim.x, i);
  }
  // This thread's channels (the block's slice is blockIdx.x % nslices: the
  // grid is a multiple of nslices): taps rounded to T, bias as it is.
  const int ch = (SLICED ? (int)blockIdx.x % p.nslices * p.cs : 0) + k * VEC;
  const bool ch_ok = !SLICED || ch < p.c;  // the last slice may run past C
  float wr[9][VEC], br[VEC];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int q = 0; q < VEC; ++q) wr[t][q] = ch_ok ? round_t<T>(__ldg(w + t * p.c + ch + q)) : 0.f;
#pragma unroll
  for (int q = 0; q < VEC; ++q) br[q] = ch_ok ? __ldg(bias + ch + q) : 0.f;
  __syncthreads();

  const int ps = p.cv * 16, rs = (p.tw + 2) * ps;  // bytes of a box pixel and a box row
  const long long ors = (long long)p.w * p.c;      // elements of an output row
  for (int i = 0; i < mine; ++i) {
    const int s = i % p.nstages;
    int b, y0, x0;
    decode_tile<SLICED>(p, blockIdx.x + i * gridDim.x, b, y0, x0);
    const int gx = x0 + col, gy = y0 + seg * ROWS;
    const bool in_frame = gx < p.w && ch_ok;
    const int nrows = p.h - gy;  // rows of this thread's walk inside the frame (may be <= 0)
    T* dst = out + (((long long)b * p.h + gy) * p.w + gx) * p.c + ch;
    // Box row seg * ROWS + j holds input row gy - 1 + j; box column col + dx
    // holds input column gx - 1 + dx.
    const unsigned char* src = smem + s * p.stage + (seg * ROWS * (p.tw + 2) + col) * ps + k * 16;
    nt_mbar_wait(&full[s], (i / p.nstages) & 1);
    float acc[3][VEC];  // running sums of output rows j, j - 1, j - 2 (mod 3)
#pragma unroll
    for (int j = 0; j < ROWS + 2; ++j) {
      uint4 v[3];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        v[dx] = *reinterpret_cast<const uint4*>(src + j * rs + dx * ps);
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const float a0 = widen<T>(v[0], q), a1 = widen<T>(v[1], q), a2 = widen<T>(v[2], q);
        if (j < ROWS) {  // output row j: taps dy = 0
          float& o = acc[j % 3][q];
          o = fmaf(a0, wr[0][q], 0.f);
          o = fmaf(a1, wr[1][q], o);
          o = fmaf(a2, wr[2][q], o);
        }
        if (j >= 1 && j <= ROWS) {  // output row j - 1: taps dy = 1
          float& o = acc[(j + 2) % 3][q];
          o = fmaf(a0, wr[3][q], o);
          o = fmaf(a1, wr[4][q], o);
          o = fmaf(a2, wr[5][q], o);
        }
        if (j >= 2) {  // output row j - 2: taps dy = 2
          float& o = acc[(j + 1) % 3][q];
          o = fmaf(a0, wr[6][q], o);
          o = fmaf(a1, wr[7][q], o);
          o = fmaf(a2, wr[8][q], o);
        }
      }
      if (j >= 2 && in_frame && j - 2 < nrows) {
        Vec<T> res;
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          float val = __fadd_rn(round_t<T>(acc[(j + 1) % 3][q]), br[q]);
          if (p.relu) val = fmaxf(val, 0.f);
          res.v[q] = from_f<T>(val);
        }
        *reinterpret_cast<uint4*>(dst + (j - 2) * ors) = *reinterpret_cast<const uint4*>(&res);
      }
    }
    __syncthreads();  // every read of stage s is done
    if (tid == 0 && i + p.nstages < mine)
      issue_tile<SLICED>(&mx, smem, full, p, blockIdx.x + (i + p.nstages) * gridDim.x, s);
  }
}

// ---------------------------------------------------------------------------
// NT_DW_TILE: one block per haloed 16 x 32 tile, any C.
// ---------------------------------------------------------------------------
constexpr int TH = 16, TW = 32, P = 4, NTHREADS = 256;

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    dw3_tile_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, T* __restrict__ out, int h, int wd, int c,
                    int cs, int nslices, int relu, int vec) {
  constexpr int VEC = Vec<T>::N, IH = TH + 2, IW = TW + 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int cv = (cs + VEC - 1) / VEC;  // channel vectors per pixel of the slice
  Vec<T>* sx = reinterpret_cast<Vec<T>*>(smem);                 // [IH][IW][cv]
  float* sw = reinterpret_cast<float*>(sx + IH * IW * cv);        // [9][cv*VEC]
  float* sb = sw + 9 * cv * VEC;                                  // [cv*VEC]

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int c0 = (int)blockIdx.z % nslices * cs;  // the slice's first channel
  const long long img = (long long)(blockIdx.z / nslices) * h * wd;
  const int cp = cv * VEC;

  for (int i = tid; i < 10 * cp; i += NTHREADS) {
    const int ch = i % cp, t = i / cp, gc = c0 + ch;
    const float v = gc < c ? (t < 9 ? round_t<T>(w[t * c + gc]) : bias[gc]) : 0.f;
    if (t < 9) sw[t * cp + ch] = v; else sb[ch] = v;
  }
  for (int i = tid; i < IH * IW * cv; i += NTHREADS) {
    const int k = i % cv, pix = i / cv, xx = pix % IW, yy = pix / IW;
    const int gy = y0 + yy - 1, gx = x0 + xx - 1, gc = c0 + k * VEC;
    Vec<T> v;
    *reinterpret_cast<uint4*>(&v) = make_uint4(0, 0, 0, 0);
    if (gy >= 0 && gy < h && gx >= 0 && gx < wd && gc < c) {
      const T* src = x + (img + (long long)gy * wd + gx) * c + gc;
      if (vec) {
        v = *reinterpret_cast<const Vec<T>*>(src);
      } else {
        for (int j = 0; j < VEC && gc + j < c; ++j) v.v[j] = src[j];
      }
    }
    sx[pix * cv + k] = v;
  }
  __syncthreads();

  // Work item: channel vector k (fastest, so neighbouring threads touch
  // neighbouring 16-byte words), output column tx, column segment sg.
  for (int item = tid; item < cv * TW * (TH / P); item += NTHREADS) {
    const int k = item % cv, tx = (item / cv) % TW, sg = item / (cv * TW);
    float acc[P][VEC];
#pragma unroll
    for (int j = 0; j < P; ++j)
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[j][q] = 0.f;
    // Input row r of the segment feeds output rows j = r - dy.
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float wv[VEC];
#pragma unroll
        for (int q = 0; q < VEC; ++q) wv[q] = sw[(dy * 3 + dx) * cp + k * VEC + q];
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const Vec<T> v = sx[((sg * P + j + dy) * IW + tx + dx) * cv + k];
#pragma unroll
          for (int q = 0; q < VEC; ++q) acc[j][q] = fmaf(to_f(v.v[q]), wv[q], acc[j][q]);
        }
      }
    }
    const int gx = x0 + tx;
    if (gx >= wd) continue;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int gy = y0 + sg * P + j;
      if (gy >= h) continue;
      Vec<T> o;
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        float v = __fadd_rn(round_t<T>(acc[j][q]), sb[k * VEC + q]);
        if (relu) v = fmaxf(v, 0.f);
        o.v[q] = from_f<T>(v);
      }
      const int gc = c0 + k * VEC;
      if (gc >= c) continue;
      T* dst = out + (img + (long long)gy * wd + gx) * c + gc;
      if (vec) {
        *reinterpret_cast<Vec<T>*>(dst) = o;
      } else {
        for (int q = 0; q < VEC && gc + q < c; ++q) dst[q] = o.v[q];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: plan, launch record, launch.
// ---------------------------------------------------------------------------
struct DwLaunch {
  DwParams p;
  CUtensorMap m;
  int grid, threads, smem, ntiles, tile_h, tile_w, nslices, cs;
  const void* fn;
};

template <typename T>
cudaError_t plan_tma(const void* x, const void* out, int b, int h, int wd, int c, int relu,
                     DwLaunch& l) {
  constexpr int es = sizeof(T);
  if (c * es % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return cudaErrorInvalidValue;
  NtDeviceLimits lim;
  cudaError_t err = nt_device_limits(lim);
  if (err != cudaSuccess) return err;
  int dev;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  DwParams& p = l.p;
  p.h = h;
  p.w = wd;
  p.c = c;
  slices_for(c, 16 / es, p.nslices, p.cs);
  p.cv = p.cs * es / 16;
  p.tw = tile_w_for(p.cv);
  p.stage = (TILE_H + 2) * (p.tw + 2) * p.cv * 16;
  p.nstages = std::min(MAX_STAGES, (lim.smem - MAX_STAGES * 8) / p.stage);
  if (p.nstages < 2) return cudaErrorInvalidConfiguration;
  p.relu = relu;
  p.tiles_x = (wd + p.tw - 1) / p.tw;
  p.tiles_y = (h + TILE_H - 1) / TILE_H;
  const long long ntiles = (long long)b * p.tiles_x * p.tiles_y * p.nslices;
  if (ntiles > INT32_MAX) return cudaErrorInvalidValue;
  p.ntiles = (int)ntiles;
  l.nslices = p.nslices;
  l.cs = p.cs;
  l.threads = p.cv * p.tw * SEGS;
  l.smem = p.nstages * p.stage + MAX_STAGES * 8;
  // Blocks an SM holds at this cv, once the kernel is configured.
  const int sliced = p.nslices > 1;
  l.fn = sliced ? reinterpret_cast<const void*>(dw3_tma_kernel<T, true>)
                : reinterpret_cast<const void*>(dw3_tma_kernel<T, false>);
  static int per_sm[64][2][17] = {};
  int& fit = per_sm[dev][sliced][p.cv];
  if (fit == 0) {
    err = cudaFuncSetAttribute(l.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, lim.smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, l.fn, l.threads, l.smem);
    if (err != cudaSuccess) return err;
    if (fit < 1) return cudaErrorInvalidConfiguration;
  }
  // A multiple of nslices (ntiles is one), so that a block keeps its slice.
  l.grid = (int)std::min<long long>(ntiles, (long long)lim.sms * fit / p.nslices * p.nslices);
  if (l.grid < 1) return cudaErrorInvalidConfiguration;
  l.ntiles = p.ntiles;
  l.tile_h = TILE_H;
  l.tile_w = p.tw;

  const NtEncodeTiled encode = nt_encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // (C, W, H, B), innermost first; a box is a haloed tile of one slice's channels.
  const CUtensorMapDataType dt =
      es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)wd, (cuuint64_t)h, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)c * es, (cuuint64_t)wd * c * es,
                                 (cuuint64_t)h * wd * c * es};
  const cuuint32_t box[4] = {(cuuint32_t)p.cs, (cuuint32_t)p.tw + 2, TILE_H + 2, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  if (encode(&l.m, dt, 4, const_cast<void*>(x), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename T>
cudaError_t plan_tile(int b, int h, int wd, int c, DwLaunch& l) {
  constexpr int VEC = Vec<T>::N;
  slices_for(c, VEC, l.nslices, l.cs);
  const int cv = (l.cs + VEC - 1) / VEC;
  l.smem = (TH + 2) * (TW + 2) * cv * 16 + 10 * cv * VEC * (int)sizeof(float);
  l.threads = NTHREADS;
  l.tile_h = TH;
  l.tile_w = TW;
  const long long tiles =
      (long long)((wd + TW - 1) / TW) * ((h + TH - 1) / TH) * b * l.nslices;
  if ((long long)b * l.nslices > 65535) return cudaErrorInvalidValue;
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  l.ntiles = l.grid = (int)tiles;
  l.fn = reinterpret_cast<const void*>(dw3_tile_kernel<T>);
  return cudaFuncSetAttribute(dw3_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              l.smem);
}

template <typename T>
cudaError_t run(const void* x, const float* w, const float* bias, void* out, int b, int h,
                int wd, int c, int relu, int route, int* rec, cudaStream_t stream) {
  DwLaunch l;
  cudaError_t err = route == NT_DW_TMA ? plan_tma<T>(x, out, b, h, wd, c, relu, l)
                                       : plan_tile<T>(b, h, wd, c, l);
  if (err != cudaSuccess) return err;
  if (rec != nullptr) {
    cudaFuncAttributes a;
    if ((err = cudaFuncGetAttributes(&a, l.fn)) != cudaSuccess) return err;
    const int r[11] = {l.grid, l.threads, l.smem, (int)a.sharedSizeBytes, a.numRegs,
                       (int)a.localSizeBytes, l.ntiles, l.tile_h, l.tile_w, l.nslices, l.cs};
    for (int i = 0; i < 11; ++i) rec[i] = r[i];
    return cudaSuccess;
  }
  if (route == NT_DW_TMA) {
    if (l.p.nslices > 1)
      dw3_tma_kernel<T, true><<<l.grid, l.threads, l.smem, stream>>>(l.m, w, bias,
                                                                      static_cast<T*>(out), l.p);
    else
      dw3_tma_kernel<T, false><<<l.grid, l.threads, l.smem, stream>>>(l.m, w, bias,
                                                                       static_cast<T*>(out), l.p);
  } else {
    const int vec = c % Vec<T>::N == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const dim3 grid((wd + TW - 1) / TW, (h + TH - 1) / TH, b * l.nslices);
    dw3_tile_kernel<T><<<grid, NTHREADS, l.smem, stream>>>(
        static_cast<const T*>(x), w, bias, static_cast<T*>(out), h, wd, c, l.cs, l.nslices, relu,
        vec);
  }
  return cudaGetLastError();
}

int checked(const void* x, const float* w, const float* bias, void* out, int c, int b, int h,
            int w_, int relu, int route, int dtype, int* rec, void* stream) {
  if (c < 1 || b < 1 || h < 1 || w_ < 1 ||
      (route != NT_DW_TMA && route != NT_DW_TILE))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == NT_BF16)
    return (int)run<__nv_bfloat16>(x, w, bias, out, b, h, w_, c, relu, route, rec, st);
  if (dtype == NT_F32) return (int)run<float>(x, w, bias, out, b, h, w_, c, relu, route, rec, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int nt_dwconv3(const void* x, const float* w, const float* bias, void* out, int c,
                          int b, int h, int w_, int relu, int route, int dtype, void* stream) {
  return checked(x, w, bias, out, c, b, h, w_, relu, route, dtype, nullptr, stream);
}

extern "C" int nt_dwconv3_launch(const void* x, const void* out, int c, int b, int h, int w_,
                                 int route, int dtype, int* rec, void* stream) {
  return checked(x, nullptr, nullptr, const_cast<void*>(out), c, b, h, w_, 0, route, dtype, rec,
                 stream);
}
