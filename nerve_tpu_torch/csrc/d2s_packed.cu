// Depth-to-space into packed rows.
//
// Replaces nerve_tpu/ops/pixel_shuffle.py `_d2s_packed_kernel` (reached via
// `depth_to_space_packed`). The TPU kernel built the lane interleave out of
// MXU matmuls against 0/1 scatter matrices, because Mosaic could not lower
// the shape cast. Here it is what it is: an index permutation.
//
//   out[b, y*s + sy, (x*s + sx)*C + c] = in[b, y, x, c*s*s + sy*s + sx]
//
// Bound: device-memory bytes (one read and one write of the frame, no
// arithmetic). The data is moved as raw 16- or 32-bit words, so the result
// is bit-exact by construction.
//
// Design. Input pixel x of row (b, y) feeds pixels x*s .. x*s + s - 1 of
// all s output rows y*s + sy, so the work unit is a segment of one input
// row: `seg_px` pixels (a multiple of the period below, about 16 KB), which
// a persistent block stages in shared memory and then writes out as the
// matching segment of each of the s output rows. The input crosses device
// memory once, in order, and no other block reads it.
//
// * Staging. Where the input is 16-byte aligned and an input row is a
//   multiple of 16 bytes (then every segment starts and ends on 16 bytes),
//   a segment arrives by one bulk copy (`cp.async.bulk`) that completes on
//   the stage's mbarrier; a block keeps up to four stages in flight, so the
//   next segments load while this one is written. Any other shape (the
//   serving layout, 24 bytes a pixel in bfloat16, at an odd width; an
//   unaligned base) loads the segment with element loads into the same
//   buffer, then a block barrier.
// * Writing. A thread builds 16 bytes (VEC elements) of one output row at
//   a time from the staged segment and writes them with one 16-byte store;
//   neighbouring threads take the other rows sy of the same pixels
//   (thread t: sy = t % s), then the next 16 bytes, so a warp writes s
//   contiguous runs. Where an output row is not a multiple of 16 bytes or
//   the output is not 16-byte aligned, the same values go out as element
//   stores.
// * The gather. Output elements repeat their source pattern every `pv`
//   vectors of a row (one period: `gpx` input pixels, pv = s*C / gcd(VEC,
//   s*C)). The block has a multiple of s*pv threads, so a thread's row sy
//   and phase in the period never change: it computes the VEC source
//   offsets of its phase once, and each vector is then VEC shared-memory
//   loads at a base plus those offsets. (Where s*pv exceeds the block, the
//   offsets are computed per element.) The read order was chosen by
//   counting, per load instruction of a warp, the distinct words that fall
//   in one bank (bank = word mod 32): with the rows sy interleaved across
//   neighbouring lanes, a warp's lanes cover both halves of each pixel's
//   words (a pixel's rows sy are neighbouring words at s = 2), so every
//   bank is used; at the serving shape (s = 2, C = 3, bfloat16) a load
//   still takes two wavefronts, which keeps the reads far under the
//   segment's memory time. No lane rotation of the reads was kept.
//
// The planar variant replaces scripts/diag_d2s.py `d2s_packed_planar`
// (`_kernel_planar`, the same interleave from channel-planar phases):
//
//   out[b, y*s + sy, (x*s + sx)*C + c] = in[b, c*s*s + sy*s + sx, y, x]
//
// It is the same kernel (PLANAR = true) with another staging. A work item
// is still (b, input row y, W segment); the C*s*s phase planes' row
// segments of that item arrive in one stage as C*s*s rows `pstride`
// elements apart, by one bulk copy each where rows are 16-byte multiples
// and the base aligned (every plane row and segment then starts on 16
// bytes: segments are a multiple of 16 bytes of pixels), else by element
// loads into the same buffer. The s output rows of the segment are written
// from the stage with 16-byte stores, each thread's gather offsets fixed
// as above (a period's source offsets are plane * pstride + x instead of
// x * C*s*s + plane). A plane row is padded by 16 bytes, so that the
// planes a warp reads at once start in different banks. Reading the input
// once in rows, rather than gathering each output vector's elements from
// planes H*W apart (the first port's design: 2-4 bytes used of each
// 32-byte sector), is what the redesign buys. Limit: a stage holds at
// least one 16-byte run of each plane, so C*s*s <= ~7,000 planes. The
// script's `d2s_packed_mxu` computes the NHWC function above and is covered
// by `nt_d2s_packed`.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <numeric>

#include "nerve_tpu_torch.h"

namespace {

constexpr int D2S_THREADS = 256;  // at most; a multiple of s*pv (of s)
constexpr int SEG_BYTES = 16384;  // input bytes of a segment, about
constexpr int MAX_STAGES = 4;

struct D2sParams {
  long long items;     // segments: rows x nseg
  int h, w, c, s, sc, cin;
  int nseg, seg_px;    // segments of an input row, pixels of a segment
  int gpx, pv;         // input pixels and output vectors (per row) of a period
  int gstride;         // staged elements from one period to the next
  int pstride;         // PLANAR: staged elements from one plane's row to the next
  int fast;            // per-thread gather offsets fixed
  int stage, nstages;  // bytes of a stage, stages
  int bulk, vec_out;   // bulk copies in; 16-byte stores out
};

// Source element (in a staged segment) of element e of output row sy's
// segment: pixel-major (x, plane) or, PLANAR, plane-major (plane, x).
template <bool PLANAR>
__device__ __forceinline__ int src_index(int e, int sy, const D2sParams& p) {
  const int x = e / p.sc, j = e - x * p.sc, sx = j / p.c, c = j - sx * p.c;
  const int plane = c * p.s * p.s + sy * p.s + sx;
  return PLANAR ? plane * p.pstride + x : x * p.cin + plane;
}

__device__ __forceinline__ void segment_of(const D2sParams& p, long long item, long long& row,
                                           int& x0, int& npx) {
  row = item / p.nseg;
  x0 = (int)(item - row * p.nseg) * p.seg_px;
  npx = min(p.seg_px, p.w - x0);
}

// Input element of plane k, pixel x0 + xx of input row `row` (b * h + y).
template <typename T, bool PLANAR>
__device__ __forceinline__ const T* src_of(const T* x, const D2sParams& p, long long row, int x0,
                                           int k) {
  if (!PLANAR) return x + (row * p.w + x0) * p.cin + k;
  const long long b = row / p.h, y = row - b * p.h;
  return x + ((b * p.cin + k) * p.h + y) * p.w + x0;
}

template <typename T, bool PLANAR>
__device__ __forceinline__ void issue(const T* x, unsigned char* smem, uint64_t* full,
                                      const D2sParams& p, long long item, int st) {
  long long row;
  int x0, npx;
  segment_of(p, item, row, x0, npx);
  unsigned char* dst = smem + st * p.stage;
  if (!PLANAR) {
    const unsigned bytes = (unsigned)npx * p.cin * sizeof(T);
    nt_mbar_expect_tx(&full[st], bytes);
    nt_bulk_load(dst, src_of<T, false>(x, p, row, x0, 0), bytes, &full[st]);
    return;
  }
  // One bulk copy per plane's row segment, all on the stage's barrier.
  const unsigned bytes = (unsigned)npx * sizeof(T);
  nt_mbar_expect_tx(&full[st], bytes * p.cin);
  for (int k = 0; k < p.cin; ++k)
    nt_bulk_load(dst + (size_t)k * p.pstride * sizeof(T), src_of<T, true>(x, p, row, x0, k),
                 bytes, &full[st]);
}

template <typename T, bool PLANAR>
__global__ void __launch_bounds__(D2S_THREADS)
    d2s_packed_kernel(const T* __restrict__ x, T* __restrict__ out, const D2sParams p) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.nstages * p.stage);
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long mine = (p.items - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int sy = tid % p.s, v0 = tid / p.s, dv = nt / p.s;
  int off[VEC];
  if (p.fast) {
    const int phase = v0 % p.pv;
#pragma unroll
    for (int k = 0; k < VEC; ++k) off[k] = src_index<PLANAR>(phase * VEC + k, sy, p);
  }
  if (p.bulk && tid == 0) {
    for (int st = 0; st < p.nstages; ++st) nt_mbar_init(&full[st], 1);
    nt_fence_mbar_init();
    for (int r = 0; r < p.nstages && r < mine; ++r)
      issue<T, PLANAR>(x, smem, full, p, blockIdx.x + (long long)r * gridDim.x, r);
  }
  __syncthreads();

  const long long ostride = (long long)p.w * p.sc;  // elements of an output row
  for (long long r = 0; r < mine; ++r) {
    const int st = (int)(r % p.nstages);
    T* buf = reinterpret_cast<T*>(smem + st * p.stage);
    const long long item = blockIdx.x + r * gridDim.x;
    long long row;
    int x0, npx;
    segment_of(p, item, row, x0, npx);
    if (p.bulk) {
      nt_mbar_wait(&full[st], (unsigned)(r / p.nstages) & 1);
    } else if (!PLANAR) {
      const T* src = src_of<T, false>(x, p, row, x0, 0);
      for (int e = tid; e < npx * p.cin; e += nt) buf[e] = src[e];
      __syncthreads();
    } else {
      // Each plane's row segment, neighbouring threads on neighbouring x.
      const T* src = src_of<T, true>(x, p, row, x0, 0);
      const long long plane = (long long)p.h * p.w;
      for (int e = tid; e < npx * p.cin; e += nt) {
        const int k = e / npx, xx = e - k * npx;
        buf[k * p.pstride + xx] = src[k * plane + xx];
      }
      __syncthreads();
    }
    const int n_out = npx * p.sc;  // elements of the segment in each output row
    const int nv = (n_out + VEC - 1) / VEC;
    T* orow = out + (row * p.s + sy) * ostride + (long long)x0 * p.sc;
    const int dg = p.fast ? dv / p.pv : 0;
    int g = p.fast ? v0 / p.pv : 0;  // this thread's period in the segment
    for (int v = v0; v < nv; v += dv, g += dg) {
      const int e0 = v * VEC, n = min(VEC, n_out - e0);
      alignas(16) T vals[VEC] = {};
      if (p.fast) {
        const T* grp = buf + g * p.gstride;
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          if (k < n) vals[k] = grp[off[k]];
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          if (k < n) vals[k] = buf[src_index<PLANAR>(e0 + k, sy, p)];
      }
      T* dst = orow + e0;
      if (p.vec_out && n == VEC) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(vals);
      } else {
        for (int k = 0; k < n; ++k) dst[k] = vals[k];
      }
    }
    __syncthreads();  // every read of stage st is done
    if (p.bulk && tid == 0 && r + p.nstages < mine)
      issue<T, PLANAR>(x, smem, full, p, item + (long long)p.nstages * gridDim.x, st);
  }
}

struct D2sLaunch {
  D2sParams p;
  int grid, threads, smem;
};

template <typename T, bool PLANAR>
cudaError_t plan(const void* x, const void* out, int b, int h, int w, int c, int s,
                 D2sLaunch& l) {
  constexpr int VEC = 16 / sizeof(T), es = sizeof(T);
  if (b < 1 || h < 1 || w < 1 || c < 1 || s < 1) return cudaErrorInvalidValue;
  NtDeviceLimits lim;
  cudaError_t err = nt_device_limits(lim);
  if (err != cudaSuccess) return err;
  int dev;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  D2sParams& p = l.p;
  p.h = h;
  p.w = w;
  p.c = c;
  p.s = s;
  p.sc = s * c;
  p.cin = c * s * s;
  const int g = std::gcd(VEC, p.sc);
  p.gpx = VEC / g;
  p.pv = p.sc / g;
  p.fast = (long long)s * p.pv <= D2S_THREADS;
  const int unit = p.fast ? s * p.pv : s;
  if (unit > D2S_THREADS) return cudaErrorInvalidValue;
  l.threads = D2S_THREADS / unit * unit;
  // Segments are whole periods; planar ones also whole 16-byte runs (gpx
  // divides VEC), so that every plane row segment starts on 16 bytes.
  const int step = PLANAR ? VEC : p.gpx;
  const long long px_bytes = (long long)p.cin * es;  // staged bytes a pixel
  const long long seg_px = std::min<long long>(std::max<long long>(1, SEG_BYTES / (step * px_bytes)),
                                               (w + step - 1) / step) * step;
  // Planar: each plane's row padded by 16 bytes (the planes start in other banks).
  const long long pstride = PLANAR ? seg_px + VEC : 0;
  const long long stage = ((PLANAR ? pstride : seg_px) * px_bytes + 127) / 128 * 128;
  const int room = lim.smem - MAX_STAGES * 8;
  if (stage > room || seg_px * p.cin > INT32_MAX) return cudaErrorInvalidValue;
  p.seg_px = (int)seg_px;
  p.pstride = (int)pstride;
  p.gstride = PLANAR ? p.gpx : p.gpx * p.cin;
  p.nseg = (int)((w + seg_px - 1) / seg_px);
  p.items = (long long)b * h * p.nseg;
  p.stage = (int)stage;
  p.nstages = (int)std::min<long long>(MAX_STAGES, room / stage);
  p.bulk = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
           (long long)w * (PLANAR ? 1 : p.cin) * es % 16 == 0;
  p.vec_out = reinterpret_cast<uintptr_t>(out) % 16 == 0 && (long long)w * p.sc * es % 16 == 0;
  l.smem = p.nstages * p.stage + MAX_STAGES * 8;

  // Blocks an SM holds at this block size and shared memory (the last query
  // per device is kept).
  static int configured[64] = {};
  static int last[64][3] = {};  // threads, shared bytes, blocks per SM
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(d2s_packed_kernel<T, PLANAR>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, lim.smem);
    if (err != cudaSuccess) return err;
    configured[dev] = 1;
  }
  if (last[dev][0] != l.threads || last[dev][1] != l.smem || last[dev][2] < 1) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, d2s_packed_kernel<T, PLANAR>,
                                                        l.threads, l.smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    last[dev][0] = l.threads;
    last[dev][1] = l.smem;
    last[dev][2] = per_sm;
  }
  l.grid = (int)std::min<long long>(p.items, (long long)lim.sms * last[dev][2]);
  return cudaSuccess;
}

template <typename T, bool PLANAR>
cudaError_t run(const void* x, void* out, int b, int h, int w, int c, int s, int* rec,
                cudaStream_t stream) {
  D2sLaunch l;
  cudaError_t err = plan<T, PLANAR>(x, out, b, h, w, c, s, l);
  if (err != cudaSuccess) return err;
  if (rec != nullptr) {
    cudaFuncAttributes a;
    if ((err = cudaFuncGetAttributes(&a, d2s_packed_kernel<T, PLANAR>)) != cudaSuccess)
      return err;
    const int r[11] = {l.grid, l.threads, l.smem, (int)a.sharedSizeBytes, a.numRegs,
                       (int)a.localSizeBytes, (int)std::min<long long>(l.p.items, INT32_MAX),
                       l.p.seg_px, l.p.nstages, l.p.bulk, l.p.fast};
    for (int i = 0; i < 11; ++i) rec[i] = r[i];
    return cudaSuccess;
  }
  d2s_packed_kernel<T, PLANAR><<<l.grid, l.threads, l.smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), l.p);
  return cudaGetLastError();
}

int d2s(const void* x, void* out, int b, int h, int w, int c, int s, int dtype, bool planar,
        int* rec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == NT_BF16)
    return (int)(planar ? run<uint16_t, true> : run<uint16_t, false>)(x, out, b, h, w, c, s, rec,
                                                                       st);
  if (dtype == NT_F32)
    return (int)(planar ? run<uint32_t, true> : run<uint32_t, false>)(x, out, b, h, w, c, s, rec,
                                                                       st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int nt_d2s_packed(const void* x, void* out, int b, int h, int w,
                             int c, int s, int dtype, void* stream) {
  return d2s(x, out, b, h, w, c, s, dtype, false, nullptr, stream);
}

extern "C" int nt_d2s_packed_launch(const void* x, const void* out, int b, int h, int w, int c,
                                    int s, int dtype, int* rec, void* stream) {
  return d2s(x, const_cast<void*>(out), b, h, w, c, s, dtype, false, rec, stream);
}

extern "C" int nt_d2s_packed_planar(const void* x, void* out, int b, int h, int w, int c,
                                    int s, int dtype, void* stream) {
  return d2s(x, out, b, h, w, c, s, dtype, true, nullptr, stream);
}

extern "C" int nt_d2s_packed_planar_launch(const void* x, const void* out, int b, int h, int w,
                                           int c, int s, int dtype, int* rec, void* stream) {
  return d2s(x, const_cast<void*>(out), b, h, w, c, s, dtype, true, rec, stream);
}

extern "C" const char* nt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
