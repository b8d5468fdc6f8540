// The float32 dense convolution and RDB fusion: one implicit-GEMM kernel
// family on the CUDA cores, FP32 FMAs only (no TF32).
//
// With conv_chain.cu (bfloat16) it replaces the dense layers of
// nerve_tpu/ops/conv_chain.py `_chain_kernel`, and with rdb.cu the dense
// layers and the local feature fusion of nerve_tpu/ops/rdb.py `_rdb_kernel`,
// for float32 activations: the continual and federated training paths, and
// float32 serving. conv_f32.cu instantiates the dense layer (`nt_conv2d`,
// NT_F32), rdb.cu the fusion (`nt_rdb_lff`, NT_F32): the same kernel as a
// 1x1 layer over the block's concatenation with the fusion's epilogue, as
// the bfloat16 route shares `conv_wgmma`.
//
// Numerics: every product is an fmaf into a float32 sum (the route's
// contract, "kept exact, no TF32": 1e-4 of max|plain| with TF32 off); the
// dense epilogue adds the float32 bias and applies relu; the fusion's is
// (sum + bias) * res_scale + cat[p, n], each operation rounded to nearest
// as `lff_plain` computes it.
//
// Bound. The 64 -> 64 3x3 layer at 1080p does 153 GFLOP against 1.1 GB: its
// bound is the float32 peak (2.28 ms at 67 TFLOP/s); the fusion 224 -> 64
// likewise (0.89 ms by operations, 0.71 by bytes). An SM issues 128 FMAs a
// clock but reads 32 shared-memory words, so what caps an FMA kernel is
// how many shared-memory words (and issue slots) each FMA costs; the
// narrow heads (3 -> 32, 3 -> 64) are bound by their output's bytes.
//
// Design:
//   * Implicit GEMM: M is a tile of TH x 32 output pixels, N a tile of NT
//     output channels (NT_F32_CFG by cout: 4, 16, 32 or 64; wider layers walk
//     N tiles), K the taps x input channels in chunks of NT_F32_CHUNK. A warp
//     owns O output channels (8; 16 for the 1x1 layer's 64-wide tile; 4
//     for cout <= 4) of an 8-row x 32-column pixel block, a lane one column
//     of it: each thread keeps an 8-pixel x O-channel tile of sums in
//     registers. A grid of fewer than two tiles an SM (the meta step's 4 x
//     64^2 frames) takes the next narrower tile while that gives more
//     tiles, and then, in a block of at most 128 threads, splits each K
//     chunk's groups over two warp sets whose sums meet in shared memory at
//     the tile's end (twice the warps on the same outputs).
//   * The 3x3 layer's input is staged as 4-channel groups [IH][IW][4]: a
//     lane reads one 16-byte vector (four channels of a pixel), neighbouring
//     lanes neighbouring pixels, so the reads are LDS.128 without bank
//     conflicts.
//     For each group and horizontal tap kx a thread reads the column
//     segment of 8 + K - 1 pixels once and uses it for the K vertical
//     taps; the weights of (channel, tap) are warp-uniform 16-byte
//     broadcasts. Per group and kx: 10 + 24 loads for 768 FMAs, 0.08
//     shared-memory wavefronts an FMA instruction where a broadcast is one,
//     so neither shared memory nor the issue slots hold the FMAs far below
//     the peak. The 1x1 layer has no vertical taps to reuse a column
//     segment across, so its 64-wide tile gives a thread 16 channels: 8 +
//     16 loads for 512 FMAs; its input arrives as 16-channel boxes (64-byte
//     rows in TMA's 64-byte swizzle, a lane's 16-byte piece of a row at
//     piece ^ ((pixel >> 1) & 3)), a quarter of the 4-channel boxes'
//     requests.
//   * Asynchronous staging on a ring of up to F32_MAX_STAGES stages, one
//     barrier a K chunk: where a pixel is a multiple of 16 bytes (cin % 4
//     == 0, every 64-wide site and RDB buffer) each staged group arrives
//     by one TMA box of a 4-D tensor map (C, W, H, B) whose zero fill is
//     the SAME padding, the ragged edge and the channels past cin; any
//     other stride (the 3-channel heads' 12-byte pixels: TMA needs 16-byte
//     strides) by 4-byte cp.async with zero fill. The route is the shape's
//     (ops/conv_chain.py `f32_input_route`), never a fallback.
//   * A last group of 3 channels (the 3-channel heads) runs only its own
//     channels: the head is K = 27, not padded.
//   * Weights: float32 HWIO as the model keeps them, copied by cp.async
//     (16 bytes where cout is a multiple of 4; zero past cin and cout).
//     They stay resident in shared memory where they fit beside
//     F32_MIN_RESIDENT_STAGES stages (the 224 -> 64 fusion 57 KB, a 64 -> 64
//     3x3 layer 147 KB), each chunk's arriving with the block's first tile's
//     item of that chunk; otherwise each stage carries its chunk's weights
//     (the RDB's 160- and 192-channel layers).
//   * Persistent blocks walk (batch, row band, column, N tile) tiles; the
//     ring runs on across tiles, so one tile's epilogue and stores overlap
//     the next tile's loads.
//   * List inputs (up to 3 parts of equal width) are read in place: a
//     tensor map per part on the TMA route, a pointer per part on the
//     cp.async route.
//   * Epilogue: the tile's output leaves unit by unit (8 rows x 32 pixels
//     x at most 32 channels), each staged in shared memory in the TMA
//     swizzle of its 128-, 64- or 16-byte rows and written by one TMA store
//     of whole lines into channel slot [ocoff, ocoff + cout) of a wider
//     output (an RDB grows its concatenation in place): a warp's lanes hold
//     neighbouring pixels, so stores straight from registers touch a cache
//     line per lane (the 3 -> 32 head at 1080p, 265 MB of output, took
//     0.37-0.41 ms so on an H100 and 0.22-0.27 ms staged, by
//     diag.federated.float32_layers). Where the
//     staging area would cost the weights' residency or a third stage, or
//     the output's layout takes no TMA store, the registers store 16 bytes
//     a pixel where the layout allows.
//
// What it still gives up: one block of 8 warps an SM where the weights are
// resident (latency is hidden by each thread's 64 independent sums, not by
// more warps); an 8-row 3x3 tile stages 25 % more input rows than it holds;
// the 1x1 layer reaches less of its bound than the 3x3 one (a staged input
// vector feeds 64 FMAs, not 192: shared-memory reads and the barrier a
// chunk weigh three times as much); the output units leave one at a time,
// each waiting for the last one's store to have read the staging area;
// cp.async stages 4 bytes at a time; at the meta step's frame sizes the
// wrapper's host work takes as long as the kernel.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "nerve_tpu_torch.h"

namespace ntf32 {

constexpr int F32_P = 8;    // output pixels a thread, down a column
constexpr int F32_TW = 32;  // tile columns: one a lane
constexpr int F32_MAX_STAGES = 4, F32_MIN_RESIDENT_STAGES = 3;
// The ring's mbarriers, at the start of shared memory; the regions after
// them start on 1024 bytes (the 64-byte swizzle of the 1x1 layer's boxes
// follows the address bits above 128).
constexpr int F32_BAR_BYTES = 1024;
// A small grid's blocks of at most F32_SPLIT_THREADS threads split each K
// chunk's groups over F32_SPLIT warp sets, whose sums meet in shared memory.
constexpr int F32_SPLIT = 2, F32_SPLIT_THREADS = 128;
// By kernel size (1x1, 3x3) and cout: (largest cout, output channels a
// thread, warps across N, warps down M). The 1x1 layer's 64-wide tile takes
// 16 channels a thread: with no vertical taps to reuse a staged input vector
// across, each serves 16 output channels; the 3x3 layer's keeps 8, which
// ran faster there on an H100 (fewer registers, a smaller unrolled body).
#define NT_F32_CFG                                                  \
  {{{4, 4, 1, 4}, {16, 8, 2, 2}, {32, 8, 4, 1}, {64, 16, 4, 2}},    \
   {{4, 4, 1, 4}, {16, 8, 2, 2}, {32, 8, 4, 1}, {64, 8, 8, 1}}}
// Input channels of a K chunk (a ring stage): 1x1, 3x3.
#define NT_F32_CHUNK {16, 8}

// The tables' entries (device code reads its own copies of them: it may not
// read a host array).
__host__ __device__ constexpr int f32_cfg(int k, int cfg, int i) {
  constexpr int t[2][4][4] = NT_F32_CFG;
  return t[k == 3][cfg][i];
}
__host__ __device__ constexpr int f32_chunk(int k) {
  constexpr int t[2] = NT_F32_CHUNK;
  return t[k == 3];
}
// Channels of one staged group (one TMA box): 16 for the 1x1 layer (64-byte
// box rows in the 64-byte swizzle), 4 for the 3x3 layer (16-byte rows).
__host__ __device__ constexpr int f32_group_channels(int k) { return k == 1 ? 16 : 4; }
// The most threads a block of configuration `cfg` runs (split or not).
__host__ __device__ constexpr int f32_max_threads(int k, int cfg) {
  return 32 * f32_cfg(k, cfg, 2) * f32_cfg(k, cfg, 3) *
         (32 * f32_cfg(k, cfg, 2) * f32_cfg(k, cfg, 3) <= F32_SPLIT_THREADS ? F32_SPLIT : 1);
}

enum { F32_ROUTE_TMA = 0, F32_ROUTE_ASYNC = 1 };
enum { F32_EPI_CONV = 0, F32_EPI_LFF = 1 };

__host__ __device__ constexpr int f32_round128(long long v) { return (int)((v + 127) / 128 * 128); }

struct F32Params {
  const float* x[3];  // input parts (channel stride xcs each)
  int nx, xcs, cin, cout;
  int h, w, ocs, ocoff, relu, vec;
  int tiles_x, tiles_y, ncot, ntiles, nchunks, ngroups;
  int resident, stages, stage_bytes, wbytes;
  int split, red_off;  // warp sets over each chunk's groups; their sums' area (bytes in)
  int tstore, out_off;  // the tile's output staged at out_off and stored by TMA
  const float* wt;  // HWIO (k, k, cin, cout)
  int wvec;         // cout % 4 == 0 and wt 16-byte aligned: 16-byte weight copies
  const float* bias;
  float* out;
  const float* res;  // F32_EPI_LFF: the residual, channels [0, cout) of res (stride rcs)
  int rcs, rvec;
  float res_scale;
};

// The host plan of a launch (ops/conv_chain.py `f32_plan` is the same rule).
struct F32Plan {
  int cfg, o, wn, wm, nt, threads, th, ck, ih, iw, group_bytes, in_bytes;
  int ncot, nchunks, ngroups, wbytes, resident, stage_bytes, stages, smem;
  int split, red_bytes, out_bytes;
  long long tiles;
};

__host__ __device__ constexpr int f32_round1024(long long v) {
  return (int)((v + 1023) / 1024 * 1024);
}

inline long long f32_tiles(int k, int cfg, int cout, int b, int h, int w) {
  const int th = F32_P * f32_cfg(k, cfg, 3), nt = f32_cfg(k, cfg, 1) * f32_cfg(k, cfg, 2);
  return (long long)b * ((h + th - 1) / th) * ((w + F32_TW - 1) / F32_TW) * ((cout + nt - 1) / nt);
}

inline bool f32_plan(int cin, int cout, int k, int b, int h, int w, int smem_limit, int sms,
                     F32Plan& pl) {
  if (cin < 1 || cout < 1 || (k != 1 && k != 3)) return false;
  int cfg = 0;
  while (cfg < 3 && cout > f32_cfg(k, cfg, 0)) ++cfg;
  // A grid of fewer than two tiles an SM takes the next narrower
  // configuration while that gives more tiles.
  while (cfg > 0 && f32_tiles(k, cfg, cout, b, h, w) < 2LL * sms &&
         f32_tiles(k, cfg - 1, cout, b, h, w) > f32_tiles(k, cfg, cout, b, h, w))
    --cfg;
  pl.cfg = cfg;
  pl.o = f32_cfg(k, cfg, 1);
  pl.wn = f32_cfg(k, cfg, 2);
  pl.wm = f32_cfg(k, cfg, 3);
  pl.nt = pl.o * pl.wn;
  pl.tiles = f32_tiles(k, cfg, cout, b, h, w);
  // Still fewer than two tiles an SM: split the K chunks' groups over two
  // warp sets where the block is small and the input has several groups.
  const int base = 32 * pl.wn * pl.wm;
  pl.split = pl.tiles < 2LL * sms && base <= F32_SPLIT_THREADS && cin > 4 ? F32_SPLIT : 1;
  pl.threads = base * pl.split;
  pl.red_bytes = (pl.split - 1) * base * F32_P * pl.o * 4;
  pl.th = F32_P * pl.wm;
  pl.ck = f32_chunk(k);
  pl.ih = pl.th + k - 1;
  pl.iw = F32_TW + k - 1;
  const int gc = f32_group_channels(k);
  pl.group_bytes = f32_round128((long long)pl.ih * pl.iw * gc * 4);
  pl.in_bytes = pl.ck / gc * pl.group_bytes;
  pl.ncot = (cout + pl.nt - 1) / pl.nt;
  pl.ngroups = (cin + gc - 1) / gc;
  pl.nchunks = (pl.ngroups * gc + pl.ck - 1) / pl.ck;
  pl.wbytes = f32_round1024((long long)pl.ngroups * gc * k * k * pl.nt * 4);
  // The ring (and resident weights) beside the staging area of one output
  // unit (8 rows x 32 pixels x at most 32 channels) where that keeps the
  // weights' residency and three stages; else register stores. A block of
  // at most 128 threads keeps to half the opt-in shared memory where that
  // keeps the weights' residency, so that two blocks share an SM.
  struct Fit {
    int resident, stage_bytes, stages, out_bytes, smem;
  };
  const int unit = F32_P * F32_TW * (pl.nt < 32 ? pl.nt : 32) * 4;
  auto fit = [&](int limit, int out_bytes) {
    Fit f;
    const int avail = limit - F32_BAR_BYTES - pl.red_bytes - (out_bytes ? out_bytes + 1024 : 0);
    f.resident = pl.ncot == 1 && pl.wbytes + F32_MIN_RESIDENT_STAGES * pl.in_bytes <= avail;
    f.stage_bytes = f32_round1024(
        pl.in_bytes + (f.resident ? 0 : f32_round128((long long)pl.ck * k * k * pl.nt * 4)));
    f.stages = (avail - (f.resident ? pl.wbytes : 0)) / f.stage_bytes;
    if (f.stages > F32_MAX_STAGES) f.stages = F32_MAX_STAGES;
    f.out_bytes = out_bytes;
    f.smem = F32_BAR_BYTES + (f.resident ? pl.wbytes : 0) + f.stages * f.stage_bytes +
             pl.red_bytes;
    if (out_bytes) f.smem = f32_round1024(f.smem) + out_bytes;
    return f;
  };
  auto best = [&](int limit) {
    const Fit plain = fit(limit, 0), staged = fit(limit, unit);
    return staged.resident == plain.resident && staged.stages >= 3 ? staged : plain;
  };
  Fit f = best(smem_limit);
  if (pl.threads <= F32_SPLIT_THREADS) {
    const Fit half = best(smem_limit / 2 - 1024);
    if (half.stages >= 2 && half.resident == f.resident) f = half;
  }
  if (f.stages < 2) return false;
  pl.resident = f.resident;
  pl.stage_bytes = f.stage_bytes;
  pl.stages = f.stages;
  pl.out_bytes = f.out_bytes;
  pl.smem = f.smem;
  return true;
}

__device__ __forceinline__ void f32_cp_async4(void* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(nt_smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void f32_cp_async16(void* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(nt_smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void f32_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void f32_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Wait until the cp.async groups of all but the newest `pending` are done.
__device__ __forceinline__ void f32_cp_wait_n(int pending) {
  if (pending >= 2) f32_cp_wait<2>();
  else if (pending == 1) f32_cp_wait<1>();
  else f32_cp_wait<0>();
}

__device__ __forceinline__ float f32_lane(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// The sums of one 4-channel group (CV of its channels real): xin is this
// thread's column in the group's staged tile, wg the group's weights
// [channel][tap][NT] at this warp's O channels.
template <int K, int O, int IW, int CV>
__device__ __forceinline__ void f32_group(const float4* __restrict__ xin,
                                          const float* __restrict__ wg, int nt,
                                          float (&acc)[F32_P][O]) {
#pragma unroll 1
  for (int kx = 0; kx < K; ++kx) {
    float4 seg[F32_P + K - 1];
#pragma unroll
    for (int j = 0; j < F32_P + K - 1; ++j) seg[j] = xin[j * IW + kx];
#pragma unroll
    for (int c = 0; c < CV; ++c) {
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
        const float4* wp = reinterpret_cast<const float4*>(wg + (c * K * K + ky * K + kx) * nt);
        float wv[O];
#pragma unroll
        for (int q = 0; q < O / 4; ++q) {
          const float4 t = wp[q];
          wv[4 * q] = t.x;
          wv[4 * q + 1] = t.y;
          wv[4 * q + 2] = t.z;
          wv[4 * q + 3] = t.w;
        }
#pragma unroll
        for (int j = 0; j < F32_P; ++j) {
          const float a = f32_lane(seg[j + ky], c);
#pragma unroll
          for (int q = 0; q < O; ++q) acc[j][q] = fmaf(a, wv[q], acc[j][q]);
        }
      }
    }
  }
}

__device__ __forceinline__ void f32_decode(const F32Params& p, int t, int& cot, int& tx, int& ty,
                                           int& b) {
  cot = t % p.ncot;
  t /= p.ncot;
  tx = t % p.tiles_x;
  t /= p.tiles_x;
  ty = t % p.tiles_y;
  b = t / p.tiles_y;
}

// The kernel body: m0..m2 are the input parts' tensor maps (TMA route).
template <int K, int CFG, bool TMA, int EPI>
__device__ __forceinline__ void conv_f32(const CUtensorMap* m0, const CUtensorMap* m1,
                                         const CUtensorMap* m2, const CUtensorMap* om,
                                         const F32Params& p) {
  constexpr int O = f32_cfg(K, CFG, 1), WN = f32_cfg(K, CFG, 2), WM = f32_cfg(K, CFG, 3);
  constexpr int NT = O * WN, TH = F32_P * WM, WARPS = WN * WM;
  constexpr int R = K / 2, IH = TH + 2 * R, IW = F32_TW + 2 * R, TAPS = K * K;
  constexpr int CK = f32_chunk(K), GC = f32_group_channels(K), GROUPS = CK / GC;
  constexpr int GROUP_BYTES = f32_round128((long long)IH * IW * GC * 4);
  constexpr int IN_BYTES = GROUPS * GROUP_BYTES;
  // The staged output's box rows: at most 32 channels (128 bytes), in the
  // TMA swizzle of their width, so that a warp's writes (neighbouring
  // pixels, one 16-byte piece each) meet no bank conflicts.
  constexpr int RB = (NT < 32 ? NT : 32) * 4, CPR = RB / 16;
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* wres = reinterpret_cast<float*>(smem + F32_BAR_BYTES);
  unsigned char* ring = smem + F32_BAR_BYTES + (p.resident ? p.wbytes : 0);
  const int tid = threadIdx.x, nthreads = blockDim.x, warp = tid / 32, lane = tid % 32;
  const int wk = warp / WARPS, wn = warp % WN, wm = (warp % WARPS) / WN;

  if (TMA && tid == 0) {
    for (int s = 0; s < p.stages; ++s) nt_mbar_init(&full[s], 1);
    nt_fence_mbar_init();
  }
  const int ntiles_mine =
      (int)blockIdx.x < p.ntiles ? (p.ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int nitems = ntiles_mine * p.nchunks;
  __syncthreads();

  // Item j of the block's walk: tile blockIdx.x + (j / nchunks) * gridDim.x, K chunk j % nchunks.
  auto issue = [&](int j) {
    const int k = j / p.nchunks, chunk = j - k * p.nchunks;
    int cot, tx, ty, b;
    f32_decode(p, (int)blockIdx.x + k * (int)gridDim.x, cot, tx, ty, b);
    const int s = j % p.stages, g0 = chunk * GROUPS;
    const int ng = min(GROUPS, p.ngroups - g0);
    unsigned char* st = ring + s * p.stage_bytes;
    const int x0 = tx * F32_TW - R, y0 = ty * TH - R;
    if constexpr (TMA) {
      if (tid == 0) {
        nt_mbar_expect_tx(&full[s], (unsigned)(ng * IH * IW * GC * 4));
        for (int g = 0; g < ng; ++g) {
          const int c = (g0 + g) * GC, part = p.nx == 1 ? 0 : min(c / p.xcs, p.nx - 1);
          nt_tma_load_4d(st + g * GROUP_BYTES, part == 0 ? m0 : part == 1 ? m1 : m2, &full[s],
                         c - part * p.xcs, x0, y0, b);
        }
      }
    } else {
      for (int e = tid; e < ng * IH * IW * GC; e += nthreads) {
        const int g = e / (IH * IW * GC), r = e - g * (IH * IW * GC);
        const int pix = r / GC, cg = r - pix * GC, iy = pix / IW, ix = pix - iy * IW;
        const int c = (g0 + g) * GC + cg, gy = y0 + iy, gx = x0 + ix;
        const bool ok = c < p.cin && gy >= 0 && gy < p.h && gx >= 0 && gx < p.w;
        const int part = p.nx == 1 ? 0 : min(c / p.xcs, p.nx - 1);
        const float* src = p.x[part] + (((size_t)b * p.h + gy) * p.w + gx) * p.xcs +
                           (c - part * p.xcs);
        // The 1x1 layer's 64-byte rows as TMA's 64-byte swizzle lays them.
        const int off = GC == 16 ? pix * 64 + (((cg >> 2) ^ ((pix >> 1) & 3)) << 4) + (cg & 3) * 4
                                 : r * 4;
        f32_cp_async4(st + g * GROUP_BYTES + off, ok ? src : p.x[0], ok);
      }
    }
    // This chunk's weights, [channel][tap][NT]: into the stage, or (resident)
    // into their place in the resident copy while the block's first tile
    // walks the chunks, so that the first products wait for one chunk only.
    if (!p.resident || j < p.nchunks) {
      float* sw = p.resident ? wres + (size_t)chunk * CK * TAPS * NT
                             : reinterpret_cast<float*>(st + IN_BYTES);
      const int nrows = (p.resident ? min(CK, p.ngroups * GC - chunk * CK) : CK) * TAPS;
      if (p.wvec) {
        for (int e = tid; e < nrows * (NT / 4); e += nthreads) {
          const int row = e / (NT / 4), nn = (e - row * (NT / 4)) * 4;
          const int cl = row / TAPS, tap = row - cl * TAPS;
          const int c = chunk * CK + cl, n = cot * NT + nn;
          const bool ok = c < p.cin && n < p.cout;
          f32_cp_async16(sw + row * NT + nn,
                         ok ? p.wt + ((size_t)tap * p.cin + c) * p.cout + n : p.wt, ok);
        }
      } else {
        for (int e = tid; e < nrows * NT; e += nthreads) {
          const int row = e / NT, nn = e - row * NT, cl = row / TAPS, tap = row - cl * TAPS;
          const int c = chunk * CK + cl, n = cot * NT + nn;
          const bool ok = c < p.cin && n < p.cout;
          f32_cp_async4(sw + e, ok ? p.wt + ((size_t)tap * p.cin + c) * p.cout + n : p.wt, ok);
        }
      }
    }
  };

  for (int j = 0; j < p.stages - 1; ++j) {
    if (j < nitems) issue(j);
    f32_cp_commit();
  }
  float acc[F32_P][O];
#pragma unroll
  for (int j = 0; j < F32_P; ++j)
#pragma unroll
    for (int q = 0; q < O; ++q) acc[j][q] = 0.f;

  for (int i = 0; i < nitems; ++i) {
    // Item i's copies have landed for every thread, and every thread is
    // done with item i - 1's stage.
    f32_cp_wait_n(p.stages - 2);
    __syncthreads();
    if (i + p.stages - 1 < nitems) issue(i + p.stages - 1);
    f32_cp_commit();
    const int s = i % p.stages, k = i / p.nchunks, chunk = i - k * p.nchunks;
    if constexpr (TMA) nt_mbar_wait(&full[s], (unsigned)((i / p.stages) & 1));
    const unsigned char* st = ring + s * p.stage_bytes;
    const float* sw = p.resident ? wres + (size_t)chunk * CK * TAPS * NT
                                 : reinterpret_cast<const float*>(st + IN_BYTES);
    // The chunk's 4-channel quads past cin are zero: skipped.
    const int nq = min(CK / 4, (p.cin + 3) / 4 - chunk * (CK / 4));
    for (int u = wk; u < nq; u += p.split) {
      const float* wg = sw + u * 4 * TAPS * NT + wn * O;
      // A last quad of 3 channels (the 3-channel heads) runs its 3; one of 1
      // or 2 runs 4, the others zero-filled in the stage and the weights.
      const bool three = !TMA && p.cin - (chunk * (CK / 4) + u) * 4 == 3;
      if constexpr (GC == 16) {
        // Quad u is the 16-byte piece u % 4 of each 64-byte row of box
        // u / 4, which the swizzle moves to (u % 4) ^ ((pixel >> 1) & 3).
        const unsigned char* row = st + (u / 4) * GROUP_BYTES +
                                   (wm * F32_P * F32_TW + lane) * 64 +
                                   ((((u & 3) ^ ((lane >> 1) & 3))) << 4);
        const float4* xin = reinterpret_cast<const float4*>(row);
        if (three) f32_group<1, O, F32_TW * 4, 3>(xin, wg, NT, acc);
        else f32_group<1, O, F32_TW * 4, 4>(xin, wg, NT, acc);
      } else {
        const float4* xin =
            reinterpret_cast<const float4*>(st + u * GROUP_BYTES) + wm * F32_P * IW + lane;
        if (three) f32_group<K, O, IW, 3>(xin, wg, NT, acc);
        else f32_group<K, O, IW, 4>(xin, wg, NT, acc);
      }
    }
    if (chunk != p.nchunks - 1) continue;

    // Split: warp set wk > 0 hands its sums to set 0 through shared memory
    // ([set - 1][warp][pixel][channel][lane]).
    if (p.split > 1) {
      float* red = reinterpret_cast<float*>(smem + p.red_off) +
                   (warp % WARPS) * (F32_P * O * 32) + lane;
      if (wk > 0) {
#pragma unroll
        for (int j = 0; j < F32_P; ++j)
#pragma unroll
          for (int q = 0; q < O; ++q) {
            red[(wk - 1) * WARPS * F32_P * O * 32 + (j * O + q) * 32] = acc[j][q];
            acc[j][q] = 0.f;
          }
      }
      __syncthreads();
      if (wk == 0)
        for (int kk = 1; kk < p.split; ++kk)
#pragma unroll
          for (int j = 0; j < F32_P; ++j)
#pragma unroll
            for (int q = 0; q < O; ++q)
              acc[j][q] += red[(kk - 1) * WARPS * F32_P * O * 32 + (j * O + q) * 32];
    }

    // Epilogue of the tile (warp set 0 holds the sums).
    int cot, tx, ty, b;
    f32_decode(p, (int)blockIdx.x + k * (int)gridDim.x, cot, tx, ty, b);
    const int gx = tx * F32_TW + lane, n0 = cot * NT + wn * O;
    float bias[O];
#pragma unroll
    for (int q = 0; q < O; ++q) bias[q] = n0 + q < p.cout ? p.bias[n0 + q] : 0.f;
    const bool whole = p.vec && n0 + O <= p.cout;
    if (wk == 0) {
#pragma unroll
      for (int j = 0; j < F32_P; ++j) {
        const int gy = ty * TH + wm * F32_P + j;
        const bool inside = gy < p.h && gx < p.w;
        const size_t pix = ((size_t)b * p.h + gy) * p.w + gx;
        float v[O];
        if constexpr (EPI == F32_EPI_LFF) {
          float r[O];
          const float* rp = p.res + pix * p.rcs + n0;
          if (inside && p.rvec && n0 + O <= p.cout) {
#pragma unroll
            for (int q = 0; q < O / 4; ++q) {
              const float4 t = __ldg(reinterpret_cast<const float4*>(rp) + q);
              r[4 * q] = t.x;
              r[4 * q + 1] = t.y;
              r[4 * q + 2] = t.z;
              r[4 * q + 3] = t.w;
            }
          } else {
#pragma unroll
            for (int q = 0; q < O; ++q) r[q] = inside && n0 + q < p.cout ? rp[q] : 0.f;
          }
#pragma unroll
          for (int q = 0; q < O; ++q)
            v[q] = __fadd_rn(__fmul_rn(__fadd_rn(acc[j][q], bias[q]), p.res_scale), r[q]);
        } else {
#pragma unroll
          for (int q = 0; q < O; ++q) {
            v[q] = acc[j][q] + bias[q];
            if (p.relu) v[q] = fmaxf(v[q], 0.f);
          }
        }
        if (p.tstore) {
#pragma unroll
          for (int q = 0; q < O; ++q) acc[j][q] = v[q];  // kept for the staged units below
          continue;
        }
        if (inside) {
          float* o = p.out + pix * p.ocs + p.ocoff + n0;
          if (whole) {
#pragma unroll
            for (int q = 0; q < O / 4; ++q)
              reinterpret_cast<float4*>(o)[q] = make_float4(v[4 * q], v[4 * q + 1],
                                                            v[4 * q + 2], v[4 * q + 3]);
          } else {
#pragma unroll
            for (int q = 0; q < O; ++q)
              if (n0 + q < p.cout) o[q] = v[q];
          }
        }
#pragma unroll
        for (int q = 0; q < O; ++q) acc[j][q] = 0.f;
      }
    }
    if (p.tstore) {
      // The tile out unit by unit (8 rows x 32 pixels x RB bytes of
      // channels): the warps that hold a unit stage it in the TMA swizzle of
      // its rows (a warp's writes, neighbouring pixels, then meet no bank
      // conflicts), and one TMA store writes it, whole lines, clipping the
      // frame's edges and the channels past the slot.
      for (int u = 0; u < WM * (NT * 4 / RB); ++u) {
        const int ug = u / (NT * 4 / RB), uh = u % (NT * 4 / RB);
        if (tid == 0) nt_bulk_wait_read<0>();  // the last unit's store has read the area
        __syncthreads();
        if (wk == 0 && wm == ug && wn * O * 4 / RB == uh) {
#pragma unroll
          for (int j = 0; j < F32_P; ++j) {
            const int row = j * F32_TW + lane;
            const int sw = RB == 128 ? (row & 7) : RB == 64 ? ((row >> 1) & 3) : 0;
#pragma unroll
            for (int q = 0; q < O / 4; ++q) {
              const int cc = wn * (O / 4) + q - uh * CPR;
              *reinterpret_cast<float4*>(smem + p.out_off + row * RB + ((cc ^ sw) * 16)) =
                  make_float4(acc[j][4 * q], acc[j][4 * q + 1], acc[j][4 * q + 2],
                              acc[j][4 * q + 3]);
            }
          }
        }
        nt_fence_proxy_async();
        __syncthreads();
        if (tid == 0) {
          nt_tma_store_4d(om, smem + p.out_off, p.ocoff + cot * NT + uh * (RB / 4), tx * F32_TW,
                          ty * TH + ug * F32_P, b);
          nt_bulk_commit();
        }
      }
#pragma unroll
      for (int j = 0; j < F32_P; ++j)
#pragma unroll
        for (int q = 0; q < O; ++q) acc[j][q] = 0.f;
    }
  }
  if (p.tstore && tid == 0) nt_bulk_wait<0>();
  f32_cp_wait<0>();
}

// The parameters and tensor maps of a launch; false where the shapes do not
// fit the kernel (the caller returns cudaErrorInvalidValue).
inline bool f32_setup(const void* const* xs, int nx, int xcs, int cin, int cout, int k, int b,
                      int h, int wd, int tma, const NtDeviceLimits& lim, F32Plan& pl,
                      F32Params& p, CUtensorMap (&maps)[4]) {
  if (nx < 1 || nx > 3 || b < 1 || h < 1 || wd < 1 || xcs < 1 ||
      (nx == 1 ? cin > xcs : cin != nx * xcs) ||
      !f32_plan(cin, cout, k, b, h, wd, lim.smem, lim.sms, pl))
    return false;
  p = F32Params{};
  for (int i = 0; i < 3; ++i) p.x[i] = static_cast<const float*>(xs[i < nx ? i : 0]);
  p.nx = nx;
  p.xcs = xcs;
  p.cin = cin;
  p.cout = cout;
  p.h = h;
  p.w = wd;
  p.tiles_x = (wd + F32_TW - 1) / F32_TW;
  p.tiles_y = (h + pl.th - 1) / pl.th;
  p.ncot = pl.ncot;
  const long long ntiles = (long long)b * p.tiles_y * p.tiles_x * p.ncot;
  if (ntiles > INT32_MAX / 64) return false;
  p.ntiles = (int)ntiles;
  p.nchunks = pl.nchunks;
  p.ngroups = pl.ngroups;
  p.resident = pl.resident;
  p.split = pl.split;
  p.red_off = F32_BAR_BYTES + (pl.resident ? pl.wbytes : 0) + pl.stages * pl.stage_bytes;
  p.out_off = pl.smem - pl.out_bytes;
  p.stages = pl.stages;
  p.stage_bytes = pl.stage_bytes;
  p.wbytes = pl.wbytes;
  for (int i = 0; i < 3; ++i) {
    if (!tma || i >= nx) {
      maps[i] = i > 0 ? maps[0] : CUtensorMap{};
      continue;
    }
    const NtEncodeTiled encode = nt_encode_tiled();
    if (encode == nullptr) return false;
    // (C, W, H, B), innermost first; a box is one 4-channel group of the
    // haloed tile. One part reads channels [0, cin) of xcs.
    const cuuint64_t dims[4] = {(cuuint64_t)(nx == 1 ? cin : xcs), (cuuint64_t)wd, (cuuint64_t)h,
                                (cuuint64_t)b};
    const cuuint64_t strides[3] = {(cuuint64_t)xcs * 4, (cuuint64_t)wd * xcs * 4,
                                   (cuuint64_t)h * wd * xcs * 4};
    const int gc = f32_group_channels(k);
    const cuuint32_t box[4] = {(cuuint32_t)gc, (cuuint32_t)pl.iw, (cuuint32_t)pl.ih, 1};
    const cuuint32_t estr[4] = {1, 1, 1, 1};
    if (encode(&maps[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(xs[i]), dims,
               strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
               gc == 16 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return false;
  }
  return true;
}

// The output's tensor map where the plan stages the output and the
// output's layout takes a TMA store (16-byte pixels and slot start, 16-byte
// aligned): (C, W, H, B) up to the slot's end, a box of one unit (8 rows x
// 32 pixels x at most 32 channels) in the swizzle of its rows; p.tstore
// says whether.
inline bool f32_output_map(const F32Plan& pl, F32Params& p, int b, CUtensorMap& om) {
  om = CUtensorMap{};
  p.tstore = pl.out_bytes > 0 && p.vec;
  if (!p.tstore) return true;
  const NtEncodeTiled encode = nt_encode_tiled();
  if (encode == nullptr) return false;
  const int rb = (pl.nt < 32 ? pl.nt : 32) * 4;
  const cuuint64_t dims[4] = {(cuuint64_t)(p.ocoff + p.cout), (cuuint64_t)p.w, (cuuint64_t)p.h,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)p.ocs * 4, (cuuint64_t)p.w * p.ocs * 4,
                                 (cuuint64_t)p.h * p.w * p.ocs * 4};
  const cuuint32_t box[4] = {(cuuint32_t)(rb / 4), F32_TW, F32_P, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = rb == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : rb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_NONE;
  return encode(&om, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p.out, dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The route by shape: TMA where cin and every part's pixel are multiples of
// 4 channels (16 bytes), every part is 16-byte aligned and, for a 1x1 layer
// on several parts, each part holds whole 16-channel boxes
// (ops/conv_chain.py `f32_input_route`).
inline int f32_route(const void* const* xs, int nx, int xcs, int cin, int k) {
  bool aligned = xcs % 4 == 0 && cin % 4 == 0 && (k == 3 || nx == 1 || xcs % 16 == 0);
  for (int i = 0; i < nx; ++i) aligned = aligned && reinterpret_cast<uintptr_t>(xs[i]) % 16 == 0;
  return aligned ? F32_ROUTE_TMA : F32_ROUTE_ASYNC;
}

// Launch `kernel`, the family's instance <K, CFG, TMA, EPI> (its occupancy
// cached per shared-memory size), or fill rec[] with what it would launch:
// grid, threads, dynamic and static shared bytes, registers, spill bytes,
// tiles, tile height, tile width, N tile, K chunk, stages, weights
// resident, route, split, output staged for a TMA store.
template <int K, int CFG, bool TMA, int EPI, typename Kernel>
cudaError_t f32_launch(Kernel kernel, const F32Plan& pl, const F32Params& p,
                       const CUtensorMap (&maps)[4], int route, const NtDeviceLimits& lim,
                       cudaStream_t stream, int* rec) {
  static int configured_smem[64] = {}, occ_smem[64] = {}, occ_blocks[64] = {};
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (configured_smem[dev] != lim.smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lim.smem);
    if (err != cudaSuccess) return err;
    configured_smem[dev] = lim.smem;
  }
  if (occ_smem[dev] != pl.smem) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, pl.threads, pl.smem);
    if (err != cudaSuccess) return err;
    if (blocks < 1) return cudaErrorInvalidConfiguration;
    occ_blocks[dev] = blocks;
    occ_smem[dev] = pl.smem;
  }
  const int grid = (int)std::min<long long>(p.ntiles, (long long)occ_blocks[dev] * lim.sms);
  if (rec != nullptr) {
    cudaFuncAttributes a;
    if ((err = cudaFuncGetAttributes(&a, kernel)) != cudaSuccess) return err;
    const int r[16] = {grid,     pl.threads,       pl.smem,     (int)a.sharedSizeBytes,
                       a.numRegs, (int)a.localSizeBytes, p.ntiles, pl.th,
                       F32_TW,   pl.nt,            pl.ck,       pl.stages,
                       pl.resident, route,       pl.split,    pl.out_bytes > 0};
    for (int i = 0; i < 16; ++i) rec[i] = r[i];
    return cudaSuccess;
  }
  kernel<<<grid, pl.threads, pl.smem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

// The dense layer's kernel and its launch by configuration and route (each
// source that includes this instantiates what it launches: conv_f32.cu the
// 3x3 instances, conv_f32_1x1.cu the 1x1 ones).

template <int K, int CFG, bool TMA>
__global__ void __launch_bounds__(f32_max_threads(K, CFG), 1)
    conv_f32_kernel(const __grid_constant__ CUtensorMap m0, const __grid_constant__ CUtensorMap m1,
                    const __grid_constant__ CUtensorMap m2,
                    const __grid_constant__ CUtensorMap om, const F32Params p) {
  conv_f32<K, CFG, TMA, F32_EPI_CONV>(&m0, &m1, &m2, &om, p);
}

template <int K, int CFG>
cudaError_t f32_dense_cfg(const F32Plan& pl, const F32Params& p, const CUtensorMap (&maps)[4],
                          int route, const NtDeviceLimits& lim, cudaStream_t st, int* rec) {
  if (route == F32_ROUTE_TMA)
    return f32_launch<K, CFG, true, F32_EPI_CONV>(conv_f32_kernel<K, CFG, true>, pl, p, maps,
                                                  route, lim, st, rec);
  return f32_launch<K, CFG, false, F32_EPI_CONV>(conv_f32_kernel<K, CFG, false>, pl, p, maps,
                                                 route, lim, st, rec);
}

template <int K>
cudaError_t f32_dense_launch(const F32Plan& pl, const F32Params& p,
                             const CUtensorMap (&maps)[4], int route, const NtDeviceLimits& lim,
                             cudaStream_t st, int* rec) {
  switch (pl.cfg) {
    case 0: return f32_dense_cfg<K, 0>(pl, p, maps, route, lim, st, rec);
    case 1: return f32_dense_cfg<K, 1>(pl, p, maps, route, lim, st, rec);
    case 2: return f32_dense_cfg<K, 2>(pl, p, maps, route, lim, st, rec);
    default: return f32_dense_cfg<K, 3>(pl, p, maps, route, lim, st, rec);
  }
}

}  // namespace ntf32

// The 1x1 dense layer's launch (conv_f32_1x1.cu).
cudaError_t nt_conv2d_f32_1x1(const ntf32::F32Plan& pl, const ntf32::F32Params& p,
                              const CUtensorMap (&maps)[4], int route,
                              const NtDeviceLimits& lim, cudaStream_t stream, int* rec);
