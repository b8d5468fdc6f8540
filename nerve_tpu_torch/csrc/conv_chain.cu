// Direct SAME convolution, one dense 3x3 or 1x1 layer per launch.
//
// Replaces nerve_tpu/ops/conv_chain.py `_chain_kernel` (reached via
// `_chain_pallas` <- `conv_chain_fused` <- `conv_chain_apply`) for its dense
// layers; the wrapper runs one launch per layer of a chain. It is also the
// dense-layer kernel of the residual dense block (see rdb.cu): the layer
// reads the leading `cin` channels of a wider buffer and writes its output
// into a channel slot of another, so an RDB grows its concatenation in place.
// Its 1x1 form with the fusion's epilogue (`lff_wgmma_kernel`, N = 64) is
// the RDB's local feature fusion (see rdb.cu).
//
// Numerics follow the reference formulation `_chain_xla`
// (conv_chain.py:411-443): float32 accumulation, the sum rounded to the
// input dtype (as XLA's convolution returns it), float32 bias, optional
// relu, the result rounded to the input dtype.
//
// Bound: arithmetic. At the serving shapes these layers do 0.03-0.46 TFLOP
// each (1.19 TFLOP for the five chain sites of a flagship frame, 1.2 ms at
// the bf16 peak; 6.6 TFLOP for the RDB stack's 40 layers).
//
// bfloat16 is an implicit GEMM on Hopper's warpgroup products:
//   * M is output pixels, one 64-pixel row of a tile per wgmma; N the output
//     channels in a tile of 8, 16, 32, 64 or 128 (cout 2-3, 12, 32, 64,
//     128); K the 9 (or 1) taps x cin in 16-channel chunks. Sums stay
//     float32 in registers.
//   * A comes from shared memory through a descriptor. The input tile is
//     held as TMA writes a 16-channel box in its 32-byte swizzle: one
//     pixel's 16 channels are one 32-byte row, 8 neighbouring pixels one
//     256-byte swizzle atom. The tap (ky, kx) is then only a start address
//     (ky rows and kx pixels further on, 32-byte steps; the swizzle follows
//     the absolute address): the nine taps read one staged tile, nothing
//     is copied per tap, and no registers hold A (rather than ldmatrix
//     into registers, which would spend registers and issue slots on what
//     the tensor core reads itself). A 32-byte row per pixel rather than
//     two 16-byte boxes without swizzle halves TMA's requests and reads
//     whole 32-byte sectors (measured 13-21 % off the RDB's layers).
//   * Input: TMA from a 4-D tensor map (B, H, W, C) per input tensor (up
//     to three: a list input is read in place, each chunk from its own
//     tensor) into rings of stages in shared memory, each stage the
//     (TH + 2) x 66 pixel haloed tile of one 16-channel chunk. TMA's zero
//     fill outside the tensor is the SAME padding, the ragged edges and the
//     channels past cin. One producer thread keeps the rings full.
//   * Two consumer warpgroups, each with a ring of its own, take every
//     other tile of the block's walk (ping-pong), so that one's epilogue
//     runs beside the other's products; a stage goes back to the producer
//     one chunk after its products were issued (wgmma.wait_group 1).
//   * Weights: packed once per call in bf16 by ops/conv_chain.py
//     `pack_conv_weights` into the layout the B descriptor reads. A block
//     copies the whole image into shared memory once (bulk copy) and keeps
//     it across its tiles where it fits beside two stages per ring;
//     otherwise each stage carries its chunk's weights.
//   * Persistent blocks, one per SM, walk the (batch, row band, column,
//     N-tile) tiles; the epilogue rounds, adds the bias, applies relu,
//     rounds and stores into the output slot, masking the edges (the
//     fusion's epilogue: float32 bias, times res_scale, plus the residual
//     channel read from device memory, rounded once).
// float32 (kept exact, no TF32) runs as FP32 FMAs on the CUDA cores: each
// thread keeps a 4-pixel column x 8-channel block of sums in registers,
// reusing a column segment of the input for the three vertical taps.
//
// What the design still gives up: a chain's intermediates round-trip device
// memory between layers (the TPU kernel keeps them on chip); a tile is 4
// rows (2 for N = 128, the accumulators' registers), so the 3x3 halo
// stages 50 % (100 %) more input rows than the tile holds; A and B both
// stream from shared memory for every product, which at N = 32 (the RDB)
// asks more bytes per cycle than shared memory gives; the epilogue stores
// from registers, 4 bytes a thread, rather than through shared memory and
// TMA; the per-call weight pack is a few small ATen kernels.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "nerve_tpu_torch.h"

namespace {

// ---------------------------------------------------------------- bfloat16

constexpr int WG_TW = 64;       // output pixels of a tile row: one wgmma M
constexpr int CONSUMERS = 2;    // consumer warpgroups; warpgroup 0 produces
constexpr int WG_THREADS = 128 * (CONSUMERS + 1);
constexpr int MAX_STAGES = 8;  // per consumer's ring
constexpr int BAR_BYTES = 1024;  // the mbarriers, at the start of shared memory

template <int K, int NT>
struct Cfg {
  static constexpr int R = K / 2;
  // Output rows of a tile: one accumulator of NT / 2 floats a thread per row.
  static constexpr int TH = NT >= 128 ? 2 : 4;
  static constexpr int IH = TH + 2 * R, IW = WG_TW + 2 * R;
  // One 16-channel TMA box of the haloed tile (32 bytes a pixel, 32-byte
  // swizzle); its place in a stage is padded to 1024 bytes.
  static constexpr int BOX_BYTES = IH * IW * 32;
  static constexpr int IN_BYTES = (BOX_BYTES + 1023) / 1024 * 1024;
  static constexpr int W_BYTES = K * K * NT * 32;   // one chunk's weights, every tap
};

// The epilogue of a tile: a dense layer's, or the RDB fusion's (rdb.cu).
enum { EPI_CONV = 0, EPI_LFF = 1 };

struct WgParams {
  int nx, xcs, nchunks, cout, ocs, ocoff, h, w, relu, pair;
  int tiles_x, tiles_y, ncot, ntiles, resident, stages;
  const uint8_t* wpack;
  const float* bias;
  __nv_bfloat16* out;
  // EPI_LFF: the block input's channels (the residual) are the leading
  // cout of the input x0, channel stride xcs.
  const __nv_bfloat16* res;
  float res_scale;
};

__device__ __forceinline__ void decode_tile(const WgParams& p, int t, int& cot, int& tx,
                                            int& ty, int& b) {
  cot = t % p.ncot;
  t /= p.ncot;
  tx = t % p.tiles_x;
  t /= p.tiles_x;
  ty = t % p.tiles_y;
  b = t / p.tiles_y;
}

// Store channels co, co + 1 of one pixel (a pair where the layout allows).
__device__ __forceinline__ void store2(const WgParams& p, __nv_bfloat16* o, int co, float v0,
                                       float v1) {
  if (p.pair && co + 1 < p.cout) {
    *reinterpret_cast<__nv_bfloat162*>(o + co) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (co < p.cout) o[co] = __float2bfloat16_rn(v0);
    if (co + 1 < p.cout) o[co + 1] = __float2bfloat16_rn(v1);
  }
}

// The body of conv_wgmma_kernel and lff_wgmma_kernel: m0..m2 are the input
// tensors' maps (kernel parameters, __grid_constant__).
template <int K, int NT, int EPI>
__device__ __forceinline__ void conv_wgmma(const CUtensorMap* m0, const CUtensorMap* m1,
                                           const CUtensorMap* m2, const WgParams& p) {
  using C = Cfg<K, NT>;
  extern __shared__ __align__(1024) uint8_t smem[];
  // Each consumer warpgroup has a ring of p.stages stages of its own.
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + CONSUMERS * MAX_STAGES;
  uint64_t* wbar = empty + CONSUMERS * MAX_STAGES;
  uint8_t* wres = smem + BAR_BYTES;
  const int wres_bytes = p.resident ? p.nchunks * C::W_BYTES : 0;
  uint8_t* ring = wres + (wres_bytes + 1023) / 1024 * 1024;
  const int stage_bytes = (C::IN_BYTES + (p.resident ? 0 : C::W_BYTES) + 1023) / 1024 * 1024;
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    for (int s = 0; s < CONSUMERS * p.stages; ++s) {
      nt_mbar_init(&full[s], 1);
      nt_mbar_init(&empty[s], 4);
    }
    nt_mbar_init(wbar, 1);
    nt_fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread issues every copy.
    nt_setmaxnreg_dec<40>();
    if (tid != 0) return;
    if (p.resident) {
      nt_mbar_expect_tx(wbar, wres_bytes);
      for (int c = 0; c < p.nchunks; ++c)
        nt_bulk_load(wres + c * C::W_BYTES, p.wpack + (size_t)c * C::W_BYTES, C::W_BYTES, wbar);
    }
    const CUtensorMap* maps[3] = {m0, m1, m2};
    int rstage[CONSUMERS] = {}, rphase[CONSUMERS] = {};
    for (int t = blockIdx.x, k = 0; t < p.ntiles; t += gridDim.x, ++k) {
      int cot, tx, ty, b;
      decode_tile(p, t, cot, tx, ty, b);
      const int x0 = tx * WG_TW - C::R, y0 = ty * C::TH - C::R;
      const int ring_id = k % CONSUMERS;  // tile k of the walk is warpgroup k % 2's
      for (int c = 0; c < p.nchunks; ++c) {
        int& phase = rphase[ring_id];
        const int stage = ring_id * p.stages + rstage[ring_id];
        nt_mbar_wait(&empty[stage], phase ^ 1);
        nt_mbar_expect_tx(&full[stage], C::BOX_BYTES + (p.resident ? 0 : C::W_BYTES));
        uint8_t* st = ring + stage * stage_bytes;
        const int part = p.nx == 1 ? 0 : min(c * 16 / p.xcs, p.nx - 1);
        nt_tma_load_4d(st, maps[part], &full[stage], c * 16 - part * p.xcs, x0, y0, b);
        if (!p.resident)
          nt_bulk_load(st + C::IN_BYTES, p.wpack + ((size_t)cot * p.nchunks + c) * C::W_BYTES,
                       C::W_BYTES, &full[stage]);
        if (++rstage[ring_id] == p.stages) {
          rstage[ring_id] = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // Consumers: warpgroup cw takes every other tile of the block's walk
  // from its own ring, so that one's epilogue runs beside the other's
  // products.
  nt_setmaxnreg_inc<232>();
  const int cw = wg - 1, warp = (tid % 128) / 32, lane = tid % 32;
  float acc[C::TH][NT / 2] = {};
  if (p.resident) nt_mbar_wait(wbar, 0);
  // A stage is handed back once the products that read it are done: one
  // chunk later, so that this chunk's products queue behind the last's.
  int stage = cw * p.stages, phase = 0, held = -1;
  for (int t = blockIdx.x + cw * gridDim.x; t < p.ntiles; t += CONSUMERS * gridDim.x) {
    int cot, tx, ty, b;
    decode_tile(p, t, cot, tx, ty, b);
    for (int c = 0; c < p.nchunks; ++c) {
      nt_mbar_wait(&full[stage], phase);
      __syncwarp();
      const unsigned in = nt_smem_addr(ring + stage * stage_bytes);
      const unsigned wb = p.resident ? nt_smem_addr(wres + c * C::W_BYTES) : in + C::IN_BYTES;
      nt_wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < K * K; ++tap) {
        const uint64_t db = nt_wgmma_desc(wb + tap * NT * 32, NT * 16, 128);
#pragma unroll
        for (int r = 0; r < C::TH; ++r) {
          const int row = r + tap / K;
          const uint64_t da = nt_wgmma_desc_sw32(in + (row * C::IW + tap % K) * 32);
          nt_wgmma<NT>(acc[r], da, db, c > 0 || tap > 0);
        }
      }
      nt_wgmma_commit();
      nt_wgmma_wait<1>();
      if (held >= 0 && lane == 0) nt_mbar_arrive(&empty[held]);
      held = stage;
      if (++stage == (cw + 1) * p.stages) {
        stage = cw * p.stages;
        phase ^= 1;
      }
    }
    nt_wgmma_wait<0>();
    if (lane == 0) nt_mbar_arrive(&empty[held]);
    held = -1;
    // Epilogue: row 16 warp + lane / 4 + 8 i of the wgmma tile is pixel
    // column x0 + that; d[4 j + 2 i + e] is channel 8 j + 2 (lane % 4) + e.
    const int y0 = ty * C::TH;
    const int xb = tx * WG_TW + warp * 16 + lane / 4;
    const int co0 = cot * NT + 2 * (lane % 4);
#pragma unroll
    for (int r = 0; r < C::TH; ++r) {
      const int gy = y0 + r;
      if constexpr (EPI == EPI_LFF) {
        // (sum + bias) * res_scale + the block input's channel, in float32,
        // rounded once. The row's residual pairs are all loaded first (the
        // TMA loads of this tile just brought them into L2).
        __nv_bfloat162 xr[2][NT / 8];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int gx = xb + 8 * i;
          const bool ok = gy < p.h && gx < p.w;
          const __nv_bfloat16* x = p.res + ((size_t)(b * p.h + gy) * p.w + gx) * p.xcs;
#pragma unroll
          for (int j = 0; j < NT / 8; ++j) {
            const int co = co0 + 8 * j;
            xr[i][j] = __floats2bfloat162_rn(0.f, 0.f);
            if (ok && co + 1 < p.cout)
              xr[i][j] = __ldg(reinterpret_cast<const __nv_bfloat162*>(x + co));
            else if (ok && co < p.cout)
              xr[i][j].x = x[co];
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int gx = xb + 8 * i;
          if (gy >= p.h || gx >= p.w) continue;
          __nv_bfloat16* o = p.out + ((size_t)(b * p.h + gy) * p.w + gx) * p.ocs + p.ocoff;
#pragma unroll
          for (int j = 0; j < NT / 8; ++j) {
            const int co = co0 + 8 * j;
            const float2 x = __bfloat1622float2(xr[i][j]);
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float bias = co + e < p.cout ? p.bias[co + e] : 0.f;
              v[e] = __fadd_rn(__fmul_rn(__fadd_rn(acc[r][4 * j + 2 * i + e], bias), p.res_scale),
                               e == 0 ? x.x : x.y);
            }
            store2(p, o, co, v[0], v[1]);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int gx = xb + 8 * i;
          if (gy >= p.h || gx >= p.w) continue;
          __nv_bfloat16* o = p.out + ((size_t)(b * p.h + gy) * p.w + gx) * p.ocs + p.ocoff;
#pragma unroll
          for (int j = 0; j < NT / 8; ++j) {
            const int co = co0 + 8 * j;
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float bias = co + e < p.cout ? p.bias[co + e] : 0.f;
              v[e] = __bfloat162float(__float2bfloat16_rn(acc[r][4 * j + 2 * i + e])) + bias;
              if (p.relu) v[e] = fmaxf(v[e], 0.f);
            }
            store2(p, o, co, v[0], v[1]);
          }
        }
      }
    }
  }
}

template <int K, int NT>
__global__ void __launch_bounds__(WG_THREADS, 1)
    conv_wgmma_kernel(const __grid_constant__ CUtensorMap m0,
                      const __grid_constant__ CUtensorMap m1,
                      const __grid_constant__ CUtensorMap m2, const WgParams p) {
  conv_wgmma<K, NT, EPI_CONV>(&m0, &m1, &m2, p);
}

// The RDB fusion (rdb.cu): a 1x1 layer over the block's concatenation with
// the fusion's epilogue.
__global__ void __launch_bounds__(WG_THREADS, 1)
    lff_wgmma_kernel(const __grid_constant__ CUtensorMap m0, const WgParams p) {
  conv_wgmma<1, NT_LFF_N_TILE, EPI_LFF>(&m0, &m0, &m0, p);
}

// A launch of conv_wgmma<K, NT, .>: its parameters, tensor maps, dynamic
// shared memory and grid.
struct WgLaunch {
  WgParams p;
  CUtensorMap maps[3];
  int smem, smem_max, grid;
};

template <int K, int NT>
cudaError_t plan_wgmma(const void* const* xs, int nx, int xcs, int cin, const void* w,
                       const float* bias, void* out, int ocs, int ocoff, int cout, int b, int h,
                       int wd, int relu, WgLaunch& l) {
  using C = Cfg<K, NT>;
  NtDeviceLimits lim;
  cudaError_t err = nt_device_limits(lim);
  if (err != cudaSuccess) return err;
  const NtEncodeTiled encode = nt_encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;

  WgParams& p = l.p;
  p.nx = nx;
  p.xcs = xcs;
  p.nchunks = (cin + 15) / 16;
  p.cout = cout;
  p.ocs = ocs;
  p.ocoff = ocoff;
  p.h = h;
  p.w = wd;
  p.relu = relu;
  p.pair = ocs % 2 == 0 && ocoff % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
  p.tiles_x = (wd + WG_TW - 1) / WG_TW;
  p.tiles_y = (h + C::TH - 1) / C::TH;
  p.ncot = (cout + NT - 1) / NT;
  const long long ntiles = (long long)b * p.tiles_y * p.tiles_x * p.ncot;
  if (ntiles > INT32_MAX) return cudaErrorInvalidValue;
  p.ntiles = (int)ntiles;
  p.wpack = static_cast<const uint8_t*>(w);
  p.bias = bias;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.res = static_cast<const __nv_bfloat16*>(xs[0]);
  p.res_scale = 0.f;

  // The weights stay resident where they fit beside two stages of each ring.
  const int avail = lim.smem - BAR_BYTES;
  const int wbytes = (p.nchunks * C::W_BYTES + 1023) / 1024 * 1024;
  p.resident = p.ncot == 1 && wbytes + 2 * CONSUMERS * C::IN_BYTES <= avail;
  const int stage_bytes = (C::IN_BYTES + (p.resident ? 0 : C::W_BYTES) + 1023) / 1024 * 1024;
  p.stages = std::min(MAX_STAGES,
                      (avail - (p.resident ? wbytes : 0)) / (CONSUMERS * stage_bytes));
  if (p.stages < 2) return cudaErrorInvalidValue;
  l.smem = BAR_BYTES + (p.resident ? wbytes : 0) + CONSUMERS * p.stages * stage_bytes;
  l.smem_max = lim.smem;
  l.grid = (int)std::min<long long>(ntiles, lim.sms);

  // One map per input tensor: (C, W, H, B), innermost first; a box is one
  // 16-channel chunk of the haloed tile, 32-byte rows in the 32-byte
  // swizzle. One input reads channels [0, cin).
  for (int i = 0; i < 3; ++i) {
    if (i >= nx) {
      l.maps[i] = l.maps[0];
      continue;
    }
    const cuuint64_t dims[4] = {(cuuint64_t)(nx == 1 ? cin : xcs), (cuuint64_t)wd,
                                (cuuint64_t)h, (cuuint64_t)b};
    const cuuint64_t strides[3] = {(cuuint64_t)xcs * 2, (cuuint64_t)wd * xcs * 2,
                                   (cuuint64_t)h * wd * xcs * 2};
    const cuuint32_t box[4] = {16, C::IW, C::IH, 1}, estr[4] = {1, 1, 1, 1};
    if (encode(&l.maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(xs[i]), dims,
               strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

template <int K, int NT>
cudaError_t launch_wgmma_cfg(const void* const* xs, int nx, int xcs, int cin, const void* w,
                             const float* bias, void* out, int ocs, int ocoff, int cout, int b,
                             int h, int wd, int relu, cudaStream_t stream) {
  WgLaunch l;
  cudaError_t err =
      plan_wgmma<K, NT>(xs, nx, xcs, cin, w, bias, out, ocs, ocoff, cout, b, h, wd, relu, l);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv_wgmma_kernel<K, NT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem_max);
  if (err != cudaSuccess) return err;
  conv_wgmma_kernel<K, NT><<<l.grid, WG_THREADS, l.smem, stream>>>(l.maps[0], l.maps[1],
                                                                     l.maps[2], l.p);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_wgmma(const void* const* xs, int nx, int xcs, int cin, const void* w,
                         const float* bias, void* out, int ocs, int ocoff, int cout, int b,
                         int h, int wd, int relu, cudaStream_t st) {
  // The N tile, as ops/conv_chain.py `n_tile` packs the weights for.
  if (cout <= 8)
    return launch_wgmma_cfg<K, 8>(xs, nx, xcs, cin, w, bias, out, ocs, ocoff, cout, b, h, wd, relu, st);
  if (cout <= 16)
    return launch_wgmma_cfg<K, 16>(xs, nx, xcs, cin, w, bias, out, ocs, ocoff, cout, b, h, wd, relu, st);
  if (cout <= 32)
    return launch_wgmma_cfg<K, 32>(xs, nx, xcs, cin, w, bias, out, ocs, ocoff, cout, b, h, wd, relu, st);
  if (cout <= 64)
    return launch_wgmma_cfg<K, 64>(xs, nx, xcs, cin, w, bias, out, ocs, ocoff, cout, b, h, wd, relu, st);
  return launch_wgmma_cfg<K, 128>(xs, nx, xcs, cin, w, bias, out, ocs, ocoff, cout, b, h, wd, relu, st);
}

// ----------------------------------------------------------------- float32

constexpr int TH = 8, TW = 32, P = 4, FMA_CK = 8;
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

cudaError_t nt_lff_bf16_wgmma(const void* cat, int xcs, int ccat, const void* w,
                              const float* bias, void* out, int ocs, int ocoff, int c, int b,
                              int h, int wd, float res_scale, cudaStream_t stream) {
  const void* xs[3] = {cat, cat, cat};
  WgLaunch l;
  cudaError_t err = plan_wgmma<1, NT_LFF_N_TILE>(xs, 1, xcs, ccat, w, bias, out, ocs, ocoff, c,
                                                 b, h, wd, 0, l);
  if (err != cudaSuccess) return err;
  l.p.res_scale = res_scale;
  err = cudaFuncSetAttribute(lff_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             l.smem_max);
  if (err != cudaSuccess) return err;
  lff_wgmma_kernel<<<l.grid, WG_THREADS, l.smem, stream>>>(l.maps[0], l.p);
  return cudaGetLastError();
}

extern "C" int nt_conv2d(const void* x0, const void* x1, const void* x2, int nx,
                         int x_cstride, int cin, const void* w, const float* bias, void* out,
                         int out_cstride, int out_coff, int cout, int b, int h, int w_,
                         int ksize, int relu, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ksize != 1 && ksize != 3) return (int)cudaErrorInvalidValue;
  if (dtype == NT_BF16) {
    const void* xs[3] = {x0, x1, x2};
    if (nx < 1 || nx > 3 || x_cstride % 8 != 0 ||
        (nx > 1 && (cin != nx * x_cstride || x_cstride % 16 != 0)))
      return (int)cudaErrorInvalidValue;
    for (int i = 0; i < nx; ++i)
      if (reinterpret_cast<uintptr_t>(xs[i]) % 16 != 0) return (int)cudaErrorInvalidValue;
    return (int)(ksize == 3 ? launch_wgmma<3> : launch_wgmma<1>)(
        xs, nx, x_cstride, cin, w, bias, out, out_cstride, out_coff, cout, b, h, w_, relu, st);
  }
  if (dtype == NT_F32 && nx == 1)
    return (int)(ksize == 3 ? launch_fma<3> : launch_fma<1>)(
        x0, x_cstride, cin, static_cast<const float*>(w), bias, out, out_cstride, out_coff,
        cout, b, h, w_, relu, st);
  return (int)cudaErrorInvalidValue;
}
