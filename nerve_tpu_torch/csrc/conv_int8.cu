// int8 direct SAME convolution, one dense 3x3 or 1x1 layer per launch.
//
// Replaces nerve_tpu/ops/conv_chain_int8.py `_chain_int8_kernel` (reached
// via `conv_chain_int8_pallas` <- `conv_chain_int8_apply`); the wrapper
// (ops/conv_chain_int8.py) runs one launch per layer of a chain. It is also
// the dense-layer kernel of the int8 residual dense block that replaces
// nerve_tpu/ops/rdb_int8.py `_rdb_int8_kernel` (see rdb_int8.cu): the layer
// reads the leading `cin` channels of the block's int8 concatenation buffer
// and requantises its output into its own channel slot. Its 1x1 form with
// the fusion's epilogue (`lff_i8_wgmma_kernel`) is the int8 RDB's local
// feature fusion (see rdb_int8.cu).
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
//     the nine taps' int32 sums add in int32 (|sum| <= 127^2 * 9 * cin,
//     below 2^31 for cin < 14,000) and the layer dequantises once,
//     f32(int32) * dq[n], before the bias.
//
// Bound: neither side by much. A dense layer does 18 * cin * cout int8
// operations per pixel for cin + cout bytes of int8 in and out: 384 to 494
// operations a byte on the RDB's layers and up to 893 on the chains', about
// the card's balance point of 590 (1,979 TOPS dense int8 over 3.35 TB/s), so
// an RDB layer's floor at 1080p is 0.06-0.14 ms either way.
//
// The design is the bf16 layer's (conv_chain.cu) on Hopper's integer
// warpgroup products, byte for byte:
//   * M is output pixels, one 64-pixel row of a tile per wgmma; N the output
//     channels in a tile of 8, 16 or 32; K the 9 (or 1) taps x cin in
//     32-channel chunks (wgmma.m64nNk32.s32.s8.s8, both operands K-major
//     from shared memory through descriptors, int32 sums in registers).
//   * 32 int8 channels are one 32-byte row per pixel, as 16 bf16 channels
//     are, so the input is staged as the bf16 kernel stages it: TMA from a
//     4-D tensor map (B, H, W, C) of bytes, one 32-channel box of the haloed
//     tile per stage in the 32-byte swizzle; TMA's zero fill is the SAME
//     padding, the ragged edges and the channels past cin; the tap (ky, kx)
//     is A's start address ky rows and kx pixels further on. One producer
//     thread keeps a ring per consumer warpgroup full; two consumer
//     warpgroups take every other tile of a persistent block's walk
//     (ping-pong), so that one's epilogue runs beside the other's products.
//   * Weights: the B descriptor's image, [n-tile][chunk][tap][k half][n / 8]
//     [n % 8][k % 16], packed once per quantised layer by
//     ops/conv_chain_int8.py `pack_i8_weights` (int8 weights do not change
//     after calibration), resident in shared memory where they fit beside
//     two stages per ring, else streamed with each chunk.
//   * The numerics decide the accumulator layout. The per-tap schedules
//     (NT_TAPS_DY, NT_TAPS_DX) dequantise each tap's complete int32 sum, so
//     a consumer holds nine accumulator sets, one per tap, walks the chunks
//     outer and the nine taps (nine start addresses in one staged chunk)
//     inner, and dequantises the nine sets in the schedule's tap order in the
//     epilogue (int32 sums are exact, so the chunk order inside a tap is
//     free). Nine sets of an m64n32 tile are 9 x 16 registers a thread, so a
//     tile is one row (the 3x3 halo stages three) and N is at most 32: a
//     wider layer (the flow head's 128 and 64, the attention site's 64)
//     walks N in 32-wide tiles, the N tiles of one pixel tile adjacent in
//     the walk so that their input reads meet in L2. That keeps one kernel
//     shape and one walk for every layer; a tap-outer walk over a staged
//     whole-cin tile would hold one set but wait on each tap's products
//     before its dequantisation, and a 2-row tile of 16-wide N tiles (the
//     same registers) measured no better. NT_TAPS_INT32 and the 1x1 layers
//     hold one set (the taps add in the tensor core) and take 4-row tiles.
//   * The epilogue dequantises (two taps' values rounded to bf16 in one
//     packed conversion), adds the bias, applies relu as a floor of 0 or
//     -inf, converts the whole row to the output type and only then stores
//     it, two channels a thread into the output's channel slot, with the
//     output type chosen once per row: a store behind a branch per channel
//     pair serialised the row's conversions. The factors, biases and
//     reciprocals of the layer sit in shared memory.
// What the design still gives up: the per-tap epilogue (nine dequantised,
// rounded and added values per output) is latency-bound in the 8 consumer
// warps of an SM and takes about as long as the loads and products of a
// 64-channel RDB layer, which it overlaps only in part; a 1-row tile stages
// 3 rows of input; a chain's intermediates round-trip device memory in int8
// between layers.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "nerve_tpu_torch.h"

namespace {

constexpr int WG_TW = 64;       // output pixels of a tile row: one wgmma M
constexpr int CONSUMERS = 2;    // consumer warpgroups; warpgroup 0 produces
constexpr int WG_THREADS = 128 * (CONSUMERS + 1);
constexpr int MAX_STAGES = 8;   // per consumer's ring
constexpr int BAR_BYTES = 1024;  // the mbarriers, at the start of shared memory
constexpr int CHUNK = 32;       // input channels per K step: one 32-byte row a pixel
constexpr int MAX_NT = 32;      // widest N tile (nine accumulator sets of it)

__host__ __device__ constexpr int ceil_to(int v, int m) { return (v + m - 1) / m * m; }

template <int K, int NT, int MODE>
struct Cfg {
  static constexpr int R = K / 2;
  // int32 accumulator sets: one per tap where each tap is dequantised alone.
  static constexpr int SETS = (K == 3 && MODE != NT_TAPS_INT32) ? 9 : 1;
  static constexpr int TH = SETS == 9 ? 1 : 4;  // output rows of a tile
  static constexpr int IH = TH + 2 * R, IW = WG_TW + 2 * R;
  // One 32-channel TMA box of the haloed tile (32 bytes a pixel, 32-byte
  // swizzle); its place in a stage is padded to 1024 bytes.
  static constexpr int BOX_BYTES = IH * IW * CHUNK;
  static constexpr int IN_BYTES = ceil_to(BOX_BYTES, 1024);
  static constexpr int W_BYTES = K * K * NT * CHUNK;  // one chunk's weights, every tap
};

// The epilogue of a tile: a dense layer's, or the int8 RDB fusion's
// (rdb_int8.cu).
enum { EPI_CONV = 0, EPI_LFF = 1 };

struct Params {
  int nchunks, cout, cpad, ocs, ocoff, h, w, relu, odt, pair;
  int tiles_x, tiles_y, ncot, ntiles, resident, stages, param_bytes;
  const uint8_t* wpack;
  const float *dq, *bias, *inv;
  void* out;
  // EPI_LFF: the block input's int8 channels (the residual) are the leading
  // cout of the input, channel stride rcs; its scale s_in[0]; the next
  // block's input scale s_next[0] (int8 output).
  const int8_t* res;
  int rcs;
  const float *s_in, *s_next;
};

__device__ __forceinline__ void decode_tile(const Params& p, int t, int& cot, int& tx,
                                            int& ty, int& b) {
  cot = t % p.ncot;
  t /= p.ncot;
  tx = t % p.tiles_x;
  t /= p.tiles_x;
  ty = t % p.tiles_y;
  b = t / p.tiles_y;
}

// Two taps' sums dequantised, each rounded to bf16 (one packed conversion).
__device__ __forceinline__ float2 dequant2_bf16(int s0, int s1, float2 d) {
  return __bfloat1622float2(__floats2bfloat162_rn(__fmul_rn(__int2float_rn(s0), d.x),
                                                  __fmul_rn(__int2float_rn(s1), d.y)));
}

// One row of a tile's outputs, o[i][j][e] (pixel xb + 8 i, channel
// co0 + 8 j + e), converted to the output type and stored. Every value is
// converted before the first store, and the stores are predicated, so that
// the conversions of a row overlap; a tile whose N tile is whole (`full`)
// stores channel pairs, an edge tile channel by channel. int8 output is
// requantised by multiplication with the channel's reciprocal sinv[n], or
// with DIV by true division by `div` (the fusion's next input scale).
template <int NT, int ODT, bool DIV = false>
__device__ __forceinline__ void store_row(const Params& p, const float (&o)[2][NT / 8][2],
                                          size_t pix0, bool row_ok, int xb, int co0, bool full,
                                          const float* sinv, float div = 1.f) {
  using T = typename std::conditional<ODT == NT_I8, int8_t,
                                      typename std::conditional<ODT == NT_BF16, __nv_bfloat16,
                                                                float>::type>::type;
  T q[2][NT / 8][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = o[i][j][e];
        if constexpr (ODT == NT_I8)
          q[i][j][e] = static_cast<int8_t>(__float2int_rn(fminf(
              fmaxf(rintf(DIV ? __fdiv_rn(v, div) : __fmul_rn(v, sinv[co0 + 8 * j + e])),
                    -127.f),
              127.f)));
        else if constexpr (ODT == NT_BF16)
          q[i][j][e] = __float2bfloat16_rn(v);
        else
          q[i][j][e] = v;
      }
  T* out = static_cast<T*>(p.out) + p.ocoff;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok || xb + 8 * i >= p.w) continue;
    T* px = out + (pix0 + 8 * i) * p.ocs;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const int co = co0 + 8 * j;
      if (full) {
        if constexpr (ODT == NT_I8)
          *reinterpret_cast<char2*>(px + co) = make_char2(q[i][j][0], q[i][j][1]);
        else if constexpr (ODT == NT_BF16)
          *reinterpret_cast<__nv_bfloat162*>(px + co) = __halves2bfloat162(q[i][j][0], q[i][j][1]);
        else
          *reinterpret_cast<float2*>(px + co) = make_float2(q[i][j][0], q[i][j][1]);
      } else {
        if (co < p.cout) px[co] = q[i][j][0];
        if (co + 1 < p.cout) px[co + 1] = q[i][j][1];
      }
    }
  }
}

// The epilogue of one tile: row 16 warp + lane / 4 + 8 i of the wgmma tile
// is pixel column xb + 8 i; a[4 j + 2 i + e] is channel co0 + 8 j + e. The
// sets are dequantised in the schedule's tap order.
template <int K, int NT, int MODE>
__device__ __forceinline__ void epilogue(const Params& p,
                                         const int (&acc)[Cfg<K, NT, MODE>::SETS *
                                                          Cfg<K, NT, MODE>::TH][NT / 2],
                                         int b, int ty, int xb, int cot, int co0,
                                         const float* sdq, const float* sbias,
                                         const float* sinv) {
  using C = Cfg<K, NT, MODE>;
  const bool full = p.pair && (cot + 1) * NT <= p.cout;
#pragma unroll
  for (int r = 0; r < C::TH; ++r) {
    const int gy = ty * C::TH + r;
    float v[2][NT / 8][2] = {};  // v[i][j][e]
#pragma unroll
    for (int s = 0; s < C::SETS; ++s) {
      const int tap = MODE == NT_TAPS_DX ? (s % K) * K + s / K : s;
      const int(&a)[NT / 2] = acc[C::SETS == 9 ? tap : r];
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        const float2 d = *reinterpret_cast<const float2*>(&sdq[tap * p.cpad + co0 + 8 * j]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if constexpr (MODE == NT_TAPS_INT32) {
            v[i][j][0] = __fmul_rn(__int2float_rn(a[4 * j + 2 * i]), d.x);
            v[i][j][1] = __fmul_rn(__int2float_rn(a[4 * j + 2 * i + 1]), d.y);
          } else {
            const float2 y = dequant2_bf16(a[4 * j + 2 * i], a[4 * j + 2 * i + 1], d);
            v[i][j][0] = __fadd_rn(v[i][j][0], y.x);
            v[i][j][1] = __fadd_rn(v[i][j][1], y.y);
          }
        }
      }
    }
    // Bias and relu (a floor of 0 or -inf, so that no branch splits the row).
    const float lo = p.relu ? 0.f : __int_as_float(0xff800000);  // 0 or -inf
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const float2 bias = *reinterpret_cast<const float2*>(&sbias[co0 + 8 * j]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        v[i][j][0] = fmaxf(__fadd_rn(v[i][j][0], bias.x), lo);
        v[i][j][1] = fmaxf(__fadd_rn(v[i][j][1], bias.y), lo);
      }
    }
    const size_t pix0 = (size_t)(b * p.h + gy) * p.w + xb;
    const bool row_ok = gy < p.h;
    if (p.odt == NT_I8)
      store_row<NT, NT_I8>(p, v, pix0, row_ok, xb, co0, full, sinv);
    else if (p.odt == NT_BF16)
      store_row<NT, NT_BF16>(p, v, pix0, row_ok, xb, co0, full, sinv);
    else
      store_row<NT, NT_F32>(p, v, pix0, row_ok, xb, co0, full, sinv);
  }
}

// The fusion's epilogue (a 1x1 layer's single set, TH rows):
//   v = (lff * ldq[n] + lbias[n]) * 0.2 + x[p, n] * s_in
// with x the block input's int8 channel (the residual, read from device
// memory, L2-hot behind this tile's TMA loads; a row's pairs all loaded
// before use), each operation rounded to nearest; int8 output divides by
// the next block's input scale.
template <int NT, int TH>
__device__ __forceinline__ void lff_epilogue(const Params& p, const int (&acc)[TH][NT / 2],
                                             int b, int ty, int xb, int cot, int co0,
                                             const float* sdq, const float* sbias, float sx,
                                             float snext) {
  const bool full = p.pair && (cot + 1) * NT <= p.cout;
#pragma unroll
  for (int r = 0; r < TH; ++r) {
    const int gy = ty * TH + r;
    const bool row_ok = gy < p.h;
    const size_t pix0 = (size_t)(b * p.h + gy) * p.w + xb;
    char2 xr[2][NT / 8];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool ok = row_ok && xb + 8 * i < p.w;
      const int8_t* x = p.res + (pix0 + 8 * i) * p.rcs;
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        const int co = co0 + 8 * j;
        xr[i][j] = make_char2(0, 0);
        if (ok && co + 1 < p.cout)
          xr[i][j] = __ldg(reinterpret_cast<const char2*>(x + co));
        else if (ok && co < p.cout)
          xr[i][j].x = x[co];
      }
    }
    float v[2][NT / 8][2];
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const float2 d = *reinterpret_cast<const float2*>(&sdq[co0 + 8 * j]);
      const float2 bias = *reinterpret_cast<const float2*>(&sbias[co0 + 8 * j]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        v[i][j][0] = __fadd_rn(
            __fmul_rn(__fadd_rn(__fmul_rn(__int2float_rn(acc[r][4 * j + 2 * i]), d.x), bias.x),
                      0.2f),
            __fmul_rn(static_cast<float>(xr[i][j].x), sx));
        v[i][j][1] = __fadd_rn(
            __fmul_rn(__fadd_rn(__fmul_rn(__int2float_rn(acc[r][4 * j + 2 * i + 1]), d.y),
                                bias.y),
                      0.2f),
            __fmul_rn(static_cast<float>(xr[i][j].y), sx));
      }
    }
    if (p.odt == NT_I8)
      store_row<NT, NT_I8, true>(p, v, pix0, row_ok, xb, co0, full, sbias, snext);
    else if (p.odt == NT_BF16)
      store_row<NT, NT_BF16>(p, v, pix0, row_ok, xb, co0, full, sbias);
    else
      store_row<NT, NT_F32>(p, v, pix0, row_ok, xb, co0, full, sbias);
  }
}

// The body of conv_i8_wgmma_kernel and lff_i8_wgmma_kernel; `map` is the
// input's tensor map (a kernel parameter, __grid_constant__).
template <int K, int NT, int MODE, int EPI>
__device__ __forceinline__ void conv_i8_wgmma(const CUtensorMap* map, const Params& p) {
  using C = Cfg<K, NT, MODE>;
  extern __shared__ __align__(1024) uint8_t smem[];
  // Each consumer warpgroup has a ring of p.stages stages of its own.
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + CONSUMERS * MAX_STAGES;
  uint64_t* wbar = empty + CONSUMERS * MAX_STAGES;
  // The layer's factors: dq [SETS][cpad], bias [cpad], 1 / s_out [cpad].
  float* sdq = reinterpret_cast<float*>(smem + BAR_BYTES);
  float* sbias = sdq + C::SETS * p.cpad;
  float* sinv = sbias + p.cpad;
  uint8_t* wres = smem + BAR_BYTES + p.param_bytes;
  const int wres_bytes = p.resident ? p.nchunks * C::W_BYTES : 0;
  uint8_t* ring = wres + ceil_to(wres_bytes, 1024);
  const int stage_bytes = ceil_to(C::IN_BYTES + (p.resident ? 0 : C::W_BYTES), 1024);
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    for (int s = 0; s < CONSUMERS * p.stages; ++s) {
      nt_mbar_init(&full[s], 1);
      nt_mbar_init(&empty[s], 4);
    }
    nt_mbar_init(wbar, 1);
    nt_fence_mbar_init();
  }
  for (int i = tid; i < C::SETS * p.cpad; i += WG_THREADS) {
    const int row = i / p.cpad, co = i % p.cpad;
    sdq[i] = co < p.cout ? p.dq[row * p.cout + co] : 0.f;
  }
  for (int co = tid; co < p.cpad; co += WG_THREADS) {
    sbias[co] = co < p.cout ? p.bias[co] : 0.f;
    sinv[co] = co < p.cout && EPI == EPI_CONV ? p.inv[co] : 0.f;
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
        nt_tma_load_4d(st, map, &full[stage], c * CHUNK, x0, y0, b);
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
  // acc[SETS * TH]: tap t's set (SETS = 9, TH = 1) or row r's (SETS = 1).
  int acc[C::SETS * C::TH][NT / 2] = {};
  float sx = 0.f, snext = 1.f;
  if constexpr (EPI == EPI_LFF) {
    sx = *p.s_in;
    if (p.odt == NT_I8) snext = *p.s_next;
  }
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
        const uint64_t db = nt_wgmma_desc(wb + tap * NT * CHUNK, NT * 16, 128);
#pragma unroll
        for (int r = 0; r < C::TH; ++r) {
          const int row = r + tap / K;
          const uint64_t da = nt_wgmma_desc_sw32(in + (row * C::IW + tap % K) * CHUNK);
          if constexpr (C::SETS == 9)
            nt_wgmma_s8<NT>(acc[tap], da, db, c > 0);
          else
            nt_wgmma_s8<NT>(acc[r], da, db, c > 0 || tap > 0);
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
    const int xb = tx * WG_TW + warp * 16 + lane / 4, co0 = cot * NT + 2 * (lane % 4);
    if constexpr (EPI == EPI_LFF)
      lff_epilogue<NT, C::TH>(p, acc, b, ty, xb, cot, co0, sdq, sbias, sx, snext);
    else
      epilogue<K, NT, MODE>(p, acc, b, ty, xb, cot, co0, sdq, sbias, sinv);
  }
}

template <int K, int NT, int MODE>
__global__ void __launch_bounds__(WG_THREADS, 1)
    conv_i8_wgmma_kernel(const __grid_constant__ CUtensorMap map, const Params p) {
  conv_i8_wgmma<K, NT, MODE, EPI_CONV>(&map, p);
}

// The int8 RDB fusion (rdb_int8.cu): a 1x1 layer over the block's int8
// concatenation with the fusion's epilogue.
__global__ void __launch_bounds__(WG_THREADS, 1)
    lff_i8_wgmma_kernel(const __grid_constant__ CUtensorMap map, const Params p) {
  conv_i8_wgmma<1, NT_LFF_I8_N_TILE, NT_TAPS_DY, EPI_LFF>(&map, p);
}

// A launch of conv_i8_wgmma<K, NT, MODE, .>: its parameters, tensor map,
// dynamic shared memory and grid.
struct I8Launch {
  Params p;
  CUtensorMap map;
  int smem, smem_max, grid;
};

template <int K, int NT, int MODE>
cudaError_t plan_i8(const void* x, int xcs, int cin, const void* w, const float* dq,
                    const float* bias, const float* inv, void* out, int ocs, int ocoff, int cout,
                    int b, int h, int wd, int relu, int odt, I8Launch& l) {
  using C = Cfg<K, NT, MODE>;
  NtDeviceLimits lim;
  cudaError_t err = nt_device_limits(lim);
  if (err != cudaSuccess) return err;
  const NtEncodeTiled encode = nt_encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;

  Params& p = l.p;
  p.nchunks = (cin + CHUNK - 1) / CHUNK;
  p.cout = cout;
  p.ncot = (cout + NT - 1) / NT;
  p.cpad = p.ncot * NT;
  p.ocs = ocs;
  p.ocoff = ocoff;
  p.h = h;
  p.w = wd;
  p.relu = relu;
  p.odt = odt;
  const int esize = odt == NT_I8 ? 1 : odt == NT_BF16 ? 2 : 4;
  p.pair = ocs % 2 == 0 && ocoff % 2 == 0 && reinterpret_cast<uintptr_t>(out) % (2 * esize) == 0;
  p.tiles_x = (wd + WG_TW - 1) / WG_TW;
  p.tiles_y = (h + C::TH - 1) / C::TH;
  const long long ntiles = (long long)b * p.tiles_y * p.tiles_x * p.ncot;
  if (ntiles > INT32_MAX) return cudaErrorInvalidValue;
  p.ntiles = (int)ntiles;
  p.param_bytes = ceil_to((C::SETS + 2) * p.cpad * 4, 1024);
  p.wpack = static_cast<const uint8_t*>(w);
  p.dq = dq;
  p.bias = bias;
  p.inv = inv;
  p.out = out;
  p.res = static_cast<const int8_t*>(x);
  p.rcs = xcs;
  p.s_in = p.s_next = nullptr;

  // The weights stay resident where they fit beside two stages of each ring.
  const int avail = lim.smem - BAR_BYTES - p.param_bytes;
  const int wbytes = ceil_to(p.nchunks * C::W_BYTES, 1024);
  p.resident = p.ncot == 1 && wbytes + 2 * CONSUMERS * C::IN_BYTES <= avail;
  const int stage_bytes = ceil_to(C::IN_BYTES + (p.resident ? 0 : C::W_BYTES), 1024);
  p.stages = std::min(MAX_STAGES, (avail - (p.resident ? wbytes : 0)) / (CONSUMERS * stage_bytes));
  if (p.stages < 2) return cudaErrorInvalidValue;
  l.smem = BAR_BYTES + p.param_bytes + (p.resident ? wbytes : 0) +
           CONSUMERS * p.stages * stage_bytes;
  l.smem_max = lim.smem;
  l.grid = (int)std::min<long long>(ntiles, lim.sms);

  // (C, W, H, B) bytes, innermost first; a box is one 32-channel chunk of
  // the haloed tile, 32-byte rows in the 32-byte swizzle. Channels from
  // cin on read as zeros.
  const cuuint64_t dims[4] = {(cuuint64_t)cin, (cuuint64_t)wd, (cuuint64_t)h, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)xcs, (cuuint64_t)wd * xcs, (cuuint64_t)h * wd * xcs};
  const cuuint32_t box[4] = {CHUNK, C::IW, C::IH, 1}, estr[4] = {1, 1, 1, 1};
  if (encode(&l.map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x), dims, strides, box,
             estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int K, int NT, int MODE>
cudaError_t launch_cfg(const void* x, int xcs, int cin, const void* w, const float* dq,
                       const float* bias, const float* inv, void* out, int ocs, int ocoff,
                       int cout, int b, int h, int wd, int relu, int odt, cudaStream_t stream) {
  I8Launch l;
  cudaError_t err = plan_i8<K, NT, MODE>(x, xcs, cin, w, dq, bias, inv, out, ocs, ocoff, cout, b,
                                         h, wd, relu, odt, l);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv_i8_wgmma_kernel<K, NT, MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem_max);
  if (err != cudaSuccess) return err;
  conv_i8_wgmma_kernel<K, NT, MODE><<<l.grid, WG_THREADS, l.smem, stream>>>(l.map, l.p);
  return cudaGetLastError();
}

template <int K, int MODE>
cudaError_t launch_k(const void* x, int xcs, int cin, const void* w, const float* dq,
                     const float* bias, const float* inv, void* out, int ocs, int ocoff,
                     int cout, int b, int h, int wd, int relu, int odt, cudaStream_t st) {
  // The N tile, as ops/conv_chain_int8.py `n_tile_i8` packs the weights for.
  if (cout <= 8)
    return launch_cfg<K, 8, MODE>(x, xcs, cin, w, dq, bias, inv, out, ocs, ocoff, cout, b, h, wd,
                                  relu, odt, st);
  if (cout <= 16)
    return launch_cfg<K, 16, MODE>(x, xcs, cin, w, dq, bias, inv, out, ocs, ocoff, cout, b, h, wd,
                                   relu, odt, st);
  return launch_cfg<K, MAX_NT, MODE>(x, xcs, cin, w, dq, bias, inv, out, ocs, ocoff, cout, b, h,
                                     wd, relu, odt, st);
}

}  // namespace

cudaError_t nt_lff_i8_wgmma(const void* cat, int xcs, int ccat, const void* w, const float* ldq,
                            const float* lbias, const float* s_in, const float* s_next,
                            void* out, int ocs, int ocoff, int c, int b, int h, int wd, int odt,
                            cudaStream_t stream) {
  I8Launch l;
  cudaError_t err = plan_i8<1, NT_LFF_I8_N_TILE, NT_TAPS_DY>(cat, xcs, ccat, w, ldq, lbias,
                                                             nullptr, out, ocs, ocoff, c, b, h,
                                                             wd, 0, odt, l);
  if (err != cudaSuccess) return err;
  l.p.s_in = s_in;
  l.p.s_next = s_next;
  err = cudaFuncSetAttribute(lff_i8_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             l.smem_max);
  if (err != cudaSuccess) return err;
  lff_i8_wgmma_kernel<<<l.grid, WG_THREADS, l.smem, stream>>>(l.map, l.p);
  return cudaGetLastError();
}

extern "C" int nt_conv2d_i8(const void* x, int x_cstride, int cin, const void* w,
                            const float* dq, const float* bias, const float* inv,
                            void* out, int out_cstride, int out_coff, int cout, int b,
                            int h, int w_, int ksize, int relu, int out_dtype,
                            int taps_mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // The 1x1 layers (the conv chains') take the per-column schedule only.
  if ((ksize != 1 && ksize != 3) || x_cstride % 16 != 0 || cin < 1 || cin > x_cstride ||
      cout < 1 ||
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
