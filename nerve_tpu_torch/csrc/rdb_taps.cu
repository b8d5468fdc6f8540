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
// operations per pixel in bf16, ~0.82 TFLOP per 1080p block at 64
// features, 0.833 ms at the card's bf16 peak).
//
// bfloat16 is the dense layer's design (conv_chain.cu) with one accumulator set
// per group, in the shape of the int8 layer's per-tap schedules
// (conv_int8.cu):
//   * Grouped rounding needs each group's sum complete over all of cin
//     before it is rounded. So a consumer warpgroup keeps one float32
//     accumulator set per group in registers while the ring streams cin in
//     16-channel chunks, and issues each chunk's nine taps into their
//     groups' sets. The map of tap to set is fixed at compile time per
//     contract family and output-row parity (SET_OF below; one family per
//     distinct grouping, ops/rdb_taps.py `FAMILIES` is the same table): nine
//     sets for `pallas_dy`, `pallas_dx` (and `acc_dtype` and the ablations,
//     which walk its groups), six for `s2d`, one for `f32_taps`. The host
//     finds the family whose groups are the table's and refuses any other
//     table.
//   * Registers: a set of an m64nNT tile is NT / 2 floats a thread, so nine
//     sets at NT = 32 (the growth) hold 9 x 16 = 144 registers: a tile is
//     one 64-pixel row (two rows would need 288), N walks 32-wide tiles
//     for wider layers, and the consumers take 232 registers a thread
//     (setmaxnreg; the producer warpgroup gives its own back). The epilogue
//     folds the sets in the contract's order into the first set's
//     registers, one output element at a time.
//   * M is the row's 64 output pixels; A comes from shared memory through a
//     descriptor, the 16-channel chunk of the haloed 3 x 66 pixel tile as
//     TMA writes it in the 32-byte swizzle (32 bytes a pixel), each tap only
//     a start address into it (ky rows and kx pixels on); TMA's zero fill
//     is the SAME padding, the ragged edge and the channels past cin, so
//     any cin runs (the whole of cin is never resident). A one-row tile
//     stages its three haloed rows per row from L2 (3.1x the input's bytes
//     per layer; the 4-row tile of the serving layer stages 1.6x).
//   * B: the layer's weights packed once per call in bf16 by the wrapper
//     (ops/conv_chain.py `pack_conv_weights` at the N tile), resident in
//     shared memory across the block's tiles where they fit beside two
//     stages per ring, else streamed with each chunk.
//   * Shared memory: 1 KB of mbarriers, the resident weights (nchunks x 9 x
//     NT x 32 bytes: 110,592 at cin 192 and NT 32), and two rings of
//     stages of 7,168 bytes (a 6,336-byte box padded to 1 KB; 16,384 with
//     a streamed chunk of weights), up to 8 a ring: 227 KB at cin 192
//     (8 stages), 225 KB at cin 384 (weights streamed, 7 stages).
//   * Persistent blocks, one per SM, of three warpgroups: one producer
//     thread issues every copy; two consumer warpgroups take every other
//     tile of the block's walk (ping-pong), so that one's epilogue runs
//     beside the other's products. A stage goes back to the producer one
//     chunk after its products were issued (wgmma.wait_group 1).
//   * Epilogue: per output element, the sets in the contract's order: bias
//     into the centre tap's set, each set rounded to bf16 and added (the
//     accumulator rounded after each add for NT_TAPS_ACC_DTYPE), relu,
//     rounded, stored two channels at a time into the layer's slot.
// float32 runs as FP32 FMAs, one thread per pixel and eight output
// channels, reading through the caches: it exists for the tests.
// What the design still gives up: the three staged rows per output row; A
// and B both stream from shared memory for every product (at N = 32 more
// bytes per cycle than shared memory gives, as in the serving layer); the
// block's concatenation round-trips device memory per layer.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "nerve_tpu_torch.h"

namespace {

// ------------------------------------------------ the contract families
constexpr int NFAM = 4;
enum { F_DY9 = 0, F_DX9 = 1, F_ONE = 2, F_S2D = 3 };
// SET_OF[family][parity][t]: the accumulator set that tap t = 3 dy + dx
// adds into, for output rows of that parity.
constexpr int SET_OF[NFAM][2][9] = {
    {{0, 1, 2, 3, 4, 5, 6, 7, 8}, {0, 1, 2, 3, 4, 5, 6, 7, 8}},  // pallas_dy
    {{0, 1, 2, 3, 4, 5, 6, 7, 8}, {0, 1, 2, 3, 4, 5, 6, 7, 8}},  // pallas_dx
    {{0, 0, 0, 0, 0, 0, 0, 0, 0}, {0, 0, 0, 0, 0, 0, 0, 0, 0}},  // f32_taps
    {{3, 4, 5, 0, 1, 2, 0, 1, 2}, {0, 1, 2, 0, 1, 2, 3, 4, 5}},  // s2d
};
// FOLD[family][i]: the set the epilogue adds i-th (both parities).
constexpr int FOLD[NFAM][9] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8},  // pallas_dy
    {0, 3, 6, 1, 4, 7, 2, 5, 8},  // pallas_dx
    {0},                          // f32_taps
    {0, 1, 2, 3, 4, 5},           // s2d
};
constexpr int NSETS[NFAM] = {9, 9, 1, 6};

__host__ __device__ constexpr int set_of(int f, int par, int t) { return SET_OF[f][par][t]; }
__host__ __device__ constexpr int fold_at(int f, int i) { return FOLD[f][i]; }
__host__ __device__ constexpr int nsets(int f) { return NSETS[f]; }
// Whether tap t is the first of its set in the order the products are
// issued (t = 0..8): its product then overwrites the set in chunk 0.
__host__ __device__ constexpr bool first_of_set(int f, int par, int t) {
  for (int u = 0; u < t; ++u)
    if (SET_OF[f][par][u] == SET_OF[f][par][t]) return false;
  return true;
}

struct TapTable {
  int order[2][9];  // taps in walk order, per output-row parity
  int ends[2];      // bit i: a group ends after the i-th tap of the walk
};

// The family whose groups, in its fold order, are the table's groups in
// walk order, or -1.
int family_of(const TapTable& tbl) {
  for (int f = 0; f < NFAM; ++f) {
    bool same = true;
    for (int par = 0; par < 2 && same; ++par) {
      int i = 0;  // position in the table's walk
      for (int g = 0; g < NSETS[f] && same; ++g) {
        unsigned want = 0, got = 0;
        for (int t = 0; t < 9; ++t)
          if (SET_OF[f][par][t] == FOLD[f][g]) want |= 1u << t;
        for (; i < 9; ++i) {
          got |= 1u << tbl.order[par][i];
          if ((tbl.ends[par] >> i) & 1) break;
        }
        ++i;
        same = got == want;
      }
      same = same && i == 9;
    }
    if (same) return f;
  }
  return -1;
}

__host__ __device__ constexpr int ceil_to(int v, int m) { return (v + m - 1) / m * m; }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---------------------------------------------------------------- bfloat16

constexpr int WG_TW = 64;        // output pixels of a tile (one row): one wgmma M
constexpr int CONSUMERS = 2;     // consumer warpgroups; warpgroup 0 produces
constexpr int WG_THREADS = 128 * (CONSUMERS + 1);
constexpr int MAX_STAGES = 8;    // per consumer's ring
constexpr int BAR_BYTES = 1024;  // the mbarriers, at the start of shared memory
constexpr int IH = 3, IW = WG_TW + 2;
// One 16-channel TMA box of the haloed row (32 bytes a pixel, 32-byte
// swizzle); its place in a stage is padded to 1024 bytes.
constexpr int BOX_BYTES = IH * IW * 32;
constexpr int IN_BYTES = ceil_to(BOX_BYTES, 1024);
// One chunk's weights, every tap, at N tile nt.
__host__ __device__ constexpr int w_bytes(int nt) { return 9 * nt * 32; }

struct Params {
  int nchunks, cout, ocs, ocoff, h, w, pair, flags;
  int tiles_x, ncot, ntiles, resident, stages;
  const uint8_t* wpack;
  const float* bias;
  __nv_bfloat16* out;
};

// Tile t: N tile fastest, then the row's 64-pixel column tile, the row, the image.
__device__ __forceinline__ void decode_tile(const Params& p, int t, int& cot, int& tx, int& y,
                                            int& b) {
  cot = t % p.ncot;
  t /= p.ncot;
  tx = t % p.tiles_x;
  t /= p.tiles_x;
  y = t % p.h;
  b = t / p.h;
}

// One chunk's nine taps, each into its set (compile-time), A at the tap's
// start in the staged box, B the tap's weights.
template <int NT, int FAM, int PAR, int TAP = 0>
__device__ __forceinline__ void chunk_products(float (&acc)[nsets(FAM)][NT / 2], unsigned in,
                                               unsigned wb, bool more) {
  if constexpr (TAP < 9) {
    constexpr int SET = set_of(FAM, PAR, TAP);
    constexpr bool FIRST = first_of_set(FAM, PAR, TAP);
    const uint64_t db = nt_wgmma_desc(wb + TAP * NT * 32, NT * 16, 128);
    const uint64_t da = nt_wgmma_desc_sw32(in + ((TAP / 3) * IW + TAP % 3) * 32);
    nt_wgmma<NT>(acc[SET], da, db, more || !FIRST);
    chunk_products<NT, FAM, PAR, TAP + 1>(acc, in, wb, more);
  }
}

// A consumer's ring position: the stage it waits on, its phase, and the
// stage it still holds (handed back one chunk later).
struct Ring {
  int stage, phase, held;
};

// Every chunk of one tile's products for output-row parity PAR.
template <int NT, int FAM, int PAR>
__device__ __forceinline__ void tile_products(const Params& p, float (&acc)[nsets(FAM)][NT / 2],
                                              uint8_t* ring, uint8_t* wres, int stage_bytes,
                                              uint64_t* full, uint64_t* empty, int cw,
                                              Ring& r) {
  const int lane = threadIdx.x % 32;
  for (int c = 0; c < p.nchunks; ++c) {
    nt_mbar_wait(&full[r.stage], r.phase);
    __syncwarp();
    const unsigned in = nt_smem_addr(ring + r.stage * stage_bytes);
    const unsigned wb = p.resident ? nt_smem_addr(wres + c * w_bytes(NT)) : in + IN_BYTES;
    nt_wgmma_fence();
    chunk_products<NT, FAM, PAR>(acc, in, wb, c > 0);
    nt_wgmma_commit();
    nt_wgmma_wait<1>();
    if (r.held >= 0 && lane == 0) nt_mbar_arrive(&empty[r.held]);
    r.held = r.stage;
    if (++r.stage == (cw + 1) * p.stages) {
      r.stage = cw * p.stages;
      r.phase ^= 1;
    }
  }
}

// Element k of a thread's accumulators folded under the contract into a:
// the sets in fold order I = 0, 1, ..., the centre tap's with the bias.
template <int NT, int FAM, int I = 0>
__device__ __forceinline__ void fold(const float (&acc)[nsets(FAM)][NT / 2], int k, float bias,
                                     bool acc_dtype, bool noshift, float& a) {
  if constexpr (I < nsets(FAM)) {
    constexpr int SET = fold_at(FAM, I);
    constexpr bool CENTRE = SET == set_of(FAM, 0, 4);
    float g = acc[SET][k];
    if (CENTRE) g = __fadd_rn(g, bias);
    const float r = round_bf16(g);
    if (noshift) {
      if (CENTRE) a = r;
    } else {
      a = __fadd_rn(a, r);
      if (acc_dtype) a = round_bf16(a);
    }
    fold<NT, FAM, I + 1>(acc, k, bias, acc_dtype, noshift, a);
  }
}

template <int NT, int FAM>
__global__ void __launch_bounds__(WG_THREADS, 1)
    taps_wgmma_kernel(const __grid_constant__ CUtensorMap map, const Params p) {
  constexpr int NS = nsets(FAM);
  static_assert(set_of(FAM, 0, 4) == set_of(FAM, 1, 4), "the centre tap's set is one set");
  extern __shared__ __align__(1024) uint8_t smem[];
  // Each consumer warpgroup has a ring of p.stages stages of its own.
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + CONSUMERS * MAX_STAGES;
  uint64_t* wbar = empty + CONSUMERS * MAX_STAGES;
  uint8_t* wres = smem + BAR_BYTES;
  const int wres_bytes = p.resident ? p.nchunks * w_bytes(NT) : 0;
  uint8_t* ring = wres + ceil_to(wres_bytes, 1024);
  const int stage_bytes = ceil_to(IN_BYTES + (p.resident ? 0 : w_bytes(NT)), 1024);
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
        nt_bulk_load(wres + c * w_bytes(NT), p.wpack + (size_t)c * w_bytes(NT), w_bytes(NT),
                     wbar);
    }
    int rstage[CONSUMERS] = {}, rphase[CONSUMERS] = {};
    for (int t = blockIdx.x, k = 0; t < p.ntiles; t += gridDim.x, ++k) {
      int cot, tx, y, b;
      decode_tile(p, t, cot, tx, y, b);
      const int ring_id = k % CONSUMERS;  // tile k of the walk is warpgroup k % 2's
      for (int c = 0; c < p.nchunks; ++c) {
        int& phase = rphase[ring_id];
        const int stage = ring_id * p.stages + rstage[ring_id];
        nt_mbar_wait(&empty[stage], phase ^ 1);
        nt_mbar_expect_tx(&full[stage], BOX_BYTES + (p.resident ? 0 : w_bytes(NT)));
        uint8_t* st = ring + stage * stage_bytes;
        nt_tma_load_4d(st, &map, &full[stage], c * 16, tx * WG_TW - 1, y - 1, b);
        if (!p.resident)
          nt_bulk_load(st + IN_BYTES,
                       p.wpack + ((size_t)cot * p.nchunks + c) * w_bytes(NT), w_bytes(NT),
                       &full[stage]);
        if (++rstage[ring_id] == p.stages) {
          rstage[ring_id] = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // Consumers: warpgroup cw takes every other tile of the block's walk from
  // its own ring.
  nt_setmaxnreg_inc<232>();
  const int cw = wg - 1, warp = (tid % 128) / 32, lane = tid % 32;
  const bool acc_dtype = p.flags & NT_TAPS_ACC_DTYPE, noshift = p.flags & NT_TAPS_NOSHIFT;
  const bool matonly = p.flags & NT_TAPS_MATONLY;
  float acc[NS][NT / 2] = {};
  if (p.resident) nt_mbar_wait(wbar, 0);
  Ring r{cw * p.stages, 0, -1};
  for (int t = blockIdx.x + cw * gridDim.x; t < p.ntiles; t += CONSUMERS * gridDim.x) {
    int cot, tx, y, b;
    decode_tile(p, t, cot, tx, y, b);
    if constexpr (FAM == F_S2D) {
      if (y & 1)
        tile_products<NT, FAM, 1>(p, acc, ring, wres, stage_bytes, full, empty, cw, r);
      else
        tile_products<NT, FAM, 0>(p, acc, ring, wres, stage_bytes, full, empty, cw, r);
    } else {
      tile_products<NT, FAM, 0>(p, acc, ring, wres, stage_bytes, full, empty, cw, r);
    }
    nt_wgmma_wait<0>();
    if (lane == 0) nt_mbar_arrive(&empty[r.held]);
    r.held = -1;

    // Epilogue: row 16 warp + lane / 4 + 8 i of the wgmma tile is pixel
    // column xb + 8 i; acc[s][4 j + 2 i + e] is channel co0 + 8 j + e.
    const int xb = tx * WG_TW + warp * 16 + lane / 4, co0 = cot * NT + 2 * (lane % 4);
    __nv_bfloat16* orow = p.out + (size_t)(b * p.h + y) * p.w * p.ocs + p.ocoff;
    if (matonly) {
      // The sets folded unrounded, one token per warp: the products are
      // kept, the layer is not stored.
      float tok = 0.f;
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int k = 0; k < NT / 2; ++k) tok += acc[s][k];
      const int gx = tx * WG_TW + warp * 16;
      if (lane == 0 && gx < p.w) orow[(size_t)gx * p.ocs + cot * NT] = __float2bfloat16_rn(tok);
      continue;
    }
    float bias[NT / 8][2];
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = co0 + 8 * j + e;
        bias[j][e] = co < p.cout ? __ldg(p.bias + co) : 0.f;
      }
    // Fold each element's sets into set 0's register, then store.
#pragma unroll
    for (int k = 0; k < NT / 2; ++k) {
      float a = 0.f;
      fold<NT, FAM>(acc, k, bias[k / 4][k % 2], acc_dtype, noshift, a);
      acc[0][k] = fmaxf(a, 0.f);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int gx = xb + 8 * i;
      if (gx >= p.w) continue;
      __nv_bfloat16* o = orow + (size_t)gx * p.ocs;
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
        const int co = co0 + 8 * j;
        const float v0 = acc[0][4 * j + 2 * i], v1 = acc[0][4 * j + 2 * i + 1];
        if (p.pair && co + 1 < p.cout) {
          *reinterpret_cast<__nv_bfloat162*>(o + co) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (co < p.cout) o[co] = __float2bfloat16_rn(v0);
          if (co + 1 < p.cout) o[co + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// A launch of taps_wgmma_kernel<NT, FAM>: its parameters, tensor map,
// dynamic shared memory and grid.
struct TapsLaunch {
  Params p;
  CUtensorMap map;
  int smem, smem_max, grid, nt, nsets;
  const void* fn;
};

template <int NT, int FAM>
cudaError_t plan(const void* x, int xcs, int cin, const void* w, const float* bias, void* out,
                 int ocs, int ocoff, int cout, int b, int h, int wd, int flags, TapsLaunch& l) {
  NtDeviceLimits lim;
  cudaError_t err = nt_device_limits(lim);
  if (err != cudaSuccess) return err;
  const NtEncodeTiled encode = nt_encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;

  Params& p = l.p;
  p.nchunks = (cin + 15) / 16;
  p.cout = cout;
  p.ocs = ocs;
  p.ocoff = ocoff;
  p.h = h;
  p.w = wd;
  p.flags = flags;
  p.pair = ocs % 2 == 0 && ocoff % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
  p.tiles_x = (wd + WG_TW - 1) / WG_TW;
  p.ncot = (cout + NT - 1) / NT;
  const long long ntiles = (long long)b * h * p.tiles_x * p.ncot;
  if (ntiles > INT32_MAX) return cudaErrorInvalidValue;
  p.ntiles = (int)ntiles;
  p.wpack = static_cast<const uint8_t*>(w);
  p.bias = bias;
  p.out = static_cast<__nv_bfloat16*>(out);

  // The weights stay resident where they fit beside two stages of each ring.
  const int avail = lim.smem - BAR_BYTES;
  const long long wbytes = ceil_to(p.nchunks * w_bytes(NT), 1024);
  p.resident = p.ncot == 1 && wbytes + 2 * CONSUMERS * IN_BYTES <= avail;
  const int stage_bytes = ceil_to(IN_BYTES + (p.resident ? 0 : w_bytes(NT)), 1024);
  p.stages = std::min<long long>(MAX_STAGES, (avail - (p.resident ? wbytes : 0)) /
                                                 (CONSUMERS * stage_bytes));
  if (p.stages < 2) return cudaErrorInvalidValue;
  l.smem = BAR_BYTES + (p.resident ? (int)wbytes : 0) + CONSUMERS * p.stages * stage_bytes;
  l.smem_max = lim.smem;
  l.grid = (int)std::min<long long>(ntiles, lim.sms);
  l.nt = NT;
  l.nsets = nsets(FAM);
  l.fn = reinterpret_cast<const void*>(taps_wgmma_kernel<NT, FAM>);

  // (C, W, H, B), innermost first; a box is one 16-channel chunk of the
  // haloed row, 32-byte rows in the 32-byte swizzle. Channels from cin on
  // read as zeros.
  const cuuint64_t dims[4] = {(cuuint64_t)cin, (cuuint64_t)wd, (cuuint64_t)h, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)xcs * 2, (cuuint64_t)wd * xcs * 2,
                                 (cuuint64_t)h * wd * xcs * 2};
  const cuuint32_t box[4] = {16, IW, IH, 1}, estr[4] = {1, 1, 1, 1};
  if (encode(&l.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// Plan, then launch or (rec) fill the launch record.
template <int NT, int FAM>
cudaError_t run_cfg(const void* x, int xcs, int cin, const void* w, const float* bias, void* out,
                    int ocs, int ocoff, int cout, int b, int h, int wd, int flags, int* rec,
                    cudaStream_t stream) {
  TapsLaunch l;
  cudaError_t err =
      plan<NT, FAM>(x, xcs, cin, w, bias, out, ocs, ocoff, cout, b, h, wd, flags, l);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(taps_wgmma_kernel<NT, FAM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem_max);
  if (err != cudaSuccess) return err;
  if (rec != nullptr) {
    cudaFuncAttributes a;
    if ((err = cudaFuncGetAttributes(&a, l.fn)) != cudaSuccess) return err;
    const int r[11] = {l.grid, WG_THREADS, l.smem, (int)a.sharedSizeBytes, a.numRegs,
                       (int)a.localSizeBytes, l.p.ntiles, l.nt, l.p.stages, l.p.resident,
                       l.nsets};
    for (int i = 0; i < 11; ++i) rec[i] = r[i];
    return cudaSuccess;
  }
  taps_wgmma_kernel<NT, FAM><<<l.grid, WG_THREADS, l.smem, stream>>>(l.map, l.p);
  return cudaGetLastError();
}

template <int NT>
cudaError_t run_family(int fam, const void* x, int xcs, int cin, const void* w,
                       const float* bias, void* out, int ocs, int ocoff, int cout, int b, int h,
                       int wd, int flags, int* rec, cudaStream_t st) {
  switch (fam) {
    case F_DY9:
      return run_cfg<NT, F_DY9>(x, xcs, cin, w, bias, out, ocs, ocoff, cout, b, h, wd, flags,
                                rec, st);
    case F_DX9:
      return run_cfg<NT, F_DX9>(x, xcs, cin, w, bias, out, ocs, ocoff, cout, b, h, wd, flags,
                                rec, st);
    case F_ONE:
      return run_cfg<NT, F_ONE>(x, xcs, cin, w, bias, out, ocs, ocoff, cout, b, h, wd, flags,
                                rec, st);
    default:
      return run_cfg<NT, F_S2D>(x, xcs, cin, w, bias, out, ocs, ocoff, cout, b, h, wd, flags,
                                rec, st);
  }
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

// The table read into tbl; its groups' family, -1 if no family has them,
// -2 if a tap is out of range.
static int checked_family(const int* table, TapTable& tbl) {
  bool ok = true;
  for (int p = 0; p < 2; ++p) {
    for (int i = 0; i < 9; ++i) {
      tbl.order[p][i] = table[p * 9 + i];
      ok = ok && tbl.order[p][i] >= 0 && tbl.order[p][i] <= 8;
    }
    tbl.ends[p] = table[18 + p];
  }
  return ok ? family_of(tbl) : -2;
}

static int taps_bf16(const void* x, int xcs, int cin, const void* w, const float* bias,
                     void* out, int ocs, int ocoff, int cout, int b, int h, int wd, int fam,
                     int flags, int* rec, cudaStream_t st) {
  // TMA: 16-byte pixel strides and base; the weight image read by bulk copies.
  if (xcs % 8 != 0 || cin > xcs || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      (rec == nullptr && reinterpret_cast<uintptr_t>(w) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  // The N tile, as ops/rdb_taps.py `n_tile` packs the weights for.
  return (int)(cout <= 16 ? run_family<16> : run_family<32>)(
      fam, x, xcs, cin, w, bias, out, ocs, ocoff, cout, b, h, wd, flags, rec, st);
}

extern "C" int nt_rdb_taps_conv(const void* x, int x_cstride, int cin, const void* w,
                                const float* bias, void* out, int out_cstride,
                                int out_coff, int cout, int b, int h, int w_,
                                const int* table, int flags, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  TapTable tbl;
  const int fam = checked_family(table, tbl);
  if (cin < 1 || cout < 1 || b < 1 || h < 1 || w_ < 1) return (int)cudaErrorInvalidValue;
  if (dtype == NT_F32) {
    if (fam == -2) return (int)cudaErrorInvalidValue;
    const long long npix = (long long)b * h * w_;
    const dim3 grid((unsigned)((npix + FMA_THREADS - 1) / FMA_THREADS), (cout + FMA_O - 1) / FMA_O);
    taps_fma_kernel<<<grid, FMA_THREADS, 0, st>>>(
        static_cast<const float*>(x), x_cstride, cin, static_cast<const float*>(w), bias,
        static_cast<float*>(out), out_cstride, out_coff, cout, b, h, w_, tbl, flags);
    return (int)cudaGetLastError();
  }
  if (dtype != NT_BF16 || fam < 0) return (int)cudaErrorInvalidValue;
  return taps_bf16(x, x_cstride, cin, w, bias, out, out_cstride, out_coff, cout, b, h, w_, fam,
                   flags, nullptr, st);
}

extern "C" int nt_rdb_taps_launch(const void* x, int x_cstride, int cin, int cout, int b, int h,
                                  int w_, const int* table, int* rec, void* stream) {
  TapTable tbl;
  const int fam = checked_family(table, tbl);
  if (fam < 0 || cin < 1 || cout < 1 || b < 1 || h < 1 || w_ < 1)
    return (int)cudaErrorInvalidValue;
  return taps_bf16(x, x_cstride, cin, nullptr, nullptr, nullptr, cout, 0, cout, b, h, w_, fam, 0,
                   rec, static_cast<cudaStream_t>(stream));
}
