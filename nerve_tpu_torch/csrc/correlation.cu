// Cost-volume correlation for the flow estimator.
//
// Replaces nerve_tpu/ops/correlation.py `_corr_kernel_planar` (reached via
// `_correlation_pallas_planar`) and its NHWC sibling `_corr_kernel` (via
// `_correlation_pallas`), which compute the same function on the same NHWC
// input and output:
//
//   out[b,y,x,(i+d)(2d+1)+(j+d)] = round_T(1/C * sum_c round_T(f1[b,y,x,c] * f2[b,y+i,x+j,c]))
//
// with zeros outside f2 and 1/C the float32 reciprocal. Numerics are the TPU
// kernels' (correlation.py:74, :177): each product is rounded to the input
// dtype T (the float32 product of two bfloat16 values is exact, so this is
// one rounding), the products are summed in float32 in an order the
// reference leaves free, the sum is multiplied by 1/C and rounded once to T.
//
// Bound. At the serving shape (f1, f2 = 2 x 540 x 960 x 64 bf16, d = 4) the
// function is 2 * 540 * 960 * 81 * 64 = 5.37 G products. It must move 0.43 GB
// (each input read once, the 81-channel output written once): 0.129 ms at
// 3.35 TB/s. That is the function's bound: its multiplies and adds take less
// at the card's bfloat16 rates (the rounded products could be summed exactly
// by a tensor-core product with a ones operand). This kernel does all its
// work on the CUDA cores, and its own bound is their issue rate: a product
// costs at least half a `mul.rn.bf16x2` (two products, each rounded to
// bfloat16, in one instruction), one widening of its half to float32 (a
// shift or a mask of the bits) and one float32 add: 2.5 instructions, 0.40
// ms at 132 SMs x 128 lanes x 1.98 GHz. The design spends as little as it
// can beside those 2.5 instructions: on an H100 80GB HBM3 at 700 W it runs
// 0.62-0.66 ms (`python -m nerve_tpu_torch.diag.correlation`).
//
// * Inputs by TMA. Per tile of TH x TW output pixels, one 4-D box of f1
//   (TH, TW, 128 bytes of channels) and one of f2 with its d-pixel halo
//   (TH + 2d, TW + 2d, 128 bytes) land in shared memory as [row][col][128 B]
//   rows. Coordinates outside the tensor read as zeros, which is the
//   correlation's zero padding on all four edges (the f2 box starts at
//   x0 - d, y0 - d; negative starts are allowed) and the zero channels past
//   C. The channel start is a multiple of 128 bytes, so the innermost start
//   coordinate is always 16-byte aligned. A tensor map needs a pixel stride
//   that is a multiple of 16 bytes: the wrapper pads other channel counts
//   with zero channels and passes the true C for 1/C.
// * Persistent blocks, one per SM at d = 4, walk the tiles. Their loads run
//   through two stages on two mbarriers: the copy of the next (tile,
//   channel chunk) runs under this one's products.
// * Register blocking. A thread owns a run of P = 4 pixels along x of one
//   output row and one displacement row i: 4 x (2d+1) float32 sums. For
//   each 16-byte piece of channels it holds its 4 pixels' f1 words and
//   streams the P + 2d f2 pixels of row y + i past them, so one f2 load
//   feeds P x (2d+1) / (P + 2d) = 3 pixels' products at d = 4. P = 8
//   would reuse f2 more but gives 9 warps a block, which the SM's four
//   schedulers split 3-2-2-2, against P = 4's 18 warps, 5-5-4-4.
// * Conflict-free reads without a swizzle or a transpose. A pixel's 128
//   bytes are eight 16-byte pieces, which are the eight bank groups of a
//   quarter warp's 16-byte loads. Lane l walks the pieces in the order
//   (s + l) mod 8, s = 0..7, so the eight lanes of every quarter warp read
//   eight different bank groups at every step, whatever pixels they own.
//   The sum's order is free, so the rotation costs one add a step; without
//   it every quarter-warp load is an eight-way conflict. (A 128-byte TMA
//   swizzle needs a lane-to-pixel map whose quarter warps span eight pixels
//   mod 8, which breaks the runs of neighbouring pixels that make the f2
//   reuse; a transpose to channel-pair-planar words costs a pass through
//   shared memory per chunk. Neither was built.)
// * Paired products. bfloat16 channel pairs are 32-bit words: one
//   `mul.rn.bf16x2` gives both products already rounded, the contract in
//   one instruction; each half is widened by a shift or a mask and added in
//   float32 (`__fadd_rn`, never contracted into an FMA). Widening the
//   operands instead ([v | +0] words) would leave one useful product per
//   multiply. float32 runs the same walk with one product and one add per
//   channel.
// * Coalesced output. After a tile's last chunk its TH x TW x (2d+1)^2
//   results are staged in shared memory in the output's own order, in the
//   stage the tile's last chunk used, and a tile row of TW pixels, which is
//   TW x (2d+1)^2 contiguous values in the output, is written with 16-byte
//   stores (element stores where a row does not start on 16 bytes).
//
// Sizing. TH x TW = 8 x 32; one stage holds 128 bytes of channels (64
// bfloat16 or 32 float32) for the f1 tile (32 KB) and the f2 window (16 x 40
// pixels at d = 4, 80 KB): two stages are 224 KB, one block of 576 threads
// (18 warps, 91 registers, no spills) per SM. Smaller d takes smaller
// windows and fewer threads (TH x TW / P x (2d+1)).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "nerve_tpu_torch.h"

namespace {

constexpr int TH = 8, TW = 32, P = 4, RUNS = TW / P;
constexpr int PIX = 128;   // shared-memory bytes of one pixel's channel chunk
constexpr int PIECES = 8;  // 16-byte pieces of a chunk

template <int D>
struct Geo {
  static constexpr int K = 2 * D + 1, KK = K * K;
  static constexpr int NT = TH * RUNS * K;  // threads: (row, run, displacement row)
  static constexpr int IH = TH + 2 * D, IW = TW + 2 * D;
  static constexpr int F1_BYTES = TH * TW * PIX, F2_BYTES = IH * IW * PIX;
  static constexpr int STAGE = F1_BYTES + F2_BYTES;
  static constexpr int SMEM = 2 * STAGE + 2 * 8;  // two stages, then their mbarriers
};

struct CorrParams {
  int h, w, tiles_x, tiles_y, ntiles, nchunks;
  float inv_c;
};

__device__ __forceinline__ unsigned mul_bf16x2(unsigned a, unsigned b) {
  unsigned r;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// acc += the rounded products of one 16-byte piece of f1 and f2 channels.
__device__ __forceinline__ void mac(float& acc, const uint4& a, const uint4& b, __nv_bfloat16) {
  const unsigned av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned p = mul_bf16x2(av[k], bv[k]);
    acc = __fadd_rn(acc, __uint_as_float(p << 16));
    acc = __fadd_rn(acc, __uint_as_float(p & 0xffff0000u));
  }
}
__device__ __forceinline__ void mac(float& acc, const uint4& a, const uint4& b, float) {
  const unsigned av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    acc = __fadd_rn(acc, __fmul_rn(__uint_as_float(av[k]), __uint_as_float(bv[k])));
}

__device__ __forceinline__ void to_out(__nv_bfloat16* o, float v) { *o = __float2bfloat16_rn(v); }
__device__ __forceinline__ void to_out(float* o, float v) { *o = v; }

__device__ __forceinline__ void decode_tile(const CorrParams& p, int t, int& b, int& y0,
                                            int& x0) {
  const int tx = t % p.tiles_x, r = t / p.tiles_x;
  x0 = tx * TW;
  y0 = (r % p.tiles_y) * TH;
  b = r / p.tiles_y;
}

// Job q of a block: chunk q % nchunks of its tile q / nchunks, into stage q % 2.
template <typename T, int D>
__device__ __forceinline__ void issue(const CUtensorMap* m1, const CUtensorMap* m2,
                                      unsigned char* smem, uint64_t* full, const CorrParams& p,
                                      int q) {
  using G = Geo<D>;
  int b, y0, x0;
  decode_tile(p, blockIdx.x + q / p.nchunks * gridDim.x, b, y0, x0);
  const int c0 = q % p.nchunks * (PIX / (int)sizeof(T)), s = q & 1;
  unsigned char* st = smem + s * G::STAGE;
  nt_mbar_expect_tx(&full[s], G::STAGE);
  nt_tma_load_4d(st, m1, &full[s], c0, x0, y0, b);
  nt_tma_load_4d(st + G::F1_BYTES, m2, &full[s], c0, x0 - D, y0 - D, b);
}

template <typename T, int D>
__global__ void __launch_bounds__(Geo<D>::NT, 1)
    corr_kernel(const __grid_constant__ CUtensorMap m1, const __grid_constant__ CUtensorMap m2,
                T* __restrict__ out, const CorrParams p) {
  using G = Geo<D>;
  static_assert(TH * TW * G::KK * (int)sizeof(T) <= G::STAGE, "the staged tile must fit a stage");
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * G::STAGE);
  const int tid = threadIdx.x;
  const int run = tid % RUNS, row = (tid / RUNS) % TH, di = tid / (RUNS * TH);
  const int rot = tid % PIECES;
  const int mine = (p.ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int njobs = mine * p.nchunks;  // (tile, chunk) pairs of this block, in order

  if (tid == 0) {
    nt_mbar_init(&full[0], 1);
    nt_mbar_init(&full[1], 1);
    nt_fence_mbar_init();
    for (int q = 0; q < 2 && q < njobs; ++q) issue<T, D>(&m1, &m2, smem, full, p, q);
  }
  __syncthreads();

  float acc[P][G::K];
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int j = 0; j < G::K; ++j) acc[i][j] = 0.f;

  for (int q = 0; q < njobs; ++q) {
    unsigned char* st = smem + (q & 1) * G::STAGE;
    nt_mbar_wait(&full[q & 1], (q >> 1) & 1);
    const unsigned char* a_base = st + (row * TW + run * P) * PIX;
    const unsigned char* b_base = st + G::F1_BYTES + ((row + di) * G::IW + run * P) * PIX;
#pragma unroll 1
    for (int s = 0; s < PIECES; ++s) {
      const int off = ((s + rot) % PIECES) * 16;
      uint4 a[P];
#pragma unroll
      for (int i = 0; i < P; ++i) a[i] = *reinterpret_cast<const uint4*>(a_base + i * PIX + off);
#pragma unroll
      for (int x = 0; x < P + 2 * D; ++x) {
        const uint4 bv = *reinterpret_cast<const uint4*>(b_base + x * PIX + off);
#pragma unroll
        for (int i = 0; i < P; ++i)
          if (x - i >= 0 && x - i < G::K) mac(acc[i][x - i], a[i], bv, T{});
      }
    }
    __syncthreads();  // every read of this stage is done

    if (q % p.nchunks == p.nchunks - 1) {
      // The tile's results, in the output's order, into this stage.
      int b, y0, x0;
      decode_tile(p, blockIdx.x + q / p.nchunks * gridDim.x, b, y0, x0);
      T* staged = reinterpret_cast<T*>(st);
#pragma unroll
      for (int i = 0; i < P; ++i)
#pragma unroll
        for (int j = 0; j < G::K; ++j) {
          to_out(staged + (row * TW + run * P + i) * G::KK + di * G::K + j,
                 __fmul_rn(acc[i][j], p.inv_c));
          acc[i][j] = 0.f;
        }
      __syncthreads();
      // Tile row r is TW x KK contiguous values of the output.
      constexpr int ROW_BYTES = TW * G::KK * (int)sizeof(T), VPR = (ROW_BYTES + 15) / 16;
      const int nrows = min(TH, p.h - y0);
      const int row_bytes = min(TW, p.w - x0) * G::KK * (int)sizeof(T);
      const long long ostride = (long long)p.w * G::KK * sizeof(T);
      unsigned char* obase = reinterpret_cast<unsigned char*>(out) +
                             (((long long)b * p.h + y0) * p.w + x0) * G::KK * sizeof(T);
      for (int v = tid; v < nrows * VPR; v += G::NT) {
        const int r = v / VPR, lo = (v - r * VPR) * 16;
        if (lo >= row_bytes) continue;
        unsigned char* dst = obase + r * ostride;
        const unsigned char* src = st + r * ROW_BYTES;
        if (lo + 16 <= row_bytes && reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
          *reinterpret_cast<uint4*>(dst + lo) = *reinterpret_cast<const uint4*>(src + lo);
        } else {
          for (int e = lo; e < min(row_bytes, lo + 16); e += sizeof(T))
            *reinterpret_cast<T*>(dst + e) = *reinterpret_cast<const T*>(src + e);
        }
      }
      nt_fence_proxy_async();  // the stage's generic accesses before the next copy into it
      __syncthreads();
    }
    if (tid == 0 && q + 2 < njobs) issue<T, D>(&m1, &m2, smem, full, p, q + 2);
  }
}

// The grid, block and shared memory of a launch; the kernel's registers,
// static shared memory and spills (cudaFuncGetAttributes).
struct CorrLaunch {
  CorrParams p;
  CUtensorMap m1, m2;
  int grid, threads, smem;
};

template <typename T, int D>
cudaError_t plan(const void* f1, const void* f2, int b, int h, int w, int c, int cs,
                 CorrLaunch& l) {
  using G = Geo<D>;
  NtDeviceLimits lim;
  cudaError_t err = nt_device_limits(lim);
  if (err != cudaSuccess) return err;
  static int per_sm[64] = {};  // blocks an SM holds, once the kernel is configured
  int dev;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (per_sm[dev] == 0) {
    err = cudaFuncSetAttribute(corr_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               G::SMEM);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev], corr_kernel<T, D>, G::NT,
                                                          G::SMEM);
    if (err != cudaSuccess) return err;
    if (per_sm[dev] < 1) return cudaErrorInvalidConfiguration;
  }

  CorrParams& p = l.p;
  p.h = h;
  p.w = w;
  p.tiles_x = (w + TW - 1) / TW;
  p.tiles_y = (h + TH - 1) / TH;
  const long long ntiles = (long long)b * p.tiles_x * p.tiles_y;
  if (ntiles > INT32_MAX) return cudaErrorInvalidValue;
  p.ntiles = (int)ntiles;
  constexpr int CK = PIX / (int)sizeof(T);
  p.nchunks = (cs + CK - 1) / CK;
  p.inv_c = 1.0f / (float)c;
  l.grid = (int)std::min<long long>(ntiles, (long long)lim.sms * per_sm[dev]);
  l.threads = G::NT;
  l.smem = G::SMEM;

  const NtEncodeTiled encode = nt_encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // (C, W, H, B), innermost first; a box is a 128-byte chunk of channels.
  const CUtensorMapDataType dt =
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint64_t es = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)cs, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)b};
  const cuuint64_t strides[3] = {cs * es, (cuuint64_t)w * cs * es, (cuuint64_t)h * w * cs * es};
  const cuuint32_t box1[4] = {(cuuint32_t)CK, TW, TH, 1};
  const cuuint32_t box2[4] = {(cuuint32_t)CK, G::IW, G::IH, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const void* src[2] = {f1, f2};
  const cuuint32_t* box[2] = {box1, box2};
  CUtensorMap* map[2] = {&l.m1, &l.m2};
  for (int i = 0; i < 2; ++i)
    if (encode(map[i], dt, 4, const_cast<void*>(src[i]), dims, strides, box[i], estr,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t run(const void* f1, const void* f2, void* out, int b, int h, int w, int c, int cs,
                int* rec, cudaStream_t stream) {
  CorrLaunch l;
  cudaError_t err = plan<T, D>(f1, f2, b, h, w, c, cs, l);
  if (err != cudaSuccess) return err;
  if (rec != nullptr) {
    cudaFuncAttributes a;
    if ((err = cudaFuncGetAttributes(&a, corr_kernel<T, D>)) != cudaSuccess) return err;
    const int r[7] = {l.grid, l.threads, l.smem, (int)a.sharedSizeBytes, a.numRegs,
                      (int)a.localSizeBytes, l.p.ntiles};
    for (int i = 0; i < 7; ++i) rec[i] = r[i];
    return cudaSuccess;
  }
  corr_kernel<T, D><<<l.grid, l.threads, l.smem, stream>>>(l.m1, l.m2, static_cast<T*>(out), l.p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* f1, const void* f2, void* out, int b, int h, int w, int c,
                       int cs, int d, int* rec, cudaStream_t stream) {
  switch (d) {
    case 1: return run<T, 1>(f1, f2, out, b, h, w, c, cs, rec, stream);
    case 2: return run<T, 2>(f1, f2, out, b, h, w, c, cs, rec, stream);
    case 3: return run<T, 3>(f1, f2, out, b, h, w, c, cs, rec, stream);
    case 4: return run<T, 4>(f1, f2, out, b, h, w, c, cs, rec, stream);
    default: return cudaErrorInvalidValue;
  }
}

int checked(const void* f1, const void* f2, void* out, int b, int h, int w, int c, int cs,
            int d, int dtype, int* rec, void* stream) {
  const int es = dtype == NT_BF16 ? 2 : dtype == NT_F32 ? 4 : 0;
  if (es == 0 || b < 1 || h < 1 || w < 1 || c < 1 || cs < c || (long long)cs * es % 16 != 0 ||
      reinterpret_cast<uintptr_t>(f1) % 16 != 0 || reinterpret_cast<uintptr_t>(f2) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == NT_BF16)
    return (int)dispatch_d<__nv_bfloat16>(f1, f2, out, b, h, w, c, cs, d, rec, st);
  return (int)dispatch_d<float>(f1, f2, out, b, h, w, c, cs, d, rec, st);
}

}  // namespace

extern "C" int nt_correlation(const void* f1, const void* f2, void* out, int b, int h, int w,
                              int c, int cs, int d, int dtype, void* stream) {
  return checked(f1, f2, out, b, h, w, c, cs, d, dtype, nullptr, stream);
}

extern "C" int nt_correlation_launch(const void* f1, const void* f2, int b, int h, int w, int c,
                                     int cs, int d, int dtype, int* rec, void* stream) {
  return checked(f1, f2, nullptr, b, h, w, c, cs, d, dtype, rec, stream);
}
