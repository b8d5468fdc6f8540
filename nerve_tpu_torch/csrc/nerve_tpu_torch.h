// C interface of the nerve_tpu_torch CUDA kernels (bound with ctypes by
// nerve_tpu_torch/ops/_build.py).
//
// Every entry point launches on `stream`, never synchronises, allocates
// nothing, and returns cudaGetLastError() as an int (0 = success). Tensors
// are contiguous NHWC. `dtype` is NT_F32 or NT_BF16; weights and biases are
// always float32 (the wrapper rounds them through the activation dtype
// first where the reference does). The int8 entry points (`_i8`) take int8
// activations and weights, float32 scales and biases, and write NT_I8,
// NT_BF16 or NT_F32 (`out_dtype`); scalars they read on the device are
// passed as pointers, so a launch never waits for the device.
#pragma once

#ifdef __cplusplus
extern "C" {
#endif

enum { NT_F32 = 0, NT_BF16 = 1, NT_I8 = 2 };
// Tap schedules of the int8 dense layer (nt_conv2d_i8's `taps_mode`).
enum { NT_TAPS_DY = 0, NT_TAPS_DX = 1, NT_TAPS_INT32 = 2 };
// Flags of nt_rdb_taps_conv.
enum { NT_TAPS_ACC_DTYPE = 1, NT_TAPS_NOSHIFT = 2, NT_TAPS_MATONLY = 4 };
// Routes of nt_dwconv3.
enum { NT_DW_TMA = 0, NT_DW_TILE = 1 };

// Depth-to-space into packed rows: (B, H, W, C*s*s) -> (B, H*s, W*s*C).
int nt_d2s_packed(const void* x, void* out, int b, int h, int w, int c, int s,
                  int dtype, void* stream);

// The launch nt_d2s_packed makes for these arguments, without launching:
// rec[0..10] = grid, threads, dynamic shared bytes, static shared bytes,
// registers a thread, local (spill) bytes a thread, segments, pixels a
// segment, stages, bulk copies (1) or element loads (0), per-thread gather
// offsets fixed (1) or computed per element (0). stream unused.
int nt_d2s_packed_launch(const void* x, const void* out, int b, int h, int w,
                         int c, int s, int dtype, int* rec, void* stream);

// The same from channel-planar phases: (B, C*s*s, H, W) -> (B, H*s, W*s*C).
int nt_d2s_packed_planar(const void* x, void* out, int b, int h, int w, int c,
                         int s, int dtype, void* stream);

// Cost volume (B, H, W, C) x2 -> (B, H, W, (2d+1)^2), 1 <= d <= 4. f1 and
// f2 hold cs >= c channels a pixel (cs * element size a multiple of 16,
// both 16-byte aligned; channels [c, cs) zero); the sums are divided by c.
int nt_correlation(const void* f1, const void* f2, void* out, int b, int h,
                   int w, int c, int cs, int d, int dtype, void* stream);

// The launch nt_correlation makes for these arguments, without launching:
// rec[0..6] = grid, threads, dynamic shared bytes, static shared bytes,
// registers a thread, local (spill) bytes a thread, tiles. stream unused.
int nt_correlation_launch(const void* f1, const void* f2, int b, int h, int w,
                          int c, int cs, int d, int dtype, int* rec,
                          void* stream);

// One SAME 3x3 or 1x1 conv layer. Reads channels [0, cin) of the input,
// writes channels [out_coff, out_coff + cout) of out (channel stride
// out_cstride). The input is x0 (channel stride x_cstride) when nx = 1, or
// the channel concatenation of x0, x1, x2 (nx = 2 or 3 parts of x_cstride
// channels each, cin = nx * x_cstride), read in place. NT_F32: w is float32
// HWIO (ksize, ksize, cin, cout), contiguous; any x_cstride and alignment
// (TMA where cin and x_cstride are multiples of 4 and every part is 16-byte
// aligned, else cp.async: ops/conv_chain.py `f32_input_route`). NT_BF16:
// x_cstride a multiple of 8 (of 16 when nx > 1), every part 16-byte
// aligned, and w the bf16 image of ops/conv_chain.py `pack_conv_weights`.
int nt_conv2d(const void* x0, const void* x1, const void* x2, int nx,
              int x_cstride, int cin, const void* w, const float* bias,
              void* out, int out_cstride, int out_coff, int cout, int b,
              int h, int w_, int ksize, int relu, int dtype, void* stream);

// The launch the float32 dense layer (lff = 0) or the float32 RDB fusion
// (lff = 1: ksize 1, nx 1, cin = ccat, cout = c) makes for these arguments,
// without launching: rec[0..14] = grid, threads, dynamic shared bytes,
// static shared bytes, registers a thread, local (spill) bytes a thread,
// tiles, tile height, tile width, N tile, K chunk, ring stages, weights
// resident (1) or streamed (0), route (0 TMA, 1 cp.async), warp sets
// splitting each K chunk. stream unused.
int nt_conv2d_f32_launch(const void* x0, const void* x1, const void* x2, int nx,
                         int x_cstride, int cin, int cout, int b, int h, int w_,
                         int ksize, int lff, int* rec, void* stream);

// One SAME depthwise 3x3 layer: out[..., c] = sum over the 9 taps of
// x[y+dy-1, x+dx-1, c] * w[dy, dx, c] (w rounded to the dtype here),
// rounded to the dtype, + bias[c], relu if asked, rounded to the dtype. x
// and out (B, H, W, c), any c (wider than 64 in channel slices of at most
// 64, ops/conv_chain.py `dw_slices`); w (3, 3, c) and bias (c) float32.
// route NT_DW_TMA takes c * element size a multiple of 16 and x, out
// 16-byte aligned; NT_DW_TILE any c and alignment (ops/conv_chain.py
// `dwconv3_route`).
int nt_dwconv3(const void* x, const float* w, const float* bias, void* out,
               int c, int b, int h, int w_, int relu, int route, int dtype,
               void* stream);

// The launch nt_dwconv3 makes for these arguments, without launching:
// rec[0..10] = grid, threads, dynamic shared bytes, static shared bytes,
// registers a thread, local (spill) bytes a thread, tiles, tile height,
// tile width, channel slices, channels a slice. stream unused.
int nt_dwconv3_launch(const void* x, const void* out, int c, int b, int h,
                      int w_, int route, int dtype, int* rec, void* stream);

// A whole chain of SAME 3x3 / 1x1 / depthwise 3x3 layers on planar
// x (B, C0, H, W) -> out (B, Cout, H, W), every intermediate in shared
// memory. `layers` is a host array of 6 ints per layer (kind 0 = 3x3,
// 1 = 1x1, 2 = depthwise, 3 = a first 3x3 layer of at most 3 input
// channels with its taps folded into one product (NT_BF16 only); cin,
// cout <= 64; relu; byte offsets of the layer's weights and bias in
// `wpack`, multiples of 16); see ops/planar_chain.py `pack_planar_chain`
// for the weight layouts. nl <= 16. Rows of x and out are `ws` elements
// apart (ws >= w_; NT_BF16: a multiple of 8, x and out 16-byte aligned;
// NT_F32: ws = w_).
int nt_planar_chain(const void* x, void* out, const void* wpack,
                    const int* layers, int nl, int b, int h, int w_, int ws,
                    int dtype, void* stream);

// One SAME 3x3 dense layer under a grouped-tap rounding contract. Reads
// channels [0, cin) of x (channel stride x_cstride), writes channels
// [out_coff, out_coff + cout) of out; bias (cout) float32 at the activation
// dtype's values. NT_F32: w float32 HWIO (3, 3, cin, cout). NT_BF16: w the
// bf16 image of ops/conv_chain.py `pack_conv_weights` at the N tile of
// ops/rdb_taps.py `n_tile` (16-byte aligned), x_cstride a multiple of 8 and
// x 16-byte aligned, and the table's groups one of the kernel's families
// (`pallas_dy`, `pallas_dx`, `f32_taps`, `s2d`). `table` is a host array of
// 20 ints: for output-row parity p (the row's index in the image mod 2),
// table[9p .. 9p+8] the taps t = 3*dy + dx in walk order and table[18 + p]
// a bit mask, bit i set where a group ends after the i-th tap. Each group's
// products are summed in float32, plus bias if it holds tap 4, rounded to
// the dtype and added in float32 (rounded to the dtype after each add with
// NT_TAPS_ACC_DTYPE); then relu, rounded to the dtype. NT_TAPS_NOSHIFT
// writes relu of tap 4's group alone; NT_TAPS_MATONLY computes the products
// and writes one value per warp (timing only).
int nt_rdb_taps_conv(const void* x, int x_cstride, int cin, const void* w,
                     const float* bias, void* out, int out_cstride,
                     int out_coff, int cout, int b, int h, int w_,
                     const int* table, int flags, int dtype, void* stream);

// The launch nt_rdb_taps_conv makes in bf16 for these arguments, without
// launching: rec[0..10] = grid, threads, dynamic shared bytes, static
// shared bytes, registers a thread, local (spill) bytes a thread, tiles, N
// tile, stages a ring, weights resident (1) or streamed (0), accumulator
// sets. stream unused.
int nt_rdb_taps_launch(const void* x, int x_cstride, int cin, int cout, int b,
                       int h, int w_, const int* table, int* rec, void* stream);

// o = 2 * a over n float32 values (the device-health probe).
int nt_probe_scale2(const float* a, float* o, int n, void* stream);

// RDB local feature fusion:
//   out[p, n] = (sum_k cat[p, k] w[k, n] + bias[n]) * res_scale + cat[p, n]
// in float32, rounded once to the dtype, for channels [0, ccat) of cat
// (channel stride cat_cstride) into channels [out_coff, out_coff + c) of
// out (channel stride out_cstride, not cat's storage). NT_F32: w float32
// (ccat, c). NT_BF16: cat_cstride a multiple of 8, cat 16-byte aligned, and
// w the bf16 image of ops/conv_chain.py `pack_conv_weights` of the
// (1, 1, ccat, c) matrix at the fusion's N tile (ops/rdb.py `LFF_N_TILE`).
int nt_rdb_lff(const void* cat, int cat_cstride, int ccat, const void* w,
               const float* bias, void* out, int out_cstride, int out_coff,
               int c, int b, int h, int w_, float res_scale, int dtype,
               void* stream);

// One SAME 3x3 or 1x1 int8 conv layer (static post-training quantisation).
// Reads int8 channels [0, cin) of x (channel stride x_cstride, a multiple of
// 16; x 16-byte aligned). w is the int8 image of ops/conv_chain_int8.py
// `pack_i8_weights` (16-byte aligned). taps_mode NT_TAPS_DY: for each tap
// t = 3*dy + dx, in order (dy outer, dx inner), the int32 sum over the
// input channels times dq[t*cout + n] is rounded to bfloat16 and added in
// float32; NT_TAPS_DX: the same with dx outer; NT_TAPS_INT32: the taps'
// int32 sums are added in int32 and the total times dq[n] (cout factors)
// is the float32 sum (NT_TAPS_DX and NT_TAPS_INT32 take ksize 3 only).
// Then bias[n], relu if asked. out_dtype NT_I8 writes
// clip(rint(v * inv[n]), -127, 127) into int8 channels
// [out_coff, out_coff + cout) of out (channel stride out_cstride); NT_BF16
// and NT_F32 write v rounded to that type.
int nt_conv2d_i8(const void* x, int x_cstride, int cin, const void* w,
                 const float* dq, const float* bias, const float* inv,
                 void* out, int out_cstride, int out_coff, int cout, int b,
                 int h, int w_, int ksize, int relu, int out_dtype,
                 int taps_mode, void* stream);

// Input quantisation of the int8 paths: the channel concatenation of x0, x1,
// x2 (nx = 1..3 parts of c0, c1, c2 channels, each (B, H, W, c_i) of one
// dtype, NT_F32 or NT_BF16) becomes clip(rint(x / scale[0]), -127, 127)
// (an IEEE division, rounded half to even) in int8 channels
// [0, c0 + c1 + c2) of out (channel stride out_cstride); channels up to
// out_c are written as zeros.
int nt_quantize_i8(const void* x0, const void* x1, const void* x2, int nx,
                   int c0, int c1, int c2, const float* scale, void* out,
                   int out_cstride, int out_c, int b, int h, int w_, int dtype,
                   void* stream);

// int8 RDB local feature fusion and residual. cat is int8 (B, H, W, .) with
// channel stride cat_cstride (a multiple of 16), of which channels
// [0, ccat) are read; lw is the int8 image of ops/conv_chain_int8.py
// `pack_i8_weights` of the fusion's (ccat, c) matrix at the int8 fusion's N
// tile (ops/rdb_int8.py `LFF_N_TILE`); cat and lw 16-byte aligned.
//   v = (lff * ldq[n] + lbias[n]) * 0.2 + cat[p, n] * s_in[0],
//   lff = sum_k cat[p, k] * lw[k, n] (int32).
// out_dtype NT_I8 writes clip(rint(v / s_next[0]), -127, 127) (an IEEE
// division) into int8 channels [out_coff, out_coff + c) of out (channel
// stride out_cstride, not cat's storage); NT_BF16 and NT_F32 write v
// rounded to that type (s_next unused).
int nt_rdb_lff_i8(const void* cat, int cat_cstride, int ccat, const void* lw,
                  const float* ldq, const float* lbias, const float* s_in,
                  const float* s_next, void* out, int out_cstride,
                  int out_coff, int c, int b, int h, int w_, int out_dtype,
                  void* stream);

const char* nt_error_string(int err);

#ifdef __cplusplus
}
#endif

#ifdef __CUDACC__
#include <cuda_bf16.h>
#include <stdint.h>

// Tensor-core building blocks (sm_80+): ldmatrix of four 8x8 b16 matrices
// (8 rows of 16 bytes each) from shared memory and one bf16 m16n8k16 product
// accumulated in float32 (planar_chain.cu).
__device__ __forceinline__ unsigned nt_smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void nt_ldmatrix_x4(const void* p, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(nt_smem_addr(p)));
}
__device__ __forceinline__ void nt_mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                            unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Hopper (sm_90a) building blocks: mbarriers, TMA and bulk copies into
// shared memory that complete on an mbarrier, and warpgroup products.
__device__ __forceinline__ void nt_mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(nt_smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void nt_fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void nt_mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(nt_smem_addr(bar)) : "memory");
}
// Arrive and expect `bytes` more to land on the barrier from async copies.
__device__ __forceinline__ void nt_mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   nt_smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool nt_mbar_try_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(nt_smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
// Wait until the barrier's phase of parity `parity` has completed. A wait
// that outlasts 10 s traps, so that a copy that never lands fails the
// launch instead of holding the card.
__device__ __forceinline__ void nt_mbar_wait(uint64_t* bar, unsigned parity) {
  if (nt_mbar_try_wait(bar, parity)) return;
  uint64_t t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t0));
  while (!nt_mbar_try_wait(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    if (t - t0 > 10000000000ull) __trap();
  }
}
// TMA: the box of a 4-D tensor map at coordinates (c0 innermost .. c3) into
// shared memory; coordinates outside the tensor read as zeros.
__device__ __forceinline__ void nt_tma_load_4d(void* dst, const void* map, uint64_t* bar,
                                               int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(nt_smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(nt_smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
// TMA store: the box at shared-memory `src` into a 4-D tensor map at
// coordinates (c0 innermost .. c3); what falls outside the tensor is not
// written. Commit with nt_bulk_commit; the writes that fill `src` must be
// made visible to the copy first (nt_fence_proxy_async, then a barrier).
__device__ __forceinline__ void nt_tma_store_4d(const void* map, const void* src, int c0, int c1,
                                                int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(nt_smem_addr(src)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
__device__ __forceinline__ void nt_fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void nt_bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until at most N committed bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void nt_bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Wait until at most N committed bulk groups are still incomplete.
template <int N>
__device__ __forceinline__ void nt_bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// Bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned).
__device__ __forceinline__ void nt_bulk_load(void* dst, const void* src, unsigned bytes,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(nt_smem_addr(dst)), "l"(src), "r"(bytes), "r"(nt_smem_addr(bar))
      : "memory");
}
// A wgmma shared-memory operand without swizzle: K-major core matrices of
// 8 rows x 16 bytes; `lbo` the byte step between the two core matrices of
// a k16 slice, `sbo` between 8-row groups.
__device__ __forceinline__ uint64_t nt_wgmma_desc(unsigned smem_addr, unsigned lbo,
                                                  unsigned sbo) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}
// A K-major operand as TMA's 32-byte swizzle lays it out: rows of 32 bytes
// (16 bf16 of K), 8-row groups 256 bytes apart. The start may sit on any
// row: the product applies the swizzle to the absolute shared-memory
// address, as TMA does, so the base offset stays 0 (on an H100, a base
// offset of (addr >> 7) & 7 gives wrong sums for starts off a 256-byte
// boundary).
__device__ __forceinline__ uint64_t nt_wgmma_desc_sw32(unsigned smem_addr) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(256 >> 4) << 32) | ((uint64_t)3 << 62);
}
__device__ __forceinline__ void nt_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void nt_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of products are still running.
template <int N>
__device__ __forceinline__ void nt_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void nt_setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void nt_setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// D (64 x N, float32, in registers) += A (64 x 16) * B (16 x N), bf16, both
// from shared memory (descriptors da, db); scale_d = 0 overwrites D. Thread
// t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 + 8i and columns
// 8j + 2 (t % 4) + {0, 1} in d[4j + 2i + {0, 1}].
__device__ __forceinline__ void nt_wgmma_m64n8k16(float (&d)[4], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void nt_wgmma_m64n16k16(float (&d)[8], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void nt_wgmma_m64n32k16(float (&d)[16], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void nt_wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void nt_wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void nt_wgmma(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 8) nt_wgmma_m64n8k16(d, da, db, scale_d);
  if constexpr (N == 16) nt_wgmma_m64n16k16(d, da, db, scale_d);
  if constexpr (N == 32) nt_wgmma_m64n32k16(d, da, db, scale_d);
  if constexpr (N == 64) nt_wgmma_m64n64k16(d, da, db, scale_d);
  if constexpr (N == 128) nt_wgmma_m64n128k16(d, da, db, scale_d);
}

// D (64 x N, int32, in registers) += A (64 x 32) * B (32 x N), s8 x s8, both
// from shared memory, both K-major; scale_d = 0 overwrites D. The fragment
// layout of D is that of the float32 products above.
__device__ __forceinline__ void nt_wgmma_m64n8k32_s8(int (&d)[4], uint64_t da, uint64_t db,
                                                     int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void nt_wgmma_m64n16k32_s8(int (&d)[8], uint64_t da, uint64_t db,
                                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void nt_wgmma_m64n32k32_s8(int (&d)[16], uint64_t da, uint64_t db,
                                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void nt_wgmma_s8(int (&d)[N / 2], uint64_t da, uint64_t db,
                                            int scale_d) {
  if constexpr (N == 8) nt_wgmma_m64n8k32_s8(d, da, db, scale_d);
  if constexpr (N == 16) nt_wgmma_m64n16k32_s8(d, da, db, scale_d);
  if constexpr (N == 32) nt_wgmma_m64n32k32_s8(d, da, db, scale_d);
}

// Host side of the TMA kernels (conv_chain.cu, conv_int8.cu).
#include <cuda.h>

// cuTensorMapEncodeTiled, looked up at run time through the runtime's
// entry-point query, so that the library needs no link against libcuda.
using NtEncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline NtEncodeTiled nt_encode_tiled() {
  static const NtEncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<NtEncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// The RDB fusions on the dense layers' warpgroup kernels: conv_chain.cu's
// and conv_int8.cu's 1x1 layer with the fusion's epilogue, launched by
// nt_rdb_lff (rdb.cu) and nt_rdb_lff_i8 (rdb_int8.cu) after their checks.
constexpr int NT_LFF_N_TILE = 64;     // output channels of a bf16 fusion tile
constexpr int NT_LFF_I8_N_TILE = 32;  // output channels of an int8 fusion tile
cudaError_t nt_lff_bf16_wgmma(const void* cat, int xcs, int ccat, const void* w,
                              const float* bias, void* out, int ocs, int ocoff, int c, int b,
                              int h, int wd, float res_scale, cudaStream_t stream);
// The float32 dense layer and RDB fusion (conv_f32.cuh's family; conv_f32.cu
// and rdb.cu), launched by nt_conv2d and nt_rdb_lff after their checks;
// with rec non-null they fill rec as nt_conv2d_f32_launch says, launching
// nothing.
cudaError_t nt_conv2d_f32(const void* const* xs, int nx, int xcs, int cin, const float* w,
                          const float* bias, void* out, int ocs, int ocoff, int cout, int b, int h,
                          int wd, int k, int relu, cudaStream_t stream, int* rec);
cudaError_t nt_lff_f32(const void* cat, int xcs, int ccat, const float* w, const float* bias,
                       void* out, int ocs, int ocoff, int c, int b, int h, int wd,
                       float res_scale, cudaStream_t stream, int* rec);
cudaError_t nt_lff_i8_wgmma(const void* cat, int xcs, int ccat, const void* w, const float* ldq,
                            const float* lbias, const float* s_in, const float* s_next,
                            void* out, int ocs, int ocoff, int c, int b, int h, int wd, int odt,
                            cudaStream_t stream);

struct NtDeviceLimits {
  int sms, smem;  // SMs; shared memory a block may opt in to
};

inline cudaError_t nt_device_limits(NtDeviceLimits& lim) {
  static NtDeviceLimits cache[64] = {};
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (cache[dev].sms == 0) {
    NtDeviceLimits d;
    err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&d.smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    cache[dev] = d;
  }
  lim = cache[dev];
  return cudaSuccess;
}
#endif
