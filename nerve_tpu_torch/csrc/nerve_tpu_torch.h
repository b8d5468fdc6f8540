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

// Depth-to-space into packed rows: (B, H, W, C*s*s) -> (B, H*s, W*s*C).
int nt_d2s_packed(const void* x, void* out, int b, int h, int w, int c, int s,
                  int dtype, void* stream);

// The same from channel-planar phases: (B, C*s*s, H, W) -> (B, H*s, W*s*C).
int nt_d2s_packed_planar(const void* x, void* out, int b, int h, int w, int c,
                         int s, int dtype, void* stream);

// Cost volume (B, H, W, C) x2 -> (B, H, W, (2d+1)^2), 1 <= d <= 4.
int nt_correlation(const void* f1, const void* f2, void* out, int b, int h,
                   int w, int c, int d, int dtype, void* stream);

// One SAME 3x3 or 1x1 conv layer. Reads channels [0, cin) of x (channel
// stride x_cstride), writes channels [out_coff, out_coff + cout) of out
// (channel stride out_cstride). w is HWIO (ksize, ksize, cin, cout).
int nt_conv2d(const void* x, int x_cstride, int cin, const float* w,
              const float* bias, void* out, int out_cstride, int out_coff,
              int cout, int b, int h, int w_, int ksize, int relu, int dtype,
              void* stream);

// One SAME depthwise 3x3 layer: out[..., c] = sum over the 9 taps of
// x[y+dy-1, x+dx-1, c] * w[dy, dx, c], rounded to the dtype, + bias[c],
// relu if asked, rounded to the dtype. x and out (B, H, W, c), c <= 64;
// w (3, 3, c).
int nt_dwconv3(const void* x, const float* w, const float* bias, void* out,
               int c, int b, int h, int w_, int relu, int dtype, void* stream);

// A whole chain of SAME 3x3 / 1x1 / depthwise 3x3 layers on planar
// x (B, C0, H, W) -> out (B, Cout, H, W), every intermediate in shared
// memory. `layers` is a host array of 6 ints per layer (kind 0 = 3x3,
// 1 = 1x1, 2 = depthwise; cin, cout <= 64; relu; byte offsets of the
// layer's weights and bias in `wpack`, multiples of 16); see
// ops/planar_chain.py `pack_planar_chain` for the weight layouts. nl <= 16.
int nt_planar_chain(const void* x, void* out, const void* wpack,
                    const int* layers, int nl, int b, int h, int w_,
                    int dtype, void* stream);

// One SAME 3x3 dense layer under a grouped-tap rounding contract. Reads
// channels [0, cin) of x (channel stride x_cstride), writes channels
// [out_coff, out_coff + cout) of out; w is HWIO (3, 3, cin, cout), bias
// (cout), both at the activation dtype's values. `table` is a host array of
// 20 ints: for output-row parity p (the row's index in the image mod 2),
// table[9p .. 9p+8] the taps t = 3*dy + dx in walk order and table[18 + p]
// a bit mask, bit i set where a group ends after the i-th tap. Each group's
// products are summed in float32, plus bias if it holds tap 4, rounded to
// the dtype and added in float32 (rounded to the dtype after each add with
// NT_TAPS_ACC_DTYPE); then relu, rounded to the dtype. NT_TAPS_NOSHIFT
// writes relu of tap 4's group alone; NT_TAPS_MATONLY computes the products
// and writes one value per warp (timing only).
int nt_rdb_taps_conv(const void* x, int x_cstride, int cin, const float* w,
                     const float* bias, void* out, int out_cstride,
                     int out_coff, int cout, int b, int h, int w_,
                     const int* table, int flags, int dtype, void* stream);

// o = 2 * a over n float32 values (the device-health probe).
int nt_probe_scale2(const float* a, float* o, int n, void* stream);

// RDB local feature fusion: out = (cat . w + bias) * res_scale + cat[..., :c]
// with cat (B, H, W, ccat), w (ccat, c), out (B, H, W, c).
int nt_rdb_lff(const void* cat, int ccat, const float* w, const float* bias,
               void* out, int c, int b, int h, int w_, float res_scale,
               int dtype, void* stream);

// One SAME 3x3 or 1x1 int8 conv layer (static post-training quantisation).
// Reads int8 channels [0, cin) of x (channel stride x_cstride, a multiple of
// 16; x 16-byte aligned). w is int8 (ksize*ksize, cout, ceil16(cin)), zero
// beyond cin. taps_mode NT_TAPS_DY: for each tap t = 3*dy + dx, in order
// (dy outer, dx inner), the int32 sum over the input channels times
// dq[t*cout + n] is rounded to bfloat16 and added in float32; NT_TAPS_DX:
// the same with dx outer; NT_TAPS_INT32: the taps' int32 sums are added in
// int32 and the total times dq[n] (cout factors) is the float32 sum
// (NT_TAPS_DX and NT_TAPS_INT32 take ksize 3 only). Then
// bias[n], relu if asked. out_dtype NT_I8 writes
// clip(rint(v * inv[n]), -127, 127) into int8 channels
// [out_coff, out_coff + cout) of out (channel stride out_cstride); NT_BF16
// and NT_F32 write v rounded to that type.
int nt_conv2d_i8(const void* x, int x_cstride, int cin, const void* w,
                 const float* dq, const float* bias, const float* inv,
                 void* out, int out_cstride, int out_coff, int cout, int b,
                 int h, int w_, int ksize, int relu, int out_dtype,
                 int taps_mode, void* stream);

// int8 RDB local feature fusion and residual. cat is int8 (B, H, W, .) with
// channel stride cat_cstride (a multiple of 16), of which channels
// [0, ccat) are read; lw is int8 (c, ceil16(ccat)), zero beyond ccat.
//   v = (lff * ldq[n] + lbias[n]) * 0.2 + cat[p, n] * s_in[0],
//   lff = sum_k cat[p, k] * lw[n, k] (int32).
// out_dtype NT_I8 writes clip(rint(v / s_next[0]), -127, 127) into int8
// channels [0, c) of out (channel stride out_cstride); NT_BF16 and NT_F32
// write v rounded to that type (s_next unused).
int nt_rdb_lff_i8(const void* cat, int cat_cstride, int ccat, const void* lw,
                  const float* ldq, const float* lbias, const float* s_in,
                  const float* s_next, void* out, int out_cstride, int c,
                  int b, int h, int w_, int out_dtype, void* stream);

const char* nt_error_string(int err);

#ifdef __cplusplus
}
#endif

#ifdef __CUDACC__
#include <cuda_bf16.h>

// Tensor-core building blocks (sm_80+): ldmatrix of four 8x8 b16 matrices
// (8 rows of 16 bytes each) from shared memory, one bf16 m16n8k16 product
// accumulated in float32, and one int8 m16n8k32 product accumulated in int32.
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
__device__ __forceinline__ void nt_mma_s8(int (&d)[4], const unsigned (&a)[4],
                                          unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
#endif
