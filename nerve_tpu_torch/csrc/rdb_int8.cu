// int8 residual dense block: the 1x1 local feature fusion, the 0.2-scaled
// residual and the requantisation to the next block's input scale.
//
// Together with the int8 convolution of conv_int8.cu this replaces
// nerve_tpu/ops/rdb_int8.py `_rdb_int8_kernel` (reached via
// `_rdb_int8_pallas` <- `rdb_chain_int8_pallas` <- `rdb_chain_int8_apply`).
// The TPU kernel kept the block's int8 concatenation in VMEM. Here the
// wrapper (ops/rdb_int8.py) keeps two int8 (B, H, W, C + L*G) buffers: the
// block's int8 input sits in channels [0, C) of one, each dense layer is
// `nt_conv2d_i8` writing its requantised G channels into its slot, and the
// fusion then computes, per pixel p and output channel n,
//
//   lff = sum_k cat[p, k] * lw[k, n]                         (int32)
//   v   = (lff * ldq[n] + lbias[n]) * 0.2 + cat[p, n] * s_in
//
// as `rdb_chain_int8_xla` does (rdb_int8.py:563-575): the residual is the
// dequantised int8 block input, not the original activation. v is then
// requantised by true division by the next block's input scale
// (`clip(rint(v / s_next), +-127)`, rdb_int8.py:576-577; a reciprocal
// multiply would round values next to .5 steps otherwise) into channels
// [0, C) of the other buffer, or, after the last block, rounded once to the
// model's dtype. Each float operation is an explicit round-to-nearest
// intrinsic, so none is contracted into an FMA.
//
// Bound: bytes. The fusion is 2 * 224 * 64 int8 operations per pixel
// (0.06 T per 1080p block) but reads the 224-byte concatenation and writes
// 64 bytes a pixel: 0.60 GB per block at 1080p, 0.178 ms at 3.35 TB/s,
// against ~0.03 ms of int8 tensor-core work.
//
// The kernel is `lff_i8_wgmma_kernel` (conv_int8.cu): the int8 dense
// layers' warpgroup kernel as a 1x1 layer (wgmma.m64n32k32.s32.s8.s8, one
// int32 accumulator set, 4 x 64-pixel tiles) with the fusion's epilogue.
// TMA streams the concatenation in 32-channel boxes (zero fill past ccat
// and the frame's edges) through a ring per consumer warpgroup. The N tile
// is 32: the model's 64 channels are two N tiles, adjacent in the tile walk
// so that the second read of a pixel tile meets the first in L2, each stage
// carrying its chunk's weights (packed once per int8 state into the B
// descriptor's image, ops/rdb_int8.py `packed_block`). A 64-wide N tile
// (wgmma m64n64k32, each row read once, weights resident) measured slower
// at 1080p on an H100 (0.87 against 0.70 ms a launch), with or without its
// epilogue; ring depth, L2 promotion and the box's element type did not
// move it, so the cause is open. The dequantisation factors and biases sit
// in shared memory, s_in and s_next in registers. The epilogue reads the
// residual's int8 pairs from device memory (L2-hot behind this tile's TMA
// loads), computes and converts a whole row before any store, and stores
// channel pairs into the output's slot.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nerve_tpu_torch.h"

extern "C" int nt_rdb_lff_i8(const void* cat, int cat_cstride, int ccat, const void* lw,
                             const float* ldq, const float* lbias, const float* s_in,
                             const float* s_next, void* out, int out_cstride, int out_coff,
                             int c, int b, int h, int w_, int out_dtype, void* stream) {
  if (cat_cstride % 16 != 0 || reinterpret_cast<uintptr_t>(cat) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(lw) % 16 != 0 || c < 1 || ccat < c || ccat > cat_cstride ||
      out_coff < 0 || out_coff + c > out_cstride ||
      (out_dtype != NT_I8 && out_dtype != NT_BF16 && out_dtype != NT_F32))
    return (int)cudaErrorInvalidValue;
  return (int)nt_lff_i8_wgmma(cat, cat_cstride, ccat, lw, ldq, lbias, s_in, s_next, out,
                              out_cstride, out_coff, c, b, h, w_, out_dtype,
                              static_cast<cudaStream_t>(stream));
}
