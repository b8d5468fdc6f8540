// The float32 dense convolution's 1x1 instances (conv_f32.cuh; the 3x3
// ones and the entry point are in conv_f32.cu).

#include <cuda.h>
#include <cuda_runtime.h>

#include "conv_f32.cuh"
#include "nerve_tpu_torch.h"

cudaError_t nt_conv2d_f32_1x1(const ntf32::F32Plan& pl, const ntf32::F32Params& p,
                              const CUtensorMap (&maps)[4], int route,
                              const NtDeviceLimits& lim, cudaStream_t stream, int* rec) {
  return ntf32::f32_dense_launch<1>(pl, p, maps, route, lim, stream, rec);
}
