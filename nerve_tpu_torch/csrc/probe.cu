// Device-health probe kernel: o = 2 * a.
//
// Replaces scripts/tpu_probe.py `k`, the one-line Pallas kernel that the
// TPU's health probe dispatched to show that a compiled kernel runs. Here
// it shows that the library built from csrc/ loads and that a kernel of it
// launches and computes on the card (nerve_tpu_torch/diag/probe.py).
// Bound: bytes, one read and one write of n float32 values; one thread per
// value.

#include <cuda_runtime.h>

#include "nerve_tpu_torch.h"

namespace {

__global__ void scale2_kernel(const float* __restrict__ a, float* __restrict__ o, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = 2.f * a[i];
}

}  // namespace

extern "C" int nt_probe_scale2(const float* a, float* o, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  scale2_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(a, o, n);
  return (int)cudaGetLastError();
}
