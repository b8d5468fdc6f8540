// Device-health probe kernel: o = 2 * a.
//
// Replaces scripts/tpu_probe.py `k`, the one-line Pallas kernel that the
// TPU's health probe dispatched to show that a compiled kernel runs. Here
// it shows that the library built from csrc/ loads and that a kernel of it
// launches and computes on the card (nerve_tpu_torch/diag/probe.py).
// Bound: bytes, one read and one write of n float32 values; at the probe's
// (8, 128) that is nanoseconds, so its time is the host's launch path
// (ops/_build.py `launch`) and the launch latency. One block: each thread
// loads and stores 16 bytes at a time when both pointers are 16-byte
// aligned (checked here, before the launch), then a scalar tail; a
// misaligned view takes the scalar loop throughout.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nerve_tpu_torch.h"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    scale2_kernel(const float* __restrict__ a, float* __restrict__ o, int n, int vec) {
  int i = threadIdx.x;
  if (vec) {
    const int n4 = n / 4;
    for (; i < n4; i += THREADS) {
      const float4 v = reinterpret_cast<const float4*>(a)[i];
      reinterpret_cast<float4*>(o)[i] = make_float4(2.f * v.x, 2.f * v.y, 2.f * v.z, 2.f * v.w);
    }
    i = 4 * n4 + threadIdx.x;
  }
  for (; i < n; i += THREADS) o[i] = 2.f * a[i];
}

}  // namespace

extern "C" int nt_probe_scale2(const float* a, float* o, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int vec = ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(o)) % 16) == 0;
  scale2_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a, o, n, vec);
  return (int)cudaGetLastError();
}
