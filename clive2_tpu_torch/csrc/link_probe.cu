// The link probe's kernel: o = a * 2 + 1 over an f32 array.
//
// Replaces the TPU kernel scripts/link_probe.py:probe.k (:84, pallas_call
// :88), which scales an f32 [256, 128] array so that the probe times a
// kernel's first run (there: the Mosaic compile and the binary's upload;
// here: the load of this library, and its nvcc build when the sources'
// hash misses) and its steady run.  The plain PyTorch version is
// clive2_tpu_torch/ops/link_probe.py:scale_shift_plain.
//
// What bounds it on the H100: at the probe's 128 KB, the launch (a few
// microseconds), not its 256 KB of traffic (0.08 us at 3.35 TB/s).  The
// design is the plain one: one thread per element, a grid over the array.
// With --fmad=false the multiply and the add round apart, as the plain
// version does (a * 2 is exact, so a fused one would round alike).

#include <cuda_runtime.h>

namespace {

__global__ void link_probe_kernel(const float* __restrict__ a,
                                  float* __restrict__ o, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = a[i] * 2.0f + 1.0f;
}

}  // namespace

extern "C" int clive2_link_probe(const float* a, float* o, long long n,
                                 void* stream) {
  constexpr int kThreads = 256;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0)
    link_probe_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(a, o, n);
  return (int)cudaGetLastError();
}
