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
// microseconds), not its 256 KB of traffic (0.08 us at 3.35 TB/s).  So the
// design cuts what a launch costs: each thread moves 16 bytes (one float4
// load and store; a scalar tail past the last whole float4, or every
// element when a or o is not 16-byte aligned), so the probe's 32,768
// floats take one wave of 32 blocks; and the launch is a programmatic
// dependent one (common.cuh:launch_dependent), so in a run of calls each
// launch overlaps the previous kernel's drain: the kernel waits for it
// (grid_dependency_wait) before its first global read and lets the next
// one be scheduled (allow_dependents) once its loads are issued.
// With --fmad=false the multiply and the add round apart, as the plain
// version does (a * 2 is exact, so a fused one would round alike).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Thread i < vectors moves float4 i; thread vectors + j moves element
// 4 vectors + j of the tail.
__global__ void __launch_bounds__(kThreads)
    link_probe_kernel(const float* __restrict__ a, float* __restrict__ o,
                      long long n, long long vectors) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long j = 4 * vectors + (i - vectors);
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  grid_dependency_wait();
  if (i < vectors)
    v = reinterpret_cast<const float4*>(a)[i];
  else if (j < n)
    v.x = a[j];
  allow_dependents();
  if (i < vectors)
    reinterpret_cast<float4*>(o)[i] =
        make_float4(v.x * 2.0f + 1.0f, v.y * 2.0f + 1.0f, v.z * 2.0f + 1.0f,
                    v.w * 2.0f + 1.0f);
  else if (j < n)
    o[j] = v.x * 2.0f + 1.0f;
}

}  // namespace

extern "C" int clive2_link_probe(const float* a, float* o, long long n,
                                 void* stream) {
  const long long vectors =
      ((uintptr_t)a | (uintptr_t)o) % 16 ? 0 : n / 4;
  const long long blocks =
      (vectors + (n - 4 * vectors) + kThreads - 1) / kThreads;
  if (blocks <= 0) return (int)cudaSuccess;
  return (int)launch_dependent(link_probe_kernel, (unsigned)blocks, kThreads,
                               0, stream, a, o, n, vectors);
}
