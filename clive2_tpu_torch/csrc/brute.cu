// Dense brute-force ray/triangle intersection for small scenes.
//
// Replaces the TPU kernel clive2_tpu/ops/brute_pallas.py:_kernel (entry
// intersect_brute_pallas, packer pack_brute).  The plain PyTorch version is
// clive2_tpu_torch/ops/brute.py:brute_plain.
//
// Contract: every ray against every triangle of a [T, 10] f32 table
// (v0, e1, e2, pad), in ascending triangle order; a triangle replaces the
// best hit only when strictly closer, and the best t starts at the ray's
// t_max.  Misses (and inactive rays) report i = -1 and t = inf.
//
// What bounds it on the H100: FP32 throughput.  A ray/triangle test is about
// 30 flops and the table is at most 256 triangles, so the kernel reads 29
// bytes of ray state and writes 16 bytes per ray against T * 30 flops: at
// the Cornell connection cast (36 * N rays, about 20 triangles) that is
// compute, not memory.
//
// Design: one thread per ray, so the ray's registers carry the best hit and
// there is no cross-lane reduction.  Each block stages the table into shared
// memory once and then walks a grid-stride loop over rays; every thread of a
// warp reads the same triangle word, which shared memory broadcasts.  The TPU
// kernel's 8 x 128 ray planes, the padding of N to 1024-ray blocks and the
// SMEM scalar table do not carry over: rays stay [N, 3] as the port holds
// them.
//
// Rounding: the expressions are written in the plain version's order and the
// file is compiled with --fmad=false, so both round identically.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTris = 256;       // ops/brute.py:MAX_TRIS, a 10 KB table

__global__ void brute_kernel(const float* __restrict__ origin,
                             const float* __restrict__ direction,
                             const uint8_t* __restrict__ active,
                             const float* __restrict__ t_max,
                             long long n_rays,
                             const float* __restrict__ tris, int n_tris,
                             int* __restrict__ out_i,
                             float* __restrict__ out_t,
                             float* __restrict__ out_u,
                             float* __restrict__ out_v) {
  __shared__ float s_tris[kMaxTris * 10];
  for (int k = threadIdx.x; k < n_tris * 10; k += blockDim.x) {
    s_tris[k] = tris[k];
  }
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < n_rays; r += stride) {
    float bt = t_max[r];
    int bi = -1;
    float bu = 0.0f, bv = 0.0f;
    if (active[r]) {
      const float ox = origin[3 * r + 0];
      const float oy = origin[3 * r + 1];
      const float oz = origin[3 * r + 2];
      const float dx = direction[3 * r + 0];
      const float dy = direction[3 * r + 1];
      const float dz = direction[3 * r + 2];
      for (int k = 0; k < n_tris; ++k) {
        float t, u, v;
        if (moller_trumbore(s_tris + 10 * k, ox, oy, oz, dx, dy, dz, t, u,
                            v) &&
            t < bt) {
          bt = t;
          bi = k;
          bu = u;
          bv = v;
        }
      }
    }
    out_i[r] = bi;
    out_t[r] = bi >= 0 ? bt : INFINITY;
    out_u[r] = bu;
    out_v[r] = bv;
  }
}

}  // namespace

extern "C" int clive2_brute(const float* origin, const float* direction,
                            const uint8_t* active, const float* t_max,
                            long long n_rays, const float* tris, int n_tris,
                            int* out_i, float* out_t, float* out_u,
                            float* out_v, void* stream) {
  if (n_tris > kMaxTris || n_tris < 0) return (int)cudaErrorInvalidValue;
  long long blocks = (n_rays + kThreads - 1) / kThreads;
  // enough resident blocks to fill 132 SMs; the grid-stride loop does the
  // rest, so each block stages the table once for many rays
  if (blocks > 132 * 16) blocks = 132 * 16;
  brute_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, active, t_max, n_rays, tris, n_tris, out_i, out_t,
      out_u, out_v);
  return (int)cudaGetLastError();
}

extern "C" const char* clive2_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
