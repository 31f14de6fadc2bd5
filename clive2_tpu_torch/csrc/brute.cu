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
// What bounds it on the H100: instruction issue.  Its bytes (45 per ray)
// and its FP32 operations (about 50 per ray and triangle, 16 triangles on
// the Cornell presets) give bounds of the same order, but built with
// --fmad=false every multiply and add is its own instruction: the exact
// test is about 72 issued instructions per triangle (57 of them the
// arithmetic, the rest the IEEE reciprocal's range check, the compares and
// the best-hit update), and the SMs issue about one per lane and cycle.
// The only way down is fewer instructions per triangle.
//
// Design: one thread per ray in a grid-stride loop, the ray's registers
// carrying the best hit.  Each block stages the table into shared memory
// once as three 16-byte rows per triangle (v0, e1, e2 with a zero each), so
// a triangle is three broadcast 16-byte loads (the first design: ten
// scalar loads of a 40-byte row), the hit test and the t < best t test are one
// chain of predicated compares with no branch, and the triangle loop is
// not unrolled (unrolled by two, as nvcc chooses, it was no faster and
// took 44 registers against 40).  The TPU kernel's 8 x
// 128 ray planes, the padding of N to 1024-ray blocks and the SMEM scalar
// table do not carry over: rays stay [N, 3] as the port holds them.
//
// An exact early-reject pre-test (end a triangle's test once u, v or t
// fails by a margin, before the division) was measured and not kept: 4.17
// ms against 3.14 on the Cornell 1080p connection cast (NVIDIA H100 80GB
// HBM3, 700 W; PERF.md, "Settled A/Bs").
//
// Rounding: the file is compiled with --fmad=false and the test is
// common.cuh's expressions in brute_plain's order, so both round
// identically.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTris = 256;       // ops/brute.py:MAX_TRIS, a 12 KB table

// Möller-Trumbore of one triangle (common.cuh:moller_trumbore's
// expressions) and the t < bt test, as one predicated chain.
__device__ __forceinline__ bool hit_before(float4 p0, float4 p1, float4 p2,
                                           float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           float bt, float& t, float& u,
                                           float& v) {
  const float hx = dy * p2.z - dz * p2.y;
  const float hy = dz * p2.x - dx * p2.z;
  const float hz = dx * p2.y - dy * p2.x;
  const float a = p1.x * hx + p1.y * hy + p1.z * hz;
  const float f = 1.0f / a;
  const float sx = ox - p0.x;
  const float sy = oy - p0.y;
  const float sz = oz - p0.z;
  u = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * p1.z - sz * p1.y;
  const float qy = sz * p1.x - sx * p1.z;
  const float qz = sx * p1.y - sy * p1.x;
  v = f * (dx * qx + dy * qy + dz * qz);
  t = f * (p2.x * qx + p2.y * qy + p2.z * qz);
  return (u >= 0.0f) & (u <= 1.0f) & (v >= 0.0f) & (u + v <= 1.0f) &
         (t > kDelta) & (t < bt);
}

__global__ void __launch_bounds__(kThreads)
brute_kernel(const float* __restrict__ origin,
             const float* __restrict__ direction,
             const uint8_t* __restrict__ active,
             const float* __restrict__ t_max, long long n_rays,
             const float* __restrict__ tris, int n_tris,
             int* __restrict__ out_i, float* __restrict__ out_t,
             float* __restrict__ out_u, float* __restrict__ out_v) {
  __shared__ float4 s_tris[kMaxTris * 3];
  for (int k = threadIdx.x; k < n_tris * 3; k += blockDim.x) {
    const float* src = tris + 10 * (k / 3) + 3 * (k % 3);
    s_tris[k] = make_float4(src[0], src[1], src[2], 0.0f);
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
#pragma unroll 1
      for (int k = 0; k < n_tris; ++k) {
        float t, u, v;
        if (hit_before(s_tris[3 * k], s_tris[3 * k + 1], s_tris[3 * k + 2],
                       ox, oy, oz, dx, dy, dz, bt, t, u, v)) {
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
