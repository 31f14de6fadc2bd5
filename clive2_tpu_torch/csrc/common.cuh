// Device helpers shared by the intersection kernels of this directory.
//
// Every kernel is compiled with --fmad=false, so these expressions round
// exactly as the plain PyTorch versions that mirror them
// (clive2_tpu_torch/ops/intersect.py: safe_inverse, box_entry, _mt).

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kDelta = 1e-4f;     // self-hit epsilon (constants.DELTA)

// 1 / d with |d| raised to at least 1e-30, keeping its sign.
__device__ __forceinline__ float safe_inverse(float d) {
  const float tiny = 1e-30f;
  const float x = fabsf(d) < tiny ? (d < 0.0f ? -tiny : tiny) : d;
  return 1.0f / x;
}

// The bound past which a box or a stack entry is culled, for a best t bt:
// bt * (1 + 2^-16), not bt.  A box that holds a hit at exactly bt can round
// its slab entry an ulp past that hit's Moller-Trumbore t (a hit on an edge
// shared with the box's face); culled at bt, it would be tested or not
// depending on whether the hit was found before it was reached, so the
// (t, slot) rule's tie (or an ulp-closer hit) would depend on the visit
// order, and under persistent warps on the schedule.  Past the bound every
// walk culls it alike (ops/intersect.py:cull_bound).
__device__ __forceinline__ float cull_bound(float bt) {
  return bt * 1.0000152587890625f;
}

// Slab test of one AABB given by its corners; returns the entry distance, or
// +inf when the box is missed or lies beyond cull_bound(bt).
__device__ __forceinline__ float box_entry(float lox, float loy, float loz,
                                           float hix, float hiy, float hiz,
                                           float ox, float oy, float oz,
                                           float ix, float iy, float iz,
                                           float bt) {
  const float t0x = (lox - ox) * ix;
  const float t1x = (hix - ox) * ix;
  const float t0y = (loy - oy) * iy;
  const float t1y = (hiy - oy) * iy;
  const float t0z = (loz - oz) * iz;
  const float t1z = (hiz - oz) * iz;
  const float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fmaxf(fminf(t0z, t1z), 0.0f));
  const float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                           fminf(fmaxf(t0z, t1z), cull_bound(bt)));
  return tmin <= tmax ? tmin : INFINITY;
}

// The same test of a box row b: min(3) max(3).
__device__ __forceinline__ float box_entry(const float* __restrict__ b,
                                           float ox, float oy, float oz,
                                           float ix, float iy, float iz,
                                           float bt) {
  return box_entry(b[0], b[1], b[2], b[3], b[4], b[5], ox, oy, oz, ix, iy,
                   iz, bt);
}

// Möller-Trumbore of one triangle given by v0, e1, e2: sets t, u, v and
// returns whether the ray hits it (inside the triangle, t past kDelta).
__device__ __forceinline__ bool moller_trumbore(
    float v0x, float v0y, float v0z, float e1x, float e1y, float e1z,
    float e2x, float e2y, float e2z, float ox, float oy, float oz, float dx,
    float dy, float dz, float& t, float& u, float& v) {
  const float hx = dy * e2z - dz * e2y;
  const float hy = dz * e2x - dx * e2z;
  const float hz = dx * e2y - dy * e2x;
  const float a = e1x * hx + e1y * hy + e1z * hz;
  const float f = 1.0f / a;
  const float sx = ox - v0x;
  const float sy = oy - v0y;
  const float sz = oz - v0z;
  u = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  v = f * (dx * qx + dy * qy + dz * qz);
  t = f * (e2x * qx + e2y * qy + e2z * qz);
  return u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t > kDelta;
}

// The same test of a triangle row tr = v0(3) e1(3) e2(3).
__device__ __forceinline__ bool moller_trumbore(const float* __restrict__ tr,
                                                float ox, float oy, float oz,
                                                float dx, float dy, float dz,
                                                float& t, float& u, float& v) {
  return moller_trumbore(tr[0], tr[1], tr[2], tr[3], tr[4], tr[5], tr[6],
                         tr[7], tr[8], ox, oy, oz, dx, dy, dz, t, u, v);
}

// Pops the topmost stack entry whose entry distance is at most
// cull_bound(bt) into ref, dropping the entries above it; returns false when
// none is left.
__device__ __forceinline__ bool pop_entry(const int* stack_ref,
                                          const float* stack_t, int& sp,
                                          float bt, int& ref) {
  const float bound = cull_bound(bt);
  while (sp > 0) {
    --sp;
    if (stack_t[sp] <= bound) {
      ref = stack_ref[sp];
      return true;
    }
  }
  return false;
}

// ---- persistent traversal warps (traverse_bvh2.cu, traverse_stream.cu,
// traverse_wide.cu) ----
// Blocks of kWalkThreads threads, as many as the card holds resident; a
// warp takes rays from a global counter whenever at least kRefill of its
// lanes are free, and each lane walks a tree of node records with a stack
// of (reference, entry distance) split between shared and local memory.

constexpr int kWalkThreads = 128;
constexpr int kWalkStack = 64;      // the binary packers' depth bound
constexpr int kSharedStack = 16;    // entries per lane in shared memory
constexpr int kRefill = 8;          // free lanes before a warp fetches rays
constexpr int kNone = INT_MIN;      // no node
constexpr unsigned kWarp = 0xffffffffu;

// A child reference: >= 0 an inner node, else a leaf code (kNone: none).
__device__ __forceinline__ bool is_leaf(int ref) {
  return ref < 0 && ref != kNone;
}

// The shared part of the block's stacks: entry j of thread x at
// j * kWalkThreads + x, so the lanes of a warp hit 32 different banks.
__shared__ int walk_stack_ref[kSharedStack * kWalkThreads];
__shared__ float walk_stack_t[kSharedStack * kWalkThreads];

// One lane's stack of (reference, entry distance), kDepth entries: the
// first kSharedStack in shared memory, the rest in local memory.  Each
// packer bounds the entries a walk of its tree can hold by the depth its
// kernel instantiates (kWalkStack for the binary trees: one entry per level
// above a node; 96 for the BVH8 tree), so a stack cannot overflow.
// Entries keep their f32 entry distance: nothing is rounded.
template <int kDepth>
struct Stack {
  int sp;
  int deep_ref[kDepth - kSharedStack];
  float deep_t[kDepth - kSharedStack];

  __device__ __forceinline__ void push(int r, float tt) {
    if (sp < kSharedStack) {
      walk_stack_ref[sp * kWalkThreads + threadIdx.x] = r;
      walk_stack_t[sp * kWalkThreads + threadIdx.x] = tt;
    } else {
      deep_ref[sp - kSharedStack] = r;
      deep_t[sp - kSharedStack] = tt;
    }
    ++sp;
  }

  // The topmost entry whose entry distance is at most cull_bound(bt),
  // dropping the entries above it; kNone when none is left.
  __device__ __forceinline__ int pop(float bt) {
    const float bound = cull_bound(bt);
    while (sp > 0) {
      --sp;
      if (sp < kSharedStack) {
        const int j = sp * kWalkThreads + threadIdx.x;
        if (walk_stack_t[j] <= bound) return walk_stack_ref[j];
      } else if (deep_t[sp - kSharedStack] <= bound) {
        return deep_ref[sp - kSharedStack];
      }
    }
    return kNone;
  }
};

// One fetch step of a persistent warp; every lane of the warp calls it.
// Unless the warp is drained, when at least kRefill lanes are free lane 0
// takes that many ray indices from *next_ray (one atomicAdd, broadcast by
// shuffle) and each free lane gets the next in lane order; an inactive ray
// is written as a miss at once, at no traversal cost.  Returns true on the
// lanes that got an active ray (its index in r); sets drained, the same on
// every lane, once the counter has passed n_rays.
__device__ __forceinline__ bool fetch_ray(
    bool has_ray, bool& drained, long long& r,
    unsigned long long* __restrict__ next_ray, long long n_rays,
    const uint8_t* __restrict__ active, int* __restrict__ out_i,
    float* __restrict__ out_t, float* __restrict__ out_u,
    float* __restrict__ out_v) {
  if (drained) return false;
  const int lane = threadIdx.x & 31;
  const unsigned free_lanes = __ballot_sync(kWarp, !has_ray);
  const int n_free = __popc(free_lanes);
  if (n_free < kRefill) return false;
  unsigned long long b = 0;
  if (lane == 0) b = atomicAdd(next_ray, (unsigned long long)n_free);
  const long long base = (long long)__shfl_sync(kWarp, b, 0);
  drained = base + n_free >= n_rays;
  if (has_ray) return false;
  r = base + __popc(free_lanes & ((1u << lane) - 1u));
  if (r >= n_rays) return false;
  if (active[r]) return true;
  out_i[r] = -1;
  out_t[r] = INFINITY;
  out_u[r] = 0.0f;
  out_v[r] = 0.0f;
  return false;
}

// The grid of a persistent kernel: the blocks the card holds resident
// (SMs x the occupancy the runtime reports), or fewer when the rays fill
// fewer.
inline cudaError_t resident_grid(const void* kernel, long long n_rays,
                                 unsigned* blocks) {
  int dev = 0, sms = 0, resident = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                      kWalkThreads, 0);
  if (e != cudaSuccess) return e;
  const long long card = (long long)sms * (resident > 1 ? resident : 1);
  const long long need = (n_rays + kWalkThreads - 1) / kWalkThreads;
  *blocks = (unsigned)(need < card ? need : card);
  return cudaSuccess;
}

// What the runtime reports of a kernel: registers per thread, static
// shared bytes per block, local bytes per thread, resident blocks of
// kWalkThreads per SM and the SMs of the current device.
inline cudaError_t kernel_resources(const void* kernel, int* out) {
  cudaFuncAttributes a;
  int dev = 0;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kernel,
                                                    kWalkThreads, 0);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[4], cudaDevAttrMultiProcessorCount, dev);
  return e;
}

}  // namespace
