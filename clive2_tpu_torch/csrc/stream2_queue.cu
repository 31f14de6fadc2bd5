// Queued fat-leaf traversal: the walk, the binning of rays by fat leaf and
// the fat-leaf test of the rays queued at each fat leaf.
//
// Replaces the TPU kernel clive2_tpu/ops/traverse_stream2.py:_kernel, with
// csrc/traverse_stream2.cu (the per-thread walk, and the tail that finishes
// a chunk).  The schedule that drives these launches, and the plain
// PyTorch version of each, are in clive2_tpu_torch/ops/traverse_stream2.py
// (queued_cast; walk_to_leaf_plain, bin_by_leaf_plain, leaf_test_plain).
// Ray state layout: stream2.cuh.
//
// What bounds it on the H100: the slot tests.  A cast needs about 40 FP32
// operations per (ray, slot) pair of every fat leaf a ray enters (1-3 fat
// leaves of ~100 slots on a connection ray), against ~100 bytes of ray
// state per ray and round.  The per-thread kernel instead reads each
// slot's 80-byte feature row once per ray (up to 10 KB per ray and fat
// leaf), with the 32 lanes of a warp in 32 different fat leaves; on the
// largest scene the rows (105 MB) do not fit the 50 MB L2.
//
// Design: the cast runs in rounds.  (a) walk: one thread per ray resumes
// the top-tree walk from its saved stack and stops at its next fat leaf.
// (b) bin: a histogram of the rays by fat leaf (atomics, one per warp and
// fat leaf), an exclusive scan of the counts padded to whole tiles of 128
// entries (one block), and a scatter into that queue.  The scan also leaves
// the round's live rays and tiles in device memory (info): the leaf test's
// grid is sized for the chunk and its blocks past the tile count return,
// so no round waits for the host.
// (c) leaf test: one block per tile copies its fat leaf's feature rows
// (<= 128 x 80 B) into shared memory once with a bulk asynchronous copy
// (cp.async.bulk + mbarrier) and runs the exact FP32 test of every slot
// against the tile's rays, so a row is read from memory once per tile, not
// once per ray, and the slot loop is a shared-memory broadcast in lockstep
// across the warp.  It updates (bt, bc) by the (t, slot) rule, so the
// answer is the same lexicographic minimum over the same passing slots as
// the per-thread kernel's, bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "stream2.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 128;          // rays per tile, threads per leaf block
constexpr int kMaxSlots = 128;      // slots per fat leaf (LANES)

// ---- (a) walk ---------------------------------------------------------------

// Pops the topmost entry of a [depth, n] stack whose entry distance is at
// most cull_bound(bt) into ref (common.cuh:pop_entry on a strided stack).
__device__ __forceinline__ bool pop_strided(const int* stack_ref,
                                            const float* stack_t,
                                            long long n, long long i, int& sp,
                                            float bt, int& ref) {
  const float bound = cull_bound(bt);
  while (sp > 0) {
    --sp;
    if (stack_t[sp * n + i] <= bound) {
      ref = stack_ref[sp * n + i];
      return true;
    }
  }
  return false;
}

template <bool kAnyHit>
__global__ void walk_kernel(
    const float* __restrict__ origin, const float* __restrict__ direction,
    const uint8_t* __restrict__ active, const float* __restrict__ t_max,
    long long n, int first, const float* __restrict__ nodebox,
    const int* __restrict__ childs, const float* __restrict__ ctr,
    float4* __restrict__ ray, float* __restrict__ bt_s, int* __restrict__ bc_s,
    int* __restrict__ ref_s, int* __restrict__ sp_s,
    int* __restrict__ stack_ref, float* __restrict__ stack_t,
    int* __restrict__ leaf) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float4 q[kRayRow];
  float bt;
  int ref, sp;
  if (first) {
    // the chunk's first round: the ray's state from its inputs
    ray_row(origin[3 * i], origin[3 * i + 1], origin[3 * i + 2],
            direction[3 * i], direction[3 * i + 1], direction[3 * i + 2],
            ctr, q);
    for (int k = 0; k < kRayRow; ++k) ray[kRayRow * i + k] = q[k];
    const float cap = t_max[i];
    bt = cap < kCapClamp ? cap : kCapClamp;
    bt_s[i] = bt;
    bc_s[i] = -1;
    sp = 0;
    ref = active[i] ? 0 : kDone;
  } else {
    ref = ref_s[i];
    if (ref == kDone) {
      leaf[i] = -1;
      return;
    }
    for (int k = 0; k < 3; ++k) q[k] = ray[kRayRow * i + k];
    bt = bt_s[i];
    sp = sp_s[i];
    // the ray's fat leaf was tested in the last round: an any-hit ray with
    // a hit stops, any other pops its next entry
    if ((kAnyHit && bc_s[i] >= 0) ||
        !pop_strided(stack_ref, stack_t, n, i, sp, bt, ref))
      ref = kDone;
  }
  while (ref >= 0) {
    bool push;
    int push_ref;
    float push_t;
    if (node_step(nodebox, childs, q[0].x, q[0].y, q[0].z, q[1].z, q[1].w,
                  q[2].x, bt, ref, push, push_ref, push_t)) {
      if (push) {
        stack_ref[sp * n + i] = push_ref;
        stack_t[sp * n + i] = push_t;
        ++sp;
      }
    } else if (!pop_strided(stack_ref, stack_t, n, i, sp, bt, ref)) {
      ref = kDone;
    }
  }
  ref_s[i] = ref;
  sp_s[i] = sp;
  leaf[i] = ref == kDone ? -1 : -(ref + 1);
}

// ---- (b) bin ----------------------------------------------------------------

// Connection rays converge on the same few fat leaves, so each warp adds
// once per distinct fat leaf among its lanes (match.any) instead of once
// per ray.  Every lane of the warp takes part (no early return).
__global__ void count_kernel(const int* __restrict__ leaf, long long n,
                             int* __restrict__ hist) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int f = i < n ? leaf[i] : -1;
  const unsigned peers = __match_any_sync(0xffffffffu, f);
  if (f >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(hist + f, __popc(peers));
}

// cursor[f] starts at fat leaf f's first queue entry; the order within a
// fat leaf does not change the answer (the (t, slot) rule).
__global__ void scatter_kernel(const int* __restrict__ leaf, long long n,
                               int* __restrict__ cursor,
                               int* __restrict__ queue) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int f = i < n ? leaf[i] : -1;
  const unsigned peers = __match_any_sync(0xffffffffu, f);
  const int lane = threadIdx.x & 31, leader = __ffs(peers) - 1;
  int base = 0;
  if (f >= 0 && lane == leader) base = atomicAdd(cursor + f, __popc(peers));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (f >= 0) queue[base + __popc(peers & ((1u << lane) - 1))] = (int)i;
}

// offs[f] = cursor[f] = the exclusive sum of the counts before fat leaf f,
// each padded to whole tiles; info = (live rays, tiles).  One block: each
// thread sums a contiguous range of fat leaves, the block scans the sums.
constexpr int kPlanThreads = 1024;

__global__ void __launch_bounds__(kPlanThreads)
    plan_kernel(const int* __restrict__ hist, int n_fat,
                int* __restrict__ offs, int* __restrict__ cursor,
                int* __restrict__ info) {
  __shared__ int padded[kPlanThreads];
  __shared__ int live[kPlanThreads];
  const int t = threadIdx.x;
  const int per = (n_fat + kPlanThreads - 1) / kPlanThreads;
  const int lo = min(n_fat, t * per), hi = min(n_fat, lo + per);
  int sum = 0, count = 0;
  for (int f = lo; f < hi; ++f) {
    sum += (hist[f] + kTile - 1) / kTile * kTile;
    count += hist[f];
  }
  padded[t] = sum;
  live[t] = count;
  __syncthreads();
  for (int d = 1; d < kPlanThreads; d <<= 1) {   // inclusive scans
    const int p = t >= d ? padded[t - d] : 0;
    const int l = t >= d ? live[t - d] : 0;
    __syncthreads();
    padded[t] += p;
    live[t] += l;
    __syncthreads();
  }
  int base = padded[t] - sum;
  for (int f = lo; f < hi; ++f) {
    offs[f] = cursor[f] = base;
    base += (hist[f] + kTile - 1) / kTile * kTile;
  }
  if (t == kPlanThreads - 1) {
    info[0] = live[t];
    info[1] = padded[t] / kTile;
  }
}

// ---- (c) leaf test ----------------------------------------------------------

// One block per tile of 128 queued rays at one fat leaf; blocks past the
// round's tile count (info[1]) return.  A tile's first entry always holds
// a ray and names the fat leaf; entries past the fat leaf's count are
// padding.
__global__ void __launch_bounds__(kTile)
    leaf_kernel(const int* __restrict__ queue, const int* __restrict__ info,
                const int* __restrict__ hist, const int* __restrict__ offs,
                const int* __restrict__ leaf,
                const float4* __restrict__ ray, float* __restrict__ bt_s,
                int* __restrict__ bc_s, const float4* __restrict__ feat,
                const int* __restrict__ fat_start) {
  __shared__ __align__(128) float4 rows[kMaxSlots * kFeatRow];
  __shared__ __align__(8) uint64_t bar;

  if ((int)blockIdx.x >= info[1]) return;
  const int tid = threadIdx.x;
  const long long entry = (long long)blockIdx.x * kTile + tid;
  const int f = leaf[queue[(long long)blockIdx.x * kTile]];
  const int r = entry - offs[f] < hist[f] ? queue[entry] : -1;
  const int start = fat_start[f];
  const int cnt = fat_start[f + 1] - start;

  float4 q0 = make_float4(0.f, 0.f, 0.f, 0.f), q1 = q0, q2 = q0, q3 = q0;
  float bt = 0.0f;
  int bc = -1;
  if (r >= 0) {
    q0 = ray[kRayRow * (long long)r];
    q1 = ray[kRayRow * (long long)r + 1];
    q2 = ray[kRayRow * (long long)r + 2];
    q3 = ray[kRayRow * (long long)r + 3];
    bt = bt_s[r];
    bc = bc_s[r];
  }
  const RayFeat x = ray_feat(q0, q1, q2, q3);
  bulk_load(rows, feat + (long long)kFeatRow * start,
            (uint32_t)(cnt * kFeatRow * sizeof(float4)), &bar);
  if (r < 0) return;

  const float bt0 = bt;
  const int bc0 = bc;
  for (int k = 0; k < cnt; ++k) {
    float t;
    if (slot_test(rows + kFeatRow * k, x, t) &&
        (t < bt || (t == bt && start + k < bc))) {
      bt = t;
      bc = start + k;
    }
  }
  if (bc != bc0 || bt != bt0) {
    bt_s[r] = bt;
    bc_s[r] = bc;
  }
}

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int clive2_s2q_walk(const float* origin, const float* direction,
                               const uint8_t* active, const float* t_max,
                               long long n, int first, const float* nodebox,
                               const int* childs, const float* ctr,
                               float* ray, float* bt, int* bc, int* ref,
                               int* sp, int* stack_ref, float* stack_t,
                               int* leaf, int any_hit, void* stream) {
  auto kernel = any_hit ? walk_kernel<true> : walk_kernel<false>;
  kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      origin, direction, active, t_max, n, first, nodebox, childs, ctr,
      reinterpret_cast<float4*>(ray), bt, bc, ref, sp, stack_ref, stack_t,
      leaf);
  return (int)cudaGetLastError();
}

extern "C" int clive2_s2q_count(const int* leaf, long long n, int* hist,
                                void* stream) {
  count_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(leaf, n,
                                                                      hist);
  return (int)cudaGetLastError();
}

extern "C" int clive2_s2q_plan(const int* hist, int n_fat, int* offs,
                               int* cursor, int* info, void* stream) {
  plan_kernel<<<1, kPlanThreads, 0, (cudaStream_t)stream>>>(hist, n_fat, offs,
                                                           cursor, info);
  return (int)cudaGetLastError();
}

extern "C" int clive2_s2q_scatter(const int* leaf, long long n, int* cursor,
                                  int* queue, void* stream) {
  scatter_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      leaf, n, cursor, queue);
  return (int)cudaGetLastError();
}

// max_tiles: the most tiles a round of the chunk can have (its grid)
extern "C" int clive2_s2q_leaf(const int* queue, const int* info,
                               const int* hist, const int* offs,
                               long long max_tiles, const int* leaf,
                               const float* ray, float* bt, int* bc,
                               const float* feat, const int* fat_start,
                               void* stream) {
  if (max_tiles > 0)
    leaf_kernel<<<(unsigned)max_tiles, kTile, 0, (cudaStream_t)stream>>>(
        queue, info, hist, offs, leaf, reinterpret_cast<const float4*>(ray),
        bt, bc, reinterpret_cast<const float4*>(feat), fat_start);
  return (int)cudaGetLastError();
}
