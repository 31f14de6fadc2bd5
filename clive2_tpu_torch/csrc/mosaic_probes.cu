// The layout probes of scripts/probe_mosaic_layouts.py: a bulk copy of a
// bf16 slab into shared memory, and two bf16 tensor-core products.
//
// Replaces the three TPU kernels of that script, which asked which DMA slice
// shapes and matmul operand orders Mosaic compiles for stream2's fat-leaf
// feature rows:
//   slab_copy_kernel   dma_probe.kern (:41, pallas_call :47): an async copy
//                      of src[2] of a bf16 [4, R, C] array into a scratch
//                      slot, then slot[:8, :128] as f32
//   mma_kernel<true>   dotT_kern (:70, pallas_call :77): A^T B, A bf16
//                      [K, M] (K-major), B bf16 [K, N], f32 out [M, N]
//   mma_kernel<false>  dot128_kern (:85, pallas_call :90): A B, A [M, K]
// The plain PyTorch versions are clive2_tpu_torch/ops/mosaic_probes.py:
// slab_copy_plain, matmul_t_plain, matmul_plain.
//
// On Hopper the questions become: can one bulk asynchronous copy
// (cp.async.bulk, completed on an mbarrier, the counterpart of the DMA and
// its semaphore) move each slab layout into shared memory, and does an
// mma.sync product with a K-major A (ldmatrix .trans) cost what the
// row-major one costs.
//
// What bounds them on the H100: at the script's sizes, the launch.  A copy
// moves at most 164 KB (0.05 us at 3.35 TB/s), a product at most 0.5 MB
// (0.16 us) for 21 MFLOP (0.02 us at 989 TFLOP/s of bf16).  So the designs
// are the plain ones: one block copies the whole slab with one bulk copy
// (a 640 x 128 slab is 160 KB, past the default 48 KB of dynamic shared
// memory, so the entry opts in up to 227 KB); a product tiles the output
// in 64 x 64 blocks of 4 warps, stages A and B through shared memory 32
// deep with 16-byte loads, loads fragments with ldmatrix and multiplies
// with mma.sync m16n8k16 (bf16 in, f32 accumulate).  No wgmma, no TMA
// tensor maps, no pipelining: those are for a kernel whose size pays.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kCopyThreads = 256;
// a block's dynamic shared memory on sm_90 (227 KB), less room for the
// static mbarrier; below expect_tx's 2^20 - 1 bytes
constexpr long long kMaxSlabBytes = 227 * 1024 - 128;

__global__ void __launch_bounds__(kCopyThreads)
    slab_copy_kernel(const __nv_bfloat16* __restrict__ src, int cols,
                     uint32_t bytes, float* __restrict__ out, int out_rows,
                     int out_cols) {
  extern __shared__ __align__(128) unsigned char slab_bytes[];
  __shared__ __align__(8) uint64_t bar;
  bulk_load(slab_bytes, src, bytes, &bar);
  const __nv_bfloat16* slab =
      reinterpret_cast<const __nv_bfloat16*>(slab_bytes);
  for (int i = threadIdx.x; i < out_rows * out_cols; i += kCopyThreads) {
    const int r = i / out_cols;
    out[i] = __bfloat162float(slab[r * cols + (i - r * out_cols)]);
  }
}

constexpr int kBM = 64, kBN = 64, kBK = 32;   // block tile, staged depth
constexpr int kPad = 8;      // bf16 per shared row: 16-byte rows for
                             // ldmatrix, no bank conflicts
constexpr int kMmaThreads = 128;   // 4 warps, 16 output rows each

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(shared_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(shared_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// C [M, N] f32 = op(A) B, all row-major: op(A) = A [M, K], or A^T with A
// [K, M] when kTransA.  B is [K, N].  M and N are multiples of 64, K of 32.
// Fragments (PTX ISA, mma.m16n8k16): lane l holds A rows l/4 and l/4 + 8
// at k = 2(l%4) + {0, 1} and + 8, B at those k and column l/4.  ldmatrix
// gives them from 8 x 8 tiles whose rows the lanes address (lanes 8i to
// 8i + 7 tile i); .trans reads a tile stored k-major, which is how B
// always is, and A under kTransA.
template <bool kTransA>
__global__ void __launch_bounds__(kMmaThreads)
    mma_kernel(const __nv_bfloat16* __restrict__ a,
               const __nv_bfloat16* __restrict__ b, float* __restrict__ c,
               int m, int n, int k) {
  constexpr int kARows = kTransA ? kBK : kBM;
  constexpr int kAWidth = kTransA ? kBM : kBK;
  __shared__ __align__(16) __nv_bfloat16 as[kARows][kAWidth + kPad];
  __shared__ __align__(16) __nv_bfloat16 bs[kBK][kBN + kPad];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp * 16;
  // the 8 x 8 tile this lane addresses: its row, and which of the four
  const int row8 = lane & 7, second = (lane >> 3) & 1, upper = lane >> 4;
  float acc[kBN / 8][4] = {};
  for (int k0 = 0; k0 < k; k0 += kBK) {
    for (int i = threadIdx.x; i < kARows * kAWidth / 8; i += kMmaThreads) {
      const int r = i / (kAWidth / 8), c8 = i % (kAWidth / 8) * 8;
      const __nv_bfloat16* g = kTransA ? a + (size_t)(k0 + r) * m + m0 + c8
                                       : a + (size_t)(m0 + r) * k + k0 + c8;
      *reinterpret_cast<uint4*>(&as[r][c8]) =
          *reinterpret_cast<const uint4*>(g);
    }
    for (int i = threadIdx.x; i < kBK * kBN / 8; i += kMmaThreads) {
      const int r = i / (kBN / 8), c8 = i % (kBN / 8) * 8;
      *reinterpret_cast<uint4*>(&bs[r][c8]) =
          *reinterpret_cast<const uint4*>(b + (size_t)(k0 + r) * n + n0 + c8);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      // A's tiles in fragment order: (m, k), (m + 8, k), (m, k + 8),
      // (m + 8, k + 8)
      uint32_t af[4];
      if (kTransA)
        ldmatrix_x4_trans(af, &as[kk + row8 + upper * 8][wm + second * 8]);
      else
        ldmatrix_x4(af, &as[wm + row8 + second * 8][kk + upper * 8]);
#pragma unroll
      for (int j = 0; j < kBN / 8; j += 2) {
        // B's tiles: (k, n), (k + 8, n) for fragment j, then for j + 1
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, &bs[kk + row8 + second * 8][j * 8 + upper * 8]);
        mma_bf16(acc[j], af, bf[0], bf[1]);
        mma_bf16(acc[j + 1], af, bf[2], bf[3]);
      }
    }
    __syncthreads();
  }
  const int row = m0 + wm + (lane >> 2), col = n0 + (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    *reinterpret_cast<float2*>(c + (size_t)row * n + col + j * 8) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(c + (size_t)(row + 8) * n + col + j * 8) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

}  // namespace

// out [min(rows, 8), min(cols, 128)] f32 from the bf16 slab [rows, cols] at
// src, copied whole into shared memory first.  The slab's bytes must be a
// multiple of 16 and at most kMaxSlabBytes, src 16-byte aligned.
extern "C" int clive2_slab_copy(const void* src, int rows, int cols,
                                float* out, void* stream) {
  const long long bytes = 2LL * rows * cols;
  if (rows <= 0 || cols <= 0 || bytes % 16 || bytes > kMaxSlabBytes ||
      (uintptr_t)src % 16)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      slab_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  slab_copy_kernel<<<1, kCopyThreads, (size_t)bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)src, cols, (uint32_t)bytes, out,
      rows < 8 ? rows : 8, cols < 128 ? cols : 128);
  return (int)cudaGetLastError();
}

// c [m, n] f32 = a^T b (trans_a, a [k, m]) or a b (a [m, k]); b [k, n];
// all bf16 row-major and 16-byte aligned; m, n multiples of 64, k of 32.
extern "C" int clive2_mma_bf16(const void* a, const void* b, float* c, int m,
                               int n, int k, int trans_a, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || m % kBM || n % kBN || k % kBK ||
      (uintptr_t)a % 16 || (uintptr_t)b % 16 || (uintptr_t)c % 8)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n / kBN, m / kBM);
  const auto* pa = (const __nv_bfloat16*)a;
  const auto* pb = (const __nv_bfloat16*)b;
  if (trans_a)
    mma_kernel<true><<<grid, kMmaThreads, 0, (cudaStream_t)stream>>>(
        pa, pb, c, m, n, k);
  else
    mma_kernel<false><<<grid, kMmaThreads, 0, (cudaStream_t)stream>>>(
        pa, pb, c, m, n, k);
  return (int)cudaGetLastError();
}
