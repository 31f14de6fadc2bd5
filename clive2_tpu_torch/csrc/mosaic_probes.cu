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
//                      [K, M], B bf16 [K, N], f32 out [M, N].  This repo
//                      calls that A "K-major"; in PTX's words it is the
//                      MN-major, transposed operand (imm-trans-a 1)
//   mma_kernel<false>  dot128_kern (:85, pallas_call :90): A B, A [M, K]
//                      (PTX's K-major, imm-trans-a 0)
// The plain PyTorch versions are clive2_tpu_torch/ops/mosaic_probes.py:
// slab_copy_plain, matmul_t_plain, matmul_plain.
//
// On Hopper the questions become: can one bulk asynchronous copy
// (cp.async.bulk, completed on an mbarrier, the counterpart of the DMA and
// its semaphore) move each slab layout into shared memory, and does a wgmma
// product whose A is transposed in shared memory cost what a row-major A
// costs.
//
// What bounds them on the H100: at the script's sizes, latency.  A copy
// moves at most 164 KB (0.05 us at 3.35 TB/s), a product at most 0.5 MB
// (0.16 us) for 21 MFLOP (0.02 us at 989 TFLOP/s of bf16), against a
// launch of about 2 us.  The slab still lands whole in shared memory, but
// split across several SMs: the copy's grid has a block per band of whole
// rows (ops/mosaic_probes.py:band_rows, about BAND_BYTES each, a multiple
// of 16 bytes), each block bulk-copies its band into its own shared memory
// on its own mbarrier, and block 0, whose band holds rows 0-7, writes the
// window.  One block moving the whole slab (160 KB at [640, 128]) set the
// copy's time by one SM's copy rate.  A band can pass the default 48 KB
// of dynamic shared memory, so the entry opts in up to 227 KB, once per
// device.  The copy is a programmatic dependent launch
// (common.cuh:launch_dependent): it waits for the kernel ahead of it before
// it issues its copy, and lets the next one be scheduled once it has.
//
// A product's time is the chain of one block: its launch, its loads, its
// multiplies, its stores.  mma.sync staged K 32 deep through registers, a
// round trip to memory per stage in series; this design keeps one round
// trip in the chain, and more blocks share the card.  Each block computes a
// 64 x kBN tile of C with one warpgroup and holds all of K in shared
// memory: thread 0 issues every TMA load of the block's A (64 x K, in
// 64 x 64 boxes, 128-byte swizzle) and B (K x kBN, in kBN x 64 boxes, the
// swizzle of a kBN-wide row: 64 bytes) at once, all on one mbarrier whose
// expect_tx is their bytes; the warpgroup waits once, then issues K / 16
// wgmma m64n{kBN}k16 products with both operands read from shared memory
// through matrix descriptors (A K-major or transposed, B [K, N] N-major:
// imm-trans-b 1), commits them as one group and waits for it; the f32
// fragments go straight to global memory as float2.  No proxy fence sits
// between the loads and the products: TMA writes and wgmma reads shared
// memory both through the async proxy, and the mbarrier's completion
// orders them.  K is at most kMaxK: A and B then stay resident together
// (97 KB at kMaxK), so no ring of stages is needed, and the entry refuses a
// larger K.  K need not fill the last box: TMA reads the elements past K
// as zeros, which add nothing.  kBN = 32 (40 blocks at the script's
// [640, 128] out) and the direct stores were chosen on the card against
// kBN 64 and 128 and against an epilogue staged through shared memory for
// one TMA store (PERF.md, PR 15).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kCopyThreads = 256;
// a block's dynamic shared memory on sm_90 (227 KB), less room for the
// static mbarrier; below expect_tx's 2^20 - 1 bytes
constexpr long long kMaxSlabBytes = 227 * 1024 - 128;

// Block b copies rows [b band_rows, min((b + 1) band_rows, rows)) of the
// bf16 slab [rows, cols] at src into its shared memory; block 0 then
// writes the window [out_rows, out_cols] (out_rows <= band_rows) as f32.
__global__ void __launch_bounds__(kCopyThreads)
    slab_copy_kernel(const __nv_bfloat16* __restrict__ src, int rows,
                     int cols, int band_rows, float* __restrict__ out,
                     int out_rows, int out_cols) {
  extern __shared__ __align__(128) unsigned char band_bytes[];
  __shared__ __align__(8) uint64_t bar;
  const int r0 = blockIdx.x * band_rows;
  const int n = min(band_rows, rows - r0);
  grid_dependency_wait();
  bulk_start(band_bytes, src + (size_t)r0 * cols, 2u * n * cols, &bar);
  allow_dependents();
  bulk_wait(&bar);
  if (blockIdx.x != 0) return;
  const __nv_bfloat16* band =
      reinterpret_cast<const __nv_bfloat16*>(band_bytes);
  for (int i = threadIdx.x; i < out_rows * out_cols; i += kCopyThreads) {
    const int r = i / out_cols;
    out[i] = __bfloat162float(band[r * cols + (i - r * out_cols)]);
  }
}

constexpr int kBM = 64;     // rows of C per block: one warpgroup's m64
constexpr int kBN = 32;     // columns of C per block
constexpr int kKStep = 16;  // K of one wgmma: K is a multiple of it
constexpr int kMaxK = 512;  // all of K resident in shared memory
constexpr int kBox = 64;    // a TMA box: 64 bf16 (the 128-byte swizzle
                            // span) by 64 rows, 8 KB
constexpr int kBoxBytes = kBox * kBox * 2;
constexpr int kBSpan = kBN < kBox ? kBN : kBox;  // B's columns per box
constexpr int kBRow = 2 * kBSpan;   // bytes of a row of B in shared memory,
                                    // and B's swizzle span
constexpr int kMmaThreads = 128;    // one warpgroup

// bytes of shared memory a block takes for K: A's and B's boxes, and 1 KB
// to align them to the swizzle's 1,024-byte repeat
__host__ __device__ constexpr int mma_smem_bytes(int k) {
  return 1024 + (k + kBox - 1) / kBox * kBox * 2 * (kBM + kBN);
}
static_assert(mma_smem_bytes(kMaxK) <= 227 * 1024 - 128,
              "A and B must fit in shared memory at kMaxK");

// A wgmma matrix descriptor (PTX ISA, "Matrix Descriptor Format"): the
// start address, the leading and the stride byte offsets, each in 16-byte
// units, and the swizzle mode in bits 62-63 (1: 128 bytes, 2: 64 bytes).
// For a K-major operand with a swizzle the leading offset is unused and
// the stride offset steps 8 rows of the operand (M or N); for an MN-major
// one the leading offset steps from one swizzle span of M or N to the next
// and the stride offset steps 8 rows of K.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo,
                                              uint32_t swizzle_bytes) {
  const uint64_t mode = swizzle_bytes == 128 ? 1 : 2;
  return (uint64_t)((addr & 0x3ffff) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3fff) << 16 |
         (uint64_t)((sbo >> 4) & 0x3fff) << 32 | mode << 62;
}

// One 2D TMA load of the box at element (x, y) of map (x along the
// contiguous dimension) into shared memory at dst, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Keeps the compiler from moving reads or writes of an accumulator
// register across the asynchronous products (CUTLASS's
// warpgroup_fence_operand).
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// d += A B for one k16 step of the block's 64 x kBN tile, both operands in
// shared memory through their descriptors: A K-major, or transposed when
// kTransA; B N-major.  Each thread holds kBN / 2 sums: warp w, lane l, sum
// i at row 16 w + l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4) +
// i % 2 (PTX ISA, wgmma m64nNk16 accumulator fragment).
template <bool kTransA>
__device__ __forceinline__ void wgmma_k16(float (&d)[kBN / 2],
                                          uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, %19, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(int(kTransA)));
}

// C [M, N] f32 = op(A) B: op(A) = A [M, K], or A^T with A [K, M] when
// kTransA; B [K, N]; all row-major.  M is a multiple of kBM, N of kBN, K of
// kKStep up to kMaxK.  map_a's boxes are 64 x 64 of A as stored, map_b's
// kBSpan columns by 64 rows of K, both with the swizzle of their row bytes.
template <bool kTransA>
__global__ void __launch_bounds__(kMmaThreads, 1)
    mma_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_b,
               float* __restrict__ c, int n, int k) {
  extern __shared__ unsigned char mma_smem[];
  __shared__ __align__(8) uint64_t bar_storage;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int boxes = (k + kBox - 1) / kBox;     // boxes along K
  // A: box j holds K rows 64 j.. (transposed: rows of K, 64 M each) or K
  // columns 64 j.. (64 rows of M), 8 KB each.  B: kBN / kBSpan spans of N
  // one after another, each every row of K (kBRow bytes a row) in its
  // boxes' order.
  const uint32_t sa = (shared_addr(mma_smem) + 1023) & ~1023u;
  const uint32_t sb = sa + boxes * kBoxBytes;
  const uint32_t b_span = boxes * kBox * kBRow;    // bytes of one span of B
  const uint32_t bar = shared_addr(&bar_storage);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(boxes * kBox * 2 * (kBM + kBN))
        : "memory");
    for (int j = 0; j < boxes; ++j) {
      if (kTransA)
        tma_load(sa + j * kBoxBytes, &map_a, m0, j * kBox, bar);
      else
        tma_load(sa + j * kBoxBytes, &map_a, j * kBox, m0, bar);
      for (int s = 0; s < kBN / kBSpan; ++s)
        tma_load(sb + s * b_span + j * kBox * kBRow, &map_b,
                 n0 + s * kBSpan, j * kBox, bar);
    }
  }
  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.0f;
  mbar_wait(bar, 0);
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) fence_operand(acc[i]);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  for (int s = 0; s < k / kKStep; ++s) {
    // A: 16 rows of K on (transposed), or 32 bytes along a row within its
    // box; B: 16 rows of K on in every span
    const uint32_t a_at = kTransA ? s * kKStep * 2 * kBox
                                  : (s * kKStep / kBox) * kBoxBytes +
                                        (s * kKStep % kBox) * 2;
    // (A's leading offset is unused: its 64 rows of M are one swizzle
    // span, and a k16 step lies within one 128-byte row)
    const uint64_t da = smem_desc(sa + a_at, 16, 8 * 2 * kBox, 128);
    const uint64_t db = smem_desc(sb + s * kKStep * kBRow, b_span,
                                  8 * kBRow, kBRow);
    wgmma_k16<kTransA>(acc, da, db);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) fence_operand(acc[i]);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* row = c + (size_t)(m0 + 16 * warp + lane / 4) * n + n0 +
               2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    *reinterpret_cast<float2*>(row + 8 * j) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(row + (size_t)8 * n + 8 * j) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

}  // namespace

// out [min(rows, 8), min(cols, 128)] f32 from the bf16 slab [rows, cols] at
// src, copied whole into shared memory first, band_rows rows a block.  The
// slab's bytes must be a multiple of 16 and at most kMaxSlabBytes, src
// 16-byte aligned; band_rows at least the window's rows and at most the
// slab's, and its bytes a multiple of 16 unless it is the whole slab.
extern "C" int clive2_slab_copy(const void* src, int rows, int cols,
                                int band_rows, float* out, void* stream) {
  const long long bytes = 2LL * rows * cols;
  const int out_rows = rows < 8 ? rows : 8;
  if (rows <= 0 || cols <= 0 || bytes % 16 || bytes > kMaxSlabBytes ||
      (uintptr_t)src % 16 || band_rows < out_rows || band_rows > rows ||
      (band_rows < rows && 2LL * band_rows * cols % 16))
    return (int)cudaErrorInvalidValue;
  static SmemOptIn smem_opt_in;
  const cudaError_t e =
      smem_opt_in((const void*)slab_copy_kernel, (int)kMaxSlabBytes);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (rows + band_rows - 1) / band_rows;
  const size_t smem = 2 * (size_t)band_rows * cols;
  const __nv_bfloat16* slab = (const __nv_bfloat16*)src;
  const int out_cols = cols < 128 ? cols : 128;
  return (int)launch_dependent(slab_copy_kernel, blocks, kCopyThreads, smem,
                               stream, slab, rows, cols, band_rows, out,
                               out_rows, out_cols);
}

// cuTensorMapEncodeTiled from the driver, found through the runtime, so the
// library links no libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// The map of a row-major bf16 [rows, cols] array read in boxes of box_cols
// x 64 rows, with the swizzle of box_cols * 2 bytes (128 or 64); rows past
// the array read as zeros.
static bool bf16_map(EncodeTiled encode, CUtensorMap* map, const void* base,
                     int rows, int cols, int box_cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)kBox};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                               : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// c [m, n] f32 = a^T b (trans_a, a [k, m]) or a b (a [m, k]); b [k, n];
// all bf16 row-major, a and b 16-byte aligned, c 8-byte aligned; m a
// multiple of kBM, n of kBN, k of kKStep and at most kMaxK.
extern "C" int clive2_mma_bf16(const void* a, const void* b, float* c, int m,
                               int n, int k, int trans_a, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || m % kBM || n % kBN || k % kKStep ||
      k > kMaxK || (uintptr_t)a % 16 || (uintptr_t)b % 16 ||
      (uintptr_t)c % 8)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap map_a, map_b;
  if (!bf16_map(encode, &map_a, a, trans_a ? k : m, trans_a ? m : k, kBox) ||
      !bf16_map(encode, &map_b, b, k, n, kBSpan))
    return (int)cudaErrorInvalidValue;
  const int smem = mma_smem_bytes(k);
  void (*kernel)(const CUtensorMap, const CUtensorMap, float*, int, int) =
      trans_a ? mma_kernel<true> : mma_kernel<false>;
  static SmemOptIn smem_opt_in[2];
  const cudaError_t e = smem_opt_in[trans_a ? 1 : 0](
      (const void*)kernel, mma_smem_bytes(kMaxK));
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(n / kBN, m / kBM), kMmaThreads, smem,
           (cudaStream_t)stream>>>(map_a, map_b, c, n, k);
  return (int)cudaGetLastError();
}
