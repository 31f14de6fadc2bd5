// The threefry RNG's two kernels (clive2_tpu_torch/rng.py):
//
//   draw_kernel  a draw of random_bits or uniform: element i of the
//                row-major draw hashes the 64-bit counter i, or
//                rows[i / inner] * inner + i % inner when the caller draws
//                only some rows of it (a tile's or a subset's lanes);
//   keys_kernel  fold_in (one key, counter (0, data)) and split (num keys,
//                counters (0, i)).
//
// They replace no TPU kernel: the JAX package draws from jax.random, whose
// threefry XLA fuses into one loop.  The port ran rng.py's threefry2x32 as
// PyTorch ops on int64 words, each masked back to 32 bits after an add or
// shift: about 171 launches a hash, 6,327 a 1080p sample in its 37 hashes
// (PERF.md), each reading and writing 8-byte words.  The plain versions
// beside the wrappers (random_bits_plain, fold_in_plain, split_plain) are
// that code; the hash itself is threefry.cuh's, bit for bit with it.
//
// What bounds a draw on the H100 is integer work: a value is one hash of
// about 72 32-bit operations (20 add/rotate/xor rounds, 5 key injections
// of two adds, two first adds), against 4 bytes written.  A 1080p
// sample's 138.9M uniforms are 10.0G operations, 0.30 ms at 132 SMs x 128
// integer lanes a clock (64 INT32, and the FMA pipe's 64, where an add
// issues as IMAD) x 1.98 GHz, and 0.556 GB written, 0.17 ms at 3.35 TB/s
// (PERF.md has the measured times).  So the design keeps every word in
// registers and issues as many independent hashes as it can: a thread
// hashes kPer consecutive elements (kPer independent chains for the
// scheduler to interleave) and writes them with one vector store (float4,
// or two 16-byte stores of int64 bits), a warp's stores contiguous; a
// counter's row is found by one division a thread (none when no rows are
// given, as on one card's whole frame).  The key is read from device
// memory inside the kernel, so the host never reads a key.  Blocks of 256
// threads; the hash needs few registers (at most 31 by ptxas), so an SM
// holds its full 2,048 threads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;             // consecutive elements a thread
constexpr int kKeyThreads = 128;

// kRows: the counters of rows[] (else the element's index is its
// counter).  kBits: write the 32 bits as int64 (random_bits), else the
// uniform float.
template <bool kRows, bool kBits>
__global__ void __launch_bounds__(kThreads)
    draw_kernel(const long long* __restrict__ key,
                const long long* __restrict__ rows, long long n,
                long long inner, void* __restrict__ out) {
  const long long i0 =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kPer;
  if (i0 >= n) return;
  const uint32_t k0 = (uint32_t)__ldg(key), k1 = (uint32_t)__ldg(key + 1);
  uint64_t c[kPer];
  if constexpr (!kRows) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) c[k] = (uint64_t)(i0 + k);
  } else {
    long long r = i0 / inner;
    long long col = i0 - r * inner;
    uint64_t row = (uint64_t)__ldg(rows + r);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      c[k] = row * (uint64_t)inner + (uint64_t)col;
      if (++col == inner) {
        col = 0;
        ++r;
        if (i0 + k + 1 < n) row = (uint64_t)__ldg(rows + r);
      }
    }
  }
  uint32_t bits[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) bits[k] = clive2::threefry_bits(k0, k1, c[k]);
  const bool whole = i0 + kPer <= n;
  if constexpr (kBits) {
    long long* o = reinterpret_cast<long long*>(out) + i0;
    if (whole && (uintptr_t)o % 16 == 0) {
      reinterpret_cast<longlong2*>(o)[0] = make_longlong2(bits[0], bits[1]);
      reinterpret_cast<longlong2*>(o)[1] = make_longlong2(bits[2], bits[3]);
    } else {
      for (int k = 0; k < kPer && i0 + k < n; ++k) o[k] = bits[k];
    }
  } else {
    float v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) v[k] = clive2::bits_to_uniform(bits[k]);
    float* o = reinterpret_cast<float*>(out) + i0;
    if (whole && (uintptr_t)o % 16 == 0) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int k = 0; k < kPer && i0 + k < n; ++k) o[k] = v[k];
    }
  }
}

// Key i of count: the hash of counter (0, first + i), as two int64 words.
__global__ void __launch_bounds__(kKeyThreads)
    keys_kernel(const long long* __restrict__ key, long long first,
                int count, long long* __restrict__ out) {
  const int i = blockIdx.x * kKeyThreads + threadIdx.x;
  if (i >= count) return;
  const clive2::Words w = clive2::threefry2x32(
      (uint32_t)__ldg(key), (uint32_t)__ldg(key + 1), 0u,
      (uint32_t)(first + i));
  out[2 * i] = w.x0;
  out[2 * i + 1] = w.x1;
}

template <bool kRows>
cudaError_t launch_draw(unsigned blocks, cudaStream_t s, int bits,
                        const long long* key, const long long* rows,
                        long long n, long long inner, void* out) {
  if (bits)
    draw_kernel<kRows, true><<<blocks, kThreads, 0, s>>>(key, rows, n,
                                                         inner, out);
  else
    draw_kernel<kRows, false><<<blocks, kThreads, 0, s>>>(key, rows, n,
                                                          inner, out);
  return cudaGetLastError();
}

}  // namespace

// A draw of n_rows x inner elements under the key's two words (int64 on
// the card): rows (int64 [n_rows]) picks the rows of a larger draw, or
// null for the draw's own rows 0..n_rows-1; bits: out is int64 random
// bits, else float32 uniforms in [0, 1).
extern "C" int clive2_rng_uniform(const long long* key,
                                  const long long* rows, long long n_rows,
                                  long long inner, int bits, void* out,
                                  void* stream) {
  if (n_rows < 0 || inner < 0) return (int)cudaErrorInvalidValue;
  const long long n = n_rows * inner;
  if (n == 0) return (int)cudaSuccess;
  const long long per_block = (long long)kThreads * kPer;
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  cudaStream_t s = (cudaStream_t)stream;
  if (rows == nullptr)
    return (int)launch_draw<false>(blocks, s, bits, key, rows, n, inner, out);
  return (int)launch_draw<true>(blocks, s, bits, key, rows, n, inner, out);
}

// count keys [count, 2] (int64) hashed from the key's counters
// (0, first + i): fold_in is first = data, count = 1; split is first = 0.
extern "C" int clive2_rng_keys(const long long* key, long long first,
                               int count, long long* out, void* stream) {
  if (count < 0) return (int)cudaErrorInvalidValue;
  if (count == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((count + kKeyThreads - 1) / kKeyThreads);
  keys_kernel<<<blocks, kKeyThreads, 0, (cudaStream_t)stream>>>(key, first,
                                                               count, out);
  return (int)cudaGetLastError();
}
