// The threefry2x32 hash on the card, bit for bit with
// clive2_tpu_torch/rng.py:threefry2x32 (and so with jax.random under
// jax_threefry_partitionable=True): 20 rounds of add, rotate and xor in
// 5 groups of 4, rotations (13, 15, 26, 6) then (17, 29, 16, 24), the key
// schedule (k0, k1, k0 ^ k1 ^ 0x1BD11BDA) injected after each group with
// the group's number + 1 added to the second word.  uint32_t arithmetic
// wraps where the plain version masks its int64 words with & 0xFFFFFFFF.
//
// A header so that any kernel can draw its own random numbers with the
// same code: rng.cu's draws and key derivations use it.

#pragma once

#include <stdint.h>

namespace clive2 {

struct Words {
  uint32_t x0, x1;
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void threefry_rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl32(x1, R0) ^ x0;
  x0 += x1; x1 = rotl32(x1, R1) ^ x0;
  x0 += x1; x1 = rotl32(x1, R2) ^ x0;
  x0 += x1; x1 = rotl32(x1, R3) ^ x0;
}

// The hash of counter words (x0, x1) under key (k0, k1).
__device__ __forceinline__ Words threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  threefry_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k1; x1 += k2 + 1u;
  threefry_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k2; x1 += k0 + 2u;
  threefry_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k0; x1 += k1 + 3u;
  threefry_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k1; x1 += k2 + 4u;
  threefry_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k2; x1 += k0 + 5u;
  return {x0, x1};
}

// 32 random bits from the 64-bit counter c (rng.py:random_bits): the hash
// of its words (c >> 32, c & 0xFFFFFFFF), its two outputs xor-ed.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint64_t c) {
  const Words w = threefry2x32(k0, k1, (uint32_t)(c >> 32), (uint32_t)c);
  return w.x0 ^ w.x1;
}

// rng.py:uniform's float in [0, 1): the top 23 bits as the mantissa of a
// float in [1, 2), minus one (exact).
__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

}  // namespace clive2
