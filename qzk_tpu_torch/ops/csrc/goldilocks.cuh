// Goldilocks field arithmetic on native 64-bit lanes for Hopper.
//
// p = 2^64 - 2^32 + 1, eps = 2^64 mod p = 2^32 - 1.  Each function
// mirrors ops/goldilocks_torch.py step for step (the same carries, the
// same two conditional subtractions in reduce128), so a kernel built on
// this header agrees bit for bit with its plain torch version on every
// 64-bit input, canonical or not.
//
// Replaces the u32-pair primitives of the TPU kernels (_cond_sub_p,
// _gadd, _mul_32_32, _reduce128, _gmul in qzk_tpu/ops/poseidon_pallas.py
// and _gsub in qzk_tpu/ops/ntt_pallas.py): the card has 64-bit integer
// lanes, so a product is one 64-bit multiply plus __umul64hi.
#pragma once
#include <cstdint>

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;

__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) s += EPS;
  return s >= P ? s - P : s;
}

__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  return a < b ? d - EPS : d;
}

__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
  uint64_t hi_hi = hi >> 32;
  uint64_t hi_lo = hi & 0xFFFFFFFFull;
  uint64_t t = lo - hi_hi;
  if (lo < hi_hi) t -= EPS;
  uint64_t s = t + hi_lo * EPS;
  if (s < t) s += EPS;
  if (s >= P) s -= P;
  if (s >= P) s -= P;
  return s;
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  return reduce128(a * b, __umul64hi(a, b));
}

}  // namespace gl
