// Goldilocks field arithmetic on native 64-bit lanes for Hopper.
//
// p = 2^64 - 2^32 + 1, eps = 2^64 mod p = 2^32 - 1.  add, sub and mul
// agree bit for bit with their plain torch versions in
// ops/goldilocks_torch.py on every 64-bit input, canonical or not.  The
// *_weak functions return some 64-bit word congruent to the result mod p,
// for callers that make their outputs canonical themselves.
//
// Replaces the u32-pair primitives of the TPU kernels (_cond_sub_p,
// _gadd, _mul_32_32, _reduce128, _gmul in qzk_tpu/ops/poseidon_pallas.py
// and _gsub in qzk_tpu/ops/ntt_pallas.py).  The card's integer pipes are
// 32 bits wide: the 128-bit product and its reduction are carry chains
// of 32-bit multiply-adds, written in PTX so that the carries stay in the
// carry flag instead of compares and selects.
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

// Any 64-bit word to its canonical value: one subtraction of p suffices,
// since 2^64 - p < p.
__device__ __forceinline__ uint64_t canonical(uint64_t x) {
  return x >= P ? x - P : x;
}

// The 128-bit product a * b as 32-bit words r[0..3], low first: four
// 32 x 32 products summed in one carry chain.
__device__ __forceinline__ void mul_wide(uint64_t a, uint64_t b, uint32_t r[4]) {
  const uint32_t a0 = (uint32_t)a, a1 = (uint32_t)(a >> 32);
  const uint32_t b0 = (uint32_t)b, b1 = (uint32_t)(b >> 32);
  asm("{\n\t"
      "mul.lo.u32     %0, %4, %6;\n\t"
      "mul.hi.u32     %1, %4, %6;\n\t"
      "mad.lo.cc.u32  %1, %4, %7, %1;\n\t"
      "madc.hi.u32    %2, %4, %7, 0;\n\t"
      "mad.lo.cc.u32  %1, %5, %6, %1;\n\t"
      "madc.hi.cc.u32 %2, %5, %6, %2;\n\t"
      "madc.hi.u32    %3, %5, %7, 0;\n\t"
      "mad.lo.cc.u32  %2, %5, %7, %2;\n\t"
      "addc.u32       %3, %3, 0;\n\t"
      "}"
      : "=&r"(r[0]), "=&r"(r[1]), "=&r"(r[2]), "=&r"(r[3])
      : "r"(a0), "r"(a1), "r"(b0), "r"(b1));
}

// r[3] 2^96 + r[2] 2^64 + r[1] 2^32 + r[0] mod p, weakly, with
// 2^64 = eps and 2^96 = -1: t = lo - r[3], less eps on a borrow;
// s = t + r[2] * eps, plus eps on a carry.  Neither correction can borrow
// or carry again.  These are the steps of the torch reduce128 before its
// subtractions of p, with the same carries.
__device__ __forceinline__ uint64_t reduce_weak(const uint32_t r[4]) {
  uint32_t s0, s1, m;
  asm("{\n\t"
      "sub.cc.u32     %0, %3, %6;\n\t"
      "subc.cc.u32    %1, %4, 0;\n\t"
      "subc.u32       %2, 0, 0;\n\t"
      "sub.cc.u32     %0, %0, %2;\n\t"
      "subc.u32       %1, %1, 0;\n\t"
      "mad.lo.cc.u32  %0, %5, %7, %0;\n\t"
      "madc.hi.cc.u32 %1, %5, %7, %1;\n\t"
      "addc.u32       %2, 0, 0;\n\t"
      "neg.s32        %2, %2;\n\t"
      "add.cc.u32     %0, %0, %2;\n\t"
      "addc.u32       %1, %1, 0;\n\t"
      "}"
      : "=&r"(s0), "=&r"(s1), "=&r"(m)
      : "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]), "r"(0xFFFFFFFFu));
  return ((uint64_t)s1 << 32) | s0;
}

// hi 2^64 + lo mod p, weakly, for hi < 2^32: reduce_weak without the
// borrow step, which a zero r[3] never takes.
__device__ __forceinline__ uint64_t reduce96_weak(uint64_t lo, uint32_t hi) {
  uint32_t s0, s1, m;
  asm("{\n\t"
      "mad.lo.cc.u32  %0, %5, %6, %3;\n\t"
      "madc.hi.cc.u32 %1, %5, %6, %4;\n\t"
      "addc.u32       %2, 0, 0;\n\t"
      "neg.s32        %2, %2;\n\t"
      "add.cc.u32     %0, %0, %2;\n\t"
      "addc.u32       %1, %1, 0;\n\t"
      "}"
      : "=&r"(s0), "=&r"(s1), "=&r"(m)
      : "r"((uint32_t)lo), "r"((uint32_t)(lo >> 32)), "r"(hi), "r"(0xFFFFFFFFu));
  return ((uint64_t)s1 << 32) | s0;
}

__device__ __forceinline__ uint64_t mul_weak(uint64_t a, uint64_t b) {
  uint32_t r[4];
  mul_wide(a, b, r);
  return reduce_weak(r);
}

// a + b mod p, weakly, for any 64-bit a and b: each carry out of bit 63
// is worth 2^64 = eps and adds eps back.  A second carry leaves a low
// word below eps, so a third cannot happen.
__device__ __forceinline__ uint64_t add_weak(uint64_t a, uint64_t b) {
  uint32_t s0, s1, c;
  asm("{\n\t"
      "add.cc.u32     %0, %3, %5;\n\t"
      "addc.cc.u32    %1, %4, %6;\n\t"
      "addc.u32       %2, 0, 0;\n\t"
      "neg.s32        %2, %2;\n\t"
      "add.cc.u32     %0, %0, %2;\n\t"
      "addc.cc.u32    %1, %1, 0;\n\t"
      "addc.u32       %2, 0, 0;\n\t"
      "neg.s32        %2, %2;\n\t"
      "add.cc.u32     %0, %0, %2;\n\t"
      "addc.u32       %1, %1, 0;\n\t"
      "}"
      : "=&r"(s0), "=&r"(s1), "=&r"(c)
      : "r"((uint32_t)a), "r"((uint32_t)(a >> 32)), "r"((uint32_t)b), "r"((uint32_t)(b >> 32)));
  return ((uint64_t)s1 << 32) | s0;
}

// a - b mod p, weakly, for any 64-bit a and b: each borrow is worth
// -2^64 = -eps and takes eps away.  A second borrow leaves the word above
// 2^64 - 2 eps, so a third cannot happen.
__device__ __forceinline__ uint64_t sub_weak(uint64_t a, uint64_t b) {
  uint32_t d0, d1, m;
  asm("{\n\t"
      "sub.cc.u32     %0, %3, %5;\n\t"
      "subc.cc.u32    %1, %4, %6;\n\t"
      "subc.u32       %2, 0, 0;\n\t"
      "sub.cc.u32     %0, %0, %2;\n\t"
      "subc.cc.u32    %1, %1, 0;\n\t"
      "subc.u32       %2, 0, 0;\n\t"
      "sub.cc.u32     %0, %0, %2;\n\t"
      "subc.u32       %1, %1, 0;\n\t"
      "}"
      : "=&r"(d0), "=&r"(d1), "=&r"(m)
      : "r"((uint32_t)a), "r"((uint32_t)(a >> 32)), "r"((uint32_t)b), "r"((uint32_t)(b >> 32)));
  return ((uint64_t)d1 << 32) | d0;
}

// The torch reduce128 ends with two conditional subtractions of p; after
// the first the value is below 2^64 - p < p, so the second never changes
// it, and canonical() is the first.
__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  return canonical(mul_weak(a, b));
}

}  // namespace gl
