// BN254 Fr / Fq Montgomery arithmetic over eight little-endian u32 limbs
// (R = 2^256), shared by every kernel of the port.
//
// Replaces the in-kernel helpers of co_zkvms_tpu/ops/field_pallas.py: _mm and
// _redc_cols (B1), _msq (B2), _madd/_msub/_mdbl/_mis_zero/_msel/_cond_sub_m
// (B3). The TPU works on sixteen 16-bit digits because its vector unit has no
// 32x32->64 multiply; Hopper has one (IMAD.WIDE), so a field element is eight
// 32-bit limbs and a product is CIOS (mul) or SOS (square) with 64-bit
// accumulators, then one conditional subtraction. Everything stays in
// registers: a kernel reads each operand once and writes each result once.
//
// The header also compiles as host C++ (FDEV -> inline), so the arithmetic can
// be checked on a machine without nvcc.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define FDEV __device__ __forceinline__
#define FMEMBER __device__ __forceinline__
#define FCONST static __constant__ const
#else
#define FDEV static inline
#define FMEMBER inline
#define FCONST static const
#endif

namespace bn254 {

// [0] = Fr (scalar field), [1] = Fq (base field)
FCONST uint32_t MOD[2][8] = {
    {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
     0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u},
    {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
     0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u}};
// R mod m: the Montgomery form of 1
FCONST uint32_t ONE[2][8] = {
    {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
     0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
    {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
     0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u}};
// -m^{-1} mod 2^32
FCONST uint32_t N0[2] = {0xefffffffu, 0xe4866389u};

// r = (t + hi * 2^256) mod m for a value < 2m (t may alias r).
template <int F>
FDEV void cond_sub(uint32_t r[8], const uint32_t t[8], uint32_t hi) {
  uint32_t d[8];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    uint64_t s = (uint64_t)t[j] - MOD[F][j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  const bool take = (hi != 0) | (borrow == 0);
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = take ? d[j] : t[j];
}

// Montgomery product r = a * b * R^{-1} mod m (CIOS). a < 2^256, b < m.
template <int F>
FDEV void mont_mul(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t t[10];
#pragma unroll
  for (int j = 0; j < 10; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    const uint32_t q = t[0] * N0[F];
    s = (uint64_t)q * MOD[F][0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; j++) {
      s = (uint64_t)q * MOD[F][j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  cond_sub<F>(r, t, t[8]);
}

// Montgomery square r = a * a * R^{-1} mod m (SOS: 28 cross products doubled,
// 8 squares, then 8 reduction rows). Requires a < m.
template <int F>
FDEV void mont_sqr(uint32_t r[8], const uint32_t a[8]) {
  uint32_t t[17];
#pragma unroll
  for (int k = 0; k < 17; k++) t[k] = 0;
#pragma unroll
  for (int i = 0; i < 7; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = i + 1; j < 8; j++) {
      uint64_t s = (uint64_t)a[i] * a[j] + t[i + j] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    t[i + 8] = (uint32_t)c;
  }
  t[15] = t[14] >> 31;
#pragma unroll
  for (int k = 14; k > 0; k--) t[k] = (t[k] << 1) | (t[k - 1] >> 31);
  t[0] = 0;
  {
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
      uint64_t s = (uint64_t)a[i] * a[i] + t[2 * i] + c;
      t[2 * i] = (uint32_t)s;
      s = (uint64_t)t[2 * i + 1] + (s >> 32);
      t[2 * i + 1] = (uint32_t)s;
      c = s >> 32;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const uint32_t q = t[i] * N0[F];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      uint64_t s = (uint64_t)q * MOD[F][j] + t[i + j] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
#pragma unroll
    for (int k = i + 8; k < 17; k++) {
      uint64_t s = (uint64_t)t[k] + c;
      t[k] = (uint32_t)s;
      c = s >> 32;
    }
  }
  cond_sub<F>(r, t + 8, t[16]);
}

// r = (a + b) mod m
template <int F>
FDEV void mod_add(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t s[8];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    uint64_t v = (uint64_t)a[j] + b[j] + c;
    s[j] = (uint32_t)v;
    c = v >> 32;
  }
  cond_sub<F>(r, s, (uint32_t)c);
}

// r = (a - b) mod m
template <int F>
FDEV void mod_sub(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t d[8];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    uint64_t v = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  const uint32_t mask = 0u - borrow;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    uint64_t v = (uint64_t)d[j] + (MOD[F][j] & mask) + c;
    r[j] = (uint32_t)v;
    c = v >> 32;
  }
}

FDEV bool fe_is_zero(const uint32_t a[8]) {
  uint32_t acc = a[0];
#pragma unroll
  for (int j = 1; j < 8; j++) acc |= a[j];
  return acc == 0;
}

FDEV void fe_copy(uint32_t r[8], const uint32_t a[8]) {
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = a[j];
}

template <int F>
FDEV void fe_one(uint32_t r[8]) {
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = ONE[F][j];
}

FDEV void fe_zero(uint32_t r[8]) {
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = 0;
}

// ---------------------------------------------------------------------------
// Carry-chain Montgomery product (kernels B5 and B7)
//
// mont_mul above accumulates in C 64-bit integers, so each 32x32 product
// becomes a wide multiply plus separate carry adds. The product below is
// written in the hardware's carry-chain instructions instead (PTX
// mad.lo.cc / madc.hi.cc / addc.cc, after sppark's mont_t): the products
// a[j] * b[i] of even j and of odd j go to two accumulators, `even` (word k
// at 2^(32k)) and `odd` (word k at 2^(32(k+1))), so that each chain takes a
// product's low and high halves as consecutive words and every 32x32
// product costs two multiply-adds with the carries folded in. The
// Montgomery reduction is interleaved (CIOS) in the same form; after each
// step the two accumulators swap roles, and the shift by one word is folded
// into the next step's chain (madc_n_rshift). The carry out of the `odd`
// chain is dropped: its top word holds less than 2^31 because the modulus
// has two spare top bits (m < 2^254) and both operands are below m.
//
// On the device every step below is one PTX instruction and the carry flag
// is the hardware's (asm volatile keeps the instructions in order). On the
// host (no __CUDA_ARCH__) each step is emulated on C integers with the flag
// in a variable, so the same sequence can be checked with g++.
// ---------------------------------------------------------------------------

struct CarryFlag {
#ifndef __CUDA_ARCH__
  uint32_t cf = 0;
#endif
};

#ifdef __CUDA_ARCH__
#define CC_OP(name, text)                                                  \
  FDEV uint32_t name(CarryFlag&, uint32_t a, uint32_t b, uint32_t c) {     \
    uint32_t r;                                                            \
    asm volatile(text " %0, %1, %2, %3;"                                   \
                 : "=r"(r) : "r"(a), "r"(b), "r"(c));                      \
    return r;                                                              \
  }
#define CC_ADD(name, text)                                                 \
  FDEV uint32_t name(CarryFlag&, uint32_t a, uint32_t b) {                 \
    uint32_t r;                                                            \
    asm volatile(text " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));          \
    return r;                                                              \
  }
CC_OP(mad_lo_cc, "mad.lo.cc.u32")      // lo(a b) + c, carry out
CC_OP(madc_lo_cc, "madc.lo.cc.u32")    // lo(a b) + c + carry, carry out
CC_OP(madc_hi_cc, "madc.hi.cc.u32")    // hi(a b) + c + carry, carry out
CC_OP(madc_hi, "madc.hi.u32")          // hi(a b) + c + carry
CC_ADD(add_cc, "add.cc.u32")           // a + b, carry out
CC_ADD(addc_cc, "addc.cc.u32")         // a + b + carry, carry out
CC_ADD(addc, "addc.u32")               // a + b + carry
CC_ADD(sub_cc, "sub.cc.u32")           // a - b, borrow out
CC_ADD(subc_cc, "subc.cc.u32")         // a - b - borrow, borrow out
CC_ADD(subc, "subc.u32")               // a - b - borrow
#undef CC_OP
#undef CC_ADD
FDEV uint32_t mul_lo(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("mul.lo.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
FDEV uint32_t mul_hi(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("mul.hi.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
#else
FDEV uint32_t cc_out(CarryFlag& f, uint64_t s) {
  f.cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
FDEV uint32_t mad_lo_cc(CarryFlag& f, uint32_t a, uint32_t b, uint32_t c) {
  return cc_out(f, (uint64_t)(uint32_t)(a * b) + c);
}
FDEV uint32_t madc_lo_cc(CarryFlag& f, uint32_t a, uint32_t b, uint32_t c) {
  return cc_out(f, (uint64_t)(uint32_t)(a * b) + c + f.cf);
}
FDEV uint32_t madc_hi_cc(CarryFlag& f, uint32_t a, uint32_t b, uint32_t c) {
  return cc_out(f, (((uint64_t)a * b) >> 32) + c + f.cf);
}
FDEV uint32_t madc_hi(CarryFlag& f, uint32_t a, uint32_t b, uint32_t c) {
  return (uint32_t)((((uint64_t)a * b) >> 32) + c + f.cf);
}
FDEV uint32_t add_cc(CarryFlag& f, uint32_t a, uint32_t b) {
  return cc_out(f, (uint64_t)a + b);
}
FDEV uint32_t addc_cc(CarryFlag& f, uint32_t a, uint32_t b) {
  return cc_out(f, (uint64_t)a + b + f.cf);
}
FDEV uint32_t addc(CarryFlag& f, uint32_t a, uint32_t b) {
  return a + b + f.cf;
}
FDEV uint32_t sub_cc(CarryFlag& f, uint32_t a, uint32_t b) {
  const uint64_t d = (uint64_t)a - b;
  f.cf = (uint32_t)(d >> 63);
  return (uint32_t)d;
}
FDEV uint32_t subc_cc(CarryFlag& f, uint32_t a, uint32_t b) {
  const uint64_t d = (uint64_t)a - b - f.cf;
  f.cf = (uint32_t)(d >> 63);
  return (uint32_t)d;
}
FDEV uint32_t subc(CarryFlag& f, uint32_t a, uint32_t b) {
  return a - b - f.cf;
}
FDEV uint32_t mul_lo(uint32_t a, uint32_t b) { return a * b; }
FDEV uint32_t mul_hi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}
#endif

// acc[j], acc[j + 1] = lo, hi of a[j] * bi for even j (exact, no carries).
FDEV void cc_mul_n(uint32_t acc[8], const uint32_t* a, uint32_t bi) {
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    acc[j] = mul_lo(a[j], bi);
    acc[j + 1] = mul_hi(a[j], bi);
  }
}

// acc += a[even j] * bi as one chain; leaves the carry out in f.
FDEV void cc_cmad_n(CarryFlag& f, uint32_t acc[8], const uint32_t* a,
                    uint32_t bi) {
  acc[0] = mad_lo_cc(f, a[0], bi, acc[0]);
  acc[1] = madc_hi_cc(f, a[0], bi, acc[1]);
#pragma unroll
  for (int j = 2; j < 8; j += 2) {
    acc[j] = madc_lo_cc(f, a[j], bi, acc[j]);
    acc[j + 1] = madc_hi_cc(f, a[j], bi, acc[j + 1]);
  }
}

// odd = (odd >> two words) + a[even j] * bi, continuing the carry in f.
FDEV void cc_madc_n_rshift(CarryFlag& f, uint32_t odd[8], const uint32_t* a,
                           uint32_t bi) {
#pragma unroll
  for (int j = 0; j < 6; j += 2) {
    odd[j] = madc_lo_cc(f, a[j], bi, odd[j + 2]);
    odd[j + 1] = madc_hi_cc(f, a[j], bi, odd[j + 3]);
  }
  odd[6] = madc_lo_cc(f, a[6], bi, 0);
  odd[7] = madc_hi(f, a[6], bi, 0);
}

// One CIOS step: (even, odd) += a * bi, then + m * MOD with m chosen so
// that word 0 of `even` becomes 0. The caller swaps the roles of the two
// arrays for the next step.
template <int F>
FDEV void cc_mad_n_redc(uint32_t even[8], uint32_t odd[8], const uint32_t a[8],
                        uint32_t bi, bool first) {
  CarryFlag f;
  if (first) {
    cc_mul_n(odd, a + 1, bi);
    cc_mul_n(even, a, bi);
  } else {
    even[0] = add_cc(f, even[0], odd[1]);
    cc_madc_n_rshift(f, odd, a + 1, bi);
    cc_cmad_n(f, even, a, bi);
    odd[7] = addc(f, odd[7], 0);
  }
  const uint32_t mi = mul_lo(even[0], N0[F]);
  cc_cmad_n(f, odd, MOD[F] + 1, mi);
  cc_cmad_n(f, even, MOD[F], mi);
  odd[7] = addc(f, odd[7], 0);
}

// Montgomery product r = a * b * R^{-1} mod m on carry chains. Requires
// a, b < m; r may alias a or b. The same value as mont_mul.
template <int F>
FDEV void mul_cc(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t even[8], odd[8];
#pragma unroll
  for (int i = 0; i < 8; i += 2) {
    cc_mad_n_redc<F>(even, odd, a, b[i], i == 0);
    cc_mad_n_redc<F>(odd, even, a, b[i + 1], false);
  }
  // merge: even + (odd >> one word) < 2m
  CarryFlag f;
  even[0] = add_cc(f, even[0], odd[1]);
#pragma unroll
  for (int i = 1; i < 7; i++) even[i] = addc_cc(f, even[i], odd[i + 1]);
  even[7] = addc(f, even[7], 0);
  // one conditional subtraction of m
  uint32_t d[8];
  d[0] = sub_cc(f, even[0], MOD[F][0]);
#pragma unroll
  for (int j = 1; j < 8; j++) d[j] = subc_cc(f, even[j], MOD[F][j]);
  const uint32_t borrow = subc(f, 0, 0);    // all ones when even < m
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = borrow ? even[j] : d[j];
}

// Montgomery square on the same chains: the product of a with itself
// (264 multiply-add slots, where mont_sqr's SOS form needs 208: a dedicated
// square keeps a 16-word product live, which the G1 kernels' register
// budget does not hold). Requires a < m.
template <int F>
FDEV void sqr_cc(uint32_t r[8], const uint32_t a[8]) {
  mul_cc<F>(r, a, a);
}

#ifdef __CUDACC__
// 32-byte element loads and stores as two 16-byte vectors.
__device__ __forceinline__ void fe_load(uint32_t r[8], const uint32_t* p) {
  const uint4 lo = __ldg(reinterpret_cast<const uint4*>(p));
  const uint4 hi = __ldg(reinterpret_cast<const uint4*>(p) + 1);
  r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
  r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
}

__device__ __forceinline__ void fe_store(uint32_t* p, const uint32_t a[8]) {
  reinterpret_cast<uint4*>(p)[0] = make_uint4(a[0], a[1], a[2], a[3]);
  reinterpret_cast<uint4*>(p)[1] = make_uint4(a[4], a[5], a[6], a[7]);
}
#endif

}  // namespace bn254
