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
#define FCONST static __constant__ const
#else
#define FDEV static inline
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
