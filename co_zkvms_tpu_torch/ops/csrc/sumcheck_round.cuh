// The per-pair schedule of B9, the sumcheck round message (sumcheck_round.cu
// eval_kernel): the combs, the points each accumulates a pair, and the
// block-level step that turns a block's sums into its partial message.
//
// A round over tables of 2h entries restricts each table to x_0 = t,
// v(t) = v[2p] + t (v[2p+1] - v[2p]), and sums comb(restrictions) over the
// h pairs at t = 0..degree. Every restriction is built by modular adds of
// the slope, so v(1) = v[2p+1] and v(2) = 2 v(1) - v(0); every value is a
// canonical residue, which the carry-chain product (field.cuh mul_cc)
// needs of both operands.
//
// The outer comb s (a b - c) reads one split-eq suffix element s per pair,
// the same at every t, so a pair's contribution is a polynomial of degree 2
// in t, and so is any sum of them. A thread accumulates t = 0, 1, 2 (two
// products a point, 6 a pair where all four points took 8) and the block's
// t = 3 follows once, after the block sum, by the third finite difference:
// S(3) = S(0) - 3 S(1) + 3 S(2) (mod m), exact in the field, so the
// partial equals the plain version's sum at t = 3 bit for bit. The inner
// comb a b is of degree 2 itself: 3 products a pair, no finishing step.
//
// The header also compiles as host C++ (FDEV -> inline): element loads are
// then plain copies, so the schedule can be checked without nvcc.
#pragma once
#include "field.cuh"

namespace bn254 {

// The kernel's comb ids, as the C entry sc_eval_round takes them.
constexpr int kOuterComb = 0;
constexpr int kInnerComb = 1;

FDEV void sc_load(uint32_t r[8], const uint32_t* p) {
#ifdef __CUDACC__
  fe_load(r, p);
#else
  fe_copy(r, p);
#endif
}

// x <- x(2) = 2 x1 - x0 from x = x0 and x1 = x(1)
template <int F>
FDEV void sc_extend(uint32_t x[8], const uint32_t x1[8]) {
  uint32_t d[8];
  mod_sub<F>(d, x1, x);
  mod_add<F>(x, x1, d);
}

// Spartan's outer comb with the split-eq suffix: s (a b - c).
struct OuterComb {
  static constexpr int kDegree = 3;   // of the round message
  static constexpr int kPoints = 3;   // t = 0, 1, 2 accumulated a pair

  // acc[t] += s (ab - c), on the product ab of the restrictions at t
  template <int F>
  static FMEMBER void term(uint32_t acc[8], const uint32_t s[8],
                           const uint32_t ab[8], const uint32_t c[8]) {
    uint32_t g[8];
    mod_sub<F>(g, ab, c);
    mul_cc<F>(g, s, g);
    mod_add<F>(acc, acc, g);
  }

  // pair p of tables a, b, c (tstride elements apart) and suffix[p]
  template <int F>
  static FMEMBER void pair(uint32_t acc[kPoints][8], const uint32_t* tabs,
                           long long tstride, const uint32_t* suffix,
                           long long p) {
    const uint32_t* a = tabs + 16 * p;
    const uint32_t* b = a + 8 * tstride;
    const uint32_t* c = b + 8 * tstride;
    uint32_t s[8], a0[8], a1[8], b0[8], b1[8], c0[8], c1[8], ab[8];
    sc_load(s, suffix + 8 * p);
    sc_load(a0, a);
    sc_load(a1, a + 8);
    sc_load(b0, b);
    sc_load(b1, b + 8);
    sc_load(c0, c);
    sc_load(c1, c + 8);
    mul_cc<F>(ab, a1, b1);
    term<F>(acc[1], s, ab, c1);
    mul_cc<F>(ab, a0, b0);
    term<F>(acc[0], s, ab, c0);
    sc_extend<F>(a0, a1);
    sc_extend<F>(b0, b1);
    sc_extend<F>(c0, c1);
    mul_cc<F>(ab, a0, b0);
    term<F>(acc[2], s, ab, c0);
  }

  // S(3) = S(0) + 3 (S(2) - S(1)) from the block sums S(0..2)
  template <int F>
  static FMEMBER void finish(uint32_t sum[kDegree + 1][8]) {
    uint32_t d[8];
    mod_sub<F>(d, sum[2], sum[1]);
    mod_add<F>(sum[3], d, d);
    mod_add<F>(sum[3], sum[3], d);
    mod_add<F>(sum[3], sum[3], sum[0]);
  }
};

// Spartan's inner comb: a b.
struct InnerComb {
  static constexpr int kDegree = 2;
  static constexpr int kPoints = 3;

  template <int F>
  static FMEMBER void pair(uint32_t acc[kPoints][8], const uint32_t* tabs,
                           long long tstride, const uint32_t*, long long p) {
    const uint32_t* a = tabs + 16 * p;
    const uint32_t* b = a + 8 * tstride;
    uint32_t a0[8], a1[8], b0[8], b1[8], ab[8];
    sc_load(a0, a);
    sc_load(a1, a + 8);
    sc_load(b0, b);
    sc_load(b1, b + 8);
    mul_cc<F>(ab, a0, b0);
    mod_add<F>(acc[0], acc[0], ab);
    mul_cc<F>(ab, a1, b1);
    mod_add<F>(acc[1], acc[1], ab);
    sc_extend<F>(a0, a1);
    sc_extend<F>(b0, b1);
    mul_cc<F>(ab, a0, b0);
    mod_add<F>(acc[2], acc[2], ab);
  }

  template <int F>
  static FMEMBER void finish(uint32_t (*)[8]) {}
};

template <int C>
struct CombOf;
template <>
struct CombOf<kOuterComb> {
  typedef OuterComb type;
};
template <>
struct CombOf<kInnerComb> {
  typedef InnerComb type;
};

// One thread's share of a round: acc[t] = the sum over pairs p = first,
// first + step, ... < h of the comb's point t (t < kPoints).
template <int F, class Comb>
FDEV void sc_thread_pairs(uint32_t acc[][8], const uint32_t* tabs,
                          long long tstride, const uint32_t* suffix,
                          long long h, long long first, long long step) {
#pragma unroll
  for (int t = 0; t < Comb::kPoints; t++) fe_zero(acc[t]);
  for (long long p = first; p < h; p += step)
    Comb::template pair<F>(acc, tabs, tstride, suffix, p);
}

}  // namespace bn254
