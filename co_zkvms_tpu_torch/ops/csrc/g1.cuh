// BN254 G1 point formulas in Jacobian coordinates over Fq (a = 0), one point
// per thread, shared by the G1 kernels (g1.cu) and the MSM bucket kernel
// (msm_bucket.cuh, msm_bucket.cu).
//
// The formulas and edge cases are those of co_zkvms_tpu/ops/curve_pallas.py
// (_double_limbs :41, _add_mixed_kernel :57, _add_kernel :116,
// _add_incomplete_kernel :177) and of the port's plain versions in
// ops/curve.py, so a kernel's Jacobian output equals the plain version's
// bit for bit. Where the TPU computed every branch and selected, a thread
// here branches: the edge cases (infinity, p = q, p = -q) are rare, so the
// warp almost never diverges and the doubling path costs nothing when unused.
//
// Infinity: Jacobian z == 0, created as (1, 1, 0) in Montgomery form; an
// affine point is infinity when x == y == 0.
//
// The formulas are templates on the arithmetic policy of their Fq products
// and squares: CiosArith (field.cuh's mont_mul / mont_sqr in C, the default
// of the untemplated names, used by B4) or ChainArith (field.cuh's
// carry-chain product, used by B5, B6, B7 and B8). Both give the same
// canonical values, so a formula's output does not depend on the policy.
#pragma once
#include "field.cuh"

namespace bn254 {

constexpr int FQ_ID = 1;

struct Jac {
  uint32_t x[8], y[8], z[8];
};

struct CiosArith {
  static FMEMBER void mul(uint32_t r[8], const uint32_t a[8],
                          const uint32_t b[8]) {
    mont_mul<FQ_ID>(r, a, b);
  }
  static FMEMBER void sqr(uint32_t r[8], const uint32_t a[8]) {
    mont_sqr<FQ_ID>(r, a);
  }
};

struct ChainArith {
  static FMEMBER void mul(uint32_t r[8], const uint32_t a[8],
                          const uint32_t b[8]) {
    mul_cc<FQ_ID>(r, a, b);
  }
  static FMEMBER void sqr(uint32_t r[8], const uint32_t a[8]) {
    sqr_cc<FQ_ID>(r, a);
  }
};

FDEV void fq_add(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  mod_add<FQ_ID>(r, a, b);
}
FDEV void fq_sub(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  mod_sub<FQ_ID>(r, a, b);
}
FDEV void fq_dbl(uint32_t r[8], const uint32_t a[8]) { mod_add<FQ_ID>(r, a, a); }

FDEV void jac_infinity(Jac& o) {
  fe_one<FQ_ID>(o.x);
  fe_one<FQ_ID>(o.y);
  fe_zero(o.z);
}

FDEV void jac_copy(Jac& o, const Jac& p) {
  fe_copy(o.x, p.x);
  fe_copy(o.y, p.y);
  fe_copy(o.z, p.z);
}

// dbl-2009-l: 2M + 5S. o may alias p (every read of p comes before the
// writes to o).
template <class Ar>
FDEV void jac_double_t(Jac& o, const Jac& p) {
  uint32_t a[8], b[8], c[8], d[8], e[8], t[8], x3[8], y3[8], z3[8];
  Ar::sqr(a, p.x);
  Ar::sqr(b, p.y);
  Ar::sqr(c, b);
  fq_add(t, p.x, b);
  Ar::sqr(t, t);
  fq_sub(t, t, a);
  fq_sub(t, t, c);
  fq_dbl(d, t);                 // d = 2((x + b)^2 - a - c)
  fq_dbl(e, a);
  fq_add(e, e, a);              // e = 3a
  Ar::sqr(t, e);                 // f = e^2
  fq_dbl(x3, d);
  fq_sub(x3, t, x3);            // x3 = f - 2d
  fq_sub(t, d, x3);
  Ar::mul(t, e, t);
  fq_dbl(c, c);
  fq_dbl(c, c);
  fq_dbl(c, c);                 // 8c
  fq_sub(y3, t, c);             // y3 = e (d - x3) - 8c
  Ar::mul(t, p.y, p.z);
  fq_dbl(z3, t);                // z3 = 2 y z
  fe_copy(o.x, x3);
  fe_copy(o.y, y3);
  fe_copy(o.z, z3);
}

// Complete mixed addition p + (qx, qy), madd-2007-bl. o may alias p.
template <class Ar>
FDEV void jac_add_mixed_t(Jac& o, const Jac& p, const uint32_t qx[8],
                          const uint32_t qy[8]) {
  const bool q_inf = fe_is_zero(qx) && fe_is_zero(qy);
  if (fe_is_zero(p.z)) {        // from_affine(q)
    if (q_inf) {
      jac_infinity(o);
    } else {
      fe_copy(o.x, qx);
      fe_copy(o.y, qy);
      fe_one<FQ_ID>(o.z);
    }
    return;
  }
  if (q_inf) {
    jac_copy(o, p);
    return;
  }
  uint32_t z1z1[8], u2[8], s2[8], h[8], r[8], t[8];
  Ar::sqr(z1z1, p.z);
  Ar::mul(u2, qx, z1z1);
  Ar::mul(t, p.z, z1z1);
  Ar::mul(s2, qy, t);
  fq_sub(h, u2, p.x);
  fq_sub(r, s2, p.y);
  if (fe_is_zero(h)) {
    if (fe_is_zero(r)) {
      jac_double_t<Ar>(o, p);
    } else {
      jac_infinity(o);
    }
    return;
  }
  uint32_t hh[8], i4[8], j[8], v[8], x3[8], y3[8], z3[8];
  Ar::sqr(hh, h);
  fq_dbl(i4, hh);
  fq_dbl(i4, i4);               // i = 4 hh
  Ar::mul(j, h, i4);
  fq_dbl(r, r);                 // rr = 2r
  Ar::mul(v, p.x, i4);
  Ar::sqr(x3, r);
  fq_sub(x3, x3, j);
  fq_dbl(t, v);
  fq_sub(x3, x3, t);            // x3 = rr^2 - j - 2v
  fq_sub(t, v, x3);
  Ar::mul(y3, r, t);
  Ar::mul(t, p.y, j);
  fq_dbl(t, t);
  fq_sub(y3, y3, t);            // y3 = rr (v - x3) - 2 y1 j
  fq_add(t, p.z, h);
  Ar::sqr(t, t);
  fq_sub(t, t, z1z1);
  fq_sub(z3, t, hh);            // z3 = (z1 + h)^2 - z1z1 - hh
  fe_copy(o.x, x3);
  fe_copy(o.y, y3);
  fe_copy(o.z, z3);
}

// add-2007-bl up to h = u2 - u1 and r = s2 - s1, ordered so that each input
// coordinate dies at its last use: zz = (z1 + z2)^2 - z1z1 - z2z2, z3's
// other factor, comes first, so that z1 and z2 die with their cubes.
template <class Ar>
FDEV void jac_add_hr(const Jac& p, const Jac& q, uint32_t u1[8],
                     uint32_t s1[8], uint32_t h[8], uint32_t r[8],
                     uint32_t zz[8]) {
  uint32_t z1z1[8], z2z2[8], t[8];
  Ar::sqr(z1z1, p.z);
  Ar::sqr(z2z2, q.z);
  fq_add(t, p.z, q.z);
  Ar::sqr(t, t);
  fq_sub(t, t, z1z1);
  fq_sub(zz, t, z2z2);
  Ar::mul(t, q.z, z2z2);
  Ar::mul(s1, p.y, t);           // s1 = y1 z2^3
  Ar::mul(u1, p.x, z2z2);        // u1 = x1 z2^2
  Ar::mul(t, p.z, z1z1);
  Ar::mul(t, q.y, t);            // s2 = y2 z1^3
  fq_sub(r, t, s1);
  Ar::mul(t, q.x, z1z1);         // u2 = x2 z1^2
  fq_sub(h, t, u1);
}

// The rest of add-2007-bl from u1, s1, h, r and zz: o may alias anything.
template <class Ar>
FDEV void jac_add_finish(Jac& o, const uint32_t u1[8], const uint32_t s1[8],
                         const uint32_t h[8], const uint32_t r[8],
                         const uint32_t zz[8]) {
  uint32_t i4[8], j[8], v[8], rr[8], t[8];
  fq_dbl(t, h);
  Ar::sqr(i4, t);                // i = (2h)^2
  Ar::mul(j, h, i4);
  Ar::mul(o.z, zz, h);           // z3 = ((z1 + z2)^2 - z1z1 - z2z2) h
  Ar::mul(v, u1, i4);
  fq_dbl(rr, r);                 // rr = 2r
  Ar::sqr(t, rr);
  fq_sub(t, t, j);
  fq_dbl(o.x, v);
  fq_sub(o.x, t, o.x);           // x3 = rr^2 - j - 2v
  fq_sub(t, v, o.x);
  Ar::mul(t, rr, t);
  Ar::mul(v, s1, j);
  fq_dbl(v, v);
  fq_sub(o.y, t, v);             // y3 = rr (v - x3) - 2 s1 j
}

// Complete Jacobian addition except for p == q: returns false there (h == 0
// and r == 0) and leaves o as it was, so that the caller doubles p. o may
// alias p or q otherwise. With jac_double_t on the `false` branch it is the
// complete add; a caller that can read p again from memory (B5) then need
// not keep p in registers until h and r are known.
template <class Ar>
FDEV bool jac_add_unless_equal(Jac& o, const Jac& p, const Jac& q) {
  if (fe_is_zero(p.z)) {
    jac_copy(o, q);
    return true;
  }
  if (fe_is_zero(q.z)) {
    jac_copy(o, p);
    return true;
  }
  uint32_t u1[8], s1[8], h[8], r[8], zz[8];
  jac_add_hr<Ar>(p, q, u1, s1, h, r, zz);
  if (fe_is_zero(h)) {
    if (fe_is_zero(r)) return false;
    jac_infinity(o);
    return true;
  }
  jac_add_finish<Ar>(o, u1, s1, h, r, zz);
  return true;
}

// Jacobian addition without the doubling path, for sums of disjoint subsets
// of fixed bases (co_zkvms_tpu/ops/curve_pallas.py:179-193): a collision
// gives h == 0 and so z3 == 0, the infinity encoding, never a wrong point.
// Infinity operands are exact. The non-edge output is the generic formula's,
// including h == 0 (x3 = rr^2, y3 = rr^3 up to the formula, z3 = 0).
template <class Ar>
FDEV void jac_add_incomplete_t(Jac& o, const Jac& p, const Jac& q) {
  if (fe_is_zero(p.z)) {
    jac_copy(o, q);
    return;
  }
  if (fe_is_zero(q.z)) {
    jac_copy(o, p);
    return;
  }
  uint32_t u1[8], s1[8], h[8], r[8], zz[8];
  jac_add_hr<Ar>(p, q, u1, s1, h, r, zz);
  jac_add_finish<Ar>(o, u1, s1, h, r, zz);
}

// p <- 2^times p by `times` doublings in place (B6), times >= 1.
template <class Ar>
FDEV void jac_double_times(Jac& p, int times) {
#pragma unroll 1
  for (int k = 0; k < times; k++) jac_double_t<Ar>(p, p);
}

// The untemplated name keeps mont_mul / mont_sqr (B4).
FDEV void jac_add_mixed(Jac& o, const Jac& p, const uint32_t qx[8],
                        const uint32_t qy[8]) {
  jac_add_mixed_t<CiosArith>(o, p, qx, qy);
}

}  // namespace bn254
