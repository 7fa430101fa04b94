// BN254 G1 point formulas in Jacobian coordinates over Fq (a = 0), one point
// per thread, shared by the G1 kernels (g1.cu) and the MSM bucket kernel
// (msm_bucket.cu).
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
#pragma once
#include "field.cuh"

namespace bn254 {

constexpr int FQ_ID = 1;

struct Jac {
  uint32_t x[8], y[8], z[8];
};

FDEV void fq_mul(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  mont_mul<FQ_ID>(r, a, b);
}
FDEV void fq_sqr(uint32_t r[8], const uint32_t a[8]) { mont_sqr<FQ_ID>(r, a); }
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

// dbl-2009-l: 2M + 5S.
FDEV void jac_double(Jac& o, const Jac& p) {
  uint32_t a[8], b[8], c[8], d[8], e[8], t[8], x3[8], y3[8], z3[8];
  fq_sqr(a, p.x);
  fq_sqr(b, p.y);
  fq_sqr(c, b);
  fq_add(t, p.x, b);
  fq_sqr(t, t);
  fq_sub(t, t, a);
  fq_sub(t, t, c);
  fq_dbl(d, t);                 // d = 2((x + b)^2 - a - c)
  fq_dbl(e, a);
  fq_add(e, e, a);              // e = 3a
  fq_sqr(t, e);                 // f = e^2
  fq_dbl(x3, d);
  fq_sub(x3, t, x3);            // x3 = f - 2d
  fq_sub(t, d, x3);
  fq_mul(t, e, t);
  fq_dbl(c, c);
  fq_dbl(c, c);
  fq_dbl(c, c);                 // 8c
  fq_sub(y3, t, c);             // y3 = e (d - x3) - 8c
  fq_mul(t, p.y, p.z);
  fq_dbl(z3, t);                // z3 = 2 y z
  fe_copy(o.x, x3);
  fe_copy(o.y, y3);
  fe_copy(o.z, z3);
}

// Complete mixed addition p + (qx, qy), madd-2007-bl. o may alias p.
FDEV void jac_add_mixed(Jac& o, const Jac& p, const uint32_t qx[8],
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
  fq_sqr(z1z1, p.z);
  fq_mul(u2, qx, z1z1);
  fq_mul(t, p.z, z1z1);
  fq_mul(s2, qy, t);
  fq_sub(h, u2, p.x);
  fq_sub(r, s2, p.y);
  if (fe_is_zero(h)) {
    if (fe_is_zero(r)) {
      jac_double(o, p);
    } else {
      jac_infinity(o);
    }
    return;
  }
  uint32_t hh[8], i4[8], j[8], v[8], x3[8], y3[8], z3[8];
  fq_sqr(hh, h);
  fq_dbl(i4, hh);
  fq_dbl(i4, i4);               // i = 4 hh
  fq_mul(j, h, i4);
  fq_dbl(r, r);                 // rr = 2r
  fq_mul(v, p.x, i4);
  fq_sqr(x3, r);
  fq_sub(x3, x3, j);
  fq_dbl(t, v);
  fq_sub(x3, x3, t);            // x3 = rr^2 - j - 2v
  fq_sub(t, v, x3);
  fq_mul(y3, r, t);
  fq_mul(t, p.y, j);
  fq_dbl(t, t);
  fq_sub(y3, y3, t);            // y3 = rr (v - x3) - 2 y1 j
  fq_add(t, p.z, h);
  fq_sqr(t, t);
  fq_sub(t, t, z1z1);
  fq_sub(z3, t, hh);            // z3 = (z1 + h)^2 - z1z1 - hh
  fe_copy(o.x, x3);
  fe_copy(o.y, y3);
  fe_copy(o.z, z3);
}

// add-2007-bl without edge cases; the caller handles infinity operands.
// Returns h == 0 and r == 0 so a complete caller can branch.
FDEV void jac_add_generic(Jac& o, const Jac& p, const Jac& q, bool& h_zero,
                          bool& r_zero) {
  uint32_t z1z1[8], z2z2[8], u1[8], u2[8], s1[8], s2[8], h[8], r[8], t[8];
  fq_sqr(z1z1, p.z);
  fq_sqr(z2z2, q.z);
  fq_mul(u1, p.x, z2z2);
  fq_mul(u2, q.x, z1z1);
  fq_mul(t, q.z, z2z2);
  fq_mul(s1, p.y, t);
  fq_mul(t, p.z, z1z1);
  fq_mul(s2, q.y, t);
  fq_sub(h, u2, u1);
  fq_sub(r, s2, s1);
  h_zero = fe_is_zero(h);
  r_zero = fe_is_zero(r);
  if (h_zero) return;
  uint32_t i4[8], j[8], v[8], x3[8], y3[8], z3[8];
  fq_dbl(t, h);
  fq_sqr(i4, t);                // i = (2h)^2
  fq_mul(j, h, i4);
  fq_dbl(r, r);                 // rr = 2r
  fq_mul(v, u1, i4);
  fq_sqr(x3, r);
  fq_sub(x3, x3, j);
  fq_dbl(t, v);
  fq_sub(x3, x3, t);            // x3 = rr^2 - j - 2v
  fq_sub(t, v, x3);
  fq_mul(y3, r, t);
  fq_mul(t, s1, j);
  fq_dbl(t, t);
  fq_sub(y3, y3, t);            // y3 = rr (v - x3) - 2 s1 j
  fq_add(t, p.z, q.z);
  fq_sqr(t, t);
  fq_sub(t, t, z1z1);
  fq_sub(t, t, z2z2);
  fq_mul(z3, t, h);             // z3 = ((z1 + z2)^2 - z1z1 - z2z2) h
  fe_copy(o.x, x3);
  fe_copy(o.y, y3);
  fe_copy(o.z, z3);
}

// Complete Jacobian addition. o may alias p or q.
FDEV void jac_add(Jac& o, const Jac& p, const Jac& q) {
  if (fe_is_zero(p.z)) {
    jac_copy(o, q);
    return;
  }
  if (fe_is_zero(q.z)) {
    jac_copy(o, p);
    return;
  }
  bool h_zero, r_zero;
  Jac g;
  jac_add_generic(g, p, q, h_zero, r_zero);
  if (h_zero) {
    if (r_zero) {
      jac_double(o, p);
    } else {
      jac_infinity(o);
    }
    return;
  }
  jac_copy(o, g);
}

// Jacobian addition without the doubling path, for sums of disjoint subsets
// of fixed bases (co_zkvms_tpu/ops/curve_pallas.py:179-193): a collision
// gives h == 0 and so z3 == 0, the infinity encoding, never a wrong point.
// Infinity operands are exact. The non-edge output is the generic formula's,
// including h == 0 (x3 = rr^2, y3 = rr^3 up to the formula, z3 = 0).
FDEV void jac_add_incomplete(Jac& o, const Jac& p, const Jac& q) {
  if (fe_is_zero(p.z)) {
    jac_copy(o, q);
    return;
  }
  if (fe_is_zero(q.z)) {
    jac_copy(o, p);
    return;
  }
  uint32_t z1z1[8], z2z2[8], u1[8], u2[8], s1[8], s2[8], h[8], r[8], t[8];
  fq_sqr(z1z1, p.z);
  fq_sqr(z2z2, q.z);
  fq_mul(u1, p.x, z2z2);
  fq_mul(u2, q.x, z1z1);
  fq_mul(t, q.z, z2z2);
  fq_mul(s1, p.y, t);
  fq_mul(t, p.z, z1z1);
  fq_mul(s2, q.y, t);
  fq_sub(h, u2, u1);
  fq_sub(r, s2, s1);
  uint32_t i4[8], j[8], v[8], x3[8], y3[8], z3[8];
  fq_dbl(t, h);
  fq_sqr(i4, t);
  fq_mul(j, h, i4);
  fq_dbl(r, r);
  fq_mul(v, u1, i4);
  fq_sqr(x3, r);
  fq_sub(x3, x3, j);
  fq_dbl(t, v);
  fq_sub(x3, x3, t);
  fq_sub(t, v, x3);
  fq_mul(y3, r, t);
  fq_mul(t, s1, j);
  fq_dbl(t, t);
  fq_sub(y3, y3, t);
  fq_add(t, p.z, q.z);
  fq_sqr(t, t);
  fq_sub(t, t, z1z1);
  fq_sub(t, t, z2z2);
  fq_mul(z3, t, h);
  fe_copy(o.x, x3);
  fe_copy(o.y, y3);
  fe_copy(o.z, z3);
}

}  // namespace bn254
