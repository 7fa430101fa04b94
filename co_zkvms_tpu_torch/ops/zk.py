"""Zero-knowledge machinery: mask polynomials, mask commitments, hiding PST13.

A copy of the JAX package's ``ops/zk.py`` over the port's ``ref_bn254``:

- ``generate_mask``: per-variable univariate mask polynomials g(x) =
  sum_var u_var(x_var), folded into sumcheck round messages by the engine
  (``ops/sumcheck.py`` ``zk_mask``);
- mask commitments: univariate KZG per variable over a beta-power basis that
  shares the trusted-setup seed with the PST13 SRS;
- hiding PST13: commitments carry a Pedersen blinder r g^beta and every
  opening quotient is re-randomized with s_k g^beta plus one compensating
  element pi_beta = (r - sum_k s_k (tau_k - z_k)) g, computed from the SRS's
  g^{tau_k} points.

All of it is host EC on Python ints (nv (degree + 1) scalar products per
mask, a handful per opening); only the mask coefficients go to the device,
for the engine. The host ``random.Random`` stream is consumed in the JAX
package's order, so a zk proof with the same seed is bit-identical.
"""

from __future__ import annotations

import hashlib
import random
from typing import NamedTuple

from . import field as F
from . import pst13
from . import ref_bn254 as bn
from .field import FR

MOD = FR.modulus


class ZkParams(NamedTuple):
    nv: int
    max_deg: int
    g_taus: tuple           # [nv] host G1 points g^{tau_k}
    g_beta_pows: tuple      # [max_deg+1] host G1 points g^{beta^i}
    h_beta: object          # G2 point h^{beta}
    beta_seeded: int        # seeded setup only: the trapdoor beta


def _seed_scalar(tag: str) -> int:
    d = hashlib.sha256(tag.encode()).digest()
    return int.from_bytes(d, "little") % MOD


def from_seed(nv: int, seed: int = 0, max_deg: int = 8) -> ZkParams:
    """zk params from the SAME seed as ``pst13.setup`` (shared trapdoor tau,
    fresh beta)."""
    taus = [_seed_scalar(f"co_zkvms_tpu/pst13/{seed}/{k}") for k in range(nv)]
    beta = _seed_scalar(f"co_zkvms_tpu/zk_beta/{seed}")
    g_taus = tuple(bn.scalar_mul(bn.G1_GEN, t) for t in taus)
    pows = []
    b = 1
    for _ in range(max_deg + 1):
        pows.append(bn.scalar_mul(bn.G1_GEN, b))
        b = b * beta % MOD
    h_beta = bn.scalar_mul(bn.G2_GEN, beta)
    return ZkParams(nv=nv, max_deg=max_deg, g_taus=g_taus,
                    g_beta_pows=tuple(pows), h_beta=h_beta,
                    beta_seeded=beta)


# --- mask polynomial (zk sumcheck) ------------------------------------------


def generate_mask(rng: random.Random, nv: int, degree: int, device="cuda"):
    """Random per-variable univariates; returns (coeffs_ints [nv][d+1],
    Montgomery tensor [nv, d+1, 8] on ``device``)."""
    coeffs = [[rng.randrange(MOD) for _ in range(degree + 1)]
              for _ in range(nv)]
    dev = F.from_int(FR, coeffs, device=device)
    return coeffs, dev


def mask_sum_ints(coeffs) -> int:
    """sum of g over the hypercube: 2^(nv-1) * sum_var (u(0) + u(1))."""
    nv = len(coeffs)
    tot = 0
    for row in coeffs:
        u0 = row[0]
        u1 = sum(row) % MOD
        tot = (tot + u0 + u1) % MOD
    return tot * pow(2, nv - 1, MOD) % MOD


def mask_eval_ints(coeffs, point) -> int:
    """g(z) = sum_var u_var(z_var)."""
    tot = 0
    for row, z in zip(coeffs, point):
        acc = 0
        for c in reversed(row):
            acc = (acc * z + c) % MOD
        tot = (tot + acc) % MOD
    return tot


def commit_mask(params: ZkParams, coeffs):
    """Per-variable univariate KZG commitments C_var = sum_i c_i g^{beta^i};
    [nv] host (x, y) int tuples."""
    out = []
    for row in coeffs:
        acc = None
        for c, p in zip(row, params.g_beta_pows):
            acc = bn.add(acc, bn.scalar_mul(p, c))
        out.append(bn.g1_coords(acc))
    return out


def open_mask(params: ZkParams, coeffs, point):
    """Open every u_var at z_var: values [nv] + KZG quotient proofs [nv]."""
    vals, proofs = [], []
    for row, z in zip(coeffs, point):
        # synthetic division: u(X) - u(z) = (X - z) q(X)
        d = len(row) - 1
        q = [0] * d
        acc = row[d]
        for i in range(d - 1, -1, -1):
            q[i] = acc
            acc = (acc * z + row[i]) % MOD
        vals.append(acc)
        pi = None
        for c, p in zip(q, params.g_beta_pows):
            pi = bn.add(pi, bn.scalar_mul(p, c))
        proofs.append(bn.g1_coords(pi))
    return vals, proofs


def verify_mask(params: ZkParams, comms, point, vals, proofs) -> bool:
    """Per-variable KZG check e(C - v g, h) == e(pi, h^beta - z h)."""
    for cm, z, v, pi in zip(comms, point, vals, proofs):
        lhs = bn.add(bn.g1_from_coords(cm),
                     bn.neg_pt(bn.scalar_mul(bn.G1_GEN, v % MOD)))
        rhs_g2 = bn.add(params.h_beta,
                        bn.neg_pt(bn.scalar_mul(bn.G2_GEN, z % MOD)))
        pairs = []
        if lhs is not None:
            pairs.append((bn.neg_pt(lhs), bn.G2_GEN))
        pi_pt = bn.g1_from_coords(pi)
        if pi_pt is not None and rhs_g2 is not None:
            pairs.append((pi_pt, rhs_g2))
        if not bn.multi_pairing_is_one(pairs):
            return False
    return True


# --- hiding PST13 -------------------------------------------------------------


class HidingProof(NamedTuple):
    pis: tuple              # [nv] (x, y) blinded quotient commitments
    pi_beta: tuple          # (x, y) compensation element


def hide_commitment(params: ZkParams, comm: pst13.Commitment, blinder: int):
    """C' = C + blinder * g^beta, on an already-combined commitment: the
    Rep3 path hides the G1 sum of the party commitments without any party
    holding the value."""
    pt = bn.add(bn.g1_from_coords(comm.xy),
                bn.scalar_mul(params.g_beta_pows[1], blinder % MOD))
    return pst13.Commitment(xy=bn.g1_coords(pt))


def hide_commit(srs: pst13.SRS, params: ZkParams, table, blinder: int):
    """C' = PST13(table) + blinder * g^beta: perfectly hiding."""
    return hide_commitment(params, pst13.commit(srs, table), blinder)


def hide_proof(srs: pst13.SRS, params: ZkParams, base_proof, z_ints,
               blinder: int, rng: random.Random) -> HidingProof:
    """Re-randomize a base PST13 opening proof: each quotient commitment
    gains s_k g^beta and pi_beta = (blinder - sum_k s_k (tau_k - z_k)) g,
    in the exponent from the SRS's g^{tau_k} points. Composes with proofs
    that are G1 sums of party proof shares."""
    nv = len(base_proof.pis)
    lvl = srs.nv - nv          # same level convention as pst13.verify
    ss = [rng.randrange(MOD) for _ in range(nv)]
    pis = []
    for k in range(nv):
        pt = bn.add(bn.g1_from_coords(base_proof.pis[k]),
                    bn.scalar_mul(params.g_beta_pows[1], ss[k]))
        pis.append(bn.g1_coords(pt))
    acc = bn.scalar_mul(bn.G1_GEN, blinder % MOD)
    for k in range(nv):
        # - s_k * (g^{tau_(lvl+k)} - z_k g)
        term = bn.add(params.g_taus[lvl + k],
                      bn.neg_pt(bn.scalar_mul(bn.G1_GEN, z_ints[k])))
        acc = bn.add(acc, bn.neg_pt(bn.scalar_mul(term, ss[k])))
    return HidingProof(pis=tuple(pis), pi_beta=bn.g1_coords(acc))


def hide_open(srs: pst13.SRS, params: ZkParams, table, point_mont,
              blinder: int, rng: random.Random):
    """Blinded opening of a plaintext table (single-party path)."""
    value, base_proof = pst13.open_at(srs, table, point_mont)
    z_ints = [int(v) for v in F.to_int(FR, point_mont)]
    return value, hide_proof(srs, params, base_proof, z_ints, blinder, rng)


def hide_check(srs: pst13.SRS, params: ZkParams, comm: pst13.Commitment,
               point_ints, value: int, proof: HidingProof) -> bool:
    """e(C' - v g, h) == prod_k e(pi'_k, h^{tau_k - z_k}) * e(pi_b, h^beta).

    The base nv may be smaller than srs.nv (same level convention as
    pst13.verify)."""
    nv = len(point_ints)
    base = srs.nv - nv
    lhs = bn.add(bn.g1_from_coords(comm.xy),
                 bn.neg_pt(bn.scalar_mul(bn.G1_GEN, value % MOD)))
    pairs = []
    if lhs is not None:
        pairs.append((bn.neg_pt(lhs), bn.G2_GEN))
    for k, z in enumerate(point_ints):
        pi = bn.g1_from_coords(proof.pis[k])
        if pi is None:
            continue
        g2 = bn.add(srs.h_taus[base + k],
                    bn.neg_pt(bn.scalar_mul(bn.G2_GEN, z % MOD)))
        if g2 is None:
            continue
        pairs.append((pi, g2))
    pib = bn.g1_from_coords(proof.pi_beta)
    if pib is not None:
        pairs.append((pib, params.h_beta))
    return bn.multi_pairing_is_one(pairs)
