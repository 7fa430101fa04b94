"""PST13 multilinear polynomial commitments over BN254.

commit = one MSM of the evaluation table against Lagrange-basis SRS points;
open at r = the quotient ladder

    f(x) - f(r) = sum_k (x_k - r_k) * q_k(x_{k+1..}),
    q_k = t_k(1, rest) - t_k(0, rest),   t_{k+1} = bind_low(t_k, r_k)

with one shrinking MSM per level, all through one ``msm_batch_ints``.
Verification is the pairing product check

    e(C - v*G, H) = prod_k e(pi_k, H^{tau_k - r_k})

on the host with the pure-Python pairing. Commitments and proofs cross the
host boundary as (x, y) int pairs, as in the JAX package's ``ops/pst13.py``.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import torch

from . import curve as C
from . import field as F
from . import msm as M
from . import poly as P
from . import ref_bn254 as bn
from .curve import APoint
from .field import FR
from ..utils import build


class SRS(NamedTuple):
    nv: int
    ck_levels: tuple          # APoint batches; level k has 2^(nv-k) points
    h_taus: tuple             # G2 points h^{tau_k}, k = 0..nv-1

    def level(self, k: int) -> APoint:
        return self.ck_levels[k]


class Commitment(NamedTuple):
    xy: tuple                 # (x, y) ints; (0, 0) = infinity

    def point(self):
        return bn.g1_from_coords(self.xy)


class OpeningProof(NamedTuple):
    pis: tuple                # nv (x, y) int pairs


def setup(nv: int, seed: int = 0, device="cuda") -> SRS:
    """SRS for nv variables, deterministic from ``seed`` (test and bench
    setup only: tau is derived from the seed). All levels' points come
    from one fixed-base MSM of the generator."""
    device = build.resolve_device(device)
    # the trapdoor: the JAX package's sha256 derivation, so both packages
    # build the same SRS from the same (nv, seed)
    taus = []
    for k in range(nv):
        d = hashlib.sha256(f"co_zkvms_tpu/pst13/{seed}/{k}".encode()).digest()
        taus.append(int.from_bytes(d, "little") % FR.modulus)
    g = C.points_from_ints([bn.g1_coords(bn.G1_GEN)], device=device)
    tables = [P.eq_table(FR, F.from_int(FR, taus[k:], device=device))
              for k in range(nv)]
    tables.append(F.ones_mont(FR, (1,), device))
    sizes = [t.shape[0] for t in tables]
    pts = C.to_affine(M.fixed_base_msm(APoint(g.x[0], g.y[0]),
                                       torch.cat(tables)))
    levels, off = [], 0
    for s in sizes:
        levels.append(APoint(pts.x[off:off + s], pts.y[off:off + s]))
        off += s
    h_taus = tuple(bn.scalar_mul(bn.G2_GEN, t) for t in taus)
    return SRS(nv=nv, ck_levels=tuple(levels), h_taus=h_taus)


def commit(srs: SRS, evals) -> Commitment:
    """Commit to an MLE table [2^nv', 8], nv' <= srs.nv, against level
    srs.nv - nv' (points g^{eq(tau_{nv-nv':}, i)})."""
    nv = evals.shape[0].bit_length() - 1
    res = C.to_affine(M.msm(srs.level(srs.nv - nv), evals))
    return Commitment(xy=C.points_to_ints(res)[0])


def open_at(srs: SRS, evals, point_mont) -> tuple:
    """Open the MLE at ``point_mont`` [nv', 8]. Returns (value_int, proof).

    Each level's quotient depends only on the bound table, so all nv
    quotient MSMs go through one ``msm_batch_ints``."""
    nv = evals.shape[0].bit_length() - 1
    base = srs.nv - nv
    t = evals
    jobs = []
    for k in range(nv):
        q = F.sub(FR, t[1::2], t[0::2])
        jobs.append((srs.level(base + k + 1), q))
        t = P.bind_low(FR, t, point_mont[k])
    pis = M.msm_batch_ints(jobs)
    value = int(F.to_int(FR, t[0]))
    return value, OpeningProof(pis=tuple(pis))


def commit_batch(srs: SRS, tables) -> list:
    """Commit many MLE tables, their window sums through one
    ``msm_batch_ints``; the same points as one ``commit`` each."""
    jobs = [(srs.level(srs.nv - (t.shape[0].bit_length() - 1)), t)
            for t in tables]
    return [Commitment(xy=xy) for xy in M.msm_batch_ints(jobs)]


def verify(srs: SRS, comm: Commitment, point_ints, value: int,
           proof: OpeningProof) -> bool:
    """Pairing product check (host). ``point_ints``: list of nv' ints."""
    nv = len(point_ints)
    base = srs.nv - nv
    c_pt = comm.point()
    g = bn.G1_GEN
    lhs = bn.add(c_pt, bn.neg_pt(bn.scalar_mul(g, value)))  # C - vG
    pairs = [(bn.neg_pt(lhs), bn.G2_GEN)] if lhs is not None else []
    for k in range(nv):
        pi = bn.g1_from_coords(proof.pis[k])
        if pi is None:
            continue
        h_exp = bn.add(
            srs.h_taus[base + k],
            bn.neg_pt(bn.scalar_mul(bn.G2_GEN, point_ints[k])),
        )  # h^(tau_k - r_k)
        if h_exp is None:
            continue
        pairs.append((pi, h_exp))
    return bn.multi_pairing_is_one(pairs)


# --- batched opening (eta-RLC aggregation) ---------------------------------


def aggregate_evals_ints(eta: int, vals) -> int:
    """sum_i eta^i vals[i] mod r (Horner from the last value)."""
    acc = 0
    for v in reversed(list(vals)):
        acc = (acc * eta + v) % FR.modulus
    return acc


def aggregate_comms(eta: int, comms) -> Commitment:
    """sum_i eta^i C_i on the host."""
    acc = None
    for i, cm in enumerate(comms):
        acc = bn.add(acc, bn.scalar_mul(cm.point(), pow(eta, i, FR.modulus)))
    return Commitment(xy=bn.g1_coords(acc))


def batch_open(srs: SRS, tables, eta_mont, point_mont):
    """Open sum_i eta^i table_i at one point with a single proof."""
    etas = [F.ones_mont(FR, (), eta_mont.device)]
    for _ in range(len(tables) - 1):
        etas.append(F.mul(FR, etas[-1], eta_mont))
    agg = P.linear_combination(FR, torch.stack(etas), tables)
    return open_at(srs, agg, point_mont)


def batch_verify(srs: SRS, comms, evals_ints, eta: int, point_ints,
                 value: int, proof) -> bool:
    if value != aggregate_evals_ints(eta, evals_ints):
        return False
    return verify(srs, aggregate_comms(eta, comms), point_ints, value, proof)
