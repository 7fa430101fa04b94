"""PST13 over Rep3 share stacks: per-party commit/open with G1 merges.

A copy of the JAX package's ``models/mpc_pcs.py``: the commitment of a
shared table is the G1 sum of the three party commitments (the MSMs run on
the B8 path), and an opening sums the party proofs pointwise. Used by
co_spartan.
"""

from __future__ import annotations

import torch

from ..ops import field as F
from ..ops import msm as M
from ..ops import poly as P
from ..ops import pst13
from ..ops import ref_bn254 as bn
from ..ops.field import FR

MOD = FR.modulus


def commit_shares(srs: pst13.SRS, stack) -> pst13.Commitment:
    """Commit each party's share [3, n, 8]; the G1 sum commits the value."""
    return commit_shares_batch(srs, [stack])[0]


def commit_shares_batch(srs: pst13.SRS, stacks) -> list:
    """Every party MSM of every stack through one ``msm_batch_ints``; the
    three party points of each stack sum on the host."""
    jobs = []
    for st in stacks:
        nv = st.shape[1].bit_length() - 1
        lvl = srs.level(srs.nv - nv)
        jobs.extend((lvl, st[p]) for p in range(3))
    coords = M.msm_batch_ints(jobs)
    out = []
    for i in range(len(stacks)):
        acc = None
        for p in range(3):
            acc = bn.add(acc, bn.g1_from_coords(coords[3 * i + p]))
        out.append(pst13.Commitment(xy=bn.g1_coords(acc)))
    return out


def _sum_openings(openings):
    """(value, proof) per party -> the opened value and the summed proof."""
    value = sum(v for v, _ in openings) % MOD
    nv = len(openings[0][1].pis)
    pis = []
    for k in range(nv):
        acc = None
        for _, pr in openings:
            acc = bn.add(acc, bn.g1_from_coords(pr.pis[k]))
        pis.append(bn.g1_coords(acc))
    return value, pst13.OpeningProof(pis=tuple(pis))


def open_shares(srs: pst13.SRS, stack, point):
    """Per-party PST13 openings; values and proof points sum across
    parties."""
    return _sum_openings([pst13.open_at(srs, stack[p], point)
                          for p in range(3)])


def batch_open_shares(srs: pst13.SRS, stacks, eta_mont, point):
    """eta-RLC batch opening over share stacks (sums the per-party
    proofs)."""
    etas = [F.ones_mont(FR, (), eta_mont.device)]
    for _ in range(len(stacks) - 1):
        etas.append(F.mul(FR, etas[-1], eta_mont))
    coeffs = torch.stack(etas)
    return _sum_openings([
        pst13.open_at(srs, P.linear_combination(FR, coeffs,
                                                [s[p] for s in stacks]), point)
        for p in range(3)])
