"""Spartan R1CS SNARK, single party: prover on the card and host verifier.

Protocol (the non-zk, non-dfs branch of the JAX package's
``models/spartan.py``):

  1. commit the witness MLE w (PST13); absorb; squeeze tau [nv].
  2. sumcheck 1 (deg 3, split-eq): 0 = sum_x eq(tau,x) (Az(x) Bz(x) - Cz(x))
     -> r_x, claims va, vb, vc.
  3. squeeze ra, rb, rc; sumcheck 2 (deg 2) over y of M_rx(y) z(y), where
     M_rx(y) = sum_m r_m M_m(r_x, y); claimed sum ra va + rb vb + rc vc.
  4. -> r_y; open w(r_y) (PST13), send val_m = M_rx(r_y).
  5. the verifier recomputes M(r_x, r_y) from the sparse matrices.

The transcript runs on the host; its bytes equal the JAX prover's, so a
proof of the same statement with the same SRS equals the JAX proof field by
field.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import field as F
from ..ops import poly as P
from ..ops import pst13
from ..ops import sumcheck as SC
from ..ops import transcript as T
from ..ops.field import FR
from ..utils import build
from ..utils.phases import phase
from .r1cs import R1CS, DeviceMatrix, _eq_table_ints

MOD = FR.modulus
LABEL = b"co_zkvms_tpu/spartan/v1"


class SpartanProof(NamedTuple):
    w_commitment: tuple         # (x, y) ints
    sumcheck1_msgs: list        # [nv][4] ints
    va: int
    vb: int
    vc: int
    sumcheck2_msgs: list        # [nv][3] ints
    w_eval: int
    val_m: int
    w_proof: pst13.OpeningProof


class SpartanIndex(NamedTuple):
    """Prover/verifier key: lowered matrices and dimensions."""

    r1cs: R1CS
    nv: int
    da: DeviceMatrix
    db: DeviceMatrix
    dc: DeviceMatrix

    @classmethod
    def from_r1cs(cls, r1cs: R1CS, device="cuda"):
        device = build.resolve_device(device)
        n = 1 << r1cs.nv
        with phase("index"):
            return cls(
                r1cs=r1cs,
                nv=r1cs.nv,
                da=DeviceMatrix.from_sparse(r1cs.a, n, n, device),
                db=DeviceMatrix.from_sparse(r1cs.b, n, n, device),
                dc=DeviceMatrix.from_sparse(r1cs.c, n, n, device),
            )


def _comb1(polys):
    eq, az, bz, cz = polys
    return F.mul(FR, eq, F.sub(FR, F.mul(FR, az, bz), cz))


def _comb2(polys):
    return F.mul(FR, polys[0], polys[1])


def prove(index: SpartanIndex, srs: pst13.SRS, z_ints) -> SpartanProof:
    """Prove knowledge of a satisfying z. ``z_ints``: the full wire
    assignment (unpadded). The io region is public; only the w region is
    committed. Runs on the device of ``index``."""
    with phase("prove"):
        return _prove(index, srs, z_ints)


def _prove(index, srs, z_ints):
    r1cs = index.r1cs
    nv = index.nv
    device = index.da.vals.device
    with phase("tables"):
        zp = r1cs.pad_z(z_ints)
        _, w_ints = r1cs.split_io_w(zp)
        z_table = F.from_int(FR, zp, device=device)
        w_table = F.from_int(FR, w_ints, device=device)

    with phase("commit"):
        w_comm = pst13.commit(srs, w_table)
    ht = T.HostTranscript(LABEL)
    ht.absorb_point(w_comm.xy)
    taus = F.from_int(FR, ht.challenges(nv), device=device)

    with phase("Az, Bz, Cz"):
        az = index.da.mul_vec(z_table)
        bz = index.db.mul_vec(z_table)
        cz = index.dc.mul_vec(z_table)
    with phase("sumcheck 1"):
        res1 = SC.prove(FR, ht, [az, bz, cz], degree=3, comb=_comb1,
                        eq_split=taus)
        va, vb, vc = (int(v) for v in F.to_int(
            FR, torch.cat(res1.final_polys, dim=0)))

    ht.absorb_many([va, vb, vc])
    rabc = F.from_int(FR, ht.challenges(3), device=device)
    with phase("M_rx"):
        eq_rx = P.eq_table(FR, res1.challenges)
        m_rx = index.da.weighted_col_table(F.mul(FR, eq_rx, rabc[0]))
        m_rx = F.add(FR, m_rx, index.db.weighted_col_table(
            F.mul(FR, eq_rx, rabc[1])))
        m_rx = F.add(FR, m_rx, index.dc.weighted_col_table(
            F.mul(FR, eq_rx, rabc[2])))

    with phase("sumcheck 2"):
        res2 = SC.prove(FR, ht, [m_rx, z_table], degree=2, comb=_comb2)
        val_m = int(F.to_int(FR, res2.final_polys[0][0]))
    with phase("open"):
        w_eval, w_proof = pst13.open_at(srs, w_table, res2.challenges)

    return SpartanProof(
        w_commitment=w_comm.xy,
        sumcheck1_msgs=res1.round_msgs,
        va=va,
        vb=vb,
        vc=vc,
        sumcheck2_msgs=res2.round_msgs,
        w_eval=w_eval,
        val_m=val_m,
        w_proof=w_proof,
    )


def _eq_eval_ints(r, s):
    acc = 1
    for a, b in zip(r, s):
        acc = acc * (a * b + (1 - a) * (1 - b)) % MOD
    return acc


def verify(index: SpartanIndex, srs: pst13.SRS, public_inputs,
           proof: SpartanProof) -> bool:
    """Host verifier (Python ints). ``public_inputs``: io values WITHOUT the
    leading constant-1 wire. Reads only ``index.r1cs``, ``index.nv`` and the
    SRS's G2 points."""
    r1cs = index.r1cs
    nv = index.nv
    try:
        ht = T.HostTranscript(LABEL)
        ht.absorb_point(proof.w_commitment)
        taus = ht.challenges(nv)

        rx, expected1 = SC.verify(proof.sumcheck1_msgs, 0, ht)
        eq_tau_rx = _eq_eval_ints(taus, rx)
        want1 = (proof.va * proof.vb - proof.vc) % MOD * eq_tau_rx % MOD
        if expected1 != want1:
            return False

        ht.absorb_many([proof.va, proof.vb, proof.vc])
        ra, rb, rc = ht.challenges(3)
        claim2 = (ra * proof.va + rb * proof.vb + rc * proof.vc) % MOD
        ry, expected2 = SC.verify(proof.sumcheck2_msgs, claim2, ht)

        # z(ry) = io(ry) + w(ry)
        eq_ry = _eq_table_ints(ry)
        io_vals = [1] + [int(v) % MOD for v in public_inputs]
        io_eval = sum(v * eq_ry[i] for i, v in enumerate(io_vals)) % MOD
        z_ry = (io_eval + proof.w_eval) % MOD
        if expected2 != proof.val_m * z_ry % MOD:
            return False

        if not pst13.verify(srs, pst13.Commitment(proof.w_commitment), ry,
                            proof.w_eval, proof.w_proof):
            return False

        val = (
            ra * r1cs.a.eval_mle(rx, ry)
            + rb * r1cs.b.eval_mle(rx, ry)
            + rc * r1cs.c.eval_mle(rx, ry)
        ) % MOD
        return val == proof.val_m
    except ValueError:
        return False
