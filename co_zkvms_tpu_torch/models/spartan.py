"""Spartan R1CS SNARK, single party: prover on the card and host verifier.

Protocol (the JAX package's ``models/spartan.py``):

  1. commit the witness MLE w (PST13); absorb; squeeze tau [nv].
  2. sumcheck 1 (deg 3, split-eq): 0 = sum_x eq(tau,x) (Az(x) Bz(x) - Cz(x))
     -> r_x, claims va, vb, vc.
  3. squeeze ra, rb, rc; sumcheck 2 (deg 2) over y of M_rx(y) z(y), where
     M_rx(y) = sum_m r_m M_m(r_x, y); claimed sum ra va + rb vb + rc vc.
  4. -> r_y; open w(r_y) (PST13), send val_m = M_rx(r_y).
  5. the verifier recomputes M(r_x, r_y) from the sparse matrices, or,
     with ``dfs``, checks the succinct round 4 (``spartan_dfs.py``).

With ``zk_ctx`` the proof is zero-knowledge (``ops/zk.py``): a hiding
witness commitment, committed mask polynomials folded into both sumchecks
and opened at their endpoints, and a re-randomized witness opening.

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
from ..ops import zk as ZK
from ..ops.field import FR
from ..utils import build
from ..utils.phases import phase
from . import spartan_dfs
from .r1cs import R1CS, DeviceMatrix, _eq_table_ints

MOD = FR.modulus
LABEL = b"co_zkvms_tpu/spartan/v1"


class ZkData(NamedTuple):
    """ZK attachments: per-sumcheck mask commitments and endpoint openings,
    mask sums, and the hiding witness opening replacing the plain one."""

    g1_comms: list              # [nv] (x, y) univariate KZG commitments
    g1_sum: int
    g1_vals: list               # per-variable u(rx_k) openings
    g1_proofs: list
    g2_comms: list
    g2_sum: int
    g2_vals: list
    g2_proofs: list
    w_hiding: object            # zk.HidingProof


class SpartanProof(NamedTuple):
    w_commitment: tuple         # (x, y) ints
    sumcheck1_msgs: list        # [nv][4] ints
    va: int
    vb: int
    vc: int
    sumcheck2_msgs: list        # [nv][3] ints
    w_eval: int
    val_m: int
    w_proof: object             # pst13.OpeningProof (None in zk mode)
    dfs: object = None          # optional DFSRoundProof (succinct val_m)
    zk: object = None           # optional ZkData: the proof is zero-knowledge


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


_comb1.lv = SC.OUTER


def _comb2(polys):
    return F.mul(FR, polys[0], polys[1])


_comb2.lv = SC.INNER


def prove(index: SpartanIndex, srs: pst13.SRS, z_ints, dfs=None,
          zk_ctx=None) -> SpartanProof:
    """Prove knowledge of a satisfying z. ``z_ints``: the full wire
    assignment (unpadded). The io region is public; only the w region is
    committed. Runs on the device of ``index``.

    ``dfs``: a ``spartan_dfs.DFSIndex`` (adds the succinct round 4).
    ``zk_ctx``: (zk.ZkParams, random.Random): a zero-knowledge proof; the
    host rng stream is read in the JAX package's order."""
    with phase("prove"):
        return _prove(index, srs, z_ints, dfs, zk_ctx)


def zk_masks(params, rng, ht, nv, degree, device):
    """Draw, commit and absorb one sumcheck's mask polynomial; returns
    (coeff ints, the engine's zk_mask, mask commitments, mask sum)."""
    coeffs, dev = ZK.generate_mask(rng, nv, degree, device=device)
    comms = ZK.commit_mask(params, coeffs)
    g_sum = ZK.mask_sum_ints(coeffs)
    for cm in comms:
        ht.absorb_point(cm)
    ht.absorb(g_sum)
    rho = F.from_int(FR, ht.challenge(), device=device)
    return coeffs, (rho, dev), comms, g_sum


def m_rx_table(index, rx, rabc):
    """M_rx(y) = sum_m r_m M_m(r_x, y), the sumcheck-2 table."""
    eq_rx = P.eq_table(FR, rx)
    m_rx = index.da.weighted_col_table(F.mul(FR, eq_rx, rabc[0]))
    m_rx = F.add(FR, m_rx, index.db.weighted_col_table(
        F.mul(FR, eq_rx, rabc[1])))
    return F.add(FR, m_rx, index.dc.weighted_col_table(
        F.mul(FR, eq_rx, rabc[2])))


def _prove(index, srs, z_ints, dfs, zk_ctx):
    r1cs = index.r1cs
    nv = index.nv
    device = index.da.vals.device
    zk_params, zk_rng = zk_ctx if zk_ctx is not None else (None, None)
    with phase("tables"):
        zp = r1cs.pad_z(z_ints)
        _, w_ints = r1cs.split_io_w(zp)
        z_table = F.from_int(FR, zp, device=device)
        w_table = F.from_int(FR, w_ints, device=device)

    with phase("commit"):
        if zk_ctx is not None:
            w_blinder = zk_rng.randrange(MOD)
            w_comm = ZK.hide_commit(srs, zk_params, w_table, w_blinder)
        else:
            w_comm = pst13.commit(srs, w_table)
    ht = T.HostTranscript(LABEL)
    ht.absorb_point(w_comm.xy)

    with phase("Az, Bz, Cz"):
        az = index.da.mul_vec(z_table)
        bz = index.db.mul_vec(z_table)
        cz = index.dc.mul_vec(z_table)
    with phase("sumcheck 1"):
        zk1 = None
        if zk_ctx is not None:
            g1_coeffs, zk1, g1_comms, g1_sum = zk_masks(
                zk_params, zk_rng, ht, nv, 3, device)
        taus = F.from_int(FR, ht.challenges(nv), device=device)
        res1 = SC.prove(FR, ht, [az, bz, cz], degree=3, comb=_comb1,
                        zk_mask=zk1, eq_split=taus)
        va, vb, vc = (int(v) for v in F.to_int(
            FR, torch.cat(res1.final_polys, dim=0)))
        if zk_ctx is not None:
            g1_vals, g1_proofs = ZK.open_mask(zk_params, g1_coeffs,
                                              res1.challenge_ints)
            ht.absorb_many(g1_vals)

    ht.absorb_many([va, vb, vc])
    rabc = F.from_int(FR, ht.challenges(3), device=device)
    with phase("M_rx"):
        m_rx = m_rx_table(index, res1.challenges, rabc)

    with phase("sumcheck 2"):
        zk2 = None
        if zk_ctx is not None:
            g2_coeffs, zk2, g2_comms, g2_sum = zk_masks(
                zk_params, zk_rng, ht, nv, 2, device)
        res2 = SC.prove(FR, ht, [m_rx, z_table], degree=2, comb=_comb2,
                        zk_mask=zk2)
        val_m = int(F.to_int(FR, res2.final_polys[0][0]))
        if zk_ctx is not None:
            g2_vals, g2_proofs = ZK.open_mask(zk_params, g2_coeffs,
                                              res2.challenge_ints)
            ht.absorb_many(g2_vals)
    with phase("open"):
        if zk_ctx is not None:
            w_eval, w_hiding = ZK.hide_open(srs, zk_params, w_table,
                                            res2.challenges, w_blinder, zk_rng)
            w_proof = None
        else:
            w_eval, w_proof = pst13.open_at(srs, w_table, res2.challenges)

    dfs_proof = None
    if dfs is not None:
        with phase("dfs"):
            ht.absorb(w_eval)
            ht.absorb(val_m)
            dfs_proof = spartan_dfs.prove_round4(
                dfs, srs, ht, res1.challenges, res2.challenges, rabc)
    zk_data = None
    if zk_ctx is not None:
        zk_data = ZkData(
            g1_comms=g1_comms, g1_sum=g1_sum, g1_vals=g1_vals,
            g1_proofs=g1_proofs, g2_comms=g2_comms, g2_sum=g2_sum,
            g2_vals=g2_vals, g2_proofs=g2_proofs, w_hiding=w_hiding)

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
        dfs=dfs_proof,
        zk=zk_data,
    )


def _eq_eval_ints(r, s):
    acc = 1
    for a, b in zip(r, s):
        acc = acc * (a * b + (1 - a) * (1 - b)) % MOD
    return acc


def verify(index: SpartanIndex, srs: pst13.SRS, public_inputs,
           proof: SpartanProof, dfs_vk=None, zk_params=None) -> bool:
    """Host verifier (Python ints). ``public_inputs``: io values WITHOUT the
    leading constant-1 wire. Reads only ``index.r1cs``, ``index.nv`` and the
    SRS's G2 points. ``zk_params`` is required iff the proof is zk,
    ``dfs_vk`` iff it carries the DFS round."""
    r1cs = index.r1cs
    nv = index.nv
    zkd = proof.zk
    if (zkd is None) != (zk_params is None):
        return False
    try:
        ht = T.HostTranscript(LABEL)
        ht.absorb_point(proof.w_commitment)
        rho1 = rho2 = 0
        if zkd is not None:
            for cm in zkd.g1_comms:
                ht.absorb_point(cm)
            ht.absorb(zkd.g1_sum)
            rho1 = ht.challenge()
        taus = ht.challenges(nv)

        claim1 = rho1 * zkd.g1_sum % MOD if zkd is not None else 0
        rx, expected1 = SC.verify(proof.sumcheck1_msgs, claim1, ht)
        eq_tau_rx = _eq_eval_ints(taus, rx)
        want1 = (proof.va * proof.vb - proof.vc) % MOD * eq_tau_rx % MOD
        if zkd is not None:
            if not ZK.verify_mask(zk_params, zkd.g1_comms, rx, zkd.g1_vals,
                                  zkd.g1_proofs):
                return False
            want1 = (want1 + rho1 * (sum(zkd.g1_vals) % MOD)) % MOD
            ht.absorb_many(zkd.g1_vals)
        if expected1 != want1:
            return False

        ht.absorb_many([proof.va, proof.vb, proof.vc])
        ra, rb, rc = ht.challenges(3)
        claim2 = (ra * proof.va + rb * proof.vb + rc * proof.vc) % MOD
        if zkd is not None:
            for cm in zkd.g2_comms:
                ht.absorb_point(cm)
            ht.absorb(zkd.g2_sum)
            rho2 = ht.challenge()
            claim2 = (claim2 + rho2 * zkd.g2_sum) % MOD
        ry, expected2 = SC.verify(proof.sumcheck2_msgs, claim2, ht)

        # z(ry) = io(ry) + w(ry)
        eq_ry = _eq_table_ints(ry)
        io_vals = [1] + [int(v) % MOD for v in public_inputs]
        io_eval = sum(v * eq_ry[i] for i, v in enumerate(io_vals)) % MOD
        z_ry = (io_eval + proof.w_eval) % MOD
        want2 = proof.val_m * z_ry % MOD
        if zkd is not None:
            if not ZK.verify_mask(zk_params, zkd.g2_comms, ry, zkd.g2_vals,
                                  zkd.g2_proofs):
                return False
            want2 = (want2 + rho2 * (sum(zkd.g2_vals) % MOD)) % MOD
            ht.absorb_many(zkd.g2_vals)
        if expected2 != want2:
            return False

        # witness opening: hiding check in zk mode, plain PST13 otherwise
        if zkd is not None:
            if not ZK.hide_check(srs, zk_params,
                                 pst13.Commitment(proof.w_commitment), ry,
                                 proof.w_eval, zkd.w_hiding):
                return False
        elif not pst13.verify(srs, pst13.Commitment(proof.w_commitment), ry,
                              proof.w_eval, proof.w_proof):
            return False

        # val_m: the succinct round when present, else direct
        if proof.dfs is not None and dfs_vk is None:
            return False
        if proof.dfs is not None:
            ht.absorb(proof.w_eval)
            ht.absorb(proof.val_m)
            return spartan_dfs.verify_round4(
                dfs_vk, srs, ht, proof.dfs, rx, ry, [ra, rb, rc], proof.val_m)
        val = (
            ra * r1cs.a.eval_mle(rx, ry)
            + rb * r1cs.b.eval_mle(rx, ry)
            + rc * r1cs.c.eval_mle(rx, ry)
        ) % MOD
        return val == proof.val_m
    except ValueError:
        return False
