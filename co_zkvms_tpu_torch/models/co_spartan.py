"""co-Spartan: the 3-party Rep3 Spartan prover, all parties on one card.

A port of the JAX package's ``models/co_spartan.py`` over share stacks
[3, N, 8] (``parallel/shares.py``):

- witness sharing: w is Rep3-shared; z = trivial(io) + w_shares (party 0
  carries the public io region);
- each party commits its w share (B8 MSMs); the witness commitment is their
  G1 sum;
- sumcheck 1 runs the engine's shared mode: az * bz is the Rep3 3-term
  local product, masked with a fresh correlated zero share per (round, t);
  each round message is scaled, masked with a zero share and opened by a
  party-axis sum before the transcript sees it;
- sumcheck 2's M_rx(y) table is public, z stays shared;
- the PST13 opening sums the parties' proofs pointwise;
- zk (``zk_ctx``) is coordinator-side: the combined commitment is hidden,
  the mask polynomial folds into the opened messages, and the combined
  opening proof is re-randomized: no step holds the witness;
- the DFS round 4 runs on public data with the single-party prover.

Every binding of a shared table (party rows included) goes through B10.
The proof equals the single-party proof field by field, whatever the share
and mask generators: the masks cancel in every opened value.

Not ported (later slices): ``mesh=``, ``witness=`` and ``ckpt=``.
"""

from __future__ import annotations

import torch

from ..ops import field as F
from ..ops import pst13
from ..ops import sumcheck as SC
from ..ops import transcript as T
from ..ops import zk as ZK
from ..ops.field import FR
from ..parallel import mpc
from ..parallel import shares as S
from ..parallel.rng import CorrelatedRng
from ..utils.phases import phase
from . import mpc_pcs, spartan_dfs
from .spartan import (LABEL, SpartanIndex, SpartanProof, ZkData, m_rx_table,
                      zk_masks)

MOD = FR.modulus


def _phase(name):
    return phase(name, "co_spartan")


def share_witness(index: SpartanIndex, z_ints, gen: torch.Generator):
    """Split z into io (public) + Rep3-shared w. Returns (io_table,
    z_shares, w_shares)."""
    r1cs = index.r1cs
    device = index.da.vals.device
    io_ints, w_ints = r1cs.split_io_w(r1cs.pad_z(z_ints))
    io_table = F.from_int(FR, io_ints, device=device)
    w_shares = S.share(FR, gen, F.from_int(FR, w_ints, device=device))
    z_shares = F.add(FR, S.promote_public(FR, io_table), w_shares)
    return io_table, z_shares, w_shares


def _comb1_shared(polys, consts, t):
    """Outer comb on shares, with a fresh correlated zero share on the
    az * bz reshare, drawn per (round, t)."""
    eq, az, bz, cz = polys
    crng, rctr = consts
    mask = crng.zero_shares(FR, az.shape[1:-1], rctr, t, device=az.device)
    prod = mpc.mul(FR, az, bz, zero_mask=mask)
    return F.mul(FR, eq, F.sub(FR, prod, cz))


_comb1_shared.wants_ctr = True


def _comb2_shared(polys):
    m_rx, z = polys
    return F.mul(FR, m_rx, z)


def prove_rep3(index: SpartanIndex, srs: pst13.SRS, z_ints, share_gen=None,
               mask_gen=None, dfs=None, zk_ctx=None) -> SpartanProof:
    """3-party MPC Spartan prove (all parties simulated on the device of
    ``index``). ``share_gen``/``mask_gen``: ``torch.Generator`` on that
    device for the witness shares and the correlated zero shares (seeds 0
    and 1 when None). ``dfs``, ``zk_ctx``: as ``spartan.prove``."""
    with _phase("prove"):
        return _prove_rep3(index, srs, z_ints, share_gen, mask_gen, dfs,
                           zk_ctx)


def _prove_rep3(index, srs, z_ints, share_gen, mask_gen, dfs, zk_ctx):
    nv = index.nv
    device = index.da.vals.device
    if share_gen is None:
        share_gen = torch.Generator(device=device).manual_seed(0)
    if mask_gen is None:
        mask_gen = torch.Generator(device=device).manual_seed(1)
    zk_params, zk_rng = zk_ctx if zk_ctx is not None else (None, None)
    with _phase("tables"):
        _, z_shares, w_shares = share_witness(index, z_ints, share_gen)
        crng = CorrelatedRng.create(mask_gen)

    with _phase("commit"):
        w_comm = mpc_pcs.commit_shares(srs, w_shares)
        if zk_ctx is not None:
            w_blinder = zk_rng.randrange(MOD)
            w_comm = ZK.hide_commitment(zk_params, w_comm, w_blinder)
    ht = T.HostTranscript(LABEL)
    ht.absorb_point(w_comm.xy)

    with _phase("Az, Bz, Cz"):
        az = index.da.mul_vec(z_shares)
        bz = index.db.mul_vec(z_shares)
        cz = index.dc.mul_vec(z_shares)
    with _phase("sumcheck 1"):
        zk1 = None
        if zk_ctx is not None:
            g1_coeffs, zk1, g1_comms, g1_sum = zk_masks(
                zk_params, zk_rng, ht, nv, 3, device)
        taus = F.from_int(FR, ht.challenges(nv), device=device)
        masks1 = torch.stack([crng.zero_shares(FR, (4,), j, device=device)
                              for j in range(nv)])
        res1 = SC.prove(FR, ht, [az, bz, cz], degree=3, comb=_comb1_shared,
                        masks=masks1, shared=True, zk_mask=zk1,
                        round_consts=[(crng, 500_000 + j) for j in range(nv)],
                        eq_split=taus)
        va, vb, vc = (int(F.to_int(FR, S.combine(FR, p)[0]))
                      for p in res1.final_polys)
        if zk_ctx is not None:
            g1_vals, g1_proofs = ZK.open_mask(zk_params, g1_coeffs,
                                              res1.challenge_ints)
            ht.absorb_many(g1_vals)

    ht.absorb_many([va, vb, vc])
    rabc = F.from_int(FR, ht.challenges(3), device=device)
    with _phase("M_rx"):
        m_rx = m_rx_table(index, res1.challenges, rabc)

    with _phase("sumcheck 2"):
        zk2 = None
        if zk_ctx is not None:
            g2_coeffs, zk2, g2_comms, g2_sum = zk_masks(
                zk_params, zk_rng, ht, nv, 2, device)
        masks2 = torch.stack([crng.zero_shares(FR, (3,), 1000 + j,
                                               device=device)
                              for j in range(nv)])
        res2 = SC.prove(FR, ht, [m_rx, z_shares], degree=2,
                        comb=_comb2_shared, masks=masks2, shared=True,
                        zk_mask=zk2)
        val_m = int(F.to_int(FR, res2.final_polys[0][0]))
        if zk_ctx is not None:
            g2_vals, g2_proofs = ZK.open_mask(zk_params, g2_coeffs,
                                              res2.challenge_ints)
            ht.absorb_many(g2_vals)

    with _phase("open"):
        # the parties open their shares; the combined proof is
        # re-randomized in zk mode: the witness never exists in one place
        w_eval, w_proof = mpc_pcs.open_shares(srs, w_shares, res2.challenges)
        if zk_ctx is not None:
            w_hiding = ZK.hide_proof(srs, zk_params, w_proof,
                                     res2.challenge_ints, w_blinder, zk_rng)
            w_proof = None

    dfs_proof = None
    if dfs is not None:
        with _phase("dfs"):
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
