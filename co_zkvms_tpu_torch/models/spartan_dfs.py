"""Succinct DFS round: Spark-style sparse-matrix evaluation via logup.

A copy of the JAX package's ``models/spartan_dfs.py``. The indexer commits
the sparse structure once, and each proof shows

  (1) value:     val_m = sum_k valmix(k) * e_rx(k) * e_ry(k)
  (2) row logup: pairs (row_k, e_rx_k) lie in the table (i, eq(r_x, i))
  (3) col logup: pairs (col_k, e_ry_k) lie in the table (i, eq(r_y, i))

where e_rx(k) = eq(r_x, row_k) is a committed prover polynomial. Pairs are
gamma-combined; the LogUp identity sum m/(x+t) = sum 1/(x+q) is enforced
with h0 = m/(x+t), h1 = 1/(x+q) and per-point zerochecks, all batched with a
lambda-RLC into ONE degree-3 sumcheck over the entries domain. Table-side
polynomials live on the matrix domain and enter the sumcheck tiled; their
MLEs ignore the high variables, so they open at the point prefix p_lo.

Everything here is public data, so the co-Spartan prover reuses it as is.
The sumcheck's comb takes constants, so it runs on the engine's glue path;
its binds go through B10. ``build_index`` builds the entries domain with
numpy (no Python loop over entries).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import field as F
from ..ops import poly as P
from ..ops import pst13
from ..ops import sumcheck as SC
from ..ops import transcript as T
from ..ops.field import FR
from .r1cs import R1CS

MOD = FR.modulus


class DFSIndex(NamedTuple):
    """Prover-side index: device tables + commitments of the sparse
    structure."""

    nv: int                     # matrix domain (rows/cols) log-size
    dlog: int                   # entries domain log-size
    dd: int                     # dlog - nv when dlog > nv else 0
    rows: torch.Tensor          # int64 [K]
    cols: torch.Tensor          # int64 [K]
    vals: tuple                 # (val_a, val_b, val_c) each [K, 8]
    row_mle: torch.Tensor       # [K, 8] row indices as field elements
    col_mle: torch.Tensor
    freq_r: torch.Tensor        # [2^nv, 8] lookup multiplicities
    freq_c: torch.Tensor
    idx_mle: torch.Tensor       # [2^nv, 8] identity MLE table
    comms: dict                 # name -> pst13.Commitment

    @property
    def vk(self) -> "DFSVerifierKey":
        return DFSVerifierKey(nv=self.nv, dlog=self.dlog, dd=self.dd,
                              comms=self.comms)


class DFSVerifierKey(NamedTuple):
    nv: int
    dlog: int
    dd: int
    comms: dict


class DFSRoundProof(NamedTuple):
    e_rx_comm: tuple
    e_ry_comm: tuple
    h_comms: dict               # h0r, h1r, h0c, h1c -> (x, y)
    sumcheck_msgs: list         # [dlog][4] ints (degree 3)
    evals: dict                 # 13 opened values (ints)
    batch_proof_k: pst13.OpeningProof     # entries-domain group at p
    batch_proof_nv: pst13.OpeningProof    # matrix-domain group at p_lo


GROUP_K = ["e_rx", "e_ry", "val_a", "val_b", "val_c", "h1r", "h1c", "row", "col"]
GROUP_NV = ["h0r", "h0c", "freq_r", "freq_c"]


def _matrix_entries(mat, n: int):
    """(keys r * n + c, values mod m) of a sparse matrix, the last entry of a
    repeated (r, c) winning, as in a dict update."""
    keys = np.asarray(mat.rows, np.int64) * n + np.asarray(mat.cols, np.int64)
    vals = np.asarray(mat.vals)
    if vals.dtype.kind not in "iu" or (len(vals) and vals.min() < 0):
        vals = np.asarray([int(v) % MOD for v in mat.vals], dtype=object)
    ukeys, first_rev = np.unique(keys[::-1], return_index=True)
    return ukeys, vals[::-1][first_rev]


class Entries(NamedTuple):
    """The entries domain of an R1CS: its nonzero (row, col) positions."""

    dlog: int
    rows: np.ndarray            # int64 [2^dlog]
    cols: np.ndarray
    vals: list                  # 3 value columns (int64 or object ints)


def entries(r1cs: R1CS) -> Entries:
    """The union of the three matrices' (row, col) entries, sorted, padded
    with (0, 0, val = 0) lookups to 2^dlog. The entries domain is at least
    the matrix domain; the padding lookups are real and are counted in the
    freq polynomials."""
    n = 1 << r1cs.nv
    per = [_matrix_entries(m, n) for m in (r1cs.a, r1cs.b, r1cs.c)]
    keys = np.unique(np.concatenate([k for k, _ in per]))
    nnz = max(len(keys), 1)
    dlog = max((nnz - 1).bit_length(), r1cs.nv, 1)
    k = 1 << dlog
    rows = np.zeros(k, np.int64)
    cols = np.zeros(k, np.int64)
    rows[:len(keys)] = keys // n
    cols[:len(keys)] = keys % n
    vals = []
    for mk, mv in per:
        col = np.zeros(k, dtype=mv.dtype)
        col[np.searchsorted(keys, mk)] = mv
        vals.append(col)
    return Entries(dlog=dlog, rows=rows, cols=cols, vals=vals)


def build_index(r1cs: R1CS, srs: pst13.SRS) -> DFSIndex:
    """Offline indexer: the entries domain on the device of ``srs``, and
    the commitments of its tables (``srs.nv`` >= ``entries(r1cs).dlog``)."""
    device = srs.level(0).x.device
    nv = r1cs.nv
    n = 1 << nv
    dlog, rows, cols, vals = entries(r1cs)
    freq_r = np.bincount(rows, minlength=n)
    freq_c = np.bincount(cols, minlength=n)

    d_vals = tuple(F.from_int(FR, v, device=device) for v in vals)
    row_mle = F.from_int(FR, rows, device=device)
    col_mle = F.from_int(FR, cols, device=device)
    d_freq_r = F.from_int(FR, freq_r, device=device)
    d_freq_c = F.from_int(FR, freq_c, device=device)
    idx_mle = F.from_int(FR, np.arange(n, dtype=np.int64), device=device)

    comms = dict(zip(
        ("row", "col", "val_a", "val_b", "val_c", "freq_r", "freq_c"),
        pst13.commit_batch(srs, [row_mle, col_mle, d_vals[0], d_vals[1],
                                 d_vals[2], d_freq_r, d_freq_c])))
    return DFSIndex(
        nv=nv, dlog=dlog, dd=dlog - nv,
        rows=torch.from_numpy(rows).to(device),
        cols=torch.from_numpy(cols).to(device), vals=d_vals,
        row_mle=row_mle, col_mle=col_mle,
        freq_r=d_freq_r, freq_c=d_freq_c, idx_mle=idx_mle, comms=comms,
    )


def _tile(table, dd: int):
    """Tile an nv-domain table 2^dd times (its MLE ignores the top dd vars)."""
    return table if dd == 0 else table.repeat(1 << dd, 1)


def _comb_dfs(polys, consts):
    (e_rx, e_ry, valmix, h0r, h1r, freqr, tr, qr, eqz1,
     h0c, h1c, freqc, tc, qc, eqz2) = polys
    lam, x_r, x_c, sf, one = consts

    g = F.mul(FR, lam[0], F.mul(FR, e_rx, F.mul(FR, e_ry, valmix)))
    g = F.add(FR, g, F.mul(FR, lam[1], F.sub(FR, F.mul(FR, sf, h0r), h1r)))
    z1r = F.sub(FR, F.mul(FR, h0r, F.add(FR, x_r, tr)), freqr)
    g = F.add(FR, g, F.mul(FR, lam[2], F.mul(FR, eqz1, z1r)))
    z1q = F.sub(FR, F.mul(FR, h1r, F.add(FR, x_r, qr)), one)
    g = F.add(FR, g, F.mul(FR, lam[3], F.mul(FR, eqz1, z1q)))
    g = F.add(FR, g, F.mul(FR, lam[4], F.sub(FR, F.mul(FR, sf, h0c), h1c)))
    z2r = F.sub(FR, F.mul(FR, h0c, F.add(FR, x_c, tc)), freqc)
    g = F.add(FR, g, F.mul(FR, lam[5], F.mul(FR, eqz2, z2r)))
    z2q = F.sub(FR, F.mul(FR, h1c, F.add(FR, x_c, qc)), one)
    g = F.add(FR, g, F.mul(FR, lam[6], F.mul(FR, eqz2, z2q)))
    return g


def prove_round4(index: DFSIndex, srs: pst13.SRS, ht: T.HostTranscript,
                 rx, ry, rabc) -> DFSRoundProof:
    """The succinct val_m round. ``rx``, ``ry``: [nv, 8] challenges,
    ``rabc``: [3, 8] (Montgomery). ``ht`` is advanced in place."""
    nv, dd = index.nv, index.dd
    dlog = index.dlog
    device = rx.device

    def fe(v):
        return F.from_int(FR, v, device=device)

    eq_rx = P.eq_table(FR, rx)
    eq_ry = P.eq_table(FR, ry)
    e_rx = eq_rx[index.rows]
    e_ry = eq_ry[index.cols]

    e_rx_comm, e_ry_comm = pst13.commit_batch(srs, [e_rx, e_ry])
    ht.absorb_point(e_rx_comm.xy)
    ht.absorb_point(e_ry_comm.xy)
    g_r, g_c, x_r, x_c = ht.challenges(4)
    dg_r, dg_c, dx_r, dx_c = fe(g_r), fe(g_c), fe(x_r), fe(x_c)

    # tables and h polynomials
    table_r = F.add(FR, index.idx_mle, F.mul(FR, eq_rx, dg_r))
    table_c = F.add(FR, index.idx_mle, F.mul(FR, eq_ry, dg_c))
    query_r = F.add(FR, index.row_mle, F.mul(FR, e_rx, dg_r))
    query_c = F.add(FR, index.col_mle, F.mul(FR, e_ry, dg_c))

    h0r_small = F.mul(FR, index.freq_r,
                      F.batch_inv(FR, F.add(FR, table_r, dx_r)))
    h0c_small = F.mul(FR, index.freq_c,
                      F.batch_inv(FR, F.add(FR, table_c, dx_c)))
    h1r = F.batch_inv(FR, F.add(FR, query_r, dx_r))
    h1c = F.batch_inv(FR, F.add(FR, query_c, dx_c))

    h_comms = dict(zip(
        ("h0r", "h1r", "h0c", "h1c"),
        pst13.commit_batch(srs, [h0r_small, h1r, h0c_small, h1c])))
    for name in ("h0r", "h1r", "h0c", "h1c"):
        ht.absorb_point(h_comms[name].xy)

    z1 = ht.challenges(dlog)
    z2 = ht.challenges(dlog)
    lam = ht.challenge()
    lam_pows = [pow(lam, i + 1, MOD) for i in range(7)]

    # K-domain sumcheck tables
    vals = index.vals
    valmix = F.mul(FR, vals[0], rabc[0])
    valmix = F.add(FR, valmix, F.mul(FR, vals[1], rabc[1]))
    valmix = F.add(FR, valmix, F.mul(FR, vals[2], rabc[2]))
    eq_z1 = P.eq_table(FR, fe(z1))
    eq_z2 = P.eq_table(FR, fe(z2))

    polys = [
        e_rx, e_ry, valmix,
        _tile(h0r_small, dd), h1r, _tile(index.freq_r, dd),
        _tile(table_r, dd), query_r, eq_z1,
        _tile(h0c_small, dd), h1c, _tile(index.freq_c, dd),
        _tile(table_c, dd), query_c, eq_z2,
    ]
    sf = pow(pow(2, dd, MOD), -1, MOD)
    consts = (fe(lam_pows), fe(x_r), fe(x_c), fe(sf),
              F.ones_mont(FR, (), device))
    res = SC.prove(FR, ht, polys, degree=3, comb=_comb_dfs, consts=consts)
    p = res.challenges
    p_lo = p[:nv]

    # openings
    tables_k = {
        "e_rx": e_rx, "e_ry": e_ry,
        "val_a": vals[0], "val_b": vals[1], "val_c": vals[2],
        "h1r": h1r, "h1c": h1c, "row": index.row_mle, "col": index.col_mle,
    }
    tables_nv = {
        "h0r": h0r_small, "h0c": h0c_small,
        "freq_r": index.freq_r, "freq_c": index.freq_c,
    }
    evals = {}
    for name, tab in tables_k.items():
        evals[name] = int(F.to_int(FR, P.evaluate(FR, tab, p)))
    for name, tab in tables_nv.items():
        evals[name] = int(F.to_int(FR, P.evaluate(FR, tab, p_lo)))

    for name in GROUP_K + GROUP_NV:
        ht.absorb(evals[name])
    eta_k = ht.challenge()
    _, proof_k = pst13.batch_open(
        srs, [tables_k[n] for n in GROUP_K], fe(eta_k), p)
    eta_nv = ht.challenge()
    _, proof_nv = pst13.batch_open(
        srs, [tables_nv[n] for n in GROUP_NV], fe(eta_nv), p_lo)

    return DFSRoundProof(
        e_rx_comm=e_rx_comm.xy,
        e_ry_comm=e_ry_comm.xy,
        h_comms={k: v.xy for k, v in h_comms.items()},
        sumcheck_msgs=res.round_msgs,
        evals=evals,
        batch_proof_k=proof_k,
        batch_proof_nv=proof_nv,
    )


def _eq_eval_ints(r, s):
    acc = 1
    for a, b in zip(r, s):
        acc = acc * (a * b + (1 - a) * (1 - b)) % MOD
    return acc


def verify_round4(vk: DFSVerifierKey, srs: pst13.SRS, ht: T.HostTranscript,
                  proof: DFSRoundProof, rx_ints, ry_ints, rabc_ints,
                  val_m: int) -> bool:
    """Host verifier of the round (Python ints)."""
    nv, dd, dlog = vk.nv, vk.dd, vk.dlog
    ra, rb, rc = rabc_ints

    ht.absorb_point(proof.e_rx_comm)
    ht.absorb_point(proof.e_ry_comm)
    g_r, g_c, x_r, x_c = ht.challenges(4)
    for name in ("h0r", "h1r", "h0c", "h1c"):
        ht.absorb_point(proof.h_comms[name])
    z1 = ht.challenges(dlog)
    z2 = ht.challenges(dlog)
    lam = ht.challenge()
    lp = [pow(lam, i + 1, MOD) for i in range(7)]

    claim = lp[0] * val_m % MOD
    try:
        p, expected = SC.verify(proof.sumcheck_msgs, claim, ht)
    except ValueError:
        return False
    p_lo = p[:nv]

    ev = proof.evals
    sf = pow(pow(2, dd, MOD), -1, MOD)
    idx_eval = sum((1 << b) * p_lo[b] for b in range(nv)) % MOD
    eq_rx_p = _eq_eval_ints(rx_ints, p_lo)
    eq_ry_p = _eq_eval_ints(ry_ints, p_lo)
    t_r = (idx_eval + g_r * eq_rx_p) % MOD
    t_c = (idx_eval + g_c * eq_ry_p) % MOD
    q_r = (ev["row"] + g_r * ev["e_rx"]) % MOD
    q_c = (ev["col"] + g_c * ev["e_ry"]) % MOD
    valmix = (ra * ev["val_a"] + rb * ev["val_b"] + rc * ev["val_c"]) % MOD
    eq_z1_p = _eq_eval_ints(z1, p)
    eq_z2_p = _eq_eval_ints(z2, p)

    g = lp[0] * ev["e_rx"] * ev["e_ry"] % MOD * valmix % MOD
    g = (g + lp[1] * (sf * ev["h0r"] - ev["h1r"])) % MOD
    g = (g + lp[2] * eq_z1_p % MOD * (ev["h0r"] * (x_r + t_r) - ev["freq_r"])) % MOD
    g = (g + lp[3] * eq_z1_p % MOD * (ev["h1r"] * (x_r + q_r) - 1)) % MOD
    g = (g + lp[4] * (sf * ev["h0c"] - ev["h1c"])) % MOD
    g = (g + lp[5] * eq_z2_p % MOD * (ev["h0c"] * (x_c + t_c) - ev["freq_c"])) % MOD
    g = (g + lp[6] * eq_z2_p % MOD * (ev["h1c"] * (x_c + q_c) - 1)) % MOD
    if g % MOD != expected:
        return False

    for name in GROUP_K + GROUP_NV:
        ht.absorb(ev[name])

    all_comms = {
        "e_rx": pst13.Commitment(proof.e_rx_comm),
        "e_ry": pst13.Commitment(proof.e_ry_comm),
        "h1r": pst13.Commitment(proof.h_comms["h1r"]),
        "h1c": pst13.Commitment(proof.h_comms["h1c"]),
        "h0r": pst13.Commitment(proof.h_comms["h0r"]),
        "h0c": pst13.Commitment(proof.h_comms["h0c"]),
        **dict(vk.comms),
    }
    eta_k = ht.challenge()
    agg_val_k = pst13.aggregate_evals_ints(eta_k, [ev[n] for n in GROUP_K])
    if not pst13.batch_verify(
        srs, [all_comms[n] for n in GROUP_K], [ev[n] for n in GROUP_K],
        eta_k, p, agg_val_k, proof.batch_proof_k,
    ):
        return False
    eta_nv = ht.challenge()
    agg_val_nv = pst13.aggregate_evals_ints(eta_nv, [ev[n] for n in GROUP_NV])
    return pst13.batch_verify(
        srs, [all_comms[n] for n in GROUP_NV], [ev[n] for n in GROUP_NV],
        eta_nv, p_lo, agg_val_nv, proof.batch_proof_nv,
    )
