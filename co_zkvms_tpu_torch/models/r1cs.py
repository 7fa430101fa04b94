"""Sparse R1CS instances, witness layout, and the row-by-row witness solver.

The host half (``SparseMatrix``, ``R1CS``, ``R1CSBuilder``) is a copy of the
JAX package's ``models/r1cs.py``: circuits are COO triplets of Python ints.
``DeviceMatrix`` lowers a matrix to tensors; its products are a gather, one
field product per entry (kernel B1 on cuda) and a lazy segment sum.

Witness vector layout:

    z[0]            = 1   (constant wire)
    z[1..n_pub]     = public inputs            } "io region", public
    z[n_pub..]      = private witness, zero-pad } "w region", committed
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import field as F
from ..ops.field import FR

MOD = FR.modulus


@dataclass
class SparseMatrix:
    """COO sparse matrix over Fr with Python-int values."""

    rows: np.ndarray            # int32 [nnz]
    cols: np.ndarray            # int32 [nnz]
    vals: np.ndarray            # object [nnz] (Python ints mod r)
    shape: tuple

    @classmethod
    def empty(cls, shape):
        return cls(
            rows=np.zeros(0, np.int32),
            cols=np.zeros(0, np.int32),
            vals=np.zeros(0, object),
            shape=shape,
        )

    def mul_vec_ints(self, z):
        """A @ z over Python ints (host reference path)."""
        out = [0] * self.shape[0]
        for r, c, v in zip(self.rows, self.cols, self.vals):
            out[r] = (out[r] + int(v) * z[c]) % MOD
        return out

    def eval_mle(self, rx, ry):
        """M(rx, ry) = sum_entries v * eq(rx, row) * eq(ry, col) (host ints)."""
        nx, ny = len(rx), len(ry)
        eq_r = _eq_table_ints(rx)
        eq_c = _eq_table_ints(ry)
        acc = 0
        for r, c, v in zip(self.rows, self.cols, self.vals):
            acc = (acc + int(v) * eq_r[r] * eq_c[c]) % MOD
        return acc


def _eq_table_ints(point):
    table = [1]
    for r in point:
        lo = [t * (1 - r) % MOD for t in table]
        hi = [t * r % MOD for t in table]
        table = lo + hi
    return table


@dataclass
class R1CS:
    """R1CS instance: (Az) o (Bz) = Cz with the z layout documented above."""

    a: SparseMatrix
    b: SparseMatrix
    c: SparseMatrix
    num_public: int             # size of the io region incl. the constant 1
    num_wires: int              # total live wires (io + witness)

    @property
    def num_constraints(self):
        return self.a.shape[0]

    @property
    def nv(self) -> int:
        """Hypercube variables: max(log2 constraints, log2 wires), padded."""
        n = max(self.num_constraints, self.num_wires, 2)
        return (n - 1).bit_length()

    def check_witness_ints(self, z):
        az = self.a.mul_vec_ints(z)
        bz = self.b.mul_vec_ints(z)
        cz = self.c.mul_vec_ints(z)
        for i, (x, y, w) in enumerate(zip(az, bz, cz)):
            if x * y % MOD != w:
                return False
        return True

    def pad_z(self, z):
        """Full-length padded z (ints) of size 2^nv."""
        out = list(z) + [0] * ((1 << self.nv) - len(z))
        return out

    def split_io_w(self, z_padded):
        """(io_part, w_part) tables — io zeroed outside [0, num_public),
        w zeroed inside it. io + w == z."""
        io = [v if i < self.num_public else 0 for i, v in enumerate(z_padded)]
        w = [0 if i < self.num_public else v for i, v in enumerate(z_padded)]
        return io, w


class R1CSBuilder:
    """Grow-able R1CS, mirroring noir-r1cs's builder + solver behavior.

    Constraints are (a_terms) * (b_terms) = (c_terms) with terms =
    [(coeff, wire_index)]. ``solve_witness`` fills unknown wires row by row
    when a row has exactly one unknown (ACVM-style sequential solving,
    noir-r1cs/src/r1cs.rs:83-115).
    """

    def __init__(self, num_public: int):
        self.num_public = num_public
        self.num_wires = num_public
        self.rows_a, self.rows_b, self.rows_c = [], [], []
        self.hints = []         # [("range_bits", src_wire, [bit_wires])]

    def new_wire(self) -> int:
        w = self.num_wires
        self.num_wires += 1
        return w

    def add_constraint(self, a_terms, b_terms, c_terms):
        self.rows_a.append(list(a_terms))
        self.rows_b.append(list(b_terms))
        self.rows_c.append(list(c_terms))

    def build(self) -> R1CS:
        n_rows = len(self.rows_a)
        shape = (n_rows, self.num_wires)

        def to_sparse(rows):
            rr, cc, vv = [], [], []
            for i, terms in enumerate(rows):
                for coeff, wire in terms:
                    rr.append(i)
                    cc.append(wire)
                    vv.append(int(coeff) % MOD)
            return SparseMatrix(
                rows=np.array(rr, np.int32),
                cols=np.array(cc, np.int32),
                vals=np.array(vv, object),
                shape=shape,
            )

        return R1CS(
            a=to_sparse(self.rows_a),
            b=to_sparse(self.rows_b),
            c=to_sparse(self.rows_c),
            num_public=self.num_public,
            num_wires=self.num_wires,
        )

    def solve_witness(self, public_inputs, assignments=None):
        """Solve for all wires given io values (z[0]=1 implicit).

        Fixpoint solver: repeatedly sweeps rows solving any with exactly one
        unknown (linear OR one unknown factor with the other side known —
        covers inverses/quotients whose values ACVM gets from Brillig), and
        executes hints ("range_bits": decompose a known wire into its bit
        wires). ``assignments``: extra known wire -> value seeds (ABI
        inputs). Raises if wires remain unsolved.
        """
        z = [None] * self.num_wires
        z[0] = 1
        if public_inputs is not None:
            assert len(public_inputs) == self.num_public - 1
            for i, v in enumerate(public_inputs):
                z[1 + i] = int(v) % MOD
        for w, v in (assignments or {}).items():
            z[w] = int(v) % MOD

        def eval_terms(terms):
            """(known_sum, unknown_list[(coeff, wire)])."""
            s, unk = 0, []
            for coeff, wire in terms:
                if z[wire] is None:
                    unk.append((int(coeff) % MOD, wire))
                else:
                    s = (s + int(coeff) * z[wire]) % MOD
            return s, unk

        pending = list(range(len(self.rows_a)))
        pending_hints = list(self.hints)
        while True:
            progress = False
            still = []
            for i in pending:
                ra, rb, rc = self.rows_a[i], self.rows_b[i], self.rows_c[i]
                sa, ua = eval_terms(ra)
                sb, ub = eval_terms(rb)
                sc, uc = eval_terms(rc)
                n_unknown = len(ua) + len(ub) + len(uc)
                if n_unknown == 0:
                    if sa * sb % MOD != sc:
                        raise ValueError("unsatisfiable constraint")
                    progress = True
                    continue
                if n_unknown > 1:
                    still.append(i)
                    continue
                if uc:
                    coeff, wire = uc[0]
                    val = (sa * sb - sc) % MOD * pow(coeff, -1, MOD) % MOD
                elif ua:
                    coeff, wire = ua[0]
                    if sb == 0:
                        still.append(i)
                        continue
                    val = (sc * pow(sb, -1, MOD) - sa) % MOD \
                        * pow(coeff, -1, MOD) % MOD
                else:
                    coeff, wire = ub[0]
                    if sa == 0:
                        still.append(i)
                        continue
                    val = (sc * pow(sa, -1, MOD) - sb) % MOD \
                        * pow(coeff, -1, MOD) % MOD
                z[wire] = val
                progress = True
            pending = still
            still_h = []
            for kind, src_w, bits in pending_hints:
                if kind == "range_bits" and z[src_w] is not None:
                    v = z[src_w]
                    for j, bw in enumerate(bits):
                        if z[bw] is None:
                            z[bw] = (v >> j) & 1
                    progress = True
                else:
                    still_h.append((kind, src_w, bits))
            pending_hints = still_h
            if not pending and not pending_hints:
                break
            if not progress:
                raise ValueError(
                    f"cannot solve: {len(pending)} rows stuck (values only "
                    f"derivable by unconstrained Brillig code)")
        if any(v is None for v in z):
            raise ValueError("unsolved wires remain")
        return z


# --- device lowering --------------------------------------------------------


@dataclass(frozen=True)
class DeviceMatrix:
    """Sparse matrix lowered to tensors for segment-sum products."""

    rows: torch.Tensor          # int64 [nnz]
    cols: torch.Tensor          # int64 [nnz]
    vals: torch.Tensor          # [nnz, 8] Montgomery
    n_rows: int
    n_cols: int

    @classmethod
    def from_sparse(cls, m: SparseMatrix, n_rows: int, n_cols: int,
                    device="cuda"):
        vals = (F.from_int(FR, [int(v) for v in m.vals], device=device)
                if len(m.vals) else F.zeros((0,), device))
        return cls(
            rows=torch.as_tensor(np.asarray(m.rows, np.int64), device=vals.device),
            cols=torch.as_tensor(np.asarray(m.cols, np.int64), device=vals.device),
            vals=vals,
            n_rows=n_rows,
            n_cols=n_cols,
        )

    def mul_vec(self, z):
        """A @ z: ``z`` [n_cols, 8] -> [n_rows, 8], or Rep3 shares [3,
        n_cols, 8] -> [3, n_rows, 8] (shares are linear: party by party)."""
        if z.dim() == 3:
            return torch.stack([self.mul_vec(zp) for zp in z])
        prods = F.mul(FR, self.vals, z[self.cols])
        return F.segment_modsum(FR, prods, self.rows, self.n_rows)

    def weighted_col_table(self, row_weights):
        """out[c] = sum_entries v * row_weights[row]: the sumcheck-2 table
        M_rx(y). ``row_weights``: [n_rows, 8]."""
        prods = F.mul(FR, self.vals, row_weights[self.rows])
        return F.segment_modsum(FR, prods, self.cols, self.n_cols)
