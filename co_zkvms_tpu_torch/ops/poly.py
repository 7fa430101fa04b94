"""Dense multilinear extensions (MLEs) as limb tensors on the hypercube.

An MLE over nv variables is its evaluation table ``[2^nv, 8]`` (Montgomery
limbs, see ``field.py``). Index bit k (LSB = bit 0) is variable x_k, as in
the JAX package's ``ops/poly.py``.
"""

from __future__ import annotations

import torch

from . import field as F
from .field import FieldSpec


def num_vars(table) -> int:
    n = table.shape[-2]
    nv = n.bit_length() - 1
    if 1 << nv != n:
        raise ValueError("table length must be a power of two")
    return nv


def eq_table(spec: FieldSpec, r) -> torch.Tensor:
    """eq(r, x) over the hypercube [2^nv, 8]; ``r``: [nv, 8] Montgomery.

    eq[j] = prod_k (r_k if bit_k(j) else 1 - r_k)."""
    one = F.ones_mont(spec, (1,), r.device)
    table = one
    for k in range(r.shape[0]):
        rk = r[k]
        lo = F.mul(spec, table, F.sub(spec, one[0], rk))
        hi = F.mul(spec, table, rk)
        table = torch.cat([lo, hi], dim=0)
    return table


def bind_low(spec: FieldSpec, table, r) -> torch.Tensor:
    """Bind x_0 (the index LSB) to r: out[j] = t[2j] + r (t[2j+1] - t[2j])."""
    even = table[0::2]
    odd = table[1::2]
    return F.add(spec, even, F.mul(spec, F.sub(spec, odd, even), r))


def evaluate(spec: FieldSpec, table, point) -> torch.Tensor:
    """The MLE at ``point`` [nv, 8] (binds x_0 first). Returns [8]."""
    nv = num_vars(table)
    if point.shape[0] != nv:
        raise ValueError(f"point has {point.shape[0]} coordinates, table {nv}")
    for k in range(nv):
        table = bind_low(spec, table, point[k])
    return table[0]


def linear_combination(spec: FieldSpec, coeffs, tables) -> torch.Tensor:
    """sum_i coeffs[i] tables[i]: coeffs [k, 8], tables k of [n, 8]."""
    acc = F.mul(spec, tables[0], coeffs[0])
    for c, t in zip(coeffs[1:], tables[1:]):
        acc = F.add(spec, acc, F.mul(spec, t, c))
    return acc


def eq_eval(spec: FieldSpec, r, s) -> torch.Tensor:
    """eq(r, s) = prod_k (r_k s_k + (1 - r_k)(1 - s_k)) for [nv, 8] points."""
    one = F.ones_mont(spec, (), r.device)
    term = F.add(spec, F.mul(spec, r, s),
                 F.mul(spec, F.sub(spec, one, r), F.sub(spec, one, s)))
    acc = term[0]
    for k in range(1, term.shape[0]):
        acc = F.mul(spec, acc, term[k])
    return acc
