"""Rep3 MPC protocol ops over the party axis (degree-2 mul, open, local ops).

A copy of the JAX package's ``parallel/mpc.py``. Local share algebra: party
p holds (a_p, b_p = a_{p-1}); x y has the additive share
d_p = xa ya + xa yb + xb ya (+ a zero-share mask for re-randomization).
The reshare ring is ``shares.b_component`` (a roll of the party axis) and an
open is a party-axis sum.
"""

from __future__ import annotations

import torch

from ..ops import field as F
from ..ops import sumcheck as SC
from ..ops.field import FieldSpec
from . import shares as S


def mul(spec: FieldSpec, x, y, zero_mask=None):
    """Share-by-share product -> additive shares (replicated after the
    implicit reshare). ``x``, ``y``: [3, ..., 8]; ``zero_mask``: correlated
    zero shares [3, ..., 8] (re-randomization; every prover path passes
    one)."""
    xb = S.b_component(x)
    yb = S.b_component(y)
    d = F.add(spec, F.mul(spec, x, y),
              F.add(spec, F.mul(spec, x, yb), F.mul(spec, xb, y)))
    if zero_mask is not None:
        d = F.add(spec, d, zero_mask)
    return d


def mul_public(spec: FieldSpec, x, c):
    """Multiply shares by a public value (local)."""
    return F.mul(spec, x, c[None] if c.dim() == x.dim() - 1 else c)


def add_public(spec: FieldSpec, x, c):
    """Add a public value: only party 0 applies it."""
    return torch.cat([F.add(spec, x[0], c)[None], x[1:]])


def open(spec: FieldSpec, x):
    """Reconstruct the public value from shares (sum over the party axis)."""
    return S.combine(spec, x)


def inner_product(spec: FieldSpec, x, y_public):
    """<shares, public vector> along the element axis -> shares [3, 8]."""
    return F.modsum(spec, F.mul(spec, x, y_public[None]), dim=1)


def eval_shares(spec: FieldSpec, stack, point):
    """MLE evaluation share-side: every party binds its own [n, 8] share
    table at ``point`` (binding is linear, so the bound shares sum to the
    true value); B10 binds all three parties in one launch a variable.
    Returns the [3, 8] scalar shares."""
    stack = stack.contiguous()
    for k in range(point.shape[0]):
        stack = SC.bind_rows(spec, stack, point[k])
    return stack[:, 0]


def eval_open(spec: FieldSpec, stack, point) -> int:
    """Share-side evaluation + opening of the scalar only."""
    opened = S.combine(spec, eval_shares(spec, stack, point))
    return int(F.to_int(spec, opened))
