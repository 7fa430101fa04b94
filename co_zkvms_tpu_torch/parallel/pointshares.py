"""Rep3 EC point shares: G1 points secret-shared over the party axis.

As in the JAX package's ``parallel/pointshares.py`` (mpc-types'
``Rep3PointShare``, rep3/pointshare/types.rs:15-22): a point P is held as
three group-additive shares P = R0 + R1 + R2, each party holding
(R_p, R_{p-1}). The party axis is the leading batch axis of a Jacobian
point batch, [3] + batch, so every party-local operation is one batched
curve kernel over all three parties, and combining is two adds along
axis 0.

Per-party commitment MSMs are point shares of the value's commitment
(commit(sum of shares) = sum of commit(share)): ``msm_shares``.
"""

from __future__ import annotations

import torch

from ..ops import curve as C
from ..ops import field as F
from ..ops import msm as M
from ..ops.curve import JPoint
from . import shamir


def share(gen: torch.Generator, p: JPoint) -> JPoint:
    """Split a Jacobian point batch into 3 additive group shares
    [3] + batch; the randomizers are uniform multiples of the generator,
    their scalars drawn from ``gen``."""
    shape = tuple(p.x.shape[:-1])
    n = 1
    for d in shape:
        n *= d
    r0, r1 = (JPoint(*(c.reshape(shape + (F.NLIMBS,)) for c in
                       shamir.random_points(gen, n, p.x.device)))
              for _ in range(2))
    r2 = C.add(p, C.add(neg(r0), neg(r1)))
    return JPoint(*(torch.stack(cs) for cs in zip(r0, r1, r2)))


# -(x, y, z) = (x, -y, z), party-local
neg = C.neg


def combine(stack: JPoint) -> JPoint:
    """Reconstruct: the sum of the three party shares (batched adds)."""
    p0, p1, p2 = (C.index(stack, i) for i in range(3))
    return C.add(C.add(p0, p1), p2)


def add(x: JPoint, y: JPoint) -> JPoint:
    """Share + share: a party-local batched Jacobian add (point shares are
    linear, no communication)."""
    return C.add(x, y)


def add_public(stack: JPoint, p: JPoint) -> JPoint:
    """Share + public point: party 0 only (the additive constant
    convention, additive.rs:15-25)."""
    s0 = C.add(C.index(stack, 0), p)
    return JPoint(*(torch.cat([a[None], b[1:]]) for a, b in zip(s0, stack)))


def msm_shares(srs_level, coeff_stack) -> JPoint:
    """Point shares of commit(value) from Rep3 coefficient shares
    [3, N, 8]: one MSM per party over the same bases; a JPoint [3]."""
    return C.cat([M.msm(srs_level, coeff_stack[p]) for p in range(3)])
