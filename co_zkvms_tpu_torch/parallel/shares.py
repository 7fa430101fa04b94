"""Replicated (Rep3) / additive secret shares as tensors with a party axis.

A shared vector of N field elements is ONE tensor ``[3, N, 8]`` whose
leading axis is the party axis, as in the JAX package's
``parallel/shares.py``. Party p's additive share is ``A[p]``; its replicated
pair is ``(A[p], A[p-1])``: the "b" component is never stored, it is
``torch.roll(A, 1, dims=0)``. All three parties live on one card; the ring
messages of a deployment are these rolls and party-axis sums.

``jax.random`` keys become explicit ``torch.Generator`` objects, so the
shares differ from the JAX package's; no proof depends on them.
"""

from __future__ import annotations

import torch

from ..ops import field as F
from ..ops.field import FieldSpec

PARTIES = 3


def share(spec: FieldSpec, gen: torch.Generator, secret):
    """Split ``secret`` [..., 8] into additive shares [3, ..., 8]; the two
    random shares come from ``gen``."""
    shape = secret.shape[:-1]
    r0 = F.random(spec, gen, shape).to(secret.device)
    r1 = F.random(spec, gen, shape).to(secret.device)
    r2 = F.sub(spec, F.sub(spec, secret, r0), r1)
    return torch.stack([r0, r1, r2])


def combine(spec: FieldSpec, shares):
    """Reconstruct the secret: the modular sum over the party axis."""
    acc = shares[0]
    for p in range(1, shares.shape[0]):
        acc = F.add(spec, acc, shares[p])
    return acc


def promote_public(spec: FieldSpec, value):
    """Trivial sharing of a public value: party 0 holds it, the others 0."""
    return torch.cat([value[None], torch.zeros((PARTIES - 1,) + value.shape,
                                               dtype=value.dtype,
                                               device=value.device)])


def b_component(shares):
    """The replicated "b" share: party p's copy of party p-1's share."""
    return torch.roll(shares, 1, dims=0)
