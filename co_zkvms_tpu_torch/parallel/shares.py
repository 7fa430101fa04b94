"""Replicated (Rep3) / additive secret shares as tensors with a party axis.

A shared vector of N field elements is ONE tensor ``[3, N, 8]`` whose
leading axis is the party axis, as in the JAX package's
``parallel/shares.py``. Party p's additive share is ``A[p]``; its replicated
pair is ``(A[p], A[p-1])``: the "b" component is never stored, it is
``torch.roll(A, 1, dims=0)``. All three parties live on one card; the ring
messages of a deployment are these rolls and party-axis sums.

``jax.random`` keys become explicit ``torch.Generator`` objects, so the
shares differ from the JAX package's; no proof depends on them. Seeded
sharing (mpc-types rep3.rs:34-174 ``SeededType``) keeps two integer seeds
where the JAX package keeps key data.
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


def _expand(spec: FieldSpec, seed: int, shape, device):
    """The share a seed stands for: drawn on a CPU generator, whose stream
    is the same on every machine (a CUDA generator's stream differs from a
    CPU one's for the same seed), then reduced on ``device``."""
    words = F.random_words(torch.Generator().manual_seed(seed), shape)
    return F.from_random_words(spec, words.to(device))


def share_seeded(spec: FieldSpec, gen: torch.Generator, secret):
    """Seeded sharing: returns (seeds, explicit share 2).

    Shares 0 and 1 are expanded from two integer seeds drawn from ``gen``
    (``expand_seeded``); only share 2 is explicit, so distributing a
    witness costs one share and two seeds. combine(expand_seeded(...)) ==
    secret on whichever device the expansion runs."""
    seeds = tuple(int(v) for v in torch.randint(
        0, 1 << 62, (2,), generator=gen, dtype=torch.int64,
        device=gen.device).tolist())
    shape = tuple(secret.shape[:-1])
    r0, r1 = (_expand(spec, s, shape, secret.device) for s in seeds)
    return seeds, F.sub(spec, F.sub(spec, secret, r0), r1)


def expand_seeded(spec: FieldSpec, seeds, explicit_share, shape):
    """The full share stack [3, *shape, 8] from two seeds and the explicit
    share, on the explicit share's device."""
    shape = tuple(shape)
    r0, r1 = (_expand(spec, int(s), shape, explicit_share.device)
              for s in seeds)
    return torch.stack([r0, r1, explicit_share])


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
