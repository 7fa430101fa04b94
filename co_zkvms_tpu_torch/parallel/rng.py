"""Correlated randomness for Rep3: 3-party zero shares from paired seeds.

Party p holds seed s_p (shared with its next neighbour) and s_{p-1} (shared
with its previous one); ``zero = PRF(s_p, ctr) - PRF(s_{p-1}, ctr)`` sums to
zero over the three parties, as in the JAX package's ``parallel/rng.py``.

The PRF here is a counter-keyed ``torch.Generator``: the seed of a draw is
sha256(s_p, counters), so every (round, t, ...) draws a fresh zero share on
the device with nothing streamed. The numbers differ from the JAX package's
threefry draws; what a proof reveals never depends on them.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import torch

from ..ops import field as F
from ..ops.field import FieldSpec
from ..utils import build


class CorrelatedRng(NamedTuple):
    """Per-party seeds s_0, s_1, s_2."""

    seeds: tuple

    @classmethod
    def create(cls, gen: torch.Generator):
        """Three party seeds drawn from ``gen``."""
        draw = torch.randint(0, 1 << 62, (3,), generator=gen,
                             dtype=torch.int64, device=gen.device)
        return cls(tuple(int(v) for v in draw.tolist()))

    def party_random(self, spec: FieldSpec, party: int, shape, counters,
                     device):
        """PRF(s_party, counters): field elements [*shape, 8]."""
        tag = f"{self.seeds[party]}/" + "/".join(str(int(c)) for c in counters)
        seed = int.from_bytes(hashlib.sha256(tag.encode()).digest()[:8],
                              "little") >> 1
        gen = torch.Generator(device=device).manual_seed(seed)
        return F.random(spec, gen, shape)

    def zero_shares(self, spec: FieldSpec, shape, *counters, device="cuda"):
        """Zero-sum shares [3, *shape, 8]: party p gets PRF(s_p) -
        PRF(s_{p-1}), keyed by ``counters``."""
        device = build.resolve_device(device)
        r = torch.stack([self.party_random(spec, p, tuple(shape), counters,
                                           device) for p in range(3)])
        return F.sub(spec, r, torch.roll(r, 1, dims=0))
