"""Sumcheck prover over MLE tables, and its host verifier.

Round j over tables of 2h entries: each table's restriction to x_0 = t is
even + t (odd - even); the round message is s_j(t) = sum over the h pairs of
comb(restrictions) for t = 0..degree. The transcript absorbs the message,
squeezes r_j, and every table binds x_0 <- r_j, reusing the slopes.

The port's single-party prover drives the transcript on the host
(``transcript.HostTranscript``): each message is reduced on the device
(``field.modsum``), copied to the host as degree + 1 ints, and absorbed in
standard form. Pair order and summation order do not change a message, so
every message equals the JAX package's ``sumcheck.prove`` bit for bit.

``eq_split`` is Dao-Thaler split-eq, as in the JAX package: the comb sees a
read-only half-size suffix table S_j[y] = eq(taus[j+1:], y) as its first
table, and the message is scaled by c_j * eq(tau_j, t) with
c_{j+1} = c_j * eq(tau_j, r_j); the eq table is never bound.

Not ported: masks, shared tables, zk masks, round constants, the fixed and
chunked compile shapes and the bit-reversed layout of the fused TPU rounds.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from . import field as F
from .field import FR, FieldSpec
from .transcript import HostTranscript


class SumcheckResult(NamedTuple):
    challenges: torch.Tensor  # [nv, 8] Montgomery
    challenge_ints: list      # [nv] ints
    round_msgs: list          # [nv][degree + 1] ints
    final_polys: list         # each [1, 8]: the tables bound at the challenges


def eq_suffix_tables(spec: FieldSpec, taus) -> list:
    """Split-eq suffix tables S_j[y] = eq(taus[j+1:], y), sizes
    2^(nv-1-j) .. 1, built LSB-first by one doubling sweep."""
    nv = taus.shape[0]
    t = F.ones_mont(spec, (1,), taus.device)
    suf = [None] * nv
    for j in range(nv - 1, -1, -1):
        suf[j] = t
        t1 = F.mul(spec, t, taus[j])
        t0 = F.sub(spec, t, t1)
        t = torch.stack([t0, t1], dim=1).reshape(-1, F.NLIMBS)
    return suf


def _eq_int(w: int, t: int, m: int) -> int:
    """eq(w, t) = (1 - w) + t (2w - 1) mod m."""
    return ((1 - w) + t * (2 * w - 1)) % m


def prove(spec: FieldSpec, transcript: HostTranscript,
          polys: Sequence[torch.Tensor], degree: int, comb: Callable,
          eq_split=None) -> SumcheckResult:
    """Run every round. ``polys``: tables [2^nv, 8] on one device.

    ``comb(list of [h, 8]) -> [h, 8]`` combines the per-table restrictions.
    ``eq_split``: optional [nv, 8] Montgomery taus (split-eq; ``polys``
    then exclude the eq table). ``transcript`` is advanced in place."""
    m = spec.modulus
    n = polys[0].shape[-2]
    nv = n.bit_length() - 1
    if 1 << nv != n:
        raise ValueError("table length must be a power of two")
    device = polys[0].device
    sufs = taus = None
    if eq_split is not None and nv > 0:
        if eq_split.shape[0] != nv:
            raise ValueError("eq_split needs one tau per variable")
        sufs = eq_suffix_tables(spec, eq_split)
        taus = [int(v) for v in F.to_int(spec, eq_split)]
        cfac = 1
    tables = list(polys)
    rs, rs_int, msgs = [], [], []
    for j in range(nv):
        evens = [p[0::2] for p in tables]
        slopes = [F.sub(spec, p[1::2], e) for p, e in zip(tables, evens)]
        cur = evens
        evals = []
        for t in range(degree + 1):
            if t:
                cur = [F.add(spec, c, s) for c, s in zip(cur, slopes)]
            args = ([sufs[j]] if sufs is not None else []) + cur
            evals.append(F.modsum(spec, comb(args)))
        msg = [int(v) for v in F.to_int(spec, torch.stack(evals))]
        if sufs is not None:
            msg = [v * cfac % m * _eq_int(taus[j], t, m) % m
                   for t, v in enumerate(msg)]
        transcript.absorb_many(msg)
        r_int = transcript.challenge()
        if sufs is not None:
            cfac = cfac * _eq_int(taus[j], r_int, m) % m
        r = F.from_int(spec, r_int, device=device)
        tables = [F.add(spec, e, F.mul(spec, s, r))
                  for e, s in zip(evens, slopes)]
        rs.append(r)
        rs_int.append(r_int)
        msgs.append(msg)
    challenges = (torch.stack(rs) if rs else
                  torch.zeros((0, F.NLIMBS), dtype=torch.int32, device=device))
    return SumcheckResult(challenges=challenges, challenge_ints=rs_int,
                          round_msgs=msgs, final_polys=[t[:1] for t in tables])


# --- host verification (copy of the JAX package's) ------------------------


def lagrange_eval_ints(evals, x: int, modulus: int) -> int:
    """Interpolate the degree-d poly through (i, evals[i]) and evaluate at x."""
    d = len(evals) - 1
    total = 0
    for i in range(d + 1):
        num, den = 1, 1
        for j in range(d + 1):
            if i == j:
                continue
            num = num * (x - j) % modulus
            den = den * (i - j) % modulus
        total = (total + evals[i] * num * pow(den, -1, modulus)) % modulus
    return total


def verify(round_msgs, claim: int, transcript: HostTranscript,
           modulus: int = FR.modulus):
    """Walk the rounds on the host: check s(0)+s(1) == claim, derive r_j.

    ``round_msgs``: [nv][degree+1] ints. Returns (challenges, final_claim).
    Raises ValueError on a failed round check.
    """
    rs = []
    for j, evals in enumerate(round_msgs):
        if (evals[0] + evals[1]) % modulus != claim % modulus:
            raise ValueError(f"sumcheck round {j}: s(0)+s(1) != claim")
        transcript.absorb_many(evals)
        r = transcript.challenge()
        claim = lagrange_eval_ints(evals, r, modulus)
        rs.append(r)
    return rs, claim
