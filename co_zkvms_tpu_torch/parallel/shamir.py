"""Shamir t-of-n secret sharing over Fr, of field elements and of G1 points.

As in the JAX package's ``parallel/shamir.py`` (which maps mpc-types'
shamir module, shamir.rs:20-432): shares of a batch of secrets are
evaluated on the device with the field kernels; Lagrange coefficients are
host ints (party ids are public), and with ``precompute_lagrange`` a fixed
subset's coefficients go to the device once, after which a reconstruction
is one batched product and a modular sum.

Point shares are S_i = P + sum_k i^k C_k with random coefficient points
C_k = r_k G; ``scalar_mul_public`` is the JAX package's 254-step
double-and-add (B6, B5) over the bits of a public scalar, MSB first, so
its Jacobian output equals the JAX package's.

``jax.random`` keys become ``torch.Generator`` objects: the shares differ
from the JAX package's, and any t + 1 of either package's shares
reconstruct through the other's functions.
"""

from __future__ import annotations

import torch

from ..ops import curve as C
from ..ops import field as F
from ..ops import msm as M
from ..ops import ref_bn254 as bn
from ..ops.curve import JPoint
from ..ops.field import FR, FieldSpec
from ..utils import build

MOD = FR.modulus
SCALAR_BITS = 254


def share(spec: FieldSpec, gen: torch.Generator, secret, t: int, n: int):
    """Degree-t polynomial sharing of ``secret`` [..., 8]: returns
    [n, ..., 8], party i at x = i + 1. The t random coefficients are drawn
    from ``gen`` (on its device) and moved to the secret's."""
    coeffs = [secret] + [F.random(spec, gen, secret.shape[:-1]).to(
        secret.device) for _ in range(t)]
    out = []
    for i in range(1, n + 1):
        # Horner at x = i (public small scalar)
        acc = coeffs[-1]
        for c in reversed(coeffs[:-1]):
            acc = F.add(spec, F.mul_small(spec, acc, i), c)
        out.append(acc)
    return torch.stack(out)


def lagrange_at(ids, x: int):
    """Lagrange coefficients for evaluating f(x) from shares at ``ids``."""
    lams = []
    for i in ids:
        num, den = 1, 1
        for j in ids:
            if j == i:
                continue
            num = num * (x - j) % MOD
            den = den * (i - j) % MOD
        lams.append(num * pow(den, -1, MOD) % MOD)
    return lams


def lagrange_at_zero(ids):
    """Lagrange coefficients lambda_i with sum lambda_i * f(id_i) = f(0)."""
    return lagrange_at(ids, 0)


def reconstruct(spec: FieldSpec, shares, ids):
    """Reconstruct from any t + 1 shares. ``shares``: [k, ..., 8] (or a
    list of k tensors); ids 1-based, in the same order."""
    acc = None
    for lam, sh in zip(lagrange_at_zero(list(ids)), shares):
        term = F.mul(spec, F.from_int(spec, lam, device=sh.device), sh)
        acc = term if acc is None else F.add(spec, acc, term)
    return acc


def precompute_lagrange(ids, x: int = 0, device="cuda"):
    """[k, 8] Montgomery Lagrange coefficients of a party subset, on
    ``device`` (shamir.rs lagrange_from_coeff)."""
    return F.from_int(FR, lagrange_at(list(ids), x),
                      device=build.resolve_device(device))


def reconstruct_precomputed(spec: FieldSpec, shares, lams_dev):
    """f(x) from shares [k, ..., 8] with precomputed coefficients: one
    batched product and a modular sum over the subset
    (interpolate_poly_from_precomputed)."""
    extra = shares.dim() - lams_dev.dim()
    lam = lams_dev.reshape(lams_dev.shape[:1] + (1,) * extra + (F.NLIMBS,))
    return F.modsum(spec, F.mul(spec, shares, lam), dim=0)


def interpolate_poly(spec: FieldSpec, shares, ids, xs):
    """The sharing polynomial at several public points ``xs``: [len(xs),
    ..., 8] (re-sharing to another party set)."""
    return torch.stack([
        reconstruct_precomputed(spec, shares, precompute_lagrange(
            ids, x, device=shares.device)) for x in xs])


# --- Shamir point shares ------------------------------------------------------


def scalar_mul_public(p: JPoint, k_int: int) -> JPoint:
    """k * P for a public host-int scalar, on every point of ``p``: from
    infinity, per bit of k mod r (MSB first, 254 bits) a doubling, then
    the complete add of P where the bit is set."""
    k = k_int % MOD
    acc = C.infinity(p.x.shape[:-1], p.x.device)
    for i in reversed(range(SCALAR_BITS)):
        acc = C.double(acc)
        if (k >> i) & 1:
            acc = C.add(acc, p)
    return acc


def _generator(device) -> C.APoint:
    g = C.points_from_ints([bn.g1_coords(bn.G1_GEN)], device=device)
    return C.APoint(g.x[0], g.y[0])


def random_points(gen: torch.Generator, count: int, device) -> JPoint:
    """``count`` uniform multiples r G, r drawn from ``gen``."""
    rs = F.random(FR, gen, (count,)).to(device)
    return M.fixed_base_msm(_generator(device), rs)


def share_point(gen: torch.Generator, p: JPoint, t: int, n: int) -> JPoint:
    """Degree-t point sharing: a JPoint with leading axis n (party i at
    x = i + 1). The coefficient points are r_k G for r_k drawn from
    ``gen``."""
    batch = tuple(p.x.shape[:-1])
    nb = 1
    for d in batch:
        nb *= d
    cs = random_points(gen, t * max(nb, 1), p.x.device)
    coeffs = JPoint(*(c.reshape((t,) + batch + (F.NLIMBS,)) for c in cs))
    out = []
    for i in range(1, n + 1):
        acc = p
        for k in range(1, t + 1):
            acc = C.add(acc, scalar_mul_public(C.index(coeffs, k - 1),
                                               pow(i, k)))
        out.append(acc)
    return JPoint(*(torch.stack(cs) for cs in zip(*out)))


def reconstruct_point(shares: JPoint, ids, x: int = 0) -> JPoint:
    """f(x) from point shares (leading axis: the subset, in the order of
    ``ids``): sum of lambda_i * S_i."""
    acc = None
    for idx, lam in enumerate(lagrange_at(list(ids), x)):
        term = scalar_mul_public(C.index(shares, idx), lam)
        acc = term if acc is None else C.add(acc, term)
    return acc
