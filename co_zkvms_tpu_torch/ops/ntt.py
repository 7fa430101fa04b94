"""Number-theoretic transform over BN254 Fr on one card: iterative radix-2.

As in the JAX package's ``ops/ntt.py``: one bit-reversal gather, then
log2(N) decimation-in-time butterfly stages over axis -2 of a
``[..., N, 8]`` Montgomery tensor. Each stage is one batched field product
of N/2 elements by twiddles strided out of a power table, one modular add
and one modular sub: glue over kernels B1 and B3 (``field.py``), with no
kernel of its own, as the JAX NTT has no Pallas kernel of its own.

The twiddle table w^j, j < N/2, is built in log2(N) doubling steps
(P[j + 2^i] = P[j] * w^(2^i): one batched product each) and cached per
(field, log_n, direction, device).

The meshed four-step variant (``ntt_mesh``) waits for the port's
multihost layer.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import field as F
from .field import FieldSpec


def two_adic_root(spec: FieldSpec, log_n: int, inverse: bool = False) -> int:
    """Primitive 2^log_n-th root of unity (host int, standard form).

    BN254 Fr has 2-adicity 28 with multiplicative generator 5 (matches
    arkworks' FrConfig so evaluation domains agree element-wise).
    """
    r = spec.modulus
    t, s = r - 1, 0
    while t % 2 == 0:
        t //= 2
        s += 1
    if log_n > s:
        raise ValueError(f"domain 2^{log_n} exceeds 2-adicity {s}")
    w = pow(5, t, r)
    assert pow(w, 1 << s, r) == 1 and pow(w, 1 << (s - 1), r) != 1
    w = pow(w, 1 << (s - log_n), r)
    if inverse:
        w = pow(w, r - 2, r)
    return w


@functools.lru_cache(maxsize=None)
def _twiddles(spec: FieldSpec, log_n: int, inverse: bool,
              device: torch.device):
    """[max(N/2, 1), 8]: w^j for j < N/2, Montgomery form, on ``device``."""
    w = two_adic_root(spec, log_n, inverse)
    p = F.ones_mont(spec, (1,), device)
    for i in range(max(log_n - 1, 0)):
        step = F.from_int(spec, [pow(w, 1 << i, spec.modulus)], device=device)
        p = torch.cat([p, F.mul(spec, p, step)], dim=0)
    return p


@functools.lru_cache(maxsize=None)
def _bitrev_idx(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def _butterfly_stages(spec: FieldSpec, x, tw, log_n: int):
    """log_n DIT stages over axis -2 of a bit-reversed [..., N, 8] tensor."""
    n = 1 << log_n
    lead = tuple(x.shape[:-2])
    for s in range(1, log_n + 1):
        m = 1 << s
        half = m >> 1
        stride = n // m
        xv = x.reshape(lead + (n // m, m, F.NLIMBS))
        u = xv[..., :half, :]
        v = xv[..., half:, :]
        t = F.mul(spec, v, tw[: half * stride: stride])
        x = torch.cat([F.add(spec, u, t), F.sub(spec, u, t)],
                      dim=-2).reshape(lead + (n, F.NLIMBS))
    return x


@functools.lru_cache(maxsize=None)
def _n_inv(spec: FieldSpec, log_n: int, device: torch.device):
    return F.from_int(spec, [pow(1 << log_n, spec.modulus - 2, spec.modulus)],
                      device=device)


def ntt(spec: FieldSpec, x, inverse: bool = False):
    """Forward/inverse NTT along axis -2 of a [..., N, 8] Montgomery tensor,
    on the tensor's device.

    Natural order in, natural order out; N must be a power of two within
    the field's 2-adic domain. ntt(intt(x)) == x; forward evaluates the
    coefficient vector on the 2^log_n roots-of-unity domain in standard
    order (w^0, w^1, ...), matching arkworks Radix2EvaluationDomain.fft.
    """
    n = x.shape[-2]
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError(f"NTT length must be a power of two, got {n}")
    idx = torch.from_numpy(_bitrev_idx(log_n)).to(x.device)
    y = torch.index_select(x, x.dim() - 2, idx)
    y = _butterfly_stages(spec, y, _twiddles(spec, log_n, inverse, x.device),
                          log_n)
    if inverse:
        y = F.mul(spec, y, _n_inv(spec, log_n, x.device)[0])
    return y


def intt(spec: FieldSpec, x):
    return ntt(spec, x, inverse=True)


def mul_polys(spec: FieldSpec, a, b):
    """Polynomial product via NTT (degree < N/2 each, length-N tensors)."""
    fa = ntt(spec, a)
    fb = ntt(spec, b)
    return intt(spec, F.mul(spec, fa, fb))
