"""Batched BN254 G1 arithmetic in Jacobian coordinates on limb tensors.

A point batch is a NamedTuple of Fq coordinate tensors ``int32 [..., 8]``
(Montgomery form, see ``field.py``):

- ``JPoint(x, y, z)``: affine (x/z^2, y/z^3); infinity is z == 0, created as
  (1, 1, 0) in Montgomery form.
- ``APoint(x, y)``: infinity is (0, 0) (not on y^2 = x^3 + 3).

``add_mixed``, ``add``, ``double`` and ``add_incomplete`` launch the kernels
of ``ops/csrc/g1.cu`` (B4-B7 of the JAX package's ``ops/curve_pallas.py``)
on cuda tensors and run the plain versions below on cpu tensors. The plain
versions use the same formulas and edge-case rules as the kernels, so both
give the same Jacobian coordinates bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import field as F
from .field import FQ
from ..utils import build


class JPoint(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


class APoint(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor


def infinity(shape=(), device="cuda") -> JPoint:
    one = F.ones_mont(FQ, shape, device)
    return JPoint(one, one.clone(), F.zeros(shape, device))


def affine_is_infinity(p: APoint) -> torch.Tensor:
    return F.is_zero(p.x) & F.is_zero(p.y)


def select(mask, p, q):
    """Pointwise select between two equally shaped point tuples."""
    return type(p)(*(F.select(mask, a, b) for a, b in zip(p, q)))


def from_affine(p: APoint) -> JPoint:
    inf = affine_is_infinity(p)
    one = F.ones_mont(FQ, p.x.shape[:-1], p.x.device)
    j = JPoint(p.x, p.y, one)
    return select(inf, infinity(p.x.shape[:-1], p.x.device), j)


def neg(p: JPoint) -> JPoint:
    return JPoint(p.x, F.neg(FQ, p.y), p.z)


def index(p, idx):
    """Rows ``idx`` of every coordinate (any torch index)."""
    return type(p)(*(c[idx] for c in p))


def cat(points, dim: int = 0):
    return type(points[0])(*(torch.cat(cs, dim=dim) for cs in zip(*points)))


# ---------------------------------------------------------------------------
# Plain versions (any device): the same formulas as ops/csrc/g1.cuh
# ---------------------------------------------------------------------------


def _mul(a, b):
    return F.mul_plain(FQ, a, b)


def _sq(a):
    return F.square_plain(FQ, a)


def _add(a, b):
    return F.add_plain(FQ, a, b)


def _sub(a, b):
    return F.sub_plain(FQ, a, b)


def _dbl(a):
    return F.add_plain(FQ, a, a)


def _broadcast(*coords):
    shape = torch.broadcast_shapes(*(c.shape for c in coords))
    return [c.expand(shape) for c in coords]


def _infinity_like(t: torch.Tensor) -> JPoint:
    one = F.constant(FQ, FQ.r_mod, t.device).expand(t.shape)
    return JPoint(one, one, torch.zeros_like(t))


def _check_times(times: int) -> None:
    if times < 1:
        raise ValueError(f"doublings: times >= 1, got {times}")


def double_plain(p: JPoint, times: int = 1) -> JPoint:
    """``times`` doublings (>= 1), each dbl-2009-l (a = 0): 2M + 5S."""
    _check_times(times)
    for _ in range(times):
        a = _sq(p.x)
        b = _sq(p.y)
        c = _sq(b)
        d = _dbl(_sub(_sub(_sq(_add(p.x, b)), a), c))
        e = _add(_dbl(a), a)
        f = _sq(e)
        x3 = _sub(f, _dbl(d))
        y3 = _sub(_mul(e, _sub(d, x3)), _dbl(_dbl(_dbl(c))))
        z3 = _dbl(_mul(p.y, p.z))
        p = JPoint(x3, y3, z3)
    return p


def add_mixed_plain(p: JPoint, q: APoint) -> JPoint:
    """Complete Jacobian + affine addition (madd-2007-bl + edge cases)."""
    px, py, pz, qx, qy = _broadcast(p.x, p.y, p.z, q.x, q.y)
    p = JPoint(px, py, pz)
    z1z1 = _sq(pz)
    u2 = _mul(qx, z1z1)
    s2 = _mul(qy, _mul(pz, z1z1))
    h = _sub(u2, px)
    r = _sub(s2, py)
    hh = _sq(h)
    i = _dbl(_dbl(hh))
    j = _mul(h, i)
    rr = _dbl(r)
    v = _mul(px, i)
    x3 = _sub(_sub(_sq(rr), j), _dbl(v))
    y3 = _sub(_mul(rr, _sub(v, x3)), _dbl(_mul(py, j)))
    z3 = _sub(_sub(_sq(_add(pz, h)), z1z1), hh)
    res = JPoint(x3, y3, z3)

    p_inf = F.is_zero(pz)
    q_inf = F.is_zero(qx) & F.is_zero(qy)
    both = ~p_inf & ~q_inf
    h_zero = F.is_zero(h)
    r_zero = F.is_zero(r)
    eq_case = h_zero & r_zero & both
    neg_case = h_zero & ~r_zero & both
    inf = _infinity_like(px)
    if bool(eq_case.any()):
        res = select(eq_case, double_plain(p), res)
    res = select(neg_case, inf, res)
    res = select(q_inf, p, res)
    one = F.constant(FQ, FQ.r_mod, px.device).expand(px.shape)
    lifted = select(q_inf, inf, JPoint(qx, qy, one))
    return select(p_inf, lifted, res)


def _add_generic(p: JPoint, q: JPoint):
    z1z1 = _sq(p.z)
    z2z2 = _sq(q.z)
    u1 = _mul(p.x, z2z2)
    u2 = _mul(q.x, z1z1)
    s1 = _mul(p.y, _mul(q.z, z2z2))
    s2 = _mul(q.y, _mul(p.z, z1z1))
    h = _sub(u2, u1)
    r = _sub(s2, s1)
    i = _sq(_dbl(h))
    j = _mul(h, i)
    rr = _dbl(r)
    v = _mul(u1, i)
    x3 = _sub(_sub(_sq(rr), j), _dbl(v))
    y3 = _sub(_mul(rr, _sub(v, x3)), _dbl(_mul(s1, j)))
    z3 = _mul(_sub(_sub(_sq(_add(p.z, q.z)), z1z1), z2z2), h)
    return JPoint(x3, y3, z3), h, r


def add_plain(p: JPoint, q: JPoint) -> JPoint:
    """Complete Jacobian addition (add-2007-bl + edge cases)."""
    px, py, pz, qx, qy, qz = _broadcast(*p, *q)
    p, q = JPoint(px, py, pz), JPoint(qx, qy, qz)
    res, h, r = _add_generic(p, q)
    p_inf = F.is_zero(pz)
    q_inf = F.is_zero(qz)
    both = ~p_inf & ~q_inf
    h_zero = F.is_zero(h)
    r_zero = F.is_zero(r)
    eq_case = h_zero & r_zero & both
    neg_case = h_zero & ~r_zero & both
    if bool(eq_case.any()):
        res = select(eq_case, double_plain(p), res)
    res = select(neg_case, _infinity_like(px), res)
    res = select(q_inf, p, res)
    return select(p_inf, q, res)


def add_incomplete_plain(p: JPoint, q: JPoint) -> JPoint:
    """Jacobian addition without the doubling path (disjoint subset sums
    only; a collision yields z == 0). Infinity operands are exact."""
    px, py, pz, qx, qy, qz = _broadcast(*p, *q)
    p, q = JPoint(px, py, pz), JPoint(qx, qy, qz)
    res, _, _ = _add_generic(p, q)
    res = select(F.is_zero(qz), p, res)
    return select(F.is_zero(pz), q, res)


# ---------------------------------------------------------------------------
# Kernel wrappers (B4-B7) and dispatch
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_N = ctypes.c_longlong
_CP = "co_zkvms_tpu/ops/curve_pallas.py"
G1_ADD_MIXED = build.KernelFn("g1_add_mixed", "g1", "g1_add_mixed",
                              [_P] * 8 + [_N, _P], replaces=f"{_CP}:383")
G1_ADD = build.KernelFn("g1_add", "g1", "g1_add",
                        [_P] * 9 + [_N, ctypes.c_int, _P],
                        replaces=f"{_CP}:409")
G1_DOUBLE = build.KernelFn("g1_double", "g1", "g1_double",
                           [_P] * 6 + [_N, ctypes.c_int, _P],
                           replaces=f"{_CP}:456")
G1_ADD_INCOMPLETE = build.KernelFn("g1_add_incomplete", "g1",
                                   "g1_add_incomplete",
                                   [_P] * 9 + [_N, ctypes.c_int, _P],
                                   replaces=f"{_CP}:432")
# B5 and B7 take their block size from the caller
_SIZED = (G1_ADD, G1_ADD_INCOMPLETE)
ADD_BLOCK_SIZES = (128, 64, 32)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    # once per device: B5 and B7 run thousands of times a prove
    return torch.cuda.get_device_properties(device).multi_processor_count


def add_block_threads(n: int, device) -> int:
    """Block size of B5 and B7 for n points: the largest of 128, 64 and 32
    threads whose blocks still cover every SM, else 32 (a launch that small
    is bound by one thread's chain of products, so it spreads as wide as it
    can)."""
    sms = _sm_count(torch.device(device))
    for t in ADD_BLOCK_SIZES:
        if -(-n // t) >= sms:
            return t
    return ADD_BLOCK_SIZES[-1]


def _flat_coords(coords):
    """Broadcast coordinates to one batch shape, each as a contiguous
    [n, 8] int32 cuda tensor. Returns (flat list, batch shape)."""
    device = coords[0].device
    for c in coords:
        if c.dtype != torch.int32 or c.shape[-1] != F.NLIMBS:
            raise TypeError(f"point coordinates are int32 [..., 8], got "
                            f"{c.dtype} {tuple(c.shape)}")
        if c.device != device:
            raise ValueError(f"coordinates on {c.device} and {device}")
    shape = torch.broadcast_shapes(*(c.shape for c in coords))
    flat = [c.expand(shape).reshape(-1, F.NLIMBS).contiguous() for c in coords]
    return flat, shape


def _launch(kfn: build.KernelFn, coords, threads: int | None = None,
            extra: tuple = ()) -> JPoint:
    """One launch of ``kfn`` over the broadcast batch. B5 and B7 take a
    block size: ``threads``, or ``add_block_threads`` of the batch; B6 its
    count of doublings in ``extra``."""
    flat, shape = _flat_coords(coords)
    device = flat[0].device
    out = [torch.empty(shape, dtype=torch.int32, device=device)
           for _ in range(3)]
    n = flat[0].shape[0]
    if n:
        sized = ()
        if kfn in _SIZED:
            sized = (threads or add_block_threads(n, device),)
        kfn(*(c.data_ptr() for c in flat), *(o.data_ptr() for o in out), n,
            *sized, *extra, build.stream_ptr(device))
    return JPoint(*out)


def add_mixed(p: JPoint, q: APoint) -> JPoint:
    """Complete mixed addition (kernel B4 on cuda)."""
    if F.on_cpu(*p, *q):
        return add_mixed_plain(p, q)
    return _launch(G1_ADD_MIXED, [*p, *q])


def add(p: JPoint, q: JPoint) -> JPoint:
    """Complete Jacobian addition (kernel B5 on cuda)."""
    if F.on_cpu(*p, *q):
        return add_plain(p, q)
    return _launch(G1_ADD, [*p, *q])


def double(p: JPoint, times: int = 1) -> JPoint:
    """2^times p by ``times`` Jacobian doublings (kernel B6 on cuda: one
    launch, the point in registers throughout)."""
    if F.on_cpu(*p):
        return double_plain(p, times)
    _check_times(times)
    return _launch(G1_DOUBLE, list(p), extra=(times,))


def add_incomplete(p: JPoint, q: JPoint) -> JPoint:
    """Incomplete Jacobian addition for disjoint subset sums (kernel B7)."""
    if F.on_cpu(*p, *q):
        return add_incomplete_plain(p, q)
    return _launch(G1_ADD_INCOMPLETE, [*p, *q])


# ---------------------------------------------------------------------------
# Glue
# ---------------------------------------------------------------------------


def to_affine(p: JPoint) -> APoint:
    """Jacobian -> affine through one batched inversion. Infinity -> (0, 0)."""
    shape = p.z.shape
    zinv = F.batch_inv(FQ, p.z.reshape(-1, F.NLIMBS)).reshape(shape)
    zinv2 = F.square(FQ, zinv)
    zinv3 = F.mul(FQ, zinv2, zinv)
    return APoint(F.mul(FQ, p.x, zinv2), F.mul(FQ, p.y, zinv3))


def tree_sum(p: JPoint) -> JPoint:
    """Sum a batch over the leading axis, log depth; returns a batch of 1.
    Odd tails fold into row 0 of each level (complete adds)."""
    n = p.x.shape[0]
    if n == 0:
        return infinity((1,), p.x.device)
    while n > 1:
        half = n // 2
        merged = add(index(p, slice(0, half)), index(p, slice(half, 2 * half)))
        if n % 2:
            first = add(index(merged, slice(0, 1)), index(p, slice(n - 1, n)))
            merged = cat([first, index(merged, slice(1, None))])
        p = merged
        n = half
    return p


def points_from_ints(xy_list, device="cuda") -> APoint:
    """List of (x, y) ints ((0, 0) = infinity) -> APoint batch."""
    xs = F.from_int(FQ, [x for x, _ in xy_list], device=device)
    ys = F.from_int(FQ, [y for _, y in xy_list], device=device)
    return APoint(xs, ys)


def points_to_ints(p: APoint) -> list:
    """APoint batch -> list of (x, y) int pairs."""
    xs = np.atleast_1d(F.to_int(FQ, p.x))
    ys = np.atleast_1d(F.to_int(FQ, p.y))
    return [(int(a), int(b)) for a, b in zip(xs.ravel(), ys.ravel())]
