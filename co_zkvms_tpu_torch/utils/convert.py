"""Carry state between the JAX package and the port, as numpy arrays and
host ints.

The JAX package stores a field element as ``uint32 [..., 16]`` 16-bit limbs
and the port as ``int32 [..., 8]`` 32-bit limbs; both are Montgomery form
with R = 2^256, so the integer is the same and conversion is a repack. A
Rep3 share stack ``[3, N, 16]`` converts like any other array.

Host objects (G1/G2 points of ``ref_bn254``, zk parameters, DFS verifier
keys, proofs) convert field by field; the NamedTuples of both packages have
the same names and fields, so ``retype`` rebuilds a port proof as the JAX
package's classes (and back) without importing either package here.

Functions that make tensors run on ``cuda`` unless the caller passes
``device="cpu"``, like every entry point of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ref_bn254 as bn
from ..ops import pst13
from ..ops.curve import APoint, JPoint
from ..utils import build


def fe_from_limbs16(arr, device="cuda") -> torch.Tensor:
    """JAX-layout limbs uint32 [..., 16] -> port limbs int32 [..., 8]
    (any leading shape: a table, a point coordinate, a [3, N] share
    stack)."""
    device = build.resolve_device(device)
    a = np.asarray(arr).astype(np.uint32)
    if a.shape[-1] != 16:
        raise ValueError(f"expected [..., 16] limbs, got {a.shape}")
    words = (a[..., 0::2] | (a[..., 1::2] << np.uint32(16))).astype(np.uint32)
    return torch.from_numpy(words.view(np.int32).copy()).to(device)


def fe_to_limbs16(t: torch.Tensor) -> np.ndarray:
    """Port limbs int32 [..., 8] -> JAX-layout limbs uint32 [..., 16]."""
    words = t.detach().cpu().numpy().view(np.uint32)
    out = np.empty(words.shape[:-1] + (16,), dtype=np.uint32)
    out[..., 0::2] = words & np.uint32(0xFFFF)
    out[..., 1::2] = words >> np.uint32(16)
    return out


def point_from_limbs16(p, device="cuda"):
    """A JAX ``APoint``/``JPoint`` (any tuple of [..., 16] coordinate
    arrays) -> the port's point of the same kind."""
    coords = [fe_from_limbs16(np.asarray(c), device) for c in p]
    return (APoint if len(coords) == 2 else JPoint)(*coords)


def point_to_limbs16(p) -> tuple:
    """A port point -> tuple of JAX-layout coordinate arrays."""
    return tuple(fe_to_limbs16(c) for c in p)


def srs_from_raw(raw: dict, device="cuda") -> pst13.SRS:
    """The ``{"nv", "levels", "h_taus"}`` dict of a ``.srs_cache`` pickle
    (levels: (x, y) [n, 16] arrays; h_taus: G2 coefficient tuples)."""
    levels = tuple(APoint(fe_from_limbs16(x, device), fe_from_limbs16(y, device))
                   for x, y in raw["levels"])
    h_taus = tuple((bn.FQ2(ht[0]), bn.FQ2(ht[1])) for ht in raw["h_taus"])
    return pst13.SRS(nv=raw["nv"], ck_levels=levels, h_taus=h_taus)


def host_point(pt):
    """An affine ``ref_bn254`` point of either package (None = infinity)
    -> the port's: coordinates with one coefficient are G1, two G2."""
    if pt is None:
        return None
    cls = bn.FQ1 if len(pt[0].coeffs) == 1 else bn.FQ2
    return tuple(cls(tuple(c.coeffs)) for c in pt)


def zk_params_from(p):
    """A JAX ``zk.ZkParams`` -> the port's ``ZkParams``."""
    from ..ops import zk

    return zk.ZkParams(
        nv=p.nv, max_deg=p.max_deg,
        g_taus=tuple(host_point(q) for q in p.g_taus),
        g_beta_pows=tuple(host_point(q) for q in p.g_beta_pows),
        h_beta=host_point(p.h_beta), beta_seeded=p.beta_seeded)


def dfs_vk_from(vk):
    """A JAX ``spartan_dfs.DFSVerifierKey`` (commitments included) -> the
    port's."""
    from ..models import spartan_dfs

    return spartan_dfs.DFSVerifierKey(
        nv=vk.nv, dlog=vk.dlog, dd=vk.dd,
        comms={k: pst13.Commitment(xy=tuple(c.xy))
               for k, c in vk.comms.items()})


def retype(obj, classes: dict):
    """Rebuild every NamedTuple inside ``obj`` (proofs, openings, zk data)
    as the class of the same name in ``classes``; lists, tuples, dicts and
    ints pass through. E.g. a port ``SpartanProof`` -> the JAX package's,
    for its host verifier."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        cls = classes[type(obj).__name__]
        return cls(**{f: retype(getattr(obj, f), classes)
                      for f in obj._fields})
    if isinstance(obj, dict):
        return {k: retype(v, classes) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(retype(v, classes) for v in obj)
    return obj
