"""Carry state between the JAX package and the port, as numpy arrays.

The JAX package stores a field element as ``uint32 [..., 16]`` 16-bit limbs
and the port as ``int32 [..., 8]`` 32-bit limbs; both are Montgomery form
with R = 2^256, so the integer is the same and conversion is a repack.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ref_bn254 as bn
from ..ops import pst13
from ..ops.curve import APoint, JPoint
from ..utils import build


def fe_from_limbs16(arr, device="cpu") -> torch.Tensor:
    """JAX-layout limbs uint32 [..., 16] -> port limbs int32 [..., 8]."""
    a = np.asarray(arr).astype(np.uint32)
    if a.shape[-1] != 16:
        raise ValueError(f"expected [..., 16] limbs, got {a.shape}")
    words = (a[..., 0::2] | (a[..., 1::2] << np.uint32(16))).astype(np.uint32)
    return torch.from_numpy(words.view(np.int32).copy()).to(
        build.resolve_device(device))


def fe_to_limbs16(t: torch.Tensor) -> np.ndarray:
    """Port limbs int32 [..., 8] -> JAX-layout limbs uint32 [..., 16]."""
    words = t.detach().cpu().numpy().view(np.uint32)
    out = np.empty(words.shape[:-1] + (16,), dtype=np.uint32)
    out[..., 0::2] = words & np.uint32(0xFFFF)
    out[..., 1::2] = words >> np.uint32(16)
    return out


def point_from_limbs16(p, device="cpu"):
    """A JAX ``APoint``/``JPoint`` (any tuple of [..., 16] coordinate
    arrays) -> the port's point of the same kind."""
    coords = [fe_from_limbs16(np.asarray(c), device) for c in p]
    return (APoint if len(coords) == 2 else JPoint)(*coords)


def point_to_limbs16(p) -> tuple:
    """A port point -> tuple of JAX-layout coordinate arrays."""
    return tuple(fe_to_limbs16(c) for c in p)


def srs_from_raw(raw: dict, device="cpu") -> pst13.SRS:
    """The ``{"nv", "levels", "h_taus"}`` dict of a ``.srs_cache`` pickle
    (levels: (x, y) [n, 16] arrays; h_taus: G2 coefficient tuples)."""
    levels = tuple(APoint(fe_from_limbs16(x, device), fe_from_limbs16(y, device))
                   for x, y in raw["levels"])
    h_taus = tuple((bn.FQ2(ht[0]), bn.FQ2(ht[1])) for ht in raw["h_taus"])
    return pst13.SRS(nv=raw["nv"], ck_levels=levels, h_taus=h_taus)
