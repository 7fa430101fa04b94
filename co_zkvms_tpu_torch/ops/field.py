"""BN254 prime-field arithmetic on torch tensors, with CUDA kernels for Hopper.

Layout, for the whole package: a field element is ``torch.int32 [..., 8]``,
the bit patterns of eight little-endian u32 limbs, kept in Montgomery form
with R = 2^256 between operations. It is the same integer as the JAX
package's ``uint32 [..., 16]`` array of 16-bit limbs (``utils/convert.py``
repacks one into the other), and a kernel reads 32 bytes per element.

Dispatch: ``mul``, ``square``, ``add`` and ``sub`` take tensors on
one device. On ``cuda`` they launch the kernels of
``ops/csrc/field_kernels.cu`` (B1, B2 and the B3 helpers of the JAX
package's ``ops/field_pallas.py``); on ``cpu`` they run the plain versions
below, which compute in int64 on 16-bit digits because torch has no uint32
arithmetic on the CPU. Any other device raises; nothing falls back from the
kernel to the plain version.

Sums (``modsum``, ``segment_modsum``) are lazy: canonical limbs are summed
as int64 without reduction and ``lazy_reduce`` brings the total back into
the field once, with two Montgomery products.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..utils import build

NLIMBS = 8
M16 = 0xFFFF
M32 = 0xFFFFFFFF
R_BITS = 256

FR_MODULUS = 21888242871839275222246405745257275088548364400416034343698204186575808495617
FQ_MODULUS = 21888242871839275222246405745257275088696311157297823662689037894645226208583


class FieldSpec(NamedTuple):
    """Static parameters of a prime field in 8 x 32-bit Montgomery form."""

    name: str
    fid: int                 # field id the kernels take: 0 = Fr, 1 = Fq
    modulus: int
    nprime: int              # -m^{-1} mod R (the REDC quotient factor)
    r_mod: int               # R mod m: Montgomery form of 1
    r2: int                  # R^2 mod m


def _make_spec(name: str, fid: int, modulus: int) -> FieldSpec:
    r = 1 << R_BITS
    return FieldSpec(
        name=name,
        fid=fid,
        modulus=modulus,
        nprime=(-pow(modulus, -1, r)) % r,
        r_mod=r % modulus,
        r2=(r * r) % modulus,
    )


FR = _make_spec("bn254_fr", 0, FR_MODULUS)
FQ = _make_spec("bn254_fq", 1, FQ_MODULUS)


# ---------------------------------------------------------------------------
# Host conversions between Python ints and limb tensors
# ---------------------------------------------------------------------------


def ints_to_words(values) -> np.ndarray:
    """Iterable of ints in [0, 2^256) -> uint32 [n, 8] little-endian words."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in values)
    return np.frombuffer(buf, dtype="<u4").reshape(-1, NLIMBS)


def words_to_ints(words: np.ndarray) -> list:
    """uint32/int32 [n, 8] words -> list of Python ints."""
    raw = np.ascontiguousarray(words).astype("<u4", copy=False).tobytes()
    return [int.from_bytes(raw[32 * i: 32 * i + 32], "little")
            for i in range(len(raw) // 32)]


def constant(spec: FieldSpec, value: int, device) -> torch.Tensor:
    words = ints_to_words([value]).view(np.int32)
    return torch.from_numpy(words[0].copy()).to(device)


def from_int(spec: FieldSpec, values, mont: bool = True, device="cuda"):
    """Python int(s) -> limb tensor [..., 8] on ``device`` (Montgomery form
    unless ``mont=False``). The reduction mod m runs on the host; the
    Montgomery conversion is one product with R^2 on the device."""
    device = build.resolve_device(device)
    if isinstance(values, (int, np.integer)):
        values = [values]
        shape = ()
    else:
        shape = np.shape(values)
    arr = np.asarray(values)
    if arr.dtype.kind in "iu" and arr.size and arr.min() >= 0:
        # fixed-width non-negative ints (< 2^64 < m): two words each,
        # without a Python loop
        v = arr.astype(np.uint64).ravel()
        words = np.zeros((v.size, NLIMBS), dtype=np.uint32)
        words[:, 0] = v & np.uint64(M32)
        words[:, 1] = v >> np.uint64(32)
    else:
        arr = np.asarray(values, dtype=object)
        words = ints_to_words([int(v) % spec.modulus for v in arr.ravel()])
    words = words.view(np.int32).reshape(tuple(shape) + (NLIMBS,))
    out = torch.from_numpy(words.copy()).to(device)
    return to_mont(spec, out) if mont else out


def to_int(spec: FieldSpec, limbs: torch.Tensor, mont: bool = True):
    """Limb tensor -> Python int (for [8]) or numpy object array of ints."""
    if mont:
        limbs = from_mont(spec, limbs)
    arr = limbs.detach().cpu().numpy()
    ints = words_to_ints(arr.reshape(-1, NLIMBS))
    if arr.ndim == 1:
        return ints[0]
    out = np.empty(len(ints), dtype=object)
    out[:] = ints
    return out.reshape(arr.shape[:-1])


def zeros(shape=(), device="cuda") -> torch.Tensor:
    return torch.zeros(tuple(shape) + (NLIMBS,), dtype=torch.int32,
                       device=build.resolve_device(device))


def ones_mont(spec: FieldSpec, shape=(), device="cuda") -> torch.Tensor:
    one = constant(spec, spec.r_mod, build.resolve_device(device))
    return one.expand(tuple(shape) + (NLIMBS,)).clone()


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """Elementwise zero test of field elements -> bool over the batch shape."""
    return (a == 0).all(dim=-1)


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Pick a where cond (batch-shaped bool) else b."""
    return torch.where(cond[..., None], a, b)


# ---------------------------------------------------------------------------
# Plain versions: int64 arithmetic on 16-bit digits (any device)
# ---------------------------------------------------------------------------

# rows per chunk of a plain product: bounds the [rows, 16, 32] int64
# temporaries when the plain version runs on the card as a kernel's oracle
_PLAIN_ROWS = 1 << 16


def as_u32(a: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return a.to(torch.int64) & M32


def _i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 bit patterns."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def _carry(x: torch.Tensor, bits: int):
    """Propagate carries through int64 base-2^bits digits (signed allowed):
    passes of (x & mask) + (x >> bits shifted up one digit) until no digit
    carries. Returns (canonical digits [..., k], carry out of the top)."""
    mask = (1 << bits) - 1
    carry_out = torch.zeros_like(x[..., 0])
    while True:
        hi = x >> bits
        if not bool(hi.any()):
            return x, carry_out
        carry_out = carry_out + hi[..., -1]
        x = (x & mask) + torch.nn.functional.pad(hi[..., :-1], (1, 0))


def _mod_words(spec: FieldSpec, device) -> torch.Tensor:
    return torch.tensor([(spec.modulus >> (32 * i)) & M32 for i in range(8)],
                        dtype=torch.int64, device=device)


def _cond_sub(spec: FieldSpec, limbs, hi_carry):
    """value = limbs + hi_carry * 2^256 (< 2m) -> value mod m, int64 limbs."""
    d, borrow = _carry(limbs - _mod_words(spec, limbs.device), 32)
    take = (hi_carry + borrow) >= 0
    return torch.where(take[..., None], d, limbs)


def _flat_pair(a, b):
    shape = torch.broadcast_shapes(a.shape, b.shape)
    return (a.expand(shape).reshape(-1, NLIMBS),
            b.expand(shape).reshape(-1, NLIMBS), shape)


def add_plain(spec: FieldSpec, a, b):
    """(a + b) mod m, canonical in and out."""
    x, y, shape = _flat_pair(a, b)
    s, carry = _carry(as_u32(x) + as_u32(y), 32)
    return _i32(_cond_sub(spec, s, carry)).reshape(shape)


def sub_plain(spec: FieldSpec, a, b):
    """(a - b) mod m."""
    x, y, shape = _flat_pair(a, b)
    d, borrow = _carry(as_u32(x) - as_u32(y), 32)
    fixed, _ = _carry(d + _mod_words(spec, d.device), 32)
    return _i32(torch.where((borrow < 0)[..., None], fixed, d)).reshape(shape)


def _digits16(words: torch.Tensor) -> torch.Tensor:
    """int32 [n, 8] -> int64 [n, 16] 16-bit digits, little-endian."""
    u = as_u32(words)
    return torch.stack([u & M16, u >> 16], dim=-1).reshape(-1, 16)


def _digits16_of(value: int, device) -> torch.Tensor:
    return torch.tensor([(value >> (16 * i)) & M16 for i in range(16)],
                        dtype=torch.int64, device=device)


def _product_columns(x, y):
    """Schoolbook 16 x 16 digit products summed into 31 loose columns
    (each < 2^36) by skewing row i right by i. y may be one [16] row."""
    n = x.shape[0]
    prods = x[:, :, None] * y[..., None, :]                     # < 2^32
    skew = torch.nn.functional.pad(prods, (0, 16)).reshape(n, 16 * 32)
    return skew[:, : 16 * 31].reshape(n, 16, 31).sum(dim=1)


def _mont_rows(spec: FieldSpec, x, y):
    """Montgomery product of [n, 8] rows (x < 2^256, y < m) -> int32 [n, 8].

    T = x y; q = T n' mod R with n' = -m^{-1} mod R; (T + q m) / R < 2m,
    then one conditional subtraction. The same value as digit-serial REDC
    (q is unique mod R), computed with three column products."""
    dev = x.device
    t, _ = _carry(torch.nn.functional.pad(
        _product_columns(_digits16(x), _digits16(y)), (0, 1)), 16)
    q, _ = _carry(_product_columns(
        t[:, :16], _digits16_of(spec.nprime, dev))[:, :16], 16)
    s = t + torch.nn.functional.pad(
        _product_columns(q, _digits16_of(spec.modulus, dev)), (0, 1))
    s, top = _carry(s, 16)
    hi = s[:, 16:]                                # s[:, :16] == 0
    limbs = hi[:, 0::2] | (hi[:, 1::2] << 16)
    return _i32(_cond_sub(spec, limbs, top))


def mul_plain(spec: FieldSpec, a, b):
    """Montgomery product a * b * R^{-1} mod m (a < 2^256, b < m)."""
    x, y, shape = _flat_pair(a, b)
    n = x.shape[0]
    if n <= _PLAIN_ROWS:
        return _mont_rows(spec, x, y).reshape(shape)
    out = torch.empty((n, NLIMBS), dtype=torch.int32, device=x.device)
    for s in range(0, n, _PLAIN_ROWS):
        out[s:s + _PLAIN_ROWS] = _mont_rows(spec, x[s:s + _PLAIN_ROWS],
                                            y[s:s + _PLAIN_ROWS])
    return out.reshape(shape)


def square_plain(spec: FieldSpec, a):
    """Montgomery square a * a * R^{-1} mod m (a < m)."""
    return mul_plain(spec, a, a)


# ---------------------------------------------------------------------------
# Kernel wrappers (B1, B2, B3) and dispatch
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_BIN_ARGS = [_P, _P, _P, _I64, _I64, _I64, ctypes.c_int, _P]
_UN_ARGS = [_P, _P, _I64, _I64, ctypes.c_int, _P]

_FP = "co_zkvms_tpu/ops/field_pallas.py"
FP_MUL = build.KernelFn("fp_mul", "field_kernels", "fp_mul", _BIN_ARGS,
                        replaces=f"{_FP}:211")
FP_SQUARE = build.KernelFn("fp_square", "field_kernels", "fp_square",
                           _UN_ARGS, replaces=f"{_FP}:166")
FP_ADD = build.KernelFn("fp_add", "field_kernels", "fp_add", _BIN_ARGS,
                        replaces=f"{_FP}:113")
FP_SUB = build.KernelFn("fp_sub", "field_kernels", "fp_sub", _BIN_ARGS,
                        replaces=f"{_FP}:124")


def _elem_stride(x: torch.Tensor, shape) -> tuple:
    """(tensor, element stride) a kernel can read as x[i * stride]:
    stride 0 for one broadcast element, the row stride of a [n, 8] view
    whose limbs are contiguous (even/odd halves), else a contiguous copy."""
    if x.numel() == NLIMBS:
        return x.contiguous(), 0
    if tuple(x.shape) == tuple(shape):
        if x.is_contiguous():
            return x, 1
        if x.dim() == 2 and x.stride(1) == 1 and x.stride(0) % NLIMBS == 0:
            return x, x.stride(0) // NLIMBS
    return x.expand(shape).contiguous(), 1


def _check(x: torch.Tensor, device):
    if x.dtype != torch.int32 or x.shape[-1] != NLIMBS:
        raise TypeError(f"field element tensors are int32 [..., 8], got "
                        f"{x.dtype} {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"operands on {x.device} and {device}")


def _launch_binary(kfn: build.KernelFn, spec: FieldSpec, a, b):
    device = a.device
    _check(a, device)
    _check(b, device)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    out = torch.empty(shape, dtype=torch.int32, device=device)
    n = out.numel() // NLIMBS
    if n == 0:
        return out
    x, sa = _elem_stride(a, shape)
    y, sb = _elem_stride(b, shape)
    kfn(x.data_ptr(), y.data_ptr(), out.data_ptr(), n, sa, sb, spec.fid,
        build.stream_ptr(device))
    return out


def _launch_unary(kfn: build.KernelFn, spec: FieldSpec, a):
    _check(a, a.device)
    out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    n = out.numel() // NLIMBS
    if n == 0:
        return out
    x, sa = _elem_stride(a, a.shape)
    kfn(x.data_ptr(), out.data_ptr(), n, sa, spec.fid,
        build.stream_ptr(a.device))
    return out


def on_cpu(*ts) -> bool:
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"field operands must all lie on cpu or on cuda, got "
                     f"{sorted(kinds)}")


def mul(spec: FieldSpec, a, b):
    """Montgomery product a * b * R^{-1} mod m (kernel B1 on cuda)."""
    if on_cpu(a, b):
        return mul_plain(spec, a, b)
    return _launch_binary(FP_MUL, spec, a, b)


def square(spec: FieldSpec, a):
    """Montgomery square (kernel B2 on cuda). Requires a < m."""
    if on_cpu(a):
        return square_plain(spec, a)
    return _launch_unary(FP_SQUARE, spec, a)


def add(spec: FieldSpec, a, b):
    """(a + b) mod m (B3 ``_madd`` as a kernel on cuda)."""
    if on_cpu(a, b):
        return add_plain(spec, a, b)
    return _launch_binary(FP_ADD, spec, a, b)


def sub(spec: FieldSpec, a, b):
    """(a - b) mod m (B3 ``_msub`` as a kernel on cuda)."""
    if on_cpu(a, b):
        return sub_plain(spec, a, b)
    return _launch_binary(FP_SUB, spec, a, b)


def neg(spec: FieldSpec, a):
    """(-a) mod m, as 0 - a."""
    return sub(spec, torch.zeros_like(a), a)


# ---------------------------------------------------------------------------
# Derived operations (glue over the kernels)
# ---------------------------------------------------------------------------


def to_mont(spec: FieldSpec, a):
    """Standard -> Montgomery form (a * R mod m); a < m."""
    return mul(spec, a, constant(spec, spec.r2, a.device))


def from_mont(spec: FieldSpec, a):
    """Montgomery -> standard form (a * R^{-1} mod m)."""
    return mul(spec, a, constant(spec, 1, a.device))


def mul_small(spec: FieldSpec, a, k: int):
    """a * k for a small host constant k >= 0, by an addition chain."""
    if k == 0:
        return torch.zeros_like(a)
    acc = None
    base = a
    while k:
        if k & 1:
            acc = base if acc is None else add(spec, acc, base)
        k >>= 1
        if k:
            base = add(spec, base, base)
    return acc


def pow_const(spec: FieldSpec, a, e: int):
    """a^e for a host exponent e (square-and-multiply, Montgomery in/out)."""
    result = None
    base = a
    while e:
        if e & 1:
            result = base if result is None else mul(spec, result, base)
        e >>= 1
        if e:
            base = square(spec, base)
    if result is None:
        return ones_mont(spec, a.shape[:-1], a.device)
    return result


def inv(spec: FieldSpec, a):
    """a^{-1} via Fermat (a^{m-2}). Montgomery in/out. inv(0) = 0."""
    return pow_const(spec, a, spec.modulus - 2)


def batch_inv(spec: FieldSpec, a):
    """Inversion of every row of ``a`` [N, 8], tree-structured: a product
    tree up, the root inverted on the host (one element), the inverse tree
    down (2 log2 N full-width products, as the JAX package's ``batch_inv``).
    Zero rows map to zero."""
    n = a.shape[0]
    if n == 0:
        return a
    zero = is_zero(a)
    one = ones_mont(spec, (), a.device)
    safe = select(zero, one.expand(a.shape), a)
    m = 1 << max(0, (n - 1).bit_length())
    if m != n:
        safe = torch.cat([safe, one.expand(m - n, NLIMBS)], dim=0)
    levels = [safe]
    cur = safe
    while cur.shape[0] > 1:
        cur = mul(spec, cur[0::2], cur[1::2])
        levels.append(cur)
    root = to_int(spec, cur[0])
    invs = from_int(spec, pow(root, -1, spec.modulus) if root else 0,
                    device=a.device)[None]
    for lvl in reversed(levels[:-1]):
        inv_left = mul(spec, invs, lvl[1::2])
        inv_right = mul(spec, invs, lvl[0::2])
        invs = torch.stack([inv_left, inv_right], dim=1).reshape(-1, NLIMBS)
    return select(zero, torch.zeros_like(a), invs[:n])


def _reduce_wide(spec: FieldSpec, lo, hi, mul_fn, add_fn):
    """(lo + hi * 2^256) mod m for lo, hi < 2^256 as int32 [..., 8]:
    lo mod m = mont(lo, R mod m), hi * 2^256 mod m = mont(hi, R^2 mod m),
    then one modular add (domain passes through)."""
    a = mul_fn(spec, lo, constant(spec, spec.r_mod, lo.device))
    b = mul_fn(spec, hi, constant(spec, spec.r2, lo.device))
    return add_fn(spec, a, b)


def _lazy_reduce_with(spec: FieldSpec, loose, mul_fn, add_fn):
    limbs, top = _carry(loose, 32)
    lo = _i32(limbs)
    hi = torch.zeros_like(lo)
    hi[..., 0] = _i32(top)
    return _reduce_wide(spec, lo, hi, mul_fn, add_fn)


def lazy_reduce(spec: FieldSpec, loose: torch.Tensor):
    """Loose int64 base-2^32 digit sums [..., 8] (value < 2^287) -> the
    canonical element with the same residue (domain passes through).

    value = lo + hi * 2^256 with lo < 2^256 and hi < 2^31 after one carry
    pass, reduced by ``_reduce_wide``."""
    return _lazy_reduce_with(spec, loose, mul, add)


def modsum(spec: FieldSpec, arr: torch.Tensor, dim: int = 0):
    """Modular sum along ``dim`` (not the limb axis); < 2^31 terms."""
    return lazy_reduce(spec, as_u32(arr).sum(dim=dim))


def modsum_plain(spec: FieldSpec, arr: torch.Tensor, dim: int = 0):
    """``modsum`` through the plain versions only (no kernel launches), for
    the plain versions of other kernels."""
    return _lazy_reduce_with(spec, as_u32(arr).sum(dim=dim), mul_plain,
                             add_plain)


def random(spec: FieldSpec, gen: torch.Generator, shape=()):
    """Uniform field elements [*shape, 8] on ``gen``'s device.

    Draws 512 random bits x = lo + hi * 2^256 and returns x mod m (bias
    about 2^-256). As a Montgomery value that is the form of another
    uniform element, so it is uniform in either domain."""
    return from_random_words(spec, random_words(gen, shape))


def random_words(gen: torch.Generator, shape=()) -> torch.Tensor:
    """512 random bits per element, int32 [*shape, 2, 8], on ``gen``'s
    device."""
    return torch.randint(0, 1 << 32, tuple(shape) + (2, NLIMBS),
                         generator=gen, dtype=torch.int64,
                         device=gen.device).to(torch.int32)


def from_random_words(spec: FieldSpec, words: torch.Tensor):
    """[..., 2, 8] words x = lo + hi * 2^256 -> x mod m [..., 8], on the
    words' device."""
    return _reduce_wide(spec, words[..., 0, :], words[..., 1, :], mul, add)


def segment_modsum(spec: FieldSpec, values, segment_ids, num_segments: int):
    """out[s] = sum of values[i] with segment_ids[i] == s (mod m)."""
    loose = torch.zeros((num_segments, NLIMBS), dtype=torch.int64,
                        device=values.device)
    loose.index_add_(0, segment_ids, as_u32(values))
    return lazy_reduce(spec, loose)
