"""Poseidon permutation over BN254 Fr: kernel B12 for t = 3, a composition
over the field kernels for t = 4 and 5, and a host mirror.

The instance is the JAX package's (``ops/poseidon.py``), copied here:

- x^5 S-box, width t in {3, 4, 5}; R_F = 8 full rounds and the per-width
  partial-round counts from the Poseidon paper's 128-bit BN254 table;
- round constants from the paper's Grain LFSR procedure (80-bit state,
  160 discarded warm-up bits, shrinking decimation, rejection sampling to
  < r), seeded with the (field, sbox, n, t, R_F, R_P) header;
- MDS: Cauchy matrix 1/(x_i + y_j) over further Grain samples (resampled
  if any pair collides), checked invertible.

A batch of states is ``int32 [..., t, 8]`` Montgomery (``field.py``).
``permute`` sends t = 3 to kernel B12 (``ops/csrc/poseidon.cu``) at every
batch size on the card, and to its plain version ``permute_plain`` on the
CPU; t = 4 and 5 run the same rounds over ``field.mul``/``square``/``add``
(B1-B3 on the card). Every value is a canonical residue, so all three give
the same integers as ``host_permute`` and as the JAX package.

Uses: a batched two-to-one hash for Merkle layers (``hash2``,
``merkle_layer``) and an Fr-native Fiat-Shamir transcript
(``transcript_*``, mirrored on the host by ``HostPoseidonTranscript``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import field as F
from .field import FR
from ..utils import build

R_FULL = 8
# partial rounds for x^5, 254-bit field, 128-bit security (Poseidon paper
# table 2 / reference script output for t = 3, 4, 5)
R_PARTIAL = {3: 57, 4: 56, 5: 60}


# --- Grain LFSR parameter generation (host, cached) --------------------------


class _Grain:
    """80-bit Grain LFSR from the Poseidon reference parameter script."""

    def __init__(self, n_bits: int, t: int, r_f: int, r_p: int):
        bits = []

        def put(val, width):
            bits.extend((val >> (width - 1 - i)) & 1 for i in range(width))

        put(1, 2)        # field tag: GF(p)
        put(0, 4)        # sbox tag: x^alpha
        put(n_bits, 12)
        put(t, 12)
        put(r_f, 10)
        put(r_p, 10)
        bits.extend([1] * 30)
        assert len(bits) == 80
        self.state = bits
        self.n_bits = n_bits
        for _ in range(160):
            self._next()

    def _next(self) -> int:
        s = self.state
        b = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        s.pop(0)
        s.append(b)
        return b

    def _next_filtered(self) -> int:
        while True:
            b1 = self._next()
            b2 = self._next()
            if b1:
                return b2

    def field_element(self, modulus: int) -> int:
        while True:
            v = 0
            for _ in range(self.n_bits):
                v = (v << 1) | self._next_filtered()
            if v < modulus:
                return v


@functools.lru_cache(maxsize=None)
def params_host(t: int):
    """(round_constants [(R_F+R_P) rounds][t], mds [t][t]) as host ints."""
    r_p = R_PARTIAL[t]
    r = FR.modulus
    g = _Grain(254, t, R_FULL, r_p)
    rc = [[g.field_element(r) for _ in range(t)]
          for _ in range(R_FULL + r_p)]
    while True:
        xs = [g.field_element(r) for _ in range(t)]
        ys = [g.field_element(r) for _ in range(t)]
        if len({(x + y) % r for x in xs for y in ys}) == t * t and all(
            (x + y) % r != 0 for x in xs for y in ys
        ):
            break
    mds = [[pow((x + y) % r, r - 2, r) for y in ys] for x in xs]
    # Cauchy over distinct nonzero sums => nonsingular; assert anyway
    assert _det(mds, r) != 0
    return rc, mds


def _det(m, r):
    m = [row[:] for row in m]
    n = len(m)
    det = 1
    for c in range(n):
        piv = next((i for i in range(c, n) if m[i][c] % r), None)
        if piv is None:
            return 0
        if piv != c:
            m[c], m[piv] = m[piv], m[c]
            det = -det
        det = det * m[c][c] % r
        inv = pow(m[c][c], r - 2, r)
        for i in range(c + 1, n):
            f = m[i][c] * inv % r
            for j in range(c, n):
                m[i][j] = (m[i][j] - f * m[c][j]) % r
    return det % r


# --- the sparse form of the partial rounds (Poseidon paper, eprint 2019/458,
# Appendix B), derived on the host -------------------------------------------


def _mat_mul(a, b, r):
    return [[sum(x * y for x, y in zip(row, col)) % r for col in zip(*b)]
            for row in a]


def _mat_vec(m, v, r):
    return [sum(x * y for x, y in zip(row, v)) % r for row in m]


def _mat_inv(m, r):
    """Inverse of a square matrix mod r (Gauss-Jordan); raises if singular."""
    n = len(m)
    a = [list(row) + [int(i == j) for j in range(n)]
         for i, row in enumerate(m)]
    for c in range(n):
        piv = next((i for i in range(c, n) if a[i][c] % r), None)
        if piv is None:
            raise ValueError("singular matrix")
        a[c], a[piv] = a[piv], a[c]
        inv = pow(a[c][c], r - 2, r)
        a[c] = [v * inv % r for v in a[c]]
        for i in range(n):
            if i != c and a[i][c]:
                f = a[i][c]
                a[i] = [(v - f * w) % r for v, w in zip(a[i], a[c])]
    return [row[n:] for row in a]


class SparseParams(NamedTuple):
    """The t-lane permutation with sparse partial rounds (host ints)."""

    full_rc: list    # [R_F][t]: the full rounds' constants, as params_host
    pre_rc: list     # [t]: added before the first partial round's S-box
    partial_rc: list  # [R_P]: added to lane 0 after each partial S-box
    sparse: list     # [R_P] of [m00, row (t-1), col (t-1)]
    pre_mds: list    # [t][t]: the matrix of the first half's last round
    mds: list        # [t][t]: every other full round's matrix


@functools.lru_cache(maxsize=None)
def sparse_params_host(t: int) -> SparseParams:
    """The constants and matrices of host_permute_sparse (and of B12 for
    t = 3), from params_host(t).

    Constants: from the last partial round back to the second, round k's
    constant c is written M (a e_0 + (0, d)) with (a, d) = M^-1 c; d joins
    round k - 1's constant (lanes 1.. pass the lane-0 S-box unchanged) and
    a is added to lane 0 after round k - 1's S-box. What is left for the
    first partial round is added before its S-box (``pre_rc``).

    Matrices: from the last partial round back, the round's matrix is
    A_k B_k with B_k = diag(1, C_k), C_k its lower-right (t-1) x (t-1)
    block, and A_k = [[m00, row_k], [col_k, I]] sparse. B_k commutes with
    the lane-0 S-box and constant, so it folds into the round before: the
    matrix of partial round k - 1 is B_k M, and B_0 folds into the first
    half's last full round (``pre_mds`` = B_0 M) and into ``pre_rc``."""
    r = FR.modulus
    rc, mds = params_host(t)
    half, r_p = R_FULL // 2, R_PARTIAL[t]
    m_inv = _mat_inv(mds, r)
    scalars = [0] * r_p
    pending = list(rc[half + r_p - 1])
    for k in range(r_p - 1, 0, -1):
        a, *d = _mat_vec(m_inv, pending, r)
        scalars[k - 1] = a
        pending = [rc[half + k - 1][0]] + [
            (c + x) % r for c, x in zip(rc[half + k - 1][1:], d)]
    sparse = [None] * r_p
    current = mds
    for k in range(r_p - 1, -1, -1):
        c_hat = [row[1:] for row in current[1:]]
        row = _mat_vec([list(x) for x in zip(*_mat_inv(c_hat, r))],
                       current[0][1:], r)
        sparse[k] = [current[0][0]] + row + [v[0] for v in current[1:]]
        b = [[1] + [0] * (t - 1)] + [[0] + v for v in c_hat]
        current = _mat_mul(b, mds, r)
    return SparseParams(rc[:half] + rc[half + r_p:], _mat_vec(b, pending, r),
                        scalars, sparse, current, mds)


def host_permute_sparse(state, t: int | None = None):
    """host_permute with the partial rounds in the sparse form: per partial
    round one S-box, one lane-0 constant and 2t - 1 products. The same
    output as host_permute, which is the schedule kernel B12 runs."""
    t = t or len(state)
    r = FR.modulus
    sp = sparse_params_host(t)
    s = [v % r for v in state]
    half = R_FULL // 2

    def full(s, rnd, m):
        return _mat_vec(m, [pow((v + c) % r, 5, r)
                            for v, c in zip(s, sp.full_rc[rnd])], r)

    for rnd in range(half):
        s = full(s, rnd, sp.pre_mds if rnd == half - 1 else sp.mds)
    s = [(v + c) % r for v, c in zip(s, sp.pre_rc)]
    for k, (m00, *rest) in enumerate(sp.sparse):
        x = (pow(s[0], 5, r) + sp.partial_rc[k]) % r
        row, col = rest[:t - 1], rest[t - 1:]
        s = [(m00 * x + sum(a * b for a, b in zip(row, s[1:]))) % r] + [
            (v + c * x) % r for v, c in zip(s[1:], col)]
    for rnd in range(half, R_FULL):
        s = full(s, rnd, sp.mds)
    return s


@functools.lru_cache(maxsize=None)
def _params_dev(t: int, device: torch.device):
    """Montgomery tables on ``device``: rc [(R_F+R_P)*t, 8], mds [t*t, 8]
    (row-major), cached per (t, device)."""
    rc, mds = params_host(t)
    rc_flat = [v for row in rc for v in row]
    mds_flat = [v for row in mds for v in row]
    return (F.from_int(FR, rc_flat, device=device),
            F.from_int(FR, mds_flat, device=device))


def _mont(value: int, device) -> torch.Tensor:
    """One Fr element in Montgomery form [8], converted on the host."""
    return F.constant(FR, value * FR.r_mod % FR.modulus, device)


# --- the rounds -----------------------------------------------------------------


def _rounds(state, t: int, mul, square, add):
    """The permutation of a [..., t, 8] batch through the given field ops:
    add the round constants, x^5 (square, square, multiply) on every lane
    (full rounds) or on lane 0 (partial rounds), then the MDS product with
    its t terms summed in order."""
    rc, mds = _params_dev(t, state.device)
    rcr = rc.reshape(R_FULL + R_PARTIAL[t], t, F.NLIMBS)
    m = mds.reshape(t, t, F.NLIMBS)
    half = R_FULL // 2

    def sbox(x):
        x4 = square(FR, square(FR, x))
        return mul(FR, x4, x)

    for rnd in range(R_FULL + R_PARTIAL[t]):
        state = add(FR, state, rcr[rnd])
        if rnd < half or rnd >= half + R_PARTIAL[t]:
            state = sbox(state)
        else:
            state = torch.cat([sbox(state[..., :1, :]), state[..., 1:, :]],
                              dim=-2)
        prods = mul(FR, m, state[..., None, :, :])       # [..., t, t, 8]
        acc = prods[..., 0, :]
        for j in range(1, t):
            acc = add(FR, acc, prods[..., j, :])
        state = acc
    return state


def permute_plain(state):
    """Plain version of B12: the t = 3 rounds over the plain field ops."""
    if state.shape[-2] != 3:
        raise ValueError(f"B12 permutes t = 3 states, got "
                         f"t = {state.shape[-2]}")
    return _rounds(state, 3, F.mul_plain, F.square_plain, F.add_plain)


def permute_composed(state):
    """The rounds over the dispatching field ops (B1-B3 on the card), for
    any t in {3, 4, 5}: the path of t = 4 and 5."""
    return _rounds(state, state.shape[-2], F.mul, F.square, F.add)


# --- kernel B12 -------------------------------------------------------------------

_P = ctypes.c_void_p
POSEIDON_T3 = build.KernelFn(
    "poseidon_permute_t3", "poseidon", "poseidon_permute_t3",
    [_P, _P, ctypes.c_longlong, _P],
    replaces="co_zkvms_tpu/ops/poseidon.py:224 _permute_pallas_t3")


@functools.lru_cache(maxsize=None)
def t3_constant_words():
    """B12's constants in the layout of poseidon.cuh PoseidonT3Consts
    (full_rc, pre_rc, partial_rc, sparse, then M and pre_mds), Montgomery
    form: uint32 [387, 8]."""
    sp = sparse_params_host(3)
    vals = ([v for row in sp.full_rc for v in row] + sp.pre_rc +
            sp.partial_rc + [v for row in sp.sparse for v in row] +
            [v for m in (sp.mds, sp.pre_mds) for row in m for v in row])
    return F.ints_to_words([v * FR.r_mod % FR.modulus for v in vals])


# the devices whose constant bank holds B12's constants
_T3_UPLOADED: set = set()


def _upload_t3_constants(device: torch.device) -> None:
    """Copy t3_constant_words into the constant bank of ``device``, once a
    process; raises if the copy fails."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index in _T3_UPLOADED:
        return
    fn = build.load("poseidon").poseidon_t3_upload_constants
    fn.argtypes = [_P, ctypes.c_size_t]
    fn.restype = ctypes.c_int
    words = t3_constant_words()
    with torch.cuda.device(index):
        err = fn(words.ctypes.data, words.nbytes)
    if err != 0:
        msg = build.load("poseidon").cuda_error_string(err).decode()
        raise RuntimeError(f"poseidon_t3_upload_constants: CUDA error "
                           f"{err}: {msg}")
    _T3_UPLOADED.add(index)


def _launch_t3(state):
    if state.dtype != torch.int32:
        raise TypeError(f"Poseidon states are int32 [..., 3, 8], got "
                        f"{state.dtype}")
    flat = state.reshape(-1, 3, F.NLIMBS).contiguous()
    out = torch.empty_like(flat)
    n = flat.shape[0]
    if n:
        _upload_t3_constants(state.device)
        POSEIDON_T3(flat.data_ptr(), out.data_ptr(), n,
                    build.stream_ptr(state.device))
    return out.reshape(state.shape)


def permute(state):
    """Poseidon permutation of a [..., t, 8] Montgomery batch, t in
    {3, 4, 5}. t = 3: kernel B12 on cuda (any batch size), its plain
    version on cpu; t = 4, 5: ``permute_composed``."""
    t = state.shape[-2]
    if t not in R_PARTIAL or state.shape[-1] != F.NLIMBS:
        raise ValueError(f"states are [..., t, 8] with t in {{3, 4, 5}}, got "
                         f"{tuple(state.shape)}")
    if t != 3:
        return permute_composed(state)
    if F.on_cpu(state):
        return permute_plain(state)
    return _launch_t3(state)


def hash_fes(inputs):
    """Fixed-arity Poseidon hash: [..., k, 8] -> [..., 8] (k = t-1 rate).

    Scheme: state = [cap = k, inputs...] permuted once, output = state[1]
    (the circomlib shape: the capacity element carries the arity tag).
    """
    k = inputs.shape[-2]
    if k + 1 not in R_PARTIAL:
        raise ValueError(f"unsupported arity {k}")
    cap = _mont(k, inputs.device).expand(inputs.shape[:-2] + (1, F.NLIMBS))
    state = torch.cat([cap, inputs], dim=-2)
    return permute(state)[..., 1, :]


def hash2(a, b):
    """Merkle 2-to-1 compression: ([..., 8], [..., 8]) -> [..., 8]."""
    return hash_fes(torch.stack([a, b], dim=-2))


def merkle_layer(leaves):
    """One Merkle level: [2n, 8] -> [n, 8] via batched hash2."""
    return hash2(leaves[0::2], leaves[1::2])


# --- host mirror ---------------------------------------------------------------


def host_permute(state, t: int | None = None):
    """Exact mirror of permute() on a list of Python ints (standard form)."""
    t = t or len(state)
    r = FR.modulus
    rc, mds = params_host(t)
    s = [v % r for v in state]
    half = R_FULL // 2
    r_p = R_PARTIAL[t]

    def sbox(v):
        return pow(v, 5, r)

    def mds_apply(s):
        return [sum(mds[i][j] * s[j] for j in range(t)) % r for i in range(t)]

    rnd = 0
    for _ in range(half):
        s = mds_apply([sbox((v + c) % r) for v, c in zip(s, rc[rnd])])
        rnd += 1
    for _ in range(r_p):
        s = [(v + c) % r for v, c in zip(s, rc[rnd])]
        s = mds_apply([sbox(s[0])] + s[1:])
        rnd += 1
    for _ in range(half):
        s = mds_apply([sbox((v + c) % r) for v, c in zip(s, rc[rnd])])
        rnd += 1
    return s


def host_hash(inputs):
    k = len(inputs)
    return host_permute([k] + list(inputs), k + 1)[1]


# --- Fr-native Fiat-Shamir transcript ------------------------------------------


def transcript_init(label: bytes, device="cuda"):
    """Device transcript state [2, 8]: duplex sponge at t = 3 (rate 2)."""
    seed = int.from_bytes(label, "little") % FR.modulus
    return _ts_device(seed, build.resolve_device(device)).clone()


@functools.lru_cache(maxsize=None)
def _ts_device(seed: int, device: torch.device):
    state = torch.stack([_mont(2, device), _mont(seed, device),
                         _mont(0, device)])
    return permute(state)[1:]


def transcript_absorb(state, fe_mont):
    """state [2, 8], fe [8] -> new state (duplex: add into rate lane 0)."""
    s = torch.stack([_mont(2, state.device), F.add(FR, state[0], fe_mont),
                     state[1]])
    return permute(s)[1:]


def transcript_challenge(state):
    """-> (new_state, challenge fe [8]): squeeze rate lane 0, re-permute."""
    s = torch.stack([_mont(3, state.device), state[0], state[1]])
    out = permute(s)
    return out[1:], out[1]


class HostPoseidonTranscript:
    """Host mirror of the device transcript (same API as HostTranscript)."""

    def __init__(self, label: bytes):
        seed = int.from_bytes(label, "little") % FR.modulus
        self.state = host_permute([2, seed, 0])[1:]

    def absorb(self, value: int):
        s = host_permute([2, (self.state[0] + value) % FR.modulus,
                          self.state[1]])
        self.state = s[1:]

    def absorb_many(self, values):
        for v in values:
            self.absorb(v)

    def challenge(self) -> int:
        s = host_permute([3, self.state[0], self.state[1]])
        self.state = s[1:]
        return s[1]

    def challenges(self, n: int):
        return [self.challenge() for _ in range(n)]
