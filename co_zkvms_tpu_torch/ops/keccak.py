"""Keccak-f[1600] and Keccak-256 on the host (Python ints).

A copy of the host half of the JAX package's ``ops/keccak.py``: the port's
single-party prover drives its Fiat-Shamir transcript on the host, so only
``keccak256_host`` is needed here.

Keccak-256 uses the pre-NIST 0x01 padding (Ethereum/Jolt convention).
"""

from __future__ import annotations

RATE_BYTES = 136  # Keccak-256 rate (1088 bits)

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rotation offsets r[x][y] (x = column, y = row), lane index = x + 5*y
_ROTATION = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_MASK64 = (1 << 64) - 1


def _rotl64(v: int, r: int) -> int:
    r %= 64
    return ((v << r) | (v >> (64 - r))) & _MASK64


def keccak_f_host(lanes):
    """One Keccak-f[1600] permutation on a 25-list of 64-bit ints (x+5y order)."""
    a = list(lanes)
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl64(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl64(
                    a[x + 5 * y], _ROTATION[x][y]
                )
        # chi
        a = [
            b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y])
            for y in range(5)
            for x in range(5)
        ]
        # iota
        a[0] ^= rc
    return a


def keccak256_host(data: bytes) -> bytes:
    """Keccak-256 (0x01 padding) of arbitrary bytes, host-side."""
    padded = bytearray(data)
    padded.append(0x01)
    while len(padded) % RATE_BYTES:
        padded.append(0x00)
    padded[-1] |= 0x80
    state = [0] * 25
    for off in range(0, len(padded), RATE_BYTES):
        block = padded[off : off + RATE_BYTES]
        for i in range(RATE_BYTES // 8):
            state[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        state = keccak_f_host(state)
    out = b"".join(state[i].to_bytes(8, "little") for i in range(4))
    return out
