"""Keccak-based Fiat-Shamir transcript (host copy of the JAX package's).

Scheme (fixed-size chained sponge, one keccak-f per operation):

    S_0 = keccak256(label)
    absorb(v):    S <- keccak256(S || bytes32_le(v) || 0x00)      (65-byte msg)
    challenge():  y = keccak256(S || zeros32 || 0x02);  S <- y
                  c = int_le(y) mod r

Two details decide the challenges: ``absorb`` hashes the STANDARD-form bytes
of a value (never its Montgomery limbs), and a challenge is ``int_le(y) mod
r``. The JAX prover runs the same byte stream in a device sponge; the port's
single-party prover drives this host object directly, so every challenge
equals the JAX one by construction.
"""

from __future__ import annotations

from . import keccak as K
from .field import FR

ABSORB_TAG = 0x00
CHALLENGE_TAG = 0x02


class HostTranscript:
    """Keccak transcript on the host, byte-exact with the JAX package's
    device sponge and its ``HostTranscript``."""

    def __init__(self, label: bytes):
        self.state = K.keccak256_host(label)

    def absorb(self, value: int):
        """Absorb a standard-form value (< 2^256) as 32 LE bytes."""
        msg = self.state + int(value).to_bytes(32, "little") + bytes([ABSORB_TAG])
        self.state = K.keccak256_host(msg)

    def absorb_many(self, values):
        for v in values:
            self.absorb(v)

    def absorb_point(self, xy):
        """Absorb an affine G1 point (x, y ints; (0,0) = infinity)."""
        self.absorb(xy[0])
        self.absorb(xy[1])

    def challenge(self) -> int:
        msg = self.state + bytes(32) + bytes([CHALLENGE_TAG])
        y = K.keccak256_host(msg)
        self.state = y
        return int.from_bytes(y, "little") % FR.modulus

    def challenges(self, n: int):
        return [self.challenge() for _ in range(n)]
