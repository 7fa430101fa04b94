"""Synthetic R1CS generators for tests, dry-runs and benchmarks.

The squaring-chain circuit is the co-zkvms analog of a "model config": its
constraint count scales the boolean hypercube exactly like the reference's
benchmark circuits scale trace length (SURVEY.md §5 long-context analog).
"""

from __future__ import annotations

from .r1cs import R1CSBuilder

MOD_HINT = "wires: [1, x, x^2, x^4, ...]"


def squaring_chain(n_constraints: int) -> R1CSBuilder:
    """x public; chain w_{i+1} = w_i^2 for n_constraints rows. Solver-friendly."""
    b = R1CSBuilder(num_public=2)  # [1, x]
    prev = 1
    for _ in range(n_constraints):
        nxt = b.new_wire()
        b.add_constraint([(1, prev)], [(1, prev)], [(1, nxt)])
        prev = nxt
    return b


def random_quadratic(n_constraints: int, rng) -> R1CSBuilder:
    """Chain with random affine mixing: w_{k+1} = (a*w_k + b) * (c*w_k + d).

    Exercises multi-term rows (sparse matrices with 2 entries per row/side).
    """
    from .r1cs import MOD

    b = R1CSBuilder(num_public=2)
    prev = 1
    for _ in range(n_constraints):
        nxt = b.new_wire()
        ca, cb = rng.randrange(1, MOD), rng.randrange(MOD)
        cc, cd = rng.randrange(1, MOD), rng.randrange(MOD)
        b.add_constraint(
            [(ca, prev), (cb, 0)], [(cc, prev), (cd, 0)], [(1, nxt)]
        )
        prev = nxt
    return b
