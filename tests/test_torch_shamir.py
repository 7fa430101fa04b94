"""Shamir sharing, Rep3 point shares and seeded Rep3 shares of the port
(co_zkvms_tpu_torch.parallel) against the JAX package's parallel/shamir.py,
pointshares.py and shares.py, through the plain versions on the CPU.

The two packages draw their randomness from different generators, so the
shares differ; what must agree is everything that is not random: shares
of either package reconstruct through the other's functions; Lagrange
coefficients, interpolation, the public scalar multiplication and a point
reconstruction (both in Jacobian coordinates) are equal integers; the
per-party MSMs equal the JAX package's reference arithmetic
(``ref_bn254``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from co_zkvms_tpu.ops import curve as JC
from co_zkvms_tpu.ops import field as JF
from co_zkvms_tpu.ops import ref_bn254 as bn
from co_zkvms_tpu.parallel import shamir as JSh
from co_zkvms_tpu.parallel import shares as JS

MOD = JF.FR.modulus

torch = F = C = M = Sh = PS = S = convert = None  # bound by _port()


def _port():
    """Import torch and the port when the first test of this module runs,
    not at collection: an xdist worker that runs none of these tests
    never loads them."""
    global torch, F, C, M, Sh, PS, S, convert
    import torch
    from co_zkvms_tpu_torch.ops import curve as C
    from co_zkvms_tpu_torch.ops import field as F
    from co_zkvms_tpu_torch.ops import msm as M
    from co_zkvms_tpu_torch.parallel import pointshares as PS
    from co_zkvms_tpu_torch.parallel import shamir as Sh
    from co_zkvms_tpu_torch.parallel import shares as S
    from co_zkvms_tpu_torch.utils import convert


@pytest.fixture(autouse=True, scope="module")
def _port_loaded():
    _port()


def _ints(rng, shape):
    flat = [int.from_bytes(rng.bytes(32), "little") % MOD
            for _ in range(int(np.prod(shape)))]
    return np.asarray(flat, dtype=object).reshape(shape)


def _to_jax(t):
    return jnp.asarray(convert.fe_to_limbs16(t))


def _from_jax(a):
    return convert.fe_from_limbs16(np.asarray(a), device="cpu")


def _jpoint(p):
    """Port point -> JAX point of the same kind."""
    return (JC.APoint if len(p) == 2 else JC.JPoint)(
        *(jnp.asarray(c) for c in convert.point_to_limbs16(p)))


def _affine(p):
    return C.points_to_ints(C.to_affine(p))


def _points(rng, n):
    """n random multiples of the generator: (reference points, their
    coordinates, a port Jacobian batch)."""
    pts = [bn.scalar_mul(bn.G1_GEN, int(k))
           for k in rng.integers(2, 1 << 62, n)]
    xy = [bn.g1_coords(q) for q in pts]
    return pts, xy, C.from_affine(C.points_from_ints(xy, device="cpu"))


def test_field_shares_reconstruct_across_packages():
    rng = np.random.default_rng(21)
    secrets = _ints(rng, (5,))
    sec = F.from_int(F.FR, secrets, device="cpu")
    jshares = JSh.share(JF.FR, jax.random.key(0), _to_jax(sec), t=2, n=5)
    pshares = Sh.share(F.FR, torch.Generator().manual_seed(1), sec, 2, 5)
    assert pshares.shape == (5, 5, 8) and pshares.device.type == "cpu"
    for ids in ([1, 2, 3], [2, 4, 5], [1, 3, 5]):
        rows = [i - 1 for i in ids]
        got = Sh.reconstruct(F.FR, _from_jax(jshares)[rows], ids)
        assert F.to_int(F.FR, got).tolist() == secrets.tolist()
        back = JSh.reconstruct(JF.FR, [_to_jax(pshares[r]) for r in rows],
                               ids)
        assert JF.to_int(JF.FR, back).tolist() == secrets.tolist()
    two = Sh.reconstruct(F.FR, pshares[:2], [1, 2])
    assert F.to_int(F.FR, two).tolist() != secrets.tolist()


def test_precomputed_lagrange_and_interpolation_equal_the_jax_packages():
    rng = np.random.default_rng(22)
    secrets = _ints(rng, (4,))
    sec = F.from_int(F.FR, secrets, device="cpu")
    shares = Sh.share(F.FR, torch.Generator().manual_seed(3), sec, 2, 5)
    ids = [2, 3, 5]
    sub = shares[[i - 1 for i in ids]]
    for x in (0, 1, 4):
        lams = Sh.precompute_lagrange(ids, x, device="cpu")
        assert np.array_equal(convert.fe_to_limbs16(lams),
                              np.asarray(JSh.precompute_lagrange(ids, x)))
    got = Sh.reconstruct_precomputed(F.FR, sub, Sh.precompute_lagrange(
        ids, device="cpu"))
    assert F.to_int(F.FR, got).tolist() == secrets.tolist()
    evals = Sh.interpolate_poly(F.FR, sub, ids, [1, 4])
    want = JSh.interpolate_poly(JF.FR, _to_jax(sub), ids, [1, 4])
    assert np.array_equal(convert.fe_to_limbs16(evals), np.asarray(want))
    assert torch.equal(evals[0], shares[0]) and torch.equal(evals[1],
                                                            shares[3])


def _same_jacobian(p, jp):
    return all(np.array_equal(a, np.asarray(b)) for a, b in
               zip(convert.point_to_limbs16(p), jp))


def test_scalar_mul_public_equals_the_jax_package_in_jacobian_coordinates():
    """One JAX call: each compiles its 254-step scan anew (tens of
    seconds on the CPU), as the scan closes over the point."""
    rng = np.random.default_rng(23)
    refs, _, p = _points(rng, 2)
    p = C.double(p)                                   # z != 1
    k = int(_ints(rng, ()))
    got = Sh.scalar_mul_public(p, k)
    assert _same_jacobian(got, JSh.scalar_mul_public(_jpoint(p), k))
    assert _affine(got) == [bn.g1_coords(bn.scalar_mul(bn.double(q), k))
                            for q in refs]
    assert _affine(Sh.scalar_mul_public(p, 0)) == [(0, 0), (0, 0)]


def test_point_shares_reconstruct_in_both_packages():
    rng = np.random.default_rng(24)
    _, pts, p = _points(rng, 2)
    shares = Sh.share_point(torch.Generator().manual_seed(4), p, 1, 3)
    assert shares.x.shape == (3, 2, 8)
    for ids in ([1, 2], [2, 3], [1, 3]):
        rec = Sh.reconstruct_point(C.index(shares, [i - 1 for i in ids]), ids)
        assert _affine(rec) == pts
    # the JAX package's reconstruction of the last subset, coordinate for
    # coordinate (two scalar multiplications: one JAX scan compile each)
    want = JSh.reconstruct_point(_jpoint(C.index(shares, [0, 2])), [1, 3])
    assert _same_jacobian(rec, want)
    assert _affine(C.index(shares, 0)) != pts


def test_rep3_point_shares_and_msm_shares_equal_the_jax_packages():
    rng = np.random.default_rng(25)
    ra, xa, pa = _points(rng, 2)
    rb, _, pb = _points(rng, 2)
    stack = PS.share(torch.Generator().manual_seed(5), pa)
    assert stack.x.shape == (3, 2, 8)
    assert _affine(PS.combine(stack)) == xa
    sb = PS.share(torch.Generator().manual_seed(6), pb)
    summed = _affine(PS.combine(PS.add(stack, sb)))
    assert summed == [bn.g1_coords(bn.add(a, b)) for a, b in zip(ra, rb)]
    assert summed == _affine(PS.combine(PS.add_public(stack, pb)))
    # the per-party MSMs of Rep3 coefficient shares, against the JAX
    # package's reference arithmetic (its msm_shares runs three device
    # MSMs, which XLA:CPU takes minutes to compile and run)
    n = 8
    refs, base_pts, _ = _points(rng, n)
    bases = C.points_from_ints(base_pts, device="cpu")
    coeffs = F.from_int(F.FR, _ints(rng, (n,)), device="cpu")
    cstack = S.share(F.FR, torch.Generator().manual_seed(7), coeffs)
    got = PS.msm_shares(bases, cstack)
    want = []
    for row in F.to_int(F.FR, cstack).tolist():
        acc = None
        for q, c in zip(refs, row):
            acc = bn.add(acc, bn.scalar_mul(q, c))
        want.append(bn.g1_coords(acc))
    assert _affine(got) == want
    assert _affine(PS.combine(got)) == _affine(M.msm(bases, coeffs))


def test_seeded_shares_expand_to_the_same_shares_on_any_device():
    """The seeds expand on a CPU generator whichever device the caller
    expands on, so the rows are the CPU stream of each seed; the stack
    combines to the secret, as the JAX package's does."""
    rng = np.random.default_rng(26)
    secrets = _ints(rng, (5,))
    sec = F.from_int(F.FR, secrets, device="cpu")
    seeds, explicit = S.share_seeded(F.FR, torch.Generator().manual_seed(8),
                                     sec)
    assert len(seeds) == 2 and all(isinstance(s, int) for s in seeds)
    stack = S.expand_seeded(F.FR, seeds, explicit, (5,))
    assert F.to_int(F.FR, S.combine(F.FR, stack)).tolist() == secrets.tolist()
    for row, seed in zip(stack[:2], seeds):
        assert torch.equal(row, F.random(F.FR, torch.Generator().manual_seed(
            seed), (5,)))
    # a caller whose default generator is elsewhere gets the same rows
    torch.manual_seed(99)
    assert torch.equal(S.expand_seeded(F.FR, seeds, explicit, (5,)), stack)
    keys, jexplicit = JS.share_seeded(JF.FR, jax.random.key(7), _to_jax(sec))
    jstack = JS.expand_seeded(JF.FR, keys, jexplicit, (5,))
    assert F.to_int(F.FR, S.combine(F.FR, _from_jax(jstack))).tolist() == \
        secrets.tolist()
