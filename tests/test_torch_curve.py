"""Port G1 formulas (co_zkvms_tpu_torch.ops.curve) against the JAX package's
Pallas kernel bodies and ref_bn254 (the JAX package's pure-Python oracle).

The kernel bodies of co_zkvms_tpu/ops/curve_pallas.py run eagerly through
fake refs, as tests/test_curve_msm.py does (interpret mode would compile
for minutes). Both sides get the same points, made from a numpy seed and
converted through co_zkvms_tpu_torch.utils.convert, with p = q, p = -q and
infinity rows planted. Jacobian outputs may differ in representation only
where the formulas allow; they are compared in affine, exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from co_zkvms_tpu.ops import curve_pallas as CP
from co_zkvms_tpu.ops import ref_bn254 as bn


C = F = convert = None  # bound by _port()


def _port():
    """Import the port when the first test of this module runs,
    not at collection: an xdist worker that runs none of these tests
    never loads them."""
    global C, F, convert
    from co_zkvms_tpu_torch.ops import curve as C
    from co_zkvms_tpu_torch.ops import field as F
    from co_zkvms_tpu_torch.utils import convert


@pytest.fixture(autouse=True, scope="module")
def _port_loaded():
    _port()


class Ref:
    """Limb-major fake Pallas ref: ref[i, :] is limb row i."""

    def __init__(self, arr=None):
        self.a = [None] * 16 if arr is None else [arr[i] for i in range(16)]

    def __getitem__(self, key):
        return self.a[key[0]]

    def __setitem__(self, key, val):
        self.a[key[0]] = val

    def limbs(self):
        return np.stack([np.asarray(v) for v in self.a], axis=-1)


def _ref(t):
    """port coordinate [N, 8] -> limb-major fake ref of JAX limbs."""
    return Ref(jnp.asarray(convert.fe_to_limbs16(t).T))


def _jac_from_refs(ox, oy, oz):
    return C.JPoint(*(convert.fe_from_limbs16(r.limbs(), device="cpu") for r in (ox, oy, oz)))


def _affine_ints(p):
    return C.points_to_ints(C.to_affine(p))


def _rand_points(rng, n):
    return [bn.scalar_mul(bn.G1_GEN, int(rng.integers(1, 1 << 62)) *
                          int(rng.integers(1, 1 << 62)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def cases():
    """p (Jacobian, z != 1), q (Jacobian and affine), ints of both; rows:
    0: p == q, 1: p == -q, 2: p = inf, 3: q = inf, 4: both inf."""
    rng = np.random.default_rng(21)
    ps, qs = _rand_points(rng, 10), _rand_points(rng, 10)
    qs[0] = ps[0]
    qs[1] = bn.neg_pt(ps[1])
    ps[2] = None
    qs[3] = None
    ps[4] = qs[4] = None
    qa = C.points_from_ints([bn.g1_coords(q) for q in qs], device="cpu")
    # Jacobian inputs with z != 1: p = double(p / 2), p / 2 = p * (r+1)/2
    half = [None if p is None else bn.scalar_mul(p, (bn.R_ORDER + 1) // 2)
            for p in ps]
    ph = C.points_from_ints([bn.g1_coords(p) for p in half], device="cpu")
    pj = C.double(C.from_affine(ph))
    qj = C.double(C.from_affine(C.points_from_ints(
        [bn.g1_coords(None if q is None else
                      bn.scalar_mul(q, (bn.R_ORDER + 1) // 2)) for q in qs],
        device="cpu")))
    return pj, qa, qj, ps, qs


def test_to_affine_and_double_of_halves(cases):
    pj, qa, qj, ps, qs = cases
    assert _affine_ints(pj) == [bn.g1_coords(p) for p in ps]
    assert _affine_ints(qj) == [bn.g1_coords(q) for q in qs]
    assert C.points_to_ints(qa) == [bn.g1_coords(q) for q in qs]


def test_add_mixed_matches_pallas_body_and_reference(cases):
    pj, qa, _, ps, qs = cases
    mod, one, n0 = CP._consts()
    ox, oy, oz = Ref(), Ref(), Ref()
    CP._add_mixed_kernel(_ref(pj.x), _ref(pj.y), _ref(pj.z), _ref(qa.x),
                         _ref(qa.y), ox, oy, oz, mod, one, n0)
    want = _affine_ints(_jac_from_refs(ox, oy, oz))
    got = _affine_ints(C.add_mixed(pj, qa))
    assert got == want
    assert got == [bn.g1_coords(bn.add(p, q)) for p, q in zip(ps, qs)]


def test_add_matches_pallas_body_and_reference(cases):
    pj, _, qj, ps, qs = cases
    mod, one, n0 = CP._consts()
    ox, oy, oz = Ref(), Ref(), Ref()
    CP._add_kernel(_ref(pj.x), _ref(pj.y), _ref(pj.z), _ref(qj.x),
                   _ref(qj.y), _ref(qj.z), ox, oy, oz, mod, one, n0)
    want = _affine_ints(_jac_from_refs(ox, oy, oz))
    got = _affine_ints(C.add(pj, qj))
    assert got == want
    assert got == [bn.g1_coords(bn.add(p, q)) for p, q in zip(ps, qs)]


def test_double_matches_pallas_body_and_reference(cases):
    pj, _, _, ps, _ = cases
    mod, _, n0 = CP._consts()
    ox, oy, oz = Ref(), Ref(), Ref()
    CP._double_kernel(_ref(pj.x), _ref(pj.y), _ref(pj.z), ox, oy, oz, mod,
                      n0)
    want = _affine_ints(_jac_from_refs(ox, oy, oz))
    got = _affine_ints(C.double(pj))
    assert got == want
    assert got == [bn.g1_coords(bn.double(p)) for p in ps]


@pytest.mark.parametrize("times", [1, 3])
def test_double_times_matches_repeated_pallas_body(cases, times):
    """double(p, times=k): k applications of the TPU kernel's body, and
    2^k p, exactly (affine)."""
    pj, _, _, ps, _ = cases
    mod, _, n0 = CP._consts()
    refs = tuple(_ref(c) for c in pj)
    for _ in range(times):
        out = Ref(), Ref(), Ref()
        CP._double_kernel(*refs, *out, mod, n0)
        refs = tuple(Ref(jnp.asarray(r.limbs().T)) for r in out)
    want = _affine_ints(_jac_from_refs(*refs))
    got = _affine_ints(C.double(pj, times=times))
    assert got == want
    assert got == [bn.g1_coords(bn.scalar_mul(p, 1 << times)
                                if p is not None else None) for p in ps]


def test_add_incomplete_matches_pallas_body(cases):
    """Same outputs as the TPU kernel on every row, the degenerate p == q
    row included (it collapses to the infinity encoding); equal to the
    group sum on the rows the incomplete formula covers."""
    pj, _, qj, ps, qs = cases
    mod, _, n0 = CP._consts()
    ox, oy, oz = Ref(), Ref(), Ref()
    CP._add_incomplete_kernel(_ref(pj.x), _ref(pj.y), _ref(pj.z),
                              _ref(qj.x), _ref(qj.y), _ref(qj.z), ox, oy, oz,
                              mod, n0)
    want = _affine_ints(_jac_from_refs(ox, oy, oz))
    got = C.add_incomplete(pj, qj)
    assert _affine_ints(got) == want
    assert F.to_int(F.FQ, got.z[0], mont=False) == 0      # p == q -> inf
    ref = [bn.g1_coords(bn.add(p, q)) for p, q in zip(ps, qs)]
    assert _affine_ints(got)[1:] == ref[1:]


def test_tree_sum_and_neg(cases):
    pj, _, qj, ps, qs = cases
    total = None
    for p in ps:
        total = bn.add(total, p)
    assert _affine_ints(C.tree_sum(pj)) == [bn.g1_coords(total)]
    odd = C.index(qj, slice(0, 7))
    total = None
    for q in qs[:7]:
        total = bn.add(total, q)
    assert _affine_ints(C.tree_sum(odd)) == [bn.g1_coords(total)]
    assert _affine_ints(C.neg(pj)) == [bn.g1_coords(bn.neg_pt(p)) for p in ps]


def test_point_convert_round_trip(cases):
    pj, qa, _, _, _ = cases
    back = convert.point_from_limbs16(convert.point_to_limbs16(pj), device="cpu")
    assert isinstance(back, C.JPoint)
    assert all(bool((a == b).all()) for a, b in zip(back, pj))
    back_a = convert.point_from_limbs16(convert.point_to_limbs16(qa), device="cpu")
    assert isinstance(back_a, C.APoint)
