"""Port field arithmetic (co_zkvms_tpu_torch.ops.field) against the JAX
package's Montgomery core and Python ints.

Inputs come from a numpy seed and reach each side through
co_zkvms_tpu_torch.utils.convert. The JAX side runs the Pallas kernels'
limb helpers (field_pallas._mm/_msq/_madd/_msub) eagerly on lists of 16
limb vectors, and field.mul/add/sub under jax.disable_jit(): no JAX program
is compiled. Every comparison is exact integer equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from co_zkvms_tpu.ops import field as JF
from co_zkvms_tpu.ops import field_pallas as JFP


torch = F = convert = None  # bound by _port()


def _port():
    """Import torch and the port when the first test of this module runs,
    not at collection: an xdist worker that runs none of these tests
    never loads them."""
    global torch, F, convert
    import torch
    from co_zkvms_tpu_torch.ops import field as F
    from co_zkvms_tpu_torch.utils import convert


@pytest.fixture(autouse=True, scope="module")
def _port_loaded():
    _port()


N = 64
SPECS = [("fr", JF.FR), ("fq", JF.FQ)]


def _rand_ints(rng, m, n=N):
    vals = [int.from_bytes(rng.bytes(32), "little") % m for _ in range(n)]
    vals[:3] = [0, 1, m - 1]
    return vals


def _limb_lists(limbs16):
    """[N, 16] numpy limbs -> list of 16 jnp [N] vectors (limb-major)."""
    return [jnp.asarray(limbs16[:, i]) for i in range(16)]


def _from_limb_lists(cols):
    return np.stack([np.asarray(c) for c in cols], axis=-1).astype(np.uint32)


@pytest.mark.parametrize("name,jspec", SPECS)
def test_plain_ops_match_python_ints(name, jspec):
    spec = getattr(F, name.upper())
    rng = np.random.default_rng(11)
    m = spec.modulus
    a, b = _rand_ints(rng, m), _rand_ints(rng, m)[::-1]
    ta = F.from_int(spec, a, device="cpu")
    tb = F.from_int(spec, b, device="cpu")
    assert list(F.to_int(spec, ta)) == a
    assert list(F.to_int(spec, F.mul(spec, ta, tb))) == \
        [x * y % m for x, y in zip(a, b)]
    assert list(F.to_int(spec, F.square(spec, ta))) == [x * x % m for x in a]
    assert list(F.to_int(spec, F.add(spec, ta, tb))) == \
        [(x + y) % m for x, y in zip(a, b)]
    assert list(F.to_int(spec, F.sub(spec, ta, tb))) == \
        [(x - y) % m for x, y in zip(a, b)]
    assert list(F.to_int(spec, F.neg(spec, ta))) == [(-x) % m for x in a]
    assert list(F.to_int(spec, F.batch_inv(spec, ta))) == \
        [pow(x, -1, m) if x else 0 for x in a]
    assert F.to_int(spec, F.inv(spec, ta[5])) == pow(a[5], -1, m)
    assert list(F.to_int(spec, F.mul_small(spec, ta, 13))) == \
        [13 * x % m for x in a]
    # one element broadcast against the batch (stride-0 operand)
    assert list(F.to_int(spec, F.mul(spec, ta, tb[7]))) == \
        [x * b[7] % m for x in a]


@pytest.mark.parametrize("name,jspec", SPECS)
def test_montgomery_core_matches_pallas_helpers(name, jspec):
    """Raw Montgomery limbs in, raw limbs out: port plain mul/square/add/sub
    == field_pallas._mm/_msq/_madd/_msub run eagerly."""
    spec = getattr(F, name.upper())
    rng = np.random.default_rng(12)
    m = spec.modulus
    # raw canonical limb patterns (no Montgomery conversion on either side)
    ta = F.from_int(spec, _rand_ints(rng, m), mont=False, device="cpu")
    tb = F.from_int(spec, _rand_ints(rng, m)[::-1], mont=False, device="cpu")
    la, lb = convert.fe_to_limbs16(ta), convert.fe_to_limbs16(tb)
    mod = [int(v) for v in jspec.mod_limbs]
    n0 = jspec.n0inv
    a_cols, b_cols = _limb_lists(la), _limb_lists(lb)
    want = {
        "mul": _from_limb_lists(JFP._mm(a_cols, b_cols, mod, n0)),
        "square": _from_limb_lists(JFP._msq(a_cols, mod, n0)),
        "add": _from_limb_lists(JFP._madd(a_cols, b_cols, mod)),
        "sub": _from_limb_lists(JFP._msub(a_cols, b_cols, mod)),
    }
    got = {
        "mul": F.mul_plain(spec, ta, tb),
        "square": F.square_plain(spec, ta),
        "add": F.add_plain(spec, ta, tb),
        "sub": F.sub_plain(spec, ta, tb),
    }
    for op in want:
        np.testing.assert_array_equal(convert.fe_to_limbs16(got[op]),
                                      want[op], err_msg=op)


@pytest.mark.parametrize("name,jspec", SPECS)
def test_dispatch_matches_jax_field_eager(name, jspec):
    """field.mul/add/sub of both packages on the same Montgomery limbs."""
    spec = getattr(F, name.upper())
    rng = np.random.default_rng(13)
    m = spec.modulus
    ta = F.from_int(spec, _rand_ints(rng, m), device="cpu")
    tb = F.from_int(spec, _rand_ints(rng, m)[::-1], device="cpu")
    ja = jnp.asarray(convert.fe_to_limbs16(ta))
    jb = jnp.asarray(convert.fe_to_limbs16(tb))
    with jax.disable_jit():
        want_mul = np.asarray(JF.mul(jspec, ja, jb))
        want_add = np.asarray(JF.add(jspec, ja, jb))
        want_sub = np.asarray(JF.sub(jspec, ja, jb))
    np.testing.assert_array_equal(convert.fe_to_limbs16(F.mul(spec, ta, tb)),
                                  want_mul)
    np.testing.assert_array_equal(convert.fe_to_limbs16(F.add(spec, ta, tb)),
                                  want_add)
    np.testing.assert_array_equal(convert.fe_to_limbs16(F.sub(spec, ta, tb)),
                                  want_sub)


@pytest.mark.parametrize("name,jspec", SPECS)
def test_lazy_sums(name, jspec):
    spec = getattr(F, name.upper())
    rng = np.random.default_rng(14)
    m = spec.modulus
    a = _rand_ints(rng, m)
    ta = F.from_int(spec, a, device="cpu")
    assert F.to_int(spec, F.modsum(spec, ta)) == sum(a) % m
    ids = rng.integers(0, 5, size=N)
    got = F.to_int(spec, F.segment_modsum(spec, ta, torch.from_numpy(ids), 7))
    assert list(got) == [sum(v for v, s in zip(a, ids) if s == k) % m
                         for k in range(7)]
    # a loose sum above 2^256 reduces to the same residue
    loose = torch.full((1, 8), (1 << 40) - 1, dtype=torch.int64)
    value = sum(((1 << 40) - 1) << (32 * k) for k in range(8))
    assert F.to_int(spec, F.lazy_reduce(spec, loose)[0], mont=False) == \
        value % m


def test_convert_round_trip():
    rng = np.random.default_rng(15)
    limbs16 = rng.integers(0, 1 << 16, size=(3, 5, 16)).astype(np.uint32)
    t = convert.fe_from_limbs16(limbs16, device="cpu")
    assert t.dtype == torch.int32 and t.shape == (3, 5, 8)
    np.testing.assert_array_equal(convert.fe_to_limbs16(t), limbs16)
    # the same integer on both sides
    ints16 = [JF.limbs_to_int(r) for r in limbs16.reshape(-1, 16)]
    assert F.words_to_ints(t.reshape(-1, 8).numpy()) == ints16
