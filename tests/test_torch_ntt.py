"""The port's single-card NTT (co_zkvms_tpu_torch.ops.ntt) against the JAX
package's ops/ntt.py on the same numpy-seeded inputs, through the plain
field versions on the CPU: twiddle tables, forward transforms (against a
host DFT too), the batched axis and the polynomial product must be equal
integers; the inverse must undo the forward transform."""

import jax
import numpy as np
import pytest

from co_zkvms_tpu.ops import field as JF
from co_zkvms_tpu.ops import ntt as JN

MOD = JF.FR.modulus

torch = F = N = convert = None  # bound by _port()


def _port():
    """Import torch and the port when the first test of this module runs,
    not at collection: an xdist worker that runs none of these tests
    never loads them."""
    global torch, F, N, convert
    import torch
    from co_zkvms_tpu_torch.ops import field as F
    from co_zkvms_tpu_torch.ops import ntt as N
    from co_zkvms_tpu_torch.utils import convert


@pytest.fixture(autouse=True, scope="module")
def _port_loaded():
    _port()


def _ints(rng, shape):
    flat = [int.from_bytes(rng.bytes(32), "little") % MOD
            for _ in range(int(np.prod(shape)))]
    return np.asarray(flat, dtype=object).reshape(shape)


def _both(ints):
    """The same values as a port tensor (CPU) and a JAX array."""
    t = F.from_int(F.FR, ints, device="cpu")
    return t, jax.numpy.asarray(convert.fe_to_limbs16(t))


def _same(t, a):
    assert t.device.type == "cpu"
    assert np.array_equal(convert.fe_to_limbs16(t), np.asarray(a))


def _host_ntt(vals, w):
    n = len(vals)
    pw = [pow(w, k, MOD) for k in range(n)]
    return [sum(v * pw[(i * k) % n] for i, v in enumerate(vals)) % MOD
            for k in range(n)]


def test_roots_and_twiddles_equal_the_jax_packages():
    cpu = torch.device("cpu")
    for log_n in (1, 3, 4):
        for inverse in (False, True):
            assert N.two_adic_root(F.FR, log_n, inverse) == \
                JN.two_adic_root(JF.FR, log_n, inverse)
            _same(N._twiddles(F.FR, log_n, inverse, cpu),
                  JN._twiddles(JF.FR, log_n, inverse))
    assert np.array_equal(N._bitrev_idx(4), JN._bitrev_idx(4))


def test_ntt_equals_the_jax_package_and_a_host_dft():
    rng = np.random.default_rng(0)
    vals = _ints(rng, (16,))
    x, jx = _both(vals)
    out = N.ntt(F.FR, x)
    _same(out, JN.ntt(JF.FR, jx))
    want = _host_ntt([int(v) for v in vals], N.two_adic_root(F.FR, 4))
    assert F.to_int(F.FR, out).tolist() == want
    _same(N.intt(F.FR, x), JN.intt(JF.FR, jx))


def test_round_trip_at_2_to_the_10():
    x = F.from_int(F.FR, _ints(np.random.default_rng(3), (1 << 10,)),
                   device="cpu")
    assert torch.equal(N.intt(F.FR, N.ntt(F.FR, x)), x)


def test_batched_axis_and_polynomial_product_equal_the_jax_packages():
    rng = np.random.default_rng(5)
    x, jx = _both(_ints(rng, (3, 8)))
    out = N.ntt(F.FR, x)
    _same(out, JN.ntt(JF.FR, jx))
    for i in range(3):
        assert torch.equal(out[i], N.ntt(F.FR, x[i]))
    # (1 + 2t)(3 + 4t) = 3 + 10t + 8t^2, and a random product of degree < 4
    a, ja = _both(np.asarray([1, 2, 0, 0, 0, 0, 0, 0], dtype=object))
    b, jb = _both(np.asarray([3, 4, 0, 0, 0, 0, 0, 0], dtype=object))
    prod = N.mul_polys(F.FR, a, b)
    assert F.to_int(F.FR, prod).tolist() == [3, 10, 8, 0, 0, 0, 0, 0]
    _same(prod, JN.mul_polys(JF.FR, ja, jb))
    ra = np.concatenate([_ints(rng, (4,)), np.zeros(4, dtype=object)])
    rb = np.concatenate([_ints(rng, (4,)), np.zeros(4, dtype=object)])
    (a, ja), (b, jb) = _both(ra), _both(rb)
    _same(N.mul_polys(F.FR, a, b), JN.mul_polys(JF.FR, ja, jb))
