"""Rep3 shares in the port (co_zkvms_tpu_torch.parallel) against the JAX
package's parallel/mpc.py on the same shares and masks (the JAX side runs
under jax.disable_jit(): nothing is compiled), the port's sharing and
correlated zero shares, and the port's twin of the JAX package's check that
every model share-mul is masked."""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from co_zkvms_tpu.ops import field as JF
from co_zkvms_tpu.parallel import mpc as JM

MOD = JF.FR.modulus

torch = F = S = M = CorrelatedRng = convert = None  # bound by _port()


def _port():
    """Import torch and the port when the first test of this module runs,
    not at collection: an xdist worker that runs none of these tests
    never loads them."""
    global torch, F, S, M, CorrelatedRng, convert
    import torch
    from co_zkvms_tpu_torch.ops import field as F
    from co_zkvms_tpu_torch.parallel import mpc as M
    from co_zkvms_tpu_torch.parallel import shares as S
    from co_zkvms_tpu_torch.parallel.rng import CorrelatedRng
    from co_zkvms_tpu_torch.utils import convert


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    _port()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ints(rng, shape):
    flat = [int.from_bytes(rng.bytes(32), "little") % MOD
            for _ in range(int(np.prod(shape)))]
    return np.asarray(flat, dtype=object).reshape(shape)


def _both(ints):
    """The same values as a port tensor and a JAX array."""
    t = F.from_int(F.FR, ints, device="cpu")
    return t, jnp.asarray(convert.fe_to_limbs16(t))


def _port_ints(t):
    return F.to_int(F.FR, t).tolist()


def _jax_ints(a):
    return JF.to_int(JF.FR, a).tolist()


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(12)
    x, y, a, b = (_ints(rng, (3, 8)) for _ in range(4))
    mask = np.stack([a[0], b[0], (-(a[0] + b[0])) % MOD])  # sums to zero
    pub = _ints(rng, (8,))
    point = _ints(rng, (3,))
    return {k: _both(v) for k, v in (("x", x), ("y", y), ("mask", mask),
                                     ("pub", pub), ("point", point))}


def test_mul_and_open_equal_the_jax_packages(operands):
    (x, jx), (y, jy), (mk, jmk) = operands["x"], operands["y"], operands["mask"]
    got = M.mul(F.FR, x, y, zero_mask=mk)
    with jax.disable_jit():
        want = JM.mul(JF.FR, jx, jy, zero_mask=jmk)
        jopen = JM.open(JF.FR, want)
        unmasked = JM.mul(JF.FR, jx, jy)
    assert _port_ints(got) == _jax_ints(want)            # share by share
    assert _port_ints(M.open(F.FR, got)) == _jax_ints(jopen)
    assert _port_ints(M.mul(F.FR, x, y)) == _jax_ints(unmasked)
    # the opened product is the product of the opened values
    xs, ys = np.asarray(_port_ints(M.open(F.FR, x)), dtype=object), \
        np.asarray(_port_ints(M.open(F.FR, y)), dtype=object)
    assert _port_ints(M.open(F.FR, got)) == ((xs * ys) % MOD).tolist()


def test_local_ops_equal_the_jax_packages(operands):
    (x, jx), (pub, jpub) = operands["x"], operands["pub"]
    with jax.disable_jit():
        cases = [
            (M.mul_public(F.FR, x, pub), JM.mul_public(JF.FR, jx, jpub)),
            (M.add_public(F.FR, x, pub), JM.add_public(JF.FR, jx, jpub)),
            (M.inner_product(F.FR, x, pub), JM.inner_product(JF.FR, jx, jpub)),
        ]
        cases = [(p, _jax_ints(j)) for p, j in cases]
    for got, want in cases:
        assert _port_ints(got) == want


def test_eval_shares_and_eval_open_equal_the_jax_packages(operands):
    (x, jx), (pt, jpt) = operands["x"], operands["point"]
    x, jx, pt, jpt = x[:, :4], jx[:, :4], pt[:2], jpt[:2]   # nv = 2
    with jax.disable_jit():
        want_shares = _jax_ints(JM.eval_shares(JF.FR, jx, jpt))
        want = JM.eval_open(JF.FR, jx, jpt)
    assert _port_ints(M.eval_shares(F.FR, x, pt)) == want_shares
    assert M.eval_open(F.FR, x, pt) == want


def test_share_reconstructs_under_any_generator():
    rng = np.random.default_rng(5)
    secret = F.from_int(F.FR, _ints(rng, (16,)), device="cpu")
    a = S.share(F.FR, torch.Generator().manual_seed(1), secret)
    b = S.share(F.FR, torch.Generator().manual_seed(2), secret)
    assert a.shape == (3, 16, 8)
    assert not torch.equal(a, b)
    assert torch.equal(S.combine(F.FR, a), secret)
    assert torch.equal(S.combine(F.FR, b), secret)
    pub = S.promote_public(F.FR, secret)
    assert torch.equal(S.combine(F.FR, pub), secret)
    assert torch.equal(S.b_component(a)[0], a[2])
    # a share stack crosses between the packages' layouts as it is
    limbs16 = convert.fe_to_limbs16(a)
    assert limbs16.shape == (3, 16, 16)
    assert torch.equal(convert.fe_from_limbs16(limbs16, device="cpu"), a)


def test_zero_shares_sum_to_zero_and_are_fresh_per_counter():
    crng = CorrelatedRng.create(torch.Generator().manual_seed(3))
    z1 = crng.zero_shares(F.FR, (5,), 7, 0, device="cpu")
    z2 = crng.zero_shares(F.FR, (5,), 7, 1, device="cpu")
    assert z1.shape == (3, 5, 8)
    for z in (z1, z2):
        assert not bool(F.is_zero(z).all())
        assert bool(F.is_zero(S.combine(F.FR, z)).all())
    assert not torch.equal(z1, z2)
    assert torch.equal(z1, crng.zero_shares(F.FR, (5,), 7, 0, device="cpu"))
    other = CorrelatedRng.create(torch.Generator().manual_seed(4))
    assert not torch.equal(z1, other.zero_shares(F.FR, (5,), 7, 0,
                                                 device="cpu"))


def test_chained_masked_muls_equal_the_jax_packages(operands):
    """A masked product is a replicated share again: multiplying it by a
    third value (degree 2 on the product's shares, as the provers' combs
    do) gives the JAX package's shares and the product of the three
    opened values."""
    (x, jx), (y, jy), (mk, jmk) = operands["x"], operands["y"], operands["mask"]
    mk2, jmk2 = torch.roll(mk, 1, dims=0), jnp.roll(jmk, 1, axis=0)
    got = M.mul(F.FR, M.mul(F.FR, x, y, zero_mask=mk), x, zero_mask=mk2)
    with jax.disable_jit():
        want = JM.mul(JF.FR, JM.mul(JF.FR, jx, jy, zero_mask=jmk), jx,
                      zero_mask=jmk2)
    assert _port_ints(got) == _jax_ints(want)
    xs = np.asarray(_port_ints(M.open(F.FR, x)), dtype=object)
    ys = np.asarray(_port_ints(M.open(F.FR, y)), dtype=object)
    assert _port_ints(M.open(F.FR, got)) == ((xs * ys * xs) % MOD).tolist()


def test_every_port_model_share_mul_is_masked():
    """Every mpc.mul call-site on a prover path of the port supplies reshare
    re-randomization: a ``zero_mask=`` argument in the call, or a fresh zero
    share drawn just before it (twin of the JAX package's
    tests/test_shares_mpc.py test_every_model_share_mul_is_masked)."""
    root = pathlib.Path(__file__).resolve().parents[1] / "co_zkvms_tpu_torch"
    bad, seen = [], 0
    for path in root.glob("models/**/*.py"):
        lines = path.read_text().splitlines()
        for i, ln in enumerate(lines):
            if not re.search(r"\bmpc\.mul\(", ln):
                continue
            seen += 1
            stmt = " ".join(lines[i:i + 3])
            context = " ".join(lines[max(0, i - 10):i])
            if "zero_mask" in stmt or "zero_shares" in context:
                continue
            bad.append(f"{path.name}:{i + 1}: {ln.strip()}")
    assert seen > 0
    assert not bad, "unmasked share-muls on prover paths:\n" + "\n".join(bad)


def test_share_commitments_and_openings_sum_to_the_values():
    """mpc_pcs over share stacks equals pst13 on the opened tables: the
    commitment, the opening and the batch opening (value and proof)."""
    import os
    import pickle

    from co_zkvms_tpu_torch.models import mpc_pcs
    from co_zkvms_tpu_torch.ops import pst13

    path = os.path.join(os.path.dirname(__file__), "..", ".srs_cache",
                        "srs_3_2.pkl")
    with open(path, "rb") as fh:
        srs = convert.srs_from_raw(pickle.load(fh), device="cpu")
    rng = np.random.default_rng(6)
    tables = [F.from_int(F.FR, _ints(rng, (4,)), device="cpu")
              for _ in range(2)]                          # nv = 2 < srs.nv
    stacks = [S.share(F.FR, torch.Generator().manual_seed(i), t)
              for i, t in enumerate(tables)]
    point = F.from_int(F.FR, _ints(rng, (2,)), device="cpu")
    eta = F.from_int(F.FR, _ints(rng, ()), device="cpu")
    assert mpc_pcs.commit_shares(srs, stacks[1]) == \
        pst13.commit(srs, tables[1])
    assert mpc_pcs.open_shares(srs, stacks[0], point) == \
        pst13.open_at(srs, tables[0], point)
    assert mpc_pcs.batch_open_shares(srs, stacks, eta, point) == \
        pst13.batch_open(srs, tables, eta, point)
