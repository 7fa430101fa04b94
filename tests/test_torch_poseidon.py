"""The port's Poseidon (co_zkvms_tpu_torch.ops.poseidon) against the JAX
package's ops/poseidon.py on the same inputs, through the plain versions
on the CPU: parameters, permutations at t = 3, 4, 5, the plain B12 on a
batch, hashes, a Merkle layer and the transcript must be equal integers.

The JAX side runs its round composition ``_permute_jit`` one field
operation at a time (its undecorated body, patched in for this module):
compiled whole, the 65 unrolled rounds take XLA:CPU many minutes and
gigabytes. Its Pallas kernel ``_permute_pallas_t3`` is held to that same
composition by the JAX package's own
``tests/test_poseidon.py::test_fused_kernel_matches_jnp_path``, so the
plain B12 is held to it here on the inputs of that test.

B12's schedule, with sparse partial rounds, is held on host ints to the
JAX package's host_permute, exactly, and its derived factors and moved
constants to the dense matrix and the original constants."""

import jax
import numpy as np
import pytest

from co_zkvms_tpu.ops import field as JF
from co_zkvms_tpu.ops import poseidon as JP

MOD = JF.FR.modulus

torch = F = P = convert = None  # bound by _port()


def _port():
    """Import torch and the port when the first test of this module runs,
    not at collection: an xdist worker that runs none of these tests
    never loads them."""
    global torch, F, P, convert
    import torch
    from co_zkvms_tpu_torch.ops import field as F
    from co_zkvms_tpu_torch.ops import poseidon as P
    from co_zkvms_tpu_torch.utils import convert


@pytest.fixture(autouse=True, scope="module")
def _port_and_op_by_op_jax():
    _port()
    mp = pytest.MonkeyPatch()
    mp.setattr(JP, "_permute_jit", JP._permute_jit.__wrapped__)
    JP._ts_device.cache_clear()
    yield
    JP._ts_device.cache_clear()
    mp.undo()


def _to_jax(t):
    return jax.numpy.asarray(convert.fe_to_limbs16(t))


def _same(t, a):
    assert t.device.type == "cpu"
    assert np.array_equal(convert.fe_to_limbs16(t), np.asarray(a))


def _ints(rng, shape):
    flat = [int.from_bytes(rng.bytes(32), "little") % MOD
            for _ in range(int(np.prod(shape)))]
    return np.asarray(flat, dtype=object).reshape(shape)


def test_params_equal_the_jax_packages():
    cpu = torch.device("cpu")
    for t in (3, 4, 5):
        assert P.params_host(t) == JP.params_host(t)
        for mine, theirs in zip(P._params_dev(t, cpu), JP._params_dev(t)):
            _same(mine, theirs)


def test_permute_equals_the_jax_package_and_the_host_mirror():
    for t in (3, 4, 5):
        vals = list(range(1, t + 1))
        state = F.from_int(F.FR, vals, device="cpu")
        out = P.permute(state)
        _same(out, JP.permute(JF.from_int(JF.FR, vals).reshape(t, 16)))
        assert F.to_int(F.FR, out).tolist() == P.host_permute(vals) == \
            JP.host_permute(vals)


def test_plain_b12_equals_the_jax_permutation_on_a_batch():
    """The inputs of the JAX package's fused-kernel test (n = 8)."""
    jstate = JF.random(JF.FR, jax.random.key(31), (8, 3))
    rc, mds = JP._params_dev(3)
    want = JP._permute_jit(jstate, 3, rc, mds)
    state = convert.fe_from_limbs16(np.asarray(jstate), device="cpu")
    _same(P.permute_plain(state), want)
    _same(P.permute(state), want)


def test_hash_and_merkle_layer_equal_the_jax_packages():
    rng = np.random.default_rng(1)
    vals = rng.integers(0, 1 << 62, (5, 2))
    pairs = F.from_int(F.FR, vals, device="cpu")
    got = P.hash_fes(pairs)
    _same(got, JP.hash_fes(_to_jax(pairs)))
    assert F.to_int(F.FR, got).tolist() == [
        JP.host_hash([int(v) for v in row]) for row in vals]
    assert torch.equal(P.hash2(pairs[:, 0], pairs[:, 1]), got)
    leaves = F.from_int(F.FR, list(range(8)), device="cpu")
    layer = P.merkle_layer(leaves)
    assert layer.shape == (4, 8)
    _same(layer, JP.merkle_layer(_to_jax(leaves)))


def test_transcript_equals_the_jax_package_and_the_host_mirror():
    label = b"pos-transcript"
    st = P.transcript_init(label, device="cpu")
    jst = JP.transcript_init(label)
    host = P.HostPoseidonTranscript(label)
    assert host.state == JP.HostPoseidonTranscript(label).state
    _same(st, jst)
    for value in (42, 7, MOD - 1):
        fe = F.from_int(F.FR, value, device="cpu")
        st = P.transcript_absorb(st, fe)
        jst = JP.transcript_absorb(jst, _to_jax(fe))
        host.absorb(value)
        _same(st, jst)
        st, ch = P.transcript_challenge(st)
        jst, jch = JP.transcript_challenge(jst)
        _same(ch, jch)
        assert F.to_int(F.FR, ch) == host.challenge()
    assert F.to_int(F.FR, st).tolist() == host.state


def _sparse_states(t, n, seed):
    """n seeded t-lane states, the first ones made of 0, 1 and r - 1."""
    rng = np.random.default_rng(seed)
    edge = [[0] * t, [1] * t, [MOD - 1] * t, [0, 1] + [MOD - 1] * (t - 2),
            [MOD - 1] + [0] * (t - 1)]
    rand = [[int(v) for v in _ints(rng, (t,))] for _ in range(n - len(edge))]
    return edge + rand


@pytest.mark.parametrize("t,n", [(3, 64), (4, 6), (5, 6)])
def test_sparse_schedule_equals_the_jax_host_permute(t, n):
    """B12's schedule (sparse partial rounds) on host ints against the JAX
    package's host_permute, exactly."""
    for state in _sparse_states(t, n, 60 + t):
        assert P.host_permute_sparse(state) == JP.host_permute(state), state


@pytest.mark.parametrize("t", [3, 4, 5])
def test_sparse_factors_and_moved_constants(t):
    """From the last partial round back: the round's matrix (M for the
    last) is A_k B_k with A_k = [[m00, row_k], [col_k, I]] from
    ``sparse[k]`` and B_k = diag(1, its lower-right block), the matrix
    before it is B_k M, and the first half's last matrix is B_0 M. Each
    partial round's constant goes back through M^-1 and returns through M
    to itself: its lane-0 part is the ``partial_rc`` of the round before,
    the rest joins that round's constant, and B_0 times what is left for
    the first partial round is ``pre_rc``."""
    r = MOD
    rc, mds = P.params_host(t)
    half, r_p = P.R_FULL // 2, P.R_PARTIAL[t]
    sp = P.sparse_params_host(t)
    assert sp.mds == mds and len(sp.sparse) == r_p
    assert sp.full_rc == rc[:half] + rc[half + r_p:]
    matrix = mds
    for k in range(r_p - 1, -1, -1):
        m00, *rest = sp.sparse[k]
        a = [[m00] + rest[:t - 1]] + [
            [c] + [int(i == j) for j in range(1, t)]
            for i, c in enumerate(rest[t - 1:], start=1)]
        b = [[1] + [0] * (t - 1)] + [[0] + row[1:] for row in matrix[1:]]
        assert P._mat_mul(a, b, r) == matrix, k
        matrix = P._mat_mul(b, mds, r)
    assert sp.pre_mds == matrix
    m_inv = P._mat_inv(mds, r)
    assert P._mat_mul(mds, m_inv, r) == [[int(i == j) for j in range(t)]
                                         for i in range(t)]
    assert sp.partial_rc[-1] == 0
    constant = list(rc[half + r_p - 1])
    for k in range(r_p - 1, 0, -1):
        lane0, *moved = P._mat_vec(m_inv, constant, r)
        assert P._mat_vec(mds, [lane0] + moved, r) == constant, k
        assert sp.partial_rc[k - 1] == lane0, k
        constant = [rc[half + k - 1][0]] + [
            (c + d) % r for c, d in zip(rc[half + k - 1][1:], moved)]
    assert sp.pre_rc == P._mat_vec(b, constant, r)

