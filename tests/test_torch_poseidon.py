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
plain B12 is held to it here on the inputs of that test."""

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
