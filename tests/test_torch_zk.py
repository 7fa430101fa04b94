"""zk Spartan in the port (co_zkvms_tpu_torch.ops.zk, the zk branch of
models/spartan.py) on the CPU, checked by the JAX package's host verifier,
and the port's zk host functions against the JAX package's (pure Python on
both sides: no JAX program is compiled).

The cubic circuit, setup_cached(3, seed=2), z = [1, 35, 3, 9, 27] and
zk.from_seed(3, seed=2, max_deg=4) are those of tests/test_co_spartan.py.
"""

import os
import pickle
import random

import numpy as np
import pytest

from co_zkvms_tpu.models import spartan as JS
from co_zkvms_tpu.models import spartan_dfs as JD
from co_zkvms_tpu.models.r1cs import R1CSBuilder as JBuilder
from co_zkvms_tpu.ops import pst13 as JP
from co_zkvms_tpu.ops import zk as JZ

torch = S = ZK = SC = F = R1CSBuilder = convert = None  # bound by _port()


def _port():
    """Import torch and the port when the first test of this module runs,
    not at collection: an xdist worker that runs none of these tests
    never loads them."""
    global torch, S, ZK, SC, F, R1CSBuilder, convert
    import torch
    from co_zkvms_tpu_torch.models import spartan as S
    from co_zkvms_tpu_torch.models.r1cs import R1CSBuilder
    from co_zkvms_tpu_torch.ops import field as F
    from co_zkvms_tpu_torch.ops import sumcheck as SC
    from co_zkvms_tpu_torch.ops import zk as ZK
    from co_zkvms_tpu_torch.utils import convert


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    _port()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SRS_DIR = os.path.join(os.path.dirname(__file__), "..", ".srs_cache")
MOD = JS.MOD
Z_CUBIC = [1, 35, 3, 9, 27]
JAX_CLASSES = {"SpartanProof": JS.SpartanProof, "ZkData": JS.ZkData,
               "HidingProof": JZ.HidingProof, "DFSRoundProof": JD.DFSRoundProof,
               "OpeningProof": JP.OpeningProof}


def cubic_circuit(builder):
    """x^3 + x + 5 == y with y public: wires [1, y, x, w1, w2]."""
    b = builder(num_public=2)
    x = b.new_wire()
    w1 = b.new_wire()
    w2 = b.new_wire()
    b.add_constraint([(1, x)], [(1, x)], [(1, w1)])
    b.add_constraint([(1, w1)], [(1, x)], [(1, w2)])
    b.add_constraint([(1, w2), (1, x), (5, 0)], [(1, 0)], [(1, 1)])
    return b


def port_srs(nv, seed):
    with open(os.path.join(SRS_DIR, f"srs_{nv}_{seed}.pkl"), "rb") as fh:
        return convert.srs_from_raw(pickle.load(fh), device="cpu")


def jax_index(r1cs):
    """The verifier reads only r1cs and nv: no device lowering needed."""
    return JS.SpartanIndex(r1cs=r1cs, nv=r1cs.nv, da=None, db=None, dc=None)


@pytest.fixture(scope="module")
def jparams():
    return JZ.from_seed(3, seed=2, max_deg=4)


@pytest.fixture(scope="module")
def zk_proof(jparams):
    index = S.SpartanIndex.from_r1cs(cubic_circuit(R1CSBuilder).build(),
                                     device="cpu")
    srs = port_srs(3, 2)
    params = ZK.from_seed(3, seed=2, max_deg=4)
    proof = S.prove(index, srs, Z_CUBIC, zk_ctx=(params, random.Random(5)))
    return index, srs, params, proof


def test_params_equal_the_jax_packages(jparams):
    assert convert.zk_params_from(jparams) == ZK.from_seed(3, seed=2,
                                                           max_deg=4)


def test_zk_proof_verifies_under_jax_host_verifier(zk_proof, jparams):
    index, srs, params, proof = zk_proof
    assert proof.zk is not None and proof.w_proof is None
    jsrs = JP.setup_cached(3, seed=2)
    jindex = jax_index(cubic_circuit(JBuilder).build())
    jproof = convert.retype(proof, JAX_CLASSES)
    assert isinstance(jproof.zk.w_hiding, JZ.HidingProof)
    assert JS.verify(jindex, jsrs, [35], jproof, zk_params=jparams)
    assert not JS.verify(jindex, jsrs, [35],
                         jproof._replace(va=(proof.va + 1) % MOD),
                         zk_params=jparams)
    vals = list(proof.zk.g2_vals)
    vals[0] = (vals[0] + 1) % MOD
    bad = jproof._replace(zk=jproof.zk._replace(g2_vals=vals))
    assert not JS.verify(jindex, jsrs, [35], bad, zk_params=jparams)
    # no zk params: a zk proof is refused
    assert not JS.verify(jindex, jsrs, [35], jproof)
    # and the port's own host verifier
    assert S.verify(index, srs, [35], proof, zk_params=params)
    assert not S.verify(index, srs, [35],
                        proof._replace(w_eval=(proof.w_eval + 1) % MOD),
                        zk_params=params)


def test_zk_proofs_hide_and_differ_by_rng(zk_proof):
    index, srs, params, proof = zk_proof
    other = S.prove(index, srs, Z_CUBIC, zk_ctx=(params, random.Random(6)))
    assert other.w_commitment != proof.w_commitment
    assert other.sumcheck1_msgs != proof.sumcheck1_msgs
    assert S.verify(index, srs, [35], other, zk_params=params)


def test_mask_functions_equal_the_jax_packages(jparams):
    params = convert.zk_params_from(jparams)
    for degree in (2, 3):
        coeffs, dev = ZK.generate_mask(random.Random(degree), 3, degree,
                                       device="cpu")
        rng = random.Random(degree)
        jcoeffs = [[rng.randrange(MOD) for _ in range(degree + 1)]
                   for _ in range(3)]
        assert coeffs == jcoeffs
        assert [[int(v) for v in row] for row in F.to_int(F.FR, dev)] == \
            coeffs
        assert ZK.mask_sum_ints(coeffs) == JZ.mask_sum_ints(coeffs)
        point = [rng.randrange(MOD) for _ in range(3)]
        assert ZK.mask_eval_ints(coeffs, point) == \
            JZ.mask_eval_ints(coeffs, point)
        assert ZK.commit_mask(params, coeffs) == \
            JZ.commit_mask(jparams, coeffs)
        assert ZK.open_mask(params, coeffs, point) == \
            JZ.open_mask(jparams, coeffs, point)


def test_hiding_proof_equals_the_jax_packages(zk_proof, jparams):
    """Re-randomizing one base opening with the same rng stream gives the
    same points in both packages."""
    index, srs, params, _ = zk_proof
    rng = np.random.default_rng(8)
    table = [int(v) for v in rng.integers(0, 1 << 62, 8)]
    point = [int(v) for v in rng.integers(0, 1 << 62, 3)]
    from co_zkvms_tpu_torch.ops import pst13

    t = F.from_int(F.FR, table, device="cpu")
    _, base = pst13.open_at(srs, t, F.from_int(F.FR, point, device="cpu"))
    got = ZK.hide_proof(srs, params, base, point, 77, random.Random(3))
    jsrs = JP.setup_cached(3, seed=2)
    want = JZ.hide_proof(jsrs, jparams, JP.OpeningProof(pis=base.pis),
                         point, 77, random.Random(3))
    assert tuple(got) == tuple(want)


def test_zk_mask_precompute_matches_a_direct_sum():
    """u_j(t), the suffix sums and the hypercube sum of g, from ints."""
    rng = random.Random(9)
    nv, degree = 4, 3
    coeffs = [[rng.randrange(MOD) for _ in range(degree + 1)]
              for _ in range(nv)]
    u_ev, suffix, pow_r, pow_r1, g_sum = SC.zk_mask_precompute(
        coeffs, degree, MOD)

    def u(j, x):
        return sum(c * pow(x, i, MOD) for i, c in enumerate(coeffs[j])) % MOD

    assert u_ev == [[u(j, t) for t in range(degree + 1)] for j in range(nv)]
    assert suffix == [sum(u(k, 0) + u(k, 1) for k in range(j + 1, nv)) % MOD
                      for j in range(nv)]
    assert pow_r == [2 ** (nv - j - 1) for j in range(nv)]
    assert pow_r1 == [2 ** (nv - j - 2) for j in range(nv - 1)] + [0]
    cube = sum(sum(u(j, (x >> j) & 1) for j in range(nv))
               for x in range(1 << nv)) % MOD
    assert g_sum == cube == JZ.mask_sum_ints(coeffs)
