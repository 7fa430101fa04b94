"""co-Spartan in the port (models/co_spartan.py, the Rep3 prover with all
three parties on one device) on the CPU: its proof equals the port's
single-party proof field by field, plain and zk, under two different pairs
of share and mask generators, and the JAX package's host verifier accepts
it. (tests/test_torch_spartan_dfs.py holds the Rep3 DFS case.)"""

import random

import pytest

from co_zkvms_tpu.models import spartan as JS
from co_zkvms_tpu.models.r1cs import R1CSBuilder as JBuilder
from co_zkvms_tpu.ops import pst13 as JP
from co_zkvms_tpu.ops import zk as JZ
from test_torch_zk import JAX_CLASSES, Z_CUBIC, cubic_circuit, jax_index, port_srs
from test_torch_zk import _port as _port_zk

MOD = JS.MOD

torch = S = CS = ZK = R1CSBuilder = convert = None  # bound by _port()


def _port():
    """Import torch and the port when the first test of this module runs,
    not at collection: an xdist worker that runs none of these tests
    never loads them."""
    global torch, S, CS, ZK, R1CSBuilder, convert
    import torch
    from co_zkvms_tpu_torch.models import co_spartan as CS
    from co_zkvms_tpu_torch.models import spartan as S
    from co_zkvms_tpu_torch.models.r1cs import R1CSBuilder
    from co_zkvms_tpu_torch.ops import zk as ZK
    from co_zkvms_tpu_torch.utils import convert
    _port_zk()                      # binds what port_srs uses


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    _port()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def single():
    """The single-party proofs, plain and zk, and what made them."""
    index = S.SpartanIndex.from_r1cs(cubic_circuit(R1CSBuilder).build(),
                                     device="cpu")
    srs = port_srs(3, 2)
    params = ZK.from_seed(3, seed=2, max_deg=4)
    proofs = {
        "plain": S.prove(index, srs, Z_CUBIC),
        "zk": S.prove(index, srs, Z_CUBIC, zk_ctx=(params, random.Random(5))),
    }
    return index, srs, params, proofs


@pytest.mark.parametrize("mode", ["plain", "zk"])
def test_rep3_equals_single_party(single, mode):
    """Under two pairs of share and mask generators."""
    index, srs, params, proofs = single
    for seeds in ((42, 43), (99, 100)):
        zk_ctx = (params, random.Random(5)) if mode == "zk" else None
        rep3 = CS.prove_rep3(index, srs, Z_CUBIC,
                             share_gen=torch.Generator().manual_seed(seeds[0]),
                             mask_gen=torch.Generator().manual_seed(seeds[1]),
                             zk_ctx=zk_ctx)
        for field in rep3._fields:
            assert getattr(rep3, field) == getattr(proofs[mode], field), \
                (seeds, field)


def test_rep3_proof_verifies_under_jax_host_verifier(single):
    index, srs, params, _ = single
    rep3 = CS.prove_rep3(index, srs, Z_CUBIC)
    jsrs = JP.setup_cached(3, seed=2)
    jindex = jax_index(cubic_circuit(JBuilder).build())
    jproof = convert.retype(rep3, JAX_CLASSES)
    assert JS.verify(jindex, jsrs, [35], jproof)
    assert not JS.verify(jindex, jsrs, [35],
                         jproof._replace(vb=(rep3.vb + 1) % MOD))
    assert S.verify(index, srs, [35], rep3)
