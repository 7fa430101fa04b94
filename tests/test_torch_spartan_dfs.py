"""The succinct DFS round in the port (models/spartan_dfs.py) on the CPU:
its entries domain against the JAX package's indexer algorithm, and a DFS
proof of the cubic circuit, single-party and Rep3, checked by the JAX
package's host verifier (spartan.verify -> spartan_dfs.verify_round4, pure
Python: no JAX program is compiled); the index commitments against MSMs
over the JAX SRS. The slow tests require the index commitments to equal
the JAX build_index's and round 4's sumcheck to equal the JAX engine's.

The cubic circuit, setup_cached(4, seed=3) and z = [1, 35, 3, 9, 27] are
those of tests/test_spartan_dfs.py.
"""

import os
import random

import numpy as np
import pytest

from co_zkvms_tpu.models import spartan as JS
from co_zkvms_tpu.models import spartan_dfs as JD
from co_zkvms_tpu.models.r1cs import R1CSBuilder as JBuilder
from co_zkvms_tpu.models.synthetic import random_quadratic as j_random_quadratic
from co_zkvms_tpu.ops import field as JF
from co_zkvms_tpu.ops import pst13 as JP
from co_zkvms_tpu.ops import ref_bn254 as jbn
from co_zkvms_tpu.ops import sumcheck as JSC
from co_zkvms_tpu.ops import transcript as JT
from test_torch_zk import JAX_CLASSES, Z_CUBIC, cubic_circuit, jax_index, port_srs
from test_torch_zk import _port as _port_zk

MOD = JS.MOD

torch = S = D = CS = F = SC = R1CSBuilder = convert = None  # bound by _port()


def _port():
    """Import torch and the port when the first test of this module runs,
    not at collection: an xdist worker that runs none of these tests
    never loads them."""
    global torch, S, D, CS, F, SC, R1CSBuilder, convert
    import torch
    from co_zkvms_tpu_torch.models import co_spartan as CS
    from co_zkvms_tpu_torch.models import spartan as S
    from co_zkvms_tpu_torch.models import spartan_dfs as D
    from co_zkvms_tpu_torch.models.r1cs import R1CSBuilder
    from co_zkvms_tpu_torch.ops import field as F
    from co_zkvms_tpu_torch.ops import sumcheck as SC
    from co_zkvms_tpu_torch.utils import convert
    _port_zk()                      # binds what port_srs uses


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    _port()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_entries(r1cs):
    """The JAX package's build_index up to its device tables (a dict of
    (row, col) -> [a, b, c] values, sorted, padded to 2^dlog)."""
    entries = {}
    for mat, slot in ((r1cs.a, 0), (r1cs.b, 1), (r1cs.c, 2)):
        for r, c, v in zip(mat.rows, mat.cols, mat.vals):
            entries.setdefault((int(r), int(c)), [0, 0, 0])[slot] = int(v) % MOD
    keys = sorted(entries)
    dlog = max((max(len(keys), 1) - 1).bit_length(), r1cs.nv, 1)
    pad = (1 << dlog) - len(keys)
    rows = [r for r, _ in keys] + [0] * pad
    cols = [c for _, c in keys] + [0] * pad
    vals = [[entries[k][s] for k in keys] + [0] * pad for s in range(3)]
    return dlog, rows, cols, vals


def test_entries_match_the_jax_indexer():
    """Same domain, order, padding and values as the JAX build_index, on
    the cubic circuit and on random_quadratic (two entries per row and
    side, (r, c) positions shared across matrices)."""
    from co_zkvms_tpu_torch.models.synthetic import random_quadratic

    for r1cs, jr1cs in (
            (cubic_circuit(R1CSBuilder).build(),
             cubic_circuit(JBuilder).build()),
            (random_quadratic(40, random.Random(4)).build(),
             j_random_quadratic(40, random.Random(4)).build())):
        got = D.entries(r1cs)
        dlog, rows, cols, vals = _jax_entries(jr1cs)
        assert got.dlog == dlog
        assert got.rows.tolist() == rows and got.cols.tolist() == cols
        assert [[int(v) for v in col] for col in got.vals] == vals


@pytest.fixture(scope="module")
def dfs_setup():
    r1cs = cubic_circuit(R1CSBuilder).build()
    index = S.SpartanIndex.from_r1cs(r1cs, device="cpu")
    srs = port_srs(4, 3)
    dfs = D.build_index(r1cs, srs)
    return index, srs, dfs, S.prove(index, srs, Z_CUBIC, dfs=dfs)


def _jax_index_tables(jr1cs):
    """The seven tables the JAX build_index commits, as ints."""
    dlog, rows, cols, vals = _jax_entries(jr1cs)
    n = 1 << jr1cs.nv
    return {"row": rows, "col": cols, "val_a": vals[0], "val_b": vals[1],
            "val_c": vals[2],
            "freq_r": np.bincount(rows, minlength=n).tolist(),
            "freq_c": np.bincount(cols, minlength=n).tolist()}


def _host_coords(limbs):
    """JAX Montgomery Fq limbs [n, 16] -> standard-form ints, on the host
    (the spec's R^-1; no JAX program)."""
    return [JF.limbs_to_int(row) * JF.FQ.r_inv % JF.FQ.modulus
            for row in np.asarray(limbs)]


def test_index_commitments_equal_msms_over_the_jax_srs(dfs_setup):
    """Each commitment of the port's build_index is the MSM of the JAX
    indexer's table over the JAX SRS level of its size (pst13.commit),
    summed point by point with the JAX package's ref_bn254."""
    _, _, dfs, _ = dfs_setup
    jsrs = JP.setup_cached(4, seed=3)
    tables = _jax_index_tables(cubic_circuit(JBuilder).build())
    assert set(dfs.comms) == set(tables)
    for name, tab in tables.items():
        level = jsrs.level(jsrs.nv - (len(tab).bit_length() - 1))
        xs, ys = _host_coords(level.x), _host_coords(level.y)
        assert len(xs) == len(tab)
        want = jbn.msm([jbn.g1(x, y) for x, y in zip(xs, ys)], tab)
        assert dfs.comms[name].xy == jbn.g1_coords(want), name


def _jax_vk(dfs):
    return JD.DFSVerifierKey(nv=dfs.nv, dlog=dfs.dlog, dd=dfs.dd,
                             comms={k: JP.Commitment(xy=v.xy)
                                    for k, v in dfs.comms.items()})


def test_dfs_proof_verifies_under_jax_verify_round4(dfs_setup):
    index, srs, dfs, proof = dfs_setup
    assert proof.dfs is not None and dfs.dlog == 4
    jsrs = JP.setup_cached(4, seed=3)
    jindex = jax_index(cubic_circuit(JBuilder).build())
    jvk = _jax_vk(dfs)
    assert convert.dfs_vk_from(jvk) == dfs.vk
    jproof = convert.retype(proof, JAX_CLASSES)
    assert JS.verify(jindex, jsrs, [35], jproof, dfs_vk=jvk)
    # tampering with the claimed val_m breaks the logup round
    assert not JS.verify(jindex, jsrs, [35], jproof._replace(
        val_m=(proof.val_m + 1) % MOD), dfs_vk=jvk)
    # tampering with an opened oracle value fails the batch opening
    evs = dict(proof.dfs.evals)
    evs["val_a"] = (evs["val_a"] + 1) % MOD
    bad = jproof._replace(dfs=jproof.dfs._replace(evals=evs))
    assert not JS.verify(jindex, jsrs, [35], bad, dfs_vk=jvk)
    # a DFS proof needs the verifier key
    assert not JS.verify(jindex, jsrs, [35], jproof)
    # the port's own host verifier
    assert S.verify(index, srs, [35], proof, dfs_vk=dfs.vk)
    assert not S.verify(index, srs, [36], proof, dfs_vk=dfs.vk)


# The JAX build_index, in a process of its own: XLA:CPU maps several memory
# regions for each compiled program it loads, and a process that also runs
# the JAX DFS prove passes the kernel's map limit (vm.max_map_count, 65530
# by default) and dies in LLVM ("Cannot allocate memory", then a segfault).
_JAX_BUILD_INDEX = """
import pickle, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir", sys.argv[1])
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
from co_zkvms_tpu.models import spartan_dfs as JD
from co_zkvms_tpu.models.r1cs import R1CSBuilder
from co_zkvms_tpu.ops import pst13 as JP
from test_torch_zk import cubic_circuit
dfs = JD.build_index(cubic_circuit(R1CSBuilder).build(),
                     JP.setup_cached(4, seed=3))
sys.stdout.buffer.write(pickle.dumps(
    ((dfs.nv, dfs.dlog, dfs.dd), {k: v.xy for k, v in dfs.comms.items()})))
"""


@pytest.mark.slow
def test_dfs_index_commitments_equal_the_jax_build_index(dfs_setup):
    """The JAX package's build_index (compiled, as tests/test_spartan_dfs.py
    runs it) commits the same points as the port's."""
    import pickle
    import subprocess
    import sys

    import jax

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [os.path.dirname(here), here]))
    out = subprocess.run(
        [sys.executable, "-c", _JAX_BUILD_INDEX,
         str(jax.config.jax_compilation_cache_dir)],
        env=env, capture_output=True, check=True, timeout=2400)
    shape, comms = pickle.loads(out.stdout)
    _, _, dfs, _ = dfs_setup
    assert (dfs.nv, dfs.dlog, dfs.dd) == shape
    assert {k: v.xy for k, v in dfs.comms.items()} == comms


@pytest.mark.slow
def test_round4_sumcheck_equals_the_jax_engine(dfs_setup, monkeypatch):
    """prove_round4's sumcheck (15 tables, constants, degree 3) against the
    JAX engine with the JAX package's comb under jax.disable_jit(), on the
    same tables, constants and transcript state: equal round messages,
    challenges, bound tables and transcript state after it."""
    import jax
    import jax.numpy as jnp

    index, srs, dfs, proof = dfs_setup
    calls = []
    engine = SC.prove

    def spy(spec, ht, polys, degree, comb, **kw):
        state = ht.state
        res = engine(spec, ht, polys, degree, comb, **kw)
        if comb is D._comb_dfs:
            calls.append((state, polys, kw["consts"], res, ht.state))
        return res

    monkeypatch.setattr(SC, "prove", spy)
    assert S.prove(index, srs, Z_CUBIC, dfs=dfs) == proof
    (state, polys, consts, res, after), = calls
    assert res.round_msgs == proof.dfs.sumcheck_msgs

    def jx(t):
        return jnp.asarray(convert.fe_to_limbs16(t))

    jht = JT.HostTranscript(b"")
    jht.state = state
    with jax.disable_jit():
        jres = JSC.prove(JF.FR, jht.device_state(), [jx(p) for p in polys],
                         degree=3, comb=JD._comb_dfs,
                         consts=tuple(jx(c) for c in consts))
        msgs = JSC.round_msgs_to_ints(jres.round_msgs)
        rs = [int(v) for v in JF.to_int(JF.FR, jres.challenges)]
        finals = [int(JF.to_int(JF.FR, p.reshape(-1, 16)[0]))
                  for p in jres.final_polys]
    assert res.round_msgs == msgs
    assert res.challenge_ints == rs
    assert [int(F.to_int(F.FR, p.reshape(-1, 8)[0]))
            for p in res.final_polys] == finals
    assert JT.HostTranscript.from_device_state(jres.state).state == after


def test_rep3_dfs_proof_equals_single_party(dfs_setup):
    index, srs, dfs, proof = dfs_setup
    rep3 = CS.prove_rep3(index, srs, Z_CUBIC, dfs=dfs,
                         share_gen=torch.Generator().manual_seed(21),
                         mask_gen=torch.Generator().manual_seed(22))
    assert rep3 == proof
