"""The slice end to end: the port's single-party Spartan prover
(co_zkvms_tpu_torch.models.spartan) on the CPU, checked by the JAX package's
host verifier (pure Python: no JAX program is compiled).

The cubic circuit, setup_cached(3, seed=2) and z = [1, 35, 3, 9, 27] are
those of tests/test_spartan.py. The slow test proves the same statement
with the JAX package and requires the two proofs to be equal field by
field; it is the only port test that runs a JAX prover.
"""

import os
import pickle

import pytest

from co_zkvms_tpu.models import spartan as JS
from co_zkvms_tpu.models.r1cs import R1CSBuilder as JBuilder
from co_zkvms_tpu.models.synthetic import squaring_chain as j_squaring_chain
from co_zkvms_tpu.ops import pst13 as JP


torch = S = R1CSBuilder = squaring_chain = convert = None  # bound by _port()


def _port():
    """Import torch and the port when the first test of this module runs,
    not at collection: an xdist worker that runs none of these tests
    never loads them."""
    global torch, S, R1CSBuilder, squaring_chain, convert
    import torch
    from co_zkvms_tpu_torch.models import spartan as S
    from co_zkvms_tpu_torch.models.r1cs import R1CSBuilder
    from co_zkvms_tpu_torch.models.synthetic import squaring_chain
    from co_zkvms_tpu_torch.utils import convert


SRS_DIR = os.path.join(os.path.dirname(__file__), "..", ".srs_cache")
MOD = JS.MOD
Z_CUBIC = [1, 35, 3, 9, 27]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    _port()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _port_srs(nv, seed):
    with open(os.path.join(SRS_DIR, f"srs_{nv}_{seed}.pkl"), "rb") as fh:
        return convert.srs_from_raw(pickle.load(fh), device="cpu")


def _jax_index(r1cs):
    """The verifier reads only r1cs and nv: no device lowering needed."""
    return JS.SpartanIndex(r1cs=r1cs, nv=r1cs.nv, da=None, db=None, dc=None)


def _as_jax_proof(p):
    return JS.SpartanProof(
        w_commitment=p.w_commitment, sumcheck1_msgs=p.sumcheck1_msgs,
        va=p.va, vb=p.vb, vc=p.vc, sumcheck2_msgs=p.sumcheck2_msgs,
        w_eval=p.w_eval, val_m=p.val_m,
        w_proof=JP.OpeningProof(pis=tuple(p.w_proof.pis)))


@pytest.fixture(scope="module")
def cubic_proof():
    r1cs = cubic_circuit(R1CSBuilder).build()
    index = S.SpartanIndex.from_r1cs(r1cs, device="cpu")
    srs = _port_srs(3, 2)
    return index, srs, S.prove(index, srs, Z_CUBIC)


def test_cubic_proof_verifies_under_jax_host_verifier(cubic_proof):
    index, srs, proof = cubic_proof
    assert index.nv == 3
    jsrs = JP.setup_cached(3, seed=2)
    jindex = _jax_index(cubic_circuit(JBuilder).build())
    jproof = _as_jax_proof(proof)
    assert JS.verify(jindex, jsrs, [35], jproof)
    assert not JS.verify(jindex, jsrs, [36], jproof)
    for field in ("va", "val_m", "w_eval"):
        bad = jproof._replace(**{field: (getattr(jproof, field) + 1) % MOD})
        assert not JS.verify(jindex, jsrs, [35], bad), field
    # and under the port's own host verifier
    assert S.verify(index, srs, [35], proof)
    assert not S.verify(index, srs, [35], proof._replace(va=(proof.va + 1) % MOD))


def test_squaring_chain_nv10_verifies_under_jax_host_verifier():
    n_cons = (1 << 10) - 4
    b = squaring_chain(n_cons)
    z = b.solve_witness([3])
    index = S.SpartanIndex.from_r1cs(b.build(), device="cpu")
    assert index.nv == 10
    proof = S.prove(index, _port_srs(10, 7), z)
    jb = j_squaring_chain(n_cons)
    assert jb.solve_witness([3]) == z
    jindex = _jax_index(jb.build())
    jsrs = JP.setup_cached(10, seed=7)
    assert JS.verify(jindex, jsrs, [3], _as_jax_proof(proof))
    bad = proof._replace(vc=(proof.vc + 1) % MOD)
    assert not JS.verify(jindex, jsrs, [3], _as_jax_proof(bad))


def test_prove_marks_its_phases(cubic_proof, monkeypatch):
    """Every phase of the real prove runs inside its named range, in
    protocol order, nested in the prove's own range."""
    import contextlib

    index, srs, proof = cubic_proof
    seen, depth = [], [0]

    @contextlib.contextmanager
    def mark(name):
        seen.append((depth[0], name))
        depth[0] += 1
        yield
        depth[0] -= 1

    monkeypatch.setattr(S, "phase", mark)
    assert S.prove(index, srs, Z_CUBIC) == proof
    assert seen == [(0, "prove")] + [(1, n) for n in (
        "tables", "commit", "Az, Bz, Cz", "sumcheck 1", "M_rx",
        "sumcheck 2", "open")]


def test_phase_table_reads_profiler_ranges():
    from co_zkvms_tpu_torch.utils import phases

    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with phases.phase("prove"):
            with phases.phase("tables"):
                torch.ones(64).cumsum(0)
            with phases.phase("open"):
                torch.ones(64).sum()
    rows, idle = phases.phase_table(prof.events())
    assert [r.name for r in rows] == ["prove", "tables", "open"]
    assert idle is None                  # no device work in a CPU profile
    assert all(r.device_s == 0 for r in rows)
    assert 0 < rows[1].host_s + rows[2].host_s <= rows[0].host_s


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0, 2), (1, 3), (5, 6)], 4.0),          # overlap counts once
    ([(5, 6), (0, 10), (2, 3)], 10.0),        # nested, unsorted
    ([(0, 1), (1, 2)], 2.0),                  # touching
])
def test_union_length(intervals, want):
    from co_zkvms_tpu_torch.utils import phases

    assert phases.union_length(intervals) == want


def test_device_work_is_kernels_copies_and_sets_only():
    """Operator rows and annotations that mirror device work, and the
    profiler's own overhead, are not device work (no double count)."""
    from types import SimpleNamespace as E

    from torch.autograd import DeviceType

    from co_zkvms_tpu_torch.utils import phases

    def ev(name, kind, dev, ann=False):
        return E(name=name, activity_type=kind, device_type=dev,
                 is_user_annotation=ann)

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    typed = [ev("aten::index", "cpu_op", cpu), ev("gather", "kernel", cuda),
             ev("Memcpy HtoD", "gpu_memcpy", cuda),
             ev("Memset", "gpu_memset", cuda),
             ev("spartan.open", "gpu_user_annotation", cuda, True),
             ev("Activity Buffer Request", "overhead", cuda)]
    assert [phases.is_device_work(e) for e in typed] == \
        [False, True, True, True, False, False]
    untyped = [ev(e.name, None, e.device_type, e.is_user_annotation)
               for e in typed]
    assert [phases.is_device_work(e) for e in untyped] == \
        [False, True, True, True, False, False]


@pytest.fixture(scope="module")
def jax_cubic_proof():
    srs = JP.setup_cached(3, seed=2)
    index = JS.SpartanIndex.from_r1cs(cubic_circuit(JBuilder).build())
    return JS.prove(index, srs, Z_CUBIC)


@pytest.mark.slow
def test_cubic_proof_equals_jax_proof(cubic_proof, jax_cubic_proof):
    _, _, proof = cubic_proof
    want = jax_cubic_proof
    for field in ("w_commitment", "sumcheck1_msgs", "va", "vb", "vc",
                  "sumcheck2_msgs", "w_eval", "val_m"):
        assert getattr(proof, field) == getattr(want, field), field
    assert tuple(proof.w_proof.pis) == tuple(want.w_proof.pis)
    assert want.dfs is None and want.zk is None
