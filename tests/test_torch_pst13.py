"""Port PST13 (co_zkvms_tpu_torch.ops.pst13): setup against the tracked SRS
files, and commit/open checked by both packages' host verifiers.

The .srs_cache pickles hold numpy arrays and ints only; they are read here
without the JAX package and converted with utils.convert.
"""

import os
import pickle

import numpy as np
import pytest

from co_zkvms_tpu.ops import pst13 as JP


torch = F = pst13 = convert = None  # bound by _port()


def _port():
    """Import torch and the port when the first test of this module runs,
    not at collection: an xdist worker that runs none of these tests
    never loads them."""
    global torch, F, pst13, convert
    import torch
    from co_zkvms_tpu_torch.ops import field as F
    from co_zkvms_tpu_torch.ops import pst13
    from co_zkvms_tpu_torch.utils import convert


SRS_DIR = os.path.join(os.path.dirname(__file__), "..", ".srs_cache")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    _port()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raw(nv, seed):
    with open(os.path.join(SRS_DIR, f"srs_{nv}_{seed}.pkl"), "rb") as fh:
        return pickle.load(fh)


@pytest.mark.parametrize("nv,seed", [(3, 2), (10, 7)])
def test_setup_equals_tracked_srs(nv, seed):
    raw = _raw(nv, seed)
    got = pst13.setup(nv, seed, device="cpu")
    assert got.nv == raw["nv"]
    assert len(got.ck_levels) == len(raw["levels"]) == nv + 1
    for lvl, (x, y) in zip(got.ck_levels, raw["levels"]):
        np.testing.assert_array_equal(convert.fe_to_limbs16(lvl.x), x)
        np.testing.assert_array_equal(convert.fe_to_limbs16(lvl.y), y)
    want = convert.srs_from_raw(raw, device="cpu")
    assert got.h_taus == want.h_taus


def test_commit_open_verify_both_packages():
    rng = np.random.default_rng(41)
    srs = convert.srs_from_raw(_raw(4, 1), device="cpu")
    jsrs = JP.setup_cached(4, seed=1)
    for nv in (4, 2):
        vals = [int(v) for v in rng.integers(0, 1 << 62, size=1 << nv)]
        table = F.from_int(F.FR, vals, device="cpu")
        point = [int(v) for v in rng.integers(0, 1 << 62, size=nv)]
        comm = pst13.commit(srs, table)
        value, proof = pst13.open_at(srs, table,
                                     F.from_int(F.FR, point, device="cpu"))
        assert pst13.verify(srs, comm, point, value, proof)
        assert JP.verify(jsrs, JP.Commitment(comm.xy), point, value,
                         JP.OpeningProof(pis=proof.pis))
        bad = (value + 1) % F.FR.modulus
        assert not pst13.verify(srs, comm, point, bad, proof)
        assert not JP.verify(jsrs, JP.Commitment(comm.xy), point, bad,
                             JP.OpeningProof(pis=proof.pis))
