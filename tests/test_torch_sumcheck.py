"""Port sumcheck prover (co_zkvms_tpu_torch.ops.sumcheck) against a
Python-int computation of the same round messages and the JAX package's
host verifier; the port's poly ops against Python ints.
(test_torch_sumcheck_jax.py holds the comparison with the JAX prover.)

Combs are the Spartan ones: degree 2 is p0 * p1; degree 3 with split-eq is
eq * (az * bz - cz), where the prover never sees the eq table.
"""

import numpy as np
import pytest

from co_zkvms_tpu.models import spartan as JS
from co_zkvms_tpu.ops import sumcheck as JSC
from co_zkvms_tpu.ops import transcript as JT


torch = S = F = P = SC = T = None  # bound by _port()


def _port():
    """Import torch and the port when the first test of this module runs,
    not at collection: an xdist worker that runs none of these tests
    never loads them."""
    global torch, S, F, P, SC, T
    import torch
    from co_zkvms_tpu_torch.models import spartan as S
    from co_zkvms_tpu_torch.ops import field as F
    from co_zkvms_tpu_torch.ops import poly as P
    from co_zkvms_tpu_torch.ops import sumcheck as SC
    from co_zkvms_tpu_torch.ops import transcript as T


MOD = JS.MOD
LABEL = b"torch-port/sumcheck-test"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    _port()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tables(nv, k, seed):
    rng = np.random.default_rng(seed)
    return [[int.from_bytes(rng.bytes(32), "little") % MOD
             for _ in range(1 << nv)] for _ in range(k)]


def _eq_table(point):
    t = [1]
    for r in point:
        t = [v * (1 - r) % MOD for v in t] + [v * r % MOD for v in t]
    return t


def _comb_ints(degree, vals):
    if degree == 2:
        return vals[0] * vals[1] % MOD
    eq, az, bz, cz = vals
    return eq * (az * bz - cz) % MOD


def _reference(degree, tables, taus, transcript):
    """Round messages and challenges over Python ints, with the eq table
    bound like any other table (no split): the messages must be equal."""
    tabs = ([_eq_table(taus)] if taus is not None else []) + \
        [list(t) for t in tables]
    msgs, rs = [], []
    while len(tabs[0]) > 1:
        msg = []
        for t in range(degree + 1):
            acc = 0
            for y in range(len(tabs[0]) // 2):
                vals = [(tb[2 * y] + t * (tb[2 * y + 1] - tb[2 * y])) % MOD
                        for tb in tabs]
                acc += _comb_ints(degree, vals)
            msg.append(acc % MOD)
        transcript.absorb_many(msg)
        r = transcript.challenge()
        tabs = [[(tb[2 * y] + r * (tb[2 * y + 1] - tb[2 * y])) % MOD
                 for y in range(len(tb) // 2)] for tb in tabs]
        msgs.append(msg)
        rs.append(r)
    return msgs, rs, [tb[0] for tb in tabs]


def _port_prove(degree, tables, taus):
    polys = [F.from_int(F.FR, t, device="cpu") for t in tables]
    comb = S._comb2 if degree == 2 else S._comb1
    eq_split = None if taus is None else F.from_int(F.FR, taus, device="cpu")
    return SC.prove(F.FR, T.HostTranscript(LABEL), polys, degree, comb,
                    eq_split=eq_split)


CASES = [(nv, d) for nv in (3, 4, 5, 6) for d in (2, 3)]


@pytest.mark.parametrize("nv,degree", CASES)
def test_messages_match_python_ints_and_verify(nv, degree):
    k = 2 if degree == 2 else 3
    tables = _tables(nv, k, seed=100 * nv + degree)
    taus = None if degree == 2 else _tables(nv, 1, seed=7 + nv)[0][:nv]
    res = _port_prove(degree, tables, taus)
    msgs, rs, finals = _reference(degree, tables, taus,
                                  JT.HostTranscript(LABEL))
    assert res.round_msgs == msgs
    assert res.challenge_ints == rs
    assert [int(v) for v in F.to_int(F.FR, res.challenges)] == rs
    got_finals = [F.to_int(F.FR, p[0]) for p in res.final_polys]
    assert got_finals == (finals if taus is None else finals[1:])

    # the JAX package's host verifier accepts the messages
    ev = _eq_table(taus) if taus is not None else None
    claim = sum(_comb_ints(degree, ([ev[i]] if ev else []) +
                           [t[i] for t in tables])
                for i in range(1 << nv)) % MOD
    vr, final_claim = JSC.verify(res.round_msgs, claim,
                                 JT.HostTranscript(LABEL))
    assert vr == rs
    want = _comb_ints(degree, ([JS._eq_eval_ints(taus, rs)] if ev else []) +
                      got_finals)
    assert final_claim == want


def test_poly_ops_match_python_ints():
    nv = 4
    table = _tables(nv, 1, seed=62)[0]
    r, s = _tables(nv, 2, seed=63)
    r, s = r[:nv], s[:nv]
    tr = F.from_int(F.FR, r, device="cpu")
    ts = F.from_int(F.FR, s, device="cpu")
    t = F.from_int(F.FR, table, device="cpu")
    assert list(F.to_int(F.FR, P.eq_table(F.FR, tr))) == _eq_table(r)
    bound = P.bind_low(F.FR, t, tr[0])
    assert list(F.to_int(F.FR, bound)) == [
        (table[2 * j] + r[0] * (table[2 * j + 1] - table[2 * j])) % MOD
        for j in range(1 << (nv - 1))]
    want = sum(v * e for v, e in zip(table, _eq_table(r))) % MOD
    assert F.to_int(F.FR, P.evaluate(F.FR, t, tr)) == want
    assert F.to_int(F.FR, P.eq_eval(F.FR, tr, ts)) == JS._eq_eval_ints(r, s)
    assert P.num_vars(t) == nv
