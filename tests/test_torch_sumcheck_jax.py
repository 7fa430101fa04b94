"""Port sumcheck prover against the JAX package's sumcheck.prove at nv = 4,
degree 2 and degree 3 with split-eq: equal round messages, challenges,
final values and transcript state. The JAX prover runs under
jax.disable_jit(), so no JAX program is compiled; each call still takes
about a minute on the CPU, which is why these two live in their own file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from co_zkvms_tpu.models import spartan as JS
from co_zkvms_tpu.ops import field as JF
from co_zkvms_tpu.ops import sumcheck as JSC
from co_zkvms_tpu.ops import transcript as JT
from test_torch_sumcheck import LABEL, _port_prove, _tables
from test_torch_sumcheck import _port as _port_sumcheck


torch = F = T = convert = None  # bound by _port()


def _port():
    """Import torch and the port when the first test of this module runs,
    not at collection: an xdist worker that runs none of these tests
    never loads them."""
    global torch, F, T, convert
    import torch
    from co_zkvms_tpu_torch.ops import field as F
    from co_zkvms_tpu_torch.ops import transcript as T
    from co_zkvms_tpu_torch.utils import convert
    _port_sumcheck()                # binds what _port_prove uses


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    _port()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_prove(degree, tables, taus):
    to_jax = lambda ints: jnp.asarray(convert.fe_to_limbs16(
        F.from_int(F.FR, ints, device="cpu")))
    comb = JS._comb2 if degree == 2 else JS._comb1
    with jax.disable_jit():
        res = JSC.prove(JF.FR, JT.init(LABEL), [to_jax(t) for t in tables],
                        degree=degree, comb=comb,
                        eq_split=None if taus is None else to_jax(taus))
        msgs = JSC.round_msgs_to_ints(res.round_msgs)
        rs = [int(v) for v in JF.to_int(JF.FR, res.challenges)]
        finals = [int(JF.to_int(JF.FR, p[0])) for p in res.final_polys]
        state = np.asarray(res.state)
    return msgs, rs, finals, state


@pytest.mark.parametrize("degree", [2, 3])
def test_matches_jax_prove_at_nv4(degree):
    nv = 4
    tables = _tables(nv, 2 if degree == 2 else 3, seed=400 + degree)
    taus = None if degree == 2 else _tables(nv, 1, seed=11)[0][:nv]
    res = _port_prove(degree, tables, taus)
    msgs, rs, finals, state = _jax_prove(degree, tables, taus)
    assert res.round_msgs == msgs
    assert res.challenge_ints == rs
    assert [F.to_int(F.FR, p[0]) for p in res.final_polys] == finals
    # the host transcript ends in the JAX device sponge's state
    ht = T.HostTranscript(LABEL)
    for msg in res.round_msgs:
        ht.absorb_many(msg)
        ht.challenge()
    assert ht.state == b"".join(int(w).to_bytes(4, "little") for w in state)
