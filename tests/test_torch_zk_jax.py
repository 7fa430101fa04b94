"""The port's zk-masked sumcheck against the JAX package's engine: with the
same tables, mask coefficients and rho, the round messages, challenges and
final values are equal. The JAX prover runs under jax.disable_jit(), so no
JAX program is compiled; the call still takes most of a minute on the CPU,
so it lives in a file of its own (nv = 2, the inner comb: round 0 folds
the mask's suffix sum, round 1 its running sum A)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from co_zkvms_tpu.models import spartan as JS
from co_zkvms_tpu.ops import field as JF
from co_zkvms_tpu.ops import sumcheck as JSC
from co_zkvms_tpu.ops import transcript as JT

MOD = JS.MOD
LABEL = b"torch-port/zk-sumcheck-test"

torch = S = F = SC = T = convert = None  # bound by _port()


def _port():
    """Import torch and the port when the first test of this module runs,
    not at collection: an xdist worker that runs none of these tests
    never loads them."""
    global torch, S, F, SC, T, convert
    import torch
    from co_zkvms_tpu_torch.models import spartan as S
    from co_zkvms_tpu_torch.ops import field as F
    from co_zkvms_tpu_torch.ops import sumcheck as SC
    from co_zkvms_tpu_torch.ops import transcript as T
    from co_zkvms_tpu_torch.utils import convert


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    _port()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_zk_messages_equal_jax_engine_at_nv2():
    nv, degree = 2, 2
    rng = np.random.default_rng(31)

    def ints(k):
        return [int.from_bytes(rng.bytes(32), "little") % MOD
                for _ in range(k)]

    tables = [ints(1 << nv) for _ in range(2)]
    coeffs = [ints(degree + 1) for _ in range(nv)]
    rho = ints(1)[0]
    polys = [F.from_int(F.FR, t, device="cpu") for t in tables]
    zk_mask = (F.from_int(F.FR, rho, device="cpu"),
               F.from_int(F.FR, coeffs, device="cpu"))
    res = SC.prove(F.FR, T.HostTranscript(LABEL), polys, degree, S._comb2,
                   zk_mask=zk_mask)

    def to_jax(t):
        return jnp.asarray(convert.fe_to_limbs16(t))

    with jax.disable_jit():
        jres = JSC.prove(JF.FR, JT.init(LABEL), [to_jax(p) for p in polys],
                         degree=degree, comb=JS._comb2,
                         zk_mask=(to_jax(zk_mask[0]), to_jax(zk_mask[1])))
        msgs = JSC.round_msgs_to_ints(jres.round_msgs)
        rs = [int(v) for v in JF.to_int(JF.FR, jres.challenges)]
        finals = [int(JF.to_int(JF.FR, p[0])) for p in jres.final_polys]
    assert res.round_msgs == msgs
    assert res.challenge_ints == rs
    assert [int(F.to_int(F.FR, p[0])) for p in res.final_polys] == finals
    # the mask did fold in: the unmasked messages differ
    plain = SC.prove(F.FR, T.HostTranscript(LABEL), polys, degree, S._comb2)
    assert plain.round_msgs[0] != res.round_msgs[0]
