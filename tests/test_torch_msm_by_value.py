"""The port's MSM by-value path (co_zkvms_tpu_torch.ops.msm) against the
JAX package's (co_zkvms_tpu/ops/msm.py:603-679) and ref_bn254.

Points are distinct multiples e_i * G made by the port's fixed-base MSM
from a numpy seed; scalars are counter-like small values. The JAX side of
``_group_by_value`` runs eagerly with its B7 kernel body through fake
refs, as the JAX package's own kernel tests run it (Pallas interpret mode
compiles for many minutes on a CPU). The JAX ``_by_value_sums`` takes
minutes on a CPU either way (jit: its compile; eager: its window path),
so the final point is held to ref_bn254 instead.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from co_zkvms_tpu.ops import curve as JC
from co_zkvms_tpu.ops import curve_pallas as CP
from co_zkvms_tpu.ops import msm as JM
from co_zkvms_tpu.ops import ref_bn254 as bn


torch = C = F = M = convert = None  # bound by _port()

# the value mix of tests/test_curve_msm.py::test_msm_by_value_counter_path
COUNTER_VALUES = [0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 7]


def _port():
    """Import torch and the port when the first test of this module runs,
    not at collection: an xdist worker that runs none of these tests
    never loads them."""
    global torch, C, F, M, convert
    import torch
    from co_zkvms_tpu_torch.ops import curve as C
    from co_zkvms_tpu_torch.ops import field as F
    from co_zkvms_tpu_torch.ops import msm as M
    from co_zkvms_tpu_torch.utils import convert


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    _port()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool():
    """64 points e_i * G, the last one replaced by affine infinity (0, 0),
    with their exponents (0 for infinity)."""
    rng = np.random.default_rng(80)
    exps = [int.from_bytes(rng.bytes(32), "little") % bn.R_ORDER
            for _ in range(64)]
    g = C.points_from_ints([bn.g1_coords(bn.G1_GEN)], device="cpu")
    pts = C.to_affine(M.fixed_base_msm(C.APoint(g.x[0], g.y[0]),
                                       F.from_int(F.FR, exps, device="cpu")))
    pts = C.APoint(pts.x.clone(), pts.y.clone())
    pts.x[-1] = 0
    pts.y[-1] = 0
    exps[-1] = 0
    return pts, exps


def _std(vals):
    """Standard-form words of Fr scalars ``vals``: the port's int64 [N, 8]
    and the JAX package's uint32 [N, 16] 16-bit limbs."""
    std = M.standard_words(F.from_int(F.FR, vals, device="cpu"))
    return std, jnp.asarray(convert.fe_to_limbs16(std.to(torch.int32)))


def _counter_values(seed, n):
    rng = np.random.default_rng(seed)
    return [int(v) for v in rng.choice(COUNTER_VALUES, size=n)]


@pytest.mark.parametrize("case", ["counter", "max_small", "just_above",
                                  "high_limb", "random"])
def test_small_value_stats_match_jax(case):
    rng = np.random.default_rng(81)
    vals = _counter_values(82, 256)
    if case == "max_small":
        vals[5] = (1 << 16) - 1
    elif case == "just_above":
        vals[5] = 1 << 16
    elif case == "high_limb":
        vals[7] = 1 << 200
    elif case == "random":
        vals = [int.from_bytes(rng.bytes(32), "little") % bn.R_ORDER
                for _ in range(256)]
    std, std16 = _std(vals)
    small, distinct = jax.device_get(JM._small_value_stats(std16))
    assert M.small_value_stats(std) == (bool(small), int(distinct))


class _Ref:
    """Limb-major fake Pallas ref: ref[i, :] is limb row i."""

    def __init__(self, arr=None):
        self.a = [None] * 16 if arr is None else [arr[i] for i in range(16)]

    def __getitem__(self, key):
        return self.a[key[0]]

    def __setitem__(self, key, val):
        self.a[key[0]] = val

    def limbs(self):
        return jnp.stack([jnp.asarray(v) for v in self.a], axis=-1)


def _b7_body(p, q):
    """The JAX package's B7 kernel body on fake refs (curve_pallas.py
    _add_incomplete_kernel), for batches [N, 16]."""
    mod, _, n0 = CP._consts()
    outs = [_Ref(), _Ref(), _Ref()]
    CP._add_incomplete_kernel(*(_Ref(c.T) for c in (*p, *q)), *outs, mod, n0)
    return JC.JPoint(*(o.limbs() for o in outs))


def test_group_by_value_matches_jax(pool, monkeypatch):
    """Group sums (Jacobian and affine), values and mask equal the JAX
    ``_group_by_value`` on the same points and values: the same sort, the
    same pairs through the same formula. 40 points (6 levels), u_bound 8
    over 5 distinct values, so 3 slots stay empty; one point is
    infinity."""
    n, u_bound = 40, 8
    pts = C.APoint(*(c[-n:].contiguous() for c in pool[0]))
    vals = _counter_values(83, n)
    std, std16 = _std(vals)
    gsum, gval, ok = M._group_by_value(pts, std[:, 0], u_bound)

    monkeypatch.setattr(CP, "add_incomplete", _b7_body)
    pts32 = jnp.concatenate([jnp.asarray(convert.fe_to_limbs16(c))
                             for c in pts], axis=-1)
    with jax.disable_jit():
        jsum, jval, jok = JM._group_by_value.__wrapped__(
            pts32, std16[:, 0], u_bound)
    assert ok.tolist() == np.asarray(jok).tolist()
    assert gval.tolist() == np.asarray(jval).astype(np.int64).tolist()
    want = convert.point_from_limbs16(jsum, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(gsum, want))
    assert C.points_to_ints(C.to_affine(gsum)) == \
        C.points_to_ints(C.to_affine(want))


@pytest.mark.parametrize("u_bound", [5, 8, 16])
def test_by_value_point_matches_reference(pool, u_bound):
    """The by-value window sums, combined by the host Horner pass, give
    sum_i s_i e_i * G; with u_bound equal to the number of distinct values
    every slot is used."""
    pts, exps = pool
    vals = _counter_values(84, 64)
    std, _ = _std(vals)
    assert M.small_value_stats(std) == (True, 5)
    sums, c = M._by_value_sums(pts, std[:, 0], u_bound)
    got = M.horner_affine_ints(C.points_to_ints(C.to_affine(sums)), c)
    want = bn.g1_coords(bn.scalar_mul(
        bn.G1_GEN, sum(e * v for e, v in zip(exps, vals)) % bn.R_ORDER))
    assert got == want


def _jax_takes_by_value(monkeypatch, n, vals):
    """The reference's own decision: its ``_plan_msm`` sees a TPU (its
    gate opens only there) and ``_plan_sort`` then decides; everything
    else, the field arithmetic included, still sees the CPU."""
    real = jax.default_backend

    def backend():
        return "tpu" if sys._getframe(1).f_code.co_name == "_plan_msm" \
            else real()

    monkeypatch.setattr(jax, "default_backend", backend)
    zeros = jnp.zeros((n, 16), jnp.uint32)
    scalars = jnp.asarray(convert.fe_to_limbs16(
        F.from_int(F.FR, vals, device="cpu")))
    plan = JM._plan_msm(JC.APoint(zeros, zeros), scalars, None)
    JM._plan_sort(plan, jax.device_get(plan["fetch"]))
    monkeypatch.setattr(jax, "default_backend", real)
    return plan["path"] == "byvalue"


@pytest.mark.parametrize("case", [
    "n_below", "n_at", "value_at_max", "value_above",
    "distinct_at_n_bound", "distinct_above_n_bound",
    "distinct_at_cap", "distinct_above_cap"])
def test_by_value_gate_decides_as_reference(monkeypatch, case):
    """Both sides of every threshold: n >= 2^13, every scalar < 2^16, at
    most min(n // 8, 4096) distinct values (1,024 at n = 2^13; the cap
    4,096 at n = 2^16)."""
    n = (1 << 13) - 1 if case == "n_below" else (
        1 << 16 if "cap" in case else 1 << 13)
    vals = [i % 7 for i in range(n)]
    if case == "value_at_max":
        vals[3] = (1 << 16) - 1
    elif case == "value_above":
        vals[3] = 1 << 16
    elif case.startswith("distinct"):
        bound = 4096 if "cap" in case else n // 8
        count = bound + (1 if "above" in case else 0)
        vals = [i % count for i in range(n)]
    std, _ = _std(vals)
    stats = M._stats_if_gated(std)
    assert (stats is None) == (n < M.BY_VALUE_MIN_N)
    small, distinct = M.small_value_stats(std)
    port = M.by_value_gate(n, small, distinct)
    assert port == _jax_takes_by_value(monkeypatch, n, vals)
    assert port == (case in ("n_at", "value_at_max", "distinct_at_n_bound",
                             "distinct_at_cap"))


def test_msm_and_commits_take_the_path(pool, monkeypatch):
    """``msm`` and ``msm_batch_ints`` go through the gate and count each
    use; with the gate's size lowered to 64 points, counter scalars take
    the by-value path and random ones do not, and every point equals
    ref_bn254."""
    pts, exps = pool
    monkeypatch.setattr(M, "BY_VALUE_MIN_N", 64)
    rng = np.random.default_rng(85)
    counter = _counter_values(86, 64)
    rand = [int.from_bytes(rng.bytes(32), "little") % bn.R_ORDER
            for _ in range(64)]

    def ref(vals):
        return bn.g1_coords(bn.scalar_mul(
            bn.G1_GEN, sum(e * v for e, v in zip(exps, vals)) % bn.R_ORDER))

    before = M.by_value_uses
    got = C.points_to_ints(C.to_affine(M.msm(pts, F.from_int(
        F.FR, counter, device="cpu"))))[0]
    assert got == ref(counter) and M.by_value_uses == before + 1
    jobs = [(pts, F.from_int(F.FR, v, device="cpu"))
            for v in (counter, rand, counter[::-1])]
    assert M.msm_batch_ints(jobs) == [ref(counter), ref(rand),
                                      ref(counter[::-1])]
    assert M.by_value_uses == before + 3
