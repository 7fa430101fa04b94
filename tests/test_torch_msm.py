"""Port MSM (co_zkvms_tpu_torch.ops.msm) against ref_bn254 sums.

Scalars and points come from a numpy seed; every result is an affine point
compared as exact ints. Includes the port of two JAX-package regressions:
msm_batch_ints against per-call msm over heterogeneous jobs, and the
weighted bucket sum over runs of empty buckets (the suffix scan's second
fold adds equal points there and needs the complete add).
"""

import numpy as np
import pytest

from co_zkvms_tpu.ops import ref_bn254 as bn


torch = C = F = M = None  # bound by _port()


def _port():
    """Import torch and the port when the first test of this module runs,
    not at collection: an xdist worker that runs none of these tests
    never loads them."""
    global torch, C, F, M
    import torch
    from co_zkvms_tpu_torch.ops import curve as C
    from co_zkvms_tpu_torch.ops import field as F
    from co_zkvms_tpu_torch.ops import msm as M


def _scalars(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % bn.R_ORDER
            for _ in range(n)]


def _base():
    g = C.points_from_ints([bn.g1_coords(bn.G1_GEN)], device="cpu")
    return C.APoint(g.x[0], g.y[0])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    _port()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool():
    """512 points e_i * G through the port's fixed-base MSM, with their
    exponents (a reference MSM is then one scalar multiple of G)."""
    rng = np.random.default_rng(30)
    exps = _scalars(rng, 512)
    pts = C.to_affine(M.fixed_base_msm(_base(), F.from_int(F.FR, exps,
                                                           device="cpu")))
    return pts, exps


def _take(pool, start, n):
    pts, exps = pool
    return C.index(pts, slice(start, start + n)), exps[start:start + n]


def _ref_msm(exps, scalars):
    return bn.g1_coords(bn.scalar_mul(
        bn.G1_GEN, sum(e * s for e, s in zip(exps, scalars)) % bn.R_ORDER))


def test_fixed_base_msm_matches_reference(pool):
    pts, exps = _take(pool, 0, 64)
    assert C.points_to_ints(pts) == \
        [bn.g1_coords(bn.scalar_mul(bn.G1_GEN, e)) for e in exps]
    zero = M.fixed_base_msm(_base(), F.zeros((2,), "cpu"))
    assert C.points_to_ints(C.to_affine(zero)) == [(0, 0), (0, 0)]


@pytest.mark.parametrize("log_n", [6, 8])
def test_msm_matches_reference(pool, log_n):
    rng = np.random.default_rng(32 + log_n)
    n = 1 << log_n
    pts, exps = _take(pool, 0, n)
    sc = _scalars(rng, n)
    sc[0] = 0
    sc[1] = sc[2]
    got = C.points_to_ints(C.to_affine(M.msm(pts, F.from_int(
        F.FR, sc, device="cpu"))))[0]
    assert got == _ref_msm(exps, sc)


def test_msm_window_bits_do_not_change_the_point(pool):
    rng = np.random.default_rng(34)
    pts, _ = _take(pool, 100, 40)
    sc = F.from_int(F.FR, _scalars(rng, 40), device="cpu")
    got = {c: C.points_to_ints(C.to_affine(M.msm(pts, sc, c)))[0]
           for c in (3, 5, 7)}
    assert len(set(got.values())) == 1


@pytest.mark.parametrize("c", [4, 6])
def test_regrouped_top_window_with_repeated_points(c):
    """All points equal and all scalars equal: every group of the
    regrouped top window holds the same sum, so the group fold must
    double (complete add); within a bucket the mixed add doubles too."""
    n = 64
    g = C.points_from_ints([bn.g1_coords(bn.G1_GEN)] * n, device="cpu")
    s = 0x2FFF_1234_5678_9ABC_DEF0 << 180
    digits, k, nb_top = M._top_regroup(
        M.window_digits(F.from_int(F.FR, [s] * n, device="cpu"), c), c)
    assert k > 1 and int(digits[-1].max()) >= nb_top
    got = C.points_to_ints(C.to_affine(M.msm(g, F.from_int(
        F.FR, [s] * n, device="cpu"), c)))[0]
    assert got == bn.g1_coords(bn.scalar_mul(bn.G1_GEN, n * s % bn.R_ORDER))


def test_window_digits_straddle_limbs():
    rng = np.random.default_rng(35)
    sc = _scalars(rng, 5)
    t = F.from_int(F.FR, sc, device="cpu")
    for c in (7, 10, 12, 16):
        d = M.window_digits(t, c)
        for i, s in enumerate(sc):
            for w in range(d.shape[0]):
                assert int(d[w, i]) == (s >> (w * c)) & ((1 << c) - 1)


def test_bucket_accumulate_plain_matches_per_bucket_sums(pool):
    rng = np.random.default_rng(36)
    n, c = 48, 3
    pts, exps = _take(pool, 200, n)
    sc = _scalars(rng, n)
    sc[:4] = [5, 5, 0, 7]
    sc_t = F.from_int(F.FR, sc, device="cpu")
    order, starts = M.sort_windows(M.window_digits(sc_t, c), c)
    buckets = M.bucket_accumulate(pts, order, starts)
    nw, nb = starts.shape[0], (1 << c)
    assert buckets.x.shape == (nw, nb, 8)
    got = C.points_to_ints(C.to_affine(C.JPoint(
        *(v.reshape(-1, 8) for v in buckets))))
    for w in list(range(6)) + [nw - 1]:
        for b in range(nb):
            e = sum(exps[i] for i in range(n)
                    if b and (sc[i] >> (w * c)) & (nb - 1) == b)
            want = bn.g1_coords(bn.scalar_mul(bn.G1_GEN, e % bn.R_ORDER))
            assert got[w * nb + b] == want, (w, b)


def test_msm_batch_ints_matches_per_call(pool):
    """Heterogeneous jobs: mixed sizes, counter-valued scalars, all-zero
    scalars (infinity results) and chunk boundaries (chunk=3 over 8 jobs)."""
    rng = np.random.default_rng(37)
    offsets = iter(range(0, 512, 32))

    def mk_job(n, kind):
        pts, exps = _take(pool, next(offsets), n)
        if kind == "zero":
            sc = [0] * n
        elif kind == "counter":
            sc = [int(v) for v in rng.choice([0, 1, 1, 2, 5], size=n)]
        else:
            sc = _scalars(rng, n)
        return (pts, F.from_int(F.FR, sc, device="cpu")), _ref_msm(exps, sc)

    made = [mk_job(16, "rand"), mk_job(64, "counter"), mk_job(24, "zero"),
            mk_job(160, "rand"), mk_job(16, "rand"), mk_job(96, "counter"),
            mk_job(32, "rand"), mk_job(48, "zero")]
    jobs = [j for j, _ in made]
    got = M.msm_batch_ints(jobs, chunk=3)
    per_call = [C.points_to_ints(C.to_affine(M.msm(p, s)))[0] for p, s in jobs]
    assert got == per_call
    assert got == [want for _, want in made]


def test_weighted_sum_empty_bucket_runs():
    """Runs of EMPTY buckets make the suffix-cumulative values constant, so
    the second fold adds equal points: a regression guard for the complete
    add there. Both the plain suffix scan (nb <= 16) and the digit-split
    path (nb > 16) against a host reference."""
    rng = np.random.default_rng(38)
    pts = [bn.scalar_mul(bn.G1_GEN, s) for s in _scalars(rng, 4)]
    for c, occupied in (
            (3, {(0, 2): pts[0], (0, 5): pts[1], (1, 6): pts[2]}),
            (6, {(0, 3): pts[0], (0, 40): pts[1], (1, 63): pts[2],
                 (1, 17): pts[3]})):
        nw, nb = 2, 1 << c
        inf = C.infinity((nw, nb), "cpu")
        buckets = C.JPoint(*(v.clone() for v in inf))
        for (w, b), pt in occupied.items():
            jp = C.from_affine(C.points_from_ints([bn.g1_coords(pt)],
                                                  device="cpu"))
            for dst, src in zip(buckets, jp):
                dst[w, b] = src[0]
        got = C.points_to_ints(C.to_affine(M.weighted_bucket_sum(buckets, c)))
        want = []
        for w in range(nw):
            acc = None
            for b in range(nb):
                if (w, b) in occupied:
                    acc = bn.add(acc, bn.scalar_mul(occupied[(w, b)], b))
            want.append(bn.g1_coords(acc))
        assert got == want, c


def test_kernel_counters_do_not_move_on_cpu(pool):
    from co_zkvms_tpu_torch.utils import build

    rng = np.random.default_rng(39)
    pts, _ = _take(pool, 300, 8)
    before = {k: v.launches for k, v in build.KERNELS.items()}
    M.msm(pts, F.from_int(F.FR, _scalars(rng, 8), device="cpu"))
    assert {k: v.launches for k, v in build.KERNELS.items()} == before
