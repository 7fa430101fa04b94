"""B8's schedule (co_zkvms_tpu_torch.ops.msm bucket_accumulate_plain): fixed
runs of T sorted points a thread, carries and merge passes, against
per-bucket sums from ref_bn254, and the MSM on row-like scalars (values
below 2^k, so that one middle window has few, full buckets) against
ref_bn254 (one JAX msm call on these 64 points takes minutes on a CPU).

T = 4 and 5 force several merge passes on 64 points (T must be at least 4:
two carries a chunk of T entries shrink the list only then). Inputs come
from numpy seeds; every comparison is exact.
"""

import numpy as np
import pytest

from co_zkvms_tpu.ops import ref_bn254 as bn


torch = C = F = M = None  # bound by _port()

N_CASE = 64
C_CASE = 3


def _port():
    """Import torch and the port when the first test of this module runs,
    not at collection: an xdist worker that runs none of these tests
    never loads them."""
    global torch, C, F, M
    import torch
    from co_zkvms_tpu_torch.ops import curve as C
    from co_zkvms_tpu_torch.ops import field as F
    from co_zkvms_tpu_torch.ops import msm as M


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    _port()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bucket_cases(seed: int = 60) -> np.ndarray:
    """Digit tables [6, 64] at c = 3 (buckets 0..7), one edge case a
    window, each row in a shuffled point order:
      0 one bucket holds every point (16 chunks at T = 4: four merges);
      1 runs of 8 zeros, then 4, 8, 12 and 32 points of buckets 1, 2, 4
        and 7: at T = 4 every run begins and ends on a chunk edge;
      2 every digit 0;
      3 digits from {0, 1, 5, 7}: empty buckets inside chunks;
      4 uniform digits;
      5 six zeros, then digits 1..7 (digit 0 ends inside a chunk)."""
    rng = np.random.default_rng(seed)
    n = N_CASE
    rows = [np.full(n, 3),
            np.repeat([0, 1, 2, 4, 7], [8, 4, 8, 12, 32]),
            np.zeros(n, dtype=np.int64),
            rng.choice([0, 1, 5, 7], size=n),
            rng.integers(0, 8, size=n),
            np.concatenate([np.zeros(6, dtype=np.int64),
                            rng.integers(1, 8, size=n - 6)])]
    return np.stack([rng.permutation(r) for r in rows]).astype(np.int64)


def case_points(kind: str, seed: int = 61):
    """64 affine points (port tensors on the CPU) and their exponents:
    "distinct": e_i * G, the last one affine infinity (0, 0), exponent 0;
    "repeated": one point for all 64, so that the complete adds double
    (the second point of a bucket, and equal carries in the merges)."""
    rng = np.random.default_rng(seed)
    if kind == "distinct":
        exps = [int.from_bytes(rng.bytes(32), "little") % bn.R_ORDER
                for _ in range(N_CASE)]
    else:
        exps = [int.from_bytes(rng.bytes(32), "little") % bn.R_ORDER] * N_CASE
    g = C.points_from_ints([bn.g1_coords(bn.G1_GEN)], device="cpu")
    pts = C.to_affine(M.fixed_base_msm(C.APoint(g.x[0], g.y[0]),
                                       F.from_int(F.FR, exps, device="cpu")))
    pts = C.APoint(pts.x.contiguous().clone(), pts.y.contiguous().clone())
    if kind == "distinct":
        pts.x[-1] = 0
        pts.y[-1] = 0
        exps[-1] = 0
    return pts, exps


@pytest.fixture(scope="module")
def points():
    return {kind: case_points(kind) for kind in ("distinct", "repeated")}


def _sorted_cases():
    digits = torch.from_numpy(bucket_cases())
    return digits, *M.sort_windows(digits, C_CASE)


def test_bucket_passes_follow_n_and_run():
    assert M.bucket_passes(1 << 20, 32) == [1 << 20, 1 << 16, 1 << 12,
                                            1 << 8, 1 << 4]
    assert M.bucket_passes(64, 4) == [64, 32, 16, 8, 4]
    assert M.bucket_passes(64, 5) == [64, 26, 12, 6, 4]
    assert M.bucket_passes(32, 32) == [32]
    assert M.bucket_passes(0, 16) == [0]
    assert M.BUCKET_RUN in M.BUCKET_RUNS
    with pytest.raises(ValueError):
        M.bucket_passes(64, 3)


@pytest.mark.parametrize("kind", ["distinct", "repeated"])
@pytest.mark.parametrize("run", [4, 5])
def test_plain_schedule_matches_per_bucket_sums(points, run, kind):
    pts, exps = points[kind]
    digits, order, starts = _sorted_cases()
    got = M.bucket_accumulate_plain(pts, order, starts, run)
    nw, nb = digits.shape[0], 1 << C_CASE
    assert got.x.shape == (nw, nb, 8)
    aff = C.points_to_ints(C.to_affine(C.JPoint(
        *(v.reshape(-1, 8) for v in got))))
    for w in range(nw):
        for b in range(nb):
            e = sum(x for x, d in zip(exps, digits[w].tolist())
                    if b and d == b)
            want = bn.g1_coords(bn.scalar_mul(bn.G1_GEN, e % bn.R_ORDER))
            assert aff[w * nb + b] == want, (w, b)


def test_plain_schedule_of_a_window_depends_on_it_alone(points):
    """A subset of windows gives the same Jacobian coordinates as the whole
    table on those windows (chip_smoke.py checks subsets of the kernel's
    windows against the plain version)."""
    pts, _ = points["distinct"]
    _, order, starts = _sorted_cases()
    whole = M.bucket_accumulate_plain(pts, order, starts, 4)
    ws = [0, 3, 5]
    part = M.bucket_accumulate_plain(pts, order[ws].contiguous(),
                                     starts[ws].contiguous(), 4)
    assert all(torch.equal(a[ws], b) for a, b in zip(whole, part))


def _row_like(seed: int, n: int, bits: int):
    """n scalars below 2^bits: at c = 4, window 1 of 6-bit values has 4
    digits, so each of its buckets holds about n / 4 points."""
    rng = np.random.default_rng(seed)
    return [int(v) for v in rng.integers(0, 1 << bits, size=n)]


@pytest.mark.parametrize("run", [4, 16])
def test_msm_on_row_like_scalars(points, monkeypatch, run):
    monkeypatch.setattr(M, "BUCKET_RUN", run)
    pts, exps = points["distinct"]
    vals = _row_like(62, N_CASE, 6)
    vals[:3] = [0, 63, 63]
    got = C.points_to_ints(C.to_affine(M.msm(pts, F.from_int(
        F.FR, vals, device="cpu"))))[0]
    e = sum(x * v for x, v in zip(exps, vals)) % bn.R_ORDER
    assert got == bn.g1_coords(bn.scalar_mul(bn.G1_GEN, e))
