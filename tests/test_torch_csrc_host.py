"""The CUDA kernels' own arithmetic, compiled as host C++.

ops/csrc/field.cuh, g1.cuh, msm_bucket.cuh, poseidon.cuh and
sumcheck_round.cuh compile with a host compiler too (FDEV -> inline). This
test builds a small harness over them with g++ and holds the kernels'
Montgomery products (the C CIOS form, and the carry-chain form of B5, B7
and B8 with each PTX step emulated on C integers), modular add/sub, G1
formulas and B8's chunk walks under both arithmetic policies to the port's
plain PyTorch versions bit for bit, edge rows included, B6's loop of
doublings to repeated plain doublings, B12's t = 3 Poseidon permutation in
its sparse schedule, with its constants as the card's constant bank holds
them, to the host mirror ``host_permute`` and to ``permute_plain``, and
B9's per-pair points and per-block partials (t = 3 of the outer comb by
finite differences) to the plain comb and ``eval_partials_plain``. No nvcc
is needed; without g++ the test skips.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

from co_zkvms_tpu.ops import ref_bn254 as bn


torch = C = F = P = SC = build = None  # bound by _port()


def _port():
    """Import torch and the port when the first test of this module runs,
    not at collection: an xdist worker that runs none of these tests
    never loads them."""
    global torch, C, F, P, SC, build
    import torch
    from co_zkvms_tpu_torch.ops import curve as C
    from co_zkvms_tpu_torch.ops import field as F
    from co_zkvms_tpu_torch.ops import poseidon as P
    from co_zkvms_tpu_torch.ops import sumcheck as SC
    from co_zkvms_tpu_torch.utils import build


@pytest.fixture(autouse=True, scope="module")
def _port_loaded():
    _port()


HARNESS = r"""
#include <algorithm>
#include <cstring>
#include "g1.cuh"
#include "msm_bucket.cuh"
#include "poseidon.cuh"
#include "sumcheck_round.cuh"
using namespace bn254;
typedef uint32_t u32;
extern "C" {
void h_mul(int f, const u32* a, const u32* b, u32* r, int n) {
  for (int i = 0; i < n; i++) {
    if (f == 0) mont_mul<0>(r + 8 * i, a + 8 * i, b + 8 * i);
    else mont_mul<1>(r + 8 * i, a + 8 * i, b + 8 * i);
  }
}
void h_sqr(int f, const u32* a, u32* r, int n) {
  for (int i = 0; i < n; i++) {
    if (f == 0) mont_sqr<0>(r + 8 * i, a + 8 * i);
    else mont_sqr<1>(r + 8 * i, a + 8 * i);
  }
}
void h_add(int f, const u32* a, const u32* b, u32* r, int n) {
  for (int i = 0; i < n; i++) {
    if (f == 0) mod_add<0>(r + 8 * i, a + 8 * i, b + 8 * i);
    else mod_add<1>(r + 8 * i, a + 8 * i, b + 8 * i);
  }
}
// the carry-chain product and square of B5 and B7 (emulated on the host)
void h_mul_cc(int f, const u32* a, const u32* b, u32* r, int n) {
  for (int i = 0; i < n; i++) {
    if (f == 0) mul_cc<0>(r + 8 * i, a + 8 * i, b + 8 * i);
    else mul_cc<1>(r + 8 * i, a + 8 * i, b + 8 * i);
  }
}
void h_sqr_cc(int f, const u32* a, u32* r, int n) {
  for (int i = 0; i < n; i++) {
    if (f == 0) sqr_cc<0>(r + 8 * i, a + 8 * i);
    else sqr_cc<1>(r + 8 * i, a + 8 * i);
  }
}
void h_sub(int f, const u32* a, const u32* b, u32* r, int n) {
  for (int i = 0; i < n; i++) {
    if (f == 0) mod_sub<0>(r + 8 * i, a + 8 * i, b + 8 * i);
    else mod_sub<1>(r + 8 * i, a + 8 * i, b + 8 * i);
  }
}
static void ld(Jac& p, const u32* const* c, int i) {
  fe_copy(p.x, c[0] + 8 * i); fe_copy(p.y, c[1] + 8 * i);
  fe_copy(p.z, c[2] + 8 * i);
}
static void st(u32* const* c, int i, const Jac& p) {
  fe_copy(c[0] + 8 * i, p.x); fe_copy(c[1] + 8 * i, p.y);
  fe_copy(c[2] + 8 * i, p.z);
}
}  // extern "C"
// op: 0 mixed add (q = x, y), 1 add, 2 incomplete add, 3 double
template <class Ar>
static void g1_rows(int op, const u32* const* p, const u32* const* q,
                    u32* const* o, int n) {
  for (int i = 0; i < n; i++) {
    Jac a, b, r;
    ld(a, p, i);
    if (op == 0) { jac_add_mixed_t<Ar>(r, a, q[0] + 8 * i, q[1] + 8 * i); }
    else if (op == 3) { jac_double_t<Ar>(r, a); }
    else if (op == 1) {
      ld(b, q, i);
      if (!jac_add_unless_equal<Ar>(r, a, b)) jac_double_t<Ar>(r, a);
    } else { ld(b, q, i); jac_add_incomplete_t<Ar>(r, a, b); }
    st(o, i, r);
  }
}
extern "C" {
// arith: 0 CiosArith (mont_mul / mont_sqr), 1 ChainArith (carry chains)
void h_g1(int arith, int op, const u32* const* p, const u32* const* q,
          u32* const* o, int n) {
  if (arith == 0) g1_rows<CiosArith>(op, p, q, o, n);
  else g1_rows<ChainArith>(op, p, q, o, n);
}
}  // extern "C"
// B8's chunk walks on the host read each point straight from memory and
// double inline where the merge add meets p == q (the kernel stages points
// through shared memory and doubles out of line).
struct DirectPoints {
  const u32* px;
  const u32* py;
  const int32_t* order_w;
  void start(int, int) {}
  void get(int p, u32 qx[8], u32 qy[8]) const {
    const long long i = order_w[p];
    fe_copy(qx, px + 8 * i);
    fe_copy(qy, py + 8 * i);
  }
};
struct InlineDouble {
  template <class Ar>
  static void apply(Jac& acc, u32* e) {
    jac_double_t<Ar>(acc, *reinterpret_cast<const Jac*>(e));
  }
};
// B8's schedule on the host: the infinity of bucket 0 and of the empty
// buckets, then pass 1 and the merge passes (input lengths `lens`, as
// ops/msm.py bucket_passes), every chunk in turn through msm_bucket.cuh's
// chunk walks; the carries of pass k go to buffer k % 2.
template <class Ar>
static void bucket_rows(const u32* px, const u32* py, const int32_t* order,
                        const int32_t* starts, int nw, int nb, int run,
                        const int* lens, int passes, u32* const* out,
                        int32_t* const* keys, u32* const* pts) {
  Jac inf;
  jac_infinity(inf);
  for (long long i = 0; i < (long long)nw * nb; i++) {
    const int b = (int)(i % nb);
    const long long s = (i / nb) * (nb + 1) + b;
    if (b == 0 || starts[s] == starts[s + 1]) {
      fe_copy(out[0] + 8 * i, inf.x); fe_copy(out[1] + 8 * i, inf.y);
      fe_copy(out[2] + 8 * i, inf.z);
    }
  }
  for (int k = 0; k < passes; k++) {
    const int len = lens[k];
    const bool final = k == passes - 1;
    const int chunks = (len + run - 1) / run;
    for (int w = 0; w < nw; w++) {
      for (int j = 0; j < chunks; j++) {
        SegmentSink sink{out[0], out[1], out[2], keys[k % 2], pts[k % 2],
                         2 * ((long long)w * chunks + j), final, 0};
        const int hi = std::min(j * run + run, len);
        if (k == 0) {
          const int32_t* sw = starts + (long long)w * (nb + 1);
          DirectPoints src{px, py, order + (long long)w * len};
          walk_points<Ar>(src, sw, nb, w * nb, std::max(j * run, sw[1]), hi,
                          sink);
        } else {
          const long long row = (long long)w * len;
          walk_carries<Ar, InlineDouble>(keys[(k - 1) % 2] + row,
                                         pts[(k - 1) % 2] + 24 * row, j * run,
                                         hi, sink);
        }
      }
    }
  }
}
extern "C" void h_bucket(int arith, const u32* px, const u32* py,
                         const int32_t* order, const int32_t* starts, int nw,
                         int nb, int run, const int* lens, int passes,
                         u32* const* out, int32_t* const* keys,
                         u32* const* pts) {
  if (arith == 0) {
    bucket_rows<CiosArith>(px, py, order, starts, nw, nb, run, lens, passes,
                           out, keys, pts);
  } else {
    bucket_rows<ChainArith>(px, py, order, starts, nw, nb, run, lens, passes,
                            out, keys, pts);
  }
}
extern "C" {
// B12's constants into the host's PoseidonT3Consts, as the card's upload
// fills the constant bank: -1 unless nbytes is the struct's size
int h_poseidon_constants(const u32* words, size_t nbytes) {
  if (nbytes != sizeof(PoseidonT3Consts)) return -1;
  memcpy(&POSEIDON_T3_K, words, nbytes);
  return 0;
}
// B12's permutation on n states [n][3][8] in place
void h_poseidon(u32* s, int n) {
  for (int i = 0; i < n; i++) {
    u32 st[3][8];
    for (int k = 0; k < 3; k++) fe_copy(st[k], s + 24 * i + 8 * k);
    poseidon_t3_permute(st);
    for (int k = 0; k < 3; k++) fe_copy(s + 24 * i + 8 * k, st[k]);
  }
}
// B6: `times` doublings of each point in place, on carry chains
void h_double_times(int times, u32* const* p, int n) {
  for (int i = 0; i < n; i++) {
    Jac a;
    ld(a, p, i);
    jac_double_times<ChainArith>(a, times);
    st(p, i, a);
  }
}
}
// B9's schedule (sumcheck_round.cuh). what 0: each pair's points
// [h][kPoints][8] from Comb::pair alone; what 1: the partials [blocks][D1][8]
// of a grid of blocks x threads, each thread's sc_thread_pairs summed over
// its block (as block_sum does), then the block's finishing step
template <int F, class Comb>
static void sc_rows(int what, const u32* tabs, long long tstride,
                    const u32* suffix, long long h, int blocks, int threads,
                    u32* out) {
  constexpr int K = Comb::kPoints;
  constexpr int D1 = Comb::kDegree + 1;
  if (what == 0) {
    for (long long p = 0; p < h; p++) {
      u32 acc[K][8];
      for (int t = 0; t < K; t++) fe_zero(acc[t]);
      Comb::template pair<F>(acc, tabs, tstride, suffix, p);
      for (int t = 0; t < K; t++) fe_copy(out + 8 * (p * K + t), acc[t]);
    }
    return;
  }
  for (int b = 0; b < blocks; b++) {
    u32 sum[D1][8];
    for (int t = 0; t < D1; t++) fe_zero(sum[t]);
    for (int i = 0; i < threads; i++) {
      u32 acc[D1][8];
      sc_thread_pairs<F, Comb>(acc, tabs, tstride, suffix, h,
                               (long long)b * threads + i,
                               (long long)blocks * threads);
      for (int t = 0; t < K; t++) mod_add<F>(sum[t], sum[t], acc[t]);
    }
    Comb::template finish<F>(sum);
    for (int t = 0; t < D1; t++)
      fe_copy(out + 8 * ((long long)b * D1 + t), sum[t]);
  }
}
extern "C" void h_sc_eval(int comb, int f, int what, const u32* tabs,
                          long long tstride, const u32* suffix, long long h,
                          int blocks, int threads, u32* out) {
  if (comb == kOuterComb) {
    if (f == 0) sc_rows<0, OuterComb>(what, tabs, tstride, suffix, h, blocks,
                                      threads, out);
    else sc_rows<1, OuterComb>(what, tabs, tstride, suffix, h, blocks,
                               threads, out);
  } else {
    if (f == 0) sc_rows<0, InnerComb>(what, tabs, tstride, suffix, h, blocks,
                                      threads, out);
    else sc_rows<1, InnerComb>(what, tabs, tstride, suffix, h, blocks,
                               threads, out);
  }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA headers as host C++")
    d = tmp_path_factory.mktemp("csrc_host")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    so = d / "libharness.so"
    subprocess.run([gxx, "-O1", "-shared", "-fPIC", "-Wno-unknown-pragmas",
                    "-I", build.CSRC, "-o", str(so), str(src)], check=True,
                   capture_output=True, timeout=300)
    return ctypes.CDLL(str(so))


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _ptrs(coords):
    arr = (ctypes.c_void_p * 3)(*(c.data_ptr() for c in coords))
    return arr


def _fe(rng, spec, n):
    vals = [int.from_bytes(rng.bytes(32), "little") % spec.modulus
            for _ in range(n)]
    vals[:3] = [0, 1, spec.modulus - 1]
    return F.from_int(spec, vals, device="cpu").contiguous()


@pytest.mark.parametrize("spec", ["FR", "FQ"], ids=["fr", "fq"])
def test_field_arithmetic_matches_plain(lib, spec):
    spec = getattr(F, spec)
    rng = np.random.default_rng(51)
    n = 256
    a, b = _fe(rng, spec, n), _fe(rng, spec, n).flip(0).contiguous()
    # mul also takes any a < 2^256 (lazy_reduce relies on it)
    wide = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(n, 8),
                                         dtype=np.int64).astype(np.int32))
    for fn, args, want in (
            (lib.h_mul, (a, b), F.mul_plain(spec, a, b)),
            (lib.h_mul, (wide, b), F.mul_plain(spec, wide, b)),
            (lib.h_sqr, (a,), F.square_plain(spec, a)),
            (lib.h_mul_cc, (a, b), F.mul_plain(spec, a, b)),
            (lib.h_sqr_cc, (a,), F.square_plain(spec, a)),
            (lib.h_add, (a, b), F.add_plain(spec, a, b)),
            (lib.h_sub, (a, b), F.sub_plain(spec, a, b))):
        out = torch.empty_like(a)
        fn(spec.fid, *(_ptr(t) for t in args), _ptr(out), n)
        assert torch.equal(out, want), fn.__name__


def _jacobian(points):
    """Jacobian points with z != 1: double(p / 2), p / 2 = p (r + 1) / 2."""
    half = [None if p is None else bn.scalar_mul(p, (bn.R_ORDER + 1) // 2)
            for p in points]
    return C.double(C.from_affine(C.points_from_ints(
        [bn.g1_coords(p) for p in half], device="cpu")))


@pytest.mark.parametrize("arith", [0, 1], ids=["cios", "carry_chain"])
def test_g1_formulas_match_plain(lib, arith):
    """Both arithmetic policies of g1.cuh's formulas (the C CIOS product of
    B4, B6 and B8; the carry-chain product of B5 and B7, emulated on the
    host). Rows: 0 p == q, 1 p == -q, 2 p = inf, 3 q = inf, 4 both inf."""
    rng = np.random.default_rng(52)
    ps = [bn.scalar_mul(bn.G1_GEN, int(rng.integers(1, 1 << 62)))
          for _ in range(12)]
    qs = [bn.scalar_mul(bn.G1_GEN, int(rng.integers(1, 1 << 62)))
          for _ in range(12)]
    qs[0], qs[1] = ps[0], bn.neg_pt(ps[1])
    ps[2] = qs[3] = ps[4] = qs[4] = None
    qa = C.points_from_ints([bn.g1_coords(q) for q in qs], device="cpu")
    pj, qj = _jacobian(ps), _jacobian(qs)
    cases = ((0, qa, C.add_mixed_plain(pj, qa)),
             (1, qj, C.add_plain(pj, qj)),
             (2, qj, C.add_incomplete_plain(pj, qj)),
             (3, qj, C.double_plain(pj)))
    for op, q, want in cases:
        out = [torch.empty_like(pj.x) for _ in range(3)]
        qc = [c.contiguous() for c in q]
        lib.h_g1(arith, op, _ptrs(pj), _ptrs(qc + qc[:3 - len(qc)]),
                 _ptrs(out), len(ps))
        assert all(torch.equal(o, w) for o, w in zip(out, want)), op


def test_poseidon_permutation_matches_host_mirror(lib):
    """B12's sparse schedule (poseidon.cuh, carry-chain products emulated)
    with its constants loaded from t3_constant_words
    as the card's upload loads them, on t = 3 states with edge values,
    against the host mirror on Python ints and the plain version
    permute_plain, exactly."""
    rng = np.random.default_rng(53)
    r = F.FR.modulus
    states = [[0, 0, 0], [1, 2, 3], [r - 1, r - 1, r - 1], [0, 1, r - 1]] + [
        [int.from_bytes(rng.bytes(32), "little") % r for _ in range(3)]
        for _ in range(4)]
    words = P.t3_constant_words()
    assert lib.h_poseidon_constants(
        ctypes.c_void_p(words.ctypes.data), ctypes.c_size_t(words.nbytes)) == 0
    assert lib.h_poseidon_constants(
        ctypes.c_void_p(words.ctypes.data),
        ctypes.c_size_t(words.nbytes - 32)) == -1
    start = F.from_int(F.FR, states, device="cpu").contiguous()
    plain = P.permute_plain(start)
    assert F.to_int(F.FR, plain).tolist() == [P.host_permute(st)
                                              for st in states]
    s = start.clone()
    lib.h_poseidon(_ptr(s), len(states))
    assert torch.equal(s, plain)


def test_double_times_matches_repeated_plain_doublings(lib):
    """B6's loop (g1.cuh jac_double_times on carry chains, emulated) with
    times = 1, 3 and 8 against that many applications of double_plain,
    Jacobian coordinates exactly; an infinity row included."""
    rng = np.random.default_rng(54)
    ps = [bn.scalar_mul(bn.G1_GEN, int(rng.integers(1, 1 << 62)))
          for _ in range(6)]
    ps[2] = None
    pj = _jacobian(ps)
    for times in (1, 3, 8):
        want = pj
        for _ in range(times):
            want = C.double_plain(want)
        got = [c.clone().contiguous() for c in pj]
        lib.h_double_times(times, _ptrs(got), len(ps))
        assert all(torch.equal(g, w) for g, w in zip(got, want)), times


@pytest.fixture(scope="module")
def bucket_inputs():
    """The edge-case digit tables of test_torch_msm_bucket.py, sorted, and
    the plain schedule's buckets for distinct and for repeated points at
    T = 4 (four merge passes) and at the kernel's T = 16."""
    import test_torch_msm_bucket as cases
    from co_zkvms_tpu_torch.ops import msm as M

    cases._port()
    order, starts = M.sort_windows(torch.from_numpy(cases.bucket_cases()),
                                   cases.C_CASE)
    runs = []
    for kind in ("distinct", "repeated"):
        pts, _ = cases.case_points(kind)
        for run in (4, 16):
            runs.append((kind, run, pts,
                         M.bucket_accumulate_plain(pts, order, starts, run)))
    return order, starts, runs


@pytest.mark.parametrize("arith", [0, 1], ids=["cios", "carry_chain"])
def test_bucket_schedule_matches_plain(lib, bucket_inputs, arith):
    """B8's chunk walks (msm_bucket.cuh walk_points / walk_carries) on the
    host, chunk after chunk and pass after pass, against the plain
    schedule bit for bit (Jacobian coordinates)."""
    from co_zkvms_tpu_torch.ops import msm as M

    order, starts, runs = bucket_inputs
    nw, nb = starts.shape[0], starts.shape[1] - 1
    for kind, run, pts, want in runs:
        lens = M.bucket_passes(order.shape[1], run)
        out = [torch.empty((nw * nb, 8), dtype=torch.int32) for _ in range(3)]
        keys = [torch.empty(nw * size, dtype=torch.int32)
                for size in (lens[1:3] + [1, 1])[:2]]
        carry = [torch.empty((k.numel(), 24), dtype=torch.int32) for k in keys]
        lib.h_bucket(arith, _ptr(pts.x), _ptr(pts.y), _ptr(order),
                     _ptr(starts), nw, nb, run,
                     (ctypes.c_int * len(lens))(*lens), len(lens),
                     _ptrs(out), _ptrs(keys + keys[:1]),
                     _ptrs(carry + carry[:1]))
        assert all(torch.equal(o.reshape(nw, nb, 8), w)
                   for o, w in zip(out, want)), (kind, run)


def _round_inputs(spec, comb, h):
    """comb's tables [n_tables, 2h, 8] and, for the outer comb, a suffix
    [h, 8], seeded; 0, 1 and m - 1 lead every row (_fe), so pair 0 is
    (0, 1) and pair 1 starts at m - 1 in every table."""
    rng = np.random.default_rng(55 + comb.cid)
    stack = torch.stack([_fe(rng, spec, 2 * h) for _ in range(comb.n_tables)])
    suffix = _fe(rng, spec, h) if comb.split_eq else None
    return stack.contiguous(), suffix


def _sc_eval(lib, spec, comb, stack, suffix, what, blocks, threads, rows):
    h = stack.shape[1] // 2
    out = torch.empty((rows, 8), dtype=torch.int32)
    lib.h_sc_eval(comb.cid, spec.fid, what, _ptr(stack),
                  ctypes.c_longlong(stack.shape[1]),
                  _ptr(stack) if suffix is None else _ptr(suffix),
                  ctypes.c_longlong(h), blocks, threads, _ptr(out))
    return out


@pytest.mark.parametrize("spec", ["FR", "FQ"], ids=["fr", "fq"])
@pytest.mark.parametrize("comb", ["outer", "inner"])
def test_round_pair_points_match_plain_comb(lib, comb, spec):
    """B9's per-pair schedule (sumcheck_round.cuh Comb::pair, carry-chain
    products emulated): the points t = 0, 1, 2 a pair accumulates equal the
    plain comb (_outer_plain / _inner_plain) on the restrictions at t, bit
    for bit; 6 products a pair for the outer comb, 3 for the inner."""
    spec = getattr(F, spec)
    comb = SC.OUTER if comb == "outer" else SC.INNER
    h = 40
    stack, suffix = _round_inputs(spec, comb, h)
    got = _sc_eval(lib, spec, comb, stack, suffix, 0, 0, 0, 3 * h)
    even, odd = stack[:, 0::2], stack[:, 1::2]
    slope = F.sub_plain(spec, odd, even)
    cur, want = even, []
    for t in range(3):
        if t:
            cur = F.add_plain(spec, cur, slope)
        want.append(comb.plain(spec, suffix, list(cur)))
    assert torch.equal(got.reshape(h, 3, 8), torch.stack(want, dim=1))


@pytest.mark.parametrize("spec", ["FR", "FQ"], ids=["fr", "fq"])
@pytest.mark.parametrize("comb", ["outer", "inner"])
def test_round_partials_match_eval_partials_plain(lib, comb, spec):
    """B9's block schedule on the host: each simulated thread's pairs
    (sc_thread_pairs), summed over its block, then the block's finishing
    step (the outer comb's t = 3 = S(0) - 3 S(1) + 3 S(2)), against
    eval_partials_plain, which sums all degree + 1 points pair by pair, bit
    for bit; grids with several pairs a thread, idle threads, one block."""
    spec = getattr(F, spec)
    comb = SC.OUTER if comb == "outer" else SC.INNER
    h = 50
    stack, suffix = _round_inputs(spec, comb, h)
    d1 = comb.degree + 1
    for blocks, threads in ((3, 4), (2, 32), (1, SC.EVAL_THREADS)):
        got = _sc_eval(lib, spec, comb, stack, suffix, 1, blocks, threads,
                       blocks * d1)
        want = SC.eval_partials_plain(spec, comb, stack, suffix,
                                      blocks=blocks, threads=threads)
        assert torch.equal(got.reshape(blocks, d1, 8), want), (blocks,
                                                               threads)
