"""The sumcheck round kernels' plain versions (B9 ``eval_partials``, B11
``reduce_partials``, B10 ``bind_rows``) against a Python-int oracle, every
round of a sumcheck from n = 2^4 to 2^6 entries. The kernels themselves run
only on the card (``chip_smoke.py`` holds them to these plain versions)."""

import numpy as np
import pytest

from co_zkvms_tpu.ops import field as JF

MOD = JF.FR.modulus

torch = F = SC = None  # bound by _port()


def _port():
    """Import torch and the port when the first test of this module runs,
    not at collection: an xdist worker that runs none of these tests
    never loads them."""
    global torch, F, SC
    import torch
    from co_zkvms_tpu_torch.ops import field as F
    from co_zkvms_tpu_torch.ops import sumcheck as SC


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    _port()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ints(rng, k):
    return [int.from_bytes(rng.bytes(32), "little") % MOD for _ in range(k)]


def _fe(ints):
    return F.from_int(F.FR, ints, device="cpu")


def _pair_values(name, tables, suffix, t):
    """comb at x_0 = t over every pair, on standard-form ints."""
    h = len(tables[0]) // 2
    out = []
    for p in range(h):
        v = [(tb[2 * p] + t * (tb[2 * p + 1] - tb[2 * p])) % MOD
             for tb in tables]
        if name == "outer":
            out.append(suffix[p] * (v[0] * v[1] - v[2]) % MOD)
        else:
            out.append(v[0] * v[1] % MOD)
    return out


def _block_sums(vals, threads, blocks):
    """The kernel's partition: block b sums p = b T + i + k G T."""
    out = [0] * blocks
    for p, v in enumerate(vals):
        out[(p // threads) % blocks] = (out[(p // threads) % blocks] + v) % MOD
    return out


GRIDS = [None, (128, 1), (2, 3)]   # the default; one block; grid-stride


@pytest.mark.parametrize("name", ["outer", "inner"])
def test_eval_and_reduce_every_round(name):
    """B9's partials (per block) and B11's message, every round from
    n = 2^4, 2^5 and 2^6 entries, with the tables bound by B10 between
    rounds; a single block and a small grid exercise the grid-stride
    partition of the pairs over blocks."""
    comb = SC.OUTER if name == "outer" else SC.INNER
    for nv in (4, 5, 6):
        for grid in GRIDS:
            _check_every_round(comb, name, nv, grid)


def _check_every_round(comb, name, nv, grid):
    rng = np.random.default_rng(10 * nv + len(name))
    tables = [_ints(rng, 1 << nv) for _ in range(comb.n_tables)]
    stack = torch.stack([_fe(t) for t in tables])
    while len(tables[0]) > 1:
        h = len(tables[0]) // 2
        suffix = _ints(rng, h) if comb.split_eq else None
        suf = _fe(suffix) if suffix else None
        if grid is None:        # the wrapper: one block per 128 pairs here
            threads, blocks = SC.EVAL_THREADS, -(-h // SC.EVAL_THREADS)
            part = SC.eval_partials(F.FR, comb, stack, suf)
        else:
            threads, blocks = grid
            part = SC.eval_partials_plain(F.FR, comb, stack, suf,
                                          blocks=blocks, threads=threads)
        assert part.shape == (blocks, comb.degree + 1, 8)
        want = [_block_sums(_pair_values(name, tables, suffix, t), threads,
                            blocks) for t in range(comb.degree + 1)]
        got = F.to_int(F.FR, part)
        assert [[int(got[b, t]) for b in range(blocks)]
                for t in range(comb.degree + 1)] == want, (nv, h, threads)
        msg = SC.reduce_partials(F.FR, part)
        assert [int(v) for v in F.to_int(F.FR, msg)] == \
            [sum(w) % MOD for w in want]
        assert torch.equal(SC.eval_round(F.FR, comb, stack,
                                         _fe(suffix) if suffix else None),
                           msg)
        r = _ints(rng, 1)[0]
        stack = SC.bind_rows(F.FR, stack, _fe(r))
        tables = [[(tb[2 * p] + r * (tb[2 * p + 1] - tb[2 * p])) % MOD
                   for p in range(h)] for tb in tables]
        assert [[int(v) for v in F.to_int(F.FR, row)] for row in stack] == \
            tables


@pytest.mark.parametrize("grid", GRIDS, ids=["default", "one_block",
                                              "grid_stride"])
def test_outer_partials_are_quadratic_in_t(grid):
    """The premise of the outer comb's schedule on the card: the split-eq
    suffix does not depend on t, so every block's partial is quadratic in t
    and S(3) = S(0) - 3 S(1) + 3 S(2) (mod r). Checked on
    eval_partials_plain, which evaluates all four points, in every block of
    every round from n = 2^4, 2^5 and 2^6 entries (tables bound between
    rounds)."""
    comb = SC.OUTER
    for nv in (4, 5, 6):
        rng = np.random.default_rng(100 + nv)
        stack = torch.stack([_fe(_ints(rng, 1 << nv))
                             for _ in range(comb.n_tables)])
        while stack.shape[1] > 1:
            h = stack.shape[1] // 2
            suf = _fe(_ints(rng, h))
            blocks, threads = grid or (None, SC.EVAL_THREADS)
            part = SC.eval_partials_plain(F.FR, comb, stack, suf,
                                          blocks=blocks, threads=threads)
            s = F.to_int(F.FR, part)
            for row in s:
                s0, s1, s2, s3 = (int(v) for v in row)
                assert s3 == (s0 - 3 * s1 + 3 * s2) % MOD, (nv, h, grid)
            stack = SC.bind_rows(F.FR, stack, _fe(_ints(rng, 1)))


def test_bind_rows_every_round():
    """B10 on three public tables and on a Rep3 stack of three share
    stacks (rows = tables x parties): canonical values, every round, from
    n = 2^4, 2^5 and 2^6 entries."""
    for nv in (4, 5, 6):
        for lead in ((3,), (3, 3)):
            rng = np.random.default_rng(nv + len(lead))
            rows = int(np.prod(lead))
            tables = [_ints(rng, 1 << nv) for _ in range(rows)]
            t = _fe(tables).reshape(lead + (1 << nv, 8))
            stack = t.reshape(rows, 1 << nv, 8)
            while len(tables[0]) > 1:
                r = _ints(rng, 1)[0]
                got = SC.bind_rows(F.FR, stack, _fe(r))
                assert torch.equal(got, SC.bind_rows_plain(F.FR, stack,
                                                           _fe(r)))
                tables = [[(tb[2 * p] + r * (tb[2 * p + 1] - tb[2 * p]))
                           % MOD for p in range(len(tb) // 2)]
                          for tb in tables]
                # canonical limbs: the raw Montgomery words are below m
                raw = F.to_int(F.FR, got, mont=False)
                assert all(int(v) < MOD for v in raw.ravel())
                assert [[int(v) for v in F.to_int(F.FR, row)]
                        for row in got] == tables, (nv, lead)
                stack = got


def test_reduce_partials_of_extreme_values():
    """m - 1 summed many times wraps exactly."""
    part = F.constant(F.FR, MOD - 1, "cpu").expand(300, 4, 8).contiguous()
    got = F.to_int(F.FR, SC.reduce_partials(F.FR, part), mont=False)
    assert [int(v) for v in got] == [300 * (MOD - 1) % MOD] * 4


def test_round_kernels_refuse_what_they_do_not_take():
    rng = np.random.default_rng(3)
    stack = torch.stack([_fe(_ints(rng, 8)) for _ in range(3)])
    with pytest.raises(ValueError):
        SC.eval_partials(F.FR, SC.OUTER, stack)                 # no suffix
    with pytest.raises(ValueError):
        SC.eval_partials(F.FR, SC.INNER, stack)                 # 3 tables
    with pytest.raises(ValueError):
        SC.eval_partials(F.FR, SC.OUTER, stack, _fe(_ints(rng, 3)))
    with pytest.raises(TypeError):
        SC.bind_rows(F.FR, stack[:, ::2], _fe(1))               # strided
    # an lv comb called with options its kernel does not take
    from co_zkvms_tpu_torch.models import spartan as S
    from co_zkvms_tpu_torch.ops import transcript as T
    with pytest.raises(ValueError, match="round kernel"):
        SC.prove(F.FR, T.HostTranscript(b"x"), list(stack), 3, S._comb1)


def test_kernel_counters_do_not_move_on_cpu():
    from co_zkvms_tpu_torch.utils import build

    rng = np.random.default_rng(4)
    before = {k: v.launches for k, v in build.KERNELS.items()}
    stack = torch.stack([_fe(_ints(rng, 16)) for _ in range(2)])
    SC.eval_round(F.FR, SC.INNER, stack)
    SC.bind_rows(F.FR, stack, _fe(5))
    assert {k: v.launches for k, v in build.KERNELS.items()} == before
