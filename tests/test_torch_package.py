"""Rules of the co_zkvms_tpu_torch package: it imports neither JAX nor the
JAX package, its entry points refuse to run without a card unless asked for
the CPU, and its wrappers never mix devices. Tests that need the card carry
the ``cuda`` marker and decide to skip inside the test."""

import os
import random
import re
import subprocess
import sys

import numpy as np
import pytest


# bound by _port()
torch = S = squaring_chain = C = F = M = pst13 = build = None


def _port():
    """Import torch and the port when the first test of this module runs,
    not at collection: an xdist worker that runs none of these tests
    never loads them."""
    global torch, S, squaring_chain, C, F, M, pst13, build
    import torch
    from co_zkvms_tpu_torch.models import spartan as S
    from co_zkvms_tpu_torch.models.synthetic import squaring_chain
    from co_zkvms_tpu_torch.ops import curve as C
    from co_zkvms_tpu_torch.ops import field as F
    from co_zkvms_tpu_torch.ops import msm as M
    from co_zkvms_tpu_torch.ops import pst13
    from co_zkvms_tpu_torch.utils import build


@pytest.fixture(autouse=True, scope="module")
def _port_loaded():
    _port()


ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(ROOT, "co_zkvms_tpu_torch")
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|co_zkvms_tpu)\b",
                       re.MULTILINE)


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out.extend(os.path.join(d, f) for f in files if f.endswith(".py"))
    return sorted(out)


def test_sources_import_no_jax_and_no_jax_package():
    srcs = _sources()
    assert len(srcs) > 10
    for path in srcs:
        with open(path) as fh:
            hits = FORBIDDEN.findall(fh.read())
        assert not hits, f"{path} imports {hits}"


def test_importing_the_package_loads_no_jax():
    mods = ["co_zkvms_tpu_torch.models.spartan", "co_zkvms_tpu_torch.ops.msm",
            "co_zkvms_tpu_torch.utils.convert", "co_zkvms_tpu_torch.ops.pst13",
            "co_zkvms_tpu_torch.models.co_spartan",
            "co_zkvms_tpu_torch.parallel.mpc",
            "co_zkvms_tpu_torch.ops.poseidon", "co_zkvms_tpu_torch.ops.ntt",
            "co_zkvms_tpu_torch.parallel.shamir",
            "co_zkvms_tpu_torch.parallel.pointshares"]
    prog = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'co_zkvms_tpu'))\n"
            "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", prog], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pst13.setup(3, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.SpartanIndex.from_r1cs(squaring_chain(4).build())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        F.from_int(F.FR, [1, 2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        C.points_from_ints([(1, 2)])
    # the functions that carry the JAX package's state in, and the new
    # modules' entry points
    from co_zkvms_tpu_torch.ops import zk
    from co_zkvms_tpu_torch.parallel.rng import CorrelatedRng
    from co_zkvms_tpu_torch.utils import convert

    limbs = np.zeros((2, 16), np.uint32)
    raw = {"nv": 0, "levels": [(limbs[:1], limbs[:1])], "h_taus": []}
    for call in (lambda: convert.fe_from_limbs16(limbs),
                 lambda: convert.point_from_limbs16((limbs, limbs)),
                 lambda: convert.srs_from_raw(raw),
                 lambda: zk.generate_mask(random.Random(1), 2, 2),
                 lambda: CorrelatedRng((1, 2, 3)).zero_shares(F.FR, (2,), 0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # slice 4 (Poseidon, NTT, Shamir, point shares, seeded shares). The
    # functions that take tensors run on their inputs' device; a caller
    # starting from host values gets a card's tensors by default, so the
    # call raises before any work runs on the CPU.
    from co_zkvms_tpu_torch.ops import ntt
    from co_zkvms_tpu_torch.ops import poseidon
    from co_zkvms_tpu_torch.parallel import pointshares, shamir, shares

    gen = torch.Generator().manual_seed(1)
    for call in (lambda: poseidon.transcript_init(b"label"),
                 lambda: shamir.precompute_lagrange([1, 2]),
                 lambda: poseidon.permute(F.from_int(F.FR, [[1, 2, 3]])),
                 lambda: ntt.ntt(F.FR, F.from_int(F.FR, [1, 2])),
                 lambda: shamir.share(F.FR, gen, F.from_int(F.FR, [5]), 1, 3),
                 lambda: pointshares.share(gen, C.from_affine(
                     C.points_from_ints([(1, 2)]))),
                 lambda: shares.expand_seeded(F.FR, (1, 2), F.zeros((2,)),
                                              (2,))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_device_parameters_default_to_cuda():
    """Every public function or method of the port that takes a device
    runs on the card unless the caller asks for the CPU: no ``device``
    parameter defaults to the CPU."""
    import importlib
    import inspect
    import pkgutil

    import co_zkvms_tpu_torch

    found = []
    for info in pkgutil.walk_packages(co_zkvms_tpu_torch.__path__,
                                      "co_zkvms_tpu_torch."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if name.startswith("_") or getattr(obj, "__module__", None) != \
                    info.name:
                continue
            fns = [obj] if inspect.isfunction(obj) else [
                f for k, f in vars(obj).items()
                if not k.startswith("_") and callable(f)] \
                if inspect.isclass(obj) else []
            for fn in fns:
                fn = getattr(fn, "__func__", fn)
                try:
                    params = inspect.signature(fn).parameters
                except (TypeError, ValueError):
                    continue
                if "device" in params:
                    found.append(f"{info.name}.{name}")
                    # "cuda", or a device the caller must name
                    assert params["device"].default in (
                        "cuda", inspect.Parameter.empty), \
                        f"{info.name}.{name}: device={params['device'].default}"
    assert "co_zkvms_tpu_torch.utils.convert.fe_from_limbs16" in found
    assert "co_zkvms_tpu_torch.ops.zk.generate_mask" in found


def test_wrappers_reject_mixed_or_foreign_devices():
    a = F.from_int(F.FR, [3, 4], device="cpu")
    meta = torch.empty((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        F.mul(F.FR, a, meta)
    with pytest.raises(ValueError):
        C.double(C.JPoint(meta, meta, meta))
    with pytest.raises(TypeError):
        F._launch_binary(F.FP_MUL, F.FR, a.to(torch.int64), a)


def test_every_kernel_names_its_source_and_tpu_kernel():
    from co_zkvms_tpu_torch.ops import poseidon

    names = set(build.KERNELS)
    assert names == {"fp_mul", "fp_square", "fp_add", "fp_sub",
                     "g1_add_mixed", "g1_add", "g1_double",
                     "g1_add_incomplete", "msm_bucket_accumulate",
                     "sc_eval_round_outer", "sc_eval_round_inner",
                     "sc_reduce_partials", "sc_bind_round",
                     "poseidon_permute_t3"}
    b12 = build.KERNELS["poseidon_permute_t3"]
    assert b12 is poseidon.POSEIDON_T3 and b12.source == "poseidon"
    assert b12.replaces == \
        "co_zkvms_tpu/ops/poseidon.py:224 _permute_pallas_t3"
    for k in build.KERNELS.values():
        assert k.source in build.SOURCES
        assert os.path.exists(os.path.join(build.CSRC, f"{k.source}.cu"))
        # "file:line", optionally followed by the function's name
        path, rest = k.replaces.split(":")
        line, *fn = rest.split()
        with open(os.path.join(ROOT, path)) as fh:
            text = fh.read().splitlines()[int(line) - 1]
        assert text.lstrip().startswith("def "), (k.name, text)
        if fn:
            assert text.lstrip().startswith(f"def {fn[0]}("), (k.name, text)


def test_ptxas_summary_parses_registers_and_spills():
    """A noinline device function's own properties (its stack frame and
    spills) are not taken for the entry's."""
    log = ("ptxas info    : Function properties for _Z6helperv\n"
           "    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Compiling entry function '_Z6kernelPj' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z6kernelPj\n"
           "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
           "ptxas info    : Function properties for _Z7helper2v\n"
           "    16 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
           "ptxas info    : Used 128 registers, used 0 barriers\n")
    lines = build.ptxas_summary(log)
    assert lines == ["_Z6kernelPj: 128 registers, 4 bytes spill stores"]


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python3 chip_smoke.py)")
    gen = torch.Generator().manual_seed(5)
    n = 1 << 12
    w = torch.randint(0, 1 << 31, (n, 8), generator=gen, dtype=torch.int64)
    w[:, 7] %= 0x30644E72
    a = w.to(torch.int32).cuda()
    b = a.flip(0).contiguous()
    for spec in (F.FR, F.FQ):
        assert torch.equal(F.mul(spec, a, b), F.mul_plain(spec, a, b))
        assert torch.equal(F.square(spec, a), F.square_plain(spec, a))
        assert torch.equal(F.add(spec, a, b), F.add_plain(spec, a, b))
        assert torch.equal(F.sub(spec, a, b), F.sub_plain(spec, a, b))
    s = F.to_mont(F.FR, a[:256])
    g = C.points_from_ints([(1, 2)], device="cuda")
    pts = C.to_affine(M.fixed_base_msm(C.APoint(g.x[0], g.y[0]), s))
    p = C.double(C.from_affine(pts))
    q = C.double(p)
    for got, want in ((C.add(p, q), C.add_plain(p, q)),
                      (C.add_incomplete(p, q), C.add_incomplete_plain(p, q)),
                      (C.double(p), C.double_plain(p)),
                      (C.add_mixed(p, pts), C.add_mixed_plain(p, pts))):
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    order, starts = M.sort_windows(M.window_digits(s, 4), 4)
    got = M.bucket_accumulate(pts, order, starts)
    want = M.bucket_accumulate_plain(pts, order, starts)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    # the sumcheck round kernels (B9-B11)
    from co_zkvms_tpu_torch.ops import sumcheck as SC

    tabs = a.reshape(4, n // 4, 8).contiguous()
    for comb, stack, suffix in ((SC.OUTER, tabs[:3], b[: n // 8]),
                                (SC.INNER, tabs[:2], None)):
        suffix = None if suffix is None else suffix.contiguous()
        part = SC.eval_partials(F.FR, comb, stack, suffix)
        assert torch.equal(part, SC.eval_partials_plain(F.FR, comb, stack,
                                                        suffix))
        assert torch.equal(SC.reduce_partials(F.FR, part),
                           SC.reduce_partials_plain(F.FR, part))
    assert torch.equal(SC.bind_rows(F.FR, tabs, b[0]),
                       SC.bind_rows_plain(F.FR, tabs, b[0]))
    # B12, on a batch that is not a multiple of the block size
    from co_zkvms_tpu_torch.ops import poseidon as P

    states = a[: 3 * 301].reshape(301, 3, 8)
    assert torch.equal(P.permute(states), P.permute_plain(states))
    assert torch.equal(P.permute(states[:1]), P.permute_plain(states[:1]))
    # seeded shares expand to the same rows on the card as on the CPU
    from co_zkvms_tpu_torch.parallel import shares

    seeds, explicit = shares.share_seeded(F.FR, gen, a[:16])
    on_card = shares.expand_seeded(F.FR, seeds, explicit, (16,))
    on_cpu = shares.expand_seeded(F.FR, seeds, explicit.cpu(), (16,))
    assert torch.equal(on_card.cpu(), on_cpu)
