#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (co_zkvms_tpu_torch) once on one NVIDIA H100.

Phases, one line each; a failed phase raises, so the script exits non-zero
before its last line:

  1. device   the card's name, the device count, nvidia-smi's name and power
              limit.
  2. build    every ops/csrc/*.cu through nvcc, all started together; the
              build time and each kernel's registers and spills.
  3. kernels  each kernel against its plain PyTorch version on the same
              inputs at the main path's shapes, bit-exact (the results are
              field elements and points: there is no tolerance); the device
              time per launch from the profiler's device events (kernel_ms;
              the CUDA-event time around the calls kept as ms_events)
              beside its bound and the plain version's time. B5 and B7 also
              at the main path's small sizes: bit-exact at 4,096 points,
              timed at 4,096 and 2,432 points with blocks of 32, 64 and 128
              threads; B6 with 1, 7 and 8 doublings a launch at the paths'
              shapes (16 and 19 window sums, 2^10 points, 2^16), each
              bit-exact; B4-B8 report their ptxas registers and spill stores.
              B12 timed on 2^(nv-2) states.
              B8 on three window sets (uniform scalars on 2^nv points,
              row-like scalars on 2^(nv+1), one scalar for all 2^nv), each
              bit-exact on two windows and timed over all its passes at
              each run length T of msm.BUCKET_RUNS; then the opening
              shape with and without the top-window regroup. The sumcheck
              round kernels (B9 for each comb instance, B11, B10 on tables
              and on a [3, n, 8] share stack) run at the first round's
              shapes of the slice's sumchecks, B9 there also at grids of
              2, 3, 4 and 8 blocks an SM and one block a 128 pairs; then
              each B9 comb at every round of one nv-round sumcheck (tables
              bound by B10 between rounds, the split-eq suffixes of random
              taus), each round bit-exact, its device time summed.
  4. slice    the main path through the entry points a user calls:
              pst13.setup(nv, 7) and spartan.prove of
              squaring_chain(2^nv - 4) with x = 3 (nv = 20 by default, as the
              JAX package's bench.py sub_spartan(20)); the host verifier
              accepts the proof and rejects a tampered one; every kernel's
              launch count in that run is > 0 (the sumchecks run B9-B11);
              the proof's sha256 (of its repr) is printed, to compare
              trees.
              Then two checks against the repository's own references:
              setup(10, 7) equals the tracked .srs_cache/srs_10_7.pkl, and
              the cubic circuit's proof on the card equals the one the plain
              versions make on the CPU.
  5. slice2   slice 2 on the same statement: pst13.setup over the DFS
              entries domain (dlog from spartan_dfs.entries), the DFS index,
              zk.from_seed; the single-party spartan.prove(dfs=, zk_ctx=) and
              co_spartan.prove_rep3(dfs=, zk_ctx=) with the same zk rng
              seed must give equal proofs, field by field; the host verifier
              accepts and rejects va + 1 and a changed DFS eval; every
              kernel's launch count in this phase is > 0, and so is the
              count of MSMs down the by-value path (the index's 0/1 and
              count tables). Then a separate commit of val_a (it must take
              the by-value path) is timed, and a 2^dlog-entry 0/1 table
              committed through the by-value path must give the point of
              the B8 window path called directly on it. The proofs'
              sha256 is printed.
  6. profile  slice 1's prove again, with the index rebuilt, under
              torch.profiler: each of the prover's named phases
              (models/spartan.py, utils/phases.py) with its host time and
              the device's busy time inside it, and the device's idle share
              of the prove. The proof must equal the slice's. Then the same
              for slice 2's prove_rep3 by its co_spartan.<phase> ranges,
              and slice 2's DFS build_index (wall, device busy time, its
              kernels by device time, B8's, B6's and B9's device time
              and launches; the same commitments).
  7. slice4   the primitives off the prover path, at the JAX package's
              bench.py shapes (nv = 20): hash2 over 2^18 pairs (B12), a
              Merkle root over 2^20 leaves by merkle_layer, the Poseidon
              transcript, t = 4 and 5 permutations of 2^16 states, the NTT
              and its inverse at 2^20, Shamir sharing of 2^20 secrets
              (t = 2, n = 5) and of 2^10 points (t = 1, n = 3), Rep3 point
              shares and per-party MSMs; every launch count of that run
              must be > 0 for B12, B1, B3, B5, B6 and B8. Then the checks:
              B12 against its plain version on 2^16 states and against the
              t = 3 composition over the field kernels on the 2^18 hash
              states (bit for bit), with its bounds for the sparse and the
              dense schedule and its registers; hash and Merkle nodes
              against host_hash,
              the transcript against its host mirror, t = 4/5 against
              host_permute, intt(ntt(x)) == x, a 2^10 NTT against a host
              DFT, and every reconstruction against its secret.

Then it prints one JSON line of kernel records, nvidia-smi's name and power
limit, and, last, {"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py [--nv 20] [--seed 7]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet; CUDA throughput table for compute
# capability 9.0: 64 32-bit integer multiply-adds per clock per SM)
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * 64 * 1.98e9
# 32-bit multiply-add slots per field product: a 32x32->64 product is two
# (low and high halves). CIOS mul: 64 + 64 wide + 8 low; SOS square:
# 28 + 8 + 64 wide + 8 low.
MUL_OPS = 2 * 128 + 8
SQR_OPS = 2 * 100 + 8
ELEM = 32                                  # bytes per field element


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# the card's state beside a timing: SM clock, its maximum, power draw and
# temperature (a card at its power limit clocks down under load)
CLOCKS = "clocks.sm,clocks.max.sm,power.draw,temperature.gpu"


def bound(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / IMAD_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nv", type=int, default=20)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from co_zkvms_tpu_torch.utils import build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[device] {name} count={torch.cuda.device_count()} "
        f"nvidia-smi: {smi}; torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    report = build.build_all()
    t_build = time.perf_counter() - t0
    regs = []
    for log_text in report.values():
        regs.extend(build.ptxas_summary(log_text))
    log(f"[build] {len(report)} sources in {t_build:.1f} s (parallel nvcc)")
    for line in regs:
        log(f"[build]   {line}")

    check_register_budget(regs)
    records, b12_ms = kernel_phase(torch, dev, args.nv, regs)
    r1cs, srs, z, proof, index = slice_phase(torch, dev, args, records)
    rep3 = slice2_phase(torch, dev, args, r1cs, z, index, records)
    profile_phase(torch, dev, r1cs, srs, z, proof)
    profile_rep3_phase(torch, dev, index, z, args.seed, *rep3)
    profile_index_phase(torch, r1cs, *rep3[:2])
    slice4_phase(torch, dev, args, records, b12_ms, regs)

    print(json.dumps({"kernels": records}), flush=True)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all; "
        f"{PROFILER_RETRIES} kernel timings profiled again for want of "
        f"device events")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------


def cuda_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def entry_key(name: str) -> str:
    """A profiler event's kernel name without spaces, as ENTRIES spells the
    kernels' device functions."""
    return name.replace(" ", "")


def is_entry(name: str, entries) -> bool:
    key = entry_key(name)
    return any(f"::{entry}(" in key for entry in entries)


# profiles kernel_ms may take for one timing, and the repeats it took
PROFILER_TRIES = 5
PROFILER_RETRIES = 0


def kernel_ms(torch, fn, reps: int, entries, launches=None) -> float:
    """Mean device time of one call of fn from torch.profiler's device
    events over ``reps`` calls: unlike CUDA events around the calls, it
    leaves out the wrapper's host time, which a small launch does not
    cover. A call launches each device function of ``entries`` the number
    of times ``launches`` gives beside it (1 each by default); its time is
    the sum of each one's mean event times that number of times. The
    profiler may drop events of a burst of short launches (seen: 49 of 50,
    and 9 of 10), so the mean of those it kept stands for a launch."""
    from co_zkvms_tpu_torch.utils import phases

    global PROFILER_RETRIES
    launches = launches or (1,) * len(entries)
    wanted = [(e, c) for e, c in zip(entries, launches) if c]
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(PROFILER_TRIES):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events() if phases.is_device_work(e)]
        us = {entry: [e.time_range.elapsed_us() for e in device
                      if is_entry(e.name, (entry,))] for entry, _ in wanted}
        if all(us.values()):
            return sum(sum(t) / len(t) * c
                       for (_, c), t in zip(wanted, us.values())) / 1e3
        # a profile can come back with no device events at all (seen in
        # runs that passed elsewhere): profile again
        PROFILER_RETRIES += 1
    seen = sorted({entry_key(e.name)[:60] for e in device})[:8]
    raise AssertionError(f"{entries}: no device events for {reps} calls in "
                         f"{PROFILER_TRIES} profiles; seen {seen}")


def bucket_launches(n: int, run: int) -> tuple:
    """B8's launches a call by device function (points_kernel,
    merge_kernel) for n points and run length T."""
    from co_zkvms_tpu_torch.ops import msm as M

    return (1, len(M.bucket_passes(n, run)) - 1)


def same(torch, a, b) -> bool:
    if isinstance(a, tuple):
        return all(same(torch, x, y) for x, y in zip(a, b))
    return bool(torch.equal(a, b))


def record(kfn, source, ms, plain_ms, nbytes, ops, note=None):
    b_ms, b_by = bound(nbytes, ops)
    rec = {"name": kfn.name, "route": "cuda", "source": source,
           "replaces": kfn.replaces, "launches": 0, "max_abs_err": 0,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": None}
    if note:
        rec["plain_scope"] = note
    return rec


def random_fe(torch, gen, n, dev):
    """n canonical elements: a top limb below both moduli's keeps x < m."""
    w = torch.randint(-(1 << 31), (1 << 31) - 1, (n, 8), generator=gen,
                      dtype=torch.int64, device="cpu")
    w[:, 7] = torch.randint(0, 0x30644E72, (n,), generator=gen,
                            dtype=torch.int64)
    return w.to(torch.int32).to(dev)


def kernel_phase(torch, dev, nv: int, regs: list) -> tuple:
    """Every kernel against its plain version, timed; returns the records
    and B12's device time on 2^(nv-2) states (slice 4 reports it: after
    the profile phases the profiler recorded no device events there)."""
    from co_zkvms_tpu_torch.ops import curve as C
    from co_zkvms_tpu_torch.ops import field as F
    from co_zkvms_tpu_torch.ops import msm as M
    from co_zkvms_tpu_torch.ops import ref_bn254 as bn

    gen = torch.Generator().manual_seed(1)
    records = []
    fsrc = "co_zkvms_tpu_torch/ops/csrc/field_kernels.cu"
    n = 1 << nv
    for kfn, fn, plain, ops in (
            (F.FP_MUL, F.mul, F.mul_plain, MUL_OPS),
            (F.FP_SQUARE, F.square, F.square_plain, SQR_OPS),
            (F.FP_ADD, F.add, F.add_plain, 0),
            (F.FP_SUB, F.sub, F.sub_plain, 0)):
        times = {}
        for spec in (F.FR, F.FQ):
            a = random_fe(torch, gen, n, dev)
            b = random_fe(torch, gen, n, dev)
            a[0] = 0
            b[1] = F.constant(spec, spec.modulus - 1, dev)
            args = (a,) if kfn is F.FP_SQUARE else (a, b)
            got = fn(spec, *args)
            want = plain(spec, *args)
            torch.cuda.synchronize()
            if not same(torch, got, want):
                raise AssertionError(f"{kfn.name} {spec.name}: kernel != plain")
            entry = ENTRIES[kfn.name][0].replace("<0", f"<{spec.fid}")
            times[spec.name] = (
                kernel_ms(torch, lambda: fn(spec, *args), 20, (entry,)),
                cuda_ms(torch, lambda: fn(spec, *args), 20),
                cuda_ms(torch, lambda: plain(spec, *args), 1))
        ms, ms_events, pms = times["bn254_fr"]
        nin = 1 if kfn is F.FP_SQUARE else 2
        records.append(record(kfn, fsrc, ms, pms, (nin + 1) * ELEM * n,
                              ops * n))
        records[-1]["ms_events"] = ms_events
        records[-1]["fq"] = dict(zip(("ms", "ms_events", "plain_ms"),
                                     times["bn254_fq"]))
        log(f"[kernels] {kfn.name} 2^{nv} bit-exact; device Fr {ms:.4f} ms, "
            f"Fq {times['bn254_fq'][0]:.4f} ms a launch (CUDA events around "
            f"the calls: Fr {ms_events:.4f}, Fq {times['bn254_fq'][1]:.4f}; "
            f"plain Fr {pms:.2f} ms, Fq {times['bn254_fq'][2]:.2f} ms), "
            f"bound {records[-1]['bound_ms']:.4f} ms "
            f"({records[-1]['bound_by']})")

    # G1 at 2^(nv-4) points, with p = q, p = -q and infinity rows planted
    npt = 1 << (nv - 4)
    g = C.points_from_ints([bn.g1_coords(bn.G1_GEN)], device=dev)
    g1 = C.APoint(g.x[0], g.y[0])

    def rand_points(count):
        s = F.to_mont(F.FR, random_fe(torch, gen, count, dev))
        return C.to_affine(M.fixed_base_msm(g1, s))

    pa, qa = rand_points(npt), rand_points(npt)
    p = C.double(C.from_affine(pa))              # z != 1
    q = C.double(C.from_affine(qa))
    inf = C.infinity((1,), dev)
    # row 0: p == q; row 1: p == -q; row 2: p = inf; row 3: q = inf;
    # row 4: both inf
    q = C.JPoint(*(c.clone() for c in q))
    p = C.JPoint(*(c.clone() for c in p))
    for dst, src in zip(q, p):
        dst[0] = src[0]
        dst[1] = src[1]
    q.y[1] = F.neg(F.FQ, p.y[1:2])[0]
    for dst, src in zip(p, inf):
        dst[2] = src[0]
        dst[4] = src[0]
    for dst, src in zip(q, inf):
        dst[3] = src[0]
        dst[4] = src[0]
    q_aff = C.to_affine(q)                       # same rows, affine
    gsrc = "co_zkvms_tpu_torch/ops/csrc/g1.cu"
    n_gen = npt - 5
    pre = 3 * MUL_OPS + SQR_OPS                  # up to h and r (mixed)
    dbl = 2 * MUL_OPS + 5 * SQR_OPS
    madd = 7 * MUL_OPS + 4 * SQR_OPS
    pre_j = 6 * MUL_OPS + 2 * SQR_OPS
    jadd = 11 * MUL_OPS + 5 * SQR_OPS
    cases = (
        (C.G1_ADD_MIXED, C.add_mixed, C.add_mixed_plain, (p, q_aff),
         n_gen * madd + 2 * pre + dbl, 8 * ELEM),
        (C.G1_ADD, C.add, C.add_plain, (p, q),
         n_gen * jadd + 2 * pre_j + dbl, 9 * ELEM),
        (C.G1_DOUBLE, C.double, C.double_plain, (p,), npt * dbl, 6 * ELEM),
        (C.G1_ADD_INCOMPLETE, C.add_incomplete, C.add_incomplete_plain,
         (p, q), (n_gen + 2) * jadd, 9 * ELEM),
    )
    for kfn, fn, plain, args, ops, per_pt in cases:
        got = fn(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        if not same(torch, tuple(got), tuple(want)):
            raise AssertionError(f"{kfn.name}: kernel != plain")
        ms = kernel_ms(torch, lambda: fn(*args), 20, ENTRIES[kfn.name])
        ms_events = cuda_ms(torch, lambda: fn(*args), 20)
        pms = cuda_ms(torch, lambda: plain(*args), 1)
        records.append(record(kfn, gsrc, ms, pms, per_pt * npt, ops))
        records[-1].update(registers_of(regs, kfn.name),
                           ms_events=ms_events)
        log(f"[kernels] {kfn.name} 2^{nv - 4} points (p=q, p=-q, inf rows) "
            f"bit-exact; device {ms:.4f} ms a launch (CUDA events around "
            f"the calls {ms_events:.4f} ms; plain {pms:.2f} ms), bound "
            f"{records[-1]['bound_ms']:.4f} ms ({records[-1]['bound_by']}); "
            f"{records[-1]['registers']} registers, "
            f"{records[-1]['spill_stores']} bytes spill stores")
    small_g1_launches(torch, C, p, q, records, jadd, pre_j, dbl)
    double_shapes(torch, C, p, records, dbl)

    bucket_kernel(torch, dev, gen, nv, regs, records, rand_points, madd)
    sumcheck_kernels(torch, dev, gen, nv, regs, records)
    return records, poseidon_ms(torch, dev, gen, nv)


def bucket_kernel(torch, dev, gen, nv: int, regs: list, records: list,
                  rand_points, madd: int) -> None:
    """B8 on three window sets, each bit for bit against its plain version
    on two windows (a window's schedule depends on that window alone):
    uniform scalars on 2^nv points; row-like scalars, 2^(nv+1) values below
    2^nv as in the DFS index's row and col tables (window 1 then has 16
    digits at c = 16, so each of its buckets holds 2^(nv-3) points); and
    one scalar for 2^nv points (one bucket a window holds every point).
    Each case timed by device events over all its passes at every run
    length T of BUCKET_RUNS; then the opening MSM's shape with and without
    the top-window regroup."""
    from co_zkvms_tpu_torch.ops import curve as C
    from co_zkvms_tpu_torch.ops import field as F
    from co_zkvms_tpu_torch.ops import msm as M

    n = 1 << nv
    kfn = M.MSM_BUCKET
    entries = ENTRIES[kfn.name]
    pts2 = rand_points(2 * n)
    pts = C.APoint(pts2.x[:n], pts2.y[:n])
    uniform = F.to_mont(F.FR, random_fe(torch, gen, n, dev))
    row = F.from_int(F.FR, torch.randint(0, n, (2 * n,), generator=gen)
                     .numpy(), device=dev)
    one = F.to_mont(F.FR, random_fe(torch, gen, 1, dev)).expand(n, 8)
    cases = {}
    for label, p, sc in (("uniform", pts, uniform), ("row_like", pts2, row),
                         ("one_scalar", pts, one.contiguous())):
        m = sc.shape[0]
        c = M.auto_c(m)
        order, starts, _, _ = M.sorted_windows(sc, c)      # as msm does
        nw, nb = starts.shape[0], starts.shape[1] - 1
        ws = [0, 1] if label == "row_like" else [0, nw - 1]
        got = M.bucket_accumulate(p, order, starts)
        want, pms = timed(torch, lambda: M.bucket_accumulate_plain(
            p, order[ws].contiguous(), starts[ws].contiguous()))
        if not same(torch, tuple(c_[ws] for c_ in got), tuple(want)):
            raise AssertionError(f"{kfn.name} {label}: kernel != plain")
        by_run = {run: kernel_ms(
            torch, lambda run=run: M.bucket_accumulate_run(
                p, order, starts, run), 5, entries,
            launches=bucket_launches(m, run)) for run in M.BUCKET_RUNS}
        counts = (starts[:, 1:] - starts[:, :-1])[:, 1:]
        adds = int(counts.sum()) - int((counts > 0).sum())
        nbytes = (m * 2 * ELEM + nw * m * 4 + nw * (nb + 1) * 4 +
                  nw * nb * 3 * ELEM)
        b_ms, b_by = bound(nbytes, adds * madd)
        cases[label] = {
            "points": m, "c": c, "windows_checked": ws, "plain_ms": pms,
            "ms_by_run": by_run,
            "passes_by_run": {r: len(M.bucket_passes(m, r))
                              for r in M.BUCKET_RUNS},
            "bytes": nbytes, "operations": adds * madd,
            "bound_ms": b_ms, "bound_by": b_by,
            "fullest_bucket": int(counts.max())}
        log(f"[kernels] {kfn.name} {label}: 2^{m.bit_length() - 1} points "
            f"c={c} ({nw} windows x {nb} buckets, fullest bucket "
            f"{cases[label]['fullest_bucket']} points) bit-exact on windows "
            f"{ws} (plain {pms:.1f} ms); device time a call, all passes: " +
            ", ".join(f"T={r} {ms:.3f} ms ({cases[label]['passes_by_run'][r]}"
                      f" passes)" for r, ms in by_run.items()) +
            f"; bound {b_ms:.4f} ms ({b_by})")
    uni = cases["uniform"]
    rec = record(kfn, "co_zkvms_tpu_torch/ops/csrc/msm_bucket.cu",
                 uni["ms_by_run"][M.BUCKET_RUN], uni["plain_ms"],
                 uni["bytes"], uni["operations"],
                 note=f"uniform case; plain_ms covers windows "
                      f"{uni['windows_checked']}")
    rec.update(run=M.BUCKET_RUN, passes=uni["passes_by_run"][M.BUCKET_RUN],
               cases=cases, **registers_of(regs, kfn.name))
    records.append(rec)
    log(f"[kernels] {kfn.name} T={M.BUCKET_RUN}: {rec['registers']} "
        f"registers, {rec['spill_stores']} bytes spill stores "
        f"({rec.get('by_entry')})")

    # the top-window regroup at an opening MSM's shape: c = auto_c(2^(nv-4))
    # leaves the top window 2 bits (nv = 20), so without the regroup a few
    # buckets hold a quarter of the points each
    n_open = 1 << (nv - 4)
    c_open = M.auto_c(n_open)
    sc_open = uniform[:n_open]
    p_open = C.APoint(pts.x[:n_open], pts.y[:n_open])
    raw = M.sort_windows(M.window_digits(sc_open, c_open), c_open)
    regrouped = M.sorted_windows(sc_open, c_open)[:2]
    opening = {}
    for label, (order, starts) in (("as_is", raw), ("regrouped", regrouped)):
        opening[label] = kernel_ms(
            torch, lambda: M.bucket_accumulate(p_open, order, starts), 5,
            entries, launches=bucket_launches(n_open, M.BUCKET_RUN))
        opening[label + "_fullest_bucket"] = int(
            (starts[:, 2:] - starts[:, 1:-1]).max())
    rec["opening"] = opening
    log(f"[kernels] {kfn.name} 2^{nv - 4} points c={c_open}, top window as "
        f"is {opening['as_is']:.3f} ms (fullest bucket "
        f"{opening['as_is_fullest_bucket']} points), regrouped "
        f"{opening['regrouped']:.3f} ms (fullest "
        f"{opening['regrouped_fullest_bucket']})")


# each kernel's device functions, spelled as entry_key spells the
# profiler's names (B1-B3 and B9-B11 are templates on the field, Fr = 0;
# B9 also on its comb id, 0 outer, 1 inner)
ENTRIES = {"fp_mul": ("binary_kernel<0,0>",),
           "fp_add": ("binary_kernel<0,1>",),
           "fp_sub": ("binary_kernel<0,2>",),
           "fp_square": ("unary_kernel<0>",),
           "g1_add_mixed": ("add_mixed_kernel",), "g1_add": ("add_kernel",),
           "g1_double": ("double_kernel",),
           "g1_add_incomplete": ("add_incomplete_kernel",),
           "msm_bucket_accumulate": ("points_kernel", "merge_kernel"),
           "sc_eval_round_outer": ("eval_kernel<0,0>",),
           "sc_eval_round_inner": ("eval_kernel<0,1>",),
           "sc_reduce_partials": ("reduce_kernel<0>",),
           "sc_bind_round": ("bind_kernel<0>",),
           "poseidon_permute_t3": ("poseidon_t3_kernel",)}


def mangled(entry: str):
    """How a mangled name spells an entry: <len><name>E, or with integer
    template arguments <len><name>ILi<a>E...E; None for other templates."""
    base, _, args = entry.partition("<")
    if not args:
        return f"{len(base)}{base}E"
    vals = args.rstrip(">").split(",")
    if not all(v.isdigit() for v in vals):
        return None
    return f"{len(base)}{base}I" + "".join(f"Li{v}E" for v in vals) + "E"


def registers_of(regs: list, name: str) -> dict:
    """{"registers": n, "spill_stores": bytes} of a kernel (the most over
    its device functions, each also under "by_entry") from the ptxas
    summary lines; {} for a kernel whose entries are templates on types."""
    entries = ENTRIES[name]
    if any(mangled(e) is None for e in entries):
        return {}
    by_entry = {}
    for entry in entries:
        token = mangled(entry)
        for line in regs:
            if token in line.split(":")[0]:
                counts = line.split(":")[1].split(",")
                by_entry[entry] = (int(counts[0].split()[0]),
                                   int(counts[1].split()[0]))
                break
        else:
            raise AssertionError(f"no ptxas line for {entry}")
    rec = {"registers": max(r for r, _ in by_entry.values()),
           "spill_stores": max(sp for _, sp in by_entry.values())}
    if len(by_entry) > 1:
        rec["by_entry"] = {e: {"registers": r, "spill_stores": sp}
                           for e, (r, sp) in by_entry.items()}
    return rec


# kernels built to at most 128 registers with no spill stores (four blocks
# of 128 threads an SM)
BUDGETED = ("g1_add", "g1_double", "g1_add_incomplete",
            "msm_bucket_accumulate", "sc_eval_round_outer",
            "sc_eval_round_inner", "poseidon_permute_t3")


def check_register_budget(regs: list) -> None:
    for name in BUDGETED:
        rec = registers_of(regs, name)
        if rec["registers"] > 128 or rec["spill_stores"]:
            raise AssertionError(f"{name} over its budget of 128 registers "
                                 f"and no spills: {rec}")
    log(f"[build] {', '.join(BUDGETED)}: each at most 128 registers, "
        f"0 bytes spill stores")


# the small launches of the main path: the weighted bucket sums of a c = 16
# window set ([16, 256] buckets) and of an opening MSM ([19, 128])
SMALL_SHAPES = (4096, 2432)


def small_g1_launches(torch, C, p, q, records, jadd, pre_j, dbl) -> None:
    """B5 and B7 at the main path's small sizes: bit-exact against their
    plain versions at 4,096 points (the edge rows included), and timed at
    each block size the wrapper may choose."""
    for rec, kfn, fn, plain, ops_edge in (
            (records[-3], C.G1_ADD, C.add, C.add_plain, 2 * pre_j + dbl),
            (records[-1], C.G1_ADD_INCOMPLETE, C.add_incomplete,
             C.add_incomplete_plain, 2 * jadd)):
        sizes = {}
        for n in SMALL_SHAPES:
            args = (C.index(p, slice(0, n)), C.index(q, slice(0, n)))
            if n == SMALL_SHAPES[0]:
                got, want = fn(*args), plain(*args)
                torch.cuda.synchronize()
                if not same(torch, tuple(got), tuple(want)):
                    raise AssertionError(f"{kfn.name} at {n} points: "
                                         "kernel != plain")
            chosen = C.add_block_threads(n, p.x.device)
            by_threads = {t: kernel_ms(torch, lambda t=t: C._launch(
                kfn, [*args[0], *args[1]], threads=t), 50, ENTRIES[kfn.name])
                for t in C.ADD_BLOCK_SIZES}
            b_ms, _ = bound(9 * ELEM * n, (n - 5) * jadd + ops_edge)
            sizes[str(n)] = {"ms": by_threads[chosen], "threads": chosen,
                             "ms_by_threads": by_threads, "bound_ms": b_ms}
            log(f"[kernels] {kfn.name} {n} points"
                f"{' bit-exact' if n == SMALL_SHAPES[0] else ''}, device "
                f"time a launch: " +
                ", ".join(f"{t} threads {ms:.4f} ms"
                          for t, ms in by_threads.items()) +
                f"; chosen {chosen}; bound {b_ms:.4f} ms")
        rec["small_shapes"] = sizes
        assert rec["name"] == kfn.name


# B6 on the paths: [nw] window sums doubled lbits = c // 2 times in one
# launch (c = 16: 16 windows, 8 doublings; an opening MSM's c = 14: 19
# windows, 7), 2^10 points doubled once between adds (Shamir's
# scalar_mul_public), and 2^16 points
DOUBLE_SHAPES = ((16, (1, 7, 8)), (19, (7,)), (1024, (1,)),
                 (1 << 16, (1, 7, 8)))


def double_shapes(torch, C, p, records, dbl) -> None:
    """B6 with `times` doublings a launch at the paths' shapes, bit-exact
    against double_plain (the first rows of the 2^16 case: p = inf at rows
    2 and 4) and timed by device events."""
    rec = next(r for r in records if r["name"] == C.G1_DOUBLE.name)
    shapes = {}
    for n, counts in DOUBLE_SHAPES:
        n = min(n, p.x.shape[0])                 # --nv below 20
        pts = C.index(p, slice(0, n))
        for times in counts:
            got = C.double(pts, times=times)
            want, pms = timed(torch, lambda: C.double_plain(pts, times))
            if not same(torch, tuple(got), tuple(want)):
                raise AssertionError(f"g1_double {n} points x {times}: "
                                     "kernel != plain")
            ms = kernel_ms(torch, lambda: C.double(pts, times=times), 20,
                           ENTRIES[C.G1_DOUBLE.name])
            b_ms, b_by = bound(6 * ELEM * n, n * times * dbl)
            shapes[f"{n}x{times}"] = {"points": n, "times": times, "ms": ms,
                                      "plain_ms": pms, "bound_ms": b_ms,
                                      "bound_by": b_by}
            log(f"[kernels] g1_double {n} points, times={times}: bit-exact; "
                f"device {ms:.4f} ms a launch (plain {pms:.2f} ms), bound "
                f"{b_ms:.5f} ms ({b_by})")
    rec["shapes"] = shapes


# B9's field products a pair: the outer comb two at each of t = 0, 1, 2
# (the block's t = 3 follows from them once, after the block sum), the
# inner one at each; the outer comb's earlier schedule took two at each of
# its four points (B9_PRODUCTS_ALL_POINTS)
B9_PRODUCTS = {"outer": 6, "inner": 3}
B9_PRODUCTS_ALL_POINTS = 8
# B9's grids timed at the first round's shape: blocks an SM (None: no cap,
# one block a 128 pairs), in turns, B9_GRID_PASSES times each
B9_GRID_CAPS = (2, 3, 4, 8, None)
B9_GRID_PASSES = 3


def sumcheck_kernels(torch, dev, gen, nv: int, regs: list,
                     records: list) -> None:
    """B9-B11 at the first round's shapes of the slice's sumchecks: the
    outer comb on 3 tables of 2^nv entries + a 2^(nv-1) suffix, the inner
    on 2 tables, B9 also on each grid of B9_GRID_CAPS; B11 on the outer
    comb's partials; B10 on 3 tables and on a [3, 2^nv, 8] share stack.
    Then B9 over a whole sumcheck (b9_over_sumcheck). The grids are timed
    in turns, each B9_GRID_PASSES times (the median kept), since the
    card's clock moves between timings."""
    from co_zkvms_tpu_torch.ops import field as F
    from co_zkvms_tpu_torch.ops import sumcheck as SC

    src = "co_zkvms_tpu_torch/ops/csrc/sumcheck_round.cu"
    n = 1 << nv
    h = n // 2
    suffix = random_fe(torch, gen, h, dev)
    r = random_fe(torch, gen, 1, dev)[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def check(name, got, want):
        torch.cuda.synchronize()
        if not same(torch, got, want):
            raise AssertionError(f"{name}: kernel != plain")

    for comb in (SC.OUTER, SC.INNER):
        tabs = torch.stack([random_fe(torch, gen, n, dev)
                            for _ in range(comb.n_tables)])
        tabs[:, 0] = 0                                  # a zero pair member
        tabs[:, 1] = F.constant(F.FR, F.FR.modulus - 1, dev)
        suf = suffix if comb.split_eq else None
        entries = ENTRIES[comb.kernel.name]
        got = SC.eval_partials(F.FR, comb, tabs, suf)
        check(f"sc_eval_round {comb.name}", got,
              SC.eval_partials_plain(F.FR, comb, tabs, suf,
                                     blocks=got.shape[0]))
        ms = kernel_ms(torch, lambda: SC.eval_partials(F.FR, comb, tabs, suf),
                       20, entries)
        ms_events = cuda_ms(torch, lambda: SC.eval_partials(
            F.FR, comb, tabs, suf), 20)
        pms = cuda_ms(torch, lambda: SC.eval_partials_plain(
            F.FR, comb, tabs, suf, blocks=got.shape[0]), 1)
        grids = {}
        for cap in B9_GRID_CAPS:
            g = -(-h // SC.EVAL_THREADS)
            grids[f"{cap}/SM" if cap else "uncapped"] = (
                g if cap is None else min(g, cap * sms))
            check(f"sc_eval_round {comb.name} on {g} blocks",
                  SC._launch_eval(F.FR, comb, tabs, suf, g),
                  SC.eval_partials_plain(F.FR, comb, tabs, suf, blocks=g))
        runs = {k: [] for k in grids}
        for _ in range(B9_GRID_PASSES):
            for k, g in grids.items():
                runs[k].append(kernel_ms(torch, lambda g=g: SC._launch_eval(
                    F.FR, comb, tabs, suf, g), 20, entries))
        by_grid = {k: {"blocks": grids[k], "ms": sorted(v)[len(v) // 2],
                       "ms_runs": v} for k, v in runs.items()}
        nbytes = (comb.n_tables * n + (h if suf is not None else 0)) * ELEM
        nbytes += got.numel() * 4
        muls = B9_PRODUCTS[comb.name]
        rec = record(comb.kernel, src, ms, pms, nbytes, muls * MUL_OPS * h)
        rec.update(registers_of(regs, comb.kernel.name), ms_events=ms_events,
                   products_a_pair=muls, blocks=got.shape[0],
                   ms_by_grid=by_grid)
        if comb.split_eq:
            rec["bound_all_points_ms"] = bound(
                nbytes, B9_PRODUCTS_ALL_POINTS * MUL_OPS * h)[0]
        records.append(rec)
        log(f"[kernels] sc_eval_round {comb.name} ({comb.n_tables} x 2^{nv}"
            f"{' + 2^%d suffix' % (nv - 1) if suf is not None else ''}, "
            f"{got.shape[0]} partials) bit-exact; device {ms:.4f} ms (CUDA "
            f"events {ms_events:.4f} ms; plain {pms:.2f} ms), bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, {muls} products "
            f"a pair), {100 * rec['bound_ms'] / ms:.1f} % of it" +
            (f"; at {B9_PRODUCTS_ALL_POINTS} products a pair "
             f"{rec['bound_all_points_ms']:.4f} ms" if comb.split_eq else "") +
            f"; {rec['registers']} registers, {rec['spill_stores']} bytes "
            f"spill stores")
        log(f"[kernels] sc_eval_round {comb.name} by grid, each bit-exact, "
            f"median of {B9_GRID_PASSES} in turns: " +
            ", ".join(f"{k} ({v['blocks']} blocks) {v['ms']:.4f} ms"
                      for k, v in by_grid.items()) +
            f"; {CLOCKS}: {nvidia_smi_line(CLOCKS)}")
        if comb is SC.OUTER:
            part = got
    red = SC.reduce_partials(F.FR, part)
    check("sc_reduce_partials", red, SC.reduce_partials_plain(F.FR, part))
    ms = kernel_ms(torch, lambda: SC.reduce_partials(F.FR, part), 50,
                   ENTRIES[SC.SC_REDUCE.name])
    ms_events = cuda_ms(torch, lambda: SC.reduce_partials(F.FR, part), 50)
    pms = cuda_ms(torch, lambda: SC.reduce_partials_plain(F.FR, part), 3)
    records.append(record(SC.SC_REDUCE, src, ms, pms,
                          (part.numel() + red.numel()) * 4, 0))
    records[-1]["ms_events"] = ms_events
    log(f"[kernels] sc_reduce_partials {tuple(part.shape)} bit-exact; device "
        f"{ms:.4f} ms (CUDA events {ms_events:.4f} ms; plain {pms:.2f} ms), "
        f"bound "
        f"{records[-1]['bound_ms']:.6f} ms ({records[-1]['bound_by']})")

    bind_ms = {}
    for label, stack in (("3 tables", torch.stack(
            [random_fe(torch, gen, n, dev) for _ in range(3)])),
            ("[3, 2^%d, 8] shares" % nv, random_fe(
                torch, gen, 3 * n, dev).reshape(3, n, 8))):
        got = SC.bind_rows(F.FR, stack, r)
        check(f"sc_bind_round {label}", got, SC.bind_rows_plain(F.FR, stack, r))
        bind_ms[label] = (
            kernel_ms(torch, lambda: SC.bind_rows(F.FR, stack, r), 20,
                      ENTRIES[SC.SC_BIND.name]),
            cuda_ms(torch, lambda: SC.bind_rows(F.FR, stack, r), 20),
            cuda_ms(torch, lambda: SC.bind_rows_plain(F.FR, stack, r), 1))
    ms, ms_events, pms = bind_ms["3 tables"]
    records.append(record(SC.SC_BIND, src, ms, pms, (3 * n + 3 * h) * ELEM,
                          3 * h * MUL_OPS))
    records[-1]["ms_events"] = ms_events
    log(f"[kernels] sc_bind_round bit-exact; device time on " + ", ".join(
        f"{k}: {v[0]:.4f} ms (CUDA events {v[1]:.4f} ms; plain {v[2]:.2f} ms)"
        for k, v in bind_ms.items())
        + f"; bound {records[-1]['bound_ms']:.4f} ms ({records[-1]['bound_by']})")
    b9_over_sumcheck(torch, dev, gen, nv, records)


def b9_over_sumcheck(torch, dev, gen, nv: int, records: list) -> None:
    """Each B9 comb at every round of one nv-round sumcheck, h = 2^(nv-1)
    pairs down to 1, as prove runs them: the tables (0 and m - 1 in the
    first pair) bound by B10 between rounds at a random challenge, the
    outer comb's split-eq suffix of each round from eq_suffix_tables of
    random taus. Every round bit-exact against eval_partials_plain; the
    device time of each round by kernel_ms, and their sum."""
    from co_zkvms_tpu_torch.ops import field as F
    from co_zkvms_tpu_torch.ops import sumcheck as SC

    n = 1 << nv
    sufs = SC.eq_suffix_tables(F.FR, random_fe(torch, gen, nv, dev))
    for comb in (SC.OUTER, SC.INNER):
        stack = torch.stack([random_fe(torch, gen, n, dev)
                             for _ in range(comb.n_tables)])
        stack[:, 0] = 0
        stack[:, 1] = F.constant(F.FR, F.FR.modulus - 1, dev)
        rounds = []
        for j in range(nv):
            suf = sufs[j] if comb.split_eq else None
            got = SC.eval_partials(F.FR, comb, stack, suf)
            want = SC.eval_partials_plain(F.FR, comb, stack, suf,
                                          blocks=got.shape[0])
            torch.cuda.synchronize()
            if not same(torch, got, want):
                raise AssertionError(f"sc_eval_round {comb.name} round {j} "
                                     f"({stack.shape[1] // 2} pairs): "
                                     "kernel != plain")
            rounds.append(kernel_ms(
                torch, lambda: SC.eval_partials(F.FR, comb, stack, suf), 20,
                ENTRIES[comb.kernel.name]))
            stack = SC.bind_rows(F.FR, stack,
                                 random_fe(torch, gen, 1, dev)[0])
        rec = next(r for r in records if r["name"] == comb.kernel.name)
        rec.update(sumcheck_ms=sum(rounds), sumcheck_rounds_ms=rounds)
        log(f"[kernels] sc_eval_round {comb.name} over a {nv}-round "
            f"sumcheck (2^{nv - 1} .. 1 pairs), every round bit-exact: "
            f"{sum(rounds):.4f} ms device time in {nv} launches; by round: "
            + ", ".join(f"{ms:.4f}" for ms in rounds) +
            f"; {CLOCKS}: {nvidia_smi_line(CLOCKS)}")


# kernels off the provers' path: slice 4 drives and checks them
OFF_PROVER = ("poseidon_permute_t3",)


def poseidon_ms(torch, dev, gen, nv: int) -> float:
    """B12's device time a launch on 2^(nv-2) t = 3 states (slice 4 checks
    permute against the plain version and the composition over B1-B3)."""
    from co_zkvms_tpu_torch.ops import field as F
    from co_zkvms_tpu_torch.ops import poseidon as P

    n = 1 << (nv - 2)
    state = F.to_mont(F.FR, random_fe(torch, gen, 3 * n, dev)).reshape(n, 3, 8)
    ms = kernel_ms(torch, lambda: P.permute(state), 10,
                   ENTRIES[P.POSEIDON_T3.name])
    log(f"[kernels] poseidon_permute_t3 2^{nv - 2} states: device "
        f"{ms:.3f} ms")
    return ms


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def cubic_circuit(builder):
    b = builder(num_public=2)                    # wires [1, y, x, w1, w2]
    x = b.new_wire()
    w1 = b.new_wire()
    w2 = b.new_wire()
    b.add_constraint([(1, x)], [(1, x)], [(1, w1)])
    b.add_constraint([(1, w1)], [(1, x)], [(1, w2)])
    b.add_constraint([(1, w2), (1, x), (5, 0)], [(1, 0)], [(1, 1)])
    return b


def slice_phase(torch, dev, args, records) -> tuple:
    from co_zkvms_tpu_torch.models import spartan
    from co_zkvms_tpu_torch.models.r1cs import R1CSBuilder
    from co_zkvms_tpu_torch.models.synthetic import squaring_chain
    from co_zkvms_tpu_torch.ops import pst13
    from co_zkvms_tpu_torch.utils import build, convert

    nv = args.nv
    t0 = time.perf_counter()
    b = squaring_chain((1 << nv) - 4)
    z = b.solve_witness([3])
    r1cs = b.build()
    t_circuit = time.perf_counter() - t0

    for k in build.KERNELS.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srs = pst13.setup(nv, args.seed, device=dev)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = spartan.SpartanIndex.from_r1cs(r1cs, device=dev)
    torch.cuda.synchronize()
    t_index = time.perf_counter() - t0
    t0 = time.perf_counter()
    proof = spartan.prove(index, srs, z)
    torch.cuda.synchronize()
    t_prove = time.perf_counter() - t0
    launches = {name: k.launches for name, k in build.KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    ok = spartan.verify(index, srs, [3], proof)
    t_verify = time.perf_counter() - t0
    bad = spartan.verify(index, srs, [3], proof._replace(
        va=(proof.va + 1) % spartan.MOD))
    if not ok or bad:
        raise AssertionError(f"verify(proof)={ok} verify(tampered)={bad}")
    missing = [k for k, v in launches.items()
               if v <= 0 and k not in OFF_PROVER]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    log(f"[slice] proof sha256 {proof_digest(proof)}")
    log(f"[slice] squaring_chain(2^{nv} - 4) nv={nv}: circuit+witness "
        f"{t_circuit:.2f} s (host), setup {t_setup:.2f} s, index "
        f"{t_index:.2f} s, prove {t_prove:.2f} s, verify {t_verify:.2f} s "
        f"(host) -> True, "
        f"tampered va -> False; peak device memory "
        f"{peak / 2**30:.2f} GiB; launches {json.dumps(launches)}")

    # references of the repository: the tracked SRS and the CPU plain path
    with open(os.path.join(HERE, ".srs_cache", "srs_10_7.pkl"), "rb") as fh:
        raw = pickle.load(fh)
    want = convert.srs_from_raw(raw, device="cpu")
    got = pst13.setup(10, 7, device=dev)
    for lg, lw in zip(got.ck_levels, want.ck_levels):
        if not (torch.equal(lg.x.cpu(), lw.x) and torch.equal(lg.y.cpu(), lw.y)):
            raise AssertionError("setup(10, 7) on the card != srs_10_7.pkl")
    if got.h_taus != want.h_taus:
        raise AssertionError("setup(10, 7) G2 points != srs_10_7.pkl")
    with open(os.path.join(HERE, ".srs_cache", "srs_3_2.pkl"), "rb") as fh:
        raw3 = pickle.load(fh)
    cubic = cubic_circuit(R1CSBuilder).build()
    zc = [1, 35, 3, 9, 27]
    proofs = []
    for d in (dev, torch.device("cpu")):
        srs3 = convert.srs_from_raw(raw3, device=d)
        proofs.append(spartan.prove(
            spartan.SpartanIndex.from_r1cs(cubic, device=d), srs3, zc))
    if proofs[0] != proofs[1]:
        raise AssertionError("cubic proof on the card != plain CPU proof")
    log("[slice] setup(10, 7) on the card == .srs_cache/srs_10_7.pkl; cubic "
        "circuit proof on the card == plain CPU proof")
    return r1cs, srs, z, proof, index


# ---------------------------------------------------------------------------
# phase 5: slice 2, co-Spartan with zk and the DFS round
# ---------------------------------------------------------------------------


def proof_digest(proof) -> str:
    """sha256 of a proof's repr (NamedTuples of ints): equal digests, equal
    proofs, across trees and runs."""
    import hashlib

    text = repr(proof)
    if "tensor" in text:
        raise AssertionError("a proof holds a tensor: its repr is no digest")
    return hashlib.sha256(text.encode()).hexdigest()


def first_difference(a, b):
    """The first field of two proofs that differs, or None."""
    for field in a._fields:
        if getattr(a, field) != getattr(b, field):
            return field
    return None


def slice2_phase(torch, dev, args, r1cs, z, index, records) -> tuple:
    import random

    from co_zkvms_tpu_torch.models import co_spartan, spartan, spartan_dfs
    from co_zkvms_tpu_torch.ops import msm as M
    from co_zkvms_tpu_torch.ops import pst13, zk
    from co_zkvms_tpu_torch.utils import build

    nv = args.nv
    t0 = time.perf_counter()
    dlog = spartan_dfs.entries(r1cs).dlog
    t_entries = time.perf_counter() - t0
    for k in build.KERNELS.values():
        k.launches = 0
    M.by_value_uses = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srs = pst13.setup(dlog, args.seed, device=dev)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    dfs = spartan_dfs.build_index(r1cs, srs)
    torch.cuda.synchronize()
    t_index = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = zk.from_seed(srs.nv, seed=args.seed, max_deg=4)
    t_params = time.perf_counter() - t0

    t0 = time.perf_counter()
    single = spartan.prove(index, srs, z, dfs=dfs,
                           zk_ctx=(params, random.Random(args.seed)))
    torch.cuda.synchronize()
    t_single = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep3 = co_spartan.prove_rep3(index, srs, z, dfs=dfs,
                                 zk_ctx=(params, random.Random(args.seed)))
    torch.cuda.synchronize()
    t_rep3 = time.perf_counter() - t0
    launches = {name: k.launches for name, k in build.KERNELS.items()}
    by_value = M.by_value_uses
    peak = torch.cuda.max_memory_allocated()
    diff = first_difference(rep3, single)
    if diff is not None:
        raise AssertionError(f"prove_rep3 != single-party proof at {diff}")
    if single.zk is None or single.dfs is None:
        raise AssertionError("the slice-2 proof lacks its zk or dfs part")
    missing = [k for k, v in launches.items()
               if v <= 0 and k not in OFF_PROVER]
    if missing:
        raise AssertionError(f"kernels not launched in slice 2: {missing}")
    if by_value <= 0:
        raise AssertionError("no MSM of slice 2 took the by-value path")
    for rec in records:
        rec["launches_slice2"] = launches[rec["name"]]
    # the index commits tables of small values (0/1 matrix entries, counts):
    # they take the by-value path. A separate commit of val_a, timed after
    # the counts and the peak were read (the prover makes no such commit).
    val_a = dfs.vals[0]
    uses = M.by_value_uses
    ms_val = cuda_ms(torch, lambda: pst13.commit(srs, val_a), 1)
    if M.by_value_uses - uses != 2:
        raise AssertionError("the val_a commit did not take the by-value path")
    by_value_check(torch, dev, args.seed, srs, records)

    def check(proof):
        return spartan.verify(index, srs, [3], proof, dfs_vk=dfs.vk,
                              zk_params=params)

    t0 = time.perf_counter()
    ok = check(rep3)
    t_verify = time.perf_counter() - t0
    bad_va = check(rep3._replace(va=(rep3.va + 1) % spartan.MOD))
    evals = dict(rep3.dfs.evals)
    evals["val_a"] = (evals["val_a"] + 1) % spartan.MOD
    bad_dfs = check(rep3._replace(dfs=rep3.dfs._replace(evals=evals)))
    if not ok or bad_va or bad_dfs:
        raise AssertionError(f"verify(proof)={ok} verify(va + 1)={bad_va} "
                             f"verify(dfs val_a + 1)={bad_dfs}")
    log(f"[slice2] squaring_chain(2^{nv} - 4) nv={nv}, zk + DFS: entries "
        f"domain dlog={dlog} ({t_entries:.2f} s host)")
    log(f"[slice2] setup({dlog}, {args.seed}) {t_setup:.2f} s")
    log(f"[slice2] index (DFS build_index) {t_index:.2f} s; a separate "
        f"commit of val_a (2^{dlog} entries of 0 or 1) takes {ms_val:.1f} ms "
        f"down the by-value path; {by_value} MSMs of the slice took it")
    log(f"[slice2] zk params (host) {t_params:.2f} s")
    log(f"[slice2] prove (single party, zk + dfs) {t_single:.2f} s")
    log(f"[slice2] prove_rep3 (zk + dfs) {t_rep3:.2f} s")
    log(f"[slice2] prove_rep3 == single-party proof, field by field; "
        f"proof sha256 {proof_digest(rep3)}")
    log(f"[slice2] verify {t_verify:.2f} s (host) -> True; va + 1 -> False; "
        f"DFS val_a + 1 -> False")
    log(f"[slice2] peak device memory {peak / 2**30:.2f} GiB")
    log(f"[slice2] launches {json.dumps(launches)}")
    return srs, dfs, params, rep3


def by_value_check(torch, dev, seed: int, srs, records: list) -> None:
    """A 2^nv-entry 0/1 table committed through the by-value path (pst13.
    commit) against the window path on B8 called directly on the same
    table: the same affine point. Both timed by CUDA events."""
    from co_zkvms_tpu_torch.ops import curve as C
    from co_zkvms_tpu_torch.ops import field as F
    from co_zkvms_tpu_torch.ops import msm as M
    from co_zkvms_tpu_torch.ops import pst13

    gen = torch.Generator().manual_seed(seed + 2)
    n = 1 << srs.nv
    bits = torch.randint(0, 2, (n,), generator=gen)
    table = F.from_int(F.FR, bits.numpy(), device=dev)
    uses = M.by_value_uses
    comm, ms_bv = timed(torch, lambda: pst13.commit(srs, table))
    if M.by_value_uses - uses != 1:
        raise AssertionError("the 0/1 table did not take the by-value path")
    pts = srs.level(0)
    std = M.standard_words(table)

    def b8_path():
        sums, c = M.bucket_window_sums(pts, std)
        return M.horner_affine_ints(C.points_to_ints(C.to_affine(sums)), c)

    xy, ms_b8 = timed(torch, b8_path)
    if comm.xy != xy:
        raise AssertionError("by-value commit != the B8 window path's point")
    log(f"[slice2] a 2^{srs.nv}-entry 0/1 table (seed {seed + 2}): by-value "
        f"commit {ms_bv:.1f} ms == the B8 window path's point "
        f"({ms_b8:.1f} ms), affine, bit for bit")
    for rec in records:
        if rec["name"] == M.MSM_BUCKET.name:
            rec["skewed_01_table"] = {"entries": n, "by_value_ms": ms_bv,
                                      "window_path_ms": ms_b8}


# ---------------------------------------------------------------------------
# phase 5: where the prove's time goes
# ---------------------------------------------------------------------------


def profile_phase(torch, dev, r1cs, srs, z, want) -> None:
    from co_zkvms_tpu_torch.models import spartan

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        index = spartan.SpartanIndex.from_r1cs(r1cs, device=dev)
        proof = spartan.prove(index, srs, z)
        torch.cuda.synchronize()
    if proof != want:
        raise AssertionError("profiled prove != the slice's proof")
    report_profile(prof.events(), "spartan", "profile")


def profile_index_phase(torch, r1cs, srs, want) -> None:
    """Slice 2's DFS build_index again under the profiler: its wall time,
    the device's busy time and idle share, and its kernels by device time.
    The commitments must equal the slice's."""
    from co_zkvms_tpu_torch.models import spartan_dfs
    from co_zkvms_tpu_torch.utils import phases

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        dfs = spartan_dfs.build_index(r1cs, srs)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if dfs.comms != want.comms:
        raise AssertionError("profiled build_index != the slice's index")
    events = prof.events()
    busy = phases.union_length(phases.device_intervals(events)) / 1e6
    log(f"[profile3] DFS build_index under torch.profiler: {wall:.2f} s, "
        f"device busy {busy:.4f} s (idle {100 * (1 - busy / wall):.1f} %)")
    report_device_work(events, "profile3")


def profile_rep3_phase(torch, dev, index, z, seed, srs, dfs, params,
                       want) -> None:
    """prove_rep3 (zk + dfs) of slice 2 again under the profiler, by its
    co_spartan.<phase> ranges."""
    import random

    from co_zkvms_tpu_torch.models import co_spartan

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        proof = co_spartan.prove_rep3(index, srs, z, dfs=dfs,
                                      zk_ctx=(params, random.Random(seed)))
        torch.cuda.synchronize()
    if proof != want:
        raise AssertionError("profiled prove_rep3 != the slice-2 proof")
    report_profile(prof.events(), "co_spartan", "profile2")


# ---------------------------------------------------------------------------
# phase 7: Poseidon (B12), the NTT, Shamir and Rep3 point shares
# ---------------------------------------------------------------------------

# B12 per state, with sparse partial rounds (the least work known for the
# function): 438 Montgomery products and 162 squares (x^5 is square, square,
# multiply; 8 full rounds of a 3 x 3 product, 57 partial rounds of 5
# products). The dense schedule, 65 rounds of a 3 x 3 product: 666 and 162.
POSEIDON_T3_OPS = 438 * MUL_OPS + 162 * SQR_OPS
POSEIDON_T3_DENSE_OPS = 666 * MUL_OPS + 162 * SQR_OPS


def timed(torch, fn):
    """(fn(), ms) of one run, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def slice4_phase(torch, dev, args, records, ms: float, regs) -> None:
    from co_zkvms_tpu_torch.ops import curve as C
    from co_zkvms_tpu_torch.ops import field as F
    from co_zkvms_tpu_torch.ops import msm as M
    from co_zkvms_tpu_torch.ops import ntt as N
    from co_zkvms_tpu_torch.ops import poseidon as P
    from co_zkvms_tpu_torch.ops import ref_bn254 as bn
    from co_zkvms_tpu_torch.parallel import pointshares as PS
    from co_zkvms_tpu_torch.parallel import shamir as Sh
    from co_zkvms_tpu_torch.parallel import shares as S
    from co_zkvms_tpu_torch.utils import build

    FR = F.FR
    nv = args.nv
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(args.seed + 4)
    dgen = torch.Generator(device=dev).manual_seed(args.seed + 4)
    n_hash, n_leaves, n_small = 1 << (nv - 2), 1 << nv, 1 << (nv - 4)
    n_pts = 1 << (nv - 10)

    def fe(count):
        return F.to_mont(FR, random_fe(torch, gen, count, dev))

    # inputs, made before the counts are zeroed
    a, b, leaves = fe(n_hash), fe(n_hash), fe(n_leaves)
    wide = {t: fe(n_small * t).reshape(n_small, t, 8) for t in (4, 5)}
    poly, poly10, secrets, coeffs = fe(n_leaves), fe(1 << 10), \
        fe(n_leaves), fe(n_pts)
    g = C.points_from_ints([bn.g1_coords(bn.G1_GEN)], device=dev)
    g1 = C.APoint(g.x[0], g.y[0])
    pts = M.fixed_base_msm(g1, fe(n_pts))
    bases = C.to_affine(M.fixed_base_msm(g1, fe(n_pts)))
    absorbed = [3, 1 << 200, FR.modulus - 1]
    fes = [F.from_int(FR, v, device=dev) for v in absorbed]
    small = [F.from_int(FR, v, device=dev) for v in
             ([1, 2, 0, 0, 0, 0, 0, 0], [3, 4, 0, 0, 0, 0, 0, 0])]
    torch.cuda.synchronize()

    for k in build.KERNELS.values():
        k.launches = 0
    wall = {}

    def run(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        return out

    def merkle():
        levels = [leaves]
        while levels[-1].shape[0] > 1:
            levels.append(P.merkle_layer(levels[-1]))
        return levels

    def transcript():
        st = P.transcript_init(b"chip_smoke", device=dev)
        out = []
        for x in fes:
            st = P.transcript_absorb(st, x)
            st, ch = P.transcript_challenge(st)
            out.append(ch)
        return torch.stack(out)

    hashes = run("hash2", lambda: P.hash2(a, b))
    levels = run("merkle", merkle)
    challenges = run("transcript", transcript)
    permuted = {t: run(f"t{t}", lambda t=t: P.permute(wide[t]))
                for t in (4, 5)}
    back = run("ntt", lambda: N.intt(FR, N.ntt(FR, poly)))
    dft10 = N.ntt(FR, poly10)
    prod = N.mul_polys(FR, *small)
    shares = run("shamir_share", lambda: Sh.share(FR, dgen, secrets, 2, 5))
    subsets = ([1, 2, 3], [2, 4, 5], [1, 3, 5])
    recs = run("shamir_reconstruct", lambda: [Sh.reconstruct(
        FR, shares[[i - 1 for i in ids]], ids) for ids in subsets])
    pshares = run("point_share", lambda: Sh.share_point(gen, pts, 1, 3))
    prec = run("point_reconstruct", lambda: [Sh.reconstruct_point(
        C.index(pshares, [i - 1 for i in ids]), ids)
        for ids in ([1, 2], [2, 3], [1, 3])])
    rep3 = run("rep3_points", lambda: PS.combine(PS.share(gen, pts)))
    msm3 = run("msm_shares", lambda: PS.combine(PS.msm_shares(
        bases, S.share(FR, dgen, coeffs))))
    launches = {name: k.launches for name, k in build.KERNELS.items()}
    t_path = time.perf_counter() - t_phase
    need = ("poseidon_permute_t3", "fp_mul", "fp_add", "fp_sub", "g1_add",
            "g1_double", "msm_bucket_accumulate")
    missing = [k for k in need if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched in slice 4: {missing}")
    for rec in records:
        rec["launches_slice4"] = launches[rec["name"]]

    def check(ok, what):
        if not ok:
            raise AssertionError(f"slice4: {what}")

    # B12 against its plain version, and against the t = 3 composition
    # over the field kernels on the 2^18 hash states
    s16 = torch.stack([a[:n_small], b[:n_small], leaves[:n_small]], dim=1)
    got16 = P.permute(s16)
    want16, plain_ms = timed(torch, lambda: P.permute_plain(s16))
    check(torch.equal(got16, want16),
          f"B12 != permute_plain on 2^{nv - 4} states")
    cap = F.from_int(FR, 2, device=dev).expand(n_hash, 1, 8)
    state = torch.cat([cap, torch.stack([a, b], dim=1)], dim=1)
    full = P.permute(state)
    check(torch.equal(full[:, 1], hashes), "hash2 != permute(state)[1]")
    composed, composed_ms = timed(torch, lambda: P.permute_composed(state))
    check(torch.equal(full, composed), "B12 != the B1-B3 composition")
    ms_events = cuda_ms(torch, lambda: P.permute(state), 10)
    hash_ms = cuda_ms(torch, lambda: P.hash2(a, b), 10)
    idx = torch.randint(0, n_hash, (64,), generator=gen).tolist()
    ia, ib, ih = (F.to_int(FR, x[idx]).tolist() for x in (a, b, hashes))
    check(all(P.host_hash([x, y]) == h for x, y, h in zip(ia, ib, ih)),
          "hash2 != host_hash on 64 samples")
    nbytes = 2 * 3 * ELEM * n_hash + P.t3_constant_words().nbytes
    rec = record(P.POSEIDON_T3, "co_zkvms_tpu_torch/ops/csrc/poseidon.cu",
                 ms, plain_ms, nbytes, POSEIDON_T3_OPS * n_hash,
                 note=f"plain_ms on 2^{nv - 4} states; ms on 2^{nv - 2}")
    rec["launches"] = rec["launches_slice4"] = launches[P.POSEIDON_T3.name]
    rec["launches_of"] = "slice4"
    rec["ms_events"] = ms_events
    rec["bound_dense_ms"], _ = bound(nbytes, POSEIDON_T3_DENSE_OPS * n_hash)
    rec.update(registers_of(regs, P.POSEIDON_T3.name))
    records.append(rec)

    # Merkle: every node of the top 10 levels, 8 of each lower level
    n_checked = 0
    for lvl in range(1, len(levels)):
        size = levels[lvl].shape[0]
        rows = list(range(size)) if size <= 512 else torch.randint(
            0, size, (8,), generator=gen).tolist()
        kids = F.to_int(FR, levels[lvl - 1][[2 * r + j for r in rows
                                              for j in (0, 1)]]).tolist()
        nodes = F.to_int(FR, levels[lvl][rows]).tolist()
        for r, node in enumerate(nodes):
            check(P.host_hash(kids[2 * r: 2 * r + 2]) == node,
                  f"Merkle level {lvl} node {rows[r]}")
        n_checked += len(rows)
    check(levels[-1].shape[0] == 1 and len(levels) == nv + 1,
          "Merkle levels")

    host = P.HostPoseidonTranscript(b"chip_smoke")
    want = []
    for v in absorbed:
        host.absorb(v)
        want.append(host.challenge())
    check(F.to_int(FR, challenges).tolist() == want,
          "transcript != HostPoseidonTranscript")
    for t, out in permuted.items():
        rows = torch.randint(0, n_small, (8,), generator=gen).tolist()
        ins = F.to_int(FR, wide[t][rows]).tolist()
        outs = F.to_int(FR, out[rows]).tolist()
        check(all(P.host_permute(x) == y for x, y in zip(ins, outs)),
              f"t = {t} != host_permute")
    check(torch.equal(back, poly), f"intt(ntt(x)) != x at 2^{nv}")
    vals = F.to_int(FR, poly10).tolist()
    w = N.two_adic_root(FR, 10)
    pw = [pow(w, k, FR.modulus) for k in range(1 << 10)]
    dft = [sum(v * pw[(i * k) & 1023] for i, v in enumerate(vals))
           % FR.modulus for k in range(1 << 10)]
    check(F.to_int(FR, dft10).tolist() == dft, "NTT 2^10 != host DFT")
    check(F.to_int(FR, prod).tolist() == [3, 10, 8, 0, 0, 0, 0, 0],
          "mul_polys")
    ntt_ms = cuda_ms(torch, lambda: N.ntt(FR, poly), 3)
    check(all(torch.equal(r, secrets) for r in recs), "Shamir reconstruct")
    want_pts = C.to_affine(pts)

    def same_points(p):
        q = C.to_affine(p)
        return torch.equal(q.x, want_pts.x) and torch.equal(q.y, want_pts.y)

    check(all(same_points(p) for p in prec), "Shamir point reconstruct")
    check(same_points(rep3), "Rep3 point shares do not combine to the point")
    check(C.points_to_ints(C.to_affine(msm3)) == C.points_to_ints(
        C.to_affine(M.msm(bases, coeffs))),
          "combine(msm_shares) != msm of the opened coefficients")

    log(f"[slice4] B12 poseidon_permute_t3 bit-exact against permute_plain "
        f"on 2^{nv - 4} states and against the t = 3 composition over "
        f"B1-B3 on 2^{nv - 2} states ({composed_ms:.1f} ms); 64 hash2 "
        f"samples == host_hash")
    log(f"[slice4] hash2 over 2^{nv - 2} pairs: {hash_ms:.3f} ms, "
        f"{n_hash / (hash_ms / 1e3):,.0f} hashes/s; B12 device {ms:.3f} ms "
        f"a launch (kernel phase; CUDA events {ms_events:.3f} ms; plain "
        f"{plain_ms:.1f} ms on 2^{nv - 4}), bound {rec['bound_ms']:.4f} ms sparse "
        f"({rec['bound_by']}), {100 * rec['bound_ms'] / ms:.1f} % of it; "
        f"dense schedule's bound {rec['bound_dense_ms']:.4f} ms; "
        f"{rec['registers']} registers, {rec['spill_stores']} bytes spill "
        "stores")
    log(f"[slice4] Merkle root over 2^{nv} leaves: {len(levels) - 1} "
        f"merkle_layer calls, {n_leaves - 1} hashes in "
        f"{wall['merkle']:.3f} s; {n_checked} nodes == host_hash")
    log(f"[slice4] transcript: {len(absorbed)} absorbs and challenges == "
        f"HostPoseidonTranscript ({wall['transcript']:.3f} s)")
    log(f"[slice4] t = 4, 5 on 2^{nv - 4} states: {wall['t4']:.3f} s, "
        f"{wall['t5']:.3f} s; 8 samples each == host_permute")
    log(f"[slice4] NTT 2^{nv}: ntt {ntt_ms:.2f} ms "
        f"({n_leaves / (ntt_ms / 1e3):,.0f} elements/s); ntt + intt "
        f"{wall['ntt']:.3f} s, intt(ntt(x)) == x; 2^10 == host DFT; "
        f"mul_polys (1 + 2t)(3 + 4t) ok")
    log(f"[slice4] Shamir 2^{nv} secrets (t = 2, n = 5): share "
        f"{wall['shamir_share']:.3f} s, reconstruct from 3 subsets "
        f"{wall['shamir_reconstruct']:.3f} s, all == secrets; "
        f"2^{nv - 10} points (t = 1, n = 3): share "
        f"{wall['point_share']:.3f} s, reconstruct from 3 subsets "
        f"{wall['point_reconstruct']:.3f} s, == points")
    log(f"[slice4] Rep3 point shares of 2^{nv - 10} points combine to them "
        f"({wall['rep3_points']:.3f} s); combine(msm_shares) == msm "
        f"({wall['msm_shares']:.3f} s)")
    log(f"[slice4] launches {json.dumps(launches)}")
    log(f"[slice4] path {t_path:.1f} s, phase "
        f"{time.perf_counter() - t_phase:.1f} s")


def report_profile(events, model: str, tag: str) -> None:
    from co_zkvms_tpu_torch.utils import phases

    rows, idle = phases.phase_table(events, model=model)
    if idle is None:
        log(f"[{tag}] the profiler recorded no device work: device busy "
            "time and idle share not measured")
    else:
        log(f"[{tag}] {model}.prove under torch.profiler: device idle "
            f"{100 * idle:.1f} % of the prove (busy = union of "
            f"kernel/memcpy/memset intervals)")
    for row in rows:
        log(f"[{tag}]   {row.name:12s} host {row.host_s:8.4f} s   "
            f"device busy {row.device_s:8.4f} s")
    report_device_work(events, tag)


G1_AND_B8 = ("g1_add_mixed", "g1_add", "g1_double", "g1_add_incomplete",
             "msm_bucket_accumulate")


def report_device_work(events, tag: str) -> None:
    """The eight kernel names with the most device time in ``events``, the
    port's G1 and B8 kernels below them, B8's total (all its passes), B6's,
    and B9's for each comb."""
    from co_zkvms_tpu_torch.utils import phases

    per_kernel = {}
    for e in events:
        if phases.is_device_work(e):
            tot, cnt = per_kernel.get(e.name, (0.0, 0))
            per_kernel[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    log(f"[{tag}]   device work: {sum(c for _, c in per_kernel.values())} "
        f"events of {len(per_kernel)} names, by device time:")
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    for key, (us, cnt) in ranked[:8]:
        log(f"[{tag}]   {us / 1e3:10.2f} ms {cnt:7d} x  {key[:80]}")
    for key, (us, cnt) in ranked[8:]:
        if any(is_entry(key, ENTRIES[k]) for k in G1_AND_B8):
            log(f"[{tag}]   {us / 1e3:10.2f} ms {cnt:7d} x  {key[:80]}")
    for label, name in (("B8 msm_bucket_accumulate, all passes",
                         "msm_bucket_accumulate"),
                        ("B6 g1_double", "g1_double"),
                        ("B9 sc_eval_round_outer", "sc_eval_round_outer"),
                        ("B9 sc_eval_round_inner", "sc_eval_round_inner")):
        got = [v for key, v in per_kernel.items()
               if is_entry(key, ENTRIES[name])]
        log(f"[{tag}]   {label}: {sum(us for us, _ in got) / 1e3:.2f} ms "
            f"device time in {sum(c for _, c in got)} launches")


if __name__ == "__main__":
    sys.exit(main())
