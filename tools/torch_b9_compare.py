#!/usr/bin/env python3
"""B9, the sumcheck round-message kernel, of the port under ``--root``,
measured by chip_smoke.py's own phases, so that two trees of the port are
measured by one code in one run on the card:

- chip_smoke.b9_over_sumcheck: each comb at every round of one nv-round
  sumcheck (round 1 is the first-round shape), every round bit-exact
  against the tree's plain version, the device time of each round;
- chip_smoke.slice_phase: slice 1 (setup, index, prove, verify, tampered
  proof rejected, the proof's sha256), then profile_phase: its prove under
  torch.profiler, with B9's device time and launches by comb;
- chip_smoke.slice2_phase: slice 2, zk + DFS, single-party and Rep3 (equal,
  verified, tampered copies rejected, the proof's sha256).

A tree's kernels may spell B9's device functions otherwise than this
tree's ENTRIES: the spelling is read from one profiled launch of each comb
and put into chip_smoke's ENTRIES first.

Usage, on a machine with a CUDA card:

    python3 tools/torch_b9_compare.py [--root DIR] [--nv 20] [--seed 7]

``--root`` is a directory that holds a co_zkvms_tpu_torch package (by
default this tree); the last line is one JSON object with B9's numbers.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke():
    """This tree's chip_smoke.py as a module (a --root tree has its own)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def b9_spellings(torch, cs, dev) -> dict:
    """{kernel name: (entry,)} for each B9 comb, the entry as entry_key
    spells the profiler's name of the one device function it launches."""
    from co_zkvms_tpu_torch.ops import field as F
    from co_zkvms_tpu_torch.ops import sumcheck as SC
    from co_zkvms_tpu_torch.utils import phases

    gen = torch.Generator().manual_seed(3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for comb in (SC.OUTER, SC.INNER):
        stack = torch.stack([cs.random_fe(torch, gen, 256, dev)
                             for _ in range(comb.n_tables)])
        suf = cs.random_fe(torch, gen, 128, dev) if comb.split_eq else None
        SC.eval_partials(F.FR, comb, stack, suf)
        torch.cuda.synchronize()
        keys = set()
        for _ in range(cs.PROFILER_TRIES):
            with torch.profiler.profile(activities=acts) as prof:
                SC.eval_partials(F.FR, comb, stack, suf)
                torch.cuda.synchronize()
            keys = {cs.entry_key(e.name) for e in prof.events()
                    if phases.is_device_work(e) and "eval_kernel" in e.name}
            if keys:
                break
        if len(keys) != 1:
            raise AssertionError(f"{comb.name}: device functions {keys}")
        key = keys.pop()
        out[comb.kernel.name] = (
            key[key.index("eval_kernel<"):key.index(">(") + 1],)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--nv", type=int, default=20)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("torch_b9_compare: no CUDA device", file=sys.stderr)
        return 2
    cs = load_chip_smoke()
    import co_zkvms_tpu_torch
    from co_zkvms_tpu_torch.ops import sumcheck as SC
    from co_zkvms_tpu_torch.utils import build

    pkg = os.path.dirname(os.path.abspath(co_zkvms_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise AssertionError(f"imported the port from {pkg}, not {root}")
    dev = torch.device("cuda")
    cs.log(f"[compare] port from {root}; {torch.cuda.get_device_name(0)}; "
           f"nvidia-smi: {cs.nvidia_smi_line()}")
    build.build_all()
    spell = b9_spellings(torch, cs, dev)
    cs.ENTRIES.update(spell)
    cs.log(f"[compare] B9 device functions: {json.dumps(spell)}")
    records = [{"name": comb.kernel.name} for comb in (SC.OUTER, SC.INNER)]
    cs.b9_over_sumcheck(torch, dev, torch.Generator().manual_seed(1),
                        args.nv, records)
    r1cs, srs, z, proof, index = cs.slice_phase(torch, dev, args, [])
    cs.profile_phase(torch, dev, r1cs, srs, z, proof)
    cs.slice2_phase(torch, dev, args, r1cs, z, index, [])
    print(json.dumps({"root": root, "b9": records}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
