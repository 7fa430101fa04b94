"""Named phases of the prover, and their times from one profiled run.

``models.spartan`` and ``models.co_spartan`` mark their phases with
``phase(name, model)``: a ``torch.profiler.record_function`` range named
``<model>.<name>``, which costs next to nothing when no profiler is
running. ``phase_table`` reads one ``torch.profiler.profile`` run of the
real prover: for each range of one model, its host time (the range on the
host clock) and the device's busy time inside it, and for the whole run
the device's idle share.

Device busy time is the union of the intervals of the device's own work
(kernels, memcpy and memset), clipped to the range. Operator and annotation
rows that only mirror that work (``aten::index`` beside its gather kernel,
``gpu_user_annotation``) are left out, so no interval counts twice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.autograd import DeviceType

MODELS = ("spartan", "co_spartan")
PREFIXES = tuple(m + "." for m in MODELS)
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
OVERHEAD = ("Activity Buffer Request",)


def phase(name: str, model: str = "spartan"):
    """A profiler range ``<model>.<name>`` around a phase of a prover."""
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}")
    return torch.profiler.record_function(f"{model}.{name}")


class PhaseRow(NamedTuple):
    name: str
    host_s: float
    device_s: float


def union_length(intervals) -> float:
    """Total length covered by ``(start, end)`` intervals."""
    total = 0.0
    cur_start = cur_end = None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def _clipped(intervals, start, end):
    return [(max(s, start), min(e, end)) for s, e in intervals
            if e > start and s < end]


def is_device_work(e) -> bool:
    """A kernel, memcpy or memset event of the profile."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind in DEVICE_WORK
    # torch releases whose events carry no activity type: the device-side
    # events that are neither annotations nor the profiler's own overhead
    return (e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(PREFIXES)
            and e.name not in OVERHEAD)


def device_intervals(events) -> list:
    """(start, end) in us of every kernel, memcpy and memset event."""
    return [(e.time_range.start, e.time_range.end) for e in events
            if is_device_work(e)]


def phase_table(events, outer: str = "prove", model: str = "spartan"):
    """Rows for every ``<model>.*`` host range, in order of start, and the
    idle share of the ``<model>.<outer>`` ranges (None when the profile
    holds no device work: busy time not measured).

    ``events``: ``prof.events()`` of a ``torch.profiler.profile`` run."""
    prefix = model + "."
    ranges = sorted(
        (e for e in events
         if e.name.startswith(prefix) and e.device_type == DeviceType.CPU),
        key=lambda e: e.time_range.start)
    work = device_intervals(events)
    rows = []
    outer_wall = outer_busy = 0.0
    for e in ranges:
        start, end = e.time_range.start, e.time_range.end
        busy = union_length(_clipped(work, start, end))
        name = e.name[len(prefix):]
        rows.append(PhaseRow(name, (end - start) / 1e6, busy / 1e6))
        if name == outer:
            outer_wall += end - start
            outer_busy += busy
    idle = None
    if work and outer_wall > 0:
        idle = 1.0 - outer_busy / outer_wall
    return rows, idle
