"""Multi-scalar multiplication: Pippenger with buckets over sorted digits.

Per window of c bits, the point indices are sorted by digit (``torch.sort``,
glue, as ``lax.sort`` is outside the TPU kernel), so every bucket is a
contiguous run; ``bucket_accumulate`` (kernel B8, ``ops/csrc/msm_bucket.cu``)
sums each run with the complete mixed add, one thread a fixed run of
``BUCKET_RUN`` sorted points whatever the bucket sizes, the pieces of a
bucket cut by a run's edge folded by merge passes. The top window, which
holds only 254 mod c bits, is first spread over all 2^c buckets by point
group and folded back with complete adds (``_top_regroup``, as in the JAX
package).
The weighted bucket sum sum_b b * S_b runs on the device with the JAX
package's digit split: two marginal trees of incomplete adds (B7), two
double suffix scans (B7 then the complete add B5, because the second scan
adds equal points whenever a run of buckets is empty), then doublings (B6).
The few window sums meet on the host, where a Horner pass over Python ints
combines them, as in the JAX package's ``_horner_affine_ints``.

Small-valued scalars (0/1 tables, counter polynomials) take the JAX
package's by-value path instead (``_by_value_sums``): Pippenger's bucket
occupancy equals a value's multiplicity there, so a few buckets would hold
most of the points. The points are grouped by value first, a
segmented sum in ceil(log2 N) full-width incomplete adds (B7), and the
window path then runs over the at most ``u_bound`` group sums, whose
values are distinct. ``by_value_gate`` holds the reference's condition.

As in the JAX package, the incomplete adds (the merge trees and the
by-value levels) assume the points are independent bases (an SRS): two
disjoint subset sums of them never coincide, short of a discrete-log
relation.

Not ported, because they work around TPU limits: the dense [R, 16, nb]
grid, the quantised grid depths, the host-gating phases and the
digit-buffer budget. Any correct MSM gives the same point.
"""

from __future__ import annotations

import ctypes

import torch

from . import curve as C
from . import field as F
from .curve import APoint, JPoint
from .field import FQ, FR
from ..utils import build

SCALAR_BITS = 254


def n_windows(c: int) -> int:
    return (SCALAR_BITS + c - 1) // c


def auto_c(n: int) -> int:
    """Window bits for n points: about 4 points per bucket, c in [2, 16]
    (capped at 16, so 2^20 points get 16 a bucket)."""
    return max(2, min(16, n.bit_length() - 1 - 2))


def standard_words(scalars_mont) -> torch.Tensor:
    """Montgomery Fr scalars [N, 8] -> standard-form words int64 [N, 8]."""
    return F.as_u32(F.from_mont(FR, scalars_mont))


def window_digits(scalars_mont, c: int) -> torch.Tensor:
    """Montgomery Fr scalars [N, 8] -> window digits int64 [n_windows, N]."""
    return _digits_of_words(standard_words(scalars_mont), c)


def _digits_of_words(std, c: int) -> torch.Tensor:
    """Standard-form words int64 [N, 8] -> window digits [n_windows, N]."""
    if not 1 <= c <= 16:
        raise ValueError(f"window bits must be in [1, 16], got {c}")
    mask = (1 << c) - 1
    outs = []
    for w in range(n_windows(c)):
        bit0 = w * c
        limb, off = bit0 // 32, bit0 % 32
        d = std[:, limb] >> off
        if off + c > 32 and limb + 1 < 8:
            d = d | (std[:, limb + 1] << (32 - off))
        outs.append(d & mask)
    return torch.stack(outs, dim=0)


def sort_windows(digits: torch.Tensor, c: int):
    """Point indices sorted by digit per window, and bucket starts.

    Returns (order int32 [nw, N], starts int32 [nw, 2^c + 1]): bucket b of
    window w is order[w, starts[w, b]:starts[w, b + 1]]."""
    nw = digits.shape[0]
    sorted_d, order = torch.sort(digits, dim=1, stable=True)
    bounds = torch.arange((1 << c) + 1, dtype=sorted_d.dtype,
                          device=digits.device).expand(nw, -1).contiguous()
    starts = torch.searchsorted(sorted_d, bounds)
    return order.to(torch.int32), starts.to(torch.int32)


# ---------------------------------------------------------------------------
# B8: bucket accumulation
# ---------------------------------------------------------------------------

# T: the sorted positions (pass 1) or carries (merge passes) that one B8
# thread folds; the fastest of BUCKET_RUNS on the H100 at every shape
# chip_smoke.py times (PERF.md)
BUCKET_RUN = 16
BUCKET_RUNS = (16, 32, 64)

_P = ctypes.c_void_p
_I = ctypes.c_int
MSM_BUCKET = build.KernelFn(
    "msm_bucket_accumulate", "msm_bucket", "msm_bucket_pass",
    [_P] * 11 + [_I, _I, ctypes.c_longlong, _I, _I, _I, _P],
    replaces="co_zkvms_tpu/ops/curve_pallas.py:320")


def bucket_passes(n: int, run: int) -> list:
    """Input length, per window, of each pass of B8: [n, L1, L2, ...].

    Pass 1 cuts a window's n sorted positions into chunks of ``run``; each
    chunk leaves two carry slots, so the next pass takes 2 ceil(L / run)
    entries. The pass whose input fits in one chunk (L <= run) is the last.
    The lists shrink only for run >= 4."""
    if run < 4:
        raise ValueError(f"B8 folds runs of at least 4, got {run}")
    lens = [n]
    while lens[-1] > run:
        lens.append(2 * -(-lens[-1] // run))
    return lens


def _walk_plain(keys, point_at, add, out: JPoint, final: bool):
    """One pass of B8's schedule for every chunk at once: the walk of
    ``ops/csrc/msm_bucket.cuh`` (``walk_points`` / ``walk_carries``), step
    t taking the t-th entry of each chunk.

    ``keys``: int64 [R, S], the bucket key of each entry of R chunks (-1:
    skipped); ``point_at(t)``: the entries' points at step t; ``add(acc,
    q)``: the pass's complete add; ``out``: the bucket sums, coordinates
    [nw nb, 8], written in place. Returns the chunks' carry slots (keys
    [R, 2], JPoint [R, 2]), or None for the final pass."""
    rows, steps = keys.shape
    dev = keys.device
    inf = C.infinity((rows,), dev)
    acc = inf
    cur = torch.full((rows,), -1, dtype=torch.int64, device=dev)
    closed = torch.zeros(rows, dtype=torch.bool, device=dev)  # one so far
    ckey = torch.full((rows, 2), -1, dtype=torch.int64, device=dev)
    cpts = C.infinity((rows, 2), dev)

    def direct(mask):
        for dst, src in zip(out, acc):
            dst[cur[mask]] = src[mask]

    def slot(mask, s):
        ckey[mask, s] = cur[mask]
        for dst, src in zip(cpts, acc):
            dst[mask, s] = src[mask]

    for t in range(steps):
        k = keys[:, t]
        valid = k >= 0
        new = valid & (k != cur)
        ends = new & (cur >= 0)              # a segment closes before t
        if final:
            direct(ends)
        else:
            direct(ends & closed)
            slot(ends & ~closed, 0)
        closed |= ends
        acc = C.select(new, inf, acc)
        cur = torch.where(valid, k, cur)
        acc = C.select(valid, add(acc, point_at(t)), acc)
    live = cur >= 0
    if final:
        direct(live)
        return None
    slot(live & ~closed, 0)
    slot(live & closed, 1)
    return ckey, cpts


def _chunk_positions(length: int, run: int, device):
    """Entry index of each step of each chunk, [chunks, S] with S = min(run,
    length), and the mask of those below ``length``."""
    chunks = -(-length // run)
    steps = min(run, length)
    pos = (torch.arange(chunks, device=device)[:, None] * run +
           torch.arange(steps, device=device)[None, :])
    return pos, pos < length


def _points_pass_plain(points: APoint, order, starts, run, out, final):
    """Pass 1 of B8 over the sorted points of every window."""
    nw, n = order.shape
    nb = starts.shape[1] - 1
    dev = order.device
    pos, inside = _chunk_positions(n, run, dev)
    chunks, steps = pos.shape
    pos = pos.reshape(-1).clamp(max=n - 1)
    inside = inside.reshape(-1)
    bounds = starts.to(torch.int64)
    bucket = torch.searchsorted(bounds, pos.expand(nw, -1).contiguous(),
                                right=True) - 1
    valid = inside[None] & (pos[None] >= bounds[:, 1:2])   # digit 0 dropped
    base = torch.arange(nw, device=dev)[:, None] * nb
    keys = torch.where(valid, base + bucket, -1).reshape(nw * chunks, steps)
    idx = order.to(torch.int64)[:, pos].reshape(nw * chunks, steps)
    return _walk_plain(keys, lambda t: APoint(points.x[idx[:, t]],
                                              points.y[idx[:, t]]),
                       C.add_mixed_plain, out, final)


def _merge_pass_plain(ckey, cpts: JPoint, run, out, final):
    """A merge pass of B8 over carry lists (keys [nw, L], JPoint [nw, L])."""
    nw, length = ckey.shape
    pos, inside = _chunk_positions(length, run, ckey.device)
    chunks, steps = pos.shape
    pos, inside = pos.reshape(-1).clamp(max=length - 1), inside.reshape(-1)
    keys = torch.where(inside[None], ckey[:, pos], -1)
    keys = keys.reshape(nw * chunks, steps)
    pts = JPoint(*(c[:, pos].reshape(nw * chunks, steps, F.NLIMBS)
                   for c in cpts))
    # the entry is the first operand (msm_bucket.cuh walk_carries)
    return _walk_plain(keys, lambda t: C.index(pts, (slice(None), t)),
                       lambda acc, e: C.add_plain(e, acc), out, final)


def bucket_accumulate_plain(points: APoint, order, starts,
                            run: int | None = None) -> JPoint:
    """Plain version of B8, on the kernel's schedule: the same chunks of
    ``run`` entries (None: the kernel's ``BUCKET_RUN``), the same carries
    and the same merge passes (``bucket_passes``), each pass vectorised
    over its chunks, so that the kernel's Jacobian coordinates equal these
    bit for bit. Bucket (w, b) is the sum of order[w, starts[w, b]:
    starts[w, b + 1]]; bucket 0 and empty buckets are infinity."""
    run = BUCKET_RUN if run is None else run
    nw, nb = starts.shape[0], starts.shape[1] - 1
    n = order.shape[1]
    lens = bucket_passes(n, run)
    out = C.infinity((nw * nb,), points.x.device)
    if n:
        carries = _points_pass_plain(points, order, starts, run, out,
                                     len(lens) == 1)
        for k in range(1, len(lens)):
            ckey, cpts = carries
            carries = _merge_pass_plain(
                ckey.reshape(nw, lens[k]),
                JPoint(*(c.reshape(nw, lens[k], F.NLIMBS) for c in cpts)),
                run, out, k == len(lens) - 1)
    return JPoint(*(c.reshape(nw, nb, F.NLIMBS) for c in out))


def bucket_accumulate(points: APoint, order, starts) -> JPoint:
    """Bucket sums [nw, nb] for sorted windows (kernel B8 on cuda, in
    ``len(bucket_passes(N, BUCKET_RUN))`` launches)."""
    if F.on_cpu(points.x, points.y, order, starts):
        return bucket_accumulate_plain(points, order, starts)
    return bucket_accumulate_run(points, order, starts, BUCKET_RUN)


def bucket_accumulate_run(points: APoint, order, starts, run: int) -> JPoint:
    """B8 on cuda tensors with a run of ``run`` (one of BUCKET_RUNS): one
    launch a pass of ``bucket_passes``. The carry lists live in two
    scratch buffers that the passes use in turn."""
    if run not in BUCKET_RUNS:
        raise ValueError(f"B8 runs are {BUCKET_RUNS}, got {run}")
    nw, nb = starts.shape[0], starts.shape[1] - 1
    n = order.shape[1]
    for t, dt in ((points.x, torch.int32), (points.y, torch.int32),
                  (order, torch.int32), (starts, torch.int32)):
        if t.dtype != dt or not t.is_contiguous():
            raise TypeError("bucket_accumulate takes contiguous int32 tensors")
        if t.device.type != "cuda":
            raise ValueError("bucket_accumulate_run takes cuda tensors")
    if points.x.shape != (n, F.NLIMBS) or points.y.shape != (n, F.NLIMBS):
        raise ValueError("points and order disagree on N")
    dev = points.x.device
    out = [torch.empty((nw, nb, F.NLIMBS), dtype=torch.int32, device=dev)
           for _ in range(3)]
    lens = bucket_passes(n, run)
    # carries of pass k go to buffer k % 2: the largest lists are L1, L2
    bufs = [(torch.empty((nw * size,), dtype=torch.int32, device=dev),
             torch.empty((nw * size, 24), dtype=torch.int32, device=dev))
            for size in lens[1:3]]
    null = None
    for k, length in enumerate(lens):
        final = k == len(lens) - 1
        src = bufs[(k - 1) % 2] if k else (null, null)
        dst = (null, null) if final else bufs[k % 2]
        MSM_BUCKET(points.x.data_ptr(), points.y.data_ptr(),
                   order.data_ptr(), starts.data_ptr(),
                   *(null if t is None else t.data_ptr() for t in src),
                   *(o.data_ptr() for o in out),
                   *(null if t is None else t.data_ptr() for t in dst),
                   nw, nb, length, run, int(k > 0), int(final),
                   build.stream_ptr(dev))
    return JPoint(*out)


# ---------------------------------------------------------------------------
# Weighted bucket sums and window combination
# ---------------------------------------------------------------------------


def _shift_down(t: JPoint, s: int) -> JPoint:
    """partner[:, b] = t[:, b + s], infinity past the end (axis 1)."""
    nw, nb = t.x.shape[0], t.x.shape[1]
    inf = C.infinity((nw, min(s, nb)), t.x.device)
    return C.cat([C.index(t, (slice(None), slice(s, None))), inf], dim=1)


def _suffix_weighted(t: JPoint, bits: int) -> JPoint:
    """sum_b b * t_b over [nw, nb] buckets via a double suffix scan.

    Fold 1 adds sums of disjoint bucket subsets: the incomplete add is
    sound. Fold 2 adds suffix-cumulative values, which are EQUAL across a
    run of empty buckets: it needs the complete add (the round-4 lesson of
    the JAX package, ``msm.py:432-443``)."""

    def fold(t, complete):
        for lvl in range(bits):
            partner = _shift_down(t, 1 << lvl)
            t = C.add(t, partner) if complete else C.add_incomplete(t, partner)
        return t

    t = fold(t, complete=False)
    nw = t.x.shape[0]
    t = C.cat([C.infinity((nw, 1), t.x.device),
               C.index(t, (slice(None), slice(1, None)))], dim=1)
    total = fold(t, complete=True)
    return C.index(total, (slice(None), 0))


def _axis_reduce(t: JPoint, dim: int) -> JPoint:
    """Tree-sum along ``dim`` with incomplete adds (disjoint subsets)."""
    while t.x.shape[dim] > 1:
        half = t.x.shape[dim] // 2
        a = JPoint(*(c.narrow(dim, 0, half) for c in t))
        b = JPoint(*(c.narrow(dim, half, half) for c in t))
        t = C.add_incomplete(a, b)
    return t


def weighted_bucket_sum(buckets: JPoint, c: int) -> JPoint:
    """sum_b b * S_b per window [nw], digit split b = hi * 2^l + lo:

        sum_b b S_b = 2^l * sum_hi hi (sum_lo S) + sum_lo lo (sum_hi S)."""
    nw, nb = buckets.x.shape[0], buckets.x.shape[1]
    if nb <= 16:
        return _suffix_weighted(buckets, c)
    lbits = c // 2
    hbits = c - lbits
    grid = JPoint(*(v.reshape(nw, 1 << hbits, 1 << lbits, F.NLIMBS)
                    for v in buckets))
    s_hi = JPoint(*(v[:, :, 0] for v in _axis_reduce(grid, dim=2)))
    s_lo = JPoint(*(v[:, 0] for v in _axis_reduce(grid, dim=1)))
    w_hi = _suffix_weighted(s_hi, hbits)
    w_lo = _suffix_weighted(s_lo, lbits)
    return C.add(C.double(w_hi, times=lbits), w_lo)


def _affine_dbl(pt):
    """2 * pt on the host over Fq ints; None is infinity."""
    if pt is None:
        return None
    p = F.FQ_MODULUS
    x, y = pt
    if y == 0:
        return None
    m = 3 * x * x * pow(2 * y, -1, p) % p
    nx = (m * m - 2 * x) % p
    return (nx, (m * (x - nx) - y) % p)


def _affine_add(p1, p2):
    """p1 + p2 on the host over Fq ints; None is infinity."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    p = F.FQ_MODULUS
    (x1, y1), (x2, y2) = p1, p2
    if x1 == x2:
        return _affine_dbl(p1) if y1 == y2 else None
    m = (y2 - y1) * pow(x2 - x1, -1, p) % p
    nx = (m * m - x1 - x2) % p
    return (nx, (m * (x1 - nx) - y1) % p)


def horner_affine_ints(aff, c: int) -> tuple:
    """sum_w 2^(c w) S_w on the host over affine window sums ``aff`` (list
    of (x, y) ints, low window first, (0, 0) = infinity)."""
    acc = None
    for xy in reversed(aff):
        for _ in range(c):
            acc = _affine_dbl(acc)
        acc = _affine_add(acc, None if xy == (0, 0) else xy)
    return (0, 0) if acc is None else acc


def _top_regroup(digits: torch.Tensor, c: int):
    """Spread the top window over all 2^c buckets.

    254 bits leave the top window only 254 - (nw - 1) c bits (2 at c = 12
    or 14), so its few buckets would each hold a large share of all points
    (B8 then folds them in merge passes; PERF.md times the opening shape
    with and without this regroup). As the JAX package's
    ``_top_regroup``: point i of group g = i // (n / k) puts top digit d in
    bucket g * nb_top + d (d = 0 stays 0). Returns (digits, k, nb_top)."""
    nw, n = digits.shape
    top_bits = max(1, SCALAR_BITS - (nw - 1) * c)
    nb_top = 1 << top_bits
    k = max(1, min((1 << c) >> top_bits, n & -n))
    if k == 1:
        return digits, 1, nb_top
    group = torch.arange(n, device=digits.device) // (n // k)
    top = digits[-1]
    regrouped = torch.where(top == 0, top, top + group * nb_top)
    return torch.cat([digits[:-1], regrouped[None]]), k, nb_top


def _fold_top(buckets: JPoint, k: int, nb_top: int) -> JPoint:
    """Sum the regrouped top window's k groups digit by digit, with the
    COMPLETE add (two groups' sums are equal when points repeat), and pad
    it back to 2^c buckets with infinity."""
    if k == 1:
        return buckets
    nw, nb = buckets.x.shape[0], buckets.x.shape[1]
    top = JPoint(*(v[-1, : k * nb_top].reshape(k, nb_top, F.NLIMBS)
                   for v in buckets))
    while top.x.shape[0] > 1:
        half = top.x.shape[0] // 2
        top = C.add(C.index(top, slice(0, half)), C.index(top, slice(half, None)))
    inf = C.infinity((1, nb - nb_top), buckets.x.device)
    top = C.cat([top, inf], dim=1)
    return C.cat([C.index(buckets, slice(0, nw - 1)), top])


def sorted_windows(scalars_mont, c: int):
    """Bucket runs of every window, top window regrouped: (order, starts,
    k, nb_top) for ``bucket_accumulate`` and ``_fold_top``."""
    return _sorted_windows_of_words(standard_words(scalars_mont), c)


def _sorted_windows_of_words(std, c: int):
    digits, k, nb_top = _top_regroup(_digits_of_words(std, c), c)
    order, starts = sort_windows(digits, c)
    return order, starts, k, nb_top


def bucket_window_sums(points: APoint, std, c: int | None = None):
    """The window path: per-window weighted sums JPoint [nw] of B8's
    buckets, and the window bits used. ``std``: standard-form scalar
    words int64 [N, 8] (``standard_words``)."""
    if c is None:
        c = auto_c(points.x.shape[0])
    order, starts, k, nb_top = _sorted_windows_of_words(std, c)
    buckets = _fold_top(bucket_accumulate(points, order, starts), k, nb_top)
    return weighted_bucket_sum(buckets, c), c


# ---------------------------------------------------------------------------
# The by-value path for small-valued scalars
# ---------------------------------------------------------------------------

BY_VALUE_MIN_N = 1 << 13
SMALL_VALUE_BITS = 16

# window-sum calls that took the by-value path (read by chip_smoke.py, as a
# kernel's ``launches``)
by_value_uses = 0


def by_value_bound(n: int) -> int:
    """u_bound: the most distinct values the by-value path takes for n
    points, and the size of its follow-up MSM."""
    return min(n // 8, 1 << 12)


def by_value_gate(n: int, small: bool, distinct: int) -> bool:
    """The JAX package's condition (``co_zkvms_tpu/ops/msm.py:707-714,
    725-729``), which it applied on a TPU only and the port applies on
    every device: at least 2^13 points, every scalar below 2^16, and at
    most ``by_value_bound(n)`` distinct values."""
    return (n >= BY_VALUE_MIN_N and bool(small)
            and distinct <= by_value_bound(n))


def _value_stats(std) -> torch.Tensor:
    """[small, distinct] int64 on the scalars' device, without a sync."""
    small = ((std[:, 1:] == 0).all() &
             (std[:, 0] >> SMALL_VALUE_BITS == 0).all()).to(torch.int64)
    v = torch.sort(std[:, 0] & ((1 << SMALL_VALUE_BITS) - 1)).values
    distinct = 1 + (v[1:] != v[:-1]).sum()
    return torch.stack([small, distinct])


def small_value_stats(std) -> tuple:
    """(all scalars < 2^16?, number of distinct low 16-bit values) of
    standard-form words [N, 8], as the JAX package's
    ``_small_value_stats`` computes them on its 16-bit limbs."""
    small, distinct = _value_stats(std).tolist()
    return bool(small), int(distinct)


def _group_by_value(points: APoint, vals, u_bound: int):
    """Sum the points of each distinct scalar value: sort by value (stable),
    then a segmented suffix sum in ceil(log2 N) levels, each one full-width
    B7 launch. Position ``pos`` adds the partial sum at ``pos + 2^l`` when
    that position lies in its segment, and infinity otherwise, so every
    add joins two disjoint runs of distinct points.

    Returns (group sums JPoint [u_bound], their values int64 [u_bound],
    valid mask [u_bound]); empty slots are infinity with value 0. The
    Jacobian coordinates equal the JAX package's ``_group_by_value``: the
    same pairs through the same formula, and affine infinity enters as
    (0, 0, 0) as there."""
    n = vals.shape[0]
    device = vals.device
    vals_sorted, order = torch.sort(vals, stable=True)
    flags = torch.ones(n, dtype=torch.bool, device=device)
    flags[1:] = vals_sorted[1:] != vals_sorted[:-1]
    segid = torch.cumsum(flags, 0)
    px, py = points.x[order], points.y[order]
    p_inf = F.is_zero(px) & F.is_zero(py)
    pz = F.select(p_inf, F.zeros((n,), device), F.ones_mont(FQ, (n,), device))
    acc = JPoint(px, py, pz)
    inf = C.infinity((n,), device)
    pos = torch.arange(n, device=device)
    for lvl in range(max((n - 1).bit_length(), 1)):
        idx = (pos + (1 << lvl)).clamp(max=n - 1)
        valid = (pos + (1 << lvl) < n) & (segid[idx] == segid)
        acc = C.add_incomplete(acc, C.select(valid, C.index(acc, idx), inf))
    # the head of segment g (1-based segid) goes to slot g - 1; the rest of
    # the positions, and heads past u_bound, go to a slot that is dropped
    slot = torch.where(flags & (segid <= u_bound), segid - 1, u_bound)
    heads = torch.full((u_bound + 1,), n, dtype=torch.int64, device=device)
    heads.scatter_(0, slot, pos)
    heads = heads[:u_bound]
    ok = heads < n
    hidx = heads.clamp(max=n - 1)
    gsum = C.select(ok, C.index(acc, hidx), C.infinity((u_bound,), device))
    gval = torch.where(ok, vals_sorted[hidx], 0)
    return gsum, gval, ok


def _by_value_sums(points: APoint, vals, u_bound: int):
    """Window sums for small-valued scalars ``vals`` (int64 [N]): group by
    value, then the window path over the u_bound affine group sums with
    their values as scalars (infinity slots carry 0). Every value is then
    distinct, so no bucket holds more than about u_bound / 2^c points.
    Returns (sums JPoint [nw], window bits)."""
    gsum, gval, _ = _group_by_value(points, vals, u_bound)
    aff = C.to_affine(gsum)
    std = torch.zeros((u_bound, F.NLIMBS), dtype=torch.int64,
                      device=vals.device)
    std[:, 0] = gval
    return bucket_window_sums(APoint(aff.x.contiguous(), aff.y.contiguous()),
                              std)


def _stats_if_gated(std):
    """The gate's device-side stats for an MSM of this size, or None."""
    return _value_stats(std) if std.shape[0] >= BY_VALUE_MIN_N else None


def _sums_of_words(points: APoint, std, stats, c: int | None):
    """Window sums down the path the gate chooses; ``stats`` are the
    fetched (small, distinct), or None below the gate's size."""
    global by_value_uses
    n = std.shape[0]
    if stats is not None and by_value_gate(n, *stats):
        by_value_uses += 1
        return _by_value_sums(points, std[:, 0], by_value_bound(n))
    return bucket_window_sums(points, std, c)


def window_sums(points: APoint, scalars_mont, c: int | None = None):
    """Per-window weighted sums JPoint [nw] and the window bits used
    (small-valued scalars take the by-value path and its own bits)."""
    std = standard_words(scalars_mont)
    stats = _stats_if_gated(std)
    if stats is not None:
        stats = stats.tolist()
    return _sums_of_words(points, std, stats, c)


def msm(points: APoint, scalars_mont, c: int | None = None) -> JPoint:
    """sum_i scalars[i] * points[i] as a batch-1 JPoint.

    ``points``: affine batch [N]; ``scalars_mont``: Fr Montgomery [N, 8];
    ``c``: window bits (None sizes them to N; the result is the same point
    for every c)."""
    sums, c = window_sums(points, scalars_mont, c)
    xy = horner_affine_ints(C.points_to_ints(C.to_affine(sums)), c)
    return C.from_affine(C.points_from_ints([xy], device=points.x.device))


def msm_batch_ints(jobs, chunk: int = 64) -> list:
    """Many independent MSMs: ``jobs`` is a list of (APoint [N_i], Fr
    Montgomery scalars [N_i, 8]); returns one affine (x, y) int pair per job
    ((0, 0) = infinity). Window sums of up to ``chunk`` jobs go through one
    batched affine conversion and one device-to-host copy."""
    out = []
    for s in range(0, len(jobs), chunk):
        part = jobs[s:s + chunk]
        stds = [standard_words(sc) for _, sc in part]
        # the by-value gate's stats of every job in one fetch
        gated = [_stats_if_gated(std) for std in stds]
        live = [g for g in gated if g is not None]
        fetched = iter(torch.stack(live).tolist() if live else [])
        sums, bits = [], []
        for (pts, _), std, g in zip(part, stds, gated):
            stats = None if g is None else next(fetched)
            w, c = _sums_of_words(pts, std, stats, None)
            sums.append(w)
            bits.append(c)
        aff = C.points_to_ints(C.to_affine(C.cat(sums)))
        off = 0
        for w, c in zip(sums, bits):
            nw = w.x.shape[0]
            out.append(horner_affine_ints(aff[off:off + nw], c))
            off += nw
    return out


# ---------------------------------------------------------------------------
# Fixed-base MSM (SRS generation: one base, many scalars)
# ---------------------------------------------------------------------------


def fixed_base_table(base: APoint, c: int) -> APoint:
    """T[w, d] = d * 2^(c w) * base, affine, [nw, 2^c]; T[w, 0] = (0, 0).

    The nw window bases 2^(c w) * base are host ints; the device then
    fills all windows at once by bits: with P_k = 2^k B_w (doublings, B6),
    T <- [T, T + P_k] (complete adds, B5) for k = 0..c-1."""
    nw = n_windows(c)
    device = base.x.device
    pt = C.points_to_ints(APoint(base.x.reshape(1, F.NLIMBS),
                                 base.y.reshape(1, F.NLIMBS)))[0]
    pt = None if pt == (0, 0) else pt
    bases = []
    for _ in range(nw):
        bases.append((0, 0) if pt is None else pt)
        for _ in range(c):
            pt = _affine_dbl(pt)
    pk = C.from_affine(C.points_from_ints(bases, device=device))   # [nw]
    table = C.infinity((nw, 1), device)
    for k in range(c):
        if k:
            pk = C.double(pk)
        step = JPoint(*(v[:, None].expand(nw, table.x.shape[1], F.NLIMBS)
                        for v in pk))
        table = C.cat([table, C.add(table, step)], dim=1)
    aff = C.to_affine(table)
    return APoint(aff.x.contiguous(), aff.y.contiguous())


def fixed_base_msm(base: APoint, scalars_mont, c: int = 8) -> JPoint:
    """base * s_i for every scalar; returns a Jacobian batch [N]."""
    table = fixed_base_table(base, c)
    digits = window_digits(scalars_mont, c)
    n = scalars_mont.shape[0]
    acc = C.infinity((n,), scalars_mont.device)
    for w in range(digits.shape[0]):
        acc = C.add_mixed(acc, APoint(table.x[w][digits[w]],
                                      table.y[w][digits[w]]))
    return acc
