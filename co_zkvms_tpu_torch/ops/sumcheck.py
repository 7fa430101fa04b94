"""Sumcheck prover over MLE tables (public or Rep3-shared), and its host
verifier.

Round j over tables of 2h entries: each table's restriction to x_0 = t is
even + t (odd - even); the round message is s_j(t) = sum over the h pairs of
comb(restrictions) for t = 0..degree. The transcript absorbs the message,
squeezes r_j, and every table binds x_0 <- r_j.

The prover drives the transcript on the host (``transcript.HostTranscript``):
each message is reduced on the device, copied to the host as degree + 1
ints, and folded and absorbed there. Pair order and summation order do not
change a message, so every message equals the JAX package's
``sumcheck.prove`` bit for bit.

Two routes evaluate a round, chosen by the comb alone:

- a comb with an ``lv`` attribute (one of the ``RoundComb`` instances below)
  goes through the round kernels of ``ops/csrc/sumcheck_round.cu``: B9
  (``eval_partials``: one partial message per block) and B11
  (``reduce_partials``), every round, whatever the table size;
- any other comb (constants, shared tables, round counters) runs as glue
  over the field kernels, one t at a time.

Every bind of every comb goes through B10 (``bind_rows``), one launch for
all tables of a round, party rows included.

Options, as in the JAX package's engine:

- ``eq_split`` (Dao-Thaler split-eq): the comb sees a read-only half-size
  suffix table S_j[y] = eq(taus[j+1:], y) as its first table, and the
  message is scaled by c_j * eq(tau_j, t) with c_{j+1} = c_j * eq(tau_j,
  r_j); the eq table is never bound.
- ``shared``: tables may carry a leading party axis [3, n, 8]; the comb
  returns [3, h, 8] additive shares, each party's message is scaled, masked
  with the round's zero share (``masks``) and the parties' messages are
  summed (opened) before the transcript sees them.
- ``zk_mask`` = (rho1, coeffs [nv, degree + 1, 8]): the mask polynomial
  g(x) = sum_var u_var(x_var) is folded into each opened message.
- ``consts`` / ``round_consts``: extra comb arguments; a comb with
  ``wants_ctr`` also receives t.

The fold order is the JAX package's (``ops/sumcheck.py:344-350``): scale,
then mask and open, then the zk fold, then absorb.

Not ported: the fixed and chunked compile shapes and the bit-reversed layout
of the fused TPU rounds.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Sequence

import torch

from . import field as F
from .field import FR, FieldSpec
from .transcript import HostTranscript
from ..utils import build


class SumcheckResult(NamedTuple):
    challenges: torch.Tensor  # [nv, 8] Montgomery
    challenge_ints: list      # [nv] ints
    round_msgs: list          # [nv][degree + 1] ints
    final_polys: list         # each [..., 1, 8]: the tables bound at r


def eq_suffix_tables(spec: FieldSpec, taus) -> list:
    """Split-eq suffix tables S_j[y] = eq(taus[j+1:], y), sizes
    2^(nv-1-j) .. 1, built LSB-first by one doubling sweep."""
    nv = taus.shape[0]
    t = F.ones_mont(spec, (1,), taus.device)
    suf = [None] * nv
    for j in range(nv - 1, -1, -1):
        suf[j] = t
        t1 = F.mul(spec, t, taus[j])
        t0 = F.sub(spec, t, t1)
        t = torch.stack([t0, t1], dim=1).reshape(-1, F.NLIMBS)
    return suf


# ---------------------------------------------------------------------------
# B9-B11: the round kernels and their plain versions
# ---------------------------------------------------------------------------


def _outer_plain(spec, suffix, v):
    a, b, c = v
    return F.mul_plain(spec, suffix, F.sub_plain(
        spec, F.mul_plain(spec, a, b), c))


def _inner_plain(spec, suffix, v):
    return F.mul_plain(spec, v[0], v[1])


_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int
_SCP = "co_zkvms_tpu/ops/sumcheck_pallas.py"
_EVAL_ARGS = [_P, _I64, _P, _I64, _P, _INT, _INT, _INT, _INT, _P]
SC_EVAL_OUTER = build.KernelFn("sc_eval_round_outer", "sumcheck_round",
                               "sc_eval_round", _EVAL_ARGS,
                               replaces=f"{_SCP}:234")
SC_EVAL_INNER = build.KernelFn("sc_eval_round_inner", "sumcheck_round",
                               "sc_eval_round", _EVAL_ARGS,
                               replaces=f"{_SCP}:234")
SC_REDUCE = build.KernelFn(
    "sc_reduce_partials", "sumcheck_round", "sc_reduce_partials",
    [_P, _I64, _INT, _P, _INT, _P], replaces=f"{_SCP}:91")
SC_BIND = build.KernelFn(
    "sc_bind_round", "sumcheck_round", "sc_bind_round",
    [_P, _I64, _P, _I64, _I64, _P, _INT, _P], replaces=f"{_SCP}:283")


class RoundComb(NamedTuple):
    """A comb that the round kernel computes (a B9 instance)."""

    name: str
    cid: int                 # the kernel's comb id
    degree: int
    n_tables: int
    split_eq: bool           # reads the split-eq suffix as operand 0
    plain: Callable          # (spec, suffix, restrictions) -> [h, 8]
    kernel: build.KernelFn   # its launch counter


OUTER = RoundComb("outer", 0, 3, 3, True, _outer_plain,  # suffix (a b - c)
                  SC_EVAL_OUTER)
INNER = RoundComb("inner", 1, 2, 2, False, _inner_plain,  # a b
                  SC_EVAL_INNER)

# B9's grid: blocks of EVAL_THREADS threads (passed to the kernel at launch),
# capped at EVAL_BLOCKS_PER_SM an SM, the blocks that its launch bounds keep
# resident (128 registers a thread): one wave, in which a thread loops over
# its pairs. The kernel's kEvalMaxThreads / kEvalMinBlocks match them.
EVAL_THREADS = 128
EVAL_BLOCKS_PER_SM = 4


def eval_blocks(h: int, device) -> int:
    """Partial rows (blocks) B9 writes for h pairs on ``device``: one per
    EVAL_THREADS pairs, capped on a card at EVAL_BLOCKS_PER_SM per SM."""
    blocks = max(1, -(-h // EVAL_THREADS))
    if torch.device(device).type == "cuda":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        blocks = min(blocks, EVAL_BLOCKS_PER_SM * sms)
    return blocks


def _check_stack(stack):
    if stack.dtype != torch.int32 or stack.dim() != 3 or \
            stack.shape[-1] != F.NLIMBS or not stack.is_contiguous():
        raise TypeError("round kernels take contiguous int32 [rows, 2h, 8] "
                        f"tables, got {stack.dtype} {tuple(stack.shape)}")
    if stack.shape[1] % 2:
        raise ValueError(f"tables of {stack.shape[1]} entries")


def eval_partials_plain(spec: FieldSpec, comb: RoundComb, stack, suffix=None,
                        blocks=None, threads=EVAL_THREADS):
    """Plain version of B9: partials [blocks, degree + 1, 8], row b the sum
    over the pairs the kernel gives block b (p = b T + i + k G T, with T =
    ``threads`` and G = ``blocks``, by default ``eval_blocks`` on the
    stack's device)."""
    h = stack.shape[1] // 2
    even, odd = stack[:, 0::2], stack[:, 1::2]
    slope = F.sub_plain(spec, odd, even)
    cur = even
    vals = []
    for t in range(comb.degree + 1):
        if t:
            cur = F.add_plain(spec, cur, slope)
        vals.append(comb.plain(spec, suffix, list(cur)))
    v = torch.stack(vals, dim=1)                      # [h, d + 1, 8]
    g = eval_blocks(h, stack.device) if blocks is None else blocks
    span = g * threads
    k = -(-h // span)
    v = torch.cat([v, torch.zeros((k * span - h,) + v.shape[1:],
                                  dtype=v.dtype, device=v.device)])
    v = v.reshape(k, g, threads, comb.degree + 1, F.NLIMBS)
    v = v.transpose(0, 1).reshape(g, k * threads, comb.degree + 1, F.NLIMBS)
    return F.modsum_plain(spec, v, dim=1)


def eval_partials(spec: FieldSpec, comb: RoundComb, stack, suffix=None):
    """B9: one round's per-block message partials [blocks, d + 1, 8].

    ``stack``: the comb's tables [n_tables, 2h, 8]; ``suffix``: the split-eq
    suffix [h, 8] for a ``split_eq`` comb, else None."""
    _check_stack(stack)
    if stack.shape[0] != comb.n_tables:
        raise ValueError(f"{comb.name} comb takes {comb.n_tables} tables")
    h = stack.shape[1] // 2
    if comb.split_eq != (suffix is not None):
        raise ValueError(f"{comb.name} comb: suffix given = "
                         f"{suffix is not None}, wanted {comb.split_eq}")
    if suffix is not None and (
            suffix.dtype != torch.int32 or not suffix.is_contiguous()
            or tuple(suffix.shape) != (h, F.NLIMBS)):
        raise ValueError("the suffix is contiguous int32 [h, 8], one entry "
                         "per pair")
    ts = (stack,) if suffix is None else (stack, suffix)
    if F.on_cpu(*ts):
        return eval_partials_plain(spec, comb, stack, suffix)
    for t in ts:
        F._check(t, stack.device)
    return _launch_eval(spec, comb, stack, suffix, eval_blocks(h, stack.device))


def _launch_eval(spec, comb, stack, suffix, blocks):
    """One B9 launch on a grid of ``blocks`` blocks (eval_partials checks
    its arguments and takes ``eval_blocks``)."""
    out = torch.empty((blocks, comb.degree + 1, F.NLIMBS), dtype=torch.int32,
                      device=stack.device)
    comb.kernel(stack.data_ptr(), stack.shape[1],
                0 if suffix is None else suffix.data_ptr(),
                stack.shape[1] // 2, out.data_ptr(), blocks, EVAL_THREADS,
                comb.cid, spec.fid, build.stream_ptr(stack.device))
    return out


def reduce_partials_plain(spec: FieldSpec, partials):
    """Plain version of B11: the canonical [d + 1, 8] sum over rows."""
    return F.modsum_plain(spec, partials, dim=0)


def reduce_partials(spec: FieldSpec, partials):
    """B11: sum B9's partials [blocks, d + 1, 8] over blocks."""
    if partials.dtype != torch.int32 or partials.dim() != 3 or \
            not partials.is_contiguous():
        raise TypeError("partials are contiguous int32 [blocks, d + 1, 8]")
    if F.on_cpu(partials):
        return reduce_partials_plain(spec, partials)
    d1 = partials.shape[1]
    out = torch.empty((d1, F.NLIMBS), dtype=torch.int32,
                      device=partials.device)
    SC_REDUCE(partials.data_ptr(), partials.shape[0], d1, out.data_ptr(),
              spec.fid, build.stream_ptr(partials.device))
    return out


def eval_round(spec: FieldSpec, comb: RoundComb, stack, suffix=None):
    """One round's message [d + 1, 8] (canonical Montgomery): B9 then B11."""
    return reduce_partials(spec, eval_partials(spec, comb, stack, suffix))


def bind_rows_plain(spec: FieldSpec, stack, r):
    """Plain version of B10."""
    even, odd = stack[:, 0::2], stack[:, 1::2]
    return F.add_plain(spec, even, F.mul_plain(
        spec, F.sub_plain(spec, odd, even), r))


def bind_rows(spec: FieldSpec, stack, r):
    """B10: bind x_0 <- r in every row of ``stack`` [rows, 2h, 8] (tables,
    party shares, any mix): out[row, p] = t[2p] + r (t[2p+1] - t[2p]),
    canonical. ``r``: one Montgomery element [8]."""
    _check_stack(stack)
    if F.on_cpu(stack, r):
        return bind_rows_plain(spec, stack, r)
    F._check(r, stack.device)
    rows, h = stack.shape[0], stack.shape[1] // 2
    out = torch.empty((rows, h, F.NLIMBS), dtype=torch.int32,
                      device=stack.device)
    if rows * h:
        SC_BIND(stack.data_ptr(), stack.shape[1], r.contiguous().data_ptr(),
                rows, h, out.data_ptr(), spec.fid,
                build.stream_ptr(stack.device))
    return out


# ---------------------------------------------------------------------------
# zk mask (host ints)
# ---------------------------------------------------------------------------


def zk_mask_precompute(coeffs, degree: int, m: int):
    """Per-round zk-mask values from coefficient ints [nv][d+1]: (u_evals
    [nv][d+1] = u_j(t), suffix [nv] = sum_{k>j} (u_k(0) + u_k(1)), pow_r
    [nv] = 2^(nv-j-1), pow_r1 [nv] = 2^(nv-j-2) or 0 in the last round,
    g_sum = the sum of g over the hypercube)."""
    nv = len(coeffs)

    def u_at(row, t):
        acc = 0
        for c in reversed(row):
            acc = (acc * t + c) % m
        return acc

    u_evals = [[u_at(row, t) for t in range(degree + 1)] for row in coeffs]
    u01 = [(u[0] + u[1]) % m for u in u_evals]
    suffix, run = [0] * nv, 0
    for j in range(nv - 1, -1, -1):
        suffix[j] = run
        run = (run + u01[j]) % m
    g_sum = (1 << (nv - 1)) * run % m if nv else 0
    pow_r = [(1 << (nv - j - 1)) % m for j in range(nv)]
    pow_r1 = [(1 << (nv - j - 2)) % m if j < nv - 1 else 0 for j in range(nv)]
    return u_evals, suffix, pow_r, pow_r1, g_sum


def _zk_round(msg, rho1, u_ev, suffix, pow_r, pow_r1, acc_a, m):
    """msg[t] += rho1 (2^R (A + u_j(t)) + 2^(R-1) suffix_j)."""
    return [(v + rho1 * ((u_ev[t] + acc_a) * pow_r + pow_r1 * suffix)) % m
            for t, v in enumerate(msg)]


def _zk_accum(row, r, acc_a, m):
    """A <- A + u_j(r) (Horner over the round's coefficients)."""
    u_r = 0
    for c in reversed(row):
        u_r = (u_r * r + c) % m
    return (acc_a + u_r) % m


def _eq_int(w: int, t: int, m: int) -> int:
    """eq(w, t) = (1 - w) + t (2w - 1) mod m."""
    return ((1 - w) + t * (2 * w - 1)) % m


# ---------------------------------------------------------------------------
# the prover
# ---------------------------------------------------------------------------


class _Rows:
    """Every table's rows in one [rows, 2h, 8] buffer, so one B10 launch
    binds them all; ``views`` gives each table back in its own shape."""

    def __init__(self, polys):
        self.leads = [tuple(p.shape[:-2]) for p in polys]
        n = polys[0].shape[-2]
        self.stack = torch.cat([p.reshape(-1, n, F.NLIMBS) for p in polys])

    def views(self):
        out, off = [], 0
        h2 = self.stack.shape[1]
        for lead in self.leads:
            k = 1
            for d in lead:
                k *= d
            out.append(self.stack[off:off + k].reshape(lead + (h2, F.NLIMBS)))
            off += k
        return out


def _glue_message(spec, views, suffix, degree, comb, consts, shared):
    """Round message sums by glue over the field kernels: [(3,) d + 1, 8]."""
    evens = [v[..., 0::2, :] for v in views]
    slopes = [F.sub(spec, v[..., 1::2, :], e) for v, e in zip(views, evens)]
    cur = evens
    evals = []
    for t in range(degree + 1):
        if t:
            cur = [F.add(spec, c, s) for c, s in zip(cur, slopes)]
        args = ([suffix] if suffix is not None else []) + cur
        if getattr(comb, "wants_ctr", False):
            v = comb(args, consts, t)
        elif consts is None:
            v = comb(args)
        else:
            v = comb(args, consts)
        if shared and v.dim() == 2:
            raise ValueError("a shared sumcheck's comb must return shares")
        evals.append(F.modsum(spec, v, dim=v.dim() - 2))
    return torch.stack(evals, dim=-2)


def prove(spec: FieldSpec, transcript: HostTranscript,
          polys: Sequence[torch.Tensor], degree: int, comb: Callable,
          masks=None, shared: bool = False, consts=None, zk_mask=None,
          round_consts=None, eq_split=None) -> SumcheckResult:
    """Run every round. ``polys``: tables [..., 2^nv, 8] on one device.

    ``comb(list of restrictions[, consts[, t]]) -> [(3,) h, 8]``.
    ``masks``: [nv, 3, degree + 1, 8] zero shares, one per round
    (``shared`` only). ``zk_mask``: (rho1 [8], coeffs [nv, degree + 1, 8]),
    Montgomery. ``round_consts``: nv tuples appended to ``consts`` round by
    round. ``eq_split``: [nv, 8] Montgomery taus (``polys`` then exclude the
    eq table). ``transcript`` is advanced in place."""
    m = spec.modulus
    n = polys[0].shape[-2]
    nv = n.bit_length() - 1
    if 1 << nv != n:
        raise ValueError("table length must be a power of two")
    device = polys[0].device
    lv = getattr(comb, "lv", None)
    if lv is not None and (
            shared or masks is not None or consts is not None
            or round_consts is not None or lv.degree != degree
            or lv.n_tables != len(polys) or any(p.dim() != 2 for p in polys)
            or lv.split_eq != (eq_split is not None)):
        raise ValueError(f"the {lv.name} round kernel does not take this "
                         "sumcheck (tables, degree, split-eq or options)")
    if masks is not None and not shared:
        raise ValueError("round masks belong to a shared sumcheck")
    sufs = taus = None
    cfac = 1
    if eq_split is not None and nv > 0:
        if eq_split.shape[0] != nv:
            raise ValueError("eq_split needs one tau per variable")
        sufs = eq_suffix_tables(spec, eq_split)
        taus = [int(v) for v in F.to_int(spec, eq_split)]
    if masks is not None:
        masks = F.to_int(spec, masks)                 # [nv, 3, d + 1] ints
    if zk_mask is not None:
        rho1 = F.to_int(spec, zk_mask[0])
        zk_coeffs = [[int(c) for c in row]
                     for row in F.to_int(spec, zk_mask[1])]
        u_evals, zk_suf, pow_r, pow_r1, _ = zk_mask_precompute(
            zk_coeffs, degree, m)
        acc_a = 0
    rows = _Rows(polys)
    rs, rs_int, msgs = [], [], []
    for j in range(nv):
        suffix = sufs[j] if sufs is not None else None
        if lv is not None:
            evals = eval_round(spec, lv, rows.stack, suffix)
        else:
            cj = consts
            if round_consts is not None:
                cj = tuple(consts or ()) + tuple(round_consts[j])
            evals = _glue_message(spec, rows.views(), suffix, degree, comb,
                                  cj, shared)
        vals = F.to_int(spec, evals)                  # [(3,) d + 1] ints
        parties = [list(vals)] if vals.ndim == 1 else [list(r) for r in vals]
        if sufs is not None:
            parties = [[v * cfac % m * _eq_int(taus[j], t, m) % m
                        for t, v in enumerate(row)] for row in parties]
        if masks is not None:
            parties = [[(v + int(mk)) % m for v, mk in zip(row, mrow)]
                       for row, mrow in zip(parties, masks[j])]
        msg = [sum(col) % m for col in zip(*parties)]
        if zk_mask is not None:
            msg = _zk_round(msg, rho1, u_evals[j], zk_suf[j], pow_r[j],
                            pow_r1[j], acc_a, m)
        transcript.absorb_many(msg)
        r_int = transcript.challenge()
        if zk_mask is not None:
            acc_a = _zk_accum(zk_coeffs[j], r_int, acc_a, m)
        if sufs is not None:
            cfac = cfac * _eq_int(taus[j], r_int, m) % m
        r = F.from_int(spec, r_int, device=device)
        rows.stack = bind_rows(spec, rows.stack, r)
        rs.append(r)
        rs_int.append(r_int)
        msgs.append(msg)
    challenges = (torch.stack(rs) if rs else
                  torch.zeros((0, F.NLIMBS), dtype=torch.int32, device=device))
    return SumcheckResult(challenges=challenges, challenge_ints=rs_int,
                          round_msgs=msgs, final_polys=rows.views())


# --- host verification (copy of the JAX package's) ------------------------


def lagrange_eval_ints(evals, x: int, modulus: int) -> int:
    """Interpolate the degree-d poly through (i, evals[i]) and evaluate at x."""
    d = len(evals) - 1
    total = 0
    for i in range(d + 1):
        num, den = 1, 1
        for j in range(d + 1):
            if i == j:
                continue
            num = num * (x - j) % modulus
            den = den * (i - j) % modulus
        total = (total + evals[i] * num * pow(den, -1, modulus)) % modulus
    return total


def verify(round_msgs, claim: int, transcript: HostTranscript,
           modulus: int = FR.modulus):
    """Walk the rounds on the host: check s(0)+s(1) == claim, derive r_j.

    ``round_msgs``: [nv][degree+1] ints. Returns (challenges, final_claim).
    Raises ValueError on a failed round check.
    """
    rs = []
    for j, evals in enumerate(round_msgs):
        if (evals[0] + evals[1]) % modulus != claim % modulus:
            raise ValueError(f"sumcheck round {j}: s(0)+s(1) != claim")
        transcript.absorb_many(evals)
        r = transcript.challenge()
        claim = lagrange_eval_ints(evals, r, modulus)
        rs.append(r)
    return rs, claim
