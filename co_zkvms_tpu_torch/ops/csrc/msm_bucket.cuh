// The chunk walk of the MSM bucket kernel (B8, msm_bucket.cu): what one
// thread does with its run of at most T sorted positions, shared by the
// kernel and the host harness (tests/test_torch_csrc_host.py builds it with
// g++), and mirrored step for step by ops/msm.py bucket_accumulate_plain.
//
// The schedule. Window w's positions order[w, 0:n] are sorted by digit, so
// bucket b is the run [starts[w, b], starts[w, b+1]). Pass 1 cuts the
// positions into chunks [j T, (j + 1) T), drops those of digit 0 (below
// starts[w, 1]) and gives one chunk to one thread. The thread folds its
// positions in order into an accumulator with the complete mixed add,
// starting from infinity at each bucket change; each run it closes (a
// segment) is written as follows:
//   - the chunk's first segment and its last segment go to the chunk's two
//     carry slots, with their key w nb + b (an unused slot gets key -1; a
//     chunk inside one bucket has one segment, its first);
//   - every other segment is a whole bucket, and is written to out[key].
// A merge pass runs the same walk over the carry list of the pass before
// (2 slots a chunk, in key order), in chunks of T entries, skipping keys
// -1, with the complete Jacobian add; it writes direct buckets and new
// carries. The pass whose input fits in one chunk (length <= T) is final:
// every segment it closes goes to out. So no thread folds more than T
// points or carries, whatever the bucket sizes, and a window's schedule
// depends on that window alone.
//
// Every product uses the carry-chain arithmetic (ChainArith, as B5 and
// B7); every value stays canonical, which it requires.
#pragma once
#include "g1.cuh"

namespace bn254 {

constexpr int32_t kNoKey = -1;

// The largest b in [lo, nb) with starts_w[b] <= pos, given starts_w[lo] <=
// pos < starts_w[nb]: a galloping search from lo, so the common step to the
// next bucket reads one or two bounds and a long run of empty buckets
// costs a logarithm of its length.
FDEV int bucket_at(const int32_t* starts_w, int lo, int nb, int pos) {
  int step = 1;
  int hi = lo + 1;
  while (hi < nb && starts_w[hi] <= pos) {
    lo = hi;
    step *= 2;
    hi = lo + step;
    if (hi > nb) hi = nb;
  }
  // starts_w[lo] <= pos < starts_w[hi]
  while (hi - lo > 1) {
    const int mid = lo + (hi - lo) / 2;
    if (starts_w[mid] <= pos) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

FDEV void fe_put(uint32_t* p, const uint32_t a[8]) {
#ifdef __CUDACC__
  fe_store(p, a);
#else
  fe_copy(p, a);
#endif
}

// Where a thread's closed segments go. out: the bucket sums [nw nb] as
// three coordinate arrays; carry_key / carry: the carry list being written
// (a point is 24 words, x y z), whose slots slot and slot + 1 are this
// chunk's; final: the pass writes every segment to out.
struct SegmentSink {
  uint32_t* ox;
  uint32_t* oy;
  uint32_t* oz;
  int32_t* carry_key;
  uint32_t* carry;
  long long slot;
  bool final;
  int closed;

  FMEMBER void direct(int key, const Jac& acc) const {
    const long long k = key;
    fe_put(ox + 8 * k, acc.x);
    fe_put(oy + 8 * k, acc.y);
    fe_put(oz + 8 * k, acc.z);
  }
  FMEMBER void put_slot(int s, int key, const Jac& acc) const {
    carry_key[slot + s] = key;
    uint32_t* c = carry + 24 * (slot + s);
    fe_put(c, acc.x);
    fe_put(c + 8, acc.y);
    fe_put(c + 16, acc.z);
  }
  // a segment followed by another one in the chunk
  FMEMBER void close(int key, const Jac& acc) {
    if (!final && closed == 0) {
      put_slot(0, key, acc);
    } else {
      direct(key, acc);
    }
    closed++;
  }
  // the chunk's last segment
  FMEMBER void last(int key, const Jac& acc) const {
    if (final) {
      direct(key, acc);
    } else if (closed == 0) {
      put_slot(0, key, acc);
      carry_key[slot + 1] = kNoKey;
    } else {
      put_slot(1, key, acc);
    }
  }
  // a chunk with nothing to fold
  FMEMBER void none() const {
    if (!final) {
      carry_key[slot] = kNoKey;
      carry_key[slot + 1] = kNoKey;
    }
  }
};

// Pass 1 for one chunk: positions [lo, hi) of window w (lo >= starts_w[1],
// so digit 0 is already dropped). Src gives the affine point of position p:
// src.start(lo, hi) before the walk, then src.get(p, qx, qy) for each p in
// order (the kernel prefetches the next point while this one is added; the
// host harness reads it straight from memory).
template <class Ar, class Src>
FDEV void walk_points(Src& src, const int32_t* starts_w, int nb, int key0,
                      int lo, int hi, SegmentSink& sink) {
  if (lo >= hi) {
    sink.none();
    return;
  }
  int b = bucket_at(starts_w, 1, nb, lo);
  int bound = starts_w[b + 1];
  Jac acc;
  jac_infinity(acc);
  src.start(lo, hi);
#pragma unroll 1
  for (int p = lo; p < hi; p++) {
    uint32_t qx[8], qy[8];
    src.get(p, qx, qy);
    if (p >= bound) {
      sink.close(key0 + b, acc);
      b = bucket_at(starts_w, b + 1, nb, p);
      bound = starts_w[b + 1];
      jac_infinity(acc);
    }
    jac_add_mixed_t<Ar>(acc, acc, qx, qy);
  }
  sink.last(key0 + b, acc);
}

// A merge pass for one chunk: entries [lo, hi) of a window's carry list
// (keys, and points of 24 words). Each entry e is folded as add(e, acc):
// the entry is the first operand, so that where the two are equal the
// doubling, acc = 2 e, can read e again from memory (Dbl::apply: the
// kernel runs it out of line, as B5's double_row; the host harness inline)
// and acc's old value need not stay live through the add.
template <class Ar, class Dbl>
FDEV void walk_carries(const int32_t* keys, uint32_t* pts, int lo, int hi,
                       SegmentSink& sink) {
  int cur = kNoKey;
  Jac acc;
  jac_infinity(acc);
#pragma unroll 1
  for (int k = lo; k < hi; k++) {
    const int key = keys[k];
    if (key == kNoKey) continue;
    if (key != cur) {
      if (cur != kNoKey) sink.close(cur, acc);
      cur = key;
      jac_infinity(acc);
    }
    uint32_t* e = pts + 24LL * k;
    if (!jac_add_unless_equal<Ar>(acc, *reinterpret_cast<const Jac*>(e),
                                  acc)) {
      Dbl::template apply<Ar>(acc, e);
    }
  }
  if (cur == kNoKey) {
    sink.none();
  } else {
    sink.last(cur, acc);
  }
}

}  // namespace bn254
