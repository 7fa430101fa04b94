// MSM bucket accumulation (B8): for every window w and bucket b >= 1, the
// Jacobian sum of the affine points whose window-w digit is b.
//
// Replaces co_zkvms_tpu/ops/curve_pallas.py bucket_accumulate (:320, body
// _bucket_accum_kernel :244). The TPU walked a dense [R, 16, nb] grid in
// order on one core, with the buckets resident in VMEM across rows; a GPU's
// blocks run in no order, so that carry does not translate. Here the caller
// sorts each window's point indices by digit (torch.sort, glue), so bucket b
// of window w is the contiguous run order[w, starts[w, b] : starts[w, b+1]].
//
// Schedule (msm_bucket.cuh): one thread folds a fixed run of T sorted
// positions, whatever the bucket sizes; a bucket cut by a chunk edge leaves
// its pieces in carry slots, which merge passes fold the same way, T
// entries a thread, until the list fits in one chunk. One launch of
// bucket_pass is one pass; the caller (ops/msm.py) fixes the passes from n
// and T alone, so nothing is read back from the device. A window of large
// buckets (the DFS index's row/col tables put 2^17 points in each of 16
// buckets of window 1) costs what a window of small ones costs, and a
// window whose digits are all 0 costs threads that exit at once.
//
// Bound on the H100: integer multiplies (one complete mixed add, about 11
// field products, per point beyond the first of its bucket) against 64
// bytes of gathered point and 4 bytes of index per point. Design for it:
//   - every product on carry chains (ChainArith), at most 128 registers
//     (__launch_bounds__(128, 4): 16 warps an SM);
//   - a block stages its slice of `order` (128 T indices) in shared memory
//     with coalesced loads, padded to T + 1 words a thread so that the
//     threads of a warp read it from distinct banks;
//   - each thread gathers its points with cp.async into a double-buffered
//     slot of shared memory (2 x 64 bytes a thread), so that point k + 1 is
//     in flight while point k is added;
//   - the infinity of bucket 0 and of empty buckets is written by pass 1
//     in a grid-stride loop, so no fill runs beforehand.
#include <cuda_runtime.h>

#include "msm_bucket.cuh"

using namespace bn254;

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The chunk's points through shared memory: slot p & 1 of this thread holds
// position p's (x, y) as four 16-byte quarters, laid out [slot][quarter]
// [thread] so that a warp's 16-byte reads of one quarter are contiguous.
struct StagedPoints {
  const uint32_t* px;
  const uint32_t* py;
  const int32_t* idx;     // this thread's staged indices, idx[p - base]
  int base;
  int hi;
  uint4* buf;             // [2][4][kThreads]
  int tid;

  __device__ __forceinline__ void issue(int p) const {
    const long long i = idx[p - base];
    uint4* d = buf + (p & 1) * 4 * kThreads + tid;
    cp_async16(d, px + 8 * i);
    cp_async16(d + kThreads, px + 8 * i + 4);
    cp_async16(d + 2 * kThreads, py + 8 * i);
    cp_async16(d + 3 * kThreads, py + 8 * i + 4);
    cp_async_commit();
  }
  __device__ __forceinline__ void start(int lo, int hi_) {
    hi = hi_;
    issue(lo);
  }
  __device__ __forceinline__ void get(int p, uint32_t qx[8],
                                      uint32_t qy[8]) const {
    if (p + 1 < hi) {
      issue(p + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const uint4* s = buf + (p & 1) * 4 * kThreads + tid;
    const uint4 a = s[0], b = s[kThreads], c = s[2 * kThreads],
                d = s[3 * kThreads];
    qx[0] = a.x; qx[1] = a.y; qx[2] = a.z; qx[3] = a.w;
    qx[4] = b.x; qx[5] = b.y; qx[6] = b.z; qx[7] = b.w;
    qy[0] = c.x; qy[1] = c.y; qy[2] = c.z; qy[3] = c.w;
    qy[4] = d.x; qy[5] = d.y; qy[6] = d.z; qy[7] = d.w;
  }
};

// A point of the carry list with plain loads: the merge pass writes the
// list (double_entry), so the read-only path of fe_load would not do.
__device__ __forceinline__ void load_entry(Jac& p, const uint32_t* e) {
  const uint4* v = reinterpret_cast<const uint4*>(e);
  uint32_t* d[3] = {p.x, p.y, p.z};
#pragma unroll
  for (int c = 0; c < 3; c++) {
    const uint4 lo = v[2 * c], hi = v[2 * c + 1];
    d[c][0] = lo.x; d[c][1] = lo.y; d[c][2] = lo.z; d[c][3] = lo.w;
    d[c][4] = hi.x; d[c][5] = hi.y; d[c][6] = hi.z; d[c][7] = hi.w;
  }
}

// The merge add's p == q path, acc = 2 e, out of line so that neither it
// nor a copy of acc sets the register peak of the add: it doubles the
// entry in place in the carry list (which only this thread reads), and
// the caller reads the result back.
__device__ __noinline__ void double_entry(uint32_t* e) {
  Jac p, o;
  load_entry(p, e);
  jac_double_t<ChainArith>(o, p);
  fe_store(e, o.x);
  fe_store(e + 8, o.y);
  fe_store(e + 16, o.z);
}

struct DoubleInMemory {
  template <class Ar>
  static __device__ __forceinline__ void apply(Jac& acc, uint32_t* e) {
    double_entry(e);
    load_entry(acc, e);
  }
};

size_t points_smem_bytes(int run) {
  return (size_t)kThreads * (run + 1) * sizeof(int32_t) +
         (size_t)2 * 4 * kThreads * sizeof(uint4);
}

// Pass 1. Grid (blocks per window, nw); block x of window w owns chunks
// [128 x, 128 (x + 1)), thread tid chunk j = 128 x + tid.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
points_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
              const int32_t* __restrict__ order,
              const int32_t* __restrict__ starts, uint32_t* __restrict__ ox,
              uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
              int32_t* __restrict__ carry_key, uint32_t* __restrict__ carry,
              int nw, int nb, int n, int run, int final) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* buf = reinterpret_cast<uint4*>(smem);
  int32_t* sorder = reinterpret_cast<int32_t*>(buf + 2 * 4 * kThreads);
  const int tid = threadIdx.x;
  const int w = blockIdx.y;

  // infinity for bucket 0 and every empty bucket (grid-stride)
  {
    const long long total = (long long)nw * nb;
    const long long stride = (long long)gridDim.x * gridDim.y * kThreads;
    Jac inf;
    jac_infinity(inf);
    for (long long i = ((long long)blockIdx.y * gridDim.x + blockIdx.x) *
                           kThreads + tid;
         i < total; i += stride) {
      const int b = (int)(i % nb);
      const long long s = (i / nb) * (nb + 1) + b;
      if (b == 0 || starts[s] == starts[s + 1]) {
        fe_store(ox + 8 * i, inf.x);
        fe_store(oy + 8 * i, inf.y);
        fe_store(oz + 8 * i, inf.z);
      }
    }
  }

  const int32_t* starts_w = starts + (long long)w * (nb + 1);
  const int first = starts_w[1];                 // digit 0 ends here
  const int chunks = (n + run - 1) / run;
  const long long blk_lo = (long long)blockIdx.x * kThreads * run;
  const long long blk_hi = min(blk_lo + (long long)kThreads * run,
                               (long long)n);
  const int32_t* order_w = order + (long long)w * n;
  for (long long p = max(blk_lo, (long long)first) + tid; p < blk_hi;
       p += kThreads) {
    const int off = (int)(p - blk_lo);
    sorder[(off / run) * (run + 1) + off % run] = order_w[p];
  }
  __syncthreads();

  const int j = blockIdx.x * kThreads + tid;
  if (j >= chunks) return;
  const int lo = max(j * run, first);
  const int hi = min(j * run + run, n);
  SegmentSink sink{ox, oy, oz, carry_key, carry,
                   2 * ((long long)w * chunks + j), final != 0, 0};
  StagedPoints src{px, py, sorder + tid * (run + 1), j * run, 0, buf, tid};
  walk_points<ChainArith>(src, starts_w, nb, w * nb, lo, hi, sink);
}

// A merge pass over carry lists of len entries a window. Grid (blocks per
// window, nw); thread j of window w owns entries [j T, (j + 1) T).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
merge_kernel(const int32_t* __restrict__ key_in, uint32_t* pts_in,
             uint32_t* __restrict__ ox,
             uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
             int32_t* __restrict__ carry_key, uint32_t* __restrict__ carry,
             int len, int run, int final) {
  const int w = blockIdx.y;
  const int chunks = (len + run - 1) / run;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= chunks) return;
  const long long row = (long long)w * len;
  SegmentSink sink{ox, oy, oz, carry_key, carry,
                   2 * ((long long)w * chunks + j), final != 0, 0};
  walk_carries<ChainArith, DoubleInMemory>(key_in + row, pts_in + 24 * row,
                                           j * run, min(j * run + run, len),
                                           sink);
}

}  // namespace

extern "C" {

// One pass of B8. merge == 0: pass 1 over the sorted points (len = n);
// merge != 0: a merge pass over the carry lists in key_in / pts_in (len
// entries a window). final != 0: every segment goes to out and no carries
// are written. run: T, the positions or entries a thread folds (>= 4).
int msm_bucket_pass(const void* px, const void* py, const void* order,
                    const void* starts, const void* key_in,
                    const void* pts_in, void* ox, void* oy, void* oz,
                    void* carry_key, void* carry, int nw, int nb,
                    long long len, int run, int merge, int final,
                    void* stream) {
  if (run < 4 || len < 0 || len > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long chunks = (len + run - 1) / run;
  const unsigned bx = (unsigned)(chunks > 0 ? (chunks + kThreads - 1) / kThreads
                                            : 1);
  const dim3 grid(bx, (unsigned)nw);
  uint32_t* x = static_cast<uint32_t*>(ox);
  uint32_t* y = static_cast<uint32_t*>(oy);
  uint32_t* z = static_cast<uint32_t*>(oz);
  int32_t* ck = static_cast<int32_t*>(carry_key);
  uint32_t* cp = static_cast<uint32_t*>(carry);
  if (merge) {
    merge_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const int32_t*>(key_in),
        static_cast<uint32_t*>(const_cast<void*>(pts_in)), x, y, z, ck, cp,
        (int)len, run, final);
  } else {
    const size_t smem = points_smem_bytes(run);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          points_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    points_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const uint32_t*>(px), static_cast<const uint32_t*>(py),
        static_cast<const int32_t*>(order),
        static_cast<const int32_t*>(starts), x, y, z, ck, cp, nw, nb,
        (int)len, run, final);
  }
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
