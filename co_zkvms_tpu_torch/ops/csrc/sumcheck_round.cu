// Sumcheck round kernels over natural-order pair tables, Fr (fid 0) and Fq
// (fid 1): the round message (B9), its reduction across blocks (B11), and
// the bind of every table at the round's challenge (B10).
//
// Replaces co_zkvms_tpu/ops/sumcheck_pallas.py eval_call (:234, body
// _eval_kernel_body :126), _LvOps.modsum0 / lazy_reduce (:91-113) and
// bind_call (:283, body _bind_kernel_body :184). The TPU kept its tables
// bit-reversed and packed [8 x hh/8] so that a pair (2p, 2p+1) landed in two
// contiguous lane blocks; a GPU thread reads the two 32-byte elements of its
// pair side by side, so the tables stay in natural order here. The TPU also
// carried loose digit sums out of every grid step and reduced them on the
// host; blocks run in no order here, so each block reduces its pairs to one
// canonical partial per t (warp shuffles, then shared memory) and a second
// launch sums the partials. Modular sums are exact, so any association
// gives the same message.
//
// Bound on the H100: bind reads two elements and writes one per output with
// one Montgomery product, so it is bound by bytes (about 96 B against 264
// IMAD slots; see field_kernels.cu). The round message reads 2 x tables (+1
// suffix) elements per pair: the outer comb does 6 carry-chain products
// per 224 bytes (t = 0, 1, 2; the block's t = 3 by finite differences, see
// sumcheck_round.cuh), the inner 3 per 128 bytes, so both are bound by
// operations. Design: one thread per pair at a time with every value in
// registers, at most 128 registers a thread so that four blocks of 128
// threads share an SM; the wrapper sizes the grid to one such wave
// (ops/sumcheck.py EVAL_BLOCKS_PER_SM), and a thread loops over its pairs.
#include <cuda_runtime.h>

#include "sumcheck_round.cuh"

using namespace bn254;

namespace {

// B9's block size is a launch argument (the wrapper's EVAL_THREADS, the one
// source of the partition its plain version rebuilds): a multiple of 32 up
// to kEvalMaxThreads, with kEvalMinBlocks blocks resident on an SM.
constexpr int kEvalMaxThreads = 128;
constexpr int kEvalMinBlocks = 4;
constexpr int kReduceThreads = 256;
constexpr int kBindThreads = 256;

template <int F>
__device__ __forceinline__ void warp_sum(uint32_t a[8]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    uint32_t o[8];
#pragma unroll
    for (int j = 0; j < 8; j++) o[j] = __shfl_down_sync(0xffffffffu, a[j], off);
    mod_add<F>(a, a, o);
  }
}

// Sum of one element per thread over the block (blockDim.x a multiple of
// 32); thread 0 holds the result. ``sm`` holds 8 words per warp.
template <int F>
__device__ __forceinline__ void block_sum(uint32_t a[8], uint32_t* sm) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_sum<F>(a);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 8; j++) sm[8 * warp + j] = a[j];
  }
  __syncthreads();
  if (warp == 0) {
    if (lane < (int)(blockDim.x >> 5)) {
#pragma unroll
      for (int j = 0; j < 8; j++) a[j] = sm[8 * lane + j];
    } else {
      fe_zero(a);
    }
    warp_sum<F>(a);
  }
  __syncthreads();
}

// B9: per-block partial sums of comb(restrictions at t), t = 0..degree, for
// comb id C (kOuterComb, kInnerComb). tabs: the comb's tables of 2h
// elements, ``tstride`` elements apart; suffix: h elements (split-eq) or
// unused. Block b takes the pairs p = b * T + i + k * (gridDim * T),
// T = blockDim; its partial lands at partials[b, t].
template <int F, int C>
__global__ void __launch_bounds__(kEvalMaxThreads, kEvalMinBlocks)
eval_kernel(const uint32_t* __restrict__ tabs, long long tstride,
            const uint32_t* __restrict__ suffix, long long h,
            uint32_t* __restrict__ partials) {
  typedef typename CombOf<C>::type Comb;
  constexpr int D1 = Comb::kDegree + 1;
  __shared__ uint32_t sm[8 * (kEvalMaxThreads / 32)];
  uint32_t acc[D1][8];
  sc_thread_pairs<F, Comb>(acc, tabs, tstride, suffix, h,
                           (long long)blockIdx.x * blockDim.x + threadIdx.x,
                           (long long)gridDim.x * blockDim.x);
#pragma unroll
  for (int t = 0; t < Comb::kPoints; t++) block_sum<F>(acc[t], sm);
  if (threadIdx.x == 0) {
    Comb::template finish<F>(acc);
#pragma unroll
    for (int t = 0; t < D1; t++)
      fe_store(partials + 8 * ((long long)blockIdx.x * D1 + t), acc[t]);
  }
}

// B11: out[t] = sum over rows b of partials[b, t]; one block per t.
template <int F>
__global__ void __launch_bounds__(kReduceThreads)
reduce_kernel(const uint32_t* __restrict__ partials, long long rows,
              uint32_t* __restrict__ out) {
  __shared__ uint32_t sm[8 * (kReduceThreads / 32)];
  const int t = blockIdx.x;
  const int d1 = gridDim.x;
  uint32_t acc[8];
  fe_zero(acc);
  for (long long b = threadIdx.x; b < rows; b += kReduceThreads) {
    uint32_t v[8];
    fe_load(v, partials + 8 * (b * d1 + t));
    mod_add<F>(acc, acc, v);
  }
  block_sum<F>(acc, sm);
  if (threadIdx.x == 0) fe_store(out + 8 * t, acc);
}

// B10: out[row, p] = in[row, 2p] + r * (in[row, 2p+1] - in[row, 2p]) for
// ``rows`` tables of 2h elements, ``istride`` elements apart; out is dense.
template <int F>
__global__ void __launch_bounds__(kBindThreads)
bind_kernel(const uint32_t* __restrict__ in, long long istride,
            const uint32_t* __restrict__ r_ptr, long long rows, long long h,
            uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kBindThreads + threadIdx.x;
  if (i >= rows * h) return;
  const long long row = i / h;
  const long long p = i - row * h;
  const uint32_t* pair = in + 8 * (row * istride + 2 * p);
  uint32_t e[8], o[8], r[8];
  fe_load(e, pair);
  fe_load(o, pair + 8);
  fe_load(r, r_ptr);
  mod_sub<F>(o, o, e);
  mont_mul<F>(o, o, r);
  mod_add<F>(o, e, o);
  fe_store(out + 8 * i, o);
}

template <int C>
int launch_eval(const void* tabs, long long tstride, const void* suffix,
                long long h, void* partials, int blocks, int threads,
                int fid, void* stream) {
  if (threads <= 0 || threads > kEvalMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* pt = static_cast<const uint32_t*>(tabs);
  const uint32_t* ps = static_cast<const uint32_t*>(suffix);
  uint32_t* po = static_cast<uint32_t*>(partials);
  if (fid == 0) {
    eval_kernel<0, C><<<blocks, threads, 0, s>>>(pt, tstride, ps, h, po);
  } else {
    eval_kernel<1, C><<<blocks, threads, 0, s>>>(pt, tstride, ps, h, po);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// comb: 0 = outer (split-eq suffix), 1 = inner. ``blocks`` partial rows of
// ``threads`` threads each.
int sc_eval_round(const void* tabs, long long tstride, const void* suffix,
                  long long h, void* partials, int blocks, int threads,
                  int comb, int fid, void* stream) {
  if (comb == kOuterComb)
    return launch_eval<kOuterComb>(tabs, tstride, suffix, h, partials,
                                   blocks, threads, fid, stream);
  if (comb == kInnerComb)
    return launch_eval<kInnerComb>(tabs, tstride, suffix, h, partials,
                                   blocks, threads, fid, stream);
  return (int)cudaErrorInvalidValue;
}

int sc_reduce_partials(const void* partials, long long rows, int d1,
                       void* out, int fid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* pp = static_cast<const uint32_t*>(partials);
  uint32_t* po = static_cast<uint32_t*>(out);
  if (fid == 0) {
    reduce_kernel<0><<<d1, kReduceThreads, 0, s>>>(pp, rows, po);
  } else {
    reduce_kernel<1><<<d1, kReduceThreads, 0, s>>>(pp, rows, po);
  }
  return (int)cudaGetLastError();
}

int sc_bind_round(const void* in, long long istride, const void* r,
                  long long rows, long long h, void* out, int fid,
                  void* stream) {
  const long long n = rows * h;
  const unsigned blocks = (unsigned)((n + kBindThreads - 1) / kBindThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* pi = static_cast<const uint32_t*>(in);
  const uint32_t* pr = static_cast<const uint32_t*>(r);
  uint32_t* po = static_cast<uint32_t*>(out);
  if (fid == 0) {
    bind_kernel<0><<<blocks, kBindThreads, 0, s>>>(pi, istride, pr, rows, h, po);
  } else {
    bind_kernel<1><<<blocks, kBindThreads, 0, s>>>(pi, istride, pr, rows, h, po);
  }
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
