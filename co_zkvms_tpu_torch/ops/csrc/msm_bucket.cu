// MSM bucket accumulation (B8): for every window w and bucket b >= 1, the
// Jacobian sum of the affine points whose window-w digit is b.
//
// Replaces co_zkvms_tpu/ops/curve_pallas.py bucket_accumulate (:320, body
// _bucket_accum_kernel :244). The TPU walked a dense [R, 16, nb] grid in
// order on one core, with the buckets resident in VMEM across rows; a GPU's
// blocks run in no order, so that carry does not translate. Here the caller
// sorts each window's point indices by digit (torch.sort, glue), so bucket b
// of window w is the contiguous run order[w, starts[w, b] : starts[w, b+1]],
// and one thread owns one bucket: it walks its run, gathers each affine point
// by index and folds it in with the COMPLETE mixed add (two equal points in a
// bucket double correctly). Bucket 0 and empty buckets stay at infinity.
//
// Bound on the H100: integer multiplies (one complete mixed add, about 11
// field products, per point and window) against 64 bytes of gathered point
// and 4 bytes of index. Threads of a warp own neighbouring buckets, so the
// warp runs as long as its fullest bucket; with uniform digits that costs
// a small factor over the mean occupancy.
#include <cuda_runtime.h>

#include "g1.cuh"

using namespace bn254;

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
bucket_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
              const int32_t* __restrict__ order,
              const int32_t* __restrict__ starts, uint32_t* __restrict__ ox,
              uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int nw,
              int nb, long long n) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)nw * nb) return;
  const int w = (int)(g / nb);
  const int b = (int)(g % nb);
  Jac acc;
  jac_infinity(acc);
  if (b != 0) {
    const int32_t* row = order + (long long)w * n;
    const int begin = starts[(long long)w * (nb + 1) + b];
    const int end = starts[(long long)w * (nb + 1) + b + 1];
    for (int k = begin; k < end; k++) {
      const long long idx = row[k];
      uint32_t qx[8], qy[8];
      fe_load(qx, px + 8 * idx);
      fe_load(qy, py + 8 * idx);
      jac_add_mixed(acc, acc, qx, qy);
    }
  }
  fe_store(ox + 8 * g, acc.x);
  fe_store(oy + 8 * g, acc.y);
  fe_store(oz + 8 * g, acc.z);
}

}  // namespace

extern "C" {

int msm_bucket_accumulate(const void* px, const void* py, const void* order,
                          const void* starts, void* ox, void* oy, void* oz,
                          int nw, int nb, long long n, void* stream) {
  const long long total = (long long)nw * nb;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  bucket_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(px), static_cast<const uint32_t*>(py),
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(starts),
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy),
      static_cast<uint32_t*>(oz), nw, nb, n);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
