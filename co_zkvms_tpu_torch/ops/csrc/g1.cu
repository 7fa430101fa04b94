// Batched BN254 G1 kernels: complete mixed add (B4), complete Jacobian add
// (B5), doubling (B6) and the incomplete add of the MSM merge trees and the
// by-value levels (B7).
//
// Replaces co_zkvms_tpu/ops/curve_pallas.py add_mixed (:383, body
// _add_mixed_kernel :57), add (:409, _add_kernel :116), double (:456,
// _double_kernel :235 -> _double_limbs :41) and add_incomplete (:432,
// _add_incomplete_kernel :177).
//
// Bound on the H100: integer multiplies. A complete add is 11 to 16 field
// products (some 3,000 to 4,200 IMAD slots) against 160 to 288 bytes of
// traffic per point, so bytes never bind. Design: one thread per point, the
// point formulas of g1.cuh entirely in registers; edge cases branch (rare,
// so warps stay converged) instead of computing every path.
//
// B5, B6 and B7 take field.cuh's carry-chain product (ChainArith), so that
// a 32x32 product costs the two multiply-add slots the bound counts, and a
// budget of 128 registers with no spills (__launch_bounds__(128, 4): four
// blocks of 128 threads an SM, so 2^16 points run in one wave on 132 SMs).
// B5's doubling path runs out of line and reads p again from memory, so
// neither p nor the doubling sets the register peak. B5 and B7 take their
// block size from the caller (32, 64 or 128 threads): a small launch takes
// smaller blocks so that it spreads over more SMs. B6 doubles each point
// `times` times in registers (the Horner loop of a weighted bucket sum is
// one launch). B4 keeps mont_mul / mont_sqr and 128-thread blocks.
#include <cuda_runtime.h>

#include "g1.cuh"

using namespace bn254;

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ void load_jac(Jac& p, const uint32_t* x,
                                         const uint32_t* y, const uint32_t* z,
                                         long long i) {
  fe_load(p.x, x + 8 * i);
  fe_load(p.y, y + 8 * i);
  fe_load(p.z, z + 8 * i);
}

__device__ __forceinline__ void store_jac(uint32_t* x, uint32_t* y,
                                          uint32_t* z, long long i,
                                          const Jac& p) {
  fe_store(x + 8 * i, p.x);
  fe_store(y + 8 * i, p.y);
  fe_store(z + 8 * i, p.z);
}

__global__ void __launch_bounds__(kThreads)
add_mixed_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                 const uint32_t* __restrict__ pz, const uint32_t* __restrict__ qx,
                 const uint32_t* __restrict__ qy, uint32_t* __restrict__ ox,
                 uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
                 long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Jac p, o;
  uint32_t x2[8], y2[8];
  load_jac(p, px, py, pz, i);
  fe_load(x2, qx + 8 * i);
  fe_load(y2, qy + 8 * i);
  jac_add_mixed(o, p, x2, y2);
  store_jac(ox, oy, oz, i, o);
}

// B5, B6 and B7: four blocks of up to 128 threads an SM, so at most 128
// registers a thread.
constexpr int kAddMaxThreads = 128;
constexpr int kMinBlocks = 4;

// B5's doubling path (p == q), out of line so that neither it nor p sets
// the register peak of the add: it reads p again and writes the result.
__device__ __noinline__ void double_row(const uint32_t* px, const uint32_t* py,
                                        const uint32_t* pz, uint32_t* ox,
                                        uint32_t* oy, uint32_t* oz,
                                        long long i) {
  Jac p, o;
  load_jac(p, px, py, pz, i);
  jac_double_t<ChainArith>(o, p);
  store_jac(ox, oy, oz, i, o);
}

__global__ void __launch_bounds__(kAddMaxThreads, kMinBlocks)
add_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
           const uint32_t* __restrict__ pz, const uint32_t* __restrict__ qx,
           const uint32_t* __restrict__ qy, const uint32_t* __restrict__ qz,
           uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
           uint32_t* __restrict__ oz, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Jac p, q, o;
  load_jac(p, px, py, pz, i);
  load_jac(q, qx, qy, qz, i);
  if (jac_add_unless_equal<ChainArith>(o, p, q)) {
    store_jac(ox, oy, oz, i, o);
  } else {
    double_row(px, py, pz, ox, oy, oz, i);
  }
}

__global__ void __launch_bounds__(kAddMaxThreads, kMinBlocks)
add_incomplete_kernel(const uint32_t* __restrict__ px,
                      const uint32_t* __restrict__ py,
                      const uint32_t* __restrict__ pz,
                      const uint32_t* __restrict__ qx,
                      const uint32_t* __restrict__ qy,
                      const uint32_t* __restrict__ qz,
                      uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                      uint32_t* __restrict__ oz, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Jac p, q, o;
  load_jac(p, px, py, pz, i);
  load_jac(q, qx, qy, qz, i);
  jac_add_incomplete_t<ChainArith>(o, p, q);
  store_jac(ox, oy, oz, i, o);
}

// B6: `times` doublings of each point in registers, one load and one store.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
double_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
              const uint32_t* __restrict__ pz, uint32_t* __restrict__ ox,
              uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
              long long n, int times) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Jac p;
  load_jac(p, px, py, pz, i);
  jac_double_times<ChainArith>(p, times);
  store_jac(ox, oy, oz, i, p);
}

unsigned blocks_for(long long n, int threads = kThreads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

extern "C" {

int g1_add_mixed(const void* px, const void* py, const void* pz,
                 const void* qx, const void* qy, void* ox, void* oy, void* oz,
                 long long n, void* stream) {
  add_mixed_kernel<<<blocks_for(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(px), static_cast<const uint32_t*>(py),
      static_cast<const uint32_t*>(pz), static_cast<const uint32_t*>(qx),
      static_cast<const uint32_t*>(qy), static_cast<uint32_t*>(ox),
      static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz), n);
  return (int)cudaGetLastError();
}

static int launch_add(bool complete, const void* px, const void* py,
                      const void* pz, const void* qx, const void* qy,
                      const void* qz, void* ox, void* oy, void* oz,
                      long long n, int threads, void* stream) {
  if (threads != 32 && threads != 64 && threads != kAddMaxThreads) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* a = static_cast<const uint32_t*>(px);
  const uint32_t* b = static_cast<const uint32_t*>(py);
  const uint32_t* c = static_cast<const uint32_t*>(pz);
  const uint32_t* d = static_cast<const uint32_t*>(qx);
  const uint32_t* e = static_cast<const uint32_t*>(qy);
  const uint32_t* f = static_cast<const uint32_t*>(qz);
  uint32_t* x = static_cast<uint32_t*>(ox);
  uint32_t* y = static_cast<uint32_t*>(oy);
  uint32_t* z = static_cast<uint32_t*>(oz);
  if (complete) {
    add_kernel<<<blocks_for(n, threads), threads, 0, s>>>(a, b, c, d, e, f,
                                                          x, y, z, n);
  } else {
    add_incomplete_kernel<<<blocks_for(n, threads), threads, 0, s>>>(
        a, b, c, d, e, f, x, y, z, n);
  }
  return (int)cudaGetLastError();
}

// threads: the block size, 32, 64 or 128 (the caller picks it from n).
int g1_add(const void* px, const void* py, const void* pz, const void* qx,
           const void* qy, const void* qz, void* ox, void* oy, void* oz,
           long long n, int threads, void* stream) {
  return launch_add(true, px, py, pz, qx, qy, qz, ox, oy, oz, n, threads,
                    stream);
}

int g1_add_incomplete(const void* px, const void* py, const void* pz,
                      const void* qx, const void* qy, const void* qz,
                      void* ox, void* oy, void* oz, long long n, int threads,
                      void* stream) {
  return launch_add(false, px, py, pz, qx, qy, qz, ox, oy, oz, n, threads,
                    stream);
}

// times: the doublings a point, >= 1.
int g1_double(const void* px, const void* py, const void* pz, void* ox,
              void* oy, void* oz, long long n, int times, void* stream) {
  if (times < 1) return (int)cudaErrorInvalidValue;
  double_kernel<<<blocks_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(px), static_cast<const uint32_t*>(py),
      static_cast<const uint32_t*>(pz), static_cast<uint32_t*>(ox),
      static_cast<uint32_t*>(oy), static_cast<uint32_t*>(oz), n, times);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
