// Elementwise BN254 field kernels: Montgomery mul (B1), square (B2) and the
// modular add / sub of the B3 helpers, for Fr (fid 0) and Fq (fid 1).
//
// Replaces co_zkvms_tpu/ops/field_pallas.py mul_limb_major (:211, body
// _mul_kernel_body :201) and square_limb_major (:166, body _sq_kernel_body
// :157); add/sub are the _madd (:113) / _msub (:124) helpers, which the
// TPU ran inside its fused kernels and which torch cannot run on u32 limbs.
//
// Bound on the H100: mul and square are bound by integer multiply issue
// (CIOS is 128 wide products + 8 low products per element, about 264 IMAD
// slots, against 96 bytes of traffic); add/sub by bytes. Design: one
// thread per element, all limbs in registers, 16-byte vector loads and
// stores, no shared memory. Operand element strides let the callers read
// even/odd halves and a broadcast scalar (stride 0) without a copy.
#include <cuda_runtime.h>

#include "field.cuh"

using namespace bn254;

namespace {

constexpr int kThreads = 256;

enum Op { kMul, kAdd, kSub };

template <int F, int OP>
__global__ void __launch_bounds__(kThreads)
binary_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
              uint32_t* __restrict__ out, long long n, long long sa,
              long long sb) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[8], y[8], r[8];
  fe_load(x, a + 8 * i * sa);
  fe_load(y, b + 8 * i * sb);
  if (OP == kMul) {
    mont_mul<F>(r, x, y);
  } else if (OP == kAdd) {
    mod_add<F>(r, x, y);
  } else {
    mod_sub<F>(r, x, y);
  }
  fe_store(out + 8 * i, r);
}

template <int F>
__global__ void __launch_bounds__(kThreads)
unary_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
             long long n, long long sa) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[8], r[8];
  fe_load(x, a + 8 * i * sa);
  mont_sqr<F>(r, x);
  fe_store(out + 8 * i, r);
}

template <int OP>
int launch_binary(const void* a, const void* b, void* out, long long n,
                  long long sa, long long sb, int fid, void* stream) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* pa = static_cast<const uint32_t*>(a);
  const uint32_t* pb = static_cast<const uint32_t*>(b);
  uint32_t* po = static_cast<uint32_t*>(out);
  if (fid == 0) {
    binary_kernel<0, OP><<<blocks, kThreads, 0, s>>>(pa, pb, po, n, sa, sb);
  } else {
    binary_kernel<1, OP><<<blocks, kThreads, 0, s>>>(pa, pb, po, n, sa, sb);
  }
  return (int)cudaGetLastError();
}

int launch_square(const void* a, void* out, long long n, long long sa, int fid,
                 void* stream) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* pa = static_cast<const uint32_t*>(a);
  uint32_t* po = static_cast<uint32_t*>(out);
  if (fid == 0) {
    unary_kernel<0><<<blocks, kThreads, 0, s>>>(pa, po, n, sa);
  } else {
    unary_kernel<1><<<blocks, kThreads, 0, s>>>(pa, po, n, sa);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fp_mul(const void* a, const void* b, void* out, long long n, long long sa,
           long long sb, int fid, void* stream) {
  return launch_binary<kMul>(a, b, out, n, sa, sb, fid, stream);
}

int fp_add(const void* a, const void* b, void* out, long long n, long long sa,
           long long sb, int fid, void* stream) {
  return launch_binary<kAdd>(a, b, out, n, sa, sb, fid, stream);
}

int fp_sub(const void* a, const void* b, void* out, long long n, long long sa,
           long long sb, int fid, void* stream) {
  return launch_binary<kSub>(a, b, out, n, sa, sb, fid, stream);
}

int fp_square(const void* a, void* out, long long n, long long sa, int fid,
              void* stream) {
  return launch_square(a, out, n, sa, fid, stream);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
