// Kernel B12: the t = 3 Poseidon permutation over BN254 Fr on a batch of
// states [n, 3, 8] (Montgomery, eight u32 limbs a lane).
//
// Replaces co_zkvms_tpu/ops/poseidon.py _permute_pallas_t3 (:224, body
// _poseidon_kernel :163). The TPU split the batch into three [16, BLK]
// limb-major lane blocks in VMEM and read the constants as SMEM scalars;
// none of that carries over. Here one thread owns one state: its 24 words
// stay in registers for all 65 rounds (poseidon.cuh), the state is read
// once and written once, and the constants rc [195, 8] and mds [9, 8] are
// read through const __restrict__ pointers at warp-uniform addresses
// (every thread of a warp reads the same word: a broadcast).
//
// Bound on the H100: integer multiplies. A permutation is 666 Montgomery
// products and 162 squares, about 209,520 32-bit multiply-add slots,
// against 192 bytes of state traffic, so bytes never bind. This simple
// version keeps the dense MDS in every partial round; the sparse
// partial-round matrices and several states a warp are later work.
#include <cuda_runtime.h>

#include "poseidon.cuh"

using namespace bn254;

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
poseidon_t3_kernel(const uint32_t* __restrict__ in,
                   const uint32_t* __restrict__ rc,
                   const uint32_t* __restrict__ mds,
                   uint32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t s[3][8];
#pragma unroll
  for (int k = 0; k < 3; k++) fe_load(s[k], in + 24 * i + 8 * k);
  poseidon_t3_permute(s, rc, mds);
#pragma unroll
  for (int k = 0; k < 3; k++) fe_store(out + 24 * i + 8 * k, s[k]);
}

}  // namespace

extern "C" {

int poseidon_permute_t3(const void* in, const void* rc, const void* mds,
                        void* out, long long n, void* stream) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  poseidon_t3_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const uint32_t*>(in), static_cast<const uint32_t*>(rc),
      static_cast<const uint32_t*>(mds), static_cast<uint32_t*>(out), n);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
