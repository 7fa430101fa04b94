// Kernel B12: the t = 3 Poseidon permutation over BN254 Fr on a batch of
// states [n, 3, 8] (Montgomery, eight u32 limbs a lane).
//
// Replaces co_zkvms_tpu/ops/poseidon.py _permute_pallas_t3 (:224, body
// _poseidon_kernel :163). The TPU split the batch into three [16, BLK]
// limb-major lane blocks in VMEM and read the constants as SMEM scalars;
// none of that carries over. Here one thread owns one state: its 24 words
// stay in registers for all 65 rounds (poseidon.cuh), the state is read
// once and written once, and the constants sit in the constant bank
// (POSEIDON_T3_K), uploaded once a process and device by
// poseidon_t3_upload_constants before the first launch.
//
// Bound on the H100: integer multiplies. With sparse partial rounds a
// permutation is 438 Montgomery products and 162 squares, about 149,328
// 32-bit multiply-add slots (the dense schedule: 666 and 162, 209,520),
// against 192 bytes of state traffic, so bytes never bind. Carry-chain
// products (field.cuh mul_cc and sqr_cc) and a budget of 128 registers at
// 128 threads a block, so four blocks (16 warps) an SM. The budget is met
// through the launch bounds' block count: at (128, 4) ptxas schedules the
// kernel up to its cap of 128 registers and spills 4 bytes; at (128, 3) it
// takes 119 registers with no spills, which still fits four blocks, in the
// same time.
#include <cuda_runtime.h>

#include "poseidon.cuh"

using namespace bn254;

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads, 3)
poseidon_t3_kernel(const uint32_t* __restrict__ in,
                   uint32_t* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t s[3][8];
#pragma unroll
  for (int k = 0; k < 3; k++) fe_load(s[k], in + 24 * i + 8 * k);
  poseidon_t3_permute(s);
#pragma unroll
  for (int k = 0; k < 3; k++) fe_store(out + 24 * i + 8 * k, s[k]);
}

}  // namespace

extern "C" {

// Copies the constants (the words of ops/poseidon.py t3_constant_words,
// nbytes of them) into the constant bank of the current device and waits
// for the device, so that a launch on any stream reads them. Once a
// process and device. Returns cudaErrorInvalidValue if nbytes is not the
// struct's size.
int poseidon_t3_upload_constants(const void* words, size_t nbytes) {
  if (nbytes != sizeof(PoseidonT3Consts)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemcpyToSymbol(POSEIDON_T3_K, words, nbytes, 0,
                                       cudaMemcpyHostToDevice);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return (int)err;
}

int poseidon_permute_t3(const void* in, void* out, long long n,
                        void* stream) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  poseidon_t3_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), n);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
