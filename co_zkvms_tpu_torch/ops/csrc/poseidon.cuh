// The t = 3 Poseidon permutation over BN254 Fr (x^5 S-box, R_F = 8 full
// rounds, R_P = 57 partial rounds), one state per thread, used by kernel
// B12 (poseidon.cu).
//
// The function is that of co_zkvms_tpu/ops/poseidon.py _poseidon_kernel
// (:163) and of the port's plain version ops/poseidon.py permute_plain;
// the schedule is the sparse one of ops/poseidon.py host_permute_sparse
// (Poseidon paper, eprint 2019/458, Appendix B):
//   - four full rounds: add the round's constants, x^5 on every lane, a
//     dense 3 x 3 product (the fourth round's matrix is pre_mds = B_0 M,
//     which carries the first partial round's diag(1, C_0) factor);
//   - add pre_rc, then 57 partial rounds: x^5 on lane 0, add the round's
//     lane-0 constant, and the sparse product
//       s0' = m00 s0 + row0 s1 + row1 s2,  s1' = s1 + col0 s0,
//       s2' = s2 + col1 s0                                  (5 products);
//   - four full rounds with M.
// Every value is a canonical residue, so the output is unique and equals
// the plain version's bit for bit.
//
// Products are field.cuh's carry-chain mul_cc (both operands < m, which
// holds: states and constants are canonical), with the constant as the
// operand whose words are taken one a step, and the S-box's two squares
// its sqr_cc (on an H100 the SOS square mont_sqr made the kernel 1.40x
// slower; PERF.md).
//
// The constants (PoseidonT3Consts, 387 elements, 12,384 bytes, Montgomery
// form) live in the constant bank on the card: every thread of a warp is in
// the same round at the same time, so each read is a broadcast. Host C++
// (no __CUDACC__) sees an ordinary static struct that its caller fills, so
// the permutation can be checked on a machine without nvcc.
#pragma once
#include "field.cuh"

#ifdef __CUDACC__
#define FBANK static __constant__
#else
#define FBANK static
#endif

namespace bn254 {

constexpr int FR_ID = 0;
constexpr int POSEIDON_T3_RF = 8;
constexpr int POSEIDON_T3_RP = 57;

// The layout of ops/poseidon.py t3_constant_words.
struct PoseidonT3Consts {
  uint32_t full_rc[POSEIDON_T3_RF][3][8];   // the full rounds, in order
  uint32_t pre_rc[3][8];                    // before the first partial S-box
  uint32_t partial_rc[POSEIDON_T3_RP][8];   // lane 0, after each partial S-box
  uint32_t sparse[POSEIDON_T3_RP][5][8];    // m00, row0, row1, col0, col1
  uint32_t mds[2][3][3][8];                 // [0] M, [1] pre_mds (row-major)
};

FBANK PoseidonT3Consts POSEIDON_T3_K;

// x <- x^5
FDEV void sbox5(uint32_t x[8]) {
  uint32_t x2[8];
  sqr_cc<FR_ID>(x2, x);
  sqr_cc<FR_ID>(x2, x2);
  mul_cc<FR_ID>(x, x, x2);
}

// Full round fr (0..7): s <- mds[m] * sbox(s + full_rc[fr]).
FDEV void poseidon_t3_full(uint32_t s[3][8], int fr, int m) {
#pragma unroll
  for (int i = 0; i < 3; i++) {
    mod_add<FR_ID>(s[i], s[i], POSEIDON_T3_K.full_rc[fr][i]);
    sbox5(s[i]);
  }
  uint32_t out[3][8], p[8];
#pragma unroll
  for (int i = 0; i < 3; i++) {
    mul_cc<FR_ID>(out[i], s[0], POSEIDON_T3_K.mds[m][i][0]);
#pragma unroll
    for (int j = 1; j < 3; j++) {
      mul_cc<FR_ID>(p, s[j], POSEIDON_T3_K.mds[m][i][j]);
      mod_add<FR_ID>(out[i], out[i], p);
    }
  }
#pragma unroll
  for (int i = 0; i < 3; i++) fe_copy(s[i], out[i]);
}

// Partial round k (0..56): x^5 and the lane-0 constant on lane 0, then the
// sparse product.
FDEV void poseidon_t3_partial(uint32_t s[3][8], int k) {
  const uint32_t(*sp)[8] = POSEIDON_T3_K.sparse[k];
  sbox5(s[0]);
  mod_add<FR_ID>(s[0], s[0], POSEIDON_T3_K.partial_rc[k]);
  uint32_t acc[8], p[8];
  mul_cc<FR_ID>(acc, s[0], sp[0]);
  mul_cc<FR_ID>(p, s[1], sp[1]);
  mod_add<FR_ID>(acc, acc, p);
  mul_cc<FR_ID>(p, s[2], sp[2]);
  mod_add<FR_ID>(acc, acc, p);
#pragma unroll
  for (int i = 1; i < 3; i++) {
    mul_cc<FR_ID>(p, s[0], sp[2 + i]);
    mod_add<FR_ID>(s[i], s[i], p);
  }
  fe_copy(s[0], acc);
}

// The whole permutation, in place. Loops, not unrolled rounds: the round
// bodies are the code size that matters.
FDEV void poseidon_t3_permute(uint32_t s[3][8]) {
  constexpr int half = POSEIDON_T3_RF / 2;
#pragma unroll 1
  for (int fr = 0; fr < half; fr++) {
    poseidon_t3_full(s, fr, fr == half - 1 ? 1 : 0);
  }
#pragma unroll
  for (int i = 0; i < 3; i++) {
    mod_add<FR_ID>(s[i], s[i], POSEIDON_T3_K.pre_rc[i]);
  }
#pragma unroll 1
  for (int k = 0; k < POSEIDON_T3_RP; k++) poseidon_t3_partial(s, k);
#pragma unroll 1
  for (int fr = half; fr < POSEIDON_T3_RF; fr++) {
    poseidon_t3_full(s, fr, 0);
  }
}

}  // namespace bn254
