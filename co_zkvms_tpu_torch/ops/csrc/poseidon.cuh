// The t = 3 Poseidon permutation over BN254 Fr (x^5 S-box, R_F = 8 full
// rounds, R_P = 57 partial rounds), one state per thread, used by kernel
// B12 (poseidon.cu).
//
// The rounds are those of co_zkvms_tpu/ops/poseidon.py _poseidon_kernel
// (:163) and of the port's plain version ops/poseidon.py permute_plain:
// add the round constants, x^5 (square, square, multiply) on every lane
// in a full round and on lane 0 only in a partial round, then the 3x3 MDS
// product with its terms summed in order j = 0, 1, 2. Every value is a
// canonical residue, so the output is unique and equals the plain
// version's bit for bit.
//
// rc is [(R_F + R_P) * 3][8] and mds [3 * 3][8] (row-major), both in
// Montgomery form. All threads read the same constant word at the same
// time, so on the card each read is one broadcast.
//
// Like field.cuh, the header also compiles as host C++ (FDEV -> inline),
// so the permutation can be checked on a machine without nvcc.
#pragma once
#include "field.cuh"

namespace bn254 {

constexpr int FR_ID = 0;
constexpr int POSEIDON_T3_RF = 8;
constexpr int POSEIDON_T3_RP = 57;

// x <- x^5
FDEV void sbox5(uint32_t x[8]) {
  uint32_t x2[8], x4[8];
  mont_sqr<FR_ID>(x2, x);
  mont_sqr<FR_ID>(x4, x2);
  mont_mul<FR_ID>(x, x4, x);
}

// One round: s <- MDS * sbox(s + rc_round); the S-box on every lane when
// ``full``, else on lane 0 only.
FDEV void poseidon_t3_round(uint32_t s[3][8], const uint32_t* rc_round,
                            const uint32_t* mds, bool full) {
  uint32_t c[8];
#pragma unroll
  for (int i = 0; i < 3; i++) {
    fe_copy(c, rc_round + 8 * i);
    mod_add<FR_ID>(s[i], s[i], c);
  }
  sbox5(s[0]);
  if (full) {
    sbox5(s[1]);
    sbox5(s[2]);
  }
  uint32_t out[3][8];
#pragma unroll
  for (int i = 0; i < 3; i++) {
    uint32_t p[8];
    fe_copy(c, mds + 8 * (3 * i));
    mont_mul<FR_ID>(out[i], c, s[0]);
#pragma unroll
    for (int j = 1; j < 3; j++) {
      fe_copy(c, mds + 8 * (3 * i + j));
      mont_mul<FR_ID>(p, c, s[j]);
      mod_add<FR_ID>(out[i], out[i], p);
    }
  }
#pragma unroll
  for (int i = 0; i < 3; i++) fe_copy(s[i], out[i]);
}

// The whole permutation, in place. A loop over the 65 rounds, not 65
// unrolled copies: the round body is the code size that matters.
FDEV void poseidon_t3_permute(uint32_t s[3][8], const uint32_t* rc,
                              const uint32_t* mds) {
  constexpr int half = POSEIDON_T3_RF / 2;
  constexpr int rounds = POSEIDON_T3_RF + POSEIDON_T3_RP;
#pragma unroll 1
  for (int rnd = 0; rnd < rounds; rnd++) {
    const bool full = rnd < half || rnd >= half + POSEIDON_T3_RP;
    poseidon_t3_round(s, rc + 24 * rnd, mds, full);
  }
}

}  // namespace bn254
