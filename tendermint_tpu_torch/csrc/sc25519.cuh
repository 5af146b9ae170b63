// Scalars for one CUDA thread: little-endian byte loads, the reduction of a
// 512-bit SHA-512 digest mod L, and the 4-tooth comb windows of a scalar.
//
// L = 2^252 + DELTA, DELTA = 27742317777372353535851937790883648493 < 2^125,
// so 2^252 === -DELTA (mod L). In signed 21-bit limbs (ref10's sc_reduce
// constants)
//
//   -DELTA = sum_k MU_k 2^(21 k),
//   MU = (666643, 470296, 654183, -997805, 136657, -683901), |MU_k| < 2^20.
//
// sc_reduce holds a value as 24 int64 limbs s_i of weight 2^(21 i). Folding
// limb i >= 12 replaces s_i 2^(21 i) = s_i 2^(21 (i-12)) 2^252 by
// s_i 2^(21 (i-12)) (-DELTA): an exact congruence mod L that adds s_i MU_k to
// limb i - 12 + k (k = 0..5) and clears limb i. Each fold is six 32x32->64
// products, so it needs |s_i| < 2^31.
//
// Bound argument (limb ranges after each step):
//   load             s_0..s_22 in [0, 2^21), s_23 in [0, 2^29) (bits
//                    483..511).
//   fold 23..18      each adds to limbs 6..16 only, so every folded limb is
//                    a loaded one; a limb takes at most 6 terms of
//                    |.| <= 2^29 * 2^20: |s_6..s_16| < 2^50. s_17 untouched.
//   round 6..16      rounding carries into limb 17: s_6..s_16 in
//                    [-2^20, 2^20), each carry |c| < 2^29 + 2^9, so
//                    |s_17| < 2^21 + 2^29 + 2^9 < 2^30.
//   fold 17..12      adds to limbs 0..10 only: one term from s_17
//                    (< 2^50), five from s_12..s_16 (< 2^40 each), so
//                    |s_0..s_10| < 2^21 + 2^50 + 5 * 2^40 < 2^51; s_11 in
//                    [-2^20, 2^20).
//   round 0..11      rounding carries into limb 12 (cleared by its fold):
//                    s_0..s_11 in [-2^20, 2^20), |carries| < 2^30 + 2^11,
//                    so |s_12| < 2^31.
//   fold 12          the value is v = lo + s_12 (-DELTA) with
//                    lo = sum_{k<12} s_k 2^(21 k), |lo| <= 2^20 (2^252 - 1)
//                    / (2^21 - 1) < 2^251 (1 + 2^-20), |s_12 DELTA| < 2^156:
//                    |v| < 2^251.01.
//   floor 0..11      floor carries into limb 12: s_0..s_11 in [0, 2^21),
//                    s_12 = floor(v / 2^252) in {-1, 0}.
//   fold 12          v' = (v mod 2^252) - s_12 DELTA: v' = v in [0, 2^252)
//                    when s_12 = 0, v' = v + L in (0, L) when s_12 = -1
//                    (v > -2^251.01 > -L). So v' in [0, L): the residue.
//   floor 0..10      s_0..s_10 in [0, 2^21), s_11 = floor(v' / 2^231)
//                    in [0, 2^22): the canonical limbs, packed into words.
// 14 folds: 84 products a digest.

#pragma once
#include <stddef.h>
#include <stdint.h>

// NW little-endian words from the bytes p[0], p[stride], p[2 stride], ...
template <int NW>
__device__ __forceinline__ void load_le(const uint8_t* p, size_t stride,
                                        uint64_t w[NW]) {
#pragma unroll
    for (int k = 0; k < NW; k++) {
        w[k] = 0;
#pragma unroll
        for (int b = 0; b < 8; b++) w[k] |= (uint64_t)p[(8 * k + b) * stride] << (8 * b);
    }
}

// Bits [off, off + width) of a little-endian multi-word value, width <= 32;
// the next word is read only when the field crosses into it.
__device__ __forceinline__ uint32_t bits_le(const uint64_t* w, int off, int width) {
    const int k = off >> 6, s = off & 63;
    uint64_t v = w[k] >> s;
    if (s + width > 64) v |= w[k + 1] << (64 - s);
    return (uint32_t)(v & ((1ULL << width) - 1));
}

__device__ __forceinline__ void sc_fold(int64_t s[24], int i) {
    const int32_t MU[6] = {666643, 470296, 654183, -997805, 136657, -683901};
    const int32_t m = (int32_t)s[i];
    s[i] = 0;
#pragma unroll
    for (int k = 0; k < 6; k++) s[i - 12 + k] += (int64_t)m * MU[k];
}

// Rounding carries from limb lo up into limb hi: limbs lo..hi-1 end in
// [-2^20, 2^20).
__device__ __forceinline__ void sc_carry_round(int64_t s[24], int lo, int hi) {
#pragma unroll
    for (int k = lo; k < hi; k++) {
        const int64_t c = (s[k] + (1 << 20)) >> 21;
        s[k + 1] += c;
        s[k] -= c * (1 << 21);
    }
}

// Floor carries from limb lo up into limb hi: limbs lo..hi-1 end in
// [0, 2^21).
__device__ __forceinline__ void sc_carry_floor(int64_t s[24], int lo, int hi) {
#pragma unroll
    for (int k = lo; k < hi; k++) {
        const int64_t c = s[k] >> 21;  // arithmetic shift: floor
        s[k + 1] += c;
        s[k] -= c * (1 << 21);
    }
}

// d (512 bits, 8 words) mod L, in [0, L), as 4 words. Bounds above.
__device__ __forceinline__ void sc_reduce(const uint64_t d[8], uint64_t out[4]) {
    int64_t s[24];
#pragma unroll
    for (int i = 0; i < 23; i++) s[i] = bits_le(d, 21 * i, 21);
    s[23] = bits_le(d, 483, 29);
#pragma unroll
    for (int i = 23; i >= 18; i--) sc_fold(s, i);
    sc_carry_round(s, 6, 17);
#pragma unroll
    for (int i = 17; i >= 12; i--) sc_fold(s, i);
    sc_carry_round(s, 0, 12);
    sc_fold(s, 12);
    sc_carry_floor(s, 0, 12);
    sc_fold(s, 12);
    sc_carry_floor(s, 0, 11);
#pragma unroll
    for (int k = 0; k < 4; k++) out[k] = 0;
#pragma unroll
    for (int i = 0; i < 12; i++) {
        const uint64_t v = (uint64_t)s[i];  // < 2^21, s_11 < 2^22
        const int k = (21 * i) >> 6, sh = (21 * i) & 63;
        out[k] |= v << sh;
        if (sh + 22 > 64) out[k + 1] |= v >> (64 - sh);
    }
}

// Comb window of step idx (0..63, the order the comb runs in) of the scalar
// w: w_j = b_j + 2 b_{64+j} + 4 b_{128+j} + 8 b_{192+j} with j = 63 - idx.
__device__ __forceinline__ int comb_window(const uint64_t w[4], int idx) {
    const int j = 63 - idx;
    return (int)((w[0] >> j) & 1) | (int)((w[1] >> j) & 1) << 1
         | (int)((w[2] >> j) & 1) << 2 | (int)((w[3] >> j) & 1) << 3;
}
