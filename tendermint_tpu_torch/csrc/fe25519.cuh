// GF(2^255-19) arithmetic for one CUDA thread.
//
// Field elements are 10 signed 32-bit limbs in radix 2^25.5 (ref10's form):
// limb i has weight 2^ceil(25.5 i) = 2^{0,26,51,77,102,128,153,179,204,230},
// so even limbs are nominally 26 bits wide and odd limbs 25. The layout is
// chosen for the card's 32x32->64 integer multiply: a product is 100 such
// multiplies accumulated in int64, a squaring 55.
//
// Bound argument (every stored element satisfies it):
//
//   B: |limb| <= 2^26.
//
// * fe_mul(f, g) with f, g in B. Precompute g19_j = 19 g_j (|.| <= 19*2^26
//   < 2^30.3, an int32) and f2_i = 2 f_i for odd i (<= 2^27). A product
//   f_i g_j lands on limb (i+j) mod 10; when i+j >= 10 it carries 2^255 ===
//   19 (mod p), so g19 is used; when i and j are both odd its weight is twice
//   that of limb i+j (25.5i+0.5 + 25.5j+0.5 = 25.5(i+j)+1), so f2 is used.
//   Each term is <= 2^27 * 2^30.3 = 2^57.3 in magnitude and a limb sums 10
//   of them: |t_k| < 2^60.7 < 2^63, exact in int64.
// * fe_carry(t) for |t_k| < 2^62: ref10's rounding carry chain. Afterwards
//   |even limb| <= 2^25 and |odd limb| <= 2^24, except that the last carries
//   add at most 2^37 * 19 / 2^26 < 2^15.3 to limb 1 and a small amount to
//   limb 5: every limb is within 2^25 + 2^16 < 2^26, so the result is in B.
// * fe_add / fe_sub of two elements of B: |t_k| <= 2^27, then fe_carry:
//   result in B. fe_lin(a, b, mb, c, mc) = a + mb b + mc c with
//   |mb| + |mc| <= 3: |t_k| <= 4 * 2^26 = 2^28, then fe_carry: in B. Every
//   operation ends in fe_carry, so every mul input is in B whatever chain of
//   adds and subs produced it.
// * fe_canonical(h) for carried h (|limbs| as after fe_carry): ref10's
//   fe_tobytes reduction; the result has limbs in [0, 2^26) / [0, 2^25) and
//   value in [0, p).
//
// Tables handed in by the host are canonical (non-negative, < 2^26): in B.

#pragma once
#include <stddef.h>
#include <stdint.h>

struct fe {
    int32_t v[10];
};

__device__ __forceinline__ fe fe_carry(int64_t t[10]) {
    int64_t c;
    c = (t[0] + (1LL << 25)) >> 26; t[1] += c; t[0] -= c * (1LL << 26);
    c = (t[4] + (1LL << 25)) >> 26; t[5] += c; t[4] -= c * (1LL << 26);
    c = (t[1] + (1LL << 24)) >> 25; t[2] += c; t[1] -= c * (1LL << 25);
    c = (t[5] + (1LL << 24)) >> 25; t[6] += c; t[5] -= c * (1LL << 25);
    c = (t[2] + (1LL << 25)) >> 26; t[3] += c; t[2] -= c * (1LL << 26);
    c = (t[6] + (1LL << 25)) >> 26; t[7] += c; t[6] -= c * (1LL << 26);
    c = (t[3] + (1LL << 24)) >> 25; t[4] += c; t[3] -= c * (1LL << 25);
    c = (t[7] + (1LL << 24)) >> 25; t[8] += c; t[7] -= c * (1LL << 25);
    c = (t[4] + (1LL << 25)) >> 26; t[5] += c; t[4] -= c * (1LL << 26);
    c = (t[8] + (1LL << 25)) >> 26; t[9] += c; t[8] -= c * (1LL << 26);
    c = (t[9] + (1LL << 24)) >> 25; t[0] += c * 19; t[9] -= c * (1LL << 25);
    c = (t[0] + (1LL << 25)) >> 26; t[1] += c; t[0] -= c * (1LL << 26);
    fe h;
#pragma unroll
    for (int i = 0; i < 10; i++) h.v[i] = (int32_t)t[i];
    return h;
}

__device__ __forceinline__ fe fe_add(const fe& a, const fe& b) {
    int64_t t[10];
#pragma unroll
    for (int i = 0; i < 10; i++) t[i] = (int64_t)a.v[i] + b.v[i];
    return fe_carry(t);
}

__device__ __forceinline__ fe fe_sub(const fe& a, const fe& b) {
    int64_t t[10];
#pragma unroll
    for (int i = 0; i < 10; i++) t[i] = (int64_t)a.v[i] - b.v[i];
    return fe_carry(t);
}

// a + mb b + mc c for small multipliers, |mb| + |mc| <= 3 (bound above).
__device__ __forceinline__ fe fe_lin(const fe& a, const fe& b, int32_t mb,
                                     const fe& c, int32_t mc) {
    int64_t t[10];
#pragma unroll
    for (int i = 0; i < 10; i++) t[i] = a.v[i] + mb * b.v[i] + mc * c.v[i];
    return fe_carry(t);
}

__device__ __forceinline__ fe fe_lin(const fe& a, const fe& b, int32_t mb) {
    return fe_lin(a, b, mb, b, 0);
}

// c ? a : b, limb by limb: a select, never a branch, so that the threads of
// a warp that pick differently do not diverge.
__device__ __forceinline__ fe fe_select(bool c, const fe& a, const fe& b) {
    fe h;
#pragma unroll
    for (int i = 0; i < 10; i++) h.v[i] = c ? a.v[i] : b.v[i];
    return h;
}

__device__ __forceinline__ fe fe_mul(const fe& f, const fe& g) {
    int32_t g19[10], f2[10];
#pragma unroll
    for (int i = 0; i < 10; i++) {
        g19[i] = 19 * g.v[i];
        f2[i] = (i & 1) ? 2 * f.v[i] : f.v[i];
    }
    int64_t t[10];
#pragma unroll
    for (int k = 0; k < 10; k++) t[k] = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
#pragma unroll
        for (int j = 0; j < 10; j++) {
            const int32_t fi = (j & 1) ? f2[i] : f.v[i];
            const int32_t gj = (i + j >= 10) ? g19[j] : g.v[j];
            t[(i + j) % 10] += (int64_t)fi * gj;
        }
    }
    return fe_carry(t);
}

// f^2 in 55 products (ref10's fe_sq): fe_mul(f, f)'s ordered terms (i, j)
// and (j, i) are equal, so each unordered pair i < j is taken once with its
// weight doubled. A term is a_i * b_j with a_i = m f_i, m in {1, 2, 4}
// (2 for i < j, again 2 when i and j are both odd), |a_i| <= 2^28, and
// b_j = f_j or 19 f_j, |b_j| < 2^30.3: each product is < 2^58.3, and every
// partial sum of limb k is a partial sum of fe_mul(f, f)'s terms for that
// limb, so |t_k| < 2^60.7 as in fe_mul.
__device__ __forceinline__ fe fe_sq(const fe& f) {
    int64_t t[10];
#pragma unroll
    for (int k = 0; k < 10; k++) t[k] = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
#pragma unroll
        for (int j = i; j < 10; j++) {
            const int32_t m = (i < j ? 2 : 1) * ((i & j & 1) ? 2 : 1);
            const int32_t a = m * f.v[i];
            const int32_t b = (i + j >= 10) ? 19 * f.v[j] : f.v[j];
            t[(i + j) % 10] += (int64_t)a * b;
        }
    }
    return fe_carry(t);
}

__device__ __forceinline__ fe fe_sqn(fe f, int n) {
    for (int i = 0; i < n; i++) f = fe_sq(f);
    return f;
}

// z^(p-2): the curve25519 addition chain (254 squarings, 11 multiplies).
__device__ __forceinline__ fe fe_invert(const fe& z) {
    fe z2 = fe_sq(z);
    fe z9 = fe_mul(z, fe_sqn(z2, 2));
    fe z11 = fe_mul(z2, z9);
    fe z_5_0 = fe_mul(z9, fe_sq(z11));
    fe z_10_0 = fe_mul(fe_sqn(z_5_0, 5), z_5_0);
    fe z_20_0 = fe_mul(fe_sqn(z_10_0, 10), z_10_0);
    fe z_40_0 = fe_mul(fe_sqn(z_20_0, 20), z_20_0);
    fe z_50_0 = fe_mul(fe_sqn(z_40_0, 10), z_10_0);
    fe z_100_0 = fe_mul(fe_sqn(z_50_0, 50), z_50_0);
    fe z_200_0 = fe_mul(fe_sqn(z_100_0, 100), z_100_0);
    fe z_250_0 = fe_mul(fe_sqn(z_200_0, 50), z_50_0);
    return fe_mul(fe_sqn(z_250_0, 5), z11);
}

// Canonical representative: limbs in [0, 2^26) / [0, 2^25), value < p.
__device__ __forceinline__ fe fe_canonical(fe h) {
    int32_t q = (19 * h.v[9] + (1 << 24)) >> 25;
#pragma unroll
    for (int i = 0; i < 10; i++) q = (h.v[i] + q) >> ((i & 1) ? 25 : 26);
    // q = floor(h / p) in {0, 1}: h - q p = h + 19 q - 2^255 q
    h.v[0] += 19 * q;
#pragma unroll
    for (int i = 0; i < 9; i++) {
        const int s = (i & 1) ? 25 : 26;
        const int32_t c = h.v[i] >> s;
        h.v[i + 1] += c;
        h.v[i] -= c * (1 << s);
    }
    h.v[9] &= (1 << 25) - 1;  // drops q * 2^255
    return h;
}

__device__ __forceinline__ fe fe_load(const int32_t* p) {
    fe h;
#pragma unroll
    for (int i = 0; i < 10; i++) h.v[i] = p[i];
    return h;
}
