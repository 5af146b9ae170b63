// ristretto255 for one CUDA thread (RFC 9496): the decode of an encoding to
// a point and the equality of two points, as the sr25519 verify kernel
// (sr25519_verify.cu) runs them. The counterpart of the JAX package's
// _ristretto_decode_dev, _sqrt_ratio_m1 and _ct_abs
// (tendermint_tpu/ops/sr25519_batch.py:136, :119, :112) and of the coset
// check of _sr_verify_kernel (:195-200).
//
// Every value is a carried field element (fe25519.cuh, bound B) or one of
// the canonical constants below (limbs in [0, 2^26), also in B), so every
// fe_mul input is in B and fe_canonical / fe_is_neg / fe_eq see carried or
// canonical limbs, the inputs ref10's reduction takes.
//
// Products (32x32->64) of one decode and check, counted from the program:
// fe_pow22523 251 squarings + 11 multiplies; besides it 6 squarings and 13
// multiplies in the decode (16,535 products in all) and 4 multiplies in the
// check (400).

#pragma once
#include "ed25519_lanes.cuh"

// Canonical limbs of d = -121665/121666, sqrt(-1) and -sqrt(-1) mod p.
__device__ __forceinline__ fe fe_const_d() {
    return fe{{56195235, 13857412, 51736253, 6949390, 114729, 24766616,
               60832955, 30306712, 48412415, 21499315}};
}

__device__ __forceinline__ fe fe_const_sqrt_m1() {
    return fe{{34513072, 25610706, 9377949, 3500415, 12389472, 33281959,
               41962654, 31548777, 326685, 11406482}};
}

__device__ __forceinline__ fe fe_const_neg_sqrt_m1() {
    return fe{{32595773, 7943725, 57730914, 30054016, 54719391, 272472,
               25146209, 2005654, 66782178, 22147949}};
}

// Bits 0..254 of the 32 little-endian bytes p[0], p[stride], ... as limbs
// (canonical when the value is below p; the host rejects the rest).
__device__ __forceinline__ fe fe_from_le(const uint8_t* p, size_t stride) {
    uint64_t w[4];
    load_le<4>(p, stride, w);
    fe h;
    int off = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
        const int width = (i & 1) ? 25 : 26;
        h.v[i] = (int32_t)bits_le(w, off, width);
        off += width;
    }
    return h;
}

// |h|: the canonical representative, negated when it is odd.
__device__ __forceinline__ fe fe_abs(const fe& h) {
    const fe c = fe_canonical(h);
    return fe_select(c.v[0] & 1, fe_sub(fe_small(0), c), c);
}

// The decode's values that live across its (p-5)/8 power (s, u1, u2, v,
// and SQRT_RATIO_M1's v and v^3): PARK_INTS ints, `stride` apart, that the
// caller provides. They are parked there through a volatile pointer, so the
// compiler keeps them in that memory and not in registers across the
// power's 262 dependent field operations: with them in registers the decode
// needed more than the 128 registers a thread that the sr25519 kernel's
// comb runs in, and spilled (PERF.md).
#define PARK_INTS 60

__device__ __forceinline__ void fe_park(volatile int32_t* p, int stride, const fe& a) {
#pragma unroll
    for (int i = 0; i < 10; i++) p[i * stride] = a.v[i];
}

__device__ __forceinline__ fe fe_unpark(const volatile int32_t* p, int stride) {
    fe h;
#pragma unroll
    for (int i = 0; i < 10; i++) h.v[i] = p[i * stride];
    return h;
}

// SQRT_RATIO_M1(1, v) (RFC 9496 4.2) with u = 1: returns was_square and
// puts |r| in *r, r^2 v = 1 when was_square. Parks v and v^3 at park
// (20 ints, `stride` apart).
__device__ __forceinline__ int32_t sqrt_ratio_m1_one(const fe& v, fe* r,
                                                     volatile int32_t* park, int stride) {
    const fe v3 = fe_mul(fe_sq(v), v);
    fe_park(park, stride, v);
    fe_park(park + 10 * stride, stride, v3);
    const fe v7 = fe_mul(fe_sq(v3), v);
    const fe r0 = fe_mul(fe_unpark(park + 10 * stride, stride), fe_pow22523(v7));
    const fe check = fe_mul(fe_unpark(park, stride), fe_sq(r0));
    const int32_t correct = fe_eq(check, fe_small(1));
    const int32_t flipped = fe_eq(check, fe_sub(fe_small(0), fe_small(1)));
    const int32_t flipped_i = fe_eq(check, fe_const_neg_sqrt_m1());
    *r = fe_abs(fe_select(flipped | flipped_i, fe_mul(r0, fe_const_sqrt_m1()), r0));
    return correct | flipped;
}

// Decode of the encoding s (RFC 9496 4.3.1) into affine (x, y); returns 1
// when s encodes a point. The host has already checked s < p and s even;
// here: the square root exists, t = x y is non-negative, and y != 0. park:
// PARK_INTS ints, `stride` apart (see PARK_INTS).
__device__ __forceinline__ int32_t ristretto_decode(const fe& s, fe* x, fe* y,
                                                    volatile int32_t* park, int stride) {
    const fe one = fe_small(1);
    const fe ss = fe_sq(s);
    const fe u1 = fe_sub(one, ss);
    const fe u2 = fe_add(one, ss);
    const fe u2_sqr = fe_sq(u2);
    // v = -(d u1^2) - u2^2
    const fe v = fe_sub(fe_small(0), fe_add(fe_mul(fe_const_d(), fe_sq(u1)), u2_sqr));
    fe_park(park, stride, s);
    fe_park(park + 10 * stride, stride, u1);
    fe_park(park + 20 * stride, stride, u2);
    fe_park(park + 30 * stride, stride, v);
    fe invsqrt;
    const int32_t was_square = sqrt_ratio_m1_one(fe_mul(v, u2_sqr), &invsqrt,
                                                 park + 40 * stride, stride);
    const fe den_x = fe_mul(invsqrt, fe_unpark(park + 20 * stride, stride));
    const fe den_y = fe_mul(fe_mul(invsqrt, den_x), fe_unpark(park + 30 * stride, stride));
    const fe s2 = fe_unpark(park, stride);
    *x = fe_abs(fe_mul(fe_add(s2, s2), den_x));
    *y = fe_mul(fe_unpark(park + 10 * stride, stride), den_y);
    const int32_t t_neg = fe_is_neg(fe_mul(*x, *y));
    const int32_t y_zero = fe_eq(*y, fe_small(0));
    return was_square & !t_neg & !y_zero;
}

// Ristretto equality of the projective point (X : Y : Z) and the affine
// (x, y) (RFC 9496 4.5, Z cancels): X y == Y x or Y y == X x.
__device__ __forceinline__ int32_t ristretto_coset_eq(const fe& X, const fe& Y,
                                                      const fe& x, const fe& y) {
    return fe_eq(fe_mul(X, y), fe_mul(Y, x)) | fe_eq(fe_mul(Y, y), fe_mul(X, x));
}

// A decoded R as the sr25519 kernel hands it from the thread that decodes
// to the threads that check: x, y (10 limbs each, as ristretto_decode left
// them) and the decode's verdict, DEC_INTS ints `stride` apart. With one
// slot a signature and the stride the number of slots, the slots form a
// structure of arrays: 32 lanes storing 32 consecutive slots touch 32
// different banks of shared memory. park: the decode's PARK_INTS ints,
// park_stride apart.
#define DEC_INTS 21

__device__ __forceinline__ void ristretto_decode_store(const uint8_t* r, size_t r_stride,
                                                       int32_t* dst, int stride,
                                                       volatile int32_t* park,
                                                       int park_stride) {
    fe x, y;
    const int32_t ok = ristretto_decode(fe_from_le(r, r_stride), &x, &y, park, park_stride);
#pragma unroll
    for (int i = 0; i < 10; i++) {
        dst[i * stride] = x.v[i];
        dst[(10 + i) * stride] = y.v[i];
    }
    dst[20 * stride] = ok;
}

// The slot that ristretto_decode_store wrote: x, y and the verdict.
__device__ __forceinline__ int32_t ristretto_decoded_load(const int32_t* src, int stride,
                                                          fe* x, fe* y) {
#pragma unroll
    for (int i = 0; i < 10; i++) {
        x->v[i] = src[i * stride];
        y->v[i] = src[(10 + i) * stride];
    }
    return src[20 * stride];
}
