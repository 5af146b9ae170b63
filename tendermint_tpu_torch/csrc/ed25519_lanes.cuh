// One ed25519 signature on a group of four threads: the per-thread program
// of the verify kernel (ed25519_verify.cu), written round by round.
//
// Thread k = 0..3 of the group holds coordinate k of the comb accumulator
// in extended coordinates (X : Y : Z : T), x = X/Z, y = Y/Z, xy = T/Z, as
// one whole field element (fe25519.cuh). The point formulas are split over
// the four coordinates as in Hisil, Wong, Carter, Dawson, "Twisted Edwards
// Curves Revisited" (2008), section 4, the 4-way parallel form that
// curve25519-dalek's vector backend uses: each doubling and each mixed add
// is two rounds of one field multiply (or squaring) per thread.
//
// Every round below is a function of the thread's index k and of values it
// holds. Between rounds a thread reads values of other threads of its group;
// the comment of each function names them ("lane j's s" = the value s that
// thread j of the group computed). In the kernel that read is __shfl_sync
// with width 4; the host test calls the same functions for k = 0..3 and
// reads from arrays. A round never branches on k: operands are picked with
// fe_select and then every thread runs the same multiply.
//
// Doubling (dbl-2008-hwcd, a = -1), with
//   S = (X^2, Y^2, Z^2, (X + Y)^2),
//   H = S0 + S1, E = H - S3, G = S0 - S1, F = G + 2 S2:
//   round 1  lane k squares: X, Y, Z, X + Y            -> S_k
//   between  lane k forms M_k: E, H, F, G
//   round 2  lane k multiplies: E F, G H, F G, E H     -> X3, Y3, Z3, T3
// Mixed add of an affine point in niels form (y+x, y-x, 2dxy):
//   round 1  lane k: (Y - X)(y-x), (Y + X)(y+x), T 2dxy, 2 Z  -> R = A, B, C, D
//   between  lane k forms M_k: E = B - A, H = B + A, F = D - C, G = D + C
//   round 2  as the doubling's.
// Per signature that is 4 squarings + 4 multiplies a doubling and 8
// multiplies a mixed add, where one thread did 4 + 4 and 7: lane 3's
// multiply by 2 in round 1 of a mixed add is the only added work, and the
// serial chain of a comb step falls from 22 field multiplies and squarings
// to 6 rounds.

#pragma once
#include "fe25519.cuh"
#include "sc25519.cuh"

// Lane k's coordinate of the identity (0 : 1 : 1 : 0).
__device__ __forceinline__ fe lane_identity(int k) {
    fe h;
#pragma unroll
    for (int i = 0; i < 10; i++) h.v[i] = (i == 0) && (k == 1 || k == 2);
    return h;
}

__device__ __forceinline__ fe fe_small(int32_t c) {
    fe h;
#pragma unroll
    for (int i = 0; i < 10; i++) h.v[i] = i == 0 ? c : 0;
    return h;
}

// ---- doubling ----

// Round 1. x, y: lanes 0 and 1's coordinates (X, Y). Returns S_k.
__device__ __forceinline__ fe dbl_round1(int k, const fe& own, const fe& x,
                                         const fe& y) {
    return fe_sq(fe_select(k == 3, fe_add(x, y), own));
}

// The lane whose S lane k reads as `e` in dbl_mid: S3 for lane 0 (E), S2
// for lane 2 (F, its own); lanes 1 and 3 need none and read their own.
__device__ __forceinline__ int dbl_extra_src(int k) { return k == 0 ? 3 : k; }

// Between the rounds. s0, s1: lanes 0 and 1's S; e: lane dbl_extra_src(k)'s
// S. Returns M_k = E, H, F, G = S0 + S1 - S3, S0 + S1, S0 - S1 + 2 S2, S0 - S1.
__device__ __forceinline__ fe dbl_mid(int k, const fe& s0, const fe& s1,
                                      const fe& e) {
    return fe_lin(s0, s1, k < 2 ? 1 : -1, e, k == 0 ? -1 : (k == 2 ? 2 : 0));
}

// ---- mixed add ----

// Offset in a niels entry (y+x, y-x, 2dxy; 10 limbs each) of the part that
// lane k multiplies by in round 1; lane 3 multiplies by 2 instead.
__device__ __forceinline__ int madd_part(int k) {
    return k == 0 ? 10 : (k == 2 ? 20 : 0);
}

// Round 1. o: lane k ^ 1's coordinate (lane 0 gets Y, 1 X, 2 T, 3 Z);
// q: this lane's part of the entry (madd_part). Returns R_k = A, B, C, D.
__device__ __forceinline__ fe madd_round1(int k, const fe& own, const fe& o,
                                          const fe& q) {
    const fe a = fe_lin(o, own, k == 0 ? -1 : (k == 1 ? 1 : 0));
    return fe_mul(a, fe_select(k == 3, fe_small(2), q));
}

// Between the rounds. p: lane k ^ 1's R. Returns M_k = E, H, F, G
// = R1 - R0, R0 + R1, R3 - R2, R2 + R3.
__device__ __forceinline__ fe madd_mid(int k, const fe& r, const fe& p) {
    return fe_lin(p, r, (k & 1) ? 1 : -1);
}

// ---- round 2 of both ----

// The lane whose M lane k reads as `a` in ext_round2: F, G, G, E.
__device__ __forceinline__ int ext_src(int k) { return k == 0 ? 2 : (k == 3 ? 0 : 3); }

// a: lane ext_src(k)'s M; b: lane 1's M (H). Returns lane k's coordinate of
// the result: E F, H G, F G, H E = X3, Y3, Z3, T3.
__device__ __forceinline__ fe ext_round2(int k, const fe& m, const fe& a,
                                         const fe& b) {
    return fe_mul(fe_select(k == 3, b, m), a);
}

// ---- the signature's scalars and the final compare ----

// h (the 64 digest bytes, reduced mod L here) and s (32 bytes) of one
// signature as 4 words each; byte b of either is at p[b * stride].
__device__ __forceinline__ void lane_scalars(const uint8_t* h64, const uint8_t* s32,
                                             size_t stride, uint64_t hw[4],
                                             uint64_t sw[4]) {
    uint64_t d[8];
    load_le<8>(h64, stride, d);
    sc_reduce(d, hw);
    load_le<4>(s32, stride, sw);
}

// 1 when the canonical encoding of (X/Z, Y/Z), y with the sign of x in bit
// 255, equals the 32 bytes at r[0], r[stride], ...
__device__ __forceinline__ int32_t encodes_to(const fe& X, const fe& Y, const fe& Z,
                                              const uint8_t* r, size_t stride) {
    const fe zinv = fe_invert(Z);
    const fe x = fe_canonical(fe_mul(X, zinv));
    const fe y = fe_canonical(fe_mul(Y, zinv));
    uint64_t w[4];
    load_le<4>(r, stride, w);
    int32_t eq = (x.v[0] & 1) == (int32_t)(w[3] >> 63);
    int off = 0;
#pragma unroll
    for (int i = 0; i < 10; i++) {
        const int width = (i & 1) ? 25 : 26;
        eq &= y.v[i] == (int32_t)bits_le(w, off, width);  // bits 0..254
        off += width;
    }
    return eq;
}
