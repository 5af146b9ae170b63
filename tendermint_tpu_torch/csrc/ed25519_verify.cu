// Batched ed25519 verification on Hopper (sm_90a): four threads per
// signature, one per coordinate of the accumulator.
//
// Replaces the Pallas TPU kernel tendermint_tpu/ops/ed25519_pallas.py:_kernel
// (:283, launched by pl.pallas_call at :342) together with the device
// prologue that feeds it in _verify_chunk (:478): per signature, h mod L
// from the raw SHA-512 digest and the comb windows of h and s, then
// R' = [s]B + [h](-A) by a 64-step 4-tooth comb (one doubling and two mixed
// niels adds a step), a Fermat inversion of Z, canonical x and y, and a
// compare with the signature's R bytes, ANDed with the host's validity.
//
// What bounds it on this card: integer multiply throughput. A field multiply
// is 100 32x32->64 products and a squaring 55 (fe25519.cuh); a signature
// needs 64 x (4 muls + 2 x 7 muls) + 11 (inversion) + 2 = 1,165 multiplies,
// 64 x 4 + 254 (inversion) = 510 squarings and 84 products for h mod L
// (sc25519.cuh): 144,634 wide products, against 133 bytes of per-signature
// input and a ~20 MB table that stays in L2. One thread per signature left
// too few warps to hide the latency of the serial multiply-and-carry chains
// (20,480 signatures gave ~1.2 warps per scheduler). So a signature runs on
// a group of four adjacent threads of a warp, each holding one of X, Y, Z, T
// (ed25519_lanes.cuh): 4x the warps, and each comb step is a chain of 6
// rounds instead of 22 field multiplies and squarings. Values cross between
// the threads of a group by __shfl_sync with width 4. The scalars' windows
// are taken from registers step by step and never stored; each thread
// reads its own part of the key's table row straight from device memory by
// key index, and the fixed-base table for B sits in shared memory.
//
// The inversion and the final compare run on all four threads of a group,
// redundantly: in a warp the four would otherwise wait for the one, so it
// costs no more time and needs no more shuffles. It is one serial chain of
// 265 field operations a warp, against 64 x 6 rounds of the comb, so the
// warps execute ~1.4x the products a signature needs; batching the inversion
// across signatures is the next step. Lanes past n, lanes with validity 0
// (failed host checks, padding) and out-of-range key indices run the same
// program on key 0 and write 0: no thread leaves early, so every shuffle
// names the whole warp.
//
// Inputs (device pointers; N lanes, Kb >= 1 keys):
//   tab     (Kb, 16, 3, 10) int32  per-key niels tables, canonical limbs
//   key_idx (N,)            int32
//   h64     (64, N)         uint8  SHA-512(R || A || M) digests
//   s32     (32, N)         uint8  S bytes
//   r32     (32, N)         uint8  R bytes
//   valid   (N,)            uint8
//   tab_b   (16, 3, 10)     int32  niels table of B
// Output: ok (N,) int32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ed25519_lanes.cuh"

// 32 signatures a block; at least 3 blocks resident per SM caps a thread at
// 168 registers. Fewer registers for more resident warps ran slower on an
// H100 (128 with 4 blocks; 96 with 5 spills), see
// tools/ed25519_launch_sweep.py and PERF.md.
#define THREADS 128
#define MIN_BLOCKS 3
#define TAB_INTS (16 * 3 * 10)

__device__ __forceinline__ fe shfl4(const fe& a, int src) {
    fe h;
#pragma unroll
    for (int i = 0; i < 10; i++) h.v[i] = __shfl_sync(0xffffffffu, a.v[i], src, 4);
    return h;
}

__device__ __forceinline__ fe group_double(int k, const fe& v) {
    const fe s = dbl_round1(k, v, shfl4(v, 0), shfl4(v, 1));
    const fe m = dbl_mid(k, shfl4(s, 0), shfl4(s, 1), shfl4(s, dbl_extra_src(k)));
    return ext_round2(k, m, shfl4(m, ext_src(k)), shfl4(m, 1));
}

__device__ __forceinline__ fe group_madd(int k, const fe& v, const int32_t* entry) {
    const fe r = madd_round1(k, v, shfl4(v, k ^ 1), fe_load(entry + madd_part(k)));
    const fe m = madd_mid(k, r, shfl4(r, k ^ 1));
    return ext_round2(k, m, shfl4(m, ext_src(k)), shfl4(m, 1));
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ed25519_verify_kernel(const int32_t* __restrict__ tab, int n_keys,
                      const int32_t* __restrict__ key_idx,
                      const uint8_t* __restrict__ h64,
                      const uint8_t* __restrict__ s32,
                      const uint8_t* __restrict__ r32,
                      const uint8_t* __restrict__ valid,
                      const int32_t* __restrict__ tab_b,
                      int32_t* __restrict__ ok, int n) {
    __shared__ int32_t sb[TAB_INTS];
    for (int i = threadIdx.x; i < TAB_INTS; i += blockDim.x) sb[i] = tab_b[i];
    __syncthreads();

    const int gid = blockIdx.x * blockDim.x + threadIdx.x;
    const int sig = gid >> 2, k = gid & 3;
    const int col = sig < n ? sig : n - 1;
    int key = key_idx[col];
    const bool active = sig < n && valid[col] && key >= 0 && key < n_keys;
    if (!active) key = 0;

    uint64_t hw[4], sw[4];
    lane_scalars(h64 + col, s32 + col, (size_t)n, hw, sw);
    const int32_t* ktab = tab + (size_t)key * TAB_INTS;
    fe v = lane_identity(k);
    for (int idx = 0; idx < 64; idx++) {
        v = group_double(k, v);
        v = group_madd(k, v, ktab + comb_window(hw, idx) * 30);
        v = group_madd(k, v, sb + comb_window(sw, idx) * 30);
    }
    const int32_t eq = encodes_to(shfl4(v, 0), shfl4(v, 1), shfl4(v, 2),
                                  r32 + col, (size_t)n);
    if (k == 0 && sig < n) ok[sig] = active && eq;
}

extern "C" int tm_ed25519_verify(const void* tab, int n_keys, const void* key_idx,
                                 const void* h64, const void* s32,
                                 const void* r32, const void* valid,
                                 const void* tab_b, void* ok, int n,
                                 void* stream) {
    if (n <= 0) return 0;
    const int blocks = (4 * n + THREADS - 1) / THREADS;
    ed25519_verify_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)tab, n_keys, (const int32_t*)key_idx,
        (const uint8_t*)h64, (const uint8_t*)s32, (const uint8_t*)r32,
        (const uint8_t*)valid, (const int32_t*)tab_b, (int32_t*)ok, n);
    return (int)cudaGetLastError();
}

// The kernel as built: info = {threads a block, registers a thread, local
// (spill) bytes a thread, blocks resident on one SM}. Returns a CUDA error.
extern "C" int tm_ed25519_kernel_info(int* info) {
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, ed25519_verify_kernel);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ed25519_verify_kernel,
                                                        THREADS, 0);
    info[0] = THREADS;
    info[1] = a.numRegs;
    info[2] = (int)a.localSizeBytes;
    info[3] = blocks;
    return (int)err;
}
