// Batched sr25519 (schnorrkel) verification on Hopper (sm_90a): comb warps,
// four threads per signature, one per coordinate of the accumulator, beside
// a decode warp whose lanes decode one signature's R each.
//
// Replaces the JAX package's device function _sr_verify_kernel
// (tendermint_tpu/ops/sr25519_batch.py:160, jitted XLA on the TPU) with the
// ristretto255 decode it calls (_ristretto_decode_dev :136, _sqrt_ratio_m1
// :119) and the mod-L reduction of the challenges (`challenges` :104, on
// the host there). Per signature: k mod L from the raw 64-byte merlin
// challenge, R' = [s]B + [k](-A) by the 64-step 4-tooth comb of the ed25519
// kernel (comb_group.cuh), the decode of the signature's R encoding to an
// affine (x, y), and the coset check X' y == Y' x or Y' y == X' x (RFC 9496
// 4.5; Z cancels, so no inversion), ANDed with the host's validity.
//
// What bounds it on this card: integer multiply throughput, as for ed25519.
// A signature needs 64 x 18 + 28 multiplies (100 products each), 64 x 4 +
// 257 squarings (55 each; the (p-5)/8 power inside the decode is 11 of the
// multiplies and 251 of the squarings) and 84 products for k mod L: 146,299
// wide products, against 133 bytes of per-signature input.
//
// The comb needs the four threads of a group; the decode of R is one serial
// chain that depends on R alone. Run on the four, as the first version of
// this kernel did, it was issued four times (a quarter of each lane's
// 52,539 products). Here a block holds SIGS signatures: COMB_WARPS warps of
// 8 groups run k mod L and the comb, and DECODE_WARPS warps decode the
// block's R encodings, DECODES_PER_LANE a lane, into shared memory (where
// the decode also parks its long-lived values, ristretto.cuh). The
// decode (16,535 products) is shorter than the comb (35,604), so the decode
// warps run beside the comb warps and are done before them: a comb warp
// waits at a named barrier (bar.sync 1) that the decode warps arrive at
// (bar.arrive 1) once their slots are stored, then runs the coset check on
// its group's slot. Issued per signature: 4 x (35,604 + 400) + 16,535 =
// 160,551 products, 1.10x what the signature needs (was 210,156, 1.44x).
// Lanes past n, lanes with validity 0 and out-of-range key indices run the
// comb on key 0 and write 0, and decode lanes past n decode column n - 1:
// no thread leaves before the barrier, and every shuffle names the whole
// warp.
//
// Inputs (device pointers; N lanes, Kb >= 1 keys):
//   tab     (Kb, 16, 3, 10) int32  per-key niels tables of -A (ristretto
//                                  decoded), canonical limbs
//   key_idx (N,)            int32
//   k64     (64, N)         uint8  wide merlin challenges
//   s32     (32, N)         uint8  s bytes, marker bit cleared
//   r32     (32, N)         uint8  R encodings
//   valid   (N,)            uint8  host validity (sizes, marker, s < L,
//                                  R < p and even, key decodes)
//   tab_b   (16, 3, 10)     int32  niels table of B
// Output: ok (N,) int32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "comb_group.cuh"
#include "ristretto.cuh"

// The block's shape: warps of each kind, decodes a decode lane runs, and the
// __launch_bounds__ minimum of resident blocks an SM must fit (which caps
// the registers a thread: ptxas gives each of an SM's four schedulers a
// quarter of the register file for the warps it holds, so 3 blocks of 5
// warps get 128 registers a thread, and the comb and the parked decode run
// in 128 without spilling). Chosen on an H100 by
// tools/ed25519_launch_sweep.py --kernel sr25519, which rewrites these four
// lines, by one rule: of the builds with no spill that beat the previous
// kernel at 3,072 and at 20,480 signatures, the fastest at 20,480. The
// sweep's two-launch variant (a decode kernel, then a comb kernel) is
// faster at 20,480 but slower than the previous kernel at 3,072; 3 comb
// warps a block are faster below 10,240 and slower from there (PERF.md).
#define COMB_WARPS 4
#define DECODE_WARPS 1
#define DECODES_PER_LANE 1
#define MIN_BLOCKS 3

#define THREADS (32 * (COMB_WARPS + DECODE_WARPS))
#define SIGS (8 * COMB_WARPS)
static_assert(SIGS <= 32 * DECODE_WARPS * DECODES_PER_LANE,
              "the decode lanes must cover the block's signatures");

// Named barrier 1 (0 is __syncthreads'): the decode warps arrive, the comb
// warps wait for all THREADS threads. Both order shared memory: the stores
// before bar.arrive are seen by the loads after bar.sync.
__device__ __forceinline__ void decoded_arrive() {
    asm volatile("bar.arrive 1, %0;" ::"n"(THREADS) : "memory");
}

__device__ __forceinline__ void decoded_wait() {
    asm volatile("bar.sync 1, %0;" ::"n"(THREADS) : "memory");
}

// Lane k's coordinate of signature sig's R' (key 0 when the lane is not
// active; *active says whether it is).
__device__ __forceinline__ fe sr_lane_comb(int sig, int k, const int32_t* tab,
                                           int n_keys, const int32_t* key_idx,
                                           const uint8_t* k64, const uint8_t* s32,
                                           const uint8_t* valid, const int32_t* sb,
                                           int n, bool* active) {
    const int col = sig < n ? sig : n - 1;
    int key = key_idx[col];
    *active = sig < n && valid[col] && key >= 0 && key < n_keys;
    if (!*active) key = 0;
    uint64_t kw[4], sw[4];
    lane_scalars(k64 + col, s32 + col, (size_t)n, kw, sw);
    return group_comb(k, tab + (size_t)key * TAB_INTS, sb, kw, sw);
}

// The coset check of the group's R' (v on each of its lanes) against the
// decoded slot at dec: 1 when R decodes and the points agree.
__device__ __forceinline__ int32_t sr_lane_check(const fe& v, const int32_t* dec,
                                                 int stride) {
    fe x, y;
    const int32_t r_ok = ristretto_decoded_load(dec, stride, &x, &y);
    return r_ok & ristretto_coset_eq(shfl4(v, 0), shfl4(v, 1), x, y);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
sr25519_verify_kernel(const int32_t* __restrict__ tab, int n_keys,
                      const int32_t* __restrict__ key_idx,
                      const uint8_t* __restrict__ k64,
                      const uint8_t* __restrict__ s32,
                      const uint8_t* __restrict__ r32,
                      const uint8_t* __restrict__ valid,
                      const int32_t* __restrict__ tab_b,
                      int32_t* __restrict__ ok, int n) {
    __shared__ int32_t sb[TAB_INTS];
    __shared__ int32_t dec[DEC_INTS * SIGS];
    __shared__ int32_t park[PARK_INTS * SIGS];
    for (int i = threadIdx.x; i < TAB_INTS; i += blockDim.x) sb[i] = tab_b[i];
    __syncthreads();

    const int base = blockIdx.x * SIGS;
    if (threadIdx.x >= 32 * COMB_WARPS) {
        // A decode lane: slots lane, lane + 32 DECODE_WARPS, ...
        const int lane = threadIdx.x - 32 * COMB_WARPS;
#pragma unroll 1
        for (int j = 0; j < DECODES_PER_LANE; j++) {
            const int slot = lane + 32 * DECODE_WARPS * j;
            const int col = base + slot < n ? base + slot : n - 1;
            if (slot < SIGS)
                ristretto_decode_store(r32 + col, (size_t)n, dec + slot, SIGS, park + slot,
                                       SIGS);
        }
        decoded_arrive();
    } else {
        const int slot = threadIdx.x >> 2, k = threadIdx.x & 3;
        const int sig = base + slot;
        bool active;
        const fe v = sr_lane_comb(sig, k, tab, n_keys, key_idx, k64, s32, valid, sb,
                                  n, &active);
        decoded_wait();
        const int32_t eq = sr_lane_check(v, dec + slot, SIGS);
        if (k == 0 && sig < n) ok[sig] = active && eq;
    }
}

extern "C" int tm_sr25519_verify(const void* tab, int n_keys, const void* key_idx,
                                 const void* k64, const void* s32,
                                 const void* r32, const void* valid,
                                 const void* tab_b, void* ok, int n,
                                 void* stream) {
    if (n <= 0) return 0;
    const int blocks = (n + SIGS - 1) / SIGS;
    sr25519_verify_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)tab, n_keys, (const int32_t*)key_idx,
        (const uint8_t*)k64, (const uint8_t*)s32, (const uint8_t*)r32,
        (const uint8_t*)valid, (const int32_t*)tab_b, (int32_t*)ok, n);
    return (int)cudaGetLastError();
}

// The kernel as built: info = {threads a block, registers a thread, local
// (spill) bytes a thread, blocks resident on one SM}. Returns a CUDA error.
extern "C" int tm_sr25519_kernel_info(int* info) {
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, sr25519_verify_kernel);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, sr25519_verify_kernel,
                                                        THREADS, 0);
    info[0] = THREADS;
    info[1] = a.numRegs;
    info[2] = (int)a.localSizeBytes;
    info[3] = blocks;
    return (int)err;
}

// The block's shape: shape = {comb warps, decode warps, decodes a decode
// lane, signatures a block}.
extern "C" void tm_sr25519_kernel_shape(int* shape) {
    shape[0] = COMB_WARPS;
    shape[1] = DECODE_WARPS;
    shape[2] = DECODES_PER_LANE;
    shape[3] = SIGS;
}
