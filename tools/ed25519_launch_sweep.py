"""Time the port's ed25519 (or sr25519) verify kernel built at other block
shapes and register caps: the answer to how registers and resident blocks
trade.

Each ed25519 variant is tendermint_tpu_torch/csrc/ed25519_verify.cu with
THREADS (threads a block) and MIN_BLOCKS (the __launch_bounds__ minimum of
resident blocks an SM must fit, which caps the registers) replaced. Each
sr25519 variant (`--kernel sr25519`) is sr25519_verify.cu with the block's
shape replaced: COMB_WARPS (warps of 8 four-thread signature groups),
DECODE_WARPS (warps that decode the block's R encodings), DECODES_PER_LANE
(decodes a decode lane runs) and MIN_BLOCKS; the kernel derives THREADS
from them. One more sr25519 variant is the two-launch alternative to the
decode warps: a decode kernel with one thread a signature that writes
(x, y, r_ok) to device memory, then a comb kernel that reads them, both at
the ed25519 kernel's launch bounds (128, 3) (TWO_LAUNCH_SRC below, on the
kernel's own device functions). Variants are built by nvcc in parallel into a temporary
directory. Timing inputs are random (the kernel runs the same program
whatever the data), with 10,240 keys. Every sr25519 variant is first held
against the plain version on seeded real signatures (valid, wrong message,
tweaked R and s, a wrong key) at lane counts that end inside a block.
Prints, per variant, the registers, local (spill) bytes and resident blocks
per SM that CUDA reports, ptxas's lines, and the kernel's ms at each of
SIZES (CUDA events, mean of 10 after a warm-up), beside the card's name
and power limit. With `--baseline DIR`
(which may be given more than once) the kernel's source in DIR (the csrc
directory of another checkout, say the parent commit's) is built as it is
and timed before the variants, and the first one again after them, for a
comparison inside one run. Needs a CUDA card and nvcc.

    python3 tools/ed25519_launch_sweep.py [--kernel ed25519|sr25519] [--baseline DIR]...
"""

import argparse
import ctypes
import os
import random
import re
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from tendermint_tpu_torch.crypto import sr25519 as sr  # noqa: E402
from tendermint_tpu_torch.ops import cbuild  # noqa: E402
from tendermint_tpu_torch.ops import ed25519_cuda as cu  # noqa: E402
from tendermint_tpu_torch.ops import sr25519_batch as srb  # noqa: E402
from tendermint_tpu_torch.ops import sr25519_cuda as scu  # noqa: E402

# (THREADS, MIN_BLOCKS) of the ed25519 kernel, which ships with (128, 3).
VARIANTS = [(128, 4), (128, 5), (128, 3), (64, 8), (64, 10), (256, 2), (128, 1),
            (128, 2)]
# (COMB_WARPS, DECODE_WARPS, DECODES_PER_LANE, MIN_BLOCKS) of the sr25519
# kernel, which ships with (4, 1, 1, 3); ("two-launch",) is the two-launch
# alternative.
SR_VARIANTS = [(4, 1, 1, 2), (4, 1, 1, 3), (3, 1, 1, 4), (4, 1, 1, 1), (8, 2, 1, 1),
               (8, 1, 2, 1), ("two-launch",)]
# Lane counts timed: the main path's sr25519 launches (config 4's commit,
# 300 lanes padded to 320; a 10,240 mixed commit's 3,072; its 20,480 batch's
# 6,144), one 10,240 commit, its 20,480 batch and four such batches.
SIZES = (320, 3_072, 6_144, 10_240, 20_480, 81_920)
N_KEYS = 10_240
# Lane counts of the sr25519 correctness check.
CHECK_LANES = (1, 31, 33, 101, 192)

TWO_LAUNCH_SRC = r"""
#include "sr25519_verify.cu"

// Decoded R of every lane, (DEC_INTS, n) in device memory.
#define TL_MAX_LANES 81920
__device__ int32_t tl_dec[DEC_INTS * TL_MAX_LANES];

__global__ void __launch_bounds__(128, 3)
tl_decode_kernel(const uint8_t* __restrict__ r32, int n) {
    __shared__ int32_t park[PARK_INTS * 128];
    const int sig = blockIdx.x * blockDim.x + threadIdx.x;
    if (sig < n)
        ristretto_decode_store(r32 + sig, (size_t)n, tl_dec + sig, n, park + threadIdx.x,
                               128);
}

__global__ void __launch_bounds__(128, 3)
tl_comb_kernel(const int32_t* __restrict__ tab, int n_keys,
               const int32_t* __restrict__ key_idx, const uint8_t* __restrict__ k64,
               const uint8_t* __restrict__ s32, const uint8_t* __restrict__ valid,
               const int32_t* __restrict__ tab_b, int32_t* __restrict__ ok, int n) {
    __shared__ int32_t sb[TAB_INTS];
    for (int i = threadIdx.x; i < TAB_INTS; i += blockDim.x) sb[i] = tab_b[i];
    __syncthreads();
    const int gid = blockIdx.x * blockDim.x + threadIdx.x;
    const int sig = gid >> 2, k = gid & 3;
    bool active;
    const fe v = sr_lane_comb(sig, k, tab, n_keys, key_idx, k64, s32, valid, sb, n,
                              &active);
    const int32_t eq = sr_lane_check(v, tl_dec + (sig < n ? sig : n - 1), n);
    if (k == 0 && sig < n) ok[sig] = active && eq;
}

extern "C" int tm_sr25519_two_launch_verify(
        const void* tab, int n_keys, const void* key_idx, const void* k64,
        const void* s32, const void* r32, const void* valid, const void* tab_b,
        void* ok, int n, void* stream) {
    if (n <= 0) return 0;
    if (n > TL_MAX_LANES) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    tl_decode_kernel<<<(n + 127) / 128, 128, 0, st>>>((const uint8_t*)r32, n);
    tl_comb_kernel<<<(4 * n + 127) / 128, 128, 0, st>>>(
        (const int32_t*)tab, n_keys, (const int32_t*)key_idx, (const uint8_t*)k64,
        (const uint8_t*)s32, (const uint8_t*)valid, (const int32_t*)tab_b,
        (int32_t*)ok, n);
    return (int)cudaGetLastError();
}

// info as tm_sr25519_kernel_info's, of the decode kernel (which = 0) or
// the comb kernel (1).
extern "C" int tm_sr25519_two_launch_info(int which, int* info) {
    const void* fn = which ? (const void*)tl_comb_kernel : (const void*)tl_decode_kernel;
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, fn);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, 128, 0);
    info[0] = 128;
    info[1] = a.numRegs;
    info[2] = (int)a.localSizeBytes;
    info[3] = blocks;
    return (int)err;
}
"""


def _start_build(mod, variant, root):
    """Copy the kernel's sources, set the variant's #defines (("baseline",
    DIR) takes DIR's sources as they are; ("two-launch",) adds the
    two-launch source) and start nvcc. Returns (process, library path)."""
    d = tempfile.mkdtemp(dir=root)
    csrc = variant[1] if variant[0] == "baseline" else cbuild.CSRC
    for name in mod.SOURCES:
        shutil.copy(os.path.join(csrc, name), d)
    path = os.path.join(d, mod.SOURCES[-1])
    if variant[0] == "baseline":
        pass
    elif variant[0] == "two-launch":
        path = os.path.join(d, "two_launch.cu")
        with open(path, "w") as f:
            f.write(TWO_LAUNCH_SRC)
    else:
        names = (("THREADS", "MIN_BLOCKS") if mod is cu else
                 ("COMB_WARPS", "DECODE_WARPS", "DECODES_PER_LANE", "MIN_BLOCKS"))
        with open(path) as f:
            src = f.read()
        for name, value in zip(names, variant):
            src, count = re.subn(rf"#define {name} \d+", f"#define {name} {value}", src)
            if count != 1:
                raise SystemExit(f"{mod.SOURCES[-1]}: no single #define {name}")
        with open(path, "w") as f:
            f.write(src)
    so = os.path.join(d, "lib.so")
    proc = subprocess.Popen([cbuild.nvcc(), *cbuild.NVCC_FLAGS, "-o", so, path],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, so


def _c_fn(lib, name, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


_VP, _CI = ctypes.c_void_p, ctypes.c_int
_VERIFY_ARGS = [_VP, _CI, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _CI, _VP]


def _bind(mod, variant, so):
    """The variant's verify function and a description of its build."""
    kname = "ed25519" if mod is cu else "sr25519"
    if variant[0] == "baseline":
        lib = ctypes.CDLL(so)
        info = cu.read_kernel_info(_c_fn(lib, f"tm_{kname}_kernel_info", [_VP]),
                                   "baseline")
        return _c_fn(lib, f"tm_{kname}_verify", _VERIFY_ARGS), (
            f"baseline {variant[1]} ({info['threads']} threads): regs "
            f"{info['registers']} local {info['local_bytes']} B blocks/SM "
            f"{info['blocks_per_sm']}")
    if variant[0] == "two-launch":
        lib = ctypes.CDLL(so)
        info_fn = _c_fn(lib, "tm_sr25519_two_launch_info", [_CI, _VP])
        parts = []
        for which, label in ((0, "decode kernel"), (1, "comb kernel")):
            info = cu.read_kernel_info(lambda p, w=which: info_fn(w, p), label)
            parts.append(f"{label} (128, 3): regs {info['registers']} local "
                         f"{info['local_bytes']} B blocks/SM {info['blocks_per_sm']}")
        return (_c_fn(lib, "tm_sr25519_two_launch_verify", _VERIFY_ARGS),
                "two launches: " + "; ".join(parts))
    lib = mod.bind(so)
    info = mod.kernel_info(lib)
    if mod is cu:
        name = f"THREADS {variant[0]} MIN_BLOCKS {variant[1]}"
    else:
        name = (f"comb warps {info['comb_warps']} decode warps "
                f"{info['decode_warps']} x {info['decodes_per_lane']} "
                f"({info['threads']} threads) MIN_BLOCKS {variant[3]}")
    return getattr(lib, f"tm_{kname}_verify"), (
        f"{name}: regs {info['registers']} local {info['local_bytes']} B "
        f"blocks/SM {info['blocks_per_sm']}")


def _call(fn, tab, tb, a, ok, m):
    err = fn(tab.data_ptr(), tab.shape[0], a["key_idx"].data_ptr(), a["d64"].data_ptr(),
             a["s32"].data_ptr(), a["r32"].data_ptr(), a["valid"].data_ptr(),
             tb.data_ptr(), ok.data_ptr(), m, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch: CUDA error {err}")


def _time(fn, tab, tb, cols, m):
    dev = tab.device
    a = {k: v[..., :m].contiguous().to(dev) for k, v in cols.items()}
    ok = torch.empty((m,), dtype=torch.int32, device=dev)
    _call(fn, tab, tb, a, ok, m)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        _call(fn, tab, tb, a, ok, m)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 10


def _sr_check_batch(dev):
    """Seeded real sr25519 signatures over 8 keys, every third one made
    invalid, as the kernel's arguments (tab, cols), and the plain version's
    bitmap."""
    rng = random.Random(7)
    privs = [sr.gen_priv_key(bytes([9, i])) for i in range(8)]
    items = []
    for i in range(max(CHECK_LANES)):
        p = privs[i % 8]
        msg = b"sweep-%d|" % i + rng.randbytes(rng.randrange(0, 64))
        sig = bytearray(sr.sign(p.data, msg, rng_seed=rng.randbytes(32)))
        pub = p.pub_key().data
        kind = i % 12
        if kind == 1:
            msg += b"!"
        elif kind == 4:
            sig[rng.randrange(1, 32)] ^= 1 << rng.randrange(8)
        elif kind == 7:
            sig[32 + rng.randrange(31)] ^= 1 << rng.randrange(8)
        elif kind == 10:
            pub = privs[(i + 1) % 8].pub_key().data
        items.append((pub, msg, bytes(sig)))
    ks, key_idx, pub_ok = srb.lookup_keys(items, dev)
    tab, *rest = scu.lane_inputs(ks, key_idx, items, pub_ok, dev)
    cols = dict(zip(("key_idx", "d64", "s32", "r32", "valid"), rest))
    want = scu.verify_plain(tab, *rest)
    if not 0 < int(want.sum()) < len(items):
        raise SystemExit("sr25519 check batch: want a mix of valid and invalid")
    return tab, cols, want


def _check(fn, tab, tb, cols, want, label):
    for m in CHECK_LANES:
        a = {k: v[..., :m].contiguous() for k, v in cols.items()}
        ok = torch.full((m,), 7, dtype=torch.int32, device=tab.device)
        _call(fn, tab, tb, a, ok, m)
        want_m = scu.verify_plain(tab, *a.values())
        if not torch.equal(ok, want_m) or not torch.equal(want_m, want[:m]):
            raise SystemExit(f"{label}: kernel != plain version at {m} lanes")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=("ed25519", "sr25519"), default="ed25519")
    ap.add_argument("--baseline", metavar="DIR", action="append", default=[],
                    help="also time DIR's kernel source as it is, before the "
                    "variants (the first DIR also after them)")
    opts = ap.parse_args()
    kernel = opts.kernel
    mod, variants = (cu, VARIANTS) if kernel == "ed25519" else (scu, SR_VARIANTS)
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    root = tempfile.mkdtemp()
    try:
        builds = [(v, *_start_build(mod, v, root)) for v in variants]
        bases = [(("baseline", d), *_start_build(mod, ("baseline", d), root))
                 for d in opts.baseline]
        builds = bases + builds + bases[:1]
        g = torch.Generator().manual_seed(5)
        n = max(SIZES)
        tab = torch.randint(0, 1 << 25, (N_KEYS, 16, 3, 10), generator=g,
                            dtype=torch.int32).to(dev)
        cols = dict(
            key_idx=torch.randint(0, N_KEYS, (n,), generator=g, dtype=torch.int32),
            d64=torch.randint(0, 256, (64, n), generator=g, dtype=torch.uint8),
            s32=torch.randint(0, 256, (32, n), generator=g, dtype=torch.uint8),
            r32=torch.randint(0, 256, (32, n), generator=g, dtype=torch.uint8),
            valid=torch.ones((n,), dtype=torch.uint8))
        tb = cu.tab_b10(dev)
        check = _sr_check_batch(dev) if mod is scu else None
        print(f"{kernel} kernel; card: {torch.cuda.get_device_name(0)} | {smi}")
        for variant, proc, so in builds:
            log = proc.communicate()[0] if proc.returncode is None else ""
            if proc.returncode:
                raise SystemExit(f"{variant}: nvcc failed\n{log}")
            ptxas = [ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln]
            fn, label = _bind(mod, variant, so)
            if check is not None:
                _check(fn, check[0], tb, check[1], check[2], label)
            times = [_time(fn, tab, tb, cols, m) for m in SIZES]
            print(f"{label} | " + ", ".join(f"{m}: {t:.3f} ms" for m, t in zip(SIZES, times))
                  + (" | kernel == plain at " + "/".join(map(str, CHECK_LANES))
                     + " lanes" if check is not None else "")
                  + " | " + " / ".join(ptxas), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
