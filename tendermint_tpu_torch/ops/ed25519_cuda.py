"""Batched ed25519 verification on the card: the CUDA kernel, its plain
PyTorch version, and the chunked dispatch.

The kernel (csrc/ed25519_verify.cu) replaces the JAX package's Pallas kernel
`ed25519_pallas._kernel` (tendermint_tpu/ops/ed25519_pallas.py:283, launched
at :342) and the device prologue of `_verify_chunk` (:478) that feeds it. It
computes the same function: per signature lane, h mod L from the raw SHA-512
digest and the comb windows of h and s, R' = [s]B + [h](-A) by a 64-step,
4-tooth comb (one doubling and two mixed niels adds a step), then a Fermat Z
inversion, canonical x and y, and a compare of y and sign(x) with the
signature's R bytes, ANDed with the host validity. Its layout is the card's,
not the TPU's: four threads per signature, one per coordinate X, Y, Z, T,
field elements in registers as 10 signed limbs (radix 2^25.5) multiplied
32x32->64, the per-key niels table read from device memory by key index, the
fixed-base table for B in shared memory. The bound arguments are written in
csrc/fe25519.cuh (field) and csrc/sc25519.cuh (mod L); the 4-thread program
in csrc/ed25519_lanes.cuh.

Inputs of both `verify` (the wrapper) and `verify_plain`:

    tab     (Kb, 16, 3, 10) int32  per-key niels comb tables in the kernel's
                                   limb form (KeySet.kernel_rows(); canonical)
    key_idx (N,)  int32            lane -> table row
    h64     (64, N) uint8          SHA-512(R || A || M) digests
    s32     (32, N) uint8          the signatures' S bytes
    r32     (32, N) uint8          the signatures' R bytes
    valid   (N,)  uint8            host validity (size, S < L, key decodes)
    ->      (N,)  int32            1 where the signature verifies

The kernel reduces h mod L and takes the windows itself. The torch prologue
below (mod-L reduction, comb windows, R limbs; the counterpart of
ed25519_pallas._reduce_mod_l_device / _windows_from_limbs12 /
_windows_device / _r_limbs_device) feeds only the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import torch

from tendermint_tpu_torch.ops import ed25519_batch as edb
from tendermint_tpu_torch.ops import edwards25519 as ed
from tendermint_tpu_torch.ops import field25519 as fe
from tendermint_tpu_torch.ops import scalar25519 as sc

P = fe.P

# Kernel limb form: limb i holds bits [OFF10[i], OFF10[i] + WID10[i]).
OFF10 = [0, 26, 51, 77, 102, 128, 153, 179, 204, 230]
WID10 = [26, 25, 26, 25, 26, 25, 26, 25, 26, 25]
OFF13 = [13 * i for i in range(fe.NLIMB)]
WID13 = [13] * fe.NLIMB

# Lanes per launch. Large enough that a 10k-validator commit (20,480
# prevote+precommit signatures) is one launch; larger batches loop.
CHUNK = 32768

# Launches of the CUDA kernel since the last reset (CPU calls never count).
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


# ---------------------------------------------------------------------------
# Limb forms
# ---------------------------------------------------------------------------


def _repack(x: torch.Tensor, src_off, src_wid, dst_off, dst_wid) -> torch.Tensor:
    """Re-split canonical non-negative limbs (..., len(src_off)) into another
    bit layout (..., len(dst_off)). Exact: source limbs occupy disjoint bit
    ranges, so summing shifted pieces is a bitwise OR."""
    x = x.to(torch.int64)
    out = []
    for o, w in zip(dst_off, dst_wid):
        acc = torch.zeros_like(x[..., 0])
        for k, (so, sw) in enumerate(zip(src_off, src_wid)):
            if so + sw <= o or so >= o + w:
                continue
            sh = so - o
            acc = acc + (x[..., k] << sh if sh >= 0 else x[..., k] >> -sh)
        out.append(acc & ((1 << w) - 1))
    return torch.stack(out, dim=-1).to(torch.int32)


def to_fe10(limbs13: torch.Tensor) -> torch.Tensor:
    """(..., 20) NORM radix-2^13 limbs -> (..., 10) canonical kernel limbs."""
    return _repack(fe.to_canonical(limbs13), OFF13, WID13, OFF10, WID10)


def from_fe10(limbs10: torch.Tensor) -> torch.Tensor:
    """(..., 10) canonical kernel limbs -> (..., 20) canonical radix-2^13."""
    return _repack(limbs10, OFF10, WID10, OFF13, WID13)


def kernel_table(niels_rows: torch.Tensor) -> torch.Tensor:
    """(Kb, 960) niels rows (the JAX layout) -> (Kb, 16, 3, 10) kernel form."""
    k = niels_rows.shape[0]
    return to_fe10(niels_rows.reshape(k, 16, 3, fe.NLIMB)).contiguous()


def _b_niels() -> np.ndarray:
    """Fixed-base niels comb table: TAB_B[w] = (y+x, y-x, 2dxy) of the comb
    point sum_j w_j [2^(64j)] B, (16, 3, 20) radix-2^13."""
    out = np.zeros((16, 3, fe.NLIMB), dtype=np.int32)
    for w, (x, y) in enumerate(edb.B_COMB_AFFINE):
        out[w, 0] = fe.from_int((y + x) % P)
        out[w, 1] = fe.from_int((y - x) % P)
        out[w, 2] = fe.from_int(2 * ed.D * x * y % P)
    return out


TAB_B_NIELS = _b_niels()
_TAB_B10: dict = {}


def tab_b10(device) -> torch.Tensor:
    """(16, 3, 10) kernel-form B table, cached per device."""
    key = str(device)
    t = _TAB_B10.get(key)
    if t is None:
        t = _TAB_B10[key] = to_fe10(
            torch.as_tensor(TAB_B_NIELS, device=device)).contiguous()
    return t


# ---------------------------------------------------------------------------
# Prologue of the plain version (torch ops, limb-major like the JAX device
# code)
# ---------------------------------------------------------------------------

_L_RADIX = 12
_L_NLIMB = 43  # 43 * 12 = 516 >= 512 bits
_DELTA12 = [(sc.DELTA >> (_L_RADIX * i)) & 0xFFF for i in range(11)]


def _digest_to_limbs12(d64: torch.Tensor) -> torch.Tensor:
    """(64, N) uint8 digest columns -> (43, N) int32 radix-2^12 limbs."""
    b = d64.to(torch.int32)
    limbs = []
    for j in range(_L_NLIMB):
        k, s = divmod(_L_RADIX * j, 8)
        v = b[k] >> s
        if k + 1 < 64:
            v = v | (b[k + 1] << (8 - s))
        if s + _L_RADIX > 16 and k + 2 < 64:
            v = v | (b[k + 2] << (16 - s))
        limbs.append(v & 0xFFF)
    return torch.stack(limbs)


def _carry_signed12(x: torch.Tensor, top: int) -> torch.Tensor:
    """Sequential signed floor-carry over rows 0..top-1, in place; row top-1
    absorbs the (possibly negative) residue."""
    carry = torch.zeros_like(x[0])
    for k in range(top):
        t = x[k] + carry
        carry = t >> _L_RADIX  # arithmetic shift = floor division
        x[k] = t - (carry << _L_RADIX)
    x[top - 1] += carry << _L_RADIX
    return x


def reduce_mod_l(d64: torch.Tensor) -> torch.Tensor:
    """(64, N) uint8 LE 512-bit digests -> (22, N) int32 canonical radix-2^12
    limbs of the value mod L. Four folds v = hi*2^252 + lo -> lo - DELTA*hi
    (2^252 === -DELTA mod L), each shrinking v by ~127 bits; the same walk as
    scalar25519.reduce_mod_l. int32 is exact: |DELTA_i * hi_j| < 2^24 and
    each row takes at most 11 such terms."""
    x = _digest_to_limbs12(d64)
    for nhi, top in ((22, 34), (13, 23), (2, 22), (1, 22)):
        hi = x[21:21 + nhi].clone()
        x[21:21 + nhi] = 0
        for i, d in enumerate(_DELTA12):
            x[i:i + nhi] -= d * hi
        x = _carry_signed12(x, top)
    return x[:22]


def _window_rows(bit) -> torch.Tensor:
    """(64, N) comb windows in processing order from a bit accessor:
    w_j = b_j + 2 b_{64+j} + 4 b_{128+j} + 8 b_{192+j}, emitted j = 63..0."""
    rows = []
    for idx in range(64):
        j = 63 - idx
        rows.append(bit(j) | (bit(64 + j) << 1) | (bit(128 + j) << 2)
                    | (bit(192 + j) << 3))
    return torch.stack(rows).to(torch.uint8)


def windows_from_limbs12(limbs: torch.Tensor) -> torch.Tensor:
    """(22, N) canonical radix-2^12 limbs -> (64, N) uint8 comb windows."""
    return _window_rows(
        lambda i: (limbs[i // _L_RADIX] >> (i % _L_RADIX)) & 1)


def windows_from_bytes(s32: torch.Tensor) -> torch.Tensor:
    """(32, N) uint8 LE scalars -> (64, N) uint8 comb windows."""
    b = s32.to(torch.int32)
    return _window_rows(lambda k: (b[k // 8] >> (k % 8)) & 1)


def r_limbs(r32: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(32, N) uint8 R bytes -> ((20, N) int32 y limbs of bits 0..254,
    (1, N) int32 sign bit)."""
    b = r32.to(torch.int32)
    sign = b[31:32] >> 7
    b = torch.cat([b[:31], b[31:32] & 0x7F,
                   torch.zeros((2, b.shape[1]), dtype=torch.int32,
                               device=b.device)])
    limbs = []
    for j in range(fe.NLIMB):
        k, s = divmod(13 * j, 8)
        v = (b[k] >> s) | (b[k + 1] << (8 - s)) | (b[k + 2] << (16 - s))
        limbs.append(v & 0x1FFF)
    return torch.stack(limbs), sign


# ---------------------------------------------------------------------------
# The kernel, its plain version, and the wrapper
# ---------------------------------------------------------------------------


def verify_plain(tab, key_idx, h64, s32, r32, valid) -> torch.Tensor:
    """The kernel's function as torch ops on the port's field and point
    modules (the torch counterpart of ed25519_batch._verify_kernel in the
    JAX package with its prologue, and the kernel's niels mixed adds). A
    lane whose key index is out of range comes out 0, as in the kernel."""
    h_win = windows_from_limbs12(reduce_mod_l(h64))
    s_win = windows_from_bytes(s32)
    dev = tab.device
    n = key_idx.shape[0]
    lanes = torch.arange(n, device=dev)
    key = key_idx.long()
    key_ok = (key >= 0) & (key < tab.shape[0])
    sel = from_fe10(tab[torch.where(key_ok, key, 0)])  # (N, 16, 3, 20)
    tb = torch.as_tensor(TAB_B_NIELS, device=dev)
    acc = ed.identity((n,), dev)
    for j in range(64):
        acc = ed.double(acc)
        pa = sel[lanes, h_win[j].long()]
        acc = ed.madd_niels(acc, pa[:, 0], pa[:, 1], pa[:, 2])
        pb = tb[s_win[j].long()]
        acc = ed.madd_niels(acc, pb[:, 0], pb[:, 1], pb[:, 2])
    y, sign = ed.compress_canonical(acc)
    r_y, r_sign = r_limbs(r32)
    ok = (y == r_y.T).all(dim=-1) & (sign == r_sign[0]) & (valid != 0) & key_ok
    return ok.to(torch.int32)


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, want {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, want {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def verify(tab, key_idx, h64, s32, r32, valid) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; CPU tensors take the plain
    version. Returns (N,) int32, 1 where the signature verifies."""
    global launches
    if tab.device.type == "cpu":
        return verify_plain(tab, key_idx, h64, s32, r32, valid)
    if tab.device.type != "cuda":
        raise ValueError(f"unsupported device {tab.device}")
    dev = tab.device
    n = key_idx.shape[0]
    _check("tab", tab, torch.int32, (tab.shape[0], 16, 3, 10), dev)
    _check("key_idx", key_idx, torch.int32, (n,), dev)
    _check("h64", h64, torch.uint8, (64, n), dev)
    _check("s32", s32, torch.uint8, (32, n), dev)
    _check("r32", r32, torch.uint8, (32, n), dev)
    _check("valid", valid, torch.uint8, (n,), dev)
    tb = tab_b10(dev)
    ok = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return ok
    if tab.shape[0] == 0:
        raise ValueError("tab: no keys")
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tm_ed25519_verify(
            tab.data_ptr(), tab.shape[0], key_idx.data_ptr(), h64.data_ptr(),
            s32.data_ptr(), r32.data_ptr(), valid.data_ptr(), tb.data_ptr(),
            ok.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"ed25519 verify kernel launch failed: CUDA error {err}")
    launches += 1
    return ok


# ---------------------------------------------------------------------------
# Build (nvcc at first use) and binding (ctypes)
# ---------------------------------------------------------------------------

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
SOURCES = ("fe25519.cuh", "sc25519.cuh", "ed25519_lanes.cuh", "ed25519_verify.cu")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB = None
# nvcc's output (ptxas register/spill report) of the last build.
build_log = ""


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found; the CUDA kernel cannot be built")
    return path


def build_library() -> str:
    """Compile csrc/ into a shared library named by the sources' digest
    (a changed source never loads a stale build). Returns its path."""
    global build_log
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"libtm_ed25519_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, "ed25519_verify.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{build_log}")
    os.replace(tmp, out)
    return out


def bind(path: str) -> ctypes.CDLL:
    """Load a build of csrc/ed25519_verify.cu and declare its C functions."""
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.tm_ed25519_verify.argtypes = [vp, ci, vp, vp, vp, vp, vp, vp, vp, ci, vp]
    lib.tm_ed25519_verify.restype = ci
    lib.tm_ed25519_kernel_info.argtypes = [vp]
    lib.tm_ed25519_kernel_info.restype = ci
    return lib


def load_library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = bind(build_library())
    return _LIB


def kernel_info(lib: ctypes.CDLL | None = None) -> dict:
    """The built kernel's block size, registers and local (spill) bytes a
    thread, and the blocks of it one SM holds at once (CUDA's occupancy
    calculator). `lib`: a bound build, by default the package's."""
    info = (ctypes.c_int * 4)()
    err = (lib or load_library()).tm_ed25519_kernel_info(ctypes.addressof(info))
    if err != 0:
        raise RuntimeError(f"ed25519 kernel attributes: CUDA error {err}")
    return dict(threads=info[0], registers=info[1], local_bytes=info[2],
                blocks_per_sm=info[3])


# ---------------------------------------------------------------------------
# Bitmap packing and the chunked dispatch
# ---------------------------------------------------------------------------


def pack_bitmap(ok: torch.Tensor) -> torch.Tensor:
    """(N,) int32 pass/fail lanes (N a multiple of 32) -> (N//32,) int64
    words, bit k of word i = lane 32*i + k."""
    w = torch.arange(32, device=ok.device, dtype=torch.int64)
    return ((ok.reshape(-1, 32).to(torch.int64) & 1) << w).sum(dim=1)


def unpack_bitmap(v: np.ndarray, n: int) -> np.ndarray:
    """(N//32,) packed words -> (n,) bool."""
    bits = (np.asarray(v, dtype=np.int64)[:, None] >> np.arange(32)) & 1
    return bits.reshape(-1)[:n].astype(bool)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def host_lanes(key_idx: np.ndarray, items, pub_ok: np.ndarray) -> dict:
    """Host prep of `items` (SHA-512, S < L) into lane-major numpy arrays
    padded to a multiple of 32 lanes: key_idx (N,) int32, h64 (64, N),
    s32 (32, N), r32 (32, N), valid (N,) uint8. Padding lanes have
    valid = 0 and key 0."""
    s = edb.prepare_scalars(items, pub_ok)
    n = len(items)
    lanes = _round_up(n, 32)

    def cols(x, rows):
        out = np.zeros((rows, lanes), dtype=np.uint8)
        out[:, :n] = x.T
        return out

    idx = np.zeros((lanes,), dtype=np.int32)
    idx[:n] = key_idx
    valid = np.zeros((lanes,), dtype=np.uint8)
    valid[:n] = s["valid"]
    return dict(key_idx=idx, h64=cols(s["h64"], 64), s32=cols(s["s32"], 32),
                r32=cols(s["r32"], 32), valid=valid)


def device_lanes(ks, host: dict, device) -> tuple:
    """Upload of host_lanes' arrays: the kernel's arguments
    (tab, key_idx, h64, s32, r32, valid)."""
    up = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    return (ks.kernel_rows(), up["key_idx"], up["h64"], up["s32"], up["r32"],
            up["valid"])


def lane_inputs(ks, key_idx: np.ndarray, items, pub_ok: np.ndarray,
                device) -> tuple:
    """Host prep of `items` and upload: the kernel's arguments
    (tab, key_idx, h64, s32, r32, valid) for len(items) rounded up to a
    multiple of 32 lanes."""
    return device_lanes(ks, host_lanes(key_idx, items, pub_ok), device)


def dispatch_items(ks, key_idx: np.ndarray, items, pub_ok: np.ndarray,
                   device) -> torch.Tensor:
    """Host prep and kernel launch for every CHUNK of items; returns the
    packed bitmap on the device without waiting for it. Launches are
    asynchronous, so host prep of chunk i+1 overlaps the kernel on chunk i."""
    oks = []
    for off in range(0, len(items), CHUNK):
        sl = slice(off, min(off + CHUNK, len(items)))
        oks.append(verify(*lane_inputs(ks, key_idx[sl], items[sl], pub_ok[sl],
                                       device)))
    return pack_bitmap(oks[0] if len(oks) == 1 else torch.cat(oks))
