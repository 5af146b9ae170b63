"""Batched sr25519 verification on the card: the CUDA kernel, its plain
PyTorch version, and the chunked dispatch.

The kernel (csrc/sr25519_verify.cu) replaces the JAX package's device
function `_sr_verify_kernel` (tendermint_tpu/ops/sr25519_batch.py:160) with
the ristretto255 decode it runs (`_ristretto_decode_dev` :136,
`_sqrt_ratio_m1` :119, `_ct_abs` :112) and the mod-L reduction of the
challenges that the JAX package does on the host. Per signature lane: k mod
L from the wide merlin challenge and the comb windows of k and s,
R' = [s]B + [k](-A) by the ed25519 kernel's 64-step comb on four threads
(csrc/comb_group.cuh), the decode of the R encoding to (x, y)
(csrc/ristretto.cuh) by a decode warp of the block, once a signature, beside
the comb, and the coset check X' y == Y' x or Y' y == X' x, ANDed with the
decode's validity, the host validity and the key range. One launch a call.

Inputs of both `verify` (the wrapper) and `verify_plain`:

    tab     (Kb, 16, 3, 10) int32  per-key niels comb tables of -A, kernel
                                   limb form (KeySet.kernel_rows())
    key_idx (N,)  int32            lane -> table row
    k64     (64, N) uint8          wide merlin challenges
    s32     (32, N) uint8          s bytes, marker bit cleared
    r32     (32, N) uint8          R encodings
    valid   (N,)  uint8            host validity (sizes, marker, s < L,
                                   R < p and even, key decodes)
    ->      (N,)  int32            1 where the signature verifies
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tendermint_tpu_torch.crypto import sr25519 as srref
from tendermint_tpu_torch.ops import cbuild
from tendermint_tpu_torch.ops import ed25519_cuda as edc
from tendermint_tpu_torch.ops import edwards25519 as ed
from tendermint_tpu_torch.ops import field25519 as fe
from tendermint_tpu_torch.ops import sr25519_batch as srb

CHUNK = edc.CHUNK
pack_bitmap = edc.pack_bitmap
unpack_bitmap = edc.unpack_bitmap
device_lanes = edc.device_lanes

# Launches of the CUDA kernel since the last reset (CPU calls never count).
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


# ---------------------------------------------------------------------------
# The plain version: the JAX device function as torch ops
# ---------------------------------------------------------------------------

_ONE = fe.from_int(1)
_D = fe.from_int(ed.D)
_SQRT_M1 = fe.from_int(srref.SQRT_M1)


def _ct_abs(x):
    """|x| mod p: negated when the canonical representative is odd."""
    xc = fe.to_canonical(x)
    neg = (xc[..., 0] & 1) == 1
    return fe.select(neg, fe.sub(torch.zeros_like(xc), xc), xc)


def _sqrt_ratio_m1(u, v):
    """RFC 9496 4.2 SQRT_RATIO_M1 over a batch -> (was_square, |r|)."""
    sqrt_m1 = fe._const("sqrt_m1", _SQRT_M1, u.device)
    v3 = fe.mul(fe.square(v), v)
    v7 = fe.mul(fe.square(v3), v)
    r = fe.mul(fe.mul(u, v3), fe.pow_p58(fe.mul(u, v7)))
    check = fe.to_canonical(fe.mul(v, fe.square(r)))
    zero = torch.zeros_like(u)
    correct = fe.eq(check, fe.to_canonical(u))
    flipped = fe.eq(check, fe.to_canonical(fe.sub(zero, u)))
    flipped_i = fe.eq(check, fe.to_canonical(fe.mul(fe.sub(zero, u), sqrt_m1)))
    r = fe.select(flipped | flipped_i, fe.mul(r, sqrt_m1), r)
    return correct | flipped, _ct_abs(r)


def ristretto_decode(s_limbs):
    """(N, 20) limbs of encodings the host found canonical and even ->
    (x, y, ok) (RFC 9496 4.3.1): ok where the square root exists, t = xy
    is non-negative and y != 0."""
    dev = s_limbs.device
    one = fe._const("one", _ONE, dev).expand(s_limbs.shape)
    ss = fe.square(s_limbs)
    u1 = fe.sub(one, ss)
    u2 = fe.add(one, ss)
    u2_sqr = fe.square(u2)
    # v = -(D * u1^2) - u2^2
    v = fe.sub(torch.zeros_like(ss),
               fe.add(fe.mul(fe._const("d", _D, dev), fe.square(u1)), u2_sqr))
    was_square, invsqrt = _sqrt_ratio_m1(one, fe.mul(v, u2_sqr))
    den_x = fe.mul(invsqrt, u2)
    den_y = fe.mul(fe.mul(invsqrt, den_x), v)
    x = _ct_abs(fe.mul(fe.mul_small(s_limbs, 2), den_x))
    y = fe.mul(u1, den_y)
    t_c = fe.to_canonical(fe.mul(x, y))
    y_c = fe.to_canonical(y)
    ok = was_square & ((t_c[..., 0] & 1) == 0) & ~(y_c == 0).all(dim=-1)
    return x, y, ok


def coset_eq(X, Y, x, y):
    """Ristretto equality of (X : Y : Z) and affine (x, y): X y == Y x or
    Y y == X x on canonical values (RFC 9496 4.5)."""
    c = fe.to_canonical
    return (fe.eq(c(fe.mul(X, y)), c(fe.mul(Y, x)))
            | fe.eq(c(fe.mul(Y, y)), c(fe.mul(X, x))))


def verify_plain(tab, key_idx, k64, s32, r32, valid) -> torch.Tensor:
    """The kernel's function as torch ops on the port's field and point
    modules: the comb of ed25519_cuda.comb_plain with the challenge in place
    of h, then the decode of R and the coset check. A lane whose key index
    is out of range comes out 0, as in the kernel."""
    acc, key_ok = edc.comb_plain(tab, key_idx, k64, s32)
    r_y, _ = edc.r_limbs(r32)  # bits 0..254; the host rejected R >= p
    x_r, y_r, ok_r = ristretto_decode(r_y.T.contiguous())
    eq = coset_eq(acc[:, 0], acc[:, 1], x_r, y_r)
    return (eq & ok_r & (valid != 0) & key_ok).to(torch.int32)


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------


def verify(tab, key_idx, k64, s32, r32, valid) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; CPU tensors take the plain
    version. Returns (N,) int32, 1 where the signature verifies."""
    global launches
    if tab.device.type == "cpu":
        return verify_plain(tab, key_idx, k64, s32, r32, valid)
    if tab.device.type != "cuda":
        raise ValueError(f"unsupported device {tab.device}")
    edc.check_lanes(tab, key_idx, k64, s32, r32, valid)
    dev = tab.device
    n = key_idx.shape[0]
    tb = edc.tab_b10(dev)
    ok = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return ok
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tm_sr25519_verify(
            tab.data_ptr(), tab.shape[0], key_idx.data_ptr(), k64.data_ptr(),
            s32.data_ptr(), r32.data_ptr(), valid.data_ptr(), tb.data_ptr(),
            ok.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"sr25519 verify kernel launch failed: CUDA error {err}")
    launches += 1
    return ok


# ---------------------------------------------------------------------------
# Build (nvcc at first use) and binding (ctypes)
# ---------------------------------------------------------------------------

# The kernel's source last, after the headers it includes.
SOURCES = ("fe25519.cuh", "sc25519.cuh", "ed25519_lanes.cuh", "comb_group.cuh",
           "ristretto.cuh", "sr25519_verify.cu")

_LIB = None
# nvcc's output (ptxas register/spill report) of the last build.
build_log = ""


def build_library() -> str:
    """Compile csrc/sr25519_verify.cu (cbuild.build, nvcc). Returns the
    library's path."""
    global build_log
    path, log = cbuild.build("tm_sr25519", SOURCES, cbuild.nvcc(), cbuild.NVCC_FLAGS)
    build_log = log or build_log
    return path


def bind(path: str) -> ctypes.CDLL:
    """Load a build of csrc/sr25519_verify.cu and declare its C functions."""
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.tm_sr25519_verify.argtypes = [vp, ci, vp, vp, vp, vp, vp, vp, vp, ci, vp]
    lib.tm_sr25519_verify.restype = ci
    lib.tm_sr25519_kernel_info.argtypes = [vp]
    lib.tm_sr25519_kernel_info.restype = ci
    lib.tm_sr25519_kernel_shape.argtypes = [vp]
    lib.tm_sr25519_kernel_shape.restype = None
    return lib


def load_library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = bind(build_library())
    return _LIB


def kernel_info(lib: ctypes.CDLL | None = None) -> dict:
    """edc.read_kernel_info of the built kernel and its block's shape:
    comb_warps, decode_warps, decodes_per_lane (of a decode warp) and
    sigs_per_block. `lib`: a bound build, by default the package's."""
    lib = lib or load_library()
    info = edc.read_kernel_info(lib.tm_sr25519_kernel_info, "sr25519")
    shape = (ctypes.c_int * 4)()
    lib.tm_sr25519_kernel_shape(ctypes.addressof(shape))
    info.update(comb_warps=shape[0], decode_warps=shape[1],
                decodes_per_lane=shape[2], sigs_per_block=shape[3])
    return info


# ---------------------------------------------------------------------------
# Host lanes and the chunked dispatch
# ---------------------------------------------------------------------------


def host_lanes(key_idx: np.ndarray, items, pub_ok: np.ndarray) -> dict:
    """Host prep of `items` (sizes, marker, s < L, R checks, C challenges)
    into lane-major numpy arrays padded to a multiple of 32 lanes
    (ed25519_cuda.pad_lanes): key_idx (N,) int32, k64 (64, N), s32 (32, N),
    r32 (32, N), valid (N,) uint8."""
    s = srb.prepare_scalars(items, pub_ok)
    return edc.pad_lanes(key_idx, s["valid"], k64=s["k64"], s32=s["s32"],
                         r32=s["r32"])


def lane_inputs(ks, key_idx: np.ndarray, items, pub_ok: np.ndarray,
                device) -> tuple:
    """Host prep of `items` and upload: the kernel's arguments
    (tab, key_idx, k64, s32, r32, valid)."""
    return device_lanes(ks, host_lanes(key_idx, items, pub_ok), device)


def dispatch_items(ks, key_idx: np.ndarray, items, pub_ok: np.ndarray,
                   device) -> torch.Tensor:
    """Host prep and kernel launch for every CHUNK of items; returns the
    packed bitmap on the device without waiting for it."""
    oks = []
    for off in range(0, len(items), CHUNK):
        sl = slice(off, min(off + CHUNK, len(items)))
        oks.append(verify(*lane_inputs(ks, key_idx[sl], items[sl], pub_ok[sl],
                                       device)))
    return pack_bitmap(oks[0] if len(oks) == 1 else torch.cat(oks))
