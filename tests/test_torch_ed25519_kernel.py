"""The port's kernel module against the JAX package: the plain version's
prologue (mod-L reduction, comb windows, R limbs), the comb-table build, the
plain verify against the JAX device path, the kernel's own arithmetic (the
scalar reduction, the windows, each round of the 4-lane program and the
whole of it) compiled for the host, and the JAX -> port key-set conversion.
The sr25519 kernel's added device functions (csrc/ristretto.cuh: the
(p-5)/8 power, sign, equality, the ristretto decode in every branch, the
coset check) and its whole program, in the order its warps run it (a decode
pass over a block's signatures into a stand-in for shared memory, then the
comb groups, each checking against its own slot), are compiled into the
same host harness and held against its plain version and Python ints, in
every block shape the launch sweep builds and at lane counts that end
inside a block. Bitmaps must match exactly.

The JAX device path is run as the JAX package's tests run it on the CPU:
`ed25519_batch.verify_batch(items, force_device=True)`, which goes through
the jnp twin `_verify_kernel` of the Pallas kernel. Its first call compiles
for ~20 s, so each JAX reference is computed once per module."""

import ctypes
import os
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tendermint_tpu.crypto import ed25519 as jref
from tendermint_tpu.ops import ed25519_batch as jedb
from tendermint_tpu.ops import ed25519_pallas as jedp
from tendermint_tpu.ops import field25519 as jfe
from tendermint_tpu.ops import scalar25519 as jsc
from tendermint_tpu_torch import convert
from tendermint_tpu_torch.crypto import ed25519 as ref
from tendermint_tpu_torch.crypto import sr25519 as sr
from tendermint_tpu_torch.device import set_default_device
from tendermint_tpu_torch.ops import cbuild
from tendermint_tpu_torch.ops import ed25519_batch as edb
from tendermint_tpu_torch.ops import ed25519_cuda as cu
from tendermint_tpu_torch.ops import edwards25519 as ed
from tendermint_tpu_torch.ops import field25519 as fe
from tendermint_tpu_torch.ops import scalar25519 as sc
from tendermint_tpu_torch.ops import sr25519_batch as srb
from tendermint_tpu_torch.ops import sr25519_cuda as scu

L = sc.L
P = fe.P


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    set_default_device("cpu")
    yield
    set_default_device(None)


def _le(v: int, nbytes: int) -> np.ndarray:
    return np.frombuffer(int(v % 2**(8 * nbytes)).to_bytes(nbytes, "little"),
                         dtype=np.uint8).copy()


def _digest_cases() -> np.ndarray:
    """The vectors of tests/test_scalar25519.py's device-reduction test plus
    its boundary values, and seeded random digests."""
    rng = np.random.default_rng(3)
    cases = [rng.integers(0, 256, size=(64,), dtype=np.uint8) for _ in range(64)]
    for v in [0, 1, L - 1, L, L + 1, 2 * L, 2 * L - 1, 2**252, 2**252 - 1,
              2**255 - 19, 2**256 - 1, 2**511, 2**512 - 1,
              (2**512 - 1) // L * L, (2**512 - 1) // L * L - 1,
              (L - 1) << 252, ((L - 1) << 252) + L - 1,
              L * 2**259, L * 2**259 + 5]:
        cases.append(_le(v, 64))
    return np.stack(cases)


def test_reduce_mod_l_matches_jax_device_and_host():
    arr = _digest_cases()
    got = cu.reduce_mod_l(torch.from_numpy(arr.T.copy())).numpy()
    want = np.asarray(jedp._reduce_mod_l_device(jnp.asarray(arr.T)))
    assert (got == want).all()
    host = sc.reduce_mod_l(arr)
    assert (host == jsc.reduce_mod_l(arr)).all()
    for i in range(arr.shape[0]):
        v = int.from_bytes(arr[i].tobytes(), "little") % L
        assert sum(int(got[j, i]) << (12 * j) for j in range(22)) == v
        assert int.from_bytes(host[i].tobytes(), "little") == v


def test_windows_match_jax_device_and_host():
    arr = _digest_cases()
    limbs = cu.reduce_mod_l(torch.from_numpy(arr.T.copy()))
    hw = cu.windows_from_limbs12(limbs).numpy()
    assert hw.dtype == np.uint8 and hw.shape == (64, arr.shape[0])
    want = np.asarray(jedp._windows_from_limbs12(jnp.asarray(limbs.numpy())))
    assert (hw == want).all()
    assert (hw.T == sc.comb_windows(sc.reduce_mod_l(arr))).all()

    s32 = np.ascontiguousarray(arr[:, :32])
    sw = cu.windows_from_bytes(torch.from_numpy(s32.T.copy())).numpy()
    assert (sw == np.asarray(jedp._windows_device(jnp.asarray(s32.T)))).all()
    assert (sw.T == sc.comb_windows(s32)).all()
    assert (sc.comb_windows(s32) == jsc.comb_windows(s32)).all()


def test_r_limbs_and_lt_l_match_jax():
    arr = _digest_cases()
    r32 = np.ascontiguousarray(arr[:, 32:])
    y, sign = cu.r_limbs(torch.from_numpy(r32.T.copy()))
    jy, jsign = jedp._r_limbs_device(jnp.asarray(r32.T))
    assert (y.numpy() == np.asarray(jy)).all()
    assert (sign.numpy() == np.asarray(jsign)).all()
    fence = np.stack([_le(v, 32) for v in
                      (0, 1, L - 1, L, L + 1, 2**252, 2**253, 2**256 - 1)])
    assert sc.lt_l(fence).tolist() == jsc.lt_l(fence).tolist() == [
        True, True, True, False, False, True, False, False]


def _keys(n, seed):
    rng = random.Random(seed)
    return [ref.gen_priv_key(rng.randbytes(32)) for _ in range(n)]


BAD_PUBS = [(5).to_bytes(32, "little"), P.to_bytes(32, "little"),
            (1 | (1 << 255)).to_bytes(32, "little")]


def test_comb_table_build_congruent_to_jax():
    """The port's table build and niels conversion equal the JAX build
    (_build_comb_tables_tiled + _to_niels) as field values, limb group by
    limb group; undecodable keys get the identity table in both."""
    pubs = [k.pub_key().data for k in _keys(5, 21)] + BAD_PUBS
    a_neg = np.broadcast_to(jedb.ed.IDENTITY_LIMBS, (len(pubs), 4, 20)).copy()
    for j, p in enumerate(pubs):
        neg = edb._decompress_neg(p)
        if neg is not None:
            a_neg[j] = neg
    got = edb.to_niels(edb.build_comb_tables(torch.from_numpy(a_neg))).numpy()
    want = np.asarray(jedb._to_niels(jedb._build_comb_tables_tiled(a_neg)))
    assert got.shape == (len(pubs), 960)
    g = got.reshape(-1, 20)
    w = want[:len(pubs)].reshape(-1, 20)
    assert [fe.to_int(r) % P for r in g] == [jfe.to_int(r) % P for r in w]


def _mixed_items(seed):
    """Valid signatures and the corruptions of tests/test_ed25519_batch.py."""
    rng = random.Random(seed)
    keys = _keys(6, seed)
    items = []
    for i in range(24):
        priv = keys[i % 6]
        msg = b"vote-%d" % i
        sig = bytearray(ref.sign(priv.data, msg))
        kind = i % 8
        pub = priv.pub_key().data
        if kind == 1:
            sig[rng.randrange(32)] ^= 1 << rng.randrange(8)
        elif kind == 2:
            sig[32 + rng.randrange(32)] ^= 1 << rng.randrange(8)
        elif kind == 3:
            msg += b"!"
        elif kind == 4:
            sig[32:] = (int.from_bytes(sig[32:], "little") + L).to_bytes(32, "little")
        elif kind == 5:
            pub = BAD_PUBS[i % 3]
        elif kind == 6:
            sig[:32] = P.to_bytes(32, "little")
        items.append((pub, msg, bytes(sig)))
    small = (P - 1).to_bytes(32, "little")
    items.append((small, b"x", (1).to_bytes(32, "little") + b"\x00" * 32))
    items.append((keys[0].pub_key().data, b"short", b"\x01" * 63))
    return items


@pytest.fixture(scope="module")
def mixed():
    items = _mixed_items(31)
    want = np.array([jref.verify(*it) for it in items])
    jax_bitmap = jedb.verify_batch(items, force_device=True)
    return items, want, jax_bitmap


def test_plain_verify_matches_jax_device_path(mixed):
    items, want, jax_bitmap = mixed
    got = edb.verify_batch(items, device="cpu")
    assert (jax_bitmap == want).all()
    assert got.tolist() == jax_bitmap.tolist()
    assert 0 < got.sum() < len(items)


def _lane_args(ks, key_idx, items):
    pub_ok = np.array([len(it[0]) == 32 for it in items]) & ks.valid[key_idx]
    return cu.lane_inputs(ks, key_idx, items, pub_ok, torch.device("cpu"))


def test_wrapper_on_cpu_takes_plain_version_and_pads_false(mixed):
    items, want, _ = mixed
    ks, key_idx, _ = edb.get_keyset([it[0] for it in items], "cpu")
    args = _lane_args(ks, key_idx, items)
    before = cu.launches
    ok = cu.verify(*args)
    assert cu.launches == before  # a CPU tensor never launches the kernel
    assert ok.dtype == torch.int32
    assert ok[:len(items)].numpy().astype(bool).tolist() == want.tolist()
    assert not ok[len(items):].any()
    packed = cu.pack_bitmap(ok)
    assert cu.unpack_bitmap(packed.numpy(), len(items)).tolist() == want.tolist()


_LANES_HARNESS = r"""
#include "ristretto.cuh"

// The kernel's 4-thread program with the exchanges between rounds made by
// array reads: lane k reads lane j's value x as x[j].
static void group_double(fe v[4], fe s[4], fe m[4]) {
  for (int k = 0; k < 4; k++) s[k] = dbl_round1(k, v[k], v[0], v[1]);
  for (int k = 0; k < 4; k++) m[k] = dbl_mid(k, s[0], s[1], s[dbl_extra_src(k)]);
  for (int k = 0; k < 4; k++) v[k] = ext_round2(k, m[k], m[ext_src(k)], m[1]);
}

static void group_madd(fe v[4], const int32_t* entry, fe r[4], fe m[4]) {
  for (int k = 0; k < 4; k++)
    r[k] = madd_round1(k, v[k], v[k ^ 1], fe_load(entry + madd_part(k)));
  for (int k = 0; k < 4; k++) m[k] = madd_mid(k, r[k], r[k ^ 1]);
  for (int k = 0; k < 4; k++) v[k] = ext_round2(k, m[k], m[ext_src(k)], m[1]);
}

static void put(int32_t* out, const fe* a) {
  for (int k = 0; k < 4; k++)
    for (int i = 0; i < 10; i++) out[10 * k + i] = a[k].v[i];
}

extern "C" void host_double4(const int32_t* in, int32_t* s_out, int32_t* m_out,
                             int32_t* out, int n) {
  for (int p = 0; p < n; p++) {
    fe v[4], s[4], m[4];
    for (int k = 0; k < 4; k++) v[k] = fe_load(in + 40 * p + 10 * k);
    group_double(v, s, m);
    put(s_out + 40 * p, s); put(m_out + 40 * p, m); put(out + 40 * p, v);
  }
}

extern "C" void host_madd4(const int32_t* in, const int32_t* entries,
                           int32_t* r_out, int32_t* m_out, int32_t* out, int n) {
  for (int p = 0; p < n; p++) {
    fe v[4], r[4], m[4];
    for (int k = 0; k < 4; k++) v[k] = fe_load(in + 40 * p + 10 * k);
    group_madd(v, entries + 30 * p, r, m);
    put(r_out + 40 * p, r); put(m_out + 40 * p, m); put(out + 40 * p, v);
  }
}

// d: (n, 64) digests, s: (n, 32) scalars -> (n, 32) h mod L, and the comb
// windows (n, 64) of h mod L and of s.
extern "C" void host_scalars(const uint8_t* d, const uint8_t* s, uint8_t* h_out,
                             uint8_t* h_win, uint8_t* s_win, int n) {
  for (int p = 0; p < n; p++) {
    uint64_t hw[4], sw[4];
    lane_scalars(d + 64 * p, s + 32 * p, 1, hw, sw);
    for (int b = 0; b < 32; b++) h_out[32 * p + b] = (uint8_t)(hw[b / 8] >> (8 * (b % 8)));
    for (int i = 0; i < 64; i++) {
      h_win[64 * p + i] = (uint8_t)comb_window(hw, i);
      s_win[64 * p + i] = (uint8_t)comb_window(sw, i);
    }
  }
}

// group_comb of csrc/comb_group.cuh with the group rounds above.
static void group_comb(fe v[4], const int32_t* ktab, const int32_t* tab_b,
                       const uint64_t dw[4], const uint64_t sw[4]) {
  fe t1[4], t2[4];
  for (int k = 0; k < 4; k++) v[k] = lane_identity(k);
  for (int idx = 0; idx < 64; idx++) {
    group_double(v, t1, t2);
    group_madd(v, ktab + comb_window(dw, idx) * 30, t1, t2);
    group_madd(v, tab_b + comb_window(sw, idx) * 30, t1, t2);
  }
}

// The first lines of a verify kernel's body: lane k's coordinates of
// signature sig's R' in v, and whether the lane is active.
static bool comb_sig(fe v[4], int sig, const int32_t* tab, int n_keys,
                     const int32_t* key_idx, const uint8_t* d64, const uint8_t* s32,
                     const uint8_t* valid, const int32_t* tab_b, int n) {
  const int col = sig < n ? sig : n - 1;
  int key = key_idx[col];
  const bool active = sig < n && valid[col] && key >= 0 && key < n_keys;
  if (!active) key = 0;
  uint64_t dw[4], sw[4];
  lane_scalars(d64 + col, s32 + col, (size_t)n, dw, sw);
  group_comb(v, tab + (size_t)key * 480, tab_b, dw, sw);
  return active;
}

// The body of ed25519_verify.cu's kernel for signature groups 0..groups-1
// (groups >= n: groups past n stand for the threads of the last block past
// the lanes).
extern "C" void host_verify(const int32_t* tab, int n_keys, const int32_t* key_idx,
    const uint8_t* h64, const uint8_t* s32, const uint8_t* r32,
    const uint8_t* valid, const int32_t* tab_b, int32_t* ok, int n, int groups) {
  for (int sig = 0; sig < groups; sig++) {
    fe v[4];
    const bool active = comb_sig(v, sig, tab, n_keys, key_idx, h64, s32, valid,
                                 tab_b, n);
    const int32_t eq = encodes_to(v[0], v[1], v[2], r32 + (sig < n ? sig : n - 1),
                                  (size_t)n);
    if (sig < n) ok[sig] = active && eq;
  }
}

// The body of sr25519_verify.cu's kernel over the blocks that cover n lanes,
// with the block's shape as arguments (at most 64 signatures a block), in
// the order its warps run: first the decode warps' pass over the block's
// slots (lanes past n decode column n - 1) into dec, which stands for the
// block's shared memory (every block's copy is kept: dec_out is (blocks,
// DEC_INTS, sigs)), then the comb groups, each checking its R' against its
// own slot.
extern "C" void host_sr_verify(const int32_t* tab, int n_keys, const int32_t* key_idx,
    const uint8_t* k64, const uint8_t* s32, const uint8_t* r32,
    const uint8_t* valid, const int32_t* tab_b, int32_t* ok, int n,
    int comb_warps, int decode_warps, int per_lane, int32_t* dec_out) {
  const int sigs = 8 * comb_warps;
  static int32_t park[PARK_INTS * 64];
  for (int base = 0; base < n; base += sigs) {
    int32_t* dec = dec_out + (size_t)(base / sigs) * DEC_INTS * sigs;
    for (int lane = 0; lane < 32 * decode_warps; lane++) {
      for (int j = 0; j < per_lane; j++) {
        const int slot = lane + 32 * decode_warps * j;
        const int col = base + slot < n ? base + slot : n - 1;
        if (slot < sigs)
          ristretto_decode_store(r32 + col, (size_t)n, dec + slot, sigs, park + slot, sigs);
      }
    }
    for (int slot = 0; slot < sigs; slot++) {
      const int sig = base + slot;
      fe v[4], x, y;
      const bool active = comb_sig(v, sig, tab, n_keys, key_idx, k64, s32, valid,
                                   tab_b, n);
      const int32_t r_ok = ristretto_decoded_load(dec + slot, sigs, &x, &y);
      const int32_t eq = r_ok & ristretto_coset_eq(v[0], v[1], x, y);
      if (sig < n) ok[sig] = active && eq;
    }
  }
}

static void put1(int32_t* out, const fe& a) {
  for (int i = 0; i < 10; i++) out[i] = a.v[i];
}

// The field functions ristretto.cuh adds, element by element over f, g
// (n, 10): f^((p-5)/8), is_neg(f), eq(f, g), |f|.
extern "C" void host_fe_ops(const int32_t* f, const int32_t* g, int32_t* pow_out,
                            int32_t* neg_out, int32_t* eq_out, int32_t* abs_out,
                            int n) {
  for (int p = 0; p < n; p++) {
    const fe a = fe_load(f + 10 * p), b = fe_load(g + 10 * p);
    put1(pow_out + 10 * p, fe_pow22523(a));
    neg_out[p] = fe_is_neg(a);
    eq_out[p] = fe_eq(a, b);
    put1(abs_out + 10 * p, fe_abs(a));
  }
}

// The decode of n 32-byte encodings -> x, y (n, 10), ok (n).
extern "C" void host_decode(const uint8_t* r, int32_t* x, int32_t* y, int32_t* ok,
                            int n) {
  for (int p = 0; p < n; p++) {
    fe xx, yy;
    int32_t park[PARK_INTS];
    ok[p] = ristretto_decode(fe_from_le(r + 32 * p, 1), &xx, &yy, park, 1);
    put1(x + 10 * p, xx);
    put1(y + 10 * p, yy);
  }
}

// The coset check of n points (X : Y) (n, 2, 10) against affine (x, y)
// (n, 2, 10).
extern "C" void host_coset(const int32_t* pts, const int32_t* aff, int32_t* eq,
                           int n) {
  for (int p = 0; p < n; p++)
    eq[p] = ristretto_coset_eq(fe_load(pts + 20 * p), fe_load(pts + 20 * p + 10),
                               fe_load(aff + 20 * p), fe_load(aff + 20 * p + 10));
}
"""


def _compile_for_host(tmp_path, name: str, code: str) -> ctypes.CDLL:
    """The kernel's headers (csrc/) and `code` built by the host C++
    compiler, with the CUDA qualifiers defined away."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src = tmp_path / f"{name}.cpp"
    src.write_text(code)
    lib_path = tmp_path / f"{name}.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-D__device__=",
                    "-D__forceinline__=inline", f"-I{cbuild.CSRC}", "-o",
                    str(lib_path), str(src)], check=True)
    return ctypes.CDLL(str(lib_path))


@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    return _compile_for_host(tmp_path_factory.mktemp("lanes"), "host_lanes",
                             _LANES_HARNESS)


def _ptr(a: np.ndarray):
    return ctypes.c_void_p(a.ctypes.data)


def _host_scalars(lib, d64: np.ndarray, s32: np.ndarray):
    n = d64.shape[0]
    h = np.zeros((n, 32), np.uint8)
    hw = np.zeros((n, 64), np.uint8)
    sw = np.zeros((n, 64), np.uint8)
    lib.host_scalars(_ptr(np.ascontiguousarray(d64)), _ptr(np.ascontiguousarray(s32)),
                     _ptr(h), _ptr(hw), _ptr(sw), ctypes.c_int(n))
    return h, hw, sw


def _reduction_cases() -> np.ndarray:
    """_digest_cases() plus the edge values of the reduction's bound
    argument (csrc/sc25519.cuh) and more seeded random digests."""
    rng = np.random.default_rng(11)
    extra = [_le(v, 64) for v in
             (2**253 - 1, 2**483 - 1, 2**483, (2**29 - 1) << 483,
              2**512 - 2**252, L << 259, (L - 1) * (2**260 - 1),
              sum(1 << (21 * i + 20) for i in range(24)),
              sum(1 << (21 * i) for i in range(24)))]
    extra += [np.full((64,), b, np.uint8) for b in (0x55, 0xAA, 0x7F, 0x80)]
    extra += list(rng.integers(0, 256, size=(512, 64), dtype=np.uint8))
    return np.concatenate([_digest_cases(), np.stack(extra)])


def test_kernel_scalar_reduction_matches_python_and_torch(lanes):
    """The header's sc_reduce of 512-bit digests, compiled for the host,
    against Python `int % L` and the plain version's torch reduce_mod_l."""
    arr = _reduction_cases()
    h, _, _ = _host_scalars(lanes, arr, arr[:, :32])
    limbs = cu.reduce_mod_l(torch.from_numpy(arr.T.copy())).numpy()
    for i in range(arr.shape[0]):
        v = int.from_bytes(arr[i].tobytes(), "little") % L
        assert int.from_bytes(h[i].tobytes(), "little") == v, i
        assert sum(int(limbs[j, i]) << (12 * j) for j in range(22)) == v


def test_kernel_windows_match_torch_prologue(lanes):
    """The header's comb windows of h mod L and of s against the plain
    version's windows_from_limbs12 / windows_from_bytes."""
    arr = _reduction_cases()
    s32 = np.ascontiguousarray(arr[:, 32:])
    _, hw, sw = _host_scalars(lanes, arr, s32)
    want_h = cu.windows_from_limbs12(cu.reduce_mod_l(torch.from_numpy(arr.T.copy())))
    want_s = cu.windows_from_bytes(torch.from_numpy(s32.T.copy()))
    assert (hw == want_h.numpy().T).all()
    assert (sw == want_s.numpy().T).all()


def _points(n: int, seed: int) -> list:
    """Extended points [s]B with Z != 1, as Python ints."""
    rng = random.Random(seed)
    return [ref._scalarmult(rng.randrange(1, L), ref.BASE) for _ in range(n)]


def _as_torch(points) -> torch.Tensor:
    """-> (n, 4, 20) radix-2^13 limbs (field25519's form)."""
    return torch.from_numpy(np.stack([[fe.from_int(c % P) for c in pt]
                                      for pt in points]))


def _as_fe10(pts: torch.Tensor) -> np.ndarray:
    """(n, 4, 20) -> (n, 4, 10) int32 kernel limbs, contiguous."""
    return np.ascontiguousarray(cu.to_fe10(pts).numpy())


def _values(a: np.ndarray) -> list:
    """(..., 10) kernel limbs (signed) -> field values."""
    return [_fe10_value(r) % P for r in a.reshape(-1, 10)]


def _torch_values(t: torch.Tensor) -> list:
    return [fe.to_int(r) % P for r in t.reshape(-1, 20).numpy()]


def test_lane_doubling_round_by_round(lanes):
    """One 4-lane doubling through the host harness, twice in a row (the
    second from the first's signed, carried limbs), against
    edwards25519.double: round 1, the values between the rounds and the
    result, as field values mod p."""
    pts = _points(8, 5)
    x = _as_fe10(_as_torch(pts))
    want = _as_torch(pts)
    for _ in range(2):
        s, m, out = (np.zeros_like(x) for _ in range(3))
        lanes.host_double4(_ptr(x), _ptr(s), _ptr(m), _ptr(out), ctypes.c_int(len(pts)))
        vals = [[_fe10_value(c) % P for c in p] for p in x]
        for (X, Y, Z, _), sv, mv in zip(vals, s, m):
            S = [X * X % P, Y * Y % P, Z * Z % P, (X + Y) ** 2 % P]
            assert _values(sv) == S
            H, G = (S[0] + S[1]) % P, (S[0] - S[1]) % P
            assert _values(mv) == [(H - S[3]) % P, H, (G + 2 * S[2]) % P, G]
        want = ed.double(want)
        assert _values(out) == _torch_values(want)
        assert np.abs(out.astype(np.int64)).max() <= 1 << 26
        x = out


def test_lane_mixed_add_round_by_round(lanes):
    """One 4-lane mixed niels add through the host harness, against
    edwards25519.madd_niels, with entries of a real per-key table and of
    B's, including the identity entry 0."""
    pts = _points(8, 6)
    ks, _, _ = edb.get_keyset([k.pub_key().data for k in _keys(2, 41)], "cpu")
    rows = torch.cat([ks.kernel_rows().reshape(-1, 3, 10), cu.tab_b10("cpu").reshape(-1, 3, 10)])
    pick = [0, 5, 15, 16, 31, 32, 40, 47]
    entries = np.ascontiguousarray(rows[pick].numpy())
    x = _as_fe10(_as_torch(pts))
    r, m, out = (np.zeros_like(x) for _ in range(3))
    lanes.host_madd4(_ptr(x), _ptr(entries), _ptr(r), _ptr(m), _ptr(out), ctypes.c_int(len(pts)))
    niels = cu.from_fe10(torch.from_numpy(entries))
    want = ed.madd_niels(_as_torch(pts), niels[:, 0], niels[:, 1], niels[:, 2])
    assert _values(out) == _torch_values(want)
    for (X, Y, Z, T), e, rv, mv in zip(pts, entries, r, m):
        ypx, ymx, t2d = (_fe10_value(c) for c in e)
        R = [(Y - X) * ymx % P, (Y + X) * ypx % P, T * t2d % P, 2 * Z % P]
        assert _values(rv) == R
        assert _values(mv) == [(R[1] - R[0]) % P, (R[1] + R[0]) % P,
                               (R[3] - R[2]) % P, (R[3] + R[2]) % P]


# Shapes of the sr25519 kernel's block (comb warps, decode warps, decodes a
# decode lane): the shipped one and the others tools/ed25519_launch_sweep.py
# builds.
SR_SHAPES = [(4, 1, 1), (3, 1, 1), (8, 2, 1), (8, 1, 2)]


def _host_verify(lib, args, sr: bool = False, shape=SR_SHAPES[0]):
    """The ed25519 kernel's body (host_verify) over args' lanes and 3 groups
    past them, or with `sr` the sr25519 kernel's (host_sr_verify) in blocks
    of `shape`; checks that nothing is written past the lanes. Returns the
    lanes' bitmap, and with `sr` also the blocks' decode slots (blocks,
    DEC_INTS, signatures a block)."""
    n = args[1].shape[0]
    ok = np.full((n + 3,), 7, dtype=np.int32)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in args]
    head = (ptrs[0], ctypes.c_int(args[0].shape[0]), *ptrs[1:],
            ctypes.c_void_p(cu.tab_b10("cpu").data_ptr()), _ptr(ok), ctypes.c_int(n))
    if sr:
        sigs = 8 * shape[0]
        assert sigs <= 64  # host_sr_verify's park
        dec = np.full((-(-n // sigs), 21, sigs), 7, dtype=np.int32)
        lib.host_sr_verify(*head, *(ctypes.c_int(v) for v in shape), _ptr(dec))
    else:
        lib.host_verify(*head, ctypes.c_int(n + 3))
    assert (ok[n:] == 7).all()
    return (ok[:n], dec) if sr else ok[:n]


def test_kernel_arithmetic_compiled_for_host_matches_plain(mixed, lanes):
    """The kernel's 4-lane program (csrc/ed25519_lanes.cuh, sc25519.cuh,
    fe25519.cuh) compiled by the host C++ compiler, with the CUDA qualifiers
    defined away, on the raw-byte inputs, gives the plain version's bitmap:
    padding lanes, groups past the last lane and lanes whose key index is
    out of range come out 0."""
    items, want, _ = mixed
    ks, key_idx, _ = edb.get_keyset([it[0] for it in items], "cpu")
    args = _lane_args(ks, key_idx, items)
    n = args[1].shape[0]
    assert n > len(items)  # padding lanes
    ok = _host_verify(lanes, args)
    assert ok.tolist() == cu.verify_plain(*args).tolist()
    assert ok[:len(items)].astype(bool).tolist() == want.tolist()
    assert not ok[len(items):].any()

    bad = args[1].clone()
    hit = np.zeros((n,), bool)
    hit[[0, 7, 8]] = True  # lanes that verify
    assert ok[hit].all()
    bad[[0, 7, 8]] = torch.tensor([-1, args[0].shape[0], 1 << 30], dtype=torch.int32)
    bargs = (args[0], bad, *args[2:])
    ok_bad = _host_verify(lanes, bargs)
    assert ok_bad.tolist() == cu.verify_plain(*bargs).tolist()
    assert not ok_bad[hit].any() and (ok_bad[~hit] == ok[~hit]).all()


# --- the sr25519 kernel's device functions (csrc/ristretto.cuh) ------------


def _fe10(v: int) -> np.ndarray:
    """Canonical kernel limbs of v mod p."""
    v %= P
    return np.array([(v >> o) & ((1 << w) - 1) for o, w in zip(cu.OFF10, cu.WID10)],
                    dtype=np.int32)


def _carried(rng, n: int) -> np.ndarray:
    """(n, 10) limbs in the ranges fe_carry leaves: |even| <= 2^25,
    |odd| <= 2^24."""
    lim = np.array([1 << (24 if i % 2 else 25) for i in range(10)])
    return rng.integers(-lim, lim + 1, size=(n, 10)).astype(np.int32)


def test_kernel_pow22523_is_neg_eq_abs_match_python_and_plain(lanes):
    """fe_pow22523, fe_is_neg, fe_eq and fe_abs, compiled for the host, on
    carried limbs and canonical edge values, against Python ints and the
    plain version's field25519.pow_p58."""
    rng = np.random.default_rng(13)
    edges = [0, 1, 2, P - 1, P - 2, sr.SQRT_M1, P - sr.SQRT_M1, ed.D, 2**254]
    f = np.concatenate([_carried(rng, 56), np.stack([_fe10(v) for v in edges])])
    vals = [_fe10_value(r) % P for r in f]
    # g: the same value in canonical limbs on even rows, value + 1 on odd
    g = np.stack([_fe10(v + (i % 2)) for i, v in enumerate(vals)])
    n = len(f)
    pw, ab = np.zeros_like(f), np.zeros_like(f)
    neg, eq = np.zeros((n,), np.int32), np.zeros((n,), np.int32)
    lanes.host_fe_ops(_ptr(f), _ptr(g), _ptr(pw), _ptr(neg), _ptr(eq), _ptr(ab),
                      ctypes.c_int(n))
    plain = fe.pow_p58(torch.from_numpy(np.stack([fe.from_int(v) for v in vals])))
    assert _values(pw) == [pow(v, (P - 5) // 8, P) for v in vals] == _torch_values(plain)
    assert neg.tolist() == [v & 1 for v in vals]
    assert eq.tolist() == [int(i % 2 == 0) for i in range(n)]
    assert _values(ab) == [P - v if v & 1 else v for v in vals]
    assert all(_fe10_value(r) % P % 2 == 0 for r in ab)


def _decode_branch(s: int) -> str:
    """Which condition of RFC 9496's decode rejects the even canonical
    encoding s ("ok" when none does), by Python ints."""
    ss = s * s % P
    u1, u2 = (1 - ss) % P, (1 + ss) % P
    v = (-(ed.D * u1 % P * u1) - u2 * u2) % P
    was_square, invsqrt = sr._sqrt_ratio_m1(1, v * u2 * u2 % P)
    den_x = invsqrt * u2 % P
    x = sr._ct_abs(2 * s * den_x % P)
    y = u1 * (invsqrt * den_x % P * v % P) % P
    if not was_square:
        return "not_square"
    if x * y % P & 1:
        return "t_negative"
    return "y_zero" if y == 0 else "ok"


def _decode_cases() -> tuple[list[int], list[str]]:
    """Even canonical encodings reaching every branch of the decode: points'
    encodings, s = 0, s = p - 1 (y = 0), and seeded even s that are not a
    square or give a negative t."""
    rng = random.Random(17)
    cases = [int.from_bytes(sr.ristretto_encode(ref._scalarmult(rng.randrange(1, L),
                                                                 ref.BASE)), "little")
             for _ in range(6)] + [0, P - 1]
    found: dict[str, int] = {}
    while min(found.get("not_square", 0), found.get("t_negative", 0)) < 4:
        s = rng.randrange(P) & ~1
        b = _decode_branch(s)
        if b in ("not_square", "t_negative") and found.get(b, 0) < 4:
            found[b] = found.get(b, 0) + 1
            cases.append(s)
    return cases, [_decode_branch(s) for s in cases]


def test_kernel_ristretto_decode_every_branch(lanes):
    """The kernel's ristretto_decode, compiled for the host, against Python
    ints (the branch and crypto/sr25519.ristretto_decode) and the plain
    version's torch decode: ok, and x and y as field values."""
    cases, branches = _decode_cases()
    assert set(branches) == {"ok", "not_square", "t_negative", "y_zero"}
    enc = np.stack([np.frombuffer(s.to_bytes(32, "little"), np.uint8) for s in cases])
    n = len(cases)
    x, y = np.zeros((n, 10), np.int32), np.zeros((n, 10), np.int32)
    ok = np.zeros((n,), np.int32)
    lanes.host_decode(_ptr(enc), _ptr(x), _ptr(y), _ptr(ok), ctypes.c_int(n))
    assert ok.tolist() == [int(b == "ok") for b in branches]
    for i, s in enumerate(cases):
        pt = sr.ristretto_decode(s.to_bytes(32, "little"))
        assert (pt is not None) == bool(ok[i])
        if pt is not None:
            assert (_fe10_value(x[i]) % P, _fe10_value(y[i]) % P) == pt[:2]
    r_y, _ = cu.r_limbs(torch.from_numpy(enc.T.copy()))
    px, py, pok = scu.ristretto_decode(r_y.T.contiguous())
    assert pok.to(torch.int32).tolist() == ok.tolist()
    assert _values(x) == _torch_values(px) and _values(y) == _torch_values(py)


def test_kernel_coset_check_matches_python_and_plain(lanes):
    """ristretto_coset_eq on projective points against affine ones: equal
    for the same point plus each 4-torsion point (its ristretto coset),
    unequal for another point; against crypto/sr25519.ristretto_eq and the
    plain version's coset_eq."""
    pts = _points(6, 8)
    torsion = [(0, 1), (0, P - 1), (sr.SQRT_M1, 0), (P - sr.SQRT_M1, 0)]
    proj, aff, want = [], [], []
    for i, q in enumerate(pts):
        zi = pow(q[2], P - 2, P)
        qx, qy = q[0] * zi % P, q[1] * zi % P
        others = [ed.affine_add((qx, qy), t) for t in torsion]
        o = pts[(i + 1) % len(pts)]
        oz = pow(o[2], P - 2, P)
        others.append((o[0] * oz % P, o[1] * oz % P))
        for a in others:
            proj.append([_fe10(q[0]), _fe10(q[1])])
            aff.append([_fe10(a[0]), _fe10(a[1])])
            want.append(sr.ristretto_eq(q, (a[0], a[1], 1, a[0] * a[1] % P)))
    proj, aff = np.array(proj, np.int32), np.array(aff, np.int32)
    eq = np.zeros((len(want),), np.int32)
    lanes.host_coset(_ptr(proj), _ptr(aff), _ptr(eq), ctypes.c_int(len(want)))
    assert eq.astype(bool).tolist() == want
    assert sum(want) == 4 * len(pts)
    t = cu.from_fe10(torch.from_numpy(proj)), cu.from_fe10(torch.from_numpy(aff))
    plain = scu.coset_eq(t[0][:, 0], t[0][:, 1], t[1][:, 0], t[1][:, 1])
    assert plain.tolist() == want


def _sr_items(seed: int):
    """Valid sr25519 signatures and the corruptions of
    tests/test_sr25519_batch.py, plus R >= p and an R that is not a square."""
    rng = random.Random(seed)
    privs = [sr.gen_priv_key(bytes([seed, i])) for i in range(3)]
    items = []
    for i in range(8):
        p = privs[i % 3]
        msg = b"sr-%d|" % i + rng.randbytes(rng.randrange(0, 90))
        items.append((p.pub_key().data, msg, sr.sign(p.data, msg, rng_seed=bytes([i]) * 32)))
    pub, msg, sig = items[0]
    not_square = next(s for s in _decode_cases()[0] if _decode_branch(s) == "not_square")
    items += [
        (pub, msg + b"!", sig),
        (pub, msg, sig[:32] + bytes(31) + b"\x80"),
        (pub, msg, sig[:63] + bytes([sig[63] & 0x7F])),
        (pub, msg, bytes([sig[0] ^ 1]) + sig[1:]),
        (b"\xff" * 32, msg, sig),
        (pub, msg, sig[:12]),
        (items[1][0], msg, sig),
        (pub, msg, (P + 1).to_bytes(32, "little") + sig[32:]),
        (pub, msg, not_square.to_bytes(32, "little") + sig[32:]),
    ]
    return items


def test_sr_kernel_arithmetic_compiled_for_host_matches_plain(lanes):
    """The sr25519 kernel's program (comb_group.cuh's comb with the group
    rounds, ristretto.cuh's decode and coset check) compiled for the host
    on the raw-byte inputs gives the plain version's bitmap and the scalar
    reference's decisions; padding lanes, groups past the last lane and
    lanes with an out-of-range key come out 0."""
    items = _sr_items(5)
    want = [sr.verify(*it) for it in items]
    assert 0 < sum(want) < len(items)
    ks, key_idx, pub_ok = srb.lookup_keys(items, "cpu")
    args = scu.lane_inputs(ks, key_idx, items, pub_ok, torch.device("cpu"))
    n = args[1].shape[0]
    ok, _ = _host_verify(lanes, args, sr=True)
    assert ok.tolist() == scu.verify_plain(*args).tolist()
    assert ok[:len(items)].astype(bool).tolist() == want
    bad = args[1].clone()
    hit = np.zeros((n,), bool)
    hit[[0, 1, 2]] = True  # lanes that verify
    assert ok[hit].all()
    bad[[0, 1, 2]] = torch.tensor([-1, args[0].shape[0], 1 << 30], dtype=torch.int32)
    bargs = (args[0], bad, *args[2:])
    ok_bad, _ = _host_verify(lanes, bargs, sr=True)
    assert ok_bad.tolist() == scu.verify_plain(*bargs).tolist()
    assert not ok_bad[hit].any() and (ok_bad[~hit] == ok[~hit]).all()


@pytest.fixture(scope="module")
def sr_batch():
    """108 sr25519 items (six seeds of _sr_items: valid signatures and every
    corruption), their reference decisions and the kernel's arguments."""
    items = [it for seed in range(5, 11) for it in _sr_items(seed)]
    want = np.array([sr.verify(*it) for it in items])
    ks, key_idx, pub_ok = srb.lookup_keys(items, "cpu")
    args = scu.lane_inputs(ks, key_idx, items, pub_ok, torch.device("cpu"))
    return items, want, args


def _first_lanes(args, m: int) -> tuple:
    """The kernel's arguments for the first m lanes only (n = m)."""
    tab, *cols = args
    return (tab, *[c[..., :m].contiguous() for c in cols])


@pytest.mark.parametrize("shape", SR_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("n", [1, 31, 33, 3 * 32 + 5])
def test_sr_kernel_block_tails_compiled_for_host(sr_batch, lanes, n, shape):
    """The sr25519 program in blocks of `shape` at n lanes that end inside a
    block: the decode lanes past n decode column n - 1 and the comb groups
    past n write nothing; the bitmap equals the plain version's and the
    scalar reference's."""
    items, want, args = sr_batch
    a = _first_lanes(args, n)
    ok, dec = _host_verify(lanes, a, sr=True, shape=shape)
    assert ok.tolist() == scu.verify_plain(*a).tolist()
    assert ok.astype(bool).tolist() == want[:n].tolist()
    assert dec.shape[0] == -(-n // (8 * shape[0]))
    tail = dec[-1][:, (n - 1) % dec.shape[2]:]
    assert (tail == tail[:, :1]).all()  # the last lane's slot, repeated


@pytest.mark.parametrize("shape", SR_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_sr_decode_pass_stores_the_decode_in_every_branch(lanes, shape):
    """The decode pass's slots (x, y, r_ok) for encodings that reach every
    branch of the decode equal the plain version's scu.ristretto_decode
    (and the scalar reference's point); each slot holds its own lane's
    decode, and slots past n the decode of column n - 1."""
    cases, branches = _decode_cases()
    n = len(cases)
    assert n < 8 * shape[0] and set(branches) == {"ok", "not_square", "t_negative",
                                                  "y_zero"}
    r32 = np.stack([np.frombuffer(s.to_bytes(32, "little"), np.uint8) for s in cases])
    cols = np.arange(8 * shape[0]).clip(max=n - 1)  # slot -> decoded column
    zeros = torch.zeros((n,), dtype=torch.int32)
    args = (cu.tab_b10("cpu").reshape(1, 16, 3, 10), zeros,
            torch.zeros((64, n), dtype=torch.uint8), torch.zeros((32, n), dtype=torch.uint8),
            torch.from_numpy(r32.T.copy()), zeros.to(torch.uint8))
    ok, dec = _host_verify(lanes, args, sr=True, shape=shape)
    assert not ok.any()  # validity 0
    r_y, _ = cu.r_limbs(args[4])
    px, py, pok = scu.ristretto_decode(r_y.T.contiguous())
    x, y, r_ok = dec[0, :10].T, dec[0, 10:20].T, dec[0, 20]
    assert r_ok.tolist() == pok.to(torch.int32)[cols].tolist()
    assert r_ok[:n].tolist() == [int(b == "ok") for b in branches]
    assert _values(x) == [_torch_values(px)[c] for c in cols]
    assert _values(y) == [_torch_values(py)[c] for c in cols]
    for i, s in enumerate(cases):
        pt = sr.ristretto_decode(s.to_bytes(32, "little"))
        if pt is not None:
            assert (_values(x[i])[0], _values(y[i])[0]) == pt[:2]


_SQ_HARNESS = r"""
#include "fe25519.cuh"
extern "C" void host_sq(const int32_t* f, int32_t* sq, int32_t* mul, int n) {
  for (int k = 0; k < n; k++) {
    const fe a = fe_load(f + 10 * k);
    const fe s = fe_sq(a), m = fe_mul(a, a);
    for (int i = 0; i < 10; i++) { sq[10 * k + i] = s.v[i]; mul[10 * k + i] = m.v[i]; }
  }
}
"""


def _fe10_value(limbs) -> int:
    return sum(int(v) << o for v, o in zip(limbs, cu.OFF10))


@pytest.mark.parametrize("kind", ["random", "all_max", "all_min", "alternating"])
def test_kernel_squaring_matches_multiply_at_the_limb_bound(kind, tmp_path):
    """The kernel's 55-product fe_sq against fe_mul(f, f) and Python ints,
    on inputs at the header's bound B (|limb| <= 2^26) and inside it; the
    result is back in B."""
    lib = _compile_for_host(tmp_path, "host_sq", _SQ_HARNESS)
    rng = np.random.default_rng(7)
    b = 1 << 26
    f = rng.integers(-b, b + 1, size=(64, 10), dtype=np.int64)
    if kind == "all_max":
        f[:8] = b
    elif kind == "all_min":
        f[:8] = -b
    elif kind == "alternating":
        f[:8] = np.where(np.arange(10) % 2, -b, b)
        f[8:16] = np.where(np.arange(10) % 2, b, -b)
    f = np.ascontiguousarray(f.astype(np.int32))
    sq = np.zeros_like(f)
    mul = np.zeros_like(f)
    lib.host_sq(ctypes.c_void_p(f.ctypes.data), ctypes.c_void_p(sq.ctypes.data),
                ctypes.c_void_p(mul.ctypes.data), ctypes.c_int(len(f)))
    assert np.abs(sq.astype(np.int64)).max() <= b
    for k in range(len(f)):
        want = _fe10_value(f[k]) ** 2 % P
        assert _fe10_value(sq[k]) % P == want
        assert _fe10_value(mul[k]) % P == want


def test_keyset_from_jax_round_trip(mixed):
    """A verify on JAX-built tables gives the JAX bitmap in the port."""
    items, want, jax_bitmap = mixed
    pubs = [it[0] for it in items]
    jks, jkey_idx, _ = jedb.get_keyset(pubs)
    ks = convert.keyset_from_jax(np.asarray(jks.niels_rows()), jks.valid,
                                 jks.n_keys, jkey_idx, device="cpu")
    assert ks.niels_rows().shape == (jks.valid.shape[0], 960)
    pub_ok = np.array([len(p) == 32 for p in pubs]) & ks.valid[jkey_idx]
    packed = cu.dispatch_items(ks, jkey_idx, items, pub_ok, torch.device("cpu"))
    got = cu.unpack_bitmap(packed.numpy(), len(items))
    assert got.tolist() == jax_bitmap.tolist() == want.tolist()
    with pytest.raises(ValueError):
        convert.keyset_from_jax(np.zeros((4, 959), np.int32), np.ones(4, bool),
                                4, jkey_idx, device="cpu")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(mixed):
    """The CUDA kernel against its plain version on the card (skips without
    one; chip_smoke.py runs the same check at full size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    items, want, _ = mixed
    ks, key_idx, _ = edb.get_keyset([it[0] for it in items], "cuda")
    args = [t.to("cuda") for t in _lane_args(ks, key_idx, items)]
    before = cu.launches
    ok = cu.verify(*args)
    assert cu.launches == before + 1
    assert ok.tolist() == cu.verify_plain(*args).tolist()
    assert ok[:len(items)].cpu().numpy().astype(bool).tolist() == want.tolist()
    assert os.path.exists(cu.build_library())
