"""Batched ed25519 verification: per-validator-set comb tables, host prep, and
the dispatch into the CUDA kernel (ops/ed25519_cuda.py).

    host (vectorized over the whole batch):
        size checks, S < L check, SHA-512 h = H(R||A||msg) with hashlib
    device (one kernel):
        mod-L reduction of h and comb windows, then R' = [s]B + [h](-A) via
        a comb (Lim-Lee) evaluation, canonical compression and an exact
        compare against the sig's R.

Comb method (t=4 teeth, d=64 columns): scalar bits split into 4 blocks of 64;
T[w] = sum_j w_j * [2^(64j)] P for w in 0..15; evaluation
acc <- 2*acc + T_A[wh_i] + T_B[ws_i] for i = 63..0. The per-key tables T_A
depend only on the pubkey, so they are built once per validator set ON THE
DEVICE and stay there across heights; per call only the per-sig scalars move
host->device.

Accept/reject is identical with the scalar path (crypto/ed25519.py):
 - s >= L rejected (host);
 - non-decodable / non-canonical A rejected (host, same rules as scalar ref);
 - R never decompressed: the comparison is against the canonical encoding of
   R', so non-canonical R bytes fail exactly as in the scalar path;
 - h reduced mod L before the scalar mult (both paths), so small-order A
   components behave identically.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

import numpy as np
import torch

from tendermint_tpu_torch import device as _device
from tendermint_tpu_torch.crypto import ed25519 as ref
from tendermint_tpu_torch.ops import edwards25519 as ed
from tendermint_tpu_torch.ops import field25519 as fe
from tendermint_tpu_torch.ops import scalar25519 as sc

L = ref.L
P = ref.P

# ---------------------------------------------------------------------------
# Fixed-base comb table for B (host, exact ints)
# ---------------------------------------------------------------------------


def _b_comb_affine() -> list[tuple[int, int]]:
    """T_B[w] = sum_j w_j * [2^(64j)] B as affine points, w = 0..15."""
    base = (ref.BASE[0], ref.BASE[1])
    pj = [base]
    for _ in range(3):
        p = pj[-1]
        for _ in range(64):
            p = ed.affine_add(p, p)
        pj.append(p)
    pts = []
    for w in range(16):
        acc = (0, 1)
        for j in range(4):
            if (w >> j) & 1:
                acc = ed.affine_add(acc, pj[j])
        pts.append(acc)
    return pts


B_COMB_AFFINE = _b_comb_affine()

# ---------------------------------------------------------------------------
# Per-key comb tables (torch ops on the device)
# ---------------------------------------------------------------------------

# Comb-table recurrence: T[w] = T[w ^ lsb(w)] + ps[log2(lsb(w))]. The unified
# Edwards formula is complete, so T[0] = identity participates safely.
_COMB_PREV = [w ^ (w & -w) for w in range(16)]
_COMB_J = [max((w & -w).bit_length() - 1, 0) for w in range(16)]


def build_comb_tables(a_neg: torch.Tensor) -> torch.Tensor:
    """(K, 4, 20) extended -A points -> (K, 16, 4, 20) comb tables:
    ps[j] = [2^(64j)](-A) by 64 doublings each, then the 16 entries."""
    ps = [a_neg]
    for _ in range(3):
        p = ps[-1]
        for _ in range(64):
            p = ed.double(p)
        ps.append(p)
    tab = [ed.identity(a_neg.shape[:1], a_neg.device)]
    for w in range(1, 16):
        tab.append(ed.add(tab[_COMB_PREV[w]], ps[_COMB_J[w]]))
    return torch.stack(tab, dim=1)


def to_niels(tab_ext: torch.Tensor) -> torch.Tensor:
    """(Kb, 16, 4, 20) extended comb points -> (Kb, 960) niels rows
    (y+x | y-x | 2dxy per entry, affine via batched Z inversion): the JAX
    package's KeySet.niels_rows() layout."""
    X, Y, Z = tab_ext[:, :, 0], tab_ext[:, :, 1], tab_ext[:, :, 2]
    zinv = fe.inv(Z)
    x = fe.mul(X, zinv)
    y = fe.mul(Y, zinv)
    txy = fe.mul(fe.mul(x, y), ed._two_d(tab_ext.device))
    niels = torch.stack([fe.add(y, x), fe.sub(y, x), txy], dim=2)
    return niels.reshape(tab_ext.shape[0], 960)


# ---------------------------------------------------------------------------
# Key sets: per-validator-set comb tables, device-resident across heights
# ---------------------------------------------------------------------------

_decomp_cache: dict[bytes, np.ndarray | None] = {}


def _decompress_neg(pub: bytes) -> np.ndarray | None:
    """Cached: pubkey bytes -> extended limbs of -A, or None if invalid."""
    hit = _decomp_cache.get(pub)
    if hit is not None or pub in _decomp_cache:
        return hit
    pt = ref._decompress(pub)
    out = None
    if pt is not None:
        x, y, _, _ = pt
        out = ed.negate_affine(x, y)
    if len(_decomp_cache) < 1_000_000:
        _decomp_cache[pub] = out
    return out


class KeySet:
    """Comb tables for an ordered multiset of pubkeys, cached on a device.

    `niels_rows()` is the (Kb, 960) int32 radix-2^13 niels form (the JAX
    package's layout); `kernel_rows()` the (Kb, 16, 3, 10) form the CUDA
    kernel reads, converted once per set and cached. `valid` (Kb,) bool marks
    keys that decoded. `key_idx` maps item slot -> table row for the pubkey
    sequence this KeySet was BUILT from; callers use the per-sequence key_idx
    returned by build_keyset (the unique-key-set cache reuses one KeySet
    across many sequences)."""

    __slots__ = ("n_keys", "valid", "key_idx", "tab_ext", "_niels", "_kernel")

    def __init__(self, n_keys, valid, key_idx, tab_ext=None, niels=None):
        self.n_keys = n_keys
        self.valid = valid
        self.key_idx = key_idx
        self.tab_ext = tab_ext
        self._niels = niels
        self._kernel = None

    def niels_rows(self) -> torch.Tensor:
        """(Kb, 960) niels-form comb tables, built on the device once."""
        if self._niels is None:
            self._niels = to_niels(self.tab_ext)
        return self._niels

    def kernel_rows(self) -> torch.Tensor:
        """(Kb, 16, 3, 10) kernel-form tables, converted once per set."""
        if self._kernel is None:
            from tendermint_tpu_torch.ops import ed25519_cuda

            self._kernel = ed25519_cuda.kernel_table(self.niels_rows())
        return self._kernel


_KS_LOCK = threading.Lock()
# Level 1: (device, exact pubkey SEQUENCE) -> (KeySet, key_idx). Steady-state
# consensus re-verifies the same validator order every height.
_KS_CACHE: OrderedDict = OrderedDict()
_KS_MAX = 8
# Level 2: (device, unique-key-SET digest) -> KeySet, so a novel interleaving
# over known keys pays only the O(n) index mapping, never a table rebuild.
# Unique keys are sorted before digesting/building so the row order (and
# digest) is interleaving-independent.
_KS_UNIQ_CACHE: OrderedDict = OrderedDict()
_KS_UNIQ_MAX = 16


def _normalize_pubs(pubs: list[bytes]) -> tuple[bytes, np.ndarray]:
    """-> (joined 32-byte-normalized pubkey bytes, (N,) bool size-ok mask)."""
    n = len(pubs)
    ok = np.fromiter((len(p) == ref.PUBKEY_SIZE for p in pubs), dtype=bool, count=n)
    if ok.all():
        return b"".join(pubs), ok
    zero = b"\x00" * 32
    return b"".join(p if len(p) == 32 else zero for p in pubs), ok


def build_keyset(pubs: list[bytes], device) -> tuple[KeySet, np.ndarray, np.ndarray]:
    """-> (KeySet on `device`, key_idx (N,) int32, pub_ok (N,) bool). Two
    cache levels: the exact pubkey SEQUENCE, then the sorted unique-key SET
    digest."""
    joined, pub_ok = _normalize_pubs(pubs)
    dkey = str(device)
    with _KS_LOCK:
        hit = _KS_CACHE.get((dkey, joined))
        if hit is not None:
            _KS_CACHE.move_to_end((dkey, joined))
            ks, key_idx = hit
            return ks, key_idx, pub_ok

    # dedupe in first-occurrence order, then canonicalize row order by
    # sorting the unique keys
    n = len(pubs)
    seen: dict[bytes, int] = {}
    uniq: list[bytes] = []
    key_slot = np.empty(n, dtype=np.int32)
    for i in range(n):
        p = joined[32 * i : 32 * i + 32]
        j = seen.get(p)
        if j is None:
            j = seen[p] = len(uniq)
            uniq.append(p)
        key_slot[i] = j
    order = sorted(range(len(uniq)), key=uniq.__getitem__)
    rank = np.empty(len(uniq), dtype=np.int32)
    for r, j in enumerate(order):
        rank[j] = r
    uniq = [uniq[j] for j in order]
    key_idx = rank[key_slot] if n else key_slot

    set_key = (dkey, hashlib.sha256(b"".join(uniq)).digest())
    with _KS_LOCK:
        ks = _KS_UNIQ_CACHE.get(set_key)
        if ks is not None:
            _KS_UNIQ_CACHE.move_to_end(set_key)
    if ks is None:
        # decompress unique keys on the host, build comb tables on device
        a_neg = np.broadcast_to(ed.IDENTITY_LIMBS, (len(uniq), 4, 20)).copy()
        valid = np.zeros((len(uniq),), dtype=bool)
        for j, p in enumerate(uniq):
            neg = _decompress_neg(p)
            if neg is not None:
                a_neg[j] = neg
                valid[j] = True
        tab_ext = build_comb_tables(torch.from_numpy(a_neg).to(device))
        ks = KeySet(len(uniq), valid, key_idx, tab_ext=tab_ext)
    with _KS_LOCK:
        _KS_CACHE[(dkey, joined)] = (ks, key_idx)
        while len(_KS_CACHE) > _KS_MAX:
            _KS_CACHE.popitem(last=False)
        _KS_UNIQ_CACHE[set_key] = ks
        while len(_KS_UNIQ_CACHE) > _KS_UNIQ_MAX:
            _KS_UNIQ_CACHE.popitem(last=False)
    return ks, key_idx, pub_ok


# ---------------------------------------------------------------------------
# Host-side preparation (vectorized)
# ---------------------------------------------------------------------------


def prepare_scalars(items, pub_ok: np.ndarray) -> dict:
    """Per-signature host prep over [(pub, msg, sig)]: returns numpy arrays
    sized to len(items): s32/r32 (N, 32) uint8, h64 (N, 64) uint8 raw
    SHA-512(R || A || msg) digests (reduced mod L on the device), valid (N,)
    bool = size ok & S < L & pub_ok."""
    n = len(items)
    sig_ok = np.fromiter(
        (len(it[2]) == ref.SIGNATURE_SIZE for it in items), dtype=bool, count=n
    )
    zero = b"\x00" * 64
    sigs = b"".join(it[2] if len(it[2]) == 64 else zero for it in items)
    sigs = np.frombuffer(sigs, dtype=np.uint8).reshape(n, 64)
    r32 = np.ascontiguousarray(sigs[:, :32])
    s32 = np.ascontiguousarray(sigs[:, 32:])

    pubs32, _ = _normalize_pubs([it[0] for it in items])
    h64 = b"".join(
        hashlib.sha512(sigs[i, :32].tobytes() + pubs32[32 * i : 32 * i + 32]
                       + it[1]).digest()
        for i, it in enumerate(items))
    valid = sig_ok & sc.lt_l(s32) & pub_ok
    return dict(s32=s32, r32=r32, valid=valid,
                h64=np.frombuffer(h64, dtype=np.uint8).reshape(n, 64))


def lookup_keys(items, device) -> tuple[KeySet, np.ndarray, np.ndarray]:
    """build_keyset over the items' pubkeys, with pub_ok also false where
    the key did not decompress. Such keys sit in the table as the identity
    point; without this mask a forged (R = compress([s]B), s) pair would
    verify under any off-curve pubkey (the scalar path rejects these)."""
    ks, key_idx, pub_ok = build_keyset([it[0] for it in items], device)
    return ks, key_idx, pub_ok & ks.valid[key_idx]


def dispatch_batch(items: list[tuple[bytes, bytes, bytes]], device=None):
    """Async batched verify of [(pub, msg, sig)] on `device` (default:
    device.default_device()): host prep and kernel launches are issued,
    nothing is fetched. Returns (device_out, finish) where
    `finish(device_out.cpu().numpy())` -> (len(items),) bool."""
    if not items:
        return None, lambda _: np.zeros((0,), dtype=bool)
    from tendermint_tpu_torch.ops import ed25519_cuda

    dev = _device.resolve(device)
    n = len(items)
    ks, key_idx, pub_ok = lookup_keys(items, dev)
    out = ed25519_cuda.dispatch_items(ks, key_idx, items, pub_ok, dev)
    return out, lambda v: ed25519_cuda.unpack_bitmap(v, n)


def verify_batch(items: list[tuple[bytes, bytes, bytes]], device=None) -> np.ndarray:
    """Batched verify of [(pub, msg, sig)]; returns (len(items),) bool."""
    dev, finish = dispatch_batch(items, device)
    return finish(None if dev is None else dev.cpu().numpy())
