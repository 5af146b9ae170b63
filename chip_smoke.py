#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:

1. the card: its name, and its name and power limit from nvidia-smi;
2. the kernel builds (nvcc, from tendermint_tpu_torch/csrc, both kernels at
   once), with their times, registers and spills (ptxas) and the blocks of
   each one SM holds, and the sr25519 kernel's block shape (comb warps,
   decode warps, threads);
3. the ed25519 kernel against its plain PyTorch version on the card, both
   fed the same raw digests and S bytes, on a seeded batch of ~4,096
   signatures mixing valid ones, flipped bits in R, S and the message,
   S >= L, truncated signatures, off-curve and small-order keys,
   non-canonical R and padding lanes; both bitmaps must equal the scalar
   reference's; then a copy with out-of-range key indices on some lanes that
   verify, which must come out false in both;
4. the sr25519 kernel against its plain version and the scalar reference in
   the same way, on ~1,024 seeded sr25519 signatures: valid ones, a wrong
   message, forged s = 0, the marker bit cleared, R's parity flipped, R
   tweaked, an undecodable key, a truncated signature, a wrong key,
   s + L, R >= p, an R that is not a square, padding lanes, and
   out-of-range key indices on lanes that verify;
5. the ed25519 main path at full width: a 10,240-validator ed25519 commit
   through ValidatorSet.verify_commit and verify_commit_light (accepted), a
   copy with one tampered signature (ErrWrongSignature at that index), and
   the 20,480-signature prevote+precommit batch through
   Ed25519BatchVerifier; the kernel's launch count is read around it;
6. the mixed main path at full width: 10,240 validators, 7,168 ed25519 and
   3,072 sr25519 keys (BASELINE config 4's 70/30 split), the same four
   checks with the tampered signature an sr25519 one and the batch through
   MixedBatchVerifier; both kernels' launch counts are read around it and
   must be > 0;
7. times on the card with CUDA events after a warm-up: verify_commit p50
   (ed25519; mixed at 10,240 and at config 4's 1,000 = 700 + 300), each
   kernel and its plain version per 20,480 signatures beside its bound,
   the ed25519 kernel at 4,096 to 81,920 signatures and the sr25519 kernel
   at 320 to 81,920, the main path's launch sizes among them (lanes
   repeated, checked against the first result)
   with the products its threads issue a signature, counted from the
   program, against those the signature needs,
   the comb-table builds (10,240 ed25519 keys; 3,072 sr25519 keys with the
   host ristretto decode), then both commits' stages one by one and one
   call of each under torch.profiler (device idle share).

Prints a `{"kernels": [...]}` line, the card line, and last
`{"ok": true, "device": {...}}`. Exits non-zero, printing no result, when no
CUDA device is present.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import random
import subprocess
import sys
import time

SEED = 20260
N_VALIDATORS = 10_240
N_SR = 3_072  # sr25519 keys of the mixed set; the other 7,168 are ed25519
CONFIG4 = (700, 300)  # BASELINE config 4: ed25519 and sr25519 validators
N_ADVERSARIAL = 4_090  # padded to 4,096 lanes by the dispatch
N_SR_ADVERSARIAL = 1_020  # padded to 1,024
CHAIN_ID = "chip-smoke"
DEVICE = "cuda"
# Peak 32-bit integer multiply-add rate of an H100 SXM: its CUDA cores do
# 67 TFLOP/s in float32 (2 flops per FMA on 128 lanes per SM); integer
# multiply-adds issue on 64 lanes per SM, a quarter of that flop rate.
PEAK_IMAD_PER_S = 67e12 / 4
# A 32x32->64 product is two multiply-adds (low and high halves).
IMAD_PER_PRODUCT = 2
HBM_BYTES_PER_S = 3.35e12
# 32x32->64 products a signature needs (tendermint_tpu_torch/csrc/
# fe25519.cuh, sc25519.cuh): 100 per field multiply, 55 per squaring, 84 for
# h mod L. Multiplies: 64 steps x (4 + 2 x 7), 11 in the inversion, 2 for
# x and y; squarings: 64 steps x 4, 254 in the inversion.
PRODUCTS_PER_SIG = (64 * 18 + 11 + 2) * 100 + (64 * 4 + 254) * 55 + 84
# The same for the sr25519 kernel (csrc/ristretto.cuh): the comb, then in
# place of the inversion and the compare the decode's (p-5)/8 power (11
# multiplies, 251 squarings) with 13 multiplies and 6 squarings around it,
# and 4 multiplies of the coset check; 84 for k mod L.
SR_PRODUCTS_PER_SIG = (64 * 18 + 11 + 13 + 4) * 100 + (64 * 4 + 251 + 6) * 55 + 84
# Products the sr25519 kernel's threads issue (csrc/sr25519_verify.cu),
# counted from the program: each of a signature's four comb threads k mod L
# and 64 steps of one squaring and five multiplies (ed25519_lanes.cuh's
# rounds), then the coset check's 4 multiplies; a decode lane the decode's
# 24 multiplies and 257 squarings for each signature it covers.
SR_COMB_THREAD_PRODUCTS = 84 + 64 * (55 + 5 * 100) + 4 * 100
SR_DECODE_PRODUCTS = (11 + 13) * 100 + (251 + 6) * 55
# Lane counts of the kernel's sweep: 4,096, one commit, its prevote +
# precommit batch, and four such batches.
SWEEP = (4_096, N_VALIDATORS, 2 * N_VALIDATORS, 8 * N_VALIDATORS)
# The sr25519 kernel's: the main path's launches (config 4's commit, 300
# lanes padded to 320; a mixed commit; the mixed batch's sr25519 lanes),
# then the ed25519 sweep's three largest.
SR_SWEEP = (320, N_SR, 2 * N_SR, N_VALIDATORS, 2 * N_VALIDATORS, 8 * N_VALIDATORS)


def _keygen(seeds):
    from tendermint_tpu_torch.crypto import ed25519

    return [ed25519.gen_priv_key(s).data for s in seeds]


def _sr_keygen(seeds):
    from tendermint_tpu_torch.crypto import sr25519

    return [sr25519.gen_priv_key(s).data for s in seeds]


def _sign(jobs):
    """[(priv, msg)] ed25519, or [(mini, msg, nonce seed)] sr25519."""
    from tendermint_tpu_torch.crypto import ed25519, sr25519

    return [ed25519.sign(*j) if len(j) == 2 else sr25519.sign(j[0], j[1], rng_seed=j[2])
            for j in jobs]


def _ref_verify(items):
    from tendermint_tpu_torch.crypto import ed25519

    return [ed25519.verify(*it) for it in items]


def _sr_ref_verify(items):
    from tendermint_tpu_torch.crypto import sr25519

    return [sr25519.verify(*it) for it in items]


def _pmap(pool, fn, xs, parts):
    step = -(-len(xs) // parts)
    chunks = [xs[i:i + step] for i in range(0, len(xs), step)]
    return [y for part in pool.map(fn, chunks) for y in part]


def _time_cuda(torch, fn, iters):
    """Mean ms per call of fn() by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _repeat_lanes(torch, args, m):
    """The kernel's arguments for the first m lanes of `args` repeated
    along the lane axis."""
    tab, *cols = args
    reps = -(-m // cols[0].shape[-1])
    return (tab, *[torch.cat([c] * reps, dim=-1)[..., :m].contiguous()
                   for c in cols])


def _lane_inputs(edb, cu, items, dev):
    """The kernel's inputs for `items`, built as the dispatch builds them,
    and the KeySet they came from."""
    ks, key_idx, pub_ok = edb.lookup_keys(items, dev)
    return cu.lane_inputs(ks, key_idx, items, pub_ok, dev), ks


def _adversarial_items(ref, pool, rng, n):
    """Seeded mix of valid and invalid signatures over 64 keys."""
    privs = _keygen([rng.randbytes(32) for _ in range(64)])
    plan = []
    for i in range(n):
        priv = privs[rng.randrange(64)]
        plan.append((priv, b"adv-%d-" % i + rng.randbytes(rng.randrange(0, 200))))
    sigs = _pmap(pool, _sign, plan, os.cpu_count() or 1)
    small = (ref.P - 1).to_bytes(32, "little")  # y = -1: order-2 point
    kinds = ("valid", "flip_r", "flip_s", "flip_msg", "s_ge_l", "truncated",
             "off_curve", "small_order", "noncanon_r", "forged_bad_key")
    items = []
    for i, ((priv, msg), sig) in enumerate(zip(plan, sigs)):
        pub = priv[32:]
        sig = bytearray(sig)
        kind = kinds[i % len(kinds)] if i % 3 else "valid"
        if kind == "flip_r":
            sig[rng.randrange(32)] ^= 1 << rng.randrange(8)
        elif kind == "flip_s":
            sig[32 + rng.randrange(32)] ^= 1 << rng.randrange(8)
        elif kind == "flip_msg":
            msg = bytes([msg[0] ^ 1]) + msg[1:]
        elif kind == "s_ge_l":
            s = int.from_bytes(sig[32:], "little") + ref.L
            sig[32:] = s.to_bytes(32, "little")
        elif kind == "truncated":
            sig = sig[:63]
        elif kind == "off_curve":
            pub = (5).to_bytes(32, "little")
        elif kind == "small_order":
            pub = small
            if i % 2:  # s = 0, R = identity: the forgery a torsion key admits
                sig = bytearray((1).to_bytes(32, "little") + b"\x00" * 32)
        elif kind == "noncanon_r":
            sig[:32] = ref.P.to_bytes(32, "little")
        elif kind == "forged_bad_key":
            s = rng.randrange(ref.L)
            sig = bytearray(ref._compress(ref._scalarmult(s, ref.BASE))
                            + s.to_bytes(32, "little"))
            pub = ref.P.to_bytes(32, "little")
        items.append((pub, msg, bytes(sig)))
    return items


def _sr_adversarial_items(sr, pool, rng, n):
    """Seeded mix of valid and invalid sr25519 signatures over 32 keys: the
    cases of tests/test_sr25519_batch.py, R >= p and R not a square."""
    minis = _pmap(pool, _sr_keygen, [rng.randbytes(32) for _ in range(32)],
                  os.cpu_count() or 1)
    pubs = [sr.PrivKey(m).pub_key().data for m in minis]
    plan = []
    for i in range(n):
        k = rng.randrange(32)
        plan.append((k, b"sr-adv-%d-" % i + rng.randbytes(rng.randrange(0, 200))))
    sigs = _pmap(pool, _sign, [(minis[k], m, rng.randbytes(32)) for k, m in plan],
                 os.cpu_count() or 1)
    not_square = next(s for s in range(2, 1 << 20, 2)  # even, < p, no square root
                      if sr.ristretto_decode(s.to_bytes(32, "little")) is None
                      and not _sr_is_square(sr, s))
    kinds = ("valid", "wrong_msg", "forged_s0", "marker_clear", "r_parity",
             "r_tweak", "undecodable_pub", "truncated", "wrong_pub", "s_plus_l",
             "r_ge_p", "r_not_square")
    items = []
    for i, ((k, msg), sig) in enumerate(zip(plan, sigs)):
        pub, sig = pubs[k], bytearray(sig)
        kind = kinds[i % len(kinds)] if i % 3 else "valid"
        if kind == "wrong_msg":
            msg = msg + b"!"
        elif kind == "forged_s0":
            sig[32:] = bytes(31) + b"\x80"
        elif kind == "marker_clear":
            sig[63] &= 0x7F
        elif kind == "r_parity":
            sig[0] ^= 1
        elif kind == "r_tweak":
            sig[rng.randrange(1, 32)] ^= 1 << rng.randrange(8)
        elif kind == "undecodable_pub":
            pub = b"\xff" * 32
        elif kind == "truncated":
            sig = sig[:12]
        elif kind == "wrong_pub":
            pub = pubs[(k + 1) % 32]
        elif kind == "s_plus_l":
            s = int.from_bytes(sig[32:], "little") & ((1 << 255) - 1)
            sig[32:] = ((s + sr.L) | (1 << 255)).to_bytes(32, "little")
        elif kind == "r_ge_p":
            sig[:32] = (sr.P + 1 + 2 * rng.randrange(8)).to_bytes(32, "little")
        elif kind == "r_not_square":
            sig[:32] = not_square.to_bytes(32, "little")
        items.append((pub, msg, bytes(sig)))
    return items


def _sr_is_square(sr, s):
    """Whether the decode of the even encoding s finds its square root."""
    P = sr.P
    ss = s * s % P
    u1, u2 = (1 - ss) % P, (1 + ss) % P
    v = (-(sr.D * u1 % P * u1) - u2 * u2) % P
    return sr._sqrt_ratio_m1(1, v * u2 * u2 % P)[0]


def _check_kernel(torch, np, name, kernel, plain, args, want, t0):
    """kernel(*args) == plain(*args) == want on the items' lanes, padding
    false; then out-of-range key indices on some lanes that verify must be
    false in both. Returns the max abs difference of kernel and plain (0)."""
    got_k = kernel(*args).cpu().numpy()
    got_p = plain(*args).cpu().numpy()
    n, lanes = len(want), got_k.shape[0]
    err = int(np.abs(got_k.astype(np.int64) - got_p).max())
    if err or not (got_k[:n].astype(bool) == want).all():
        raise SystemExit(f"{name}: kernel/plain/reference disagree: kernel "
                         f"{got_k.sum()} plain {got_p.sum()} want {want.sum()}")
    if got_k[n:].any():
        raise SystemExit(f"{name}: a padding lane came out true")
    dev = args[0].device
    hit = np.flatnonzero(got_k)[::50]
    bad = args[1].clone()
    bad[torch.from_numpy(hit).to(dev)] = torch.tensor(
        [-1, args[0].shape[0], 1 << 30], dtype=torch.int32,
        device=dev).repeat(len(hit))[:len(hit)]
    bargs = (args[0], bad, *args[2:])
    bad_k = kernel(*bargs).cpu().numpy()
    rest = np.ones(lanes, dtype=bool)
    rest[hit] = False
    if ((bad_k != plain(*bargs).cpu().numpy()).any()
            or bad_k[hit].any() or (bad_k[rest] != got_k[rest]).any()):
        raise SystemExit(f"{name}: lanes with an out-of-range key index are wrong")
    print(f"[{name} kernel==plain==reference] {n} signatures + {lanes - n} padding "
          f"lanes, {int(want.sum())} valid; {len(hit)} of those false with an "
          f"out-of-range key index; max_abs_err {err}; "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    return err


def _signed_votes(pool, vals, signer, block_id, height, ts, rng):
    """Prevote and precommit of every validator of `vals`, signed in the
    pool: {(type, index): Vote}. signer: address -> ed25519 priv or
    sr25519 mini."""
    from tendermint_tpu_torch.types.vote import PRECOMMIT_TYPE, PREVOTE_TYPE, Vote

    votes, jobs = {}, []
    for vtype in (PREVOTE_TYPE, PRECOMMIT_TYPE):
        for i, v in enumerate(vals.validators):
            vote = Vote(vtype, height, 0, block_id, ts.add_ns(i), v.address, i)
            votes[vtype, i] = vote
            key = signer[v.address]
            msg = vote.sign_bytes(CHAIN_ID)
            jobs.append((key, msg) if v.pub_key.type == "ed25519"
                        else (key, msg, rng.randbytes(32)))
    for vote, sig in zip(votes.values(), _pmap(pool, _sign, jobs, os.cpu_count() or 1)):
        vote.signature = sig
    return votes


class _MainPath:
    """One validator set, its signed votes, the commit, a copy with one
    tampered signature (at an index of the given key type) and the
    prevote+precommit batch with that signature tampered too."""

    def __init__(self, np, rng, vals, votes, block_id, height, tamper_type):
        from tendermint_tpu_torch.types.block import make_commit
        from tendermint_tpu_torch.types.vote import PRECOMMIT_TYPE

        n = len(vals.validators)
        self.vals, self.block_id, self.height = vals, block_id, height
        pre = [votes[PRECOMMIT_TYPE, i] for i in range(n)]
        self.commit = make_commit(block_id, height, 0, pre)
        self.bad_idx = rng.choice([i for i, v in enumerate(vals.validators)
                                   if v.pub_key.type == tamper_type])
        self.bad_commit = make_commit(block_id, height, 0, pre)
        s = bytearray(self.bad_commit.signatures[self.bad_idx].signature)
        s[rng.randrange(64)] ^= 1 << rng.randrange(8)
        self.bad_commit.signatures[self.bad_idx].signature = bytes(s)
        self.batch = [(vals.validators[i].pub_key, vote.sign_bytes(CHAIN_ID),
                       vote.signature) for (_, i), vote in votes.items()]
        self.batch[n + self.bad_idx] = self.batch[n + self.bad_idx][:2] + (bytes(s),)
        self.batch_want = np.ones(len(self.batch), dtype=bool)
        self.batch_want[n + self.bad_idx] = False

    def run(self, np, verifier):
        """verify_commit and verify_commit_light accept, the tampered copy
        fails at its index, the batch's bitmap through `verifier` is exact."""
        from tendermint_tpu_torch.types.validator_set import ErrWrongSignature

        args = (CHAIN_ID, self.block_id, self.height)
        self.vals.verify_commit(*args, self.commit)
        self.vals.verify_commit_light(*args, self.commit)
        try:
            self.vals.verify_commit(*args, self.bad_commit)
            raise SystemExit("tampered commit accepted")
        except ErrWrongSignature as e:
            if e.index != self.bad_idx:
                raise SystemExit(f"tampered commit: index {e.index}, want {self.bad_idx}")
        for it in self.batch:
            verifier.add(*it)
        all_ok, bitmap = verifier.verify()
        if all_ok or not (np.array(bitmap) == self.batch_want).all():
            raise SystemExit(f"{len(self.batch)}-signature batch bitmap is wrong")

    def p50(self, np, runs=7):
        ms = []
        for _ in range(runs):
            t0 = time.monotonic()
            self.vals.verify_commit(CHAIN_ID, self.block_id, self.height, self.commit)
            ms.append((time.monotonic() - t0) * 1e3)
        return float(np.median(ms)), ms


def _where_the_time_goes(torch, np, kinds, mp, dev, card, label):
    """verify_commit's stages, each through the package's own functions in
    the order each key type's dispatch_batch calls them, timed one by one (a
    device sync after each), median of 5; then one verify_commit under
    torch.profiler for the device's busy time and idle share. kinds: key
    type -> (its ops module, its kernel module)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    vals, commit = mp.vals, mp.commit
    n = len(commit.signatures)
    stages: dict[str, list[float]] = {}

    def lap(name, t0):
        torch.cuda.synchronize()
        stages.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return time.perf_counter()

    for _ in range(5):
        t = time.perf_counter()
        items: dict[str, list] = {}
        for i in range(n):
            pk = vals.validators[i].pub_key
            items.setdefault(pk.type, []).append(
                (pk.bytes(), commit.vote_sign_bytes(CHAIN_ID, i),
                 commit.signatures[i].signature))
        t = lap("sign_bytes", t)
        if max(len(v) for v in items.values()) > kinds["ed25519"][1].CHUNK:
            raise SystemExit("breakdown: more signatures than one chunk")
        looked = {kt: kinds[kt][0].lookup_keys(its, dev) for kt, its in items.items()}
        t = lap("keyset_lookup", t)
        host = {}
        for kt, its in items.items():
            _, key_idx, pub_ok = looked[kt]
            host[kt] = kinds[kt][1].host_lanes(key_idx, its, pub_ok)
            t = lap(f"{kt} host_prep", t)
        args = {kt: kinds[kt][1].device_lanes(looked[kt][0], host[kt], dev)
                for kt in items}
        t = lap("upload", t)
        packed = {}
        for kt in items:
            packed[kt] = kinds[kt][1].pack_bitmap(kinds[kt][1].verify(*args[kt]))
            t = lap(f"{kt} kernel", t)
        ok = [kinds[kt][1].unpack_bitmap(packed[kt].cpu().numpy(), len(items[kt])).all()
              for kt in items]
        lap("readback", t)
        if not all(ok):
            raise SystemExit("breakdown: the commit did not verify")
    med = {k: float(np.median(v)) for k, v in stages.items()}
    print(f"[where] {label} verify_commit stages at {n} validators, median of 5, "
          "ms: " + ", ".join(f"{k} {v:.2f}" for k, v in med.items())
          + f" (sum {sum(med.values()):.2f}) on {card}")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        vals.verify_commit(CHAIN_ID, mp.block_id, mp.height, commit)
        wall_ms = (time.perf_counter() - t) * 1e3
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation) / 1e3
    print(f"[where] profiled {label} verify_commit: wall {wall_ms:.2f} ms, device "
          f"busy {busy_ms:.3f} ms, device idle {100 * (1 - busy_ms / wall_ms):.1f}% "
          f"on {card}", flush=True)


def _bound_ms(args, n_sig, products_per_sig, tab_b_ints):
    """The least time for the kernel's work on these inputs: the larger of
    its bytes (each input read once, the output written once) over HBM's
    rate and its 32x32->64 products over the integer multiply-add rate."""
    bytes_moved = (sum(t.numel() * t.element_size() for t in args)
                   + tab_b_ints * 4 + n_sig * 4)
    ops_s = n_sig * products_per_sig * IMAD_PER_PRODUCT / PEAK_IMAD_PER_S
    bytes_s = bytes_moved / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from tendermint_tpu_torch.crypto import batch as crypto_batch
    from tendermint_tpu_torch.crypto import ed25519 as ref
    from tendermint_tpu_torch.crypto import sr25519 as sr
    from tendermint_tpu_torch.ops import ed25519_batch as edb
    from tendermint_tpu_torch.ops import ed25519_cuda as cu
    from tendermint_tpu_torch.ops import sr25519_batch as srb
    from tendermint_tpu_torch.ops import sr25519_cuda as scu
    from tendermint_tpu_torch.types.block_id import BlockID, PartSetHeader
    from tendermint_tpu_torch.types.ttime import Time
    from tendermint_tpu_torch.types.validator import Validator
    from tendermint_tpu_torch.types.validator_set import ValidatorSet

    dev = torch.device(DEVICE)
    rng = random.Random(SEED)
    kinds = {"ed25519": (edb, cu), "sr25519": (srb, scu)}

    # 1. the card
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = f"{name}, power limit {smi.split(',')[-1].strip()}"
    print(f"[card] {name} | nvidia-smi: {smi}", flush=True)

    # 2. the kernel builds, both nvcc runs at once
    def timed_build(mod):
        t0 = time.monotonic()
        mod.load_library()
        return time.monotonic() - t0

    with ThreadPoolExecutor(2) as ex:
        build_s = dict(zip(kinds, ex.map(timed_build, (cu, scu))))
    for kt, (_, mod) in kinds.items():
        print(f"[build] {kt}: nvcc sm_90a {build_s[kt]:.1f} s (both built at once)")
        for line in mod.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {kt}: {line.strip()}")
        info = mod.kernel_info()
        print(f"[build] {kt} kernel: {info['threads']} threads a block, "
              f"{info['registers']} registers and {info['local_bytes']} local "
              f"bytes a thread, {info['blocks_per_sm']} blocks resident per SM "
              f"on {card}", flush=True)
    sr_info = scu.kernel_info()
    sr_design = (f"{sr_info['comb_warps']} comb warps + {sr_info['decode_warps']} "
                 f"decode warp(s) x {sr_info['decodes_per_lane']} decodes a lane, "
                 f"{sr_info['threads']} threads and {sr_info['sigs_per_block']} "
                 "signatures a block")
    print(f"[build] sr25519 kernel shape: {sr_design}; {sr_info['registers']} "
          f"registers, {sr_info['local_bytes']} local bytes, "
          f"{sr_info['blocks_per_sm']} blocks per SM on {card}", flush=True)

    height = 1000
    ts = Time(1_700_000_000, 0)
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(os.cpu_count() or 1) as pool:
        # 3. the ed25519 kernel against its plain version
        t0 = time.monotonic()
        adv = _adversarial_items(ref, pool, rng, N_ADVERSARIAL)
        want = np.array(_pmap(pool, _ref_verify, adv, os.cpu_count() or 1))
        args, _ = _lane_inputs(edb, cu, adv, dev)
        adv_err = _check_kernel(torch, np, "ed25519", cu.verify, cu.verify_plain,
                                args, want, t0)

        # 4. the sr25519 kernel against its plain version
        t0 = time.monotonic()
        sr_adv = _sr_adversarial_items(sr, pool, rng, N_SR_ADVERSARIAL)
        sr_want = np.array(_pmap(pool, _sr_ref_verify, sr_adv, os.cpu_count() or 1))
        sks, skey_idx, spub_ok = srb.lookup_keys(sr_adv, dev)
        sargs = scu.lane_inputs(sks, skey_idx, sr_adv, spub_ok, dev)
        sr_adv_err = _check_kernel(torch, np, "sr25519", scu.verify, scu.verify_plain,
                                   sargs, sr_want, t0)

        # the validator sets and their signed votes
        t0 = time.monotonic()
        privs = _pmap(pool, _keygen, [rng.randbytes(32) for _ in range(N_VALIDATORS)],
                      os.cpu_count() or 1)
        minis = _pmap(pool, _sr_keygen, [rng.randbytes(32) for _ in range(N_SR)],
                      os.cpu_count() or 1)
        signer = {}
        ed_vals, sr_vals = [], []
        for p in privs:
            pk = ref.PrivKey(p).pub_key()
            signer[pk.address()] = p
            ed_vals.append(Validator.new(pk, 10))
        for m in minis:
            pk = sr.PrivKey(m).pub_key()
            signer[pk.address()] = m
            sr_vals.append(Validator.new(pk, 10))
        paths = {}
        for label, vs, tamper in (
                ("ed25519", ed_vals, "ed25519"),
                ("mixed", ed_vals[:N_VALIDATORS - N_SR] + sr_vals, "sr25519"),
                ("config4", ed_vals[:CONFIG4[0]] + sr_vals[:CONFIG4[1]], "sr25519")):
            vals = ValidatorSet(vs)
            block_id = BlockID(rng.randbytes(32), PartSetHeader(1, rng.randbytes(32)))
            votes = _signed_votes(pool, vals, signer, block_id, height, ts, rng)
            paths[label] = _MainPath(np, rng, vals, votes, block_id, height, tamper)
    print(f"[setup] {N_VALIDATORS} ed25519 validators; mixed {N_VALIDATORS - N_SR} "
          f"ed25519 + {N_SR} sr25519; config 4 {CONFIG4[0]} + {CONFIG4[1]}; "
          f"{sum(len(mp.batch) for mp in paths.values())} signatures; "
          f"{time.monotonic() - t0:.1f} s", flush=True)

    # 5. the ed25519 main path at full width
    ed_path = paths["ed25519"]
    torch.cuda.synchronize()
    cu.reset_launches()
    scu.reset_launches()
    t0 = time.monotonic()
    ed_path.run(np, crypto_batch.Ed25519BatchVerifier(dev))
    ed_launches = cu.launches
    if ed_launches == 0:
        raise SystemExit("the ed25519 main path never launched the ed25519 kernel")
    print(f"[main path] ed25519: verify_commit + verify_commit_light accepted "
          f"{N_VALIDATORS}; tampered #{ed_path.bad_idx} rejected at its index; "
          f"{len(ed_path.batch)}-signature batch bitmap exact; ed25519 kernel "
          f"launches {ed_launches}; {time.monotonic() - t0:.1f} s (first call "
          f"builds the comb tables)", flush=True)

    # 6. the mixed main path at full width
    mixed = paths["mixed"]
    torch.cuda.synchronize()
    cu.reset_launches()
    scu.reset_launches()
    t0 = time.monotonic()
    mixed.run(np, crypto_batch.MixedBatchVerifier(dev))
    mixed_launches = {"ed25519": cu.launches, "sr25519": scu.launches}
    if min(mixed_launches.values()) == 0:
        raise SystemExit(f"the mixed main path missed a kernel: {mixed_launches}")
    print(f"[main path] mixed: verify_commit + verify_commit_light accepted "
          f"{N_VALIDATORS - N_SR} ed25519 + {N_SR} sr25519; tampered sr25519 "
          f"#{mixed.bad_idx} rejected at its index; {len(mixed.batch)}-signature "
          f"batch bitmap exact through MixedBatchVerifier; kernel launches "
          f"{mixed_launches}; {time.monotonic() - t0:.1f} s (first call builds "
          f"the comb tables)", flush=True)
    paths["config4"].run(np, crypto_batch.MixedBatchVerifier(dev))

    # 7. times
    p50 = {label: mp.p50(np) for label, mp in paths.items()}
    for label, (med, ms) in p50.items():
        vals = paths[label].vals
        print(f"[time] {label} verify_commit p50 at {len(vals.validators)} "
              f"validators: {med:.2f} ms (runs {', '.join(f'{x:.1f}' for x in ms)}) "
              f"on {card}")

    # the ed25519 kernel per 20,480 signatures, its sweep and its tables
    args, ks = _lane_inputs(edb, cu, [(pk.bytes(), m, s) for pk, m, s in ed_path.batch],
                            dev)
    tab = args[0]
    n_sig = len(ed_path.batch)
    kernel_ms = _time_cuda(torch, lambda: cu.verify(*args), 10)
    plain_ms = _time_cuda(torch, lambda: cu.verify_plain(*args), 2)
    ok_k = cu.verify(*args)
    ok_p = cu.verify_plain(*args)
    err = max(adv_err, int((ok_k - ok_p).abs().max()))
    if err or not (ok_k[:n_sig].cpu().numpy().astype(bool) == ed_path.batch_want).all():
        raise SystemExit("ed25519 kernel and plain version disagree at 20,480")
    sweep = []
    for m in SWEEP:
        rargs = _repeat_lanes(torch, args, m)
        if not torch.equal(cu.verify(*rargs), _repeat_lanes(torch, (tab, ok_k), m)[1]):
            raise SystemExit(f"kernel at {m} lanes disagrees with its 20,480 result")
        sweep.append((m, _time_cuda(torch, lambda: cu.verify(*rargs), 10)))
    a_neg = ks.tab_ext[:, 1]  # T[1] = -A for every key
    table_ms = _time_cuda(
        torch, lambda: cu.kernel_table(edb.to_niels(edb.build_comb_tables(a_neg))), 2)
    bound_ms, bound_by = _bound_ms(args, n_sig, PRODUCTS_PER_SIG, 480)
    print(f"[time] ed25519 kernel {kernel_ms:.3f} ms per {n_sig} signatures "
          f"({tab.shape[0]} keys), bound {bound_ms:.3f} ms ({bound_by}), on {card}")
    print(f"[time] ed25519 plain version {plain_ms:.1f} ms per {n_sig} signatures "
          f"on {card}")
    print("[time] ed25519 kernel sweep: " + ", ".join(
        f"{m} sigs {ms:.3f} ms ({1e3 * ms / m:.4f} us/sig)" for m, ms in sweep)
        + f" on {card}")
    print(f"[time] ed25519 comb-table build {table_ms:.1f} ms for {a_neg.shape[0]} "
          f"keys on {card}", flush=True)

    # the sr25519 kernel per 3,072 and 20,480 lanes, its sweep and its tables
    sr_items = [(pk.bytes(), m, s) for pk, m, s in mixed.batch
                if pk.type == "sr25519"]
    sr_want_b = np.array([w for (pk, _, _), w in zip(mixed.batch, mixed.batch_want)
                          if pk.type == "sr25519"])
    sks, skey_idx, spub_ok = srb.lookup_keys(sr_items, dev)
    sargs = scu.lane_inputs(sks, skey_idx, sr_items, spub_ok, dev)
    sok = scu.verify(*sargs)
    if not (sok[:len(sr_items)].cpu().numpy().astype(bool) == sr_want_b).all():
        raise SystemExit("sr25519 kernel wrong on the mixed batch's sr25519 lanes")
    sr_ms = {}
    for m in SR_SWEEP:
        rargs = _repeat_lanes(torch, sargs, m)
        if not torch.equal(scu.verify(*rargs), _repeat_lanes(torch, (sargs[0], sok), m)[1]):
            raise SystemExit(f"sr25519 kernel at {m} lanes disagrees with its first result")
        sr_ms[m] = _time_cuda(torch, lambda: scu.verify(*rargs), 10)
    r20 = _repeat_lanes(torch, sargs, 2 * N_VALIDATORS)
    sr_plain_ms = _time_cuda(torch, lambda: scu.verify_plain(*r20), 2)
    sr_err = max(sr_adv_err, int((scu.verify(*r20) - scu.verify_plain(*r20)).abs().max()))
    if sr_err:
        raise SystemExit("sr25519 kernel and plain version disagree at 20,480")
    sr_bound_ms, sr_bound_by = _bound_ms(r20, 2 * N_VALIDATORS, SR_PRODUCTS_PER_SIG, 480)
    sr_bound_3k, _ = _bound_ms(_repeat_lanes(torch, sargs, N_SR), N_SR,
                               SR_PRODUCTS_PER_SIG, 480)
    pubs = [v.pub_key.bytes() for v in mixed.vals.validators
            if v.pub_key.type == "sr25519"]
    srb._decode_cache.clear()
    t0 = time.perf_counter()
    a_neg = np.stack([srb._decode_neg(p) for p in pubs])
    decode_ms = (time.perf_counter() - t0) * 1e3
    a_neg = torch.from_numpy(a_neg).to(dev)
    sr_table_ms = _time_cuda(
        torch, lambda: cu.kernel_table(edb.to_niels(edb.build_comb_tables(a_neg))), 2)
    print(f"[time] sr25519 kernel {sr_ms[2 * N_VALIDATORS]:.3f} ms per "
          f"{2 * N_VALIDATORS} signatures, bound {sr_bound_ms:.3f} ms ({sr_bound_by}); "
          f"{sr_ms[N_SR]:.3f} ms per {N_SR}, bound {sr_bound_3k:.3f} ms "
          f"({sks.n_keys} keys; lanes repeated) on {card}")
    print("[time] sr25519 kernel sweep: " + ", ".join(
        f"{m} sigs {ms:.3f} ms ({1e3 * ms / m:.4f} us/sig)" for m, ms in sr_ms.items())
        + f" on {card}")
    decodes_per_sig = (32 * sr_info["decode_warps"] * sr_info["decodes_per_lane"]
                       / sr_info["sigs_per_block"])
    issued = 4 * SR_COMB_THREAD_PRODUCTS + decodes_per_sig * SR_DECODE_PRODUCTS
    print(f"[count] sr25519 kernel issues {issued:.0f} lane-products a signature "
          f"(counted from the program: 4 comb threads x {SR_COMB_THREAD_PRODUCTS}, "
          f"{decodes_per_sig:g} decode x {SR_DECODE_PRODUCTS}) against "
          f"{SR_PRODUCTS_PER_SIG} needed: {issued / SR_PRODUCTS_PER_SIG:.3f}x")
    print(f"[time] sr25519 plain version {sr_plain_ms:.1f} ms per "
          f"{2 * N_VALIDATORS} signatures on {card}")
    print(f"[time] sr25519 comb tables for {len(pubs)} keys: host ristretto decode "
          f"{decode_ms:.1f} ms, device build {sr_table_ms:.1f} ms on {card}",
          flush=True)

    _where_the_time_goes(torch, np, kinds, ed_path, dev, card, "ed25519")
    _where_the_time_goes(torch, np, kinds, mixed, dev, card, "mixed")

    print(json.dumps({"kernels": [{
        "name": "ed25519_verify",
        "route": "cuda",
        "source": "tendermint_tpu_torch/csrc/ed25519_verify.cu",
        "replaces": "tendermint_tpu/ops/ed25519_pallas.py:283",
        "launches": ed_launches + mixed_launches["ed25519"],
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "sr25519_verify",
        "design": sr_design,
        "route": "cuda",
        "source": "tendermint_tpu_torch/csrc/sr25519_verify.cu",
        "replaces": "tendermint_tpu/ops/sr25519_batch.py:160",
        "launches": mixed_launches["sr25519"],
        "max_abs_err": sr_err,
        "ms": sr_ms[2 * N_VALIDATORS],
        "plain_ms": sr_plain_ms,
        "bound_ms": sr_bound_ms,
        "bound_by": sr_bound_by,
        "library_ms": None,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
