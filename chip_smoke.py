#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:

1. the card: its name, and its name and power limit from nvidia-smi;
2. the kernel build (nvcc, from tendermint_tpu_torch/csrc), with its time,
   its registers and spills (ptxas) and the blocks of it one SM holds;
3. the kernel against its plain PyTorch version on the card, both fed the
   same raw digests and S bytes, on a seeded batch of ~4,096 signatures
   mixing valid ones, flipped bits in R, S and the message, S >= L,
   truncated signatures, off-curve and small-order keys, non-canonical R
   and padding lanes; both bitmaps must equal the scalar reference's; then
   a copy with out-of-range key indices on some lanes that verify, which
   must come out false in both;
4. the main path at full width: a 10,240-validator ed25519 commit through
   ValidatorSet.verify_commit and verify_commit_light (accepted), a copy
   with one tampered signature (ErrWrongSignature at that index), and the
   20,480-signature prevote+precommit batch through Ed25519BatchVerifier;
   the kernel's launch count is read around this phase and must be > 0;
5. times on the card with CUDA events after a warm-up: verify_commit p50,
   the kernel and its plain version per 20,480 signatures, the kernel at
   4,096, 10,240, 20,480 and 81,920 signatures (the batch's lanes repeated;
   checked against the 20,480 result), the comb-table build for 10,240
   keys, and the kernel's bound; then verify_commit's stages one by one and
   one call under torch.profiler (device idle share).

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
N_ADVERSARIAL = 4_090  # padded to 4,096 lanes by the dispatch
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
# Lane counts of the kernel's sweep: 4,096, one commit, its prevote +
# precommit batch, and four such batches.
SWEEP = (4_096, N_VALIDATORS, 2 * N_VALIDATORS, 8 * N_VALIDATORS)


def _keygen(seeds):
    from tendermint_tpu_torch.crypto import ed25519

    return [ed25519.gen_priv_key(s).data for s in seeds]


def _sign(jobs):
    from tendermint_tpu_torch.crypto import ed25519

    return [ed25519.sign(priv, msg) for priv, msg in jobs]


def _ref_verify(items):
    from tendermint_tpu_torch.crypto import ed25519

    return [ed25519.verify(*it) for it in items]


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


def _where_the_time_goes(torch, np, cu, edb, vals, commit, block_id, height,
                         dev, card):
    """verify_commit's stages, each through the package's own function in
    the order dispatch_batch calls them, timed one by one (a device sync
    after each), median of 5; then one verify_commit under torch.profiler
    for the device's busy time and idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = len(commit.signatures)
    if n > cu.CHUNK:
        raise SystemExit(f"breakdown: {n} signatures are more than one chunk")
    stages: dict[str, list[float]] = {}

    def lap(name, t0):
        torch.cuda.synchronize()
        stages.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return time.perf_counter()

    for _ in range(5):
        t = time.perf_counter()
        items = [(vals.validators[i].pub_key.bytes(),
                  commit.vote_sign_bytes(CHAIN_ID, i),
                  commit.signatures[i].signature) for i in range(n)]
        t = lap("sign_bytes", t)
        ks, key_idx, pub_ok = edb.lookup_keys(items, dev)
        t = lap("keyset_lookup", t)
        host = cu.host_lanes(key_idx, items, pub_ok)
        t = lap("host_prep", t)
        args = cu.device_lanes(ks, host, dev)
        t = lap("upload", t)
        packed = cu.pack_bitmap(cu.verify(*args))
        t = lap("kernel", t)
        if not cu.unpack_bitmap(packed.cpu().numpy(), n).all():
            raise SystemExit("breakdown: the commit did not verify")
        lap("readback", t)
    med = {k: float(np.median(v)) for k, v in stages.items()}
    print(f"[where] verify_commit stages at {n} validators, median of 5, ms: "
          + ", ".join(f"{k} {v:.2f}" for k, v in med.items())
          + f" (sum {sum(med.values()):.2f}) on {card}")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        vals.verify_commit(CHAIN_ID, block_id, height, commit)
        wall_ms = (time.perf_counter() - t) * 1e3
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation) / 1e3
    print(f"[where] profiled verify_commit: wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.3f} ms, device idle {100 * (1 - busy_ms / wall_ms):.1f}% "
          f"on {card}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import numpy as np

    from tendermint_tpu_torch.crypto import batch as crypto_batch
    from tendermint_tpu_torch.crypto import ed25519 as ref
    from tendermint_tpu_torch.ops import ed25519_batch as edb
    from tendermint_tpu_torch.ops import ed25519_cuda as cu
    from tendermint_tpu_torch.types.block import make_commit
    from tendermint_tpu_torch.types.block_id import BlockID, PartSetHeader
    from tendermint_tpu_torch.types.ttime import Time
    from tendermint_tpu_torch.types.validator import Validator
    from tendermint_tpu_torch.types.validator_set import (
        ErrWrongSignature,
        ValidatorSet,
    )
    from tendermint_tpu_torch.types.vote import PRECOMMIT_TYPE, PREVOTE_TYPE, Vote

    dev = torch.device(DEVICE)
    rng = random.Random(SEED)

    # 1. the card
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = f"{name}, power limit {smi.split(',')[-1].strip()}"
    print(f"[card] {name} | nvidia-smi: {smi}", flush=True)

    # 2. the kernel build
    t0 = time.monotonic()
    cu.load_library()
    print(f"[build] nvcc sm_90a {time.monotonic() - t0:.1f} s", flush=True)
    for line in cu.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")
    info = cu.kernel_info()
    print(f"[build] kernel: {info['threads']} threads a block, "
          f"{info['registers']} registers and {info['local_bytes']} local bytes "
          f"a thread, {info['blocks_per_sm']} blocks resident per SM on {card}",
          flush=True)

    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(os.cpu_count() or 1) as pool:
        # 3. kernel against plain version on the adversarial batch
        t0 = time.monotonic()
        adv = _adversarial_items(ref, pool, rng, N_ADVERSARIAL)
        want = np.array(_pmap(pool, _ref_verify, adv, os.cpu_count() or 1))
        args, _ = _lane_inputs(edb, cu, adv, dev)
        got_k = cu.verify(*args).cpu().numpy()
        got_p = cu.verify_plain(*args).cpu().numpy()
        lanes = got_k.shape[0]
        adv_err = int(np.abs(got_k.astype(np.int64) - got_p).max())
        if adv_err or not (got_k[:len(adv)].astype(bool) == want).all():
            raise SystemExit(f"kernel/plain/reference disagree: kernel {got_k.sum()} "
                             f"plain {got_p.sum()} want {want.sum()}")
        if got_k[len(adv):].any():
            raise SystemExit("a padding lane came out true")
        # out-of-range key indices on lanes that verify: 0 in both
        hit = np.flatnonzero(got_k)[::50]
        bad = args[1].clone()
        bad[torch.from_numpy(hit).to(dev)] = torch.tensor(
            [-1, args[0].shape[0], 1 << 30], dtype=torch.int32,
            device=dev).repeat(len(hit))[:len(hit)]
        bargs = (args[0], bad, *args[2:])
        bad_k = cu.verify(*bargs).cpu().numpy()
        rest = np.ones(lanes, dtype=bool)
        rest[hit] = False
        if ((bad_k != cu.verify_plain(*bargs).cpu().numpy()).any()
                or bad_k[hit].any() or (bad_k[rest] != got_k[rest]).any()):
            raise SystemExit("lanes with an out-of-range key index are wrong")
        print(f"[kernel==plain==reference] {len(adv)} signatures + "
              f"{lanes - len(adv)} padding lanes, {int(want.sum())} valid; "
              f"{len(hit)} of those false with an out-of-range key index; "
              f"{time.monotonic() - t0:.1f} s", flush=True)

        # 4. the main path at full width
        t0 = time.monotonic()
        privs = _pmap(pool, _keygen,
                      [rng.randbytes(32) for _ in range(N_VALIDATORS)],
                      os.cpu_count() or 1)
        vals = ValidatorSet([Validator.new(ref.PrivKey(p).pub_key(), 10)
                             for p in privs])
        by_addr = {ref.PrivKey(p).pub_key().address(): p for p in privs}
        height = 1000
        block_id = BlockID(rng.randbytes(32), PartSetHeader(1, rng.randbytes(32)))
        ts = Time(1_700_000_000, 0)
        votes = {}
        jobs = []
        for vtype in (PREVOTE_TYPE, PRECOMMIT_TYPE):
            for i, v in enumerate(vals.validators):
                vote = Vote(vtype, height, 0, block_id, ts.add_ns(i),
                            v.address, i)
                votes[vtype, i] = vote
                jobs.append((by_addr[v.address], vote.sign_bytes(CHAIN_ID)))
        sigs = _pmap(pool, _sign, jobs, os.cpu_count() or 1)
    for (key, vote), sig in zip(votes.items(), sigs):
        vote.signature = sig
    commit = make_commit(block_id, height, 0,
                         [votes[PRECOMMIT_TYPE, i] for i in range(N_VALIDATORS)])
    bad_idx = rng.randrange(N_VALIDATORS)
    bad_commit = make_commit(block_id, height, 0,
                             [votes[PRECOMMIT_TYPE, i] for i in range(N_VALIDATORS)])
    s = bytearray(bad_commit.signatures[bad_idx].signature)
    s[rng.randrange(64)] ^= 1 << rng.randrange(8)
    bad_commit.signatures[bad_idx].signature = bytes(s)
    batch_items = [(vals.validators[i].pub_key, vote.sign_bytes(CHAIN_ID),
                    vote.signature) for (_, i), vote in votes.items()]
    batch_items[N_VALIDATORS + bad_idx] = (
        batch_items[N_VALIDATORS + bad_idx][:2] + (bytes(s),))
    batch_want = np.ones(len(batch_items), dtype=bool)
    batch_want[N_VALIDATORS + bad_idx] = False
    print(f"[setup] {N_VALIDATORS} validators, {len(sigs)} signatures, "
          f"{time.monotonic() - t0:.1f} s", flush=True)

    def run_batch():
        bv = crypto_batch.Ed25519BatchVerifier(dev)
        for it in batch_items:
            bv.add(*it)
        return bv.verify()

    torch.cuda.synchronize()
    cu.reset_launches()
    t0 = time.monotonic()
    vals.verify_commit(CHAIN_ID, block_id, height, commit)
    vals.verify_commit_light(CHAIN_ID, block_id, height, commit)
    try:
        vals.verify_commit(CHAIN_ID, block_id, height, bad_commit)
        raise SystemExit("tampered commit accepted")
    except ErrWrongSignature as e:
        if e.index != bad_idx:
            raise SystemExit(f"tampered commit: index {e.index}, want {bad_idx}")
    all_ok, bitmap = run_batch()
    main_launches = cu.launches
    if all_ok or not (np.array(bitmap) == batch_want).all():
        raise SystemExit("20,480-signature batch bitmap is wrong")
    if main_launches == 0:
        raise SystemExit("the main path never launched the kernel")
    print(f"[main path] verify_commit + verify_commit_light accepted "
          f"{N_VALIDATORS}; tampered #{bad_idx} rejected at its index; "
          f"{len(batch_items)}-signature batch bitmap exact; kernel launches "
          f"{main_launches}; {time.monotonic() - t0:.1f} s (first call builds "
          f"the comb tables)", flush=True)

    # 5. times
    commit_ms = []
    for _ in range(7):
        t0 = time.monotonic()
        vals.verify_commit(CHAIN_ID, block_id, height, commit)
        commit_ms.append((time.monotonic() - t0) * 1e3)
    p50 = float(np.median(commit_ms))
    args, ks = _lane_inputs(edb, cu, [(pk.bytes(), m, s)
                                      for pk, m, s in batch_items], dev)
    tab = args[0]
    n_sig = len(batch_items)
    kernel_ms = _time_cuda(torch, lambda: cu.verify(*args), 10)
    plain_ms = _time_cuda(torch, lambda: cu.verify_plain(*args), 2)
    ok_k = cu.verify(*args)
    ok_p = cu.verify_plain(*args)
    err = max(adv_err, int((ok_k - ok_p).abs().max()))
    if err or not (ok_k[:n_sig].cpu().numpy().astype(bool) == batch_want).all():
        raise SystemExit("kernel and plain version disagree at 20,480")
    sweep = []
    for m in SWEEP:
        sargs = _repeat_lanes(torch, args, m)
        if not torch.equal(cu.verify(*sargs), _repeat_lanes(torch, (tab, ok_k), m)[1]):
            raise SystemExit(f"kernel at {m} lanes disagrees with its 20,480 result")
        sweep.append((m, _time_cuda(torch, lambda: cu.verify(*sargs), 10)))
    a_neg = ks.tab_ext[:, 1]  # T[1] = -A for every key
    table_ms = _time_cuda(
        torch, lambda: cu.kernel_table(edb.to_niels(edb.build_comb_tables(a_neg))), 2)
    bytes_moved = (sum(t.numel() * t.element_size() for t in args)
                   + cu.tab_b10(dev).numel() * 4 + n_sig * 4)
    ops_s = n_sig * PRODUCTS_PER_SIG * IMAD_PER_PRODUCT / PEAK_IMAD_PER_S
    bytes_s = bytes_moved / HBM_BYTES_PER_S
    bound_ms = max(ops_s, bytes_s) * 1e3
    print(f"[time] verify_commit p50 at {N_VALIDATORS} validators: {p50:.2f} ms "
          f"(runs {', '.join(f'{x:.1f}' for x in commit_ms)}) on {card}")
    print(f"[time] kernel {kernel_ms:.3f} ms per {n_sig} signatures "
          f"({tab.shape[0]} keys), bound {bound_ms:.3f} ms "
          f"({'operations' if ops_s >= bytes_s else 'bytes'}), on {card}")
    print(f"[time] plain version {plain_ms:.1f} ms per {n_sig} signatures on {card}")
    print("[time] kernel sweep: " + ", ".join(
        f"{m} sigs {ms:.3f} ms ({1e3 * ms / m:.4f} us/sig)" for m, ms in sweep)
        + f" on {card}")
    print(f"[time] comb-table build {table_ms:.1f} ms for {a_neg.shape[0]} keys "
          f"on {card}", flush=True)
    _where_the_time_goes(torch, np, cu, edb, vals, commit, block_id, height,
                         dev, card)

    print(json.dumps({"kernels": [{
        "name": "ed25519_verify",
        "route": "cuda",
        "source": "tendermint_tpu_torch/csrc/ed25519_verify.cu",
        "replaces": "tendermint_tpu/ops/ed25519_pallas.py:283",
        "launches": main_launches,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_s >= bytes_s else "bytes",
        "library_ms": None,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
