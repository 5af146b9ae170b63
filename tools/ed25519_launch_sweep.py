"""Time the port's ed25519 verify kernel built at other block sizes and
register caps: the answer to how registers and resident blocks trade.

Each variant is tendermint_tpu_torch/csrc/ed25519_verify.cu with THREADS
(threads a block) and MIN_BLOCKS (the __launch_bounds__ minimum of resident
blocks an SM must fit, which caps the registers) replaced, built by nvcc in
parallel into a temporary directory. Inputs are random (the kernel runs the
same program whatever the data), with 10,240 keys. Prints, per variant, the
registers, local (spill) bytes and resident blocks per SM that CUDA reports,
ptxas's line, and the kernel's ms at 10,240, 20,480 and 81,920 signatures
(CUDA events, mean of 10 after a warm-up), beside the card's name and power
limit. Needs a CUDA card and nvcc.

    python3 tools/ed25519_launch_sweep.py
"""

import os
import re
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from tendermint_tpu_torch.ops import ed25519_cuda as cu  # noqa: E402

# (THREADS, MIN_BLOCKS); the kernel ships with (128, 3).
VARIANTS = [(128, 4), (128, 5), (128, 3), (64, 8), (64, 10), (256, 2), (128, 1)]
SIZES = (10_240, 20_480, 81_920)
N_KEYS = 10_240


def _start_build(threads, min_blocks, root):
    d = tempfile.mkdtemp(dir=root)
    for name in cu.SOURCES:
        shutil.copy(os.path.join(cu.CSRC, name), d)
    path = os.path.join(d, "ed25519_verify.cu")
    with open(path) as f:
        src = f.read()
    src = re.sub(r"#define THREADS \d+", f"#define THREADS {threads}", src)
    src = re.sub(r"#define MIN_BLOCKS \d+", f"#define MIN_BLOCKS {min_blocks}", src)
    with open(path, "w") as f:
        f.write(src)
    so = os.path.join(d, "lib.so")
    proc = subprocess.Popen([cu._nvcc(), *cu.NVCC_FLAGS, "-o", so, path],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, so


def _time(lib, tab, tb, cols, m):
    dev = tab.device
    a = {k: v[..., :m].contiguous().to(dev) for k, v in cols.items()}
    ok = torch.empty((m,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.tm_ed25519_verify(
            tab.data_ptr(), tab.shape[0], a["key_idx"].data_ptr(), a["h64"].data_ptr(),
            a["s32"].data_ptr(), a["r32"].data_ptr(), a["valid"].data_ptr(),
            tb.data_ptr(), ok.data_ptr(), m, stream)
        if err:
            raise RuntimeError(f"launch: CUDA error {err}")

    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 10


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    root = tempfile.mkdtemp()
    try:
        builds = [(v, *_start_build(*v, root)) for v in VARIANTS]
        g = torch.Generator().manual_seed(5)
        n = max(SIZES)
        tab = torch.randint(0, 1 << 25, (N_KEYS, 16, 3, 10), generator=g,
                            dtype=torch.int32).to(dev)
        cols = dict(
            key_idx=torch.randint(0, N_KEYS, (n,), generator=g, dtype=torch.int32),
            h64=torch.randint(0, 256, (64, n), generator=g, dtype=torch.uint8),
            s32=torch.randint(0, 256, (32, n), generator=g, dtype=torch.uint8),
            r32=torch.randint(0, 256, (32, n), generator=g, dtype=torch.uint8),
            valid=torch.ones((n,), dtype=torch.uint8))
        tb = cu.tab_b10(dev)
        print(f"card: {torch.cuda.get_device_name(0)} | {smi}")
        for (threads, min_blocks), proc, so in builds:
            log = proc.communicate()[0]
            if proc.returncode:
                raise SystemExit(f"{threads}x{min_blocks}: nvcc failed\n{log}")
            ptxas = [ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln]
            lib = cu.bind(so)
            info = cu.kernel_info(lib)
            times = [_time(lib, tab, tb, cols, m) for m in SIZES]
            print(f"THREADS {threads} MIN_BLOCKS {min_blocks}: regs "
                  f"{info['registers']} local {info['local_bytes']} B blocks/SM "
                  f"{info['blocks_per_sm']} | "
                  + ", ".join(f"{m}: {t:.3f} ms" for m, t in zip(SIZES, times))
                  + " | " + " / ".join(ptxas), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
