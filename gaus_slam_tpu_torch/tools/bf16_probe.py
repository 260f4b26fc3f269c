"""Measure elementwise throughput, f32 against bf16, on the CUDA card
(port of tools/bf16_probe.py).

Three dependent chains per dtype over a [4096, 512] array, through K6
(csrc/bf16_probe.cu): fma (64 multiply-adds), exp (8 exp), mixed (32
multiply-adds with an exp and a select after every 8th). Prints the
card, then for each chain and dtype the time of one launch (50 launches
in a CUDA graph, between CUDA events) and the chain steps per second, then
the bf16/f32 ratio per chain, as the JAX tool does, and last the card's
name and power limit as nvidia-smi reports them.

    python -m gaus_slam_tpu_torch.tools.bf16_probe

With ``--old <csrc dir>`` it instead times K6 against the bf16_probe.cu of
an older csrc/ (one thread per vector, its 7-argument C interface), built
with the same nvcc flags into build/torch_kernels/ab/: per (chain,
dtype) case, the old kernel and the current one at 1, 2 and 4 vectors per
thread and sized to the card (vpt 0), rounds interleaved (forward, then
reverse order), the median over the rounds of a 50-launch CUDA graph,
beside torch's copy of the same array (the bytes moved, no chain);
every variant's output must equal the old kernel's bit for bit. The last
line is a JSON summary.

    git archive <rev> gaus_slam_tpu_torch/csrc | tar -x -C build/old
    python -m gaus_slam_tpu_torch.tools.bf16_probe \
        --old build/old/gaus_slam_tpu_torch/csrc
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops.bf16_probe import CHAIN_LEN, SHAPE, probe


def clock(x: torch.Tensor, chain: str, n: int, iters: int = 50,
          fn=None) -> float:
    """Seconds per launch: ``iters`` launches captured in one CUDA graph
    (a launch takes tens of microseconds, about the wrapper's own host
    time, which the graph keeps out), replayed between CUDA events.
    ``fn()`` launches instead of ``probe(x, chain, n)`` when given."""
    fn = fn or (lambda: probe(x, chain, n))
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters / 1e3


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return (r.stdout.strip().splitlines()[0] if r.returncode == 0
            else f"nvidia-smi failed: {r.stderr.strip()}")


def _old_library(csrc: Path) -> ctypes.CDLL:
    from ..ops import _cuda

    out = _cuda.BUILD_DIR / "ab"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libbf16_probe_old.so"
    r = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(lib),
                        str(csrc / "bf16_probe.cu")], capture_output=True,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for the old bf16_probe.cu:\n"
                           f"{r.stdout}{r.stderr}")
    fn = ctypes.CDLL(str(lib)).bf16_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ab(old_csrc: str, rounds: int = 12) -> int:
    """K6 against an older build, per case; 0 when every variant is
    bit-equal to the old kernel."""
    from ..ops import _cuda
    from ..ops.bf16_probe import CHAINS

    old = _old_library(Path(old_csrc))
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}")
    base = torch.as_tensor(np.random.default_rng(0).uniform(
        0.5, 1.5, SHAPE).astype(np.float32), device=dev)
    variants = ("old", "vpt0", "vpt1", "vpt2", "vpt4")
    summary, ok = {}, True
    for chain, n in CHAIN_LEN.items():
        for dtype in (torch.float32, torch.bfloat16):
            name = f"{chain} {str(dtype).split('.')[-1]}"
            x = base.to(dtype)
            outs = {}

            def launcher(v, x=x, chain=chain, n=n, dtype=dtype):
                if v == "old":
                    out = outs.setdefault(v, torch.empty_like(x))
                    return lambda: _cuda.check(old(
                        _cuda.ptr(x), _cuda.ptr(out), x.numel(),
                        CHAINS[chain], n, int(dtype == torch.bfloat16),
                        _cuda.stream()), "old bf16_probe")
                return lambda: probe(x, chain, n, vpt=int(v[3:]))

            launcher("old")()
            for v in variants[1:]:
                outs[v] = launcher(v)()
            torch.cuda.synchronize()
            for v in variants[1:]:
                same = torch.equal(outs[v], outs["old"])
                ok &= same
                if not same:
                    print(f"{name}: {v} differs from the old kernel")
            # torch's copy of x: the same bytes moved, no chain
            copy_out = torch.empty_like(x)
            timed = variants + ("copy",)
            times = {v: [] for v in timed}
            for r in range(rounds):
                for v in (timed if r % 2 == 0 else timed[::-1]):
                    fn = (lambda: copy_out.copy_(x)) if v == "copy" \
                        else launcher(v)
                    times[v].append(clock(x, chain, n, fn=fn) * 1e3)
            med = {v: float(np.median(t)) for v, t in times.items()}
            summary[name] = med
            print(f"{name:15s} " + "  ".join(
                f"{v} {ms * 1e3:7.2f} us" for v, ms in med.items()))
    print(card_line())
    print(json.dumps({"k6_ab_ms": summary, "bit_equal": bool(ok)}))
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", default=None,
                    help="an older csrc/ directory to time K6 against")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bf16_probe: no CUDA device", file=sys.stderr)
        return 2
    if args.old:
        return ab(args.old)
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}")
    base = torch.as_tensor(np.random.default_rng(0).uniform(
        0.5, 1.5, SHAPE).astype(np.float32), device=dev)
    rate = {}
    for chain, n in CHAIN_LEN.items():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            t = clock(base.to(dtype), chain, n)
            rate[(chain, name)] = base.numel() * n / t / 1e9
            print(f"{chain:6s} {name:9s} {t * 1e6:8.1f} us "
                  f"{rate[(chain, name)]:8.1f} Gop/s")
    for chain in CHAIN_LEN:
        r = rate[(chain, "bfloat16")] / rate[(chain, "float32")]
        print(f"bf16/f32 speedup [{chain}]: {r:.2f}x")
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
