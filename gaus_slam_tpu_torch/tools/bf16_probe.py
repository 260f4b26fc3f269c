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
"""
from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from ..ops.bf16_probe import CHAIN_LEN, SHAPE, probe


def clock(x: torch.Tensor, chain: str, n: int, iters: int = 50) -> float:
    """Seconds per launch: ``iters`` launches captured in one CUDA graph
    (a launch takes tens of microseconds, about the wrapper's own host
    time, which the graph keeps out), replayed between CUDA events."""
    probe(x, chain, n)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            probe(x, chain, n)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("bf16_probe: no CUDA device", file=sys.stderr)
        return 2
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
