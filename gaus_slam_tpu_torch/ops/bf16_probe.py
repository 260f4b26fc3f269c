"""The f32 vs bf16 elementwise-rate probe — K6 (port of the Pallas
kernel tools/bf16_probe.py::build).

Three dependent chains per element, each with its constants in the
array's dtype (float32 or bfloat16), as the JAX kernel bodies write them:

  fma    n times  x = x * 1.0001 + 1e-4
  exp    n times  x = exp(x * -0.5) + 1
  mixed  n times  x = x * 1.0001 + 1e-4, and after every 8th step
                  x = exp(x * -0.25); x = where(x > 0.7, x * 1.0001, x)

``probe_plain`` is the chain in PyTorch, rounding to the dtype after
every operation; ``probe`` launches csrc/bf16_probe.cu on a CUDA tensor
(16-byte vectors, packed bf16 pairs, one or more vectors per thread with
the grid sized to the card) and runs the plain version on a CPU tensor.
The kernel's f32 FMA rounds once where the plain version rounds after
the multiply and after the add.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda

CHAINS = {"fma": 0, "exp": 1, "mixed": 2}
# the probe's shape and chain lengths (tools/bf16_probe.py)
SHAPE = (4096, 512)
CHAIN_LEN = {"fma": 64, "exp": 8, "mixed": 32}


def probe_plain(x: torch.Tensor, chain: str, n: int) -> torch.Tensor:
    dt, dev = x.dtype, x.device

    def c(v):
        # a 0-d tensor of the dtype: a python float would enter the
        # operation in float32 without being rounded to bf16 first
        return torch.tensor(v, dtype=dt, device=dev)

    a, b = c(1.0001), c(1e-4)
    if chain == "fma":
        for _ in range(n):
            x = x * a + b
    elif chain == "exp":
        h, one = c(-0.5), c(1.0)
        for _ in range(n):
            x = torch.exp(x * h) + one
    elif chain == "mixed":
        q, th = c(-0.25), c(0.7)
        for i in range(n):
            x = x * a + b
            if i % 8 == 7:
                x = torch.exp(x * q)
                x = torch.where(x > th, x * a, x)
    else:
        raise ValueError(f"unknown chain {chain!r}; one of {tuple(CHAINS)}")
    return x


def probe(x: torch.Tensor, chain: str, n: int, vpt: int = 0) -> torch.Tensor:
    """The chain over every element of ``x`` (float32 or bfloat16).
    ``vpt``: 16-byte vectors per thread of the kernel, 1, 2 or 4, or 0 to
    size the grid to the card (the same bits for every choice)."""
    if not x.is_cuda:
        return probe_plain(x, chain, n)
    if chain not in CHAINS:
        raise ValueError(f"unknown chain {chain!r}; one of {tuple(CHAINS)}")
    if vpt not in (0, 1, 2, 4):
        raise ValueError(f"bf16_probe: vpt {vpt}; one of 0, 1, 2, 4")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"bf16_probe: float32 or bfloat16, got {x.dtype}")
    _cuda.require(x, x.dtype, "bf16_probe x")
    per_vec = 16 // x.element_size()
    if x.numel() % per_vec or x.data_ptr() % 16:
        raise ValueError(f"bf16_probe: {x.numel()} elements at 0x"
                         f"{x.data_ptr():x}; the kernel takes a multiple of "
                         f"{per_vec} elements, 16-byte aligned")
    out = torch.empty_like(x)
    fn = _cuda.library("bf16_probe").bf16_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _cuda.LAUNCHES["bf16_probe"] += 1
    _cuda.check(fn(_cuda.ptr(x), _cuda.ptr(out), x.numel(), CHAINS[chain], n,
                   int(x.dtype == torch.bfloat16), vpt, _cuda.stream()),
                "bf16_probe")
    return out
