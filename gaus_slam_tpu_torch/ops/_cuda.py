"""Build, load and launch the hand-written CUDA kernels (csrc/).

Each ``csrc/*.cu`` source is compiled by its own ``nvcc`` process into a
shared library with a plain C interface, all sources at once, at first
use, into ``build/torch_kernels/`` beside the package. A library's file
name carries a hash of its sources and flags, so an edited kernel is
never served from a stale build. The wrappers call the C functions
through ``ctypes`` with raw device pointers and PyTorch's current
stream; each C function returns ``cudaGetLastError()`` and the wrapper
raises if it is not 0.

``LAUNCHES`` counts kernel launches by name: a wrapper adds one where it
launches its kernel, and nowhere else. A loop program's iterations run
as many times as the card decides (slam/programs.py): their launches are
tallied on the card and folded into ``LAUNCHES`` where the counts are
read, by ``fold_launches`` (``clear_launches`` folds, then zeroes), never
on a step's path. With ``GAUS_LAUNCH_LOG`` set to a file path, a process
appends its counts to that file as one JSON line when it exits, so a
tool that runs the drivers in child processes (tools/quality_ab.py,
tools/test_spread.py) can sum their launches.
"""
from __future__ import annotations

import atexit
import collections
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"
SOURCES = ("raster_forward", "raster_backward", "gather", "bf16_probe",
           "graph_loop")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no FMA contraction: the backward's forward recompute must
    # reproduce the forward kernel's values bit for bit
    "-fmad=false", "-lineinfo", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

LAUNCHES: collections.Counter = collections.Counter()
LAUNCH_LOG_ENV = "GAUS_LAUNCH_LOG"
# device tallies of launches: objects whose fold() adds to LAUNCHES what
# ran since their last fold and returns False once nothing can run again;
# settle(), which never waits, True once that is so and all is folded
TALLIES: list = []


def fold_launches() -> collections.Counter:
    """``LAUNCHES`` with every device tally folded in (reads the card)."""
    TALLIES[:] = [t for t in TALLIES if t.fold()]
    return LAUNCHES


def clear_launches() -> None:
    """Every count to 0, the tallies' launches until now included."""
    fold_launches()
    LAUNCHES.clear()


def _log_launches(path: str) -> None:
    with open(path, "a") as f:
        f.write(json.dumps({"pid": os.getpid(),
                            "launches": dict(fold_launches())}) + "\n")


if os.environ.get(LAUNCH_LOG_ENV):
    atexit.register(_log_launches, os.environ[LAUNCH_LOG_ENV])

_LIBS: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "on a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every missing library, one nvcc per source, all started
    together. Returns {name: (library path, ptxas report)}; a library
    built before reports from the log kept beside it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    reports = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            log = out.with_suffix(".log")
            reports[name] = log.read_text() if log.exists() else ""
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: (_lib_path(n), reports[n]) for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
        return lib


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch "
                           f"(cudaError {rc})")


def require(t: torch.Tensor, dtype, what: str) -> None:
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous CUDA {dtype} "
                         f"tensor, got {t.dtype} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")
