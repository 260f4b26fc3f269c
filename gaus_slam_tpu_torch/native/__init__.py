"""Native (C++) host code of the port, built with g++ at first use.

``tsdf_fusion.cpp`` is the port's own copy of the JAX package's TSDF
volume (the same source, so both packages fuse and extract the same
mesh). It is compiled into ``build/torch_native/`` beside the package,
never into the package tree, under a file name that carries a hash of
the source and the flags, so an edited source is never served from a
stale build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent.parent / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_LIB = None
_LOCK = threading.Lock()


def _build_lib(name: str) -> Path:
    src = _DIR / f"{name}.cpp"
    h = hashlib.sha1(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    out = BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(src)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed for {src.name}:\n{r.stderr}")
    os.replace(tmp, out)
    return out


def load_tsdf_lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(_build_lib("tsdf_fusion")))
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.tsdf_create.restype = ctypes.c_void_p
        lib.tsdf_create.argtypes = [ctypes.c_float, ctypes.c_float]
        lib.tsdf_destroy.argtypes = [ctypes.c_void_p]
        lib.tsdf_num_blocks.restype = ctypes.c_int64
        lib.tsdf_num_blocks.argtypes = [ctypes.c_void_p]
        lib.tsdf_integrate.argtypes = [
            ctypes.c_void_p, f32p, f32p, ctypes.c_int, ctypes.c_int,
            f32p, f32p, ctypes.c_float,
        ]
        lib.tsdf_extract_mesh.restype = ctypes.c_void_p
        lib.tsdf_extract_mesh.argtypes = [ctypes.c_void_p, ctypes.c_float]
        lib.mesh_num_vertices.restype = ctypes.c_int64
        lib.mesh_num_vertices.argtypes = [ctypes.c_void_p]
        lib.mesh_num_triangles.restype = ctypes.c_int64
        lib.mesh_num_triangles.argtypes = [ctypes.c_void_p]
        lib.mesh_copy.argtypes = [ctypes.c_void_p, f32p, i32p]
        lib.mesh_destroy.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib
