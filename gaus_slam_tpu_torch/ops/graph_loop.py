"""The tracking loop's ``lax.while_loop`` as one CUDA graph
(csrc/graph_loop.cu).

The JAX package compiles ``tracking_loop``'s two while_loops into one XLA
program whose cond (``cond_until``, gaus_slam_tpu/slam/steps.py:129-135)
runs on the device. Here ``LoopGraph`` assembles a graph of CUDA graph
conditional WHILE nodes, one per level, each with a level's captured
iteration graph as its body, and a tail after them; the kernel
``while_cond`` sets each level's condition on the card, before the level
and after each of its iterations. ``while_cond_plain`` computes the same
boolean as a tensor: the CPU path's host while tests it, and nothing on
the card's path does.

``LAUNCHES["while_cond"]`` counts the condition's launches: the entry
node of every level at each launch here, and one per iteration through
the loop program's device tally (slam/programs.py).
"""
from __future__ import annotations

import ctypes
import sys

import torch

from . import _cuda

# cudaGraphNodeType
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
              5: "empty", 6: "wait_event", 7: "event_record",
              8: "ext_semaphore_signal", 9: "ext_semaphore_wait",
              10: "mem_alloc", 11: "mem_free", 12: "batch_memop",
              13: "conditional"}
# what a conditional node's body may hold (CUDA programming guide, "CUDA
# Graphs", conditional node body graph requirements)
BODY_TYPES = frozenset(("kernel", "memcpy", "memset", "graph", "empty",
                        "conditional"))

_VP, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "graph_loop_create": [_INT, ctypes.POINTER(_VP)],
    "graph_loop_add_level": [_VP, ctypes.POINTER(_VP), _VP, _VP, _VP, _INT,
                             _INT, _VP],
    "graph_loop_add_child": [_VP, ctypes.POINTER(_VP), _VP],
    "graph_loop_instantiate": [_VP, ctypes.POINTER(_VP),
                               ctypes.POINTER(_INT)],
    "graph_loop_launch": [_VP, _VP],
    "graph_loop_destroy": [_VP, _VP],
    "graph_loop_node_types": [_VP, ctypes.POINTER(_INT), ctypes.c_size_t,
                              ctypes.POINTER(ctypes.c_size_t)],
}


def while_cond_plain(iters: torch.Tensor, live: torch.Tensor, kmax: int,
                     early: bool) -> torch.Tensor:
    """The JAX ``cond_until``: ``iters < kmax`` and, with the early exit
    on, ``live`` (a 0-d bool tensor)."""
    go = iters < kmax
    return go & live if early else go


def _lib() -> ctypes.CDLL:
    lib = _cuda.library("graph_loop")
    if not getattr(lib, "_typed", False):
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, _INT
        lib.graph_loop_error_string.argtypes = [_INT]
        lib.graph_loop_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().graph_loop_error_string(rc).decode()
        raise RuntimeError(f"graph_loop: {what} failed (cudaError {rc}: "
                           f"{msg})")


def node_types(graph: int) -> list:
    """The type names of a raw ``cudaGraph_t``'s nodes (top level)."""
    n = ctypes.c_size_t(0)
    _check(_lib().graph_loop_node_types(_VP(graph), None, 0,
                                        ctypes.byref(n)), "cudaGraphGetNodes")
    types = (_INT * max(n.value, 1))()
    _check(_lib().graph_loop_node_types(_VP(graph), types, n.value,
                                        ctypes.byref(n)), "cudaGraphGetNodes")
    return [NODE_TYPES.get(types[i], str(types[i])) for i in range(n.value)]


class LoopGraph:
    """A graph of WHILE levels and child graphs, assembled in order, then
    instantiated once. The raw graphs a level or child is made from are
    cloned into it; the memory their nodes address must outlive it."""

    def __init__(self, device: torch.device):
        device = torch.device(device)
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        self.device = torch.device("cuda", index)
        self.graph, self.exec = _VP(), _VP()
        self._last = _VP()
        self.levels = 0
        _check(_lib().graph_loop_create(index, ctypes.byref(self.graph)),
               "cudaGraphCreate")

    def add_level(self, body: int, iters: torch.Tensor, live: torch.Tensor,
                  kmax: int, early: bool, tally: torch.Tensor) -> None:
        """A while_loop: ``body`` (a raw cudaGraph_t) runs while
        ``while_cond_plain(iters, live, kmax, early)`` holds, tested on
        entry and after each run; each run adds one to ``tally`` (int64)."""
        _cuda.require(iters, torch.int32, "while_cond iters")
        _cuda.require(live, torch.bool, "while_cond live")
        _cuda.require(tally, torch.int64, "while_cond tally")
        _check(_lib().graph_loop_add_level(
            self.graph, ctypes.byref(self._last), _VP(body), _cuda.ptr(iters),
            _cuda.ptr(live), int(kmax), int(bool(early)), _cuda.ptr(tally)),
            "adding a WHILE level")
        self.levels += 1

    def add_child(self, child: int) -> None:
        _check(_lib().graph_loop_add_child(self.graph, ctypes.byref(
            self._last), _VP(child)), "adding a child graph")

    def instantiate(self) -> None:
        result = _INT(0)
        rc = _lib().graph_loop_instantiate(self.graph, ctypes.byref(
            self.exec), ctypes.byref(result))
        if rc != 0:
            _check(rc, f"cudaGraphInstantiate (cudaGraphInstantiateResult "
                       f"{result.value})")

    def launch(self) -> None:
        """One launch on PyTorch's current stream."""
        _cuda.LAUNCHES["while_cond"] += self.levels
        _check(_lib().graph_loop_launch(self.exec, _cuda.stream()),
               "cudaGraphLaunch")

    def close(self) -> None:
        if self.graph or self.exec:
            graph, exec_ = self.graph, self.exec
            self.graph, self.exec = _VP(), _VP()
            _check(_lib().graph_loop_destroy(graph, exec_),
                   "destroying the loop graph")

    def __del__(self, _finalizing=sys.is_finalizing):
        # at interpreter exit the runtime may be gone before the graph
        if not _finalizing():
            self.close()
