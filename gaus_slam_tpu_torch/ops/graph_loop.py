"""The tracking loop's ``lax.while_loop`` as one CUDA graph, and the
gradient reduction's ``lax.cond`` as an IF node inside a captured step
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

``cond`` is the port's ``lax.cond`` (gaus_slam_tpu/ops/binning.py:120):
inside an owner's capture on a card (slam/programs.py sets its
``CondScope`` for the capturing stream) it adds the kernel ``if_cond``
and an IF node with an else body to the graph under capture, each branch
captured into its body from a second stream into a graph pool of the
branches' own, so a replay runs the branch the device flag picks and
only it. Elsewhere (the CPU, ``programs.eager()``, a program's eager
warm-up, an uncaptured step) it runs both branches and ``torch.where``s
on the flag: no host read. ``if_cond_plain`` says which branch runs.
Each node tallies its branches on the card (two int64 slots); the
branches' kernel launches are taken out of the capture's counts and
folded from the tally (``_cuda.fold_launches``).
``LAUNCHES["if_cond"]`` counts the IF nodes' condition kernels.
"""
from __future__ import annotations

import collections
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
    "graph_cond_add": [_VP, _VP, _VP, ctypes.POINTER(_VP)],
    "graph_cond_body_begin": [_VP, _VP],
    "graph_cond_body_end": [_VP],
    "graph_cond_stream": [_INT, ctypes.POINTER(_VP)],
}


def while_cond_plain(iters: torch.Tensor, live: torch.Tensor, kmax: int,
                     early: bool) -> torch.Tensor:
    """The JAX ``cond_until``: ``iters < kmax`` and, with the early exit
    on, ``live`` (a 0-d bool tensor)."""
    go = iters < kmax
    return go & live if early else go


def if_cond_plain(flag: torch.Tensor) -> torch.Tensor:
    """The branch ``if_cond`` picks for a 0-d bool ``flag``: 0 (the then
    branch) where it holds, 1 (the else branch) where not; the tally slot
    it adds one to."""
    return torch.where(flag, 0, 1)


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


# ---------------------------------------------------------------------------
# lax.cond inside a capture


class CondScope:
    """What ``cond`` needs inside an owner's capture on a card: the branch
    graphs' pool (a ``torch.cuda.MemPool`` of the stream kind's, kept for
    the process) and the stream their bodies are captured from; the IF
    nodes built so far as (tally, [the then branch's launches, the else
    branch's]), the tally an int64 [2] outside the capture's pool that
    the owner zeroes once the capture has ended."""

    def __init__(self, pool, body_stream):
        self.pool, self.body_stream = pool, body_stream
        self.conds: list = []


_BODY_STREAMS: dict = {}   # device index -> body_stream(device)


def body_stream(device: torch.device) -> torch.cuda.ExternalStream:
    """The stream IF node bodies are captured from on ``device``: one of
    its own, made once (``torch.cuda.Stream`` hands out PyTorch's pool of
    streams round robin, and an owner may be capturing on the one it would
    give), with ``if_cond`` loaded (outside any capture)."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    side = _BODY_STREAMS.get(index)
    if side is None:
        raw = _VP()
        with torch.cuda.device(index):
            _check(_lib().graph_cond_stream(index, ctypes.byref(raw)),
                   "making the IF node bodies' stream")
        side = _BODY_STREAMS[index] = torch.cuda.ExternalStream(
            raw.value, device=torch.device("cuda", index))
    return side


# the capturing stream (its cuda_stream) -> its CondScope; set by
# slam/programs.py around each capture, read where cond runs (on a card
# the autograd engine's device thread runs the reduction, on the
# capturing stream)
SCOPES: dict = {}


def cond(pred: torch.Tensor, then_fn, else_fn,
         out: torch.Tensor) -> torch.Tensor:
    """``lax.cond(pred, then, else)`` into ``out``: each ``fn(o)`` writes
    its branch's result into ``o`` (laid out as ``out``) and returns it.

    Inside an owner's capture on a card: ``if_cond`` on ``pred`` (a 0-d
    bool on the card) and an IF node after it; each branch is captured
    into its body on the scope's stream, writing into ``out`` (allocated
    before the call, on the capturing stream), its temporaries in the
    branches' pool; nothing after the node may read a tensor that only
    one branch made. A node that cannot be built raises. Elsewhere both
    branches run and ``torch.where(pred, ...)`` picks one, bit for bit."""
    if not (pred.is_cuda and torch.cuda.is_current_stream_capturing()):
        a = then_fn(torch.empty_like(out))
        b = else_fn(torch.empty_like(out))
        return torch.where(pred, a, b, out=out)
    stream = torch.cuda.current_stream(pred.device)
    scope = SCOPES.get(stream.cuda_stream)
    if scope is None:
        raise RuntimeError("cond: a capture on a stream with no CondScope: "
                           "an IF node is built only inside an owner's "
                           "capture (slam/programs.py)")
    _cuda.require(pred, torch.bool, "if_cond flag")
    lib = _lib()
    side = scope.body_stream
    # the tally outlives the replays: not from the capture's pool, whose
    # blocks the graph's earlier temporaries rewrite on every replay, but
    # an ordinary block (taken on the body stream, which is not capturing
    # yet); the owner zeroes it once the capture has ended
    with torch.cuda.stream(side):
        tally = torch.empty(2, dtype=torch.int64, device=pred.device)
    bodies = (_VP * 2)()
    _check(lib.graph_cond_add(_VP(stream.cuda_stream), _cuda.ptr(pred),
                              _cuda.ptr(tally), bodies), "adding an IF node")
    _cuda.LAUNCHES["if_cond"] += 1
    counts = []
    for fn, body in zip((then_fn, else_fn), bodies):
        before = collections.Counter(_cuda.LAUNCHES)
        _check(lib.graph_cond_body_begin(_VP(side.cuda_stream), body),
               "beginning a branch's capture")
        try:
            with torch.cuda.stream(side), torch.cuda.use_mem_pool(
                    scope.pool, pred.device):
                fn(out)
        except BaseException:
            lib.graph_cond_body_end(_VP(side.cuda_stream))
            raise
        _check(lib.graph_cond_body_end(_VP(side.cuda_stream)),
               "ending a branch's capture")
        # the branch's launches run only where it is taken: out of the
        # capture's counts, into the node's tally's
        c = collections.Counter(_cuda.LAUNCHES)
        c.subtract(before)
        c = +c
        for k, v in c.items():
            _cuda.LAUNCHES[k] -= v
            if _cuda.LAUNCHES[k] == 0:
                del _cuda.LAUNCHES[k]
        counts.append(c)
    scope.conds.append((tally, counts))
    return out
