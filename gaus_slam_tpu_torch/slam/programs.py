"""Captured steps: the port's counterpart of ``jax.jit``.

The JAX package runs each step as one compiled device program (a jitted
``mapping_step``, a ``lax.scan`` of mapping iterations, a ``while_loop``
of tracking iterations). Here a step is captured once per key as a CUDA
graph and replayed, one launch for the whole step. The key is what jit
keys its cache on: the function, its static arguments (``opts``,
``tcfg``, ``lcfg``, ``mcfg`` and the like, as JAX's ``static_argnames``
name them) and the shapes of its tensors, which here means the map's
capacity bucket and the pair cache's rows; besides, the owner.

An ``Owner`` (the frontend, the backend, or the default owner of a
device for any other caller) holds its programs, the static buffers
they read and write, and on a card a capture stream. The programs that
replay on a device's default stream share one graph memory pool, and
those that replay on another stream (a backend's own) another: every
result is copied into an owner's buffers, so a graph's temporaries are
free again once it has run, and the graphs of one stream run one at a
time. The frontend and a backend on a stream of its own run at the same
time and never share a pool.

A call binds each tensor argument to the owner's buffer of the same
name, shape and layout (strides, storage offset, and which arguments
share a storage: the eager step's kernels see the same layout, so the
program computes its bits), copying it in unless the buffer already
holds it (the same storage, or the same tensor at the same version as
the last copy). The program writes every result into buffers of the
owner, laid out as the eager result, and the returned values are those
buffers:

  * ``gm``, the map, is written back into the buffers it was read from
    where the result's layout is the argument's (an Adam step's map
    after an Adam step's map): a map that lives there is stepped in
    place and the next call copies nothing. Anything that holds a map
    across a step holds a copy (``gaussians.extract_params`` makes one
    for the submap cut).
  * the other results are valid until the owner's next call of the same
    program; a caller that keeps one across calls copies it. The
    default owner returns copies of every result, as a jitted function
    returns fresh arrays.

On a card the first call of a key runs the step once on the caller's
stream (the warm-up that capture needs: constant tables filled, the
autograd engine and cuBLAS set up; its results are the call's), then
captures the same body on the owner's capture stream. Later calls replay
the graph on the caller's stream and add, to ``ops._cuda.LAUNCHES``, the
kernel launches the capture recorded. A capture or replay that fails
raises an error naming its key; nothing falls back to eager execution.
On the CPU the same static-buffer body is built once per key and then
called with no arguments, so a host value that a capture would bake is
baked there too. When the map's capacity changes, the owner's programs
and buffers are dropped (freed once the owner's queued work is done). ``eager()`` runs every step as a plain call, the port's
``jax.disable_jit``. A program called inside another program's body
runs inline, as a jitted function called under ``jax.jit`` is traced
into the caller's program.

One more way of binding: an argument named in ``borrow`` whose tensors
lie in a buffer of some owner (another program's results, a map stepped
in place) is read where it lies, its address part of the key, so that
a program reading the results of another copies nothing.

``while_loop`` is the port's ``lax.while_loop``: levels of iterations,
each run while a device condition holds, and a tail, as one program.
Each iteration writes its carry back into the buffers it read, so one
captured iteration graph replayed is the loop's carry; on a card the
levels become CUDA graph conditional WHILE nodes (ops/graph_loop.py) and
one launch runs them all, the card deciding when each level stops. The
iterations' kernel launches are tallied on the card and folded into
``ops._cuda.LAUNCHES`` where the counts are read (``_cuda.fold_launches``).

``ops/graph_loop.py::cond`` is the port's ``lax.cond``: inside an
owner's capture on a card (``Owner._capture`` sets the capturing stream's
``CondScope``) it builds an IF node whose branch the card picks, each
branch's temporaries in a graph pool of the branches' own (one per
device and stream kind, beside ``_POOLS``); the nodes' branch tallies
fold into ``LAUNCHES`` as the loop programs' do (a loop program's body
holds no IF node). Every capture lists its graph's node types
(``_Program.types``) before instantiating it. On the CPU, under
``eager()`` and in a key's eager warm-up call ``cond`` runs both
branches and ``torch.where``s on the flag.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import weakref

import torch

from ..ops import _cuda
from ..ops.camera import Camera
from ..ops import graph_loop
from ..ops.graph_loop import (CondScope, LoopGraph, node_types,
                              while_cond_plain)

# replays by program name, and captures, since the process started
GRAPH_LAUNCHES: collections.Counter = collections.Counter()
CAPTURES: collections.Counter = collections.Counter()

_EAGER = [0]
_INSIDE = [0]         # program bodies running: a nested call runs inline
_DEFAULT: dict = {}
_POOLS: dict = {}     # (device, on the default stream) -> _pool(...)
# (device, on the default stream) -> the IF nodes' branches' MemPool
_BRANCH_POOLS: dict = {}
_OWNERS: "weakref.WeakSet" = weakref.WeakSet()


@contextlib.contextmanager
def eager():
    """Within: every step runs as a plain call of its eager body."""
    _EAGER[0] += 1
    try:
        yield
    finally:
        _EAGER[0] -= 1


def is_eager() -> bool:
    return _EAGER[0] > 0


def _owned(t: torch.Tensor) -> bool:
    """Whether ``t`` lies in a buffer of some owner (a graph may write it
    without a version bump)."""
    ptr = t.untyped_storage().data_ptr()
    return any(ptr in o._storages for o in _OWNERS)


# ---------------------------------------------------------------------------
# argument trees: tensors are leaves, python values are static


def _flatten(x, path: str, leaves: list):
    """Spec of ``x`` (hashable; python values in it); its tensors are
    appended to ``leaves`` as (path, tensor)."""
    if isinstance(x, torch.Tensor):
        leaves.append((path, x))
        return ("T",)
    if isinstance(x, Camera):
        return ("C", (x.height, x.width, x.fx, x.fy, x.cx, x.cy, x.near,
                      x.far), _flatten(x.w2c, path + ".w2c", leaves))
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return ("N", type(x), tuple(_flatten(getattr(x, f), f"{path}.{f}",
                                             leaves) for f in x._fields))
    if isinstance(x, (tuple, list)):
        return ("L", type(x), tuple(_flatten(v, f"{path}.{i}", leaves)
                                    for i, v in enumerate(x)))
    if isinstance(x, dict):
        keys = tuple(sorted(x))
        return ("D", keys, tuple(_flatten(x[k], f"{path}.{k}", leaves)
                                 for k in keys))
    if x is None or isinstance(x, (bool, int, float, str)):
        return ("S", x)
    raise TypeError(f"programs: cannot pass a {type(x).__name__} at {path}")


def _unflatten(spec, it):
    tag = spec[0]
    if tag == "T":
        return next(it)
    if tag == "S":
        return spec[1]
    if tag == "C":
        h, w, fx, fy, cx, cy, near, far = spec[1]
        return Camera(h, w, fx, fy, cx, cy, _unflatten(spec[2], it), near,
                      far)
    if tag == "N":
        return spec[1](*(_unflatten(s, it) for s in spec[2]))
    if tag == "L":
        return spec[1](_unflatten(s, it) for s in spec[2])
    return dict(zip(spec[1], (_unflatten(s, it) for s in spec[2])))


def _static_values(spec) -> list:
    """The python numbers among a result's leaves (a graph would bake
    them)."""
    tag = spec[0]
    if tag == "S":
        return [] if spec[1] is None else [spec[1]]
    if tag in ("N", "L", "D"):
        return [v for s in spec[2] for v in _static_values(s)]
    return []


def _clone(tree):
    leaves: list = []
    spec = _flatten(tree, "", leaves)
    return _unflatten(spec, iter([t.clone() for _, t in leaves]))


def _fresh(tree):
    """The same tensors in new containers (a caller may edit a dict)."""
    leaves: list = []
    spec = _flatten(tree, "", leaves)
    return _unflatten(spec, iter([t for _, t in leaves]))


# ---------------------------------------------------------------------------


class _Program:
    """One captured step: the graph (None on the CPU), its body, its
    results (owner buffers) and the kernel launches one run makes."""

    def __init__(self, name, key, body):
        self.name, self.key, self.body = name, key, body
        self.graph = None
        self.out = None
        self.launches: collections.Counter = collections.Counter()
        self.tally = None   # the IF nodes' branches, counted on the card
        self.types = None   # the graph's node types, read at its capture


class Owner:
    """The programs, static buffers and (on a card) capture stream of one
    caller (its graphs go into the pool of the stream it calls them on:
    ``_pool``). ``alias=False`` (the
    default owner) hands out copies of every result. ``device``: where
    the programs run, when not where their arguments lie (a shard of the
    sharded BA step on another card: its arguments are copied there)."""

    def __init__(self, name: str, alias: bool = True, device=None):
        self.name, self.alias = name, alias
        self.device = None
        self.fixed = device is not None
        if self.fixed:
            self._check_device(torch.device(device))
        self.programs: dict = {}
        self.buffers: dict = {}
        self._source: dict = {}      # id(buffer) -> (weakref, version)
        self._storages: set = set()  # data_ptr of every buffer storage
        self.capacity = None
        self.stream = None
        self._retired: list = []
        self.resets = 0
        _OWNERS.add(self)

    # -- buffers -------------------------------------------------------
    def _check_device(self, dev: torch.device):
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if self.device is None:
            self.device = dev
        elif dev != self.device:
            raise RuntimeError(f"programs: owner {self.name} serves "
                               f"{self.device}, called with {dev}")

    def mirror(self, leaves: list) -> tuple:
        """The owner's buffers laid out as ``leaves`` ((path, tensor)
        pairs) are: the same shapes, strides and storage offsets, and the
        views into one storage (a map's fields in one block) sharing one
        (a PyTorch kernel may order a sum by the layout it finds, so a
        step computes the bits its eager run would only on the same
        layout). Returns (buffers, layout signature)."""
        groups: dict = {}
        for i, (_, t) in enumerate(leaves):
            st = t.untyped_storage()
            # a tensor that is its whole storage stands alone, also when it
            # is passed twice: one step's frames repeat at random
            whole = (t.storage_offset() == 0 and t.is_contiguous()
                     and t.numel() * t.element_size() == st.nbytes())
            groups.setdefault(("own", i) if whole or not st.nbytes()
                              else st.data_ptr(), []).append(i)
        bufs, sig = [None] * len(leaves), []
        for members in groups.values():
            desc = tuple((leaves[i][0], tuple(leaves[i][1].shape),
                          leaves[i][1].dtype, leaves[i][1].storage_offset(),
                          tuple(leaves[i][1].stride())) for i in members)
            key = ("mirror", desc,
                   leaves[members[0]][1].untyped_storage().nbytes())
            views = self.buffers.get(key)
            if views is None:
                if _capturing(self):
                    raise RuntimeError(f"programs: {desc[0][0]} has no "
                                       f"buffer at capture")
                raw = torch.empty(key[2], dtype=torch.uint8,
                                  device=self.device).untyped_storage()
                views = [torch.empty(0, dtype=dt, device=self.device).set_(
                    raw, off, shape, stride)
                    for _, shape, dt, off, stride in desc]
                self.buffers[key] = views
                self._storages.add(raw.data_ptr())
            for i, v in zip(members, views):
                bufs[i] = v
            sig.append(key)
        return bufs, tuple(sig)

    def bind(self, leaves: list, borrow: tuple = ()) -> tuple:
        """``mirror``'s buffers holding the leaves' values: each copied in
        unless its buffer already holds it (the same storage, or the same
        tensor at the same version as the last copy). A graph's replay
        writes its buffers without a version bump, so a tensor in a storage
        of an owner's is copied every time. A leaf under an argument named
        in ``borrow`` that lies in an owner's buffer on this device is not
        copied: the program reads it where it lies (its address, shape,
        strides and offset join the layout signature)."""
        kept, lent = [], {}
        for i, (path, t) in enumerate(leaves):
            if (borrow and path.split(".")[1] in borrow
                    and t.device == self.device and _owned(t)):
                lent[i] = t
            else:
                kept.append((path, t))
        bufs, sig = self.mirror(kept)
        for buf, (_, t) in zip(bufs, kept):
            if buf.data_ptr() == t.data_ptr():
                continue
            src = self._source.get(id(buf))
            if (src is not None and src[0]() is t and src[1] == t._version
                    and not _owned(t)):
                continue
            buf.copy_(t.detach())
            self._source[id(buf)] = (weakref.ref(t), t._version)
        if not lent:
            return bufs, sig
        it = iter(bufs)
        out = [lent[i] if i in lent else next(it) for i in range(len(leaves))]
        sig += tuple(("lent", leaves[i][0], t.data_ptr(), tuple(t.shape),
                      tuple(t.stride()), t.dtype) for i, t in lent.items())
        return out, sig

    def ring(self, n: int, device) -> "FlagRing":
        """The tracking loop's ring of n (live, iterations) slots, kept
        for the owner's lifetime (a graph writes it)."""
        self._check_device(torch.device(device))
        k = ("ring", n)
        r = self.buffers.get(k)
        if r is None:
            r = self.buffers[k] = FlagRing(n, self.device)
        return r

    # -- capacity ------------------------------------------------------
    def set_capacity(self, cap: int):
        """Drop every program and buffer when the map's capacity changes;
        on a card the old graphs are destroyed once the work queued before
        the change is done."""
        self._purge()
        if cap == self.capacity:
            return
        if self.capacity is not None and self.programs:
            ev = None
            if self.device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record()
            self._retired.append((ev, self.programs, self.buffers))
            self.resets += 1
        rings = {k: v for k, v in self.buffers.items() if k[0] == "ring"}
        self.programs, self.buffers, self._source = {}, rings, {}
        self._storages = set()
        self.capacity = cap

    def _purge(self):
        self._retired = [r for r in self._retired
                         if r[0] is not None and not r[0].query()]

    # -- running -------------------------------------------------------
    def _capture(self, fns, keep_graph: bool = False) -> list:
        """Each of ``fns`` (run before, on the caller's stream: the
        warm-up) captured on the owner's capture stream into the pool of
        the graphs replayed on the caller's stream. Returns [(graph, the
        fn's result, the kernel launches its capture recorded, its IF
        nodes' (tally, branch launches), the graph's node types)], those
        launches taken back out of ``LAUNCHES``: a capture launches
        nothing, its counts belong to the replays (a branch's to its
        node's tally). Each graph's nodes are listed before it is
        instantiated. ``keep_graph``: keep each raw graph
        (``CUDAGraph.raw_cuda_graph``), not instantiated."""
        if self.stream is None:
            self.stream = torch.cuda.Stream(device=self.device)
        cur = torch.cuda.current_stream(self.device)
        where = (self.device, cur == torch.cuda.default_stream(self.device))
        pool = _POOLS.get(where)
        if pool is None:
            pool = _POOLS[where] = _pool(self.device, self.stream)
        branch_pool = _BRANCH_POOLS.get(where)
        if branch_pool is None:
            branch_pool = _BRANCH_POOLS[where] = torch.cuda.MemPool()
        side = graph_loop.body_stream(self.device)
        s = self.stream
        s.wait_stream(cur)
        # a graph that Python's collector destroys during a capture (an
        # owner of a dropped Frontend, say) invalidates it: no collection
        # while capturing
        gc_was = gc.isenabled()
        gc.disable()
        out = []
        try:
            for fn in fns:
                before = collections.Counter(_cuda.LAUNCHES)
                graph = torch.cuda.CUDAGraph(keep_graph=True)
                scope = CondScope(branch_pool, side)
                with torch.cuda.device(self.device), torch.cuda.stream(s):
                    graph.capture_begin(pool=pool[0],
                                        capture_error_mode="thread_local")
                    _CAPTURING.add(id(self))
                    graph_loop.SCOPES[s.cuda_stream] = scope
                    try:
                        res = fn()
                    finally:
                        del graph_loop.SCOPES[s.cuda_stream]
                        _CAPTURING.discard(id(self))
                        graph.capture_end()
                    for tally, _ in scope.conds:
                        tally.zero_()
                    types = node_types(graph.raw_cuda_graph())
                    if not keep_graph:
                        graph.instantiate()
                counts = collections.Counter(_cuda.LAUNCHES)
                counts.subtract(before)
                counts = +counts
                for k, v in counts.items():
                    _cuda.LAUNCHES[k] -= v
                    if _cuda.LAUNCHES[k] == 0:
                        del _cuda.LAUNCHES[k]
                out.append((graph, res, counts, scope.conds, types))
        finally:
            if gc_was:
                gc.enable()
            cur.wait_stream(s)
        return out

    def _build(self, name, key, body, capture: bool) -> tuple:
        prog = _Program(name, key, body)
        # the warm-up: the call's real work, on the caller's stream
        out = body()
        if self.device.type != "cuda" or not capture:
            prog.out = out
            return prog, out
        try:
            [(prog.graph, prog.out, prog.launches, conds,
              prog.types)] = self._capture([body])
        except Exception as e:
            raise RuntimeError(f"programs: capture of {_describe(key)} failed "
                               f"(owner {self.name}): {e}") from e
        if conds:
            prog.tally = _Tally(prog, conds)
            _track(prog.tally)
        CAPTURES[name] += 1
        return prog, out

    def _replay(self, prog: _Program):
        if prog.graph is None:
            return prog.body()
        try:
            if prog.tally is not None:
                prog.tally.stream = torch.cuda.current_stream(self.device)
            prog.graph.replay()
        except Exception as e:
            raise RuntimeError(f"programs: replay of {_describe(prog.key)} "
                               f"failed (owner {self.name}): {e}") from e
        _cuda.LAUNCHES.update(prog.launches)
        GRAPH_LAUNCHES[prog.name] += 1
        return prog.out

    def _build_loop(self, prog: "_Loop") -> tuple:
        """A loop program's first call. On the CPU the host loop over its
        bodies (every call). On a card the warm-up that capture needs is
        the loop's first iteration, run eagerly on the caller's stream
        (its results are the loop's), and the tail once (``warm``); then
        each level's iteration and the tail are captured (``_capture``),
        assembled into one graph of WHILE nodes and instantiated, and its
        launch runs the rest of the loop from the carry the warm-up left.
        The other levels are captured without an iteration of their own:
        they differ from the first only in the tiles they render."""
        if self.device.type != "cuda":
            return prog.host_loop(check=True)
        prog.warm()
        fns = prog.bodies + ([prog.tail] if prog.tail else [])
        try:
            caps = self._capture(fns, keep_graph=True)
            prog.graphs = [c[0] for c in caps]
            if prog.tail:
                prog.out = (prog.out[0], caps[-1][1])
            for body in prog.bodies:
                prog.check_carry(body)
            if any(c[3] for c in caps):
                raise RuntimeError("an IF node in a loop program's body")
            prog.assemble([c[2] for c in caps])
        except Exception as e:
            raise RuntimeError(f"programs: the loop program "
                               f"{_describe(prog.key)} failed to capture or "
                               f"assemble (owner {self.name}): {e}") from e
        CAPTURES[prog.name] += 1
        return self._run_loop(prog)

    def _run_loop(self, prog: "_Loop"):
        if prog.loop is None:
            return prog.host_loop()
        try:
            prog.tally.stream = torch.cuda.current_stream(self.device)
            prog.loop.launch()
        except Exception as e:
            raise RuntimeError(f"programs: launch of the loop program "
                               f"{_describe(prog.key)} failed (owner "
                               f"{self.name}): {e}") from e
        _cuda.LAUNCHES.update(prog.launches)
        GRAPH_LAUNCHES[prog.name] += 1
        return prog.out


_CAPTURING: set = set()


def _pool(device, stream) -> tuple:
    """(a graph pool handle, a one-kernel graph captured into it, that
    graph's tensor), the capture on ``stream``: the pool of the programs
    that replay on a device's default stream, or of those that replay on
    another. A pool goes with the last graph captured into it, and its
    handle may not be captured into again (PyTorch 2.11 asserts): the
    keeper graph, kept as long as the process runs, holds it."""
    t = torch.zeros(1, device=device)
    keeper = torch.cuda.CUDAGraph()
    handle = torch.cuda.graph_pool_handle()
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.device(device), torch.cuda.stream(stream):
        keeper.capture_begin(pool=handle, capture_error_mode="thread_local")
        t.add_(1)
        keeper.capture_end()
    return handle, keeper, t


def _describe(key) -> str:
    """A program's key, short: its name, its static arguments and the
    shapes of its first tensors."""
    name, _, layout, static = key
    shapes = ", ".join(f"{d[0][0]}{list(d[0][1])}" for d in
                       (g[1] for g in layout[:4] if g[0] == "mirror"))
    return (f"{name}[{', '.join(f'{k}={v!r:.60}' for k, v in static)}; "
            f"{shapes}, ...]")


def _capturing(owner: Owner) -> bool:
    return id(owner) in _CAPTURING


class FlagRing:
    """n slots of (live, iterations) int32 the tracking loop's iterations
    copy their flags into (pinned memory on a card, with one event per
    slot recorded after the iteration is queued) and the host reads."""

    def __init__(self, n: int, device: torch.device):
        self.n = n
        self.cuda = device.type == "cuda"
        self.buf = torch.zeros((n, 2), dtype=torch.int32,
                               pin_memory=self.cuda)
        self.events = ([torch.cuda.Event() for _ in range(n)] if self.cuda
                       else None)

    def push(self, i: int, flags: torch.Tensor):
        """Inside an iteration: its flags into slot i."""
        self.buf[i].copy_(flags, non_blocking=self.cuda)

    def queued(self, i: int):
        """After an iteration that pushed into slot i was queued."""
        if self.cuda:
            self.events[i].record()

    def wait(self, i: int):
        if self.cuda:
            self.events[i].synchronize()


def default_owner(device) -> Owner:
    """The owner of the calls that name none, per device: it hands out
    copies of its results."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    own = _DEFAULT.get(dev)
    if own is None:
        own = _DEFAULT[dev] = Owner(f"default:{dev}", alias=False)
    return own


def resolve(owner: Owner | None, device) -> Owner:
    return owner if owner is not None else default_owner(device)


def call(owner: Owner | None, name: str, fn, args: dict, static: dict,
         outs, copies: tuple = (), capture: bool = True,
         capacity: int | None = None, borrow: tuple = ()):
    """``fn(**args, **static)`` as the owner's program for its key.

    ``args``: the traced arguments (tensors, and trees of them; python
    values inside are static); ``static``: hashable static arguments;
    ``outs``: a name for each result of ``fn`` (a tuple when there are
    several). A result named as an argument ("gm") is written back into
    that argument's buffers, a result named ".x" into the buffers of the
    argument x of the owner's other programs; the results named in
    ``copies`` are handed
    out as copies (state the caller keeps per frame or submap).
    ``capture=False`` keeps a body that reads the device (the reference
    render backend's plain compositor) out of a graph: on a card its
    static-buffer body runs as on the CPU. ``capacity``: the map capacity
    the program is made for, where no argument is named "gm" (a change
    drops the owner's programs, as a new map's does). ``borrow``: the
    arguments read where they lie when they lie in an owner's buffer
    (``Owner.bind``)."""
    if is_eager() or _INSIDE[0]:
        return fn(**args, **static)
    leaves: list = []
    spec = _flatten(args, "", leaves)
    own = resolve(owner, leaves[0][1].device)
    if not own.fixed:
        own._check_device(leaves[0][1].device)
    with (torch.cuda.device(own.device) if own.device.type == "cuda"
          else contextlib.nullcontext()):
        return _call(own, name, fn, args, static, outs, copies, capture,
                     capacity, borrow, spec, leaves)


def _call(own, name, fn, args, static, outs, copies, capture, capacity,
          borrow, spec, leaves):
    if capacity is None and "gm" in args:
        capacity = args["gm"].capacity
    if capacity is not None:
        own.set_capacity(capacity)
    bufs, layout = own.bind(leaves, borrow)
    key = (name, spec, layout, tuple(sorted(static.items())))
    prog = own.programs.get(key)
    if prog is None:
        body = _make_body(own, name, fn, _unflatten(spec, iter(bufs)),
                          static, outs)
        prog, out = own._build(name, key, body, capture)
        own.programs[key] = prog
    else:
        out = own._replay(prog)
    # the buffers a result was written to no longer hold what was copied
    # into them
    for buf in prog.body.written:
        own._source.pop(id(buf), None)
    if not own.alias:
        return _clone(out)
    if not isinstance(outs, tuple):
        return _clone(out) if outs in copies else _fresh(out)
    return tuple(_clone(o) if n in copies else _fresh(o)
                 for n, o in zip(outs, out))


def _make_body(own: Owner, name, fn, args, static, outs):
    """The static-buffer body of a program: ``fn`` on the owner's
    buffers, each result copied into a buffer laid out as the eager
    result is (``body.written`` lists them). A result named as an
    argument lands in that argument's buffers where its layout is the
    argument's; such results are written last, after every other result
    was read out of the inputs."""
    multi = isinstance(outs, tuple)
    names = outs if multi else (outs,)

    def body():
        _INSIDE[0] += 1
        try:
            res = fn(**args, **static)
        finally:
            _INSIDE[0] -= 1
        parts = res if multi else (res,)
        if len(parts) != len(names):
            raise ValueError(f"programs: {name} returned {len(parts)} "
                             f"results for {names}")
        tree, written = [None] * len(parts), []
        order = sorted(range(len(parts)), key=lambda i: names[i] in args)
        for i in order:
            nm = names[i]
            lv: list = []
            sp = _flatten(parts[i], f".{nm}" if nm in args else
                          nm if nm.startswith(".") else f"{name}:{nm}", lv)
            baked = _static_values(sp)
            if baked:
                raise TypeError(f"programs: {name} returns python values "
                                f"{baked} in {nm}: a graph would bake them")
            bufs, _ = own.mirror(lv)
            for buf, (_, t) in zip(bufs, lv):
                if buf.data_ptr() != t.data_ptr():
                    buf.copy_(t.detach())
            written += bufs
            tree[i] = _unflatten(sp, iter(bufs))
        body.written = written
        return tuple(tree) if multi else tree[0]

    body.written = []
    return body


# ---------------------------------------------------------------------------
# while_loop: levels of iterations and a tail as one program


class _Loop(_Program):
    """A loop program: the static-buffer body of each level's iteration,
    the tail's, the (iterations, live) buffers the condition reads, and on
    a card the PyTorch graphs captured from them (kept: their pool blocks
    are the addresses the loop graph runs on), the assembled loop graph
    and its device tally of iterations per level. ``launches`` are the
    tail's, which runs once a launch."""

    def __init__(self, name, key, bodies, tail, levels, cond, carry):
        super().__init__(name, key, None)
        self.bodies, self.tail, self.levels = bodies, tail, levels
        self.cond = cond
        self.carry = carry           # data_ptrs of the carry's buffers
        # (the carry's buffers, the tail's results) after a call
        self.graphs: list = []
        self.loop = None
        self.tally = None

    @property
    def written(self) -> list:
        return [b for f in self.bodies + ([self.tail] if self.tail else [])
                for b in f.written]

    def check_carry(self, body):
        """After a run or capture of ``body``: it wrote its results back
        into the buffers it read (the loop's carry)."""
        if {b.data_ptr() for b in body.written} != self.carry:
            raise RuntimeError(
                f"programs: {_describe(self.key)}: an iteration's results "
                f"are not laid out as its carry arguments, so they cannot "
                f"be its carry")

    def host_loop(self, check: bool = False):
        """Each level's body while ``while_cond_plain`` holds, then the
        tail. ``check``: each body's first run is checked by
        ``check_carry``."""
        unchecked = set(range(len(self.bodies)) if check else ())

        def step(l):
            self.bodies[l]()
            if l in unchecked:
                unchecked.discard(l)
                self.check_carry(self.bodies[l])

        _host_while(lambda: self.cond, self.levels, step)
        self.out = (self.out[0], self.tail() if self.tail else None)
        return self.out

    def warm(self):
        """The loop's first iteration, if its condition holds (a host
        read), eagerly, checked by ``check_carry``; then the tail, whose
        results the loop's own tail overwrites (a capture makes no
        buffer)."""
        iters, live = self.cond
        for body, (kmax, early) in zip(self.bodies, self.levels):
            if bool(while_cond_plain(iters, live, kmax, early)):
                body()
                self.check_carry(body)
                break
        if self.tail:
            self.tail()

    def assemble(self, counts: list):
        """The captured graphs as one loop graph, instantiated; ``counts``
        the launches each capture recorded (the levels', then the tail's)."""
        dev = self.cond[0].device
        iters = torch.zeros(len(self.bodies), dtype=torch.int64, device=dev)
        self.tally = _Tally(self, [(iters, [
            c + collections.Counter(while_cond=1)
            for c in counts[:len(self.bodies)]])])
        self.launches = counts[-1] if self.tail else collections.Counter()
        loop = LoopGraph(dev)
        for l, (kmax, early) in enumerate(self.levels):
            loop.add_level(self.graphs[l].raw_cuda_graph(), *self.cond, kmax,
                           early, iters[l:l + 1])
        if self.tail:
            loop.add_child(self.graphs[-1].raw_cuda_graph())
        loop.instantiate()
        self.loop = loop
        _track(self.tally)


def _track(tally: "_Tally"):
    """``tally`` among ``_cuda.TALLIES``; the tallies of retired programs
    leave once folded."""
    _cuda.TALLIES[:] = [t for t in _cuda.TALLIES if not t.settle()]
    _cuda.TALLIES.append(tally)


class _Tally:
    """A program's device-decided runs, counted on the card: a loop
    program's iterations per level, the branch each of its IF nodes took
    (``cond``). ``parts``: [(an int64 tensor of k slots, the launches of
    one run of each slot)]; ``fold`` adds the launches of the runs since
    the last fold to ``LAUNCHES``. Once the program is gone, ``settle``
    copies its last counts to the host behind its last launch and then
    folds them, never waiting."""

    def __init__(self, prog: _Program, parts: list):
        self.parts = parts
        self.per_slot = [c for _, counts in parts for c in counts]
        self.seen = [0] * len(self.per_slot)
        self.prog = weakref.ref(prog)
        self.stream = None       # of the last launch
        self.last = None         # (pinned counts, their copy's event)

    def _counts(self) -> torch.Tensor:
        ts = [t for t, _ in self.parts]
        return ts[0] if len(ts) == 1 else torch.cat(ts)

    def _add(self, now: list):
        for counts, a, b in zip(self.per_slot, now, self.seen):
            if a != b:
                for k, v in counts.items():
                    _cuda.LAUNCHES[k] += v * (a - b)
        self.seen = now

    def fold(self) -> bool:
        """Waits for the last launch. False once the program is gone."""
        alive = self.prog() is not None
        if self.last is not None:
            self.last[1].synchronize()
            self._add(self.last[0].tolist())
            return alive
        if self.stream is None:      # never launched: nothing ran
            return alive
        self.stream.synchronize()
        self._add(self._counts().tolist())
        return alive

    def settle(self) -> bool:
        """True once the program is gone and every launch of it folded;
        else, once it is gone, the copy of its counts is queued."""
        if self.prog() is not None:
            return False
        if self.stream is None:
            return True
        if self.last is None:
            host = torch.empty(len(self.seen), dtype=torch.int64,
                               pin_memory=True)
            ev = torch.cuda.Event()
            with torch.cuda.stream(self.stream):
                host.copy_(self._counts(), non_blocking=True)
                ev.record()
            self.last = (host, ev)
            return False
        if not self.last[1].query():
            return False
        self._add(self.last[0].tolist())
        return True


def _host_while(cond, levels, step):
    """The levels on the host: ``step(l)`` runs an iteration of level l
    while ``while_cond_plain(*cond(), kmax, early)`` holds."""
    for l, (kmax, early) in enumerate(levels):
        while bool(while_cond_plain(*cond(), kmax, early)):
            step(l)


def while_loop(owner: Owner | None, name: str, body, levels, args: dict,
               carry: tuple, cond, body_args: tuple, tail=None,
               tail_args: tuple = (), tail_static: dict | None = None):
    """The JAX ``lax.while_loop``s of one jitted function, in sequence,
    and what follows them, as one program of ``owner``.

    ``levels``: ((static, kmax, early), ...): the level runs
    ``body(**args[body_args], **static)`` while ``while_cond_plain(iters,
    live, kmax, early)`` holds, tested before each iteration, where
    ``cond(args)`` gives the (iters, live) tensors of the carry. ``body``
    returns the new values of the arguments named in ``carry``, laid out
    as they are (they are written back into the same buffers). Then
    ``tail(**args[tail_args], **tail_static)``, whose result is handed out
    as a ``call``'s would be. Returns ({carry name: its value after the
    loop (the owner's buffers)}, the tail's result).

    Keyed and bound as ``call``; on a card the first call of a key runs
    the host loop (the warm-up), then captures each level's iteration and
    the tail and assembles them into one graph of CUDA graph conditional
    WHILE nodes (ops/graph_loop.py); later calls make one launch. A failure
    to capture, assemble or launch raises an error naming the key. On the
    CPU every call runs the host loop over the same static-buffer bodies.
    Under ``eager()`` (or inside a program's body) the host loop runs on
    plain calls."""
    tail_static = tail_static or {}
    if is_eager() or _INSIDE[0]:
        a = dict(args)
        _host_while(lambda: cond(a), [lv[1:] for lv in levels],
                    lambda l: a.update(zip(carry, body(
                        **{k: a[k] for k in body_args}, **levels[l][0]))))
        out = (tail(**{k: a[k] for k in tail_args}, **tail_static)
               if tail else None)
        return {k: a[k] for k in carry}, out
    leaves: list = []
    spec = _flatten(args, "", leaves)
    own = resolve(owner, leaves[0][1].device)
    if not own.fixed:
        own._check_device(leaves[0][1].device)
    static = (("levels", tuple((tuple(sorted(st.items())), kmax, early)
                               for st, kmax, early in levels)),
              ("tail", tuple(sorted(tail_static.items()))))
    with (torch.cuda.device(own.device) if own.device.type == "cuda"
          else contextlib.nullcontext()):
        bufs, layout = own.bind(leaves)
        key = (name, spec, layout, static)
        prog = own.programs.get(key)
        if prog is None:
            a = _unflatten(spec, iter(bufs))
            sub = {k: a[k] for k in body_args}
            bodies = [_make_body(own, name, body, sub, st, carry)
                      for st, _, _ in levels]
            tail_b = (_make_body(own, f"{name}.tail", tail,
                                 {k: a[k] for k in tail_args}, tail_static,
                                 "aux") if tail else None)
            lv: list = []
            _flatten({k: a[k] for k in carry}, "", lv)
            ptrs = {t.data_ptr() for _, t in lv}
            prog = _Loop(name, key, bodies, tail_b,
                         [(kmax, early) for _, kmax, early in levels],
                         cond(a), ptrs)
            prog.out = ({k: a[k] for k in carry}, None)
            out = own._build_loop(prog)
            own.programs[key] = prog
        else:
            out = own._run_loop(prog)
        for buf in prog.written:
            own._source.pop(id(buf), None)
    done, res = out
    if not own.alias:
        return _clone(done), (_clone(res) if tail else None)
    return _fresh(done), (_fresh(res) if tail else None)
