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
they read and write, and on a card a capture stream; the owners of one
name share a graph memory pool. The frontend and the backend run on
streams of their own at the same time and never share a pool.

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
``jax.disable_jit``.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import weakref

import torch

from ..ops import _cuda
from ..ops.camera import Camera

# replays by program name, and captures, since the process started
GRAPH_LAUNCHES: collections.Counter = collections.Counter()
CAPTURES: collections.Counter = collections.Counter()

_EAGER = [0]
_DEFAULT: dict = {}
_POOLS: dict = {}     # (device, owner name) -> _pool(...)


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


class Owner:
    """The programs, static buffers and (on a card) capture stream of one
    caller, and the graph pool of every owner of its name on its device:
    the temporaries of one graph are free again when the next is
    captured, so the graphs of the owners of one name (one Frontend after
    another; never two at once) share their memory. ``alias=False`` (the
    default owner) hands out copies of every result."""

    def __init__(self, name: str, alias: bool = True):
        self.name, self.alias = name, alias
        self.device = None
        self.programs: dict = {}
        self.buffers: dict = {}
        self._source: dict = {}      # id(buffer) -> (weakref, version)
        self._storages: set = set()  # data_ptr of every buffer storage
        self.capacity = None
        self.stream = None
        self._retired: list = []
        self.resets = 0

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

    def bind(self, leaves: list) -> tuple:
        """``mirror``'s buffers holding the leaves' values: each copied in
        unless its buffer already holds it (the same storage, or the same
        tensor at the same version as the last copy). A graph's replay
        writes its buffers without a version bump, so a tensor in a storage
        of the owner's is copied every time."""
        bufs, sig = self.mirror(leaves)
        for buf, (_, t) in zip(bufs, leaves):
            if buf.data_ptr() == t.data_ptr():
                continue
            src = self._source.get(id(buf))
            if (src is not None and src[0]() is t and src[1] == t._version
                    and t.untyped_storage().data_ptr() not in self._storages):
                continue
            buf.copy_(t.detach())
            self._source[id(buf)] = (weakref.ref(t), t._version)
        return bufs, sig

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
    def _build(self, name, key, body, capture: bool) -> tuple:
        prog = _Program(name, key, body)
        if self.device.type != "cuda" or not capture:
            out = body()
            prog.out = out
            return prog, out
        if self.stream is None:
            self.stream = torch.cuda.Stream(device=self.device)
        pool = _POOLS.get((self.device, self.name))
        if pool is None:
            pool = _POOLS[(self.device, self.name)] = _pool(self.device,
                                                            self.stream)
        # the warm-up: the call's real work, on the caller's stream
        out = body()
        cur = torch.cuda.current_stream(self.device)
        s = self.stream
        s.wait_stream(cur)
        before = collections.Counter(_cuda.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        # a graph that Python's collector destroys during a capture (an
        # owner of a dropped Frontend, say) invalidates it: no collection
        # while capturing
        gc_was = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(self.device), torch.cuda.stream(s):
                graph.capture_begin(pool=pool[0],
                                    capture_error_mode="thread_local")
                _CAPTURING.add(id(self))
                try:
                    prog.out = body()
                finally:
                    _CAPTURING.discard(id(self))
                    graph.capture_end()
        except Exception as e:
            raise RuntimeError(f"programs: capture of {_describe(key)} failed "
                               f"(owner {self.name}): {e}") from e
        finally:
            if gc_was:
                gc.enable()
            cur.wait_stream(s)
        # the capture launched nothing: its counts belong to the replays
        counts = collections.Counter(_cuda.LAUNCHES)
        counts.subtract(before)
        prog.launches = +counts
        for k, v in prog.launches.items():
            _cuda.LAUNCHES[k] -= v
            if _cuda.LAUNCHES[k] == 0:
                del _cuda.LAUNCHES[k]
        prog.graph = graph
        CAPTURES[name] += 1
        return prog, out

    def _replay(self, prog: _Program):
        if prog.graph is None:
            return prog.body()
        try:
            prog.graph.replay()
        except Exception as e:
            raise RuntimeError(f"programs: replay of {_describe(prog.key)} "
                               f"failed (owner {self.name}): {e}") from e
        _cuda.LAUNCHES.update(prog.launches)
        GRAPH_LAUNCHES[prog.name] += 1
        return prog.out


_CAPTURING: set = set()


def _pool(device, stream) -> tuple:
    """(a graph pool handle, a one-kernel graph captured into it, that
    graph's tensor), the capture on ``stream``. A pool
    goes with the last graph captured into it, and its handle may not be
    captured into again (PyTorch 2.11 asserts): the keeper graph, kept as
    long as the process runs, holds it for the owners of one name."""
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
                       (g[1] for g in layout[:4]))
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
         outs, copies: tuple = (), capture: bool = True):
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
    static-buffer body runs as on the CPU."""
    if is_eager():
        return fn(**args, **static)
    leaves: list = []
    spec = _flatten(args, "", leaves)
    own = resolve(owner, leaves[0][1].device)
    own._check_device(leaves[0][1].device)
    if "gm" in args:
        own.set_capacity(args["gm"].capacity)
    bufs, layout = own.bind(leaves)
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
        res = fn(**args, **static)
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
