"""The port's tracing: spans at the layer boundaries of the frontend, the
backend and the captured programs, and the card's time in each launch of
a captured program.

Tracing is on while a torch.profiler records (``on()``); nothing else
switches it. Off, every entry point costs one flag check and records
nothing. On, the module keeps in memory:

  * spans (``span(name, **attrs)``, a context manager, or
    ``spanned(name)`` on a function; ``annotate(**attrs)`` adds attributes
    to the innermost open span): a name, a start and an end on
    ``time.perf_counter_ns``, the enclosing span of the same thread, the
    thread, and attributes (``frame``: the frame's
    ``time_idx``; ``submap``; ``iters``; ``kind``; ``owner`` and
    ``program`` on the programs' spans). Each span is also a
    ``torch.profiler.record_function`` of its name, so it lands on the
    profiler's timeline. A span named ``<layer>.wait`` covers a place
    where its layer blocks the host on the card.
  * device intervals (``device(owner, program, device)``, a context
    manager around ``graph.replay()`` or a loop program's launch): a pair
    of timing CUDA events recorded on the launching stream, outside the
    graph, so the interval holds the whole program, the runs of its
    WHILE bodies included (which the profiler does not see). Each is
    tagged with its owner, its program, its device and the span open at
    the launch. The events are read when ``records()`` or ``summary()``
    is called, after the caller's own synchronisation (a pending event is
    waited for there, never during the run), and placed on the host's
    clock by one anchor per card: an event recorded right after a
    ``torch.cuda.synchronize()`` at the card's first traced launch,
    paired with ``perf_counter_ns`` at that moment.

``records()`` gives both, ``summary(t0_ns, t1_ns)`` totals over those that
start in [t0, t1], ``clear()`` drops them. The profiler's own chrome
trace carries the spans; there is no other exporter.
"""
from __future__ import annotations

import collections
import functools
import itertools
import threading
import time

import torch

# names of the spans the benchmark's readers (slambench/metrics) total
FRAME = "frontend.process_frame"
TRACKING = "frontend.tracking"
CAPTURE = "programs.capture"
WAIT = ".wait"          # the suffix of a host wait's span
READ = (FRAME, TRACKING, "frontend.wait", CAPTURE)
IDS = ("frame", "submap")   # attributes that name, not count: never summed

on = torch._C._autograd._profiler_enabled    # a profiler records

_SPANS: list = []        # finished spans, as dicts
_IVS: list = []          # resolved device intervals, as dicts
_PENDING: list = []      # device intervals whose events are not read yet
_ANCHORS: dict = {}      # device -> (CUDA event, perf_counter_ns)
_IDS = itertools.count(1)
_LOCAL = threading.local()


def _stack() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


class _Off:
    """What an entry point returns while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.rec = {"id": next(_IDS), "name": name, "parent": None,
                    "thread": threading.get_ident(), "t0_ns": 0, "t1_ns": 0,
                    "attrs": attrs}

    def __enter__(self):
        st = _stack()
        if st:
            self.rec["parent"] = st[-1].rec["id"]
        self._rf = torch.profiler.record_function(self.rec["name"])
        self._rf.__enter__()
        st.append(self)
        self.rec["t0_ns"] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.rec["t1_ns"] = time.perf_counter_ns()
        _stack().pop()
        self._rf.__exit__(*exc)
        _SPANS.append(self.rec)
        return False


def span(name: str, **attrs):
    """A span of ``name`` around the enclosed block; a no-op while tracing
    is off."""
    if not on():
        return _OFF
    return _Span(name, attrs)


def spanned(name: str):
    """A method or function decorator: each call is a span of ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*a, **kw):
            if not on():
                return fn(*a, **kw)
            with _Span(name, {}):
                return fn(*a, **kw)
        return traced
    return wrap


def annotate(**attrs):
    """Attributes of the innermost span open in this thread (a count read
    back inside it); a no-op while tracing is off."""
    if not on():
        return
    st = _stack()
    if st:
        st[-1].rec["attrs"].update(attrs)


def _anchor(dev: torch.device) -> tuple:
    a = _ANCHORS.get(dev)
    if a is None:
        torch.cuda.synchronize(dev)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(dev))
        a = _ANCHORS[dev] = (ev, time.perf_counter_ns())
    return a


class _Interval:
    __slots__ = ("owner", "program", "device", "span", "thread", "anchor",
                 "ev0", "ev1")

    def __init__(self, owner: str, program: str, dev: torch.device):
        self.owner, self.program, self.device = owner, program, dev
        st = _stack()
        self.span = st[-1].rec["id"] if st else None
        self.thread = threading.get_ident()

    def __enter__(self):
        self.anchor = _anchor(self.device)
        self.ev0 = torch.cuda.Event(enable_timing=True)
        self.ev0.record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc):
        self.ev1 = torch.cuda.Event(enable_timing=True)
        self.ev1.record(torch.cuda.current_stream(self.device))
        _PENDING.append(self)
        return False

    def resolve(self) -> dict:
        self.ev1.synchronize()
        ev, ns = self.anchor
        t0 = ns + round(ev.elapsed_time(self.ev0) * 1e6)
        return {"owner": self.owner, "program": self.program,
                "device": str(self.device), "span": self.span,
                "thread": self.thread, "t0_ns": t0,
                "t1_ns": t0 + round(self.ev0.elapsed_time(self.ev1) * 1e6)}


def device(owner: str, program: str, dev: torch.device):
    """The card's interval of the enclosed launch of ``owner``'s
    ``program`` on the current stream of ``dev`` (a CUDA device); a no-op
    while tracing is off or on another device."""
    if not on() or dev.type != "cuda":
        return _OFF
    return _Interval(owner, program, dev)


def _resolve():
    done = _PENDING[:]
    del _PENDING[:len(done)]
    _IVS.extend(iv.resolve() for iv in done)


def records() -> dict:
    """{"spans": [...], "intervals": [...]}, each a dict: a span's ``id``,
    ``name``, ``parent`` (an id or None), ``thread``, ``t0_ns``, ``t1_ns``,
    ``attrs``; an interval's ``owner``, ``program``, ``device``, ``span``
    (the id of the span open at the launch, or None), ``thread``,
    ``t0_ns``, ``t1_ns`` (the host's clock). Waits for the events of
    launches the card has not finished."""
    _resolve()
    return {"spans": list(_SPANS), "intervals": list(_IVS)}


def clear():
    """Drops every record and the cards' anchors."""
    _PENDING.clear()
    _SPANS.clear()
    _IVS.clear()
    _ANCHORS.clear()


def _union_ms(ivs: list, t1: int) -> float:
    busy, end = 0, None
    for a, b in sorted((iv["t0_ns"], min(iv["t1_ns"], t1)) for iv in ivs):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e6


def summary(t0_ns: int, t1_ns: int) -> dict:
    """Totals over the spans and device intervals that start in [t0_ns,
    t1_ns]:

      ``spans``: {name: {"n", "ms", "wait_ms": the ms of the ``*.wait``
        spans inside it (at any depth, not inside another wait),
        "device_ms": the card's ms of the launches made inside it,
        "sum": {attribute: total} of its numeric attributes but the
        ``IDS``,
        "by": {attribute: {value: {"n", "ms"}}} of its string ones}};
      ``device``: {owner: {program: {"n", "ms"}}};
      ``busy_ms``: the union of the intervals (cut at t1_ns), every card's
        together; ``window_ms``: t1_ns - t0_ns in ms.
    """
    recs = records()
    by_id = {s["id"]: s for s in recs["spans"]}
    spans = [s for s in recs["spans"] if t0_ns <= s["t0_ns"] <= t1_ns]
    ivs = [iv for iv in recs["intervals"] if t0_ns <= iv["t0_ns"] <= t1_ns]

    def row():
        return {"n": 0, "ms": 0.0, "wait_ms": 0.0, "device_ms": 0.0,
                "sum": collections.Counter(), "by": {}}

    out: dict = collections.defaultdict(row)
    for s in spans:
        r = out[s["name"]]
        ms = (s["t1_ns"] - s["t0_ns"]) / 1e6
        r["n"] += 1
        r["ms"] += ms
        for k, v in s["attrs"].items():
            if isinstance(v, str):
                c = r["by"].setdefault(k, {}).setdefault(v, {"n": 0,
                                                             "ms": 0.0})
                c["n"] += 1
                c["ms"] += ms
            elif (isinstance(v, (int, float)) and not isinstance(v, bool)
                  and k not in IDS):
                r["sum"][k] += v

    def ancestors(sid):
        seen = set()
        while sid is not None and sid in by_id:
            s = by_id[sid]
            if s["name"] not in seen:
                seen.add(s["name"])
                yield s
            sid = s["parent"]

    in_window = {id(s) for s in spans}
    for s in spans:
        if not s["name"].endswith(WAIT):
            continue
        ups = list(ancestors(s["parent"]))
        if any(u["name"].endswith(WAIT) for u in ups):
            continue
        for u in ups:
            if id(u) in in_window:
                out[u["name"]]["wait_ms"] += (s["t1_ns"] - s["t0_ns"]) / 1e6
    dev: dict = {}
    for iv in ivs:
        ms = (iv["t1_ns"] - iv["t0_ns"]) / 1e6
        d = dev.setdefault(iv["owner"], {}).setdefault(
            iv["program"], {"n": 0, "ms": 0.0})
        d["n"] += 1
        d["ms"] += ms
        for u in ancestors(iv["span"]):
            if id(u) in in_window:
                out[u["name"]]["device_ms"] += ms
    for r in out.values():
        r["sum"] = dict(r["sum"])
    return {"spans": dict(out), "device": dev,
            "busy_ms": _union_ms(ivs, t1_ns),
            "window_ms": (t1_ns - t0_ns) / 1e6}
