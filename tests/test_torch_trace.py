"""The port's tracing (gaus_slam_tpu_torch/utils/trace.py).

On the CPU, a tiny Frontend (configs/synthetic/config.py at 48x64,
submaps of 3 frames, 8 tracking and 4 mapping iterations: frame 0 makes
the map, frame 3 cuts the first submap, frame 4 is a keyframe, frame 6
cuts the second) and a Backend that merges both submaps (2 BA iterations
a submap):

  * with no profiler running nothing is recorded;
  * under ``torch.profiler`` each frame is one ``frontend.process_frame``
    span with its ``frame`` and ``kind``, every child span lies inside its
    parent, ``frontend.tracking``'s ``iters`` is the count the frontend
    read back, each task ``Backend.process`` pops is in one
    ``backend.task`` span, ``programs.capture`` spans match the growth of
    ``programs.CAPTURES`` (none on the CPU) and the span names the
    benchmark's readers total exist;
  * ``summary`` on a record set put into the module, against totals
    worked out by hand;
  * ``tools/frame_split.py``'s table of the traced run.

Marked ``cuda`` (skipped without a card): a loop program's device
interval against the same launch timed between two fences, ``summary``
on a traced loop program against what the profiler's trace holds of it,
and capture spans against ``programs.CAPTURES`` on a card.
"""
import inspect
import os
import queue
import time

import numpy as np
import pytest
import torch

from gaus_slam_tpu_torch.slam import programs
from gaus_slam_tpu_torch.utils import trace

H, W, N_FRAMES = 48, 64, 7
ENV = dict(SYN_H=str(H), SYN_W=str(W), SYN_MAX_FRAMES="3",
           SYN_TRACK_ITERS="8", SYN_MAP_ITERS="4", SYN_TAU_K="0.02")
CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs",
                      "synthetic", "config.py")
FRAME_CHILDREN = {"frontend.h2d", "frontend.pose_init", "frontend.tracking",
                  "frontend.kf_test", "frontend.densify", "frontend.mapping",
                  "frontend.prune", "frontend.cut", "frontend.create_map",
                  "frontend.wait"}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several test processes side by side; PyTorch's
    default of one thread per core in each oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config():
    from gaus_slam_tpu_torch.data.synthetic import SyntheticDataset
    from gaus_slam_tpu_torch.utils.config import load_config, probe_cameras

    old = {k: os.environ.get(k) for k in ENV}
    os.environ.update(ENV)
    try:
        cfg = load_config(CONFIG)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    ds = SyntheticDataset(height=H, width=W, num_frames=12)
    probe_cameras(cfg, ds[0][0], ds.intrinsics)
    cfg["tpu"]["frontend_capacity"] = 8192
    cfg["tpu"]["capacity_quantum"] = 4096
    cfg["backend"].update(num_ba_iters=2, random_process=False)
    return cfg, ds


def _frames(fe, ds, n):
    """Frames 0..n-1 through ``fe``; per frame its kind as the frontend's
    state shows it, the iterations it read back, and the submaps cut."""
    kinds, iters, cut = [], [], []
    for t in range(n):
        color, depth, _, c2w = ds[t]
        lmid = fe.cur_lmid
        fe.last_track = None
        fe.process_frame(t, np.asarray(color, np.float32) / np.float32(255),
                         np.asarray(depth), c2w)
        kinds.append("init" if t == 0 else "cut" if fe.cur_lmid > lmid
                     else "keyframe" if fe.local_frames[-1].frame_type == 1
                     else "tracked")
        iters.append(fe.last_track and fe.last_track["iters"])
        while not fe.to_backend.empty():
            cut.append(fe.to_backend.get())
    return kinds, iters, cut


@pytest.fixture(scope="module")
def runs():
    """The untraced run's records, then the traced run's: the frontend's
    frames, the backend's merges and tasks."""
    from gaus_slam_tpu_torch.slam.backend import Backend
    from gaus_slam_tpu_torch.slam.frontend import Frontend

    cfg, ds = _config()
    trace.clear()
    _frames(Frontend(cfg, queue.Queue(), device="cpu"), ds, 5)
    off = trace.records()
    captures0 = sum(programs.CAPTURES.values())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert trace.on()
        fe = Frontend(cfg, queue.Queue(), device="cpu")
        kinds, iters, lms = _frames(fe, ds, N_FRAMES)
        be = Backend(cfg, device="cpu")
        popped = 0
        for lm in lms:
            be.process_localmap(lm, multi_process=True)
            while be.task_queue:
                n = len(be.task_queue)
                be.process()
                popped += n - len(be.task_queue)
        be._check_escalation()
    assert not trace.on()
    recs = trace.records()
    trace.clear()
    return dict(off=off, recs=recs, kinds=kinds, iters=iters, n_lms=len(lms),
                popped=popped,
                captures=sum(programs.CAPTURES.values()) - captures0)


def _named(recs, name):
    return [s for s in recs["spans"] if s["name"] == name]


def test_nothing_is_recorded_without_a_profiler(runs):
    assert not trace.on()
    assert runs["off"] == {"spans": [], "intervals": []}
    # the CPU runs no graph: no device interval in the traced run either
    assert runs["recs"]["intervals"] == []


def test_one_frame_span_per_frame_with_its_kind(runs):
    frames = sorted(_named(runs["recs"], trace.FRAME),
                    key=lambda s: s["t0_ns"])
    assert [s["attrs"]["frame"] for s in frames] == list(range(N_FRAMES))
    assert [s["attrs"]["kind"] for s in frames] == runs["kinds"]
    # the schedule holds each kind of frame
    assert {"init", "tracked", "keyframe", "cut"} <= set(runs["kinds"])
    assert runs["n_lms"] == runs["kinds"].count("cut") >= 2
    assert all(s["parent"] is None for s in frames)


def test_children_lie_inside_their_parents(runs):
    spans = runs["recs"]["spans"]
    by_id = {s["id"]: s for s in spans}
    assert len(by_id) == len(spans)
    n_child = 0
    for s in spans:
        assert s["t0_ns"] <= s["t1_ns"]
        if s["parent"] is None:
            continue
        p = by_id[s["parent"]]
        assert p["t0_ns"] <= s["t0_ns"] and s["t1_ns"] <= p["t1_ns"], s
        assert p["thread"] == s["thread"]
        n_child += 1
        if p["name"] == trace.FRAME:
            assert s["name"] in FRAME_CHILDREN, s["name"]
    assert n_child > 0
    # the cut's map init is a child of the cut
    inits = _named(runs["recs"], "frontend.create_map")
    assert sum(by_id[s["parent"]]["name"] == "frontend.cut"
               for s in inits) == runs["kinds"].count("cut")


def test_tracking_span_iters_are_the_read_back_count(runs):
    by_id = {s["id"]: s for s in runs["recs"]["spans"]}
    got = {by_id[s["parent"]]["attrs"]["frame"]: s["attrs"]["iters"]
           for s in _named(runs["recs"], trace.TRACKING)}
    want = {t: n for t, n in enumerate(runs["iters"]) if n is not None}
    assert got == want and len(got) == N_FRAMES - 1


def test_one_task_span_per_popped_task(runs):
    tasks = _named(runs["recs"], "backend.task")
    n = sum(len(s["attrs"]["submap"]) if isinstance(s["attrs"]["submap"],
                                                     list) else 1
            for s in tasks)
    assert n == runs["popped"] > 0
    kinds = {s["attrs"]["kind"] for s in tasks}
    assert {"mapping", "prune", "tracking"} <= kinds
    assert kinds <= {"mapping_batch", "mapping", "mapping_group", "tracking",
                     "ba", "prune"}
    merges = _named(runs["recs"], "backend.process_localmap")
    assert [s["attrs"]["submap"] for s in merges] == list(
        range(runs["n_lms"]))
    esc = _named(runs["recs"], "backend.escalation")
    assert esc and all({"demand", "r_max", "cap"} <= set(s["attrs"])
                       for s in esc)
    waits = {s["parent"] for s in _named(runs["recs"], "backend.wait")}
    assert all(s["id"] in waits for s in esc)


def test_capture_spans_match_the_captures(runs):
    recs = runs["recs"]
    assert len(_named(recs, trace.CAPTURE)) == runs["captures"]
    warm = _named(recs, "programs.warmup")
    assert warm and all({"owner", "program"} <= set(s["attrs"])
                        for s in warm)
    assert {s["attrs"]["owner"] for s in warm} >= {"frontend", "backend"}


def test_the_readers_span_names_exist(runs):
    names = {s["name"] for s in runs["recs"]["spans"]}
    for name in trace.READ:
        if name == trace.CAPTURE:
            # the CPU captures nothing: the programs open the span
            for fn in (programs.Owner._build, programs.Owner._build_loop):
                assert "trace.CAPTURE" in inspect.getsource(fn)
        else:
            assert name in names, name


def _span(i, name, t0, t1, parent=None, **attrs):
    return {"id": i, "name": name, "parent": parent, "thread": 1,
            "t0_ns": t0, "t1_ns": t1, "attrs": attrs}


def _iv(owner, program, t0, t1, span=None):
    return {"owner": owner, "program": program, "device": "cuda:0",
            "span": span, "thread": 1, "t0_ns": t0, "t1_ns": t1}


def test_summary_by_hand(monkeypatch):
    ms = 1_000_000
    spans = [
        _span(1, trace.FRAME, 0, 100 * ms, frame=0, kind="tracked"),
        _span(2, trace.TRACKING, 10 * ms, 60 * ms, parent=1, iters=40),
        _span(3, "frontend.wait", 50 * ms, 58 * ms, parent=2),
        _span(4, "frontend.wait", 70 * ms, 72 * ms, parent=1),
        _span(5, trace.FRAME, 200 * ms, 300 * ms, frame=1, kind="cut"),
        _span(6, "frontend.wait", 210 * ms, 214 * ms, parent=5),
        _span(7, "frontend.wait", 211 * ms, 213 * ms, parent=6),
        _span(8, trace.CAPTURE, 220 * ms, 250 * ms, parent=5,
              owner="frontend", program="mapping_loop"),
        # starts after the window: left out
        _span(9, trace.FRAME, 500 * ms, 600 * ms, frame=2, kind="tracked"),
    ]
    ivs = [_iv("frontend", "tracking_loop", 12 * ms, 40 * ms, span=2),
           _iv("frontend", "mapping_loop", 30 * ms, 45 * ms, span=1),
           _iv("backend", "mapping_loop", 260 * ms, 290 * ms),
           # cut at the window's end
           _iv("backend", "prune_gaussians", 390 * ms, 420 * ms),
           _iv("frontend", "tracking_loop", 510 * ms, 520 * ms, span=9)]
    monkeypatch.setattr(trace, "_SPANS", spans)
    monkeypatch.setattr(trace, "_IVS", ivs)
    monkeypatch.setattr(trace, "_PENDING", [])
    s = trace.summary(0, 400 * ms)
    assert s["window_ms"] == 400.0
    f = s["spans"][trace.FRAME]
    assert (f["n"], f["ms"]) == (2, 200.0)
    # waits: 8 + 2 in frame 0, 4 in frame 1 (the nested wait once)
    assert f["wait_ms"] == 14.0
    assert f["device_ms"] == 28.0 + 15.0
    assert f["by"]["kind"] == {"tracked": {"n": 1, "ms": 100.0},
                               "cut": {"n": 1, "ms": 100.0}}
    assert f["sum"] == {}
    t = s["spans"][trace.TRACKING]
    assert (t["ms"], t["wait_ms"], t["device_ms"]) == (50.0, 8.0, 28.0)
    assert t["sum"] == {"iters": 40}
    assert s["spans"]["frontend.wait"]["n"] == 4
    assert s["spans"][trace.CAPTURE]["by"]["owner"] == {
        "frontend": {"n": 1, "ms": 30.0}}
    assert s["device"] == {
        "frontend": {"tracking_loop": {"n": 1, "ms": 28.0},
                     "mapping_loop": {"n": 1, "ms": 15.0}},
        "backend": {"mapping_loop": {"n": 1, "ms": 30.0},
                    "prune_gaussians": {"n": 1, "ms": 30.0}}}
    # union: 12-45, 260-290, 390-400 (cut at the window's end)
    assert s["busy_ms"] == 33.0 + 30.0 + 10.0


def test_frame_split_table(runs):
    from gaus_slam_tpu_torch.tools import frame_split as FS

    kinds = FS.summarize(runs["recs"])["kinds"]
    for kind in ("init", "tracked", "keyframe", "cut"):
        assert kinds[kind]["n"] == runs["kinds"].count(kind)
    row = kinds["keyframe"]
    assert {trace.FRAME, "frontend.tracking", "frontend.densify",
            "frontend.mapping", "frontend.prune"} <= set(row["host_ms"])
    assert "frontend.create_map" in kinds["cut"]["host_ms"]
    assert all(v == 0.0 for v in row["device_ms"].values())


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device intervals time graph launches "
                    "there")
    trace.clear()
    yield torch.device("cuda", torch.cuda.current_device())
    trace.clear()


def _heavy_loop(owner, n_iters, size=2048):
    """A loop program of ``n_iters`` iterations of a [size, size] matmul
    and tanh, as one launch of a WHILE node on a card."""
    dev = owner.device or torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    args = {"n": torch.zeros((), dtype=torch.int32, device=dev),
            "live": torch.ones((), dtype=torch.bool, device=dev),
            "x": torch.randn(size, size, device=dev, generator=gen),
            "w": torch.randn(size, size, device=dev, generator=gen)
            / size ** 0.5}
    done, _ = programs.while_loop(
        owner, "heavy", lambda n, live, x, w: (n + 1, live,
                                               torch.tanh(x @ w)),
        [({}, n_iters, False)], args, carry=("n", "live", "x"),
        cond=lambda a: (a["n"], a["live"]),
        body_args=("n", "live", "x", "w"))
    return done


@pytest.mark.cuda
def test_cuda_loop_interval_matches_a_fenced_launch(card):
    """A loop program's device interval within 10% of the same launch
    timed on the host between two synchronizes."""
    own = programs.Owner("heavy", device=card)
    _heavy_loop(own, 200)          # warm-up, capture, first launch
    fenced = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _heavy_loop(own, 200)
        torch.cuda.synchronize()
        fenced.append((time.perf_counter() - t0) * 1e3)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            _heavy_loop(own, 200)
    torch.cuda.synchronize()
    ivs = [iv for iv in trace.records()["intervals"]
           if iv["program"] == "heavy"]
    assert len(ivs) == 3 and all(iv["owner"] == "heavy" for iv in ivs)
    got = [(iv["t1_ns"] - iv["t0_ns"]) / 1e6 for iv in ivs]
    want = float(np.median(fenced))
    print(f"loop program: fenced {fenced} ms, device intervals {got} ms")
    assert want > 5.0
    assert all(abs(g - want) <= 0.1 * want for g in got), (got, fenced)


@pytest.mark.cuda
def test_cuda_summary_counts_the_loop_time_the_profiler_misses(card):
    """Under a profiler that traces the card, ``summary`` holds each loop
    launch whole: its device ms cover the fenced time of the launches,
    while the profiler's device operations add up to less (on the H100
    with PyTorch 2.11 it recorded from one iteration of 200 a launch to
    every one, by process)."""
    own = programs.Owner("heavy", device=card)
    _heavy_loop(own, 200)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _heavy_loop(own, 200)
    torch.cuda.synchronize()
    fenced = (time.perf_counter() - t0) * 1e3
    a = time.perf_counter_ns()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            _heavy_loop(own, 200)
        torch.cuda.synchronize()
    s = trace.summary(a, time.perf_counter_ns())
    dev = s["device"]["heavy"]["heavy"]
    ops = [ev for ev in prof.profiler.kineto_results.events()
           if ev.device_type() == torch.autograd.DeviceType.CUDA
           and ev.duration_ns() > 0]
    seen = sum(ev.duration_ns() for ev in ops) / 1e6
    mm = sum(1 for ev in ops if "gemm" in ev.name().lower())
    print(f"loop program: fenced {fenced:.3f} ms a launch; trace "
          f"{dev['ms']:.3f} ms in {dev['n']} launches; the profiler's "
          f"device operations {seen:.3f} ms in {len(ops)} ({mm} matmuls of "
          f"1000 iterations)")
    assert dev["n"] == 5 and s["busy_ms"] == pytest.approx(dev["ms"])
    assert dev["ms"] >= 0.9 * 5 * fenced
    assert seen < dev["ms"]


@pytest.mark.cuda
def test_cuda_capture_spans_match_the_captures(card):
    own = programs.Owner("captures", device=card)
    n0 = sum(programs.CAPTURES.values())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _heavy_loop(own, 4, size=64)
        x = torch.ones(8, device=card)
        for _ in range(2):
            programs.call(own, "twice", lambda x: 2 * x, dict(x=x), {},
                          outs="y")
    recs = trace.records()
    caps = _named(recs, trace.CAPTURE)
    assert len(caps) == sum(programs.CAPTURES.values()) - n0 == 2
    assert {(s["attrs"]["owner"], s["attrs"]["program"]) for s in caps} == {
        ("captures", "heavy"), ("captures", "twice")}
    ivs = {(iv["owner"], iv["program"]) for iv in recs["intervals"]}
    assert ivs == {("captures", "heavy"), ("captures", "twice")}
