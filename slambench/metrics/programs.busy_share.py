"""programs.busy_share (%): the union of the device intervals of every
captured program's launches (utils/trace.py: CUDA events around each
graph replay and loop launch, so the runs of WHILE bodies count) over
the traced part of the window (from ``prof_t0`` for ``traced_s``), the
card busy with the programs. Eager work outside a program (a warm-up
before a capture, the submap cut's copies, the merge's transform) counts
as idle. None where the program records no interval."""


def read(rec):
    if "prof_t0" not in rec or "traced_s" not in rec:
        return None
    try:
        from gaus_slam_tpu_torch.utils import trace
    except ImportError:   # a tree without the port's tracing
        return None
    t0 = round(rec["prof_t0"] * 1e9)
    s = trace.summary(t0, t0 + round(rec["traced_s"] * 1e9))
    if not s["device"]:
        return None
    return 100.0 * s["busy_ms"] / s["window_ms"]
