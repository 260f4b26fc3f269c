"""kernel.k1_roofline (%): K1's bound over its ms, the bound from the
frozen work count and peaks (reference/work.py) on the frontend's map and
last frame at the window's end, the ms from the profiler's trace of the
probe's launches after the window (probe.py)."""


def read(rec):
    p = rec.get("probe")
    if not p or not p.get("k1_ms"):
        return None
    return 100.0 * p["k1_bound_ms"] / p["k1_ms"]
