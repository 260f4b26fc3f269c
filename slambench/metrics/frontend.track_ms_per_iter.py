"""frontend.track_ms_per_iter (ms/iter): the card's ms in the launches of
the frontend's tracking_loop program (utils/trace.py device intervals:
its WHILE nodes' iterations and its tail) in the traced part of the
window, over the iterations that the frontend.tracking spans there read
back (their ``iters``)."""


def read(rec):
    if "prof_t0" not in rec or "traced_s" not in rec:
        return None
    try:
        from gaus_slam_tpu_torch.utils import trace
    except ImportError:   # a tree without the port's tracing
        return None
    t0 = round(rec["prof_t0"] * 1e9)
    s = trace.summary(t0, t0 + round(rec["traced_s"] * 1e9))
    loop = s["device"].get("frontend", {}).get("tracking_loop")
    iters = s["spans"].get(trace.TRACKING, {}).get("sum", {}).get("iters")
    if not loop or not iters:
        return None
    return loop["ms"] / iters
