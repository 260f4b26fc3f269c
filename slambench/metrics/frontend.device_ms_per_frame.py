"""frontend.device_ms_per_frame (ms/frame): the card's ms in the launches
of the frontend owner's programs (utils/trace.py device intervals, WHILE
bodies included) in the traced part of the window, per
frontend.process_frame span there."""


def read(rec):
    if "prof_t0" not in rec or "traced_s" not in rec:
        return None
    try:
        from gaus_slam_tpu_torch.utils import trace
    except ImportError:   # a tree without the port's tracing
        return None
    t0 = round(rec["prof_t0"] * 1e9)
    s = trace.summary(t0, t0 + round(rec["traced_s"] * 1e9))
    frames = s["spans"].get(trace.FRAME, {}).get("n", 0)
    if not frames:
        return None
    progs = s["device"].get("frontend")
    if not progs:
        return None
    return sum(p["ms"] for p in progs.values()) / frames
