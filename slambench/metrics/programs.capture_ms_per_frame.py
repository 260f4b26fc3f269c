"""programs.capture_ms_per_frame (ms/frame): host ms in programs.capture
spans (utils/trace.py: a key's capture, a loop program's assembly and
each graph's instantiation; the eager warm-up before it is a span of its
own and left out) in the traced part of the window, per
frontend.process_frame span there (0 where nothing was captured)."""


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
    return s["spans"].get(trace.CAPTURE, {}).get("ms", 0.0) / frames
