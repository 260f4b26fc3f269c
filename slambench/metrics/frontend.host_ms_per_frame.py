"""frontend.host_ms_per_frame (ms/frame): the host's own ms in
Frontend.process_frame: its frontend.process_frame spans (utils/trace.py,
no fences) less the frontend.wait spans inside them, where the host
blocks on the card, in the traced part of the window, per frame."""


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
    row = s["spans"][trace.FRAME]
    return (row["ms"] - row["wait_ms"]) / frames
