"""backend.ms_per_frame (ms/frame): host ms in Backend.process_localmap
and Backend.process, fenced, per window frame (traced run)."""


def read(rec):
    if not rec.get("frames") or not rec.get("traced"):
        return None
    return rec["backend_s"] * 1000 / rec["frames"]
