"""frontend.ms_per_frame (ms/frame): host ms in Frontend.process_frame,
fenced by device synchronisations, per window frame (traced run)."""


def read(rec):
    if not rec.get("frames") or not rec.get("traced"):
        return None
    return rec["frontend_s"] * 1000 / rec["frames"]
