"""fps (frames/s, host clock): frames whose process_frame returned in the
window over the seconds from the first window frame's hand-off to the
drained backend and the synchronised card."""


def read(rec):
    if not rec.get("frames") or not rec.get("window_s"):
        return None
    return rec["frames"] / rec["window_s"]
