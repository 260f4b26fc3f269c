"""programs.captures_per_frame (captures/frame): the growth of the
port's programs.CAPTURES over the window, per window frame."""


def read(rec):
    if not rec.get("frames"):
        return None
    return rec["captures"] / rec["frames"]
