"""staging.wait_ms_per_frame (ms/frame): host ms that turns spent asleep
on an empty feeder queue, per window frame."""


def read(rec):
    if not rec.get("frames"):
        return None
    return rec["staging_wait_s"] * 1000 / rec["frames"]
