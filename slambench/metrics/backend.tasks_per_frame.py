"""backend.tasks_per_frame (tasks/frame): backend tasks popped in the
window, drain included (a fused mapping batch pops four), per window
frame."""


def read(rec):
    if not rec.get("frames"):
        return None
    return rec["tasks"] / rec["frames"]
