"""setup_s (s, host clock): process start to the first window frame's
hand-off (kernels loaded or built, frames made, Frontend and Backend
built, the two warm-up cuts and their backend work)."""


def read(rec):
    return rec.get("setup_s")
