"""driver.drain_s (s): from the last window frame's return to the empty
backend task queue and the synchronised card."""


def read(rec):
    return rec.get("drain_s")
