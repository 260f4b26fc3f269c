"""peak_mib (MiB, host clock run): torch.cuda.max_memory_reserved over
the whole process up to the window's end, graph pools included."""


def read(rec):
    b = rec.get("peak_bytes")
    return None if b is None else b / 2**20
