"""programs.pool_mib (MiB): device memory held in CUDA graph pools at the
window's end (reference/pools.py)."""


def read(rec):
    return rec.get("pool_mib")
