"""kernel.k2_roofline (%): K2's bound over its measured ms (see
kernel.k1_roofline)."""


def read(rec):
    p = rec.get("probe")
    if not p or not p.get("k2_ms"):
        return None
    return 100.0 * p["k2_bound_ms"] / p["k2_ms"]
