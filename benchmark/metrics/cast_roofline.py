"""``cast_roofline``: the bytes bound of the traced stretch's casts
(``roofline.cast_bytes`` over the card's HBM bandwidth, ``peaks.py``) over
their device time, in %.  Bytes only, so a lower bound on the time and a
share that operations could not push higher."""

from benchmark.peaks import H100_SXM
from benchmark.roofline import cast_bytes


def read(records):
    t = records.get("trace")
    if not t or not t["casts"] or t["cast_device_s"] <= 0:
        return None
    total = sum(cast_bytes(c["rays"], c["active"], c["t_max"],
                           t["n_triangles"]) for c in t["casts"])
    return 100.0 * total / H100_SXM["hbm_bytes_per_s"] / t["cast_device_s"]
