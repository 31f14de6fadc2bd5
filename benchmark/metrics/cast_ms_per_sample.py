"""``cast_ms_per_sample``: device time of the kernels, copies and memsets
launched inside the ``intersect_scene`` ranges of the traced stretch (the
traversal with its sort and glue), per sample, in ms."""


def read(records):
    t = records.get("trace")
    if not t or not t["samples"] or t["cast_device_s"] <= 0:
        return None
    return 1e3 * t["cast_device_s"] / t["samples"]
