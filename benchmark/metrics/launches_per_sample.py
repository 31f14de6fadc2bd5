"""``launches_per_sample``: the device's kernels, copies and memsets in the
traced stretch over its samples (the benchmark's own ray counts left
out)."""


def read(records):
    t = records.get("trace")
    if not t or not t["samples"] or not t["launches"]:
        return None
    return t["launches"] / t["samples"]
