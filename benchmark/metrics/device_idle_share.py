"""``device_idle_share``: 1 - busy / window over the traced stretch, in %:
busy is the union of the device's kernels, copies and memsets; the window
runs from the host's start of the stretch's first sample to the end of its
last device operation."""


def read(records):
    t = records.get("trace")
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
