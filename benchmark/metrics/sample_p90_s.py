"""``sample_p90_s``: the 90th percentile (nearest rank) of the intervals
between consecutive samples' completions over the whole window, each
completion a CUDA event recorded on the stream after its ``run_sample``
(the first interval runs from an event recorded as the window opens)."""

import math


def read(records):
    w = records.get("window")
    if not w or not w["intervals"]:
        return None
    v = sorted(w["intervals"])
    return v[math.ceil(0.9 * len(v)) - 1]
