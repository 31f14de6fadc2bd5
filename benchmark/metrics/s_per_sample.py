"""``s_per_sample``: the window's seconds over the samples completed in it
(host clock from the first ``run_sample`` of the window to the synchronize
after the last)."""


def read(records):
    w = records.get("window")
    if not w or not w["samples"]:
        return None
    return w["seconds"] / w["samples"]
