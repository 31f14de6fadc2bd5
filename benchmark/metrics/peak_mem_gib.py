"""``peak_mem_gib``: ``torch.cuda.max_memory_allocated()`` over the window
(the peak statistics reset at the end of set-up, what is resident
counted), in GiB."""


def read(records):
    w = records.get("window")
    if not w:
        return None
    return w["peak_bytes"] / 2 ** 30
