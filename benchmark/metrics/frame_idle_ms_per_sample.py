"""``frame_idle_ms_per_sample``: the device's idle time under the movie's
frame boundary, per sample of the traced stretch, in ms: the
``idle_gaps`` of the stretch whose innermost host range is the program's
``clive2.frame`` span or one inside it (``clive2.frame.image``,
``.save``, ``.camera``; ``apps/movie.py:Movie.step``), summed.  None
without a trace, or where no gap falls under those spans (a program
without them).  ``tracing.records`` keeps only the ten labels with the
most idle time, so a frame span whose gaps rank lower is left out of the
sum: the number is a floor of the boundary's idle time, and falls to
None once every frame span ranks below the tenth label."""

PREFIX = "clive2.frame"


def read(records):
    t = records.get("trace")
    if not t or not t["samples"]:
        return None
    gaps = [s for name, s in t["idle_gaps"]
            if name == PREFIX or name.startswith(PREFIX + ".")]
    if not gaps:
        return None
    return 1e3 * sum(gaps) / t["samples"]
