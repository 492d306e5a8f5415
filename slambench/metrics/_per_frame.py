"""Shared arithmetic of the frame-program span readers."""


def per_tracked_call(run, names, minus=()):
    """The port's host ms of the named spans (less those of ``minus``),
    summed over the window, per tracked call: a call that began with the
    tracker tracking, which is one that runs the frame program.  None
    without a tracked call, or when the program has none of the spans."""
    stage = run["counters"]["stage_ms"]
    n = sum(1 for f in run["calls"] if f.tracking)
    if not n or any(k not in stage for k in (*names, *minus)):
        return None
    return (sum(stage[k] for k in names) - sum(stage[k] for k in minus)) / n
