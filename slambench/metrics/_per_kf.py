"""Shared arithmetic of the per-keyframe stage readers."""


def per_kf(run, names):
    """The port's host ms of the named keyframe stages, summed over the
    window, per keyframe made in it; None without a keyframe or a stage."""
    c = run["counters"]
    stages = [c["stage_ms"][n] for n in names if n in c["stage_ms"]]
    if not c["keyframes"] or not stages:
        return None
    return sum(stages) / c["keyframes"]
