"""The loop detector: every ``loop_*`` stage of the loop closer per keyframe
made."""

from slambench.metrics._per_kf import per_kf


def read(run):
    return per_kf(run, sorted(k for k in run["counters"]["stage_ms"] if k.startswith("loop_")))
