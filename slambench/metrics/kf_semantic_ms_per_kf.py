"""The semantic step (planes and cuboids): ``Tracker.stage_ms["kf_semantic"]``
per keyframe made."""

from slambench.metrics._per_kf import per_kf


def read(run):
    return per_kf(run, ["kf_semantic"])
