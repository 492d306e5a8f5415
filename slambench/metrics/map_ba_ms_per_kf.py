"""The local BA: ``Tracker.stage_ms["map_ba"]`` per keyframe made."""

from slambench.metrics._per_kf import per_kf


def read(run):
    return per_kf(run, ["map_ba"])
