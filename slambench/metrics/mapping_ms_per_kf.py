"""Local mapping without the BA: the ``map_tri``, ``map_fuse`` and
``map_kfcull`` stages per keyframe made."""

from slambench.metrics._per_kf import per_kf


def read(run):
    return per_kf(run, ["map_tri", "map_fuse", "map_kfcull"])
