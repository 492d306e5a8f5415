"""The three matches without their pose optimizations: the spans
``frame_motion``, ``frame_ref`` and ``frame_localmap`` less
``frame_pose_opt``, which nests inside them, per tracked call."""

from slambench.metrics._per_frame import per_tracked_call


def read(run):
    return per_tracked_call(run, ["frame_motion", "frame_ref", "frame_localmap"], minus=["frame_pose_opt"])
