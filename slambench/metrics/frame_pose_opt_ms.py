"""The motion-only pose LM: ``Tracker.stage_ms["frame_pose_opt"]``, the
three ``optimize_pose`` calls of the frame program, per tracked call."""

from slambench.metrics._per_frame import per_tracked_call


def read(run):
    return per_tracked_call(run, ["frame_pose_opt"])
