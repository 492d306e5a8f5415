"""ORB extraction: ``Tracker.stage_ms["frame_extract"]`` (the span around
the extractor, kernel K1 inside; ``tpuslam/frame_extract`` in a trace) per
tracked call."""

from slambench.metrics._per_frame import per_tracked_call


def read(run):
    return per_tracked_call(run, ["frame_extract"])
