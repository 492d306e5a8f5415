"""The frame program's time: the median of the port's own seconds around
each tracker call of the window that neither initialized nor made a
keyframe (``run_loop``'s per-frame time), in ms."""

from slambench.harness import percentile


def read(run):
    hot = [f.call_s * 1e3 for f in run["calls"] if f.kind == "hot"]
    return percentile(hot, 50.0) if hot else None
