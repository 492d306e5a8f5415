"""The Tracker's explicit host waits on the device (``Tracker.waits``: its
reads and CUDA-event waits) summed over the window, per frame handed in."""


def read(run):
    n = len(run["calls"])
    return run["counters"]["waits"] / n if n else None
