"""The host's time blocked on the device: the spans ``wait_event`` (the
CUDA-event wait of ``_HostCopy.get``) and ``wait_read`` (each
``_sync_read``), the same waits ``host_waits_per_frame`` counts, summed
over the window, per frame handed in."""


def read(run):
    stage = run["counters"]["stage_ms"]
    keys = [k for k in ("wait_event", "wait_read") if k in stage]
    n = len(run["calls"])
    return sum(stage[k] for k in keys) / n if keys and n else None
