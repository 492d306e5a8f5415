"""Per-layer metric readers, one file per metric named as in
``BENCHMARK.json``.  Each has ``read(run) -> float | None``; ``run`` is the
dict ``run.py`` builds after the window (``calls``: the harness's frame
records of the window, ``counters``: the port's spans and counters summed
over the window, ``trace``: the traced stretch's reduction, ``config``: the
configuration).  A reader that finds nothing to read returns None, and the
metric is left out of the line."""
