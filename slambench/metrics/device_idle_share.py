"""The device's idle share of the traced stretch, in %: one minus the union
of its kernels, copies and sets over the stretch's span."""


def read(run):
    t = run["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
