"""Shared arithmetic of the kernel roofline readers."""

from slambench import tracing


def share(run, kernel: str, bound_s: float):
    """The kernel's least time over its measured device time per call, in
    %, or None when the traced stretch holds no call of it."""
    got = tracing.kernel_call_s(run["trace"], kernel)
    if got is None or got[0] <= 0:
        return None
    return 100.0 * bound_s / got[0]
