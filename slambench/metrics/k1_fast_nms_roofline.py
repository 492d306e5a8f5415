"""Kernel K1 (FAST-9 + NMS): its bound at the configuration's pyramid over
its device time per call in the traced stretch, in %."""

from slambench import roofline
from slambench.metrics._roofline import share


def read(run):
    return share(run, roofline.K1_KERNEL, roofline.k1_bound_s(run["config"]))
