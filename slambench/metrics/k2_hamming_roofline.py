"""Kernel K2 (Hamming top-2): its bound at max_keypoints x max_keypoints
over its device time per call in the traced stretch, in %."""

from slambench import roofline
from slambench.metrics._roofline import share


def read(run):
    return share(run, roofline.K2_KERNEL, roofline.k2_bound_s(run["config"]))
