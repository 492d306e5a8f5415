"""The yardstick of the kernels: the card's published peaks and the work each
kernel's call needs at a configuration's shapes, counted from the shapes
alone, so the same work is counted whatever implements it.

The counts are the ones the port's kernel table states (``chip_smoke.py``'s
``time_k1`` and ``time_k2``, copied here): K1 reads each level's live pixels
once and writes the whole (L, H, W) score map, in float32; K2 compares every
descriptor of one set with every one of the other as a +-1 int8 product of
256 lanes, and reads both sets, the other's mask, and writes index and two
distances per row.
"""

from __future__ import annotations

# NVIDIA H100 SXM, data sheet, dense rates at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

K1_KERNEL = "fast_nms_kernel"
K2_KERNEL = "hamming_top2_kernel"


def level_dims(H: int, W: int, n_levels: int, scale_factor: float):
    return [(int(round(H / scale_factor**lvl)), int(round(W / scale_factor**lvl))) for lvl in range(n_levels)]


def k1_bound_s(config: dict) -> float:
    """The least time of one K1 call on the configuration's pyramid: bytes
    (live pixels in, the whole map out, 4 bytes each) over HBM bandwidth."""
    c, o = config["camera"], config["orb"]
    H, W, L = c["height"], c["width"], o["n_levels"]
    live = sum(h * w for h, w in level_dims(H, W, L, o["scale_factor"]))
    return (live + L * H * W) * 4 / HBM_BYTES_PER_S


def k2_bound_s(config: dict) -> float:
    """The least time of one K2 call, the frame's descriptors against the
    reference keyframe's (both ``max_keypoints``): the larger of the int8
    operations over the tensor peak and the bytes over HBM bandwidth."""
    n = m = config["caps"]["max_keypoints"]
    ops = 2 * n * m * 256 / INT8_OPS_PER_S
    moved = (n * 32 + m * 33 + n * 12) / HBM_BYTES_PER_S
    return max(ops, moved)
