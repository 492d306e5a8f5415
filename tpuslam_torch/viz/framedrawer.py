"""Current-frame overlay, the FrameDrawer analogue (port of
``tpuslam/viz/framedrawer.py``; reference FrameDrawer.cc:40-160, 260+:
tracked keypoints, state text and cuboid edges drawn on the current image).
Image in, image out, no window: the apps write the overlay to a PNG.
Tensors are read to the host first; drawing needs ``cv2``, imported when
called.
"""

from __future__ import annotations

import numpy as np
import torch

_STATE_TEXT = {0: "TRYING TO INITIALIZE", 1: "SLAM MODE", 2: "LOST"}


def host(x):
    """A tensor (on any device) or array-like as a numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def draw_frame_overlay(gray, uv, kp_valid, kp_bound=None, state: int = 1, n_kf: int = 0, n_pt: int = 0,
                       bboxes=None, corners2d=None):
    """Return a BGR uint8 overlay image, 22 rows taller than ``gray``.

    - green squares: keypoints bound to map points (FrameDrawer.cc: mvbMap)
    - blue dots: extracted but unbound keypoints
    - red wireframes: projected cuboid detections (``corners2d`` (O, 16))
    - yellow rectangles: 2D detection bboxes (``bboxes`` (O, 4) cx, cy, w, h)
    - a status bar (FrameDrawer::DrawTextInfo)
    """
    import cv2

    img = host(gray)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    out = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)

    uv = host(uv)
    kp_valid = host(kp_valid).astype(bool)
    bound = host(kp_bound).astype(bool) if kp_bound is not None else np.zeros_like(kp_valid)
    for i in np.where(kp_valid)[0]:
        x, y = int(round(float(uv[i, 0]))), int(round(float(uv[i, 1])))
        if not (0 <= x < out.shape[1] and 0 <= y < out.shape[0]):
            continue
        if bound[i]:
            cv2.rectangle(out, (x - 3, y - 3), (x + 3, y + 3), (0, 255, 0), 1)
        else:
            cv2.circle(out, (x, y), 1, (255, 80, 0), -1)

    if bboxes is not None:
        for bb in host(bboxes):
            cx, cy, w, h = [float(v) for v in bb[:4]]
            if w <= 0 or h <= 0:
                continue
            cv2.rectangle(out, (int(cx - w / 2), int(cy - h / 2)), (int(cx + w / 2), int(cy + h / 2)),
                          (0, 255, 255), 1)

    if corners2d is not None:
        edges = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4), (0, 4), (1, 5), (2, 6), (3, 7)]
        for row in host(corners2d):
            pts = row.reshape(8, 2)
            if not np.isfinite(pts).all() or np.abs(pts).max() < 1e-6:
                continue
            for a, b in edges:
                cv2.line(out, (int(pts[a, 0]), int(pts[a, 1])), (int(pts[b, 0]), int(pts[b, 1])), (0, 0, 255), 1)

    bar = np.zeros((22, out.shape[1], 3), np.uint8)
    txt = (f"{_STATE_TEXT.get(state, '?')} | KFs: {n_kf} | MPs: {n_pt} "
           f"| tracked: {int((kp_valid & bound).sum())}")
    cv2.putText(bar, txt, (4, 15), cv2.FONT_HERSHEY_PLAIN, 0.9, (255, 255, 255), 1)
    return np.concatenate([out, bar], axis=0)
