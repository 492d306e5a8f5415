"""Per-frame tracking program and the host ``Tracker`` (port of
``tpuslam/frontend/tracking.py``).

``track_image_and_decide`` is the whole tracked-frame path: ORB extraction,
the motion-model match, the reference-keyframe match, the local-map match,
motion-only pose optimization after each, and the keyframe-decision
scalars.  It makes no host sync: no ``.item()``, no data-dependent Python
branch, no boolean-mask indexing; every choice is a tensor select, so the
host can enqueue the next frame from this frame's device outputs.

``ref_kf`` is a Python int: the host owns the reference keyframe.

The frame program's functions take ``spans``, a recorder
(``utils/profiler.Spans``) that the ``Tracker`` passes and whose default
times nothing: ``frame_extract`` around the ORB extractor,
``frame_motion``, ``frame_ref`` and ``frame_localmap`` around the three
matches, and ``frame_pose_opt`` around each ``optimize_pose`` inside them.

``Tracker`` is the host state machine every app drives: monocular or
depth (RGB-D, stereo) initialization, the pipelined hot path, the stereo
entry point, keyframe insertion with close-depth densification and its
semantic step (the metric rescale, plane and cuboid association), the
local mapping step (point culling, triangulation, fusion, local BA,
keyframe culling), loop closing with its global BA, relocalization
against the keyframe database, and localization mode: a frozen map, with
relocalization and then last-frame visual odometry
(:func:`match_motion_model_vo`) when map tracking fails.

``TPUSLAM_TRACE=<path>``, read when a ``Tracker`` is built, appends the
reference's per-frame trace lines to that file: one ``fid=...`` line per
tracked frame with the scalars its keyframe decision read, a ``LOST``
line when tracking fails and a ``KF`` line before each keyframe.  The
lines are written from values already on the host.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..backend import mapping as bm
from ..backend.local_ba import run_global_ba, run_local_ba
from ..core import geometry as geo
from ..core.camera import Camera, backproject, camera_matrix, undistort_points
from ..core.config import SlamConfig
from ..graph import lm
from ..io.trajectory import se3_inv as se3_inv_np
from ..kernels import match as km
from ..kernels.orb import Features, OrbExtractor, topk_stable
from ..kernels.stereo import compute_stereo_matches
from ..map import mapstate as ms
from ..place.loop import LoopCloser
from ..place.vocab import random_vocabulary, update_kf_bow
from ..semantic import associate as sa
from ..utils.profiler import NO_SPANS, Spans
from .initializer import initialize_two_view, ransac_samples
from .relocalize import relocalize


class Frame(NamedTuple):
    uv: torch.Tensor  # (N, 2) undistorted pixels
    octave: torch.Tensor  # (N,) int32
    angle: torch.Tensor  # (N,)
    desc: torch.Tensor  # (N, 8) int32 words
    valid: torch.Tensor  # (N,) bool
    ur: torch.Tensor  # (N,) right-view u (stereo/RGBD), -1 for mono
    depth: torch.Tensor  # (N,) depth, -1 unknown


class TrackStep(NamedTuple):
    """Outputs of the per-frame tracking program."""

    T: torch.Tensor  # (4, 4) optimized pose
    kp_pt: torch.Tensor  # (N,) int32 keypoint -> map point binding
    m: ms.MapState  # map with updated found/visible counters
    # (9,) int32: [n_mm, n_rf, used_rf, n_final, n_ref_obs2, n_ref_obs3,
    # n_valid_kf, n_close_tracked, n_close_free]
    scalars: torch.Tensor
    T_ref: torch.Tensor  # (4, 4) reference-KF pose at track time
    velocity: torch.Tensor  # (4, 4) next-frame motion model T_new @ inv(T_prev)


def frame_from_features(feats: Features, cam: Camera, ur=None, depth=None) -> Frame:
    n = feats.uv.shape[0]

    def unknown():
        return torch.full((n,), -1.0, dtype=torch.float32, device=feats.uv.device)

    return Frame(
        uv=undistort_points(cam, feats.uv),
        octave=feats.octave,
        angle=feats.angle,
        desc=feats.desc,
        valid=feats.valid,
        ur=unknown() if ur is None else ur,
        depth=unknown() if depth is None else depth,
    )


def sample_depth_at_keypoints(feats_uv, depth_map, bf: float):
    """Depth lookup + virtual right coordinate per keypoint
    (Frame::ComputeStereoFromRGBD: ur = u - bf/z)."""
    H, W = depth_map.shape
    x = torch.clamp(torch.round(feats_uv[:, 0]).long(), 0, W - 1)
    y = torch.clamp(torch.round(feats_uv[:, 1]).long(), 0, H - 1)
    z = depth_map[y, x]
    ok = z > 0
    # a tensor numerator: ``number / tensor`` is a reciprocal times the number
    ur = torch.where(ok, feats_uv[:, 0] - torch.full_like(z, bf) / torch.clamp(z, min=1e-6), -1.0)
    return torch.where(ok, z, -1.0), ur


def _project(cam: Camera, pc):
    z = torch.clamp(pc[:, 2], min=1e-6)
    return torch.stack([cam.fx * pc[:, 0] / z + cam.cx, cam.fy * pc[:, 1] / z + cam.cy], dim=-1)


def _inv_sigma2(octave):
    return 1.0 / (1.2 ** (2.0 * octave.to(torch.float32)))


def _bind(n: int, tgt, values):
    """(n,) int32 bindings: -1, then ``values[i]`` at ``tgt[i]``; rows with
    ``tgt == n`` write nowhere, and where two rows hit one keypoint the
    higher row wins, as the reference's scatter does on the CPU."""
    base = torch.full((n + 1,), -1, dtype=torch.int32, device=tgt.device)
    return ms.scatter_last(base, tgt, values)[:n]


def _count(n: int, idx):
    """(n,) int32 occurrences of each index below n (index n is dropped)."""
    ones = torch.ones(idx.shape[0], dtype=torch.int32, device=idx.device)
    return torch.zeros(n + 1, dtype=torch.int32, device=idx.device).index_add(
        0, idx.long(), ones
    )[:n]


def match_motion_model(m: ms.MapState, frame: Frame, last_pt, last_angle, last_octave, T_pred,
                       cam: Camera, radius: float, spans=NO_SPANS):
    """SearchByProjection(current, last) (ORBmatcher.cc:1328-1470) + pose
    optimization -> (T_opt, kp_pt, n_inliers).  The window scales with the
    last observation's octave and candidates keep to octaves within +-1."""
    lp = torch.clamp(last_pt, min=0).long()
    has_pt = (last_pt >= 0) & m.pt_valid[lp]
    X = m.pt_pos[lp]
    pc = geo.se3_apply(T_pred, X)
    uv_pred = _project(cam, pc)
    vis = has_pt & (pc[:, 2] > 0)
    radius_row = radius * 1.2 ** last_octave.to(torch.float32)
    gate = km.window_gate(uv_pred, frame.uv, radius_row)
    gate = gate & km.octave_gate(last_octave, frame.octave, -1, 1)
    idx, _, ok = km.match_descriptors(
        m.pt_desc[lp], frame.desc, vis, frame.valid, gate_mask=gate, max_dist=100.0, ratio=0.9
    )
    ok = km.rotation_consistency(last_angle, frame.angle, idx, ok)
    with spans.span("frame_pose_opt"):
        T_opt, inl, n_in = lm.optimize_pose(
            T_pred, X, frame.uv[idx], _inv_sigma2(frame.octave[idx]), ok,
            cam.fx, cam.fy, cam.cx, cam.cy, ur=frame.ur[idx], bf=cam.bf,
        )
    N = frame.uv.shape[0]
    bound = ok & inl
    kp_pt = _bind(N, torch.where(bound, idx, N), torch.where(bound, last_pt, -1))
    return T_opt, kp_pt, n_in


def match_reference_kf(m: ms.MapState, frame: Frame, ref_kf: int, T_init, cam: Camera, spans=NO_SPANS):
    """TrackReferenceKeyFrame (Tracking.cc:988-1031): ungated descriptor
    matching against the reference KF's bound keypoints (kernel K2), then
    pose optimization -> (T_opt, kp_pt, n_inliers, n_matches)."""
    ref_pt = m.kf_pt[ref_kf]
    has_pt = (ref_pt >= 0) & m.kf_kp_valid[ref_kf]
    idx, _, ok = km.match_descriptors(
        frame.desc, m.kf_desc[ref_kf], frame.valid, has_pt, max_dist=50.0, ratio=0.7
    )
    ok = km.rotation_consistency(frame.angle, m.kf_angle[ref_kf], idx, ok)
    pt_ids = torch.where(ok, ref_pt[idx], -1)
    X = m.pt_pos[torch.clamp(pt_ids, min=0).long()]
    matched = ok & (pt_ids >= 0)
    with spans.span("frame_pose_opt"):
        T_opt, inl, n_in = lm.optimize_pose(
            T_init, X, frame.uv, _inv_sigma2(frame.octave), matched,
            cam.fx, cam.fy, cam.cx, cam.cy, ur=frame.ur, bf=cam.bf,
        )
    kp_pt = torch.where(matched & inl, pt_ids, -1)
    return T_opt, kp_pt, n_in, torch.sum(matched)


def track_local_map(m: ms.MapState, frame: Frame, kp_pt, T_init, ref_kf: int, cam: Camera,
                    n_local: int = 4096, radius: float = 6.0, n_local_kfs: int = 80, spans=NO_SPANS):
    """TrackLocalMap (Tracking.cc:1163-1208): project the covisibility-local
    point set, bind more keypoints, optimize the pose again.  The local
    keyframes are the reference KF's first-order covisible neighbours, then
    their own neighbours, capped at ``n_local_kfs``.

    Returns (T_opt, kp_pt_out, n_inliers, map_with_updated_counters)."""
    N = frame.uv.shape[0]
    P = m.pt_pos.shape[0]
    K = m.kf_pose.shape[0]
    dev = m.kf_pt.device
    obs = ms.incidence(m)
    cov = ms.covisibility_of(obs)
    w1 = torch.where(m.kf_valid, cov[ref_kf], -1.0)
    first = (w1 > 0) | (torch.arange(K, device=dev) == ref_kf)
    # second-order score: strongest covisibility link into the first-order set
    w2 = torch.max(cov * first[:, None].to(cov.dtype), dim=0).values
    w2 = torch.where(m.kf_valid & ~first, w2, -1.0)
    combined = torch.where(m.kf_valid, torch.where(w1 > 0, 1e6 + w1, w2), -1.0)
    combined = torch.where(torch.arange(K, device=dev) == ref_kf, float("inf"), combined)
    n_kfs = min(n_local_kfs, K)
    top_w, kf_top = topk_stable(combined, n_kfs)
    kf_mask = (top_w > 0) | (torch.arange(n_kfs, device=dev) == 0)
    local_mask = (torch.sum(obs[kf_top] * kf_mask[:, None], dim=0) > 0) & m.pt_valid
    sel_val, pt_ids = topk_stable(local_mask.to(torch.float32), n_local)
    pt_mask = sel_val > 0

    X = m.pt_pos[pt_ids]
    pc = geo.se3_apply(T_init, X)
    z_ok = pc[:, 2] > 0.05
    uv_proj = _project(cam, pc)
    in_img = (
        (uv_proj[:, 0] >= 0) & (uv_proj[:, 0] < cam.width)
        & (uv_proj[:, 1] >= 0) & (uv_proj[:, 1] < cam.height)
    )
    # isInFrustum scale/viewing gates (Frame::isInFrustum); points without
    # computed stats (max_dist sentinel 1e9) pass unconditionally
    C = -T_init[:3, :3].T @ T_init[:3, 3]
    po = X - C
    dist = torch.linalg.vector_norm(po, dim=-1)
    max_d = m.pt_max_dist[pt_ids]
    normal = m.pt_normal[pt_ids]
    has_band = max_d < 1e8
    in_band = (dist >= 0.8 * m.pt_min_dist[pt_ids]) & (dist <= 1.2 * max_d)
    view_cos = torch.sum(po * normal, dim=-1) / torch.clamp(dist, min=1e-9)
    has_normal = torch.linalg.vector_norm(normal, dim=-1) > 0.5
    frustum_ok = ~has_band | (in_band & (~has_normal | (view_cos > 0.5)))
    visible = pt_mask & z_ok & in_img & frustum_ok
    # already-bound map points must not be double-bound
    already = torch.zeros(P + 1, dtype=torch.bool, device=dev).index_fill(
        0, torch.where(kp_pt >= 0, kp_pt, P).long(), True
    )[:P]
    candidate = visible & ~already[pt_ids]
    kp_free = frame.valid & (kp_pt < 0)
    # predicted-octave search radius (ORBmatcher.cc:45-157): radius * s^pred,
    # candidate octaves in [pred-1, pred]
    pred_lvl = ms.predict_scale_level(dist, max_d)
    gate = km.window_gate(uv_proj, frame.uv, radius * 1.2**pred_lvl)
    gate = gate & km.octave_gate(pred_lvl.to(torch.int32), frame.octave, -1, 0)
    idx, _, ok = km.match_descriptors(
        m.pt_desc[pt_ids], frame.desc, candidate, kp_free, gate_mask=gate, max_dist=50.0, ratio=0.8
    )
    # bind new matches; the highest candidate row wins a contested keypoint
    add = _bind(N, torch.where(ok, idx, N), torch.where(ok, pt_ids, -1))
    kp_pt2 = torch.where(kp_pt >= 0, kp_pt, add)

    with spans.span("frame_pose_opt"):
        T_opt, inl, n_in = lm.optimize_pose(
            T_init, m.pt_pos[torch.clamp(kp_pt2, min=0).long()], frame.uv,
            _inv_sigma2(frame.octave), kp_pt2 >= 0, cam.fx, cam.fy, cam.cx, cam.cy,
            ur=frame.ur, bf=cam.bf,
        )
    kp_pt_out = torch.where((kp_pt2 >= 0) & inl, kp_pt2, -1)

    # found/visible counters (MapPoint::IncreaseVisible/Found)
    vis_add = _count(P, torch.where(visible, pt_ids, P))
    fnd_add = _count(P, torch.where(kp_pt_out >= 0, kp_pt_out, P))
    m = m.replace(pt_visible=m.pt_visible + vis_add, pt_found=m.pt_found + fnd_add)
    return T_opt, kp_pt_out, n_in, m


def match_motion_model_vo(last_frame: Frame, T_last, frame: Frame, T_pred, cam: Camera, radius: float):
    """Visual odometry of localization mode (tracking.py:250-283 of the
    reference; the temporal points of UpdateLastFrame, Tracking.cc:1045-1097):
    the last frame's keypoints with depth, backprojected from ``T_last``,
    matched into the frame at ``T_pred`` and a motion-only pose
    optimization.  Nothing of the map is read.  Returns (T_opt, n_inliers)."""
    has_d = last_frame.valid & (last_frame.depth > 0)
    X = geo.se3_apply(geo.se3_inv(T_last), backproject(cam, last_frame.uv, last_frame.depth))
    pc = geo.se3_apply(T_pred, X)
    vis = has_d & (pc[:, 2] > 0)
    gate = km.window_gate(_project(cam, pc), frame.uv, radius)
    idx, _, ok = km.match_descriptors(
        last_frame.desc, frame.desc, vis, frame.valid, gate_mask=gate, max_dist=100.0, ratio=0.9
    )
    ok = km.rotation_consistency(last_frame.angle, frame.angle, idx, ok)
    T_opt, _, n_in = lm.optimize_pose(
        T_pred, X, frame.uv[idx], _inv_sigma2(frame.octave[idx]), ok, cam.fx, cam.fy, cam.cx, cam.cy,
        ur=frame.ur[idx], bf=cam.bf,
    )
    return T_opt, n_in


def np_renorm(T):
    """The rotation block of a host (4, 4) pose back onto SO(3) by row-wise
    Gram-Schmidt in float64 (the reference's ``_np_renorm``, the host twin
    of ``geometry.se3_renorm``)."""
    R = np.asarray(T[:3, :3], np.float64)
    r0 = R[0] / (np.linalg.norm(R[0]) + 1e-12)
    r1 = R[1] - (r0 @ R[1]) * r0
    r1 = r1 / (np.linalg.norm(r1) + 1e-12)
    out = np.array(T, np.float32)
    out[:3, :3] = np.stack([r0, r1, np.cross(r0, r1)])
    return out


def track_and_decide(
    m: ms.MapState,
    frame: Frame,
    T_cur,
    velocity,
    last_kp_pt,
    last_angle,
    last_octave,
    ref_kf: int,
    cam: Camera,
    radius_motion: float,
    radius_localmap: float,
    min_track_motion: int,
    th_depth: float,
    n_local: int = 4096,
    n_local_kfs: int = 80,
    spans=NO_SPANS,
) -> TrackStep:
    """The whole per-frame tracking path on one frame's features: motion-model
    match + pose opt, the reference-KF match (computed unconditionally,
    selected by inlier count), the local-map track, and every scalar the
    keyframe decision (NeedNewKeyFrame, Tracking.cc:1227-1252) needs."""
    T_pred = geo.se3_renorm(velocity @ T_cur)
    with spans.span("frame_motion"):
        T_mm, kp_mm, n_mm = match_motion_model(
            m, frame, last_kp_pt, last_angle, last_octave, T_pred, cam, radius_motion, spans=spans
        )
    with spans.span("frame_ref"):
        T_rf, kp_rf, n_rf, _ = match_reference_kf(m, frame, ref_kf, T_cur, cam, spans=spans)
    used_rf = n_mm < min_track_motion
    T1 = torch.where(used_rf, T_rf, T_mm)
    kp1 = torch.where(used_rf, kp_rf, kp_mm)
    with spans.span("frame_localmap"):
        T2, kp2, n_final, m = track_local_map(
            m, frame, kp1, T1, ref_kf, cam, n_local=n_local, radius=radius_localmap,
            n_local_kfs=n_local_kfs, spans=spans,
        )

    obs_count = ms.point_obs_counts(m)
    ref_pt = m.kf_pt[ref_kf]
    ref_ok = (ref_pt >= 0) & m.kf_kp_valid[ref_kf]
    ref_obs = obs_count[torch.clamp(ref_pt, min=0).long()]
    close = frame.valid & (frame.depth > 0) & (frame.depth < th_depth)
    scalars = torch.stack(
        [
            n_mm.to(torch.int32),
            n_rf.to(torch.int32),
            used_rf.to(torch.int32),
            n_final.to(torch.int32),
            torch.sum(ref_ok & (ref_obs >= 2)).to(torch.int32),
            torch.sum(ref_ok & (ref_obs >= 3)).to(torch.int32),
            torch.sum(m.kf_valid).to(torch.int32),
            torch.sum(close & (kp2 >= 0)).to(torch.int32),
            torch.sum(close & (kp2 < 0)).to(torch.int32),
        ]
    )
    return TrackStep(
        T=T2, kp_pt=kp2, m=m, scalars=scalars, T_ref=m.kf_pose[ref_kf],
        velocity=T2 @ geo.se3_inv(T_cur),
    )


def track_image_and_decide(
    m: ms.MapState,
    gray,
    depth,
    T_cur,
    velocity,
    last_kp_pt,
    last_angle,
    last_octave,
    ref_kf: int,
    cam: Camera,
    radius_motion: float,
    radius_localmap: float,
    min_track_motion: int,
    th_depth: float,
    extractor: OrbExtractor,
    n_local: int = 4096,
    n_local_kfs: int = 80,
    has_depth: bool = False,
    spans=NO_SPANS,
):
    """:func:`track_and_decide` with ORB extraction in front: image in,
    (TrackStep, Frame) out.  ``extractor`` carries the reference's static
    ORB settings (n_features, n_levels, scale_factor, thresholds)."""
    with spans.span("frame_extract"):
        feats = extractor(gray.to(torch.float32))
    d = ur = None
    if has_depth:
        d, ur = sample_depth_at_keypoints(feats.uv, depth, cam.bf)
    frame = frame_from_features(feats, cam, ur=ur, depth=d)
    step = track_and_decide(
        m, frame, T_cur, velocity, last_kp_pt, last_angle, last_octave, ref_kf, cam,
        radius_motion, radius_localmap, min_track_motion, th_depth,
        n_local=n_local, n_local_kfs=n_local_kfs, spans=spans,
    )
    return step, frame


def _metric_scale_inputs(m: ms.MapState, kf_slot: int):
    """The bound keypoints of keyframe ``kf_slot`` and their points in its
    camera frame, for the metric-scale vote: (N,) bool, (N, 3)."""
    row = m.kf_pt[kf_slot]
    bound = (row >= 0) & m.kf_kp_valid[kf_slot]
    T = m.kf_pose[kf_slot]
    return bound, m.pt_pos[row.clamp(min=0).long()] @ T[:3, :3].T + T[:3, 3]


def match_for_init(f1: Frame, f2: Frame):
    """SearchForInitialization (ORBmatcher.cc:405): 100 px window, 0.9 ratio,
    rotation consistency.  Gated, so on the dense path."""
    gate = km.window_gate(f1.uv, f2.uv, 100.0)
    idx, _, ok = km.match_descriptors(
        f1.desc, f2.desc, f1.valid, f2.valid, gate_mask=gate, max_dist=50.0, ratio=0.9
    )
    return idx, km.rotation_consistency(f1.angle, f2.angle, idx, ok)


# ---------------------------------------------------------------------------
# Host orchestrator
# ---------------------------------------------------------------------------


class _HostCopy:
    """Device tensors copied into pinned host buffers without waiting; the
    first :meth:`get` waits on the CUDA event recorded after the copies,
    counted in ``waits`` and timed as the span ``wait_event``."""

    def __init__(self, tensors, waits: dict, spans):
        self._waits = waits
        self._spans = spans
        self._event = None
        if tensors[0].device.type == "cuda":
            self._host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            for h, t in zip(self._host, tensors):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = list(tensors)

    def get(self):
        with self._spans.span("wait_event"):
            if self._event is not None:
                self._event.synchronize()
                self._waits["event"] = self._waits.get("event", 0) + 1
                self._event = None
        return [h.numpy() for h in self._host]


class Tracker:
    """Host-side SLAM pipeline (System + Tracking + LocalMapping facade) for
    a monocular, RGB-D or stereo camera, with planes and objects.

    Each frame runs tracking; a keyframe runs the semantic step and the
    mapping step inline.  The hot path is pipelined: frame n's program is
    enqueued from frame n-1's device outputs before frame n-1's scalars are
    read back, so the only wait per tracked frame is on the previous
    frame's copy.  Entry points run on ``device`` (``cuda:0`` unless the
    caller asks for the CPU).  Every feature flag is accepted;
    ``associate_point_with_object`` and ``build_worldframe_on_ground`` are
    read nowhere, as in the reference.  With ``enable_loop_closing`` (the
    default) every keyframe gets its BoW row, the loop closer runs after
    each keyframe's mapping, and a LOST tracker with more than 5 keyframes
    relocalizes against the keyframe database; a map restored from a
    checkpoint (``io/checkpoint.load_tracker`` sets ``_resumed``) is never
    reset by the tiny-map rule.  :meth:`set_localization_mode` freezes the
    map."""

    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2

    def __init__(self, cam: Camera, cfg: SlamConfig, device="cuda:0", vocab=None):
        """``vocab``: the place-recognition codebook (``place/vocab.py``), a
        trained one or None for the seeded one; its word count must equal
        ``cfg.caps.vocab_words`` (the width of the map's BoW rows)."""
        if cfg.sensor not in ("mono", "rgbd", "stereo"):
            raise ValueError(f"sensor {cfg.sensor!r}: one of mono, rgbd, stereo")
        if vocab is not None and vocab.n_words != cfg.caps.vocab_words:
            raise ValueError(f"vocabulary has {vocab.n_words} words but caps.vocab_words={cfg.caps.vocab_words}; "
                             "adjust caps to match")
        self.device = torch.device(device)
        if cam.dist.device != self.device:
            cam = dataclasses.replace(cam, dist=cam.dist.to(self.device))
        self.cam = cam
        self.cfg = cfg
        self.K = camera_matrix(cam)
        self.extractor = self._extractor(cam.height, cam.width)
        self.map = ms.empty_map(cfg.caps, self.device)
        self.loop_closer = None
        if cfg.flags.enable_loop_closing:
            vocab = vocab or random_vocabulary(cfg.caps.vocab_words, device=self.device)
            self.loop_closer = LoopCloser(vocab, cam, cfg)
        self.state = self.NOT_INITIALIZED
        self.n_kf = 0
        self.n_pt = 0  # point-slot high-water mark (slots below it may be free)
        self._free_slots = np.empty(0, np.int64)
        self._alloc_pending = None  # (host copy of the consumed count, avail)
        self._pt_valid_snap = None  # host copy of pt_valid for the freelist
        self.dbg = {}
        self._trace_path = os.environ.get("TPUSLAM_TRACE", "")  # per-frame trace file
        self.kf_decisions = []  # (frame id, the scalars NeedNewKeyFrame read, made)
        # cumulative host wall ms per stage: the frame program's frame_*, the
        # host's waits wait_*, the keyframe chain's kf_* and map_*
        self.stage_ms = {}
        self.spans = Spans(self.stage_ms)
        self.waits = {}  # explicit host waits on the device, by kind
        self.velocity = np.eye(4, dtype=np.float32)
        self.T_cur = np.eye(4, dtype=np.float32)
        self.last_frame: Optional[Frame] = None
        self.last_kp_pt = None
        self.init_frame: Optional[Frame] = None
        self.init_frame_id = -1
        self.ref_kf = 0
        self.frames_since_kf = 0
        self._kf_fids: list = []  # frame ids of every keyframe created
        self.trajectory: list = []  # (frame_id, Tcw)
        self.traj_rel: dict = {}  # fid -> (ref slot, ref fid, T_frame @ inv(T_ref))
        self._kf_slot_fid: dict = {}
        self.n_inliers = 0
        self.n_loops = 0  # loop closures accepted
        self.n_relocalized = 0  # frames placed by relocalization (LOST, or localization mode's fallback)
        self.n_vo = 0  # frames placed by localization mode's visual odometry
        self._resumed = False  # set by io.checkpoint.load_tracker
        self.localization_only = False
        self.n_plane = 0
        self.n_cub = 0
        self._metric_anchored = False  # the mono map was rescaled onto metric planes
        self.n_rescales = 0  # metric rescales applied
        self.ba_factors = {}  # valid factors per bundle summed over the local BAs (device scalars)
        self.stereo_matches = []  # left keypoints with a stereo match, per stereo pair (device scalars)
        self._pending_plane_det = None
        self._pending_cuboid_det = None
        self._pending = None  # the in-flight frame of the hot path
        self._dev_T = None
        self._dev_vel = None
        # set when a keyframe chain advanced self.map past the in-flight
        # program's snapshot: that program's counter-updated map is dropped
        self._map_fork = False

    # -- device <-> host ------------------------------------------------------

    def _upload(self, a):
        """A small host array to the device, from pinned memory, without a wait."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def _copy_to_host(self, tensors):
        return _HostCopy(tensors, self.waits, self.spans)

    def _sync_read(self, t):
        """A read the host must wait for (initialization, slot reuse),
        timed as the span ``wait_read``."""
        with self.spans.span("wait_read"):
            if self.device.type == "cuda":
                self.waits["read"] = self.waits.get("read", 0) + 1
            return t.cpu().numpy()

    # -- public API -----------------------------------------------------------

    def set_localization_mode(self, on: bool):
        """System::ActivateLocalizationMode / DeactivateLocalizationMode
        (System.cc:118-133, 245-277; tracking.py:568-576 of the reference).
        When on, the map is frozen: no keyframe, no mapping, no loop step.
        A frame that map tracking loses is relocalized against the map, then,
        for RGB-D and stereo, tracked by last-frame visual odometry
        (:meth:`_localization_fallback`).  As in the reference (and
        Tracking::TrackLocalMap), a tracked frame still commits its points'
        found/visible counters, ``pt_found`` and ``pt_visible``; every other
        map field stays as it was."""
        self.flush()
        self.localization_only = bool(on)

    def _check_feature_caps(self):
        if self.cfg.orb.n_features != self.cfg.caps.max_keypoints:
            raise ValueError(
                f"cfg.orb.n_features ({self.cfg.orb.n_features}) must equal "
                f"cfg.caps.max_keypoints ({self.cfg.caps.max_keypoints}): the "
                "map's per-keyframe arrays are padded to max_keypoints"
            )

    def _extractor(self, height: int, width: int) -> OrbExtractor:
        o = self.cfg.orb
        return OrbExtractor(height, width, self.device, n_features=o.n_features, n_levels=o.n_levels,
                            scale_factor=o.scale_factor, ini_th=o.ini_th_fast, min_th=o.min_th_fast)

    def _fit_extractor(self, img) -> None:
        """Rebuild the extractor for an image of another size than the
        camera's (the stream node's camera comes from flags): the
        reference's jitted extractor follows the image's shape."""
        h, w = img.shape[-2:]
        if (h, w) != (self.extractor.height, self.extractor.width):
            self.extractor = self._extractor(h, w)

    def _to_device(self, img):
        t = img if isinstance(img, torch.Tensor) else torch.from_numpy(np.asarray(img))
        return t.to(self.device, non_blocking=True)

    def process_image(self, gray, frame_id: int, depth=None, plane_det=None, cuboid_det=None):
        """Track one grayscale image (uint8 or float, numpy or tensor), with
        its (H, W) depth in metres for RGB-D.  ``plane_det`` /
        ``cuboid_det``: this frame's detections (``semantic/detect.py``),
        used if it becomes a keyframe.  Returns the pose of the frame
        resolved in this call: in the pipelined state that is the previous
        frame's, else this frame's."""
        self._check_feature_caps()
        g = self._to_device(gray)
        self._fit_extractor(g)
        d = None if depth is None else self._to_device(depth).to(torch.float32)
        if self.state == self.OK:
            cfg = self.cfg
            tc = cfg.tracking
            th_depth = cfg.depth_threshold * self.cam.bf / max(self.cam.fx, 1e-6)
            out, frame = track_image_and_decide(
                self.map, g, d,
                self._dev_T if self._dev_T is not None else self._upload(self.T_cur),
                self._dev_vel if self._dev_vel is not None else self._upload(self.velocity),
                self.last_kp_pt, self.last_frame.angle, self.last_frame.octave,
                self.ref_kf, self.cam, tc.search_radius_motion, tc.search_radius_localmap,
                tc.min_track_motion, th_depth, self.extractor,
                n_local=cfg.caps.local_ba_points, n_local_kfs=tc.max_local_keyframes, has_depth=d is not None,
                spans=self.spans,
            )
            fetch = self._copy_to_host((out.scalars, out.T, out.T_ref))
            loops_before = self.n_loops
            ref_at_dispatch = self.ref_kf  # out.T_ref is this slot's pose
            prev_pose = self._finish_pending()
            if self.state == self.OK and self.n_loops == loops_before:
                self._pending = (frame_id, out, frame, plane_det, cuboid_det, ref_at_dispatch, fetch)
                self._dev_T = out.T
                self._dev_vel = out.velocity
                self.last_kp_pt = out.kp_pt
                self.last_frame = frame
            # else LOST, or a loop closure re-based the map under the frame in
            # flight: its outputs are in the old frame, so it is dropped.  As
            # in the reference (tracking.py:636-648), _dev_T and _dev_vel are
            # not cleared: the next frame starts from the stale pose, a
            # reference fault the port mirrors
            return prev_pose
        self.flush()
        feats = self.extractor(g.to(torch.float32))
        z = ur = None
        if d is not None:
            z, ur = sample_depth_at_keypoints(feats.uv, d, self.cam.bf)
        return self.process_frame(frame_from_features(feats, self.cam, ur=ur, depth=z), frame_id, plane_det,
                                  cuboid_det)

    def process_stereo_pair(self, gray_l, gray_r, frame_id: int, plane_det=None, cuboid_det=None):
        """Stereo entry point (System::TrackStereo, tracking.py:657-680 of the
        reference): ORB on both images, the left-right match
        (``kernels/stereo.py``) for each left keypoint's right coordinate and
        depth, then the synchronous tracking path."""
        self.flush()
        self._check_feature_caps()
        gl = self._to_device(gray_l).to(torch.float32)
        gr = self._to_device(gray_r).to(torch.float32)
        self._fit_extractor(gl)
        fl, fr = self.extractor(gl), self.extractor(gr)
        ur, depth, ok = compute_stereo_matches(gl, gr, fl.uv, fl.octave, fl.desc, fl.valid, fr.uv, fr.octave,
                                               fr.desc, fr.valid, bf=self.cam.bf, fx=self.cam.fx)
        self.stereo_matches.append(ok.sum())
        frame = frame_from_features(fl, self.cam, ur=ur, depth=depth)
        return self.process_frame(frame, frame_id, plane_det, cuboid_det)

    def process_frame(self, frame: Frame, frame_id: int, plane_det=None, cuboid_det=None):
        """Track one frame's features synchronously (no pipelining)."""
        self._pending_plane_det = plane_det
        self._pending_cuboid_det = cuboid_det
        if self.state == self.NOT_INITIALIZED:
            self._initialize(frame, frame_id)
        elif self.state == self.LOST:
            self._relocalize(frame, frame_id)
        else:
            self._track(frame, frame_id)
        if self.state == self.OK:
            self.trajectory.append((frame_id, np.array(self.T_cur)))
        return np.array(self.T_cur) if self.state == self.OK else None

    def flush(self):
        """Resolve the in-flight frame, if any; call before reading state."""
        return self._finish_pending()

    # -- initialization -------------------------------------------------------

    def _initialize(self, frame: Frame, frame_id: int):
        if self.cfg.sensor in ("rgbd", "stereo"):
            self._depth_initialization(frame, frame_id)
        else:
            self._monocular_initialization(frame, frame_id)

    def _depth_initialization(self, frame: Frame, frame_id: int):
        """StereoInitialization (Tracking.cc:657-700, tracking.py:802-838 of
        the reference): one keyframe, its points backprojected from depth;
        the map is metric from the start."""
        good = frame.valid & (frame.depth > 0)
        n_new = int(self._sync_read(good.sum()))
        if n_new < 100:  # Tracking.cc:661 asks for > 500 features; relaxed
            return
        dev = self.device
        N = frame.uv.shape[0]
        slots = torch.where(good, torch.cumsum(good.to(torch.int32), 0) - 1 + self.n_pt, 0).to(torch.int32)
        self.map = ms.add_points(
            self.map, slots, backproject(self.cam, frame.uv, frame.depth), frame.desc,
            torch.zeros((N, 3), device=dev), torch.zeros(N, device=dev), torch.full((N,), 1e9, device=dev),
            torch.zeros(N, dtype=torch.int32, device=dev), good,
            first_fid=torch.full((N,), frame_id, dtype=torch.int32, device=dev),
        )
        pt_of_kp = torch.where(good, slots, -1).to(torch.int32)
        self.map = ms.add_keyframe(
            self.map, 0, torch.eye(4, device=dev), frame_id, frame.uv, frame.octave, frame.angle, frame.desc,
            frame.valid, pt_of_kp, frame.ur, frame.depth,
        )
        self.n_kf = 1
        self.n_pt += n_new
        self._kf_fids.append(frame_id)
        self._kf_slot_fid[0] = frame_id
        self._update_bow(0)
        self.map = ms.update_point_stats(self.map)
        self.T_cur = np.eye(4, dtype=np.float32)
        self.velocity = np.eye(4, dtype=np.float32)
        self.last_frame = frame
        self.last_kp_pt = pt_of_kp
        self.ref_kf = 0
        self.frames_since_kf = 0
        self.state = self.OK

    def _update_bow(self, kf_slot: int):
        """The BoW row of a keyframe made outside the loop closer (the
        initialization keyframes): relocalization scores against every
        keyframe's row (KeyFrame::ComputeBoW)."""
        if self.loop_closer is not None:
            self.map, _ = update_kf_bow(self.loop_closer.vocab, self.map, kf_slot)

    def _ransac_samples(self, valid, frame_id: int):
        """The (200, 8) RANSAC samples of one attempt, the reference's draw
        keyed by ``PRNGKey(frame_id)`` (a fixed seed would replay one
        unlucky draw on every attempt)."""
        return ransac_samples(valid, frame_id)

    def _monocular_initialization(self, frame: Frame, frame_id: int):
        cfg = self.cfg
        n_valid = int(self._sync_read(frame.valid.sum()))
        if self.init_frame is None or n_valid < cfg.tracking.min_init_matches:
            if n_valid >= cfg.tracking.min_init_matches:
                self.init_frame = frame
                self.init_frame_id = frame_id
            return
        idx, ok = match_for_init(self.init_frame, frame)
        if int(self._sync_read(ok.sum())) < cfg.tracking.min_init_matches:
            self.init_frame = frame  # restart (Tracking.cc:755-773)
            self.init_frame_id = frame_id
            return
        res = initialize_two_view(
            self.init_frame.uv, frame.uv[idx], ok, self.K, self._ransac_samples(ok, frame_id)
        )
        if not bool(self._sync_read(res.ok)):
            return
        # scale so the median scene depth is 1 (Tracking.cc:861-906)
        good = res.good
        med = float(self._sync_read(ms.nanmedian(torch.where(good, res.points[:, 2], float("nan")))))
        n_new = int(self._sync_read(good.sum()))
        if not np.isfinite(med) or med <= 0 or n_new < 80:
            return
        scale = cfg.tracking.init_median_depth / med
        pts = res.points * scale
        T2 = res.T_21.clone()
        T2[:3, 3] *= scale
        dev = self.device
        N = frame.uv.shape[0]
        slots = torch.where(good, torch.cumsum(good.to(torch.int32), 0) - 1 + self.n_pt, 0).to(torch.int32)
        self.map = ms.add_points(
            self.map, slots, pts, frame.desc[idx], torch.zeros((N, 3), device=dev),
            torch.zeros(N, device=dev), torch.full((N,), 1e9, device=dev),
            torch.zeros(N, dtype=torch.int32, device=dev), good,
            first_fid=torch.full((N,), frame_id, dtype=torch.int32, device=dev),
        )
        pt_of_kp1 = torch.where(good, slots, -1).to(torch.int32)
        # frame-2 bindings through the match: two frame-1 keypoints matched to
        # one frame-2 keypoint leave the higher one's point (tracking.py:769-773)
        pt_of_kp2 = ms.scatter_last(
            torch.full((N + 1,), -1, dtype=torch.int32, device=dev),
            torch.where(good, idx, N), torch.where(good, slots, -1),
        )[:N]
        f1 = self.init_frame
        self.map = ms.add_keyframe(
            self.map, 0, torch.eye(4, device=dev), self.init_frame_id, f1.uv, f1.octave, f1.angle,
            f1.desc, f1.valid, pt_of_kp1, f1.ur, f1.depth,
        )
        self.map = ms.add_keyframe(
            self.map, 1, T2, frame_id, frame.uv, frame.octave, frame.angle, frame.desc, frame.valid,
            pt_of_kp2, frame.ur, frame.depth,
        )
        self.n_kf = 2
        self.n_pt += n_new
        self._kf_fids += [self.init_frame_id, frame_id]
        self._kf_slot_fid[0] = self.init_frame_id
        self._kf_slot_fid[1] = frame_id
        self._update_bow(0)
        self._update_bow(1)
        self.map = ms.update_point_stats(self.map)
        self.map, _ = run_local_ba(self.map, 1, self.cam, self.cfg)
        self.T_cur = self._sync_read(self.map.kf_pose[1])
        self.velocity = np.eye(4, dtype=np.float32)
        self.last_frame = frame
        self.last_kp_pt = pt_of_kp2
        self.ref_kf = 1
        self.frames_since_kf = 0
        self.state = self.OK

    # -- tracking -------------------------------------------------------------

    def _finish_pending(self):
        """Read back and commit the in-flight frame: the delayed half of the
        pipelined hot path.  Returns the committed pose or None."""
        if self._pending is None:
            return None
        frame_id, out, frame, plane_det, cuboid_det, ref_at_dispatch, fetch = self._pending
        self._pending = None
        scalars_np, T_np, T_ref_np = fetch.get()
        self._pending_plane_det = plane_det
        self._pending_cuboid_det = cuboid_det
        return self._commit(frame_id, out, frame, ref_at_dispatch, scalars_np, T_np, T_ref_np,
                            pipelined=True)

    def _commit(self, frame_id, out, frame, ref_slot, scalars_np, T_np, T_ref_np, pipelined):
        cfg = self.cfg
        n_mm, n_rf, used_rf, n_final, n_ref2, n_ref3, n_valid_kf, n_close_tr, n_close_free = (
            int(x) for x in scalars_np)
        self.dbg.update(n_mm=n_mm, n_rf=n_rf, used_rf=bool(used_rf))
        self._trace(f"fid={frame_id} n_mm={n_mm} n_rf={n_rf} used_rf={used_rf} n_final={n_final} n_ref2={n_ref2} "
                    f"n_ref3={n_ref3} n_valid_kf={n_valid_kf} since_kf={self.frames_since_kf}")
        ref_fid = self._kf_slot_fid.get(ref_slot, -1)
        if ref_fid >= 0 and np.isfinite(T_ref_np).all():
            self.traj_rel[frame_id] = (ref_slot, ref_fid, T_np @ se3_inv_np(T_ref_np))
        rf_lost = used_rf and n_rf < cfg.tracking.min_track_ref
        lost = rf_lost or n_final < cfg.tracking.min_track_localmap
        # the pipelined commit (tracking.py:910-917 of the reference) tries
        # localization mode's fallback on either failure, the synchronous
        # one (:997-1003) on the reference-keyframe failure only.  A
        # pipelined frame the fallback places does not feed the device
        # chain: the next frame was dispatched from this one's failed pose
        # (the reference's fault, mirrored; ROADMAP section 3)
        if lost and self.localization_only and (pipelined or rf_lost) and self._localization_fallback(
                frame, np_renorm(self.velocity @ self.T_cur)):
            if pipelined:
                self.trajectory.append((int(frame_id), np.array(self.T_cur)))
            return np.array(self.T_cur)
        if lost:
            # the reference's pipelined commit writes one LOST line, its
            # synchronous _track one per failed test (tracking.py:917, 1002, 1009)
            self._trace(f"  LOST fid={frame_id} (n_rf={n_rf} n_final={n_final})" if pipelined else
                        f"  LOST fid={frame_id} (motion+ref: n_rf={n_rf})" if rf_lost else
                        f"  LOST fid={frame_id} (localmap: n_final={n_final})")
            self.state = self.LOST
            self._dev_T = self._dev_vel = None
            self._map_fork = False
            return None
        self.n_inliers = n_final
        if not self._map_fork:  # the tracked frame's found/visible counters, localization mode too
            self.map = out.m
        self._map_fork = False
        self.velocity = T_np @ se3_inv_np(self.T_cur)
        self.T_cur = T_np
        if not pipelined:
            self.last_frame = frame
            self.last_kp_pt = out.kp_pt
        self.frames_since_kf += 1
        if self.localization_only:  # a frozen map: no keyframe decision
            if pipelined:
                self.trajectory.append((int(frame_id), np.array(self.T_cur)))
            return np.array(self.T_cur)
        since = self.frames_since_kf
        make = self._need_new_keyframe(n_final, n_ref2, n_ref3, n_valid_kf, n_close_tr, n_close_free)
        self.kf_decisions.append((frame_id, dict(n_in=n_final, n_ref=self.dbg.get("n_ref"),
                                                  n_valid_kf=n_valid_kf, since_kf=since), make))
        if make:
            self._trace(f"  KF fid={frame_id} c1a={self.dbg.get('c1a')} c2={self.dbg.get('c2')} "
                        f"n_ref={self.dbg.get('n_ref')}")
            self._create_keyframe(frame, frame_id, out.kp_pt, out.T)
            self._map_fork = pipelined
        if pipelined:
            self.trajectory.append((int(frame_id), np.array(self.T_cur)))
        return np.array(self.T_cur)

    def _trace(self, line: str) -> None:
        """Append one line to the ``TPUSLAM_TRACE`` file, if one was named."""
        if self._trace_path:
            with open(self._trace_path, "a") as f:
                f.write(line + "\n")

    def _track(self, frame: Frame, frame_id: int):
        """Synchronous tracking of one frame's features (process_frame)."""
        cfg = self.cfg
        tc = cfg.tracking
        th_depth = cfg.depth_threshold * self.cam.bf / max(self.cam.fx, 1e-6)
        out = track_and_decide(
            self.map, frame, self._upload(self.T_cur), self._upload(self.velocity),
            self.last_kp_pt, self.last_frame.angle, self.last_frame.octave, self.ref_kf, self.cam,
            tc.search_radius_motion, tc.search_radius_localmap, tc.min_track_motion, th_depth,
            n_local=cfg.caps.local_ba_points, n_local_kfs=tc.max_local_keyframes, spans=self.spans,
        )
        scalars_np, T_np, T_ref_np = self._copy_to_host((out.scalars, out.T, out.T_ref)).get()
        self._commit(frame_id, out, frame, self.ref_kf, scalars_np, T_np, T_ref_np, pipelined=False)

    def _localization_fallback(self, frame: Frame, T_pred) -> bool:
        """Localization mode's recovery when map tracking fails
        (mbOnlyTracking, Tracking.cc:515-560; tracking.py:1032-1074 of the
        reference): relocalization against the map first, then, for RGB-D
        and stereo, last-frame visual odometry from ``T_pred`` (host).
        Returns True if the frame was placed (the state stays OK)."""
        if self.loop_closer is not None:
            res = relocalize(self.map, frame, self.cam, self.loop_closer.vocab, self.cfg, self.n_kf,
                             fetch=self._fetch)
            if res is not None:
                T_opt, kp_pt, n_in = res
                T_opt = self._fetch((T_opt,))[0]
                self.velocity = T_opt @ se3_inv_np(self.T_cur)
                self.T_cur = T_opt
                self.last_frame = frame
                self.last_kp_pt = kp_pt
                self.n_inliers = n_in
                self.frames_since_kf += 1
                self.n_relocalized += 1
                return True
        if self.cfg.sensor in ("rgbd", "stereo"):
            T_vo, n_vo = match_motion_model_vo(self.last_frame, self._upload(self.T_cur), frame,
                                               self._upload(T_pred), self.cam,
                                               self.cfg.tracking.search_radius_motion)
            T_vo, n_vo = self._fetch((T_vo, n_vo))
            if int(n_vo) >= self.cfg.tracking.min_track_motion:
                self.velocity = T_vo @ se3_inv_np(self.T_cur)
                self.T_cur = T_vo
                self.last_frame = frame
                # the bindings were made under a rejected pose: cleared, so
                # the next frame tries the map again
                self.last_kp_pt = torch.full((frame.uv.shape[0],), -1, dtype=torch.int32, device=self.device)
                self.n_inliers = int(n_vo)
                self.frames_since_kf += 1
                self.n_vo += 1
                return True
        return False

    def _relocalize(self, frame: Frame, frame_id: int):
        """LOST: a map of at most 5 keyframes is reset and initialization
        starts again (Tracking.cc:620-628), from this frame's depth for the
        depth sensors, unless the map was restored from a checkpoint (the
        rule targets failed bootstraps, not restored maps); a larger map
        relocalizes against the keyframe database when loop closing is on
        (Tracking.cc:1663-1824), its PnP samples the reference's draw
        keyed by the candidate slot."""
        if self.n_kf <= 5 and not self._resumed:
            self._reset()
            self._initialize(frame, frame_id)
            return
        if self.loop_closer is None:
            return
        res = relocalize(self.map, frame, self.cam, self.loop_closer.vocab, self.cfg, self.n_kf, fetch=self._fetch)
        if res is None:
            return
        T_opt, kp_pt, n_in = res
        self.T_cur = self._fetch((T_opt,))[0]
        self.velocity = np.eye(4, dtype=np.float32)
        self.last_frame = frame
        self.last_kp_pt = kp_pt
        self.n_inliers = n_in
        self.state = self.OK
        self.n_relocalized += 1

    def _reset(self):
        """System::Reset: a new map lives in a new frame, so the trajectory
        records are cleared too."""
        self.map = ms.empty_map(self.cfg.caps, self.device)
        self.state = self.NOT_INITIALIZED
        self.n_kf = 0
        self.n_pt = 0
        self.n_plane = 0
        self.n_cub = 0
        self._metric_anchored = False
        self._free_slots = np.empty(0, np.int64)
        self._alloc_pending = None
        self._pt_valid_snap = None
        self.velocity = np.eye(4, dtype=np.float32)
        self.init_frame = None
        self.ref_kf = 0
        self._kf_fids = []
        self.trajectory = []
        self.traj_rel = {}
        self._kf_slot_fid = {}
        self._pending = None
        self._dev_T = self._dev_vel = None
        self._map_fork = False
        if self.loop_closer is not None:
            lc = self.loop_closer
            lc.prev_groups = []
            lc.last_loop_fid = -1000
            lc.kf_seen = 0
            lc.last_loop_kf_seen = -1000

    # -- point-slot allocation ----------------------------------------------
    #
    # The host keeps a candidate list (culled slots first, then fresh) built
    # from a pt_valid snapshot copied back without waiting at the end of each
    # mapping step.  An allocation uploads a slice of the list; the device
    # assigns slots by lane rank; the consumed count comes back the same way
    # and is read before the next allocation.

    def _resolve_pending_alloc(self):
        if self._alloc_pending is not None:
            fetch, avail_np = self._alloc_pending
            n = int(fetch.get()[0])
            if n > 0:
                consumed = avail_np[:n]
                self.n_pt = max(self.n_pt, int(consumed.max()) + 1)
                self._free_slots = self._free_slots[
                    ~np.isin(self._free_slots, consumed, assume_unique=True)
                ]
            self._alloc_pending = None
        if self._pt_valid_snap is not None:
            snap = self._pt_valid_snap.get()[0]
            self._free_slots = np.flatnonzero(~snap[: self.n_pt])
            self._pt_valid_snap = None

    def _alloc_begin(self, n_lanes: int):
        """``n_lanes`` candidate slots on the device (padded with the
        out-of-range sentinel, whose lanes drop their writes) and their host
        copy."""
        self._resolve_pending_alloc()
        cap = self.cfg.caps.max_points
        avail = np.concatenate([self._free_slots, np.arange(self.n_pt, cap)])[:n_lanes]
        avail_np = np.full(n_lanes, cap, np.int32)
        avail_np[: len(avail)] = avail
        return self._upload(avail_np), avail_np

    def _alloc_end(self, n_dev, avail_np):
        self._alloc_pending = (self._copy_to_host((n_dev,)), avail_np)

    def _snapshot_free_slots(self):
        self._pt_valid_snap = self._copy_to_host((self.map.pt_valid,))

    def _alloc_point_slots(self, good):
        """Synchronous allocation (tracking.py:1197-1222 of the reference):
        slots for the ``good`` lanes, culled ones first, from the mask and
        ``pt_valid`` read in one copy.  Returns (slots (N,) int32, lanes
        given a slot (N,) bool, their number)."""
        N = good.shape[0]
        good_np, valid_np = self._fetch((good, self.map.pt_valid))
        n_req = int(good_np.sum())
        none = (torch.zeros(N, dtype=torch.int32, device=self.device),
                torch.zeros(N, dtype=torch.bool, device=self.device), 0)
        if n_req == 0:
            return none
        self._resolve_pending_alloc()
        self._free_slots = np.flatnonzero(~valid_np[: self.n_pt])
        avail = np.concatenate([self._free_slots, np.arange(self.n_pt, self.cfg.caps.max_points)])[:n_req]
        n_alloc = len(avail)
        if n_alloc == 0:
            return none
        rank = np.cumsum(good_np) - 1
        lane_ok = good_np & (rank < n_alloc)
        slot_np = np.zeros(N, np.int32)
        slot_np[lane_ok] = avail[rank[lane_ok]]
        self.n_pt = max(self.n_pt, int(avail.max()) + 1)
        self._free_slots = self._free_slots[~np.isin(self._free_slots, avail, assume_unique=True)]
        return self._upload(slot_np), self._upload(lane_ok), n_alloc

    def live_points(self) -> int:
        """Number of valid map points (``n_pt`` is only the slot high-water
        mark once culled slots are reused)."""
        return int(self._sync_read(self.map.pt_valid.sum()))

    # -- keyframes -------------------------------------------------------------

    def _need_new_keyframe(self, n_in: int, n_ref2: int, n_ref3: int, n_valid_kf: int, n_close_tracked: int,
                           n_close_free: int) -> bool:
        """Tracking::NeedNewKeyFrame (Tracking.cc:1211-1295, tracking.py:
        1229-1277 of the reference), from the scalars the tracking program
        computed.  Mapping runs inline, so the decision is c2 (gated by the
        modelled mapping-busy window) or the cadence cap c1a.  The depth
        sensors add the close-point rule (fewer than 100 close points
        tracked and more than 70 untracked) and ask for 0.75 of the
        reference keyframe's points where mono asks for 0.9."""
        cfg = self.cfg
        if self.n_kf >= cfg.caps.max_keyframes - 1 and self.n_kf - n_valid_kf <= 0:
            return False
        min_obs = 2 if n_valid_kf <= 4 else 3
        n_ref = n_ref2 if min_obs == 2 else n_ref3
        depth = cfg.sensor in ("rgbd", "stereo")
        need_close = depth and n_close_tracked < 100 and n_close_free > 70
        th_ref = 0.4 if n_valid_kf < 2 else 0.75 if depth else 0.9
        c1a = self.frames_since_kf >= cfg.tracking.max_frames_between_kf
        c1b = self.frames_since_kf >= cfg.tracking.mapping_busy_frames
        c2 = (n_in < th_ref * n_ref or need_close) and n_in > 15 and c1b
        self.dbg.update(n_ref=n_ref, n_in=n_in, min_obs=min_obs, n_valid_kf=n_valid_kf, c1a=c1a, c2=c2)
        return bool(c1a or c2)

    def _alloc_kf_slot(self):
        """Fresh slots first, then the stalest culled slot (never slot 0, the
        BA gauge).  None when every slot holds a valid keyframe."""
        if self.n_kf < self.cfg.caps.max_keyframes - 1:
            slot = self.n_kf
            self.n_kf += 1
            return slot
        valid = self._sync_read(self.map.kf_valid[: self.n_kf])
        free = np.flatnonzero(~valid)
        free = free[free > 0]
        if len(free) == 0:
            return None
        fids = self._sync_read(self.map.kf_frame_id[: self.n_kf])
        return int(free[np.argmin(fids[free])])

    def _create_keyframe(self, frame: Frame, frame_id: int, kp_pt, T_dev=None):
        with self.spans.laps("kf_add") as lap:
            slot = self._alloc_kf_slot()
            if slot is None:
                return
            T = T_dev if T_dev is not None else self._upload(self.T_cur)
            self.map = ms.add_keyframe(
                self.map, slot, T, frame_id, frame.uv, frame.octave, frame.angle, frame.desc,
                frame.valid, kp_pt, frame.ur, frame.depth,
            )
            self.ref_kf = slot
            self.frames_since_kf = 0
            self._kf_fids.append(frame_id)
            self._kf_slot_fid[slot] = frame_id
            if self.cfg.sensor in ("rgbd", "stereo"):
                self._create_depth_points(slot, frame, frame_id, T)
            lap.next("kf_semantic")
            self._semantic_step(slot, kp_pt)
            lap.next("kf_mapping")
            self._local_mapping_step(slot, frame_id)
            closed = False
            if self.loop_closer is not None:
                lap.next("kf_loop")
                self.map, closed = self.loop_closer.on_keyframe(self.map, slot, self.n_kf, frame_id=frame_id,
                                                                fetch=self._fetch)
            lap.end()
        if closed:
            self._after_loop_closure(slot)
        self.last_kp_pt = self.map.kf_pt[slot]

    def _after_loop_closure(self, slot: int):
        """The global BA after a closure (tracking.py:1335-1363 of the
        reference), under ``cfg.ba.gba_time_budget_s`` when that is set.
        Its result is refused when it leaves fewer than half the live
        points: a global BA fed an imprecise weld can flag most observations
        as outliers, and the <= 2-observation kill then cascades (1011 -> 1
        live points measured on a golden-loop closure); the essential
        graph's map is kept instead."""
        self.n_loops += 1
        budget = self.cfg.ba.gba_time_budget_s
        abort = None
        if budget > 0:
            t0 = time.perf_counter()

            def abort():
                return time.perf_counter() - t0 > budget
        pre_live = self.live_points()
        post_map, _ = run_global_ba(self.map, self.cam, self.cfg, n_kf=self.n_kf, should_abort=abort,
                                    fetch=self._fetch)
        post_live = int(self._fetch((post_map.pt_valid.sum(),))[0])
        if post_live >= 0.5 * pre_live:
            self.map = post_map
        else:
            self.dbg["gba_rejected"] = (pre_live, post_live)
        self.T_cur = self._fetch((self.map.kf_pose[slot],))[0]
        self.velocity = np.eye(4, dtype=np.float32)

    def _create_depth_points(self, kf_slot: int, frame: Frame, frame_id: int, T):
        """Close-depth points for the keyframe's unbound keypoints
        (Tracking.cc:1395-1455, tracking.py:840-875 of the reference): every
        one closer than the depth threshold, and the 100 closest in any
        case.  Depth ties are ranked by a stable sort, as ``jnp.argsort``
        does.  ``T``: the keyframe's world->camera pose on the device."""
        th_depth = self.cfg.depth_threshold * self.cam.bf / self.cam.fx
        cand = frame.valid & (frame.depth > 0)
        order = torch.argsort(torch.where(cand, frame.depth, float("inf")), stable=True)
        N = order.shape[0]
        rank = torch.empty_like(order).scatter_(0, order, torch.arange(N, device=order.device))
        keep = cand & ((frame.depth < th_depth) | (rank < 100))
        slots, free, n_new = self._alloc_point_slots(keep & (self.map.kf_pt[kf_slot] < 0))
        if n_new == 0:
            return
        dev = self.device
        pts_w = geo.se3_apply(geo.se3_inv(T), backproject(self.cam, frame.uv, frame.depth))
        self.map = ms.add_points(
            self.map, slots, pts_w, frame.desc, torch.zeros((N, 3), device=dev), torch.zeros(N, device=dev),
            torch.full((N,), 1e9, device=dev), torch.full((N,), kf_slot, dtype=torch.int32, device=dev), free,
            first_fid=torch.full((N,), frame_id, dtype=torch.int32, device=dev),
        )
        self.map = ms.assign_observations(self.map, kf_slot, torch.arange(N, dtype=torch.int32, device=dev),
                                          slots, free)

    def _fetch(self, tensors):
        """Read device tensors in one pinned copy behind one CUDA event."""
        return self._copy_to_host(tensors).get()

    def _semantic_step(self, kf_slot: int, kp_pt):
        """DetectPlane / AssociatePlanes and DetectCuboid / AssociateCuboids
        at keyframe creation (Tracking.cc:1313-1334), after the metric
        rescale of a mono map: metric measurements must land in a metric
        map (the depth sensors' maps are metric already)."""
        fl = self.cfg.flags
        pdet, cdet = self._pending_plane_det, self._pending_cuboid_det
        if fl.enable_ground_height_scale and self.cfg.sensor == "mono" and pdet is not None:
            self._update_metric_scale(kf_slot, pdet)
        if fl.detect_plane and pdet is not None:
            self.map, self.n_plane = sa.associate_planes(self.map, kf_slot, pdet, self.n_plane, fetch=self._fetch)
        if fl.detect_object and cdet is not None and self.n_kf > 2:
            # the reference skips objects in the first two keyframes (Tracking.cc:2102-2107)
            self.map, self.n_cub = sa.associate_cuboids(self.map, kf_slot, cdet, kp_pt, self.n_cub, self.cfg,
                                                        fetch=self._fetch)
        self._pending_plane_det = self._pending_cuboid_det = None

    def _update_metric_scale(self, kf_slot: int, plane_det):
        """Rescale the mono map onto metric scale from this keyframe's metric
        plane detections, the analogue of the reference's ground-height
        rescale (Tracking.cc:1335-1393).  Each (tracked point, detected
        plane) pair votes s = d_meas / (-n . p_cam); the mode of a log
        histogram and the median around it pick s (tracking.py:1392-1458 of
        the reference, whose comments record its A/B of the anchor policy).

        The next frame's program is already in flight on the old map and
        the old pose when the map is rescaled here, and nothing corrects it:
        the reference has no guard for the pipeline either (ROADMAP section
        3).  The fault is mirrored."""
        tc = self.cfg.tracking
        pvalid = np.asarray(plane_det.valid)
        if int(pvalid.sum()) < 1:
            return
        coefs = np.asarray(plane_det.coef)  # (L, 4) camera frame, metric
        bound, pc = self._fetch(_metric_scale_inputs(self.map, kf_slot))
        if int(bound.sum()) < 30:
            return
        n, d_meas = coefs[:, :3], coefs[:, 3]
        denom = -(pc @ n.T)  # (N, L) map-scale point-plane depth along the normal
        good = (bound[:, None] & pvalid[None, :] & (denom > tc.rescale_min_plane_dist)
                & (d_meas[None, :] > tc.rescale_min_plane_dist))
        s_cand = d_meas[None, :] / np.maximum(denom, 1e-6)
        logs = np.log(np.clip(s_cand[good], 1e-3, 1e3))
        if logs.size < 30:
            return
        hist, edges = np.histogram(logs, bins=np.linspace(-2.2, 2.2, 89))
        peak = int(np.argmax(hist))
        if hist[peak] < max(30, 0.1 * logs.size):
            return
        lo, hi = edges[max(peak - 1, 0)], edges[min(peak + 2, len(edges) - 1)]
        s = float(np.exp(np.median(logs[(logs >= lo) & (logs <= hi)])))
        # after the first anchor the map is metric: only small corrections
        s_lo, s_hi = (tc.rescale_min, tc.rescale_max) if self._metric_anchored else (0.15, 8.0)
        if s_lo < s < s_hi and abs(s - 1.0) > 0.005:
            self.map = ms.rescale_map(self.map, s)
            # the keyframe's pose is T_cur (both are this frame's optimized
            # pose); scaled here as on the device, without reading it back
            self.T_cur = np.array(self.T_cur)
            self.T_cur[:3, 3] *= np.float32(s)
            self.velocity = np.array(self.velocity)
            self.velocity[:3, 3] *= s
            self._metric_anchored = True
            self.n_rescales += 1
            self.dbg["metric_s"] = round(s, 4)

    def _local_mapping_step(self, kf_slot: int, frame_id: int = -1):
        """LocalMapping::Run for one keyframe (LocalMapping.cc:49-145): cull
        points, triangulate with neighbours, fuse, local BA, cull keyframes.
        Enqueued without waiting, apart from eigh's check in triangulation."""
        cfg = self.cfg
        with self.spans.laps("map_tri") as lap:
            f = self._kf_fids
            fid_recent_min = f[-4] if len(f) >= 4 else 0
            fid_old_max = f[-3] if len(f) >= 3 else -(1 << 30)
            self.map = ms.cull_points(self.map, bm.point_cull_mask(self.map, fid_recent_min, fid_old_max))
            n_nb = 10
            pos, kp2, chosen, nb_ids = bm.triangulate_with_neighbors(
                self.map, kf_slot, self.K, self.cam.bf / max(self.cam.fx, 1e-6), scale_factor=cfg.orb.scale_factor,
                mono=cfg.sensor == "mono", n_nb=n_nb,
            )
            avail_dev, avail_np = self._alloc_begin(n_nb * self.map.kf_pt.shape[1])
            self.map, n_dev = bm.insert_triangulated(
                self.map, kf_slot, pos, kp2, chosen, nb_ids, avail_dev, cfg.caps.max_points, fid=frame_id,
            )
            self._alloc_end(n_dev, avail_np)
            lap.next("map_fuse")
            self.map = bm.fuse_duplicates(self.map, kf_slot, self.K)
            self.map = ms.update_point_stats(self.map)
            lap.next("map_ba")
            if self.n_kf > 2:
                self.map, _ = run_local_ba(self.map, kf_slot, self.cam, cfg, stats=self.ba_factors)
            lap.next("map_kfcull")
            if self.n_kf > 3:
                self.map, _ = ms.cull_keyframes_sequential(
                    self.map, kf_slot, cfg.tracking.kf_cull_redundancy, th_obs=cfg.tracking.kf_cull_min_obs,
                )
            self._snapshot_free_slots()
            lap.end()
