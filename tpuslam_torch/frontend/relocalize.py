"""Relocalization after tracking loss (port of
``tpuslam/frontend/relocalize.py``; Tracking::Relocalization,
Tracking.cc:1663-1824).

BoW candidates from the keyframe database; per candidate an ungated,
ratio-tested match of the frame against its bound keypoints (kernel K2,
as the reference sends it to its Pallas kernel), rotation consistency
(>= 15 matches), RANSAC PnP and motion-only pose optimization, accepted at
``reloc_min_inliers``; when the first optimization lands short, the widened
re-search rounds of Tracking.cc:1762-1801.  The candidate gating is numpy
on the host, the reference's code on the same arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import geometry as geo
from ..graph import lm
from ..kernels import match as km
from ..map import mapstate as ms
from ..place import vocab as vb
from .initializer import ransac_samples
from .pnp import ransac_pnp


def _inv_sigma2(octave):
    return 1.0 / (1.2 ** (2.0 * octave.to(torch.float32)))


def pnp_samples(valid, seed: int):
    """The (200, 6) PnP RANSAC samples of the reference's draw keyed by
    ``PRNGKey(seed)``, ``seed`` the candidate slot as in the reference."""
    return ransac_samples(valid, seed, n_iters=200, n_pick=6)


def research_by_projection(m: ms.MapState, frame, cand: int, T_est, kp_pt, cam, radius: float = 10.0,
                           max_dist: float = 100.0):
    """The widened SearchByProjection round (ORBmatcher.cc:1472, the reloc
    variant): project the candidate keyframe's bound points at the pose
    estimate, bind free keypoints within ``radius * 1.2^octave``, optimize
    the pose again.  Returns (T_opt, kp_pt_out, n_inliers)."""
    N = frame.uv.shape[0]
    P = m.pt_pos.shape[0]
    cand_pt = m.kf_pt[cand]
    cp = cand_pt.clamp(min=0).long()
    has = (cand_pt >= 0) & m.kf_kp_valid[cand] & m.pt_valid[cp]
    pc = geo.se3_apply(T_est, m.pt_pos[cp])
    z = torch.clamp(pc[:, 2], min=1e-6)
    uv_pred = torch.stack([cam.fx * pc[:, 0] / z + cam.cx, cam.fy * pc[:, 1] / z + cam.cy], dim=-1)
    # points already bound to a keypoint must not bind twice
    already = torch.zeros(P + 1, dtype=torch.bool, device=cp.device).index_fill(
        0, torch.where(kp_pt >= 0, kp_pt, P).long(), True)[:P]
    vis = has & (pc[:, 2] > 0) & ~already[cp]
    gate = km.window_gate(uv_pred, frame.uv, radius * 1.2 ** m.kf_octave[cand].to(torch.float32))
    idx, _, ok = km.match_descriptors(m.pt_desc[cp], frame.desc, vis, frame.valid & (kp_pt < 0), gate_mask=gate,
                                      max_dist=max_dist)
    add = ms.scatter_last(torch.full((N + 1,), -1, dtype=torch.int32, device=cp.device), torch.where(ok, idx, N),
                          torch.where(ok, cand_pt, -1))[:N]
    kp2 = torch.where(kp_pt >= 0, kp_pt, add)
    T_opt, inl, n_in = lm.optimize_pose(T_est, m.pt_pos[kp2.clamp(min=0).long()], frame.uv, _inv_sigma2(frame.octave),
                                        kp2 >= 0, cam.fx, cam.fy, cam.cx, cam.cy, ur=frame.ur, bf=cam.bf)
    return T_opt, torch.where((kp2 >= 0) & inl, kp2, -1), n_in


def detect_reloc_candidates(m: ms.MapState, bow, max_candidates: int = 10, fetch=ms.read_numpy):
    """KeyFrameDatabase::DetectRelocalizationCandidates (KeyFrameDatabase.cc:
    199-310): candidates share > 0.8 x maxCommonWords words with the query;
    each one's score is summed with its top-10 covisible neighbours that
    are candidates too, groups below 0.75 x the best sum are dropped and
    each is represented by its best-scoring member.  Scores, shared-word
    counts and the covisibility come in one copy.  Returns candidate slots,
    best first."""
    common_d = torch.sum((m.kf_bow > 0) & (bow > 0)[None, :], dim=1).to(torch.float32)
    kf_valid, scores, common, cov = fetch((m.kf_valid, vb.bow_scores(bow, m.kf_bow, m.kf_valid), common_d,
                                           ms.covisibility(m)))
    if not kf_valid.any():
        return []
    common = np.where(kf_valid, common, 0.0)
    if common.max() <= 0:
        return []
    pool = kf_valid & (common > 0.8 * common.max())
    cand_idx = np.flatnonzero(pool)
    if len(cand_idx) == 0:
        return []
    acc = np.empty(len(cand_idx), np.float32)
    best_in_group = np.empty(len(cand_idx), np.int64)
    for n, c in enumerate(cand_idx):
        nbrs = np.argsort(-cov[c])[:10]
        group = np.concatenate([[c], nbrs[cov[c][nbrs] > 0]])
        gm = group[pool[group]]
        acc[n] = scores[gm].sum()
        best_in_group[n] = gm[np.argmax(scores[gm])]
    keep = acc > 0.75 * acc.max()
    order_keys = {}
    for n in np.flatnonzero(keep):
        r = int(best_in_group[n])
        order_keys[r] = max(order_keys.get(r, -1.0), float(acc[n]))
    return sorted(order_keys, key=lambda r: -order_keys[r])[:max_candidates]


def relocalize(m: ms.MapState, frame, cam, vocab: vb.Vocabulary, cfg, n_kf: int, draw=pnp_samples,
               fetch=ms.read_numpy):
    """Returns (T_cw, kp_pt, n_inliers) or None.  ``draw(valid, cand)``: the
    PnP RANSAC samples for candidate ``cand``; ``fetch``: reads device
    tensors to numpy in one copy."""
    bow = vb.bow_vector(vocab, frame.desc, frame.valid)
    reloc_min = cfg.tracking.reloc_min_inliers
    inv_s2 = _inv_sigma2(frame.octave)
    for cand in detect_reloc_candidates(m, bow, fetch=fetch):
        cand = int(cand)
        has_pt = (m.kf_pt[cand] >= 0) & m.kf_kp_valid[cand]
        idx, _, ok = km.match_descriptors(frame.desc, m.kf_desc[cand], frame.valid, has_pt, max_dist=50.0, ratio=0.75)
        ok = km.rotation_consistency(frame.angle, m.kf_angle[cand], idx, ok)
        pt_ids = torch.where(ok, m.kf_pt[cand][idx], -1)
        matched = ok & (pt_ids >= 0)
        n_ok, matched_np = fetch((ok.sum(), matched))
        if int(n_ok) < 15:  # Tracking.cc:1699
            continue
        X = m.pt_pos[pt_ids.clamp(min=0).long()]
        res = ransac_pnp(X, frame.uv, matched, cam.fx, cam.fy, cam.cx, cam.cy, draw(torch.from_numpy(matched_np), cand))
        if not bool(fetch((res.ok,))[0]):
            continue
        T_opt, inl, n_in = lm.optimize_pose(res.T_cw, X, frame.uv, inv_s2, matched, cam.fx, cam.fy, cam.cx, cam.cy)
        kp_pt = torch.where(matched & inl, pt_ids, -1)
        n_in = int(fetch((n_in,))[0])
        if 10 <= n_in < reloc_min:
            # the coarse re-search at the estimated pose (Tracking.cc:1762-1786)
            T_opt, kp_pt, n_in = research_by_projection(m, frame, cand, T_opt, kp_pt, cam, radius=10.0,
                                                        max_dist=100.0)
            n_in = int(fetch((n_in,))[0])
            if 30 < n_in < reloc_min:
                # the final narrow round (Tracking.cc:1787-1801)
                T_opt, kp_pt, n_in = research_by_projection(m, frame, cand, T_opt, kp_pt, cam, radius=3.0,
                                                            max_dist=64.0)
                n_in = int(fetch((n_in,))[0])
        if n_in >= reloc_min:
            return T_opt, kp_pt, n_in
    return None
