"""Loop detection and correction (port of ``tpuslam/place/loop.py``;
LoopClosing.cc and KeyFrameDatabase.cc).

  DetectLoop    BoW scores of the new keyframe against every non-covisible
                keyframe, the min-covisible-score gate (LoopClosing.cc:
                119-150), the 0.8 x maxCommonWords shared-word gate and the
                accumulated covisibility-group score (KeyFrameDatabase.cc:
                55-130), and covisibility-group consistency over 3
                consecutive keyframes (LoopClosing.cc:152-211).
  ComputeSim3   a mutual descriptor match between the two keyframes' bound
                keypoints, Sim3 RANSAC (>= 20 inliers), its Gauss-Newton
                refinement, and the guided projection of the loop
                neighbourhood's points, accepted with >= 40 matched
                keypoints in all (LoopClosing.cc:274-391).
  CorrectLoop   Sim3 propagation to the current keyframe's neighbourhood
                with point correction, loop-point fusion with landmark
                merging, the essential graph over every keyframe and point
                re-anchoring (LoopClosing.cc:402-613).

The gating statistics come from one program on the device and one small
copy per keyframe; the full covisibility matrix is copied only when
candidates survive.  The gating itself is numpy on the host, the
reference's code on the same arrays (``np.argsort``, ``np.unique`` and the
streaks), so ties fall as they do there.  The Sim3 RANSAC samples are
the reference's own draw keyed by ``PRNGKey(kf_cur)``
(``initializer.ransac_samples``), from :meth:`LoopCloser._sim3_samples`,
which a test may replace.

``TPUSLAM_LOOP_DEBUG=<path>``, read when the module is imported, appends
the reference's detector log to that file (one ``fid=...`` line per
keyframe past the refractory and covisibility checks, then a line per
gate and per Sim3 step) and saves each Sim3 attempt's inputs beside it
(``<path>.sim3_<frame id>_<loop slot>.npz``).  The values only the log
reads are fetched only while it is on.
"""

from __future__ import annotations

import os
from collections import Counter

import numpy as np
import torch

from ..backend import posegraph as pg
from ..backend.mapping import fuse_into_keyframe
from ..backend.sim3solver import optimize_sim3, solve_sim3
from ..core import geometry as geo
from ..core.camera import camera_matrix
from ..frontend.initializer import ransac_samples
from ..kernels import match as km
from ..map import mapstate as ms
from ..utils.profiler import Spans
from . import vocab as vb

_DEBUG_PATH = os.environ.get("TPUSLAM_LOOP_DEBUG", "")


def _dbg(msg: str) -> None:
    if _DEBUG_PATH:
        with open(_DEBUG_PATH, "a") as f:
            f.write(msg + "\n")


def _loop_candidate_stats(m: ms.MapState, bow, kf_slot: int):
    """Everything the detector's gates read, computed on the device: (BoW
    scores (K,), shared-word counts (K,), the new keyframe's covisibility
    row (K,), kf_valid)."""
    cov_row = ms.covisibility(m)[kf_slot]
    scores = vb.bow_scores(bow, m.kf_bow, m.kf_valid)
    common = torch.sum((m.kf_bow > 0) & (bow > 0)[None, :], dim=1).to(torch.float32)
    return scores, common, cov_row, m.kf_valid


def _first_true(mask, dim: int = 0):
    """Index of the first True along ``dim`` (0 where none), as ``jnp.argmax``
    of a bool array gives it; the card's ``argmax`` has no bool kernel."""
    return torch.argmax(mask.to(torch.uint8), dim=dim)


class LoopCloser:
    """The host-side loop-closing stage: :meth:`on_keyframe` after each
    keyframe's mapping, with the map as it stands."""

    def __init__(self, vocab: vb.Vocabulary, cam, cfg):
        self.vocab = vocab
        self.cam = cam
        self.cfg = cfg
        self.K = camera_matrix(cam)
        # the previous keyframe's consistent groups: (covisibility mask (K,), streak)
        self.prev_groups: list = []
        self.last_loop_fid = -1000  # frame id of the last closed loop
        # keyframes seen, monotonic: the refractory window counts keyframes
        # (LoopClosing.cc: mnId < mLastLoopKFid + 10)
        self.kf_seen = 0
        self.last_loop_kf_seen = -1000
        self.n_loops_closed = 0
        self.stage_ms = {}  # cumulative host wall ms per stage
        self.spans = Spans(self.stage_ms, prefix="loop_")  # traced as tpuslam/loop_<stage>
        self.gates = Counter()  # keyframes that reached each gate
        self.closures = []  # (current keyframe's frame id, loop keyframe's) per closure

    def _sim3_samples(self, valid, kf_cur: int):
        """The (iters, 3) Sim3 RANSAC samples of the reference's draw keyed
        by ``PRNGKey(kf_cur)``."""
        return ransac_samples(valid, kf_cur, n_iters=self.cfg.loop.sim3_ransac_max_iters, n_pick=3)

    def on_keyframe(self, m: ms.MapState, kf_slot: int, n_kf: int, frame_id: int = -1, fetch=None):
        """Returns (map, loop closed).  ``frame_id``: the new keyframe's frame
        id (read from the map when -1).  ``fetch``: reads device tensors to
        numpy in one copy (the Tracker's counted reads); the default waits
        with ``.cpu()``."""
        with self.spans.laps("bow") as lap:
            return self._detect_and_close(m, kf_slot, n_kf, frame_id, fetch or ms.read_numpy, lap)

    def _detect_and_close(self, m: ms.MapState, kf_slot: int, n_kf: int, frame_id: int, fetch, lap):
        """:meth:`on_keyframe` inside its stages: ``bow``, ``stats``,
        ``gates``, then ``sim3`` per candidate tried and ``correct``.  A
        stage left by an early return is not timed."""
        cfg = self.cfg
        m, bow = vb.update_kf_bow(self.vocab, m, kf_slot)
        lap.next("stats")
        self.kf_seen += 1
        if n_kf < 10 or self.kf_seen - self.last_loop_kf_seen < 10:
            return m, False
        self.gates["stats"] += 1
        scores, common_raw, cov_row, kf_valid = fetch(_loop_candidate_stats(m, bow, kf_slot))
        cur_fid = int(frame_id) if frame_id >= 0 else int(fetch((m.kf_frame_id[kf_slot],))[0])
        lap.next("gates")
        covisible = cov_row >= 15
        if covisible.sum() == 0:
            self.prev_groups = []
            return m, False
        self.gates["covisible"] += 1
        min_score = float(scores[covisible].min())
        pool = ~covisible & kf_valid
        pool[kf_slot] = False
        if _DEBUG_PATH:
            fids = fetch((m.kf_frame_id,))[0]
            pool_scores = np.where(pool, scores, -1.0)
            best = int(np.argmax(pool_scores))
            _dbg(f"fid={cur_fid} kf_seen={self.kf_seen} pool={int(pool.sum())} "
                 f"min_score={min_score:.5f} best_pool_score={pool_scores.max():.5f} "
                 f"best_slot={best} best_fid={int(fids[best]) if pool.any() else -1} "
                 f"common_best={float(np.where(pool, common_raw, 0).max()):.0f}")
        # a detection without candidates clears the groups (LoopClosing.cc:160-166)
        common = np.where(pool, common_raw, 0.0)
        if common.max() <= 0:
            self.prev_groups = []
            return m, False
        self.gates["words"] += 1
        score_and_match = pool & (common > 0.8 * common.max()) & (scores >= min_score)
        _dbg(f"  gate2 n_score_and_match={int(score_and_match.sum())}")
        if not score_and_match.any():
            self.prev_groups = []
            return m, False
        self.gates["score"] += 1
        cov = fetch((ms.covisibility(m),))[0]

        # accumulated covisibility-group scores (KeyFrameDatabase.cc:90-130)
        cand_idx = np.where(score_and_match)[0]
        acc_scores = np.empty(len(cand_idx), np.float32)
        best_in_group = np.empty(len(cand_idx), np.int64)
        for n, c in enumerate(cand_idx):
            nbrs = np.argsort(-cov[c])[:10]
            group = np.concatenate([[c], nbrs[cov[c][nbrs] > 0]])
            in_match = score_and_match[group]
            acc_scores[n] = scores[group][in_match].sum()
            gm = group[in_match]
            best_in_group[n] = gm[np.argmax(scores[gm])]
        keep = acc_scores > 0.75 * acc_scores.max()
        candidates = np.unique(best_in_group[keep])

        # covisibility-group consistency over consecutive keyframes
        new_groups, consistent_enough = [], []
        for c in candidates:
            group_mask = (cov[c] > 0) & kf_valid
            group_mask[c] = True
            streak = 1
            for prev_mask, prev_streak in self.prev_groups:
                if (group_mask & prev_mask).any():
                    streak = max(streak, prev_streak + 1)
            new_groups.append((group_mask, streak))
            if streak >= cfg.loop.covisibility_consistency_th:
                consistent_enough.append(int(c))
        self.prev_groups = new_groups
        _dbg(f"  gate3 candidates={candidates.tolist()} streaks={[s for _, s in new_groups]} "
             f"consistent={consistent_enough}")
        if not consistent_enough:
            return m, False
        self.gates["consistent"] += 1
        consistent_enough.sort(key=lambda c: -scores[c])
        lap.next("sim3")
        for loop_kf in consistent_enough[:3]:
            res = self._compute_sim3(m, kf_slot, loop_kf, fetch)
            _dbg(f"  sim3 cand={loop_kf} ok={res is not None}")
            lap.next("sim3" if res is None else "correct")
            if res is None:
                continue
            self.gates["sim3"] += 1
            S_cl, loop_pts = res
            m = self._correct_loop(m, kf_slot, loop_kf, S_cl, loop_pts, fetch)
            lap.end()
            self.last_loop_fid = cur_fid
            self.last_loop_kf_seen = self.kf_seen
            self.prev_groups = []
            self.n_loops_closed += 1
            return m, True
        return m, False

    def _loop_neighbourhood_points(self, m: ms.MapState, kf_loop: int):
        """(P,) bool: points observed by the loop keyframe or its covisible
        neighbours (mvpLoopMapPoints, LoopClosing.cc:360-373)."""
        obs = ms.incidence(m)
        nbh = (ms.covisibility_of(obs)[kf_loop] >= 15) & m.kf_valid
        nbh = ms._set_row(nbh, kf_loop, True)
        return (torch.sum(obs * nbh[:, None], dim=0) > 0) & m.pt_valid

    def _compute_sim3(self, m: ms.MapState, kf_cur: int, kf_loop: int, fetch=ms.read_numpy):
        """Match the two keyframes' bound keypoints and solve the Sim3 between
        their camera frames: (S_cl (4, 4) mapping loop-frame points into the
        current frame, the loop neighbourhood's point mask) or None."""
        cfg = self.cfg
        has_cur = (m.kf_pt[kf_cur] >= 0) & m.kf_kp_valid[kf_cur]
        has_loop = (m.kf_pt[kf_loop] >= 0) & m.kf_kp_valid[kf_loop]
        idx, _, ok = km.match_descriptors(m.kf_desc[kf_cur], m.kf_desc[kf_loop], has_cur, has_loop,
                                          max_dist=50.0, ratio=0.75, mutual=True)
        ok_np = fetch((ok,))[0]
        n_matches = int(ok_np.sum())
        _dbg(f"    sim3: desc_matches={n_matches} (need {cfg.loop.min_bow_matches})")
        if n_matches < cfg.loop.min_bow_matches:
            return None
        pt_cur = m.kf_pt[kf_cur]
        pt_loop = m.kf_pt[kf_loop][idx]
        P1 = geo.se3_apply(m.kf_pose[kf_cur], m.pt_pos[pt_cur.clamp(min=0).long()])
        P2 = geo.se3_apply(m.kf_pose[kf_loop], m.pt_pos[pt_loop.clamp(min=0).long()])
        uv1 = m.kf_uv[kf_cur]
        uv2 = m.kf_uv[kf_loop][idx]
        res = solve_sim3(P1, P2, ok, uv1, uv2, self.K, self._sim3_samples(torch.from_numpy(ok_np), kf_cur))
        res_ok, n_inl = fetch((res.ok, res.n_inliers))
        _dbg(f"    sim3: ransac ok={bool(res_ok)} inliers={int(n_inl)}")
        if _DEBUG_PATH:
            names = ("P1", "P2", "ok", "uv1", "uv2", "K", "T_cur", "T_loop", "fid")
            arrays = dict(zip(names, fetch((P1, P2, ok, uv1, uv2, self.K, m.kf_pose[kf_cur], m.kf_pose[kf_loop],
                                             m.kf_frame_id[kf_cur]))))
            np.savez(_DEBUG_PATH + f".sim3_{int(arrays.pop('fid'))}_{kf_loop}.npz", **arrays)
        if not bool(res_ok) or int(n_inl) < cfg.loop.min_sim3_inliers:
            return None
        S_cl = geo.sim3_from_sRt(res.s, res.R, res.t)
        # Gauss-Newton refinement with bidirectional reprojection residuals
        # (Optimizer::OptimizeSim3), accepted with the same inlier floor
        S_ref, inl, n_in = optimize_sim3(S_cl, P1, P2, uv1, uv2, self.K, res.inliers,
                                         fix_scale=cfg.sensor != "mono")
        # the guided projection of the loop neighbourhood's points into the
        # current keyframe at the corrected pose: >= 40 matched keypoints in
        # all, the gate that keeps false loops from welding the map
        loop_pts = self._loop_neighbourhood_points(m, kf_loop)
        kp_proj, _ = _project_and_match(m, kf_cur, loop_pts, S_ref @ m.kf_pose[kf_loop], self.K, radius=10.0)
        total = torch.sum(kp_proj | (inl & ok & (pt_cur >= 0)))
        n_in_np, total_np = fetch((n_in, total))
        _dbg(f"    sim3: gn inliers={int(n_in_np)}")
        if int(n_in_np) < cfg.loop.min_sim3_inliers:
            return None
        _dbg(f"    sim3: guided total={int(total_np)} (need {cfg.loop.min_total_matches})")
        if int(total_np) < cfg.loop.min_total_matches:
            return None
        return S_ref, loop_pts

    def _correct_loop(self, m: ms.MapState, kf_cur: int, kf_loop: int, S_cl, loop_pts, fetch=ms.read_numpy):
        """Sim3 propagation, fusion and the essential graph
        (LoopClosing::CorrectLoop, LoopClosing.cc:402-585)."""
        K = m.kf_pose.shape[0]
        dev = m.kf_pose.device
        S_old = m.kf_pose  # scale-1 Sim3 == SE3: the pre-correction snapshot
        cov_np, kf_valid, fids_np = fetch((ms.covisibility(m), m.kf_valid, m.kf_frame_id))
        self.closures.append((int(fids_np[kf_cur]), int(fids_np[kf_loop])))

        # 1. propagate the corrected Sim3 to the current keyframe's covisible
        #    neighbourhood (LoopClosing.cc:443-470): S_iw' = (T_i T_c^-1) S_cw'
        nbh_np = (cov_np[kf_cur] >= 15) & kf_valid
        nbh_np[kf_cur] = True
        nbh = torch.from_numpy(nbh_np).to(dev)
        S_corr = (S_old @ geo.se3_inv(S_old[kf_cur])) @ (S_cl @ S_old[kf_loop])
        S_start = torch.where(nbh[:, None, None], S_corr, S_old)

        # 2. each point's anchor keyframe (LoopClosing.cc:470-516): current-side
        #    points anchor to their first observer in the current neighbourhood
        #    and move with it; loop-neighbourhood points anchor to a loop-side
        #    observer, one outside the current neighbourhood if there is one
        lnbh_np = (cov_np[kf_loop] >= 15) & kf_valid
        lnbh_np[kf_loop] = True
        lnbh = torch.from_numpy(lnbh_np).to(dev)
        obs = ms.incidence(m) > 0
        pref = obs & lnbh[:, None] & ~nbh[:, None]
        fall = obs & lnbh[:, None]
        anchor_loop = torch.where(torch.any(pref, dim=0), _first_true(pref), _first_true(fall))
        nbh_obs = obs & nbh[:, None]
        anchor_cur = torch.where(torch.any(nbh_obs, dim=0), _first_true(nbh_obs), m.pt_first_kf.clamp(0, K - 1).long())
        anchor = torch.where(loop_pts, anchor_loop, anchor_cur)
        pts = pg.correct_points_for_sim3(m.pt_pos, anchor, S_old, S_start)
        pts = torch.where(m.pt_valid[:, None], pts, m.pt_pos)
        m = m.replace(kf_pose=torch.where(nbh[:, None, None], pg.sim3_to_se3(S_start), m.kf_pose), pt_pos=pts)

        # 3. fuse the loop neighbourhood's points into the corrected current
        #    neighbourhood, merging landmarks (SearchAndFuse, LoopClosing.cc:
        #    542, 587-613; the better-observed point wins)
        fuse_kfs = [kf_cur] + [int(k) for k in np.argsort(-cov_np[kf_cur])[:15] if nbh_np[k] and k != kf_cur]
        for k in fuse_kfs:
            m = fuse_into_keyframe(m, k, self.K, src_mask=loop_pts, radius=4.0)

        # 4. the essential graph over every keyframe (Optimizer::
        #    OptimizeEssentialGraph, Optimizer.cc:789-1052): measurements from
        #    the pre-correction relative poses, started at the propagated
        #    poses, the loop keyframe fixed.  Edges: the temporal chain in
        #    frame-id order, strong covisibility pairs (deduplicated) and the
        #    loop edge last
        strong = cov_np >= self.cfg.loop.essential_graph_min_feat
        valid_slots = np.flatnonzero(kf_valid)
        valid_slots = valid_slots[np.argsort(fids_np[valid_slots])]
        ca, cb = valid_slots[:-1], valid_slots[1:]
        off = ~np.eye(len(kf_valid), dtype=bool)
        su = np.argwhere(np.triu(strong & kf_valid[:, None] & kf_valid[None, :] & off, 1))
        K_all = len(kf_valid)
        pairs = np.stack([np.concatenate([ca, su[:, 0]]), np.concatenate([cb, su[:, 1]])], axis=1)
        packed = np.unique(pairs.min(1) * K_all + pairs.max(1))
        ii = torch.from_numpy(np.concatenate([packed // K_all, [kf_loop]]).astype(np.int64)).to(dev)
        jj = torch.from_numpy(np.concatenate([packed % K_all, [kf_cur]]).astype(np.int64)).to(dev)
        E = ii.shape[0]
        meas = S_old[jj] @ geo.se3_inv(S_old[ii])
        meas = torch.cat([meas[:-1], S_cl[None]])
        weight = torch.ones(E, device=dev)
        weight[-1] = 5.0
        edges = pg.Sim3Edges(i=ii, j=jj, meas=meas, weight=weight, valid=torch.ones(E, dtype=torch.bool, device=dev))
        fixed = ms._set_row(torch.zeros(K, dtype=torch.bool, device=dev), kf_loop, True) | ~m.kf_valid
        S_new, _ = pg.optimize_essential_graph(S_start, fixed, edges, n_iters=self.cfg.loop.essential_graph_iters)
        # write back: the poses with the scale folded in, the points re-anchored
        # through the same anchors from the propagated to the optimized poses
        new_poses = torch.where(m.kf_valid[:, None, None], pg.sim3_to_se3(S_new), m.kf_pose)
        pts = pg.correct_points_for_sim3(m.pt_pos, anchor, S_start, S_new)
        pts = torch.where(m.pt_valid[:, None], pts, m.pt_pos)
        plane_coef, cub_pose, cub_scale = _correct_semantics_for_sim3(m, S_old, S_new)
        m = m.replace(kf_pose=new_poses, pt_pos=pts, plane_coef=plane_coef, cub_pose=cub_pose, cub_scale=cub_scale)
        return ms.update_point_stats(m)


def _latest_observer(link, link_valid, kf_valid, n_landmarks: int):
    """(n_landmarks,) the highest valid keyframe slot whose detections link
    to each landmark, -1 for none."""
    K = link.shape[0]
    q = torch.arange(n_landmarks, device=link.device)
    seen = torch.any((link[:, :, None] == q) & link_valid[:, :, None], dim=1) & kf_valid[:, None]
    rows = torch.arange(K, device=link.device)[:, None]
    return torch.max(torch.where(seen, rows, -1), dim=0).values


def _correct_semantics_for_sim3(m: ms.MapState, S_old, S_new):
    """Planes and cuboids follow their latest valid observer keyframe through
    the loop correction (the analogue of ``correct_points_for_sim3``; the
    reference's CorrectLoop leaves them to the later optimization).
    Returns (plane_coef, cub_pose, cub_scale)."""

    def delta_for(anchor):
        a = anchor.clamp(min=0)
        return geo.sim3_inv(S_new[a]) @ S_old[a]  # world -> world correction

    # planes: n' = R n, d' = s d - n'.t for x' = s R x + t
    pa = _latest_observer(m.kf_plane_map, m.kf_plane_valid, m.kf_valid, m.plane_coef.shape[0])
    Dp = delta_for(pa)
    sp, Rp, tp = geo.sim3_scale(Dp), geo.sim3_R(Dp), Dp[:, :3, 3]
    n_new = torch.einsum("qij,qj->qi", Rp, m.plane_coef[:, :3])
    d_new = sp * m.plane_coef[:, 3] - torch.einsum("qi,qi->q", n_new, tp)
    use_p = (m.plane_valid & (pa >= 0))[:, None]
    plane_coef = torch.where(use_p, torch.cat([n_new, d_new[:, None]], dim=1), m.plane_coef)

    # cuboids: R' = R_d R_o, t' = s R_d t_o + t_d, scale' = s scale
    ca = _latest_observer(m.kf_cub_map, m.kf_cub_valid, m.kf_valid, m.cub_pose.shape[0])
    Dc = delta_for(ca)
    sc, Rc = geo.sim3_scale(Dc), geo.sim3_R(Dc)
    R_new = Rc @ m.cub_pose[:, :3, :3]
    t_new = torch.einsum("cij,cj->ci", Dc[:, :3, :3], m.cub_pose[:, :3, 3]) + Dc[:, :3, 3]
    use_c = m.cub_valid & (ca >= 0)
    cub_pose = torch.where(use_c[:, None, None], geo.se3_from_Rt(R_new, t_new), m.cub_pose)
    cub_scale = torch.where(use_c[:, None], sc[:, None] * m.cub_scale, m.cub_scale)
    return plane_coef, cub_pose, cub_scale


def _project_and_match(m: ms.MapState, kf: int, src_mask, S_cw, K, radius: float = 10.0):
    """Project the points of ``src_mask`` through the Sim3 ``S_cw`` into
    keyframe ``kf`` and match them against its keypoints: the guided
    SearchByProjection of ComputeSim3 (no ratio test, TH_LOW).  A gated
    match, so on the dense path, as in the reference.  Returns (ok (N,)
    per keypoint, matched point (N,))."""
    pc = geo.sim3_apply(S_cw, m.pt_pos)
    q = pc @ K.T
    uv = q[:, :2] / torch.where(torch.abs(q[:, 2:3]) < 1e-9, 1e-9, q[:, 2:3])
    visible = src_mask & (pc[:, 2] > 0.05)
    gate = km.window_gate(m.kf_uv[kf], uv, radius)
    idx, _, ok = km.match_descriptors(m.kf_desc[kf], m.pt_desc, m.kf_kp_valid[kf], visible, gate_mask=gate,
                                      max_dist=50.0)
    return ok, idx
