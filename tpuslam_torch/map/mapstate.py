"""Structure-of-arrays map state (port of ``tpuslam/map/mapstate.py``).

``MapState`` has every field of the reference's NamedTuple, under the same
names and in the same order, so a map crosses between the packages as a
dict of numpy arrays (:func:`map_from_numpy`, :func:`map_to_numpy`).
Packed descriptors (``kf_desc``, ``pt_desc``) are int32 tensors holding the
uint32 bits; the numpy side keeps them uint32.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..core.config import Capacities
from ..kernels.orb import topk_stable


@dataclass
class MapState:
    """The whole map as padded tensors (shapes as in the reference)."""

    # keyframes
    kf_pose: torch.Tensor  # (K, 4, 4) world->camera
    kf_valid: torch.Tensor  # (K,) bool
    kf_frame_id: torch.Tensor  # (K,) int32
    kf_uv: torch.Tensor  # (K, N, 2)
    kf_octave: torch.Tensor  # (K, N) int32
    kf_angle: torch.Tensor  # (K, N)
    kf_desc: torch.Tensor  # (K, N, 8) int32 words
    kf_kp_valid: torch.Tensor  # (K, N) bool
    kf_pt: torch.Tensor  # (K, N) int32 map-point id per keypoint, -1 none
    kf_ur: torch.Tensor  # (K, N)
    kf_depth: torch.Tensor  # (K, N)
    # points
    pt_pos: torch.Tensor  # (P, 3)
    pt_valid: torch.Tensor  # (P,) bool
    pt_desc: torch.Tensor  # (P, 8) int32 words
    pt_normal: torch.Tensor  # (P, 3)
    pt_min_dist: torch.Tensor  # (P,)
    pt_max_dist: torch.Tensor  # (P,)
    pt_first_kf: torch.Tensor  # (P,) int32
    pt_first_fid: torch.Tensor  # (P,) int32
    pt_found: torch.Tensor  # (P,) int32
    pt_visible: torch.Tensor  # (P,) int32
    # planes
    plane_coef: torch.Tensor  # (Q, 4)
    plane_valid: torch.Tensor  # (Q,) bool
    plane_obs_count: torch.Tensor  # (Q,) int32
    # cuboids
    cub_pose: torch.Tensor  # (C, 4, 4)
    cub_scale: torch.Tensor  # (C, 3)
    cub_valid: torch.Tensor  # (C,) bool
    cub_class: torch.Tensor  # (C,) int32
    cub_obs_count: torch.Tensor  # (C,) int32
    cub_first_kf: torch.Tensor  # (C,) int32
    cub_last_kf: torch.Tensor  # (C,) int32
    cub_good: torch.Tensor  # (C,) bool
    # per-KF plane detections
    kf_plane_coef: torch.Tensor  # (K, L, 4)
    kf_plane_valid: torch.Tensor  # (K, L) bool
    kf_plane_map: torch.Tensor  # (K, L) int32
    kf_plane_ver: torch.Tensor  # (K, L) int32
    kf_plane_par: torch.Tensor  # (K, L) int32
    # per-KF cuboid detections
    kf_cub_local_pose: torch.Tensor  # (K, O, 4, 4)
    kf_cub_local_scale: torch.Tensor  # (K, O, 3)
    kf_cub_bbox: torch.Tensor  # (K, O, 4)
    kf_cub_corners: torch.Tensor  # (K, O, 16)
    kf_cub_quality: torch.Tensor  # (K, O)
    kf_cub_valid: torch.Tensor  # (K, O) bool
    kf_cub_map: torch.Tensor  # (K, O) int32
    kf_kp_cub: torch.Tensor  # (K, N) int32
    # point -> cuboid ownership
    pt_cub: torch.Tensor  # (P,) int32
    pt_cub_votes: torch.Tensor  # (P,) int32
    # place recognition
    kf_bow: torch.Tensor  # (K, W)

    def replace(self, **changes) -> "MapState":
        return dataclasses.replace(self, **changes)


FIELDS = tuple(f.name for f in dataclasses.fields(MapState))


def empty_map(caps: Capacities, device) -> MapState:
    K, N, P = caps.max_keyframes, caps.max_keypoints, caps.max_points
    Q, C = caps.max_planes, caps.max_cuboids
    L, O = caps.max_planes_per_frame, caps.max_cuboids_per_frame
    f32, i32 = torch.float32, torch.int32

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    def eye4(*batch):
        return torch.eye(4, dtype=f32, device=device).expand(*batch, 4, 4).clone()

    def plane0(*batch):
        return torch.tensor([0.0, 0.0, 1.0, 1.0], device=device).expand(*batch, 4).clone()

    return MapState(
        kf_pose=eye4(K),
        kf_valid=full((K,), False, torch.bool),
        kf_frame_id=full((K,), 0, i32),
        kf_uv=full((K, N, 2), 0.0, f32),
        kf_octave=full((K, N), 0, i32),
        kf_angle=full((K, N), 0.0, f32),
        kf_desc=full((K, N, 8), 0, i32),
        kf_kp_valid=full((K, N), False, torch.bool),
        kf_pt=full((K, N), -1, i32),
        kf_ur=full((K, N), -1.0, f32),
        kf_depth=full((K, N), -1.0, f32),
        pt_pos=full((P, 3), 0.0, f32),
        pt_valid=full((P,), False, torch.bool),
        pt_desc=full((P, 8), 0, i32),
        pt_normal=full((P, 3), 0.0, f32),
        pt_min_dist=full((P,), 0.0, f32),
        pt_max_dist=full((P,), 1e9, f32),
        pt_first_kf=full((P,), 0, i32),
        pt_first_fid=full((P,), -1, i32),
        pt_found=full((P,), 1, i32),
        pt_visible=full((P,), 1, i32),
        plane_coef=plane0(Q),
        plane_valid=full((Q,), False, torch.bool),
        plane_obs_count=full((Q,), 0, i32),
        cub_pose=eye4(C),
        cub_scale=full((C, 3), 1.0, f32),
        cub_valid=full((C,), False, torch.bool),
        cub_class=full((C,), -1, i32),
        cub_obs_count=full((C,), 0, i32),
        cub_first_kf=full((C,), 0, i32),
        cub_last_kf=full((C,), 0, i32),
        cub_good=full((C,), False, torch.bool),
        kf_plane_coef=plane0(K, L),
        kf_plane_valid=full((K, L), False, torch.bool),
        kf_plane_map=full((K, L), -1, i32),
        kf_plane_ver=full((K, L), -1, i32),
        kf_plane_par=full((K, L), -1, i32),
        kf_cub_local_pose=eye4(K, O),
        kf_cub_local_scale=full((K, O, 3), 1.0, f32),
        kf_cub_bbox=full((K, O, 4), 0.0, f32),
        kf_cub_corners=full((K, O, 16), 0.0, f32),
        kf_cub_quality=full((K, O), 0.7, f32),
        kf_cub_valid=full((K, O), False, torch.bool),
        kf_cub_map=full((K, O), -1, i32),
        kf_kp_cub=full((K, N), -1, i32),
        pt_cub=full((P,), -1, i32),
        pt_cub_votes=full((P,), 0, i32),
        kf_bow=full((K, caps.vocab_words), 0.0, f32),
    )


# ---------------------------------------------------------------------------
# Crossing between the packages (numpy in, numpy out)
# ---------------------------------------------------------------------------


def tensor_from_numpy(a, device) -> torch.Tensor:
    """numpy -> tensor; uint32 (packed descriptor words) becomes int32."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.tensor(a, device=device)


def map_from_numpy(fields: dict, device) -> MapState:
    """Build from ``{name: np.ndarray}`` keyed by the reference's
    ``MapState._fields``."""
    return MapState(**{k: tensor_from_numpy(fields[k], device) for k in FIELDS})


def read_numpy(tensors) -> list:
    """Device tensors to numpy, each with its own wait (the default read of
    the loop closer, relocalization and global BA; the Tracker passes its
    counted one-copy read instead)."""
    return [t.cpu().numpy() for t in tensors]


def map_to_numpy(m: MapState) -> dict:
    out = {k: getattr(m, k).cpu().numpy() for k in FIELDS}
    for k in ("kf_desc", "pt_desc"):
        out[k] = out[k].view(np.uint32)
    return out


# ---------------------------------------------------------------------------
# Derived structure
# ---------------------------------------------------------------------------


def incidence(m: MapState):
    """(K, P) float32 observation incidence matrix from kf_pt."""
    K, N = m.kf_pt.shape
    P = m.pt_pos.shape[0]
    rows = torch.arange(K, device=m.kf_pt.device)[:, None].expand(K, N)
    cols = torch.where(m.kf_pt >= 0, m.kf_pt, P).long()  # invalid -> overflow col
    obs = torch.zeros((K, P + 1), dtype=torch.float32, device=m.kf_pt.device)
    obs = obs.index_put((rows, cols), torch.ones((), device=obs.device).expand(K, N),
                        accumulate=True)[:, :P]
    return obs * m.kf_valid[:, None].to(torch.float32)


def covisibility(m: MapState):
    """(K, K) shared-map-point counts (KeyFrame::UpdateConnections weight)."""
    return covisibility_of(incidence(m))


def covisibility_of(obs):
    """Covisibility from a (K, P) incidence matrix (one matmul)."""
    cov = obs @ obs.T
    return cov - torch.diag(torch.diagonal(cov))


def point_obs_counts(m: MapState):
    """(P,) number of keyframes observing each point."""
    return torch.sum(incidence(m) > 0, dim=0).to(torch.int32)


def predict_scale_level(dist, max_dist, n_levels: int = 8, scale_factor: float = 1.2):
    """Predicted pyramid octave of a point seen from ``dist`` (float);
    points without a computed band (max_dist >= 1e8) predict level 0."""
    ratio = torch.clamp(max_dist, min=1e-9) / torch.clamp(dist, min=1e-9)
    lvl = torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / float(np.log(np.float32(scale_factor))))
    lvl = torch.clamp(lvl, 0, n_levels - 1)
    return torch.where(max_dist >= 1e8, 0.0, lvl)


# ---------------------------------------------------------------------------
# Mutations (functional: each returns a new MapState)
# ---------------------------------------------------------------------------


def _set_row(a, slot: int, value):
    out = a.clone()
    if isinstance(value, torch.Tensor):
        out[slot] = value
    else:  # a Python number: fill_ passes it as an argument, no host copy
        out[slot].fill_(value)
    return out


def add_keyframe(m: MapState, slot: int, pose, frame_id, uv, octave, angle, desc, kp_valid,
                 pt_ids, ur, depth) -> MapState:
    return m.replace(
        kf_pose=_set_row(m.kf_pose, slot, pose),
        kf_valid=_set_row(m.kf_valid, slot, True),
        kf_frame_id=_set_row(m.kf_frame_id, slot, frame_id),
        kf_uv=_set_row(m.kf_uv, slot, uv),
        kf_octave=_set_row(m.kf_octave, slot, octave),
        kf_angle=_set_row(m.kf_angle, slot, angle),
        kf_desc=_set_row(m.kf_desc, slot, desc),
        kf_kp_valid=_set_row(m.kf_kp_valid, slot, kp_valid),
        kf_pt=_set_row(m.kf_pt, slot, pt_ids),
        kf_ur=_set_row(m.kf_ur, slot, ur),
        kf_depth=_set_row(m.kf_depth, slot, depth),
    )


def scatter_last(base, idx, values):
    """``base`` with ``base[idx[i]] = values[i]``, the HIGHEST row i winning
    where indices repeat (XLA's scatter-set applies rows in order on the CPU,
    so the last writer wins there; CUDA's ``index_put_`` would pick any).
    Deterministic: the winning row index is a scatter-max, then a gather."""
    rows = torch.arange(idx.shape[0], device=idx.device)
    winner = torch.full((base.shape[0],), -1, dtype=torch.int64, device=idx.device)
    winner = winner.scatter_reduce(0, idx.long(), rows, "amax")
    hit = winner >= 0
    picked = values[winner.clamp(min=0)].to(base.dtype)
    return torch.where(hit.reshape(hit.shape + (1,) * (base.dim() - 1)), picked, base)


def _padset(arr, idx, vals):
    """Scatter-set that drops rows with index len(arr) (the reference's
    overflow-slot idiom)."""
    padded = torch.cat([arr, torch.zeros_like(arr[:1])], dim=0)
    return scatter_last(padded, idx, vals)[:-1]


def add_points(m: MapState, slots, pos, desc, normal, min_dist, max_dist, first_kf, valid,
               first_fid=None) -> MapState:
    """Write a batch of new points at ``slots``; invalid lanes write nowhere."""
    P = m.pt_pos.shape[0]
    slots = torch.where(valid, slots, P)
    if first_fid is None:
        first_fid = torch.full_like(first_kf, -1)
    return m.replace(
        pt_pos=_padset(m.pt_pos, slots, pos),
        pt_valid=_padset(m.pt_valid, slots, valid),
        pt_desc=_padset(m.pt_desc, slots, desc),
        pt_normal=_padset(m.pt_normal, slots, normal),
        pt_min_dist=_padset(m.pt_min_dist, slots, min_dist),
        pt_max_dist=_padset(m.pt_max_dist, slots, max_dist),
        pt_first_kf=_padset(m.pt_first_kf, slots, first_kf),
        pt_first_fid=_padset(m.pt_first_fid, slots, first_fid),
    )


def assign_observations(m: MapState, kf_slot: int, kp_idx, pt_ids, ok) -> MapState:
    """Set kf_pt[kf_slot, kp_idx] = pt_ids where ok (feature -> point links)."""
    N = m.kf_pt.shape[1]
    kp_idx = torch.where(ok, kp_idx, N)
    row = _padset(m.kf_pt[kf_slot], kp_idx, pt_ids.to(m.kf_pt.dtype))
    return m.replace(kf_pt=_set_row(m.kf_pt, kf_slot, row))


def assign_observations_flat(m: MapState, kf_rows, kp_idx, pt_ids, ok) -> MapState:
    """kf_pt[kf_rows[i], kp_idx[i]] = pt_ids[i] where ok[i], across many
    keyframes in one scatter (the last lane wins a repeated cell)."""
    K, N = m.kf_pt.shape
    flat_idx = torch.where(ok, kf_rows.long() * N + kp_idx.long(), K * N)
    flat = _padset(m.kf_pt.reshape(-1), flat_idx, pt_ids.to(m.kf_pt.dtype))
    return m.replace(kf_pt=flat.reshape(K, N))


def cull_points(m: MapState, kill_mask) -> MapState:
    """Mark points invalid and unlink them from every keyframe."""
    kill_of_obs = (m.kf_pt >= 0) & kill_mask[m.kf_pt.clamp(min=0).long()]
    return m.replace(
        pt_valid=m.pt_valid & ~kill_mask,
        kf_pt=torch.where(kill_of_obs, -1, m.kf_pt),
    )


def nanmedian(x):
    """Median over the last axis of the non-NaN entries, interpolated as
    ``jnp.nanmedian`` does (``lo * (1 - w) + hi * w``); NaN when none."""
    finite = ~torch.isnan(x)
    n = torch.sum(finite, dim=-1)
    srt = torch.sort(torch.where(finite, x, float("inf")), dim=-1).values
    pos = 0.5 * (n - 1).clamp(min=0).to(x.dtype)
    low = torch.floor(pos)
    w = pos - low
    lo_i = low.long()
    hi_i = torch.minimum(lo_i + 1, (n - 1).clamp(min=0))
    lo = srt.gather(-1, lo_i[..., None])[..., 0]
    hi = srt.gather(-1, hi_i[..., None])[..., 0]
    return torch.where(n > 0, lo * (1.0 - w) + hi * w, float("nan"))


def scene_median_depth(m: MapState, kf):
    """Median depth of keyframe ``kf``'s tracked points in its camera frame
    (KeyFrame::ComputeSceneMedianDepth); +inf when it tracks none.  ``kf``
    is an int or a (L,) tensor of keyframes, giving (L,) medians."""
    dev = m.kf_pt.device
    kf_t = kf.long().reshape(-1) if isinstance(kf, torch.Tensor) else torch.arange(kf, kf + 1, device=dev)
    row = m.kf_pt[kf_t]
    pt = row.clamp(min=0).long()
    has = (row >= 0) & m.kf_kp_valid[kf_t] & m.pt_valid[pt]
    T = m.kf_pose[kf_t]
    z = torch.einsum("lnk,lk->ln", m.pt_pos[pt], T[:, 2, :3]) + T[:, 2, 3:4]
    med = nanmedian(torch.where(has, z, float("nan")))
    med = torch.where(torch.isnan(med), float("inf"), med)
    return med if isinstance(kf, torch.Tensor) and kf.dim() == 1 else med[0]


def keyframe_redundancy(m: MapState, th_obs: int = 3, scale_slack: int = 1, n_octaves: int = 8):
    """(K,) fraction of each keyframe's tracked points that at least
    ``th_obs`` other keyframes observe at the same or a finer scale
    (LocalMapping::KeyFrameCulling's rule, as one per-octave histogram)."""
    P = m.pt_pos.shape[0]
    pt = m.kf_pt.clamp(min=0).long()
    obs = (m.kf_pt >= 0) & m.kf_kp_valid & m.kf_valid[:, None] & m.pt_valid[pt]
    octv = m.kf_octave.clamp(0, n_octaves - 1).long()
    cols = torch.where(obs, pt, P)
    hist = torch.zeros(n_octaves * (P + 1), dtype=torch.float32, device=pt.device)
    hist = hist.index_add(0, (octv * (P + 1) + cols).reshape(-1),
                          torch.ones(cols.numel(), device=pt.device))
    cnt_le = torch.cumsum(hist.reshape(n_octaves, P + 1)[:, :P], dim=0)
    o_idx = (octv + scale_slack).clamp(0, n_octaves - 1)
    others = cnt_le[o_idx, pt] - 1.0  # the keyframe's own observation excluded
    red = obs & (others >= th_obs)
    n_obs = torch.sum(obs.to(torch.float32), dim=1)
    n_red = torch.sum(red.to(torch.float32), dim=1)
    return torch.where(n_obs > 0, n_red / torch.clamp(n_obs, min=1.0), 0.0)


def cull_keyframes(m: MapState, kill_mask) -> MapState:
    """Remove keyframes (KeyFrame::SetBadFlag): invalidate the rows, drop
    their observations, and kill each point that lost one of them and is
    left with <= 2 observers (MapPoint::EraseObservation).  Plane and cuboid
    counters are lifetime statistics and stay."""
    kill_col = kill_mask[:, None]
    P = m.pt_pos.shape[0]
    lost_rows = kill_col & (m.kf_pt >= 0) & m.kf_kp_valid
    lost = torch.zeros(P + 1, dtype=torch.bool, device=kill_mask.device).index_fill(
        0, torch.where(lost_rows, m.kf_pt, P).reshape(-1).long(), True
    )[:P]
    m = m.replace(
        kf_valid=m.kf_valid & ~kill_mask,
        kf_kp_valid=m.kf_kp_valid & ~kill_col,
        kf_pt=torch.where(kill_col, -1, m.kf_pt),
        kf_plane_valid=m.kf_plane_valid & ~kill_col,
        kf_plane_map=torch.where(kill_col, -1, m.kf_plane_map),
        kf_plane_ver=torch.where(kill_col, -1, m.kf_plane_ver),
        kf_plane_par=torch.where(kill_col, -1, m.kf_plane_par),
        kf_cub_valid=m.kf_cub_valid & ~kill_col,
        kf_cub_map=torch.where(kill_col, -1, m.kf_cub_map),
        kf_kp_cub=torch.where(kill_col, -1, m.kf_kp_cub),
    )
    return cull_points(m, lost & m.pt_valid & (point_obs_counts(m) <= 2))


def select_map(cond, a: MapState, b: MapState) -> MapState:
    """Field-wise ``where(cond, b, a)`` for a 0-d bool tensor ``cond``."""
    return MapState(**{k: torch.where(cond, getattr(b, k), getattr(a, k)) for k in FIELDS})


def cull_keyframes_sequential(m: MapState, center_kf: int, redundancy_th: float,
                              th_obs: int = 3, max_passes: int = 3):
    """Up to ``max_passes`` sequential KeyFrameCulling passes: each
    recomputes redundancy, kills the single most redundant eligible keyframe
    (never slot 0 or ``center_kf``), and the rest do nothing once none
    qualifies.  A fixed loop whose steps are selects: no host wait.
    Returns (map, n_culled)."""
    K = m.kf_pose.shape[0]
    dev = m.kf_pt.device
    done = torch.zeros((), dtype=torch.bool, device=dev)
    n = torch.zeros((), dtype=torch.int32, device=dev)
    not_pinned = torch.ones(K, dtype=torch.bool, device=dev)
    not_pinned[0].fill_(False)
    not_pinned[center_kf].fill_(False)
    for _ in range(max_passes):
        red = keyframe_redundancy(m, th_obs=th_obs)
        cov_row = covisibility(m)[center_kf]
        elig = (red >= redundancy_th) & (cov_row >= 15.0) & m.kf_valid & not_pinned
        any_elig = torch.any(elig) & ~done
        victim = torch.argmax(torch.where(elig, red, -1.0))
        kill = (torch.arange(K, device=dev) == victim) & any_elig
        m = select_map(any_elig, m, cull_keyframes(m, kill))
        done = done | ~any_elig
        n = n + any_elig.to(torch.int32)
    return m, n


def rescale_map(m: MapState, s: float) -> MapState:
    """Multiply every world-unit quantity by ``s``: the analogue of the
    reference's ground-height map rescaling (Tracking.cc:1335-1393), with the
    scale taken from metric plane measurements
    (``frontend/tracking.py:Tracker._update_metric_scale``).  ``s`` is
    rounded to float32 first, as the reference's ``jnp.float32(s)``."""
    s = float(np.float32(s))

    def scaled_t(T):
        T = T.clone()
        T[..., :3, 3] *= s
        return T

    plane_coef = m.plane_coef.clone()
    plane_coef[:, 3] *= s
    return m.replace(
        kf_pose=scaled_t(m.kf_pose), pt_pos=m.pt_pos * s, plane_coef=plane_coef,
        cub_pose=scaled_t(m.cub_pose), cub_scale=m.cub_scale * s,
        pt_min_dist=m.pt_min_dist * s, pt_max_dist=m.pt_max_dist * s,
    )


def keypoint_of_point(m: MapState):
    """(K, P) int32: the keypoint of keyframe k observing point p, -1 when k
    does not observe p (the inverse of ``kf_pt``; where two keypoints of one
    keyframe hold one point, the higher keypoint wins, as on the reference)."""
    K, N = m.kf_pt.shape
    P = m.pt_pos.shape[0]
    dev = m.kf_pt.device
    linked = (m.kf_pt >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    cols = torch.where(linked, m.kf_pt, P).long()
    flat_idx = (torch.arange(K, device=dev)[:, None] * (P + 1) + cols).reshape(-1)
    kp = torch.arange(N, dtype=torch.int32, device=dev).expand(K, N).reshape(-1)
    kp_of = scatter_last(torch.full((K * (P + 1),), -1, dtype=torch.int32, device=dev), flat_idx, kp)
    return kp_of.reshape(K, P + 1)[:, :P]


def popcount32(x):
    """Bits set in each int32 word (counted as its uint32 bit pattern)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def update_point_stats(m: MapState, max_obs: int = 8, n_levels: int = 8,
                       scale_factor: float = 1.2) -> MapState:
    """Refresh each point's distinctive descriptor (the observation of
    least median Hamming distance to the others, over up to ``max_obs``
    observers), mean viewing normal, and scale band from its anchor
    observation (MapPoint::ComputeDistinctiveDescriptors and
    UpdateNormalAndDepth), batched over the whole map."""
    K, N = m.kf_pt.shape
    P = m.pt_pos.shape[0]
    dev = m.kf_pt.device
    obs = incidence(m) > 0  # (K, P)
    Rt = m.kf_pose[:, :3, :3].transpose(1, 2)
    centers = -torch.einsum("kij,kj->ki", Rt, m.kf_pose[:, :3, 3])

    diff = m.pt_pos[None, :, :] - centers[:, None, :]  # (K, P, 3)
    dirs = diff / (torch.linalg.vector_norm(diff, dim=-1, keepdim=True) + 1e-9)
    normal = torch.einsum("kp,kpd->pd", obs.to(torch.float32), dirs)
    nrm = torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
    normal = torch.where(nrm > 1e-6, normal / nrm, m.pt_normal)

    M = min(max_obs, K)
    kp_of = keypoint_of_point(m)  # (K, P)
    val, kf_ids = topk_stable(obs.T.to(torch.float32), M)  # (P, M)
    obs_mask = val > 0
    p_idx = torch.arange(P, device=dev)
    kp_ids = kp_of[kf_ids, p_idx[:, None]]
    obs_mask = obs_mask & (kp_ids >= 0)
    cnt = torch.sum(obs_mask, dim=1)

    descs = m.kf_desc[kf_ids, kp_ids.clamp(min=0).long()]  # (P, M, 8)
    x = descs[:, :, None, :] ^ descs[:, None, :, :]
    ham = torch.sum(popcount32(x), dim=-1).to(torch.float32)  # (P, M, M)
    ham = torch.where(obs_mask[:, None, :], ham, float("inf"))
    srt = torch.sort(ham, dim=-1).values
    med_idx = torch.clamp(cnt - 1, min=0) // 2
    med = srt.gather(-1, med_idx[:, None, None].expand(P, M, 1))[..., 0]
    med = torch.where(obs_mask, med, float("inf"))
    best = torch.argmin(med, dim=-1)
    new_desc = descs[p_idx, best]
    has_obs = cnt > 0
    pt_desc = torch.where(has_obs[:, None], new_desc, m.pt_desc)

    ref_kf = m.pt_first_kf.clamp(0, K - 1).long()
    ref_kp = kp_of[ref_kf, p_idx]
    ref_ok = m.kf_valid[ref_kf] & (ref_kp >= 0)
    ref_kf = torch.where(ref_ok, ref_kf, kf_ids[:, 0])
    ref_kp = torch.where(ref_ok, ref_kp, kp_ids[:, 0])
    dist = torch.linalg.vector_norm(m.pt_pos - centers[ref_kf], dim=-1)
    level = m.kf_octave[ref_kf, ref_kp.clamp(min=0).long()].to(torch.float32)
    max_d = dist * scale_factor**level
    min_d = max_d / scale_factor ** float(n_levels - 1)
    return m.replace(
        pt_normal=normal, pt_desc=pt_desc,
        pt_min_dist=torch.where(has_obs, min_d, m.pt_min_dist),
        pt_max_dist=torch.where(has_obs, max_d, m.pt_max_dist),
    )
