"""Typed configuration (the port's own copy of ``tpuslam/core/config.py``).

The port imports nothing of the reference package, so it keeps these
dataclasses itself.  Every default equals the reference's, field for field;
``tests/test_torch_config.py`` holds the two copies together.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class OrbConfig:
    """ORB extractor settings (ORBextractor.cc ctor + ICL.yaml)."""

    n_features: int = 1024  # must equal caps.max_keypoints
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20  # threshold fallback 20 -> 7
    min_th_fast: int = 7
    cell_size: int = 30
    edge_threshold: int = 19
    patch_size: int = 31


@dataclass(frozen=True)
class MatcherConfig:
    """ORB matcher constants (ORBmatcher.cc:37-39 and call sites)."""

    th_low: int = 50
    th_high: int = 100
    hist_length: int = 30
    nn_ratio_track: float = 0.9
    nn_ratio_bow: float = 0.7
    nn_ratio_init: float = 0.9


@dataclass(frozen=True)
class TrackingConfig:
    """Front-end thresholds (Tracking.cc)."""

    min_init_matches: int = 100
    min_track_motion: int = 20
    min_track_ref: int = 10
    min_track_localmap: int = 30
    max_local_keyframes: int = 80
    search_radius_motion: float = 15.0
    search_radius_localmap: float = 6.0
    min_frames_between_kf: int = 0
    max_frames_between_kf: int = 30
    mapping_busy_frames: int = 5
    reloc_min_inliers: int = 50
    kf_cull_redundancy: float = 0.9
    kf_cull_min_obs: int = 3
    init_median_depth: float = 1.0
    rescale_min_plane_dist: float = 0.3
    rescale_min: float = 0.5
    rescale_max: float = 2.0
    rescale_min_planes: int = 2


@dataclass(frozen=True)
class BAConfig:
    """Optimizer thresholds (Optimizer.cc + Parameters.cc:55-75)."""

    chi2_mono: float = 5.991
    chi2_stereo: float = 7.815
    pose_opt_rounds: int = 4
    pose_opt_iters: int = 10
    local_ba_iters_phase1: int = 5
    local_ba_iters_phase2: int = 10
    global_ba_iters: int = 10
    gba_time_budget_s: float = 0.0
    ba_weight_bbox: float = 1.0
    ba_weight_corner: float = 1.0
    ba_weight_se3: float = 1.0
    ba_weight_pt_obj: float = 1.0
    th_huber_bbox_2d: float = 80.0
    th_huber_corner_2d: float = 10.0
    th_huber_se3: float = 900.0
    th_huber_pt_obj: float = 10.0
    plane_angle_info: float = 1.0
    plane_dist_info: float = 100.0
    plane_chi: float = 500.0
    plane_par_sigma: float = 0.5
    plane_ver_sigma: float = 0.5
    plane_vp_chi: float = 200.0
    cuboid_plane_angle_info: float = 2.0
    cuboid_plane_dist_info: float = 100.0
    cuboid_plane_chi: float = 500.0
    max_outside_margin_ratio: float = 1.0
    cuboid_vertex_fixrollpitch: bool = True
    cuboid_vertex_fixheight: bool = True
    cuboid_fix_scale: bool = False


@dataclass(frozen=True)
class SemanticConfig:
    """Plane/cuboid detection + association gates (Tracking.cc)."""

    plane_cloud_stride: int = 3
    plane_min_inliers: int = 1000
    plane_angle_threshold_deg: float = 3.0
    plane_dist_threshold: float = 0.05
    plane_asso_dist: float = 0.4
    plane_asso_angle: float = 0.8
    plane_ver_angle: float = 0.08716
    plane_par_angle: float = 0.9962
    cuboid_plane_dist: float = 0.2
    cuboid_plane_angle: float = 0.9397
    cuboid_min_own_points: int = 20
    cuboid_shared_point_votes: int = 5
    cuboid_cull_min_obs: int = 3
    cuboid_cull_after_kfs: int = 15
    object_boundary_margin: int = 5


@dataclass(frozen=True)
class LoopConfig:
    """Loop closing constants (LoopClosing.cc, Optimizer.cc)."""

    covisibility_consistency_th: int = 3
    min_bow_matches: int = 20
    min_sim3_inliers: int = 20
    min_total_matches: int = 40
    essential_graph_min_feat: int = 100
    essential_graph_iters: int = 20
    sim3_ransac_max_iters: int = 300
    sim3_ransac_prob: float = 0.99
    sim3_min_inliers_ransac: int = 20


@dataclass(frozen=True)
class FeatureFlags:
    """Pipeline feature toggles (Parameters.cc:34-52)."""

    detect_object: bool = False
    read_offline_cuboidtxt: bool = False
    detect_plane: bool = False
    read_offline_planetxt: bool = False
    associate_point_with_object: bool = False
    associate_cuboid_with_classname: bool = False
    optimize_with_plane_3d: bool = False
    optimize_with_cuboid_plane: bool = False
    optimize_with_cuboid_2d: bool = False
    optimize_with_cuboid_3d: bool = False
    optimize_with_corners_2d: bool = False
    optimize_with_pt_obj_3d: bool = False
    enable_ground_height_scale: bool = False
    build_worldframe_on_ground: bool = False
    enable_loop_closing: bool = True
    distributed_ba: bool = True


@dataclass(frozen=True)
class Capacities:
    """Static-shape capacities: the pad sizes of every map container."""

    max_keypoints: int = 1024
    max_keyframes: int = 512
    max_points: int = 32768
    max_planes: int = 64
    max_cuboids: int = 32
    max_obs_per_point: int = 32
    max_planes_per_frame: int = 16
    max_cuboids_per_frame: int = 8
    max_points_per_cuboid: int = 64
    local_ba_keyframes: int = 16
    local_ba_fixed_keyframes: int = 16
    local_ba_points: int = 4096
    pose_opt_points: int = 1024
    vocab_words: int = 1024
    global_ba_keyframes: int = 64
    global_ba_points: int = 8192


@dataclass(frozen=True)
class SlamConfig:
    sensor: str = "mono"  # mono | rgbd | stereo
    # close/far point split multiplier: the metric threshold is
    # depth_threshold * bf / fx (Tracking.cc:144)
    depth_threshold: float = 40.0
    orb: OrbConfig = field(default_factory=OrbConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    ba: BAConfig = field(default_factory=BAConfig)
    semantic: SemanticConfig = field(default_factory=SemanticConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    flags: FeatureFlags = field(default_factory=FeatureFlags)
    caps: Capacities = field(default_factory=Capacities)

    def replace(self, **kwargs) -> "SlamConfig":
        return dataclasses.replace(self, **kwargs)
