"""Configuration tree: dataclass groups + YAML loader + overrides.

The port's own copy of vslam_tpu/io/config.py (which it may not import:
the JAX package's import pulls in jax).  Group and key names are
identical, so configurations/*.yaml load unchanged.  Mirrors the
reference's parameter system (src/types/parameters.cpp:272-441 YAML
groups); unknown keys warn instead of failing.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import yaml


@dataclass
class CommandLineParameters:
    # reference parameters.h:23-64
    # Live Qt/OpenGL viewers are a documented non-goal (real-time display
    # is explicitly no constraint, reference README.md:7); these two flags
    # are parsed for YAML compat and intentionally unread — the file-dump
    # equivalent is visualization.enable_image_dump.
    option_use_gui: bool = False
    option_disable_relocalization: bool = False  # -open-loop
    option_show_top_viewer: bool = False
    # Drives the landmark-eviction sweep (map lifecycle).  Default True
    # here (the reference defaults false and frees whole frames; our sweep
    # only recycles stale low-quality unprotected slots, so it is safe to
    # leave on and required for bounded memory on long runs).
    option_drop_framepoints: bool = True
    option_equalize_histogram: bool = False
    option_use_odometry: bool = False
    option_recover_landmarks: bool = True
    option_save_pose_graph: bool = False
    tracker_mode: str = "RGB_STEREO"  # RGB_STEREO | RGB_DEPTH
    dataset_file_name: str = ""
    configuration_file_name: str = ""


@dataclass
class LandmarkParameters:
    # reference parameters.h:97-126
    minimum_number_of_forced_updates: int = 2
    maximum_translation_error_to_depth_ratio: float = 1.0
    minimum_number_of_measurements_for_optimization: int = 2


@dataclass
class LocalMapParameters:
    # reference parameters.h:128-137
    minimum_number_of_landmarks: int = 50
    maximum_number_of_landmarks: int = 1000


@dataclass
class WorldMapParameters:
    # reference parameters.h:139-152; trigger logic world_map.cpp:108-111
    minimum_distance_traveled_for_local_map: float = 0.5
    minimum_degrees_rotated_for_local_map: float = 30.0
    minimum_number_of_frames_for_local_map: int = 4


@dataclass
class FramepointGenerationParameters:
    # reference parameters.h:154-257 (base/stereo/depth groups)
    target_number_of_keypoints_tolerance: float = 0.1
    detector_threshold_minimum: float = 5.0
    detector_threshold_starting_value: float = 20.0
    detector_threshold_maximum: float = 100.0
    detector_threshold_maximum_change: float = 10.0
    detector_type: str = "FAST"
    descriptor_type: str = "BRIEF256"  # BRIEF256 | BRIEF256R (oriented) | ORB256
    # Pyramid levels for detection+description (TPU-native analog of the
    # reference detectors' internal multi-scale behaviour — cv::ORB runs 8
    # levels, base_framepoint_generator.cpp:52-70).  1 = single scale.
    detector_number_of_octaves: int = 1
    bin_size_pixels: int = 16
    capacity: int = 1024  # fixed keypoint capacity (TPU-native addition)
    border_pixels: int = 20
    matching_distance_tracking_threshold: int = 60
    # stereo group (parameters.h:214-235)
    maximum_matching_distance_triangulation: int = 60
    minimum_disparity_pixels: float = 1.0
    maximum_disparity_pixels: float = 200.0
    maximum_epipolar_search_offset_pixels: float = 1.5
    # depth group (parameters.h:237-257)
    maximum_depth_meters: float = 10.0
    minimum_depth_meters: float = 0.3
    # 16-bit depth units -> meters (reference key name, parameters.h:251;
    # 1e-3 = millimeter-encoded depth as in ROS bag streams).  The TUM/ICL
    # PNG loader defaults to 1/5000 unless this key is explicitly set in
    # the YAML (io/datasets.py, system/cli.py).
    depth_scale_factor_intensity_to_meters: float = 1e-3
    # Optional bilateral smoothing of the (registered) depth map
    # (reference depth_framepoint_generator.cpp:415-421).
    enable_bilateral_filtering: bool = False
    # Misaligned depth sensor calibration (reference registers the depth
    # image into the RGB camera every frame, _computeDepthMap,
    # depth_framepoint_generator.cpp:410-484).  None = already registered
    # (TUM/ICL); otherwise 3x3 / 4x4 row-major nested lists from YAML.
    depth_camera_intrinsics: list | None = None
    depth_camera_to_rgb: list | None = None


@dataclass
class TrackingParameters:
    # reference parameters.h:259-327
    minimum_track_length_for_landmark_creation: int = 2
    minimum_number_of_landmarks_to_track: int = 5
    minimum_threshold_distance_tracking_pixels: int = 50
    maximum_threshold_distance_tracking_pixels: int = 60
    # Parsed for reference-YAML compatibility; DEAD IN THE REFERENCE TOO
    # (parameters.cpp parses it, nothing in src/ reads it) — intentionally
    # ignored here as well.
    range_point_tracking: int = 2
    maximum_distance_tracking_pixels: int = 150
    good_tracking_ratio: float = 0.3
    # 0 disables landmark recovery entirely (with option_recover_landmarks
    # it gates frame_mod.recover_lost_landmarks).  The reference parses
    # this key but never reads it (dead there); the 0-disables semantic is
    # our documented extension.
    maximum_number_of_landmark_recoveries: int = 3
    minimum_delta_angular_for_movement: float = 0.001
    minimum_delta_translational_for_movement: float = 0.01
    motion_model: str = "CONSTANT_VELOCITY"  # NONE | CONSTANT_VELOCITY
    # TPU-native addition: fused single-dispatch frame program (production)
    # vs the modular multi-kernel path (reference implementation).
    use_fused_tracker: bool = True
    # TPU-native addition: run the front-end batched over whole frame
    # chunks (data parallelism of detect/describe/match) with sequential
    # track steps consuming the precomputed frames.
    batch_frontend: bool = False
    # aligner sub-group (parameters.h:66-95)
    aligner_maximum_error_kernel: float = 25.0
    aligner_damping: float = 1.0
    aligner_maximum_number_of_iterations: int = 100
    aligner_minimum_number_of_inliers: int = 20
    aligner_minimum_inlier_ratio: float = 0.4


@dataclass
class RelocalizationParameters:
    # reference parameters.h:329-356
    preliminary_minimum_interspace_queries: int = 10
    preliminary_minimum_matching_ratio: float = 0.1
    minimum_number_of_matches_per_landmark: int = 20
    minimum_matches_per_correspondence: int = 0
    maximum_descriptor_distance: int = 45
    # Lowe-style absolute margin: best must beat the runner-up by this many
    # bits (TPU-native addition; plays the role of the reference's ratio
    # test + HBST ambiguity filtering, relocalizer.cpp:86-123).
    minimum_second_best_margin: int = 8
    aligner_type: str = "ICP"  # ICP (FAST-ICP variant: backend AA extension)
    icp_minimum_number_of_inliers: int = 25
    icp_minimum_inlier_ratio: float = 0.4
    icp_maximum_error_kernel: float = 1.0
    # TPU-native addition: max correspondence pairs fed to closure ICP
    # (fixed so the aligner compiles once; excess pairs are dropped).
    icp_correspondence_cap: int = 512


@dataclass
class GraphOptimizationParameters:
    # reference parameters.h:358-429
    optimization_algorithm: str = "GAUSS_NEWTON"  # GAUSS_NEWTON | LEVENBERG
    enable_full_bundle_adjustment: bool = False
    number_of_frames_per_bundle_adjustment: int = 100
    maximum_number_of_iterations: int = 10
    minimum_estimation_delta_for_update_meters: float = 0.001
    base_information_frame: float = 1e4
    free_translation_for_poses: bool = True
    base_information_frame_factor_for_translation: float = 1e3
    enable_robust_kernel_for_poses: bool = True
    # Default True here (reference default false): BA measurement rows
    # come from automated matching, and un-reweighted outliers drag the
    # Schur solve; disable for strict reference behavior.
    enable_robust_kernel_for_landmarks: bool = True
    # Landmark vertex id offset in g2o exports (reference parameters.h:362).
    identifier_space: int = 1_000_000_000
    # TPU-native additions (no reference counterpart — the reference
    # re-optimizes on every relocalized frame, slam_assembly.cpp:576-579):
    # skip the optimization when every pending closure edge agrees with
    # the current estimate within these bounds.  Default 0.0 = gate OFF
    # (reference parity: optimize on every verified closure) — a nonzero
    # default silently disabled closure corrections on small indoor
    # scenes whose drift never exceeds the gate (ADVICE r4).  The
    # KITTI-scale bench/scale configs enable it explicitly.
    minimum_closure_residual_for_optimization_meters: float = 0.0
    minimum_closure_residual_for_optimization_degrees: float = 0.0
    # Closure-edge compaction cell for the hierarchical solver: one edge
    # kept per (ref//b, query//b) neighborhood (backend/pose_graph.py).
    closure_compaction_bucket: int = 4


@dataclass
class VisualizationParameters:
    enable_image_dump: bool = False
    dump_directory: str = "/tmp/vslam_tpu_viz"


@dataclass
class ParallelismParameters:
    """TPU-native addition: device mesh layout (no reference counterpart —
    SURVEY.md §2.9)."""

    mesh_shape: tuple = (1,)
    mesh_axis_names: tuple = ("lm",)
    shard_landmarks: bool = True
    shard_descriptor_db: bool = True
    # Frames between result-ring readbacks of the tracker on an
    # accelerator (the CPU path reads back every frame).  Larger values
    # batch more readbacks at the cost of keyframe-path latency.
    frames_per_chunk: int = 32
    # Device-side keyframe snapshot ARCHIVE rows on an accelerator:
    # snapshot descriptors and observations stay on the device for the
    # whole run; 4096 rows cover > 10k-frame sequences at the reference
    # keyframe cadence.
    kf_archive_size: int = 4096


@dataclass
class ParameterCollection:
    command_line: CommandLineParameters = field(default_factory=CommandLineParameters)
    landmark: LandmarkParameters = field(default_factory=LandmarkParameters)
    local_map: LocalMapParameters = field(default_factory=LocalMapParameters)
    world_map: WorldMapParameters = field(default_factory=WorldMapParameters)
    framepoint_generation: FramepointGenerationParameters = field(
        default_factory=FramepointGenerationParameters
    )
    tracking: TrackingParameters = field(default_factory=TrackingParameters)
    relocalization: RelocalizationParameters = field(
        default_factory=RelocalizationParameters
    )
    graph_optimization: GraphOptimizationParameters = field(
        default_factory=GraphOptimizationParameters
    )
    visualization: VisualizationParameters = field(
        default_factory=VisualizationParameters
    )
    parallelism: ParallelismParameters = field(default_factory=ParallelismParameters)

    def validate(self) -> None:
        """Reject inconsistent parameter combinations with the offending
        key named (reference ParameterCollection::validateParameters +
        setMode mode check, parameters.cpp:443-475)."""

        def bad(key, why):
            raise ValueError(f"invalid configuration: {key} {why}")

        cl, fp, tr = self.command_line, self.framepoint_generation, self.tracking
        if cl.tracker_mode not in ("RGB_STEREO", "RGB_DEPTH"):
            bad("command_line.tracker_mode", f"= {cl.tracker_mode!r} "
                "(RGB_STEREO | RGB_DEPTH)")
        if fp.detector_type not in ("FAST", "FAST9", "FAST12", "AGAST",
                                    "HARRIS", "GFTT", "SHI_TOMASI", "DOG",
                                    "KAZE", "AKAZE"):
            bad("framepoint_generation.detector_type", f"= {fp.detector_type!r}")
        if fp.descriptor_type not in ("BRIEF256", "BRIEF256R", "ORB256"):
            bad("framepoint_generation.descriptor_type",
                f"= {fp.descriptor_type!r}")
        if fp.capacity <= 0 or (fp.capacity & (fp.capacity - 1)):
            bad("framepoint_generation.capacity",
                f"= {fp.capacity} (positive power of two required)")
        if fp.bin_size_pixels <= 0:
            bad("framepoint_generation.bin_size_pixels", "must be positive")
        if not (
            fp.detector_threshold_minimum
            <= fp.detector_threshold_starting_value
            <= fp.detector_threshold_maximum
        ):
            bad("framepoint_generation.detector_threshold_*",
                "must satisfy minimum <= starting_value <= maximum")
        if fp.minimum_depth_meters >= fp.maximum_depth_meters:
            bad("framepoint_generation.minimum_depth_meters",
                ">= maximum_depth_meters")
        if fp.minimum_disparity_pixels >= fp.maximum_disparity_pixels:
            bad("framepoint_generation.minimum_disparity_pixels",
                ">= maximum_disparity_pixels")
        if tr.motion_model not in ("NONE", "CONSTANT_VELOCITY",
                                   "CAMERA_ODOMETRY"):
            bad("tracking.motion_model", f"= {tr.motion_model!r}")
        if self.graph_optimization.optimization_algorithm.upper() not in (
            "GAUSS_NEWTON", "LEVENBERG", "DOGLEG",
        ):
            bad("graph_optimization.optimization_algorithm",
                f"= {self.graph_optimization.optimization_algorithm!r}")
        rl = self.relocalization
        for key in ("preliminary_minimum_matching_ratio",
                    "icp_minimum_inlier_ratio"):
            v = getattr(rl, key)
            if not (0.0 <= v <= 1.0):
                bad(f"relocalization.{key}", f"= {v} (outside [0, 1])")


_GROUP_ALIASES = {
    # reference YAML group names -> our fields (parameters.cpp:272-441)
    "command_line": "command_line",
    "landmark": "landmark",
    "local_map": "local_map",
    "world_map": "world_map",
    "base_framepoint_generation": "framepoint_generation",
    "stereo_framepoint_generation": "framepoint_generation",
    "depth_framepoint_generation": "framepoint_generation",
    "framepoint_generation": "framepoint_generation",
    "tracking": "tracking",
    "relocalization": "relocalization",
    "graph_optimization": "graph_optimization",
    "visualization": "visualization",
    "parallelism": "parallelism",
}


# Old/short key spellings accepted for compatibility with earlier configs.
_KEY_ALIASES = {
    "depth_scale_factor": "depth_scale_factor_intensity_to_meters",
}

# Reference YAML spellings that differ from our field names, per target
# group: the reference nests aligner parameters as "aligner-><key>"
# (parameters.cpp:272-441) and uses minimum_number_of_matched_landmarks
# for the relocalizer ambiguity gate (parameters.cpp:126).
_GROUP_KEY_ALIASES = {
    ("tracking", "aligner->maximum_error_kernel"): "aligner_maximum_error_kernel",
    ("tracking", "aligner->damping"): "aligner_damping",
    ("tracking", "aligner->maximum_number_of_iterations"):
        "aligner_maximum_number_of_iterations",
    ("tracking", "aligner->minimum_number_of_inliers"):
        "aligner_minimum_number_of_inliers",
    ("tracking", "aligner->minimum_inlier_ratio"): "aligner_minimum_inlier_ratio",
    ("relocalization", "aligner->maximum_error_kernel"): "icp_maximum_error_kernel",
    ("relocalization", "aligner->minimum_number_of_inliers"):
        "icp_minimum_number_of_inliers",
    ("relocalization", "aligner->minimum_inlier_ratio"): "icp_minimum_inlier_ratio",
    ("relocalization", "minimum_number_of_matched_landmarks"):
        "minimum_number_of_matches_per_landmark",
    ("framepoint_generation", "maximum_descriptor_distance_tracking"):
        "matching_distance_tracking_threshold",
}

# Reference/OpenCV detector + descriptor spellings -> nearest TPU-native
# implementation (reference Detector hierarchy,
# base_framepoint_generator.cpp:9-159; the float scale-space family maps
# onto the DoG extremum detector, the segment-test family onto FAST).
_DETECTOR_ALIASES = {
    "SIFT": "DOG",
    "SURF": "DOG",
    # KAZE/AKAZE are REAL nonlinear-diffusion detectors here
    # (frontend/detect.kaze_score_map), no longer aliases.
    "BRISK": "FAST",
    "ORB": "FAST",
}
_DESCRIPTOR_ALIASES = {
    "BRIEF": "BRIEF256",
    "BRIEF-128": "BRIEF256",
    "BRIEF-256": "BRIEF256",
    "BRIEF-512": "BRIEF256",
    "ORB-256": "ORB256",
    "BRISK-512": "BRIEF256R",
    "FREAK-512": "BRIEF256R",
    "A-KAZE-486": "BRIEF256R",
    "BinBoost-064": "BRIEF256",
}


def load_config(path: Optional[str] = None, overrides: Optional[dict] = None) -> ParameterCollection:
    """Build a ParameterCollection from YAML + flat 'group.key' overrides.

    The returned collection carries `explicit_keys`: the set of
    "group.key" strings the YAML/overrides actually provided — consumers
    whose defaults depend on context (e.g. the TUM PNG depth scale) use it
    to tell an explicit value from a dataclass default.
    """
    cfg = ParameterCollection()
    explicit: set[str] = set()
    if path:
        with open(path) as f:
            doc = yaml.safe_load(f) or {}
        for group_name, values in doc.items():
            target_name = _GROUP_ALIASES.get(group_name)
            if target_name is None or not isinstance(values, dict):
                print(f"[config] ignoring unknown group '{group_name}'")
                continue
            group = getattr(cfg, target_name)
            for key, val in values.items():
                key = _KEY_ALIASES.get(key, key)
                key = _GROUP_KEY_ALIASES.get((target_name, key), key)
                if hasattr(group, key):
                    cur = getattr(group, key)
                    try:
                        setattr(group, key, type(cur)(val) if cur is not None else val)
                    except (TypeError, ValueError):
                        setattr(group, key, val)
                    explicit.add(f"{target_name}.{key}")
                else:
                    print(f"[config] ignoring unknown key '{group_name}/{key}'")
    for dotted, val in (overrides or {}).items():
        group_name, key = dotted.split(".", 1)
        target_name = _GROUP_ALIASES.get(group_name)
        if target_name is None:
            print(f"[config] ignoring unknown override group '{group_name}'")
            continue
        # Same alias resolution + warn-and-ignore as the YAML path: a
        # reference spelling that works in YAML must work as an override
        # too (ADVICE r4 — getattr on an unknown key crashed here).
        key = _KEY_ALIASES.get(key, key)
        key = _GROUP_KEY_ALIASES.get((target_name, key), key)
        group = getattr(cfg, target_name)
        if not hasattr(group, key):
            print(f"[config] ignoring unknown override '{dotted}'")
            continue
        cur = getattr(group, key)
        try:
            setattr(group, key, type(cur)(val) if cur is not None else val)
        except (TypeError, ValueError):
            setattr(group, key, val)
        explicit.add(f"{target_name}.{key}")
    fp = cfg.framepoint_generation
    det = fp.detector_type.upper()
    if det in _DETECTOR_ALIASES:
        print(
            f"[config] detector '{fp.detector_type}' -> "
            f"'{_DETECTOR_ALIASES[det]}' (nearest TPU-native detector)"
        )
        fp.detector_type = _DETECTOR_ALIASES[det]
    if fp.descriptor_type in _DESCRIPTOR_ALIASES:
        print(
            f"[config] descriptor '{fp.descriptor_type}' -> "
            f"'{_DESCRIPTOR_ALIASES[fp.descriptor_type]}'"
        )
        fp.descriptor_type = _DESCRIPTOR_ALIASES[fp.descriptor_type]
    cfg.explicit_keys = explicit
    cfg.validate()
    return cfg


def save_config(cfg: ParameterCollection, path: str) -> None:
    doc = {f.name: dataclasses.asdict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    with open(path, "w") as f:
        yaml.safe_dump(doc, f)
