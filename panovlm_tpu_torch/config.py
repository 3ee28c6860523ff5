"""Pipeline configuration — same keys/defaults as the reference Config.

Replaces base/Config.h:19-281: a flat config parsed from `key = value` text
(boost::program_options config-file syntax: '#' comments, one pair per
line). Unknown file -> defaults with a warning; derived result directories;
T_cl parsed from 7 (qw qx qy qz tx ty tz) or 12 (row-major R|t) numbers
(Config.h:261-279).

The port's copy of panovlm_tpu/config.py: same keys, same defaults.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from dataclasses import dataclass, field

import numpy as np

log = logging.getLogger("panovlm")


@dataclass
class Config:
    # paths (Config.h:26-58)
    image_path: str = ""
    lidar_path: str = ""
    depth_path: str = ""
    frame_path: str = ""
    match_pair_path: str = ""
    match_pair_joint_path: str = ""
    image_line_path: str = ""
    lidar_path_undistort: str = ""
    mvs_data_path: str = ""
    result_path: str = ""
    mask_path: str = ""
    gps_path: str = ""

    num_threads: int = -1
    data_gap_time: float = 0.0
    use_cuda: bool = False          # accepted for config parity; ignored
    max_depth: float = 20.0
    min_depth: float = 0.1
    max_depth_visual: float = 20.0

    # LiDAR feature extraction (Config.h:70-77)
    extraction_method: int = 3      # 3 = ADAPTIVE
    lidar_ring_repair: bool = False  # ReOrderVLP2's LCS packet-order
                                    # conflict repair instead of plain
                                    # elevation binning (the reference
                                    # ships both; production default is
                                    # ReOrderVLP, LidarOdometry.cpp:142-143)
    max_curvature: float = 5.0
    intersection_angle_threshold: float = 5.0
    ground_segment: bool = True
    lidar_segmentation: bool = True

    # image line extraction
    ncc_threshold: float = -0.2

    # SIFT (Config.h:84-88)
    root_sift: bool = True
    num_sift: int = 8096
    # panovlm_tpu extension (no reference analog): run SIFT on the TPU
    # (ops/sift_device.py batched DoG) instead of host cv2 — for 1-core
    # hosts where cv2 detect costs ~1 s/frame at profile resolution
    sift_device: bool = False
    sift_match_dist_threshold: float = 0.6
    sift_match_num_threshold: int = 40

    # relative pose
    keep_pairs_no_scale: bool = True
    T_cl: np.ndarray = field(default_factory=lambda: np.eye(4))
    time_offset: float = 0.0

    # SfM (Config.h:97-111)
    rotation_averaging_method: int = 1
    translation_averaging_method: int = 1
    # FrameMatchMethod bitmask (sfm/SfM.h:56-63): 1 EXHAUSTIVE, 2 CONTIGUOUS,
    # 4 VLAD, 8 GPS, 16 GPS_VLAD. The reference hardcodes VLAD|CONTIGUOUS
    # (main.cpp:202); exposed as a config key here.
    frame_match_method: int = 6
    use_all_pairs_ra: bool = True
    use_all_pairs_ta: bool = True
    init_translation_DLT: bool = True
    init_translation_GPS: bool = False
    num_iteration_L2IRLS: int = 10
    upper_scale_ratio: float = 1.3
    lower_scale_ratio: float = 0.9
    triangulate_angle_threshold: float = 25.0
    colorize_structure: bool = True

    # LiDAR residuals (Config.h:115-124)
    angle_residual: bool = True
    point_to_line_residual: bool = True
    point_to_line_dis_threshold: float = 0.3
    line_to_line_residual: bool = True
    point_to_plane_residual: bool = True
    point_to_plane_dis_threshold: float = 1.0
    lidar_plane_tolerance: float = 0.03
    normalize_distance: bool = True

    num_iteration_lidar: int = 5
    num_iteration_joint: int = 1
    neighbor_size_joint: int = 3
    # line-track gating in joint optimization (AssociateLineMulti flags,
    # joint_optimization/CameraLidarOptimizer.h:78-79; default false there)
    use_image_track: bool = False
    use_lidar_track: bool = False
    # AssociateTrack redistribution (CameraLidarTrackAssociate.cpp:103-204)
    use_track_associate: bool = False
    min_track_length: int = 3
    camera_weight: float = 1.0
    lidar_weight: float = 1.0
    camera_lidar_weight: float = 1.0

    # MVS (Config.h:136-146)
    mvs_use_lidar: bool = True
    # NeighborSelection enum (mvs/MVS.h:32-36): 1 SFM_POINTS co-visibility
    # scoring, 2 NEAREST_NEIGHBOR center KNN (the reference default)
    mvs_neighbor_selection: int = 2
    scale: int = 0
    ncc_half_window: int = 11
    ncc_step: int = 2
    propagate_strategy: int = 1     # 1 = checkerboard, 2 = sequential
    depth_diff_threshold: float = 0.01
    min_segment: int = 50
    mvs_use_geometric: bool = True
    keep_lidar_constant: bool = False
    mvs_sweep_slices: int = 64      # TPU extension: plane-sweep sample
                                    # volume slices for gather-free NCC
                                    # scoring (0 = exact per-plane bilinear
                                    # sampling, the reference's semantics)
    mvs_num_iterations: int = 4     # TPU extension: PatchMatch propagation
                                    # rounds (the reference hardcodes 4,
                                    # mvs/MVS.cpp:640)
    mvs_fit_sweep_range: bool = True  # TPU extension: tighten the sweep
                                    # depth range (and slice count, at
                                    # constant displacement resolution) to
                                    # the LiDAR depth prior's 2-98 pct
                                    # span — the volume build is the MVS
                                    # bottleneck and costs O(slices)

    # derived (Config.h:249-257)
    sfm_result_path: str = ""
    odo_result_path: str = ""
    joint_result_path: str = ""
    calib_result_path: str = ""
    texture_result_path: str = ""
    mvs_result_path: str = ""
    mvs_depth_path: str = ""
    mvs_normal_path: str = ""
    mvs_conf_path: str = ""

    def __post_init__(self):
        if self.image_path.endswith(".txt") and os.path.isfile(self.image_path):
            raise TypeError(
                f"Config({self.image_path!r}): got a config-file path as the "
                "first field; use load_config(path) to parse a file")
        self._derive()

    def _derive(self):
        self.sfm_result_path = os.path.join(self.result_path, "sfm")
        self.odo_result_path = os.path.join(self.result_path, "odometry")
        self.joint_result_path = os.path.join(self.result_path, "joint")
        self.calib_result_path = os.path.join(self.result_path, "calib")
        self.texture_result_path = os.path.join(self.result_path, "texture")
        self.mvs_result_path = os.path.join(self.result_path, "mvs")
        self.mvs_depth_path = os.path.join(self.mvs_data_path, "depth")
        self.mvs_normal_path = os.path.join(self.mvs_data_path, "normal")
        self.mvs_conf_path = os.path.join(self.mvs_data_path, "conf")


_BOOL = {"true": True, "1": True, "yes": True, "on": True,
         "false": False, "0": False, "no": False, "off": False}


def load_config(path: str) -> Config:
    """Parse a `key = value` config file into Config (Config.h:150-248)."""
    cfg = Config()
    if not os.path.exists(path):
        log.warning("Fail to open config file: %s, use default config", path)
        return cfg
    fields = {f.name: f for f in dataclasses.fields(Config)}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, _, val = line.partition("=")
            key = key.strip()
            val = val.strip()
            if key == "T_cl":
                nums = [float(x) for x in val.split()]
                T = np.eye(4)
                if len(nums) == 7:
                    qw, qx, qy, qz, tx, ty, tz = nums
                    from scipy.spatial.transform import Rotation as ScR
                    T[:3, :3] = ScR.from_quat([qx, qy, qz, qw]).as_matrix()
                    T[:3, 3] = [tx, ty, tz]
                elif len(nums) == 12:
                    T[:3, :4] = np.asarray(nums).reshape(3, 4)
                cfg.T_cl = T
                continue
            if key not in fields:
                log.warning("unknown config key: %s", key)
                continue
            ftype = fields[key].type
            if ftype in ("int", int):
                setattr(cfg, key, int(val))
            elif ftype in ("float", float):
                setattr(cfg, key, float(val))
            elif ftype in ("bool", bool):
                v = val.lower()
                setattr(cfg, key, _BOOL[v] if v in _BOOL else bool(int(val)))
            else:
                setattr(cfg, key, val)
    cfg._derive()
    return cfg
