"""Artifact writers (util/Visualization.{h,cpp} of the reference): the
port's copy of the parts of panovlm_tpu/utils/visualization.py that the
port calls. The JAX module colours depth with cv2's JET colormap and writes
JPEG; the machine with the card has no cv2, so `depth_to_color` uses the
piecewise-linear JET formula and the SfM stage writes PNG."""

from __future__ import annotations

import numpy as np

from ..io.pointcloud import write_pcd
from .poses import params_to_world


def depth_to_color(depth, max_depth: float = 20.0, min_depth: float = 0.0):
    """Depth colormap -> (H,W,3) uint8 BGR (cv2's channel order), JET:
    blue (near) through green to red (far); no depth is black."""
    d = np.asarray(depth, np.float32)
    x = np.clip((d - min_depth) / max(max_depth - min_depth, 1e-6), 0, 1)
    x = (x * 255).astype(np.uint8).astype(np.float32) / 255.0
    rgb = np.stack([np.clip(1.5 - np.abs(4 * x - c), 0, 1) for c in (3.0, 2.0, 1.0)], -1)
    color = (rgb[..., ::-1] * 255 + 0.5).astype(np.uint8)
    color[d <= 0] = 0
    return color


def camera_centers_pcd(path, poses_params, frame_valid=None):
    """CameraCenterPCD (util/Visualization.h): one point per camera center,
    intensity = time index."""
    _, C = params_to_world(poses_params)
    n = len(C)
    valid = np.ones(n, bool) if frame_valid is None else np.asarray(frame_valid)
    inten = (np.arange(n) / max(n - 1, 1)).astype(np.float32)
    write_pcd(path, C[valid].astype(np.float32), intensity=inten[valid])


def camera_pose_ply(path, poses_params, frame_valid=None, scale: float = 0.2):
    """CameraPoseVisualize: small 5-point frustum per camera as PLY points
    with per-axis colored edges collapsed to points (x=red axis tip etc.)."""
    R_w, t_w = params_to_world(poses_params)
    n = len(t_w)
    valid = np.ones(n, bool) if frame_valid is None else np.asarray(frame_valid)
    pts, cols = [], []
    axes = np.eye(3) * scale
    axis_colors = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255]], np.uint8)
    for i in range(n):
        if not valid[i]:
            continue
        pts.append(t_w[i])
        cols.append(np.array([255, 255, 255], np.uint8))
        for a in range(3):
            for s in np.linspace(0.25, 1.0, 4):
                pts.append(t_w[i] + R_w[i] @ axes[a] * s)
                cols.append(axis_colors[a])
    pts = np.asarray(pts, np.float32)
    cols = np.asarray(cols, np.uint8)
    with open(path, "wb") as f:
        f.write((f"ply\nformat binary_little_endian 1.0\n"
                 f"element vertex {len(pts)}\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                 "end_header\n").encode())
        rec = np.zeros(len(pts), dtype=[("xyz", np.float32, 3),
                                        ("rgb", np.uint8, 3)])
        rec["xyz"] = pts
        rec["rgb"] = cols
        f.write(rec.tobytes())
