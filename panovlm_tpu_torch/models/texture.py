"""Point-cloud colorization — the port of panovlm_tpu/models/texture.py
(mvs/Texture.{h,cpp} of the reference).

`colorize_points` samples one panorama for world points (the SfM stage's
structure.pcd). `colorize_lidar_map` is stage 4's ColorizeLidarPointCloud:
each scan takes its colours from its nearest camera, chosen on the host as
the reference does; the scans are then colorized on the device in chunks
(the reference's lax.map over scans). The panoramas stay uint8 on the
device, a quarter of the reference's float32 stack; each bilinear tap is
read as the float32 u8 / 255 the reference's images hold, so the lerp
sees the same values. `fuse_cloud` merges the coloured scans in a voxel
grid (FuseCloud), with exact sums.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import se3, spherical
from ..utils.membudget import device_chunk
from .association import scan_centers, to_world


def colorize_points(points_w, mask, image, pose_cw, max_dist: float = 35.0):
    """Sample image color for world points seen from one camera. points_w
    (P,3); image (H,W) gray or (H,W,3) rgb; pose_cw (6,) [aa_cw, t_cw].
    Returns (colors (P,C), ok (P,))."""
    H, W = image.shape[:2]
    R = se3.exp_so3(pose_cw[:3])
    p_c = points_w @ R.T + pose_cw[3:]
    dist = torch.linalg.vector_norm(p_c, dim=-1)
    col = spherical.bilinear_sample(image, spherical.cam_to_image(p_c, H, W))
    ok = mask & (dist > 0.1) & (dist < max_dist)
    if col.dim() == 1:
        col = col[:, None]
    return torch.where(ok[:, None], col, torch.zeros_like(col)), ok


def nearest_cameras(lidar_poses, cam_poses, nearest_dist: float = 1.5):
    """Each scan's camera (texture.py:80-86 of the reference), on the host in
    float32: the argmin over the (N, M) distances between the scan centres
    and the camera centres -R^T t, first index on ties, and whether it lies
    within nearest_dist. The camera validity flags play no part, as in the
    reference. lidar_poses (N,6) [aa_lw, t_lw], cam_poses (M,6) [aa_cw,
    t_cw]. Returns (cam_idx (N,) int32, cam_near (N,) bool) numpy."""
    lp = torch.as_tensor(np.asarray(lidar_poses, np.float32))
    cp = torch.as_tensor(np.asarray(cam_poses, np.float32))
    C_l = scan_centers(lp).numpy()
    C_c = (-torch.einsum("nji,nj->ni", se3.exp_so3(cp[:, :3]), cp[:, 3:])).numpy()
    d = np.linalg.norm(C_c[None, :] - C_l[:, None], axis=-1)
    cam_idx = np.argmin(d, axis=1).astype(np.int32)
    return cam_idx, d[np.arange(len(C_l)), cam_idx] <= nearest_dist


def colorize_scans(pts, mask, lidar_poses, images, cam_poses, cam_idx, cam_near,
                   max_dist: float = 35.0):
    """The per-scan body of the reference's _colorize_all, over a batch of
    scans: pts (B,P,3) local, mask (B,P), lidar_poses (B,6), images
    (M,H,W,C) uint8, cam_poses (M,6), cam_idx (B,), cam_near (B,). Returns
    (points_w (B,P,3), colors (B,P,C) zero where not ok, ok (B,P))."""
    H, W = images.shape[1:3]
    p_w = to_world(lidar_poses, pts)
    pose = cam_poses[cam_idx.to(torch.int64)]
    R = se3.exp_so3(pose[:, :3])
    p_c = torch.einsum("bpj,bij->bpi", p_w, R) + pose[:, None, 3:]    # p_w @ R^T + t
    dist = torch.linalg.vector_norm(p_c, dim=-1)
    col = spherical.bilinear_sample_u8(images, cam_idx, spherical.cam_to_image(p_c, H, W))
    ok = mask & (dist > 0.1) & (dist < max_dist) & cam_near[:, None]
    return p_w, torch.where(ok[..., None], col, torch.zeros_like(col)), ok


def colorize_lidar_map(scans_pts, scans_mask, lidar_poses, images, cam_poses,
                       nearest_dist: float = 1.5, max_dist: float = 35.0,
                       device="cuda"):
    """ColorizeLidarPointCloud (mvs/Texture.cpp): each scan is colorized from
    its nearest camera (by centre distance, <= nearest_dist).

    scans_pts (N,P,3) local scans, scans_mask (N,P); lidar_poses (N,6)
    [aa_lw, t_lw]; images (M,H,W,C) uint8 (C = 1 or 3); cam_poses (M,6)
    [aa_cw, t_cw]; numpy or tensors. Returns (points_w (N*P,3), colors
    (N*P,C), mask (N*P,)) on `device`."""
    device = torch.device(device)
    cam_idx, cam_near = nearest_cameras(lidar_poses, cam_poses, nearest_dist)

    def on_dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a), device=device, dtype=dtype)

    imgs = on_dev(images)
    if imgs.dim() == 3:
        imgs = imgs[..., None]
    pts, msk = on_dev(scans_pts, torch.float32), on_dev(scans_mask, torch.bool)
    lp, cp = on_dev(lidar_poses, torch.float32), on_dev(cam_poses, torch.float32)
    idx, near = on_dev(cam_idx), on_dev(cam_near)
    N, P = msk.shape
    # ~30 float32 temporaries per point
    chunk = device_chunk(P * 30 * 4, device)
    parts = [colorize_scans(pts[s:s + chunk], msk[s:s + chunk], lp[s:s + chunk], imgs, cp,
                            idx[s:s + chunk], near[s:s + chunk], max_dist)
             for s in range(0, N, chunk)]
    p_w, col, ok = (torch.cat(x) for x in zip(*parts))
    return p_w.reshape(N * P, 3), col.reshape(N * P, -1), ok.reshape(N * P)


def fuse_cloud(points, colors, mask, leaf: float = 0.04):
    """FuseCloud (mvs/Texture.cpp): voxel-merge the colorized cloud.
    Returns (centroids, out_mask, mean colours)."""
    from ..sensors.velodyne import voxel_downsample
    return voxel_downsample(points, mask, aux=colors, leaf=leaf)
